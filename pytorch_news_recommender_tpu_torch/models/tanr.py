"""TANR: NRMS towers with an auxiliary topic-prediction task (port of the
JAX package's ``models/tanr.py``).

A linear ``topic_head`` on each news vector predicts the news category; in
training its cross-entropy over the non-pad news of an encode call, times
``topic_loss_weight``, is recorded as the auxiliary loss ``topic_ce``, which
the train step adds to the click loss. As in the JAX package a later encode
call's loss replaces an earlier one's, so a length-split step counts the
long block's news only (ROADMAP.md C). At eval and serving the head is
unused and the cached two-tower path is NRMS's.
"""

from __future__ import annotations

from typing import Optional

import torch

from pytorch_news_recommender_tpu_torch.config import ModelConfig
from pytorch_news_recommender_tpu_torch.models.common import Batch
from pytorch_news_recommender_tpu_torch.models.layers import Dense
from pytorch_news_recommender_tpu_torch.models.nrms import NRMS


class TANR(NRMS):
    """NRMS towers + topic-prediction auxiliary loss."""

    FEAT_KEYS = ("title", "categ")
    HAS_AUX_LOSS = True

    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        self.topic_head = Dense(cfg.word_embed_size, cfg.category_nums,
                                getattr(torch, cfg.compute_dtype))

    def reset_parameters(self, generator: torch.Generator) -> None:
        super().reset_parameters(generator)
        self.topic_head.reset_parameters(generator)

    def encode_news_feats(self, feats: Batch, deterministic: bool = True,
                          generator: Optional[torch.Generator] = None
                          ) -> torch.Tensor:
        vec = self.news_encoder(feats["title"], deterministic, generator)
        # the JAX package applies the head on every call so that Flax's init
        # makes its parameters (XLA drops it at eval); here they exist from
        # construction, and the head runs only where its loss is used
        if not deterministic:
            logp = torch.log_softmax(self.topic_head(vec).float(), dim=-1)
            categ = feats["categ"].long()
            ce = -logp.gather(-1, categ[..., None])[..., 0]
            maskf = (categ != 0).float()
            ce = (ce * maskf).sum() / maskf.sum().clamp_min(1.0)
            self.sow_loss("topic_ce", self.cfg.topic_loss_weight * ce)
        return vec
