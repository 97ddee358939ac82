"""NRMS + knowledge-entity view: the title tower fused with a pooled entity
embedding view (port of the JAX package's ``models/nrms_entity.py``).

* entity view: ``entity [.., E]`` ids -> the ``entity_embedding`` table
  (``PadEmbedding``; the dataset's pretrained entity vectors load into it,
  ``Trainer._apply_pretrained``) -> additive-attention pooling over the E
  entities (pad id 0 masked); news without an entity get a zero view;
* news vector = ``fuse``, a ``Dense(D)`` over ``[title | entity]``, so the
  NRMS user tower runs unchanged at the word dimension;
* scoring: masked dot product.

The title and user towers go through the fused encoder kernels on the card;
the entity view is plain PyTorch, as it is jnp in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch

from pytorch_news_recommender_tpu_torch.config import ModelConfig
from pytorch_news_recommender_tpu_torch.models.common import Batch
from pytorch_news_recommender_tpu_torch.models.layers import (
    AdditiveAttention, Dense, PadEmbedding,
)
from pytorch_news_recommender_tpu_torch.models.nrms import NRMS


class NRMSEntity(NRMS):
    """Title + entity two-view news encoder with the NRMS user tower."""

    FEAT_KEYS = ("title", "entity")

    def __init__(self, cfg: ModelConfig):
        if cfg.entity_nums <= 0:
            raise ValueError("dataset has no entity features")
        super().__init__(cfg)
        cd = getattr(torch, cfg.compute_dtype)
        self.entity_embedding = PadEmbedding(cfg.entity_nums, cfg.entity_embed_size, cd)
        self.entity_attention = AdditiveAttention(cfg.entity_embed_size,
                                                  cfg.query_vector_dim, cd)
        self.fuse = Dense(cfg.word_embed_size + cfg.entity_embed_size,
                          cfg.word_embed_size, cd)

    def reset_parameters(self, generator: torch.Generator) -> None:
        super().reset_parameters(generator)
        for m in (self.entity_embedding, self.entity_attention, self.fuse):
            m.reset_parameters(generator)

    def encode_news_feats(self, feats: Batch, deterministic: bool = True,
                          generator: Optional[torch.Generator] = None
                          ) -> torch.Tensor:
        title_vec = self.news_encoder(feats["title"], deterministic, generator)
        ent_ids = feats["entity"]                        # [.., E]
        ent_mask = (ent_ids != 0).float()
        ent_vec = self.entity_attention(self.entity_embedding(ent_ids), ent_mask)
        # news with zero entities contribute a zero entity view
        any_ent = (ent_mask.sum(-1) > 0).to(ent_vec.dtype)[..., None]
        return self.fuse(torch.cat([title_vec, ent_vec * any_ent], dim=-1))
