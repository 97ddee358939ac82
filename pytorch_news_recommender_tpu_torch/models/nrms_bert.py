"""NRMS-BERT: precomputed per-news BERT vectors as the news tower (port of
the JAX package's ``models/nrms_bert.py``).

* news tower: a per-news vector table (``bert_embedding/embedding``, the
  dataset's ``bert`` feature rows) -> ``news_dense``, a ``Dense(bert_dim ->
  bert_embed_size)`` in the compute dtype -> dropout (a mask drawn from the
  step's ``torch.Generator``: another stream than the JAX package's);
* with ``bert_trainable`` the table is a float32 parameter that starts as a
  copy of the dataset's table (``Trainer._apply_pretrained`` copies it, as
  Flax's init does); without it the tower reads ``news_feats["bert"]`` and
  the table holds no parameter;
* user tower: the fused encoder at ``bert_embed_size`` (the slice's full
  width: D=512, 4 heads of 128, query dim ``query_vector_dim_large``=400;
  the JAX default of 10 heads does not divide 512, in either package);
* dot-product scoring, padded candidates at -1e9.

The news tower encodes by id (no word axis), so ``LENGTH_SPLIT_OK`` is
False. The user tower goes through the fused encoder kernels on the card.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_news_recommender_tpu_torch.config import ModelConfig
from pytorch_news_recommender_tpu_torch.models.common import Batch, RecModel
from pytorch_news_recommender_tpu_torch.models.layers import Dense, UserEncoder, dropout
from pytorch_news_recommender_tpu_torch.ops.attention import dot_product_scores


class BertEmbedding(nn.Module):
    """The per-news vector table: a trainable float32 parameter of the
    dataset table's shape, or (frozen) the ``news_feats`` table itself."""

    def __init__(self, shape: Tuple[int, int], trainable: bool = True):
        super().__init__()
        self.trainable = trainable
        if trainable:
            self.embedding = nn.Parameter(torch.zeros(shape))

    def forward(self, ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
        if self.trainable:
            return F.embedding(ids.long(), self.embedding)
        return table[ids.long()]


class NRMSBert(RecModel):
    """BERT-vector news tower + attention user tower + dot-product scores."""

    FEAT_KEYS = ("bert",)
    LENGTH_SPLIT_OK = False

    def __init__(self, cfg: ModelConfig, bert_shape: Optional[Tuple[int, int]] = None):
        super().__init__()
        if bert_shape is None or len(bert_shape) != 2:
            raise ValueError("nrms_bert needs the dataset's [n_news, bert_dim] 'bert' "
                             "vectors (cli bert-embeds, then preprocess --bert-npz)")
        self.cfg = cfg
        cd = getattr(torch, cfg.compute_dtype)
        self.bert_embedding = BertEmbedding(tuple(bert_shape), cfg.bert_trainable)
        self.news_dense = Dense(bert_shape[1], cfg.bert_embed_size, cd)
        self.user_encoder = UserEncoder(cfg.bert_embed_size, cfg.user_heads_num,
                                        cfg.query_vector_dim_large, cd)

    @classmethod
    def from_config(cls, cfg: ModelConfig,
                    feat_shapes: Optional[Mapping[str, Tuple[int, ...]]] = None
                    ) -> "NRMSBert":
        return cls(cfg, (feat_shapes or {}).get("bert"))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The dense head and the user tower; the table keeps its values
        (the dataset's copy is loaded by ``Trainer._apply_pretrained``)."""
        self.news_dense.reset_parameters(generator)
        self.user_encoder.reset_parameters(generator)

    def encode_user(self, browsed_vecs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """``[B, H, D]`` clicked-news vectors -> ``[B, D]`` user vector."""
        return self.user_encoder(browsed_vecs, mask)

    def _head(self, vec: torch.Tensor, deterministic: bool,
              generator: Optional[torch.Generator]) -> torch.Tensor:
        return dropout(self.news_dense(vec), self.cfg.dropout, deterministic, generator)

    def encode_news_ids(self, ids: torch.Tensor, news_feats: Batch,
                        deterministic: bool = True,
                        feat_trunc: Optional[Mapping[str, int]] = None,
                        generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The table's rows for ``ids`` through the dense head
        (``feat_trunc`` has no word axis to cut and is ignored)."""
        return self._head(self.bert_embedding(ids, news_feats["bert"]), deterministic,
                          generator)

    def encode_news_feats(self, feats: Batch, deterministic: bool = True,
                          generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The dense head over given BERT rows (a frozen external table)."""
        return self._head(feats["bert"], deterministic, generator)

    def score_impression(self, batch, browsed_ids, cand_ids, browsed_vecs,
                         cand_vecs, news_feats=None,
                         deterministic: bool = True) -> torch.Tensor:
        user_vec = self.encode_user(browsed_vecs, (browsed_ids != 0).float())
        return dot_product_scores(user_vec, cand_vecs, cand_ids != 0)
