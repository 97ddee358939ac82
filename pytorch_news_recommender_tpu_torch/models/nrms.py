"""NRMS: word-level multi-head self-attention news encoder + attention user
encoder + dot-product scoring (port of the JAX package's
``models/nrms.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from pytorch_news_recommender_tpu_torch.config import ModelConfig
from pytorch_news_recommender_tpu_torch.models.common import Batch, RecModel
from pytorch_news_recommender_tpu_torch.models.layers import NewsEncoder, UserEncoder
from pytorch_news_recommender_tpu_torch.ops.attention import dot_product_scores


class NRMS(RecModel):
    """Title-only batched NRMS."""

    FEAT_KEYS = ("title",)

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        cd = getattr(torch, cfg.compute_dtype)
        self.news_encoder = NewsEncoder(
            n_words=cfg.n_words, word_embed_size=cfg.word_embed_size,
            num_heads=cfg.num_attention_heads, query_dim=cfg.query_vector_dim,
            compute_dtype=cd, dropout=cfg.dropout,
            freeze_embeddings=cfg.freeze_word_embeddings,
            embedding_lookup=cfg.embedding_lookup,
            a2a_capacity_factor=cfg.a2a_capacity_factor)
        self.user_encoder = UserEncoder(
            model_dim=cfg.word_embed_size, num_heads=cfg.user_heads_num,
            query_dim=cfg.query_vector_dim, compute_dtype=cd)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.news_encoder.reset_parameters(generator)
        self.user_encoder.reset_parameters(generator)

    # ---- two-tower serving API ----
    def encode_user(self, browsed_vecs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """``[B, H, D]`` clicked-news vectors -> ``[B, D]`` user vector."""
        return self.user_encoder(browsed_vecs, mask)

    # ---- RecModel contract ----
    def encode_news_feats(self, feats: Batch, deterministic: bool = True,
                          generator: Optional[torch.Generator] = None
                          ) -> torch.Tensor:
        return self.news_encoder(feats["title"], deterministic, generator)

    def score_impression(self, batch, browsed_ids, cand_ids, browsed_vecs,
                         cand_vecs, news_feats=None,
                         deterministic: bool = True) -> torch.Tensor:
        user_vec = self.encode_user(browsed_vecs, (browsed_ids != 0).float())
        return dot_product_scores(user_vec, cand_vecs, cand_ids != 0)
