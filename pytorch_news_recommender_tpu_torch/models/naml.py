"""NAML: a multi-view news encoder (title and abstract through one shared
attention tower, category and subcategory embeddings) with the NRMS user
tower over LayerNorm-ed clicked-news vectors (port of the JAX package's
``models/naml.py``).

* one word table and one ``text_tower`` (MHSA + additive pooling, no
  dropout inside it) shared by the title and abstract views, encoded as two
  calls of the tower at their own lengths (title 12/20, abstract 40);
  autograd sums the shared weights' gradients;
* category and subcategory embeddings with pad row 0 (``PadEmbedding``);
* news vector = ``[title | abstract | category | subcategory]``, 800 wide
  at the default widths, with dropout on the whole vector in training (a
  mask drawn on the vectors' device from a seed of the step's
  ``torch.Generator``: another stream than the JAX package's ``make_rng``,
  as for the kernel's dropout);
* user tower: the fused encoder at the news width (10 heads of 80, query
  dim 400), history pads masked; ``score_impression`` runs it over the
  ``norm``-ed clicked-news vectors, ``top_k`` (``encode_user``) over the
  cached vectors as they are, as the JAX package's serving does (ROADMAP C);
  the corpus cache holds un-normed vectors, as in the JAX two-tower path;
* dot-product scoring, padded candidates at -1e9.

Every encoder call (title, abstract, user) goes through the fused encoder
kernels on the card; the user tower's D=800 takes their wide variants
(``ops/csrc/tiles.cuh``).
"""

from __future__ import annotations

from typing import Optional

import torch

from pytorch_news_recommender_tpu_torch.config import ModelConfig
from pytorch_news_recommender_tpu_torch.models.common import Batch, RecModel
from pytorch_news_recommender_tpu_torch.models.layers import (
    AttentionPoolTower, LayerNorm, PadEmbedding, UserEncoder, WordEmbedding, dropout,
)
from pytorch_news_recommender_tpu_torch.ops.attention import dot_product_scores


class NAML(RecModel):
    """Title + abstract + category multi-view news encoder, NRMS user tower."""

    FEAT_KEYS = ("title", "abst", "categ", "subcateg")

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        cd = getattr(torch, cfg.compute_dtype)
        self.word_embedding = WordEmbedding(cfg.n_words, cfg.word_embed_size, cd,
                                            trainable=not cfg.freeze_word_embeddings,
                                            embedding_lookup=cfg.embedding_lookup,
                                            a2a_capacity_factor=cfg.a2a_capacity_factor)
        self.text_tower = AttentionPoolTower(cfg.word_embed_size, cfg.num_attention_heads,
                                             cfg.query_vector_dim, cd)
        self.category_embedding = PadEmbedding(cfg.category_nums, cfg.cate_embed_size, cd)
        self.subcategory_embedding = PadEmbedding(cfg.subcategory_nums,
                                                  cfg.cate_embed_size, cd)
        self.news_dim = 2 * cfg.word_embed_size + 2 * cfg.cate_embed_size
        self.norm = LayerNorm(self.news_dim, cd)
        self.user_encoder = UserEncoder(self.news_dim, cfg.user_heads_num,
                                        cfg.query_vector_dim_large, cd)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in (self.word_embedding, self.text_tower, self.category_embedding,
                  self.subcategory_embedding, self.norm, self.user_encoder):
            m.reset_parameters(generator)

    def _text_view(self, ids: torch.Tensor) -> torch.Tensor:
        mask = (ids != 0).float()
        return self.text_tower(self.word_embedding(ids, mask), mask)

    def encode_user(self, browsed_vecs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """``[B, H, D]`` clicked-news vectors -> ``[B, D]`` user vector, by
        the user tower alone: ``norm`` is applied by ``score_impression``
        only, so ``top_k`` ranks with the un-normed cached vectors, as the
        JAX package's ``top_k`` does (``user_encoder``, ROADMAP C)."""
        return self.user_encoder(browsed_vecs, mask)

    def encode_news_feats(self, feats: Batch, deterministic: bool = True,
                          generator: Optional[torch.Generator] = None
                          ) -> torch.Tensor:
        vec = torch.cat([self._text_view(feats["title"]), self._text_view(feats["abst"]),
                         self.category_embedding(feats["categ"]),
                         self.subcategory_embedding(feats["subcateg"])], dim=-1)
        return dropout(vec, self.cfg.dropout, deterministic, generator)

    def score_impression(self, batch, browsed_ids, cand_ids, browsed_vecs,
                         cand_vecs, news_feats=None,
                         deterministic: bool = True) -> torch.Tensor:
        user_vec = self.encode_user(self.norm(browsed_vecs), (browsed_ids != 0).float())
        return dot_product_scores(user_vec, cand_vecs, cand_ids != 0)
