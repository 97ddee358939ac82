"""Listwise re-ranker: two towers and a transformer interaction head over
the candidate list (port of the JAX package's ``models/list_rank.py``), in
plain PyTorch, as it is plain jnp there: the family reaches no kernel.

* news tower: the frozen BERT vectors (``news_feats["bert"]``) with the
  category and subcategory embeddings -> ``news_dense`` (``list_title_size``)
  -> GELU -> dropout;
* user tower (:class:`ListRankUserEncoder`): MHSA -> position-wise FFN ->
  additive pooling with the large query dim, over the clicked-news vectors;
* head: per candidate ``[user | candidate]`` -> LayerNorm -> Dense + GELU,
  padded candidates zeroed, ``list_layers`` transformer blocks over the
  candidate axis, ``fc`` -> one score, -1e9 on pads.

``top_k`` ranks the corpus with the user tower's vector against the cached
news vectors (``encode_user``), a dot product, as the JAX ``Recommender``
does, not through the interaction head (ROADMAP C). The user tower's heads
must divide ``list_title_size``: the JAX default of 10 heads does not
divide 512, in either package.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from pytorch_news_recommender_tpu_torch.config import ModelConfig
from pytorch_news_recommender_tpu_torch.models.common import Batch, RecModel
from pytorch_news_recommender_tpu_torch.models.layers import (
    Dense, LayerNorm, MultiHeadSelfAttention, PadEmbedding, PositionwiseFeedForward,
    TransformerEncoderBlock, _draw, _xavier_uniform, dropout, gelu,
)
from pytorch_news_recommender_tpu_torch.ops.attention import (
    NEG_INF, additive_attention_with_weights,
)


class ListRankUserEncoder(nn.Module):
    """MHSA + FFN + additive pooling; the pooling's ``aw [D, Q]``
    (Xavier-uniform), ``ab`` (zeros) and ``aq`` (U(-1, 1)) in Flax's
    layout."""

    def __init__(self, model_dim: int, num_heads: int, query_dim: int, rate: float,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.mhsa = MultiHeadSelfAttention(num_heads, model_dim, compute_dtype)
        self.ffn = PositionwiseFeedForward(model_dim, model_dim, rate, compute_dtype)
        self.aw = nn.Parameter(torch.empty(model_dim, query_dim))
        self.ab = nn.Parameter(torch.empty(query_dim))
        self.aq = nn.Parameter(torch.empty(query_dim))
        self.compute_dtype = compute_dtype

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.mhsa.reset_parameters(generator)
        self.ffn.reset_parameters(generator)
        _xavier_uniform(self.aw, generator)
        _draw(self.ab, torch.zeros_like)
        _draw(self.aq, lambda t: t.uniform_(-1.0, 1.0, generator=generator))

    def forward(self, news_vecs: torch.Tensor, mask: torch.Tensor,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cd = self.compute_dtype
        h = self.ffn(self.mhsa(news_vecs, mask), deterministic, generator)
        pooled, _ = additive_attention_with_weights(
            h.to(cd), self.aw.to(cd), self.ab.to(cd), self.aq.to(cd), mask)
        return pooled


class ListRank(RecModel):
    """Two towers + a candidate-list transformer re-ranker."""

    FEAT_KEYS = ("bert", "categ", "subcateg")

    def __init__(self, cfg: ModelConfig, bert_dim: Optional[int] = None):
        super().__init__()
        if bert_dim is None:
            raise ValueError("list_rank needs the dataset's [n_news, bert_dim] 'bert' "
                             "vectors (cli bert-embeds, then preprocess --bert-npz)")
        self.cfg = cfg
        cd = self.compute_dtype = getattr(torch, cfg.compute_dtype)
        D = cfg.list_title_size
        self.category_embedding = PadEmbedding(cfg.category_nums, cfg.cate_embed_size, cd)
        self.subcategory_embedding = PadEmbedding(cfg.subcategory_nums,
                                                  cfg.cate_embed_size, cd)
        self.news_dense = Dense(bert_dim + 2 * cfg.cate_embed_size, D, cd)
        self.user_encoder = ListRankUserEncoder(D, cfg.user_heads_num,
                                                cfg.query_vector_dim_large, cfg.dropout, cd)
        self.norm = LayerNorm(2 * D, cd)
        self.iter_dense = Dense(2 * D, D, cd)
        self.n_blocks = cfg.list_layers
        # Flax's names: block0, block1, ...
        for i in range(self.n_blocks):
            self.add_module(f"block{i}", TransformerEncoderBlock(
                cfg.list_num_heads, D, cfg.list_ff_dim, cfg.dropout, cd))
        self.fc = Dense(D, 1, cd)

    @classmethod
    def from_config(cls, cfg: ModelConfig, feat_shapes=None) -> "ListRank":
        shape = (feat_shapes or {}).get("bert")
        return cls(cfg, shape[1] if shape is not None and len(shape) == 2 else None)

    @property
    def blocks(self) -> list:
        return [getattr(self, f"block{i}") for i in range(self.n_blocks)]

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in (self.category_embedding, self.subcategory_embedding, self.news_dense,
                  self.user_encoder, self.norm, self.iter_dense, *self.blocks, self.fc):
            m.reset_parameters(generator)

    def encode_user(self, browsed_vecs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """The user tower alone, without dropout: ``top_k``'s user vector."""
        return self.user_encoder(browsed_vecs, mask)

    def encode_news_feats(self, feats: Batch, deterministic: bool = True,
                          generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cd = self.compute_dtype
        parts = [feats["bert"].to(cd), self.category_embedding(feats["categ"]),
                 self.subcategory_embedding(feats["subcateg"])]
        vec = gelu(self.news_dense(torch.cat(parts, dim=-1)))
        return dropout(vec, self.cfg.dropout, deterministic, generator)

    def forward(self, batch: Batch, news_feats: Batch, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """As :meth:`RecModel.forward`, with ``generator`` handed to the
        head too: its user tower and blocks drop out in training."""
        self.aux_losses = {}
        b_ids, c_ids, b_vecs, c_vecs = self.resolve_batch(
            batch, news_feats, deterministic, generator)
        return self.score_impression(batch, b_ids, c_ids, b_vecs, c_vecs, news_feats,
                                     deterministic, generator)

    def score_impression(self, batch, browsed_ids, cand_ids, browsed_vecs,
                         cand_vecs, news_feats=None, deterministic: bool = True,
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cand_mask = (cand_ids != 0).float()
        user_vec = self.user_encoder(browsed_vecs, (browsed_ids != 0).float(),
                                     deterministic, generator)
        user_rep = user_vec[:, None, :].expand(*cand_vecs.shape[:2], user_vec.shape[-1])
        ui = gelu(self.iter_dense(self.norm(torch.cat([user_rep, cand_vecs], dim=-1))))
        ui = ui * cand_mask[..., None]      # float32 from here, as the JAX product
        for block in self.blocks:
            ui = block(ui, cand_mask, deterministic, generator)
        scores = self.fc(ui)[..., 0].float()
        return torch.where(cand_mask > 0, scores, NEG_INF)
