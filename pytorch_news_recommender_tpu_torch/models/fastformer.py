"""Fastformer: an additive-attention transformer news recommender (Wu et
al. 2021; port of the JAX package's ``models/fastformer.py``), in plain
PyTorch, as it is plain jnp there: the family reaches no kernel.

* :class:`FastformerLayer`: per head, a softmax over the tokens pools the
  query rows into one global query, which scales the keys; a second
  softmax pools those into a global key, which scales the values; an
  output Dense, the query residual and a LayerNorm. Linear in the title
  length, no ``L x L`` scores;
* news tower: word embedding -> dropout -> ``fastformer_layers`` layers
  (each followed by dropout) -> additive pooling;
* user tower: the same stack (its own weights, ``user_heads_num`` heads, no
  dropout) over the clicked-news vectors; dot-product scoring.

The family has no ``user_encoder`` attribute, so the JAX ``Recommender``'s
``top_k`` fails for it (``AttributeError``); the port's has no
``encode_user`` and refuses ``top_k`` with a ``ValueError`` naming the
family (ROADMAP C).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from pytorch_news_recommender_tpu_torch.config import ModelConfig
from pytorch_news_recommender_tpu_torch.models.common import Batch, RecModel
from pytorch_news_recommender_tpu_torch.models.layers import (
    AdditiveAttention, Dense, LayerNorm, WordEmbedding, _xavier_uniform, dropout,
)
from pytorch_news_recommender_tpu_torch.ops.attention import NEG_INF, dot_product_scores


def _head_softmax(logits: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """``logits [..., L, H]`` -> softmax over ``L`` with ``mask [..., L]``."""
    if mask is not None:
        logits = torch.where(mask[..., None] > 0, logits, NEG_INF)
    return torch.softmax(logits, dim=-2)


class FastformerLayer(nn.Module):
    """One multi-head Fastformer block with LayerNorm, in Flax's layout:
    Dense ``query``, ``key``, ``value``, ``out`` ``[D, D]``; ``wq``, ``wk``
    ``[H, dh]`` (Xavier-uniform); ``norm``."""

    def __init__(self, model_dim: int, num_heads: int, compute_dtype: torch.dtype):
        super().__init__()
        D, H = model_dim, num_heads
        if D % H:
            raise ValueError(f"model dim {D} is not divisible by {H} heads")
        self.num_heads = H
        self.compute_dtype = compute_dtype
        for name in ("query", "key", "value"):
            self.add_module(name, Dense(D, D, compute_dtype))
        self.wq = nn.Parameter(torch.empty(H, D // H))
        self.wk = nn.Parameter(torch.empty(H, D // H))
        self.out = Dense(D, D, compute_dtype)
        self.norm = LayerNorm(D, compute_dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        # Flax's order of first use: query, key, value, wq, wk, out, norm
        for name in ("query", "key", "value"):
            getattr(self, name).reset_parameters(generator)
        _xavier_uniform(self.wq, generator)
        _xavier_uniform(self.wk, generator)
        self.out.reset_parameters(generator)
        self.norm.reset_parameters(generator)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        cd = self.compute_dtype
        *lead, L, D = x.shape
        H = self.num_heads
        dh = D // H
        # 1 / sqrt(dh), the root rounded to the compute dtype and the
        # quotient taken there, as the JAX layer's scale
        scale = float(1.0 / torch.tensor(math.sqrt(dh)).to(cd))
        xc = x.to(cd)
        q, k, v = (getattr(self, n)(xc).reshape(*lead, L, H, dh)
                   for n in ("query", "key", "value"))

        def pool(t, w):
            """The global vector of ``t [..., L, H, dh]`` under the query
            ``w [H, dh]``: ``[..., H, dh]`` in the compute dtype."""
            logits = torch.einsum("...lhd,hd->...lh", t.float(), w.to(cd).float()) * scale
            alpha = _head_softmax(logits, mask)
            return torch.einsum("...lh,...lhd->...hd", alpha.to(cd).float(),
                                t.float()).to(cd)

        g = pool(q, self.wq)                            # the global query
        p = g[..., None, :, :] * k                      # [..., L, H, dh]
        kg = pool(p, self.wk)                           # the global key
        u = (kg[..., None, :, :] * v).reshape(*lead, L, D)
        return self.norm(self.out(u) + q.reshape(*lead, L, D))


class _Tower(nn.Module):
    """The Fastformer stack + additive-attention pooling (``pool``)."""

    def __init__(self, model_dim: int, num_heads: int, num_layers: int, query_dim: int,
                 rate: float, compute_dtype: torch.dtype):
        super().__init__()
        self.n_layers = num_layers
        # Flax's names: layer0, layer1, ...
        for i in range(num_layers):
            self.add_module(f"layer{i}", FastformerLayer(model_dim, num_heads, compute_dtype))
        self.pool = AdditiveAttention(model_dim, query_dim, compute_dtype)
        self.rate = rate

    def reset_parameters(self, generator: torch.Generator) -> None:
        for i in range(self.n_layers):
            getattr(self, f"layer{i}").reset_parameters(generator)
        self.pool.reset_parameters(generator)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for i in range(self.n_layers):
            x = dropout(getattr(self, f"layer{i}")(x, mask), self.rate, deterministic,
                        generator)
        return self.pool(x, mask)


class Fastformer(RecModel):
    """Title-only Fastformer news and user towers, dot-product scoring."""

    FEAT_KEYS = ("title",)

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        cd = getattr(torch, cfg.compute_dtype)
        D = cfg.word_embed_size
        self.word_embedding = WordEmbedding(cfg.n_words, D, cd,
                                            trainable=not cfg.freeze_word_embeddings)
        self.news_tower = _Tower(D, cfg.num_attention_heads, cfg.fastformer_layers,
                                 cfg.query_vector_dim, cfg.dropout, cd)
        self.user_tower = _Tower(D, cfg.user_heads_num, cfg.fastformer_layers,
                                 cfg.query_vector_dim, 0.0, cd)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in (self.word_embedding, self.news_tower, self.user_tower):
            m.reset_parameters(generator)

    def encode_news_feats(self, feats: Batch, deterministic: bool = True,
                          generator: Optional[torch.Generator] = None) -> torch.Tensor:
        ids = feats["title"]
        mask = (ids != 0).float()
        x = dropout(self.word_embedding(ids, mask), self.cfg.dropout, deterministic,
                    generator)
        return self.news_tower(x, mask, deterministic, generator)

    def score_impression(self, batch, browsed_ids, cand_ids, browsed_vecs,
                         cand_vecs, news_feats=None,
                         deterministic: bool = True) -> torch.Tensor:
        user_vec = self.user_tower(browsed_vecs, (browsed_ids != 0).float())
        return dot_product_scores(user_vec, cand_vecs, cand_ids != 0)
