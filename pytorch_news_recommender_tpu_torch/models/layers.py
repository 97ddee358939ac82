"""``nn.Module``s of the NRMS towers (port of the JAX package's
``models/layers.py``).

Parameters keep Flax's names and layout, so weights carry over by a plain
copy (``models/convert.py``): ``wqkv [D, 3D]`` used as ``x @ W``, ``wo [D,
D]``, ``aw [D, Q]``, ``ab [Q]``, ``aq [Q]``, and the word table ``[n_words,
D]`` with row 0 as pad. Each module's ``reset_parameters(generator)`` draws
Flax's initializers from a CPU ``torch.Generator``, so one seed gives the
same weights on every device.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from pytorch_news_recommender_tpu_torch.ops.fused_encoder import fused_news_encoder


def _draw(p: torch.Tensor, fill) -> None:
    """Fills ``p`` with ``fill(cpu_tensor)``, drawn on the CPU."""
    with torch.no_grad():
        p.copy_(fill(torch.empty(p.shape, dtype=p.dtype)))


def _xavier_uniform(p: nn.Parameter, g: torch.Generator) -> None:
    a = math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
    _draw(p, lambda t: t.uniform_(-a, a, generator=g))


class WordEmbedding(nn.Module):
    """Word table, row 0 = pad; pad positions are zeroed by the mask.
    Initialized ~N(0, 1) with a zero pad row."""

    def __init__(self, n_words: int, embed_size: int, compute_dtype: torch.dtype):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(n_words, embed_size))
        self.compute_dtype = compute_dtype

    def reset_parameters(self, generator: torch.Generator) -> None:
        _draw(self.embedding, lambda t: t.normal_(generator=generator))
        with torch.no_grad():
            self.embedding[0] = 0.0

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        return self.embedding[ids.long()].to(cd) * mask[..., None].to(cd)


class AttentionPoolTower(nn.Module):
    """Multi-head self-attention + additive pooling over ``[..., L, D]``
    through :func:`fused_news_encoder` (the kernel on a CUDA device, its
    plain version on the CPU). The shared core of the news tower (L = title
    words) and the user tower (L = history length)."""

    def __init__(self, model_dim: int, num_heads: int, query_dim: int,
                 compute_dtype: torch.dtype):
        super().__init__()
        D, Q = model_dim, query_dim
        if D % num_heads:
            raise ValueError(f"model dim {D} is not divisible by {num_heads} heads")
        self.num_heads = num_heads
        self.compute_dtype = compute_dtype
        self.wqkv = nn.Parameter(torch.empty(D, 3 * D))
        self.bqkv = nn.Parameter(torch.empty(3 * D))
        self.wo = nn.Parameter(torch.empty(D, D))
        self.bo = nn.Parameter(torch.empty(D))
        self.aw = nn.Parameter(torch.empty(D, Q))
        self.ab = nn.Parameter(torch.empty(Q))
        self.aq = nn.Parameter(torch.empty(Q))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.wqkv, self.wo, self.aw):
            _xavier_uniform(w, generator)
        for b in (self.bqkv, self.bo, self.ab):
            _draw(b, torch.zeros_like)
        _draw(self.aq, lambda t: t.uniform_(-0.1, 0.1, generator=generator))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        *lead, L, D = x.shape
        cd = self.compute_dtype
        weights = [p.to(cd) for p in (self.wqkv, self.bqkv, self.wo, self.bo,
                                      self.aw, self.ab, self.aq)]
        out = fused_news_encoder(x.reshape(-1, L, D).to(cd),
                                 mask.reshape(-1, L).float(), *weights,
                                 num_heads=self.num_heads)
        return out.reshape(*lead, D)


class NewsEncoder(nn.Module):
    """Word-level news tower: embed -> MHSA -> pool, over ``ids: [..., L]``
    with any leading shape (serving: no dropout)."""

    def __init__(self, n_words: int, word_embed_size: int, num_heads: int,
                 query_dim: int, compute_dtype: torch.dtype):
        super().__init__()
        self.word_embedding = WordEmbedding(n_words, word_embed_size, compute_dtype)
        self.tower = AttentionPoolTower(word_embed_size, num_heads, query_dim,
                                        compute_dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.word_embedding.reset_parameters(generator)
        self.tower.reset_parameters(generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        mask = (ids != 0).float()
        return self.tower(self.word_embedding(ids, mask), mask)


class UserEncoder(nn.Module):
    """User tower: MHSA + pooling over the clicked-news vectors ``[B, H,
    D]`` with their ``[B, H]`` mask."""

    def __init__(self, model_dim: int, num_heads: int, query_dim: int,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.tower = AttentionPoolTower(model_dim, num_heads, query_dim,
                                        compute_dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.tower.reset_parameters(generator)

    def forward(self, news_vecs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return self.tower(news_vecs, mask)
