"""LSTUR: a CNN title encoder and a long- and short-term user encoder over
a masked GRU (port of the JAX package's ``models/lstur.py``), in plain
PyTorch, as it is plain jnp there: the family reaches no kernel.

* news tower: ``[category | subcategory | title]``, the two category
  tables with pad row 0 (``PadEmbedding``) and the title view :class:`CNNTitleEncoder`:
  word embedding -> dropout -> Flax's ``nn.Conv`` (kernel 3, SAME padding,
  ``num_filters`` out; the kernel kept in Flax's ``[3, D, F]`` layout, so
  weights copy over as they are) -> ReLU -> dropout -> additive pooling;
  news dim ``num_filters + 2·cate_embed_size`` (600 at the defaults);
* user tower: :class:`MaskedGRU` over the clicked-news vectors, the carry
  advancing only where the history is real (histories are left-padded, so
  the final carry is the last real click). ``'ini'``: the long-term user
  embedding (``user_embedding``, looked up by ``user_ids``) is the GRU's
  initial state; ``'con'``: a GRU of half the news dim from zeros,
  concatenated with a user embedding of the other half. A batch without
  ``user_ids``, and user id 0, get a zero long-term vector; a model built
  for data without users (``n_users`` 0) holds no user table and uses the
  zero vector for every user;
* dot-product scoring, padded candidates at -1e9.

LSTUR has no user tower over cached vectors alone (``encode_user``), so the
``Recommender`` refuses ``top_k`` for it, as the JAX package's fails there.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_news_recommender_tpu_torch.config import ModelConfig
from pytorch_news_recommender_tpu_torch.models.common import Batch, RecModel
from pytorch_news_recommender_tpu_torch.models.layers import (
    AdditiveAttention, Dense, PadEmbedding, WordEmbedding, _draw, _lecun_normal, dropout,
)
from pytorch_news_recommender_tpu_torch.ops.attention import dot_product_scores


class Conv1d(nn.Module):
    """Flax's ``nn.Conv(features, kernel_size=(k,), padding="SAME",
    dtype=compute_dtype)`` over ``[B, L, D]``: ``kernel [k, D, F]``
    (lecun-normal over fan-in ``k·D``), ``bias [F]`` (zeros); the operands
    in the compute dtype, the sums in float32, the result rounded to the
    compute dtype, then the bias added there."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(kernel_size, in_features, features))
        self.bias = nn.Parameter(torch.empty(features))
        self.compute_dtype = compute_dtype

    def reset_parameters(self, generator: torch.Generator) -> None:
        k, d, _ = self.kernel.shape
        _lecun_normal(self.kernel, generator, fan_in=k * d)
        _draw(self.bias, torch.zeros_like)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        k = self.kernel.shape[0]
        w = self.kernel.to(cd).float().permute(2, 1, 0)          # [F, D, k]
        # SAME: (k - 1) // 2 zeros before, the rest after
        xp = F.pad(x.to(cd).float().transpose(1, 2), ((k - 1) // 2, k // 2))
        y = F.conv1d(xp, w).transpose(1, 2)
        return y.to(cd) + self.bias.to(cd)


class CNNTitleEncoder(nn.Module):
    """Word embed -> dropout -> conv -> ReLU -> dropout -> additive pooling
    over ``ids: [..., L]`` -> ``[..., num_filters]``."""

    def __init__(self, cfg: ModelConfig, compute_dtype: torch.dtype):
        super().__init__()
        self.word_embedding = WordEmbedding(cfg.n_words, cfg.word_embed_size, compute_dtype,
                                            trainable=not cfg.freeze_word_embeddings)
        self.title_cnn = Conv1d(cfg.word_embed_size, cfg.num_filters, cfg.kernel_size,
                                compute_dtype)
        self.title_attention = AdditiveAttention(cfg.num_filters, cfg.query_vector_dim,
                                                 compute_dtype)
        self.rate = cfg.dropout

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in (self.word_embedding, self.title_cnn, self.title_attention):
            m.reset_parameters(generator)

    def forward(self, ids: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        drop = lambda t: dropout(t, self.rate, deterministic, generator)  # noqa: E731
        mask = (ids != 0).float()
        x = drop(self.word_embedding(ids, mask))
        *lead, L, D = x.shape
        h = drop(F.relu(self.title_cnn(x.reshape(-1, L, D))))
        pooled = self.title_attention(h, mask.reshape(-1, L))
        return pooled.reshape(*lead, pooled.shape[-1])


class GRUCell(nn.Module):
    """The parameters of Flax's ``nn.GRUCell`` in its layout: ``ir``,
    ``iz``, ``in`` (input, with bias; lecun-normal) and ``hr``, ``hz``
    (recurrent, no bias) and ``hn`` (recurrent, with bias), each a
    ``Dense`` in the compute dtype; recurrent kernels orthogonal."""

    def __init__(self, in_features: int, features: int, compute_dtype: torch.dtype):
        super().__init__()
        for name in ("ir", "iz", "in"):
            self.add_module(name, Dense(in_features, features, compute_dtype))
        for name, bias in (("hr", False), ("hz", False), ("hn", True)):
            self.add_module(name, Dense(features, features, compute_dtype, bias=bias))
        self.compute_dtype = compute_dtype

    def reset_parameters(self, generator: torch.Generator) -> None:
        for name in ("ir", "iz", "in", "hr", "hz", "hn"):
            dense = getattr(self, name)
            dense.reset_parameters(generator)
            if name[0] == "h":
                with torch.no_grad():
                    nn.init.orthogonal_(dense.kernel, generator=generator)

    @staticmethod
    def _dense3(denses, x: torch.Tensor, cd: torch.dtype):
        """Three Dense layers of one input as one product: each part is the
        layer's own ``x @ kernel`` (float32 sums, rounded to ``cd``), then
        its bias in ``cd``."""
        y = torch.matmul(x.to(cd).float(), torch.cat(
            [d.kernel.to(cd).float() for d in denses], dim=-1)).to(cd)
        parts = y.chunk(3, dim=-1)
        return [p if d.bias is None else p + d.bias.to(cd) for p, d in zip(parts, denses)]

    def input_products(self, x: torch.Tensor):
        """``ir(x)``, ``iz(x)``, ``in(x)`` for every step at once."""
        return self._dense3((self.ir, self.iz, getattr(self, "in")), x, self.compute_dtype)

    def step(self, h: torch.Tensor, xr: torch.Tensor, xz: torch.Tensor,
             xn: torch.Tensor) -> torch.Tensor:
        """One step of Flax's GRUCell from the step's input products:
        ``r = σ(xr + hr(h))``, ``z = σ(xz + hz(h))``, ``n = tanh(xn + r ·
        hn(h))``, ``h' = (1 − z)·n + z·h``."""
        hr, hz, hn = self._dense3((self.hr, self.hz, self.hn), h, self.compute_dtype)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        return (1.0 - z) * n + z * h


class MaskedGRU(nn.Module):
    """GRU over ``x: [B, T, D]`` whose carry advances only where ``mask [B,
    T]`` is set; returns the final carry ``[B, features]`` in the carry's
    dtype."""

    def __init__(self, in_features: int, features: int, compute_dtype: torch.dtype):
        super().__init__()
        self.cell = GRUCell(in_features, features, compute_dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.cell.reset_parameters(generator)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                init_carry: torch.Tensor) -> torch.Tensor:
        # the steps' slices as views of one unbind, whose backward stacks
        # their gradients once (indexing each would add a zeroed [B, T, H]
        # gradient per step)
        steps = zip(*(p.unbind(1) for p in self.cell.input_products(x)),
                    (mask > 0).unbind(1))
        carry = init_carry
        for xr, xz, xn, real in steps:
            new = self.cell.step(carry, xr, xz, xn).to(carry.dtype)
            carry = torch.where(real[:, None], new, carry)
        return carry


class LSTUR(RecModel):
    """CNN news tower + long- and short-term GRU user tower."""

    FEAT_KEYS = ("title", "categ", "subcateg")

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.long_short_term_method not in ("ini", "con"):
            raise ValueError(f"long_short_term_method must be ini|con, got "
                             f"{cfg.long_short_term_method!r}")
        self.cfg = cfg
        cd = self.compute_dtype = getattr(torch, cfg.compute_dtype)
        self.category_embedding = PadEmbedding(cfg.category_nums, cfg.cate_embed_size, cd)
        self.subcategory_embedding = PadEmbedding(cfg.subcategory_nums,
                                                  cfg.cate_embed_size, cd)
        self.title_encoder = CNNTitleEncoder(cfg, cd)
        self.news_dim = cfg.num_filters + 2 * cfg.cate_embed_size
        if cfg.long_short_term_method == "ini":
            self.gru_dim = self.user_embed_dim = self.news_dim
        else:
            self.gru_dim = self.news_dim // 2
            self.user_embed_dim = self.news_dim - self.gru_dim
        # the JAX family makes this table only when its data has users
        self.user_embedding = (PadEmbedding(cfg.n_users, self.user_embed_dim, cd)
                               if cfg.n_users > 0 else None)
        self.gru = MaskedGRU(self.news_dim, self.gru_dim, cd)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in (self.category_embedding, self.subcategory_embedding, self.title_encoder,
                  self.user_embedding, self.gru):
            if m is not None:
                m.reset_parameters(generator)

    def encode_news_feats(self, feats: Batch, deterministic: bool = True,
                          generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return torch.cat([self.category_embedding(feats["categ"]),
                          self.subcategory_embedding(feats["subcateg"]),
                          self.title_encoder(feats["title"], deterministic, generator)],
                         dim=-1)

    def _user_vector(self, batch: Batch, browsed_ids: torch.Tensor,
                     browsed_vecs: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        B = browsed_vecs.shape[0]
        hist_mask = (browsed_ids != 0).float()
        if "user_ids" in batch and self.user_embedding is not None:
            long_term = self.user_embedding(batch["user_ids"]).to(cd)
        else:
            long_term = torch.zeros((B, self.user_embed_dim), dtype=cd,
                                    device=browsed_vecs.device)
        if self.cfg.long_short_term_method == "ini":
            return self.gru(browsed_vecs.to(cd), hist_mask, long_term)
        init = torch.zeros((B, self.gru_dim), dtype=cd, device=browsed_vecs.device)
        return torch.cat([self.gru(browsed_vecs.to(cd), hist_mask, init), long_term], dim=-1)

    def score_impression(self, batch, browsed_ids, cand_ids, browsed_vecs,
                         cand_vecs, news_feats=None,
                         deterministic: bool = True) -> torch.Tensor:
        user_vec = self._user_vector(batch, browsed_ids, browsed_vecs)
        return dot_product_scores(user_vec, cand_vecs, cand_ids != 0)
