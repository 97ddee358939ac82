"""``nn.Module``s of the NRMS towers and the pieces the other families share
(port of the JAX package's ``models/layers.py``).

Parameters keep Flax's names and layout, so weights carry over by a plain
copy (``models/convert.py``): ``wqkv [D, 3D]`` used as ``x @ W``, ``wo [D,
D]``, ``aw [D, Q]``, ``ab [Q]``, ``aq [Q]``, and the word table ``[n_words,
D]`` with row 0 as pad; :class:`Dense` ``kernel [in, out]``, ``bias
[out]``; :class:`AdditiveAttention` ``w [D, Q]``, ``b [Q]`` and ``query
[Q]``, stored as Flax stores it (U(0, 0.2), shifted by -0.1 at use). Each module's ``reset_parameters(generator)`` draws
Flax's initializers from a CPU ``torch.Generator``, so one seed gives the
same weights on every device.

Training: the news tower drops out the projected attention output only
(after the MHSA, as the JAX package's ``NewsEncoder``), with a mask that the
encoder hashes from one int32 seed drawn per call from an explicit
``torch.Generator`` (the JAX package draws it from ``make_rng("dropout")``)
and folded with the rank that a :class:`RankGenerator` carries
(``ops.fused_encoder.shard_seed``, as the JAX package's sharded encoder
folds ``axis_index``); the user tower has no dropout.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_news_recommender_tpu_torch.ops.attention import (
    additive_attention_with_weights, multi_head_self_attention,
)
from pytorch_news_recommender_tpu_torch.ops.fused_encoder import (
    fused_news_encoder, shard_seed,
)
from pytorch_news_recommender_tpu_torch.parallel.sharded_embedding import scheduled_lookup


class RankGenerator(torch.Generator):
    """A CPU ``torch.Generator`` that also carries the data-parallel rank of
    the step it seeds (``rank``, 0 unless set). :func:`draw_seed` folds it
    into every dropout seed drawn from it, so ranks that share the step's
    generator drop out their own rows with their own masks."""
    rank = 0


def draw_seed(generator: torch.Generator) -> int:
    """One int32 dropout seed from ``generator``, folded with its rank when
    it is a :class:`RankGenerator` (``shard_seed``)."""
    seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=generator))
    return shard_seed(seed, generator.rank if isinstance(generator, RankGenerator) else 0)


def _draw(p: torch.Tensor, fill) -> None:
    """Fills ``p`` with ``fill(cpu_tensor)``, drawn on the CPU."""
    with torch.no_grad():
        p.copy_(fill(torch.empty(p.shape, dtype=p.dtype)))


def _xavier_uniform(p: nn.Parameter, g: torch.Generator) -> None:
    a = math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
    _draw(p, lambda t: t.uniform_(-a, a, generator=g))


def _lecun_normal(p: nn.Parameter, g: torch.Generator,
                  fan_in: Optional[int] = None) -> None:
    """Flax's ``lecun_normal``: a normal truncated at 2 standard deviations,
    scaled so that its variance is ``1 / fan_in`` (``p``'s first axis
    unless given)."""
    std = math.sqrt(1.0 / (fan_in or p.shape[0])) / 0.87962566103423978
    _draw(p, lambda t: nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                             generator=g))


def dropout(x: torch.Tensor, rate: float, deterministic: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Flax's ``nn.Dropout``: ``x / (1 - rate)`` where kept, 0 elsewhere, in
    ``x``'s dtype; ``x`` itself when ``deterministic`` or ``rate`` is 0. The
    mask is drawn where ``x`` lies, from a seed of ``generator`` (another
    stream than the JAX package's ``make_rng``) by :func:`draw_seed`, so
    each call is one draw, folded with the generator's rank."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout needs a torch.Generator for its seed")
    seed = draw_seed(generator)
    drawn = torch.Generator(device=x.device).manual_seed(seed)
    keep = torch.rand(x.shape, generator=drawn, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


class Dense(nn.Module):
    """``x @ kernel (+ bias)`` in the compute dtype, in Flax's layout
    (``kernel [in, out]``, lecun-normal; ``bias [out]``, zeros, unless
    ``bias`` is off); the product sums in float32."""

    def __init__(self, in_features: int, out_features: int,
                 compute_dtype: torch.dtype, bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None
        self.compute_dtype = compute_dtype

    def reset_parameters(self, generator: torch.Generator) -> None:
        _lecun_normal(self.kernel, generator)
        if self.bias is not None:
            _draw(self.bias, torch.zeros_like)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        y = torch.matmul(x.to(cd).float(), self.kernel.to(cd).float()).to(cd)
        return y if self.bias is None else y + self.bias.to(cd)


class PadEmbedding(nn.Module):
    """Table whose row 0 is pad: ids 0 look up zeros, so row 0 gets a zero
    gradient (torch's ``padding_idx=0``, done by the mask). Every row is
    drawn ~N(0, 1), as Flax's ``normal(1.0)``. The lookup is in the compute
    dtype. Category, subcategory, user and entity tables; the entity table,
    when row-sharded over the model axis (``row_block``), looks up through
    the psum path (``parallel/sharded_embedding.py``)."""

    def __init__(self, num: int, dim: int, compute_dtype: torch.dtype):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num, dim))
        self.compute_dtype = compute_dtype
        self.row_block = self.mesh = None

    def reset_parameters(self, generator: torch.Generator) -> None:
        _draw(self.embedding, lambda t: t.normal_(generator=generator))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        return scheduled_lookup(self.embedding, ids, (ids != 0).to(cd), cd,
                                block=self.row_block, mesh=self.mesh)


class LayerNorm(nn.Module):
    """Flax's ``nn.LayerNorm(dtype=compute_dtype)`` over the last axis, in
    its layout and arithmetic: ``scale`` (ones) and ``bias`` (zeros) in
    float32; the statistics reduced in float32 with the fast variance
    ``E[x²] − E[x]²`` clamped at 0, each mean a float32 sum times the
    float32 ``1/n`` (as XLA lowers a mean); ``epsilon`` 1e-6; ``(x − mean) ·
    (rsqrt(var + eps) · scale) + bias`` in float32, returned in the compute
    dtype. (``torch.nn.LayerNorm`` names its parameters ``weight``, takes
    eps 1e-5 and the two-pass variance.)"""

    def __init__(self, dim: int, compute_dtype: torch.dtype, epsilon: float = 1e-6):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))
        self.compute_dtype = compute_dtype
        self.epsilon = epsilon

    def reset_parameters(self, generator: torch.Generator) -> None:
        _draw(self.scale, torch.ones_like)
        _draw(self.bias, torch.zeros_like)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        inv_n = 1.0 / xf.shape[-1]
        mean = xf.sum(-1, keepdim=True) * inv_n
        var = ((xf * xf).sum(-1, keepdim=True) * inv_n - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + self.epsilon) * self.scale.float()
        return ((xf - mean) * mul + self.bias.float()).to(self.compute_dtype)


class AdditiveAttention(nn.Module):
    """``softmax(tanh(xW + b) @ q)``-weighted pooling over the second-last
    axis of ``x: [..., L, D]`` (plain PyTorch, no kernel). ``query`` is
    stored U(0, 0.2) and used as ``query - 0.1``, as the Flax module keeps
    it, so that its weights carry over by a plain copy."""

    def __init__(self, in_features: int, query_dim: int,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.w = nn.Parameter(torch.empty(in_features, query_dim))
        self.b = nn.Parameter(torch.empty(query_dim))
        self.query = nn.Parameter(torch.empty(query_dim))
        self.compute_dtype = compute_dtype

    def reset_parameters(self, generator: torch.Generator) -> None:
        _xavier_uniform(self.w, generator)
        _draw(self.b, torch.zeros_like)
        _draw(self.query, lambda t: t.uniform_(0.0, 0.2, generator=generator))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        cd = self.compute_dtype
        pooled, _ = additive_attention_with_weights(
            x.to(cd), self.w.to(cd), self.b.to(cd), (self.query - 0.1).to(cd), mask)
        return pooled


class WordEmbedding(nn.Module):
    """Word table, row 0 = pad; pad positions are zeroed by the mask.
    Initialized ~N(0, 1) with a zero pad row. Its gradient is the float32
    scatter-add of ``g * mask`` (taken in the compute dtype) over the looked
    up rows, as the JAX package's masked lookup gives; with ``trainable``
    off the table gets no gradient. The plain lookup is ``F.embedding``,
    whose backward sums each row's duplicates as segments after one sort
    (the backward of ``table[ids]`` took 27 ms a step at batch 512 on an
    H100: PERF.md). Under a model axis the lookup follows
    ``embedding_lookup`` (``auto`` | ``psum`` | ``a2a``, with
    ``a2a_capacity_factor``; ``parallel/sharded_embedding.py``), on the
    rank's row block when the table is sharded (``row_block``), over the
    process mesh that ``shard_tables`` gave it (``mesh``)."""

    def __init__(self, n_words: int, embed_size: int, compute_dtype: torch.dtype,
                 trainable: bool = True, embedding_lookup: str = "auto",
                 a2a_capacity_factor: float = 2.0):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(n_words, embed_size))
        self.compute_dtype = compute_dtype
        self.trainable = trainable
        self.embedding_lookup = embedding_lookup
        self.a2a_capacity_factor = a2a_capacity_factor
        self.row_block = self.mesh = None

    def reset_parameters(self, generator: torch.Generator) -> None:
        _draw(self.embedding, lambda t: t.normal_(generator=generator))
        with torch.no_grad():
            self.embedding[0] = 0.0

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        table = self.embedding if self.trainable else self.embedding.detach()
        return scheduled_lookup(table, ids, mask, self.compute_dtype, self.embedding_lookup,
                                self.a2a_capacity_factor, self.row_block, self.mesh)


class AttentionPoolTower(nn.Module):
    """Multi-head self-attention + (dropout) + additive pooling over
    ``[..., L, D]`` through :func:`fused_news_encoder` (the kernels on a
    CUDA device, forward and, under autograd, backward; the plain version on
    the CPU). The shared core of the news tower (L = title words) and the
    user tower (L = history length)."""

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

    @staticmethod
    def init_scales(D: int, Q: int) -> list:
        """The standard deviations of :meth:`reset_parameters`'s draws at
        widths ``D``, ``Q``, in the order wqkv, bqkv, wo, bo, aw, ab, aq:
        Xavier-uniform matrices, sqrt(2 / (fan_in + fan_out)), and aq uniform
        on ±0.1. The biases start at 0; 0.01 stands for them, a trained
        bias's scale, so that weights drawn at these scales exercise them."""
        return [math.sqrt(2 / (4 * D)), 0.01, math.sqrt(2 / (2 * D)), 0.01,
                math.sqrt(2 / (D + Q)), 0.01, 0.1 / math.sqrt(3)]

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                dropout_rate: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``dropout_rate > 0`` needs ``generator``, which gives the call's
        dropout seed."""
        *lead, L, D = x.shape
        cd = self.compute_dtype
        seed = 0
        if dropout_rate > 0.0:
            if generator is None:
                raise ValueError("dropout needs a torch.Generator for its seed")
            seed = draw_seed(generator)
        weights = [p.to(cd) for p in (self.wqkv, self.bqkv, self.wo, self.bo,
                                      self.aw, self.ab, self.aq)]
        out = fused_news_encoder(x.reshape(-1, L, D).to(cd),
                                 mask.reshape(-1, L).float(), *weights,
                                 num_heads=self.num_heads,
                                 dropout_rate=dropout_rate, seed=seed)
        return out.reshape(*lead, D)


class NewsEncoder(nn.Module):
    """Word-level news tower: embed -> MHSA -> dropout -> pool, over ``ids:
    [..., L]`` with any leading shape; dropout only when not
    ``deterministic``."""

    def __init__(self, n_words: int, word_embed_size: int, num_heads: int,
                 query_dim: int, compute_dtype: torch.dtype, dropout: float = 0.2,
                 freeze_embeddings: bool = False, embedding_lookup: str = "auto",
                 a2a_capacity_factor: float = 2.0):
        super().__init__()
        self.word_embedding = WordEmbedding(n_words, word_embed_size, compute_dtype,
                                            trainable=not freeze_embeddings,
                                            embedding_lookup=embedding_lookup,
                                            a2a_capacity_factor=a2a_capacity_factor)
        self.tower = AttentionPoolTower(word_embed_size, num_heads, query_dim,
                                        compute_dtype)
        self.dropout = dropout

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.word_embedding.reset_parameters(generator)
        self.tower.reset_parameters(generator)

    def forward(self, ids: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        mask = (ids != 0).float()
        return self.tower(self.word_embedding(ids, mask), mask,
                          0.0 if deterministic else self.dropout, generator)


class UserEncoder(nn.Module):
    """User tower: MHSA + pooling over the clicked-news vectors ``[B, H,
    D]`` with their ``[B, H]`` mask; no dropout."""

    def __init__(self, model_dim: int, num_heads: int, query_dim: int,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.tower = AttentionPoolTower(model_dim, num_heads, query_dim,
                                        compute_dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.tower.reset_parameters(generator)

    def forward(self, news_vecs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return self.tower(news_vecs, mask)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Flax's ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class MultiHeadSelfAttention(nn.Module):
    """Self-attention with a fused QKV projection and an output projection,
    in Flax's layout (``wqkv [D, 3D]``, ``bqkv``, ``wo [D, D]``, ``bo``;
    Xavier-uniform matrices, zero biases), through the plain
    ``ops/attention.multi_head_self_attention``: the JAX module never calls
    a Pallas kernel (its ``use_pallas`` field is unused). ``D`` must be a
    multiple of ``num_heads``, as the JAX module asserts."""

    def __init__(self, num_heads: int, model_dim: int, compute_dtype: torch.dtype):
        super().__init__()
        D = model_dim
        if D % num_heads:
            raise ValueError(f"model dim {D} is not divisible by {num_heads} heads")
        self.num_heads = num_heads
        self.compute_dtype = compute_dtype
        self.wqkv = nn.Parameter(torch.empty(D, 3 * D))
        self.bqkv = nn.Parameter(torch.empty(3 * D))
        self.wo = nn.Parameter(torch.empty(D, D))
        self.bo = nn.Parameter(torch.empty(D))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.wqkv, self.wo):
            _xavier_uniform(w, generator)
        for b in (self.bqkv, self.bo):
            _draw(b, torch.zeros_like)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        cd = self.compute_dtype
        return multi_head_self_attention(
            x.to(cd), self.wqkv.to(cd), self.bqkv.to(cd), self.wo.to(cd),
            self.bo.to(cd), self.num_heads, mask)


class PositionwiseFeedForward(nn.Module):
    """GELU FFN with a residual and LayerNorm: ``norm(x + drop(fc2(drop(
    gelu(fc1(x))))))``."""

    def __init__(self, model_dim: int, hidden_dim: int, rate: float,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.fc1 = Dense(model_dim, hidden_dim, compute_dtype)
        self.fc2 = Dense(hidden_dim, model_dim, compute_dtype)
        self.norm = LayerNorm(model_dim, compute_dtype)
        self.rate = rate

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in (self.fc1, self.fc2, self.norm):
            m.reset_parameters(generator)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        drop = lambda t: dropout(t, self.rate, deterministic, generator)  # noqa: E731
        h = drop(self.fc2(drop(gelu(self.fc1(x)))))
        return self.norm(x + h)


class TransformerEncoderBlock(nn.Module):
    """MHSA -> dropout -> ``norm(x + h)`` -> :class:`PositionwiseFeedForward`
    (the listwise re-ranker's block)."""

    def __init__(self, num_heads: int, model_dim: int, ff_dim: int, rate: float,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.mhsa = MultiHeadSelfAttention(num_heads, model_dim, compute_dtype)
        self.norm = LayerNorm(model_dim, compute_dtype)
        self.ffn = PositionwiseFeedForward(model_dim, ff_dim, rate, compute_dtype)
        self.rate = rate

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in (self.mhsa, self.norm, self.ffn):
            m.reset_parameters(generator)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = dropout(self.mhsa(x, mask), self.rate, deterministic, generator)
        x = self.norm(x + h)
        return self.ffn(x, deterministic, generator)
