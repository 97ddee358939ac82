"""Attention math as plain functions on tensors.

The port of the JAX package's ``ops/attention.py``, with the same rounding
points, so that bf16 inputs round where they round there:

* scaled dot-product attention with a pairwise validity mask, the outer
  product of a 1-D mask, filled with ``-1e9``; scaling ``1/sqrt(d)`` after
  the head split;
* multi-head self-attention with a fused ``[D, 3D]`` QKV projection and an
  output projection;
* additive attention pooling ``softmax(tanh(xW + b) @ q)``;
* masked dot-product candidate scoring.

Every product accumulates in float32: bf16 operands are widened (exactly)
before the product, which is what ``preferred_element_type=float32`` does in
the JAX package. These functions are also the plain version that the fused
encoder kernel is held against (``ops/fused_encoder.py``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e9


def _mm32(eq: str, *operands: torch.Tensor) -> torch.Tensor:
    """``einsum`` in float32: bf16 operands widen exactly, the sum is f32."""
    return torch.einsum(eq, *(t.float() for t in operands))


def scaled_dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``softmax(q kᵀ / sqrt(d)) v`` over the last two axes.

    ``q, k, v``: ``[..., L, d]``; ``mask``: optional ``[..., L]`` validity
    (1 = valid), expanded to a pairwise mask whose masked scores are
    ``-1e9``. Returns ``[..., L, d]`` in ``v``'s dtype.
    """
    d = q.shape[-1]
    scores = _mm32("...qd,...kd->...qk", q, k) / math.sqrt(d)
    if mask is not None:
        m = mask.float()
        pair = m[..., :, None] * m[..., None, :]
        scores = torch.where(pair > 0, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return _mm32("...qk,...kd->...qd", probs.to(v.dtype), v).to(v.dtype)


def multi_head_self_attention(
    x: torch.Tensor,
    wqkv: torch.Tensor,
    bqkv: torch.Tensor,
    wo: torch.Tensor,
    bo: torch.Tensor,
    num_heads: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Multi-head self-attention over ``x: [..., L, D]`` with ``wqkv: [D,
    3D]`` (fused Q|K|V, used as ``x @ W``) and ``wo: [D, D]``."""
    *lead, L, D = x.shape
    dh = D // num_heads
    qkv = _mm32("...ld,de->...le", x, wqkv).to(x.dtype) + bqkv
    q, k, v = torch.split(qkv, D, dim=-1)

    def split_heads(t):
        return t.reshape(*lead, L, num_heads, dh).movedim(-2, -3)

    hmask = None if mask is None else mask[..., None, :]  # broadcast over heads
    out = scaled_dot_product_attention(
        split_heads(q), split_heads(k), split_heads(v), hmask)
    out = out.movedim(-3, -2).reshape(*lead, L, D)
    return _mm32("...ld,de->...le", out, wo).to(x.dtype) + bo


def additive_attention_with_weights(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    query: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Additive-attention pooling ``softmax(tanh(xW + b) @ q) · x``.

    ``x``: ``[..., L, D]``; ``w``: ``[D, Q]``; ``b``, ``query``: ``[Q]``.
    Returns the pooled ``[..., D]`` (``x``'s dtype) and the ``[..., L]``
    float32 softmax weights.
    """
    proj = torch.tanh(_mm32("...ld,dq->...lq", x, w) + b)
    scores = _mm32("...lq,q->...l", proj, query)
    if mask is not None:
        scores = torch.where(mask > 0, scores, NEG_INF)
    weight = torch.softmax(scores, dim=-1)
    pooled = _mm32("...l,...ld->...d", weight.to(x.dtype), x).to(x.dtype)
    return pooled, weight


def dot_product_scores(
    user_vec: torch.Tensor,
    cand_vecs: torch.Tensor,
    cand_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Click scores ``user · candidate``: ``[B, D]`` x ``[B, S, D]`` ->
    ``[B, S]`` float32, ``-1e9`` where ``cand_mask`` is 0."""
    scores = _mm32("bd,bsd->bs", user_vec, cand_vecs)
    if cand_mask is not None:
        scores = torch.where(cand_mask > 0, scores, NEG_INF)
    return scores
