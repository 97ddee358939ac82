"""Attention-weight inspection (port of the JAX package's
``utils/inspect.py``).

:func:`attention_maps` scores one batch and returns the softmax weights of
every additive-attention site: each :class:`AttentionPoolTower` (the news
tower over title words, the user tower over the history) and each
:class:`AdditiveAttention`, keyed by the module's path as the JAX package
keys its ``intermediates`` (``news_encoder/tower``, ``user_encoder/tower``,
...; a site called more than once in the forward gets ``[i]`` suffixes).

The fused encoder kernels never hold the weights, so the batch runs through
the plain PyTorch chain on the model's own device and weights, with no
kernel launched, as the JAX package inspects through its jnp path: the
sites' ``forward`` is replaced on this model instance for the one call.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from pytorch_news_recommender_tpu_torch.models.layers import (
    AdditiveAttention, AttentionPoolTower,
)
from pytorch_news_recommender_tpu_torch.ops import attention as A


def _plain_tower(m: AttentionPoolTower, record: List[torch.Tensor]):
    def forward(x, mask, dropout_rate=0.0, generator=None):
        *lead, L, D = x.shape
        cd = m.compute_dtype
        x2, mask2 = x.reshape(-1, L, D).to(cd), mask.reshape(-1, L).float()
        wqkv, bqkv, wo, bo, aw, ab, aq = (p.to(cd) for p in (
            m.wqkv, m.bqkv, m.wo, m.bo, m.aw, m.ab, m.aq))
        h = A.multi_head_self_attention(x2, wqkv, bqkv, wo, bo, m.num_heads, mask2)
        out, wts = A.additive_attention_with_weights(h, aw, ab, aq, mask2)
        record.append(wts.reshape(*lead, L))
        return out.reshape(*lead, D)
    return forward


def _plain_pool(m: AdditiveAttention, record: List[torch.Tensor]):
    def forward(x, mask=None):
        cd = m.compute_dtype
        pooled, wts = A.additive_attention_with_weights(
            x.to(cd), m.w.to(cd), m.b.to(cd), (m.query - 0.1).to(cd), mask)
        record.append(wts)
        return pooled
    return forward


@torch.no_grad()
def attention_maps(model, batch, news_feats) -> Dict[str, np.ndarray]:
    """Scores ``batch`` (tensors on the model's device) deterministically
    and returns ``{site path: [..., L] float32 weights}`` for every
    additive-attention site the forward called."""
    records: Dict[str, List[torch.Tensor]] = {}
    patched = []
    for name, m in model.named_modules():
        if isinstance(m, AttentionPoolTower):
            m.forward = _plain_tower(m, records.setdefault(name.replace(".", "/"), []))
        elif isinstance(m, AdditiveAttention):
            m.forward = _plain_pool(m, records.setdefault(name.replace(".", "/"), []))
        else:
            continue
        patched.append(m)
    try:
        model(batch, news_feats, deterministic=True)
    finally:
        for m in patched:
            del m.forward
    out: Dict[str, np.ndarray] = {}
    for name, calls in records.items():
        for i, w in enumerate(calls):
            out[f"{name}[{i}]" if len(calls) > 1 else name] = w.float().cpu().numpy()
    return out


def attention_summary(maps: Dict[str, np.ndarray]) -> Dict[str, Dict[str, float]]:
    """Scalar summaries per attention site: mean and max weight, and the
    mean entropy normalised by ``log L`` (1 = uniform, 0 = one-hot)."""
    out: Dict[str, Dict[str, float]] = {}
    for name, w in maps.items():
        L = w.shape[-1]
        p = np.clip(w, 1e-12, 1.0)
        ent = -(p * np.log(p)).sum(-1) / np.log(L)
        out[name] = {
            "mean": float(w.mean()),
            "max": float(w.max()),
            "entropy": float(ent.mean()),
            "seq_len": float(L),
        }
    return out
