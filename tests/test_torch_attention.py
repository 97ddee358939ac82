"""The port's attention ops against the JAX package's ``ops/attention.py`` on
partly padded inputs, in float32 (tolerance 1e-5: both sides compute the
same float32 chain, summed in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_news_recommender_tpu.ops import attention as JA
from pytorch_news_recommender_tpu_torch.ops import attention as TA

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _mask(rng, B, L):
    lens = rng.integers(0, L + 1, size=B)
    lens[0], lens[1] = 0, L       # one all-pad row, one full row
    return (np.arange(L)[None, :] < lens[:, None]).astype(np.float32)


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])


def test_scaled_dot_product_attention():
    rng = np.random.default_rng(0)
    B, H, L, d = 5, 3, 12, 8
    q, k, v = (rng.normal(size=(B, H, L, d)).astype(np.float32) for _ in range(3))
    mask = _mask(rng, B, L)[:, None, :]
    (jq, jk, jv, jm), (tq, tk, tv, tm) = _both(q, k, v, mask)
    np.testing.assert_allclose(
        TA.scaled_dot_product_attention(tq, tk, tv, tm).numpy(),
        np.asarray(JA.scaled_dot_product_attention(jq, jk, jv, jm)), **TOL)


@pytest.mark.parametrize("B,L,D,H", [(6, 20, 64, 4), (4, 50, 96, 4)])
def test_multi_head_self_attention(B, L, D, H):
    rng = np.random.default_rng(1)
    mask = _mask(rng, B, L)
    x = (rng.normal(size=(B, L, D)) * mask[..., None]).astype(np.float32)
    wqkv = (rng.normal(size=(D, 3 * D)) * 0.05).astype(np.float32)
    bqkv = (rng.normal(size=(3 * D,)) * 0.01).astype(np.float32)
    wo = (rng.normal(size=(D, D)) * 0.05).astype(np.float32)
    bo = (rng.normal(size=(D,)) * 0.01).astype(np.float32)
    j, t = _both(x, wqkv, bqkv, wo, bo, mask)
    np.testing.assert_allclose(
        TA.multi_head_self_attention(*t[:5], H, t[5]).numpy(),
        np.asarray(JA.multi_head_self_attention(*j[:5], H, j[5])), **TOL)


def test_additive_attention_with_weights():
    rng = np.random.default_rng(2)
    B, L, D, Q = 7, 20, 64, 32
    mask = _mask(rng, B, L)
    x = rng.normal(size=(B, L, D)).astype(np.float32)
    w = (rng.normal(size=(D, Q)) * 0.05).astype(np.float32)
    b = (rng.normal(size=(Q,)) * 0.01).astype(np.float32)
    q = (rng.normal(size=(Q,)) * 0.1).astype(np.float32)
    j, t = _both(x, w, b, q, mask)
    t_pooled, t_w = TA.additive_attention_with_weights(*t)
    j_pooled, j_w = JA.additive_attention_with_weights(*j)
    np.testing.assert_allclose(t_pooled.numpy(), np.asarray(j_pooled), **TOL)
    np.testing.assert_allclose(t_w.numpy(), np.asarray(j_w), **TOL)


def test_dot_product_scores():
    rng = np.random.default_rng(3)
    B, S, D = 4, 9, 64
    user = rng.normal(size=(B, D)).astype(np.float32)
    cands = rng.normal(size=(B, S, D)).astype(np.float32)
    cmask = _mask(rng, B, S)
    j, t = _both(user, cands, cmask)
    got = TA.dot_product_scores(*t).numpy()
    np.testing.assert_allclose(got, np.asarray(JA.dot_product_scores(*j)), **TOL)
    assert np.all(got[cmask == 0] == TA.NEG_INF)
