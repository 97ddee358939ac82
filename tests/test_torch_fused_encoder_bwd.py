"""The fused encoder's training half in the port (``ops/fused_encoder.py``):
the hashed dropout mask, the forward with dropout and the ``o1`` residual,
the plain backward, the autograd ``Function`` and the weight-gradient
reduction, against the JAX package's Pallas kernels in interpret mode and
against torch autograd; and, on a CUDA card only, the Hopper kernels against
their plain versions.

JAX is imported inside the tests that compare with it, so that the card's
tests also run where JAX is not installed; where it is, keep it on the CPU
(on a GPU its float32 products may run in TF32)::

    JAX_PLATFORMS=cpu python -m pytest --noconftest tests/test_torch_fused_encoder_bwd.py -q
"""

import numpy as np
import pytest
import torch

from pytorch_news_recommender_tpu_torch.ops import fused_encoder as FE

torch.set_num_threads(1)


def _inputs(seed, M, L, D, Q):
    """Masked tokens with rows of 0..L real tokens, weights and a pooled
    cotangent, as numpy float32."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, L + 1, size=M)
    lens[0], lens[1] = 0, L
    mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.float32)
    x = (rng.normal(size=(M, L, D)) * mask[..., None]).astype(np.float32)
    shapes = [(D, 3 * D), (3 * D,), (D, D), (D,), (D, Q), (Q,), (Q,)]
    # aw and ab large enough that the pooling tanh bends: the bias gradient
    # dab = -aq sum_l ds_l t_l^2 (sum_l ds_l = 0) is otherwise all rounding
    scales = [0.05, 0.01, 0.05, 0.01, 0.3, 0.5, 0.1]
    w = [(rng.normal(size=s) * c).astype(np.float32) for s, c in zip(shapes, scales)]
    g = rng.normal(size=(M, D)).astype(np.float32)
    return x, mask, w, g, lens


def _t(arrays, device="cpu"):
    return [torch.from_numpy(np.array(a)).to(device) for a in arrays]


def _rel(a, b):
    """max|a - b| / max|b|, in float64."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("L", [12, 20, 50, 1, 7, 33])
def test_block_geometry_matches_jax(L):
    from pytorch_news_recommender_tpu.ops.pallas.fused_encoder import _block_geometry
    assert FE._block_geometry(L) == _block_geometry(L)[0]


@pytest.mark.parametrize("seed,M,L,D,rate", [
    (0, 5, 12, 16, 0.2), (7, 61, 20, 8, 0.5), (2 ** 31 - 3, 30, 50, 6, 0.1),
    (123, 41, 12, 4, 0.3), (5, 3, 20, 10, 0.0)])
def test_dropout_mask_equals_jax_host_mask_bit_for_bit(seed, M, L, D, rate):
    """Includes an M that is not a multiple of the block (61 at L=20, 41 at
    L=12) and a seed whose block seeds wrap past 2^31."""
    from pytorch_news_recommender_tpu.ops.pallas.fused_encoder import host_dropout_keep
    expect = host_dropout_keep(seed, M, L, D, rate)
    got = FE.dropout_keep(seed, M, L, D, rate).numpy()
    np.testing.assert_array_equal(got, expect)
    if rate:
        assert abs(got.mean() - (1 - rate)) < 0.05


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("M,L,D,H,Q", [(13, 20, 64, 4, 32), (9, 12, 48, 4, 16)])
def test_forward_with_dropout_and_o1_matches_jax_kernel(M, L, D, H, Q, rate):
    """Pooled rows with a real token and ``o1`` on every real token, 2e-4 as
    the JAX package holds its kernel to the jnp chain (pad-token rows of
    ``o1`` take another, unused, value in the TPU kernel's packed tiles)."""
    jnp = pytest.importorskip("jax.numpy")
    from pytorch_news_recommender_tpu.ops.pallas.fused_encoder import (
        fused_news_encoder as jax_fwd,
    )
    x, mask, w, _, lens = _inputs(1, M, L, D, Q)
    out, o1 = jax_fwd(jnp.asarray(x), jnp.asarray(mask), *map(jnp.asarray, w),
                      num_heads=H, dropout_rate=rate, seed=11, save_o1=True,
                      interpret=True)
    got, got_o1 = FE.fused_news_encoder(*_t([x, mask, *w]), num_heads=H,
                                        dropout_rate=rate, seed=11, save_o1=True)
    valid = lens > 0
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(out)[valid],
                               rtol=2e-4, atol=2e-4)
    real = mask > 0
    np.testing.assert_allclose(got_o1.numpy()[real], np.asarray(o1)[real],
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("M,L,D,H,Q", [(13, 20, 64, 4, 32), (6, 50, 32, 4, 16)])
def test_plain_backward_matches_jax_kernel_on_every_row(M, L, D, H, Q, rate):
    """The all-pad items included (zero gradients on both sides); relative
    error (max|a-b| / max|b|) below 2e-3 for dx and every weight gradient."""
    jnp = pytest.importorskip("jax.numpy")
    from pytorch_news_recommender_tpu.ops.pallas.fused_encoder import (
        _bwd_pallas_call, fused_news_encoder as jax_fwd,
    )
    x, mask, w, g, _ = _inputs(2, M, L, D, Q)
    jw = list(map(jnp.asarray, w))
    _, o1 = jax_fwd(jnp.asarray(x), jnp.asarray(mask), *jw, num_heads=H,
                    dropout_rate=rate, seed=5, save_o1=True, interpret=True)
    expect = _bwd_pallas_call(jnp.asarray(g), jnp.asarray(x), jnp.asarray(mask), o1,
                              *jw, 5, num_heads=H, dropout_rate=rate, block_news=64,
                              pack_news=None, interpret=True)
    got = FE.fused_news_encoder_bwd_reference(
        *_t([g, x, mask, np.asarray(o1), *w]), num_heads=H, dropout_rate=rate, seed=5)
    for name, a, b in zip(["dx", "dwqkv", "dbqkv", "dwo", "dbo", "daw", "dab", "daq"],
                          got, expect):
        b = np.asarray(b).reshape(tuple(a.shape))
        assert _rel(a.numpy(), b) < 2e-3, name
    assert torch.all(got[0][0] == 0), "an all-pad item gets zero dx"


def _autograd_of_plain(x, mask, w, g, H, rate, seed, valid):
    """Gradients of sum(g * out) through the plain forward, pooled rows of
    all-pad items left out (their plain output is a mean, the kernel's 0)."""
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, *w)]
    out = FE.fused_news_encoder_reference(ts[0], torch.from_numpy(mask), *ts[1:],
                                          num_heads=H, dropout_rate=rate, seed=seed)
    (out * torch.from_numpy(g) * torch.from_numpy(valid[:, None])).sum().backward()
    return [t.grad for t in ts]


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("M,L,D,H,Q", [(13, 20, 64, 4, 32), (7, 12, 32, 2, 16)])
def test_plain_backward_matches_autograd(M, L, D, H, Q, rate):
    """Autograd of the plain forward with the mask baked in, on items with a
    real token: relative error below 2e-3."""
    x, mask, w, g, lens = _inputs(3, M, L, D, Q)
    valid = (lens > 0).astype(np.float32)
    expect = _autograd_of_plain(x, mask, w, g, H, rate, 9, valid)
    _, o1 = FE.fused_news_encoder_reference(*_t([x, mask, *w]), num_heads=H,
                                            dropout_rate=rate, seed=9, save_o1=True)
    got = FE.fused_news_encoder_bwd_reference(
        torch.from_numpy(g * valid[:, None]), *_t([x, mask]), o1, *_t(w),
        num_heads=H, dropout_rate=rate, seed=9)
    for a, b in zip(got, expect):
        assert _rel(a.numpy(), b.numpy()) < 2e-3


def test_function_gradients_match_autograd_on_cpu():
    M, L, D, H, Q = 9, 20, 32, 4, 16
    x, mask, w, g, lens = _inputs(4, M, L, D, Q)
    valid = (lens > 0).astype(np.float32)
    expect = _autograd_of_plain(x, mask, w, g, H, 0.2, 3, valid)
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, *w)]
    out = FE.FusedNewsEncoder.apply(ts[0], torch.from_numpy(mask), *ts[1:], 3, 0.2, H)
    (out * torch.from_numpy(g * valid[:, None])).sum().backward()
    for t, e in zip(ts, expect):
        assert _rel(t.grad.numpy(), e.numpy()) < 2e-3


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("a_dtype", [torch.float32, torch.bfloat16, None])
def test_weight_grad_plain_version(a_dtype, bias):
    """``aᵀ b`` (and with ``bias`` the column sums of ``b``) against numpy in
    float64; ``a`` None gives the column sums alone."""
    rng = np.random.default_rng(5)
    a, b = rng.normal(size=(37, 6)), rng.normal(size=(37, 10))
    bt = torch.tensor(b, dtype=torch.float32)
    if a_dtype is None:
        np.testing.assert_allclose(FE.weight_grad(None, bt, bias).numpy(), b.sum(0),
                                   rtol=1e-5, atol=1e-5)
        return
    at = torch.tensor(a, dtype=torch.float32).to(a_dtype)
    a = at.float().numpy().astype(np.float64)    # what the bf16 rounding left
    got = FE.weight_grad(at, bt, bias)
    prod = got[0] if bias else got
    np.testing.assert_allclose(prod.numpy(), a.T @ b, rtol=1e-5, atol=1e-5)
    if bias:
        np.testing.assert_allclose(got[1].numpy(), b.sum(0), rtol=1e-5, atol=1e-5)


def test_cpu_backward_builds_and_counts_nothing():
    x, mask, w, g, _ = _inputs(5, 4, 12, 16, 8)
    before = (FE.fused_news_encoder_bwd.launches, FE.weight_grad.launches)
    _, o1 = FE.fused_news_encoder(*_t([x, mask, *w]), num_heads=2, save_o1=True)
    FE.fused_news_encoder_bwd(*_t([g, x, mask]), o1, *_t(w), num_heads=2)
    assert (FE.fused_news_encoder_bwd.launches, FE.weight_grad.launches) == before
    assert FE._lib.cache_info().currsize == 0


# ---- on the card ------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


TOLS = {torch.float32: 2e-3, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("M,L,D,H,Q", [(13, 20, 64, 4, 32), (9, 50, 96, 4, 48),
                                       (64, 12, 300, 10, 200), (8, 50, 300, 10, 200)])
def test_backward_kernel_matches_plain_on_card(cuda_device, dtype, rate, M, L, D, H, Q):
    x, mask, w, g, _ = _inputs(6, M, L, D, Q)
    t = _t([x, mask, *w, g], cuda_device)
    x_, mask_, w_, g_ = t[0].to(dtype), t[1], [a.to(dtype) for a in t[2:9]], t[9]
    out, o1 = FE.fused_news_encoder(x_, mask_, *w_, num_heads=H, dropout_rate=rate,
                                    seed=17, save_o1=True)
    ref_out, ref_o1 = FE.fused_news_encoder_reference(
        x_, mask_, *w_, num_heads=H, dropout_rate=rate, seed=17, save_o1=True)
    valid = torch.from_numpy(~(mask.sum(1) == 0)).to(cuda_device)
    assert _rel(out[valid].float().cpu(), ref_out[valid].float().cpu()) < TOLS[dtype]
    got = FE.fused_news_encoder_bwd(g_, x_, mask_, o1, *w_, num_heads=H,
                                    dropout_rate=rate, seed=17)
    torch.cuda.synchronize()
    expect = FE.fused_news_encoder_bwd_reference(g_, x_, mask_, o1, *w_, num_heads=H,
                                                 dropout_rate=rate, seed=17)
    for a, b in zip(got, expect):
        assert _rel(a.float().cpu(), b.float().cpu()) < TOLS[dtype]
    assert torch.all(got[0][0] == 0), "an all-pad item gets zero dx"


def test_cuda_call_under_autograd_has_grad_fn_and_plain_gradients(cuda_device):
    """A CUDA call of the encoder with weights that require grad returns an
    output with a gradient node, and its gradients equal the plain
    version's (f32)."""
    M, L, D, H, Q = 16, 20, 64, 4, 32
    x, mask, w, g, lens = _inputs(7, M, L, D, Q)
    valid = (lens > 0).astype(np.float32)
    ts = [torch.from_numpy(a).to(cuda_device).requires_grad_() for a in (x, *w)]
    m = torch.from_numpy(mask).to(cuda_device)
    gv = torch.from_numpy(g * valid[:, None]).to(cuda_device)
    before = FE.fused_news_encoder_bwd.launches
    out = FE.fused_news_encoder(ts[0], m, *ts[1:], num_heads=H)
    assert out.grad_fn is not None
    (out * gv).sum().backward()
    assert FE.fused_news_encoder_bwd.launches == before + 1
    ps = [torch.from_numpy(a).to(cuda_device).requires_grad_() for a in (x, *w)]
    (FE.fused_news_encoder_reference(ps[0], m, *ps[1:], num_heads=H) * gv).sum().backward()
    for a, b in zip(ts, ps):
        assert _rel(a.grad.cpu(), b.grad.cpu()) < 2e-3


# the weight-gradient products of one backward call (a's width K, b's
# width N, a's dtype in bf16 training, bias): dWqkv, dWo, daw, daq
WGRAD_PRODUCTS = [(300, 900, torch.bfloat16, True), (300, 300, torch.bfloat16, True),
                  (300, 200, torch.float32, True), (200, 1, torch.float32, False)]
# small widths: a bf16 row of K=6 (12 bytes) takes 4-byte copies, K=4
# 8-byte ones; b's rows of N=10 and 8 take 8- and 16-byte copies
WGRAD_SMALL = [(6, 10, torch.bfloat16), (4, 8, torch.bfloat16)]


def _wgrad_err(got, expect):
    """max|got - expect| over the largest |expect|, every output together."""
    got = torch.cat([t.reshape(-1) for t in (got if isinstance(got, tuple) else (got,))])
    expect = torch.cat([t.reshape(-1) for t in
                        (expect if isinstance(expect, tuple) else (expect,))])
    return float((got - expect).abs().max() / expect.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("a_dtype", ["table", torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,N,dtype", [p[:3] for p in WGRAD_PRODUCTS] + WGRAD_SMALL)
@pytest.mark.parametrize("R", [25_600, 5_003, 37, 0])
def test_weight_grad_kernel_matches_plain_on_card(cuda_device, R, K, N, dtype, a_dtype, bias):
    """Every product of the backward, and two small widths, at the user
    tower's R (25,600), a ragged R, a tiny one and none; ``a`` in the
    table's dtype, and in both dtypes; the bias on and off; within 1e-4 of
    the largest output of the plain version."""
    dtype = dtype if a_dtype == "table" else a_dtype
    rng = np.random.default_rng(R + K + N)
    a = torch.tensor(rng.normal(size=(R, K)), dtype=torch.float32, device=cuda_device).to(dtype)
    b = torch.tensor(rng.normal(size=(R, N)) * 1e-3, dtype=torch.float32, device=cuda_device)
    got = FE.weight_grad(a, b, bias)
    expect = FE.weight_grad_reference(a, b, bias)
    if R == 0:
        assert all(torch.equal(t, torch.zeros_like(t)) for t in
                   (got if bias else (got,)))
        return
    assert _wgrad_err(got, expect) < 1e-4, (R, K, N, dtype, bias)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("R,N", [(25_600, 900), (5_003, 200), (37, 1)])
def test_weight_grad_column_sums_on_card(cuda_device, R, N, bias):
    """``a`` None: the column sums of ``b`` alone, whatever ``bias`` says."""
    b = torch.tensor(np.random.default_rng(R).normal(size=(R, N)), dtype=torch.float32,
                     device=cuda_device)
    got = FE.weight_grad(None, b, bias)
    assert got.shape == (N,)
    assert _wgrad_err(got, FE.weight_grad_reference(None, b)) < 1e-4


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_weight_grad_keeps_f32_accuracy_over_a_wide_range_on_card(cuda_device, dtype):
    """Rows of ``b`` spread over 1e-4 to 1e2: the high/low split holds 1e-4
    of the largest output, where one bf16 pass of the same product does
    not."""
    R, K, N = 25_600, 300, 900
    rng = np.random.default_rng(9)
    scale = 10.0 ** rng.uniform(-4, 2, size=(R, 1))
    a = torch.tensor(rng.normal(size=(R, K)), dtype=torch.float32, device=cuda_device).to(dtype)
    b = torch.tensor(rng.normal(size=(R, N)) * scale, dtype=torch.float32, device=cuda_device)
    got = FE.weight_grad(a, b, bias=True)
    expect = FE.weight_grad_reference(a, b, bias=True)
    assert _wgrad_err(got, expect) < 1e-4
    one_pass = (a.bfloat16().float().T @ b.bfloat16().float(),
                b.bfloat16().float().sum(0))
    assert _wgrad_err(one_pass, expect) > 1e-4


@pytest.mark.parametrize("K,N,dtype,bias", WGRAD_PRODUCTS)
def test_weight_grad_launches_are_bit_equal_on_card(cuda_device, K, N, dtype, bias):
    R = 5_003
    rng = np.random.default_rng(K * N)
    a = torch.tensor(rng.normal(size=(R, K)), dtype=torch.float32, device=cuda_device).to(dtype)
    b = torch.tensor(rng.normal(size=(R, N)), dtype=torch.float32, device=cuda_device)
    first = FE.weight_grad(a, b, bias)
    for again in (FE.weight_grad(a, b, bias), FE.weight_grad(a, b, bias)):
        for x, y in zip(first if bias else (first,), again if bias else (again,)):
            assert torch.equal(x, y), "weight_grad is not deterministic"


def test_backward_launches_four_weight_gradients_on_card(cuda_device):
    """One backward call: one backward launch and four weight-gradient
    launches, the bias gradients fused into three of them."""
    M, L, D, H, Q = 13, 20, 64, 4, 32
    x, mask, w, g, _ = _inputs(6, M, L, D, Q)
    t = _t([x, mask, *w, g], cuda_device)
    _, o1 = FE.fused_news_encoder(t[0], t[1], *t[2:9], num_heads=H, save_o1=True)
    before = (FE.fused_news_encoder_bwd.launches, FE.weight_grad.launches)
    FE.fused_news_encoder_bwd(t[9], t[0], t[1], o1, *t[2:9], num_heads=H)
    assert (FE.fused_news_encoder_bwd.launches, FE.weight_grad.launches) == (
        before[0] + 1, before[1] + 4)
