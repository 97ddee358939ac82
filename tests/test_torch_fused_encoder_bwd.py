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

from pytorch_news_recommender_tpu_torch.models.layers import AttentionPoolTower
from pytorch_news_recommender_tpu_torch.ops import fused_encoder as FE
from pytorch_news_recommender_tpu_torch.ops import kernels as K

torch.set_num_threads(1)


def _inputs(seed, M, L, D, Q, pads=(), scales=None):
    """Masked tokens with rows of 0..L real tokens, weights (normal, of
    standard deviation ``scales``) and a pooled cotangent, as numpy float32.
    Item 0 and the items in ``pads`` are all pad, item 1 is full."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, L + 1, size=M)
    lens[0], lens[1] = 0, L
    lens[list(pads)] = 0
    mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.float32)
    x = (rng.normal(size=(M, L, D)) * mask[..., None]).astype(np.float32)
    shapes = [(D, 3 * D), (3 * D,), (D, D), (D,), (D, Q), (Q,), (Q,)]
    # aw and ab large enough that the pooling tanh bends: the bias gradient
    # dab = -aq sum_l ds_l t_l^2 (sum_l ds_l = 0) is otherwise all rounding
    scales = scales or [0.05, 0.01, 0.05, 0.01, 0.3, 0.5, 0.1]
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


def _tile_geometry(L):
    """Whole items per block of the backward's pooling and attention kernels
    and the block's token rows (``csrc/fused_encoder_bwd.cu``): ``64 // L``
    items, their rows rounded up to 16 (one item of ``L`` rounded up past
    64). ``test_tile_geometry_is_the_kernels_on_card`` holds it to the
    built library's."""
    items = 64 // L if L <= 64 else 1
    return items, (items * L + 15) // 16 * 16


def _tile_attention_bwd(x, mask, do1, wqkv, bqkv, *, num_heads):
    """Plain model of the grouping of the attention kernel
    (``csrc/fused_encoder_bwd.cu``, ``attn_bwd``): items packed
    ``_tile_geometry(L)`` to a tile (zero rows past the last item, and zero
    items past M), one Rt x Rt attention per tile and head over the tile's
    block diagonal, with the penalty ``(m_i m_j - 1) * 1e9`` within an item
    and ``-1e9`` between items; returns ``dqkv`` ``[M, L, 3D]``."""
    T = x.dtype
    M, L, D = x.shape
    H = num_heads
    dh = D // H
    scale = 1.0 / np.sqrt(dh)
    items, Rt = _tile_geometry(L)
    tiles = -(-M // items)

    def pack(t):  # [M, L, ...] -> [tiles, Rt, ...], zeros past the last item
        t = torch.cat([t, t.new_zeros((tiles * items - M, *t.shape[1:]))])
        t = t.reshape(tiles, items * L, *t.shape[2:])
        return torch.cat([t, t.new_zeros((tiles, Rt - items * L, *t.shape[2:]))], 1)

    f = lambda t: t.float()  # noqa: E731
    xt, mt, gt = f(pack(x)), f(pack(mask)), pack(do1)
    qkv = xt @ f(wqkv) + f(bqkv)
    heads = lambda t: t.reshape(tiles, Rt, H, dh).transpose(1, 2)  # noqa: E731
    q = f(heads(qkv[..., :D] * scale).to(T))
    k = f(heads(qkv[..., D:2 * D]).to(T))
    v = f(heads(qkv[..., 2 * D:]).to(T))
    gh = f(heads(gt))
    item = torch.arange(Rt) // L
    same = item[:, None] == item[None, :]
    pen = torch.where(same, (mt[:, None, :, None] * mt[:, None, None, :] - 1.0) * 1e9,
                      torch.tensor(-1e9))
    sc = q @ k.transpose(-1, -2) + pen
    ea = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
    probs = ea / ea.sum(dim=-1, keepdim=True)
    dv = f(probs.to(T)).transpose(-1, -2) @ gh
    pdp = probs * (gh @ v.transpose(-1, -2))
    dsc = f((pdp - probs * pdp.sum(dim=-1, keepdim=True)).to(T))
    dq = (dsc @ k) * scale
    dk = dsc.transpose(-1, -2) @ q
    merge = lambda t: t.transpose(1, 2).reshape(tiles, Rt, D)  # noqa: E731
    dqkv = torch.cat([merge(dq), merge(dk), merge(dv)], dim=-1)
    return dqkv[:, :items * L].reshape(tiles * items, L, 3 * D)[:M]


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("M,L,pads", [(7, 12, (2,)), (13, 20, (4,)), (5, 50, (2,)),
                                      (9, 7, (1, 3, 4)), (3, 70, ())])
def test_tile_grouping_equals_per_item_attention(M, L, pads, rate, monkeypatch):
    """The exactness argument of the kernels' block-diagonal attention, on
    the CPU in float32: the tiled model's ``dqkv``, and the ``dx`` and
    ``dWqkv`` of the plain backward run through it, within 1e-6 of the
    per-item plain version's; all-pad items (inside a tile too) get exactly
    zero ``dx``."""
    D, H, Q = 32, 4, 16
    x, mask, w, g, _ = _inputs(9, M, L, D, Q, pads)
    tx, tm, tw, tg = *_t([x, mask]), _t(w), torch.from_numpy(g)
    _, o1 = FE.fused_news_encoder_reference(tx, tm, *tw, num_heads=H, dropout_rate=rate,
                                            seed=5, save_o1=True)
    run = lambda: FE.fused_news_encoder_bwd_reference(  # noqa: E731
        tg, tx, tm, o1, *tw, num_heads=H, dropout_rate=rate, seed=5)
    expect = run()
    per_item, seen = FE.attention_bwd_reference, {}

    def tiled(*args, num_heads):
        seen["item"] = per_item(*args, num_heads=num_heads)
        seen["tile"] = _tile_attention_bwd(*args, num_heads=num_heads)
        return seen["tile"]

    monkeypatch.setattr(FE, "attention_bwd_reference", tiled)
    got = run()
    assert _rel(seen["tile"].numpy(), seen["item"].numpy()) < 1e-6
    for name, a, b in zip(["dx", "dwqkv", "dbqkv"], got, expect):
        assert _rel(a.numpy(), b.numpy()) < 1e-6, name
    for i in (0, *pads):
        assert torch.all(got[0][i] == 0), "an all-pad item gets zero dx"
    assert float(seen["tile"].abs().max()) > 0


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
    assert K.lib.cache_info().currsize == 0


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
@pytest.mark.parametrize("M,L,D,H,Q,pads", [
    (13, 20, 64, 4, 32, ()), (9, 50, 96, 4, 48, ()), (64, 12, 300, 10, 200, ()),
    (8, 50, 300, 10, 200, ()),
    # the kernels take whole items in tiles of 64 rows (5 at L=12, 3 at
    # L=20, 1 at L=50): M not a multiple of that, and an all-pad item
    # between real items of one tile
    (7, 12, 64, 4, 32, (2,)), (13, 20, 300, 10, 200, (4,)), (5, 50, 300, 10, 200, (2,)),
    # head widths 24 (D=96, 4 heads) and 16 (D=64), an item past one tile
    (11, 20, 96, 4, 48, (4,)), (3, 70, 64, 4, 32, ()),
    # past one tile at the model's widths: pool_bwd's narrower weight tiles
    (4, 66, 300, 10, 200, (2,))])
def test_backward_kernel_matches_plain_on_card(cuda_device, dtype, rate, M, L, D, H, Q, pads):
    _backward_matches_plain(cuda_device, dtype, rate, M, L, D, H, Q, pads)


def _backward_matches_plain(cuda_device, dtype, rate, M, L, D, H, Q, pads, scales=None):
    x, mask, w, g, _ = _inputs(6, M, L, D, Q, pads, scales)
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
    for i in (0, *pads):
        assert torch.all(got[0][i] == 0), "an all-pad item gets zero dx"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("M,L,pads", [(5, 50, (2,)), (7, 20, (4,))])
def test_backward_matches_plain_at_naml_user_tower_on_card(cuda_device, dtype, rate, M, L,
                                                           pads):
    """NAML's user tower (D=800, 10 heads of 80, Q=400) in the wide
    variants, and items of 20 rows three to a tile there, with weights at
    the tower's own init scale (``AttentionPoolTower.init_scales``; at D=800
    larger scales put the bf16 rounding-point differences between the
    kernel and the plain chain alone past the tolerance, as
    ``test_bf16_rounding_points_alone_set_the_d800_input_scale`` shows for
    the forward); the checks and tolerances of
    ``test_backward_kernel_matches_plain_on_card``."""
    D, H, Q = 800, 10, 400
    _backward_matches_plain(cuda_device, dtype, rate, M, L, D, H, Q, pads,
                            AttentionPoolTower.init_scales(D, Q))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("M,L,pads", [(5, 50, (2,)), (7, 20, (4,))])
@pytest.mark.parametrize("D,H,Q", [(512, 4, 400), (600, 10, 200)])
def test_backward_matches_plain_at_bert_and_disan_user_towers_on_card(
        cuda_device, D, H, Q, dtype, rate, M, L, pads):
    """The user towers of nrms_bert (D=512, 4 heads of 128, Q=400; in f32
    attn_bwd's 64-wide weight tiles) and disan (D=600, 10 heads of 60,
    Q=200) in the wide variants, weights at the tower's init scale; the
    checks and tolerances of ``test_backward_kernel_matches_plain_on_card``,
    and two backward calls equal bit for bit."""
    _backward_matches_plain(cuda_device, dtype, rate, M, L, D, H, Q, pads,
                            AttentionPoolTower.init_scales(D, Q))
    x, mask, w, g, _ = _inputs(9, M, L, D, Q, pads, AttentionPoolTower.init_scales(D, Q))
    t = _t([x, mask, *w, g], cuda_device)
    x_, w_ = t[0].to(dtype), [a.to(dtype) for a in t[2:9]]
    _, o1 = FE.fused_news_encoder(x_, t[1], *w_, num_heads=H, dropout_rate=rate, seed=5,
                                  save_o1=True)
    bwd = lambda: FE.fused_news_encoder_bwd(t[9], x_, t[1], o1, *w_,  # noqa: E731
                                            num_heads=H, dropout_rate=rate, seed=5)
    first = bwd()
    assert all(torch.equal(a, b) for a, b in zip(first, bwd()))


@pytest.mark.parametrize("L", [1, 7, 12, 20, 33, 50, 64, 65, 70, 80])
def test_tile_geometry_is_the_kernels_on_card(cuda_device, L):
    """The CPU grouping test's model of the tiles is the built kernels'."""
    assert FE.bwd_tile(L) == _tile_geometry(L)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_takes_every_length_up_to_80_at_the_model_widths_on_card(cuda_device, dtype):
    """At D=300, 10 heads, Q=200 the kernels' shared memory fits one block
    for every L up to 80 (the CUDA-core kernels before them took up to 68),
    and the wrapper refuses an L that does not fit."""
    lib = K.lib()
    need = lambda L: lib.newsrec_fused_encoder_bwd_smem_bytes(  # noqa: E731
        K.DTYPE_CODE[dtype], L, 300, 10, 200)
    assert all(need(L) <= K.MAX_SMEM for L in range(1, 81))
    assert need(96) > K.MAX_SMEM
    x, mask, w, g, _ = _inputs(2, 2, 96, 300, 200)
    t = _t([x, mask, *w, g], cuda_device)
    w_ = [a.to(dtype) for a in t[2:9]]
    o1 = torch.zeros((2, 96, 300), dtype=dtype, device=cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        FE.fused_news_encoder_bwd(t[9], t[0].to(dtype), t[1], o1, *w_, num_heads=10)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,L", [(13, 20), (7, 12), (5, 66)])
def test_backward_launches_are_bit_equal_on_card(cuda_device, dtype, M, L):
    """No atomics and a fixed order of every sum: two backward calls on the
    same inputs give the same bits, dx and every weight gradient."""
    D, H, Q = 300, 10, 200
    x, mask, w, g, _ = _inputs(8, M, L, D, Q, (3,))
    t = _t([x, mask, *w, g], cuda_device)
    x_, w_ = t[0].to(dtype), [a.to(dtype) for a in t[2:9]]
    _, o1 = FE.fused_news_encoder(x_, t[1], *w_, num_heads=H, dropout_rate=0.2, seed=3,
                                  save_o1=True)
    run = lambda: FE.fused_news_encoder_bwd(t[9], x_, t[1], o1, *w_, num_heads=H,  # noqa: E731
                                            dropout_rate=0.2, seed=3)
    first = run()
    for again in (run(), run()):
        for a, b in zip(first, again):
            assert torch.equal(a, b), "the backward is not deterministic"


def test_bf16_training_shapes_run_on_wgmma_on_card(cuda_device):
    """One bf16 training step at NRMS's shapes (titles of 12 and 20 tokens,
    histories of 50; D=300, 10 heads, Q=200) through autograd: every
    forward and backward launch takes the wgmma engine."""
    D, H, Q = 300, 10, 200
    fns = (FE.fused_news_encoder, FE.fused_news_encoder_bwd)
    before = [(fn.launches, fn.wgmma_launches) for fn in fns]
    for L in (12, 20, 50):
        x, mask, w, g, _ = _inputs(10, 32, L, D, Q, (3,))
        ts = [torch.from_numpy(a).to(cuda_device).to(torch.bfloat16).requires_grad_()
              for a in (x, *w)]
        m = torch.from_numpy(mask).to(cuda_device)
        out = FE.fused_news_encoder(ts[0], m, *ts[1:], num_heads=H, dropout_rate=0.2, seed=1)
        (out.float() * torch.from_numpy(g).to(cuda_device)).sum().backward()
    torch.cuda.synchronize()
    counts = [(fn.launches - b[0], fn.wgmma_launches - b[1]) for fn, b in zip(fns, before)]
    assert counts == [(3, 3), (3, 3)], counts


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
# the same at NAML's user tower (D=800, Q=400): K+1 = 801 spans three of
# the kernel's 320-row output tiles
WGRAD_NAML = [(800, 2400, torch.bfloat16, True), (800, 800, torch.bfloat16, True),
              (800, 400, torch.float32, True), (400, 1, torch.float32, False)]
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
@pytest.mark.parametrize("K,N,dtype", [p[:3] for p in WGRAD_PRODUCTS + WGRAD_NAML]
                         + WGRAD_SMALL)
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


@pytest.mark.parametrize("K,N,dtype,bias", WGRAD_PRODUCTS + WGRAD_NAML)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_variants_are_bit_equal_on_card(cuda_device, dtype):
    """NAML's user tower in the wide variants: repeat forward calls (with
    dropout) and repeat backward calls give the same bits."""
    M, L, D, H, Q = 5, 50, 800, 10, 400
    x, mask, w, g, _ = _inputs(9, M, L, D, Q, (3,))
    t = _t([x, mask, *w, g], cuda_device)
    x_, w_ = t[0].to(dtype), [a.to(dtype) for a in t[2:9]]
    fwd = lambda: FE.fused_news_encoder(x_, t[1], *w_, num_heads=H,  # noqa: E731
                                        dropout_rate=0.2, seed=5, save_o1=True)
    out, o1 = fwd()
    assert all(torch.equal(a, b) for a, b in zip((out, o1), fwd()))
    bwd = lambda: FE.fused_news_encoder_bwd(t[9], x_, t[1], o1, *w_,  # noqa: E731
                                            num_heads=H, dropout_rate=0.2, seed=5)
    first = bwd()
    assert all(torch.equal(a, b) for a, b in zip(first, bwd()))
