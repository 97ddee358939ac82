"""The port's fused encoder (``ops/fused_encoder.py``) against the JAX
package: its plain version against the Pallas kernel in interpret mode and
against the jnp chain; the wrapper's dispatch; and, on a CUDA card only,
the Hopper kernel against the plain version.

JAX is imported inside the tests that compare with it, so that the card's
tests also run where JAX is not installed; where it is, keep it on the CPU
(on a GPU its float32 products may run in TF32)::

    JAX_PLATFORMS=cpu python -m pytest --noconftest tests/test_torch_fused_encoder.py -q
"""

import pathlib

import numpy as np
import pytest
import torch

from pytorch_news_recommender_tpu_torch.ops import fused_encoder as FE

torch.set_num_threads(1)


def _inputs(seed, M, L, D, Q, pads=()):
    """Masked tokens with rows of 0..L real tokens, and weights, as numpy.
    Item 0 and the items in ``pads`` are all pad, item 1 is full (one item
    alone is full)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, L + 1, size=M)
    if M > 1:
        lens[0], lens[1] = 0, L
    else:
        lens[0] = L
    lens[list(pads)] = 0
    mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.float32)
    x = (rng.normal(size=(M, L, D)) * mask[..., None]).astype(np.float32)
    shapes = [(D, 3 * D), (3 * D,), (D, D), (D,), (D, Q), (Q,), (Q,)]
    scales = [0.05, 0.01, 0.05, 0.01, 0.05, 0.01, 0.1]
    w = [(rng.normal(size=s) * c).astype(np.float32) for s, c in zip(shapes, scales)]
    return x, mask, w, lens


def _torch_plain(x, mask, w, H):
    t = [torch.from_numpy(a) for a in (x, mask, *w)]
    return FE.fused_news_encoder_reference(
        t[0], t[1], *t[2:], num_heads=H).numpy()


@pytest.mark.parametrize("M,L,D,H,Q", [(13, 20, 64, 4, 32), (9, 50, 96, 4, 48)])
def test_plain_matches_jax_pallas_kernel(M, L, D, H, Q):
    """Rows with at least one real token; 2e-4 as the JAX package holds its
    own kernel to the jnp chain."""
    jnp = pytest.importorskip("jax.numpy")
    from pytorch_news_recommender_tpu.ops.pallas.fused_encoder import (
        fused_news_encoder as jax_fused_news_encoder,
    )
    x, mask, w, lens = _inputs(0, M, L, D, Q)
    expect = jax_fused_news_encoder(
        jnp.asarray(x), jnp.asarray(mask), *map(jnp.asarray, w), num_heads=H,
        dropout_rate=0.0, interpret=True)
    valid = lens > 0
    np.testing.assert_allclose(_torch_plain(x, mask, w, H)[valid],
                               np.asarray(expect)[valid], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("M,L,D,H,Q", [(13, 20, 64, 4, 32), (9, 50, 96, 4, 48)])
def test_plain_matches_jnp_chain_on_all_rows(M, L, D, H, Q):
    """All rows, the all-pad item included: the same float32 chain."""
    jax = pytest.importorskip("jax")
    from pytorch_news_recommender_tpu.ops import attention as JA

    @jax.jit
    def chain(x, mask, wqkv, bqkv, wo, bo, aw, ab, aq):
        h = JA.multi_head_self_attention(x, wqkv, bqkv, wo, bo, H, mask)
        return JA.additive_attention(h, aw, ab, aq, mask)

    x, mask, w, _ = _inputs(1, M, L, D, Q)
    expect = chain(x, mask, *w)
    np.testing.assert_allclose(_torch_plain(x, mask, w, H), np.asarray(expect),
                               rtol=1e-5, atol=1e-5)


def _tile_geometry(L):
    """Whole items per block of the forward's kernels and the block's token
    rows (``csrc/tiles.cuh``): ``64 // L`` items, their rows rounded up to
    16 (one item of ``L`` rounded up past 64).
    ``test_tile_geometry_is_the_kernels_on_card`` holds it to the built
    library's."""
    items = 64 // L if L <= 64 else 1
    return items, (items * L + 15) // 16 * 16


def _tile_forward(x, mask, wqkv, bqkv, wo, bo, aw, ab, aq, *, num_heads, dropout_rate=0.0,
                  seed=0):
    """Plain model of the forward kernels' tiling (``csrc/fused_encoder.cu``):
    items packed ``_tile_geometry(L)`` to a tile (zero rows past the last
    item, and zero items past M), one Rt x Rt attention per tile and head
    over the tile's block diagonal, with the penalty ``(m_i m_j - 1) * 1e9``
    within an item and ``-2e9`` between items, ``o1 = T((T(e) v) /
    rowsum(e))``; then the tail row by row and the pooling per item with the
    item's own max and ``max(den, 1e-30)``. Returns ``(out, o1)``; an
    all-pad item pools to 0."""
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
    xt, mt = f(pack(x)), f(pack(mask))
    qkv = xt @ f(wqkv) + f(bqkv)
    heads = lambda t: t.reshape(tiles, Rt, H, dh).transpose(1, 2)  # noqa: E731
    q = f(heads(qkv[..., :D] * scale).to(T))
    k = f(heads(qkv[..., D:2 * D]).to(T))
    v = f(heads(qkv[..., 2 * D:]).to(T))
    item = torch.arange(Rt) // L
    same = item[:, None] == item[None, :]
    pen = torch.where(same, (mt[:, None, :, None] * mt[:, None, None, :] - 1.0) * 1e9,
                      torch.tensor(-2e9))
    sc = q @ k.transpose(-1, -2) + pen
    e = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
    o1 = ((f(e.to(T)) @ v) / e.sum(dim=-1, keepdim=True)).to(T)
    o1 = o1.transpose(1, 2).reshape(tiles, Rt, D)[:, :items * L].reshape(-1, L, D)[:M]
    o2 = f(o1) @ f(wo) + f(bo)
    if dropout_rate > 0.0:
        keep = FE.dropout_keep(seed, M, L, D, dropout_rate)
        o2 = torch.where(keep, o2 * (1.0 / (1.0 - dropout_rate)), 0.0)
    logit = torch.tanh(f(o2.to(T)) @ f(aw) + f(ab)) @ f(aq)
    valid = f(mask) > 0
    logit = torch.where(valid, logit, -1e9)
    w = torch.where(valid, torch.exp(logit - logit.amax(dim=-1, keepdim=True)), 0.0)
    den = w.sum(-1, keepdim=True).clamp_min(1e-30)
    out = ((w[..., None] * o2).sum(1) / den).to(T)
    return out, o1


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("M,L,pads", [(7, 12, (2,)), (13, 20, (4,)), (5, 50, (2,)),
                                      (9, 7, (1, 3, 4)), (3, 70, ()), (6, 20, (3, 4, 5))])
def test_tile_grouping_equals_per_item_forward(M, L, pads, rate):
    """The exactness argument of the forward kernels' block-diagonal
    attention, on the CPU in float32: every row of ``o1``, pad rows
    included, and the pooled rows of items with a real token, within 1e-6
    of the per-item plain version's; all-pad items (inside a tile too, and
    a tile's last item) pool to exactly 0. M not a multiple of the items per
    tile, and one item past 64 rows (L=70)."""
    D, H, Q = 32, 4, 16
    x, mask, w, lens = _inputs(9, M, L, D, Q, pads)
    t = [torch.from_numpy(a) for a in (x, mask, *w)]
    expect, expect_o1 = FE.fused_news_encoder_reference(
        t[0], t[1], *t[2:], num_heads=H, dropout_rate=rate, seed=5, save_o1=True)
    got, got_o1 = _tile_forward(t[0], t[1], *t[2:], num_heads=H, dropout_rate=rate, seed=5)
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())  # noqa: E731
    assert rel(got_o1, expect_o1) < 1e-6
    valid = torch.from_numpy(lens > 0)
    assert rel(got[valid], expect[valid]) < 1e-6
    assert torch.all(got[~valid] == 0)
    # the pad rows of an item hold the mean of its v rows, not zeros
    assert float(got_o1[torch.from_numpy(mask == 0)].abs().max()) > 0


def test_cpu_tensors_take_the_plain_version_and_build_nothing():
    x, mask, w, _ = _inputs(2, 5, 20, 64, 32)
    t = [torch.from_numpy(a) for a in (x, mask, *w)]
    before = FE.fused_news_encoder.launches
    got = FE.fused_news_encoder(t[0], t[1], *t[2:], num_heads=4)
    np.testing.assert_array_equal(got.numpy(), _torch_plain(x, mask, w, 4))
    assert FE.fused_news_encoder.launches == before
    assert FE._lib.cache_info().currsize == 0


def test_other_devices_raise():
    x, mask, w, _ = _inputs(3, 2, 20, 64, 32)
    t = [torch.from_numpy(a).to("meta") for a in (x, mask, *w)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        FE.fused_news_encoder(t[0], t[1], *t[2:], num_heads=4)


def test_failed_build_raises(monkeypatch, tmp_path):
    import torch.utils.cpp_extension as ext

    def broken(**kw):
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(ext, "load", broken)
    monkeypatch.setattr(FE, "BUILD_DIR", tmp_path / "kernels")
    FE._lib.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc failed"):
        FE.build()
    assert FE._lib.cache_info().currsize == 0


def test_import_loads_no_extension():
    """Importing the port (every module) builds and loads nothing; the
    isolation test checks the same in a fresh interpreter."""
    import pytorch_news_recommender_tpu_torch.cli  # noqa: F401
    import pytorch_news_recommender_tpu_torch.serve  # noqa: F401
    assert FE._lib.cache_info().currsize == 0
    assert "newsrec_fused_encoder" not in pathlib.Path("/proc/self/maps").read_text()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# bf16: the kernel rounds where the TPU kernel does, the plain version where
# the jnp chain does; the two differ by a few bf16 steps (2^-7 at |out| ~ 1)
TOLS = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
# o1, every row, max error over the largest |o1|: the same rounding points
# as chip_smoke.py's phase 5 holds o1 to
O1_TOLS = {torch.float32: 2e-3, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,L,D,H,Q,pads", [
    (13, 20, 64, 4, 32, ()), (9, 50, 96, 4, 48, ()), (64, 20, 300, 10, 200, ()),
    (4, 50, 300, 10, 200, ()),
    # the kernels take whole items in tiles of 64 rows (5 at L=12, 3 at
    # L=20, 1 at L=50): M not a multiple of that, an all-pad item between
    # real items of one tile, an item past one tile, and the serving calls
    # of one user and of a batch of 32
    (7, 12, 300, 10, 200, ()), (13, 20, 300, 10, 200, (4,)), (4, 66, 300, 10, 200, (2,)),
    (1, 50, 300, 10, 200, ()), (32, 50, 300, 10, 200, (5,))])
def test_kernel_matches_plain_on_card(cuda_device, dtype, M, L, D, H, Q, pads):
    """The pooled rows of items with a real token, and every row of ``o1``
    (pad rows included), held to the plain version; all-pad items pool to
    exactly 0; one wrapper launch per call."""
    x, mask, w, lens = _inputs(4, M, L, D, Q, pads)
    t = [torch.from_numpy(a).to(cuda_device) for a in (x, mask, *w)]
    args = [t[0].to(dtype), t[1], *(a.to(dtype) for a in t[2:])]
    before = FE.fused_news_encoder.launches
    got, o1 = FE.fused_news_encoder(*args, num_heads=H, save_o1=True)
    torch.cuda.synchronize()
    assert FE.fused_news_encoder.launches == before + 1
    expect, expect_o1 = FE.fused_news_encoder_reference(*args, num_heads=H, save_o1=True)
    valid = torch.from_numpy(lens > 0).to(cuda_device)
    tol = TOLS[dtype]
    torch.testing.assert_close(got[valid].float(), expect[valid].float(),
                               rtol=tol, atol=tol)
    assert torch.all(got[~valid] == 0)
    o1_err = float((o1.float() - expect_o1.float()).abs().max() / expect_o1.float().abs().max())
    assert o1_err < O1_TOLS[dtype], o1_err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,L", [(13, 20), (7, 12), (5, 66), (1, 50), (600, 20)])
def test_forward_launches_are_bit_equal_on_card(cuda_device, dtype, M, L):
    """No atomics and a fixed order of every sum: repeat launches give the
    same bits, the pooled output and ``o1``, with dropout (M=600 at L=20 is
    past the tile count at which a block takes every head)."""
    D, H, Q = 300, 10, 200
    x, mask, w, _ = _inputs(8, M, L, D, Q, (3,) if M > 3 else ())
    t = [torch.from_numpy(a).to(cuda_device) for a in (x, mask, *w)]
    args = [t[0].to(dtype), t[1], *(a.to(dtype) for a in t[2:])]
    run = lambda: FE.fused_news_encoder(*args, num_heads=H, dropout_rate=0.2,  # noqa: E731
                                        seed=3, save_o1=True)
    first = run()
    for again in (run(), run()):
        assert all(torch.equal(a, b) for a, b in zip(first, again)), \
            "the forward is not deterministic"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_takes_every_length_up_to_80_at_the_model_widths_on_card(cuda_device, dtype):
    """At D=300, 10 heads, Q=200 the kernels' shared memory fits one block
    for every L up to 80 (the CUDA-core kernel before them took up to 73),
    each runs and holds the plain version, and the wrapper refuses an L that
    does not fit."""
    lib = FE._lib()
    need = lambda L: lib.newsrec_fused_encoder_smem_bytes(  # noqa: E731
        FE._DTYPE_CODE[dtype], L, 300, 10, 200)
    assert all(need(L) <= FE.MAX_SMEM for L in range(1, 81))
    assert need(112) > FE.MAX_SMEM
    for L in range(1, 81):
        x, mask, w, lens = _inputs(L, 3, L, 300, 200)
        t = [torch.from_numpy(a).to(cuda_device) for a in (x, mask, *w)]
        args = [t[0].to(dtype), t[1], *(a.to(dtype) for a in t[2:])]
        got = FE.fused_news_encoder(*args, num_heads=10)
        expect = FE.fused_news_encoder_reference(*args, num_heads=10)
        valid = torch.from_numpy(lens > 0).to(cuda_device)
        tol = TOLS[dtype]
        torch.testing.assert_close(got[valid].float(), expect[valid].float(),
                                   rtol=tol, atol=tol, msg=f"L={L}")
    x, mask, w, _ = _inputs(2, 2, 112, 300, 200)
    t = [torch.from_numpy(a).to(cuda_device) for a in (x, mask, *w)]
    with pytest.raises(ValueError, match="shared memory"):
        FE.fused_news_encoder(t[0].to(dtype), t[1], *(a.to(dtype) for a in t[2:]),
                              num_heads=10)


@pytest.mark.parametrize("L", [1, 7, 12, 20, 33, 50, 64, 65, 70, 80])
def test_tile_geometry_is_the_kernels_on_card(cuda_device, L):
    """The CPU tiling test's model of the tiles is the built kernels'."""
    assert FE.fwd_tile(L) == _tile_geometry(L)
