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

from pytorch_news_recommender_tpu_torch.models.layers import AttentionPoolTower
from pytorch_news_recommender_tpu_torch.ops import fused_encoder as FE
from pytorch_news_recommender_tpu_torch.ops import kernels as K

torch.set_num_threads(1)


def _inputs(seed, M, L, D, Q, pads=(), scales=None):
    """Masked tokens with rows of 0..L real tokens, and weights (normal,
    of standard deviation ``scales``), as numpy. Item 0 and the items in
    ``pads`` are all pad, item 1 is full (one item alone is full)."""
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
    scales = scales or [0.05, 0.01, 0.05, 0.01, 0.05, 0.01, 0.1]
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
    assert K.lib.cache_info().currsize == 0


def test_cpu_calls_count_no_wgmma_launch():
    """The plain path, forward and backward, launches nothing: neither
    count moves, the wgmma count included."""
    x, mask, w, _ = _inputs(2, 5, 20, 64, 32)
    t = [torch.from_numpy(a) for a in (x, mask, *w)]
    fns = (FE.fused_news_encoder, FE.fused_news_encoder_bwd)
    before = [(fn.launches, fn.wgmma_launches) for fn in fns]
    _, o1 = FE.fused_news_encoder(t[0], t[1], *t[2:], num_heads=4, save_o1=True)
    g = torch.ones(5, 64)
    FE.fused_news_encoder_bwd(g, t[0], t[1], o1, *t[2:], num_heads=4)
    assert [(fn.launches, fn.wgmma_launches) for fn in fns] == before
    if not torch.cuda.is_available():
        assert [fn.wgmma_launches for fn in fns] == [0, 0]
    assert K.lib.cache_info().currsize == 0


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
    monkeypatch.setattr(K, "BUILD_DIR", tmp_path / "kernels")
    K.lib.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc failed"):
        K.build()
    assert K.lib.cache_info().currsize == 0


def test_import_loads_no_extension():
    """Importing the port (every module) builds and loads nothing; the
    isolation test checks the same in a fresh interpreter."""
    import pytorch_news_recommender_tpu_torch.cli  # noqa: F401
    import pytorch_news_recommender_tpu_torch.serve  # noqa: F401
    assert K.lib.cache_info().currsize == 0
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
    _kernel_matches_plain(cuda_device, dtype, M, L, D, H, Q, pads)


def _kernel_matches_plain(cuda_device, dtype, M, L, D, H, Q, pads, scales=None):
    x, mask, w, lens = _inputs(4, M, L, D, Q, pads, scales)
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
    lib = K.lib()
    need = lambda L: lib.newsrec_fused_encoder_smem_bytes(  # noqa: E731
        K.DTYPE_CODE[dtype], L, 300, 10, 200)
    assert all(need(L) <= K.MAX_SMEM for L in range(1, 81))
    assert need(112) > K.MAX_SMEM
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


# NAML's user tower: L=50, D=800, 10 heads (dh=80), Q=400
NAML_USER = (50, 800, 10, 400)
# the library's shared-memory need there, the sums of the layouts of the
# variants it takes (the headers of csrc/fused_encoder.cu and
# csrc/fused_encoder_bwd.cu): bf16 forward = fwd_tail's wide variant (o1's
# tile 103,424 + terms 51,200 + ring 55,296 + 7,168), backward = pool_bwd's
# (dpre's tiles 104,448 + ring with do2's stages 110,592 + 7,680); f32
# forward = fwd_attn with x streamed (heads 67,584 + ring 92,160 + 1,728),
# backward = dx's ring (221,184)
NAML_SMEM = {torch.bfloat16: (217_088, 222_720), torch.float32: (161_472, 221_184)}


@pytest.mark.parametrize("dtype,wide", [
    (torch.bfloat16, ("fwd_tail", "pool_bwd")),
    (torch.float32, ("fwd_attn", "fwd_tail", "pool_bwd", "attn_bwd"))])
def test_variant_chooser_widens_only_where_the_layout_does_not_fit_on_card(
        cuda_device, dtype, wide):
    """At NRMS's widths every kernel keeps its layout (no wide variant, no
    o2 scratch); at NAML's user tower the kernels whose layout does not fit
    one block take their wide variant, the forward asks for its [M * L, D]
    o2 scratch, and the library's need is then within one block."""
    lib, code = K.lib(), K.DTYPE_CODE[dtype]
    for L in (1, 12, 20, 40, 50, 64, 65, 80):
        assert FE.variant(dtype, L, 300, 10, 200) == (), L
        assert lib.newsrec_fused_encoder_fwd_o2_elems(code, 7, L, 300, 10, 200) == 0, L
    assert FE.variant(dtype, *NAML_USER) == wide
    L, D = NAML_USER[:2]
    assert lib.newsrec_fused_encoder_fwd_o2_elems(code, 7, *NAML_USER) == 7 * L * D
    need = (lib.newsrec_fused_encoder_smem_bytes(code, *NAML_USER),
            lib.newsrec_fused_encoder_bwd_smem_bytes(code, *NAML_USER))
    assert need == NAML_SMEM[dtype] and max(need) <= K.MAX_SMEM


# (dtype, L, D, H, Q) -> the engine: wgmma at every shape of the training
# cells in bf16 (NRMS's titles at 12 and 20, NAML's abstracts at 40, both
# histories and NAML's user tower at 50), mma.sync in f32 and past 64 rows
ENGINES = [(torch.bfloat16, L, 300, 10, 200, "wgmma") for L in (12, 20, 40, 50)] + [
    (torch.bfloat16, 50, 800, 10, 400, "wgmma"), (torch.bfloat16, 80, 300, 10, 200, "mma.sync"),
    (torch.float32, 20, 300, 10, 200, "mma.sync"), (torch.float32, 50, 800, 10, 400, "mma.sync")]


@pytest.mark.parametrize("dtype,L,D,H,Q,engine", ENGINES)
def test_engine_follows_dtype_and_tile_on_card(cuda_device, dtype, L, D, H, Q, engine):
    """The library reports the engine of the weight products, and a launch
    counts as a wgmma launch exactly where that is wgmma."""
    assert FE.engine(dtype, L, D, H, Q) == engine
    x, mask, w, _ = _inputs(4, 3, L, D, Q)
    t = [torch.from_numpy(a).to(cuda_device).to(dtype) for a in (x, *w)]
    m = torch.from_numpy(mask).to(cuda_device)
    fn = FE.fused_news_encoder
    before = (fn.launches, fn.wgmma_launches)
    fn(t[0], m, *t[1:], num_heads=H)
    assert (fn.launches - before[0], fn.wgmma_launches - before[1]) == (
        1, int(engine == "wgmma"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,L,pads", [(1, 50, ()), (5, 50, (2,)), (7, 20, (4,))])
def test_kernel_matches_plain_at_naml_user_tower_on_card(cuda_device, dtype, M, L, pads):
    """NAML's user tower (D=800, 10 heads of 80, Q=400) in the kernels' wide
    variants, one user, a few, and items of 20 rows three to a tile, with
    weights at the tower's own init scale (at D=800 the D=300 test scales
    put the bf16 rounding-point differences between the kernel and the
    plain chain alone past the tolerance:
    ``test_bf16_rounding_points_alone_set_the_d800_input_scale``); the
    checks and tolerances of ``test_kernel_matches_plain_on_card``."""
    D, H, Q = 800, 10, 400
    _kernel_matches_plain(cuda_device, dtype, M, L, D, H, Q, pads,
                          AttentionPoolTower.init_scales(D, Q))


# the user towers of nrms_bert (D=512, 4 heads of 128, Q=400) and disan
# (D=600, 10 heads of 60, Q=200), L=50: the variants of NAML's tower, and
# the library's need there (csrc/fused_encoder.cu's and fused_encoder_bwd.cu's
# heads): bf16 forward = fwd_tail's wide variant, backward = pool_bwd's; f32
# forward = fwd_attn with x streamed, backward = dx's ring
NEW_USER_TOWERS = [(512, 4, 400), (600, 10, 200)]
NEW_USER_SMEM = {(512, torch.bfloat16): (179_072, 221_568),
                 (512, torch.float32): (198_912, 221_184),
                 (600, torch.bfloat16): (164_512, 194_720),
                 (600, torch.float32): (148_992, 221_184)}


@pytest.mark.parametrize("dtype,wide", [
    (torch.bfloat16, ("fwd_tail", "pool_bwd")),
    (torch.float32, ("fwd_attn", "fwd_tail", "pool_bwd", "attn_bwd"))])
@pytest.mark.parametrize("D,H,Q", NEW_USER_TOWERS)
def test_variants_at_the_bert_and_disan_user_towers_on_card(cuda_device, D, H, Q, dtype,
                                                            wide):
    """At D=512 (dh=128) and D=600 (dh=60) the kernels take NAML's wide
    variants, and the library's need is then within one block."""
    lib, code = K.lib(), K.DTYPE_CODE[dtype]
    assert FE.variant(dtype, 50, D, H, Q) == wide
    need = (lib.newsrec_fused_encoder_smem_bytes(code, 50, D, H, Q),
            lib.newsrec_fused_encoder_bwd_smem_bytes(code, 50, D, H, Q))
    assert need == NEW_USER_SMEM[(D, dtype)] and max(need) <= K.MAX_SMEM


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,L,pads", [(1, 50, ()), (5, 50, (2,)), (7, 20, (4,))])
@pytest.mark.parametrize("D,H,Q", NEW_USER_TOWERS)
def test_kernel_matches_plain_at_bert_and_disan_user_towers_on_card(cuda_device, D, H, Q,
                                                                    dtype, M, L, pads):
    """The user towers of nrms_bert (heads of 128) and disan (heads of 60,
    padded to 64 per head) in the kernels' wide variants, with weights at
    the tower's own init scale; the checks and tolerances of
    ``test_kernel_matches_plain_on_card``."""
    _kernel_matches_plain(cuda_device, dtype, M, L, D, H, Q, pads,
                          AttentionPoolTower.init_scales(D, Q))


def _kernel_rounding_forward(x, mask, wqkv, bqkv, wo, bo, aw, ab, aq, *, num_heads,
                             dropout_rate=0.0, seed=0):
    """The Hopper forward's arithmetic in float32 on the CPU, rounding to
    ``x``'s dtype where the kernel does (csrc/fused_encoder.cu's head): q
    (scaled), k, v once after the bias, e before the v product, o1, T(o2)
    for the logit; o2 and the pooled sum in float32."""
    T, f = x.dtype, (lambda t: t.float())
    M, L, D = x.shape
    dh = D // num_heads
    qkv = f(x) @ f(wqkv) + f(bqkv)
    q = (qkv[..., :D] / np.sqrt(dh)).to(T).float()
    k, v = qkv[..., D:2 * D].to(T).float(), qkv[..., 2 * D:].to(T).float()
    heads = lambda t: t.reshape(M, L, num_heads, dh).transpose(1, 2)  # noqa: E731
    m = f(mask)
    s = heads(q) @ heads(k).transpose(-1, -2)
    s = s + (m[:, None, :, None] * m[:, None, None, :] - 1.0) * 1e9
    e = torch.exp(s - s.amax(-1, keepdim=True))
    o1 = (e.to(T).float() @ heads(v)) / e.sum(-1, keepdim=True)
    o2 = o1.to(T).float().transpose(1, 2).reshape(M, L, D) @ f(wo) + f(bo)
    if dropout_rate > 0.0:
        keep = FE.dropout_keep(seed, M, L, D, dropout_rate)
        o2 = torch.where(keep, o2 / (1.0 - dropout_rate), 0.0)
    logit = torch.tanh(o2.to(T).float() @ f(aw) + f(ab)) @ f(aq)
    w = torch.where(m > 0, torch.exp(logit - torch.where(m > 0, logit, -1e9).amax(
        -1, keepdim=True)), 0.0)
    return ((w[..., None] * o2).sum(1) / w.sum(-1, keepdim=True).clamp_min(1e-30)).to(T)


def test_bf16_rounding_points_alone_set_the_d800_input_scale():
    """Why NAML's user-tower checks draw weights at the tower's init scale:
    with the D=300 test scales (0.05) at D=800, the kernel's rounding points
    (``_kernel_rounding_forward``, f32 on the CPU) and the plain chain's
    differ by more than the card tests' bf16 tolerance on some pooled
    element, with no kernel in play; at the init scale they stay within it.
    At D=300 the test scales stay within it too. The shape is one of
    ``test_kernel_matches_plain_at_naml_user_tower_on_card``'s."""
    M, L, pads = 7, 20, (4,)

    def excess(D, Q, scales):
        x, mask, w, lens = _inputs(4, M, L, D, Q, pads, scales)
        t = [torch.from_numpy(a).to(torch.bfloat16) for a in (x, *w)]
        args = [t[0], torch.from_numpy(mask), *t[1:]]
        plain = FE.fused_news_encoder_reference(*args, num_heads=10).float()
        emul = _kernel_rounding_forward(*args, num_heads=10).float()
        valid = torch.from_numpy(lens > 0)
        tol = TOLS[torch.bfloat16]
        return float(((emul - plain).abs() - tol - tol * plain.abs())[valid].max())
    assert excess(800, 400, None) > 0
    assert excess(800, 400, AttentionPoolTower.init_scales(800, 400)) < 0
    assert excess(300, 200, None) < 0
