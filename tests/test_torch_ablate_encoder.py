"""The port's stage ablation of the fused encoder (``ops/ablate_encoder.py``)
against the JAX package's harness ``benchmarks/ablate_encoder.py``: each of
its six Pallas bodies, run through its own ``build`` in interpret mode on
the CPU, against the port's plain version on the same inputs; the slice as a
whole through ``chip_ablate_encoder.py``'s table; the semantics that are
easy to miss (an all-pad row attends over its whole 160-row subtile, V2b
mixes a subtile's items); the wrapper's checks; and, on a CUDA card only,
the Hopper kernels against the plain version.

JAX is imported inside the tests that compare with it; where it is
installed on a card's machine, keep it on the CPU::

    JAX_PLATFORMS=cpu python -m pytest --noconftest tests/test_torch_ablate_encoder.py -q
"""

import functools
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import chip_ablate_encoder as CA
from pytorch_news_recommender_tpu_torch.ops import ablate_encoder as AE
from pytorch_news_recommender_tpu_torch.ops import fused_encoder as FE

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]
L, D, Q = AE.L, 300, 200     # the harness's widths are fixed
M = 128                      # two grid steps of 64 items
# max|a - b| / max|ref|. bf16: both sides round to bf16 at the same points,
# but their f32 sums run in another order, so a value at a rounding edge may
# land one bf16 step (2^-8 of its size) away before the output's sum of 20
# rows rounds again. f32: the same f32 arithmetic in another order.
TOLS = {"bfloat16": 2e-2, "float32": 1e-4}


def _inputs(seed, M, real_mask):
    """Harness-layout numpy inputs with nonzero biases: the mask all ones, or
    0..L tokens per item with item 0 all pad (in the first subtile) and item
    1 full, pad tokens of x zeroed."""
    rng = np.random.default_rng(seed)
    mask = np.ones((M, L), np.float32)
    if real_mask:
        lens = rng.integers(0, L + 1, size=M)
        lens[0], lens[1] = 0, L
        mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.float32)
    x = rng.normal(size=(M, L, D)) * mask[..., None]
    shapes = [(D, 3 * D), (1, 3 * D), (D, D), (1, D), (D, Q), (1, Q), (Q, 1)]
    scales = [0.05, 0.01, 0.05, 0.01, 0.05, 0.01, 0.1]
    w = [rng.normal(size=s) * c for s, c in zip(shapes, scales)]
    return [np.float32(a) for a in [x.reshape(M * L, D), mask.reshape(M * L, 1), *w]]


def _torch(arrays, dtype):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    return [t[0].to(dtype), t[1]] + [a.to(dtype) for a in t[2:]]


@pytest.fixture(scope="module")
def harness():
    """``run(stage, arrays, dtype)``: the harness's own ``build`` of the
    stage's body, ``pallas_call`` in interpret mode, on a fresh copy of the
    module with ``M`` set from the inputs."""
    jnp = pytest.importorskip("jax.numpy")
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    spec = importlib.util.spec_from_file_location(
        "ablate_encoder_harness", ROOT / "benchmarks" / "ablate_encoder.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    f32 = jnp.float32
    qkv = pltpu.VMEM((mod.R, 3 * D), f32)
    o = pltpu.VMEM((mod.R, D), f32)
    scratch = {"passthrough": [], "qkv": [qkv], "tail": [qkv], "attn": [qkv, o],
               "attn_slices": [qkv, o], "attn_nosoftmax": [qkv, o]}

    def run(stage, arrays, dtype):
        jd = jnp.bfloat16 if dtype == torch.bfloat16 else f32
        args = [jnp.asarray(arrays[0], jd), jnp.asarray(arrays[1], f32)]
        args += [jnp.asarray(a, jd) for a in arrays[2:]]
        mod.M = arrays[0].shape[0] // L
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
            out = mod.build(getattr(mod, "k_" + stage), scratch[stage])(*args)
        return np.asarray(out.astype(f32))
    return run


def _assert_close(got, ref, dtype):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= TOLS[str(dtype).split(".")[-1]], err


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("real_mask", [False, True], ids=["ones", "real"])
@pytest.mark.parametrize("stage", AE.STAGES)
def test_plain_matches_jax_harness(harness, stage, real_mask, dtype):
    arrays = _inputs(7, M, real_mask)
    got = AE.ablate_encoder_reference(stage, *_torch(arrays, dtype))
    assert got.dtype == dtype and got.shape == (M, D)
    _assert_close(got.float().numpy(), harness(stage, arrays, dtype), dtype)


def test_table_on_the_cpu_equals_the_harness(harness):
    """The slice as a whole: ``chip_ablate_encoder.table`` (the stages
    through the wrapper, which takes the plain version on the CPU) on every
    stage, with a real mask, and its full-forward line."""
    t = CA.table(M, real_mask=True, device="cpu")
    arrays = [a.float().numpy() for a in t["inputs"]]
    for stage, r in t["stages"].items():
        _assert_close(r["out"].float().numpy(), harness(stage, arrays, torch.bfloat16),
                      torch.bfloat16)
        assert r["max_rel_err"] == 0.0 and r["ms"] is None and r["plain_ms"] is None
        assert r["bound_by"] == ("bytes" if stage == "passthrough" else "operations")
    assert t["forward"]["out"].shape == (M, D) and t["forward"]["ms"] is None


def test_all_pad_rows_attend_over_the_whole_subtile():
    """V2: a row with mask 0 scores -1e9 everywhere, so it takes the mean of
    v over its 160-row subtile, across items: item 0 (all pad) sums L such
    rows; with item 0 real, its rows attend within the item."""
    arrays = _inputs(3, 64, real_mask=True)
    x2, maskf, wqkv, bqkv = (torch.from_numpy(a).double() for a in arrays[:4])
    v = (x2 @ wqkv + bqkv)[:, 2 * D:]
    mean_v = v[:AE.SUB].mean(0)
    got = AE.ablate_encoder_reference("attn", *_torch(arrays, torch.float32))
    np.testing.assert_allclose(got[0].numpy(), (L * mean_v).numpy(), rtol=1e-5, atol=1e-5)
    assert not np.allclose(got[0].numpy(), L * v[:L].mean(0).numpy(), atol=1e-2)


def test_nosoftmax_mixes_the_items_of_a_subtile():
    """V2b has no mask and no block diagonal: changing item 1 moves item 0,
    which lies in the same 160-row subtile, and not item 8 in the next
    subtile. V2 keeps item 0 apart (all-ones mask)."""
    arrays = _inputs(4, 64, real_mask=False)
    other = [a.copy() for a in arrays]
    other[0][L:2 * L] += 1.0
    for stage, moves in (("attn_nosoftmax", True), ("attn", False)):
        a = AE.ablate_encoder_reference(stage, *_torch(arrays, torch.float32))
        b = AE.ablate_encoder_reference(stage, *_torch(other, torch.float32))
        assert (not torch.allclose(a[0], b[0], atol=1e-3)) == moves, stage
        assert torch.equal(a[8:], b[8:]) and not torch.allclose(a[1], b[1], atol=1e-3)


@pytest.mark.parametrize("case", ["M not a multiple of 64", "unknown stage",
                                  "flat bias", "mask shape"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    arrays = _inputs(5, 100 if case == "M not a multiple of 64" else 64, real_mask=False)
    stage = "qkv"
    if case == "unknown stage":
        stage = "softmax"
    elif case == "flat bias":
        arrays[3] = arrays[3].reshape(-1)
    elif case == "mask shape":
        arrays[1] = arrays[1].reshape(64, L)
    with pytest.raises(ValueError):
        AE.ablate_encoder(stage, *_torch(arrays, torch.float32))


def test_cpu_tensors_take_the_plain_version_and_build_nothing():
    arrays = _inputs(6, 64, real_mask=True)
    args = _torch(arrays, torch.float32)
    before = AE.ablate_encoder.launches
    for stage in AE.STAGES:
        assert torch.equal(AE.ablate_encoder(stage, *args),
                           AE.ablate_encoder_reference(stage, *args))
    assert AE.ablate_encoder.launches == before
    assert FE._lib.cache_info().currsize == 0


def test_other_devices_raise():
    args = [t.to("meta") for t in _torch(_inputs(6, 64, real_mask=False), torch.float32)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        AE.ablate_encoder("qkv", *args)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stage", AE.STAGES)
def test_kernel_matches_plain_on_card(cuda_device, stage, dtype):
    """A CUDA call goes to the kernel (one launch) and agrees with the plain
    version on a real mask with an all-pad item, in two grid steps; a second
    launch gives the same bits (no atomics, fixed sum orders)."""
    args = [t.to(cuda_device) for t in _torch(_inputs(8, M, real_mask=True), dtype)]
    before = AE.ablate_encoder.launches
    got = AE.ablate_encoder(stage, *args)
    again = AE.ablate_encoder(stage, *args)
    torch.cuda.synchronize()
    assert AE.ablate_encoder.launches == before + 2
    assert torch.equal(got, again)
    expect = AE.ablate_encoder_reference(stage, *args)
    _assert_close(got.float().cpu().numpy(), expect.float().cpu().numpy(), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_smem_needs_are_the_layouts_sums(cuda_device, dtype):
    """The library's shared-memory needs at the harness's widths are the sums
    that ``csrc/ablate_encoder.cu``'s header gives: V0 4 items' partial
    sums, V1 / V2a x, the ring and the f32 q|k|v tile, V2 / V2b the 160-row
    layout (x whole in bf16, streamed in f32), V3 at least V1's and the
    forward's tail; all within one block."""
    lib = FE._lib()
    code = FE._DTYPE_CODE[dtype]
    need = {s: lib.newsrec_ablate_encoder_smem_bytes(i, code, L, D, AE.H, Q)
            for i, s in enumerate(AE.STAGES)}
    f32 = dtype == torch.float32
    # 4 items of 1 (f32) or 2 (bf16) rows of f32 partial sums
    assert need["passthrough"] == 4 * (1 if f32 else 2) * D * 4
    assert need["qkv"] == need["attn_slices"] == (162_176 if f32 else 108_416)
    assert need["attn"] == need["attn_nosoftmax"] == (226_560 if f32 else 218_624)
    assert need["tail"] >= need["qkv"]
    assert need["tail"] >= lib.newsrec_fused_encoder_smem_bytes(code, L, D, AE.H, Q)
    assert max(need.values()) <= FE.MAX_SMEM
