"""The port's segment scatter (``ops/segment_scatter.py``) against the JAX
package's: the plain version against the Pallas kernel in interpret mode,
``dedup_gather``'s gradient, and a training step's loss and gradients under
``dedup_gather_mxu`` against the JAX model on its Pallas path; on a CUDA
card only, the Hopper kernel against the plain version::

    JAX_PLATFORMS=cpu python -m pytest --noconftest tests/test_torch_segment_scatter.py -q
"""

import numpy as np
import pytest
import torch

from pytorch_news_recommender_tpu_torch.config import synthetic_config
from pytorch_news_recommender_tpu_torch.data import synthetic
from pytorch_news_recommender_tpu_torch.data.loader import train_batches
from pytorch_news_recommender_tpu_torch.models import build_model
from pytorch_news_recommender_tpu_torch.models.convert import assign, from_flax
from pytorch_news_recommender_tpu_torch.ops import kernels as K
from pytorch_news_recommender_tpu_torch.ops import segment_scatter as SS
from pytorch_news_recommender_tpu_torch.train.loop import softmax_ce_loss

torch.set_num_threads(1)


def _zipf(seed, U, S, D, pad_share=0.0):
    """Zipf-skewed destinations (``pad_share`` of them on row 0, as the pad
    news holds history slots) and normal sources, as numpy."""
    rng = np.random.default_rng(seed)
    idx = (rng.zipf(1.5, size=S) % U).astype(np.int32)
    idx[rng.random(S) < pad_share] = 0
    return idx, rng.standard_normal((S, D)).astype(np.float32)


@pytest.mark.parametrize("U,S,D", [(64, 200, 32), (130, 1000, 48)])
def test_plain_matches_jax_pallas_kernel(U, S, D):
    """rtol/atol 1e-5, as the JAX package holds its kernel to XLA's
    scatter-add."""
    jnp = pytest.importorskip("jax.numpy")
    from pytorch_news_recommender_tpu.ops.pallas.segment_scatter import (
        scatter_add_rows as jax_scatter_add_rows,
    )
    idx, g = _zipf(0, U, S, D)
    expect = jax_scatter_add_rows(jnp.asarray(idx), jnp.asarray(g), U, block_u=64,
                                  block_s=256, interpret=True)
    got = SS.scatter_add_rows(torch.from_numpy(idx), torch.from_numpy(g), U)
    assert got.dtype == torch.float32 and got.shape == (U, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dedup_gather_gradient_matches_plain_gather(dtype):
    """Forward equal to ``table[idx]``; the gradient equal to autograd's of
    the plain float32 gather, to float32 summation order, in ``dtype`` (bf16:
    the float32 sums rounded once, as the JAX package casts its kernel's
    float32 output)."""
    idx, g = _zipf(1, 96, 4 * 50, 32, pad_share=0.5)
    idx = torch.from_numpy(idx).reshape(4, 50)
    table = torch.randn(96, 32, generator=torch.Generator().manual_seed(0)).to(dtype)
    cot = torch.from_numpy(g).reshape(4, 50, 32).to(dtype)
    t = table.clone().requires_grad_(True)
    out = SS.dedup_gather(t, idx)
    assert torch.equal(out.detach(), table[idx.long()])
    out.backward(cot)
    t32 = table.float().requires_grad_(True)
    t32[idx.long()].backward(cot.float())
    assert t.grad.dtype == dtype
    tol = {torch.float32: 1e-5, torch.bfloat16: 1e-2}[dtype]
    torch.testing.assert_close(t.grad.float(), t32.grad.to(dtype).float(), rtol=tol, atol=tol)


def _seg_of(S):
    """Sorted positions per block of the kernel's reduction
    (``csrc/segment_scatter.cu``, ``seg_of``): the power of two from 16 to
    128 that gives about 264 blocks. ``test_segment_length_is_the_kernels_on_card``
    holds it to the built library's."""
    seg = 16
    while seg < 128 and seg * 264 < S:
        seg *= 2
    return seg


def _partition_model(idx, g, U):
    """Plain model of the kernel's sums, in float32: a stable sort of the
    sources by row, blocks of ``_seg_of(S)`` sorted positions each summed in
    order, a row inside one block written from it, a row across a block
    edge left in its blocks' partial slots and summed by 32 warps (warp w
    takes the parts w, w + 32, ...), the warp sums added in warp order."""
    S, D = g.shape
    seg = _seg_of(S)
    keep = (idx >= 0) & (idx < U)
    order = np.argsort(np.where(keep, idx, U), kind="stable")[:int(keep.sum())]
    key, rows = idx[order], g[order].astype(np.float32)
    n = len(key)
    starts = np.searchsorted(key, np.arange(U + 1))
    out = np.zeros((U, D), np.float32)
    parts = {}  # (block, row) -> the block's part of a row across an edge
    for j in range(-(-n // seg)):
        p0, p1 = j * seg, min((j + 1) * seg, n)
        acc, start = np.zeros(D, np.float32), p0
        for p in range(p0, p1):
            acc = acc + rows[p]
            if p + 1 == p1 or key[p + 1] != key[p]:
                u = key[p]
                if start == starts[u] and p + 1 == starts[u + 1]:
                    out[u] = acc
                else:
                    parts[(j, u)] = acc
                acc, start = np.zeros(D, np.float32), p + 1
    for u in {u for _, u in parts}:
        j0, j1 = starts[u] // seg, (starts[u + 1] - 1) // seg
        warp = [np.zeros(D, np.float32) for _ in range(32)]
        for j in range(j0, j1 + 1):
            warp[(j - j0) % 32] = warp[(j - j0) % 32] + parts[(j, u)]
        total = np.zeros(D, np.float32)
        for w in warp:
            total = total + w
        out[u] = total
    return out


def _dedup_indices():
    """The inverse indices of a dedup batch (browsed and candidates), from
    the small synthetic configuration."""
    cfg = synthetic_config()
    ds = synthetic.generate(cfg.data, seed=2, n_train=256, n_dev=8)
    batch = next(train_batches(ds.train, 64, np.random.default_rng(0), dedup=True,
                               unique_buckets=(64, 128, 256, 512)))
    U = int(batch["unique_ids"].shape[0])
    return U, {k: batch[k].reshape(-1).astype(np.int32) for k in ("browsed_idx",
                                                                 "candidate_idx")}


@pytest.mark.parametrize("case", ["browsed", "candidate", "zipf-1", "zipf-127", "zipf-129",
                                  "zipf-3072", "zipf-25600", "one-row-5000", "out-of-range"])
def test_partition_model_equals_index_add(case):
    """The kernel's partition (segment length from S, the fixup of rows that
    cross a block edge) sums what ``index_add_`` sums, within 1e-6 of the
    largest output: ``index_add_`` in float64 on every case, and the plain
    version (float32 ``index_add_``) on a dedup batch's skewed indices (the
    pad news holds about half the history slots); Zipf indices at the sizes
    the card tests take; one row of 5,000 sources across many edges;
    indices outside [0, U)."""
    D = 24
    rng = np.random.default_rng(3)
    if case in ("browsed", "candidate"):
        U, idx = _dedup_indices()
        idx = idx[case + "_idx"]
        assert case == "candidate" or np.bincount(idx).max() > 2 * _seg_of(len(idx))
    elif case.startswith("zipf"):
        S = int(case.split("-")[1])
        U = 9216 if S >= 3072 else 130
        idx, _ = _zipf(7, U, S, 1, pad_share=0.5)
    elif case == "one-row-5000":
        U, idx = 3, np.ones(5000, np.int32)
    else:
        U, idx = 5, np.array([0, 5, 2, -1, 2, 3, 7, 4] * 40, np.int32)
    g = rng.standard_normal((len(idx), D)).astype(np.float32)
    got = _partition_model(idx, g, U)
    valid = (idx >= 0) & (idx < U)
    iv, gv = torch.from_numpy(idx[valid]).long(), torch.from_numpy(g[valid])
    exact = torch.zeros((U, D), dtype=torch.float64).index_add_(0, iv, gv.double()).numpy()
    assert np.abs(got - exact).max() <= 1e-6 * np.abs(exact).max()
    if case in ("browsed", "candidate"):
        # the plain version's float32 sums too (at thousands of sources in
        # one row its sequential sum drifts some 3e-6 from the exact one)
        expect = SS.scatter_add_rows_reference(iv, gv, U).numpy()
        assert np.abs(got - expect).max() <= 1e-6 * np.abs(expect).max()
    assert np.all(got[np.bincount(idx[(idx >= 0) & (idx < U)], minlength=U) == 0] == 0)


def test_cpu_tensors_take_the_plain_version_and_build_nothing():
    idx, g = _zipf(2, 40, 300, 16)
    before = SS.scatter_add_rows.launches
    got = SS.scatter_add_rows(torch.from_numpy(idx), torch.from_numpy(g), 40)
    expect = SS.scatter_add_rows_reference(torch.from_numpy(idx), torch.from_numpy(g), 40)
    assert torch.equal(got, expect)
    assert SS.scatter_add_rows.launches == before
    assert K.lib.cache_info().currsize == 0


def test_other_devices_raise():
    idx = torch.zeros(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        SS.scatter_add_rows(idx, torch.zeros(4, 8, device="meta"), 3)


def test_resolve_batch_under_dedup_gather_mxu_matches_jax():
    """A seeded dedup batch through the port on the CPU (``dedup_gather``,
    plain versions) and through the JAX model on its Pallas path in
    interpret mode (fused encoder and MXU segment scatter), from the same
    Flax weights: loss and every gradient within rtol/atol 1e-4."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from pytorch_news_recommender_tpu.config import synthetic_config as jax_synthetic_config
    from pytorch_news_recommender_tpu.data import synthetic as jax_synthetic
    from pytorch_news_recommender_tpu.train import loop as jax_loop

    over = {"model.dropout": 0.0, "model.use_pallas": True, "model.pallas_interpret": True,
            "model.dedup_gather_mxu": True}
    data = dict(seed=4, n_train=64, n_dev=8)
    jcfg, cfg = jax_synthetic_config(**over), synthetic_config(**over)
    jtr = jax_loop.Trainer(jcfg, jax_synthetic.generate(jcfg.data, **data))
    params = jax.device_get(jtr.init_state(seed=0).params)
    ds = synthetic.generate(cfg.data, **data)
    batch = next(train_batches(ds.train, 8, np.random.default_rng(0), dedup=True,
                               unique_buckets=(64, 128, 256)))
    assert "unique_ids" in batch

    def jloss(p):
        s = jtr.model.apply({"params": p}, {k: jnp.asarray(v) for k, v in batch.items()},
                            jtr.news_feats, True)
        return jax_loop.softmax_ce_loss(s)

    jl, jg = jax.value_and_grad(jloss)(params)
    model = build_model(cfg.model.with_artifact_meta(ds.meta))
    assign(model, from_flax(params))
    feats = {k: torch.from_numpy(v) for k, v in ds.news.as_dict().items()}
    loss = softmax_ce_loss(model({k: torch.from_numpy(v) for k, v in batch.items()}, feats))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-4, atol=1e-4)
    expect = from_flax(jax.device_get(jg))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), expect[name].numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


# ---- on the card ------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("U,S,D,pad_share", [
    (1, 1, 1, 0.0), (5, 0, 8, 0.0), (64, 200, 32, 0.0), (130, 1000, 48, 0.5),
    (9216, 25600, 300, 0.5), (9216, 3072, 300, 0.0), (300, 100_000, 7, 0.9),
    # heavy skew at the segment lengths of small S (16 positions a block up
    # to S = 4,224): one source, one block, one edge, the candidate gather
    (9216, 1, 300, 0.9), (9216, 127, 300, 0.9), (9216, 129, 300, 0.9),
    (9216, 3072, 300, 0.9), (130, 129, 1, 0.9)])
def test_kernel_matches_plain_on_card(cuda_device, dtype, U, S, D, pad_share):
    """Max error 1e-5 of the largest output: float32 sums of the same
    terms, in another order; rows with no source exactly 0; two launches
    equal bit for bit."""
    idx, g = _zipf(3, U, S, D, pad_share)
    idx = torch.from_numpy(idx).to(cuda_device)
    g = torch.from_numpy(g).to(cuda_device).to(dtype)
    before = SS.scatter_add_rows.launches
    got = SS.scatter_add_rows(idx, g, U)
    torch.cuda.synchronize()
    assert SS.scatter_add_rows.launches == before + 1
    expect = SS.scatter_add_rows_reference(idx, g, U)
    scale = float(expect.abs().max()) if S else 1.0
    assert float((got - expect).abs().max()) <= 1e-5 * max(scale, 1e-30)
    empty = torch.bincount(idx.long(), minlength=U) == 0
    assert torch.all(got[empty] == 0)
    assert torch.equal(got, SS.scatter_add_rows(idx, g, U))


@pytest.mark.parametrize("S", [0, 1, 127, 129, 3072, 4224, 4225, 25_600, 100_000])
def test_segment_length_is_the_kernels_on_card(cuda_device, S):
    """The CPU partition model's segment length is the built kernel's."""
    assert SS.segment_length(S) == _seg_of(S)


def test_out_of_range_indices_match_no_row_on_card(cuda_device):
    idx = torch.tensor([0, 5, 2, -1, 2, 3], dtype=torch.int32, device=cuda_device)
    g = torch.ones(6, 4, device=cuda_device)
    got = SS.scatter_add_rows(idx, g, 3)
    expect = torch.tensor([[1.0] * 4, [0.0] * 4, [2.0] * 4], device=cuda_device)
    assert torch.equal(got, expect)


def test_dedup_gather_backward_launches_the_kernel_on_card(cuda_device):
    idx, g = _zipf(5, 200, 2000, 64, pad_share=0.5)
    table = torch.randn(200, 64, device=cuda_device, dtype=torch.bfloat16,
                        requires_grad=True)
    idx = torch.from_numpy(idx).to(cuda_device).reshape(40, 50)
    cot = torch.from_numpy(g).to(cuda_device).reshape(40, 50, 64).to(torch.bfloat16)
    before = SS.scatter_add_rows.launches
    SS.dedup_gather(table, idx).backward(cot)
    assert SS.scatter_add_rows.launches == before + 1
    expect = SS.scatter_add_rows_reference(idx.reshape(-1), cot.reshape(-1, 64), 200)
    # one bf16 rounding of float32 sums taken in two orders
    torch.testing.assert_close(table.grad.float(), expect.to(torch.bfloat16).float(),
                               rtol=1e-2, atol=1e-2)


def test_wrapper_rejects_what_the_kernel_does_not_take_on_card(cuda_device):
    idx = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        SS.scatter_add_rows(idx, torch.zeros(4, 8, device=cuda_device,
                                             dtype=torch.float16), 3)
    with pytest.raises(ValueError, match="idx"):
        SS.scatter_add_rows(idx[:3], torch.zeros(4, 8, device=cuda_device), 3)
    with pytest.raises(ValueError, match="D <="):
        SS.scatter_add_rows(idx, torch.zeros(4, 2048, device=cuda_device), 3)
