"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

1. Builds the kernels from ``pytorch_news_recommender_tpu_torch/ops/csrc``
   (the fused encoder forward, its backward and the tensor-core weight
   gradients, the segment scatter, the forward's stage ablation; ninja
   compiles the sources in parallel).
2. Holds the forward kernel against its plain PyTorch version at the
   serving shapes in float32 and bfloat16, with repeat launches equal bit
   for bit, one wrapper launch and three device kernels per call (read
   from the profiler), and times it at every serving and training shape
   and at M=28,672, L=20.
3. Serves NRMS at full width (D=300, 10 heads, query dim 200, title 20,
   history 50, bf16) over HTTP on a seeded synthetic corpus of 65,238 news
   (the news count of MIND-small), in both corpus-cache modes, and checks a
   sample of the served answers against the plain version.
4. Times the serving paths.
5. Holds the backward and weight-gradient kernels, and the forward with
   dropout and the ``o1`` residual, against their plain versions at the
   training step's shapes, float32 and bfloat16, dropout 0 and 0.2, with
   two backward calls equal bit for bit and one backward launch and four
   weight-gradient launches per call, and times the backward whole and its
   per-item kernels alone; then
   the weight-gradient kernel alone at each product of one backward call
   over the long block's R=81,920 token rows (dWqkv with bf16 and f32 ``a``,
   dWo, daw with the bias fused, daq without), against the plain version
   and ``torch.mm``.
6. Trains NRMS at the JAX package's default configuration (batch 512, bf16
   activations, f32 parameters, dropout 0.2, dedup and a length split at 12
   words) on a synthetic corpus with MIND's mean title length: one step
   through the kernels against the same step through the plain version,
   then 40 steps, then an evaluation through the two-tower path.
7. Trains the same configuration with ``model.dedup_gather_mxu``, the
   inverse gathers' backward through the segment-scatter kernel: the kernel
   against its plain version (``index_add_`` into zeros) on a real dedup
   batch's indices, with its device time by launch, one step
   against the plain step, 40 steps; then the user workflow on the card:
   checkpoint at an evaluation, restore into a fresh trainer, evaluate
   again, write a submission file, and ``cli train`` / ``eval`` / ``submit``
   / ``export-vectors`` at the small synthetic size with the exported table
   served through ``Recommender(vectors_file=...)``.
8. Runs the stage ablation of the forward (``chip_ablate_encoder.py``'s
   table: six truncations of the forward kernel, then the full forward on
   the same input) at M=28,672, L=20 with the all-ones mask and at M=4096
   with a real mask that holds an all-pad item, holds each stage's kernel
   against its plain version, and counts the launches.

Prints timings tagged with the card's name and power limit, the kernels'
line as JSON, and ends with ``{"ok": true, "device": {...}}``. Any failed
phase raises; there is no result without a CUDA card.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import http.client
import itertools
import dataclasses
import json
import math
import pathlib
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

N_NEWS = 65_238          # MIND-small's news count; the table adds the pad row
VOCAB = 32_000
D, H, Q = 300, 10, 200
SHAPES = [(4096, 20), (32, 50), (1, 50)]   # corpus chunk, score_many batch, single user
# the training step's encoder calls: short news block, long news block, users
TRAIN_SHAPES = [(4096, 12), (4096, 20), (512, 50)]
TOLS = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
# the forward timed at every serving and training shape, and at the stage
# ablation's M=28,672
FWD_SHAPES = SHAPES + TRAIN_SHAPES + [(28_672, 20)]
# launches of one forward call: the wrapper's count, and the device kernels
# (the weight layout, the attention, the tail), read from the profiler
FWD_LAUNCHES, FWD_KERNELS = 1, 3
# backward kernel vs plain version, max|a - b| / max|b| per output
BWD_TOLS = {torch.float32: 2e-3, torch.bfloat16: 2e-2}
TRAIN_STEPS = 40
# launches of one backward call: the per-item kernels' (one count for the
# pooling, attention and dx kernels of one call) and weight_grad's
BWD_LAUNCHES = (1, 4)
# segment scatter vs plain, max|a - b| / max|b|: float32 sums of the same
# bfloat16 terms, only the order of the additions differs
SCATTER_TOL = 1e-5
# scratch of phase 7 (checkpoints, CLI runs), inside the checkout
WORK = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke"
# a served score may differ from the plain recomputation by this share of the
# sample's largest |score|: bf16 vectors, kernel vs plain rounding points;
# int8 rows add up to amax/254 per element on top
SCORE_TOL = {"native": 2e-2, "int8": 4e-2}
PEAK_BF16_FLOPS, PEAK_F32_FLOPS, PEAK_BYTES = 989e12, 67e12, 3.35e12  # H100 SXM
# weight-gradient kernel vs plain version, max|a - b| / max|b| over the
# product and the bias sums: f32 sums of the same products (a high/low
# split of each f32 operand), only the order and the split's 2^-16 differ
WGRAD_TOL = 1e-4
# the weight-gradient products of one backward call in bf16 training (name,
# a's width K, b's width N, a's dtype, bias fused): dWqkv, dWo, daw, daq;
# and dWqkv with an f32 a, as in f32 training
WGRAD_PRODUCTS = [("wgrad", D, 3 * D, torch.bfloat16, True),
                  ("wgrad_f32", D, 3 * D, torch.float32, True),
                  ("wgrad_dwo", D, D, torch.bfloat16, True),
                  ("wgrad_daw", D, Q, torch.float32, True),
                  ("wgrad_daq", Q, 1, torch.float32, False)]
# ablation kernel vs plain version, max|a - b| / max|b| per stage: both
# round to bf16 at the same points, their f32 sums run in another order, so
# a value at a rounding edge may land one bf16 step away
ABLATION_TOL = 2e-2
DEVICE = "cuda"


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def encoder_inputs(seed, M, L, dtype, scales=(0.05, 0.01, 0.05, 0.01, 0.05, 0.01, 0.1)):
    """Seeded masked tokens (rows of 0..L real tokens) and encoder weights."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, L + 1, size=M)
    if M > 1:
        lens[0], lens[1] = 0, L     # an all-pad item and a full one
    else:
        lens[0] = max(lens[0], 1)
    mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.float32)
    x = rng.normal(size=(M, L, D)) * mask[..., None]
    shapes = [(D, 3 * D), (3 * D,), (D, D), (D,), (D, Q), (Q,), (Q,)]
    w = [rng.normal(size=s) * c for s, c in zip(shapes, scales)]
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=DEVICE)
    return ([t(x).to(dtype), t(mask)] + [t(a).to(dtype) for a in w],
            torch.as_tensor(lens > 0, device=DEVICE))


def bound(M, L, itemsize):
    """(ms, "bytes" | "operations"): the least time for the work, the larger
    of the bytes moved once over the memory rate and the operations over the
    peak rate for the operand type. The kernel does the same work whatever
    the mask, so the shapes decide it."""
    flops = M * (2 * L * D * (3 * D + D + Q) + 4 * H * L * L * (D // H))
    weights = D * 3 * D + 3 * D + D * D + D + D * Q + 2 * Q
    nbytes = (M * L * D + weights + M * D) * itemsize + M * L * 4
    peak = PEAK_BF16_FLOPS if itemsize == 2 else PEAK_F32_FLOPS
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / peak * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def ablation_bound(stage, M, L, itemsize=2):
    """Bound of one stage of the encoder's ablation
    (``ops/csrc/ablate_encoder.cu``), counting the work the stage exists to
    do: bytes are x (and the mask, where the stage reads it) and the weights
    it reads in, ``[M, D]`` out; FLOP are V0's adds, or ``2·L·D·3D`` per item
    for the projection, + ``4·H·L²·dh`` per item for V2 (attention within
    items), + two ``SUB×SUB×dh`` products per 160-row subtile and head for
    V2b, + ``2·L·D·(D+Q)`` per item for V3 (the Wo and aw products)."""
    from pytorch_news_recommender_tpu_torch.ops.ablate_encoder import SUB
    rows, dh = M * L, D // H
    flops, weights, mask = rows * D, 0, 0
    if stage != "passthrough":
        flops, weights = 2 * rows * D * 3 * D, D * 3 * D + 3 * D
    if stage == "attn":
        flops, mask = flops + M * 4 * H * L * L * dh, rows * 4
    elif stage == "attn_nosoftmax":
        flops += rows // SUB * H * 2 * (2 * SUB * SUB * dh)
    elif stage == "tail":
        flops += 2 * rows * D * (D + Q)
        weights, mask = weights + D * D + D + D * Q + 2 * Q, rows * 4
    nbytes = (rows * D + weights + M * D) * itemsize + mask
    peak = PEAK_BF16_FLOPS if itemsize == 2 else PEAK_F32_FLOPS
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / peak * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bwd_bound(M, L, itemsize=2):
    """Backward bound: 6·L·D·(3D+D+Q) + 10·H·L²·dh FLOP per item (the
    projections for the recompute, dx and the weight gradients, and the
    attention products) over the bf16 peak; bytes are g, x, o1 and the mask
    in, dx and the weight gradients out."""
    flops = M * (6 * L * D * (3 * D + D + Q) + 10 * H * L * L * (D // H))
    wgrads = (D * 3 * D + 3 * D + D * D + D + D * Q + 2 * Q) * 4
    nbytes = M * D * 4 + 3 * M * L * D * itemsize + M * L * 4 + wgrads
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def wgrad_bound(R, K, N, itemsize_a, bias=True):
    """Weight-gradient bound, whatever the design: bytes a and b in and the
    [K (+1), N] sums out over the memory rate, or 2·R·K·N FLOP over the
    bf16 tensor-core peak, whichever is larger."""
    flops = 2 * R * K * N
    nbytes = R * K * itemsize_a + R * N * 4 + (K + bias) * N * 4
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def rel_err(a, b):
    """max|a - b| / max|b| in float32."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def cuda_ms(fn, iters):
    """Mean device time of ``fn()`` over ``iters`` calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_kernels(fn):
    """Device kernels (and memsets) that one call of ``fn`` launches, from
    the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


def check_kernel(FE):
    """Phase 2: kernel vs plain version at the serving shapes, two dtypes,
    one wrapper launch and FWD_KERNELS device kernels per call, repeat calls
    equal bit for bit; then the times at every shape of FWD_SHAPES (bf16)."""
    errs, times = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        for M, L in SHAPES:
            args, valid = encoder_inputs(M * 100 + L, M, L, dtype)
            before = FE.fused_news_encoder.launches
            got = FE.fused_news_encoder(*args, num_heads=H)
            torch.cuda.synchronize()
            assert FE.fused_news_encoder.launches - before == FWD_LAUNCHES
            expect = FE.fused_news_encoder_reference(*args, num_heads=H)
            err = float((got[valid].float() - expect[valid].float()).abs().max())
            tol = TOLS[dtype]
            torch.testing.assert_close(got[valid].float(), expect[valid].float(),
                                       rtol=tol, atol=tol)
            assert torch.all(got[~valid] == 0), "an all-pad item must pool to 0"
            # no atomics, a fixed order of every sum: the same bits again
            assert torch.equal(got, FE.fused_news_encoder(*args, num_heads=H)), \
                ("the forward is not deterministic", str(dtype), M, L)
            errs[(str(dtype), M, L)] = err
            print(f"kernel vs plain {str(dtype):15s} M={M:5d} L={L}: "
                  f"max|err| {err:.3g} (tol {tol}); two launches equal bit for bit",
                  flush=True)
    kernels = device_kernels(lambda: FE.fused_news_encoder(*args, num_heads=H))
    assert kernels == FWD_KERNELS, (kernels, FWD_KERNELS)
    for M, L in FWD_SHAPES:
        args, _ = encoder_inputs(M * 100 + L, M, L, torch.bfloat16)
        iters = 5 if M > 10_000 else (10 if M > 1000 else 100)
        times[(M, L)] = (
            cuda_ms(lambda: FE.fused_news_encoder(*args, num_heads=H), iters),
            cuda_ms(lambda: FE.fused_news_encoder_reference(*args, num_heads=H), iters))
    print(f"fused_encoder_fwd: {FWD_LAUNCHES} wrapper launch and {kernels} device kernels "
          f"per call; {FE.fwd_tile(20)[0]} items in {FE.fwd_tile(20)[1]}-row tiles at L=20",
          flush=True)
    return errs, times, kernels


def check_backward(FE):
    """Phase 5: the forward with dropout and the o1 residual, the backward
    and the weight-gradient kernels against their plain versions at the
    training step's shapes, two dtypes, dropout 0 and 0.2. Returns the worst
    errors and the timings (bf16, dropout 0.2)."""
    # pooling weights large enough that the tanh bends: the bias gradient
    # dab = -aq sum_l ds_l t_l^2 is otherwise all rounding
    scales = (0.05, 0.01, 0.05, 0.01, 0.3, 0.5, 0.1)
    errs = {"bwd_abs": 0.0, "bwd_rel": 0.0}
    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        for rate in (0.0, 0.2):
            for M, L in TRAIN_SHAPES:
                args, valid = encoder_inputs(M * 7 + L, M, L, dtype, scales)
                x, mask, w = args[0], args[1], args[2:]
                g = torch.as_tensor(np.random.default_rng(M + L).normal(size=(M, D)),
                                    dtype=torch.float32, device=DEVICE)
                out, o1 = FE.fused_news_encoder(*args, num_heads=H, dropout_rate=rate,
                                                seed=1234, save_o1=True)
                torch.cuda.synchronize()
                ref, ref_o1 = FE.fused_news_encoder_reference(
                    *args, num_heads=H, dropout_rate=rate, seed=1234, save_o1=True)
                tol = TOLS[dtype]
                torch.testing.assert_close(out[valid].float(), ref[valid].float(),
                                           rtol=tol, atol=tol)
                # o1 on the real tokens; in bf16 the kernel rounds the
                # attention where the TPU kernel does and the plain version
                # where the jnp chain does, so single elements may differ by
                # a few bf16 steps: held to the tensor's scale
                real = mask > 0
                o1_err = rel_err(o1[real], ref_o1[real])
                assert o1_err < BWD_TOLS[dtype], (str(dtype), rate, M, L, o1_err)
                assert torch.all(out[~valid] == 0), "an all-pad item must pool to 0"
                before = (FE.fused_news_encoder_bwd.launches, FE.weight_grad.launches)
                bwd = lambda: FE.fused_news_encoder_bwd(  # noqa: E731
                    g, x, mask, o1, *w, num_heads=H, dropout_rate=rate, seed=1234)
                got = bwd()
                torch.cuda.synchronize()
                launched = (FE.fused_news_encoder_bwd.launches - before[0],
                            FE.weight_grad.launches - before[1])
                assert launched == BWD_LAUNCHES, (launched, BWD_LAUNCHES)
                # no atomics, a fixed order of every sum: the same bits again
                assert all(torch.equal(a, b) for a, b in zip(got, bwd())), \
                    ("the backward is not deterministic", str(dtype), rate, M, L)
                expect = FE.fused_news_encoder_bwd_reference(
                    g, x, mask, o1, *w, num_heads=H, dropout_rate=rate, seed=1234)
                each = {name: rel_err(a, b) for name, a, b in zip(
                    ("dx", "dwqkv", "dbqkv", "dwo", "dbo", "daw", "dab", "daq"), got, expect)}
                worst = max(each.values())
                assert worst < BWD_TOLS[dtype], (str(dtype), rate, M, L, each)
                assert torch.all(got[0][~valid] == 0), "an all-pad item must get zero dx"
                if dtype == torch.bfloat16:
                    errs["bwd_rel"] = max(errs["bwd_rel"], worst)
                    errs["bwd_abs"] = max(errs["bwd_abs"], *(
                        float((a.float() - b.float()).abs().max()) for a, b in zip(got, expect)))
                if dtype == torch.bfloat16 and rate > 0:
                    times[(M, L)] = (
                        cuda_ms(bwd, 5),
                        cuda_ms(lambda: FE.fused_news_encoder_bwd_reference(
                            g, x, mask, o1, *w, num_heads=H, dropout_rate=rate, seed=1234), 5),
                        # the per-item kernels alone, without the weight gradients
                        cuda_ms(lambda: FE._bwd_per_item(g, x, mask, o1, w, H, rate, 1234), 5))
                    if (M, L) == TRAIN_SHAPES[1]:
                        times["fwd_train"] = cuda_ms(lambda: FE.fused_news_encoder(
                            *args, num_heads=H, dropout_rate=rate, seed=1234, save_o1=True), 10)
                print(f"backward kernel vs plain {str(dtype):15s} dropout {rate} M={M:5d} "
                      f"L={L}: max rel err {worst:.3g} (tol {BWD_TOLS[dtype]}); two calls equal "
                      f"bit for bit; forward with dropout + o1 ok", flush=True)
    # the weight-gradient kernel alone, each product of one backward call
    # over the long block's rows, each held to its own largest output
    R = TRAIN_SHAPES[1][0] * TRAIN_SHAPES[1][1]
    rng = np.random.default_rng(5)
    flat = lambda outs: torch.cat([o.reshape(-1) for o in outs])  # noqa: E731
    for key, K, N, dtype, bias in WGRAD_PRODUCTS:
        a = torch.as_tensor(rng.normal(size=(R, K)), dtype=torch.float32,
                            device=DEVICE).to(dtype)
        b = torch.as_tensor(rng.normal(size=(R, N)) * 1e-3, dtype=torch.float32,
                            device=DEVICE)
        outs = lambda o: o if bias else (o,)  # noqa: E731
        got = outs(FE.weight_grad(a, b, bias=bias))
        torch.cuda.synchronize()
        plain = outs(FE.weight_grad_reference(a, b, bias=bias))
        errs[key] = rel_err(flat(got), flat(plain))
        errs[key + "_abs"] = float((flat(got) - flat(plain)).abs().max())
        assert errs[key] < WGRAD_TOL, (key, str(dtype), errs[key])
        again = outs(FE.weight_grad(a, b, bias=bias))
        assert all(torch.equal(x, y) for x, y in zip(got, again)), \
            f"weight_grad is not deterministic ({key})"
        # one PyTorch call of the same function: [a | 1]^T b, or a^T b
        at = (torch.cat([a.float(), torch.ones((R, 1), device=DEVICE)], 1) if bias
              else a.float()).t()
        times[key] = (cuda_ms(lambda: FE.weight_grad(a, b, bias=bias), 20),
                      cuda_ms(lambda: FE.weight_grad_reference(a, b, bias=bias), 20),
                      cuda_ms(lambda: torch.mm(at, b), 20), (R, K, N, a.element_size(), bias))
        print(f"weight_grad vs plain ({key}: R={R}, K={K}, N={N}, {str(dtype)} x f32, "
              f"bias {'fused' if bias else 'off'}): max err {errs[key]:.3g} of the largest "
              f"output (tol {WGRAD_TOL}); two launches equal bit for bit", flush=True)
    return errs, times


@contextlib.contextmanager
def plain_kernels(FE, SS):
    """The towers and the inverse gathers' backward through the plain
    versions on the card (autograd differentiates the towers), for the
    comparison steps of phases 6 and 7 only."""
    from pytorch_news_recommender_tpu_torch.models import layers
    kernels = layers.fused_news_encoder, SS.scatter_add_rows
    layers.fused_news_encoder = FE.fused_news_encoder_reference
    SS.scatter_add_rows = SS.scatter_add_rows_reference
    try:
        yield
    finally:
        layers.fused_news_encoder, SS.scatter_add_rows = kernels


def loss_and_grads(trainer, state, batch, seed):
    """One training forward and backward (no update) -> (loss, grads)."""
    from pytorch_news_recommender_tpu_torch.train.loop import softmax_ce_loss
    model = state.model
    model.zero_grad(set_to_none=True)
    b = {k: torch.as_tensor(v, device=DEVICE) for k, v in batch.items()}
    scores = model(b, trainer.news_feats, deterministic=False,
                   generator=torch.Generator().manual_seed(seed))
    loss = softmax_ce_loss(scores)
    loss.backward()
    grads = {n: p.grad.float().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def training_data():
    """The configuration and data of phases 6 and 7: the JAX package's
    defaults on the 65,238-news corpus with MIND's mean title length, 40
    batches of training impressions, 512 dev and 256 test impressions."""
    from pytorch_news_recommender_tpu_torch.config import Config, DataConfig
    from pytorch_news_recommender_tpu_torch.data import synthetic

    cfg = Config(data=DataConfig(dataset="synthetic"))
    t0 = time.perf_counter()
    ds = synthetic.generate(cfg.data, seed=1, n_news=N_NEWS, vocab_size=VOCAB,
                            n_train=TRAIN_STEPS * cfg.train.batch_size, n_dev=512,
                            n_test=256, title_len=(11.5, 4))
    print(f"training data: {time.perf_counter() - t0:.1f} s ({len(ds.train)} impressions, "
          f"batch {cfg.train.batch_size}, dropout {cfg.model.dropout}, "
          f"{cfg.model.compute_dtype})", flush=True)
    return cfg, ds


def train_run(FE, SS, cfg, ds, phase):
    """NRMS training through Trainer.run_step and Trainer.evaluate: one step
    through the kernels against the same step through the plain versions,
    then the main path (every launch count set to 0 before it and read
    after it): TRAIN_STEPS steps over prefetched batches and an evaluation."""
    from pytorch_news_recommender_tpu_torch.data.loader import (
        DEFAULT_UNIQUE_BUCKETS, train_batches,
    )
    from pytorch_news_recommender_tpu_torch.data.prefetch import device_prefetch
    from pytorch_news_recommender_tpu_torch.train.loop import Trainer

    bs = cfg.train.batch_size
    trainer = Trainer(cfg, ds, device=DEVICE)
    state = trainer.init_state(seed=0)
    host = train_batches(ds.train, bs, np.random.default_rng(cfg.train.seed), dedup=True,
                         unique_buckets=DEFAULT_UNIQUE_BUCKETS,
                         length_split=trainer._length_split)
    first = next(host)
    assert "short_mark" in first, "the batch must use both the short and the long block"

    # one step through the kernels against the same step through the plain versions
    lk, gk = loss_and_grads(trainer, state, first, 7)
    with plain_kernels(FE, SS):
        lp, gp = loss_and_grads(trainer, trainer.init_state(seed=0), first, 7)
    names = [n for n, _ in state.model.named_parameters()]
    assert sorted(gk) == sorted(gp) == sorted(names), "a parameter got no gradient"
    assert all(float(gk[n].abs().max()) > 0 for n in names), "a zero gradient"
    scale = max(float(g.abs().max()) for g in gp.values())
    grad_err = max(float((gk[n] - gp[n]).abs().max()) for n in names) / scale
    loss_err = abs(lk - lp) / abs(lp)
    assert loss_err < 0.01 and grad_err < 2e-2, (lk, lp, grad_err)
    print(f"[phase {phase}] train step kernel vs plain (unique {first['unique_ids'].shape[0]}, "
          f"short {first['short_mark'].shape[0]}): loss {lk:.5f} vs {lp:.5f} (rel "
          f"{loss_err:.3g}, tol 0.01); grads max err {grad_err:.3g} of the largest gradient "
          f"(tol 2e-2); every tower weight and the word table get a gradient", flush=True)

    # the main path: run_step over prefetched batches, then evaluate
    counted = {"fwd": FE.fused_news_encoder, "bwd": FE.fused_news_encoder_bwd,
               "wgrad": FE.weight_grad, "scatter": SS.scatter_add_rows}
    for fn in counted.values():
        fn.launches = 0
    losses, step_ms, widths = [], [], []
    torch.cuda.synchronize()
    for batch in device_prefetch(itertools.chain([first], host), DEVICE):
        t0 = time.perf_counter()
        state, m = trainer.run_step(state, batch)
        losses.append(float(m["loss"]))   # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        widths.append((batch["unique_ids"].shape[0], batch["short_mark"].shape[0]
                       if "short_mark" in batch else 0))
    assert len(losses) == TRAIN_STEPS and np.all(np.isfinite(losses)), losses
    first10, last10 = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    assert last10 < first10, (first10, last10)
    t0 = time.perf_counter()
    metrics = trainer.evaluate(state)
    eval_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counted.items()}
    assert launches["fwd"] and launches["bwd"], launches
    # dWqkv+dbqkv, dWo+dbo, daw+dab, daq: four launches per backward call
    assert launches["wgrad"] == 4 * launches["bwd"], launches
    assert np.isfinite(metrics["auc"]) and metrics["n_impressions"] == 512, metrics
    print(f"[phase {phase}] trained {TRAIN_STEPS} steps: loss first 10 {first10:.4f} -> "
          f"last 10 {last10:.4f}; unique news per step "
          f"{np.mean([w for w, _ in widths]):.0f} (short block "
          f"{np.mean([s for _, s in widths]):.0f}); dev AUC {metrics['auc']:.4f} over 512 "
          f"impressions (eval {eval_s:.2f} s); launches {launches}", flush=True)
    return {"launches": launches, "step_ms": step_ms, "trainer": trainer, "state": state,
            "first": first, "metrics": metrics, "loss_err": loss_err, "grad_err": grad_err}


def scatter_bound(S, U, itemsize):
    """Segment-scatter bound: g, idx read once and out written once over
    the memory rate (the work has no multiplications)."""
    return (S * D * itemsize + 4 * S + U * D * 4) / PEAK_BYTES * 1e3, "bytes"


def scatter_split(fn, calls=20):
    """Device time of each launch of one call of ``fn`` (every kernel and
    memset, by name) over ``calls`` calls under ``torch.profiler``:
    ``{name: (launches per call, us per launch)}``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total, count = {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "").removeprefix("void ")
            name = name.split("<")[0].split("(")[0]
            total[name] = total.get(name, 0.0) + e.device_time_total
            count[name] = count.get(name, 0) + 1
    return {n: (count[n] / calls, total[n] / count[n]) for n in total}


def check_scatter(SS, batch):
    """Phase 7a: the segment-scatter kernel against its plain version on
    the inverse indices of a real dedup batch (the pad news holds about half
    the history slots) with bf16 cotangents; two launches equal bit for bit;
    times beside the bound, the plain version (``scatter_add_rows_reference``,
    which widens idx to int64 on every call), one ``index_add_`` call into
    zeros with the int32 idx as it is (the single PyTorch call of the same
    function, which the port's kernel path never makes) and
    ``embedding_dense_backward``; and the kernel's device time by launch."""
    U = int(batch["unique_ids"].shape[0])
    rng = np.random.default_rng(11)
    out = {}
    for name in ("browsed_idx", "candidate_idx"):
        idx = torch.as_tensor(batch[name].reshape(-1), device=DEVICE)
        S = idx.shape[0]
        g = torch.as_tensor(rng.normal(size=(S, D)), dtype=torch.float32,
                            device=DEVICE).to(torch.bfloat16)
        got = SS.scatter_add_rows(idx, g, U)
        torch.cuda.synchronize()
        plain = SS.scatter_add_rows_reference(idx, g, U)
        err = rel_err(got, plain)
        assert err < SCATTER_TOL, (name, err)
        assert torch.equal(got, SS.scatter_add_rows(idx, g, U)), "scatter is not deterministic"
        counts = torch.bincount(idx.long(), minlength=U)
        il = idx.long()
        out[name] = {
            "S": S, "U": U, "max_sources": int(counts.max()),
            "empty_rows": int((counts == 0).sum()),
            "err": err, "abs_err": float((got - plain).abs().max()),
            "ms": cuda_ms(lambda: SS.scatter_add_rows(idx, g, U), 20),
            "plain_ms": cuda_ms(lambda: SS.scatter_add_rows_reference(idx, g, U), 20),
            "edb_ms": cuda_ms(lambda: torch.ops.aten.embedding_dense_backward(
                g, il, U, -1, False), 20),
            "library_ms": cuda_ms(lambda: torch.zeros(
                (U, D), dtype=torch.float32, device=DEVICE).index_add_(0, idx, g.float()), 20),
            "bound": scatter_bound(S, U, 2),
            "split": scatter_split(lambda: SS.scatter_add_rows(idx, g, U))}
        r = out[name]
        print(f"[phase 7] segment scatter vs plain ({name}: S={S}, U={U}, D={D}, bf16; "
              f"largest row {r['max_sources']} sources, {r['empty_rows']} empty rows): max "
              f"err {err:.3g} of the largest output (tol {SCATTER_TOL}); two launches "
              f"equal bit for bit", flush=True)
    return out


def workflow_run(trainer, state, ds):
    """Phase 7c: the user workflow on the card. A checkpoint at an
    evaluation, restored into a fresh trainer, gives the same parameters,
    optimizer state, step and AUC; a submission file from it has one ranking
    per test impression; then the CLI at the small synthetic size."""
    from pytorch_news_recommender_tpu_torch import cli
    from pytorch_news_recommender_tpu_torch.train.checkpoint import CheckpointManager
    from pytorch_news_recommender_tpu_torch.train.loop import Trainer
    from pytorch_news_recommender_tpu_torch.train.submit import write_submission

    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    metrics = trainer.evaluate(state)
    mngr = CheckpointManager(WORK / "ckpt", trainer.cfg)
    mngr.save(state.step, state, metrics)
    fresh = Trainer(trainer.cfg, ds, device=DEVICE)
    restored = mngr.restore(fresh.init_state(seed=5))
    assert restored.step == state.step and mngr.best_step() == state.step
    for k, v in state.params.items():
        assert torch.equal(restored.params[k], v), k
    a, b = state.opt.state_dict(), restored.opt.state_dict()
    assert (a["count"], a["mini_step"]) == (b["count"], b["mini_step"])
    for tree in ("mu", "nu"):
        assert all(torch.equal(a[tree][k], b[tree][k]) for k in a[tree]), tree
    again = fresh.evaluate(restored)
    assert again["auc"] == metrics["auc"], (again["auc"], metrics["auc"])
    path = write_submission(fresh, restored, path=WORK / "submission.txt")
    lines = path.read_text().splitlines()
    n_imp = sum(1 for i in range(len(ds.test)) if len(ds.test.impression(i)[0]))
    assert len(lines) == n_imp, (len(lines), n_imp)
    for i, line in enumerate(lines):
        key, ranks = line.split(" ", 1)
        ranks = [int(r) for r in ranks.strip("[]").split(",")]
        assert int(key) == i + 1 and sorted(ranks) == list(range(1, len(ranks) + 1)), line
    print(f"[phase 7] checkpoint at step {state.step} restored into a fresh trainer: "
          f"parameters, optimizer state and step equal; dev AUC {again['auc']:.6f} = "
          f"{metrics['auc']:.6f}; submission: {len(lines)} lines, each a permutation",
          flush=True)

    # the CLI at the small synthetic size, on the card
    save, data = WORK / "cli", ["--data", "synthetic"]
    assert cli.main(["train", *data, "--epochs", "1", "--eval-step", "16",
                     "--save-dir", str(save)]) == 0
    ckpt = str(save / "nrms")
    assert cli.main(["eval", *data, "--ckpt", ckpt]) == 0
    assert cli.main(["submit", *data, "--ckpt", ckpt, "--out", str(WORK / "cli.txt")]) == 0
    assert (WORK / "cli.txt").read_text().count("\n") > 0
    vec = {}
    for kind, extra in (("native", []), ("int8", ["--int8"])):
        out = WORK / f"vectors_{kind}.npz"
        assert cli.main(["export-vectors", *data, "--ckpt", ckpt, "--out", str(out),
                         *extra]) == 0
        vec[kind] = out
    return vec, ckpt


def serve_exported(vec, ckpt):
    """The exported tables served: scores from ``vectors_file`` equal those
    of a recommender that encodes the corpus itself (f32), or are within
    int8 rounding of them."""
    from pytorch_news_recommender_tpu_torch import cli
    from pytorch_news_recommender_tpu_torch.serve import Recommender
    from pytorch_news_recommender_tpu_torch.train.checkpoint import load_config

    cfg = load_config(ckpt)
    args = cli.build_parser().parse_args(["eval", "--data", "synthetic", "--ckpt", ckpt])
    ds = cli._load_dataset(args, cfg)
    base = Recommender.from_checkpoint(ckpt, ds, device=DEVICE)
    hist, cands = [1, 2, 3, 4], list(range(5, 45))
    ref = base.score(hist, cands)
    for kind, path in vec.items():
        rec = Recommender.from_checkpoint(ckpt, ds, corpus_cache=kind, vectors_file=str(path),
                                          device=DEVICE)
        got = rec.score(hist, cands)
        err = float(np.abs(got - ref).max() / np.abs(ref).max())
        assert err <= SCORE_TOL[kind], (kind, err)
    print(f"[phase 7] cli train / eval / submit / export-vectors ran on the card; the "
          f"exported tables (float32 and int8) serve within {SCORE_TOL} of a fresh "
          f"encode", flush=True)


def ablation_run(FE, tag):
    """Phase 8: the stage ablation of the forward through
    ``chip_ablate_encoder.table`` at its two shapes, the main path of this
    phase (the launch counts set to 0 before it and read after it), each
    stage's kernel held to its plain version there. Returns the kernels-line
    entry."""
    import chip_ablate_encoder as CA
    from pytorch_news_recommender_tpu_torch.ops import ablate_encoder as AE

    AE.ablate_encoder.launches = FE.fused_news_encoder.launches = 0
    tables = {M: CA.table(M, real_mask) for M, real_mask in CA.SHAPES}
    launches = {"ablation": AE.ablate_encoder.launches, "fwd": FE.fused_news_encoder.launches}
    # per stage (and for the forward): its output, a warm-up, the timed launches
    per_stage = sum(CA.iters(M) + 2 for M, _ in CA.SHAPES)
    assert launches == {"ablation": len(AE.STAGES) * per_stage, "fwd": per_stage}, launches
    for (M, real_mask), t in zip(CA.SHAPES, tables.values()):
        for stage, r in t["stages"].items():
            out = r.pop("out")
            assert out.shape == (M, D) and bool(torch.isfinite(out.float()).all()), (M, stage)
            assert r["max_rel_err"] < ABLATION_TOL, (M, stage, r["max_rel_err"])
        CA.report(M, real_mask, t, tag)
    print(f"[phase 8] encoder ablation: every stage's kernel within {ABLATION_TOL} of its "
          f"plain version at M={' and M='.join(str(M) for M, _ in CA.SHAPES)}; launches "
          f"{launches}", flush=True)
    M0 = CA.SHAPES[0][0]
    stages = tables[M0]["stages"]
    variants = {}
    for stage, r in stages.items():
        v = {"label": CA.NAMES[stage], **{k: r[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by")}}
        v["max_rel_err"] = max(t["stages"][stage]["max_rel_err"] for t in tables.values())
        if "library_ms" in r:
            v["library_ms"] = r["library_ms"]
        variants[stage] = v
    v1 = stages["qkv"]
    return {"name": "encoder_ablation", "route": "cuda",
            "source": "pytorch_news_recommender_tpu_torch/ops/csrc/ablate_encoder.cu",
            "replaces": "benchmarks/ablate_encoder.py:30", "launches": launches["ablation"],
            "max_abs_err": max(r["max_abs_err"] for t in tables.values()
                               for r in t["stages"].values()),
            "max_rel_err": max(v["max_rel_err"] for v in variants.values()),
            "ms": v1["ms"], "plain_ms": v1["plain_ms"], "bound_ms": v1["bound_ms"],
            "bound_by": v1["bound_by"], "library_ms": None,
            "shape": {"M": M0, "L": CA.L, "D": D, "H": H, "Q": Q, "dtype": "bfloat16",
                      "mask": "all ones"},
            "variants": variants,
            "forward_ms": tables[M0]["forward"]["ms"], "forward_launches": launches["fwd"],
            "by_M": {M: {**{s: r["ms"] for s, r in t["stages"].items()},
                         "forward": t["forward"]["ms"]} for M, t in tables.items()}}


def word_dict(n_words):
    """Digit-free tokens ("wab", ...) for word ids 1..n_words-1."""
    def name(i):
        s = ""
        while i:
            i, r = divmod(i, 26)
            s += chr(97 + r)
        return "w" + s
    return {name(i): i for i in range(1, n_words)}


def make_requests(rng, n, n_news):
    return [([int(h) for h in rng.integers(1, n_news, size=rng.integers(0, 51))],
             [int(c) for c in rng.integers(1, n_news, size=rng.integers(5, 301))])
            for _ in range(n)]


def post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", path, body=json.dumps(body))
        resp = conn.getresponse()
        out = json.loads(resp.read())
        assert resp.status == 200, (path, out)
        return out
    finally:
        conn.close()


def plain_tower(rec, FE, tower, x, mask):
    """One tower through the plain version, in the serving dtype."""
    w = [p.to(rec._cd) for p in (tower.wqkv, tower.bqkv, tower.wo, tower.bo,
                                 tower.aw, tower.ab, tower.aq)]
    return FE.fused_news_encoder_reference(x.to(rec._cd), mask, *w,
                                           num_heads=tower.num_heads)


@torch.no_grad()
def plain_news(rec, FE, title):
    """News vectors of ``[n, L]`` title ids through the plain version."""
    enc = rec.model.news_encoder
    tmask = (title != 0).float()
    return plain_tower(rec, FE, enc.tower, enc.word_embedding(title, tmask), tmask)


@torch.no_grad()
def plain_scores(rec, FE, hist, cands):
    """Scores recomputed on the card through the plain version of both
    towers, from the word ids up."""
    ids = torch.as_tensor(rec._pad_history(hist).tolist() + list(cands),
                          device=DEVICE).long()
    vecs = plain_news(rec, FE, rec.news_feats["title"][ids])
    hmask = (ids[:rec.H] != 0).float()
    user = plain_tower(rec, FE, rec.model.user_encoder.tower, vecs[None, :rec.H],
                       hmask[None])[0]
    return (vecs[rec.H:].float() @ user.float()).cpu().numpy()


def serve_run(cfg, ds, params, cache, FE, rng):
    """Phase 3 for one cache mode: start the server, answer requests over
    HTTP, check a sample against the plain version. Returns the
    recommender."""
    from pytorch_news_recommender_tpu_torch.serve import Recommender
    from pytorch_news_recommender_tpu_torch.server import RecommenderServer

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec = Recommender(cfg, ds, params, corpus_cache=cache, device=DEVICE)
    torch.cuda.synchronize()
    startup_s = time.perf_counter() - t0
    srv = RecommenderServer(rec, port=0, batch_window_ms=5.0)
    srv.start(block=False)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        conn.close()
        assert health == {"status": "ok", "model": "nrms", "n_news": N_NEWS + 1,
                          "corpus_cache": cache}, health
        reqs = make_requests(rng, 64, N_NEWS + 1)
        with concurrent.futures.ThreadPoolExecutor(16) as pool:
            futs = [pool.submit(post, srv.port, "/score",
                                {"history": h, "candidates": c}) for h, c in reqs]
            served = [f.result()["scores"] for f in futs]
        for (h, c), s in zip(reqs, served):
            assert len(s) == len(c) and np.all(np.isfinite(s))
        worst = 0.0
        sample = [(h, c, s) for (h, c), s in zip(reqs, served) if h][:12]
        for h, c, s in sample:
            ref = plain_scores(rec, FE, h, c)
            worst = max(worst, float(np.abs(np.asarray(s) - ref).max()
                                     / max(1e-6, np.abs(ref).max())))
        assert worst <= SCORE_TOL[cache], f"served scores off by {worst:.3g} of scale"
        for h, _ in reqs[:8]:
            r = post(srv.port, "/top_k", {"history": h, "k": 10})
            ids, scores = np.asarray(r["ids"]), np.asarray(r["scores"])
            assert len(ids) == 10 and np.all((ids >= 1) & (ids <= N_NEWS))
            assert np.all(np.diff(scores) <= 0) and np.all(np.isfinite(scores))
        words = list(ds.dicts["word"])
        new_ids = []
        for i in range(2):
            title = " ".join(words[100 * i + j] for j in range(8)) + " unknown"
            new_ids.append(post(srv.port, "/add_news", {"title": title})["id"])
            title_ids = torch.as_tensor(rec.tokenize_new_news(title)["title"],
                                        device=DEVICE)[None]
            vec = rec._lookup(torch.as_tensor([new_ids[-1]], device=DEVICE)).float()
            ref = plain_news(rec, FE, title_ids).float()
            tol = TOLS[torch.bfloat16] if cache == "native" else 2 * TOLS[torch.bfloat16]
            torch.testing.assert_close(vec, ref, rtol=tol, atol=tol)
        assert new_ids == [N_NEWS + 1, N_NEWS + 2], new_ids
        r = post(srv.port, "/score", {"history": new_ids + [1, 2], "candidates": new_ids + [3]})
        assert len(r["scores"]) == 3 and np.all(np.isfinite(r["scores"]))
        ref = plain_scores(rec, FE, new_ids + [1, 2], new_ids + [3])
        new_err = float(np.abs(np.asarray(r["scores"]) - ref).max() / np.abs(ref).max())
        assert new_err <= SCORE_TOL[cache], f"fresh-news scores off by {new_err:.3g}"
        print(f"serve[{cache}]: start-up {startup_s:.2f} s, 64 /score + 8 /top_k + "
              f"2 /add_news answered; served vs plain max err {worst:.3g} of scale "
              f"(fresh news {new_err:.3g}; tol {SCORE_TOL[cache]})", flush=True)
        return rec
    finally:
        srv.stop()


def latency(fn, n):
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.percentile(out, 50)), float(np.percentile(out, 99))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    from pytorch_news_recommender_tpu_torch.config import Config, DataConfig
    from pytorch_news_recommender_tpu_torch.data import synthetic
    from pytorch_news_recommender_tpu_torch.models import build_model
    from pytorch_news_recommender_tpu_torch.ops import fused_encoder as FE
    from pytorch_news_recommender_tpu_torch.ops import segment_scatter as SS

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = card()
    tag = f"[{gpu}]"
    print(f"card: {gpu}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    # 1. setup
    t0 = time.perf_counter()
    FE.build()
    print(f"kernel build+load: {time.perf_counter() - t0:.1f} s", flush=True)

    # 2. forward kernel vs plain
    errs, times, fwd_kernels = check_kernel(FE)

    # 3. serving end to end, at full width
    cfg = Config(data=DataConfig(dataset="synthetic"))
    t0 = time.perf_counter()
    ds = synthetic.generate(cfg.data, seed=0, n_news=N_NEWS, vocab_size=VOCAB)
    ds.dicts = {"word": word_dict(VOCAB)}
    model = build_model(cfg.model.with_artifact_meta(ds.meta))
    model.reset_parameters(torch.Generator().manual_seed(0))
    params = model.state_dict()
    print(f"corpus + seeded weights: {time.perf_counter() - t0:.1f} s "
          f"({ds.news.n_news} rows, vocab {VOCAB})", flush=True)
    rng = np.random.default_rng(0)
    FE.fused_news_encoder.launches = 0
    rec = serve_run(cfg, ds, params, "native", FE, rng)
    serve_run(cfg, ds, params, "int8", FE, rng)
    serve_launches = FE.fused_news_encoder.launches
    per_encode = math.ceil(ds.news.n_news / cfg.train.eval_encode_chunk)
    assert serve_launches >= 2 * per_encode, (serve_launches, per_encode)
    print(f"fused_encoder_fwd launches on the serving path: {serve_launches} "
          f"({per_encode} per corpus encode)", flush=True)

    # 4. serving timings
    chunk = cfg.train.eval_encode_chunk
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec._encode_corpus(ds.news.n_news, chunk)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    print(f"{tag} corpus encode: {enc_s * 1e3:.1f} ms for {ds.news.n_news} news "
          f"= {ds.news.n_news / enc_s:.0f} news/s", flush=True)
    batch = [(h, rng.integers(1, N_NEWS, size=300).tolist(), 0)
             for h, _ in make_requests(rng, rec.BATCH_PAD, N_NEWS + 1)]
    p50, p99 = latency(lambda: rec.score_many(batch), 50)
    print(f"{tag} score_many (one batch of {rec.BATCH_PAD} x 300 candidates): "
          f"p50 {p50:.2f} ms, p99 {p99:.2f} ms", flush=True)
    hist = batch[0][0]
    p50, p99 = latency(lambda: rec.top_k(hist, 10), 50)
    print(f"{tag} top_k (k=10 over {rec.n_news} news): p50 {p50:.2f} ms, "
          f"p99 {p99:.2f} ms", flush=True)
    for (M, L), (k_ms, p_ms) in times.items():
        print(f"{tag} fused_encoder_fwd bf16 M={M} L={L}: kernel {k_ms:.4f} ms/call "
              f"({fwd_kernels} device kernels), plain {p_ms:.4f} ms, bound "
              f"{bound(M, L, 2)[0]:.4f} ms", flush=True)
    del rec

    # 5. backward and weight-gradient kernels vs plain
    bwd_errs, bwd_times = check_backward(FE)

    # 6. training at full width
    cfg, ds = training_data()
    run6 = train_run(FE, SS, cfg, ds, 6)
    train_launches, step_ms, bs = run6["launches"], run6["step_ms"], cfg.train.batch_size
    assert train_launches["scatter"] == 0, train_launches
    del run6
    steps = len(step_ms)
    p50, p99 = float(np.percentile(step_ms, 50)), float(np.percentile(step_ms, 99))
    print(f"{tag} train step (batch {bs}, {steps} steps): p50 {p50:.2f} ms, p99 "
          f"{p99:.2f} ms = {bs / p50 * 1e3:.0f} impressions/s", flush=True)
    print(f"{tag} fused_encoder_fwd bf16 M={TRAIN_SHAPES[1][0]} L={TRAIN_SHAPES[1][1]} "
          f"with dropout 0.2 + o1: {bwd_times['fwd_train']:.4f} ms/launch", flush=True)
    for M, L in TRAIN_SHAPES:
        k_ms, p_ms, i_ms = bwd_times[(M, L)]
        print(f"{tag} fused_encoder_bwd bf16 dropout 0.2 M={M} L={L}: kernels "
              f"{k_ms:.4f} ms/call (incl. 4 weight_grad; per-item kernels {i_ms:.4f} ms, "
              f"{FE.bwd_tile(L)[0]} items in {FE.bwd_tile(L)[1]}-row tiles), plain "
              f"{p_ms:.4f} ms, bound {bwd_bound(M, L)[0]:.4f} ms; "
              f"{train_launches['bwd'] / steps:.1f} calls per step", flush=True)
    for key, *_ in WGRAD_PRODUCTS:
        w_ms, wp_ms, wl_ms, (R, K, N, itemsize, bias) = bwd_times[key]
        wb = wgrad_bound(R, K, N, itemsize, bias)
        print(f"{tag} weight_grad {key}, {'bf16' if itemsize == 2 else 'f32'} a, R={R} "
              f"K={K} N={N}, bias {'fused' if bias else 'off'}: kernel {w_ms:.4f} ms, plain "
              f"{wp_ms:.4f} ms, torch.mm {wl_ms:.4f} ms, bound {wb[0]:.4f} ms ({wb[1]}); "
              f"{train_launches['wgrad'] / steps:.1f} launches per step", flush=True)

    # 7. training with the segment scatter, and the workflow on the card
    cfg7 = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dedup_gather_mxu=True))
    run7 = train_run(FE, SS, cfg7, ds, 7)
    mxu_launches = run7["launches"]
    assert mxu_launches["scatter"] == 2 * TRAIN_STEPS, mxu_launches
    p50_7, p99_7 = (float(np.percentile(run7["step_ms"], q)) for q in (50, 99))
    print(f"{tag} train step with dedup_gather_mxu (batch {bs}, {steps} steps): p50 "
          f"{p50_7:.2f} ms, p99 {p99_7:.2f} ms = {bs / p50_7 * 1e3:.0f} impressions/s "
          f"(default path above: p50 {p50:.2f} ms, p99 {p99:.2f} ms); segment_scatter "
          f"launches {mxu_launches['scatter']} = 2 per step", flush=True)
    sc = check_scatter(SS, run7["first"])
    for name, r in sc.items():
        print(f"{tag} segment_scatter bf16 {name} S={r['S']} U={r['U']} D={D}: kernel "
              f"{r['ms']:.4f} ms/call, plain version {r['plain_ms']:.4f} ms, one "
              f"index_add_ into zeros {r['library_ms']:.4f} ms, embedding_dense_backward "
              f"{r['edb_ms']:.4f} ms, "
              f"bound {r['bound'][0]:.4f} ms; device time by launch:", flush=True)
        for kernel, (n, us) in r["split"].items():
            print(f"{tag}   {kernel:28s} {n:g} per call, {us:8.2f} us", flush=True)
    vec, ckpt = workflow_run(run7["trainer"], run7["state"], ds)
    del run7
    serve_exported(vec, ckpt)

    # 8. the stage ablation of the forward
    ablation = ablation_run(FE, tag)

    k_ms, p_ms = times[SHAPES[0]]
    b_ms, b_by = bound(*SHAPES[0], 2)
    bk_ms, bp_ms, bi_ms = bwd_times[TRAIN_SHAPES[1]]
    bb_ms, bb_by = bwd_bound(*TRAIN_SHAPES[1])
    w_ms, wp_ms, wl_ms, (R, K, N, _, _) = bwd_times["wgrad"]
    wb_ms, wb_by = wgrad_bound(R, K, N, 2)
    products = {}
    for key, *_ in WGRAD_PRODUCTS:
        ms, plain_ms, library_ms, (Rp, Kp, Np, itemsize, bias) = bwd_times[key]
        products[key] = {"K": Kp, "N": Np, "a_itemsize": itemsize, "bias": bias, "ms": ms,
                         "plain_ms": plain_ms, "library_ms": library_ms,
                         "bound_ms": wgrad_bound(Rp, Kp, Np, itemsize, bias)[0],
                         "max_rel_err": bwd_errs[key], "max_abs_err": bwd_errs[key + "_abs"]}
    src = "pytorch_news_recommender_tpu_torch/ops/csrc/"
    tpu = "pytorch_news_recommender_tpu/ops/pallas/fused_encoder.py:"
    print(json.dumps({"kernels": [
        {"name": "fused_encoder_fwd", "route": "cuda", "source": src + "fused_encoder.cu",
         "replaces": tpu + "149",
         "launches": serve_launches + train_launches["fwd"],
         "launches_by_path": {"serve": serve_launches, "train": train_launches["fwd"],
                              "train_dedup_gather_mxu": mxu_launches["fwd"]},
         "max_abs_err": max(v for k, v in errs.items() if "bfloat16" in k[0]),
         "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
         "library_ms": None,
         "shape": {"M": SHAPES[0][0], "L": SHAPES[0][1], "D": D, "H": H, "Q": Q,
                   "dtype": "bfloat16"},
         "launches_per_call": {"wrapper": FWD_LAUNCHES, "device_kernels": fwd_kernels},
         "tile_rows": FE.fwd_tile(SHAPES[0][1])[1],
         "by_shape": {f"M={M},L={L}": {"ms": k, "plain_ms": p, "bound_ms": bound(M, L, 2)[0]}
                      for (M, L), (k, p) in times.items()},
         "train_ms": bwd_times["fwd_train"]},
        {"name": "fused_encoder_bwd", "route": "cuda", "source": src + "fused_encoder_bwd.cu",
         "replaces": tpu + "261",
         "launches": train_launches["bwd"],
         "max_abs_err": bwd_errs["bwd_abs"], "max_rel_err": bwd_errs["bwd_rel"],
         "ms": bk_ms, "plain_ms": bp_ms, "bound_ms": bb_ms, "bound_by": bb_by,
         "library_ms": None, "kernels_ms": bi_ms,
         "tile_rows": FE.bwd_tile(TRAIN_SHAPES[1][1])[1],
         "shape": {"M": TRAIN_SHAPES[1][0], "L": TRAIN_SHAPES[1][1], "D": D, "H": H, "Q": Q,
                   "dtype": "bfloat16", "dropout": 0.2}},
        {"name": "encoder_weight_grad", "route": "cuda",
         "source": src + "fused_encoder_bwd.cu", "replaces": tpu + "432",
         "launches": train_launches["wgrad"],
         "launches_by_path": {"train": train_launches["wgrad"],
                              "train_dedup_gather_mxu": mxu_launches["wgrad"]},
         "max_abs_err": max(p["max_abs_err"] for p in products.values()),
         "max_rel_err": max(p["max_rel_err"] for p in products.values()),
         "ms": w_ms, "plain_ms": wp_ms, "bound_ms": wb_ms, "bound_by": wb_by,
         "library_ms": wl_ms,
         "shape": {"R": R, "K": K, "N": N, "bias": True, "dtype": "bfloat16 x float32"},
         "products": products},
        {"name": "segment_scatter", "route": "cuda", "source": src + "segment_scatter.cu",
         "replaces": "pytorch_news_recommender_tpu/ops/pallas/segment_scatter.py:38",
         "launches": mxu_launches["scatter"],
         "max_abs_err": max(r["abs_err"] for r in sc.values()),
         "max_rel_err": max(r["err"] for r in sc.values()),
         "ms": sc["browsed_idx"]["ms"], "plain_ms": sc["browsed_idx"]["plain_ms"],
         "bound_ms": sc["browsed_idx"]["bound"][0], "bound_by": "bytes",
         "library_ms": sc["browsed_idx"]["library_ms"], "library_call": "index_add_",
         "shape": {"S": sc["browsed_idx"]["S"], "U": sc["browsed_idx"]["U"], "D": D,
                   "dtype": "bfloat16"},
         "embedding_dense_backward_ms": sc["browsed_idx"]["edb_ms"],
         "split_us": sc["browsed_idx"]["split"],
         "candidate": {**{k: sc["candidate_idx"][k] for k in ("S", "ms", "plain_ms", "bound")},
                       "library_ms": sc["candidate_idx"]["library_ms"],
                       "embedding_dense_backward_ms": sc["candidate_idx"]["edb_ms"],
                       "split_us": sc["candidate_idx"]["split"]}},
        ablation,
    ]}), flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
