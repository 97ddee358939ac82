"""Where today's forward of the fused news encoder spends its time, part
by part, on one NVIDIA card.

    python3 chip_ablate_encoder.py

The counterpart of the JAX package's ``benchmarks/ablate_encoder.py``
(``main`` and ``main2``): the six truncations of the forward
(``ops/ablate_encoder.py``; ``ops/csrc/ablate_encoder.cu`` says what each
computes), built from the pieces of today's tensor-core forward
(``ops/csrc/tiles.cuh``; V3 runs the forward's own tail kernel), at
M=28,672, L=20 with the all-ones mask, as the harness runs them, and at
M=4096, L=20 with a real mask (the training step's long block, a
corpus-encode chunk), bf16, D=300, 10 heads, Q=200. For each stage it
prints the kernel's time (CUDA events), its plain version's, its bound, its
largest difference from the plain version, whether two launches gave the
same bits, and for V0 the time of ``x.view(M, L, D).sum(1)``, the one
PyTorch call of the same function; then the forward kernel
(``fused_news_encoder``) on the same ``x``, and the split of the forward
that the stages give: the QKV product (V1), the forward's own attention
over its 64-row tiles (forward - V3: V3 is the forward with scores,
softmax and P v left out), the tail with its ``o1`` round trip through
device memory (V3 - V1); then the harness's attention over 160-row
subtiles (V2 - V1) and the forward against V2 + (V3 - V1). Every timing
line is tagged with the card's name and power limit. Needs a CUDA card:
without one it prints no result and exits 2.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

import chip_smoke as CS
from pytorch_news_recommender_tpu_torch.ops import ablate_encoder as AE
from pytorch_news_recommender_tpu_torch.ops import fused_encoder as FE

D, H, Q, L = CS.D, AE.H, CS.Q, AE.L
SHAPES = ((28_672, False), (4096, True))   # (M, real mask)
NAMES = {"passthrough": "V0", "qkv": "V1", "attn": "V2", "tail": "V3",
         "attn_slices": "V2a", "attn_nosoftmax": "V2b"}


def iters(M, stage=None):
    """Timed launches of a stage after one warm-up. V0 (a sum of some 0.1
    ms) takes 100, twice, in turns with its PyTorch sum."""
    if stage == "passthrough":
        return 100
    return 5 if M > 10_000 else 20


def launches(M):
    """The ablation's launches in :func:`table` at ``M``: per stage its
    output, a repeat, then a warm-up and the timed launches (twice for V0)."""
    return sum(2 + (2 if s == "passthrough" else 1) * (iters(M, s) + 1) for s in AE.STAGES)


def inputs(M, real_mask, device, dtype=torch.bfloat16, seed=0):
    """The harness's inputs in its layout (``x2, maskf, wqkv, bqkv, wo, bo,
    aw, ab, aq``): x ~ N(0, 1) drawn on the device, weights N(0, 0.05²) and
    aq N(0, 0.1²) as in its ``main``, biases N(0, 0.01²). The mask is all
    ones, or real: 0..L tokens per item with item 0 all pad (so the first
    160-row subtile holds an all-pad item) and item 1 full, pad tokens of x
    zeroed."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((M, L, D), generator=gen, device=device)
    mask = torch.ones((M, L), device=device)
    if real_mask:
        lens = rng.integers(0, L + 1, size=M)
        lens[0], lens[1] = 0, L
        mask = torch.as_tensor(np.arange(L)[None, :] < lens[:, None], device=device).float()
        x = x * mask[..., None]
    shapes = [(D, 3 * D), (1, 3 * D), (D, D), (1, D), (D, Q), (1, Q), (Q, 1)]
    scales = [0.05, 0.01, 0.05, 0.01, 0.05, 0.01, 0.1]
    w = [torch.as_tensor(rng.normal(size=s) * c, dtype=torch.float32, device=device).to(dtype)
         for s, c in zip(shapes, scales)]
    return [x.reshape(M * L, D).to(dtype), mask.reshape(M * L, 1)] + w


def encoder_args(args):
    """The same inputs in the forward's layout: ``x [M, L, D]``, ``mask [M,
    L]``, the biases and ``aq`` flat."""
    x2, maskf, wqkv, bqkv, wo, bo, aw, ab, aq = args
    M = x2.shape[0] // L
    return (x2.view(M, L, D), maskf.view(M, L), wqkv, bqkv.reshape(-1), wo,
            bo.reshape(-1), aw, ab.reshape(-1), aq.reshape(-1))


def table(M, real_mask=False, device="cuda"):
    """Each stage once through :func:`ablate_encoder`, held to its plain
    version on the same inputs, and on a card timed beside the plain
    version and (V0, in turns) the PyTorch sum; then the full forward on
    the same x.
    Two launches of each stage are compared bit for bit. Returns
    ``{"inputs", "stages": {stage: {"out", "bit_equal", "max_abs_err",
    "max_rel_err", "bound_ms", "bound_by", "ms", "plain_ms"[, "library_ms"]}},
    "forward": {...}}``; on the CPU every time is None (a CPU run measures no
    device time)."""
    args = inputs(M, real_mask, device)
    on_card = torch.device(device).type == "cuda"

    def timed(fn, stage=None):
        return CS.cuda_ms(fn, iters(M, stage)) if on_card else None

    stages = {}
    for stage in AE.STAGES:
        out = AE.ablate_encoder(stage, *args)
        again = AE.ablate_encoder(stage, *args)
        plain = AE.ablate_encoder_reference(stage, *args)
        row = {"out": out, "bit_equal": bool(torch.equal(out, again)),
               "max_rel_err": CS.rel_err(out, plain),
               "max_abs_err": float((out.float() - plain.float()).abs().max())}
        kernel = lambda: AE.ablate_encoder(stage, *args)  # noqa: E731
        if stage == "passthrough":
            # kernel, sum, kernel, sum; the better of each pair
            library = lambda: args[0].view(M, L, D).sum(1)  # noqa: E731
            k1, l1, k2, l2 = (timed(f, stage) for f in (kernel, library, kernel, library))
            row["ms"], row["library_ms"] = (min(k1, k2), min(l1, l2)) if on_card else (None, None)
        else:
            row["ms"] = timed(kernel)
        row["plain_ms"] = timed(lambda: AE.ablate_encoder_reference(stage, *args))
        row["bound_ms"], row["bound_by"] = CS.ablation_bound(stage, M, L, args[0].element_size())
        stages[stage] = row
    enc = encoder_args(args)
    forward = {"out": FE.fused_news_encoder(*enc, num_heads=H),
               "ms": timed(lambda: FE.fused_news_encoder(*enc, num_heads=H)),
               "plain_ms": timed(lambda: FE.fused_news_encoder_reference(*enc, num_heads=H))}
    forward["bound_ms"], forward["bound_by"] = CS.bound(M, L, args[0].element_size())
    return {"inputs": args, "stages": stages, "forward": forward}


def report(M, real_mask, t, tag):
    """Prints one shape's table, each line tagged with the card."""
    mask = "a real mask" if real_mask else "the all-ones mask"
    print(f"{tag} encoder ablation, M={M} L={L} D={D} H={H} Q={Q} bf16, {mask}", flush=True)
    for stage, r in t["stages"].items():
        lib = (f", x.view(M, L, D).sum(1) {r['library_ms']:.4f} ms"
               if "library_ms" in r else "")
        print(f"{tag}   {NAMES[stage]:3s} {stage:14s}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}){lib}; "
              f"max err vs plain {r['max_rel_err']:.3g} of the largest output; two launches "
              f"{'equal' if r['bit_equal'] else 'DIFFER'} bit for bit", flush=True)
    f = t["forward"]
    print(f"{tag}   full forward (fused_news_encoder): kernel {f['ms']:.4f} ms, plain "
          f"{f['plain_ms']:.4f} ms, bound {f['bound_ms']:.4f} ms ({f['bound_by']})", flush=True)
    ms = {s: r["ms"] for s, r in t["stages"].items()}
    attn, tail = ms["attn"] - ms["qkv"], ms["tail"] - ms["qkv"]
    print(f"{tag}   read as today's forward: QKV product (V1) {ms['qkv']:.4f} ms; its own "
          f"64-row attention (forward - V3) {f['ms'] - ms['tail']:.4f} ms; tail with the o1 "
          f"round trip (V3 - V1) {tail:.4f} ms. The harness's 160-row attention (V2 - V1) "
          f"{attn:.4f} ms, without softmax and mask (V2b - V1) "
          f"{ms['attn_nosoftmax'] - ms['qkv']:.4f} ms; V2 + (V3 - V1) {ms['attn'] + tail:.4f} "
          f"ms against the forward's {f['ms']:.4f} ms; x read and summed (V0) "
          f"{ms['passthrough']:.4f} ms", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_ablate_encoder: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = CS.card()
    print(f"card: {gpu}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    FE.build()
    for M, real_mask in SHAPES:
        report(M, real_mask, table(M, real_mask), f"[{gpu}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
