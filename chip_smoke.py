"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # one card: phases 1-24 below
    python3 chip_smoke.py --nccl     # two or more cards: data- and model-
                                     # parallel training over nccl, and
                                     # mesh serving (``nccl_run``)

1. Builds the kernels from ``pytorch_news_recommender_tpu_torch/ops/csrc``
   (the fused encoder forward, its backward and the tensor-core weight
   gradients, the segment scatter, the forward's stage ablation; ninja
   compiles the sources in parallel).
2. Holds the forward kernel against its plain PyTorch version at the
   serving shapes, NAML's abstract view (M=4096, L=40) and NAML's user
   tower (M=512, 32 and 1 at L=50, D=800, 10 heads, Q=400, in the kernels'
   wide variants) in float32 and bfloat16, with repeat launches equal bit
   for bit, one wrapper launch and three device kernels per call (read
   from the profiler), and times it at every serving and training shape,
   at M=28,672, L=20 and at NAML's shapes.
3. Serves NRMS at full width (D=300, 10 heads, query dim 200, title 20,
   history 50, bf16) over HTTP on a seeded synthetic corpus of 65,238 news
   (the news count of MIND-small), in both corpus-cache modes, and checks a
   sample of the served answers against the plain version.
4. Times the serving paths.
5. Holds the backward and weight-gradient kernels, and the forward with
   dropout and the ``o1`` residual, against their plain versions at the
   training step's shapes, float32 and bfloat16, dropout 0 and 0.2, and at
   NAML's abstract view and user tower (dropout 0), with two backward calls
   equal bit for bit and one backward launch and four weight-gradient
   launches per call, and times the backward whole and its per-item kernels
   alone; then the weight-gradient kernel alone at each product of one
   backward call over the long block's R=81,920 token rows (dWqkv with bf16
   and f32 ``a``, dWo, daw with the bias fused, daq without) and over NAML's
   user tower's R=25,600 (K=800), against the plain version and
   ``torch.mm``.
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
   table: six truncations of today's forward, built from its tensor-core
   pieces, then the full forward on the same input) at M=28,672, L=20 with
   the all-ones mask and at M=4096 with a real mask that holds an all-pad
   item, holds each stage's kernel against its plain version and two of its
   launches against each other bit for bit, and counts the launches.
9-11. Trains, evaluates and serves the ``nrms_entity``, ``tanr`` and
   ``hierec`` families at NRMS's full width on one corpus with 10 entities
   per news (a 20,000-entity vocabulary, 100-d vectors), 18 categories and
   294 subcategories: one step through the kernels against the same step
   through the plain versions (TANR's topic loss and HieRec's gate
   included), FAMILY_STEPS steps and an evaluation with the plain versions
   made to raise (no fallback), then a ``Recommender`` at the trained
   weights: corpus encode, ``score_many`` and ``top_k`` times, and its
   scores and top-10 scores against a recommender that runs the plain
   versions.
12. The same for ``naml`` (title and abstract towers at D=300, the user
   tower at D=800) on that corpus with abstracts of NAML_ABST_LEN real
   words, and one ``add_news`` with a title, an abstract and a category,
   its vector held to the plain towers'; then a checkpoint of the trained
   state restored into a fresh trainer and evaluated, and ``cli train`` /
   ``eval`` / ``serve --model naml`` at the small synthetic size.
13-15. The same for ``nrms_bert`` (768-wide BERT vectors in a trainable
   table, the user tower at D=512 with 4 heads of 128), ``disan`` (the
   DiSAN news tower in plain PyTorch, the user tower at D=600 with 10 heads
   of 60; its peak device memory printed) and ``lstur`` (a CNN news tower
   and a masked GRU over the history with a long-term embedding of 50,000
   users; no encoder kernel, its launch counts 0), on that corpus with
   BERT vectors and users: ``score_many`` with distinct user ids, ``top_k``
   (for ``lstur`` its refusal), ``add_news``'s refusal for ``nrms_bert``,
   and ``cli train`` / ``eval`` / ``serve`` of each at the small synthetic
   size. Phases 2 and 5 hold the kernels at both user towers.
16-19. The same for ``gnn`` (NRMS's title and user towers through the
   kernels, two GAT layers over 15 graph neighbors; each training step's
   dedup batch carries its 2-hop neighborhood closure, which fills the
   65,536-news frontier bucket: the title tower runs at M=65,536, L=20),
   ``fastformer``, ``npa`` and ``list_rank`` (no encoder kernel, their
   launch counts 0), on that corpus with a 15-neighbor graph (``list_rank``
   at 15 negatives a training impression, as ``cli train`` sets it):
   ``top_k`` refused for ``fastformer``, the ``Recommender`` refused for
   ``npa`` (its news vectors depend on the user), and ``cli train`` /
   ``eval`` / ``serve`` of each (``serve --model npa`` refused). Phases 2
   and 5 also hold the kernels at the GNN's frontier shape (M=65,536,
   L=20: 1,310,720 token rows) and the weight-gradient products over its
   rows.

20. Trains NRMS at phase 6's configuration with ``optimizer="adafactor"``
   (factored second moments for the word table and the towers' matrices):
   one step through the kernels against the plain step (loss, each
   parameter's gradient at its own scale, the bf16 noise taken from the
   plain step against its float32 twin, and the parameters after the
   update), the same gradients in float32 training, ADAFACTOR_STEPS steps, an
   evaluation, step time and peak memory beside Adam's, and a checkpoint
   -> restore -> eval round trip equal bit for bit.
21. The C++ fast path of ``native/`` (built with g++ into
   ``build/native/``; it must build here): phase 6's batches from its
   dedup equal numpy's bit for bit, and the corpus's titles, written as
   text, tokenize to the same ids through it as through the Python loop;
   host times of both.
22. Two ranks on the one card (``torch.multiprocessing`` spawn, ``gloo``,
   both on ``cuda:0``, the kernels built before the spawn): NRMS at full
   width, global batch 512 (256 a rank), RANK_STEPS steps through the
   sliced feed; with dropout 0 the ranks' losses and parameters equal bit
   for bit after every step, and the losses, the first gradients and the
   first update within 1% / 2e-2 of one process on the same global batches
   (``Trainer(replay_ranks=2)``: both ranks' blocks in one multi-block
   batch); with dropout 0.2 each
   rank's kernel applies the mask of
   ``seed + rank * 1,000,003`` (``ops.fused_encoder.shard_seed``); then
   ``cli train --coordinator ... --log-attention`` and ``cli submit`` on
   two ranks at the small synthetic size, whose file equals one process's.
23. The model axis on the one card (``mesh_worker``, ``gloo``, every rank on
   ``cuda:0``): NRMS at full width on phase 6's corpus with the word table
   split by rows over the two ranks of each data row, at (1 x 2) with psum
   and with a2a lookups (capacity 2.0) and at (2 x 2) with a2a, MESH_STEPS
   steps at dropout 0 and 0.2: every rank's loss equal bit for bit, the
   replicated parameters equal on every rank and each block on its data
   group, against one process on the same global batches (loss 1%, the
   first update with the blocks joined, as phase 22 holds it), each rank's
   kernel mask at its data index's folded seed, a NaN loss at capacity
   0.02, step times, peak memory and launches per rank, and a (1 x 2)
   checkpoint restored in one process with the ranks' AUC.
24. ``Recommender(mesh=...)`` with the corpus cache in MESH_BLOCKS row
   blocks on the one card, on phase 3's corpus (65,239 rows, padded), in
   both cache modes, against the single-device recommender (``score``,
   ``score_many``, ``top_k``, ``add_news`` past the blocks' end) with both
   timed; then ``cli serve --mesh`` answering over HTTP.

Prints timings tagged with the card's name and power limit, the kernels'
line as JSON, and ends with ``{"ok": true, "device": {...}}``. Any failed
phase raises; there is no result without a CUDA card, or when the script
is not in a checkout of the repo (the package must lie beside it).
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import http.client
import itertools
import dataclasses
import json
import math
import os
import pathlib
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

N_NEWS = 65_238          # MIND-small's news count; the table adds the pad row
VOCAB = 32_000
D, H, Q = 300, 10, 200   # NRMS's widths: every family's title (and abstract) tower
WIDTH = (D, H, Q)
# NAML's user tower: the 800-wide news vector, 10 heads of 80, query dim 400
NAML_USER = (800, 10, 400)
# nrms_bert's user tower: bert_embed_size 512, 4 heads of 128 (the JAX
# default of 10 heads does not divide 512; 4 is the most either CLI takes),
# query_vector_dim_large 400; disan's: the 600-wide news vector (2 x 300),
# 10 heads of 60, query dim 200
BERT_USER = (512, 4, 400)
DISAN_USER = (600, 10, 200)
# the user towers past NRMS's width, each in the kernels' wide variants
WIDE_USERS = {"naml": NAML_USER, "nrms_bert": BERT_USER, "disan": DISAN_USER}
SHAPES = [(4096, 20), (32, 50), (1, 50)]   # corpus chunk, score_many batch, single user
# the GNN's title tower in training: its 2-hop frontier fills the largest
# frontier bucket on the 65,238-news corpus (``GNN_FRONTIER_BUCKETS``)
GNN_FRONTIER = (65_536, 20)
# the training step's encoder calls: short news block, long news block, users
TRAIN_SHAPES = [(4096, 12), (4096, 20), (512, 50)]
TOLS = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
# phase 2's checks, (M, L, (D, H, Q)): NRMS's serving shapes, NAML's
# abstract view (a corpus chunk at L=40), the user towers of NAML,
# nrms_bert and disan at the training batch, the score_many batch and one
# user, and the GNN's frontier
CHECK_SHAPES = ([(M, L, WIDTH) for M, L in SHAPES] + [(4096, 40, WIDTH)]
                + [(M, 50, w) for w in WIDE_USERS.values() for M in (512, 32, 1)]
                + [(*GNN_FRONTIER, WIDTH)])
# the forward timed at every serving and training shape, at the stage
# ablation's M=28,672, and at NAML's
FWD_SHAPES = ([(M, L, WIDTH) for M, L in SHAPES + TRAIN_SHAPES + [(28_672, 20)]]
              + CHECK_SHAPES[len(SHAPES):])
# phase 5's checks, (M, L, (D, H, Q), dropout rates): NRMS's training step,
# then NAML's abstract view and the user towers of NAML, nrms_bert and disan
# (no dropout in a user tower), and the GNN's frontier
BWD_SHAPES = ([(M, L, WIDTH, (0.0, 0.2)) for M, L in TRAIN_SHAPES]
              + [(4096, 40, WIDTH, (0.0,))]
              + [(512, 50, w, (0.0,)) for w in WIDE_USERS.values()]
              + [(*GNN_FRONTIER, WIDTH, (0.0, 0.2))])
# launches of one forward call: the wrapper's count, and the device kernels
# (the weight layout, the attention, the tail), read from the profiler
FWD_LAUNCHES, FWD_KERNELS = 1, 3
# backward kernel vs plain version, max|a - b| / max|b| per output
BWD_TOLS = {torch.float32: 2e-3, torch.bfloat16: 2e-2}
TRAIN_STEPS = 40
# phases 9-11: the families trained beside NRMS, and the steps of each
FAMILIES = ("nrms_entity", "tanr", "hierec")
FAMILY_STEPS = 12
# phase 12: NAML on the same corpus with abstracts of 28 real words on
# average (sd 8, clipped to 1..40), the synthetic generator's default fill
NAML_ABST_LEN = (28.0, 8.0)
# phases 13-15: the families on the corpus with BERT vectors (BERT-base's
# 768-wide hidden state) and users (MIND-small's 50,000), and the model
# fields each sets beside the JAX defaults
NEW_FAMILIES = {"nrms_bert": {"user_heads_num": BERT_USER[1]}, "disan": {}, "lstur": {}}
BERT_DIM, N_USERS = 768, 50_000
# phases 16-19: the families on that corpus with a 15-neighbor news graph,
# and the model fields each sets beside the JAX defaults (list_rank's 4 user
# heads: 10 do not divide its 512-wide news vectors, in either package)
LATER_FAMILIES = {"gnn": {}, "fastformer": {}, "npa": {}, "list_rank": {"user_heads_num": 4}}
# NPA's family default learning rate (2e-2, FAMILY_TRAIN_DEFAULTS) was tuned
# at a narrow width; at the JAX default widths its loss climbs in both
# packages, so phase 18 trains at the shared default 1e-3 (``cli train --lr
# 1e-3``) and only probes 2e-2 (``lr_probe``)
LATER_TRAIN = {"npa": {"learning_rate": 1e-3}}
NPA_PROBE_LR, PROBE_STEPS = 2e-2, 6
GNN_NEIGHBORS = 15
# list_rank trains on 15 negatives an impression, as cli train sets it
LIST_RANK_SAMPLE_SIZE = 15
# parameters whose exact gradient is 0 (a constant added to every
# candidate's score): list_rank's fc bias and the last block's output
# LayerNorm bias; they get float rounding, which may be 0
EXACT_ZERO_GRADS = {"list_rank": ("fc.bias", "block0.ffn.norm.bias")}
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
# split of each f32 operand), only the order and the split's 2^-16 differ.
# Every product is also held to the same function in float64 at this
# tolerance: the kernel's error grows with its splits' rows (81,920 rows a
# split: 2.0e-4 of the largest output; ``kWgMaxRows`` caps them), the
# plain version's stays near 2e-6
WGRAD_TOL = 1e-4
# the weight-gradient products of one backward call in bf16 training (name,
# a's width K, b's width N, a's dtype, bias fused, token rows R): dWqkv,
# dWo, daw, daq over the long block's rows; dWqkv with an f32 a, as in f32
# training; and the four at each wide user tower over the training batch's
# 25,600 history rows (K+1 = 801, 601 and 513 span three or two of the
# kernel's 320-row output tiles)
R_LONG = TRAIN_SHAPES[1][0] * TRAIN_SHAPES[1][1]
R_USER = 512 * 50
R_GNN = GNN_FRONTIER[0] * GNN_FRONTIER[1]
WGRAD_PRODUCTS = [("wgrad", D, 3 * D, torch.bfloat16, True, R_LONG),
                  ("wgrad_f32", D, 3 * D, torch.float32, True, R_LONG),
                  ("wgrad_dwo", D, D, torch.bfloat16, True, R_LONG),
                  ("wgrad_daw", D, Q, torch.float32, True, R_LONG),
                  ("wgrad_daq", Q, 1, torch.float32, False, R_LONG)] + [
    (f"{fam}_wgrad{sfx}", K, N, dtype, bias, R_USER)
    for fam, (Dw, _, Qw) in WIDE_USERS.items()
    for sfx, K, N, dtype, bias in (("", Dw, 3 * Dw, torch.bfloat16, True),
                                   ("_dwo", Dw, Dw, torch.bfloat16, True),
                                   ("_daw", Dw, Qw, torch.float32, True),
                                   ("_daq", Qw, 1, torch.float32, False))] + [
    # the GNN's title tower over its frontier's 1,310,720 token rows
    ("gnn_wgrad", D, 3 * D, torch.bfloat16, True, R_GNN),
    ("gnn_wgrad_dwo", D, D, torch.bfloat16, True, R_GNN),
    ("gnn_wgrad_daw", D, Q, torch.float32, True, R_GNN),
    ("gnn_wgrad_daq", Q, 1, torch.float32, False, R_GNN)]
# ablation kernel vs plain version, max|a - b| / max|b| per stage: both
# round to bf16 at the harness's points, their f32 sums run in another order,
# so a value at a rounding edge may land one bf16 step away; the kernel also
# rounds q, k, v and p to bf16 for the attention products, as the bf16
# forward does (some 2^-9 of each product, ablate_encoder.cu's header)
ABLATION_TOL = 2e-2
DEVICE = "cuda"
# phase 20: Adafactor's steps; phase 22: the two ranks' steps (at phase 6's
# global batch) and the dropout rate of the mask check
ADAFACTOR_STEPS = 12
RANK_STEPS, RANK_DROPOUT = 6, 0.2
# phases 20 and 22: a parameter whose plain bf16 gradient lies further than
# this relative L2 distance from the plain float32 gradient of the same step
# is at bf16 noise (chosen from the plain versions alone): its bf16 update is
# not determined, so it is left out of the update check and its kernel
# gradient is held to the float32 one within twice the plain one's largest
# error (the float32 step below holds it tightly). On the H100 at NRMS's
# first step the two towers' pooling weights (aw, ab, aq) read 0.011-0.019,
# every other parameter 0.0046-0.0076
GRAD_NOISE = 1e-2
# phase 20, float32 training: the kernel step's gradient vs the plain step's,
# max|a - b| / max|b| of each parameter. The f32 kernels' split products
# come within 2e-4 of a product's largest output (WGRAD_TOL), and a
# gradient chains a few of them; a bias gradient whose terms cancel loses
# more against its own largest entry (the user tower's pooling bias `ab`,
# whose softmax gradient sums to 0 over each history: 2.2e-3 on the H100)
F32_GRAD_TOL = 1e-2
# bf16 gradients, kernel vs plain step, of each parameter not at bf16 noise,
# as a share of its own largest entry; and the update after it, as a share
# of each parameter's largest change
GRAD_TOL = UPDATE_TOL = 2e-2
# --nccl: the seconds a rank may take for its cli train and cli submit
NCCL_RANK_S = 150
# phase 23: the model axis on the one card, a (world / 2, 2) mesh of ranks:
# the lookup schedules each world trains with, its steps at each dropout
# rate, the a2a bucket capacity factor, and the factor that must overflow
MESH_RUNS = {2: ("psum", "a2a"), 4: ("a2a",)}
MESH_STEPS = {2: 6, 4: 4}
MESH_CAPACITY, MESH_OVERFLOW = 2.0, 0.02
# phase 24: the corpus cache's row blocks, all on the one card
MESH_BLOCKS = 4
# phase 24: a mesh score within this share of the largest |score| of the
# single-device one (they gather the same rows); top_k ids may differ only
# where two scores lie within this relative distance
MESH_SCORE_TOL, MESH_TIE = 1e-4, 1e-5


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def encoder_inputs(seed, M, L, dtype, scales=None, width=WIDTH):
    """Seeded masked tokens (rows of 0..L real tokens) and encoder weights
    at ``width = (D, H, Q)``; the weights' scales default to 0.05 (matrices),
    0.01 (biases) and 0.1 (aq) at NRMS's width, to the encoder's own init
    scales elsewhere (``AttentionPoolTower.init_scales``). NAML's user tower
    is checked with the latter: at D=800 the D=300 scales put the bf16
    rounding-point differences between the kernel and the plain chain alone
    past the elementwise 2e-2 (``tests/test_torch_fused_encoder.py::
    test_bf16_rounding_points_alone_set_the_d800_input_scale``)."""
    from pytorch_news_recommender_tpu_torch.models.layers import AttentionPoolTower

    D, _, Q = width
    if scales is None:
        scales = (0.05, 0.01, 0.05, 0.01, 0.05, 0.01, 0.1) if width == WIDTH \
            else AttentionPoolTower.init_scales(D, Q)
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


def bound(M, L, itemsize, width=WIDTH):
    """(ms, "bytes" | "operations"): the least time for the work, the larger
    of the bytes moved once over the memory rate and the operations over the
    peak rate for the operand type. The kernel does the same work whatever
    the mask, so the shapes decide it."""
    D, H, Q = width
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


def bwd_bound(M, L, itemsize=2, width=WIDTH):
    """Backward bound: 6·L·D·(3D+D+Q) + 10·H·L²·dh FLOP per item (the
    projections for the recompute, dx and the weight gradients, and the
    attention products) over the bf16 peak; bytes are g, x, o1 and the mask
    in, dx and the weight gradients out."""
    D, H, Q = width
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


def device_kernels(fn, tries=3):
    """Device kernels (and memsets) that one call of ``fn`` launches, from
    the profiler: the most that any of ``tries`` profiled calls shows. The
    profiler can miss a short kernel of a call (a one-user forward has shown
    two of its three unconditional launches) but adds none, so a kernel
    too many still shows, and so does one missing from every call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    counts = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        counts.append(sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA))
    return max(counts)


def check_kernel(FE):
    """Phase 2: kernel vs plain version at CHECK_SHAPES, two dtypes, one
    wrapper launch and FWD_KERNELS device kernels per call, repeat calls
    equal bit for bit; then the times at every shape of FWD_SHAPES (bf16)."""
    errs, times = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        for M, L, width in CHECK_SHAPES:
            h = width[1]
            args, valid = encoder_inputs(M * 100 + L, M, L, dtype, width=width)
            before = FE.fused_news_encoder.launches
            got = FE.fused_news_encoder(*args, num_heads=h)
            torch.cuda.synchronize()
            assert FE.fused_news_encoder.launches - before == FWD_LAUNCHES
            expect = FE.fused_news_encoder_reference(*args, num_heads=h)
            err = float((got[valid].float() - expect[valid].float()).abs().max())
            tol = TOLS[dtype]
            torch.testing.assert_close(got[valid].float(), expect[valid].float(),
                                       rtol=tol, atol=tol)
            assert torch.all(got[~valid] == 0), "an all-pad item must pool to 0"
            # no atomics, a fixed order of every sum: the same bits again
            assert torch.equal(got, FE.fused_news_encoder(*args, num_heads=h)), \
                ("the forward is not deterministic", str(dtype), M, L, width)
            errs[(str(dtype), M, L, width[0])] = err
            print(f"kernel vs plain {str(dtype):15s} M={M:5d} L={L} D={width[0]}: "
                  f"max|err| {err:.3g} (tol {tol}); two launches equal bit for bit; "
                  f"wide variants {FE.variant(dtype, L, *width) or 'none'}", flush=True)
    # the device kernels of one call, in today's layout and in the wide one
    # (the last shape checked: disan's user tower at one user)
    nrms_args, _ = encoder_inputs(1, *SHAPES[-1], torch.bfloat16)
    kernels = device_kernels(lambda: FE.fused_news_encoder(*nrms_args, num_heads=H))
    wide = device_kernels(lambda: FE.fused_news_encoder(*args, num_heads=h))
    assert kernels == wide == FWD_KERNELS, (kernels, wide, FWD_KERNELS)
    for M, L, width in FWD_SHAPES:
        args, _ = encoder_inputs(M * 100 + L, M, L, torch.bfloat16, width=width)
        iters = 5 if M > 10_000 else (10 if M > 1000 else 100)
        fn = lambda: FE.fused_news_encoder(*args, num_heads=width[1])  # noqa: E731
        plain = lambda: FE.fused_news_encoder_reference(  # noqa: E731
            *args, num_heads=width[1])
        times[(M, L, width[0])] = (cuda_ms(fn, iters), cuda_ms(plain, iters))
    print(f"fused_encoder_fwd: {FWD_LAUNCHES} wrapper launch and {kernels} device kernels "
          f"per call; {FE.fwd_tile(20)[0]} items in {FE.fwd_tile(20)[1]}-row tiles at L=20",
          flush=True)
    return errs, times, kernels


def check_backward(FE):
    """Phase 5: the forward with dropout and the o1 residual, the backward
    and the weight-gradient kernels against their plain versions at
    BWD_SHAPES, two dtypes. Returns the worst errors and the timings (bf16,
    dropout 0.2 at NRMS's shapes, 0 at NAML's)."""
    # pooling weights large enough that the tanh bends: the bias gradient
    # dab = -aq sum_l ds_l t_l^2 is otherwise all rounding
    scales = (0.05, 0.01, 0.05, 0.01, 0.3, 0.5, 0.1)
    errs = {"bwd_abs": 0.0, "bwd_rel": 0.0}
    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        for M, L, width, rates in BWD_SHAPES:
            Dw, h, _ = width
            for rate in rates:
                args, valid = encoder_inputs(M * 7 + L, M, L, dtype,
                                             scales if width == WIDTH else None, width)
                x, mask, w = args[0], args[1], args[2:]
                g = torch.as_tensor(np.random.default_rng(M + L).normal(size=(M, Dw)),
                                    dtype=torch.float32, device=DEVICE)
                out, o1 = FE.fused_news_encoder(*args, num_heads=h, dropout_rate=rate,
                                                seed=1234, save_o1=True)
                torch.cuda.synchronize()
                ref, ref_o1 = FE.fused_news_encoder_reference(
                    *args, num_heads=h, dropout_rate=rate, seed=1234, save_o1=True)
                tol = TOLS[dtype]
                torch.testing.assert_close(out[valid].float(), ref[valid].float(),
                                           rtol=tol, atol=tol)
                # o1 on the real tokens; in bf16 the kernel rounds the
                # attention where the TPU kernel does and the plain version
                # where the jnp chain does, so single elements may differ by
                # a few bf16 steps: held to the tensor's scale
                real = mask > 0
                o1_err = rel_err(o1[real], ref_o1[real])
                assert o1_err < BWD_TOLS[dtype], (str(dtype), rate, M, L, Dw, o1_err)
                assert torch.all(out[~valid] == 0), "an all-pad item must pool to 0"
                before = (FE.fused_news_encoder_bwd.launches, FE.weight_grad.launches)
                bwd = lambda: FE.fused_news_encoder_bwd(  # noqa: E731
                    g, x, mask, o1, *w, num_heads=h, dropout_rate=rate, seed=1234)
                got = bwd()
                torch.cuda.synchronize()
                launched = (FE.fused_news_encoder_bwd.launches - before[0],
                            FE.weight_grad.launches - before[1])
                assert launched == BWD_LAUNCHES, (launched, BWD_LAUNCHES)
                # no atomics, a fixed order of every sum: the same bits again
                assert all(torch.equal(a, b) for a, b in zip(got, bwd())), \
                    ("the backward is not deterministic", str(dtype), rate, M, L, Dw)
                expect = FE.fused_news_encoder_bwd_reference(
                    g, x, mask, o1, *w, num_heads=h, dropout_rate=rate, seed=1234)
                each = {name: rel_err(a, b) for name, a, b in zip(
                    ("dx", "dwqkv", "dbqkv", "dwo", "dbo", "daw", "dab", "daq"), got, expect)}
                worst = max(each.values())
                assert worst < BWD_TOLS[dtype], (str(dtype), rate, M, L, Dw, each)
                assert torch.all(got[0][~valid] == 0), "an all-pad item must get zero dx"
                if dtype == torch.bfloat16:
                    errs["bwd_rel"] = max(errs["bwd_rel"], worst)
                    errs["bwd_abs"] = max(errs["bwd_abs"], *(
                        float((a.float() - b.float()).abs().max()) for a, b in zip(got, expect)))
                if dtype == torch.bfloat16 and rate == max(rates):
                    times[(M, L, Dw)] = (
                        cuda_ms(bwd, 5),
                        cuda_ms(lambda: FE.fused_news_encoder_bwd_reference(
                            g, x, mask, o1, *w, num_heads=h, dropout_rate=rate, seed=1234), 5),
                        # the per-item kernels alone, without the weight gradients
                        cuda_ms(lambda: FE._bwd_per_item(g, x, mask, o1, w, h, rate, 1234), 5))
                    if (M, L, width) == (*TRAIN_SHAPES[1], WIDTH):
                        times["fwd_train"] = cuda_ms(lambda: FE.fused_news_encoder(
                            *args, num_heads=h, dropout_rate=rate, seed=1234, save_o1=True), 10)
                    if width != WIDTH:
                        times[("fwd_o1", M, L, Dw)] = cuda_ms(lambda: FE.fused_news_encoder(
                            *args, num_heads=h, save_o1=True), 10)
                print(f"backward kernel vs plain {str(dtype):15s} dropout {rate} M={M:5d} "
                      f"L={L} D={Dw}: max rel err {worst:.3g} (tol {BWD_TOLS[dtype]}); two "
                      f"calls equal bit for bit; forward with dropout + o1 ok", flush=True)
    # the weight-gradient kernel alone, each product of one backward call
    # over its token rows, each held to its own largest output
    rng = np.random.default_rng(5)
    flat = lambda outs: torch.cat([o.reshape(-1) for o in outs])  # noqa: E731
    for key, K, N, dtype, bias, R in WGRAD_PRODUCTS:
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
        # the same function in float64: the sums' own rounding aside
        exact = (a.double().t() @ b.double(), b.double().sum(0))
        exact = flat(exact if bias else exact[:1])
        errs[key + "_f64"] = rel_err(flat(got), exact)
        errs[key + "_plain_f64"] = rel_err(flat(plain), exact)
        del exact
        assert errs[key + "_f64"] < WGRAD_TOL, (key, str(dtype), errs[key + "_f64"])
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
              f"output (tol {WGRAD_TOL}); "
              f"vs float64 kernel {errs[key + '_f64']:.3g}, plain "
              f"{errs[key + '_plain_f64']:.3g} (tol {WGRAD_TOL}); two launches equal bit "
              f"for bit", flush=True)
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
    """One training forward and backward (no update), the auxiliary losses
    included -> (loss, grads)."""
    from pytorch_news_recommender_tpu_torch.train.loop import training_loss
    model = state.model
    model.zero_grad(set_to_none=True)
    b = {k: torch.as_tensor(v, device=DEVICE) for k, v in batch.items()}
    scores = model(b, trainer.news_feats, deterministic=False,
                   generator=torch.Generator().manual_seed(seed))
    assert sorted(model.aux_losses) == (["topic_ce"] if model.HAS_AUX_LOSS else []), \
        model.aux_losses
    loss = training_loss(model, scores)
    loss.backward()
    grads = {n: p.grad.float().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def training_data(steps=TRAIN_STEPS):
    """The configuration and data of phases 6, 7, 20 and 22: the JAX
    package's defaults on the 65,238-news corpus with MIND's mean title
    length, ``steps`` batches of training impressions, 512 dev and 256 test
    impressions."""
    from pytorch_news_recommender_tpu_torch.config import Config, DataConfig
    from pytorch_news_recommender_tpu_torch.data import synthetic

    cfg = Config(data=DataConfig(dataset="synthetic"))
    t0 = time.perf_counter()
    ds = synthetic.generate(cfg.data, seed=1, n_news=N_NEWS, vocab_size=VOCAB,
                            n_train=steps * cfg.train.batch_size, n_dev=512,
                            n_test=256, title_len=(11.5, 4))
    print(f"training data: {time.perf_counter() - t0:.1f} s ({len(ds.train)} impressions, "
          f"batch {cfg.train.batch_size}, dropout {cfg.model.dropout}, "
          f"{cfg.model.compute_dtype})", flush=True)
    return cfg, ds


@contextlib.contextmanager
def no_plain(FE, SS):
    """The plain versions of the kernels raise while the main path runs: on
    the card no wrapper may fall back to them."""
    names = {FE: ("fused_news_encoder_reference", "fused_news_encoder_bwd_reference",
                  "weight_grad_reference"), SS: ("scatter_add_rows_reference",)}
    saved = {(m, n): getattr(m, n) for m, ns in names.items() for n in ns}

    def refuse(name):
        def fn(*args, **kwargs):
            raise AssertionError(f"{name} ran on the main path")
        return fn
    for m, n in saved:
        setattr(m, n, refuse(n))
    try:
        yield
    finally:
        for (m, n), fn in saved.items():
            setattr(m, n, fn)


def uses_encoder_kernels(model) -> bool:
    """Whether the family's towers run the fused encoder kernels (LSTUR's
    CNN and GRU run none)."""
    from pytorch_news_recommender_tpu_torch.models.layers import AttentionPoolTower
    return any(isinstance(m, AttentionPoolTower) for m in model.modules())


def train_run(FE, SS, cfg, ds, phase):
    """Training of ``cfg.model.name`` through Trainer.run_step and
    Trainer.evaluate: one step through the kernels against the same step
    through the plain versions, then the main path (every launch count set
    to 0 before it and read after it, the plain versions made to raise): a
    step over each prefetched batch of ``ds.train`` and an evaluation. A
    family without the encoder kernels must launch none. The host feed goes
    through ``Trainer._maybe_frontier`` as ``fit``'s does, so that the GNN's
    batches carry their neighborhood closure (its time on the first batch
    is printed)."""
    from pytorch_news_recommender_tpu_torch.data.loader import (
        DEFAULT_UNIQUE_BUCKETS, train_batches,
    )
    from pytorch_news_recommender_tpu_torch.data.prefetch import device_prefetch
    from pytorch_news_recommender_tpu_torch.train.loop import Trainer

    bs = cfg.train.batch_size
    trainer = Trainer(cfg, ds, device=DEVICE)
    state = trainer.init_state(seed=0)
    raw = train_batches(ds.train, bs, np.random.default_rng(cfg.train.seed), dedup=True,
                        unique_buckets=DEFAULT_UNIQUE_BUCKETS,
                        length_split=trainer._length_split)
    t0 = time.perf_counter()
    first = trainer._maybe_frontier(next(raw))
    frontier_ms = (time.perf_counter() - t0) * 1e3
    host = map(trainer._maybe_frontier, raw)
    # a family that encodes by id (nrms_bert) has no length split
    assert ("short_mark" in first) == (trainer._length_split is not None), \
        "the batch must use both the short and the long block"
    assert ("gnn_frontier_ids" in first) == bool(trainer._frontier_depth), first.keys()

    # one step through the kernels against the same step through the plain versions
    lk, gk = loss_and_grads(trainer, state, first, 7)
    with plain_kernels(FE, SS):
        lp, gp = loss_and_grads(trainer, trainer.init_state(seed=0), first, 7)
    names = [n for n, _ in state.model.named_parameters()]
    name = cfg.model.name
    assert sorted(gk) == sorted(gp) == sorted(names), "a parameter got no gradient"
    assert all(float(gk[n].abs().max()) > 0 for n in names
               if n not in EXACT_ZERO_GRADS.get(name, ())), "a zero gradient"
    scale = max(float(g.abs().max()) for g in gp.values())
    grad_err = max(float((gk[n] - gp[n]).abs().max()) for n in names) / scale
    loss_err = abs(lk - lp) / abs(lp)
    assert loss_err < 0.01 and grad_err < 2e-2, (lk, lp, grad_err)
    short = first["short_mark"].shape[0] if "short_mark" in first else 0
    if "gnn_frontier_ids" in first:
        real = int((first["gnn_frontier_ids"] != 0).sum()) + 1
        print(f"[phase {phase}] {name} frontier of the first batch: {real} news of the "
              f"{trainer._frontier_depth}-hop closure of {first['unique_ids'].shape[0]} "
              f"unique slots, padded to {first['gnn_frontier_ids'].shape[0]}; built on the "
              f"host in {frontier_ms:.1f} ms (in fit's and this run's prefetch thread)",
              flush=True)
    print(f"[phase {phase}] {name} train step kernel vs plain (unique "
          f"{first['unique_ids'].shape[0]}, short {short}): loss "
          f"{lk:.5f} vs {lp:.5f} (rel {loss_err:.3g}, tol 0.01); grads max err "
          f"{grad_err:.3g} of the largest gradient (tol 2e-2); each of the "
          f"{len(names)} parameters gets a gradient", flush=True)

    # the main path: run_step over prefetched batches, then evaluate
    counted = {"fwd": FE.fused_news_encoder, "bwd": FE.fused_news_encoder_bwd,
               "wgrad": FE.weight_grad, "scatter": SS.scatter_add_rows}
    for fn in counted.values():
        fn.launches = 0
    losses, step_ms, widths = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with no_plain(FE, SS):
        for batch in device_prefetch(itertools.chain([first], host), DEVICE):
            t0 = time.perf_counter()
            state, m = trainer.run_step(state, batch)
            losses.append(float(m["loss"]))   # waits for the step
            step_ms.append((time.perf_counter() - t0) * 1e3)
            widths.append((batch["unique_ids"].shape[0], batch["short_mark"].shape[0]
                           if "short_mark" in batch else 0,
                           batch["gnn_frontier_ids"].shape[0]
                           if "gnn_frontier_ids" in batch else 0))
        steps = len(ds.train) // bs
        step_launches = {k: fn.launches for k, fn in counted.items()}
        steps_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        assert len(losses) == steps and np.all(np.isfinite(losses)), losses
        q = max(1, steps // 4)
        first_q, last_q = float(np.mean(losses[:q])), float(np.mean(losses[-q:]))
        assert last_q < first_q, (first_q, last_q)
        t0 = time.perf_counter()
        metrics = trainer.evaluate(state)
        eval_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counted.items()}
    if uses_encoder_kernels(state.model):
        assert launches["fwd"] and launches["bwd"], launches
    else:
        assert launches == dict.fromkeys(counted, 0), launches
    # dWqkv+dbqkv, dWo+dbo, daw+dab, daq: four launches per backward call
    assert launches["wgrad"] == 4 * launches["bwd"], launches
    assert np.isfinite(metrics["auc"]) and metrics["n_impressions"] == 512, metrics
    frontier = (f"; frontier widths {sorted(set(f for _, _, f in widths))}"
                if trainer._frontier_depth else "")
    print(f"[phase {phase}] {name} trained {steps} steps: loss first {q} {first_q:.4f} -> "
          f"last {q} {last_q:.4f}; unique news per step "
          f"{np.mean([w for w, _, _ in widths]):.0f} (short block "
          f"{np.mean([s for _, s, _ in widths]):.0f}){frontier}; dev AUC "
          f"{metrics['auc']:.4f} over 512 impressions (eval {eval_s:.2f} s); launches "
          f"{launches}", flush=True)
    return {"launches": launches, "step_launches": step_launches, "step_ms": step_ms,
            "trainer": trainer, "state": state, "first": first, "metrics": metrics,
            "loss_err": loss_err, "grad_err": grad_err, "steps_peak_gib": steps_peak_gib}


def family_data(abst_len=None, bert_dim=0, n_users=0, n_neighbors=0, sample_size=None):
    """The data of phases 9-15: the JAX package's defaults on the 65,238-news
    corpus with MIND's mean title length, 10 entities per news from a
    20,000-entity vocabulary with 100-d pretrained vectors, 293 topics over
    18 categories and 294 subcategories (each topic its own subcategory),
    FAMILY_STEPS batches of training impressions and 512 dev impressions;
    ``abst_len`` (mean, sd) of the abstracts' real words, the generator's
    fixed 70% fill when None; ``bert_dim``-wide BERT vectors and
    ``n_users`` users (the impressions drawn from the users' topics), an
    ``n_neighbors``-neighbor news graph (same-topic news) and
    ``sample_size`` negatives a training impression when given."""
    from pytorch_news_recommender_tpu_torch.config import Config, DataConfig
    from pytorch_news_recommender_tpu_torch.data import synthetic

    cfg = Config(data=DataConfig(dataset="synthetic"))
    if sample_size is not None:
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data,
                                                                sample_size=sample_size))
    t0 = time.perf_counter()
    ds = synthetic.generate(cfg.data, seed=2, n_news=N_NEWS, vocab_size=VOCAB,
                            n_topics=293, n_categories=18, n_subcategories=294,
                            n_entities=20_000, entities_per_news=10, entity_dim=100,
                            n_train=FAMILY_STEPS * cfg.train.batch_size, n_dev=512,
                            title_len=(11.5, 4), abst_len=abst_len, bert_dim=bert_dim,
                            n_users=n_users, n_neighbors=n_neighbors)
    assert ds.meta.entity_nums == 20_001 and cfg.model.entity_embed_size == 100
    extra = (f", {bert_dim}-wide BERT vectors" if bert_dim else "") + (
        f", {ds.meta.n_users - 1} users" if n_users else "") + (
        f", {n_neighbors} graph neighbors a news" if n_neighbors else "") + (
        f", {cfg.data.sample_size} negatives an impression" if sample_size else "")
    print(f"family data: {time.perf_counter() - t0:.1f} s ({len(ds.train)} impressions, "
          f"{ds.news.entity.shape[1]} entities per news of {ds.meta.entity_nums - 1}, "
          f"{ds.meta.category_nums} categories, {ds.meta.subcategory_nums} subcategories"
          f"{extra})", flush=True)
    return cfg, ds


def lr_probe(cfg, ds, name, lr, phase):
    """The losses of PROBE_STEPS training steps of family ``name`` at
    learning rate ``lr`` (no check: a measurement)."""
    from pytorch_news_recommender_tpu_torch.data.loader import train_batches
    from pytorch_news_recommender_tpu_torch.train.loop import Trainer

    fcfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, name=name),
                               train=dataclasses.replace(cfg.train, learning_rate=lr))
    trainer = Trainer(fcfg, ds, device=DEVICE)
    state = trainer.init_state(seed=0)
    losses = []
    for batch in itertools.islice(train_batches(
            ds.train, fcfg.train.batch_size, np.random.default_rng(fcfg.train.seed),
            dedup=True), PROBE_STEPS):
        state, m = trainer.run_step(state, batch)
        losses.append(round(float(m["loss"]), 4))
    print(f"[phase {phase}] {name} at learning rate {lr}: losses of {PROBE_STEPS} steps "
          f"{losses}", flush=True)
    return losses


def family_cli_run(name, phase):
    """The CLI with ``--model name`` on the card at the small synthetic
    size: ``train`` (checkpoints), ``eval`` of the best step, and ``serve``'s
    HTTP daemon answering one ``/score`` (for a family whose news vectors
    depend on the user, NPA, ``serve`` must fail as the JAX CLI's does).
    Returns the checkpoint's path."""
    from pytorch_news_recommender_tpu_torch import cli

    save = WORK / f"cli_{name}"
    shutil.rmtree(save, ignore_errors=True)
    data = ["--data", "synthetic", "--model", name]
    assert cli.main(["train", *data, "--epochs", "1", "--eval-step", "16",
                     "--save-dir", str(save)]) == 0
    ckpt = str(save / name)
    assert cli.main(["eval", *data, "--ckpt", ckpt]) == 0
    serve_args = cli.build_parser().parse_args(["serve", *data, "--ckpt", ckpt, "--port", "0"])
    if name == "npa":
        try:
            cli.build_server(serve_args)
            raise AssertionError("cli serve --model npa served")
        except ValueError as e:
            assert "TWO_TOWER=False" in str(e), e
        print(f"[phase {phase}] cli train / eval --model {name} ran on the card; serve "
              f"refused (user-conditioned news vectors)", flush=True)
        return ckpt
    srv = cli.build_server(serve_args)
    # each family's class lives in the module named after it (NRMSBert in
    # models/nrms_bert.py, DiSANRec in models/disan.py)
    assert type(srv.rec.model).__module__.rsplit(".", 1)[-1] == name, type(srv.rec.model)
    assert srv.rec.device.type == torch.device(DEVICE).type, srv.rec.device
    srv.start(block=False)
    try:
        scores = post(srv.port, "/score", {"history": [1, 2, 3], "candidates": [4, 5, 6]})
    finally:
        srv.stop()
    assert len(scores["scores"]) == 3 and np.all(np.isfinite(scores["scores"])), scores
    print(f"[phase {phase}] cli train / eval / serve --model {name} ran on the card (one "
          f"/score answered)", flush=True)
    return ckpt


def family_run(FE, SS, cfg, ds, name, phase, tag, workflow=False, cli=False,
               model_over=None, train_over=None):
    """Phases 9-19, one family (``model_over``: model fields beside the JAX
    defaults): training through ``train_run``, then a ``Recommender`` at the
    trained weights, the main serving path (launch counts set to 0 before it
    and read after it, the plain versions made to raise): the corpus
    encode, ``score_many`` (32 x 300, distinct user ids where the data has
    users) and ``top_k`` timed, and for a family that reads abstracts one
    ``add_news`` with a title, an abstract and a category; its scores, its
    top-10 scores and the fresh news vector held to those of a recommender
    built and run with the plain versions of the towers. A family without
    a user tower over the cached vectors (LSTUR) must refuse ``top_k``, and
    one that encodes from BERT vectors ``add_news``, and a family whose news
    vectors depend on the user (NPA) the ``Recommender`` itself. The
    family's training defaults (``FAMILY_TRAIN_DEFAULTS``: NPA's and
    Fastformer's learning rates) apply, as ``cli train`` applies them, then
    ``train_over`` (train fields, as ``cli train --lr`` overrides). With
    ``workflow``, also a checkpoint of the trained state restored and
    evaluated (``restore_run``); with ``workflow`` or ``cli``, the CLI
    (``family_cli_run``); both off the counted paths. Returns the launch
    counts of both paths."""
    from pytorch_news_recommender_tpu_torch.config import FAMILY_TRAIN_DEFAULTS
    from pytorch_news_recommender_tpu_torch.serve import Recommender

    fcfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, name=name, **(model_over or {})),
        train=dataclasses.replace(cfg.train, **{**FAMILY_TRAIN_DEFAULTS.get(name, {}),
                                                **(train_over or {})}))
    torch.cuda.reset_peak_memory_stats()
    run = train_run(FE, SS, fcfg, ds, phase)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    assert run["launches"]["scatter"] == 0, run["launches"]
    kernels = uses_encoder_kernels(run["state"].model)
    two_tower = run["state"].model.TWO_TOWER
    params = run["state"].params
    if workflow:
        shutil.rmtree(WORK / name, ignore_errors=True)
        _, _, auc = restore_run(run["trainer"], run["state"], ds, WORK / name)
        print(f"[phase {phase}] {name} checkpoint at step {run['state'].step} restored into "
              f"a fresh trainer: parameters, optimizer state, step and dev AUC ({auc:.6f}) "
              f"equal", flush=True)
    if workflow or cli:
        family_cli_run(name, phase)
    del run["trainer"], run["state"]
    steps = len(run["step_ms"])
    p50, p99 = (float(np.percentile(run["step_ms"], q)) for q in (50, 99))
    bs = fcfg.train.batch_size
    per_step = {k: v / steps for k, v in run["step_launches"].items() if k != "scatter"}
    train_line = (f"{tag} {name} train step (batch {bs}, {steps} steps): p50 {p50:.2f} ms, "
                  f"p99 {p99:.2f} ms = {bs / p50 * 1e3:.0f} impressions/s; dev AUC "
                  f"{run['metrics']['auc']:.4f}; peak device memory {peak_gib:.2f} GiB "
                  f"(torch.cuda.max_memory_allocated over the training)")
    if not two_tower:
        # NPA: no corpus table to serve from, as in the JAX package
        try:
            Recommender(fcfg, ds, params, device=DEVICE)
            raise AssertionError(f"{name}'s Recommender served")
        except ValueError as e:
            assert "TWO_TOWER=False" in str(e), e
        print(f"[phase {phase}] {name}: Recommender refused (user-conditioned news "
              f"vectors)", flush=True)
        print(train_line, flush=True)
        print(f"[phase {phase}] {name} launches per training step: {per_step}", flush=True)
        return {"train": run["launches"], "serve": 0, "per_step": per_step,
                "peak_gib": peak_gib}
    rng = np.random.default_rng(phase)
    users = (rng.choice(np.arange(1, ds.meta.n_users), Recommender.BATCH_PAD, replace=False)
             if ds.meta.n_users > Recommender.BATCH_PAD else np.zeros(Recommender.BATCH_PAD))
    batch = [(h, rng.integers(1, N_NEWS, size=300).tolist(), int(u))
             for (h, _), u in zip(make_requests(rng, Recommender.BATCH_PAD, N_NEWS + 1), users)]
    hist = batch[0][0]
    FE.fused_news_encoder.launches = 0
    with no_plain(FE, SS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = Recommender(fcfg, ds, params, device=DEVICE)
        torch.cuda.synchronize()
        startup_ms = (time.perf_counter() - t0) * 1e3
        ranks = rec.ranks_corpus
        t0 = time.perf_counter()
        rec._encode_corpus(ds.news.n_news, fcfg.train.eval_encode_chunk)
        torch.cuda.synchronize()
        encode_ms = (time.perf_counter() - t0) * 1e3
        served = rec.score_many(batch)
        score_many = latency(lambda: rec.score_many(batch), 30)
        top = top_k = None
        if ranks:
            top = rec.top_k(hist, 10)
            top_k = latency(lambda: rec.top_k(hist, 10), 30)
        else:
            try:
                rec.top_k(hist, 10)
                raise AssertionError(f"{name}'s top_k ranked the corpus")
            except ValueError as e:
                assert name in str(e), e
        fresh = None
        if "abst" in rec.model.FEAT_KEYS:
            words = list(ds.dicts["word"])
            fresh = dict(title=" ".join(words[200:209]), abstract=" ".join(words[300:330]),
                         category=next(iter(ds.dicts["category"])))
            nid = rec.add_news(**fresh)
            assert nid == N_NEWS + 1, nid
            fresh_vec = rec._lookup(torch.as_tensor([nid], device=DEVICE)).float()[0]
        if "bert" in rec.model.FEAT_KEYS:
            try:
                rec.add_news("a fresh title")
                raise AssertionError(f"{name}'s add_news tokenized a title")
            except ValueError as e:
                assert "external vector" in str(e), e
    serve_launches = FE.fused_news_encoder.launches
    assert (serve_launches > 0) == kernels, (name, serve_launches)
    with plain_kernels(FE, SS):
        plain_rec = Recommender(fcfg, ds, params, device=DEVICE)
        plain = plain_rec.score_many(batch)
        plain_top = plain_rec.top_k(hist, 10) if ranks else None
        if fresh is not None:
            plain_fresh = torch.as_tensor(plain_rec.encode_new_news(**fresh), device=DEVICE)
        users_differ = None
        if ds.meta.n_users > 1:
            # the same request as two users: LSTUR's long-term vector moves
            # its scores, the other families' ignore the user
            hist1, cands1, uid = batch[1]
            other = plain_rec.score(hist1, cands1, user_id=uid % (ds.meta.n_users - 1) + 1)
            users_differ = float(np.abs(other - plain_rec.score(hist1, cands1, uid)).max())
        del plain_rec
    # an empty history pools to 0 in the kernel, to the mean of its rows in
    # the plain version (ROADMAP.md C): compared where the history is real
    real = [i for i, (h, _, _) in enumerate(batch) if h]
    err = max(float(np.abs(served[i] - plain[i]).max()) for i in real) / max(
        float(np.abs(plain[i]).max()) for i in real)
    assert all(len(a) == 300 and np.all(np.isfinite(a)) for a in served)
    assert err <= SCORE_TOL["native"], (name, err)
    top_note = "top_k refused (no user tower over the cached vectors alone)"
    if ranks:
        ids, scores = top
        assert len(ids) == 10 and np.all((ids >= 1) & (ids <= N_NEWS)), ids
        assert np.all(np.diff(scores) <= 0) and np.all(np.isfinite(scores)), scores
        # the ten best scores, kernel and plain towers, at the same tolerance
        top_err = float(np.abs(scores - plain_top[1]).max() / np.abs(plain_top[1]).max())
        assert top_err <= SCORE_TOL["native"], (name, top_err)
        top_note = f"top_k's ten scores {top_err:.3g}"
    if users_differ is not None:
        assert (users_differ > 0) == (name == "lstur"), (name, users_differ)
        top_note += f"; one request as two users: scores differ by {users_differ:.3g}"
    fresh_note = ""
    if fresh is not None:
        tol = TOLS[torch.bfloat16]
        torch.testing.assert_close(fresh_vec, plain_fresh.float(), rtol=tol, atol=tol)
        fresh_note = (f"; add_news (title {len(fresh['title'].split())} words, abstract "
                      f"{len(fresh['abstract'].split())}, category) vector vs the plain towers "
                      f"max err {float((fresh_vec - plain_fresh.float()).abs().max()):.3g} "
                      f"(tol {tol})")
    if "bert" in rec.model.FEAT_KEYS:
        fresh_note = "; add_news refused (fresh news needs an external vector)"
    del rec
    print(f"[phase {phase}] {name} served at the trained weights: score_many vs the plain "
          f"towers max err {err:.3g} of scale, {top_note} (tol "
          f"{SCORE_TOL['native']}){fresh_note}; fused_encoder_fwd launches {serve_launches}",
          flush=True)
    print(train_line, flush=True)
    top_p = f"top_k (k=10) p50 {top_k[0]:.2f} ms, p99 {top_k[1]:.2f} ms" if ranks else \
        "top_k refused"
    print(f"{tag} {name} serving: start-up {startup_ms:.1f} ms; corpus encode "
          f"{encode_ms:.1f} ms for {ds.news.n_news} news; score_many (32 x 300) p50 "
          f"{score_many[0]:.2f} ms, p99 {score_many[1]:.2f} ms; {top_p}", flush=True)
    print(f"[phase {phase}] {name} launches per training step: {per_step}", flush=True)
    return {"train": run["launches"], "serve": serve_launches, "per_step": per_step,
            "peak_gib": peak_gib}


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


def restore_run(trainer, state, ds, directory):
    """A checkpoint of ``state`` at an evaluation, written to ``directory``
    and restored into a fresh trainer, gives the same parameters, optimizer
    state, step and AUC. Returns the fresh trainer, the restored state and
    the AUC."""
    from pytorch_news_recommender_tpu_torch.train.checkpoint import CheckpointManager
    from pytorch_news_recommender_tpu_torch.train.loop import Trainer

    metrics = trainer.evaluate(state)
    mngr = CheckpointManager(directory, trainer.cfg)
    mngr.save(state.step, state, metrics)
    fresh = Trainer(trainer.cfg, ds, device=DEVICE)
    restored = mngr.restore(fresh.init_state(seed=5))
    assert restored.step == state.step and mngr.best_step() == state.step
    for k, v in state.params.items():
        assert torch.equal(restored.params[k], v), k
    a, b = state.opt.state_dict(), restored.opt.state_dict()
    assert (a["count"], a["mini_step"]) == (b["count"], b["mini_step"])
    for tree in state.opt.trees:
        assert sorted(a[tree]) == sorted(b[tree]), tree
        assert all(torch.equal(a[tree][k], b[tree][k]) for k in a[tree]), tree
    again = fresh.evaluate(restored)
    assert again["auc"] == metrics["auc"], (again["auc"], metrics["auc"])
    return fresh, restored, again["auc"]


def workflow_run(trainer, state, ds):
    """Phase 7c: the user workflow on the card. A checkpoint at an
    evaluation, restored into a fresh trainer, gives the same parameters,
    optimizer state, step and AUC; a submission file from it has one ranking
    per test impression; then the CLI at the small synthetic size."""
    from pytorch_news_recommender_tpu_torch import cli
    from pytorch_news_recommender_tpu_torch.train.submit import write_submission

    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    fresh, restored, auc = restore_run(trainer, state, ds, WORK / "ckpt")
    path = write_submission(fresh, restored, path=WORK / "submission.txt")
    lines = path.read_text().splitlines()
    n_imp = sum(1 for i in range(len(ds.test)) if len(ds.test.impression(i)[0]))
    assert len(lines) == n_imp, (len(lines), n_imp)
    for i, line in enumerate(lines):
        key, ranks = line.split(" ", 1)
        ranks = [int(r) for r in ranks.strip("[]").split(",")]
        assert int(key) == i + 1 and sorted(ranks) == list(range(1, len(ranks) + 1)), line
    print(f"[phase 7] checkpoint at step {state.step} restored into a fresh trainer: "
          f"parameters, optimizer state, step and dev AUC ({auc:.6f}) equal; submission: "
          f"{len(lines)} lines, each a permutation", flush=True)

    # the CLI at the small synthetic size, on the card
    ckpt, data = family_cli_run("nrms", 7), ["--data", "synthetic"]
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
    # the forward: its output, a warm-up, the timed launches
    expect = {"ablation": sum(CA.launches(M) for M, _ in CA.SHAPES),
              "fwd": sum(CA.iters(M) + 2 for M, _ in CA.SHAPES)}
    assert launches == expect, (launches, expect)
    for (M, real_mask), t in zip(CA.SHAPES, tables.values()):
        for stage, r in t["stages"].items():
            out = r.pop("out")
            assert out.shape == (M, D) and bool(torch.isfinite(out.float()).all()), (M, stage)
            assert r["max_rel_err"] < ABLATION_TOL, (M, stage, r["max_rel_err"])
            assert r["bit_equal"], (M, stage, "two launches differ")
        CA.report(M, real_mask, t, tag)
    print(f"[phase 8] encoder ablation: every stage's kernel within {ABLATION_TOL} of its "
          f"plain version at M={' and M='.join(str(M) for M, _ in CA.SHAPES)}, two launches "
          f"equal bit for bit; launches {launches}", flush=True)
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
            # today's forward split by the stages: V1, forward - V3, V3 - V1
            "forward_split": {"qkv": stages["qkv"]["ms"],
                              "attention": tables[M0]["forward"]["ms"] - stages["tail"]["ms"],
                              "tail": stages["tail"]["ms"] - stages["qkv"]["ms"]},
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


def head_train(ds, n):
    """``ds`` with its first ``n`` training impressions."""
    t = ds.train
    return dataclasses.replace(ds, train=dataclasses.replace(
        t, browsed_ids=t.browsed_ids[:n], candidate_ids=t.candidate_ids[:n],
        user_ids=None if t.user_ids is None else t.user_ids[:n]))


def step_grads(trainer, state, batch):
    """The gradients of ``run_step``'s loss on ``batch`` at ``state`` (its
    dropout seeds from the step generator), without the update."""
    from pytorch_news_recommender_tpu_torch.train.loop import step_generator, training_loss
    model = state.model
    model.zero_grad(set_to_none=True)
    b = {k: torch.as_tensor(v, device=DEVICE) for k, v in batch.items()}
    scores = model(b, trainer.news_feats, deterministic=False,
                   generator=step_generator(trainer.cfg.train.seed + 1, state.step))
    training_loss(model, scores).backward()
    grads = {n: p.grad.float().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return grads


def f32_trainer(trainer, **kw):
    """A Trainer of ``trainer``'s configuration and data with float32
    activations (the same initial parameters)."""
    from pytorch_news_recommender_tpu_torch.train.loop import Trainer
    cfg = trainer.cfg
    return Trainer(dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype="float32")), trainer.dataset, device=DEVICE, **kw)


def grad_noise(FE, SS, trainer, t32, batch):
    """The plain versions' step gradients on ``batch`` from the initial
    parameters in bf16 (``trainer``) and float32 (``t32``) training, and
    each parameter's bf16 noise: ``|bf16 - f32| / |f32|`` (L2)."""
    with plain_kernels(FE, SS):
        gp = step_grads(trainer, trainer.init_state(seed=0), batch)
        g32 = step_grads(t32, t32.init_state(seed=0), batch)
    return gp, g32, {n: float((gp[n] - g32[n]).norm() / g32[n].norm()) for n in g32}


def hold_grads(gk, gp, g32, noise):
    """Each parameter's kernel gradient ``gk``, as max|a - b| / max|b| at
    its own scale: within GRAD_TOL of the plain one ``gp`` where the plain
    gradient is not at bf16 noise (``noise`` at most GRAD_NOISE), else
    within twice the plain one's own such error of the float32 gradient
    ``g32``. Returns ``{parameter: (noise, error)}`` and the noisy set."""
    readings, noisy, bad = {}, set(), []
    for n in g32:
        if noise[n] > GRAD_NOISE:
            noisy.add(n)
            err = rel_err(gk[n], g32[n])
            bad += [n] if err > 2 * rel_err(gp[n], g32[n]) else []
        else:
            err = rel_err(gk[n], gp[n])
            bad += [n] if err >= GRAD_TOL else []
        readings[n] = (noise[n], err)
    assert not bad, (bad, readings_text(readings))
    return readings, noisy


def update_errors(before, after_k, after_p, g32, noisy, per_entry):
    """One optimizer update from ``before`` on two gradient sets: the
    parameters after it (``after_k``, ``after_p``) compared where the
    comparison is determined. Adam and Adafactor normalise each update, so
    an update is only as close as its gradient is relative to its own
    scale: the ``noisy`` parameters (plain bf16 gradient at bf16 noise,
    ``grad_noise``) are left out, and must hold under 5% of all entries. Of
    the others, a parameter with per-entry moments (``per_entry``; Adam's
    all) is held where its float32 gradient is above 2e-2 of its largest
    entry (its first update is ``lr * g / |g|``), its largest error as a
    share of its largest change; a factored one (per-row normalisation) by
    the relative L2 norm of the update's error. Returns the worst share."""
    worst, errs = 0.0, {}
    for n, p0 in before.items():
        if n in noisy:
            continue
        dk, dp = after_k[n].float() - p0, after_p[n].float() - p0
        if n in per_entry:
            held = g32[n].abs() > 2e-2 * g32[n].abs().max()
            err = float((dk - dp)[held].abs().max()) / float(dp.abs().max())
        else:
            err = float((dk - dp).norm()) / float(dp.norm())
        worst, errs[n] = max(worst, err), float(f"{err:.3g}")
    share = sum(before[n].numel() for n in noisy) / sum(v.numel() for v in before.values())
    assert worst < UPDATE_TOL and share < 0.05, (worst, share, sorted(noisy), errs)
    return worst


def readings_text(readings):
    return "{" + ", ".join(f"{n}: {a:.3g}/{b:.3g}" for n, (a, b) in readings.items()) + "}"


def update_check(FE, SS, trainer, batch):
    """Phase 20: one ``run_step`` through the kernels against the same step
    through the plain versions, from the same weights: the gradients held
    by ``hold_grads`` (the noise from the plain bf16 and float32 steps,
    ``grad_noise``), the update by ``update_errors`` (Adafactor's per-entry
    moments are the parameters ``opt.v`` keeps); and in float32 training,
    every parameter's kernel gradient within F32_GRAD_TOL of the plain
    one's largest entry."""
    t32 = f32_trainer(trainer)
    before = {n: p.detach().clone() for n, p in trainer.init_state(seed=0).params.items()}
    gk = step_grads(trainer, trainer.init_state(seed=0), batch)
    gk32 = step_grads(t32, t32.init_state(seed=0), batch)
    sk, _ = trainer.run_step(trainer.init_state(seed=0), batch)
    gp, g32, noise = grad_noise(FE, SS, trainer, t32, batch)
    with plain_kernels(FE, SS):
        sp, _ = trainer.run_step(trainer.init_state(seed=0), batch)
    f32_err = {n: rel_err(gk32[n], g32[n]) for n in g32}
    print(f"[phase 20] float32 training, kernel vs plain gradient of each parameter: "
          f"{ {n: float(f'{v:.3g}') for n, v in f32_err.items()} }", flush=True)
    readings, noisy = hold_grads(gk, gp, g32, noise)
    assert max(f32_err.values()) < F32_GRAD_TOL, f32_err
    per_entry = set(sp.opt.v)
    worst = update_errors(before, sk.params, sp.params, g32, noisy, per_entry)
    return {"worst": worst, "noisy": noisy, "per_entry": len(per_entry),
            "readings": readings, "f32": max(f32_err.values())}


def adafactor_run(FE, SS, cfg, ds, tag, adam):
    """Phase 20: NRMS at full width trained with ``optimizer="adafactor"``:
    the kernel step against the plain step (loss, gradients, and the
    parameters after the update), ADAFACTOR_STEPS steps on the main path
    (counted, the plain versions raising) with the loss falling, an
    evaluation over 512 dev impressions, the step time and peak memory
    beside Adam's (phase 6, ``adam``), and a checkpoint -> restore -> eval
    round trip equal bit for bit. Returns the launch counts."""
    bs = cfg.train.batch_size
    acfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, optimizer="adafactor"))
    run = train_run(FE, SS, acfg, head_train(ds, ADAFACTOR_STEPS * bs), 20)
    state, launches, per_step = run["state"], run["launches"], run["step_launches"]
    opt = state.opt
    assert sorted(opt.v_row) == sorted(opt.v_col) == sorted(
        n for n, p in state.model.named_parameters() if p.dim() == 2 and min(p.shape) >= 128)
    # 3 encoder calls a step (short, long, users), 4 weight gradients each
    steps = len(run["step_ms"])
    assert per_step["fwd"] == per_step["bwd"] == 3 * steps, per_step
    assert per_step["wgrad"] == 12 * steps, per_step
    assert {k: per_step[k] / steps for k in ("fwd", "bwd", "wgrad")} == {
        k: adam["per_step"][k] for k in ("fwd", "bwd", "wgrad")}, (per_step, adam)
    chk = update_check(FE, SS, run["trainer"], run["first"])
    shutil.rmtree(WORK / "adafactor", ignore_errors=True)
    _, _, auc = restore_run(run["trainer"], state, ds, WORK / "adafactor")
    p50, p99 = (float(np.percentile(run["step_ms"], q)) for q in (50, 99))
    print(f"[phase 20] adafactor: factored moments for {sorted(opt.v_row)}, per-entry for "
          f"{chk['per_entry']} parameters; gradients kernel vs plain, per parameter "
          f"(bf16 noise of the plain step, relative L2 against its float32 twin / kernel "
          f"error, of the parameter's largest entry; noise above {GRAD_NOISE}: against "
          f"the float32 step, tol twice the plain step's; else against the plain step, "
          f"tol {GRAD_TOL}): "
          f"{readings_text(chk['readings'])}; float32 training, kernel vs plain "
          f"gradients {chk['f32']:.3g} of each parameter's largest (tol {F32_GRAD_TOL}); "
          f"update kernel vs plain {chk['worst']:.3g} (per-entry: of each parameter's "
          f"largest change where its float32 gradient is above 2e-2 of its largest; "
          f"factored: relative L2; tol {UPDATE_TOL}; not held, at bf16 noise: "
          f"{sorted(chk['noisy'])}); launches per step {per_step['fwd'] // steps} / "
          f"{per_step['bwd'] // steps} / {per_step['wgrad'] // steps} (as Adam's); "
          f"checkpoint -> restore -> eval equal (AUC {auc:.6f})", flush=True)
    print(f"{tag} train step adafactor (batch {bs}, {steps} steps): p50 {p50:.2f} ms, p99 "
          f"{p99:.2f} ms, peak memory of the steps {run['steps_peak_gib']:.2f} GiB; Adam "
          f"(phase 6, {adam['steps']} steps): p50 {adam['p50']:.2f} ms, p99 "
          f"{adam['p99']:.2f} ms, peak {adam['peak']:.2f} GiB", flush=True)
    return launches


def native_run(cfg, ds, tag):
    """Phase 21: the C++ fast path of ``native/``. It must build on this
    machine; phase 6's 40 batches from its dedup equal numpy's bit for bit,
    and the corpus's titles, written out as text, tokenize to the same ids
    through the C++ tokenizer as through the Python loop (and to the
    titles). Host time per batch of each dedup, and of each tokenizer."""
    from pytorch_news_recommender_tpu_torch import native
    from pytorch_news_recommender_tpu_torch.data import mind
    from pytorch_news_recommender_tpu_torch.data.loader import (
        DEFAULT_UNIQUE_BUCKETS, LengthSplit, train_batches,
    )

    assert native.available(), "the C++ library did not build"
    lens = (ds.news.title != 0).sum(axis=1).astype(np.int32)
    split = LengthSplit({"title": lens}, {"title": cfg.model.short_title_len})

    def batches():
        t = time.perf_counter()
        out = list(train_batches(ds.train, cfg.train.batch_size,
                                 np.random.default_rng(cfg.train.seed), dedup=True,
                                 unique_buckets=DEFAULT_UNIQUE_BUCKETS, length_split=split))
        return out, (time.perf_counter() - t) * 1e3 / len(out)

    fast, fast_ms = batches()
    available = native.available
    native.available = lambda: False
    try:
        slow, slow_ms = batches()
    finally:
        native.available = available
    assert len(fast) == len(slow) == TRAIN_STEPS
    for a, b in zip(fast, slow):
        assert sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)
    inv = {i: w for w, i in word_dict(VOCAB).items()}
    texts = [" ".join(inv[int(i)] for i in row if i).capitalize()
             for row in ds.news.title[1:]]
    L = ds.news.title.shape[1]
    t = time.perf_counter()
    ids_c = mind.ids_matrix(texts, word_dict(VOCAB), L, native_mod=native)
    tok_c = time.perf_counter() - t
    t = time.perf_counter()
    ids_py = mind.ids_matrix(texts, word_dict(VOCAB), L)
    tok_py = time.perf_counter() - t
    assert np.array_equal(ids_c, ids_py) and np.array_equal(ids_c[1:], ds.news.title[1:])
    print(f"[phase 21] native: {native._LIB.relative_to(native.BUILD_DIR.parents[1])} (built "
          f"at its first use, phase 6's first batch); {len(fast)} dedup batches "
          f"equal bit for bit to numpy's; {len(texts)} titles tokenize to the same ids "
          f"both ways", flush=True)
    print(f"{tag} host time (not device time): dedup batch (batch "
          f"{cfg.train.batch_size}, with the length split) C++ {fast_ms:.2f} ms, numpy "
          f"{slow_ms:.2f} ms; tokenizing {len(texts)} titles C++ {tok_c * 1e3:.1f} ms, "
          f"Python {tok_py * 1e3:.1f} ms", flush=True)
    return {"dedup_ms": fast_ms, "numpy_dedup_ms": slow_ms}


def free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def rank_worker(rank, port, work):
    """Phase 22, one of two ranks on the one card (``gloo``): NRMS at full
    width, phase 6's global batch, RANK_STEPS steps through the sliced
    feed (this rank's block) with dropout 0, the launches counted, every
    parameter's bytes hashed after every step, then the same with dropout
    RANK_DROPOUT, where the first training forward's inputs and seed are
    kept and the kernel's output is held to the plain version with the
    mask of ``seed + rank * SHARD_SEED_STRIDE`` and with the other rank's.
    Writes ``rank<r>.json`` and this rank's final parameters into
    ``work``."""
    import hashlib
    from pytorch_news_recommender_tpu_torch.data.prefetch import device_prefetch
    from pytorch_news_recommender_tpu_torch.models import layers
    from pytorch_news_recommender_tpu_torch.ops import fused_encoder as FE
    from pytorch_news_recommender_tpu_torch.parallel import distributed
    from pytorch_news_recommender_tpu_torch.train.loop import Trainer, step_generator

    torch.cuda.set_device(0)
    assert distributed.initialize(f"127.0.0.1:{port}", 2, rank, backend="gloo")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, ds = training_data(RANK_STEPS)
    FE.build()
    out = {"rank": rank}
    for rate in (0.0, RANK_DROPOUT):
        rcfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dropout=rate))
        trainer = Trainer(rcfg, ds, device=DEVICE)
        state = trainer.init_state(seed=0)
        host = list(trainer.sliced_batches(np.random.default_rng(rcfg.train.seed)))
        if rate == 0.0:
            # the first step's gradients, averaged over the ranks as run_step does
            grads = step_grads(trainer, state, host[0])
            avg = distributed.all_reduce_mean(list(grads.values()))
            torch.save({n: g.cpu() for n, g in zip(grads, avg)}, work / f"rank{rank}_grads1.pt")
        kept, real = [], layers.fused_news_encoder

        def keep_first(x, mask, *weights, **kw):
            if kw.get("dropout_rate", 0.0) > 0 and not kept:
                kept.append((x.detach().clone(), mask.clone(),
                             [w.detach().clone() for w in weights], dict(kw)))
            return real(x, mask, *weights, **kw)
        layers.fused_news_encoder = keep_first
        for fn in (FE.fused_news_encoder, FE.fused_news_encoder_bwd, FE.weight_grad):
            fn.launches = 0
        losses, step_ms, hashes = [], [], []
        draws = []
        torch.cuda.synchronize()
        for batch in device_prefetch(host, DEVICE):
            draws.append(int(torch.randint(0, 2 ** 31 - 1, (), generator=step_generator(
                rcfg.train.seed + 1, state.step))))
            t0 = time.perf_counter()
            state, m = trainer.run_step(state, batch)
            losses.append(float(m["loss"]))
            step_ms.append((time.perf_counter() - t0) * 1e3)
            hashes.append(hashlib.sha256(b"".join(
                p.detach().cpu().numpy().tobytes() for p in state.model.parameters())).hexdigest())
            trainer.check_replicas(state)
            if rate == 0.0 and state.step == 1:
                torch.save({k: v.cpu() for k, v in state.params.items()},
                           work / f"rank{rank}_step1.pt")
        layers.fused_news_encoder = real
        launches = {"fwd": FE.fused_news_encoder.launches, "bwd": FE.fused_news_encoder_bwd.launches,
                    "wgrad": FE.weight_grad.launches}
        run = {"losses": losses, "step_ms": step_ms, "hashes": hashes, "launches": launches}
        if rate == 0.0:
            torch.save({k: v.cpu() for k, v in state.params.items()}, work / f"rank{rank}.pt")
        else:
            x, mask, weights, kw = kept[0]
            seed = kw["seed"]
            assert seed == FE.shard_seed(draws[0], rank) == \
                (draws[0] + rank * FE.SHARD_SEED_STRIDE) % 2 ** 32, (seed, draws[0], rank)
            with torch.no_grad():
                got = FE.fused_news_encoder(x, mask, *weights, **kw)
                real_rows = mask.sum(1) > 0
                errs = {}
                for who, r in (("own", rank), ("other", 1 - rank)):
                    ref = FE.fused_news_encoder_reference(
                        x, mask, *weights, num_heads=kw["num_heads"],
                        dropout_rate=kw["dropout_rate"],
                        seed=draws[0] + r * FE.SHARD_SEED_STRIDE)
                    errs[who] = rel_err(got[real_rows], ref[real_rows])
            run.update(seed=seed, draw=draws[0], mask_err=errs, rows=list(x.shape))
        out[f"dropout_{rate}"] = run
    (work / f"rank{rank}.json").write_text(json.dumps(out))
    distributed.barrier()


def ranks_run(FE, SS, tag):
    """Phase 22: two ranks on the one card, spawned after the kernels were
    built (phase 1), over ``gloo`` (``rank_worker``): with dropout 0 the
    ranks' losses and parameters equal bit for bit after every step, and
    against one process training the same global batches (both ranks'
    blocks of each, ``Trainer(replay_ranks=2)``), the losses within 1%, the
    ranks' all-reduced first gradients held to the one process's by
    ``hold_grads`` and the first update by ``update_errors``, with the share of all
    entries within 2e-2 of their parameter's largest change after the last
    step printed; with dropout 0.2 each rank's kernel
    applied the mask of ``seed + rank * 1,000,003`` (its output within 2e-2
    of the plain version with that mask, and past 2e-2 from the plain
    version with the other rank's), and the ranks' losses still agree.
    Then ``cli train --coordinator ... --log-attention`` and ``cli submit``
    on two ranks at the small synthetic size: one submission file, equal to
    one process's. Returns the ranks' launch counts."""
    import torch.multiprocessing as mp
    from pytorch_news_recommender_tpu_torch import cli
    from pytorch_news_recommender_tpu_torch.train.loop import Trainer

    work = WORK / "ranks"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    mp.start_processes(rank_worker, args=(free_port(), work), nprocs=2, join=True,
                       start_method="spawn")
    spawn_s = time.perf_counter() - t0
    res = [json.loads((work / f"rank{r}.json").read_text()) for r in (0, 1)]
    a, b = (r["dropout_0.0"] for r in res)
    assert a["losses"] == b["losses"] and a["hashes"] == b["hashes"], (a["losses"], b["losses"])
    assert len(a["losses"]) == RANK_STEPS
    for r in res:
        launches = r["dropout_0.0"]["launches"]
        assert launches["fwd"] == launches["bwd"] == 3 * RANK_STEPS, launches
        assert launches["wgrad"] == 12 * RANK_STEPS, launches
    # one process on the same global batches: both ranks' blocks of each,
    # encoded block by block (the multi-block resolve_batch)
    cfg, ds = training_data(RANK_STEPS)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dropout=0.0))
    trainer = Trainer(cfg, ds, device=DEVICE, replay_ranks=2)
    state = trainer.init_state(seed=0)
    before = {k: v.detach().clone() for k, v in state.params.items()}
    host = list(trainer.sliced_batches(np.random.default_rng(cfg.train.seed)))
    assert len(host) == RANK_STEPS and "block_mark" in host[0], sorted(host[0])
    grads, single, after1 = step_grads(trainer, state, host[0]), [], None
    bs = cfg.train.batch_size
    for fn in (FE.fused_news_encoder, FE.fused_news_encoder_bwd, FE.weight_grad):
        fn.launches = 0
    with no_plain(FE, SS):
        for batch in host:
            state, m = trainer.run_step(state, batch)
            single.append(float(m["loss"]))
            if after1 is None:
                after1 = {k: v.detach().clone() for k, v in state.params.items()}
    replay_launches = {"fwd": FE.fused_news_encoder.launches,
                       "bwd": FE.fused_news_encoder_bwd.launches, "wgrad": FE.weight_grad.launches}
    assert list(replay_launches.values()) == [3 * RANK_STEPS, 3 * RANK_STEPS, 12 * RANK_STEPS], \
        replay_launches
    loss_err = max(abs(x - y) / abs(y) for x, y in zip(a["losses"], single))
    # the ranks' first gradients and update against the one process's, held
    # where the plain versions determine them in bf16 (grad_noise on the
    # same joined batch; Adam's moments are per entry)
    step1 = {k: v.to(DEVICE) for k, v in torch.load(work / "rank0_step1.pt").items()}
    grads1 = {k: v.to(DEVICE) for k, v in torch.load(work / "rank0_grads1.pt").items()}
    _, g32, noise = grad_noise(FE, SS, trainer, f32_trainer(trainer, replay_ranks=2), host[0])
    readings, noisy = hold_grads(grads1, grads, g32, noise)
    step1_err = update_errors(before, step1, after1, g32, noisy, set(before))
    # after all steps, the share of entries within 2e-2 of each parameter's
    # largest change (the rest: entries whose gradient is near bf16 noise)
    last = torch.load(work / "rank0.pt")
    close = sum(int(((last[k].to(DEVICE) - v).abs()
                     <= 2e-2 * (v - before[k]).abs().max()).sum())
                for k, v in state.params.items())
    close_share = close / sum(v.numel() for v in state.params.values())
    assert loss_err < 0.01, (loss_err, a["losses"], single)
    da, db = (r[f"dropout_{RANK_DROPOUT}"] for r in res)
    assert da["losses"] == db["losses"] and da["hashes"] == db["hashes"]
    assert db["seed"] == (da["seed"] + FE.SHARD_SEED_STRIDE) % 2 ** 32 and da["seed"] != db["seed"]
    for d in (da, db):
        assert d["mask_err"]["own"] < 2e-2 < d["mask_err"]["other"], d["mask_err"]
    print(f"[phase 22] two ranks on one card over gloo ({spawn_s:.1f} s with the spawn): "
          f"dropout 0, {RANK_STEPS} steps of global batch {bs}: losses and parameter "
          f"bytes equal on both ranks after every step; against one process on the same "
          f"batches (both ranks' blocks of each, launches per step 3 / 3 / 12 as "
          f"the ranks'): loss max rel "
          f"err {loss_err:.3g} (tol 0.01); the ranks' first gradients against the one "
          f"process's, per parameter (bf16 noise of the plain step / error, as in phase 20, "
          f"tol {GRAD_TOL} or twice the noise): {readings_text(readings)}; the first "
          f"update {step1_err:.3g} of each parameter's largest change where the float32 "
          f"gradient is above 2e-2 of its largest (tol {UPDATE_TOL}; not held, at bf16 "
          f"noise: {sorted(noisy)}); after {RANK_STEPS} steps "
          f"{close_share:.4%} of all "
          f"entries within 2e-2 of their parameter's largest change; launches per rank per step "
          f"{a['launches']['fwd'] // RANK_STEPS} / {a['launches']['bwd'] // RANK_STEPS} / "
          f"{a['launches']['wgrad'] // RANK_STEPS}; dropout {RANK_DROPOUT}: seeds "
          f"{da['seed']} / {db['seed']} (= draw + rank * {FE.SHARD_SEED_STRIDE}), kernel "
          f"output vs the plain version with its own rank's mask {da['mask_err']['own']:.3g} / "
          f"{db['mask_err']['own']:.3g}, with the other rank's {da['mask_err']['other']:.3g} / "
          f"{db['mask_err']['other']:.3g} (rows {da['rows']})", flush=True)
    for r, d in enumerate(res):
        p50 = float(np.percentile(d["dropout_0.0"]["step_ms"], 50))
        print(f"{tag} train step p50 rank {r} (global batch {bs}, {bs // 2} a "
              f"rank): {p50:.2f} ms; two processes time-sharing one card over gloo, not a "
              f"multi-card figure", flush=True)

    # the CLI on two ranks at the small synthetic size
    save, port = work / "cli", free_port()
    code = ("import sys; from pytorch_news_recommender_tpu_torch import cli; "
            "flags = sys.argv[2:] + ['--device', '" + DEVICE + "']; "
            "assert cli.main(['train', '--data', 'synthetic', '--epochs', '1', '--save-dir', "
            "sys.argv[1], '--log-attention'] + flags) == 0; "
            "assert cli.main(['submit', '--data', 'synthetic', '--ckpt', sys.argv[1] + '/nrms', "
            "'--out', sys.argv[1] + '/two.txt'] + flags) == 0")
    root = pathlib.Path(__file__).resolve().parent
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(save), "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", "2", "--process-id", str(r), "--dist-backend", "gloo"],
        cwd=root, env={**os.environ, "PYTHONPATH": os.pathsep.join(
            [str(root)] + [x for x in [os.environ.get("PYTHONPATH")] if x])},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in (0, 1)]
    for p in procs:
        text, _ = p.communicate(timeout=600)
        assert p.returncode == 0, text[-3000:]
    lines = [json.loads(x) for x in (save / "nrms" / "metrics.jsonl").read_text().splitlines()]
    sites = sorted(x["site"] for x in lines if x.get("tag") == "attention")
    assert sites == ["news_encoder/tower", "user_encoder/tower"], sites
    assert cli.main(["submit", "--data", "synthetic", "--ckpt", str(save / "nrms"),
                     "--out", str(save / "one.txt"), "--device", DEVICE]) == 0
    two, one = (save / "two.txt").read_text(), (save / "one.txt").read_text()
    assert two == one and two.count("\n") > 0
    print(f"[phase 22] cli train --coordinator/--num-processes/--process-id --dist-backend "
          f"gloo --log-attention on two ranks: one metrics log, attention sites {sites}; "
          f"two-rank cli submit: one file of {two.count(chr(10))} lines, equal to one "
          f"process's", flush=True)
    return [r["dropout_0.0"]["launches"] for r in res], replay_launches


def mesh_worker(rank, world, port, work):
    """Phase 23, one rank of a ``(world / 2, 2)`` process mesh on the one
    card (``gloo``): NRMS at full width on phase 6's corpus, the word table
    split by rows over the two ranks of each data row, MESH_STEPS steps of
    the sliced feed at dropout 0 and at RANK_DROPOUT under each schedule of
    MESH_RUNS (the plain versions made to raise, the launches counted from 0
    before each run): every step's loss, the bytes of the replicated
    parameters and of the table's block hashed, the replicas checked; the
    peak memory and the step times; the parameters after the first step at
    dropout 0; at dropout RANK_DROPOUT the first training forward's inputs
    and seed kept and the kernel's output held to the plain version with the
    mask of its data index's folded seed and with the other row's. At
    ``world`` 2 the psum run ends with an evaluation and a checkpoint, and
    one step at capacity factor MESH_OVERFLOW. Writes ``rank<r>.json`` and
    ``<schedule>_rank<r>_step1.pt`` into ``work``."""
    import hashlib
    from pytorch_news_recommender_tpu_torch.data.prefetch import device_prefetch
    from pytorch_news_recommender_tpu_torch.models import layers
    from pytorch_news_recommender_tpu_torch.ops import fused_encoder as FE
    from pytorch_news_recommender_tpu_torch.ops import segment_scatter as SS
    from pytorch_news_recommender_tpu_torch.parallel import distributed
    from pytorch_news_recommender_tpu_torch.train.checkpoint import CheckpointManager
    from pytorch_news_recommender_tpu_torch.train.loop import Trainer, step_generator

    torch.cuda.set_device(0)
    assert distributed.initialize(f"127.0.0.1:{port}", world, rank, backend="gloo")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, ds = training_data(MESH_STEPS[world])
    FE.build()
    out = {"rank": rank}

    def config(sched, rate, capacity=MESH_CAPACITY):
        return dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, dropout=rate, embedding_lookup=sched,
                                           a2a_capacity_factor=capacity),
            mesh=dataclasses.replace(cfg.mesh, model_parallel_size=2))

    def digest(tensors):
        return hashlib.sha256(b"".join(t.detach().cpu().numpy().tobytes()
                                       for t in tensors)).hexdigest()

    for sched in MESH_RUNS[world]:
        for rate in (0.0, RANK_DROPOUT):
            rcfg = config(sched, rate)
            trainer = Trainer(rcfg, ds, device=DEVICE)
            state = trainer.init_state(seed=0)
            blocks = state.opt.blocks
            assert sorted(blocks) == ["news_encoder.word_embedding.embedding"], blocks
            host = list(trainer.sliced_batches(np.random.default_rng(rcfg.train.seed)))
            kept, real = [], layers.fused_news_encoder

            def keep_first(x, mask, *weights, **kw):
                if kw.get("dropout_rate", 0.0) > 0 and not kept:
                    kept.append((x.detach().clone(), mask.clone(),
                                 [w.detach().clone() for w in weights], dict(kw)))
                return real(x, mask, *weights, **kw)
            layers.fused_news_encoder = keep_first
            for fn in (FE.fused_news_encoder, FE.fused_news_encoder_bwd, FE.weight_grad):
                fn.launches = 0
            losses, step_ms, hashes, draws = [], [], [], []
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with no_plain(FE, SS):
                for batch in device_prefetch(host, DEVICE):
                    draws.append(int(torch.randint(0, 2 ** 31 - 1, (), generator=step_generator(
                        rcfg.train.seed + 1, state.step))))
                    t0 = time.perf_counter()
                    state, m = trainer.run_step(state, batch)
                    losses.append(float(m["loss"]))
                    step_ms.append((time.perf_counter() - t0) * 1e3)
                    named = dict(state.model.named_parameters())
                    hashes.append([digest(p for n, p in named.items() if n not in blocks),
                                   digest(named[n] for n in blocks)])
                    trainer.check_replicas(state)
                    if rate == 0.0 and state.step == 1:
                        torch.save({k: v.cpu() for k, v in state.params.items()},
                                   work / f"{sched}_rank{rank}_step1.pt")
                peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
                launches = {"fwd": FE.fused_news_encoder.launches,
                            "bwd": FE.fused_news_encoder_bwd.launches,
                            "wgrad": FE.weight_grad.launches}
                run = {"losses": losses, "step_ms": step_ms, "hashes": hashes,
                       "launches": launches, "peak_gib": peak_gib,
                       "data_index": trainer.data_idx,
                       "block_rows": [[n, b.start, b.rows, b.full_rows]
                                      for n, b in blocks.items()],
                       "block_mib": sum(3 * named[n].numel() * 4 for n in blocks) / 2 ** 20}
                if rate == 0.0 and world == 2 and sched == "psum":
                    metrics = trainer.evaluate(state)
                    CheckpointManager(work / "ckpt", rcfg).save(state.step, state, metrics)
                    run["auc"] = metrics["auc"]
            layers.fused_news_encoder = real
            if rate > 0:
                x, mask, weights, kw = kept[0]
                d = trainer.data_idx
                assert kw["seed"] == FE.shard_seed(draws[0], d), (kw["seed"], draws[0], d)
                with torch.no_grad():
                    got = FE.fused_news_encoder(x, mask, *weights, **kw)
                    real_rows = mask.sum(1) > 0
                    errs = {}
                    for who, r in (("own", d), ("other", 1 - d)):
                        if r >= trainer.n_data:
                            continue
                        ref = FE.fused_news_encoder_reference(
                            x, mask, *weights, num_heads=kw["num_heads"],
                            dropout_rate=kw["dropout_rate"],
                            seed=draws[0] + r * FE.SHARD_SEED_STRIDE)
                        errs[who] = rel_err(got[real_rows], ref[real_rows])
                run.update(seed=kw["seed"], draw=draws[0], mask_err=errs)
            out[f"{sched}_{rate}"] = run
            del trainer, state
    if world == 2:
        # a2a buckets far too small: the loss must come out NaN, never silent
        trainer = Trainer(config("a2a", 0.0, MESH_OVERFLOW), ds, device=DEVICE)
        batch = next(iter(trainer.sliced_batches(np.random.default_rng(cfg.train.seed))))
        _, m = trainer.run_step(trainer.init_state(seed=0), batch)
        out["overflow_loss"] = float(m["loss"])
    (work / f"rank{rank}.json").write_text(json.dumps(out))
    distributed.barrier()


def mesh_run(FE, SS, tag):
    """Phase 23: the model axis on the one card. For each world of MESH_RUNS,
    its ranks (``mesh_worker``, spawned after the kernels were built, over
    ``gloo``, all on ``cuda:0``) train NRMS with the word table split by rows
    over the two ranks of each data row. Held: every rank's loss equal bit
    for bit at every step; the replicated parameters' bytes equal on every
    rank and each block's on its data group; 3 / 3 / 12 launches a step; at
    dropout 0 against one process on the same global batches
    (``Trainer(replay_ranks=n_data)``): the losses within 1%, and the first
    update, the model peers' blocks joined into the whole table, held by
    ``update_errors`` as phases 20 and 22 hold it; at dropout 0.2 each
    rank's kernel applied the mask of its data index's folded seed, equal on
    model peers. At two ranks: a NaN loss at capacity factor MESH_OVERFLOW,
    and the psum run's checkpoint restored in one process evaluates to the
    ranks' AUC. Returns the ranks' launch counts by run."""
    import torch.multiprocessing as mp
    from pytorch_news_recommender_tpu_torch.train.checkpoint import CheckpointManager
    from pytorch_news_recommender_tpu_torch.train.loop import Trainer

    table = "news_encoder.word_embedding.embedding"
    launches_by_run = {}
    for world, scheds in MESH_RUNS.items():
        work = WORK / f"mesh{world}"
        shutil.rmtree(work, ignore_errors=True)
        work.mkdir(parents=True)
        t0 = time.perf_counter()
        mp.start_processes(mesh_worker, args=(world, free_port(), work), nprocs=world,
                           join=True, start_method="spawn")
        spawn_s = time.perf_counter() - t0
        res = [json.loads((work / f"rank{r}.json").read_text()) for r in range(world)]
        n_data, steps = world // 2, MESH_STEPS[world]
        for sched in scheds:
            for rate in (0.0, RANK_DROPOUT):
                runs = [r[f"{sched}_{rate}"] for r in res]
                for r, run in enumerate(runs):
                    assert run["losses"] == runs[0]["losses"], (r, run["losses"])
                    assert np.all(np.isfinite(run["losses"])) and len(run["losses"]) == steps
                    assert [h[0] for h in run["hashes"]] == [h[0] for h in runs[0]["hashes"]]
                    assert [h[1] for h in run["hashes"]] == [h[1] for h in runs[r % 2]["hashes"]]
                    assert run["data_index"] == r // 2
                    lc = run["launches"]
                    assert [lc["fwd"], lc["bwd"], lc["wgrad"]] == [3 * steps, 3 * steps,
                                                                  12 * steps], lc
                    launches_by_run[f"mesh{n_data}x2_{sched}_dropout{rate}_rank{r}"] = lc
                if rate > 0:
                    for r, run in enumerate(runs):
                        peer = runs[r - r % 2]
                        assert run["seed"] == peer["seed"] and run["mask_err"]["own"] < 2e-2
                        if "other" in run["mask_err"]:
                            assert run["mask_err"]["other"] > 2e-2, run["mask_err"]
                    if n_data > 1:
                        assert runs[2]["seed"] == (runs[0]["seed"] + FE.SHARD_SEED_STRIDE) % 2 ** 32
        # one process on the same global batches (every data row's block)
        cfg, ds = training_data(steps)
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dropout=0.0))
        trainer = Trainer(cfg, ds, device=DEVICE, replay_ranks=n_data)
        state = trainer.init_state(seed=0)
        before = {k: v.detach().clone() for k, v in state.params.items()}
        host = list(trainer.sliced_batches(np.random.default_rng(cfg.train.seed)))
        single, after1 = [], None
        with no_plain(FE, SS):
            for batch in host:
                state, m = trainer.run_step(state, batch)
                single.append(float(m["loss"]))
                if after1 is None:
                    after1 = {k: v.detach().clone() for k, v in state.params.items()}
        _, g32, noise = grad_noise(FE, SS, trainer, f32_trainer(trainer, replay_ranks=n_data),
                                   host[0])
        noisy = {n for n in g32 if noise[n] > GRAD_NOISE}
        for sched in scheds:
            ranks = [r[f"{sched}_0.0"] for r in res]
            loss_err = max(abs(x - y) / abs(y) for x, y in zip(ranks[0]["losses"], single))
            assert loss_err < 0.01, (sched, loss_err, ranks[0]["losses"], single)
            peers = [torch.load(work / f"{sched}_rank{r}_step1.pt") for r in (0, 1)]
            step1 = {k: (torch.cat([p[k] for p in peers]) if k == table else v).to(DEVICE)
                     for k, v in peers[0].items()}
            assert step1[table].shape == before[table].shape
            upd_err = update_errors(before, step1, after1, g32, noisy, set(before))
            blocks = ranks[0]["block_rows"]
            print(f"[phase 23] ({n_data} x 2) mesh, {sched} lookups ({spawn_s:.1f} s for the "
                  f"world's spawn and runs): {steps} steps of global batch "
                  f"{cfg.train.batch_size} at dropout 0 and {RANK_DROPOUT}: every rank's loss "
                  f"equal at every step, the replicated parameters' bytes equal on all {world} "
                  f"ranks and each block's on its data group; the word table's blocks "
                  f"{blocks}; against one process on the same batches: loss max rel err "
                  f"{loss_err:.3g} (tol 0.01), first update, the two blocks joined, "
                  f"{upd_err:.3g} of each parameter's largest change (tol {UPDATE_TOL}; not "
                  f"held, at bf16 noise: {sorted(noisy)}); dropout {RANK_DROPOUT}: seeds "
                  f"{[r[f'{sched}_{RANK_DROPOUT}']['seed'] for r in res]} (draw + data index "
                  f"* {FE.SHARD_SEED_STRIDE}), kernel vs the plain version with its own "
                  f"mask / the other row's "
                  f"{[r[f'{sched}_{RANK_DROPOUT}']['mask_err'] for r in res]}", flush=True)
            for r, rr in enumerate(res):
                run = rr[f"{sched}_0.0"]
                p50, p99 = (float(np.percentile(run["step_ms"], q)) for q in (50, 99))
                print(f"{tag} ({n_data} x 2) {sched} rank {r} (data row {r // 2}, model "
                      f"index {r % 2}): train step p50 {p50:.2f} ms, p99 {p99:.2f} ms "
                      f"(global batch {cfg.train.batch_size}); peak memory of the steps "
                      f"{run['peak_gib']:.2f} GiB, the table's block with Adam's moments "
                      f"{run['block_mib']:.1f} MiB of {2 * run['block_mib']:.1f}; launches "
                      f"{run['launches']}; {world} processes time-sharing one card over "
                      f"gloo, not a multi-card figure", flush=True)
        if world == 2:
            assert all(np.isnan(r["overflow_loss"]) for r in res), [r["overflow_loss"]
                                                                    for r in res]
            ranks_auc = res[0]["psum_0.0"]["auc"]
            assert all(r["psum_0.0"]["auc"] == ranks_auc for r in res)
            one = Trainer(dataclasses.replace(cfg, mesh=dataclasses.replace(
                cfg.mesh, model_parallel_size=1)), ds, device=DEVICE)
            restored = CheckpointManager(work / "ckpt").restore(one.init_state(seed=5))
            assert restored.params[table].shape == (VOCAB, D)
            assert restored.opt.mu[table].shape == (VOCAB, D)
            auc = one.evaluate(restored)["auc"]
            assert auc == ranks_auc, (auc, ranks_auc)
            print(f"[phase 23] (1 x 2): capacity factor {MESH_OVERFLOW} gives a NaN loss on "
                  f"both ranks; the psum run's checkpoint (step {restored.step}, the whole "
                  f"word table and its moments) restored in one process: dev AUC "
                  f"{auc:.6f}, equal to the ranks'", flush=True)
        del trainer, state
    return launches_by_run


def mesh_serve_run(FE, SS, cfg, ds, params, ckpt, tag):
    """Phase 24: ``Recommender(mesh=...)`` with MESH_BLOCKS row blocks of the
    corpus cache on the one card, in both cache modes, on phase 3's corpus
    and weights (65,239 rows: the pad path runs), against the single-device
    ``Recommender``: ``score_many`` and ``score`` within MESH_SCORE_TOL of
    the largest score, ``top_k`` ids equal but where two scores lie within
    MESH_TIE, ``add_news`` across the blocks' end, and times beside the
    single-device ones. The single-device answers and times come first; then
    the main path (the mesh recommender's corpus encode and requests) runs
    alone with the plain versions made to raise, its launches counted from
    0, and they must be one per corpus-encode chunk, ``score_many`` batch,
    ``score``, ``top_k`` and ``add_news``. Then ``cli serve --mesh`` on phase
    7's checkpoint answers ``/score`` and ``/top_k`` over HTTP. Returns the
    launches."""
    from pytorch_news_recommender_tpu_torch import cli
    from pytorch_news_recommender_tpu_torch.parallel.mesh import make_mesh
    from pytorch_news_recommender_tpu_torch.serve import Recommender
    from pytorch_news_recommender_tpu_torch.train.checkpoint import load_config

    rng = np.random.default_rng(24)
    mesh = make_mesh(cfg.mesh, [DEVICE + ":0"] * MESH_BLOCKS)
    assert mesh.shape == {"data": MESH_BLOCKS, "model": 1}
    n_rows = N_NEWS + 1
    launches = 0

    def close(a, b):
        return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                     / max(1e-6, float(np.abs(np.asarray(b)).max())))

    def same_top(a, b):
        (ids, scores), (ids1, scores1) = a, b
        assert close(scores, scores1) <= MESH_SCORE_TOL, (scores, scores1)
        for i in np.nonzero(ids != ids1)[0]:
            tie = np.abs(scores1 - scores1[i]) <= MESH_TIE * abs(scores1[i])
            assert ids[i] in ids1[tie], (i, ids, ids1, scores1)

    def batches(r, reqs):
        """The ``score_many`` batches (one user-tower launch each) of ``reqs``."""
        widths = collections.Counter(r._width_for(len(c)) for _, c, _ in reqs)
        return sum(-(-n // r.BATCH_PAD) for n in widths.values())

    rows0 = -(-n_rows // MESH_BLOCKS)
    cap = rows0 * MESH_BLOCKS
    words = list(ds.dicts["word"])
    # fresh news: the first fills the last block's pad row, the last passes
    # the blocks' end (the table grows and splits again)
    titles = [" ".join(words[50 * i + j] for j in range(6)) for i in range(cap - n_rows + 1)]
    for cache in ("native", "int8"):
        # the single-device answers first, outside the mesh path's count
        one = Recommender(cfg, ds, params, corpus_cache=cache, device=DEVICE)
        whole = one.news_q if cache == "int8" else one.news_vecs
        reqs = [(h, c, 0) for h, c in make_requests(rng, 2 * one.BATCH_PAD, n_rows)]
        batch = [(h, rng.integers(1, n_rows, size=300).tolist(), 0)
                 for h, _ in make_requests(rng, one.BATCH_PAD, n_rows)]
        hist = batch[0][0]
        want_many = one.score_many(reqs)
        want_score = [one.score(h, c) for h, c, _ in reqs[:4]]
        want_top = [one.top_k(h, 10) for h, _, _ in reqs[:8]]
        times = {"one": (latency(lambda: one.score_many(batch), 50),
                         latency(lambda: one.top_k(hist, 10), 50))}
        # the mesh path alone, its launches counted from 0
        FE.fused_news_encoder.launches = 0
        with no_plain(FE, SS):
            rec = Recommender(cfg, ds, params, corpus_cache=cache, mesh=mesh)
            assert rec.block_rows == rows0
            got_many = rec.score_many(reqs)
            got_score = [rec.score(h, c) for h, c, _ in reqs[:4]]
            got_top = [rec.top_k(h, 10) for h, _, _ in reqs[:8]]
            times["mesh"] = (latency(lambda: rec.score_many(batch), 50),
                             latency(lambda: rec.top_k(hist, 10), 50))
            new = [rec.add_news(t) for t in titles]
            got_added = (rec.score(new + [1, 2], new + [3, 4]), rec.top_k(new + [5], 10))
        mesh_launches = FE.fused_news_encoder.launches
        per_encode = math.ceil(n_rows / cfg.train.eval_encode_chunk)
        want_launches = (per_encode + batches(rec, reqs) + 4 + 8
                         + 50 * batches(rec, batch) + 50 + len(new) + 2)
        assert mesh_launches == want_launches, (mesh_launches, want_launches)
        launches += mesh_launches
        blocks = rec.q_blocks if cache == "int8" else rec.vec_blocks
        assert len(blocks) == MESH_BLOCKS and rec.block_rows > rows0
        joined = rec.news_q if cache == "int8" else rec.news_vecs
        assert torch.equal(joined[:n_rows], whole) and not joined[n_rows + len(new):].any()
        score_err = max(close(a, b) for a, b in zip(got_many, want_many))
        score_err = max([score_err] + [close(a, b) for a, b in zip(got_score, want_score)])
        assert score_err <= MESH_SCORE_TOL, score_err
        for a, b in zip(got_top, want_top):
            same_top(a, b)
        for i, t in enumerate(titles):
            assert one.add_news(t) == new[i] == n_rows + i
        assert rec.block_rows * MESH_BLOCKS > cap and rec.n_news == one.n_news
        add_err = close(got_added[0], one.score(new + [1, 2], new + [3, 4]))
        assert add_err <= MESH_SCORE_TOL, add_err
        same_top(got_added[1], one.top_k(new + [5], 10))
        print(f"[phase 24] mesh serving ({cache}): {MESH_BLOCKS} row blocks of "
              f"{rows0} rows on {DEVICE}:0 ({n_rows} rows padded to {cap}); "
              f"score_many / score vs the single-device recommender {score_err:.3g} of the "
              f"largest score (tol {MESH_SCORE_TOL}), top_k ids equal but for ties within "
              f"{MESH_TIE}; {len(new)} add_news past the blocks' end (now {rec.block_rows} "
              f"rows a block): scores {add_err:.3g} off, top_k equal; the mesh path's "
              f"fused_encoder_fwd launches {mesh_launches} ({per_encode} corpus-encode "
              f"chunks + one per score_many batch, score, top_k and add_news)", flush=True)
        print(f"{tag} mesh serving ({cache}, {MESH_BLOCKS} blocks on one card): score_many "
              f"({rec.BATCH_PAD} x 300) p50 {times['mesh'][0][0]:.2f} ms, p99 "
              f"{times['mesh'][0][1]:.2f} ms (single device {times['one'][0][0]:.2f} / "
              f"{times['one'][0][1]:.2f}); top_k (k=10) p50 {times['mesh'][1][0]:.2f} ms, p99 "
              f"{times['mesh'][1][1]:.2f} ms (single device {times['one'][1][0]:.2f} / "
              f"{times['one'][1][1]:.2f})", flush=True)
        del rec, one, whole, joined

    # cli serve --mesh on phase 7's checkpoint (small synthetic size)
    args = cli.build_parser().parse_args(["serve", "--data", "synthetic", "--ckpt", ckpt,
                                          "--port", "0", "--mesh"])
    srv = cli.build_server(args)
    n_cards = torch.cuda.device_count()
    assert srv.rec.mesh is not None and len(srv.rec.vec_blocks) == n_cards
    small = Recommender.from_checkpoint(ckpt, cli._load_dataset(args, load_config(ckpt)),
                                        device=DEVICE)
    srv.start(block=False)
    try:
        got = post(srv.port, "/score", {"history": [1, 2, 3], "candidates": [4, 5, 6, 7]})
        assert close(got["scores"], small.score([1, 2, 3], [4, 5, 6, 7])) <= MESH_SCORE_TOL
        got = post(srv.port, "/top_k", {"history": [1, 2, 3], "k": 5})
        same_top((np.asarray(got["ids"]), np.asarray(got["scores"])), small.top_k([1, 2, 3], 5))
    finally:
        srv.stop()
    print(f"[phase 24] cli serve --mesh: {n_cards} row block(s), one a visible card; /score "
          f"and /top_k answered over HTTP as the single-device recommender answers",
          flush=True)
    return launches


def nccl_run(tag):
    """``--nccl``: ``cli train`` at the small synthetic size, with its
    dev-split evaluations (each gathers the replicas' checksums and the
    score blocks), then ``cli submit``, over the nccl backend with one
    rank a card, at two ranks and at every card, data-parallel and with
    ``--model-parallel 2`` (the word table split by rows over each pair of
    cards): every rank finishes on its own card, rank 0 writes one metrics
    log and one submission file, and the file equals one process's from the
    same checkpoint. The kernels and ``native/`` are built before the ranks
    start; each rank logs to its own file (NCCL's INFO lines too) and dumps
    its stacks and exits if it is not done within NCCL_RANK_S, so that a
    hang shows where it waits. Then ``cli serve --mesh`` in this process
    splits the corpus cache over every card."""
    from pytorch_news_recommender_tpu_torch import cli, native
    from pytorch_news_recommender_tpu_torch.ops import fused_encoder as FE

    cards = torch.cuda.device_count()
    assert cards >= 2, f"--nccl needs two or more cards, found {cards}"
    FE.build()
    assert native.available()
    root = pathlib.Path(__file__).resolve().parent
    env = {**os.environ, "NCCL_DEBUG": "INFO", "PYTHONPATH": os.pathsep.join(
        [str(root)] + [x for x in [os.environ.get("PYTHONPATH")] if x])}
    code = ("import faulthandler, sys; faulthandler.dump_traceback_later(" + str(NCCL_RANK_S)
            + ", exit=True); from pytorch_news_recommender_tpu_torch import cli; "
            "d, flags = sys.argv[1], sys.argv[2:]; "
            "assert cli.main(['train', '--data', 'synthetic', '--epochs', '1', "
            "'--save-dir', d] + flags) == 0; print('train done', flush=True); "
            "assert cli.main(['submit', '--data', 'synthetic', '--ckpt', d + '/nrms', "
            "'--out', d + '/ranks.txt'] + flags) == 0; print('submit done', flush=True)")
    for world, mp in itertools.product(sorted({2, cards}), (1, 2)):
        save, port = WORK / f"nccl{world}_mp{mp}", free_port()
        shutil.rmtree(save, ignore_errors=True)
        save.mkdir(parents=True)
        logs = [save / f"rank{r}.log" for r in range(world)]
        t0 = time.perf_counter()
        procs = []
        for r in range(world):
            with open(logs[r], "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", code, str(save), "--coordinator",
                     f"127.0.0.1:{port}", "--num-processes", str(world), "--process-id",
                     str(r), "--model-parallel", str(mp)], cwd=root, env=env, stdout=f,
                    stderr=subprocess.STDOUT))
        rcs = [p.wait(timeout=NCCL_RANK_S + 60) for p in procs]
        wall = time.perf_counter() - t0
        texts = [log.read_text(errors="replace") for log in logs]
        if any(rcs):
            for r, text in enumerate(texts):
                print(f"[nccl] {world} ranks, model axis {mp}: rank {r} rc {rcs[r]}, its "
                      f"log's tail:\n{text[-4000:]}", flush=True)
            raise AssertionError(f"--nccl: {world} ranks (model axis {mp}) ended with {rcs}")
        for r, text in enumerate(texts):
            assert f"rank {r} of {world} (nccl)" in text and "submit done" in text, text[-2000:]
        lines = [json.loads(x) for x in (save / "nrms" / "metrics.jsonl").read_text()
                 .splitlines()]
        aucs = [x["auc"] for x in lines if "auc" in x]
        assert aucs and all(np.isfinite(aucs)), lines
        assert cli.main(["submit", "--data", "synthetic", "--ckpt", str(save / "nrms"),
                         "--out", str(save / "one.txt")]) == 0
        ranks, one = (save / "ranks.txt").read_text(), (save / "one.txt").read_text()
        assert ranks == one and ranks.count("\n") > 0
        print(f"{tag} [nccl] {world} ranks, one a card, a ({world // mp} x {mp}) mesh: cli "
              f"train --model-parallel {mp} with {len(aucs)} evaluations (dev AUC "
              f"{aucs[-1]:.4f}, the replicas' checksums gathered at each) and cli submit: "
              f"one file of {ranks.count(chr(10))} lines, equal to one process's; "
              f"{wall:.1f} s of wall time for both commands, process start-up included",
              flush=True)
    # cli serve --mesh: the corpus cache split by rows over every card
    from pytorch_news_recommender_tpu_torch.serve import Recommender
    from pytorch_news_recommender_tpu_torch.train.checkpoint import load_config
    ckpt = str(WORK / f"nccl{cards}_mp2" / "nrms")
    args = cli.build_parser().parse_args(["serve", "--data", "synthetic", "--ckpt", ckpt,
                                          "--port", "0", "--mesh"])
    srv = cli.build_server(args)
    devices = [str(b.device) for b in srv.rec.vec_blocks]
    assert devices == [f"cuda:{i}" for i in range(cards)], devices
    one = Recommender.from_checkpoint(ckpt, cli._load_dataset(args, load_config(ckpt)),
                                      device=DEVICE)
    srv.start(block=False)
    try:
        got = post(srv.port, "/score", {"history": [1, 2, 3], "candidates": [4, 5, 6, 7]})
        np.testing.assert_allclose(got["scores"], one.score([1, 2, 3], [4, 5, 6, 7]),
                                   rtol=MESH_SCORE_TOL, atol=MESH_SCORE_TOL)
        got = post(srv.port, "/top_k", {"history": [1, 2, 3], "k": 5})
        assert got["ids"] == one.top_k([1, 2, 3], 5)[0].tolist(), got
    finally:
        srv.stop()
    print(f"{tag} [nccl] cli serve --mesh: the corpus cache in {cards} row blocks on "
          f"{devices}; /score and /top_k answered as one card answers", flush=True)


def latency(fn, n):
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.percentile(out, 50)), float(np.percentile(out, 99))


def main() -> int:
    try:
        import pytorch_news_recommender_tpu_torch  # noqa: F401
    except ModuleNotFoundError:
        print("chip_smoke: the package pytorch_news_recommender_tpu_torch is not beside "
              "this script; run it from the root of a checkout of the repo", file=sys.stderr)
        return 2
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
    if sys.argv[1:] == ["--nccl"]:
        nccl_run(tag)
        print(gpu, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    # 1. setup
    t0 = time.perf_counter()
    FE.build()
    print(f"kernel build+load: {time.perf_counter() - t0:.1f} s", flush=True)
    # the variants the kernels take: today's layout at NRMS's widths, the
    # wide variants where it does not fit one block (the user towers of
    # NAML, nrms_bert and disan), and the library's shared-memory need there
    lib = FE._lib()
    variants = {}
    for dt in (torch.bfloat16, torch.float32):
        for L in (12, 20, 40, 50):
            assert FE.variant(dt, L, *WIDTH) == (), (dt, L)
        code = FE._DTYPE_CODE[dt]
        for fam, width in WIDE_USERS.items():
            variants[(fam, str(dt))] = FE.variant(dt, 50, *width)
            need = [getattr(lib, f"newsrec_fused_encoder{sfx}_smem_bytes")(code, 50, *width)
                    for sfx in ("", "_bwd")]
            assert max(need) <= FE.MAX_SMEM, (dt, width, need)
            print(f"variants {str(dt)}: none at D=300 (L=12, 20, 40, 50); at {fam}'s user "
                  f"tower (L=50, D={width[0]}, {width[1]} heads, Q={width[2]}) "
                  f"{variants[(fam, str(dt))]}, shared memory forward {need[0]} and "
                  f"backward {need[1]} bytes of one block's {FE.MAX_SMEM}", flush=True)
    for fam in WIDE_USERS:
        assert variants[(fam, "torch.bfloat16")] == ("fwd_tail", "pool_bwd"), variants
        assert variants[(fam, "torch.float32")] == (
            "fwd_attn", "fwd_tail", "pool_bwd", "attn_bwd"), variants

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
    serving = (cfg, ds, params)   # phase 24 serves the same corpus and weights
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
    for M, L, width in FWD_SHAPES:
        k_ms, p_ms = times[(M, L, width[0])]
        print(f"{tag} fused_encoder_fwd bf16 M={M} L={L} D={width[0]}: kernel {k_ms:.4f} "
              f"ms/call ({fwd_kernels} device kernels), plain {p_ms:.4f} ms, bound "
              f"{bound(M, L, 2, width)[0]:.4f} ms", flush=True)
    del rec

    # 5. backward and weight-gradient kernels vs plain
    bwd_errs, bwd_times = check_backward(FE)

    # 6. training at full width
    cfg, ds = training_data()
    run6 = train_run(FE, SS, cfg, ds, 6)
    train_launches, step_ms, bs = run6["launches"], run6["step_ms"], cfg.train.batch_size
    assert train_launches["scatter"] == 0, train_launches
    steps = len(step_ms)
    p50, p99 = float(np.percentile(step_ms, 50)), float(np.percentile(step_ms, 99))
    adam = {"per_step": {k: v / steps for k, v in run6["step_launches"].items()},
            "p50": p50, "p99": p99, "peak": run6["steps_peak_gib"], "steps": steps}
    del run6
    print(f"{tag} train step (batch {bs}, {steps} steps): p50 {p50:.2f} ms, p99 "
          f"{p99:.2f} ms = {bs / p50 * 1e3:.0f} impressions/s", flush=True)
    print(f"{tag} fused_encoder_fwd bf16 M={TRAIN_SHAPES[1][0]} L={TRAIN_SHAPES[1][1]} "
          f"with dropout 0.2 + o1: {bwd_times['fwd_train']:.4f} ms/launch", flush=True)
    for M, L, width, rates in BWD_SHAPES:
        k_ms, p_ms, i_ms = bwd_times[(M, L, width[0])]
        print(f"{tag} fused_encoder_bwd bf16 dropout {max(rates)} M={M} L={L} D={width[0]}: "
              f"kernels {k_ms:.4f} ms/call (incl. 4 weight_grad; per-item kernels "
              f"{i_ms:.4f} ms, {FE.bwd_tile(L)[0]} items in {FE.bwd_tile(L)[1]}-row tiles), "
              f"plain {p_ms:.4f} ms, bound {bwd_bound(M, L, 2, width)[0]:.4f} ms", flush=True)
        if width != WIDTH:
            f_ms = bwd_times[("fwd_o1", M, L, width[0])]
            print(f"{tag} fused_encoder_fwd bf16 M={M} L={L} D={width[0]} with o1 (the "
                  f"training forward): {f_ms:.4f} ms/call, bound "
                  f"{bound(M, L, 2, width)[0]:.4f} ms", flush=True)
    print(f"{tag} NRMS training: {train_launches['bwd'] / steps:.1f} backward calls per step",
          flush=True)
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

    # 9-11. the nrms_entity, tanr and hierec families, trained and served
    fcfg, fds = family_data()
    fam = {name: family_run(FE, SS, fcfg, fds, name, 9 + i, tag)
           for i, name in enumerate(FAMILIES)}
    del fds

    # 12. NAML (title and abstract towers at D=300, the user tower at D=800
    # in the kernels' wide variants), trained and served on the same corpus
    # with abstracts
    fcfg, fds = family_data(NAML_ABST_LEN)
    fill = fds.news.abst[1:] != 0
    fds.dicts = {"word": word_dict(VOCAB), "category": {"sports": 3},
                 "subcategory": {"golf": 7}}
    print(f"[phase 12] naml corpus: abstracts of {fds.news.abst.shape[1]} slots, "
          f"{float(fill.sum(1).mean()):.2f} real words on average (sd "
          f"{float(fill.sum(1).std()):.2f})", flush=True)
    fam["naml"] = family_run(FE, SS, fcfg, fds, "naml", 12, tag, workflow=True)
    del fds

    # 13-15. nrms_bert, disan and lstur on the corpus with 768-wide BERT
    # vectors and 50,000 users, each with the CLI at the small synthetic size
    fcfg, fds = family_data(bert_dim=BERT_DIM, n_users=N_USERS)
    fds.dicts = {"word": word_dict(VOCAB)}
    for i, (name, over) in enumerate(NEW_FAMILIES.items()):
        fam[name] = family_run(FE, SS, fcfg, fds, name, 13 + i, tag, cli=True,
                               model_over=over)
    del fds

    # 16-19. gnn (its title tower over the 2-hop frontier, M=65,536),
    # fastformer, npa and list_rank on that corpus with a 15-neighbor graph
    for i, (name, over) in enumerate(LATER_FAMILIES.items()):
        if i == 0 or name == "list_rank":
            fcfg, fds = family_data(
                bert_dim=BERT_DIM, n_users=N_USERS, n_neighbors=GNN_NEIGHBORS,
                sample_size=LIST_RANK_SAMPLE_SIZE if name == "list_rank" else None)
            fds.dicts = {"word": word_dict(VOCAB)}
        fam[name] = family_run(FE, SS, fcfg, fds, name, 16 + i, tag, cli=True,
                               model_over=over, train_over=LATER_TRAIN.get(name))
        if name == "npa":
            fam[name]["probe_losses"] = lr_probe(fcfg, fds, name, NPA_PROBE_LR, 16 + i)
    del fds

    # 20. Adafactor at NRMS's full width, on phase 6's corpus
    ada_launches = adafactor_run(FE, SS, cfg, ds, tag, adam)

    # 21. the C++ fast path of native/ on phase 6's batches and corpus
    native_run(cfg, ds, tag)
    del ds

    # 22. two ranks on the one card over gloo, and the CLI on two ranks
    rank_launches, replay_launches = ranks_run(FE, SS, tag)

    # 23. the model axis: (1 x 2) and (2 x 2) meshes of ranks on the one card
    mesh_launches = mesh_run(FE, SS, tag)

    # 24. the corpus cache in row blocks (Recommender(mesh=...)), cli serve --mesh
    mesh_serve_launches = mesh_serve_run(FE, SS, *serving, ckpt, tag)

    by_path = {
        "fwd": {"serve": serve_launches, "train": train_launches["fwd"],
                "train_dedup_gather_mxu": mxu_launches["fwd"]},
        "bwd": {"train": train_launches["bwd"], "train_dedup_gather_mxu": mxu_launches["bwd"]},
        "wgrad": {"train": train_launches["wgrad"],
                  "train_dedup_gather_mxu": mxu_launches["wgrad"]}}
    for key in ("fwd", "bwd", "wgrad"):
        by_path[key]["train_adafactor"] = ada_launches[key]
        for r, launches in enumerate(rank_launches):
            by_path[key][f"train_2rank_rank{r}"] = launches[key]
        by_path[key]["train_2rank_replay"] = replay_launches[key]
        for run, launches in mesh_launches.items():
            by_path[key][run] = launches[key]
    by_path["fwd"]["serve_mesh"] = mesh_serve_launches
    for name, r in fam.items():
        by_path["fwd"][f"{name}_train"] = r["train"]["fwd"]
        by_path["fwd"][f"{name}_serve"] = r["serve"]
        by_path["bwd"][f"{name}_train"] = r["train"]["bwd"]
        by_path["wgrad"][f"{name}_train"] = r["train"]["wgrad"]

    k_ms, p_ms = times[(*SHAPES[0], D)]
    b_ms, b_by = bound(*SHAPES[0], 2)
    bk_ms, bp_ms, bi_ms = bwd_times[(*TRAIN_SHAPES[1], D)]
    bb_ms, bb_by = bwd_bound(*TRAIN_SHAPES[1])
    w_ms, wp_ms, wl_ms, (R, K, N, _, _) = bwd_times["wgrad"]
    wb_ms, wb_by = wgrad_bound(R, K, N, 2)
    products = {}
    for key, *_ in WGRAD_PRODUCTS:
        ms, plain_ms, library_ms, (Rp, Kp, Np, itemsize, bias) = bwd_times[key]
        products[key] = {"K": Kp, "N": Np, "a_itemsize": itemsize, "bias": bias, "ms": ms,
                         "plain_ms": plain_ms, "library_ms": library_ms,
                         "bound_ms": wgrad_bound(Rp, Kp, Np, itemsize, bias)[0],
                         "max_rel_err": bwd_errs[key], "max_abs_err": bwd_errs[key + "_abs"],
                         "max_rel_err_f64": bwd_errs[key + "_f64"],
                         "plain_max_rel_err_f64": bwd_errs[key + "_plain_f64"]}
    src = "pytorch_news_recommender_tpu_torch/ops/csrc/"
    tpu = "pytorch_news_recommender_tpu/ops/pallas/fused_encoder.py:"
    print(json.dumps({"kernels": [
        {"name": "fused_encoder_fwd", "route": "cuda", "source": src + "fused_encoder.cu",
         "replaces": tpu + "149",
         "launches": sum(by_path["fwd"].values()), "launches_by_path": by_path["fwd"],
         "max_abs_err": max(v for k, v in errs.items() if "bfloat16" in k[0]),
         "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
         "library_ms": None,
         "shape": {"M": SHAPES[0][0], "L": SHAPES[0][1], "D": D, "H": H, "Q": Q,
                   "dtype": "bfloat16"},
         "launches_per_call": {"wrapper": FWD_LAUNCHES, "device_kernels": fwd_kernels},
         "tile_rows": FE.fwd_tile(SHAPES[0][1])[1],
         "by_shape": {f"M={M},L={L}" + ("" if w == WIDTH else f",D={w[0]}"): {
             "ms": times[(M, L, w[0])][0], "plain_ms": times[(M, L, w[0])][1],
             "bound_ms": bound(M, L, 2, w)[0]} for M, L, w in FWD_SHAPES},
         "train_ms": bwd_times["fwd_train"],
         "naml_user_train_ms": bwd_times[("fwd_o1", 512, 50, NAML_USER[0])],
         "user_tower_train_ms": {fam: bwd_times[("fwd_o1", 512, 50, w[0])]
                                 for fam, w in WIDE_USERS.items()},
         "variants_naml_user": {dt: v for (fam, dt), v in variants.items() if fam == "naml"},
         "variants_user_towers": {f"{fam},{dt}": v for (fam, dt), v in variants.items()}},
        {"name": "fused_encoder_bwd", "route": "cuda", "source": src + "fused_encoder_bwd.cu",
         "replaces": tpu + "261",
         "launches": sum(by_path["bwd"].values()), "launches_by_path": by_path["bwd"],
         "max_abs_err": bwd_errs["bwd_abs"], "max_rel_err": bwd_errs["bwd_rel"],
         "ms": bk_ms, "plain_ms": bp_ms, "bound_ms": bb_ms, "bound_by": bb_by,
         "library_ms": None, "kernels_ms": bi_ms,
         "by_shape": {f"M={M},L={L},D={w[0]}": {
             "dropout": max(rates), "ms": bwd_times[(M, L, w[0])][0],
             "plain_ms": bwd_times[(M, L, w[0])][1], "kernels_ms": bwd_times[(M, L, w[0])][2],
             "bound_ms": bwd_bound(M, L, 2, w)[0]} for M, L, w, rates in BWD_SHAPES},
         "tile_rows": FE.bwd_tile(TRAIN_SHAPES[1][1])[1],
         "shape": {"M": TRAIN_SHAPES[1][0], "L": TRAIN_SHAPES[1][1], "D": D, "H": H, "Q": Q,
                   "dtype": "bfloat16", "dropout": 0.2}},
        {"name": "encoder_weight_grad", "route": "cuda",
         "source": src + "fused_encoder_bwd.cu", "replaces": tpu + "432",
         "launches": sum(by_path["wgrad"].values()), "launches_by_path": by_path["wgrad"],
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
