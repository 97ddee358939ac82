"""Where the port's training step spends its time, on one NVIDIA card.

    python3 chip_profile.py [--dedup-gather-mxu]
        [--model nrms_entity|tanr|hierec|naml|nrms_bert|disan|lstur|
                 gnn|fastformer|npa|list_rank]

Trains NRMS at the configuration of ``chip_smoke.py``'s training phase
(the JAX package's defaults: D=300, 10 heads, Q=200, batch 512, bf16,
dropout 0.2, dedup and a length split at 12 words, on the 65,238-news
synthetic corpus with MIND's mean title length), warms up for 3 steps, then
records 5 steps with ``torch.profiler`` and prints: the step's wall time,
the device time by kernel group and by kernel (the top 15, then every kernel
of the weight gradients, of the segment scatter and every memset, with
launches and time per launch), and the device's busy and idle shares of the
wall time. ``--dedup-gather-mxu`` profiles the step
whose inverse gathers' backward is the segment-scatter kernel; ``--model``
another family than NRMS, on the corpus of ``chip_smoke.py``'s phases 9-15
(entities, 18 categories, 294 subcategories; for ``naml`` the abstracts of
phase 12; for ``nrms_bert``, ``disan`` and ``lstur`` the BERT vectors and
users of phases 13-15; for ``gnn``, ``fastformer``, ``npa`` and
``list_rank`` those with the 15-neighbor graph of phases 16-19, and
``list_rank``'s 15 negatives; each with its model fields and training
defaults). The host feed goes through ``Trainer._maybe_frontier``, as
``fit``'s does (the GNN's neighborhood closure, in the prefetch thread).
Needs a CUDA card; prints nothing else.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import sys
import time
from collections import defaultdict

import numpy as np
import torch

import chip_smoke as CS

WARMUP, STEPS = 3, 5
GROUPS = (("fwd_attn_kernel", "encoder forward: attention"),
          ("fwd_tail_kernel", "encoder forward: tail"),
          ("pool_bwd_kernel", "encoder backward: pooling"),
          ("attn_bwd_kernel", "encoder backward: attention"),
          ("dx_kernel", "encoder backward: dx"),
          ("stage_weights_kernel", "encoder weight layout (forward and backward)"),
          ("weight_grad", "weight gradients"),
          ("::ss_", "segment scatter"),
          ("gemm", "library matrix products (cuBLAS, CUTLASS)"),
          ("index", "gathers and scatter-adds"),
          ("gather", "gathers and scatter-adds"),
          ("scatter", "gathers and scatter-adds"),
          ("grad_weight", "gathers and scatter-adds"),
          ("RadixSort", "gathers and scatter-adds"),
          ("elementwise", "elementwise (Adam, casts, masks)"),
          ("reduce", "reductions"),
          ("Memcpy", "copies"),
          ("Memset", "memsets"))


def group_of(name: str) -> str:
    for key, group in GROUPS:
        if key.lower() in name.lower():
            return group
    return "other"


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--dedup-gather-mxu", action="store_true")
    parser.add_argument("--model", default="nrms",
                        choices=("nrms",) + CS.FAMILIES + ("naml",) + tuple(CS.NEW_FAMILIES)
                        + tuple(CS.LATER_FAMILIES))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pytorch_news_recommender_tpu_torch.config import (
        FAMILY_TRAIN_DEFAULTS, Config, DataConfig,
    )
    from pytorch_news_recommender_tpu_torch.data import synthetic
    from pytorch_news_recommender_tpu_torch.data.loader import train_batches
    from pytorch_news_recommender_tpu_torch.data.prefetch import device_prefetch
    from pytorch_news_recommender_tpu_torch.train.loop import Trainer

    gpu = CS.card()
    if args.model == "nrms":
        cfg = Config(data=DataConfig(dataset="synthetic"))
        ds = synthetic.generate(cfg.data, seed=1, n_news=CS.N_NEWS, vocab_size=CS.VOCAB,
                                n_train=(WARMUP + STEPS) * cfg.train.batch_size, n_dev=64,
                                title_len=(11.5, 4))
    elif args.model in CS.NEW_FAMILIES:
        cfg, ds = CS.family_data(bert_dim=CS.BERT_DIM, n_users=CS.N_USERS)
    elif args.model in CS.LATER_FAMILIES:
        cfg, ds = CS.family_data(
            bert_dim=CS.BERT_DIM, n_users=CS.N_USERS, n_neighbors=CS.GNN_NEIGHBORS,
            sample_size=CS.LIST_RANK_SAMPLE_SIZE if args.model == "list_rank" else None)
    else:
        cfg, ds = CS.family_data(CS.NAML_ABST_LEN if args.model == "naml" else None)
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(
            cfg.model, name=args.model, dedup_gather_mxu=args.dedup_gather_mxu,
            **{**CS.NEW_FAMILIES, **CS.LATER_FAMILIES}.get(args.model, {})),
        train=dataclasses.replace(cfg.train, **FAMILY_TRAIN_DEFAULTS.get(args.model, {})))
    bs = cfg.train.batch_size
    trainer = Trainer(cfg, ds, device="cuda")
    state = trainer.init_state(seed=0)
    host = train_batches(ds.train, bs, np.random.default_rng(cfg.train.seed), dedup=True,
                         length_split=trainer._length_split)
    batches = device_prefetch(map(trainer._maybe_frontier, host), "cuda")
    for _ in range(WARMUP):
        state, m = trainer.run_step(state, next(batches))
    float(m["loss"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in itertools.islice(batches, STEPS):
            state, m = trainer.run_step(state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel: dict = defaultdict(float)
    calls: dict = defaultdict(int)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_kernel[e.name] += e.device_time_total / 1e3   # us -> ms
            calls[e.name] += 1
    busy = sum(by_kernel.values())
    by_group: dict = defaultdict(float)
    for name, ms in by_kernel.items():
        by_group[group_of(name)] += ms
    tag = f"[{gpu}]"
    print(f"{tag} {args.model}: {STEPS} training steps (batch {bs}, dedup_gather_mxu "
          f"{cfg.model.dedup_gather_mxu}): {wall_ms / STEPS:.2f} ms per step "
          f"(wall); device busy {busy / STEPS:.2f} ms per step = "
          f"{100 * busy / wall_ms:.1f}% of the wall, idle {100 * (1 - busy / wall_ms):.1f}%",
          flush=True)
    for group, ms in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"{tag}   {group:36s} {ms / STEPS:8.3f} ms per step "
              f"({100 * ms / busy:5.1f}% of device time)", flush=True)
    print(f"{tag} top kernels by device time:", flush=True)
    for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:15]:
        print(f"{tag}   {ms / STEPS:8.3f} ms per step  {name[:110]}", flush=True)
    # every kernel of these groups, so that their split by kernel is not cut
    # off by the top list (the scatter's memset is in the memsets, beside the
    # other memsets of the step)
    for group in ("weight gradients", "segment scatter", "memsets"):
        names = sorted((n for n in by_kernel if group_of(n) == group),
                       key=lambda n: -by_kernel[n])
        if names:
            print(f"{tag} {group}, by kernel:", flush=True)
        for name in names:
            print(f"{tag}   {by_kernel[name] / STEPS:8.4f} ms per step, "
                  f"{calls[name] / STEPS:g} launches per step, "
                  f"{1e3 * by_kernel[name] / calls[name]:8.2f} us per launch  {name[:90]}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
