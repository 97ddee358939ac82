"""Data-parallel training: one process a rank, one card a rank, over the
program's ``parallel/distributed.initialize`` (NCCL on the cards, gloo on
the CPU), each rank on its slice of every global batch. The ranks report to
the benchmark's process, which computes the metrics, checks every rank's
step against one reference at the global batch and prints the result."""

from __future__ import annotations

import os
import socket
import tempfile
import time
import traceback
from typing import Dict, List

from h100bench import checks as CK
from h100bench import core, devtrace
from h100bench.drivers import train as TR

REPORT_TIMEOUT_S = 900
STOP_EVERY = 4   # steps between the ranks' agreements to stop


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_main(root: str, cell_name: str, seed: int, seconds: float, trace: bool,
              rank: int, ranks: int, addr: str, device: str, trace_path: str,
              hook: str | None, q) -> None:
    """A rank's run (the target of each spawned process)."""
    try:
        import importlib

        import torch
        import torch.distributed as dist

        from pytorch_news_recommender_tpu_torch.parallel import distributed

        if hook:
            mod, fn = hook.split(":")
            getattr(importlib.import_module(mod), fn)()
        backend = "nccl" if device == "cuda" else "gloo"
        distributed.initialize(addr, ranks, rank, backend)
        flags = dist.new_group(backend="gloo")
        cell = core.Bench(root).cell(cell_name)
        sess = TR.RankRun(cell, seed, device, rank, ranks)
        prog = sess.check_steps()
        for _ in range(max(0, int(cell.spec.get("warmup_steps", 20)) - sess.steps)):
            sess.step()
        sess.sync()
        dist.barrier(group=flags)

        def stop(steps: int, elapsed: float) -> bool:
            if steps % STOP_EVERY:
                return False
            flag = torch.tensor([int(elapsed >= seconds)])
            dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=flags)
            return bool(flag[0])

        win = sess.window(seconds, stop)
        traced = sess.traced(int(cell.spec.get("trace_steps", 8)), trace_path) if trace else None
        peak = (torch.cuda.max_memory_allocated(sess.device)
                if sess.device.type == "cuda" else 0)
        sess.close()
        dist.barrier(group=flags)
        if rank != 0:
            win["feed_wait"] = []
        q.put({"rank": rank, "prog": prog, "win": win, "traced": traced, "peak": peak,
               "foreign": core.foreign_modules()})
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 — reported to the benchmark's process
        q.put({"rank": rank, "error": traceback.format_exc()})
        raise


def run(ctx, ranks: int) -> Dict:
    import queue

    import torch.multiprocessing as mp

    mctx = mp.get_context("spawn")
    q = mctx.Queue()
    addr = f"127.0.0.1:{_free_port()}"
    paths = []
    for r in range(ranks):
        fd, p = tempfile.mkstemp(prefix=f"h100bench-rank{r}-", suffix=".json")
        os.close(fd)
        paths.append(p)
    procs = [mctx.Process(target=rank_main,
                          args=(str(ctx.bench.root), ctx.cell.name, ctx.seed, ctx.seconds,
                                bool(ctx.trace), r, ranks, addr, ctx.device, paths[r],
                                getattr(ctx, "hook", None), q))
             for r in range(ranks)]
    for p in procs:
        p.start()
    reports: Dict[int, Dict] = {}
    deadline = time.time() + REPORT_TIMEOUT_S
    try:
        while len(reports) < ranks:
            try:
                rep = q.get(timeout=5)
            except queue.Empty:
                if time.time() > deadline or any(p.exitcode not in (None, 0) for p in procs):
                    raise RuntimeError("a rank ended without its report")
                continue
            if "error" in rep:
                raise RuntimeError(f"rank {rep['rank']} failed:\n{rep['error']}")
            reports[rep["rank"]] = rep
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
                p.join()
    rep0 = reports[0]
    win = rep0["win"]
    B = int(ctx.cell.config["port"]["train"]["batch_size"])
    out = {"attempted": win["steps"] * B,
           "failed": max(r["win"]["bad_steps"] for r in reports.values()) * B,
           "setup_s": win["start_epoch"] - ctx.t0,
           "memory_peak_bytes": max(r["peak"] for r in reports.values()),
           "foreign": sorted({m for r in reports.values() for m in r["foreign"]}),
           "metrics": {"train_impressions_per_s": {
               "value": win["steps"] * B / win["seconds"], "unit": "impressions/s"}}}
    inputs = TR.Inputs(ctx.cell, ctx.seed, ranks)
    if ctx.trace:
        traces = [devtrace.load(p) for p in paths]
        t0 = rep0["traced"]
        rec = core.Record(kind="train", ranks=ranks, chips=ranks, trace=traces[0],
                          spans={**t0["durations"], "feed_wait": win["feed_wait"]},
                          counts={**t0["counts"], "traced_steps": t0["steps"]},
                          work=TR.work_of(inputs, t0["first"], t0["steps"], 0),
                          step_work=TR.work_of(inputs, win["first"], win["steps"], None),
                          window_s=win["seconds"])
        rec.counts["busy_s"] = sum(t.busy_s for t in traces) / ranks
        rec.counts["window_s"] = sum(t.window_s for t in traces) / ranks
        out["record"] = rec
    for p in paths:
        os.unlink(p)
    import torch

    device = torch.device("cuda", 0) if ctx.device == "cuda" else torch.device("cpu")
    batches = [inputs.slices(k) for k in range(3)]
    ref, _ = TR.reference_numbers(ctx.cell, ctx.seed, device, ranks, batches)
    per_rank: List[Dict] = [CK.train_numbers(r["prog"]["losses"], r["prog"]["grad"],
                                             r["prog"]["change"], ref)
                            for _, r in sorted(reports.items())]
    worst = {k: max(n[k] for n in per_rank) for k in ctx.cell.checks}
    worst["ranks"] = per_rank
    out["numbers"] = worst
    return out
