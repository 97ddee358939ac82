"""The readings that the limits of ``correct`` are set from, and the
serving sweep. Not part of a benchmark run.

    python3 h100bench/control.py --workload <cell> --seeds 1 2 3 ... [--fault half_batch]
    python3 h100bench/control.py --workload nrms-serve-mixed --sweep 200 400 800 --seconds 8

For each seed, in one process: the program's numbers as a run computes them
(a training cell's three check steps; a serving cell's short window at the
cell's own rate) and the control's, the reference computed in fp8 (both
operands of every product) in the program's place, held to the float32
reference alike. ``--fault half_batch`` plants a fault in the program's
step instead (half of each batch left out, the loss the mean over the
rest). Each reading carries ``judged``: ``correct`` as a run decides it
under the cell's limits, and each number over its limit. ``--sweep``
serves one seed's daemon at each offered rate in turn and prints each
rate's latencies, completions and backlog. One JSON line a reading, on
standard output and in ``--out``.
"""

from __future__ import annotations

import json
import os
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
if sys.path and pathlib.Path(sys.path[0] or ".").resolve() == HERE:
    sys.path.pop(0)
sys.path.insert(0, str(HERE.parent))

from h100bench import core  # noqa: E402

os.environ.update(core.cache_env())


def half_batch() -> None:
    """Plants the fault: every training step sees the first half of its
    impressions only."""
    from pytorch_news_recommender_tpu_torch.train.loop import Trainer

    inner = Trainer.run_step

    def run_step(self, state, batch):
        keys = ("browsed_idx", "candidate_idx") if "browsed_idx" in batch else (
            "browsed_ids", "candidate_ids")
        half = batch[keys[0]].shape[0] // 2
        return inner(self, state, {**batch, **{k: batch[k][:half] for k in keys}})

    Trainer.run_step = run_step


def train_readings(cell, seed: int, device: str, fault: str | None) -> dict:
    import torch

    from h100bench import checks as CK
    from h100bench.drivers import train as TR

    ranks = int(cell.traffic.get("ranks", 1))
    sess = TR.RankRun(cell, seed, device)
    prog = sess.check_steps()
    sess.close()
    torch.cuda.empty_cache()
    batches = [sess.inputs.slices(k) for k in range(3)]
    ref, _ = TR.reference_numbers(cell, seed, sess.device, ranks, batches)
    out = {"program": CK.train_numbers(prog["losses"], prog["grad"], prog["change"], ref)}
    if fault is None:
        _, out["control"] = TR.reference_numbers(cell, seed, sess.device, ranks, batches,
                                                 "fp8", ref)
    return out


def serve_readings(cell, seed: int, device: str, seconds: float) -> dict:
    import torch

    from h100bench import traffic as T
    from h100bench.drivers import serve as SV

    svc = SV.Service(cell, seed, device)
    reqs = T.make_requests(cell.traffic, svc.corpus, seconds, seed)
    sample = SV.sample_of(reqs, seed)
    res = svc.load(reqs, sample)
    dev = svc.device
    svc.stop()
    torch.cuda.empty_cache()
    got = SV.replies(res, reqs, sample)
    return {"program": SV.reference_numbers(cell, seed, dev, reqs, *got),
            "control": SV.reference_numbers(cell, seed, dev, reqs, *got, precision="fp8"),
            "p95_ms": {k: v["value"] for k, v in SV.latency_metrics(res, reqs).items()}}


def sweep(cell, seed: int, device: str, rates, seconds: float, request_seeds=None):
    import numpy as np

    from h100bench import traffic as T
    from h100bench.drivers import serve as SV

    svc = SV.Service(cell, seed, device)
    try:
        for rate, rseed in ((r, s) for r in rates for s in (request_seeds or [seed])):
            reqs = T.make_requests(cell.traffic, svc.corpus, seconds, rseed, rate=rate)
            res = svc.load(reqs, np.zeros(0, np.int64))
            lat = np.asarray(res["latency_s"])
            ok = np.asarray(res["status"]) == 200
            due = reqs.due
            q1, q4 = due < seconds / 4, due >= 3 * seconds / 4
            sc = lat[reqs.kind == 0]
            yield {"rate": rate, "request_seed": rseed, "requests": len(reqs),
                   "failed": int((~ok).sum()),
                   "score_p50_p90_p99_ms": [SV.percentile(sc, q) * 1e3 for q in (50, 90, 99)],
                   **{k: v["value"] for k, v in SV.latency_metrics(res, reqs).items()},
                   "median_first_quarter_ms": float(np.nanmedian(lat[q1])) * 1e3,
                   "median_last_quarter_ms": float(np.nanmedian(lat[q4])) * 1e3,
                   "last_reply_after_close_s": float(np.nanmax(lat + due) - seconds),
                   "lateness_p95_ms": SV.percentile(np.asarray(res["late_s"]), 95) * 1e3,
                   "over_500ms": int((lat > 0.5).sum()),
                   "connect_over_500ms": int((np.asarray(res["connect_s"]) > 0.5).sum()),
                   "connect_max_ms": float(np.nanmax(res["connect_s"])) * 1e3}
    finally:
        svc.stop()


def judged(numbers: dict, limits: dict) -> dict:
    """What a run would print of ``numbers``: ``correct`` as
    :func:`core.judge` decides it, and each number's share of its limit."""
    checks = core.judge(numbers, limits)
    return {"correct": core.all_within(checks),
            **{n: c["value"] / c["limit"] for n, c in checks.items()}}


def main() -> int:
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[1])
    p.add_argument("--fault", choices=("half_batch",))
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--sweep", type=float, nargs="*")
    p.add_argument("--request-seeds", type=int, nargs="*")
    p.add_argument("--out")
    args = p.parse_args()
    cell = core.Bench().cell(args.workload)
    out = open(args.out, "a") if args.out else None
    if args.fault == "half_batch":
        half_batch()

    def emit(d):
        line = json.dumps({"workload": cell.name, "card": core.card(), **d})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    if args.sweep:
        for row in sweep(cell, args.seeds[0], "cuda", args.sweep, args.seconds,
                         args.request_seeds):
            emit(row)
        return 0
    for seed in args.seeds:
        t = time.time()
        if cell.spec["driver"] == "serve":
            r = serve_readings(cell, seed, "cuda", args.seconds)
        else:
            r = train_readings(cell, seed, "cuda", args.fault)
        emit({"seed": seed, "fault": args.fault, "seconds": time.time() - t, **r,
              "judged": {side: judged(r[side], cell.checks)
                         for side in ("program", "control") if side in r}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
