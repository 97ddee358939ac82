"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Finds ``workloads/<cell>.json`` and its configuration and traffic files,
checks the chips the cell asks for, runs the cell's driver (set-up and
warm-up of the cell's own shapes, then the measured window), holds what the
timed path produced to the plain reference, and prints the result as the
last line of standard output: the cell's end-to-end metrics with ``--trace
0``, its per-layer metrics with ``--trace 1``. The numbers that decide
``correct`` are printed beside their limits as the last lines of standard
error and under ``checks``, last in the result. The run fails, and prints no
result, without the cards the cell asks for, or when JAX or the JAX package
is in any of its processes once the window has closed.
"""

from __future__ import annotations

import os
import pathlib
import sys

# the checkout's root on the path (the port and this package), this folder off
HERE = pathlib.Path(__file__).resolve().parent
if sys.path and pathlib.Path(sys.path[0] or ".").resolve() == HERE:
    sys.path.pop(0)
sys.path.insert(0, str(HERE.parent))

from h100bench import core  # noqa: E402

os.environ.update(core.cache_env())
# one process with few threads: no CPU thread pool competing with the host path
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "1")


def parse(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


class Context:
    """What a driver is given: the cell, the run's arguments, the device,
    the process's start time (``t0``) and the benchmark's files."""

    def __init__(self, bench, cell, seed, seconds, trace, device, t0, hook=None):
        self.bench, self.cell, self.seed, self.seconds = bench, cell, seed, seconds
        self.trace, self.device, self.t0, self.hook = trace, device, t0, hook


def execute(ctx: Context) -> tuple:
    """Runs the cell's driver; returns ``(result line, check lines)``."""
    out = ctx.bench.driver(ctx.cell.spec["driver"]).run(ctx)
    foreign = sorted(set(out.get("foreign", [])) | set(core.foreign_modules()))
    if foreign:
        raise SystemExit(f"h100bench: {', '.join(foreign)} loaded in a process of the run")
    numbers = out["numbers"]
    checks = core.judge(numbers, ctx.cell.checks)
    correct = core.all_within(checks)
    device = {"platform": "gpu" if ctx.device == "cuda" else ctx.device,
              "kind": device_name(ctx), "count": ctx.cell.chips,
              "memory_peak_bytes": int(out["memory_peak_bytes"])}
    breakdown = None
    if ctx.trace:
        rec = out["record"]
        metrics = core.per_layer(ctx.bench, rec)
        device["busy_s"] = rec.counts.get("busy_s", rec.trace.busy_s)
        device["window_s"] = rec.counts.get("window_s", rec.trace.window_s)
        breakdown = {"device_ops": rec.trace.top_ops(10), "idle_gaps": rec.trace.idle_gaps(10)}
    else:
        metrics = dict(out["metrics"])
        metrics["setup_s"] = {"value": float(out["setup_s"]), "unit": "s"}
    device["card"] = core.card() if ctx.device == "cuda" else ctx.device
    if "client" in out:
        device["client"] = out["client"]
    lines = [f"check {name}: {c['value']:.6g} (limit {c['limit']:.6g})"
             for name, c in checks.items()]
    detail = {k: v for k, v in numbers.items() if k not in checks and k != "ranks"}
    if detail:
        lines.insert(0, f"check detail: {detail}")
    return core.result_line(correct, out["attempted"], out["failed"], metrics, device,
                            checks, breakdown), lines


def device_name(ctx: Context) -> str:
    if ctx.device != "cuda":
        return ctx.device
    import torch

    return torch.cuda.get_device_name(0)


def main(argv=None) -> int:
    t0 = core.process_start()
    args = parse(argv)
    bench = core.Bench()
    cell = bench.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"h100bench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    ctx = Context(bench, cell, args.seed, args.seconds, bool(args.trace), "cuda", t0)
    line, checks = execute(ctx)
    for c in checks:
        print(c, file=sys.stderr)
    sys.stderr.flush()
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
