"""What every cell shares: finding its files by name, the fixed cache
directories, the run's record that the per-layer readers read, the check
for JAX in the process, and the result line.

Layout of the benchmark's folder (``ROOT``): ``configs/<config>.json``,
``traffic/<traffic>.json``, ``workloads/<cell>.json`` (its configuration,
traffic, driver, chips and checks), ``drivers/<driver>.py`` (``run(ctx)``)
and ``metrics/<metric>.py`` (``LAYER``, ``UNIT``, ``BETTER``, ``SOURCE``,
``MOVES`` and ``read(record)``). A new configuration, traffic mix, cell or
metric is a new file; nothing here lists them.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import pathlib
import sys
import time
from typing import Any, Dict, List, Optional

ROOT = pathlib.Path(__file__).resolve().parent
CHECKOUT = ROOT.parent

# top-level module names that no process of a run may hold
FOREIGN = ("jax", "jaxlib", "flax", "optax", "orbax", "pytorch_news_recommender_tpu")


def cache_env(checkout: pathlib.Path = CHECKOUT) -> Dict[str, str]:
    """Fixed cache directories inside the checkout, so that only a cell's
    first run there builds: PyTorch's extension and kernel caches and
    Triton's (the program builds its kernels into ``build/kernels`` and
    ``build/native`` itself). ``USE_FLAX``/``USE_TF`` keep libraries that
    could load JAX from doing so."""
    build = checkout / "build"
    return {"TORCH_EXTENSIONS_DIR": str(build / "torch_extensions"),
            "PYTORCH_KERNEL_CACHE_PATH": str(build / "torch_kernels"),
            "TRITON_CACHE_DIR": str(build / "triton"),
            "USE_FLAX": "0", "USE_TF": "0"}


def foreign_modules(modules=None) -> List[str]:
    """The names of :data:`FOREIGN` held in ``sys.modules``, compared by
    whole top-level name (``pytorch_news_recommender_tpu_torch`` is not the
    JAX package)."""
    tops = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(tops & set(FOREIGN))


def process_start() -> float:
    """The epoch time at which this process started (``/proc``), or now."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(float(l.split()[1]) for l in f if l.startswith("btime"))
        return btime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


def load_module(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """A workload file with its configuration and traffic loaded."""

    name: str
    spec: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]

    @property
    def chips(self) -> int:
        return int(self.spec["chips"])

    @property
    def checks(self) -> Dict[str, float]:
        """The limit of each number that decides ``correct``."""
        return dict(self.spec["checks"])


class Bench:
    """The benchmark's files under ``root``, found by name."""

    def __init__(self, root: pathlib.Path = ROOT):
        self.root = pathlib.Path(root)

    def json(self, kind: str, name: str) -> Dict[str, Any]:
        path = self.root / kind / f"{name}.json"
        with open(path) as f:
            return json.load(f)

    def names(self, kind: str, suffix: str) -> List[str]:
        return sorted(p.name[:-len(suffix)] for p in (self.root / kind).glob(f"*{suffix}"))

    def cell(self, name: str) -> Cell:
        spec = self.json("workloads", name)
        return Cell(name, spec, self.json("configs", spec["config"]),
                    self.json("traffic", spec["traffic"]))

    def driver(self, name: str):
        """``drivers/<name>.py`` (a module of this package, so that the
        processes it spawns can import it)."""
        return importlib.import_module(f"h100bench.drivers.{name}")

    def metrics(self) -> Dict[str, Any]:
        """Every per-layer reader, by metric name."""
        return {n: load_module(self.root / "metrics" / f"{n}.py",
                               "h100bench_metric_" + n.replace(".", "_").replace("-", "_"))
                for n in self.names("metrics", ".py")}


@dataclasses.dataclass
class Record:
    """What a run hands the per-layer readers.

    * ``kind``: ``train`` or ``serve``; ``ranks``: processes of the step;
    * ``trace``: the first rank's :class:`devtrace.Trace` of the traced
      stretch (None without ``--trace 1``);
    * ``spans``: the benchmark's host spans, durations in seconds by name;
    * ``counts``: counters (requests per scoring call, steps traced, ...);
    * ``work``: :class:`counting.Work` of what the first rank's device was
      given in the traced steps; ``step_work``: the whole window's work,
      over ``window_s`` seconds on ``chips`` chips."""

    kind: str
    ranks: int = 1
    chips: int = 1
    trace: Any = None
    spans: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    counts: Dict[str, float] = dataclasses.field(default_factory=dict)
    work: Any = None
    step_work: Any = None
    window_s: float = 0.0


def per_layer(bench: Bench, rec: Record) -> Dict[str, Dict[str, Any]]:
    """Every reader's value for ``rec``; a reader with nothing to read
    returns None and its metric is left out."""
    out = {}
    for name, mod in bench.metrics().items():
        value = mod.read(rec)
        if value is not None:
            if not math.isfinite(value):
                raise ValueError(f"metric {name} read {value}")
            out[name] = {"value": float(value), "unit": mod.UNIT}
    return out


class Spans:
    """Host spans of the benchmark's own wrappers: durations by name, and
    ``torch.profiler`` ranges named ``h100bench.<name>`` while a profiler
    records."""

    def __init__(self):
        self.durations: Dict[str, List[float]] = {}
        self.counts: Dict[str, float] = {}
        self.intervals: List[tuple] = []   # (name, start, end), perf_counter seconds

    def wrap(self, name: str, fn, count=None):
        """``fn`` with a span around each call; ``count(args)`` adds to the
        counter ``name``."""
        import torch

        label = "h100bench." + name

        def wrapped(*args, **kw):
            t0 = time.perf_counter()
            with torch.profiler.record_function(label):
                out = fn(*args, **kw)
            t1 = time.perf_counter()
            self.durations.setdefault(name, []).append(t1 - t0)
            self.intervals.append((name, t0, t1))
            if count is not None:
                self.counts[name] = self.counts.get(name, 0) + count(*args, **kw)
            return out

        return wrapped


def result_line(correct: bool, attempted: int, failed: int, metrics: Dict,
                device: Dict, checks: Dict[str, Dict[str, float]],
                breakdown: Optional[Dict] = None) -> str:
    """The run's last line: the contract's keys, ``checks`` last."""
    out: Dict[str, Any] = {"correct": bool(correct), "attempted": int(attempted),
                           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)


# what a compared number reads when there is none (a reply that never came)
NO_READING = 1e30


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """Each compared number beside its limit; a number that is missing or
    not finite is above any limit."""
    out = {}
    for name, limit in limits.items():
        v = numbers.get(name)
        v = float(v) if v is not None and math.isfinite(float(v)) else NO_READING
        out[name] = {"value": v, "limit": float(limit)}
    return out


def all_within(checks: Dict[str, Dict[str, float]]) -> bool:
    return bool(checks) and all(c["value"] <= c["limit"] for c in checks.values())


def card() -> str:
    """The card's name and power limit from ``nvidia-smi``, or ``unknown``."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=30,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"
