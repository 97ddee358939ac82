"""Reduction of a ``torch.profiler`` trace to what the metrics read.

* Busy time is the length of the union of the device's operation intervals
  (kernels, copies, memsets) inside the traced window: operations that
  overlap on two streams, as the prefetch copy and a kernel do, count once.
  Idle time is the window less that.
* Each device operation is given to the host ranges that were open on the
  launching thread when it was launched (its runtime call, matched by the
  trace's correlation id): the benchmark's own ranges (``h100bench.*``)
  and the program's operator and autograd-node ranges. A metric of a layer
  sums the operations launched inside that layer's range, whatever their
  kernels are called, so a renamed or replaced kernel keeps its metric.
* The idle gaps are labelled by the benchmark ranges open on the host at
  their middle.

The window is the host range named :data:`WINDOW`; the trace's host and
device clocks are the profiler's one clock, in microseconds.
"""

from __future__ import annotations

import bisect
import collections
import json
from typing import Callable, Dict, Iterable, List, Sequence, Tuple

WINDOW = "h100bench.window"
SPAN_PREFIX = "h100bench."
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}
HOST_CATS = {"cpu_op", "user_annotation"}


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The disjoint union of ``(start, end)`` intervals, sorted."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(merged: Sequence[Tuple[float, float]], lo: float, hi: float):
    """The stretches of ``[lo, hi]`` that no interval of ``merged`` (a
    disjoint sorted union) covers."""
    out, at = [], lo
    for s, e in merged:
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


def _open_ranges(host: List[tuple], points: List[Tuple[float, int]]) -> Dict[int, tuple]:
    """For each ``(time, key)`` point on one thread, the names of the host
    ranges ``(start, end, name)`` open there, outermost first."""
    ev = []
    for i, (s, e, _) in enumerate(host):
        ev.append((s, 1, -e, i))
        ev.append((e, 0, 0, i))
    for t, key in points:
        ev.append((t, 2, 0, key))
    ev.sort()
    stack: List[int] = []
    out = {}
    for _, kind, _, i in ev:
        if kind == 1:
            stack.append(i)
        elif kind == 0:
            if stack and stack[-1] == i:
                stack.pop()
            elif i in stack:
                stack.remove(i)
        else:
            out[i] = tuple(host[j][2] for j in stack)
    return out


class Trace:
    """One process's trace: its device operations within the window, each
    with the host ranges it was launched inside."""

    def __init__(self, trace: Dict, device: int | None = None):
        events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
        host: Dict[tuple, List[tuple]] = collections.defaultdict(list)
        launch: Dict[int, tuple] = {}
        dev = []
        self.window = None
        for e in events:
            cat, ts, dur = e.get("cat", ""), float(e.get("ts", 0)), float(e.get("dur", 0))
            args = e.get("args") or {}
            if cat in DEVICE_CATS:
                if device is None or int(args.get("device", device)) == device:
                    dev.append((e["name"], ts, ts + dur, args.get("correlation")))
            elif cat in LAUNCH_CATS and "correlation" in args:
                launch[args["correlation"]] = ((e.get("pid"), e.get("tid")), ts)
            elif cat in HOST_CATS:
                host[(e.get("pid"), e.get("tid"))].append((ts, ts + dur, e["name"]))
                if e["name"] == WINDOW and cat == "user_annotation":
                    self.window = (ts, ts + dur)
        if self.window is None:
            raise ValueError(f"the trace holds no {WINDOW!r} range")
        lo, hi = self.window
        self.ops = [(n, max(s, lo), min(e, hi), c) for n, s, e, c in dev if e > lo and s < hi]
        # the host ranges open at each operation's launch
        by_thread: Dict[tuple, list] = collections.defaultdict(list)
        for i, (_, _, _, c) in enumerate(self.ops):
            if c in launch:
                thread, t = launch[c]
                by_thread[thread].append((t, i))
        self.stacks: Dict[int, tuple] = {}
        for thread, pts in by_thread.items():
            self.stacks.update(_open_ranges(host[thread], pts))
        self.host = host
        # host spans recorded outside the profiler, on its clock: (start, end, name)
        self.extra_spans: List[tuple] = []
        self.busy_intervals = union((s, e) for _, s, e, _ in self.ops)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals) * 1e-6

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def device_s(self, inside: Callable[[str], bool]) -> float:
        """Device seconds (union) of the operations launched inside a host
        range whose name satisfies ``inside``."""
        sel = [(s, e) for i, (_, s, e, _) in enumerate(self.ops)
               if any(inside(n) for n in self.stacks.get(i, ()))]
        return sum(e - s for s, e in union(sel)) * 1e-6

    def top_ops(self, n: int = 10) -> List[list]:
        tot: Dict[str, float] = collections.defaultdict(float)
        for name, s, e, _ in self.ops:
            tot[name] += (e - s) * 1e-6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The ``n`` longest idle stretches of the window, each labelled by
        the benchmark ranges open on any host thread at its middle."""
        spans = [(s, e, name) for rs in self.host.values() for s, e, name in rs
                 if name.startswith(SPAN_PREFIX) and name != WINDOW] + list(self.extra_spans)
        spans.sort()
        starts = [s for s, _, _ in spans]
        out = []
        for s, e in sorted(gaps(self.busy_intervals, *self.window), key=lambda g: g[0] - g[1])[:n]:
            mid = (s + e) / 2
            j = bisect.bisect_right(starts, mid)
            names = sorted({name for a, b, name in spans[:j] if b >= mid})
            out.append(["+".join(names) or "no benchmark span", (e - s) * 1e-6])
        return out


def load(path) -> Trace:
    with open(path) as f:
        return Trace(json.load(f))
