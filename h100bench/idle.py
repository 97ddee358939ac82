"""Device idle time put down to the program's own host spans.

The program (``utils/tracing.py``) opens ``torch.profiler`` ranges named
``newsrec.*`` on the stepping thread while a profiler records, so they lie
in the trace beside the benchmark's. :func:`per_step_ms` takes the share of
the traced stretch's idle time (no operation on the device) that falls
inside the ranges of one name, and scales it to the untraced window's idle
time a step.

The profiler adds some microseconds of records to every operation it sees,
so a host-paced step idles longer traced than untraced, and the share is
biased towards the spans that launch the most operations (the forward and
the optimizer over the feed's wait): the split is where the idle time lies
under the profiler, the total is the window's.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from h100bench import devtrace


def ranges(trace, name: str) -> List[Tuple[float, float]]:
    """The disjoint union of the host ranges called ``name`` on any thread
    of ``trace``, in the trace's microseconds."""
    return devtrace.union((s, e) for rs in trace.host.values() for s, e, n in rs if n == name)


def overlap(a: Sequence[Tuple[float, float]], b: Sequence[Tuple[float, float]]) -> float:
    """The length of the intersection of two disjoint sorted unions."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def untraced_idle_ms(rec) -> Optional[float]:
    """Milliseconds a step of the untraced window in which the first rank's
    device idles: the window's host time a step less the traced stretch's
    device busy time a step (what ``device_idle_pct.train`` reads as a
    share), or None without a traced training window."""
    steps = rec.counts.get("traced_steps", 0)
    if (rec.kind != "train" or rec.trace is None or not steps or rec.step_work is None
            or rec.step_work.steps <= 0 or rec.window_s <= 0):
        return None
    busy_per_step = rec.counts.get("busy_s", rec.trace.busy_s) / steps
    return 1e3 * (rec.window_s / rec.step_work.steps - busy_per_step)


def per_step_ms(rec, name: str) -> Optional[float]:
    """Milliseconds a step of the untraced window's idle time that lie inside
    the ranges called ``name``, by their share of the traced stretch's idle
    time; None when the trace holds no such range (a program without it)."""
    window = untraced_idle_ms(rec)
    if window is None:
        return None
    spans = ranges(rec.trace, name)
    if not spans:
        return None
    idle = devtrace.gaps(rec.trace.busy_intervals, *rec.trace.window)
    total = sum(e - s for s, e in idle)
    return window * overlap(idle, spans) / total if total > 0 else 0.0
