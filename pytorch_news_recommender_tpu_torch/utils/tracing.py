"""Spans of the port's own code, on the profiler's clock.

``span(name)`` marks a stretch of host code (the training step's forward,
backward and optimizer, the feed's wait, build and upload). It records
while a ``torch.profiler`` session records anywhere in the process (the
profiler's process-wide flag, true on every thread); otherwise it returns
one shared no-op context, at the cost of one attribute read.

A recording span

* on the thread where the profiler records also opens
  ``torch.profiler.record_function(name)``, so that it lies in the
  profiler's trace and the device operations launched inside it are
  credited to it (the profiler keeps no ranges of other threads);
* on every thread appends ``(name, tid, start_ns, end_ns)`` to a buffer of
  the last :data:`CAPACITY` spans (``tid`` the thread's native id, the times
  ``time.time_ns()``). The profiler's trace is on that clock: a span lies at
  ``(t_ns - baseTimeNanoseconds) / 1000`` microseconds of a Chrome trace,
  which is how :func:`add_to_trace` puts other threads' spans beside the
  profiler's own.

Every name starts ``newsrec.``.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from typing import List, NamedTuple

import torch
from torch.autograd import profiler as _profiler

CAPACITY = 65_536


class Span(NamedTuple):
    name: str
    tid: int
    start_ns: int
    end_ns: int


_buffer: collections.deque = collections.deque(maxlen=CAPACITY)
_OFF = contextlib.nullcontext()
_thread = threading.local()


def _tid() -> int:
    """The calling thread's native id, asked of the system once a thread
    (a system call, which costs microseconds on some hosts)."""
    tid = getattr(_thread, "tid", None)
    if tid is None:
        tid = _thread.tid = threading.get_native_id()
    return tid


class _Recording:
    __slots__ = ("name", "_range", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        # the buffer's span encloses the profiler's range (the range's first
        # entry in a session takes a millisecond after its start stamp)
        self._t0 = time.time_ns()
        self._range = None
        if torch.autograd._profiler_enabled():
            self._range = _profiler.record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
        _buffer.append(Span(self.name, _tid(), self._t0, time.time_ns()))
        return False


def span(name: str):
    """A context that records the stretch it encloses as ``name`` while a
    profiler records, and the shared no-op context otherwise."""
    if _profiler._is_profiler_enabled:
        return _Recording(name)
    return _OFF


def snapshot() -> List[Span]:
    """The recorded spans, oldest first."""
    return list(_buffer.copy())


def reset() -> None:
    """Forgets every recorded span."""
    _buffer.clear()


def add_to_trace(path) -> int:
    """Adds the buffer's spans of every thread but the calling one (which
    started the profiler, so the trace holds its spans already) to the
    Chrome trace at ``path``, as ``user_annotation`` ranges on the trace's
    own clock. Returns how many it added."""
    skip_tid = _tid()
    with open(path) as f:
        trace = json.load(f)
    base = int(trace["baseTimeNanoseconds"])
    pid = os.getpid()
    added = [{"ph": "X", "cat": "user_annotation", "name": s.name, "pid": pid, "tid": s.tid,
              "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
              "args": {}}
             for s in snapshot() if s.tid != skip_tid]
    trace["traceEvents"].extend(added)
    with open(path, "w") as f:
        json.dump(trace, f)
    return len(added)
