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

``backward_span(name, x, anchor)`` marks the backward pass of a stretch of
the forward, from the gradient's arrival at the stretch's output to its
departure from the stretch's input, as a recording span of the thread that
runs the backward (autograd's own thread on a CUDA device), so the device
operations of that backward are credited to it. While a profiler records it
puts two identity autograd nodes at the stretch's ends; otherwise it adds
none and costs one attribute read.

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


class _BackwardRange:
    """The recording span of one stretch's backward: opened once, closed
    once, whichever of its two nodes or the backward's end comes first."""

    __slots__ = ("name", "_rec", "_done")

    def __init__(self, name: str):
        self.name, self._rec, self._done = name, None, False

    def open(self) -> None:
        if self._rec is None and not self._done:
            self._rec = _Recording(self.name)
            self._rec.__enter__()
            # a backward that never reaches the stretch's input (gradients
            # asked of inner parameters only) closes the span at its end
            torch.autograd.Variable._execution_engine.queue_callback(self.close)

    def close(self) -> None:
        rec, self._rec, self._done = self._rec, None, True
        if rec is not None:
            rec.__exit__(None, None, None)


class _OpenAt(torch.autograd.Function):
    """Identity at a stretch's output; its backward opens the span."""

    @staticmethod
    def forward(ctx, rng, out):
        ctx.rng = rng
        return out.view_as(out)

    @staticmethod
    def backward(ctx, grad):
        ctx.rng.open()
        return None, grad


class _CloseAt(torch.autograd.Function):
    """Identity at a stretch's input; its backward closes the span. The
    ``anchor`` (a parameter of the stretch) keeps the node in the graph
    when the input needs no gradient."""

    @staticmethod
    def forward(ctx, rng, x, anchor):
        ctx.rng = rng
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        ctx.rng.close()
        return None, grad if ctx.needs_input_grad[1] else None, None


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def backward_span(name: str, x: torch.Tensor, anchor: torch.Tensor):
    """``(x, leave)`` for a stretch of the forward that starts at ``x``:
    the stretch computes from the returned ``x`` and returns
    ``leave(output)``. While a profiler records (and autograd records), the
    stretch's backward is the span ``name`` (module docstring); otherwise
    ``x`` comes back as it is and ``leave`` is the identity."""
    if not _profiler._is_profiler_enabled or not torch.is_grad_enabled():
        return x, _same
    rng = _BackwardRange(name)
    return _CloseAt.apply(rng, x, anchor), lambda out: _OpenAt.apply(rng, out)


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
