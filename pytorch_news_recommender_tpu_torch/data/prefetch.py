"""Double-buffered host -> device batch prefetching (port of the JAX
package's ``data/prefetch.py``).

On a CUDA device a background thread runs the numpy batch iterator
(shuffling, slicing, dedup), copies each batch into pinned host memory and
starts its host-to-device copy with ``non_blocking`` on a side stream, so
the copy of step N+1 overlaps the computation of step N. The consumer's
stream waits on an event recorded after the copy, and each tensor is
marked as used by that stream (``record_stream``), so a batch is never read
before its copy lands nor freed while a step still reads it. On the CPU it
is a plain iterator over ``torch.from_numpy`` views.

Spans (``utils/tracing.py``): ``newsrec.feed.wait`` on the consumer, from
entering ``next`` to holding the batch; ``newsrec.feed.build`` around the
host iterator's ``next`` (on the worker thread, or inside the wait on the
CPU) and ``newsrec.feed.upload`` around the pinning and the copy's enqueue.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

from pytorch_news_recommender_tpu_torch.utils import tracing

Batch = Dict[str, np.ndarray]

_SENTINEL = object()


def device_prefetch(batches: Iterator[Batch], device: torch.device,
                    depth: int = 2) -> Iterator[Dict[str, torch.Tensor]]:
    """Wrap a host batch iterator with an asynchronous upload stage: yields
    the batches as dicts of tensors on ``device``. ``depth`` bounds how many
    batches are uploaded ahead of the consumer (2 = double buffering)."""
    device = torch.device(device)
    batches = iter(batches)
    if device.type != "cuda":
        while True:
            with tracing.span("newsrec.feed.wait"):
                with tracing.span("newsrec.feed.build"):
                    b = next(batches, _SENTINEL)
                if b is _SENTINEL:
                    return
                dev = {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in b.items()}
            yield dev

    q: queue.Queue = queue.Queue(maxsize=depth)
    err: list[BaseException] = []
    stop = threading.Event()

    def worker():
        try:
            with torch.cuda.device(device):
                side = torch.cuda.Stream(device)
                while True:
                    with tracing.span("newsrec.feed.build"):
                        b = next(batches, _SENTINEL)
                    if b is _SENTINEL or stop.is_set():
                        break
                    with tracing.span("newsrec.feed.upload"):
                        host = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                                for k, v in b.items()}
                        with torch.cuda.stream(side):
                            dev = {k: t.to(device, non_blocking=True) for k, t in host.items()}
                            done = torch.cuda.Event()
                            done.record(side)
                    q.put((dev, done))
        except BaseException as e:  # propagate to the consumer
            err.append(e)
        finally:
            q.put(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            with tracing.span("newsrec.feed.wait"):
                item = q.get()
                if item is _SENTINEL:
                    break
                dev, done = item
                compute = torch.cuda.current_stream(device)
                compute.wait_event(done)
                for v in dev.values():
                    v.record_stream(compute)
            yield dev
    finally:
        # an abandoned generator (early stop) lets the worker finish
        stop.set()
        while t.is_alive():
            try:
                q.get(timeout=0.1)
            except queue.Empty:
                pass
        t.join()
    if err:
        raise err[0]
