"""The port's spans (``utils/tracing.py``): off, a span is one shared no-op
and records nothing; under ``torch.profiler`` the training step's and the
feed's spans lie in the trace, nested as the code nests them, and every
thread's spans in the bounded buffer, on the trace's clock; ``cli train
--profile-dir`` adds the other threads' spans to its ``trace.json``."""

import contextlib
import json
import statistics
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pytorch_news_recommender_tpu_torch import cli
from pytorch_news_recommender_tpu_torch.config import synthetic_config
from pytorch_news_recommender_tpu_torch.data import synthetic
from pytorch_news_recommender_tpu_torch.data.loader import train_batches
from pytorch_news_recommender_tpu_torch.data.prefetch import device_prefetch
from pytorch_news_recommender_tpu_torch.train.loop import Trainer
from pytorch_news_recommender_tpu_torch.utils import tracing

torch.set_num_threads(2)

STEP = "newsrec.train.step"
STEPS = 2


@pytest.fixture(autouse=True)
def _clean():
    tracing.reset()
    yield
    tracing.reset()


@pytest.fixture(scope="module")
def trainer():
    cfg = synthetic_config(**{"train.batch_size": 64})
    ds = synthetic.generate(cfg.data, seed=3, n_train=256, n_dev=48, title_len=(11.5, 4))
    return Trainer(cfg, ds, device="cpu")


def _steps(tr, n=STEPS):
    state = tr.init_state(seed=0)
    feed = device_prefetch(train_batches(tr.dataset.train, tr.cfg.train.batch_size,
                                         np.random.default_rng(0)), tr.device)
    for _ in range(n):
        state, _ = tr.run_step(state, next(feed))
    feed.close()


@pytest.fixture(scope="module")
def profiled(trainer, tmp_path_factory):
    """``STEPS`` steps through ``device_prefetch`` and ``run_step`` under a
    CPU profiler: (the exported trace, the buffer, the stepping thread's
    native id)."""
    tracing.reset()
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _steps(trainer)
    prof.export_chrome_trace(str(path))
    spans = tracing.snapshot()
    tracing.reset()
    return json.loads(path.read_text()), spans, threading.get_native_id()


def _ranges(trace, name):
    return [e for e in trace["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e["name"] == name]


def test_off_a_span_is_the_shared_noop_and_records_nothing(trainer, monkeypatch):
    """With no profiler recording, every ``span`` is the same no-op
    context, enters no ``record_function``, and a step records nothing."""
    assert tracing.span("newsrec.a") is tracing.span("newsrec.b")
    assert isinstance(tracing.span("newsrec.a"), contextlib.nullcontext)

    def refuse(*_a, **_k):
        raise AssertionError("record_function entered with tracing off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    _steps(trainer, 1)
    assert tracing.snapshot() == []


@pytest.mark.parametrize("child", ["newsrec.train.forward", "newsrec.train.backward",
                                   "newsrec.train.optimizer"])
def test_the_step_span_holds_its_parts(profiled, child):
    trace, _, tid = profiled
    steps = _ranges(trace, STEP)
    parts = _ranges(trace, child)
    assert len(steps) == len(parts) == STEPS
    for s, p in zip(sorted(steps, key=lambda e: e["ts"]), sorted(parts, key=lambda e: e["ts"])):
        assert s["tid"] == p["tid"] == tid
        assert s["ts"] <= p["ts"] and p["ts"] + p["dur"] <= s["ts"] + s["dur"]


def test_the_feed_waits_lie_in_the_trace_and_builds_in_the_buffer(profiled):
    trace, spans, tid = profiled
    waits = _ranges(trace, "newsrec.feed.wait")
    assert len(waits) == STEPS and all(w["tid"] == tid for w in waits)
    steps = _ranges(trace, STEP)
    assert all(not (s["ts"] <= w["ts"] <= s["ts"] + s["dur"]) for w in waits for s in steps)
    builds = [s for s in spans if s.name == "newsrec.feed.build"]
    assert len(builds) == STEPS
    # on the CPU the host batch is built inside the wait
    for b, w in zip(builds, [s for s in spans if s.name == "newsrec.feed.wait"]):
        assert w.start_ns <= b.start_ns <= b.end_ns <= w.end_ns


def test_buffer_and_trace_share_the_clock(profiled):
    """The stepping thread's spans lie on the trace's clock
    (``baseTimeNanoseconds + ts * 1000``): each buffer span encloses its
    range in the trace (stamped before the range opens and after it
    closes), and their starts lie within 1 ms of each other at the median.
    An offset between the clocks would move every span; a thread preempted
    between the two stamps moves one (by 4 ms on a loaded host)."""
    trace, spans, tid = profiled
    base = int(trace["baseTimeNanoseconds"])
    mine = [s for s in spans if s.tid == tid]
    assert mine
    gaps = []
    for name in {s.name for s in mine}:
        buf = sorted((s.start_ns, s.end_ns) for s in mine if s.name == name)
        tr = sorted((base + e["ts"] * 1e3, base + (e["ts"] + e["dur"]) * 1e3)
                    for e in _ranges(trace, name))
        assert len(buf) == len(tr), name
        for (b0, b1), (t0, t1) in zip(buf, tr):
            # the trace's microseconds, rounded
            assert b0 - 1e3 <= t0 and t1 <= b1 + 1e3, name
            gaps.append(t0 - b0)
    assert statistics.median(gaps) < 1e6


def _on_thread(name, go=None):
    """Records ``name`` on a new thread (once ``go`` is set, if given);
    returns the thread and a list that receives its native id."""
    tid = []

    def run():
        if go is not None:
            go.wait()
        with tracing.span(name):
            time.sleep(0.002)
        tid.append(threading.get_native_id())

    t = threading.Thread(target=run)
    t.start()
    return t, tid


def _span_on_thread(name):
    """Records ``name`` on a new thread; returns that thread's native id."""
    t, tid = _on_thread(name)
    t.join()
    return tid[0]


@pytest.mark.parametrize("started", ["before", "inside"])
def test_a_span_on_another_thread_lands_in_the_buffer(started, tmp_path):
    """A worker thread's span reaches the buffer while the profiler records
    (which keeps no ranges of threads other than its own), whether the
    thread started before the profiler or under it."""
    go = threading.Event()
    if started == "before":
        t, tids = _on_thread("newsrec.feed.build", go)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if started == "inside":
            t, tids = _on_thread("newsrec.feed.build", go)
        go.set()
        t.join()
    tid = tids[0]
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    assert not _ranges(json.loads((tmp_path / "t.json").read_text()), "newsrec.feed.build")
    (s,) = tracing.snapshot()
    assert s.name == "newsrec.feed.build" and s.tid == tid != threading.get_native_id()
    assert s.end_ns - s.start_ns >= 2e6


def test_the_buffer_keeps_the_last_spans():
    def many():
        for i in range(tracing.CAPACITY + 5):
            with tracing.span(f"newsrec.{i}"):
                pass

    # on another thread, so that only the buffer records
    worker = threading.Thread(target=many)
    with profile(activities=[ProfilerActivity.CPU]):
        worker.start()
        worker.join()
    spans = tracing.snapshot()
    assert len(spans) == tracing.CAPACITY
    assert spans[0].name == "newsrec.5" and spans[-1].name == f"newsrec.{tracing.CAPACITY + 4}"


def test_add_to_trace_places_other_threads_spans_on_its_clock(tmp_path):
    path = tmp_path / "trace.json"
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("newsrec.train.step"):
            tid = _span_on_thread("newsrec.feed.upload")
    prof.export_chrome_trace(str(path))
    assert tracing.add_to_trace(path) == 1
    trace = json.loads(path.read_text())
    (step,) = _ranges(trace, "newsrec.train.step")
    (up,) = _ranges(trace, "newsrec.feed.upload")
    assert up["tid"] == tid != step["tid"]
    # the thread ran inside the step
    assert step["ts"] <= up["ts"] and up["ts"] + up["dur"] <= step["ts"] + step["dur"]


def test_cli_profile_dir_adds_the_other_threads_spans(tmp_path, monkeypatch):
    """``cli train --profile-dir``'s ``trace.json`` holds the step's and the
    feed's spans of the stepping thread, and a span recorded on another
    thread during ``fit`` on the trace's clock; tracing is off afterwards."""
    tids = []
    fit = Trainer.fit

    def fit_with_a_worker(self, *a, **k):
        tids.append(_span_on_thread("newsrec.feed.build"))
        return fit(self, *a, **k)

    monkeypatch.setattr(Trainer, "fit", fit_with_a_worker)
    assert cli.main(["train", "--data", "synthetic", "--epochs", "1", "--batch-size", "256",
                     "--eval-step", "100", "--device", "cpu", "--save-dir",
                     str(tmp_path / "save"), "--profile-dir", str(tmp_path / "prof")]) == 0
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    steps = _ranges(trace, STEP)
    assert steps and _ranges(trace, "newsrec.feed.wait")
    (worker,) = [e for e in _ranges(trace, "newsrec.feed.build") if e["tid"] == tids[0]]
    assert worker["ts"] < min(s["ts"] for s in steps)
    assert worker["ts"] > min(e["ts"] for e in trace["traceEvents"] if "ts" in e) - 1e6
    assert tracing.snapshot() == [] and tracing.span("newsrec.x") is tracing.span("newsrec.y")
