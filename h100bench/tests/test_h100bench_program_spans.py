"""The readers of the program's own spans (``newsrec.*``): idle time put
down to the feed's wait and the step, the optimizer's device time, the
feed's build time; quiet on a program without the spans."""

import pytest

from h100bench import core, counting, devtrace, idle

NEW = ("idle_feed_ms.train", "idle_step_ms.train", "optimizer_ms.train", "feed_build_ms.train")


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid,
            "args": args}


def _trace(program_spans=True):
    """Window [0, 100] us; the device busy over [0, 40] and [80, 100], idle
    over [40, 80]. The step [0, 60] holds the optimizer [10, 30]; the feed's
    wait is [60, 90], so half the idle gap lies in it and half in the step."""
    ev = [
        _ev("user_annotation", devtrace.WINDOW, 0, 100),
        _ev("cuda_runtime", "cudaLaunchKernel", 2, 1, correlation=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 12, 1, correlation=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 14, 1, correlation=3),
        _ev("cuda_runtime", "cudaLaunchKernel", 70, 1, correlation=4),
        _ev("kernel", "fwd_attn_kernel", 0, 15, tid=7, correlation=1),
        # two of the optimizer's operations, overlapping on two streams
        _ev("kernel", "vectorized_elementwise_kernel", 15, 20, tid=7, correlation=2),
        _ev("kernel", "vectorized_elementwise_kernel", 25, 15, tid=8, correlation=3),
        _ev("gpu_memcpy", "Memcpy HtoD", 80, 20, tid=8, correlation=4),
    ]
    if program_spans:
        ev += [_ev("user_annotation", "newsrec.train.step", 0, 60),
               _ev("user_annotation", "newsrec.train.optimizer", 10, 20),
               _ev("user_annotation", "newsrec.feed.wait", 60, 30)]
    return devtrace.Trace({"traceEvents": ev})


def _rec(trace, steps=2, step_us=50.0):
    """The record of a traced stretch of ``steps`` steps whose untraced
    window took ``step_us`` a step (ten steps)."""
    work = counting.Work()
    work.steps = 10
    return core.Record(kind="train", trace=trace, counts={"traced_steps": steps},
                       step_work=work, window_s=10 * step_us * 1e-6)


@pytest.fixture(scope="module")
def readers():
    return core.Bench().metrics()


@pytest.mark.parametrize("step_us", [50.0, 80.0])
@pytest.mark.parametrize("name", ["idle_feed_ms.train", "idle_step_ms.train"])
def test_idle_time_goes_to_the_span_it_lies_in(readers, name, step_us):
    """The traced 40 us idle gap lies half in the step and half in the
    feed's wait, so each takes half of the untraced window's idle time a
    step: its step time less the traced 60 us of device time over two
    steps."""
    rec = _rec(_trace(), step_us=step_us)
    assert readers[name].read(rec) == pytest.approx(1e-3 * (step_us - 30.0) / 2)


def test_an_optimizer_operation_counts_once(readers):
    """Launched inside both the step and the optimizer, on two streams that
    overlap: their union [15, 40], once."""
    assert readers["optimizer_ms.train"].read(_rec(_trace(), steps=1)) == pytest.approx(25e-3)


def test_the_feed_build_is_the_mean_span_of_the_traced_stretch(readers, monkeypatch):
    """The buffer's clock lies 1 s after the trace's; the stretch's wait
    (trace 60 us) places the window [0, 100] us there. A build of an earlier
    profile (with its own wait) and one after the window are left out."""
    from pytorch_news_recommender_tpu_torch.utils import tracing

    at = lambda us: int(1e9 + 1e3 * us)  # noqa: E731
    spans = [tracing.Span("newsrec.feed.wait", 1, at(-6000), at(-5990)),
             tracing.Span("newsrec.feed.build", 9, at(-5000), at(2000)),
             tracing.Span("newsrec.feed.build", 9, at(5), at(25)),
             tracing.Span("newsrec.feed.upload", 9, at(25), at(95)),
             tracing.Span("newsrec.feed.wait", 1, at(59.99), at(90)),
             tracing.Span("newsrec.feed.build", 9, at(60), at(100)),
             tracing.Span("newsrec.feed.build", 9, at(150), at(900))]
    monkeypatch.setattr(tracing, "snapshot", lambda: spans)
    assert readers["feed_build_ms.train"].read(_rec(_trace())) == pytest.approx(0.03)


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_the_spans_reads_nothing(readers, name, monkeypatch):
    from pytorch_news_recommender_tpu_torch.utils import tracing

    monkeypatch.setattr(tracing, "snapshot", lambda: [])
    assert readers[name].read(_rec(_trace(program_spans=False))) is None


def test_a_tiny_traced_run_reads_all_four(tiny, runner, monkeypatch):
    recs = []
    per_layer = core.per_layer
    monkeypatch.setattr(core, "per_layer", lambda b, rec: recs.append(rec) or per_layer(b, rec))
    out = runner(tiny, "nrms-train-b512", trace=True)
    m = out["metrics"]
    assert all(m.get(n, {}).get("value") is not None for n in NEW), sorted(m)
    assert all(m[n]["unit"] == "ms" for n in NEW)
    assert m["feed_build_ms.train"]["value"] > 0
    # on the CPU no operation runs on a device, so the untraced window idles
    # all of its step time; the feed's wait and the step, which do not
    # overlap, hold nearly all of it
    (rec,) = recs
    step_ms = 1e3 * rec.window_s / rec.step_work.steps
    assert idle.untraced_idle_ms(rec) == pytest.approx(step_ms)
    idle_ms = m["idle_feed_ms.train"]["value"] + m["idle_step_ms.train"]["value"]
    assert 0.5 * step_ms < idle_ms <= step_ms * (1 + 1e-9)
