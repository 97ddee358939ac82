"""The trace's reduction: busy time is a union, device time goes to the
host range that launched it, idle gaps carry the open span."""

import numpy as np

from h100bench import devtrace


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid,
            "args": args}


def _trace():
    return {"traceEvents": [
        _ev("user_annotation", devtrace.WINDOW, 0, 100),
        _ev("user_annotation", "h100bench.encoder_fwd", 1, 10),
        _ev("cuda_runtime", "cudaLaunchKernel", 2, 1, correlation=1),
        _ev("cpu_op", "autograd::engine::evaluate_function: FusedNewsEncoderBackward", 30, 10,
            tid=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 31, 1, tid=2, correlation=2),
        _ev("user_annotation", "h100bench.feed_next", 70, 20),
        # a kernel of the forward, one of the backward overlapping a copy on
        # another stream, and one launched outside any range
        _ev("kernel", "fwd_attn_kernel", 10, 20, tid=7, correlation=1),
        _ev("kernel", "pool_bwd_kernel", 40, 20, tid=7, correlation=2),
        _ev("gpu_memcpy", "Memcpy HtoD", 50, 20, tid=8, correlation=3),
    ]}


def test_busy_time_is_the_union_not_the_sum():
    t = devtrace.Trace(_trace())
    assert abs(t.window_s - 100e-6) < 1e-12
    assert abs(t.busy_s - 50e-6) < 1e-12          # [10,30] + [40,70]; the sum is 60
    assert abs(t.idle_share - 0.5) < 1e-9


def test_device_time_goes_to_the_launching_range():
    t = devtrace.Trace(_trace())
    assert abs(t.device_s(lambda n: n == "h100bench.encoder_fwd") - 20e-6) < 1e-12
    assert abs(t.device_s(lambda n: n.endswith("FusedNewsEncoderBackward")) - 20e-6) < 1e-12
    assert t.device_s(lambda n: n == "h100bench.feed_next") == 0


def test_idle_gaps_carry_the_open_span():
    t = devtrace.Trace(_trace())
    gaps = t.idle_gaps(3)
    assert gaps[0][0] == "h100bench.feed_next" and abs(gaps[0][1] - 30e-6) < 1e-12  # [70, 100]
    assert np.allclose([g[1] for g in gaps], [30e-6, 10e-6, 10e-6])
    assert t.top_ops(2)[0][0] in ("fwd_attn_kernel", "pool_bwd_kernel", "Memcpy HtoD")


def test_union_and_gaps():
    u = devtrace.union([(5, 7), (0, 2), (1, 3), (6, 9)])
    assert u == [(0, 3), (5, 9)]
    assert devtrace.gaps(u, 0, 10) == [(3, 5), (9, 10)]
