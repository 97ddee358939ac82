"""The share of the profiled stretch of the serving window in which no
operation ran on the device."""

LAYER = "device"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "score_p95_ms"


def read(rec):
    if rec.kind != "serve" or rec.trace is None:
        return None
    return 100.0 * rec.trace.idle_share
