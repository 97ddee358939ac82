"""Device time per step of the gradient all-reduce in data-parallel
training: every operation launched inside the program's
``distributed.all_reduce_mean`` (the benchmark's span ``all_reduce_mean``),
on the first rank, over the traced steps."""

LAYER = "parallel/distributed.py"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "train_impressions_per_s"


def read(rec):
    if rec.kind != "train" or rec.ranks < 2 or rec.trace is None:
        return None
    steps = rec.counts.get("traced_steps", 0)
    if not steps:
        return None
    return 1e3 * rec.trace.device_s(lambda name: name == "h100bench.all_reduce_mean") / steps
