"""Host time a training step waits on the prefetched feed's ``next``, per
step of the window (the benchmark's span around the iterator's ``next``)."""

LAYER = "data/loader.py and data/prefetch.py"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "train_impressions_per_s"


def read(rec):
    waits = rec.spans.get("feed_wait")
    if rec.kind != "train" or not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
