"""Device idle time per training step while the stepping thread waited on
the feed: the idle stretches (no operation on the first rank's device) of
the traced stretch inside the program's ``newsrec.feed.wait`` spans
(``data/prefetch.py``: from entering the prefetched iterator's ``next`` to
holding the batch).

The profiler's per-operation records slow a host-paced step, so the traced
stretch holds more idle time than the untraced window: the spans' share of
the traced idle time is scaled to the window's idle time a step (the one
``device_idle_pct.train`` reads as a share; ``idle.per_step_ms``). That
share leans towards the spans that launch the most operations."""

from h100bench import idle

LAYER = "data/prefetch.py"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "train_impressions_per_s"


def read(rec):
    return idle.per_step_ms(rec, "newsrec.feed.wait")
