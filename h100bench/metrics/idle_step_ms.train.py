"""Device idle time per training step while the stepping thread was inside
the program's ``Trainer.run_step`` (its ``newsrec.train.step`` span): the
idle stretches (no operation on the first rank's device) of the traced
stretch inside those spans.

The profiler's per-operation records slow a host-paced step, so the traced
stretch holds more idle time than the untraced window: the spans' share of
the traced idle time is scaled to the window's idle time a step (the one
``device_idle_pct.train`` reads as a share; ``idle.per_step_ms``). That
share leans towards the spans that launch the most operations."""

from h100bench import idle

LAYER = "train/loop.py (run_step)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "train_impressions_per_s"


def read(rec):
    return idle.per_step_ms(rec, "newsrec.train.step")
