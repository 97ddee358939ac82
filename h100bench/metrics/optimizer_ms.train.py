"""Device time per traced training step of the optimizer: every operation
launched inside the program's ``newsrec.train.optimizer`` span (the
``Optimizer.step`` call of ``Trainer.run_step``) on the first rank, their
union over the traced steps."""

from h100bench import idle

LAYER = "train/loop.py (Optimizer)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "train_impressions_per_s"
SPAN = "newsrec.train.optimizer"


def read(rec):
    steps = rec.counts.get("traced_steps", 0)
    if rec.kind != "train" or rec.trace is None or not steps or not idle.ranges(rec.trace, SPAN):
        return None
    return 1e3 * rec.trace.device_s(lambda name: name == SPAN) / steps
