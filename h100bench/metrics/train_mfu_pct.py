"""The whole training step's share of the chips' peak: the operations the
window's batches need (towers forward and backward, scores; each distinct
news of a global batch once, at its real length) over the bf16 tensor-core
peak of every chip for the whole window."""

from h100bench import counting

LAYER = "train/loop.py and models/ (the whole step)"
UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
MOVES = "train_impressions_per_s"


def read(rec):
    if rec.kind != "train" or rec.step_work is None or rec.window_s <= 0:
        return None
    return 100.0 * rec.step_work.step_flops / (rec.chips * counting.PEAK_FLOPS * rec.window_s)
