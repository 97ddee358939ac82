"""Kernels #2 and #2a's share of their roofline in training: twice the
forward towers' counted work over the device time of every operation
launched inside the encoder's autograd node (``FusedNewsEncoderBackward``:
the per-item backward and the weight-gradient products), on the first
rank."""

from h100bench import counting

LAYER = "ops/csrc kernels"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "train_impressions_per_s"
NODE = "FusedNewsEncoderBackward"


def read(rec):
    if rec.kind != "train" or rec.trace is None or rec.work is None:
        return None
    t = rec.trace.device_s(lambda name: name.endswith(NODE))
    if t <= 0:
        return None
    return 100.0 * counting.roofline_s(rec.work.bwd_flops, rec.work.bwd_bytes) / t
