"""Kernel #1's share of its roofline in training: the least time the chip
could take for the forward towers' work (each distinct news once at its real
length, each impression's real history) over the device time of every
operation launched inside the program's encoder forward wrapper
(``fused_news_encoder``, which the benchmark's span ``encoder_fwd``
encloses), on the first rank."""

from h100bench import counting

LAYER = "ops/csrc kernels"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "train_impressions_per_s"


def read(rec):
    if rec.kind != "train" or rec.trace is None or rec.work is None:
        return None
    t = rec.trace.device_s(lambda name: name == "h100bench.encoder_fwd")
    if t <= 0:
        return None
    return 100.0 * counting.roofline_s(rec.work.fwd_flops, rec.work.fwd_bytes) / t
