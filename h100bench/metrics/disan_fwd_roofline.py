"""The DiSAN news tower's share of its roofline in the training forward: the
least time the chip could take for its counted work (``work.parts["disan"]``:
each distinct news once at its real title length, the products only) over
the device time of every operation launched inside the program's span
``newsrec.disan.encoder``, on the first rank. Nothing to read where the
family has no ``disan`` part."""

from h100bench import counting

LAYER = "models/disan.py (DiSA and Source2Token)"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "train_impressions_per_s"
SPAN = "newsrec.disan.encoder"


def read(rec):
    if rec.kind != "train" or rec.trace is None or rec.work is None:
        return None
    part = rec.work.parts.get("disan")
    if part is None:
        return None
    t = rec.trace.device_s(lambda name: name == SPAN)
    if t <= 0:
        return None
    return 100.0 * counting.roofline_s(*part) / t
