"""The GNN's graph-attention rounds' share of their roofline in the training
backward: twice the forward's counted work (``work.parts["gat"]``) over the
device time of every operation launched inside the program's span
``newsrec.gnn.gat.backward`` (the thread that runs the backward, from the
gradient's arrival at the rounds' output to its leaving for the title
vectors), on the first rank. Nothing to read where the family has no
``gat`` part."""

from h100bench import counting

LAYER = "models/gnn.py (GATLayer)"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "train_impressions_per_s"
SPAN = "newsrec.gnn.gat.backward"


def read(rec):
    if rec.kind != "train" or rec.trace is None or rec.work is None:
        return None
    part = rec.work.parts.get("gat")
    if part is None:
        return None
    t = rec.trace.device_s(lambda name: name == SPAN)
    if t <= 0:
        return None
    flops, nbytes = part
    return 100.0 * counting.roofline_s(2 * flops, 2 * nbytes) / t
