"""The GNN's graph-attention rounds' share of their roofline in the training
forward: the least time the chip could take for their counted work
(``work.parts["gat"]``: each round over the nodes that a later round or the
scores read, the logits as dot products with ``Wq a[:D]`` and ``Wk a[D:]``)
over the device time of every operation launched inside the program's span
``newsrec.gnn.gat`` (the neighbour gathers, every round, the gather of the
batch's own positions), on the first rank. Nothing to read where the family
has no ``gat`` part."""

from h100bench import counting

LAYER = "models/gnn.py (GATLayer)"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "train_impressions_per_s"
SPAN = "newsrec.gnn.gat"


def read(rec):
    if rec.kind != "train" or rec.trace is None or rec.work is None:
        return None
    part = rec.work.parts.get("gat")
    if part is None:
        return None
    t = rec.trace.device_s(lambda name: name == SPAN)
    if t <= 0:
        return None
    return 100.0 * counting.roofline_s(*part) / t
