"""What the inputs need: operations and bytes of a training step, and the
chip's peaks.

The work counted is what a batch's inputs need, not what the program
launched: each distinct news of a step once, at its real token count; the
user tower over each impression's real history; the backward at twice the
forward's operations. Padding, recomputation, the bf16 high/low passes of
the weight gradients and the launched tile shapes are not counted, so a
change to the program's padding or tiling cannot change what is counted.

Each model family counts its own work. This module keeps the formulas and
the sums and names no family: ``reference/<family>.py`` (the module that
``reference.family(name)`` loads) gives ``work(work, model, lens, news,
browsed, cand)``, which adds one slice's work to a :class:`Work`:

* ``Work.add_tower`` for a tower that runs inside the program's fused
  encoder (kernel #1 forward, #2 and #2a backward). Only these towers make
  ``fwd_flops`` and ``fwd_bytes``, what the encoder rooflines divide;
* ``Work.add_part(name, flops, nbytes)`` for forward work outside the fused
  encoder (a family's own attention, pooling or recurrence), counted at
  real token lengths with :func:`dense_flops` and
  :func:`elementwise_bytes`; it enters the whole step's operations and
  stays out of the encoder rooflines;
* ``Work.other_flops`` for products outside any tower (the scores), and
  ``Work.news_tokens`` for the real tokens of the news views it encodes.

``lens`` holds the corpus's per-news tables by news id
(``port.feature_lengths``): the real token counts, and the news graph
``neighbors [N+1, K]`` where the corpus has one, so that a family whose
step encodes a neighbourhood counts it from the slice's news.

A module without ``work`` stops the run (:func:`family_work`).

Per item of ``l`` real tokens, width ``D``, ``H`` heads of ``dh = D / H``,
pooling query ``Q`` (PERF.md gives the same formulas):

* forward operations ``2 l D (3D + D + Q) + 4 H l^2 dh + 2 l (Q + D)``:
  the q|k|v, output and pooling projections, the scores and the weighted
  values of every head, the pooling scores and the weighted sum;
* forward bytes ``2 (l D + D)`` of bfloat16 activations in and out, plus the
  tower's weights ``2 (3D^2 + 3D + D^2 + D + DQ + 2Q)`` once per call;
* backward: twice the forward's operations and bytes.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np

PEAK_FLOPS = 989e12          # dense bf16 tensor-core FLOP/s of one H100 SXM
PEAK_BYTES = 3.35e12         # HBM3 bytes/s of one H100 SXM
BYTES_BF16 = 2


def tower_flops(lengths: np.ndarray, D: int, H: int, Q: int) -> float:
    """Forward operations of one tower over items of ``lengths`` real
    tokens (items without one need none)."""
    l = np.asarray(lengths, np.float64)
    l = l[l > 0]
    dh = D / H
    return float((2 * l * D * (4 * D + Q) + 4 * H * l * l * dh + 2 * l * (Q + D)).sum())


def tower_bytes(lengths: np.ndarray, D: int, Q: int, calls: int = 1) -> float:
    """Forward bytes: each real item's tokens in and its vector out, and the
    weights once per call."""
    l = np.asarray(lengths, np.float64)
    l = l[l > 0]
    weights = 3 * D * D + 3 * D + D * D + D + D * Q + 2 * Q
    return float(BYTES_BF16 * ((l * D).sum() + D * len(l) + calls * weights))


def dense_flops(rows, k: int, n: int) -> float:
    """Operations of ``rows`` products of a ``k``-vector by a ``[k, n]``
    matrix."""
    return 2.0 * rows * k * n


def elementwise_bytes(elements, inputs: int = 1, outputs: int = 1,
                      itemsize: int = BYTES_BF16) -> float:
    """Bytes of one elementwise pass over ``elements`` values: each of
    ``inputs`` tensors read once, each of ``outputs`` written once."""
    return float(itemsize * elements * (inputs + outputs))


class Work:
    """Forward operations and bytes of a step's work, summed over steps:
    the fused encoder's towers (``fwd_flops``, ``fwd_bytes``), a family's
    named parts outside it (``parts[name] = (flops, bytes)``) and the
    products outside both (``other_flops``)."""

    def __init__(self):
        self.fwd_flops = 0.0
        self.fwd_bytes = 0.0
        self.other_flops = 0.0   # products outside the towers (the scores)
        self.parts: Dict[str, Tuple[float, float]] = {}
        self.steps = 0
        self.news = 0            # distinct news encoded, summed over steps
        self.news_tokens = 0     # their real tokens, every view the family encodes
        self.history_clicks = 0  # real history entries through the user tower

    def per_step(self) -> Dict[str, float]:
        """What the inputs gave a step, on average."""
        n = max(self.steps, 1)
        return {"news": self.news / n, "news_tokens": self.news_tokens / n,
                "history_clicks": self.history_clicks / n}

    def add_tower(self, lengths, D, H, Q, calls=1) -> None:
        self.fwd_flops += tower_flops(lengths, D, H, Q)
        self.fwd_bytes += tower_bytes(lengths, D, Q, calls)

    def add_part(self, name: str, flops: float, nbytes: float) -> None:
        f, b = self.parts.get(name, (0.0, 0.0))
        self.parts[name] = (f + float(flops), b + float(nbytes))

    @property
    def bwd_flops(self) -> float:
        return 2 * self.fwd_flops

    @property
    def bwd_bytes(self) -> float:
        return 2 * self.fwd_bytes

    @property
    def step_flops(self) -> float:
        """Forward and backward of the whole model."""
        return 3 * (self.fwd_flops + self.other_flops + sum(f for f, _ in self.parts.values()))


def roofline_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the operations
    over peak FLOP/s and the bytes over peak bandwidth."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def family_work(fam):
    """The family module's ``work``; a module without one stops the run."""
    count = getattr(fam, "work", None)
    if not callable(count):
        raise TypeError(f"{fam.__name__} has no work(work, model, lens, news, browsed, cand): "
                        "a family module counts its own work (h100bench/counting.py)")
    return count


def step_work(work: Work, model: Dict, lens: Dict[str, np.ndarray],
              slices: Iterable[tuple], fam) -> None:
    """Adds one training step to ``work``: for each slice ``(browsed,
    candidates)`` that one device encodes, its distinct news and real
    history clicks, and what family module ``fam`` counts for it. ``lens``
    holds each feature's real token count by news id (``title_len``, and
    ``abst_len`` where the corpus has abstracts) and, where the corpus has a
    news graph, its ``neighbors [N+1, K]`` table."""
    count = family_work(fam)
    for browsed, cand in slices:
        news = np.unique(np.concatenate([browsed.ravel(), cand.ravel()]))
        news = news[news != 0]
        work.news += len(news)
        work.history_clicks += int((browsed != 0).sum())
        count(work, model, lens, news, browsed, cand)
    work.steps += 1
