"""What the inputs need: operations and bytes of the encoder towers, and the
chip's peaks.

The work counted is what a batch's inputs need, not what the program
launched: each distinct news of a step once, at its real token count; the
user tower over each impression's real history; the backward at twice the
forward's operations. Padding, recomputation, the bf16 high/low passes of
the weight gradients and the launched tile shapes are not counted, so a
change to the program's padding or tiling cannot change what is counted.

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

from typing import Dict, Iterable

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


class Work:
    """Forward operations and bytes of the encoder towers, summed over
    steps; ``fwd_flops`` also feeds the whole step's count."""

    def __init__(self):
        self.fwd_flops = 0.0
        self.fwd_bytes = 0.0
        self.other_flops = 0.0   # products outside the towers (the scores)
        self.steps = 0
        self.news = 0            # distinct news encoded, summed over steps
        self.news_tokens = 0     # their real tokens (title, and abstract for NAML)
        self.history_clicks = 0  # real history entries through the user tower

    def per_step(self) -> Dict[str, float]:
        """What the inputs gave a step, on average."""
        n = max(self.steps, 1)
        return {"news": self.news / n, "news_tokens": self.news_tokens / n,
                "history_clicks": self.history_clicks / n}

    def add_tower(self, lengths, D, H, Q, calls=1) -> None:
        self.fwd_flops += tower_flops(lengths, D, H, Q)
        self.fwd_bytes += tower_bytes(lengths, D, Q, calls)

    @property
    def bwd_flops(self) -> float:
        return 2 * self.fwd_flops

    @property
    def bwd_bytes(self) -> float:
        return 2 * self.fwd_bytes

    @property
    def step_flops(self) -> float:
        """Forward and backward of the whole model."""
        return 3 * (self.fwd_flops + self.other_flops)


def roofline_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the operations
    over peak FLOP/s and the bytes over peak bandwidth."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def step_work(work: Work, model: Dict, feats: Dict[str, np.ndarray],
              slices: Iterable[tuple], family: str) -> None:
    """Adds one training step to ``work``: for each slice ``(browsed,
    candidates)`` that one device encodes, its distinct news at their real
    lengths through the news tower(s), the user tower over each impression's
    real history, and the scores. ``feats`` holds ``title_len`` (and, for
    NAML, ``abst_len``) by news id."""
    D, H, Q = model["word_embed_size"], model["num_attention_heads"], model["query_vector_dim"]
    for browsed, cand in slices:
        ids = np.unique(np.concatenate([browsed.ravel(), cand.ravel()]))
        ids = ids[ids != 0]
        work.news += len(ids)
        work.add_tower(feats["title_len"][ids], D, H, Q)
        work.news_tokens += int(feats["title_len"][ids].sum())
        if family == "naml":
            work.add_tower(feats["abst_len"][ids], D, H, Q)
            work.news_tokens += int(feats["abst_len"][ids].sum())
            UD, UQ = 2 * D + 2 * model["cate_embed_size"], model["query_vector_dim_large"]
        else:
            UD, UQ = D, Q
        work.add_tower((browsed != 0).sum(1), UD, model["user_heads_num"], UQ)
        work.history_clicks += int((browsed != 0).sum())
        work.other_flops += 2.0 * cand.size * UD
    work.steps += 1
