"""Which news a training step encodes in which call: a frozen copy of the
program's batch layout, worked out again from the raw impressions.

A batch of ``B`` impressions (``browsed [B, H]``, ``candidates [B, S]``) is
encoded once per distinct news: the ids sorted (slot 0 the pad news),
padded to a bucket width, and, where a length split is set, partitioned
into a short block (news whose title fits the cutoff, encoded truncated) and
a long block, the short block's width a multiple of 512. Where the bucket
would not shrink the work, every slot is encoded as it stands. The dropout
mask a news gets depends on its call and its row in it, so the reference
must encode the same calls.

In a data-parallel step each rank lays out its own slice at a bucket width
and a short width that all ranks agree on (the largest distinct count, the
smallest short width).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

BUCKETS = (1024, 2048, 3072, 4096, 6144, 8192, 9216, 10240,
           11264, 12288, 14336, 16384, 20480, 24576, 32768)
GRID = 512


@dataclasses.dataclass
class Call:
    """One news-tower call: ``ids [M]`` (or ``[B, S]`` flattened in the
    direct form) at the word-feature truncation ``trunc`` (None: full)."""

    ids: np.ndarray
    trunc: Optional[int]


@dataclasses.dataclass
class Layout:
    """The calls of one slice, in order, and each slot's row in their
    joined output: ``browsed_pos [B, H]``, ``cand_pos [B, S]``."""

    calls: List[Call]
    browsed_pos: np.ndarray
    cand_pos: np.ndarray


def _dedup(browsed: np.ndarray, cand: np.ndarray):
    allids = np.concatenate([np.zeros(1, browsed.dtype), browsed.ravel(), cand.ravel()])
    uniq, inv = np.unique(allids, return_inverse=True)
    nb = browsed.size
    return (len(uniq), uniq, inv[1:1 + nb].reshape(browsed.shape).astype(np.int64),
            inv[1 + nb:].reshape(cand.shape).astype(np.int64))


def bucket(u: int, buckets: Sequence[int] = BUCKETS) -> int:
    w = next((b for b in buckets if u <= b), None)
    return w if w is not None else int(np.ceil(u / buckets[-1])) * buckets[-1]


def _partition(uniq, u, width, short_mask, short_width=None):
    n_s = int(short_mask.sum())
    if short_width is None:
        short_width = max(0, (width - (u - n_s)) // GRID * GRID)
    k_keep = min(n_s, short_width)
    order = np.argsort(~short_mask, kind="stable")
    buf = np.zeros(width, np.int64)
    buf[:k_keep] = uniq[order[:k_keep]]
    rest = order[k_keep:]
    buf[short_width:short_width + len(rest)] = uniq[rest]
    newpos = np.empty(u, np.int64)
    newpos[order[:k_keep]] = np.arange(k_keep)
    newpos[rest] = short_width + np.arange(len(rest))
    return buf, newpos, short_width


def _calls(buf: np.ndarray, ws: int, trunc: Optional[int]) -> List[Call]:
    if ws >= len(buf):
        return [Call(buf, trunc)]
    if ws > 0:
        return [Call(buf[:ws], trunc), Call(buf[ws:], None)]
    return [Call(buf, None)]


def _direct(browsed, cand) -> Layout:
    B, H = browsed.shape
    S = cand.shape[1]
    ids = np.concatenate([browsed, cand], axis=1)
    pos = np.arange(B * (H + S)).reshape(B, H + S)
    return Layout([Call(ids.reshape(-1).astype(np.int64), None)], pos[:, :H], pos[:, H:])


def single(browsed: np.ndarray, cand: np.ndarray, title_len: np.ndarray,
           trunc: Optional[int]) -> Layout:
    """The layout of a one-process step."""
    u, uniq, b_idx, c_idx = _dedup(browsed, cand)
    width = bucket(u)
    if width >= browsed.size + cand.size:
        return _direct(browsed, cand)
    ws = 0
    if trunc:
        buf, newpos, ws = _partition(uniq, u, width, title_len[uniq] <= trunc)
        if ws > 0:
            b_idx, c_idx = newpos[b_idx], newpos[c_idx]
    if ws == 0:
        buf = np.zeros(width, np.int64)
        buf[:min(u, width)] = uniq[:width]
    return Layout(_calls(buf, ws, trunc), b_idx, c_idx)


def sliced(browsed: np.ndarray, cand: np.ndarray, title_len: np.ndarray,
           trunc: Optional[int], ranks: int) -> List[Layout]:
    """Every rank's layout of one global batch, ranks in order."""
    per = browsed.shape[0] // ranks
    parts = [(browsed[r * per:(r + 1) * per], cand[r * per:(r + 1) * per]) for r in range(ranks)]
    deds = [_dedup(b, c) for b, c in parts]
    width = bucket(max(d[0] for d in deds))
    if width >= parts[0][0].size + parts[0][1].size:
        return [_direct(b, c) for b, c in parts]
    ws = 0
    if trunc:
        nat = [max(0, (width - int(u - (title_len[uq[:u]] <= trunc).sum())) // GRID * GRID)
               for u, uq, _, _ in deds]
        ws = max(min(min(nat), width - GRID), 0)
    out = []
    for u, uniq, b_idx, c_idx in deds:
        if ws > 0:
            buf, newpos, _ = _partition(uniq, u, width, title_len[uniq] <= trunc, ws)
            b_idx, c_idx = newpos[b_idx], newpos[c_idx]
        else:
            buf = np.zeros(width, np.int64)
            buf[:min(u, width)] = uniq[:width]
        out.append(Layout(_calls(buf, ws, trunc), b_idx, c_idx))
    return out
