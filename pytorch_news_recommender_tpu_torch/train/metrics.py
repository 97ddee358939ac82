"""Impression-level ranking metrics in pure numpy (the port's copy of the
JAX package's ``train/metrics.py``).

Matches the reference metric definitions (``MIND_2020/evaluation.py:6-27``):
AUC (sklearn ``roc_auc_score`` semantics, i.e. Mann-Whitney U with tie-rank
averaging), MRR, and exponential-gain nDCG@k. The reference computes only AUC
in practice and comments out the rest (``train_eval.py:263-270``) — here all
four are first-class.
"""

from __future__ import annotations

import concurrent.futures
import os
from typing import Dict, Sequence

import numpy as np


def _average_ranks(x: np.ndarray) -> np.ndarray:
    """1-based ranks with ties assigned the average rank (scipy ``rankdata``
    'average' method)."""
    order = np.argsort(x, kind="mergesort")
    sx = x[order]
    # Group boundaries among sorted values
    boundary = np.empty(len(x), dtype=bool)
    boundary[0] = True
    boundary[1:] = sx[1:] != sx[:-1]
    group = np.cumsum(boundary) - 1
    counts = np.bincount(group)
    ends = np.cumsum(counts)
    starts = ends - counts
    avg = (starts + ends + 1) / 2.0  # average of 1-based ranks in the group
    ranks = np.empty(len(x), dtype=np.float64)
    ranks[order] = avg[group]
    return ranks


def auc_score(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """ROC AUC via the rank-sum statistic; requires both classes present."""
    y_true = np.asarray(y_true, dtype=np.float64)
    y_score = np.asarray(y_score, dtype=np.float64)
    n_pos = y_true.sum()
    n_neg = len(y_true) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    ranks = _average_ranks(y_score)
    return float((ranks[y_true > 0].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


def mrr_score(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Mean reciprocal rank over all positives (``evaluation.py:20-24``).

    Score ties rank in stable (mergesort) order — the reference's default
    ``argsort`` leaves tie order unspecified (quicksort), i.e. its MRR/nDCG
    are nondeterministic under ties; here both the scalar and vectorized
    paths pin the same deterministic order."""
    order = np.argsort(y_score, kind="mergesort")[::-1]
    y = np.take(np.asarray(y_true, dtype=np.float64), order)
    rr = y / (np.arange(len(y)) + 1)
    denom = y.sum()
    return float(rr.sum() / denom) if denom > 0 else float("nan")


def dcg_score(y_true: np.ndarray, y_score: np.ndarray, k: int = 10) -> float:
    order = np.argsort(y_score, kind="mergesort")[::-1]  # stable under ties
    y = np.take(np.asarray(y_true, dtype=np.float64), order[:k])
    gains = 2 ** y - 1
    discounts = np.log2(np.arange(len(y)) + 2)
    return float((gains / discounts).sum())


def ndcg_score(y_true: np.ndarray, y_score: np.ndarray, k: int = 10) -> float:
    best = dcg_score(y_true, y_true, k)
    if best == 0:
        return float("nan")
    return dcg_score(y_true, y_score, k) / best


def impression_metrics(y_true: np.ndarray, y_score: np.ndarray) -> Dict[str, float]:
    return {
        "auc": auc_score(y_true, y_score),
        "mrr": mrr_score(y_true, y_score),
        "ndcg@5": ndcg_score(y_true, y_score, 5),
        "ndcg@10": ndcg_score(y_true, y_score, 10),
    }


def _ranks_2d(s: np.ndarray) -> np.ndarray:
    """Row-wise tie-averaged 1-based ranks for a ``[n, W]`` score matrix —
    the vectorized form of :func:`_average_ranks` (bit-equal semantics)."""
    n, W = s.shape
    order = np.argsort(s, axis=1, kind="mergesort")
    sx = np.take_along_axis(s, order, axis=1)
    idx = np.arange(W)
    boundary = np.ones((n, W), dtype=bool)
    boundary[:, 1:] = sx[:, 1:] != sx[:, :-1]
    # 0-based start index of each element's tie group
    start = np.maximum.accumulate(np.where(boundary, idx[None, :], 0), axis=1)
    # exclusive end: the next group boundary to the right (or W)
    next_b = np.concatenate([boundary[:, 1:], np.ones((n, 1), bool)], axis=1)
    cand = np.where(next_b, idx[None, :] + 1, W)
    end = np.minimum.accumulate(cand[:, ::-1], axis=1)[:, ::-1]
    avg = (start + end + 1) / 2.0  # == 1D impl's (starts + ends + 1) / 2
    ranks = np.empty((n, W), np.float64)
    np.put_along_axis(ranks, order, avg, axis=1)
    return ranks


def _group_metrics(y: np.ndarray, s: np.ndarray) -> Dict[str, np.ndarray]:
    """All four metrics for a same-width group: ``y``/``s`` are ``[n, W]``
    (no padding — impressions are grouped by exact candidate count).
    Returns per-impression value arrays with NaN where undefined."""
    y = y.astype(np.float64)
    s = s.astype(np.float64)
    n, W = y.shape
    with np.errstate(invalid="ignore", divide="ignore"):
        # AUC (rank-sum)
        ranks = _ranks_2d(s)
        n_pos = y.sum(axis=1)
        n_neg = W - n_pos
        pos_rank_sum = (ranks * (y > 0)).sum(axis=1)
        auc = (pos_rank_sum - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)
        auc = np.where((n_pos == 0) | (n_neg == 0), np.nan, auc)
        # MRR: replicate argsort(s)[::-1] exactly (tie order matters)
        order_desc = np.argsort(s, axis=1, kind="mergesort")[:, ::-1]
        y_desc = np.take_along_axis(y, order_desc, axis=1)
        rr = (y_desc / (np.arange(W) + 1.0)).sum(axis=1)
        mrr = np.where(n_pos > 0, rr / n_pos, np.nan)
        # nDCG@k: gains over the score ordering vs the ideal ordering
        discounts = 1.0 / np.log2(np.arange(W) + 2.0)
        gains_desc = 2.0 ** y_desc - 1.0
        ideal_desc = 2.0 ** -np.sort(-y, axis=1) - 1.0
        out = {"auc": auc, "mrr": mrr}
        for k in (5, 10):
            kk = min(k, W)
            dcg = (gains_desc[:, :kk] * discounts[:kk]).sum(axis=1)
            best = (ideal_desc[:, :kk] * discounts[:kk]).sum(axis=1)
            out[f"ndcg@{k}"] = np.where(best > 0, dcg / best, np.nan)
    return out


def aggregate_metrics(
    labels: Sequence[np.ndarray],
    scores: Sequence[np.ndarray],
    parallel: bool | None = None,
) -> Dict[str, float]:
    """Mean per-impression metrics, NaN-skipping (impressions without both
    classes contribute nothing, matching sklearn's refusal + the reference's
    per-impression averaging, ``train_eval.py:256-273``).

    Impressions are grouped by candidate count and each group computed as
    one vectorized ``[n, W]`` pass (the eval path already buckets by width,
    so groups are few and large): 32k impressions aggregate in ~0.5 s vs
    ~12 s for the per-impression loop on a 2-vCPU host — at a dense eval
    cadence this was the dominant eval cost, not the model.
    ``tests/test_metrics.py`` pins equivalence against the scalar path,
    ties included. ``parallel`` is accepted for API compatibility (the
    vectorized path needs no pool)."""
    del parallel
    by_len: Dict[int, list] = {}
    for i, (y, s) in enumerate(zip(labels, scores)):
        by_len.setdefault(len(y), []).append(i)
    n_total = len(labels)
    vals = {k: np.full(n_total, np.nan)
            for k in ("auc", "mrr", "ndcg@5", "ndcg@10")}
    for W, idxs in by_len.items():
        if W == 0:
            continue
        y2 = np.stack([np.asarray(labels[i]) for i in idxs])
        s2 = np.stack([np.asarray(scores[i]) for i in idxs])
        g = _group_metrics(y2, s2)
        for k, v in g.items():
            vals[k][idxs] = v
    out: Dict[str, float] = {}
    with np.errstate(invalid="ignore"):
        for k, v in vals.items():
            out[k] = float(np.nanmean(v)) if n_total else float("nan")
    return out


def aggregate_metrics_loop(
    labels: Sequence[np.ndarray],
    scores: Sequence[np.ndarray],
    parallel: bool | None = None,
) -> Dict[str, float]:
    """Per-impression reference implementation (the pre-vectorization path);
    kept for the equivalence test and as the semantics ground truth."""
    if parallel is None:
        parallel = len(labels) > 20_000

    def one(args):
        y, s = args
        return impression_metrics(np.asarray(y), np.asarray(s))

    pairs = list(zip(labels, scores))
    if parallel:
        workers = max(2, (os.cpu_count() or 4) // 2)
        with concurrent.futures.ThreadPoolExecutor(workers) as ex:
            per = list(ex.map(one, pairs, chunksize=1024))
    else:
        per = [one(p) for p in pairs]

    out: Dict[str, float] = {}
    for key in ("auc", "mrr", "ndcg@5", "ndcg@10"):
        vals = np.asarray([p[key] for p in per])
        out[key] = float(np.nanmean(vals)) if len(vals) else float("nan")
    return out


def score_submission_file(
    submission_path,
    labels_by_key: Dict[int, np.ndarray],
) -> Dict[str, float]:
    """Score a MIND leaderboard rank file against ground-truth labels.

    This is the official-scorer role the reference ships commented out
    (``MIND_2020/evaluation.py:29-118``). Lines are
    ``"<impression_id> [r1,r2,...]"``; ranks convert to scores as ``1/rank``.
    ``labels_by_key`` maps impression id -> 0/1 label array in candidate
    order (truncated/padded to the rank-list length like the reference's
    ``rank_score[i][:len(y_true)]``, ``train_eval.py:225``).
    """
    labels, scores = [], []
    with open(submission_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            key_str, rank_str = line.split(" ", 1)
            key = int(key_str)
            if key not in labels_by_key:
                continue
            ranks = np.asarray(
                [int(r) for r in rank_str.strip()[1:-1].split(",")],
                dtype=np.float64)
            y = np.asarray(labels_by_key[key], dtype=np.float64)
            n = min(len(ranks), len(y))
            labels.append(y[:n])
            scores.append(1.0 / ranks[:n])
    return aggregate_metrics(labels, scores)
