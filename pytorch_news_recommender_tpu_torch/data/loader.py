"""Runtime batching: id-only batches, bucketed ragged eval (the port's copy
of the single-process parts of the JAX package's ``data/loader.py``).

* Train batches are numpy slices of the pre-packed ``[n, H]`` / ``[n, S]``
  id arrays; the gathers of title words and embeddings happen on the device
  inside the step.
* :func:`dedup_batch` rewrites a batch so that each distinct news is
  encoded once, optionally split into a short block (truncated titles) and a
  long block (:class:`LengthSplit`).
* Eval impressions are bucketed by candidate count and padded only to the
  bucket width.

* :func:`add_gnn_frontier` attaches a dedup batch's deduplicated
  neighborhood closure (the GNN family encodes each title in it once).

The multi-process feed (``train_batches_sliced``) and the C++ dedup of
``native/`` are not ported yet (``ROADMAP.md``); the numpy dedup below gives
the same arrays as the C++ one.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Sequence

import numpy as np

from pytorch_news_recommender_tpu_torch.data.dataset import DevData, TrainData

Batch = Dict[str, np.ndarray]


# ~12% geometric spacing through the region real batch sizes land in; every
# rung is a multiple of 1024 and compiles (on the JAX side) only when hit.
DEFAULT_UNIQUE_BUCKETS = (1024, 2048, 3072, 4096, 6144, 8192, 9216, 10240,
                          11264, 12288, 14336, 16384, 20480, 24576, 32768)


@dataclasses.dataclass(frozen=True)
class LengthSplit:
    """Host-side spec for length-bucketed unique-news encoding.

    ``feat_lens`` maps a word-level feature name (``title``/``abst``) to the
    per-news true token count (indexed by news id); ``thresholds`` to its
    short-block cutoff. A news is *short* when every thresholded feature fits
    its cutoff; the model then truncates those features to the cutoff for
    the short block (exact: the dropped columns are all pad and the towers
    mask on ``ids != 0``). ``grid`` quantizes the short-block width."""

    feat_lens: Dict[str, np.ndarray]
    thresholds: Dict[str, int]
    grid: int = 512

    def is_short(self, ids: np.ndarray) -> np.ndarray:
        """Boolean mask: every thresholded feature of ``ids`` fits its
        cutoff. The model's ``_feat_trunc`` must match ``thresholds``."""
        short = np.ones(np.shape(ids), bool)
        for k, thr in self.thresholds.items():
            short &= self.feat_lens[k][ids] <= thr
        return short


def _length_partition(unique_ids: np.ndarray, u: int, width: int,
                      split: LengthSplit,
                      short_width: Optional[int] = None):
    """Partition the ``u`` real unique ids inside a ``width``-slot buffer
    into [short block | long block]; returns ``(buf, newpos, short_width)``.

    The short block occupies ``[0, short_width)`` (real shorts first, then
    pad slots); the long block ``[short_width, width)`` holds everything
    full-length. ``newpos`` remaps old unique positions to new positions for
    the inverse indices. Shorts past the short block's capacity spill to the
    long block (exact: they are merely encoded at full length)."""
    uniq = unique_ids[:u]
    short = split.is_short(uniq)
    n_s = int(short.sum())
    n_l = u - n_s
    G = split.grid
    if short_width is None:
        short_width = max(0, (width - n_l) // G * G)
    k_keep = min(n_s, short_width)
    order = np.argsort(~short, kind="stable")  # shorts first, stable
    buf = np.zeros(width, unique_ids.dtype)
    buf[:k_keep] = uniq[order[:k_keep]]
    rest = order[k_keep:]
    buf[short_width:short_width + len(rest)] = uniq[rest]
    newpos = np.empty(u, np.int32)
    newpos[order[:k_keep]] = np.arange(k_keep, dtype=np.int32)
    newpos[rest] = short_width + np.arange(len(rest), dtype=np.int32)
    return buf, newpos, short_width


def _dedup_ids(browsed: np.ndarray, cand: np.ndarray):
    """Shared dedup core: ``(u, unique_buffer, browsed_idx, candidate_idx)``
    with slot 0 always the pad news 0 and inverse indices into the buffer."""
    all_ids = np.concatenate(
        [np.zeros(1, browsed.dtype), browsed.ravel(), cand.ravel()])
    uniq_buf, inv = np.unique(all_ids, return_inverse=True)
    nb = browsed.size
    browsed_idx = inv[1:1 + nb].reshape(browsed.shape).astype(np.int32)
    candidate_idx = inv[1 + nb:].reshape(cand.shape).astype(np.int32)
    return len(uniq_buf), uniq_buf, browsed_idx, candidate_idx


def _pick_unique_bucket(u: int, buckets: Sequence[int]) -> int:
    width = next((b for b in buckets if u <= b), None)
    if width is None:
        width = int(np.ceil(u / buckets[-1])) * buckets[-1]
    return width


def dedup_batch(batch: Batch,
                buckets: Sequence[int] = DEFAULT_UNIQUE_BUCKETS,
                length_split: Optional[LengthSplit] = None) -> Batch:
    """Rewrite a batch in deduplicated form.

    The batch then carries the ``unique_ids`` buffer (slot 0 is always the
    pad news 0; ascending without ``length_split``, otherwise partitioned
    shorts-first, so do not rely on sortedness) plus inverse indices
    ``browsed_idx`` / ``candidate_idx``. The unique count is padded up to a
    bucket width. With a length split, ``short_mark``'s shape carries the
    short-block width. When the bucketed width would not shrink the encoder
    work, the batch is returned in direct form.
    """
    browsed = batch["browsed_ids"]
    cand = batch["candidate_ids"]
    n_slots = browsed.size + cand.size

    u, uniq_buf, browsed_idx, candidate_idx = _dedup_ids(browsed, cand)
    width = _pick_unique_bucket(u, buckets)
    if width >= n_slots:
        return batch  # dedup would not shrink the encoder workload
    short_width = 0
    if length_split is not None and length_split.thresholds:
        unique_ids, newpos, short_width = _length_partition(
            np.asarray(uniq_buf, np.int32), u, width, length_split)
        if short_width > 0:
            browsed_idx = newpos[browsed_idx]
            candidate_idx = newpos[candidate_idx]
    if short_width == 0:
        unique_ids = np.zeros(width, np.int32)
        unique_ids[:min(u, width)] = uniq_buf[:u][:width]
    out = {
        "unique_ids": unique_ids,
        "browsed_idx": browsed_idx,
        "candidate_idx": candidate_idx,
    }
    if short_width > 0:
        # its shape carries the short-block width (values unused)
        out["short_mark"] = np.zeros(short_width, np.int8)
    # non-news keys (user_ids, ...) pass through untouched
    for k, v in batch.items():
        if k not in ("browsed_ids", "candidate_ids"):
            out[k] = v
    return out


def train_batches(
    data: TrainData,
    batch_size: int,
    rng: Optional[np.random.Generator] = None,
    drop_remainder: bool = True,
    dedup: bool = False,
    unique_buckets: Sequence[int] = DEFAULT_UNIQUE_BUCKETS,
    length_split: Optional[LengthSplit] = None,
) -> Iterator[Batch]:
    """Shuffled fixed-shape training batches; with ``drop_remainder`` the
    trailing partial batch is dropped, with ``dedup`` each batch goes
    through :func:`dedup_batch`."""
    n = len(data)
    order = np.arange(n)
    if rng is not None:
        rng.shuffle(order)
    n_full = n - (n % batch_size) if drop_remainder else n
    for s in range(0, n_full, batch_size):
        idx = order[s:s + batch_size]
        batch = {
            "browsed_ids": data.browsed_ids[idx],
            "candidate_ids": data.candidate_ids[idx],
        }
        if data.user_ids is not None:
            batch["user_ids"] = data.user_ids[idx]
        yield (dedup_batch(batch, unique_buckets, length_split)
               if dedup else batch)


# Finer rungs near the top: closures saturate toward the corpus size on dense
# graphs, and a coarse last rung would encode a large pad of dead titles.
GNN_FRONTIER_BUCKETS = (2048, 4096, 8192, 12288, 16384, 24576, 32768,
                        40960, 49152, 53248, 57344, 61440, 65536)


def _frontier_closure(uids: np.ndarray, neighbors: np.ndarray,
                      depth: int) -> np.ndarray:
    """Deduplicated ``depth``-hop neighborhood closure of ``uids`` (sorted
    unique ids; slot 0 is always the pad news 0)."""
    cur = np.unique(uids)
    frontier = cur
    for _ in range(depth):
        cur = np.unique(neighbors[cur])
        frontier = np.union1d(frontier, cur)
    if frontier[0] != 0:
        frontier = np.concatenate([np.zeros(1, frontier.dtype), frontier])
    return frontier


def _frontier_block(uids: np.ndarray, frontier: np.ndarray, width: int,
                    neighbors: np.ndarray):
    """One frontier block of ``width`` slots: ``(frontier_ids [width],
    nbr_pos [width, K], self_pos [len(uids)])``, positions local to the
    block. A neighbor outside the closure maps to position 0, the pad news,
    which the model masks (``frontier_ids[pos] == 0``)."""
    fbuf = np.zeros(width, np.int32)
    fbuf[: len(frontier)] = frontier
    pos_of = np.zeros(neighbors.shape[0], np.int32)
    pos_of[frontier] = np.arange(len(frontier), dtype=np.int32)
    in_closure = np.zeros(neighbors.shape[0], bool)
    in_closure[frontier] = True
    neigh_ids = neighbors[fbuf]                      # [width, K]
    neigh_ids = np.where(in_closure[neigh_ids], neigh_ids, 0)
    neigh_ids[fbuf == 0] = 0                         # the pad news has none
    return fbuf, pos_of[neigh_ids].astype(np.int32), \
        pos_of[uids].astype(np.int32)


def add_gnn_frontier(batch: Batch, neighbors: np.ndarray, depth: int,
                     buckets: Sequence[int] = GNN_FRONTIER_BUCKETS) -> Batch:
    """``batch`` (dedup form) with its deduplicated ``depth``-hop
    neighborhood closure ``S = V ∪ N(V) ∪ ... ∪ N^depth(V)`` attached, so
    that the GNN family encodes each title in ``S`` once and runs its GAT
    layers level by level over position gathers:

    * ``gnn_frontier_ids [F]``: the closure's ids, slot 0 the pad news,
      padded to a width of ``buckets``;
    * ``gnn_nbr_pos [F, K]``: each node's neighbors as positions in that
      buffer (0 for a neighbor outside the closure: only nodes at the
      closure's edge have one, and their values feed no output);
    * ``gnn_self_pos [U]``: each unique slot's position in the buffer.

    A direct-form batch and ``depth <= 0`` leave the batch as it is."""
    if "unique_ids" not in batch or depth <= 0:
        return batch
    uids = np.asarray(batch["unique_ids"])
    frontier = _frontier_closure(uids, neighbors, depth)
    F = _pick_unique_bucket(len(frontier), buckets)
    fbuf, nbr_pos, self_pos = _frontier_block(uids, frontier, F, neighbors)
    return {**batch, "gnn_frontier_ids": fbuf, "gnn_nbr_pos": nbr_pos,
            "gnn_self_pos": self_pos}


@dataclasses.dataclass
class EvalBatch:
    """One padded eval batch plus bookkeeping to scatter scores back."""

    batch: Batch                 # browsed_ids [b, H], candidate_ids [b, C]
    impression_ids: np.ndarray   # [b] row indices into the DevData
    n_candidates: np.ndarray     # [b] true candidate counts (<= C)


def pick_bucket(count: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if count <= b:
            return b
    return buckets[-1]


def eval_batches(
    data: DevData,
    batch_size: int,
    buckets: Sequence[int],
    max_impressions: Optional[int] = None,
) -> Iterator[EvalBatch]:
    """Bucket impressions by candidate count, pad to bucket width, batch.
    Candidate lists longer than the largest bucket are truncated to it."""
    buckets = sorted(buckets)
    m = len(data)
    if max_impressions is not None:
        m = min(m, max_impressions)
    counts = data.candidate_counts[:m]
    barr = np.asarray(buckets)
    bucket_of = barr[np.minimum(np.searchsorted(barr, counts, side="left"),
                                len(barr) - 1)]

    flat = data.cand_flat
    offsets = data.offsets
    for width in buckets:
        rows = np.where(bucket_of == width)[0]
        if rows.size == 0:
            continue
        for s in range(0, rows.size, batch_size):
            idx = rows[s:s + batch_size]
            ncand = np.minimum(counts[idx], width).astype(np.int32)
            # vectorized ragged gather: position grid clipped into the flat
            # CSR array, pads zeroed
            pos = offsets[idx][:, None] + np.arange(width)[None, :]
            valid = np.arange(width)[None, :] < ncand[:, None]
            cand = np.where(
                valid, flat[np.minimum(pos, len(flat) - 1)], 0
            ).astype(np.int32)
            eb = {
                "browsed_ids": data.browsed_ids[idx],
                "candidate_ids": cand,
            }
            if data.user_ids is not None:
                eb["user_ids"] = data.user_ids[idx]
            yield EvalBatch(batch=eb, impression_ids=idx, n_candidates=ncand)


def pad_batch(batch: Batch, to_size: int) -> tuple[Batch, int]:
    """Pad the leading axis to ``to_size`` (repeating row 0); returns the
    padded batch and the original size."""
    b = next(iter(batch.values())).shape[0]
    if b == to_size:
        return batch, b
    pad = to_size - b
    out = {k: np.concatenate([v, np.repeat(v[:1], pad, axis=0)], axis=0)
           for k, v in batch.items()}
    return out, b
