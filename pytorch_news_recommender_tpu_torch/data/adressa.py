"""Adressa dataset preprocessing: event-log JSONL -> :class:`RecDataset`
(the port's copy of the JAX package's ``data/adressa.py``).

The reference names Adressa as a supported dataset (``README.md:3``) but
ships NO code for it (SURVEY.md §0) — this implements the standard protocol
used by the news-rec literature for Adressa (one-week event logs):

* each line is a JSON click event; field names follow the Adressa one-week
  dump (``uid``, ``id``, ``title``, ``category1``, ``time``) and are
  configurable;
* ``category1`` strings like ``"nyheter|trondheim"`` split into
  category / subcategory;
* events are grouped per user and sorted by time; the stream is split
  CHRONOLOGICALLY (default: first 90% of the time range = train);
* each click becomes a sample: history = the user's previous clicks (last
  ``history_len``), candidates = the clicked news + K sampled negatives
  (uniform over the news corpus, deterministic splitmix64 stream — Adressa
  has no impression lists, so negatives must be sampled; this is the
  standard protocol);
* dev impressions get ``dev_negatives`` sampled negatives with 0/1 labels.

Vocabulary / title tokenization reuse the MIND pipeline's functions
(``data/mind.py``) so models are identical across datasets.
"""

from __future__ import annotations

import json
import pathlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from pytorch_news_recommender_tpu_torch.config import ArtifactMeta, DataConfig
from pytorch_news_recommender_tpu_torch.data.dataset import (
    DevData,
    NewsFeatures,
    RecDataset,
    TrainData,
)
from pytorch_news_recommender_tpu_torch.data import mind as M


DEFAULT_FIELDS = {
    "user": "uid",
    "news": "id",
    "title": "title",
    "category": "category1",
    "time": "time",
}


def read_events(
    paths: Sequence[str | pathlib.Path],
    fields: Dict[str, str] = DEFAULT_FIELDS,
) -> List[Tuple[int, str, str, str, str]]:
    """Parse event JSONL files -> [(time, user, news, title, category)]."""
    out = []
    for path in paths:
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except json.JSONDecodeError:
                    continue
                nid = ev.get(fields["news"])
                uid = ev.get(fields["user"])
                if not nid or not uid:
                    continue
                out.append((
                    int(ev.get(fields["time"], 0)),
                    str(uid), str(nid),
                    str(ev.get(fields["title"], "") or ""),
                    str(ev.get(fields["category"], "") or ""),
                ))
    out.sort(key=lambda t: t[0])
    return out


def _neg_stream(seed: int, row: int, k: int, n_news: int,
                exclude: int) -> List[int]:
    """k deterministic uniform negatives over [1, n_news), skipping the
    positive (splitmix64 counter stream — same primitive as the MIND
    hash-shuffle)."""
    out: List[int] = []
    i = 0
    while len(out) < k:
        h = M._splitmix64(np.uint64(seed)
                          ^ M._splitmix64(np.uint64(row))
                          ^ M._splitmix64(np.uint64(0xA5A5_0000 + i)))
        cand = int(h % np.uint64(n_news - 1)) + 1
        i += 1
        if cand != exclude:
            out.append(cand)
    return out


def build_dataset(
    cfg: DataConfig,
    event_paths: Sequence[str | pathlib.Path],
    fields: Dict[str, str] = DEFAULT_FIELDS,
    train_fraction: float = 0.9,
    dev_negatives: int = 20,
    seed: int = 2020,
    out_dir: Optional[str | pathlib.Path] = None,
    news_graph_neighbors: int = 0,
) -> RecDataset:
    """Event logs -> RecDataset with MIND-compatible batch geometry.

    ``news_graph_neighbors > 0`` additionally builds the ``[N, k]`` co-click
    news-news graph for the GNN family from TRAIN-period clicks only (the
    chronological dev tail never leaks into the graph)."""
    events = read_events(event_paths, fields)
    if not events:
        raise ValueError(f"no events parsed from {list(event_paths)}")

    # --- news table (first-seen order; index 1-based, 0 = pad) ---
    news = M.NewsTable()
    for _, _, nid, title, cat in events:
        if nid in news.index:
            continue
        news.index[nid] = len(news.ids) + 1
        news.ids.append(nid)
        parts = cat.split("|")
        news.category.append(parts[0] if parts else "")
        news.subcategory.append(parts[1] if len(parts) > 1 else "")
        news.title.append(title)
        news.abstract.append("")
        news.entities.append([])

    vocab = M.build_vocab(news, cfg.word_freq_threshold)
    cat_dict = M._index_dict(news.category)
    subcat_dict = M._index_dict(news.subcategory)
    N = len(news) + 1
    L_t, L_a = cfg.n_words_title, cfg.n_words_abst
    title = np.zeros((N, L_t), np.int32)
    abst = np.zeros((N, L_a), np.int32)
    categ = np.zeros(N, np.int32)
    subcateg = np.zeros(N, np.int32)
    for i in range(1, N):
        title[i] = M._to_ids(news.title[i - 1], vocab, L_t)
        categ[i] = cat_dict.get(news.category[i - 1], 0)
        subcateg[i] = subcat_dict.get(news.subcategory[i - 1], 0)

    user_index: Dict[str, int] = {}
    for _, uid, *_ in events:
        if uid not in user_index:
            user_index[uid] = len(user_index) + 1

    # --- chronological split ---
    t0, t1 = events[0][0], events[-1][0]
    cut = t0 + (t1 - t0) * train_fraction

    H, K = cfg.history_len, cfg.sample_size
    histories: Dict[str, List[int]] = {}
    train_clicks: Dict[str, List[int]] = {}
    tr_browsed, tr_cand, tr_users = [], [], []
    dev_browsed, dev_users = [], []
    dev_cand_chunks, dev_label_chunks, dev_offsets = [], [], [0]

    for row_no, (t, uid, nid, _, _) in enumerate(events):
        idx = news.index[nid]
        hist = histories.setdefault(uid, [])
        if len(hist) >= cfg.min_history:
            browsed = np.zeros(H, np.int32)
            h = hist[-H:]
            browsed[H - len(h):] = h
            if t <= cut:
                negs = _neg_stream(seed, row_no, K, N, idx)
                tr_browsed.append(browsed)
                tr_cand.append(np.asarray([idx] + negs, np.int32))
                tr_users.append(user_index[uid])
            else:
                negs = _neg_stream(seed, row_no, dev_negatives, N, idx)
                cands = np.asarray([idx] + negs, np.int32)
                labels = np.zeros(1 + dev_negatives, np.int8)
                labels[0] = 1
                dev_browsed.append(browsed)
                dev_users.append(user_index[uid])
                dev_cand_chunks.append(cands)
                dev_label_chunks.append(labels)
                dev_offsets.append(dev_offsets[-1] + len(cands))
        hist.append(idx)
        if t <= cut:
            train_clicks.setdefault(uid, []).append(idx)

    if not tr_browsed:
        raise ValueError("no train samples (check min_history / split)")

    train = TrainData(
        browsed_ids=np.stack(tr_browsed),
        candidate_ids=np.stack(tr_cand),
        user_ids=np.asarray(tr_users, np.int32),
    )
    dev = None
    if dev_browsed:
        dev = DevData(
            browsed_ids=np.stack(dev_browsed),
            cand_flat=np.concatenate(dev_cand_chunks),
            label_flat=np.concatenate(dev_label_chunks),
            offsets=np.asarray(dev_offsets, np.int64),
            user_ids=np.asarray(dev_users, np.int32),
        )

    meta = ArtifactMeta(
        n_words=len(vocab) + 1,
        n_news=N,
        category_nums=len(cat_dict) + 1,
        subcategory_nums=len(subcat_dict) + 1,
        n_users=len(user_index) + 1,
        n_train_samples=len(train),
        n_dev_impressions=len(dev) if dev is not None else 0,
    )
    neighbors = None
    if news_graph_neighbors:
        neighbors = M.coclick_graph_from_histories(
            train_clicks.values(), N, news_graph_neighbors)
    ds = RecDataset(
        news=NewsFeatures(title=title, abst=abst, categ=categ,
                          subcateg=subcateg, neighbors=neighbors),
        train=train, dev=dev, test=None, meta=meta,
        dicts={"word": vocab, "news": news.index, "category": cat_dict,
               "subcategory": subcat_dict, "user": user_index},
    )
    if out_dir is not None:
        ds.save(out_dir)
    return ds
