"""MIND dataset preprocessing: raw TSVs -> columnar :class:`RecDataset`
(the port's copy of the JAX package's ``data/mind.py``).

``build_dataset(use_native=True)`` takes the C++ fast path of ``native/``
(tokenizer, train groups, eval splits) where the library builds, and the
pure-Python path otherwise; the two give the same arrays bit for bit.

Replaces the reference's offline pipeline
(``MIND_2020/data_processor.py`` + the index-mapping half of
``data_handler.py``) with ONE deterministic job emitting numpy artifacts
(``RecDataset.save``) instead of convention-keyed pickles. Reference
semantics preserved exactly (they determine AUC parity — SURVEY.md §7):

* **news union** across train/dev/test, deduped by News_ID
  (``data_processor.py:100-139``); news index is 1-based, 0 = pad
  (``data_handler.py:60-66`` ``+1`` mapping);
* **tokenization**: lowercase, DELETE digit characters, ``\\w+`` tokens —
  for BOTH the vocabulary count and the title/abstract id conversion. The
  reference's ``clean_words`` mutates the Title/Abstract dataframe columns
  in place (``data_processor.py:157-158``) BEFORE ``get_title_word_idxs``
  is applied to those same mutated columns (``data_processor.py:218-219``),
  so the id path also sees digit-stripped text ("covid19" tokenizes as
  "covid", which is in-vocab — not dropped). Vocabulary keeps words with
  frequency >= 3 (``data_processor.py:179-183``); pad/truncate
  title -> 20, abstract -> 40;
* **category / subcategory / user dictionaries**: 1-based, 0 = pad/unknown;
* **GloVe matrix**: row 0 zeros, known words from the vectors file, missing
  words ~ N(0, 1) (``data_processor.py:67-97``);
* **entity embeddings**: train+dev ``entity_embedding.vec`` merged, deduped
  by WikiData Q-id, zero row 0 (``tools.py:30-48``); per-news entity-id lists
  parsed from the Title_Entities JSON column, padded to ``entity_nums``;
* **behaviors**: history = LAST ``history_len`` clicks
  (``data_processor.py:510``); train impressions dropna, split pos/neg by the
  trailing label char, negatives shuffled once per impression, each positive
  grouped with the next ``sample_size`` negatives WITHOUT wraparound
  (``data_processor.py:519-528``) then zero-padded; users with history < 5
  dropped from train (``data_handler.py:90-93``); dev/test keep the full
  ragged candidate list (``data_processor.py:530-536``) with 0/1 labels
  (dev) or zeros (test).

Demo/small mode needs no special code path (the reference duplicates a whole
``Demo_News_Processor``) — point the same function at the small split dirs.
"""

from __future__ import annotations

import json
import pathlib
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from pytorch_news_recommender_tpu_torch.config import ArtifactMeta, DataConfig
from pytorch_news_recommender_tpu_torch.data.dataset import (
    DevData,
    NewsFeatures,
    RecDataset,
    TrainData,
)

_TOKEN_RE = re.compile(r"\w+")
_DIGITS_TABLE = str.maketrans("", "", "0123456789")

NEWS_COLS = ("news_id", "category", "subcategory", "title", "abstract",
             "url", "title_entities", "abstract_entities")
BEHAVIOR_COLS = ("impression_id", "user_id", "time", "history", "impressions")


def tokenize(text: str) -> List[str]:
    """Lowercase, delete digit chars, ``\\w+`` tokens
    (``data_processor.py:151-156``).

    Used for BOTH vocabulary counting and word-id conversion: the reference
    overwrites the Title/Abstract columns with ``clean_words`` output
    (``data_processor.py:157-158``) before ``get_title_word_idxs`` runs on
    those same columns (``data_processor.py:218-219``), so its id sequences
    are built from digit-stripped text too.
    """
    return _TOKEN_RE.findall(text.lower().translate(_DIGITS_TABLE))


# Both paths share the same semantics (see ``tokenize``); the aliases keep
# call sites self-documenting about WHICH reference path they mirror.
tokenize_for_vocab = tokenize
tokenize_for_ids = tokenize


def _read_tsv(path: pathlib.Path, cols: Sequence[str]) -> Iterable[Dict[str, str]]:
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            yield {c: (parts[i] if i < len(parts) else "")
                   for i, c in enumerate(cols)}


def _parse_entity_ids(blob: str) -> List[str]:
    """WikidataId list from a Title_Entities JSON column."""
    if not blob:
        return []
    try:
        ents = json.loads(blob)
    except json.JSONDecodeError:
        return []
    return [e.get("WikidataId", "") for e in ents if e.get("WikidataId")]


class NewsTable:
    """Union of news across splits with vocab / category / entity indexing."""

    def __init__(self) -> None:
        self.ids: List[str] = []           # ordered News_IDs (index = id - 1)
        self.index: Dict[str, int] = {}    # News_ID -> 1-based index
        self.category: List[str] = []
        self.subcategory: List[str] = []
        self.title: List[str] = []
        self.abstract: List[str] = []
        self.entities: List[List[str]] = []

    def add_split(self, news_tsv: pathlib.Path) -> None:
        for row in _read_tsv(news_tsv, NEWS_COLS):
            nid = row["news_id"]
            if not nid or nid in self.index:
                continue
            self.index[nid] = len(self.ids) + 1
            self.ids.append(nid)
            self.category.append(row["category"])
            self.subcategory.append(row["subcategory"])
            self.title.append(row["title"])
            self.abstract.append(row["abstract"])
            self.entities.append(_parse_entity_ids(row["title_entities"]))

    def __len__(self) -> int:
        return len(self.ids)


def build_vocab(news: NewsTable, freq_threshold: int) -> Dict[str, int]:
    """Word -> 1-based id for words with frequency >= threshold
    (``data_processor.py:160-183``)."""
    freq: Dict[str, int] = {}
    for text in news.title:
        for w in tokenize_for_vocab(text):
            freq[w] = freq.get(w, 0) + 1
    for text in news.abstract:
        for w in tokenize_for_vocab(text):
            freq[w] = freq.get(w, 0) + 1
    vocab: Dict[str, int] = {}
    for w, c in freq.items():
        if c >= freq_threshold:
            vocab[w] = len(vocab) + 1
    return vocab


def _to_ids(text: str, vocab: Dict[str, int], length: int) -> List[int]:
    ids = [vocab[w] for w in tokenize_for_ids(text) if w in vocab]
    ids = ids[:length]
    return ids + [0] * (length - len(ids))


def ids_matrix(texts: Sequence[str], vocab: Dict[str, int], length: int,
               native_mod=None) -> np.ndarray:
    """``[1 + n, length]`` word-id rows (row 0 = pad) for a text list.

    With ``native_mod`` (the ``native`` module) the C++ ASCII tokenizer
    converts the rows, and the rows it flags (non-ASCII text, where Python's
    unicode ``\\w`` and ``lower`` may differ from the byte rules) are redone
    with :func:`_to_ids`, so the result is the pure-Python loop's bit for
    bit."""
    out = np.zeros((len(texts) + 1, length), np.int32)
    nat = (native_mod.tokenize_ids(list(texts), vocab, length)
           if native_mod is not None else None)
    if nat is not None:
        ids, fallback = nat
        out[1:] = ids
        for i in np.nonzero(fallback)[0]:
            out[i + 1] = _to_ids(texts[i], vocab, length)
    else:
        for i, t in enumerate(texts):
            out[i + 1] = _to_ids(t, vocab, length)
    return out


def _index_dict(values: Iterable[str]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for v in values:
        if v and v not in out:
            out[v] = len(out) + 1
    return out


def load_glove(path: pathlib.Path, vocab: Dict[str, int], dim: int,
               seed: int = 2020) -> np.ndarray:
    """``[n_words, dim]`` matrix: row 0 zeros, GloVe rows for known words,
    ~N(0,1) for missing (``data_processor.py:67-97``)."""
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((len(vocab) + 1, dim)).astype(np.float32)
    emb[0] = 0.0
    found = 0
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip().split(" ")
            if len(parts) != dim + 1:
                continue
            idx = vocab.get(parts[0])
            if idx is not None:
                emb[idx] = np.asarray(parts[1:], dtype=np.float32)
                found += 1
    if found == 0:
        raise ValueError(f"no vocabulary words found in {path}")
    return emb


def load_entity_embeddings(
    vec_paths: Sequence[pathlib.Path],
) -> Tuple[np.ndarray, Dict[str, int]]:
    """Merge ``entity_embedding.vec`` files, dedup by Q-id, prepend zero row
    (``tools.py:30-48``). Returns ``([n_entities, dim], qid -> 1-based id)``."""
    qids: Dict[str, int] = {}
    rows: List[np.ndarray] = []
    dim = None
    for path in vec_paths:
        if not pathlib.Path(path).exists():
            continue
        with open(path, encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip().split("\t")
                if len(parts) < 2:
                    continue
                qid = parts[0]
                if qid in qids:
                    continue
                vec = np.asarray(parts[1:], dtype=np.float32)
                if dim is None:
                    dim = vec.shape[0]
                elif vec.shape[0] != dim:
                    continue
                qids[qid] = len(rows) + 1
                rows.append(vec)
    if not rows:
        return np.zeros((1, 100), np.float32), {}
    mat = np.concatenate([np.zeros((1, dim), np.float32), np.stack(rows)])
    return mat, qids


# ---- behaviors -----------------------------------------------------------

# Deterministic, implementation-independent negative shuffling: negatives are
# ordered by a splitmix64 hash of (seed, raw file row, news index). Unlike the
# reference's ``random.shuffle`` (``data_processor.py:524``) the result is
# independent of processing order / parallel chunking, and the JAX package's
# C++ fast path (``native/mind_native.cpp``) reproduces it bit-exactly.
_SM64_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_SM64_M1 = np.uint64(0xBF58476D1CE4E5B9)
_SM64_M2 = np.uint64(0x94D049BB133111EB)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        z = (x + _SM64_GAMMA).astype(np.uint64)
        z = (z ^ (z >> np.uint64(30))) * _SM64_M1
        z = (z ^ (z >> np.uint64(27))) * _SM64_M2
        return z ^ (z >> np.uint64(31))


def shuffle_negatives(neg: List[int], seed: int, row: int) -> List[int]:
    """Order negatives by ``splitmix64(seed ^ sm64(row) ^ sm64(idx))``."""
    if len(neg) < 2:
        return neg
    arr = np.asarray(neg, np.uint64)
    keys = _splitmix64(np.uint64(seed)
                       ^ _splitmix64(np.uint64(row))
                       ^ _splitmix64(arr))
    return [int(v) for v in np.asarray(neg)[np.argsort(keys, kind="stable")]]


def _split_history(blob: str, news_index: Dict[str, int],
                   history_len: int) -> List[int]:
    """Last ``history_len`` clicks, mapped to indices, unknown news dropped."""
    clicks = [news_index.get(n, 0) for n in blob.split(" ") if n]
    clicks = [c for c in clicks if c]
    return clicks[-history_len:]


def build_train_samples(
    behaviors_tsv: pathlib.Path,
    news_index: Dict[str, int],
    user_index: Dict[str, int],
    cfg: DataConfig,
    seed: int = 2020,
) -> TrainData:
    """Negative-sampled 1+K training groups (``data_processor.py:519-528``),
    history<min filter (``data_handler.py:90-93``)."""
    H, K = cfg.history_len, cfg.sample_size
    browsed_rows, cand_rows, user_rows = [], [], []
    for row_no, row in enumerate(_read_tsv(behaviors_tsv, BEHAVIOR_COLS)):
        if not row["history"] or not row["impressions"]:
            continue  # reference train dropna (data_processor.py:484-485)
        hist = _split_history(row["history"], news_index, H)
        if len(hist) < cfg.min_history:
            continue
        uid = user_index.get(row["user_id"], 0)
        pos, neg = [], []
        for tok in row["impressions"].split(" "):
            if not tok or "-" not in tok:
                continue
            nid, label = tok.rsplit("-", 1)
            idx = news_index.get(nid, 0)
            if not idx:
                continue
            (pos if label == "1" else neg).append(idx)
        if not pos:
            continue
        neg = shuffle_negatives(neg, seed, row_no)
        browsed = np.zeros(H, np.int32)
        browsed[H - len(hist):] = hist          # most-recent last, left-pad
        for i, p in enumerate(pos):
            group = [p] + neg[i * K:(i + 1) * K]
            cand = np.zeros(1 + K, np.int32)
            cand[:len(group)] = group
            browsed_rows.append(browsed)
            cand_rows.append(cand)
            user_rows.append(uid)
    if not browsed_rows:
        raise ValueError(f"no training samples built from {behaviors_tsv}")
    return TrainData(
        browsed_ids=np.stack(browsed_rows),
        candidate_ids=np.stack(cand_rows),
        user_ids=np.asarray(user_rows, np.int32),
    )


def build_eval_split(
    behaviors_tsv: pathlib.Path,
    news_index: Dict[str, int],
    user_index: Dict[str, int],
    cfg: DataConfig,
    with_labels: bool,
) -> DevData:
    """Ragged CSR eval impressions; labels parsed from the trailing char
    (dev, ``data_processor.py:530-532``) or zeros (test, ``:534-536``)."""
    H = cfg.history_len
    browsed_rows, user_rows, keys = [], [], []
    cand_chunks, label_chunks, offsets = [], [], [0]
    for row in _read_tsv(behaviors_tsv, BEHAVIOR_COLS):
        hist = _split_history(row["history"] or "", news_index, H)
        browsed = np.zeros(H, np.int32)
        if hist:
            browsed[H - len(hist):] = hist
        cands, labels = [], []
        for tok in (row["impressions"] or "").split(" "):
            if not tok:
                continue
            if with_labels and "-" in tok:
                nid, label = tok.rsplit("-", 1)
                labels.append(1 if label == "1" else 0)
            else:
                nid = tok
                labels.append(0)
            cands.append(news_index.get(nid, 0))
        if not cands:
            continue
        browsed_rows.append(browsed)
        user_rows.append(user_index.get(row["user_id"], 0))
        keys.append(int(row["impression_id"]) if
                    row["impression_id"].isdigit() else len(keys) + 1)
        cand_chunks.append(np.asarray(cands, np.int32))
        label_chunks.append(np.asarray(labels, np.int8))
        offsets.append(offsets[-1] + len(cands))
    return DevData(
        browsed_ids=np.stack(browsed_rows),
        cand_flat=np.concatenate(cand_chunks),
        label_flat=np.concatenate(label_chunks),
        offsets=np.asarray(offsets, np.int64),
        user_ids=np.asarray(user_rows, np.int32),
        impression_keys=np.asarray(keys, np.int64),
    )


def collect_users(behavior_paths: Sequence[pathlib.Path]) -> Dict[str, int]:
    users: Dict[str, int] = {}
    for p in behavior_paths:
        if not pathlib.Path(p).exists():
            continue
        for row in _read_tsv(p, BEHAVIOR_COLS):
            u = row["user_id"]
            if u and u not in users:
                users[u] = len(users) + 1
    return users


# ---- top-level job -------------------------------------------------------

def build_dataset(
    cfg: DataConfig,
    train_dir: str | pathlib.Path,
    dev_dir: str | pathlib.Path,
    test_dir: Optional[str | pathlib.Path] = None,
    glove_path: Optional[str | pathlib.Path] = None,
    word_embed_size: int = 300,
    bert_npz: Optional[str | pathlib.Path] = None,
    news_graph_neighbors: int = 0,
    seed: int = 2020,
    out_dir: Optional[str | pathlib.Path] = None,
    use_native: bool = True,
) -> RecDataset:
    """One deterministic preprocessing job: MIND split dirs -> RecDataset.

    Each split dir holds ``news.tsv`` + ``behaviors.tsv`` (+ optional
    ``entity_embedding.vec``). ``bert_npz`` optionally supplies precomputed
    per-news sentence vectors keyed by News_ID order (the reference generates
    these with a bert-as-service server, ``data_processor.py:45-65``).
    ``use_native`` takes the C++ fast path (``native/``) where its library
    builds; both paths give the same arrays.
    """
    train_dir = pathlib.Path(train_dir)
    dev_dir = pathlib.Path(dev_dir)
    dirs = [train_dir, dev_dir] + ([pathlib.Path(test_dir)] if test_dir else [])

    news = NewsTable()
    for d in dirs:
        news.add_split(d / "news.tsv")

    vocab = build_vocab(news, cfg.word_freq_threshold)
    cat_dict = _index_dict(news.category)
    subcat_dict = _index_dict(news.subcategory)

    native_mod = None
    if use_native:
        from pytorch_news_recommender_tpu_torch import native as native_mod_
        if native_mod_.available():
            native_mod = native_mod_

    N = len(news) + 1
    L_t, L_a = cfg.n_words_title, cfg.n_words_abst
    title = ids_matrix(news.title, vocab, L_t, native_mod)
    abst = ids_matrix(news.abstract, vocab, L_a, native_mod)
    categ = np.zeros(N, np.int32)
    subcateg = np.zeros(N, np.int32)
    for i in range(1, N):
        categ[i] = cat_dict.get(news.category[i - 1], 0)
        subcateg[i] = subcat_dict.get(news.subcategory[i - 1], 0)

    # entities
    entity_mat, qid_dict = load_entity_embeddings(
        [d / "entity_embedding.vec" for d in dirs])
    entity = None
    if qid_dict:
        E = cfg.entity_nums
        entity = np.zeros((N, E), np.int32)
        for i in range(1, N):
            eids = [qid_dict.get(q, 0) for q in news.entities[i - 1]]
            eids = [e for e in eids if e][:E]
            entity[i, :len(eids)] = eids

    bert = None
    if bert_npz is not None:
        with np.load(bert_npz) as z:
            bert = z[z.files[0]].astype(np.float32)
        assert bert.shape[0] == N, (bert.shape, N)

    neighbors = None
    if news_graph_neighbors:
        neighbors = build_coclick_graph(
            train_dir / "behaviors.tsv", news.index, N, news_graph_neighbors)

    word_emb = None
    if glove_path is not None:
        word_emb = load_glove(pathlib.Path(glove_path), vocab,
                              word_embed_size, seed)

    user_index = collect_users([d / "behaviors.tsv" for d in dirs])

    def _train(path):
        if native_mod is not None:
            browsed, cand, user = native_mod.build_train_samples(
                path, news.index, user_index, cfg.history_len, cfg.sample_size,
                cfg.min_history, seed)
            if len(user) == 0:
                raise ValueError(f"no training samples built from {path}")
            return TrainData(browsed_ids=browsed, candidate_ids=cand, user_ids=user)
        return build_train_samples(path, news.index, user_index, cfg, seed)

    def _eval(path, with_labels):
        if native_mod is not None:
            browsed, user, keys, offsets, cand_flat, label_flat = \
                native_mod.build_eval_split(path, news.index, user_index,
                                            cfg.history_len, with_labels)
            return DevData(browsed_ids=browsed, cand_flat=cand_flat,
                           label_flat=label_flat, offsets=offsets, user_ids=user,
                           impression_keys=keys)
        return build_eval_split(path, news.index, user_index, cfg,
                                with_labels=with_labels)

    train = _train(train_dir / "behaviors.tsv")
    dev = _eval(dev_dir / "behaviors.tsv", True)
    test = None
    if test_dir is not None:
        test = _eval(pathlib.Path(test_dir) / "behaviors.tsv", False)

    meta = ArtifactMeta(
        n_words=len(vocab) + 1,
        n_news=N,
        category_nums=len(cat_dict) + 1,
        subcategory_nums=len(subcat_dict) + 1,
        entity_nums=(entity_mat.shape[0] if qid_dict else 0),
        n_users=len(user_index) + 1,
        n_train_samples=len(train),
        n_dev_impressions=len(dev),
        n_test_impressions=len(test) if test is not None else 0,
    )
    ds = RecDataset(
        news=NewsFeatures(title=title, abst=abst, categ=categ,
                          subcateg=subcateg, bert=bert, entity=entity,
                          neighbors=neighbors),
        train=train, dev=dev, test=test, meta=meta,
        word_embeddings=word_emb,
        entity_embeddings=entity_mat if qid_dict else None,
        # the id dictionaries the reference persists as word_dict.csv /
        # news_words.csv / entity_ids_dict.pkl — required to tokenize NEW
        # news at serving time (Recommender.add_news)
        dicts={"word": vocab, "news": news.index, "category": cat_dict,
               "subcategory": subcat_dict, "user": user_index,
               "entity": qid_dict},
    )
    if out_dir is not None:
        ds.save(out_dir)
    return ds


def coclick_graph_from_histories(
    histories,
    n_news: int,
    k: int,
    max_pairs_per_user: int = 50,
) -> np.ndarray:
    """``[N, k]`` top co-clicked neighbors per news from an iterable of
    per-user click-id sequences — the offline news-news graph for the GNN
    family (no reference equivalent; BASELINE.json config 5). Shared by the
    MIND TSV path and the Adressa event-log path."""
    from collections import Counter, defaultdict

    co: Dict[int, Counter] = defaultdict(Counter)
    for hist in histories:
        hist = [h for h in hist if h][-max_pairs_per_user:]
        for i, a in enumerate(hist):
            for b in hist[i + 1:]:
                if a != b:
                    co[a][b] += 1
                    co[b][a] += 1
    out = np.zeros((n_news, k), np.int32)
    for nid, counter in co.items():
        top = [b for b, _ in counter.most_common(k)]
        out[nid, :len(top)] = top
    return out


def build_coclick_graph(
    behaviors_tsv: pathlib.Path,
    news_index: Dict[str, int],
    n_news: int,
    k: int,
    max_pairs_per_user: int = 50,
) -> np.ndarray:
    """MIND TSV wrapper over :func:`coclick_graph_from_histories`."""
    def gen():
        for row in _read_tsv(behaviors_tsv, BEHAVIOR_COLS):
            yield [news_index.get(n, 0)
                   for n in (row["history"] or "").split(" ")]

    return coclick_graph_from_histories(gen(), n_news, k, max_pairs_per_user)
