"""Columnar in-memory dataset containers.

The reference materializes per-sample Python lists in pickles and rebuilds
``[50, 20]`` word tensors per sample inside ``Dataset.__getitem__``
(``MIND_2020/data_handler.py:185-250``). Here everything is a contiguous
numpy array built once:

* ``NewsFeatures`` — one row per news (row 0 = pad), uploaded to device once;
* ``TrainData``    — ``[n, H]`` histories + ``[n, 1+K]`` candidate groups
  (positive at slot 0, reference ``data_processor.py:519-528``);
* ``DevData``      — ragged candidate lists stored flat + offsets, with 0/1
  labels (reference dev keeps full impression lists,
  ``data_processor.py:530-532``).

Batch assembly is then pure array slicing — no per-sample Python.
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import Dict, Optional

import numpy as np

from pytorch_news_recommender_tpu_torch.config import ArtifactMeta


@dataclasses.dataclass
class NewsFeatures:
    """Device-residable per-news feature tables. Row 0 is the pad news
    (all zeros). Word ids use 0 = pad."""

    title: np.ndarray                   # [N, L_title] int32
    abst: Optional[np.ndarray] = None   # [N, L_abst] int32
    categ: Optional[np.ndarray] = None  # [N] int32
    subcateg: Optional[np.ndarray] = None  # [N] int32
    bert: Optional[np.ndarray] = None   # [N, bert_dim] float32
    entity: Optional[np.ndarray] = None  # [N, E] int32 entity ids per news
    neighbors: Optional[np.ndarray] = None  # [N, K] int32 graph neighbor ids

    @property
    def n_news(self) -> int:
        return self.title.shape[0]

    def as_dict(self) -> Dict[str, np.ndarray]:
        return {k: v for k, v in dataclasses.asdict(self).items() if v is not None}


@dataclasses.dataclass
class TrainData:
    """Fixed-shape negative-sampled training impressions."""

    browsed_ids: np.ndarray     # [n, H] int32, 0-padded (most-recent last)
    candidate_ids: np.ndarray   # [n, 1+K] int32, positive at slot 0
    user_ids: Optional[np.ndarray] = None  # [n] int32 (0 = unknown user)

    def __len__(self) -> int:
        return self.browsed_ids.shape[0]


@dataclasses.dataclass
class DevData:
    """Ragged eval impressions stored flat (CSR-style)."""

    browsed_ids: np.ndarray     # [m, H] int32
    cand_flat: np.ndarray       # [sum_i c_i] int32 news ids
    label_flat: np.ndarray      # [sum_i c_i] int8 click labels
    offsets: np.ndarray         # [m+1] int64 into cand_flat/label_flat
    user_ids: Optional[np.ndarray] = None  # [m] int32 (0 = unknown user)
    impression_keys: Optional[np.ndarray] = None  # [m] original impression ids

    def __len__(self) -> int:
        return self.browsed_ids.shape[0]

    def n_candidates(self, i: int) -> int:
        return int(self.offsets[i + 1] - self.offsets[i])

    @property
    def candidate_counts(self) -> np.ndarray:
        return np.diff(self.offsets).astype(np.int32)

    def impression(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        s, e = self.offsets[i], self.offsets[i + 1]
        return self.cand_flat[s:e], self.label_flat[s:e]


@dataclasses.dataclass
class RecDataset:
    """A fully prepared dataset split bundle."""

    news: NewsFeatures
    train: Optional[TrainData]
    dev: Optional[DevData]
    test: Optional[DevData]  # labels all-zero for test (unknown)
    meta: ArtifactMeta
    # pretrained tables used to initialize model parameters (not per-news
    # features): GloVe word matrix (row 0 = pad, ``data_processor.py:67-97``)
    # and the entity matrix (``tools.py:30-48``)
    word_embeddings: Optional[np.ndarray] = None    # [n_words, D] float32
    entity_embeddings: Optional[np.ndarray] = None  # [n_entities, D] float32
    # String -> 1-based id dictionaries from preprocessing: "word", "news",
    # "category", "subcategory", "user", "entity" (WikiData Q-id). The
    # reference persists these as word_dict.csv / news_words.csv /
    # entity_ids_dict.pkl (``data_processor.py:186-188,221``,
    # ``tools.py:44-48``); without them a NEW news item cannot be tokenized
    # at serving time nor a tokenization diff debugged against reference
    # artifacts.
    dicts: Optional[Dict[str, Dict[str, int]]] = None

    # ---- persistence (npz + json metadata; replaces the reference's
    # convention-keyed pickles, ``data_processor.py:498-503``) ----
    def save(self, path: str | pathlib.Path) -> None:
        path = pathlib.Path(path)
        path.mkdir(parents=True, exist_ok=True)
        def drop_none(d):
            return {k: v for k, v in d.items() if v is not None}

        np.savez_compressed(path / "news.npz", **self.news.as_dict())
        if self.train is not None:
            np.savez_compressed(path / "train.npz",
                                **drop_none(dataclasses.asdict(self.train)))
        for split_name in ("dev", "test"):
            split = getattr(self, split_name)
            if split is not None:
                np.savez_compressed(path / f"{split_name}.npz",
                                    **drop_none(dataclasses.asdict(split)))
        pretrained = {}
        if self.word_embeddings is not None:
            pretrained["word"] = self.word_embeddings
        if self.entity_embeddings is not None:
            pretrained["entity"] = self.entity_embeddings
        if pretrained:
            np.savez_compressed(path / "pretrained.npz", **pretrained)
        if self.dicts is not None:
            import json
            with open(path / "dicts.json", "w", encoding="utf-8") as f:
                json.dump(self.dicts, f, ensure_ascii=False)
        self.meta.save(path / "meta.json")

    @classmethod
    def load(cls, path: str | pathlib.Path) -> "RecDataset":
        path = pathlib.Path(path)
        news_npz = dict(np.load(path / "news.npz"))
        news = NewsFeatures(**news_npz)
        meta = ArtifactMeta.load(path / "meta.json")

        def load_split(name, tp):
            p = path / f"{name}.npz"
            if not p.exists():
                return None
            return tp(**dict(np.load(p)))

        word_emb = entity_emb = None
        pre = path / "pretrained.npz"
        if pre.exists():
            with np.load(pre) as z:
                word_emb = z["word"] if "word" in z.files else None
                entity_emb = z["entity"] if "entity" in z.files else None

        dicts = None
        dj = path / "dicts.json"
        if dj.exists():
            import json
            with open(dj, encoding="utf-8") as f:
                dicts = json.load(f)

        return cls(
            news=news,
            train=load_split("train", TrainData),
            dev=load_split("dev", DevData),
            test=load_split("test", DevData),
            meta=meta,
            word_embeddings=word_emb,
            entity_embeddings=entity_emb,
            dicts=dicts,
        )
