"""The benchmark's inputs handed to the system under test through its public
types: the configuration file as the program's ``Config``, the corpus (its
news graph included, where it has one) and the click log as its
``RecDataset``."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from h100bench import traffic as T


def train_seed(seed: int) -> int:
    """The program's ``train.seed`` for a run's seed: its dropout seeds
    follow from it."""
    return int(seed) % 1_000_000_007


def config(cfg: Dict, seed: int):
    """The program's ``Config`` of configuration file ``cfg``."""
    from pytorch_news_recommender_tpu_torch.config import Config

    d = {k: dict(v) for k, v in cfg["port"].items()}
    d.setdefault("train", {})["seed"] = train_seed(seed)
    return Config.from_dict(d)


def dataset(cfg: Dict, corpus: T.Corpus, log: Optional[T.ClickLog] = None):
    """The program's ``RecDataset`` of the benchmark's corpus and click
    log."""
    from pytorch_news_recommender_tpu_torch.config import ArtifactMeta
    from pytorch_news_recommender_tpu_torch.data.dataset import (
        NewsFeatures, RecDataset, TrainData,
    )

    c = cfg["corpus"]
    news = NewsFeatures(title=corpus.title, abst=corpus.abst, categ=corpus.categ,
                        subcateg=corpus.subcateg, neighbors=corpus.neighbors)
    train = TrainData(log.browsed, log.candidates) if log is not None else None
    meta = ArtifactMeta(n_words=int(c["vocab"]), n_news=corpus.n_news,
                        category_nums=int(c.get("n_categories", 0)),
                        subcategory_nums=int(c.get("n_subcategories", 0)),
                        n_train_samples=len(log.browsed) if log is not None else 0)
    return RecDataset(news=news, train=train, dev=None, test=None, meta=meta)


def feature_lengths(corpus: T.Corpus) -> Dict[str, np.ndarray]:
    """Per-news tables for counting work, by news id: the real token counts
    (``title_len``, ``abst_len``) and, where the corpus has a news graph,
    ``neighbors [N+1, K]``."""
    out = {"title_len": (corpus.title != 0).sum(1)}
    if corpus.abst is not None:
        out["abst_len"] = (corpus.abst != 0).sum(1)
    if corpus.neighbors is not None:
        out["neighbors"] = corpus.neighbors
    return out


def reference_feats(corpus: T.Corpus, device) -> Dict:
    """The corpus tables as tensors for the reference, the news graph
    (``neighbors``) among them where the corpus has one."""
    import torch

    out = {"title": corpus.title}
    for k in ("abst", "categ", "subcateg", "neighbors"):
        if getattr(corpus, k) is not None:
            out[k] = getattr(corpus, k)
    return {k: torch.as_tensor(np.asarray(v, np.int64), device=device) for k, v in out.items()}
