"""MIND leaderboard submission writer (port of the JAX package's
``train/submit.py``).

Every test impression is scored, its scores turned into 1-based ranks
(rank of a candidate = its position in the descending-score order + 1), and
written as the line ``"<impression_id> [r1,r2,...]"``. The key is the real
impression id captured at preprocessing (``split.impression_keys``), else
``i + 1`` in file order; an impression without a candidate is skipped.
Scoring is the trainer's own (:meth:`Trainer.score_split`: the corpus
encoded once, bucketed ragged batches).

In a ``torch.distributed`` group the ranks score their rows of every batch
and gather the scores (``Trainer.score_split``), and rank 0 alone writes
the file; the JAX package's writer has no such guard (``ROADMAP.md`` §C).
"""

from __future__ import annotations

import pathlib
import time
from typing import Dict, Optional

import numpy as np

from pytorch_news_recommender_tpu_torch.data.dataset import DevData
from pytorch_news_recommender_tpu_torch.parallel import distributed


def scores_to_ranks(scores: np.ndarray) -> np.ndarray:
    """Descending-score 1-based ranks (a stable sort breaks ties by position)."""
    order = np.argsort(-scores, kind="stable")
    ranks = np.empty(len(scores), dtype=np.int32)
    ranks[order] = np.arange(1, len(scores) + 1)
    return ranks


def collect_scores(trainer, state_or_params, split: DevData,
                   max_impressions: Optional[int] = None) -> Dict[int, np.ndarray]:
    """Scores a ragged split -> ``{row index: [c_i] float32 scores}``."""
    return trainer.score_split(state_or_params, split, max_impressions)


def write_submission(trainer, state_or_params, split: Optional[DevData] = None,
                     path: Optional[str | pathlib.Path] = None) -> pathlib.Path:
    """Scores the test split (default ``trainer.dataset.test``) and writes
    the MIND submission file to ``path`` (default
    ``submit_<model>_<time>.txt``), from rank 0 only in a group of ranks,
    which all wait for the write; every rank returns the path."""
    split = split if split is not None else trainer.dataset.test
    if split is None:
        raise ValueError("no test split to submit")
    if path is None:
        ts = time.strftime("%m-%d_%H.%M", time.localtime())
        path = f"submit_{trainer.cfg.model.name}_{ts}.txt"
    path = pathlib.Path(path)
    scores = collect_scores(trainer, state_or_params, split)
    if distributed.process_index() == 0:
        with open(path, "w") as f:
            for i in range(len(split)):
                sc = scores.get(i)
                if sc is None:
                    continue
                key = (int(split.impression_keys[i]) if split.impression_keys is not None
                       else i + 1)
                f.write(f"{key} [{','.join(str(int(r)) for r in scores_to_ranks(sc))}]\n")
    distributed.barrier()
    return path
