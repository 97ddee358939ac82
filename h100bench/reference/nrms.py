"""NRMS in plain float32 (Wu et al., EMNLP 2019): the title's words through
multi-head self-attention, dropout on the projected attention output, and
additive pooling; the user tower the same over the clicked news' vectors
(no dropout); the score a dot product."""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch

from h100bench import counting
from h100bench.reference import common as C

FEATS = ("title",)


def leaves(model: Dict, corpus: Dict):
    """``(name, shape, law)`` of every weight, in the program's state-dict
    names. Laws: ``normal`` (std 1), ``normal_pad0`` (std 1, row 0 zero),
    ``("std", s)``."""
    D, Q = model["word_embed_size"], model["query_vector_dim"]
    out = [("news_encoder.word_embedding.embedding", (corpus["vocab"], D), "normal_pad0")]
    for tw in ("news_encoder.tower.", "user_encoder.tower."):
        out += tower_leaves(tw, D, Q)
    return out


def tower_leaves(prefix: str, D: int, Q: int):
    """The seven weights of one attention-and-pooling tower at the scales
    of its initializers (Xavier-uniform matrices, aq uniform on +-0.1), the
    biases at 0.01, a trained bias's scale, so that they are exercised."""
    x = lambda a, b: ("std", (2.0 / (a + b)) ** 0.5)  # noqa: E731
    return [(prefix + "wqkv", (D, 3 * D), x(D, 3 * D)), (prefix + "bqkv", (3 * D,), ("std", 0.01)),
            (prefix + "wo", (D, D), x(D, D)), (prefix + "bo", (D,), ("std", 0.01)),
            (prefix + "aw", (D, Q), x(D, Q)), (prefix + "ab", (Q,), ("std", 0.01)),
            (prefix + "aq", (Q,), ("std", 0.1 / 3 ** 0.5))]


def encode(p: C.Precision, W: Dict[str, torch.Tensor], model: Dict,
           feats: Dict[str, torch.Tensor], seeds: Optional[Iterator[int]] = None,
           rate: float = 0.0) -> torch.Tensor:
    """``{title: [M, L]}`` -> ``[M, D]``; with ``seeds``, the step's seed
    stream, the encoder's hashed dropout of this call at ``rate``, from the
    one seed the call draws (whatever the rate)."""
    ids = feats["title"]
    M, L = ids.shape
    D = model["word_embed_size"]
    seed = next(seeds) if seeds is not None else None
    x = C.lookup(W["news_encoder.word_embedding.embedding"], ids)
    keep = (C.hash_keep_scale(seed, M, L, D, rate, ids.device)
            if seed is not None and rate > 0 else None)
    return C.tower(p, W, "news_encoder.tower.", x, ids != 0,
                   model["num_attention_heads"], keep)


def user(p: C.Precision, W: Dict[str, torch.Tensor], model: Dict,
         vecs: torch.Tensor, mask: torch.Tensor, for_top_k: bool = False) -> torch.Tensor:
    """``[B, H, D]`` clicked-news vectors and their mask -> ``[B, D]``."""
    return C.tower(p, W, "user_encoder.tower.", vecs, mask, model["user_heads_num"])


def work(work: counting.Work, model: Dict, lens: Dict[str, np.ndarray], news: np.ndarray,
         browsed: np.ndarray, cand: np.ndarray) -> None:
    """One slice's work (``counting.py``): the title tower over its distinct
    ``news`` at their real lengths and the user tower over each impression's
    real history, both in the fused encoder; the scores."""
    D, H, Q = model["word_embed_size"], model["num_attention_heads"], model["query_vector_dim"]
    work.add_tower(lens["title_len"][news], D, H, Q)
    work.news_tokens += int(lens["title_len"][news].sum())
    work.add_tower((browsed != 0).sum(1), D, model["user_heads_num"], Q)
    work.other_flops += counting.dense_flops(cand.size, D, 1)
