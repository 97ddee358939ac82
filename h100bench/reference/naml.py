"""NAML as the program's ``naml`` family builds it (the reference
repository's ``nrms_naml``), in plain float32: the title and the abstract
through one shared attention-and-pooling tower over one word table,
category and subcategory embeddings, the four views joined into an 800-wide
news vector with dropout on the whole vector; the user tower over the
LayerNorm-ed clicked-news vectors for scoring (over the vectors as they are
for corpus retrieval); the score a dot product."""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch

from h100bench import counting
from h100bench.reference import common as C
from h100bench.reference.nrms import tower_leaves

FEATS = ("title", "abst", "categ", "subcateg")


def news_dim(model: Dict) -> int:
    return 2 * model["word_embed_size"] + 2 * model["cate_embed_size"]


def leaves(model: Dict, corpus: Dict):
    D, Q, E = model["word_embed_size"], model["query_vector_dim"], model["cate_embed_size"]
    N = news_dim(model)
    return ([("word_embedding.embedding", (corpus["vocab"], D), "normal_pad0")]
            + tower_leaves("text_tower.", D, Q)
            + [("category_embedding.embedding", (corpus["n_categories"], E), "normal"),
               ("subcategory_embedding.embedding", (corpus["n_subcategories"], E), "normal"),
               ("norm.scale", (N,), ("one_plus_std", 0.01)),
               ("norm.bias", (N,), ("std", 0.01))]
            + tower_leaves("user_encoder.tower.", N, model["query_vector_dim_large"]))


def _view(p, W, model, ids):
    x = C.lookup(W["word_embedding.embedding"], ids)
    return C.tower(p, W, "text_tower.", x, ids != 0, model["num_attention_heads"])


def encode(p: C.Precision, W: Dict[str, torch.Tensor], model: Dict,
           feats: Dict[str, torch.Tensor], seeds: Optional[Iterator[int]] = None,
           rate: float = 0.0) -> torch.Tensor:
    """``{title [M, Lt], abst [M, La], categ [M], subcateg [M]}`` -> ``[M,
    800]``; with ``seeds``, the step's seed stream, the vector's dropout
    drawn where it lies from the one seed the call draws."""
    seed = next(seeds) if seeds is not None else None
    vec = torch.cat([_view(p, W, model, feats["title"]), _view(p, W, model, feats["abst"]),
                     C.lookup(W["category_embedding.embedding"], feats["categ"]),
                     C.lookup(W["subcategory_embedding.embedding"], feats["subcateg"])], dim=-1)
    if seed is not None and rate > 0:
        vec = vec * C.rand_keep_scale(seed, vec.shape, rate, vec.device)
    return vec


def user(p: C.Precision, W: Dict[str, torch.Tensor], model: Dict,
         vecs: torch.Tensor, mask: torch.Tensor, for_top_k: bool = False) -> torch.Tensor:
    if not for_top_k:
        vecs = C.layer_norm(vecs, W["norm.scale"], W["norm.bias"])
    return C.tower(p, W, "user_encoder.tower.", vecs, mask, model["user_heads_num"])


def work(work: counting.Work, model: Dict, lens: Dict[str, np.ndarray], news: np.ndarray,
         browsed: np.ndarray, cand: np.ndarray) -> None:
    """One slice's work (``counting.py``): the shared text tower over the
    title and the abstract of each distinct news at their real lengths, the
    800-wide user tower (query ``query_vector_dim_large``) over each
    impression's real history, all in the fused encoder; the scores."""
    D, H, Q = model["word_embed_size"], model["num_attention_heads"], model["query_vector_dim"]
    for view in ("title_len", "abst_len"):
        work.add_tower(lens[view][news], D, H, Q)
        work.news_tokens += int(lens[view][news].sum())
    N = news_dim(model)
    work.add_tower((browsed != 0).sum(1), N, model["user_heads_num"],
                   model["query_vector_dim_large"])
    work.other_flops += counting.dense_flops(cand.size, N, 1)
