"""The GNN family in plain float32, as the program's ``gnn`` family builds
it: NRMS's title tower (``reference/nrms.py``'s weights and tower), rounds of
graph attention over each news's neighbours in the corpus's news graph
(Veličković et al., "Graph Attention Networks", ICLR 2018, arXiv:1710.10903
§2.1), NRMS's user tower over the clicked news' vectors, the score a dot
product.

A round (``gat{i}``) takes a news's self vector ``s`` and its neighbours'
vectors ``n_j`` (``j < K``) with a mask of the real ones:

* ``q = s·Wq``, ``k_j = n_j·Wk``;
* ``e_j = leaky_relu(q·a[:D] + k_j·a[D:], 0.01)``;
* ``α = softmax(e)`` over the real neighbours (all 0 where there is none);
* ``agg = Σ_j α_j n_j``;
* ``g = σ([s | agg]·Wg + bg)``, the output ``g·s + (1 − g)·agg``.

With ``R`` = ``gnn_layers`` rounds, deepest first: the self input of every
round is the news's title vector ``t``; the neighbour input of the first
round (``gat{R-1}``) is the neighbours' title vectors, of each later round
the round before's outputs; the last round (``gat0``) gives the news vectors.

Departures from the paper, all as the program has them: separate ``q`` and
``k`` projections where the paper shares one ``W``; a leaky slope of 0.01
(the paper's 0.2); one head; the node itself is not among its neighbours
(no self-loop), and a gated residual ``g·s + (1 − g)·agg`` takes the place
of the paper's nonlinearity over the weighted sum and of its concatenated
heads.

**The training step's layout** (:func:`slice_vectors`, a frozen copy of the
program's ``loader.add_gnn_frontier`` and ``GNNRec._encode_frontier``): the
step's distinct news ``U`` (with the pad news 0) and their ``R``-hop closure
``U ∪ N(U) ∪ ... ∪ N^R(U)``, sorted, padded to a width of
:data:`FRONTIER_BUCKETS`; each slot's neighbours as positions in that
buffer, a neighbour outside the closure (and every neighbour of a pad slot)
at position 0, which the mask drops. The whole buffer's titles are one
encode call with one seed from the step's stream, so each row's dropout
mask depends on its position as the program's does; both rounds run over
every slot through position gathers, and the browsed and candidate vectors
are gathered at their news's positions. The title tower runs in blocks of
:data:`BLOCK_ITEMS` items under ``torch.utils.checkpoint``, so that the
cell's 49,152-row buffer fits under autograd; blocks change no value, and
the fp8 control rounds each block's operands with that block's own scale.

**Work** (:func:`work`): the least that the equations need, whatever runs
them. The title tower over the closure's real news at their real lengths
(``add_tower``; the buffer's pad rows and the pad news do not count) and the
user tower over each impression's real history. A part ``gat``, counted over
the nodes whose outputs a later round or the scores read: ``S_r``, the
news within ``R − r`` hops of ``U``, for round ``r = 1 .. R`` (``S_1 = U ∪
N(U)`` and ``S_2 = U`` at ``R = 2``). ``q`` and ``k_j`` enter only through
``q·a[:D]`` and ``k_j·a[D:]``, that is ``s·(Wq a[:D])`` and ``n_j·(Wk
a[D:])``, so a round of ``S`` with ``k_x`` real neighbours at ``x`` and
``N(S)`` the distinct real neighbour rows counts

* operations ``4D² + 2D·|S| + 2D·|N(S)| + 2D·Σ_x k_x + 4D²·|S|``: ``Wq
  a[:D]`` and ``Wk a[D:]`` once, a dot product per self row and per
  distinct neighbour row, the weighted sum of the neighbours, the gate's
  ``[s | agg]·Wg``;
* bytes ``2D·(|S| + |N(S)|)`` of bfloat16 rows read once (self, neighbours),
  ``2D·|S|`` written, ``4K·|S|`` of int32 positions, and ``2(4D² + 3D)`` of
  bfloat16 weights (``Wq``, ``Wk``, ``a``, ``Wg``, ``bg``) once.

The softmax, the leaky ReLU, the sigmoid and the gated sum are not counted.
Beside the shared counts, ``inputs_per_step`` then reports the closure's
news, the frontier's width and each round's counted rows.

Serving does not go through this module's layout: :func:`encode` is the
title tower alone (the GAT's level 0).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from h100bench import counting
from h100bench.reference import common as C
from h100bench.reference import layout as LY
from h100bench.reference import nrms

FEATS = ("title",)
# the program's GNN_FRONTIER_BUCKETS (data/loader.py), frozen
FRONTIER_BUCKETS = (2048, 4096, 8192, 12288, 16384, 24576, 32768,
                    40960, 49152, 53248, 57344, 61440, 65536)
LEAKY_SLOPE = 0.01
# title-tower items a checkpointed block holds
BLOCK_ITEMS = 8192


def rounds(model: Dict) -> int:
    return max(1, int(model["gnn_layers"]))


def leaves(model: Dict, corpus: Dict):
    """NRMS's weights (the word table, the title and user towers), then each
    round's at its initializer's scale: ``wq``, ``wk`` ``[D, D]`` and ``a``
    ``[2D, 1]`` Xavier, the gate's kernel ``[2D, D]`` lecun-normal
    (``1 / sqrt(2D)``), its bias at 0.01."""
    D = model["word_embed_size"]
    x = lambda a, b: ("std", (2.0 / (a + b)) ** 0.5)  # noqa: E731
    out = nrms.leaves(model, corpus)
    for i in range(rounds(model)):
        pre = f"gat{i}."
        out += [(pre + "wq", (D, D), x(D, D)), (pre + "wk", (D, D), x(D, D)),
                (pre + "a", (2 * D, 1), x(2 * D, 1)),
                (pre + "gate.kernel", (2 * D, D), ("std", (2 * D) ** -0.5)),
                (pre + "gate.bias", (D,), ("std", 0.01))]
    return out


def encode(p: C.Precision, W: Dict[str, torch.Tensor], model: Dict,
           feats: Dict[str, torch.Tensor], seeds: Optional[Iterator[int]] = None,
           rate: float = 0.0) -> torch.Tensor:
    """The title tower (``reference/nrms.py``'s): ``{title: [M, L]}`` ->
    ``[M, D]``, in blocks of :data:`BLOCK_ITEMS` items; with ``seeds``, the
    call's one seed and its hashed dropout over all ``M`` items."""
    ids = feats["title"]
    M, L = ids.shape
    D = model["word_embed_size"]
    seed = next(seeds) if seeds is not None else None
    x = C.lookup(W["news_encoder.word_embedding.embedding"], ids)
    keep = (C.hash_keep_scale(seed, M, L, D, rate, ids.device)
            if seed is not None and rate > 0 else None)
    heads = model["num_attention_heads"]
    outs = []
    for a in range(0, M, BLOCK_ITEMS):
        sl = slice(a, a + BLOCK_ITEMS)
        outs.append(checkpoint(C.tower, p, W, "news_encoder.tower.", x[sl], ids[sl] != 0,
                               heads, None if keep is None else keep[sl], use_reentrant=False))
    return torch.cat(outs)


user = nrms.user


def gat_round(p: C.Precision, W: Dict[str, torch.Tensor], prefix: str, s: torch.Tensor,
              nbr: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    """One round (module docstring): ``s [n, D]``, ``nbr [n, K, D]``, ``real
    [n, K]`` (True on a real neighbour) -> ``[n, D]``."""
    D = s.shape[-1]
    a = W[prefix + "a"][:, 0]
    q = p.mm("nd,de->ne", s, W[prefix + "wq"])
    k = p.mm("nkd,de->nke", nbr, W[prefix + "wk"])
    e = F.leaky_relu(p.mm("ne,e->n", q, a[:D])[:, None] + p.mm("nke,e->nk", k, a[D:]),
                     LEAKY_SLOPE)
    alpha = torch.softmax(torch.where(real, e, C.NEG_INF), dim=-1) * real.any(-1, keepdim=True)
    agg = p.mm("nk,nkd->nd", alpha, nbr)
    g = torch.sigmoid(p.mm("nc,cd->nd", torch.cat([s, agg], -1), W[prefix + "gate.kernel"])
                      + W[prefix + "gate.bias"])
    return g * s + (1.0 - g) * agg


def closure(ids: np.ndarray, neighbors: np.ndarray, depth: int) -> np.ndarray:
    """The sorted ``depth``-hop closure of ``ids`` in the graph (the pad id 0
    where ``ids`` or a missing neighbour brings it)."""
    cur = reach = np.unique(ids)
    for _ in range(depth):
        cur = np.unique(neighbors[cur])
        reach = np.union1d(reach, cur)
    return reach


@dataclasses.dataclass
class Frontier:
    """One step's buffer: ``ids [F]`` (slot 0 the pad news, the closure
    sorted, then pad slots), ``nbr_pos [F, K]`` and each news id's position
    ``pos_of [N+1]`` (0 for a news outside the closure)."""

    ids: np.ndarray
    nbr_pos: np.ndarray
    pos_of: np.ndarray


def frontier(browsed: np.ndarray, cand: np.ndarray, neighbors: np.ndarray,
             depth: int) -> Frontier:
    """The program's frontier layout of one dedup step, worked out again."""
    reach = closure(np.concatenate([[0], browsed.ravel(), cand.ravel()]), neighbors, depth)
    ids = np.zeros(LY.bucket(len(reach), FRONTIER_BUCKETS), np.int64)
    ids[:len(reach)] = reach
    pos_of = np.zeros(neighbors.shape[0], np.int64)
    pos_of[reach] = np.arange(len(reach))
    nb = neighbors[ids].astype(np.int64)
    nb[ids == 0] = 0
    return Frontier(ids, pos_of[nb], pos_of)


def slice_vectors(p: C.Precision, W: Dict[str, torch.Tensor], model: Dict,
                  feats: Dict[str, torch.Tensor], browsed: np.ndarray, cand: np.ndarray,
                  title_len: np.ndarray, trunc, seeds, rate: float, device):
    """One step's browsed and candidate vectors through the frontier layout
    (module docstring). The program takes no length split for this family,
    so ``trunc`` is not used. A step whose dedup bucket would not shrink the
    work is one the program encodes in its recursive form, which this
    reference does not lay out: it stops."""
    news = np.unique(np.concatenate([[0], browsed.ravel(), cand.ravel()]))
    if LY.bucket(len(news)) >= browsed.size + cand.size:
        raise ValueError("a direct-form step: the program's GNN encodes it recursively")
    fr = frontier(browsed, cand, feats["neighbors"].cpu().numpy(), rounds(model))
    ids = torch.as_tensor(fr.ids, device=device)
    nbr_pos = torch.as_tensor(fr.nbr_pos, device=device)
    t = encode(p, W, model, {"title": feats["title"][ids]}, seeds, rate)
    real = ids[nbr_pos] != 0
    h = t
    for i in reversed(range(rounds(model))):
        h = gat_round(p, W, f"gat{i}.", t, h[nbr_pos], real)
    pos = lambda a: torch.as_tensor(fr.pos_of[a], device=device)  # noqa: E731
    return h[pos(browsed)], h[pos(cand)]


def gat_work(news: np.ndarray, neighbors: np.ndarray, depth: int, D: int):
    """The ``gat`` part of a step whose distinct real news are ``news``
    (module docstring): ``(flops, bytes, rows)``, ``rows`` each round's
    counted nodes ``|S_r|``."""
    K = neighbors.shape[1]
    flops = nbytes = 0.0
    rows = []
    for r in range(1, depth + 1):
        S = closure(news, neighbors, depth - r)
        S = S[S != 0]
        nb = neighbors[S]
        k = int(np.count_nonzero(nb))
        distinct = int(np.count_nonzero(np.unique(nb)))
        flops += (4 * D * D + 2 * D * len(S) + 2 * D * distinct + 2 * D * k
                  + counting.dense_flops(len(S), 2 * D, D))
        nbytes += (counting.elementwise_bytes(D * (len(S) + distinct), inputs=1, outputs=0)
                   + counting.elementwise_bytes(D * len(S), inputs=0, outputs=1)
                   + 4.0 * K * len(S)
                   + counting.elementwise_bytes(4 * D * D + 3 * D, inputs=1, outputs=0))
        rows.append(len(S))
    return flops, nbytes, rows


def _counters(work: counting.Work) -> collections.Counter:
    """This family's counters on ``work``, summed over steps; the first call
    makes ``work.per_step`` report their means beside the shared ones."""
    got = work.__dict__.get("gnn_counts")
    if got is None:
        got = work.gnn_counts = collections.Counter()
        shared = work.per_step
        work.per_step = lambda: {**shared(), **{k: v / max(work.steps, 1)
                                                for k, v in got.items()}}
    return got


def work(work: counting.Work, model: Dict, lens: Dict[str, np.ndarray], news: np.ndarray,
         browsed: np.ndarray, cand: np.ndarray) -> None:
    """One slice's work (module docstring): the title tower over the
    closure, the user tower, the ``gat`` part, the scores; and the
    closure's news, the frontier's width and each round's rows."""
    D, H, Q = model["word_embed_size"], model["num_attention_heads"], model["query_vector_dim"]
    nb = lens["neighbors"]
    depth = rounds(model)
    reach = closure(news, nb, depth)
    reach = reach[reach != 0]
    titles = lens["title_len"][reach]
    work.add_tower(titles, D, H, Q)
    work.news_tokens += int(titles.sum())
    work.add_tower((browsed != 0).sum(1), D, model["user_heads_num"], Q)
    work.other_flops += counting.dense_flops(cand.size, D, 1)
    flops, nbytes, rows = gat_work(news, nb, depth, D)
    work.add_part("gat", flops, nbytes)
    got = _counters(work)
    got["closure_news"] += len(reach)
    got["frontier_width"] += LY.bucket(len(reach) + 1, FRONTIER_BUCKETS)
    for r, n in enumerate(rows, 1):
        got[f"gat_rows.round{r}"] += n
