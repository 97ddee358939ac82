"""DiSAN as the program's ``disan`` family builds it, in plain float32: a
directional multi-dimensional self-attention news tower (Shen et al., "DiSAN:
Directional Self-Attention Network for RNN/CNN-Free Language
Understanding", AAAI 2018, sections 3-4), the attention-and-pooling user
tower at ``2·d`` over the clicked news' vectors (no dropout), the score a
dot product.

The news tower over the title's words ``x [M, L, D]`` (``d`` =
``disan_hidden``, or ``D`` where it is 0), one direction:

* ``rep = elu(x' fc + b_fc)`` with ``x'`` a dropout of ``x``;
* ``dep = rep' w1``, ``head = rep' w2`` (``rep'`` a dropout of ``rep``);
  for each hidden dimension the pair logit of token ``i`` to token ``j``
  is ``c·tanh((dep_j + head_i + b1) / c)``, ``c = 5``;
* the pairs the direction allows: ``j > i`` forward, ``j < i`` backward,
  ``j`` a real token; a softmax over ``j``, each dimension on its own, over
  the allowed pairs (a row with none attends to nothing);
* ``res_i = Σ_j att_ij · rep_j``;
* the fusion gate ``g = sigmoid(rep'' wf1 + res' wf2 + bf)`` (``rep''``,
  ``res'`` dropouts of their own), ``out_i = (g rep_i + (1 - g) res_i)``,
  0 on pad tokens.

Then ``u = [out_fw, out_bw]`` (``2·d`` wide) and Source2Token: ``h =
elu(u' fc1 + b1)``, per-dimension scores ``h' fc2 + b2`` softmaxed over the
real tokens, the vector ``Σ_l soft_l · u_l`` (an item without a real token
pools to 0).

Departures from the paper, all as the program has them: the query token's
projection is ``w2`` and the key token's ``w1`` (the paper's ``W(1) x_i +
W(2) x_j`` with the two named the other way round), and the gate's ``wf1``
multiplies the direction's input, ``wf2`` its attention output (the paper's
``W(f1) s + W(f2) h``, the same swap); the disabled diagonal of both masks
as in the paper; dropout on the tower's input, on ``rep`` before the pair
products and before the gate, on ``res`` before the gate, and on both of
Source2Token's inputs (the paper gives no such places); the words are a
trained table with the pad row looked up as 0, where the paper fixes GloVe
vectors.

The step's seed stream gives each call ten seeds in the program's order
(forward direction: ``x``, ``rep`` for ``w1``/``w2``, ``rep`` for
``wf1``, ``res``; the backward direction the same; Source2Token's ``u`` and
``h``), each mask drawn over the call's whole ``[M, L, ·]`` shape where the
program draws it (``common.rand_keep_scale``). The pair tensors of all
``M`` items would not fit under autograd at the cell's size, so the tower
runs in blocks of items under ``torch.utils.checkpoint``, each block
slicing the call's masks and recomputing its pair tensors in the backward;
blocks change no value. The fp8 control rounds each block's operands with
that block's own scale.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from h100bench import counting
from h100bench.reference import common as C
from h100bench.reference.nrms import tower_leaves

FEATS = ("title",)
C_SCALE = 5.0
DIRECTIONS = ("fw", "bw")
# float32 elements of one block's [items, L, L, d] pair tensor (256 MiB)
BLOCK_ELEMENTS = 1 << 26


def hidden(model: Dict) -> int:
    return int(model.get("disan_hidden") or 0) or int(model["word_embed_size"])


def leaves(model: Dict, corpus: Dict):
    """The program's state-dict names: kernels at Flax's lecun-normal scale
    (``1 / sqrt(fan_in)``), biases at 0.01, the word table N(0, 1) with its
    pad row 0."""
    D, d = model["word_embed_size"], hidden(model)
    lecun = lambda fan_in: ("std", fan_in ** -0.5)  # noqa: E731
    bias = ("std", 0.01)
    out = [("word_embedding.embedding", (corpus["vocab"], D), "normal_pad0")]
    for side in DIRECTIONS:
        pre = f"disan.{side}."
        out += [(pre + "b1", (d,), bias), (pre + "bf", (d,), bias),
                (pre + "fc.kernel", (D, d), lecun(D)), (pre + "fc.bias", (d,), bias)]
        out += [(pre + f"{n}.kernel", (d, d), lecun(d)) for n in ("w1", "w2", "wf1", "wf2")]
    for n in ("fc1", "fc2"):
        out += [(f"disan.source2token.{n}.kernel", (2 * d, 2 * d), lecun(2 * d)),
                (f"disan.source2token.{n}.bias", (2 * d,), bias)]
    return out + tower_leaves("user_encoder.tower.", 2 * d, model["query_vector_dim"])


def _drop(t: torch.Tensor, keep: Optional[torch.Tensor]) -> torch.Tensor:
    return t if keep is None else t * keep


def _dense(p: C.Precision, x: torch.Tensor, kernel: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = p.mm("bld,de->ble", x, kernel)
    return y if bias is None else y + bias


def _disa(p: C.Precision, W: Dict[str, torch.Tensor], side: str, x: torch.Tensor,
          mask: torch.Tensor, keep: List[Optional[torch.Tensor]]) -> torch.Tensor:
    """One direction over a block: ``x [b, L, D]``, ``mask [b, L]`` (1 on
    real tokens), ``keep`` the block's four dropout scales (or None)."""
    w = lambda n: W[f"disan.{side}.{n}"]  # noqa: E731
    L = x.shape[1]
    rep = F.elu(_dense(p, _drop(x, keep[0]), w("fc.kernel"), w("fc.bias")))
    rep_dp = _drop(rep, keep[1])
    dep, head = _dense(p, rep_dp, w("w1.kernel")), _dense(p, rep_dp, w("w2.kernel"))
    # [b, i, j, d]: the key token j's dep, the query token i's head
    logits = C_SCALE * torch.tanh((dep[:, None, :, :] + head[:, :, None, :] + w("b1")) / C_SCALE)
    ar = torch.arange(L, device=x.device)
    direct = ar[None, :] > ar[:, None] if side == "fw" else ar[None, :] < ar[:, None]
    pair = (direct[None] & (mask[:, None, :] > 0))[..., None]            # [b, i, j, 1]
    att = torch.softmax(torch.where(pair, logits, C.NEG_INF), dim=2) * pair
    res = p.mm("bijd,bjd->bid", att, rep)
    gate = torch.sigmoid(_dense(p, _drop(rep, keep[2]), w("wf1.kernel"))
                         + _dense(p, _drop(res, keep[3]), w("wf2.kernel")) + w("bf"))
    return (gate * rep + (1.0 - gate) * res) * mask[..., None]


def _source2token(p: C.Precision, W: Dict[str, torch.Tensor], u: torch.Tensor,
                  mask: torch.Tensor, keep: List[Optional[torch.Tensor]]) -> torch.Tensor:
    w = lambda n: W[f"disan.source2token.{n}"]  # noqa: E731
    h = F.elu(_dense(p, _drop(u, keep[0]), w("fc1.kernel"), w("fc1.bias")))
    valid = mask[..., None] > 0
    scores = torch.where(valid, _dense(p, _drop(h, keep[1]), w("fc2.kernel"), w("fc2.bias")),
                         C.NEG_INF)
    soft = torch.softmax(scores, dim=1) * valid
    return p.mm("bld,bld->bd", soft, u)


def _block(p, W, x, mask, *keep):
    """The tower over one block of items: ``[b, L, D]`` -> ``[b, 2·d]``."""
    u = torch.cat([_disa(p, W, "fw", x, mask, list(keep[0:4])),
                   _disa(p, W, "bw", x, mask, list(keep[4:8]))], dim=-1)
    return _source2token(p, W, u, mask, list(keep[8:10]))


def _masks(seeds: Optional[Iterator[int]], rate: float, M: int, L: int, D: int, d: int,
           device) -> List[Optional[torch.Tensor]]:
    """The call's ten dropout scales in the program's order; None each
    without ``seeds`` (serving) or at rate 0, where the program draws no
    seed."""
    if seeds is None or rate <= 0:
        return [None] * 10
    shapes = ([(M, L, D)] + [(M, L, d)] * 3) * 2 + [(M, L, 2 * d)] * 2
    return [C.rand_keep_scale(next(seeds), shape, rate, device) for shape in shapes]


def block_items(L: int, d: int) -> int:
    """Items a block holds: one ``[items, L, L, d]`` pair tensor of at most
    :data:`BLOCK_ELEMENTS` values."""
    return max(1, BLOCK_ELEMENTS // (L * L * d))


def encode(p: C.Precision, W: Dict[str, torch.Tensor], model: Dict,
           feats: Dict[str, torch.Tensor], seeds: Optional[Iterator[int]] = None,
           rate: float = 0.0) -> torch.Tensor:
    """``{title: [M, L]}`` -> ``[M, 2·d]``, in blocks of :func:`block_items`
    items; with ``seeds``, the step's seed stream, the call's ten dropout
    masks at ``rate``."""
    ids = feats["title"]
    M, L = ids.shape
    D, d = model["word_embed_size"], hidden(model)
    x = C.lookup(W["word_embedding.embedding"], ids)
    mask = (ids != 0).float()
    keep = _masks(seeds, rate, M, L, D, d, ids.device)
    items = block_items(L, d)
    outs = []
    for a in range(0, M, items):
        sl = slice(a, a + items)
        args = [x[sl], mask[sl]] + [k if k is None else k[sl] for k in keep]
        outs.append(checkpoint(_block, p, W, *args, use_reentrant=False))
    return torch.cat(outs)


def user(p: C.Precision, W: Dict[str, torch.Tensor], model: Dict,
         vecs: torch.Tensor, mask: torch.Tensor, for_top_k: bool = False) -> torch.Tensor:
    """``[B, H, 2·d]`` clicked-news vectors and their mask -> ``[B, 2·d]``."""
    return C.tower(p, W, "user_encoder.tower.", vecs, mask, model["user_heads_num"])


def disan_flops(lengths: np.ndarray, D: int, d: int) -> float:
    """Forward operations of the news tower over items of ``lengths`` real
    tokens: ``4 l D d + 32 l d^2 + 2 l (l - 1) d + 4 l d`` an item, the
    products ``fc``, ``w1``, ``w2``, ``wf1``, ``wf2`` of both directions,
    each direction's ``Σ_j att·rep`` over its ``l (l - 1) / 2`` pairs, and
    Source2Token's ``fc1``, ``fc2`` and pooled sum. The pair tensors'
    elementwise work (the sums, tanh, the softmax, the masks) is not
    counted."""
    l = np.asarray(lengths, np.float64)
    l = l[l > 0]
    return float((4 * l * D * d + 32 * l * d * d + 2 * l * (l - 1) * d + 4 * l * d).sum())


def disan_bytes(lengths: np.ndarray, D: int, d: int) -> float:
    """Forward bytes: each real item's bfloat16 token rows in and its
    ``2·d`` vector out, and the tower's weights once."""
    l = np.asarray(lengths, np.float64)
    l = l[l > 0]
    weights = 2 * (D * d + 4 * d * d + 3 * d) + 2 * (4 * d * d + 2 * d)
    return (counting.elementwise_bytes(l.sum() * D, inputs=1, outputs=0)
            + counting.elementwise_bytes(2 * d * len(l), inputs=0, outputs=1)
            + counting.elementwise_bytes(weights, inputs=1, outputs=0))


def work(work: counting.Work, model: Dict, lens: Dict[str, np.ndarray], news: np.ndarray,
         browsed: np.ndarray, cand: np.ndarray) -> None:
    """One slice's work (``counting.py``): the news tower over each distinct
    news at its real title length, a part of its own (``disan``) outside the
    fused encoder; the ``2·d``-wide user tower over each impression's real
    history in the fused encoder; the scores."""
    D, d = model["word_embed_size"], hidden(model)
    titles = lens["title_len"][news]
    work.add_part("disan", disan_flops(titles, D, d), disan_bytes(titles, D, d))
    work.news_tokens += int(titles.sum())
    work.add_tower((browsed != 0).sum(1), 2 * d, model["user_heads_num"],
                   model["query_vector_dim"])
    work.other_flops += counting.dense_flops(cand.size, 2 * d, 1)
