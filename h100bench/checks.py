"""The numbers that decide ``correct``, computed the same way for the
program, for the control and for a planted fault.

Training (three steps from the seeded weights, on the window's own call and
feed); a cell compares the numbers that its ``checks`` name, and the others
are printed beside them:

* ``loss_gap``: the first step's ``|loss - ref| / |ref|``. The later
  steps' losses are printed beside it: Adam's first update moves every
  entry by the learning rate whatever its gradient's size, so entries whose
  gradient is near nought step by rounding, and the later losses carry that
  noise (PERF.md gives the readings);
* ``grad_gap``: the first step's gradient, as the optimizer got it (Adam's
  first moment after one step over ``1 - b1``), by leaf: the gap between
  the program's norm and the reference's, over the reference leaf's own
  norm; the worst leaf;
* ``update_gap``: the same for the parameters' change over the three
  steps;
* ``grad_gap_median``, ``update_gap_median``: the median leaf's gap, which
  swings less from seed to seed than the worst leaf's.

A leaf is a parameter, or one of the query, key and value thirds of a fused
``wqkv``/``bqkv``. Leaves whose reference gradient is under a thousandth of
the median leaf's are left out of both: their gradient is nought but for
rounding (the key bias under softmax), so its gap has no scale, and Adam
turns rounding into steps of the learning rate.

Serving (a sample of the window's requests, drawn from the seed, with the
longest in it):

* ``score_err``: the largest ``|served - ref|`` over every sampled score
  (``/score``'s candidates and ``/top_k``'s returned scores against the
  reference's score of the returned id), over the largest ``|ref|`` score
  of the sample;
* ``topk_miss``: the largest shortfall of a returned id's reference score
  below the reference's ``k``-th best, on the same scale; a reply with the
  wrong count, a repeated id, the pad row or an id outside the corpus
  reads 1.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

B1 = 0.9
SPLIT = ("wqkv", "bqkv")


def leaf_views(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    out = {}
    for n, t in tensors.items():
        if n.rsplit(".", 1)[-1] in SPLIT:
            for part, v in zip("qkv", t.chunk(3, dim=-1)):
                out[f"{n}.{part}"] = v
        else:
            out[n] = t
    return out


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t.detach().float()))
            for n, t in leaf_views(tensors).items()}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep) -> Dict[str, float]:
    """Each leaf's ``|prog - ref| / ref``, for the leaves in ``keep``."""
    return {n: abs(prog.get(n, 0.0) - ref[n]) / max(ref[n], 1e-30) for n in ref if n in keep}


def train_numbers(losses: Sequence[float], grad_norms: Dict[str, float],
                  change_norms: Dict[str, float], ref: Dict) -> Dict[str, object]:
    """The three numbers of a training cell (and the leaves they came
    from). ``ref`` holds the reference's ``losses``, ``grad`` and the
    parameters' change ``change`` by parameter."""
    r_loss = ref["losses"]
    loss_gap = abs(losses[0] - r_loss[0]) / max(abs(r_loss[0]), 1e-30)
    if not all(np.isfinite(losses)) or len(losses) < len(r_loss):
        loss_gap = float("inf")
    r_grad = norms(ref["grad"])
    r_change = norms(ref["change"])
    med = float(np.median(list(r_grad.values())))
    moving = {k for k, v in r_grad.items() if v >= 1e-3 * med}
    g_all = leaf_gaps(grad_norms, r_grad, moving)
    u_all = leaf_gaps(change_norms, r_change, moving)
    g_leaf, u_leaf = max(g_all, key=g_all.get), max(u_all, key=u_all.get)
    top = lambda d: sorted(((round(v, 6), k) for k, v in d.items()), reverse=True)[:3]  # noqa: E731
    return {"loss_gap": loss_gap, "grad_gap": g_all[g_leaf], "update_gap": u_all[u_leaf],
            "grad_leaf": g_leaf, "update_leaf": u_leaf,
            "grad_gap_median": float(np.median(list(g_all.values()))),
            "update_gap_median": float(np.median(list(u_all.values()))),
            "losses": [float(x) for x in losses], "ref_losses": [float(x) for x in r_loss],
            "grad_top": top(g_all), "update_top": top(u_all),
            "left_out": sorted(set(r_grad) - moving)}


def serve_numbers(served_scores: Sequence[np.ndarray], ref_scores: Sequence[np.ndarray],
                  topk_ids: Sequence[np.ndarray], topk_scores: Sequence[np.ndarray],
                  ref_corpus: torch.Tensor, k: int, n_news: int) -> Dict[str, float]:
    """``ref_corpus``: ``[n_topk, N]`` reference scores of every news for
    the sampled ``/top_k`` requests (pad row at ``-inf``)."""
    errs: List[float] = [0.0]
    scale = max([float(np.abs(r).max()) for r in ref_scores if len(r)] + [1e-30])
    bad = False
    for s, r in zip(served_scores, ref_scores):
        if s is None or len(s) != len(r) or not np.all(np.isfinite(s)):
            bad = True
            continue
        errs.append(float(np.abs(np.asarray(s) - r).max()))
    miss = [0.0]
    if len(topk_ids):
        rc = ref_corpus.float()
        kth = torch.topk(rc, k, dim=1).values[:, -1].cpu().numpy()
        scale = max(scale, float(rc[torch.isfinite(rc)].abs().max()))
        for i, (ids, sc) in enumerate(zip(topk_ids, topk_scores)):
            ids = np.asarray(ids, np.int64)
            if (len(ids) != k or len(set(ids.tolist())) != k or ids.min() < 1
                    or ids.max() >= n_news or not np.all(np.isfinite(sc))):
                miss.append(float("inf"))
                continue
            ref_of = rc[i, torch.as_tensor(ids, device=rc.device)].cpu().numpy()
            errs.append(float(np.abs(np.asarray(sc) - ref_of).max()))
            miss.append(float(kth[i] - ref_of.min()))
    score_err = float("inf") if bad else max(errs) / scale
    topk_miss = max(miss) / scale if np.isfinite(max(miss)) else 1.0
    return {"score_err": score_err, "topk_miss": max(topk_miss, 0.0)}
