"""The first three training steps in plain float32, from the seeded
weights and the raw impressions: each step's loss, the first step's
gradient and the parameters after the third update, as Adam at the
configuration's learning rate leaves them. A slice's vectors come from the
frozen batch layout (``layout.py``), or from the family's own
``slice_vectors`` where it has one (``reference/__init__.py``)."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from h100bench.reference import common as C
from h100bench.reference import layout as LY


def _slice_scores(fam, p, W, model, feats, lay: LY.Layout, seeds, rate, device):
    """One rank's slice: every call of its layout encoded, each drawing its
    dropout seeds from the step's stream ``seeds`` in the program's order,
    the slots gathered, the user tower, the scores."""
    outs = []
    for call in lay.calls:
        ids = torch.as_tensor(call.ids, device=device)
        f = {}
        for k in fam.FEATS:
            rows = feats[k][ids]
            if call.trunc and rows.ndim == 2 and k == "title":
                rows = rows[:, :call.trunc]
            f[k] = rows
        outs.append(fam.encode(p, W, model, f, seeds, rate))
    vecs = torch.cat(outs)
    b_pos = torch.as_tensor(lay.browsed_pos, device=device)
    c_pos = torch.as_tensor(lay.cand_pos, device=device)
    return vecs[b_pos], vecs[c_pos]


def run(fam, model: Dict, lr: float, train_seed: int, W0: Dict[str, torch.Tensor],
        feats: Dict[str, torch.Tensor], title_len: np.ndarray,
        batches: Sequence[tuple], ranks: int = 1,
        p: C.Precision = C.F32) -> Dict:
    """``batches``: the steps' global impressions ``(browsed [B, H],
    candidates [B, 1+K])``, numpy. Returns ``losses`` (one float a step),
    ``grad`` (the first step's gradient by leaf) and ``params`` (the
    parameters after the last step), as tensors."""
    C.strict_fp32()
    own = getattr(fam, "slice_vectors", None)
    if own is not None and ranks > 1:
        raise ValueError(f"{fam.__name__} lays out its own step (slice_vectors) for one rank "
                         f"only, not for {ranks}")
    device = next(iter(W0.values())).device
    params = {n: w.detach().clone().float().requires_grad_(True) for n, w in W0.items()}
    opt = C.Adam(params, lr)
    rate = float(model["dropout"])
    trunc = int(model.get("short_title_len") or 0) or None
    losses: List[float] = []
    grad0 = None
    for step, (browsed, cand) in enumerate(batches):
        if own is None and ranks == 1:
            lays = [LY.single(browsed, cand, title_len, trunc)]
        elif own is None:
            lays = LY.sliced(browsed, cand, title_len, trunc, ranks)
        per = browsed.shape[0] // ranks
        loss = 0.0
        for r in range(ranks):
            b_ids = torch.as_tensor(browsed[r * per:(r + 1) * per], device=device)
            c_ids = torch.as_tensor(cand[r * per:(r + 1) * per], device=device)
            seeds = C.step_seeds(train_seed, step, r)
            if own is not None:
                b_vecs, c_vecs = own(p, params, model, feats, browsed, cand, title_len, trunc,
                                     seeds, rate, device)
            else:
                b_vecs, c_vecs = _slice_scores(fam, p, params, model, feats, lays[r], seeds,
                                               rate, device)
            user = fam.user(p, params, model, b_vecs, b_ids != 0)
            scores = torch.where(c_ids != 0, C.dot_scores(p, user, c_vecs), C.NEG_INF)
            loss = loss + (-torch.log_softmax(scores, dim=-1)[:, 0].mean()) / ranks
        grads = torch.autograd.grad(loss, list(params.values()))
        grads = dict(zip(params, grads))
        if grad0 is None:
            grad0 = {n: g.detach().clone() for n, g in grads.items()}
        opt.step(grads)
        losses.append(float(loss.detach()))
    return {"losses": losses, "grad": grad0,
            "params": {n: t.detach() for n, t in params.items()}}
