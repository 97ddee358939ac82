"""Serving in plain float32: the corpus table from the seeded weights, then
for each request the user tower over its history's vectors and either the
candidates' scores or the corpus-wide best ``k`` (the pad row excluded)."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from h100bench.reference import common as C


@torch.no_grad()
def corpus_vectors(fam, model: Dict, W: Dict[str, torch.Tensor],
                   feats: Dict[str, torch.Tensor], p: C.Precision = C.F32,
                   block: int = 8192) -> torch.Tensor:
    """``[N, D]`` news vectors, ``block`` news at a time; the pad news
    pools to 0."""
    C.strict_fp32()
    n = feats["title"].shape[0]
    out = []
    for s in range(0, n, block):
        f = {k: feats[k][s:s + block] for k in fam.FEATS}
        out.append(fam.encode(p, W, model, f))
    return torch.cat(out)


def _histories(hists: Sequence[np.ndarray], H: int, device) -> torch.Tensor:
    """The last ``H`` clicks of each history, left-padded with 0."""
    out = np.zeros((len(hists), H), np.int64)
    for i, h in enumerate(hists):
        h = np.asarray(h, np.int64)[-H:]
        out[i, H - len(h):] = h
    return torch.as_tensor(out, device=device)


@torch.no_grad()
def users(fam, model: Dict, W: Dict[str, torch.Tensor], vecs: torch.Tensor,
          hists: Sequence[np.ndarray], H: int, for_top_k: bool,
          p: C.Precision = C.F32, block: int = 1024) -> torch.Tensor:
    """``[n, D]`` user vectors of the histories."""
    out = []
    for s in range(0, len(hists), block):
        b = _histories(hists[s:s + block], H, vecs.device)
        out.append(fam.user(p, W, model, vecs[b], b != 0, for_top_k))
    return torch.cat(out)


@torch.no_grad()
def scores(user: torch.Tensor, vecs: torch.Tensor, cands: Sequence[np.ndarray],
           p: C.Precision = C.F32) -> List[np.ndarray]:
    """Each request's candidate scores."""
    out = []
    for u, c in zip(user, cands):
        cv = vecs[torch.as_tensor(np.asarray(c, np.int64), device=vecs.device)]
        out.append(C.dot_scores(p, u[None], cv[None])[0].cpu().numpy())
    return out


@torch.no_grad()
def corpus_scores(user: torch.Tensor, vecs: torch.Tensor, n_news: int,
                  p: C.Precision = C.F32) -> torch.Tensor:
    """``[n, N]`` scores of every news, the pad row 0 at ``-inf``."""
    s = p.mm("bd,nd->bn", user, vecs[:n_news])
    s[:, 0] = -torch.inf
    return s
