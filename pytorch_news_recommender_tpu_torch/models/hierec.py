"""HieRec-style hierarchical user-interest model (port of the JAX package's
``models/hierec.py``).

* news tower: the NRMS title tower;
* user interest at three levels: for each candidate, attention over the
  clicked news of the candidate's subcategory, the same over its category,
  and the NRMS user tower over the whole history (global);
* score: the ``level_logits`` softmax gate over the three dot products; a
  candidate whose (sub)category the history lacks scores 0 at that level.

The matched interests are computed per candidate with an ``[B, S, H]``
equality-masked attention, three small products in plain PyTorch. Scoring
gathers ``categ`` / ``subcateg`` by id from ``news_feats``; ``top_k`` ranks
the corpus by the global level alone, as the JAX package's serving does.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from pytorch_news_recommender_tpu_torch.config import ModelConfig
from pytorch_news_recommender_tpu_torch.models.nrms import NRMS
from pytorch_news_recommender_tpu_torch.ops.attention import NEG_INF, _mm32


def _matched_interest_scores(cand_vecs: torch.Tensor, hist_vecs: torch.Tensor,
                             cand_tags: torch.Tensor, hist_tags: torch.Tensor,
                             hist_valid: torch.Tensor) -> torch.Tensor:
    """Per-candidate interest score at one level: candidate ``s`` attends
    over the clicked news whose tag equals its own; the score is the
    attention-weighted history vector dotted with the candidate (0 where no
    clicked news has its tag). ``cand_vecs [B, S, D]``, ``hist_vecs [B, H,
    D]``, tags ``[B, S]`` / ``[B, H]`` int, ``hist_valid [B, H]`` bool ->
    ``[B, S]`` float32."""
    D = cand_vecs.shape[-1]
    match = hist_tags[:, None, :] == cand_tags[:, :, None]           # [B, S, H]
    match = match & hist_valid[:, None, :] & (cand_tags != 0)[:, :, None]
    logits = _mm32("bsd,bhd->bsh", cand_vecs, hist_vecs) / math.sqrt(D)
    att = torch.softmax(torch.where(match, logits, NEG_INF), dim=-1)
    att = att * match.any(dim=-1, keepdim=True)   # no match: no interest
    interest = _mm32("bsh,bhd->bsd", att.to(cand_vecs.dtype), hist_vecs)
    return _mm32("bsd,bsd->bs", interest, cand_vecs)


class HieRec(NRMS):
    """Hierarchical (subcategory / category / global) interest matching."""

    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        # softmax gate over the (subcategory, category, global) levels
        self.level_logits = nn.Parameter(torch.zeros(3))

    def reset_parameters(self, generator: torch.Generator) -> None:
        super().reset_parameters(generator)
        with torch.no_grad():
            self.level_logits.zero_()

    def score_impression(self, batch, browsed_ids, cand_ids, browsed_vecs,
                         cand_vecs, news_feats=None,
                         deterministic: bool = True) -> torch.Tensor:
        if news_feats is None:
            raise ValueError("HieRec needs news_feats at score time")
        hist_valid = browsed_ids != 0
        b_ids, c_ids = browsed_ids.long(), cand_ids.long()
        levels = [_matched_interest_scores(cand_vecs, browsed_vecs, tags[c_ids],
                                           tags[b_ids], hist_valid)
                  for tags in (news_feats["subcateg"], news_feats["categ"])]
        user_vec = self.encode_user(browsed_vecs, hist_valid.float())
        levels.append(_mm32("bd,bsd->bs", user_vec, cand_vecs))
        w = torch.softmax(self.level_logits.float(), dim=0)
        scores = w[0] * levels[0] + w[1] * levels[1] + w[2] * levels[2]
        return torch.where(cand_ids != 0, scores, NEG_INF)
