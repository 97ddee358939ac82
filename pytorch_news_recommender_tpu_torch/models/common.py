"""Shared model base (port of the JAX package's ``models/common.py``).

A family defines ``encode_news_feats(feats)`` (the news tower over a
per-news feature dict) and ``score_impression(...)`` (the user tower and
the scoring head); :class:`RecModel` resolves id-only batches into those
calls. Feature rows are gathered on the device from the resident
``news_feats`` tables.

Ported so far: the direct batch form (``browsed_ids [B, H]``,
``candidate_ids [B, S]``). The deduplicated and length-split forms belong
to training and come with it (``ROADMAP.md``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

Batch = Dict[str, torch.Tensor]


def gather_feats(news_feats: Batch, keys: Tuple[str, ...],
                 ids: torch.Tensor) -> Batch:
    """Per-news feature rows for ``ids`` with any leading shape."""
    return {k: news_feats[k][ids.long()] for k in keys}


class RecModel(nn.Module):
    """Base class: id-resolution skeleton shared by every model family."""

    # which ``news_feats`` tables the news tower consumes
    FEAT_KEYS = ("title",)

    def encode_news_feats(self, feats: Batch) -> torch.Tensor:
        """``{feat: [..., ...]}`` -> ``[..., D]`` news vectors."""
        raise NotImplementedError

    def score_impression(self, batch: Batch, browsed_ids: torch.Tensor,
                         cand_ids: torch.Tensor, browsed_vecs: torch.Tensor,
                         cand_vecs: torch.Tensor,
                         news_feats: Batch | None = None) -> torch.Tensor:
        """Encoded impression -> ``[B, S]`` float32 scores (pads at -1e9)."""
        raise NotImplementedError

    def encode_news_ids(self, ids: torch.Tensor, news_feats: Batch) -> torch.Tensor:
        """``[...]`` int news ids -> ``[..., D]`` news vectors."""
        return self.encode_news_feats(gather_feats(news_feats, self.FEAT_KEYS, ids))

    def resolve_batch(self, batch: Batch, news_feats: Batch
                      ) -> Tuple[torch.Tensor, ...]:
        """Direct batch -> ``(browsed_ids, cand_ids, browsed_vecs,
        cand_vecs)``: history and candidates encoded in one call."""
        browsed_ids = batch["browsed_ids"]
        cand_ids = batch["candidate_ids"]
        H = browsed_ids.shape[1]
        vecs = self.encode_news_ids(torch.cat([browsed_ids, cand_ids], dim=1),
                                    news_feats)
        return browsed_ids, cand_ids, vecs[:, :H], vecs[:, H:]

    def forward(self, batch: Batch, news_feats: Batch) -> torch.Tensor:
        """``[B, S]`` float32 candidate scores, padded candidates at -1e9."""
        b_ids, c_ids, b_vecs, c_vecs = self.resolve_batch(batch, news_feats)
        return self.score_impression(batch, b_ids, c_ids, b_vecs, c_vecs, news_feats)

    def score_from_vecs(self, batch: Batch, news_vecs: torch.Tensor,
                        news_feats: Batch | None = None) -> torch.Tensor:
        """Two-tower path: impression vectors looked up from a precomputed
        corpus table instead of re-encoded."""
        browsed_ids = batch["browsed_ids"]
        cand_ids = batch["candidate_ids"]
        return self.score_impression(
            batch, browsed_ids, cand_ids, news_vecs[browsed_ids.long()],
            news_vecs[cand_ids.long()], news_feats)
