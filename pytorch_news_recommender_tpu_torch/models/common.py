"""Shared model base (port of the JAX package's ``models/common.py``).

A family defines ``encode_news_feats(feats, deterministic, generator)``
(the news tower over a per-news feature dict) and ``score_impression(...)``
(the user tower and the scoring head); :class:`RecModel` resolves id-only
batches into those calls. Feature rows are gathered on the device from the
resident ``news_feats`` tables.

Batch forms: direct (``browsed_ids [B, H]``, ``candidate_ids [B, S]``) and
deduplicated (``loader.dedup_batch``: ``unique_ids [U]`` plus inverse
indices), the latter plain, split into a truncated short block and a long
block (``short_mark``'s shape is the short width), or all short. The
multi-block form of the multi-process feed (``block_mark``) is not ported
yet. With ``dedup_gather_mxu`` the inverse gathers' backward is the
segment-scatter kernel (``ops/segment_scatter.py``). ``deterministic=False``
is training: the news tower drops out, with seeds drawn from ``generator``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_news_recommender_tpu_torch.ops.segment_scatter import dedup_gather

Batch = Dict[str, torch.Tensor]


def gather_feats(news_feats: Batch, keys: Tuple[str, ...], ids: torch.Tensor,
                 feat_trunc: Optional[Dict[str, int]] = None) -> Batch:
    """Per-news feature rows for ``ids`` with any leading shape.
    ``feat_trunc`` keeps the first ``n`` columns of a word-axis feature (the
    short block: the host guaranteed the dropped columns are all pad, so the
    result is exact; see ``loader.LengthSplit``)."""
    out = {}
    for k in keys:
        rows = news_feats[k][ids.long()]
        if feat_trunc and k in feat_trunc and rows.ndim >= 2:
            rows = rows[..., :feat_trunc[k]]
        out[k] = rows
    return out


class RecModel(nn.Module):
    """Base class: id-resolution skeleton shared by every model family."""

    # which ``news_feats`` tables the news tower consumes
    FEAT_KEYS = ("title",)
    # news vectors are user-independent: the two-tower eval path applies
    TWO_TOWER = True
    # the news tower is exact under word-axis truncation of all-pad columns
    # (masks from ``ids != 0``), so length-split batches apply
    LENGTH_SPLIT_OK = True

    def encode_news_feats(self, feats: Batch, deterministic: bool = True,
                          generator: Optional[torch.Generator] = None
                          ) -> torch.Tensor:
        """``{feat: [..., ...]}`` -> ``[..., D]`` news vectors."""
        raise NotImplementedError

    def score_impression(self, batch: Batch, browsed_ids: torch.Tensor,
                         cand_ids: torch.Tensor, browsed_vecs: torch.Tensor,
                         cand_vecs: torch.Tensor,
                         news_feats: Batch | None = None,
                         deterministic: bool = True) -> torch.Tensor:
        """Encoded impression -> ``[B, S]`` float32 scores (pads at -1e9)."""
        raise NotImplementedError

    def encode_news_ids(self, ids: torch.Tensor, news_feats: Batch,
                        deterministic: bool = True,
                        feat_trunc: Optional[Dict[str, int]] = None,
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
        """``[...]`` int news ids -> ``[..., D]`` news vectors;
        ``feat_trunc`` as in :func:`gather_feats`."""
        return self.encode_news_feats(
            gather_feats(news_feats, self.FEAT_KEYS, ids, feat_trunc),
            deterministic, generator)

    def _feat_trunc(self) -> Dict[str, int]:
        """Word-feature truncation lengths of the short block, from the
        config (``short_title_len`` / ``short_abst_len``); the host criterion
        ``loader.LengthSplit`` must use the same."""
        c = getattr(self, "cfg", None)
        out = {}
        for feat, attr in (("title", "short_title_len"),
                           ("abst", "short_abst_len")):
            n = int(getattr(c, attr, 0) or 0) if c is not None else 0
            if n > 0 and feat in self.FEAT_KEYS:
                out[feat] = n
        return out

    def resolve_batch(self, batch: Batch, news_feats: Batch,
                      deterministic: bool = True,
                      generator: Optional[torch.Generator] = None
                      ) -> Tuple[torch.Tensor, ...]:
        """A direct or deduplicated batch -> ``(browsed_ids, cand_ids,
        browsed_vecs, cand_vecs)``."""
        if "unique_ids" not in batch:
            browsed_ids = batch["browsed_ids"]
            cand_ids = batch["candidate_ids"]
            H = browsed_ids.shape[1]
            vecs = self.encode_news_ids(torch.cat([browsed_ids, cand_ids], dim=1),
                                        news_feats, deterministic,
                                        generator=generator)
            return browsed_ids, cand_ids, vecs[:, :H], vecs[:, H:]
        if "block_mark" in batch and batch["block_mark"].shape[0] > 1:
            raise NotImplementedError(
                "multi-block dedup batches belong to the multi-process feed, "
                "not ported yet (ROADMAP.md A.6)")
        unique_ids = batch["unique_ids"]                               # [U]
        ws = batch["short_mark"].shape[0] if "short_mark" in batch else 0
        enc = lambda ids, trunc=None: self.encode_news_ids(  # noqa: E731
            ids, news_feats, deterministic, trunc, generator)
        if ws >= unique_ids.shape[0] and self.LENGTH_SPLIT_OK:
            # everything is short: one truncated encode
            uvecs = enc(unique_ids, self._feat_trunc())
        elif ws > 0 and self.LENGTH_SPLIT_OK:
            # the short block's word features are truncated (host-verified
            # all-pad columns), the long block is encoded at full length
            uvecs = torch.cat([enc(unique_ids[:ws], self._feat_trunc()),
                               enc(unique_ids[ws:])])
        else:
            uvecs = enc(unique_ids)
        b_idx = batch["browsed_idx"].long()
        c_idx = batch["candidate_idx"].long()
        # the inverse gathers' backward adds the slots of each unique news
        # (the pad news holds about half the history slots): with
        # ``dedup_gather_mxu`` the hand-written segment scatter, else
        # F.embedding's segment-sum backward, as for the word table
        if self.cfg.dedup_gather_mxu:
            take = dedup_gather
        else:
            take = lambda table, idx: F.embedding(idx, table)  # noqa: E731
        return (unique_ids[b_idx], unique_ids[c_idx],
                take(uvecs, b_idx), take(uvecs, c_idx))

    def forward(self, batch: Batch, news_feats: Batch, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``[B, S]`` float32 candidate scores, padded candidates at -1e9."""
        b_ids, c_ids, b_vecs, c_vecs = self.resolve_batch(
            batch, news_feats, deterministic, generator)
        return self.score_impression(batch, b_ids, c_ids, b_vecs, c_vecs,
                                     news_feats, deterministic)

    def score_from_vecs(self, batch: Batch, news_vecs: torch.Tensor,
                        news_feats: Batch | None = None) -> torch.Tensor:
        """Two-tower path: impression vectors looked up from a precomputed
        corpus table instead of re-encoded."""
        browsed_ids = batch["browsed_ids"]
        cand_ids = batch["candidate_ids"]
        return self.score_impression(
            batch, browsed_ids, cand_ids, news_vecs[browsed_ids.long()],
            news_vecs[cand_ids.long()], news_feats)
