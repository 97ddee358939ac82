"""Shared model base (port of the JAX package's ``models/common.py``).

A family defines ``encode_news_feats(feats, deterministic, generator)``
(the news tower over a per-news feature dict) and ``score_impression(...)``
(the user tower and the scoring head); :class:`RecModel` resolves id-only
batches into those calls. Feature rows are gathered on the device from the
resident ``news_feats`` tables.

Batch forms: direct (``browsed_ids [B, H]``, ``candidate_ids [B, S]``) and
deduplicated (``loader.dedup_batch``: ``unique_ids [U]`` plus inverse
indices), the latter plain, split into a truncated short block and a long
block (``short_mark``'s shape is the short width), or all short, or the
multi-process feed's ``block_mark`` blocks, each split so. With
``dedup_gather_mxu`` the inverse gathers' backward is the
segment-scatter kernel (``ops/segment_scatter.py``). ``deterministic=False``
is training: the news tower drops out, with seeds drawn from ``generator``.

Auxiliary losses (the JAX package's ``losses`` collection): a family with
``HAS_AUX_LOSS`` records them with :meth:`RecModel.sow_loss` while it
encodes; each :meth:`RecModel.forward` starts with none, as each Flax
``apply`` starts with an empty collection, and the train step adds them to
the click loss (``train/loop.py::training_loss``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

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
    # the family records auxiliary losses (``sow_loss``) for the train step
    HAS_AUX_LOSS = False
    # the trainer attaches the GNN frontier (``loader.add_gnn_frontier``) to
    # dedup batches
    WANTS_GNN_FRONTIER = False
    # eval and serving encode the corpus level by level
    # (:func:`corpus_encode_levelwise`) instead of by chunks of ids
    CORPUS_LEVELWISE = False

    def __init__(self):
        super().__init__()
        self.aux_losses: Dict[str, torch.Tensor] = {}

    @classmethod
    def from_config(cls, cfg, feat_shapes: Optional[Mapping[str, Tuple[int, ...]]] = None
                    ) -> "RecModel":
        """The family at ``cfg``. ``feat_shapes`` (the dataset's feature
        tables' shapes) serves families whose parameters take a table's
        shape, as Flax's init takes it from the data (``nrms_bert``)."""
        return cls(cfg)

    def sow_loss(self, name: str, value: torch.Tensor) -> None:
        """Records an auxiliary loss under ``name``; a later call with the
        same name replaces it (Flax ``sow`` with ``reduce_fn=lambda a, b:
        b``). So in a length-split batch, which encodes the short block and
        then the long block, the long block's loss is the one kept."""
        self.aux_losses[name] = value

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
        browsed_vecs, cand_vecs)``. A dedup batch is one block, or the
        ``block_mark`` blocks of the multi-process feed
        (``loader.train_batches_sliced``), each split at its own short
        width."""
        if "unique_ids" not in batch:
            browsed_ids = batch["browsed_ids"]
            cand_ids = batch["candidate_ids"]
            H = browsed_ids.shape[1]
            vecs = self.encode_news_ids(torch.cat([browsed_ids, cand_ids], dim=1),
                                        news_feats, deterministic,
                                        generator=generator)
            return browsed_ids, cand_ids, vecs[:, :H], vecs[:, H:]
        unique_ids = batch["unique_ids"]                               # [U]
        ws = batch["short_mark"].shape[0] if "short_mark" in batch else 0
        nb = batch["block_mark"].shape[0] if "block_mark" in batch else 1
        enc = lambda ids, trunc=None: self.encode_news_ids(  # noqa: E731
            ids, news_feats, deterministic, trunc, generator)
        if nb > 1 and ws > 0 and self.LENGTH_SPLIT_OK:
            # the multi-process feed's layout: nb blocks of W slots, each
            # [short ws/nb | long] at one agreed width; every block's shorts
            # in one truncated encode, every long in one full-length encode,
            # put back in the block layout that the indices point into
            U = unique_ids.shape[0]
            W, wsl = U // nb, ws // nb
            u2 = unique_ids.reshape(nb, W)
            v_s = enc(u2[:, :wsl].reshape(-1), self._feat_trunc())
            v_l = enc(u2[:, wsl:].reshape(-1))
            D = v_s.shape[-1]
            uvecs = torch.cat([v_s.reshape(nb, wsl, D), v_l.reshape(nb, W - wsl, D)],
                              dim=1).reshape(U, D)
        elif ws >= unique_ids.shape[0] and self.LENGTH_SPLIT_OK:
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
        """``[B, S]`` float32 candidate scores, padded candidates at -1e9;
        the auxiliary losses of this call are in ``aux_losses``."""
        self.aux_losses = {}
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


@torch.no_grad()
def corpus_encode_levelwise(model: RecModel, news_feats: Batch,
                            chunk: int) -> torch.Tensor:
    """Whole-corpus news vectors of a ``CORPUS_LEVELWISE`` family (GNN):
    the titles once for every news (``encode_title_ids``), then one pass of
    each GAT layer over the whole table (``gat_chunk``), deepest layer
    first, ``chunk`` news at a time: ``1 + n_layers`` passes instead of the
    ``1 + K + ... + K^n_layers`` titles per news of the recursive encode.
    The one implementation behind ``Trainer.compute_news_vectors`` and the
    ``Recommender``'s corpus encode. ``news_feats`` is an argument of every
    pass, so the tables read are those of the call."""
    n = int(news_feats["title"].shape[0])
    device = news_feats["title"].device

    def chunked(fn):
        outs = []
        for s in range(0, n, chunk):
            e = min(s + chunk, n)
            ids = torch.zeros(chunk, dtype=torch.int32, device=device)
            ids[:e - s] = torch.arange(s, e, dtype=torch.int32, device=device)
            outs.append(fn(ids))
        return torch.cat(outs)[:n]

    titles = chunked(lambda ids: model.encode_title_ids(ids, news_feats))
    h = titles
    # deepest layer first: the recursive encode's per-depth layer order
    for li in reversed(range(len(model.gat_layers))):
        h = chunked(lambda ids, prev=h, li=li: model.gat_chunk(
            ids, titles, prev, news_feats, li))
    return h
