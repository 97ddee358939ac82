"""Serving API: weights + corpus -> ready-to-score recommender (port of the
JAX package's ``serve.py``).

* The news tower runs once over the whole corpus at start-up, in chunks of
  ``train.eval_encode_chunk`` news, into a resident ``[N, D]`` vector table.
* ``score(history, candidates, user_id)`` runs only the user tower and the
  head per request, the user id in the batch (``user_ids``: LSTUR's
  long-term vector reads it); ``score_many`` batches many requests, padded
  to :attr:`Recommender.BATCH_PAD` rows per width bucket.
* ``top_k(history, k)`` scores the entire corpus with one ``[D] @ [D, N]``
  product and ``torch.topk``, for families whose user tower runs over the
  cached vectors alone (not LSTUR, not Fastformer).
* ``add_news`` tokenizes, encodes and appends a news item that was not in
  the corpus; it scores at once (not for ``nrms_bert``, whose news come as
  precomputed vectors).

The GNN's corpus is encoded level by level, as its eval is; a family whose
news vectors depend on the user (NPA) has no corpus table and is refused,
as in the JAX package.

``corpus_cache="int8"`` keeps the table quantized per row (int8 values +
one float32 scale per news), 4x smaller than float32.

The corpus cache (``native``, or int8 values and scales) is a list of
contiguous row blocks: one on the recommender's device, or with ``mesh=``
(``parallel.mesh.make_mesh``) ``mesh.shape[axis_names[0]]`` of them, one on
each device of the mesh's first axis, the rows zero-padded to a multiple of
the block count (never replicated): a corpus larger than one card serves
from several. One process drives every device, as JAX's single controller
does; the model and the feature tables stay on the first device.
``score``/``score_many`` gather each id's row from its block onto the first
device; ``top_k`` runs the user tower once, scores each block on its device
(the pad row 0 and rows at or past ``n_news`` at ``-inf``), takes a top-k
per block and merges the candidates by score, ties to the lower id;
``add_news`` writes into the last rows or, when the blocks are full, grows
the table by ``GROW_BLOCK`` rows and splits it again. ``news_vecs``,
``news_q`` and ``news_scale`` give the whole tables.

On a CUDA device both towers run through the fused encoder kernel
(``ops/fused_encoder.py``). An entry point runs on the card unless the
caller passes ``device="cpu"`` (or a mesh of host devices): with
``device=None`` and no CUDA, it raises. PyTorch runs eagerly, so there is nothing to compile or warm; the candidate
width buckets are kept so that ``score`` and ``score_many`` cut long lists
exactly where the JAX package does.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from pytorch_news_recommender_tpu_torch.config import Config
from pytorch_news_recommender_tpu_torch.data.dataset import RecDataset
from pytorch_news_recommender_tpu_torch.models import build_model
from pytorch_news_recommender_tpu_torch.models.common import corpus_encode_levelwise
from pytorch_news_recommender_tpu_torch.models.convert import assign, load_params
from pytorch_news_recommender_tpu_torch.train.checkpoint import load_config, params_file


def resolve_device(device: Optional[str | torch.device]) -> torch.device:
    """``None`` means the CUDA card, which must then exist. A CUDA device
    without an index becomes the caller's current card by index: the
    current card is set per thread, so a bare ``cuda`` would name card 0
    in a helper thread (the prefetch's) of a rank that owns another card."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the port serves on the GPU; "
                               "pass device='cpu' to run the plain version "
                               "on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _quantize(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8: ``q = round(v / s)``, ``s = amax / 127``."""
    v = v.float()
    s = (v.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-12)
    q = torch.clamp(torch.round(v / s), -127, 127).to(torch.int8)
    return q, s


class Recommender:
    """Loaded model + precomputed corpus vectors, ready to answer requests.

    ``params`` is the port's state dict (``models/convert.py``:
    ``from_flax`` of JAX weights, ``load_params`` of a checkpoint, or a
    seeded model's ``state_dict()``)."""

    # score_many pads every request group to this batch size
    BATCH_PAD = 32
    # corpus tables over-allocate in blocks of this many rows on add_news
    GROW_BLOCK = 256

    def __init__(
        self,
        cfg: Config,
        dataset: RecDataset,
        params: Mapping[str, torch.Tensor],
        candidate_widths: Sequence[int] = (8, 16, 32, 64, 300),
        corpus_cache: str = "native",
        vectors_file: Optional[str] = None,
        mesh=None,
        device: Optional[str | torch.device] = None,
    ):
        if corpus_cache not in ("native", "int8"):
            raise ValueError(f"corpus_cache must be native|int8, "
                             f"got {corpus_cache!r}")
        if device is None and mesh is not None:
            device = mesh.devices.flat[0]
        self.device = resolve_device(device)
        self.mesh = mesh
        # the devices of the cache's row blocks (the mesh's first axis)
        self._block_devices = ([resolve_device(d) for d in mesh.devices[:, 0]]
                               if mesh is not None else [self.device])
        self.block_rows = 0
        self.cfg = cfg
        self.model_cfg = cfg.model.with_artifact_meta(dataset.meta)
        self.news_feats = {k: torch.as_tensor(v, device=self.device)
                           for k, v in dataset.news.as_dict().items()}
        self.model = build_model(self.model_cfg,
                                 {k: tuple(v.shape) for k, v in self.news_feats.items()})
        if not self.model.TWO_TOWER:
            raise ValueError(
                f"model family '{cfg.model.name}' has user-conditioned news "
                "vectors (TWO_TOWER=False) and cannot serve from a cached "
                "corpus table; score per request with the Trainer's full forward")
        assign(self.model, params)
        self.model.to(self.device).eval()
        self.H = cfg.data.history_len
        self.data_cfg = cfg.data
        # preprocessing dictionaries (word/category/... -> 1-based id), for
        # tokenizing news that were not in the corpus
        self.dicts = dataset.dicts
        self.widths = tuple(sorted(candidate_widths))
        self.corpus_cache = corpus_cache
        self._cd = getattr(torch, self.model_cfg.compute_dtype)

        n = dataset.news.n_news
        vecs = q = scale = None
        if vectors_file is not None:
            # precomputed table from the same weights; skips the corpus encode
            with np.load(vectors_file) as z:
                if "news_q" in z.files:
                    if corpus_cache != "int8":
                        raise ValueError("vectors_file holds an int8 table; pass "
                                         "corpus_cache='int8' to serve from it")
                    q = torch.as_tensor(z["news_q"], device=self.device)
                    scale = torch.as_tensor(z["news_scale"], device=self.device)
                    n_file = q.shape[0]
                else:
                    vecs = torch.as_tensor(z["news_vectors"], device=self.device)
                    n_file = vecs.shape[0]
            if n_file != n:
                raise ValueError(f"vectors_file has {n_file} rows, dataset "
                                 f"has {n} news")
        else:
            vecs = self._encode_corpus(n, cfg.train.eval_encode_chunk)

        if vecs is not None and corpus_cache == "int8":
            (q, scale), vecs = _quantize(vecs), None
        # each cache table as a list of row blocks, one per block device
        self.vec_blocks, self.q_blocks, self.scale_blocks = (
            None if t is None else self._split(t) for t in (vecs, q, scale))
        self.n_news = int(n)   # real news count; tables may be over-allocated

    @torch.no_grad()
    def _encode_corpus(self, n: int, chunk: int) -> torch.Tensor:
        """The news tower over ids ``0..n-1``, ``chunk`` at a time; the last
        chunk is zero-padded (id 0 is the all-pad news). A
        ``CORPUS_LEVELWISE`` family (GNN) encodes level by level, as its
        eval does (``corpus_encode_levelwise``)."""
        if self.model.CORPUS_LEVELWISE:
            return corpus_encode_levelwise(
                self.model, {k: v[:n] for k, v in self.news_feats.items()}, chunk)
        outs = []
        for s in range(0, n, chunk):
            ids = torch.zeros(chunk, dtype=torch.int32, device=self.device)
            e = min(s + chunk, n)
            ids[:e - s] = torch.arange(s, e, dtype=torch.int32, device=self.device)
            outs.append(self.model.encode_news_ids(ids, self.news_feats))
        return torch.cat(outs)[:n]

    @classmethod
    def from_checkpoint(cls, ckpt_dir, dataset: RecDataset, **kw) -> "Recommender":
        """Config + weights from a checkpoint directory of
        ``train/checkpoint.py`` (its best step) or a flat weights directory
        (``config.json`` + ``params.npz``)."""
        return cls(load_config(ckpt_dir), dataset, load_params(params_file(ckpt_dir)), **kw)

    def _split(self, table: torch.Tensor) -> list:
        """``table`` zero-padded to a multiple of the block count and cut
        into contiguous row blocks, block ``i`` on the ``i``-th block device
        (sets :attr:`block_rows`)."""
        n = len(self._block_devices)
        pad = (-table.shape[0]) % n
        if pad:
            table = torch.cat([table, table.new_zeros((pad,) + tuple(table.shape[1:]))])
        self.block_rows = table.shape[0] // n
        return [b.to(d) for b, d in zip(table.split(self.block_rows), self._block_devices)]

    def _joined(self, blocks: Optional[list]) -> Optional[torch.Tensor]:
        """The whole table of ``blocks`` on this recommender's device."""
        if blocks is None:
            return None
        return blocks[0] if len(blocks) == 1 else torch.cat([b.to(self.device) for b in blocks])

    @property
    def news_vecs(self) -> Optional[torch.Tensor]:
        """The float corpus table (``None`` with an int8 cache)."""
        return self._joined(self.vec_blocks)

    @property
    def news_q(self) -> Optional[torch.Tensor]:
        """The int8 corpus table (``None`` with a native cache)."""
        return self._joined(self.q_blocks)

    @property
    def news_scale(self) -> Optional[torch.Tensor]:
        """The int8 table's per-row scales (``None`` with a native cache)."""
        return self._joined(self.scale_blocks)

    def _take(self, blocks: list, ids: torch.Tensor) -> torch.Tensor:
        """The rows ``ids`` of a table in row blocks, each gathered from its
        block, on this recommender's device."""
        R = self.block_rows
        out = None
        for b, blk in enumerate(blocks):
            rows = blk[(ids - b * R).clamp(0, R - 1).to(blk.device)].to(self.device)
            if out is None:
                out = rows
                continue
            mine = (ids // R == b).reshape(ids.shape + (1,) * (rows.ndim - ids.ndim))
            out = torch.where(mine, rows, out)
        return out

    def _lookup(self, ids: torch.Tensor) -> torch.Tensor:
        """Cached corpus rows for ``ids`` (dequantized when int8)."""
        ids = ids.long()
        if self.corpus_cache == "int8":
            return (self._take(self.q_blocks, ids).float()
                    * self._take(self.scale_blocks, ids)).to(self._cd)
        return self._take(self.vec_blocks, ids)

    # ---- request paths ----
    def _pad_history(self, history: Sequence[int]) -> np.ndarray:
        h = np.zeros(self.H, np.int32)
        hist = [int(x) for x in history][-self.H:]
        h[self.H - len(hist):] = hist
        return h

    def _width_for(self, n: int) -> int:
        for w in self.widths:
            if n <= w:
                return w
        return self.widths[-1]

    @torch.no_grad()
    def _score(self, browsed: np.ndarray, cand: np.ndarray,
               users: np.ndarray) -> np.ndarray:
        """``[B, H]`` histories x ``[B, w]`` candidates of the ``[B]`` users
        -> ``[B, w]`` scores (``RecModel.score_from_vecs`` with the
        cache-mode lookup; the batch carries ``user_ids`` for heads that
        read them, as LSTUR's long-term vector, and the resident feature
        tables go along, for heads that gather by id, as HieRec's
        categories)."""
        b = torch.as_tensor(browsed, device=self.device)
        c = torch.as_tensor(cand, device=self.device)
        u = torch.as_tensor(np.asarray(users, np.int32), device=self.device)
        s = self.model.score_impression({"browsed_ids": b, "candidate_ids": c,
                                         "user_ids": u},
                                        b, c, self._lookup(b), self._lookup(c),
                                        self.news_feats)
        return s.cpu().numpy()

    def score(self, history: Sequence[int], candidates: Sequence[int],
              user_id: int = 0) -> np.ndarray:
        """Scores for an explicit candidate list of user ``user_id`` (0:
        unknown)."""
        w = self._width_for(len(candidates))
        cand = np.zeros(w, np.int32)
        cand[:len(candidates)] = np.asarray(candidates[:w], np.int32)
        return self._score(self._pad_history(history)[None], cand[None],
                           np.asarray([user_id], np.int32))[0][:len(candidates)]

    def score_many(
        self,
        requests: Sequence[tuple[Sequence[int], Sequence[int], int]],
    ) -> list[np.ndarray]:
        """Scores many ``(history, candidates, user_id)`` requests: grouped
        by candidate-width bucket, each group padded to :attr:`BATCH_PAD`
        rows (chunked when larger), one user-tower pass per group."""
        out: list = [None] * len(requests)
        groups: Dict[int, list] = {}
        for i, (hist, cands, uid) in enumerate(requests):
            groups.setdefault(self._width_for(len(cands)), []).append(i)
        B = self.BATCH_PAD
        for w, idxs in groups.items():
            for s0 in range(0, len(idxs), B):
                chunk = idxs[s0:s0 + B]
                browsed = np.zeros((B, self.H), np.int32)
                cand = np.zeros((B, w), np.int32)
                users = np.zeros(B, np.int32)
                for j, i in enumerate(chunk):
                    hist, cands, uid = requests[i]
                    browsed[j] = self._pad_history(hist)
                    cand[j, :len(cands)] = np.asarray(cands[:w], np.int32)
                    users[j] = uid
                s = self._score(browsed, cand, users)
                for j, i in enumerate(chunk):
                    out[i] = s[j, :len(requests[i][1])]
        return out

    @property
    def ranks_corpus(self) -> bool:
        """Whether the family has a user tower over the cached vectors
        alone (``encode_user``), which ``top_k`` ranks the corpus with."""
        return hasattr(self.model, "encode_user")

    @torch.no_grad()
    def top_k(self, history: Sequence[int], k: int = 10):
        """Corpus-wide retrieval: ``(ids, scores)`` of the ``k`` best news,
        the pad row 0 and rows at or past ``n_news`` excluded. Needs a
        family whose user tower runs over the cached vectors alone
        (``encode_user``); LSTUR and Fastformer have none, and raise, as the
        JAX package's ``top_k`` fails for them."""
        if not self.ranks_corpus:
            raise ValueError(
                f"model family '{self.cfg.model.name}' has no user tower that ranks "
                "the corpus from the cached vectors alone (encode_user); top_k "
                "serves dot-product families with one")
        b = torch.as_tensor(self._pad_history(history)[None], device=self.device)
        user_vec = self.model.encode_user(self._lookup(b), (b != 0).float()).float()
        blocks = self.q_blocks if self.corpus_cache == "int8" else self.vec_blocks
        scales = self.scale_blocks or [None] * len(blocks)
        # each block's top-k on its device, merged by score, ties to the lower id
        parts = [self._top_of(user_vec, b * self.block_rows, t, s, k)
                 for b, (t, s) in enumerate(zip(blocks, scales))]
        if len(parts) > 1:
            scores = torch.cat([s.to(self.device) for s, _ in parts], dim=1)
            ids = torch.cat([i.to(self.device) for _, i in parts], dim=1)
            by_id = torch.argsort(ids, dim=1)
            scores, ids = scores.gather(1, by_id), ids.gather(1, by_id)
            best = torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :k]
            parts = [(scores.gather(1, best), ids.gather(1, best))]
        # one block needs no merge: its top-k is the corpus's
        scores, ids = parts[0]
        return ids[0].cpu().numpy(), scores[0].cpu().numpy()

    def _top_of(self, user_vec: torch.Tensor, start: int, table: torch.Tensor,
                scale: Optional[torch.Tensor], k: int):
        """``(scores, ids)`` of the ``k`` best rows of the cache's row block
        that starts at row ``start``, on its device, the int8 rows times
        their ``scale``: the pad row 0 and rows at or past ``n_news``
        excluded."""
        scores = user_vec.to(table.device) @ table.float().T
        if scale is not None:
            scores = scores * scale[:, 0][None]
        rows = start + torch.arange(scores.shape[1], device=table.device)[None]
        scores = scores.masked_fill((rows < 1) | (rows >= self.n_news), -torch.inf)
        top_scores, top = torch.topk(scores, min(k, scores.shape[1]))
        return top_scores, top + start

    # ---- fresh-news ingestion ----
    def tokenize_new_news(self, title: str, abstract: str = "",
                          category: str = "", subcategory: str = "",
                          entities: Sequence[str] = ()) -> Dict[str, np.ndarray]:
        """Feature rows for a news item not in the corpus, with the persisted
        preprocessing dictionaries and the pipeline's tokenization."""
        if not self.dicts or "word" not in self.dicts:
            raise ValueError(
                "dataset has no persisted dictionaries (dicts.json); fresh "
                "news cannot be tokenized")
        from pytorch_news_recommender_tpu_torch.data import mind
        d = self.data_cfg
        word = self.dicts["word"]
        ent_dict = self.dicts.get("entity", {})
        eids = [e for e in (ent_dict.get(q, 0) for q in entities) if e][:d.entity_nums]
        ent = np.zeros(d.entity_nums, np.int32)
        ent[:len(eids)] = eids
        rows = {
            "title": np.asarray(mind._to_ids(title, word, d.n_words_title), np.int32),
            "abst": np.asarray(mind._to_ids(abstract, word, d.n_words_abst), np.int32),
            "categ": np.int32(self.dicts.get("category", {}).get(category, 0)),
            "subcateg": np.int32(self.dicts.get("subcategory", {}).get(subcategory, 0)),
            "entity": ent,
        }
        if "neighbors" in self.news_feats:
            # a fresh item has no graph edges yet: the all-pad neighborhood,
            # which the GNN encodes as an isolated node; edges come with the
            # next offline graph build
            rows["neighbors"] = np.zeros(self.news_feats["neighbors"].shape[1], np.int32)
        return rows

    def _fresh_rows(self, title: str, abstract: str, category: str, subcategory: str,
                    entities: Sequence[str]) -> Dict[str, np.ndarray]:
        """A fresh item's feature rows; raises, as the JAX package does,
        for a family that encodes news from precomputed vectors (``bert``)
        and for features that tokenization cannot build."""
        keys = self.model.FEAT_KEYS
        if "bert" in keys:
            raise ValueError(
                f"model family '{self.cfg.model.name}' encodes news from "
                "precomputed per-news vectors; fresh news needs an external "
                "vector, not tokenization")
        rows = self.tokenize_new_news(title, abstract, category, subcategory, entities)
        missing = [k for k in keys if k not in rows]
        if missing:
            raise ValueError(f"cannot build features {missing} for a fresh "
                             f"news item (family '{self.cfg.model.name}')")
        return rows

    @torch.no_grad()
    def _encode_rows(self, rows: Dict[str, np.ndarray]) -> torch.Tensor:
        feats = {k: torch.as_tensor(rows[k], device=self.device)[None]
                 for k in self.model.FEAT_KEYS}
        return self.model.encode_news_feats(feats)[0]

    def encode_new_news(self, title: str, abstract: str = "",
                        category: str = "", subcategory: str = "",
                        entities: Sequence[str] = ()) -> np.ndarray:
        """News-tower vector ``[D]`` (float32) for a fresh news item."""
        rows = self._fresh_rows(title, abstract, category, subcategory, entities)
        return self._encode_rows(rows).float().cpu().numpy()

    def _grown_blocks(self, blocks: list, nid: int, row) -> list:
        """Row blocks with ``row`` at ``nid``, written in place; when the
        blocks are full, they are joined, grown by GROW_BLOCK rows and split
        again."""
        if nid >= sum(b.shape[0] for b in blocks):
            return self._split(self._grown(self._joined(blocks), nid, row))
        blk, r = divmod(nid, self.block_rows)
        blocks[blk][r] = torch.as_tensor(row, dtype=blocks[blk].dtype,
                                         device=blocks[blk].device)
        return blocks

    def _grown(self, table: torch.Tensor, nid: int, row) -> torch.Tensor:
        """``table`` with ``row`` at ``nid``, grown by GROW_BLOCK rows when
        full. Writes in place when there is room."""
        if nid >= table.shape[0]:
            pad = table.new_zeros((self.GROW_BLOCK,) + tuple(table.shape[1:]))
            table = torch.cat([table, pad])
        table[nid] = torch.as_tensor(row, dtype=table.dtype, device=table.device)
        return table

    def add_news(self, title: str, abstract: str = "", category: str = "",
                 subcategory: str = "", entities: Sequence[str] = ()) -> int:
        """Ingests a fresh news item: tokenize, encode through the news
        tower, append to the corpus cache and the resident feature tables.
        Returns the new id, usable in ``score``/``top_k`` at once."""
        rows = self._fresh_rows(title, abstract, category, subcategory, entities)
        vec = self._encode_rows(rows)
        nid = self.n_news
        if self.corpus_cache == "int8":
            q, s = _quantize(vec)
            self.q_blocks = self._grown_blocks(self.q_blocks, nid, q)
            self.scale_blocks = self._grown_blocks(self.scale_blocks, nid, s)
        else:
            self.vec_blocks = self._grown_blocks(self.vec_blocks, nid, vec)
        for k in list(self.news_feats):
            if k in rows:
                self.news_feats[k] = self._grown(self.news_feats[k], nid, rows[k])
        if self.dicts is not None and "news" in self.dicts:
            self.dicts["news"][f"__fresh_{nid}"] = nid
        self.n_news = nid + 1
        return nid
