"""GNN: message passing over a precomputed news-news graph with an
attention readout (port of the JAX package's ``models/gnn.py``).

* news graph: the dataset's ``neighbors [N, K]`` table (row 0 the pad news,
  id 0 a missing neighbor);
* news tower: NRMS's title tower (:class:`NewsEncoder`, the fused encoder
  kernels on the card) for a news and its neighbors, then ``gnn_layers``
  rounds of :class:`GATLayer`, deepest first;
* user tower: NRMS's (:class:`UserEncoder`) over the clicked-news vectors;
  dot-product scoring.

Three encodes give the same vectors:

* the frontier form (``loader.add_gnn_frontier`` on a dedup batch, which
  ``Trainer`` attaches): each title of the batch's neighborhood closure is
  encoded once, then the GAT layers run level by level over position
  gathers;
* the recursive form (``encode_news_ids``, direct batches): the ``1 + K +
  ... + K^depth`` titles under each news;
* the levelwise corpus encode of eval and serving
  (``models.common.corpus_encode_levelwise``: ``encode_title_ids``, then
  ``gat_chunk`` per layer).

A fresh news item (``encode_news_feats``) is an isolated node. Neighbor
titles' lengths are not checked by the host's length split, so
``LENGTH_SPLIT_OK`` is False.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_news_recommender_tpu_torch.config import ModelConfig
from pytorch_news_recommender_tpu_torch.models.common import Batch, RecModel
from pytorch_news_recommender_tpu_torch.models.layers import (
    Dense, NewsEncoder, UserEncoder, _xavier_uniform,
)
from pytorch_news_recommender_tpu_torch.ops.attention import NEG_INF, dot_product_scores


class GATLayer(nn.Module):
    """One round of neighborhood aggregation with additive edge attention:
    ``wq``, ``wk`` ``[D, D]`` and ``a`` ``[2D, 1]`` (Xavier-uniform), the
    ``gate`` a Dense ``[2D, D]``; logits ``leaky_relu([q | k_j] · a)``,
    softmax over the real neighbors (0 where there is none), the gated sum
    ``g·self + (1 − g)·agg``, in the compute dtype."""

    def __init__(self, model_dim: int, compute_dtype: torch.dtype):
        super().__init__()
        D = model_dim
        self.wq = nn.Parameter(torch.empty(D, D))
        self.wk = nn.Parameter(torch.empty(D, D))
        self.a = nn.Parameter(torch.empty(2 * D, 1))
        self.gate = Dense(2 * D, D, compute_dtype)
        self.compute_dtype = compute_dtype

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.a):
            _xavier_uniform(w, generator)
        self.gate.reset_parameters(generator)

    def forward(self, self_vecs: torch.Tensor, neigh_vecs: torch.Tensor,
                neigh_mask: torch.Tensor) -> torch.Tensor:
        """``self_vecs [..., D]``, ``neigh_vecs [..., K, D]``, ``neigh_mask
        [..., K]`` (1 = a real neighbor) -> ``[..., D]``."""
        cd = self.compute_dtype
        D = self_vecs.shape[-1]
        s, n = self_vecs.to(cd), neigh_vecs.to(cd)
        q = torch.matmul(s.float(), self.wq.to(cd).float()).to(cd)
        k = torch.matmul(n.float(), self.wk.to(cd).float()).to(cd)
        # [q | k_j] · a as q·a[:D] + k_j·a[D:], one rounding of the f32 sum
        a = self.a.to(cd).float()[:, 0]
        logits = (torch.matmul(q.float(), a[:D])[..., None]
                  + torch.matmul(k.float(), a[D:])).to(cd)
        logits = F.leaky_relu(logits, 0.01).float()
        real = neigh_mask > 0
        att = torch.softmax(torch.where(real, logits, NEG_INF), dim=-1)
        att = att * real.any(dim=-1, keepdim=True)
        agg = torch.matmul(att.to(cd).float()[..., None, :], n.float())[..., 0, :].to(cd)
        gate = torch.sigmoid(self.gate(torch.cat([s, agg], dim=-1)))
        return gate * s + (1 - gate) * agg


class GNNRec(RecModel):
    """Graph-enhanced NRMS title tower + attention-readout user tower."""

    FEAT_KEYS = ("title", "neighbors")
    LENGTH_SPLIT_OK = False
    WANTS_GNN_FRONTIER = True
    CORPUS_LEVELWISE = True

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        cd = getattr(torch, cfg.compute_dtype)
        self.news_encoder = NewsEncoder(
            n_words=cfg.n_words, word_embed_size=cfg.word_embed_size,
            num_heads=cfg.num_attention_heads, query_dim=cfg.query_vector_dim,
            compute_dtype=cd, dropout=cfg.dropout,
            freeze_embeddings=cfg.freeze_word_embeddings,
            embedding_lookup=cfg.embedding_lookup,
            a2a_capacity_factor=cfg.a2a_capacity_factor)
        self.n_gat = max(1, cfg.gnn_layers)
        # Flax's names: gat0, gat1, ...
        for i in range(self.n_gat):
            self.add_module(f"gat{i}", GATLayer(cfg.word_embed_size, cd))
        self.user_encoder = UserEncoder(
            model_dim=cfg.word_embed_size, num_heads=cfg.user_heads_num,
            query_dim=cfg.query_vector_dim, compute_dtype=cd)

    @property
    def gat_layers(self) -> list:
        return [getattr(self, f"gat{i}") for i in range(self.n_gat)]

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.news_encoder.reset_parameters(generator)
        for layer in self.gat_layers:
            layer.reset_parameters(generator)
        self.user_encoder.reset_parameters(generator)

    def encode_user(self, browsed_vecs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """``[B, H, D]`` clicked-news vectors -> ``[B, D]`` user vector."""
        return self.user_encoder(browsed_vecs, mask)

    # ---- the frontier form ----
    def forward(self, batch: Batch, news_feats: Batch, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if "gnn_frontier_ids" not in batch:
            return super().forward(batch, news_feats, deterministic, generator)
        self.aux_losses = {}
        uvecs = self._encode_frontier(batch, news_feats, deterministic, generator)
        unique_ids = batch["unique_ids"]
        b_idx, c_idx = batch["browsed_idx"].long(), batch["candidate_idx"].long()
        return self.score_impression(batch, unique_ids[b_idx], unique_ids[c_idx],
                                     F.embedding(b_idx, uvecs), F.embedding(c_idx, uvecs),
                                     news_feats, deterministic)

    def _encode_frontier(self, batch: Batch, news_feats: Batch, deterministic: bool,
                         generator: Optional[torch.Generator]) -> torch.Tensor:
        """Titles once for the whole closure, then the GAT layers level by
        level with position gathers -> ``[U, D]``. Level ``l`` holds
        garbage at nodes deeper than ``depth - l`` (their neighbors outside
        the closure are masked), which no shallower level gathers."""
        fids = batch["gnn_frontier_ids"].long()                  # [F]
        nbr_pos = batch["gnn_nbr_pos"].long()                    # [F, K]
        titles = self.news_encoder(news_feats["title"][fids], deterministic, generator)
        mask = (fids[nbr_pos] != 0).float()
        h = titles
        for layer in reversed(self.gat_layers):
            h = layer(titles, F.embedding(nbr_pos, h), mask)
        return h[batch["gnn_self_pos"].long()]

    # ---- the levelwise corpus encode ----
    def encode_title_ids(self, ids: torch.Tensor, news_feats: Batch,
                         deterministic: bool = True) -> torch.Tensor:
        """The title tower alone (level 0)."""
        return self.news_encoder(news_feats["title"][ids.long()], deterministic)

    def gat_chunk(self, ids: torch.Tensor, titles_tab: torch.Tensor,
                  h_prev: torch.Tensor, news_feats: Batch, layer_idx: int) -> torch.Tensor:
        """GAT layer ``layer_idx`` for a chunk of news ids, the neighbors'
        vectors gathered by id from the whole previous level ``h_prev``."""
        ids = ids.long()
        neigh = news_feats["neighbors"][ids].long() * (ids != 0)[..., None]
        return self.gat_layers[layer_idx](titles_tab[ids], h_prev[neigh],
                                          (neigh != 0).float())

    # ---- the recursive form ----
    def encode_news_ids(self, ids: torch.Tensor, news_feats: Batch,
                        deterministic: bool = True, feat_trunc=None,
                        generator: Optional[torch.Generator] = None) -> torch.Tensor:
        titles, neighbors = news_feats["title"], news_feats["neighbors"]
        layers = self.gat_layers

        def node_repr(node_ids: torch.Tensor, depth: int) -> torch.Tensor:
            node_ids = node_ids.long()
            self_vecs = self.news_encoder(titles[node_ids], deterministic, generator)
            if depth == 0:
                return self_vecs
            # the pad news keeps an all-pad neighborhood
            neigh_ids = neighbors[node_ids].long() * (node_ids != 0)[..., None]
            neigh_vecs = node_repr(neigh_ids, depth - 1)
            return layers[len(layers) - depth](self_vecs, neigh_vecs,
                                               (neigh_ids != 0).float())

        return node_repr(ids, len(layers))

    def encode_news_feats(self, feats: Batch, deterministic: bool = True,
                          generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """A news item from its features alone (fresh news), as an isolated
        node: the title tower, then ``gat0`` over an empty neighborhood (its
        gate passes the self vector). For such a node every deeper level
        feeds only the masked-out aggregate, so this equals the levelwise
        encode of a news whose neighbor row is all pad. Any ``neighbors``
        in ``feats`` are ignored."""
        T = self.news_encoder(feats["title"], deterministic, generator)
        K = max(1, int(self.cfg.gnn_neighbors))
        zeros = T.new_zeros(T.shape[:-1] + (K, T.shape[-1]))
        mask = torch.zeros(T.shape[:-1] + (K,), device=T.device)
        return self.gat_layers[0](T, zeros, mask)

    def score_impression(self, batch, browsed_ids, cand_ids, browsed_vecs,
                         cand_vecs, news_feats=None,
                         deterministic: bool = True) -> torch.Tensor:
        user_vec = self.encode_user(browsed_vecs, (browsed_ids != 0).float())
        return dot_product_scores(user_vec, cand_vecs, cand_ids != 0)
