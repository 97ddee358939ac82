"""NPA: neural news recommendation with personalized attention (Wu et al.,
KDD 2019; port of the JAX package's ``models/npa.py``), in plain PyTorch,
as it is plain jnp there: the family reaches no kernel.

* a 50-d user-id embedding (``PadEmbedding``; id 0 and a batch without
  ``user_ids`` get the zero row) gives two personalized queries, each a
  Dense + ReLU of ``npa_query_dim`` (``query_vector_dim // 2`` when 0);
* news tower: word embedding -> dropout -> LSTUR's ``Conv1d`` -> ReLU ->
  dropout, pooled by :class:`PersonalizedAttention` under the word query;
* user tower: the clicked-news vectors pooled under the news query;
  dot-product scoring.

The news vectors depend on the user, so ``TWO_TOWER`` is False: eval
scores every batch in full, and the ``Recommender`` refuses the family,
as the JAX one does. A dedup batch encodes the user-independent prefix
(embedding and CNN) once per distinct news and gathers the ``[.., L, F]``
token maps back per slot for the pooling; no length split.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_news_recommender_tpu_torch.config import ModelConfig
from pytorch_news_recommender_tpu_torch.models.common import Batch, RecModel
from pytorch_news_recommender_tpu_torch.models.layers import (
    Dense, PadEmbedding, WordEmbedding, _draw, _xavier_uniform, dropout,
)
from pytorch_news_recommender_tpu_torch.models.lstur import Conv1d
from pytorch_news_recommender_tpu_torch.ops.attention import NEG_INF, dot_product_scores


class PersonalizedAttention(nn.Module):
    """Additive attention whose query is a per-sample vector: ``w [D, Q]``
    (Xavier-uniform), ``b [Q]`` (zeros); ``softmax(tanh(xW + b) · query)``
    pools ``x``."""

    def __init__(self, in_features: int, query_dim: int, compute_dtype: torch.dtype):
        super().__init__()
        self.w = nn.Parameter(torch.empty(in_features, query_dim))
        self.b = nn.Parameter(torch.empty(query_dim))
        self.compute_dtype = compute_dtype

    def reset_parameters(self, generator: torch.Generator) -> None:
        _xavier_uniform(self.w, generator)
        _draw(self.b, torch.zeros_like)

    def forward(self, x: torch.Tensor, query: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``x [..., L, D]``, ``query [..., Q]`` (leading dims broadcast
        against x's), ``mask [..., L]`` -> ``[..., D]`` in x's dtype."""
        cd = self.compute_dtype
        proj = torch.tanh(torch.matmul(x.to(cd).float(), self.w.to(cd).float()) + self.b)
        scores = torch.matmul(proj, query.float()[..., :, None])[..., 0]
        if mask is not None:
            scores = torch.where(mask > 0, scores, NEG_INF)
        wts = torch.softmax(scores, dim=-1)
        return torch.matmul(wts.to(x.dtype).float()[..., None, :],
                            x.float())[..., 0, :].to(x.dtype)


class NPA(RecModel):
    """CNN news tower and user tower, both pooled by personalized queries."""

    FEAT_KEYS = ("title",)
    TWO_TOWER = False          # news vectors are user-conditioned
    LENGTH_SPLIT_OK = False    # its dedup path keeps the full token maps

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        cd = self.compute_dtype = getattr(torch, cfg.compute_dtype)
        q = cfg.npa_query_dim or max(cfg.query_vector_dim // 2, 1)
        self.user_embedding = PadEmbedding(max(cfg.n_users, 1), 50, cd)
        # no dtype in the JAX Dense: a bf16 input with f32 weights runs in f32
        self.word_query = Dense(50, q, torch.float32)
        self.news_query = Dense(50, q, torch.float32)
        self.word_embedding = WordEmbedding(cfg.n_words, cfg.word_embed_size, cd,
                                            trainable=not cfg.freeze_word_embeddings)
        self.title_cnn = Conv1d(cfg.word_embed_size, cfg.num_filters, cfg.kernel_size, cd)
        self.word_pa = PersonalizedAttention(cfg.num_filters, q, cd)
        self.news_pa = PersonalizedAttention(cfg.num_filters, q, cd)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in (self.user_embedding, self.word_query, self.news_query, self.word_embedding,
                  self.title_cnn, self.word_pa, self.news_pa):
            m.reset_parameters(generator)

    def _token_maps(self, title_ids: torch.Tensor, deterministic: bool,
                    generator: Optional[torch.Generator]) -> torch.Tensor:
        """The user-independent prefix: word embedding -> dropout -> CNN ->
        ReLU -> dropout, ``[..., L]`` ids -> ``[..., L, F]``."""
        drop = lambda t: dropout(t, self.cfg.dropout, deterministic, generator)  # noqa: E731
        mask = (title_ids != 0).float()
        x = drop(self.word_embedding(title_ids, mask))
        *lead, L, D = x.shape
        h = F.relu(self.title_cnn(x.reshape(-1, L, D)))
        return drop(h.reshape(*lead, L, h.shape[-1]))

    def _queries(self, batch: Batch, B: int, device: torch.device):
        uid = batch.get("user_ids")
        if uid is None:
            uid = torch.zeros(B, dtype=torch.int32, device=device)
        u = self.user_embedding(uid)                                   # [B, 50]
        return F.relu(self.word_query(u)), F.relu(self.news_query(u))

    def forward(self, batch: Batch, news_feats: Batch, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        self.aux_losses = {}
        titles = news_feats["title"]
        if "unique_ids" in batch:
            unique_ids = batch["unique_ids"]
            b_idx, c_idx = batch["browsed_idx"].long(), batch["candidate_idx"].long()
            h_u = self._token_maps(titles[unique_ids.long()], deterministic, generator)
            browsed_ids, cand_ids = unique_ids[b_idx], unique_ids[c_idx]
            browsed_h, cand_h = h_u[b_idx], h_u[c_idx]
        else:
            browsed_ids, cand_ids = batch["browsed_ids"], batch["candidate_ids"]
            Hn = browsed_ids.shape[1]
            h = self._token_maps(titles[torch.cat([browsed_ids, cand_ids], dim=1).long()],
                                 deterministic, generator)            # [B, H+S, L, F]
            browsed_h, cand_h = h[:, :Hn], h[:, Hn:]
        qw, qd = self._queries(batch, browsed_ids.shape[0], browsed_ids.device)
        # word masks per slot, from the title table
        b_wmask = (titles[browsed_ids.long()] != 0).float()           # [B, H, L]
        c_wmask = (titles[cand_ids.long()] != 0).float()
        browsed_vecs = self.word_pa(browsed_h, qw[:, None, :], b_wmask)
        cand_vecs = self.word_pa(cand_h, qw[:, None, :], c_wmask)
        user_vec = self.news_pa(browsed_vecs, qd, (browsed_ids != 0).float())
        return dot_product_scores(user_vec, cand_vecs, cand_ids != 0)
