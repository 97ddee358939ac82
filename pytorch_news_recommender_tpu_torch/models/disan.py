"""DiSAN: a directional multi-dimensional self-attention news tower (port
of the JAX package's ``models/disan.py``, plain jnp there): plain PyTorch
around one hand-written pair of CUDA kernels, ``ops/disa.py``'s
``disa_pairs``, which on the card runs DiSA's token-pair chain, forward and
backward, without a pair tensor in device memory; on the CPU DiSA runs the
plain chain, :func:`disa_pairs_reference`, which autograd differentiates.

* :class:`DiSA`, one direction: ``rep = elu(fc(drop(x)))``; token-pair
  logits ``c·tanh((w1(rep') + w2(rep') + b1) / c)`` per hidden dimension
  with c = 5 (``rep'`` a second draw of ``drop(rep)``; the sum of the two
  products rounds in the compute dtype, then adds the float32 ``b1``, so the
  logits are float32, as in JAX); the strict upper (``fw``: j > i) or lower
  (``bw``) pair mask intersected with the token mask; the softmax over j
  within it; ``res = Σ_j att·rep`` (att rounded to the compute dtype,
  float32 sums, rounded back): that chain is ``disa_pairs`` (the kernels)
  or :func:`disa_pairs_reference` (plain, on the CPU); then the
  fusion gate ``sigmoid(wf1(drop(rep)) + wf2(drop(res)) + bf)`` blending
  ``rep`` and ``res``, zero on pad tokens. Its output is float32 (the
  float32 gate promotes it).
* :class:`Source2Token`: ``softmax`` over the tokens, per dimension, of
  ``fc2(drop(elu(fc1(drop(u)))))`` (masked), pooling ``u``.
* :class:`DiSANEncoder`: ``fw`` and ``bw`` concatenated, then Source2Token
  -> ``[..., 2·d_h]`` news vectors (float32), ``d_h = disan_hidden or
  word_embed_size``. Its spans (``utils/tracing.py``, on only while a
  profiler records): ``newsrec.disan.encoder`` around the tower's forward,
  holding ``newsrec.disan.fw``, ``.bw`` and ``.source2token``, and
  ``newsrec.disan.encoder.backward`` around its backward.
* :class:`DiSANRec`: that news tower, the fused encoder user tower at
  ``2·d_h`` (600 at the default widths: 10 heads of 60, query dim 200),
  dot-product scoring.

Every dropout is its own draw from the step's ``torch.Generator`` (another
stream than the JAX package's), so parity runs with dropout off. The pair
values, L² d_h per news and direction, are the tower's elementwise work:
the kernels keep them in registers and shared memory and recompute them in
the backward. The tower's twelve ``Dense`` products (``fc``, ``w1``,
``w2``, ``wf1``, ``wf2`` of each direction, Source2Token's ``fc1`` and
``fc2``) run on the card's tensor cores in bf16 with float32 sums, forward
and backward, so what is left of its device time is mostly the gates,
dropout draws and Source2Token's softmax and sums around them, and the
kernels' arithmetic (PERF.md §5).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_news_recommender_tpu_torch.config import ModelConfig
from pytorch_news_recommender_tpu_torch.models.common import Batch, RecModel
from pytorch_news_recommender_tpu_torch.models.layers import (
    Dense, UserEncoder, WordEmbedding, _draw, dropout,
)
from pytorch_news_recommender_tpu_torch.ops.attention import NEG_INF, dot_product_scores
from pytorch_news_recommender_tpu_torch.ops.disa import C_SCALE, direction_mask, disa_pairs
from pytorch_news_recommender_tpu_torch.utils import tracing


def disa_pairs_reference(dep, head, rep, rep_mask, b1, direction: str) -> torch.Tensor:
    """DiSA's pair chain in plain PyTorch, the CPU's route and the kernels'
    reference: ``dep``, ``head``, ``rep`` ``[..., L, d]`` in the compute
    dtype, ``rep_mask [..., L]``, ``b1 [d]`` float32 -> ``res`` ``[..., L,
    d]`` in the compute dtype. ``dep[j] + head[i]`` sums in the compute
    dtype, then adds the float32 ``b1``; the logits ``c·tanh(s/c)`` are
    float32; the softmax over j is float32 and per dimension, over the
    strict upper (``fw``) or lower (``bw``) triangle met with the token
    mask; ``att`` rounds to the compute dtype before the float32 sum over
    j, which rounds back."""
    cd = rep.dtype
    L = rep.shape[-2]
    # [B, i, j, d]: dep over j, head over i, summed in cd, then + f32 b1
    pre = (dep[..., None, :, :] + head[..., :, None, :]).float() + b1.float()
    logits = C_SCALE * torch.tanh(pre / C_SCALE)
    pair = direction_mask(L, direction, rep.device) & (rep_mask[..., None, :] > 0)  # [B, i, j]
    att = torch.softmax(torch.where(pair[..., None], logits, NEG_INF), dim=-2)
    att = (att * pair[..., None]).to(cd)
    return (att.float() * rep.float()[..., None, :, :]).sum(-2).to(cd)  # Σ_j


class DiSA(nn.Module):
    """One directional self-attention pass over ``x: [B, L, D]``."""

    def __init__(self, in_features: int, d_h: int, direction: str, rate: float,
                 compute_dtype: torch.dtype):
        super().__init__()
        if direction not in ("fw", "bw"):
            raise ValueError(f"direction must be fw|bw, got {direction!r}")
        cd = compute_dtype
        self.direction, self.rate, self.compute_dtype = direction, rate, cd
        self.fc = Dense(in_features, d_h, cd)
        self.w1 = Dense(d_h, d_h, cd, bias=False)
        self.w2 = Dense(d_h, d_h, cd, bias=False)
        self.wf1 = Dense(d_h, d_h, cd, bias=False)
        self.wf2 = Dense(d_h, d_h, cd, bias=False)
        self.b1 = nn.Parameter(torch.empty(d_h))
        self.bf = nn.Parameter(torch.empty(d_h))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in (self.fc, self.w1, self.w2, self.wf1, self.wf2):
            m.reset_parameters(generator)
        _draw(self.b1, torch.zeros_like)
        _draw(self.bf, torch.zeros_like)

    def forward(self, x: torch.Tensor, rep_mask: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cd = self.compute_dtype
        drop = lambda t: dropout(t, self.rate, deterministic, generator)  # noqa: E731
        rep = F.elu(self.fc(drop(x)))
        rep_dp = drop(rep)
        pairs = disa_pairs_reference if rep.device.type == "cpu" else disa_pairs
        res = pairs(self.w1(rep_dp), self.w2(rep_dp), rep, rep_mask, self.b1, self.direction)
        gate = torch.sigmoid(self.wf1(drop(rep)) + self.wf2(drop(res)) + self.bf.float())
        out = gate * rep + (1 - gate) * res
        return out * rep_mask[..., None].to(cd)


class Source2Token(nn.Module):
    """Per-dimension masked-softmax pooling over the tokens of ``x: [B, L,
    D]``."""

    def __init__(self, dim: int, rate: float, compute_dtype: torch.dtype):
        super().__init__()
        self.rate = rate
        self.fc1 = Dense(dim, dim, compute_dtype)
        self.fc2 = Dense(dim, dim, compute_dtype)
        self.compute_dtype = compute_dtype

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.fc1.reset_parameters(generator)
        self.fc2.reset_parameters(generator)

    def forward(self, x: torch.Tensor, rep_mask: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        drop = lambda t: dropout(t, self.rate, deterministic, generator)  # noqa: E731
        h = F.elu(self.fc1(drop(x)))
        valid = rep_mask[..., None] > 0
        logits = torch.where(valid, self.fc2(drop(h)).float(), NEG_INF)
        soft = torch.softmax(logits, dim=-2) * valid
        return (x * soft.to(self.compute_dtype)).sum(-2)


class DiSANEncoder(nn.Module):
    """``fw`` and ``bw`` DiSA, concatenated, pooled by Source2Token ->
    ``[B, 2·d_h]``."""

    def __init__(self, in_features: int, d_h: int, rate: float,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.fw = DiSA(in_features, d_h, "fw", rate, compute_dtype)
        self.bw = DiSA(in_features, d_h, "bw", rate, compute_dtype)
        self.source2token = Source2Token(2 * d_h, rate, compute_dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in (self.fw, self.bw, self.source2token):
            m.reset_parameters(generator)

    def forward(self, x: torch.Tensor, rep_mask: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        with tracing.span("newsrec.disan.encoder"):
            x, leave = tracing.backward_span("newsrec.disan.encoder.backward", x, self.fw.b1)
            with tracing.span("newsrec.disan.fw"):
                f = self.fw(x, rep_mask, deterministic, generator)
            with tracing.span("newsrec.disan.bw"):
                b = self.bw(x, rep_mask, deterministic, generator)
            with tracing.span("newsrec.disan.source2token"):
                out = self.source2token(torch.cat([f, b], dim=-1), rep_mask, deterministic,
                                        generator)
            return leave(out)


class DiSANRec(RecModel):
    """DiSAN news tower + attention user tower + dot-product scoring."""

    FEAT_KEYS = ("title",)

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        cd = getattr(torch, cfg.compute_dtype)
        self.d_h = cfg.disan_hidden or cfg.word_embed_size
        self.word_embedding = WordEmbedding(cfg.n_words, cfg.word_embed_size, cd,
                                            trainable=not cfg.freeze_word_embeddings,
                                            embedding_lookup=cfg.embedding_lookup,
                                            a2a_capacity_factor=cfg.a2a_capacity_factor)
        self.disan = DiSANEncoder(cfg.word_embed_size, self.d_h, cfg.dropout, cd)
        self.user_encoder = UserEncoder(2 * self.d_h, cfg.user_heads_num,
                                        cfg.query_vector_dim, cd)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in (self.word_embedding, self.disan, self.user_encoder):
            m.reset_parameters(generator)

    def encode_user(self, browsed_vecs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """``[B, H, 2·d_h]`` clicked-news vectors -> ``[B, 2·d_h]``."""
        return self.user_encoder(browsed_vecs, mask)

    def encode_news_feats(self, feats: Batch, deterministic: bool = True,
                          generator: Optional[torch.Generator] = None) -> torch.Tensor:
        ids = feats["title"]
        mask = (ids != 0).float()
        x = self.word_embedding(ids, mask)
        *lead, L, D = x.shape
        out = self.disan(x.reshape(-1, L, D), mask.reshape(-1, L), deterministic, generator)
        return out.reshape(*lead, 2 * self.d_h)

    def score_impression(self, batch, browsed_ids, cand_ids, browsed_vecs,
                         cand_vecs, news_feats=None,
                         deterministic: bool = True) -> torch.Tensor:
        user_vec = self.encode_user(browsed_vecs, (browsed_ids != 0).float())
        return dot_product_scores(user_vec, cand_vecs, cand_ids != 0)
