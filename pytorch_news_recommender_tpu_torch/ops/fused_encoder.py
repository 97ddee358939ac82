"""Fused news encoder: QKV -> multi-head attention -> output projection ->
(dropout) -> additive-attention pooling, ``[M, L, D] -> [M, D]``, and its
backward.

Replaces the TPU kernels of the JAX package's ``ops/pallas/fused_encoder.py``:
``_encoder_kernel`` (forward, with in-kernel dropout and the ``o1``
residual), ``_encoder_bwd_kernel`` (backward) and the in-kernel dropout mask
(``_interp_dropout_bits`` / ``host_dropout_keep``), plus the custom-VJP glue
``_make_diff_encoder``. The Hopper kernels are ``csrc/fused_encoder.cu``
(forward) and ``csrc/fused_encoder_bwd.cu`` (backward and weight
gradients); their headers say what bounds them and how they are laid out.

* :func:`fused_news_encoder`, :func:`fused_news_encoder_bwd` and
  :func:`weight_grad` are the wrappers. A tensor on the CPU goes to the
  plain version; a CUDA tensor goes to the kernel, or the call raises. There
  is no fallback from a kernel to its plain version.
* :func:`fused_news_encoder_reference`, :func:`fused_news_encoder_bwd_reference`
  and :func:`weight_grad_reference` are the plain versions, with the TPU
  kernel's rounding points (the forward is the ``ops/attention.py`` chain).
* :class:`FusedNewsEncoder` is the autograd ``Function`` (kernel forward
  with ``save_o1``, kernel backward); :func:`fused_news_encoder_diff` calls
  it on a CUDA tensor and the plain forward, which autograd differentiates,
  on the CPU. :func:`fused_news_encoder` takes that route on a CUDA tensor
  whenever autograd records (and launches the forward kernel alone
  otherwise), so no CUDA call returns an output without a gradient node.
* :func:`engine` names the engine of the kernels' weight products at a
  shape (``wgmma`` for bfloat16 at tiles of at most 64 rows, else
  ``mma.sync``); ``fused_news_encoder.wgmma_launches`` and
  ``fused_news_encoder_bwd.wgmma_launches`` count the launches that took
  ``wgmma``, beside ``launches``.
* :func:`dropout_keep` is the dropout mask: a murmur3-finalizer hash of
  ``(seed + block, row in block, column)`` over the TPU kernel's block
  geometry, equal bit for bit to the JAX package's ``host_dropout_keep``.
  The CUDA kernels compute the same hash per element.
* :func:`shard_seed` folds the rank of a data-parallel run into a dropout
  seed, ``seed + rank * SHARD_SEED_STRIDE``, as the JAX package's sharded
  encoder folds ``axis_index`` (``_make_sharded_diff_encoder``): each rank
  drops out its own rows with its own mask, forward and backward alike.
* The kernels build with the port's others at their first launch
  (``ops/kernels.py``); nothing is built when this module is imported.

One documented difference from the plain forward, inherited from the TPU
kernel: a news item whose tokens are all pad pools to **0** and gets zero
gradients (the plain version returns the mean of its rows), so only pooled
rows of items with at least one real token are comparable. Every row of the
``o1`` residual, pad-token rows included, is the plain version's up to
rounding: the forward kernel keeps each row's attention within its item.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from pytorch_news_recommender_tpu_torch.ops import attention as A
from pytorch_news_recommender_tpu_torch.ops.kernels import (
    DTYPE_CODE, MAX_SMEM, declare, launch, require_cuda,
)

_i, _p, _lg, _fl = ctypes.c_int, ctypes.c_void_p, ctypes.c_long, ctypes.c_float
# seed, rows per block, threshold, keep scale
_DROPOUT = [ctypes.c_uint32, _i, ctypes.c_uint32, _fl]
_fwd = declare("newsrec_fused_encoder_fwd",
               [_i] + [_p] * 13 + [_i] * 5 + [_fl] + _DROPOUT + [_p])
_bwd = declare("newsrec_fused_encoder_bwd",
               [_i] + [_p] * 20 + [_i] * 5 + [_fl] + _DROPOUT + [_p])
_weight_grad = declare("newsrec_weight_grad", [_i, _p, _lg, _p, _lg, _lg, _i, _i, _i, _p, _p, _p])
_weight_grad_splits = declare("newsrec_weight_grad_splits", [_lg, _i, _i])
_fwd_ws_elems = declare("newsrec_fused_encoder_fwd_ws_elems", [_i] * 3, _lg)
_bwd_ws_elems = declare("newsrec_fused_encoder_bwd_ws_elems", [_i] * 3, _lg)
_fwd_o2_elems = declare("newsrec_fused_encoder_fwd_o2_elems", [_i, _lg, _i, _i, _i, _i], _lg)
_fwd_smem = declare("newsrec_fused_encoder_smem_bytes", [_i] * 5, _lg)
_bwd_smem = declare("newsrec_fused_encoder_bwd_smem_bytes", [_i] * 5, _lg)
_variant = declare("newsrec_fused_encoder_variant", [_i] * 5)
_variant_name = declare("newsrec_fused_encoder_variant_name", [_i], ctypes.c_char_p)
_engine = declare("newsrec_fused_encoder_engine", [_i] * 5)
_TILE = [_i, ctypes.POINTER(_i), ctypes.POINTER(_i)]
_fwd_tile = declare("newsrec_fused_encoder_fwd_tile", _TILE, None)
_bwd_tile = declare("newsrec_fused_encoder_bwd_tile", _TILE, None)


# ---- dropout mask -----------------------------------------------------------

# the per-rank dropout-seed stride of the JAX package's sharded encoder
SHARD_SEED_STRIDE = 1_000_003


def shard_seed(seed: int, rank: int) -> int:
    """``seed + rank * SHARD_SEED_STRIDE`` modulo 2^32 (rank 0 leaves
    ``seed`` as it is)."""
    return (int(seed) + int(rank) * SHARD_SEED_STRIDE) & 0xFFFFFFFF


def _block_geometry(L: int, block_news: int = 64, max_rows: int = 1280) -> int:
    """News per block of the TPU kernel (its ``_block_geometry(L)[0]`` with
    the default packing). The dropout hash counts rows within such a block,
    so the mask depends on it."""
    under = [p for p in range(1, 256 // L + 1)
             if (p * L) % 8 == 0 and p * L <= 128]
    over = [p for p in range(1, 256 // L + 1)
            if (p * L) % 8 == 0 and p * L <= 256]
    P = max(under) if under else (min(over) if over else 1)
    step = P * 8 // math.gcd(P, 8)
    target = min(block_news, max(1, max_rows // L))
    return step * max(1, target // step)


def _dropout_threshold(rate: float) -> int:
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    return int(rate * (2 ** 32))


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``a * c mod 2^32`` for int64 ``a`` in [0, 2^32), without overflow."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & 0xFFFFFFFF


def dropout_keep(seed: int, M: int, L: int, D: int, rate: float,
                 device: Optional[torch.device] = None) -> torch.Tensor:
    """The ``[M, L, D]`` bool keep mask that the kernels apply to the
    projected attention output for ``seed``: keep where the hash of ``(seed
    + block, row within the block, column)`` is at least ``rate * 2^32``,
    with blocks of ``_block_geometry(L) * L`` token rows."""
    thr = _dropout_threshold(rate)
    rows_per_block = _block_geometry(L) * L
    g = torch.arange(M * L, dtype=torch.int64, device=device)
    row = (g % rows_per_block)[:, None]
    sv = ((int(seed) + g // rows_per_block) & 0xFFFFFFFF)[:, None]
    col = torch.arange(D, dtype=torch.int64, device=device)[None, :]
    x = _mul32(row, 0x9E3779B1) ^ _mul32(col, 0x85EBCA77) ^ _mul32(sv, 0xC2B2AE3D)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return (x >= thr).reshape(M, L, D)


# ---- plain versions ---------------------------------------------------------

def fused_news_encoder_reference(x, mask, wqkv, bqkv, wo, bo, aw, ab, aq, *,
                                 num_heads: int, dropout_rate: float = 0.0,
                                 seed: int = 0, save_o1: bool = False):
    """Plain PyTorch version: multi-head self-attention, inverted dropout
    with the :func:`dropout_keep` mask, then additive pooling, exactly as the
    JAX package's jnp chain computes them. With ``save_o1`` also returns the
    heads' output before the projection (``[M, L, D]``, ``x``'s dtype)."""
    o1 = A.self_attention_heads(x, wqkv, bqkv, num_heads, mask)
    h = A._mm32("...ld,de->...le", o1, wo).to(x.dtype) + bo
    if dropout_rate > 0.0:
        keep = dropout_keep(seed, *x.shape, dropout_rate, device=x.device)
        h = torch.where(keep, h * (1.0 / (1.0 - dropout_rate)), 0.0).to(x.dtype)
    out = A.additive_attention_with_weights(h, aw, ab, aq, mask)[0]
    return (out, o1) if save_o1 else out


def fused_news_encoder_bwd_reference(g, x, mask, o1, wqkv, bqkv, wo, bo, aw,
                                     ab, aq, *, num_heads: int,
                                     dropout_rate: float = 0.0, seed: int = 0):
    """Plain PyTorch version of the backward: the equations of the TPU
    kernel ``_encoder_bwd_kernel`` with its rounding points. ``g: [M, D]``
    is the cotangent of the pooled output; returns ``(dx, dwqkv, dbqkv, dwo,
    dbo, daw, dab, daq)``, ``dx`` in ``x``'s dtype and the weight gradients
    in float32. An item with no real token gets zero gradients."""
    T = x.dtype
    M, L, D = x.shape
    f = lambda t: t.float()  # noqa: E731
    valid = f(mask) > 0
    # pooling backward: o2 from the o1 residual, the mask regenerated
    o2 = f(o1) @ f(wo) + f(bo)
    keep_scale = None
    if dropout_rate > 0.0:
        keep = dropout_keep(seed, M, L, D, dropout_rate, device=x.device)
        keep_scale = torch.where(keep, 1.0 / (1.0 - dropout_rate), 0.0)
        o2 = o2 * keep_scale
    t = torch.tanh(f(o2.to(T)) @ f(aw) + f(ab))
    s = torch.where(valid, t @ f(aq), A.NEG_INF)
    s = s - s.amax(dim=-1, keepdim=True)
    e = torch.where(valid, torch.exp(s), 0.0)
    w = e / e.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    gf = f(g)[:, None, :]
    dw = (o2 * gf).sum(-1)
    ds = w * (dw - (w * dw).sum(-1, keepdim=True))
    daq = torch.einsum("mlq,ml->q", t, ds)
    dpre = ds[..., None] * f(aq) * (1.0 - t * t)
    daw = torch.einsum("mld,mlq->dq", o2, dpre)
    dab = dpre.sum((0, 1))
    do2 = w[..., None] * gf + dpre @ f(aw).T
    if keep_scale is not None:
        do2 = do2 * keep_scale
    dwo = torch.einsum("mld,mle->de", f(o1), do2)
    dbo = do2.sum((0, 1))
    do1 = (do2 @ f(wo).T).to(T)
    # attention backward: q, k, v and the probabilities recomputed
    dqkv = attention_bwd_reference(x, mask, do1, wqkv, bqkv, num_heads=num_heads)
    dwqkv = torch.einsum("mld,mle->de", f(x), dqkv)
    dbqkv = dqkv.sum((0, 1))
    dx = (dqkv @ f(wqkv).T).to(T)
    return dx, dwqkv, dbqkv, dwo, dbo, daw, dab, daq


def attention_bwd_reference(x, mask, do1, wqkv, bqkv, *, num_heads: int):
    """The attention part of :func:`fused_news_encoder_bwd_reference`, item
    by item: q, k, v and the probabilities recomputed from ``x``, then
    ``dqkv = [dq | dk | dv]`` (``[M, L, 3D]`` float32) from the heads'
    cotangent ``do1`` (``x``'s dtype), with the TPU kernel's rounding
    points."""
    T = x.dtype
    M, L, D = x.shape
    H = num_heads
    dh = D // H
    scale = 1.0 / math.sqrt(dh)
    f = lambda t: t.float()  # noqa: E731
    m = f(mask)
    qkv = f(x) @ f(wqkv) + f(bqkv)
    heads = lambda t: t.reshape(M, L, H, dh).transpose(1, 2)  # noqa: E731
    q = f(heads(qkv[..., :D] * scale).to(T))
    k = f(heads(qkv[..., D:2 * D]).to(T))
    v = f(heads(qkv[..., 2 * D:]).to(T))
    gh = f(heads(do1))
    pen = (m[:, None, :, None] * m[:, None, None, :] - 1.0) * 1e9
    sc = q @ k.transpose(-1, -2) + pen
    ea = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
    probs = ea / ea.sum(dim=-1, keepdim=True)
    dv = f(probs.to(T)).transpose(-1, -2) @ gh
    pdp = probs * (gh @ v.transpose(-1, -2))
    dsc = f((pdp - probs * pdp.sum(dim=-1, keepdim=True)).to(T))
    dq = (dsc @ k) * scale
    dk = dsc.transpose(-1, -2) @ q
    merge = lambda t: t.transpose(1, 2).reshape(M, L, D)  # noqa: E731
    dqkv = torch.cat([merge(dq), merge(dk), merge(dv)], dim=-1)
    return dqkv


def weight_grad_reference(a: Optional[torch.Tensor], b: torch.Tensor,
                          bias: bool = False):
    """Plain version of :func:`weight_grad`: ``aᵀ b`` in float32 (with
    ``bias``, also the column sums of ``b``), or the column sums of ``b``
    when ``a`` is None."""
    if a is None:
        return b.float().sum(0)
    prod = a.float().T @ b.float()
    return (prod, b.float().sum(0)) if bias else prod


# ---- checks -----------------------------------------------------------------

def _check(x, mask, weights, num_heads):
    if x.dtype not in DTYPE_CODE:
        raise TypeError(f"fused encoder takes float32 or bfloat16, got {x.dtype}")
    M, L, D = x.shape
    wqkv, bqkv, wo, bo, aw, ab, aq = weights
    Q = aw.shape[1]
    shapes = {"wqkv": (D, 3 * D), "bqkv": (3 * D,), "wo": (D, D), "bo": (D,),
              "aw": (D, Q), "ab": (Q,), "aq": (Q,)}
    for (name, shape), t in zip(shapes.items(), weights):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != x.dtype or t.device != x.device:
            raise TypeError(f"{name} is {t.dtype} on {t.device}; the kernel "
                            f"needs {x.dtype} on {x.device}")
    if tuple(mask.shape) != (M, L) or mask.device != x.device:
        raise ValueError(f"mask must be [{M}, {L}] on {x.device}, got "
                         f"{tuple(mask.shape)} on {mask.device}")
    dh = D // num_heads
    if D % num_heads or D % 4 or dh % 2 or Q % 4:
        raise ValueError(f"the kernels need D % heads == 0, D % 4 == 0, Q % 4 "
                         f"== 0 and an even head width; got D={D} H={num_heads} "
                         f"Q={Q}")
    return M, L, D, Q


def _dropout_args(seed: int, L: int, rate: float):
    thr = _dropout_threshold(rate)
    scale = 1.0 / (1.0 - rate) if rate > 0.0 else 1.0
    return [int(seed) & 0xFFFFFFFF, _block_geometry(L) * L, thr, scale]


def _prepare(x, mask, weights, num_heads, smem_fn):
    """Contiguous operands, checked against what the kernels take
    (``smem_fn`` is the library's shared-memory need of the kernels)."""
    weights = [t.contiguous() for t in weights]
    M, L, D, Q = _check(x, mask, weights, num_heads)
    x = x.contiguous()
    mask = mask.to(torch.float32).contiguous()
    smem = smem_fn(DTYPE_CODE[x.dtype], L, D, num_heads, Q)
    if smem > MAX_SMEM:
        raise ValueError(f"L={L} D={D} needs {smem} bytes of shared memory; "
                         f"one block has {MAX_SMEM}")
    if any(t.data_ptr() % 16 for t in (x, *weights)):
        raise ValueError("fused encoder operands must be 16-byte aligned")
    return x, mask, weights, (M, L, D, Q)


# ---- wrappers ---------------------------------------------------------------

def fused_news_encoder(x, mask, wqkv, bqkv, wo, bo, aw, ab, aq, *,
                       num_heads: int, dropout_rate: float = 0.0, seed: int = 0,
                       save_o1: bool = False):
    """``x: [M, L, D]`` embedded tokens (pad tokens zeroed), ``mask: [M, L]``
    validity, weights in ``x``'s dtype in Flax's layout -> ``[M, D]`` pooled
    news vectors in ``x``'s dtype. ``dropout_rate > 0`` drops the projected
    attention output with the :func:`dropout_keep` mask of ``seed`` (f32,
    before the pooling tanh). ``save_o1`` also returns the heads' output
    ``[M, L, D]`` in ``x``'s dtype, the backward's residual.

    On a CUDA tensor, while autograd records and an input requires grad,
    the call goes through :class:`FusedNewsEncoder`, so the output has a
    gradient node (``save_o1`` is then refused: the ``Function`` keeps the
    residual itself)."""
    weights = (wqkv, bqkv, wo, bo, aw, ab, aq)
    if x.device.type == "cpu":
        return fused_news_encoder_reference(
            x, mask, *weights, num_heads=num_heads, dropout_rate=dropout_rate,
            seed=seed, save_o1=save_o1)
    require_cuda(x, "fused encoder")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *weights)):
        if save_o1:
            raise ValueError("save_o1 returns the backward's residual, which "
                             "the autograd Function keeps itself")
        return fused_news_encoder_diff(x, mask, *weights, num_heads=num_heads,
                                       dropout_rate=dropout_rate, seed=seed)
    x, mask, weights, (M, L, D, Q) = _prepare(x, mask, weights, num_heads, _fwd_smem)
    out = torch.empty((M, D), dtype=x.dtype, device=x.device)
    # o1 goes through device memory between the attention and the tail
    # kernels whether or not the caller keeps it
    o1 = torch.empty((M, L, D), dtype=x.dtype, device=x.device)
    if M == 0:
        return (out, o1) if save_o1 else out
    ws = weight_scratch(x.dtype, D, num_heads, Q, x.device)
    o2 = o2_scratch(x.dtype, M, L, D, num_heads, Q, x.device)
    launch(_fwd, DTYPE_CODE[x.dtype], x.data_ptr(), mask.data_ptr(),
           *(t.data_ptr() for t in weights), out.data_ptr(), o1.data_ptr(), ws.data_ptr(),
           None if o2 is None else o2.data_ptr(),
           M, L, D, num_heads, Q, 1.0 / math.sqrt(D // num_heads),
           *_dropout_args(seed, L, dropout_rate), device=x.device, what="fused encoder",
           counter=fused_news_encoder, wgmma=_wgmma(x.dtype, L, D, num_heads, Q))
    return (out, o1) if save_o1 else out


def weight_grad(a: Optional[torch.Tensor], b: torch.Tensor, bias: bool = False):
    """``aᵀ b`` summed over rows in float32: ``a: [R, K]`` (float32 or
    bfloat16), ``b: [R, N]`` float32 -> ``[K, N]``; with ``bias`` also the
    column sums of ``b`` (``[N]``), from the same read of ``b``. With ``a``
    None, the column sums alone. On a CUDA tensor, the hand-written
    tensor-core kernel (bf16 high/low split, f32 sums) with a fixed split
    of the rows and a fixed-order sum of the splits, so the result does not
    change from run to run."""
    if b.device.type == "cpu":
        return weight_grad_reference(a, b, bias)
    require_cuda(b, "weight_grad")
    if b.dim() != 2 or b.dtype != torch.float32 or (a is not None and (
            a.dim() != 2 or a.dtype not in DTYPE_CODE or a.shape[0] != b.shape[0]
            or a.device != b.device)):
        raise TypeError("weight_grad takes a [R, K] float32/bfloat16 and a "
                        "[R, N] float32 on one device")
    R, N = b.shape
    K = 0 if a is None else a.shape[1]
    Kout = K + 1 if (bias or a is None) else K
    b = b.contiguous()
    a = None if a is None else a.contiguous()
    if a is not None and a.dtype == torch.bfloat16 and K % 2:
        raise ValueError(f"the kernel's copies need an even bfloat16 width, got K={K}")
    out = torch.empty((Kout, N), dtype=torch.float32, device=b.device)
    if Kout and N:
        splits = _weight_grad_splits(R, Kout, N)
        partial = (torch.empty((splits, Kout, N), dtype=torch.float32, device=b.device)
                   if splits > 1 else None)
        launch(_weight_grad, -1 if a is None else DTYPE_CODE[a.dtype],
               None if a is None else a.data_ptr(), K, b.data_ptr(), N, R, K,
               int(bias), N, None if partial is None else partial.data_ptr(),
               out.data_ptr(), device=b.device, what="weight_grad", counter=weight_grad)
    if a is None:
        return out[0]
    return (out[:K], out[K]) if bias else out


def variant(dtype: torch.dtype, L: int, D: int, H: int, Q: int) -> Tuple[str, ...]:
    """The names of the wide variants that the kernels take at these
    shapes, as the built library chooses and names them (``tiles.cuh``'s
    ``kVar*``): none wherever each kernel's layout fits one block (builds
    the library; needs ``nvcc``)."""
    bits = _variant(DTYPE_CODE[dtype], L, D, H, Q)
    names, i = [], 0
    while (name := _variant_name(i)) is not None:
        if bits >> i & 1:
            names.append(name.decode())
        i += 1
    return tuple(names)


def _wgmma(dtype, L, D, H, Q) -> bool:
    return bool(_engine(DTYPE_CODE[dtype], L, D, H, Q))


def engine(dtype: torch.dtype, L: int, D: int, H: int, Q: int) -> str:
    """The engine of the per-item kernels' weight products at these shapes,
    as the built library chooses it (``tiles.cuh``'s ``wgmma_engine``):
    ``"wgmma"`` for bfloat16 and tiles of at most 64 rows, else
    ``"mma.sync"`` (builds the library; needs ``nvcc``)."""
    return "wgmma" if _wgmma(dtype, L, D, H, Q) else "mma.sync"


def _tile(fn, L: int) -> Tuple[int, int]:
    items, rows = ctypes.c_int(), ctypes.c_int()
    fn(L, ctypes.byref(items), ctypes.byref(rows))
    return items.value, rows.value


def fwd_tile(L: int) -> Tuple[int, int]:
    """Whole items per block of the forward's kernels at item length
    ``L``, and the block's token rows, as the built kernels take them
    (builds the library; needs ``nvcc``)."""
    return _tile(_fwd_tile, L)


def bwd_tile(L: int) -> Tuple[int, int]:
    """Whole items per block of the backward's pooling and attention
    kernels at item length ``L``, and the block's token rows, as the built
    kernels take them (builds the library; needs ``nvcc``)."""
    return _tile(_bwd_tile, L)


def weight_scratch(dtype, D: int, H: int, Q: int, device, backward: bool = False):
    """Room for the weights as the forward's kernels (with ``backward``, the
    backward's) read them: bf16, f32 weights as high and low parts, written
    once per launch. The stage ablation takes the forward's layout too."""
    parts = 2 if dtype == torch.float32 else 1
    elems = (_bwd_ws_elems if backward else _fwd_ws_elems)(D, H, Q)
    return torch.empty(parts * elems, dtype=torch.bfloat16, device=device)


def o2_scratch(dtype, M: int, L: int, D: int, H: int, Q: int, device) -> Optional[torch.Tensor]:
    """The forward tail's f32 ``o2`` rows in device memory where it takes
    its wide variant at these shapes, else None."""
    elems = _fwd_o2_elems(DTYPE_CODE[dtype], M, L, D, H, Q)
    return torch.empty(elems, dtype=torch.float32, device=device) if elems else None


def bwd_per_item(g, x, mask, o1, weights, num_heads, dropout_rate, seed):
    """The backward's per-item kernels (pooling, attention, dx) on a CUDA
    tensor: ``dx``, the contiguous ``x`` and ``o1``, and the f32
    intermediates the weight gradients read (o2, t, dpre, do2, d(logit),
    dqkv, each ``[M*L, *]``)."""
    x, mask, weights, (M, L, D, Q) = _prepare(x, mask, weights, num_heads, _bwd_smem)
    if tuple(o1.shape) != (M, L, D) or o1.dtype != x.dtype or tuple(g.shape) != (M, D):
        raise ValueError(f"o1 must be [{M}, {L}, {D}] {x.dtype} and g [{M}, {D}]")
    g = g.to(torch.float32).contiguous()
    o1 = o1.contiguous()
    dev = x.device
    R = M * L
    empty = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)  # noqa: E731
    dx = torch.empty_like(x)
    # per-token intermediates in device memory, read by the weight gradients
    o2_s, t_s, dpre_s, do2_s = empty(R, D), empty(R, Q), empty(R, Q), empty(R, D)
    ds_s, dqkv_s = empty(R, 1), empty(R, 3 * D)
    do1_s = torch.empty((R, D), dtype=x.dtype, device=dev)
    ws = weight_scratch(x.dtype, D, num_heads, Q, dev, backward=True)
    if M > 0:
        launch(_bwd, DTYPE_CODE[x.dtype], g.data_ptr(), x.data_ptr(), mask.data_ptr(),
               o1.data_ptr(), *(t.data_ptr() for t in weights), dx.data_ptr(),
               o2_s.data_ptr(), t_s.data_ptr(), dpre_s.data_ptr(),
               do2_s.data_ptr(), ds_s.data_ptr(), dqkv_s.data_ptr(),
               do1_s.data_ptr(), ws.data_ptr(),
               M, L, D, num_heads, Q,
               1.0 / math.sqrt(D // num_heads),
               *_dropout_args(seed, L, dropout_rate), device=dev,
               what="fused encoder backward", counter=fused_news_encoder_bwd,
               wgmma=_wgmma(x.dtype, L, D, num_heads, Q))
    return dx, x, o1, (o2_s, t_s, dpre_s, do2_s, ds_s, dqkv_s)


def fused_news_encoder_bwd(g, x, mask, o1, wqkv, bqkv, wo, bo, aw, ab, aq, *,
                           num_heads: int, dropout_rate: float = 0.0,
                           seed: int = 0) -> Tuple[torch.Tensor, ...]:
    """Backward of :func:`fused_news_encoder` from its ``o1`` residual:
    ``g: [M, D]`` -> ``(dx, dwqkv, dbqkv, dwo, dbo, daw, dab, daq)`` (``dx``
    in ``x``'s dtype, weight gradients float32). ``dropout_rate`` and
    ``seed`` must be the forward's: the mask is regenerated, not stored."""
    weights = (wqkv, bqkv, wo, bo, aw, ab, aq)
    if x.device.type == "cpu":
        return fused_news_encoder_bwd_reference(
            g, x, mask, o1, *weights, num_heads=num_heads,
            dropout_rate=dropout_rate, seed=seed)
    require_cuda(x, "fused encoder backward")
    dx, x, o1, (o2_s, t_s, dpre_s, do2_s, ds_s, dqkv_s) = bwd_per_item(
        g, x, mask, o1, weights, num_heads, dropout_rate, seed)
    R, D = dqkv_s.shape[0], x.shape[-1]
    # four weight-gradient launches, the bias gradients with their products
    dwqkv, dbqkv = weight_grad(x.reshape(R, D), dqkv_s, bias=True)
    dwo, dbo = weight_grad(o1.reshape(R, D), do2_s, bias=True)
    daw, dab = weight_grad(o2_s, dpre_s, bias=True)
    return dx, dwqkv, dbqkv, dwo, dbo, daw, dab, weight_grad(t_s, ds_s)[:, 0]


# Launches of each kernel since its count was last set to 0; of #1's and
# #2's, those whose weight products ran on wgmma (engine()).
fused_news_encoder.launches = fused_news_encoder.wgmma_launches = 0
fused_news_encoder_bwd.launches = fused_news_encoder_bwd.wgmma_launches = 0
weight_grad.launches = 0


# ---- autograd ---------------------------------------------------------------

class FusedNewsEncoder(torch.autograd.Function):
    """Kernel forward with the ``o1`` residual, kernel backward (the port of
    ``_make_diff_encoder``). The mask gets no gradient and the seed is not
    differentiable; the weight gradients are returned in the weights' dtype
    (the compute dtype), and flow on through the cast to the float32
    parameters."""

    @staticmethod
    def forward(ctx, x, mask, wqkv, bqkv, wo, bo, aw, ab, aq, seed, dropout_rate,
                num_heads):
        out, o1 = fused_news_encoder(x, mask, wqkv, bqkv, wo, bo, aw, ab, aq,
                                     num_heads=num_heads, dropout_rate=dropout_rate,
                                     seed=seed, save_o1=True)
        ctx.save_for_backward(x, mask, o1, wqkv, bqkv, wo, bo, aw, ab, aq)
        ctx.seed, ctx.rate, ctx.heads = seed, dropout_rate, num_heads
        return out

    @staticmethod
    def backward(ctx, g):
        x, mask, o1, *weights = ctx.saved_tensors
        dx, *dw = fused_news_encoder_bwd(g, x, mask, o1, *weights,
                                         num_heads=ctx.heads,
                                         dropout_rate=ctx.rate, seed=ctx.seed)
        return (dx, None, *(d.reshape(w.shape).to(w.dtype)
                            for d, w in zip(dw, weights)), None, None, None)


def fused_news_encoder_diff(x, mask, wqkv, bqkv, wo, bo, aw, ab, aq, *,
                            num_heads: int, dropout_rate: float = 0.0,
                            seed: int = 0) -> torch.Tensor:
    """Differentiable encoder ``[M, L, D] -> [M, D]``: on a CUDA tensor
    :class:`FusedNewsEncoder` (kernel forward with the ``o1`` residual,
    kernel backward); on the CPU the plain forward, which autograd
    differentiates (so CPU training follows the JAX package's jnp chain,
    all-pad items included)."""
    weights = (wqkv, bqkv, wo, bo, aw, ab, aq)
    if x.device.type == "cpu":
        return fused_news_encoder_reference(x, mask, *weights, num_heads=num_heads,
                                            dropout_rate=dropout_rate, seed=seed)
    require_cuda(x, "fused encoder")
    return FusedNewsEncoder.apply(x, mask, *weights, int(seed),
                                  float(dropout_rate), num_heads)
