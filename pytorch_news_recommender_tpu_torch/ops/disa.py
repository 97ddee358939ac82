"""DiSA's token-pair chain: the per-dimension directional self-attention of
the DiSAN news tower (``models/disan.py``), from ``w1``'s and ``w2``'s
products to ``res = Σ_j att_ij·rep_j``, and its backward.

Replaces no TPU kernel: the JAX package's DiSA is plain jnp. The Hopper
kernels are ``csrc/disa.cu`` (forward, and backward); its header says what
bounds them and how they keep every pair value on chip.

* :func:`disa_pairs` and :func:`disa_pairs_bwd` are the wrappers, for CUDA
  tensors only: any other device is refused, and there is no fallback from
  a kernel to a plain version. The plain forward, with the rounding points
  the kernels keep, is ``models/disan.py``'s ``disa_pairs_reference``:
  ``DiSA.forward`` runs it on the CPU, where autograd differentiates it as
  the JAX package's parity tests expect.
* :func:`disa_pairs_bwd_reference` is the plain backward of the kernel's
  function, the equations of ``disa_pairs_bwd``'s kernel.
* :class:`DisaPairs` is the autograd ``Function`` (kernel forward, kernel
  backward); it saves its inputs only, never a pair tensor.
  :func:`disa_pairs` takes that route on a CUDA tensor whenever autograd
  records, and launches the forward kernel alone otherwise.

One documented difference from the plain forward: a pad query row
(``rep_mask[i] == 0``) gives ``res = 0`` in the kernel, where the plain
chain gives it a value that DiSA's output mask zeroes; every gradient
through such a row is 0 either way. Only real rows of ``res`` are
comparable. The kernels build with the port's others at their first launch
(``ops/kernels.py``); importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from pytorch_news_recommender_tpu_torch.ops import kernels as K

C_SCALE = 5.0   # DiSA's non-trainable logit scale
_i, _p, _lg = ctypes.c_int, ctypes.c_void_p, ctypes.c_long
_max_len = K.declare("newsrec_disa_max_len", [])
_fwd = K.declare("newsrec_disa_fwd", [_i, _i] + [_p] * 6 + [_lg, _i, _i, _p])
_bwd = K.declare("newsrec_disa_bwd", [_i, _i] + [_p] * 10 + [_lg, _i, _i, _p])
# where the plain chain runs instead, the end of the wrappers' refusal
_ELSEWHERE = " (models/disan.py runs the plain chain, disa_pairs_reference, elsewhere)"


def _is_fw(direction: str) -> bool:
    if direction not in ("fw", "bw"):
        raise ValueError(f"direction must be fw|bw, got {direction!r}")
    return direction == "fw"


def direction_mask(L: int, direction: str, device) -> torch.Tensor:
    """``[L, L]`` (query i, key j): j > i for ``fw``, j < i for ``bw``."""
    ar = torch.arange(L, device=device)
    return ar[None, :] > ar[:, None] if _is_fw(direction) else ar[None, :] < ar[:, None]


# ---- plain backward ---------------------------------------------------------

def disa_pairs_bwd_reference(g, dep, head, rep, rep_mask, b1, direction: str
                             ) -> Tuple[torch.Tensor, ...]:
    """Plain version of :func:`disa_pairs_bwd`: the backward of the
    kernel's forward (pad query rows give 0) from ``g = dres [..., L, d]``
    -> ``(ddep, dhead, drep, db1)``, the first three in the compute dtype,
    ``db1 [d]`` float32. With ``a`` the unrounded softmax and ``t`` the
    tanh: ``drep[j] = Σ_i T(a_ij)·g_i``, ``ds_ij = a_ij·g_i·(rep[j] − r_i)
    ·(1 − t_ij²)`` with ``r_i = Σ_k a_ik·rep[k]``, ``dhead[i] = Σ_j ds_ij``,
    ``ddep[j] = Σ_i ds_ij``, ``db1 = Σ ds``, all in float32."""
    cd = rep.dtype
    L = rep.shape[-2]
    real = rep_mask > 0
    pre = (dep[..., None, :, :] + head[..., :, None, :]).float() + b1.float()
    t = torch.tanh(pre / C_SCALE)
    pair = direction_mask(L, direction, rep.device) & real[..., None, :] & real[..., :, None]
    e = torch.where(pair[..., None], torch.exp(C_SCALE * t), 0.0)
    total = e.sum(-2, keepdim=True)
    a = torch.where(total > 0, e / total.clamp_min(1e-30), 0.0)   # [.., i, j, d]
    r32 = rep.float()[..., None, :, :]
    r = (a * r32).sum(-2, keepdim=True)                          # [.., i, 1, d]
    gi = g.float()[..., :, None, :]
    drep = (a.to(cd).float() * gi).sum(-3)
    ds = a * gi * (r32 - r) * (1.0 - t * t)
    db1 = ds.reshape(-1, ds.shape[-1]).sum(0)
    return ds.sum(-3).to(cd), ds.sum(-2).to(cd), drep.to(cd), db1


# ---- wrappers ---------------------------------------------------------------

def max_len() -> int:
    """The longest item (``L``) the kernels take (builds the library; needs
    ``nvcc``)."""
    return _max_len()


def _prepare(tensors, rep_mask, b1):
    """The row operands as contiguous ``[M, L, d]``, the mask as float32
    ``[M, L]`` and ``b1`` as float32, checked against what the kernels
    take."""
    rep = tensors[-1]
    if rep.dtype not in K.DTYPE_CODE:
        raise TypeError(f"DiSA's pair kernels take float32 or bfloat16, got {rep.dtype}")
    *lead, L, d = rep.shape
    for t in tensors:
        if tuple(t.shape) != tuple(rep.shape) or t.dtype != rep.dtype or t.device != rep.device:
            raise ValueError(f"the row operands must all be {tuple(rep.shape)} {rep.dtype} "
                             f"on {rep.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    if tuple(rep_mask.shape) != (*lead, L) or rep_mask.device != rep.device:
        raise ValueError(f"rep_mask must be {(*lead, L)} on {rep.device}, got "
                         f"{tuple(rep_mask.shape)} on {rep_mask.device}")
    if tuple(b1.shape) != (d,) or b1.device != rep.device:
        raise ValueError(f"b1 must be [{d}] on {rep.device}, got {tuple(b1.shape)}")
    if L > max_len():
        raise ValueError(f"DiSA's pair kernels take items of at most "
                         f"{max_len()} tokens, got L={L}")
    rows = [t.reshape(-1, L, d).contiguous() for t in tensors]
    mask = rep_mask.reshape(-1, L).to(torch.float32).contiguous()
    return rows, mask, b1.detach().to(torch.float32).contiguous()


def _forward(dep, head, rep, rep_mask, b1, direction):
    """The forward kernel on CUDA tensors: ``res`` in ``rep``'s shape."""
    fw = _is_fw(direction)
    shape = rep.shape
    (dep, head, rep), mask, b1 = _prepare((dep, head, rep), rep_mask, b1)
    M, L, d = rep.shape
    res = torch.empty_like(rep)
    if M > 0 and d > 0:
        K.launch(_fwd, K.DTYPE_CODE[rep.dtype], int(fw), dep.data_ptr(), head.data_ptr(),
                 rep.data_ptr(), mask.data_ptr(), b1.data_ptr(), res.data_ptr(), M, L, d,
                 device=rep.device, what="DiSA pair kernel", counter=disa_pairs)
    return res.reshape(shape)


def disa_pairs(dep, head, rep, rep_mask, b1, direction: str) -> torch.Tensor:
    """``res = Σ_j att_ij·rep_j`` of one DiSA direction: ``dep = w1(rep')``,
    ``head = w2(rep')`` and ``rep`` ``[..., L, d]`` in the compute dtype
    (float32 or bfloat16) on a CUDA card, ``rep_mask [..., L]``, ``b1 [d]``
    float32 -> ``[..., L, d]`` in the compute dtype, with the rounding
    points of ``models/disan.py``'s ``disa_pairs_reference``.

    While autograd records and an input requires grad, the call goes
    through :class:`DisaPairs` (kernel forward and backward); otherwise the
    forward kernel launches alone. A pad query row gives 0 (the module
    docstring)."""
    _is_fw(direction)
    K.require_cuda(rep, "DiSA pair kernel", _ELSEWHERE)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (dep, head, rep, b1)):
        return DisaPairs.apply(dep, head, rep, rep_mask, b1, direction)
    return _forward(dep, head, rep, rep_mask, b1, direction)


def disa_pairs_bwd(g, dep, head, rep, rep_mask, b1, direction: str
                   ) -> Tuple[torch.Tensor, ...]:
    """Backward of :func:`disa_pairs` from ``g = dres`` (``rep``'s shape):
    ``(ddep, dhead, drep, db1)``, the first three in the compute dtype and
    ``db1 [d]`` float32. The kernel recomputes the softmax from the inputs
    and writes each item's column sums of ``ds``; ``db1`` is their sum over
    the items, a reduction without atomics, so two calls give the same
    bits."""
    K.require_cuda(rep, "DiSA pair backward kernel", _ELSEWHERE)
    fw = _is_fw(direction)
    shape = rep.shape
    (g, dep, head, rep), mask, b1 = _prepare(
        (g.to(rep.dtype), dep, head, rep), rep_mask, b1)
    M, L, d = rep.shape
    ddep, dhead, drep = (torch.empty_like(rep) for _ in range(3))
    part = torch.empty((M, d), dtype=torch.float32, device=rep.device)
    if M > 0 and d > 0:
        K.launch(_bwd, K.DTYPE_CODE[rep.dtype], int(fw), g.data_ptr(),
                 dep.data_ptr(), head.data_ptr(), rep.data_ptr(), mask.data_ptr(),
                 b1.data_ptr(), ddep.data_ptr(), dhead.data_ptr(), drep.data_ptr(),
                 part.data_ptr(), M, L, d, device=rep.device,
                 what="DiSA pair backward kernel", counter=disa_pairs_bwd)
    return ddep.reshape(shape), dhead.reshape(shape), drep.reshape(shape), part.sum(0)


# Launches of each kernel since its count was last set to 0: one forward
# per direction and encode call, one backward per direction and training
# encode.
disa_pairs.launches = 0
disa_pairs_bwd.launches = 0


# ---- autograd ---------------------------------------------------------------

class DisaPairs(torch.autograd.Function):
    """Kernel forward, kernel backward; saves the inputs only. The mask and
    the direction get no gradient; ``db1`` is returned in ``b1``'s dtype."""

    @staticmethod
    def forward(ctx, dep, head, rep, rep_mask, b1, direction):
        ctx.save_for_backward(dep, head, rep, rep_mask, b1)
        ctx.direction = direction
        return _forward(dep, head, rep, rep_mask, b1, direction)

    @staticmethod
    def backward(ctx, g):
        dep, head, rep, rep_mask, b1 = ctx.saved_tensors
        ddep, dhead, drep, db1 = disa_pairs_bwd(g, dep, head, rep, rep_mask, b1,
                                                ctx.direction)
        return ddep, dhead, drep, None, db1.to(b1.dtype), None
