"""Stage-by-stage ablation of the fused news encoder's forward: six
truncations of it, timed one against another to show where the forward's
time goes.

Replaces the TPU kernel ``build`` of the JAX package's
``benchmarks/ablate_encoder.py`` (its six bodies ``k_passthrough``,
``k_qkv``, ``k_attn``, ``k_tail``, ``k_attn_slices``,
``k_attn_nosoftmax``). The Hopper kernels are ``csrc/ablate_encoder.cu``,
built into the port's one library (``fused_encoder._lib``); its header says
what each stage computes, what bounds it and how it is laid out.

* :func:`ablate_encoder` is the wrapper: a tensor on the CPU goes to the
  plain version, a CUDA tensor to the kernel, or the call raises.
* :func:`ablate_encoder_reference` is the plain version, with the TPU
  kernel's rounding points: ``qkv`` in float32, rounding to ``x``'s dtype at
  ``q`` (or the attention output) and at the output, float32 sums.

Inputs use the harness's layout: ``x2 [M·L, D]``, ``maskf [M·L, 1]``
float32, ``wqkv [D, 3D]``, ``bqkv [1, 3D]``, ``wo [D, D]``, ``bo [1, D]``,
``aw [D, Q]``, ``ab [1, Q]``, ``aq [Q, 1]``, weights in ``x``'s dtype, at the
harness's ``L`` = 20 tokens per item and ``H`` = 10 heads. The output is
``[M, D]`` in ``x``'s dtype.
"""

from __future__ import annotations

import math

import torch

from pytorch_news_recommender_tpu_torch.ops import fused_encoder as FE

L, H = 20, 10        # tokens per item, heads (the harness's)
BM = 64              # items per grid step of the TPU kernel: M must be a multiple
SUB = 160            # rows of an attention subtile (8 items)
STAGES = ("passthrough", "qkv", "attn", "tail", "attn_slices", "attn_nosoftmax")


def _check(stage, x2, maskf, weights):
    """(M, D, Q), after checking the harness's layout."""
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {STAGES}, got {stage!r}")
    if x2.dim() != 2 or x2.dtype not in FE._DTYPE_CODE:
        raise TypeError(f"x2 must be [M·L, D] float32 or bfloat16, got "
                        f"{tuple(x2.shape)} {x2.dtype}")
    rows, D = x2.shape
    if rows % (BM * L):
        raise ValueError(f"x2 has {rows} rows: the ablation takes M·{L} rows with M a "
                         f"multiple of {BM}, as the TPU kernel's grid of M // {BM} steps does")
    Q = weights[4].shape[-1]
    shapes = {"wqkv": (D, 3 * D), "bqkv": (1, 3 * D), "wo": (D, D), "bo": (1, D),
              "aw": (D, Q), "ab": (1, Q), "aq": (Q, 1)}
    for (name, shape), t in zip(shapes.items(), weights):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != x2.dtype or t.device != x2.device:
            raise TypeError(f"{name} is {t.dtype} on {t.device}; expected {x2.dtype} "
                            f"on {x2.device}")
    if tuple(maskf.shape) != (rows, 1) or maskf.device != x2.device:
        raise ValueError(f"maskf must be [{rows}, 1] on {x2.device}, got "
                         f"{tuple(maskf.shape)} on {maskf.device}")
    dh = D // H
    if D % H or D % 4 or dh % 2 or dh > 32 or Q % 4:
        raise ValueError(f"the kernels need D % {H} == 0, D % 4 == 0, Q % 4 == 0 and an "
                         f"even head width of at most 32; got D={D} Q={Q}")
    return rows // L, D, Q


def _pool(o, M, T):
    """``T(Σ_l T(o_l))`` per item: the TPU kernel's indicator product."""
    return o.to(T).float().reshape(M, L, -1).sum(1).to(T)


def ablate_encoder_reference(stage, x2, maskf, wqkv, bqkv, wo, bo, aw, ab, aq):
    """Plain PyTorch version of :func:`ablate_encoder`."""
    M, D, _ = _check(stage, x2, maskf, (wqkv, bqkv, wo, bo, aw, ab, aq))
    T, f = x2.dtype, (lambda t: t.float())  # noqa: E731
    if stage == "passthrough":
        return f(x2).reshape(M, L, D).sum(1).to(T)
    qkv = f(x2) @ f(wqkv) + f(bqkv)
    q, k, v = qkv[:, :D], qkv[:, D:2 * D], qkv[:, 2 * D:]
    if stage == "qkv":
        return _pool(q, M, T)
    if stage == "attn_slices":
        return _pool(q + k + v, M, T)
    if stage == "tail":
        o2 = f(q.to(T)) @ f(wo) + f(bo)
        t = torch.tanh(f(o2.to(T)) @ f(aw) + f(ab))
        valid = (maskf > 0).reshape(M, L)
        s = torch.where(valid, (t @ f(aq)).reshape(M, L), -1e9)
        # the item's own max (the TPU kernel takes one over 64 items): the
        # same weights, since |s| <= sum|aq| cannot underflow
        e = torch.where(valid, torch.exp(s - s.amax(1, keepdim=True)), 0.0)
        num = (e[..., None] * o2.reshape(M, L, D)).sum(1)
        return (num / e.sum(1, keepdim=True).clamp_min(1e-30)).to(T)
    # attn, attn_nosoftmax: per SUB-row subtile and head
    G, dh = M * L // SUB, D // H
    heads = lambda t: t.reshape(G, SUB, H, dh).transpose(1, 2)  # noqa: E731
    s = heads(q) @ heads(k).transpose(-1, -2)                  # [G, H, SUB, SUB]
    if stage == "attn":
        m = maskf.reshape(G, SUB)
        item = torch.arange(SUB, device=x2.device) // L
        pair = (m[:, :, None] * m[:, None, :]) * (item[:, None] == item[None, :])
        s = torch.where(pair[:, None] > 0, s * (1.0 / math.sqrt(dh)), -1e9)
        e = torch.exp(s - s.amax(-1, keepdim=True))
        p = e / e.sum(-1, keepdim=True)
    else:
        p = s * (1.0 / math.sqrt(dh))
    o = (p @ heads(v)).transpose(1, 2).reshape(M * L, D)
    return _pool(o, M, T)


def ablate_encoder(stage, x2, maskf, wqkv, bqkv, wo, bo, aw, ab, aq):
    """One stage of the encoder's ablation, ``x2 [M·L, D] -> [M, D]`` in
    ``x2``'s dtype, ``stage`` one of :data:`STAGES` (``csrc/ablate_encoder.cu``
    says what each computes). ``M`` must be a multiple of 64."""
    weights = (wqkv, bqkv, wo, bo, aw, ab, aq)
    M, D, Q = _check(stage, x2, maskf, weights)
    if x2.device.type == "cpu":
        return ablate_encoder_reference(stage, x2, maskf, *weights)
    FE._on_cuda(x2, "encoder ablation")
    code, dcode = STAGES.index(stage), FE._DTYPE_CODE[x2.dtype]
    lib = FE._lib()
    smem = lib.newsrec_ablate_encoder_smem_bytes(code, dcode, L, D, H, Q)
    if smem > FE.MAX_SMEM:
        raise ValueError(f"D={D} Q={Q} needs {smem} bytes of shared memory; one block "
                         f"has {FE.MAX_SMEM}")
    x2, maskf = x2.contiguous(), maskf.to(torch.float32).contiguous()
    weights = [t.contiguous() for t in weights]
    if any(t.data_ptr() % 16 for t in (x2, *weights)):
        raise ValueError("encoder ablation operands must be 16-byte aligned")
    out = torch.empty((M, D), dtype=x2.dtype, device=x2.device)
    if M == 0:
        return out
    # scratch: the weights as the forward's kernels read them (every stage
    # but passthrough); the tail's o1 and, where the forward's tail takes its
    # wide variant, its f32 o2
    ws = o1 = o2 = None
    if stage != "passthrough":
        ws = FE._weight_scratch(lib.newsrec_fused_encoder_fwd_ws_elems, x2.dtype, D, H, Q,
                                x2.device)
    if stage == "tail":
        o1 = torch.empty((M * L, D), dtype=x2.dtype, device=x2.device)
        o2_elems = lib.newsrec_fused_encoder_fwd_o2_elems(dcode, M, L, D, H, Q)
        if o2_elems:
            o2 = torch.empty(o2_elems, dtype=torch.float32, device=x2.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(x2.device):
        rc = lib.newsrec_ablate_encoder(
            code, dcode, x2.data_ptr(), maskf.data_ptr(),
            *(t.data_ptr() for t in weights), out.data_ptr(), ptr(ws), ptr(o1), ptr(o2),
            M, L, D, H, Q, 1.0 / math.sqrt(D // H),
            torch.cuda.current_stream(x2.device).cuda_stream)
    FE._raise_on(lib, rc, f"encoder ablation ({stage})")
    FE._count(ablate_encoder)
    return out


# Launches of the kernels since the count was last set to 0.
ablate_encoder.launches = 0
