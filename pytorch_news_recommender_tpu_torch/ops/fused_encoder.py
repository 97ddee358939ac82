"""Fused news encoder: QKV -> multi-head attention -> output projection ->
additive-attention pooling, ``[M, L, D] -> [M, D]`` in one kernel launch.

Replaces the TPU kernel ``_encoder_kernel`` / ``fused_news_encoder`` of the
JAX package's ``ops/pallas/fused_encoder.py`` (forward, no dropout, no
``o1`` residual: what serving runs). The Hopper kernel is
``csrc/fused_encoder.cu``; its header says what bounds it and how it is laid
out.

* :func:`fused_news_encoder` is the wrapper. A tensor on the CPU goes to the
  plain version; a CUDA tensor goes to the kernel, or the call raises. There
  is no fallback from the kernel to the plain version.
* :func:`fused_news_encoder_reference` is the plain version: the
  ``ops/attention.py`` chain, with the jnp chain's rounding points.
* The kernel is built at its first launch with
  ``torch.utils.cpp_extension.load`` for ``sm_90a`` into ``build/`` at the
  root of the checkout, and bound with ``ctypes`` (the source has a plain C
  interface, so no PyTorch header is compiled). Nothing is built when this
  module is imported.

Two documented differences from the plain version, both inherited from the
TPU kernel: a news item whose tokens are all pad pools to **0** (the plain
version returns the mean of its rows), and the rows of pad tokens inside a
news item take another (unused) value. Only pooled rows of items with at
least one real token are comparable.
"""

from __future__ import annotations

import ctypes
import functools
import math
import pathlib
import threading

import torch

from pytorch_news_recommender_tpu_torch.ops import attention as A

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc" / "fused_encoder.cu"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
# Hopper's shared-memory limit for one block (bytes)
MAX_SMEM = 232_448
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_COUNT_LOCK = threading.Lock()  # serving threads launch concurrently


def fused_news_encoder_reference(x, mask, wqkv, bqkv, wo, bo, aw, ab, aq, *,
                                 num_heads: int) -> torch.Tensor:
    """Plain PyTorch version: multi-head self-attention, then additive
    pooling, exactly as the JAX package's jnp chain computes them."""
    h = A.multi_head_self_attention(x, wqkv, bqkv, wo, bo, num_heads, mask)
    return A.additive_attention_with_weights(h, aw, ab, aq, mask)[0]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Builds (once per checkout and source version) and loads the kernel."""
    from torch.utils.cpp_extension import load

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = load(
        name="newsrec_fused_encoder",
        sources=[str(_CSRC)],
        build_directory=str(BUILD_DIR),
        extra_cuda_cflags=["-O3", "-std=c++17",
                           "-gencode=arch=compute_90a,code=sm_90a"],
        is_python_module=False,
        verbose=False,
    )
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.newsrec_fused_encoder_fwd.argtypes = (
        [i] + [p] * 10 + [i] * 5 + [ctypes.c_float, p])
    lib.newsrec_fused_encoder_fwd.restype = i
    lib.newsrec_fused_encoder_smem_bytes.argtypes = [i] * 4
    lib.newsrec_fused_encoder_smem_bytes.restype = ctypes.c_long
    lib.newsrec_cuda_error_string.argtypes = [i]
    lib.newsrec_cuda_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Builds and loads the kernel now instead of at its first launch."""
    _lib()


def _check(x, mask, weights, num_heads):
    if x.dtype not in _DTYPE_CODE:
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
    if D % num_heads or D % 4 or dh % 2 or Q % 2:
        raise ValueError(f"the kernel needs D % heads == 0, D % 4 == 0 and even "
                         f"head and query widths; got D={D} H={num_heads} Q={Q}")
    return M, L, D, Q


def fused_news_encoder(x, mask, wqkv, bqkv, wo, bo, aw, ab, aq, *,
                       num_heads: int) -> torch.Tensor:
    """``x: [M, L, D]`` embedded tokens (pad tokens zeroed), ``mask: [M, L]``
    validity, weights in ``x``'s dtype in Flax's layout -> ``[M, D]`` pooled
    news vectors in ``x``'s dtype."""
    if x.device.type == "cpu":
        return fused_news_encoder_reference(
            x, mask, wqkv, bqkv, wo, bo, aw, ab, aq, num_heads=num_heads)
    if x.device.type != "cuda":
        raise ValueError(f"fused encoder runs on cuda or cpu, not {x.device}")
    weights = [t.contiguous() for t in (wqkv, bqkv, wo, bo, aw, ab, aq)]
    M, L, D, Q = _check(x, mask, weights, num_heads)
    x = x.contiguous()
    mask = mask.to(torch.float32).contiguous()
    out = torch.empty((M, D), dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    lib = _lib()
    smem = lib.newsrec_fused_encoder_smem_bytes(L, D, num_heads, Q)
    if smem > MAX_SMEM:
        raise ValueError(f"L={L} D={D} needs {smem} bytes of shared memory; "
                         f"one block has {MAX_SMEM}")
    if any(t.data_ptr() % 16 for t in (x, *weights)):
        raise ValueError("fused encoder operands must be 16-byte aligned")
    with torch.cuda.device(x.device):
        rc = lib.newsrec_fused_encoder_fwd(
            _DTYPE_CODE[x.dtype], x.data_ptr(), mask.data_ptr(),
            *(t.data_ptr() for t in weights), out.data_ptr(),
            M, L, D, num_heads, Q, 1.0 / math.sqrt(D // num_heads),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("fused encoder launch failed: "
                           + lib.newsrec_cuda_error_string(rc).decode())
    with _COUNT_LOCK:
        fused_news_encoder.launches += 1
    return out


# Launches of the kernel since the count was last set to 0.
fused_news_encoder.launches = 0
