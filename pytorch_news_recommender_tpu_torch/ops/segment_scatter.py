"""Row scatter-add, the backward of a row gather with duplicate indices.

Replaces the TPU kernel ``_scatter_kernel`` of the JAX package's
``ops/pallas/segment_scatter.py`` (its wrapper ``scatter_add_rows`` and the
custom VJP ``dedup_gather``). The Hopper kernel is ``csrc/segment_scatter.cu``:
a stable counting sort of the indices in four launches and a
fixed-partition segment sum whose segment length follows from the number
of sources
(:func:`segment_length`), bound by bytes; its header says how it handles
the skew of the dedup inverse gathers (the pad news holds about half the
history slots).

* :func:`scatter_add_rows` is the wrapper. A tensor on the CPU goes to the
  plain version; a CUDA tensor goes to the kernel, or the call raises.
* :func:`scatter_add_rows_reference` is the plain version (``index_add_``
  into zeros, float32).
* :func:`dedup_gather` is ``table[idx]`` whose backward is
  :func:`scatter_add_rows`, cast to the gradient's dtype.

The kernel is built with the port's other kernels (``fused_encoder._lib``)
at the first launch; importing this module builds nothing.
"""

from __future__ import annotations

import torch

from pytorch_news_recommender_tpu_torch.ops.fused_encoder import (
    _count, _lib, _on_cuda, _raise_on,
)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_WIDTH = 1024  # the widest row the kernel takes


def segment_length(S: int) -> int:
    """Sorted positions per block of the kernel's reduction for ``S``
    sources, as the built kernel takes them (builds the library; needs
    ``nvcc``)."""
    return _lib().newsrec_segment_scatter_seg(S)


def scatter_add_rows_reference(idx: torch.Tensor, g: torch.Tensor,
                               num_rows: int) -> torch.Tensor:
    """Plain version: ``out[u] = sum_{s: idx[s] = u} g[s]`` in float32,
    ``[num_rows, D]``."""
    out = torch.zeros((num_rows, g.shape[1]), dtype=torch.float32, device=g.device)
    return out.index_add_(0, idx.long(), g.float())


def scatter_add_rows(idx: torch.Tensor, g: torch.Tensor, num_rows: int) -> torch.Tensor:
    """``idx: [S]`` integer destination rows in ``[0, num_rows)``, ``g: [S,
    D]`` float32 or bfloat16 -> ``[num_rows, D]`` float32 sums, rows with no
    source 0. The range of ``idx`` is not checked on the card (that would
    need a sync); the kernel lets an index outside it match no row. On a
    CUDA tensor the sum is the same bit for bit on every run."""
    if g.device.type == "cpu":
        return scatter_add_rows_reference(idx, g, num_rows)
    _on_cuda(g, "scatter_add_rows")
    if g.ndim != 2 or idx.ndim != 1 or idx.shape[0] != g.shape[0]:
        raise ValueError(f"scatter_add_rows takes idx [S] and g [S, D], got "
                         f"{tuple(idx.shape)} and {tuple(g.shape)}")
    if g.dtype not in _DTYPE_CODE:
        raise TypeError(f"scatter_add_rows takes float32 or bfloat16 g, got {g.dtype}")
    if idx.dtype not in (torch.int32, torch.int64) or idx.device != g.device:
        raise TypeError(f"idx must be int32 or int64 on {g.device}, got "
                        f"{idx.dtype} on {idx.device}")
    S, D = g.shape
    if num_rows < 0 or D > MAX_WIDTH or S >= 2 ** 31:
        raise ValueError(f"the kernel takes num_rows >= 0, D <= {MAX_WIDTH} and "
                         f"S < 2^31; got {num_rows}, {D}, {S}")
    out = torch.empty((num_rows, D), dtype=torch.float32, device=g.device)
    if num_rows == 0 or D == 0:
        return out
    idx = idx.to(torch.int32).contiguous()
    g = g.contiguous()
    lib = _lib()
    # one allocation: the int32 workspace, then the float32 partial sums
    n_ws = lib.newsrec_segment_scatter_ws_ints(S, num_rows)
    ws = torch.empty(n_ws + max(1, lib.newsrec_segment_scatter_partial_floats(S, D)),
                     dtype=torch.int32, device=g.device)
    with torch.cuda.device(g.device):
        rc = lib.newsrec_segment_scatter(
            _DTYPE_CODE[g.dtype], idx.data_ptr(), g.data_ptr(), S, D, num_rows,
            ws.data_ptr(), ws.data_ptr() + 4 * n_ws, out.data_ptr(),
            torch.cuda.current_stream(g.device).cuda_stream)
    _raise_on(lib, rc, "segment scatter")
    _count(scatter_add_rows)
    return out


# Launches of the kernel since its count was last set to 0.
scatter_add_rows.launches = 0


class DedupGather(torch.autograd.Function):
    """``table[idx]`` forward; backward :func:`scatter_add_rows` of the
    flattened cotangent into ``table``'s rows, cast to the cotangent's dtype
    (the port of ``_dedup_gather_impl``); ``idx`` gets no gradient."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.num_rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        D = g.shape[-1]
        dtable = scatter_add_rows(idx.reshape(-1), g.reshape(-1, D), ctx.num_rows)
        return dtable.to(g.dtype), None


def dedup_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` (rows of ``table [U, D]`` for integer ``idx`` of any
    shape) whose backward is the segment scatter above instead of
    ``index_put_``'s accumulation. For gathers with heavy-tailed duplicate
    indices (news ids of a batch's histories)."""
    return DedupGather.apply(table, idx.long())
