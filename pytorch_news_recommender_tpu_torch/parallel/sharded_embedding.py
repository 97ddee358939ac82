"""Row-sharded embedding tables and their lookups over the model group
(port of the JAX package's ``parallel/sharded_embedding.py``).

Each rank of a model group (``distributed.mesh_groups``: the ranks of one
data row) holds a contiguous row block ``[V/n, D]`` of every table that
:func:`mesh.row_sharded` splits (word, BERT-news, entity); the model's
table module carries its :class:`RowBlock` and the process mesh it was
sharded over (:func:`shard_tables`).

* :func:`sharded_embedding_lookup` (``psum``): each rank gathers the rows
  it owns (other ids give zeros) and one ``all_reduce`` sums the partial
  gathers over the model group. Exactly one rank contributes each row, so
  the result is exact. The backward needs no collective: the cotangent
  rows of the owned ids are summed in float32 into the local block (in JAX
  the psum's transpose is an identity broadcast; every model peer holds the
  same cotangent).
* :func:`sharded_embedding_lookup_a2a` (``a2a``): each model peer takes a
  ``1/n`` slice of the ids, routes each id to its owner over
  ``all_to_all``, owners gather their rows and a second ``all_to_all``
  returns them; an ``all_gather`` gives every peer the whole result. Buckets
  have a static capacity; ids past it are dropped (zero rows), counted and
  reported, never silent: callers NaN-poison the output when ``dropped`` is
  not 0 (``models.layers.scheduled_lookup``). The backward routes each
  peer's own slice of the cotangent back to the owners, which add it into
  their blocks: the table's gradient is the plain lookup's (summing the
  peers' identical cotangents instead would scale it by ``n``).

``auto`` has no compiler to insert collectives here: on a sharded table it
takes the psum path, which gives the same values as JAX's ``jnp.take`` on a
row-sharded table (the JAX package's ``tests/test_sharding.py`` holds psum
and a2a to auto).

A table module looks up over the process mesh that :func:`shard_tables`
gave it (:class:`distributed.MeshGroups`); with none, or a model axis of
1, every schedule takes the plain lookup.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import torch
from torch import nn

from pytorch_news_recommender_tpu_torch.parallel import distributed
from pytorch_news_recommender_tpu_torch.parallel.mesh import row_sharded

@dataclasses.dataclass(frozen=True)
class RowBlock:
    """The rows ``[start, start + rows)`` of a ``full_rows``-row table that
    a rank holds."""

    start: int
    rows: int
    full_rows: int


# ---- the lookups ------------------------------------------------------------

def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all_single`` of equal splits of ``t``'s first axis over
    ``group``, staged on :func:`distributed._comm_device` (the host under
    gloo); returned on ``t``'s device."""
    src = t.to(distributed._comm_device()).contiguous()
    out = torch.empty_like(src)
    torch.distributed.all_to_all_single(out, src, group=group)
    return out.to(t.device)


class _PsumLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block, flat, mesh):
        rows = block.shape[0]
        local = flat.long() - mesh.model_index * rows
        in_range = (local >= 0) & (local < rows)
        safe = local.clamp(0, rows - 1)
        out = block[safe] * in_range[:, None].to(block.dtype)
        distributed.all_reduce_sum_(out, mesh.model_group)
        ctx.save_for_backward(safe, in_range)
        ctx.block_shape, ctx.block_dtype = block.shape, block.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        safe, in_range = ctx.saved_tensors
        d = torch.zeros(ctx.block_shape, dtype=torch.float32, device=g.device)
        d.index_add_(0, safe[in_range], g[in_range].float())
        return d.to(ctx.block_dtype), None, None


def sharded_embedding_lookup(block: torch.Tensor, ids: torch.Tensor,
                             mesh: distributed.MeshGroups) -> torch.Tensor:
    """``[...] -> [..., D]`` lookup into a table whose rank-local row block
    is ``block`` (rank ``model_index`` of ``n_model`` holds rows
    ``[model_index * rows, (model_index + 1) * rows)``): local gather + one
    ``all_reduce`` over the model group. Every rank of the model group
    calls it with the same ``ids``."""
    out = _PsumLookup.apply(block, ids.reshape(-1), mesh)
    return out.reshape(*ids.shape, block.shape[1])


def a2a_capacity(k: int, n_model: int, capacity_factor: float) -> int:
    """Bucket capacity of a peer's ``k`` ids per owner (JAX's expression)."""
    return max(1, min(k, int(-(-k * capacity_factor // n_model))))


class _A2ALookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block, flat, mesh, cap, skip_id, n_valid):
        n, m, group = mesh.n_model, mesh.model_index, mesh.model_group
        rows, D = block.shape
        dev = flat.device
        k = flat.shape[0] // n
        sl = flat[m * k:(m + 1) * k].long()
        ar = torch.arange(k, device=dev)
        # pad slots (past n_valid) and skip_id slots are not requests: a
        # sentinel owner sorts them last, they take no capacity and are
        # never counted as dropped
        valid = (m * k + ar) < n_valid
        if skip_id is not None:
            valid &= sl != skip_id
        owner = torch.where(valid, sl // rows, torch.full_like(sl, n))
        order = torch.sort(owner, stable=True).indices
        s_owner, s_ids, s_valid = owner[order], sl[order], valid[order]
        start = torch.searchsorted(s_owner, torch.arange(n, device=dev))
        row = s_owner.clamp(max=n - 1)
        pos = ar - start[row]
        ok = (pos < cap) & s_valid
        dropped = (s_valid & (pos >= cap)).sum().reshape(1)
        col = torch.where(ok, pos, torch.full_like(pos, cap))   # cap: trash column
        disp = torch.zeros(n, cap + 1, dtype=torch.long, device=dev)
        disp[row, col] = torch.where(ok, s_ids, torch.zeros_like(s_ids))
        recv = _all_to_all(disp[:, :cap], group)   # recv[j]: peer j's requests of my rows
        local_req = (recv - m * rows).clamp(0, rows - 1)
        resp = _all_to_all(block[local_req], group)   # resp[o]: owner o's rows for me
        got = resp[row, pos.clamp(0, cap - 1)] * ok[:, None].to(block.dtype)
        out_slice = torch.zeros(k, D, dtype=block.dtype, device=dev)
        out_slice[order] = got
        out = distributed.gather_blocks(out_slice, group)
        dropped = distributed.all_reduce_sum_(dropped, group)
        ctx.save_for_backward(order, row, col, ok, local_req)
        ctx.mesh, ctx.k, ctx.cap = mesh, k, cap
        ctx.block_shape, ctx.block_dtype = block.shape, block.dtype
        return out, dropped.reshape(())

    @staticmethod
    def backward(ctx, g_out, _g_dropped):
        order, row, col, ok, local_req = ctx.saved_tensors
        mesh, k, cap = ctx.mesh, ctx.k, ctx.cap
        rows, D = ctx.block_shape
        m = mesh.model_index
        # this peer's own slice of the (replicated) cotangent, to its owners
        g = g_out[m * k:(m + 1) * k].float()[order] * ok[:, None]
        buf = torch.zeros(mesh.n_model, cap + 1, D, dtype=torch.float32, device=g.device)
        buf[row, col] = g
        grecv = _all_to_all(buf[:, :cap], mesh.model_group)   # for my requests recv
        d = torch.zeros(rows, D, dtype=torch.float32, device=g.device)
        d.index_add_(0, local_req.reshape(-1), grecv.reshape(-1, D))
        return d.to(ctx.block_dtype), None, None, None, None, None


def sharded_embedding_lookup_a2a(
    block: torch.Tensor,
    ids: torch.Tensor,
    mesh: distributed.MeshGroups,
    capacity_factor: float = 2.0,
    skip_id: Optional[int] = None,
    n_valid: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """All-to-all lookup. Returns ``(out [..., D], dropped)``: ``dropped``
    counts the ids of the model group that overflowed their owner's bucket
    (their rows are zero); ``dropped == 0`` guarantees the plain lookup's
    values, except slots equal to ``skip_id``, whose rows are zero.

    ``skip_id`` marks a pad id: its slots take no capacity and are never
    counted (masked lookups pass 0: a dedup buffer is zero-padded to its
    bucket width, and those slots would all route to owner 0). Positions
    at or past ``n_valid`` (default: all are valid) are pad slots too. The
    id stream is zero-padded to a multiple of ``n_model``; the capacity per
    owner bucket of a peer's ``k`` ids is :func:`a2a_capacity`.

    Schedule per rank (model peer ``m`` of ``n``): take the ``m``-th slice
    of the ids; sort it by owner (stable) and pack ``[n, cap]`` request
    buckets (overflow goes to a trash column, so in-capacity entries are
    never corrupted); ``all_to_all`` the requests; gather the local rows;
    ``all_to_all`` the rows back; unsort, zero the overflow slots and
    ``all_gather`` the slices over the model group."""
    n = mesh.n_model
    D = block.shape[1]
    flat = ids.reshape(-1)
    n_total = flat.shape[0]
    pad = (-n_total) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    k = flat.shape[0] // n
    cap = a2a_capacity(k, n, capacity_factor)
    out, dropped = _A2ALookup.apply(block, flat, mesh, cap, skip_id,
                                    n_total if n_valid is None else n_valid)
    return out[:n_total].reshape(*ids.shape, D), dropped


class _SumGradOverGroup(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over a group (every
    rank gets the same bits)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return distributed.all_reduce_sum_(g.contiguous().clone(), ctx.group), None


def _plain(table, ids, mask, cd):
    out = torch.nn.functional.embedding(ids.long(), table).to(cd)
    return out if mask is None else out * mask[..., None].to(cd)


def scheduled_lookup(table: torch.Tensor, ids: torch.Tensor, mask: Optional[torch.Tensor],
                     cd: torch.dtype, schedule: str = "auto",
                     capacity_factor: float = 2.0,
                     block: Optional[RowBlock] = None,
                     mesh: Optional[distributed.MeshGroups] = None) -> torch.Tensor:
    """``table[ids]`` in ``cd`` (times ``mask``) through the schedule of
    ``ModelConfig.embedding_lookup`` (the JAX package's
    ``layers._scheduled_lookup``).

    * ``block`` set: ``table`` is this rank's row block; ``a2a`` takes the
      all-to-all lookup, ``psum`` and ``auto`` the psum lookup.
    * A whole table under a ``mesh`` with a model axis, with ``psum`` or ``a2a``:
      zero-padded to a multiple of the axis and cut to this rank's block
      (its gradient summed over the model group, so that every rank holds
      the whole table's), then as above (keep vocabularies divisible).
    * Otherwise the plain lookup.

    A masked lookup skips id 0 in the exchange (``skip_id=0``); an a2a
    overflow NaN-poisons the output, never silent."""
    if block is None and (schedule == "auto" or mesh is None or mesh.n_model <= 1):
        return _plain(table, ids, mask, cd)
    if schedule not in ("auto", "psum", "a2a"):
        raise ValueError(f"embedding_lookup must be auto|psum|a2a, got {schedule!r}")
    if mesh is None or mesh.n_model <= 1:
        raise RuntimeError("a row-sharded table looks up over its process mesh "
                           "(shard_tables)")
    if block is None:
        n = mesh.n_model
        if table.requires_grad:
            table = _SumGradOverGroup.apply(table, mesh.model_group)
        pad = (-table.shape[0]) % n
        if pad:
            table = torch.nn.functional.pad(table, (0, 0, 0, pad))
        rows = table.shape[0] // n
        table = table[mesh.model_index * rows:(mesh.model_index + 1) * rows]
    if schedule == "a2a":
        out, dropped = sharded_embedding_lookup_a2a(
            table, ids, mesh, capacity_factor=capacity_factor,
            skip_id=0 if mask is not None else None)
        out = out + torch.where(dropped == 0, 0.0, float("nan")).to(out.dtype)
    else:
        out = sharded_embedding_lookup(table, ids, mesh)
    out = out.to(cd)
    return out if mask is None else out * mask[..., None].to(cd)


# ---- the tables of a model ------------------------------------------------------

def shard_tables(model: nn.Module, mesh: Optional[distributed.MeshGroups]
                 ) -> Dict[str, RowBlock]:
    """Replaces each table of ``model`` that :func:`mesh.row_sharded` splits
    by this rank's row block (a new parameter, on the table's device; its
    module's ``row_block`` records the rows), and gives every table module
    ``mesh`` to look up over. Every rank passes the same whole tables.
    Returns ``{parameter name: RowBlock}``."""
    if mesh is None or mesh.n_model <= 1:
        return {}
    for mod in model.modules():
        if hasattr(mod, "row_block"):
            mod.mesh = mesh
    out = {}
    for name, p in list(model.named_parameters()):
        if not row_sharded(name, p.shape, mesh.n_model):
            continue
        mod_name, attr = name.rsplit(".", 1)
        mod = model.get_submodule(mod_name)
        if not hasattr(mod, "row_block"):
            raise TypeError(f"{name} matches a row-sharding rule but "
                            f"{type(mod).__name__} looks up no row block")
        rows = p.shape[0] // mesh.n_model
        rb = RowBlock(mesh.model_index * rows, rows, p.shape[0])
        setattr(mod, attr, nn.Parameter(p.detach()[rb.start:rb.start + rows].clone(),
                                        requires_grad=p.requires_grad))
        mod.row_block = rb
        out[name] = rb
    return out


def local_rows(state: Mapping[str, torch.Tensor], blocks: Mapping[str, RowBlock]
               ) -> Dict[str, torch.Tensor]:
    """``state`` with each whole table of ``blocks`` cut to this rank's
    rows (a tensor already at the block's size stays as it is)."""
    out = dict(state)
    for name, rb in blocks.items():
        t = out.get(name)
        if t is not None and t.shape[0] == rb.full_rows:
            out[name] = t[rb.start:rb.start + rb.rows]
    return out


def joined_rows(state: Mapping[str, torch.Tensor], blocks, model_group
                ) -> Dict[str, torch.Tensor]:
    """``state`` with each block named in ``blocks`` joined over
    ``model_group`` into the whole table (a collective over the group, in
    name order)."""
    out = dict(state)
    for name in sorted(blocks):
        if name in out:
            out[name] = distributed.gather_blocks(out[name], model_group)
    return out
