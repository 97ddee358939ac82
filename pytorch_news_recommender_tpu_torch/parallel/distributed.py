"""Multi-process runtime on ``torch.distributed`` (port of the JAX package's
``parallel/distributed.py``): the process group, the mesh's two groups, the
rank's slice of a batch, and the gathers the ``Trainer`` needs.

* :func:`initialize` brings the group up: from explicit arguments
  (``init_process_group(init_method="tcp://<coordinator>")``), from a
  launcher's environment (``torchrun``, or SLURM with ``MASTER_ADDR`` /
  ``MASTER_PORT`` set), or not at all in a plain single-process run.
* :func:`process_index` / :func:`process_count` are the rank and the world
  size (0 and 1 without a group), as ``jax.process_index`` /
  ``jax.process_count``.
* :func:`mesh_groups` lays the world out as a ``(n_data, n_model)`` mesh of
  processes (``mesh.model_parallel_size`` = ``n_model``): a rank's
  ``data_index = rank // n_model`` and ``model_index = rank % n_model``, so
  model peers are consecutive ranks, as JAX's device order puts them. The
  **model group** (the ranks of one data row, same ``data_index``) holds
  the row blocks of one sharded table between them and looks its rows up
  together (``parallel/sharded_embedding.py``); they train on the same
  rows. The **data group** (same ``model_index``) holds the same block of
  each table, on different rows of the batch: a block's gradient is
  averaged over it, and the eval's score blocks are gathered over it.
* :func:`process_local_slice` is a data row's rows of a global batch.
* :func:`fetch_global` gathers every rank's block of a tensor, in rank
  order, onto every rank of a group (the eval score blocks, the table
  blocks of a checkpoint).
* :func:`all_reduce_mean` averages a list of tensors over a group in one
  collective on one flat buffer (the weight gradients of a step).
* :func:`assert_replicated` compares a checksum of tensors across a group.

The JAX package's ``global_batch`` has no counterpart: JAX assembles each
process's slice into one global array, while here each rank keeps its slice
and computes on it, and only the gradients, the step's loss, the sharded
tables' rows and the eval scores cross ranks.

Backends: ``nccl`` when each rank owns a card (``cuda:{LOCAL_RANK}``, made
the current device), ``gloo`` on the CPU. ``backend="gloo"`` also serves
ranks that share one card; gloo stages CUDA tensors through the host.
nccl takes only tensors on the rank's card and gloo gathers only CPU
tensors, so the gathers move their blocks to :func:`_comm_device` first;
the all-reduce moves its buffer to the card under nccl and leaves it where
it is under gloo. Nothing switches backends silently: a group that cannot
form raises. Every function that takes ``group`` takes ``None`` for the
whole world.
"""

from __future__ import annotations

import dataclasses
import os
from datetime import timedelta
from typing import Any, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# how long a rank waits for the others to join the group
INIT_TIMEOUT = timedelta(minutes=10)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    """The world size (1 without a group)."""
    return dist.get_world_size() if is_initialized() else 1


def _int_env(name: str, default: int = 1) -> Optional[int]:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return None


def cluster_env_detected() -> bool:
    """Does the environment describe a multi-process launch? Reads only
    environment variables: torchrun's ``WORLD_SIZE`` (with ``RANK`` and
    ``MASTER_ADDR``) and SLURM's ``SLURM_NTASKS`` / ``SLURM_NPROCS``; a size
    that is not a number counts as one process.

    ``NEWSREC_NO_DISTRIBUTED`` set to anything but ``""`` or ``"0"`` vetoes
    the detection, for a deliberately single-process run inside a
    multi-task allocation (``cli train --no-distributed``)."""
    env = os.environ
    if env.get("NEWSREC_NO_DISTRIBUTED", "0") not in ("", "0"):
        return False
    if (_int_env("WORLD_SIZE") or 1) > 1:
        return True
    slurm = _int_env("SLURM_NTASKS", _int_env("SLURM_NPROCS") or 1)
    return (slurm or 1) > 1


def _default_backend() -> str:
    return "nccl" if torch.cuda.is_available() else "gloo"


def _bind_card(backend: str, rank: int) -> None:
    """With ``nccl`` each rank owns one card: ``LOCAL_RANK`` (torchrun;
    SLURM's ``SLURM_LOCALID``), else the rank modulo the cards on the
    host."""
    if backend != "nccl":
        return
    if not torch.cuda.is_available():
        raise RuntimeError("the nccl backend needs a CUDA card on every rank")
    local = os.environ.get("LOCAL_RANK") or os.environ.get("SLURM_LOCALID")
    torch.cuda.set_device(int(local) if local else rank % torch.cuda.device_count())


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> bool:
    """Brings up the process group; returns True iff one exists afterwards
    (already up, or formed here).

    * Explicit arguments (all three together): ``init_process_group``
      over ``tcp://<coordinator_address>`` with that world size and rank.
    * No arguments, a launcher's environment (:func:`cluster_env_detected`):
      torchrun's ``env://`` (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
      ``MASTER_PORT``), or under SLURM the same over
      ``tcp://MASTER_ADDR:MASTER_PORT`` with ``SLURM_PROCID`` /
      ``SLURM_NTASKS``; the address must be set. The environment is read,
      not changed.
    * No arguments, no launcher: a single-process run; returns False and
      touches nothing.

    ``backend`` defaults to ``nccl`` where CUDA is available (each rank
    then owns ``cuda:{LOCAL_RANK}``) and ``gloo`` elsewhere. A group that
    was asked for and cannot form raises; nothing falls back to a single
    process."""
    if is_initialized():
        return True
    explicit = (coordinator_address, num_processes, process_id)
    if any(a is not None for a in explicit):
        missing = [n for n, a in zip(("coordinator_address", "num_processes",
                                      "process_id"), explicit) if a is None]
        if missing:
            raise ValueError("initialize(): an explicit cluster spec needs all of "
                             "coordinator_address/num_processes/process_id; "
                             f"missing {missing}")
        if not 0 <= process_id < num_processes:
            raise ValueError(f"process_id {process_id} is outside a world of "
                             f"{num_processes} processes")
        backend = backend or _default_backend()
        _bind_card(backend, process_id)
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id,
                                timeout=INIT_TIMEOUT)
        return True
    if not cluster_env_detected():
        return False
    env = os.environ
    torchrun = bool(env.get("RANK") and env.get("WORLD_SIZE"))
    # torchrun's variables, else SLURM's task ids (its task count detected)
    spec = {"RANK": env.get("RANK") or env.get("SLURM_PROCID"),
            "WORLD_SIZE": (env.get("WORLD_SIZE") or env.get("SLURM_NTASKS")
                           or env.get("SLURM_NPROCS")),
            "MASTER_ADDR": env.get("MASTER_ADDR"), "MASTER_PORT": env.get("MASTER_PORT")}
    missing = [k for k, v in spec.items() if not v]
    if missing:
        raise ValueError(f"a multi-process launch was detected but {missing} "
                         "is not set; export them, or pass --coordinator/"
                         "--num-processes/--process-id")
    if not torchrun:
        return initialize(f"{spec['MASTER_ADDR']}:{spec['MASTER_PORT']}",
                          int(spec["WORLD_SIZE"]), int(spec["RANK"]), backend)
    # torchrun's agent may host the rendezvous store: join it as env:// does
    backend = backend or _default_backend()
    _bind_card(backend, int(spec["RANK"]))
    dist.init_process_group(backend, init_method="env://", timeout=INIT_TIMEOUT)
    return True


def process_local_slice(n: int, index: Optional[int] = None,
                        count: Optional[int] = None) -> slice:
    """Row ``index`` of ``count`` (default: this rank of the world) of a
    length-``n`` global batch, as a contiguous slice."""
    p = process_index() if index is None else index
    count = process_count() if count is None else count
    if n % count:
        raise ValueError(f"a batch of {n} rows does not split over {count} processes")
    per = n // count
    return slice(p * per, (p + 1) * per)


# a group of one rank: every collective over it is the identity
SOLO = "solo"


@dataclasses.dataclass(frozen=True)
class MeshGroups:
    """A rank's place in the ``(n_data, n_model)`` process mesh and its two
    groups: a ``torch.distributed`` group, ``None`` where the group is the
    whole world, :data:`SOLO` where it is this rank alone."""

    n_data: int
    n_model: int
    data_index: int
    model_index: int
    data_group: Any = SOLO
    model_group: Any = SOLO


_MESHES: dict = {}


def mesh_groups(model_parallel_size: int) -> MeshGroups:
    """The process mesh of the world with a model axis of
    ``model_parallel_size`` (``MeshConfig.mesh_shape``'s ``ValueError`` when
    it does not divide the world). The first call for a size creates the
    groups, every rank every group in the same order, as ``dist.new_group``
    requires; later calls return them."""
    from pytorch_news_recommender_tpu_torch.config import MeshConfig

    world, rank = process_count(), process_index()
    n_data, n_model = MeshConfig(model_parallel_size=model_parallel_size).mesh_shape(world)
    key = (world, rank, n_model)
    if key in _MESHES:
        return _MESHES[key]
    data_index, model_index = divmod(rank, n_model)
    data_group = SOLO if n_data == 1 else None
    model_group = SOLO if n_model == 1 else None
    if n_data > 1 and n_model > 1:
        for d in range(n_data):
            g = dist.new_group(list(range(d * n_model, (d + 1) * n_model)))
            if d == data_index:
                model_group = g
        for m in range(n_model):
            g = dist.new_group(list(range(m, world, n_model)))
            if m == model_index:
                data_group = g
    mesh = MeshGroups(n_data, n_model, data_index, model_index, data_group, model_group)
    _MESHES[key] = mesh
    return mesh


def group_size(group=None) -> int:
    """The ranks in ``group`` (``None``: the world, 1 without a process
    group; :data:`SOLO`: 1)."""
    if group is SOLO:
        return 1
    return process_count() if group is None else dist.get_world_size(group)


def _on(group) -> dict:
    """The ``group=`` keyword of a collective (none for the world)."""
    return {} if group is None else {"group": group}


def _comm_device() -> torch.device:
    """Where a gather's buffers must lie: the rank's current card under
    ``nccl``, the host under ``gloo``."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def fetch_global(t: torch.Tensor, group=None) -> np.ndarray:
    """Every rank's block of ``t`` (equal shapes) in ``group``, concatenated
    along the first axis in rank order, as numpy on this host (without a
    group, ``t``'s own values)."""
    return gather_blocks(t, group).cpu().numpy()


def gather_blocks(t: torch.Tensor, group=None) -> torch.Tensor:
    """:func:`fetch_global` as a tensor on ``t``'s device."""
    n = group_size(group)
    if n == 1:
        return t.detach()
    src = t.detach().to(_comm_device()).contiguous()
    out = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(out, src, **_on(group))
    return torch.cat(out).to(t.device)


def _reduce_device(t: torch.Tensor) -> torch.device:
    """Where an all-reduce's buffer lies: the rank's card under nccl, the
    tensor's own device under gloo (which reduces CUDA tensors itself)."""
    return _comm_device() if dist.get_backend() == "nccl" else t.device


def all_reduce_mean(tensors: Sequence[torch.Tensor], group=None) -> List[torch.Tensor]:
    """The mean over the ranks of ``group`` of each tensor, from one
    ``all_reduce`` of one flat float32 buffer (every rank gets the same
    bits: the reduced buffer is shared, not recomputed per rank). Returns
    new tensors shaped as the inputs, on their device. The buffer lies on
    the rank's card under nccl and on the tensors' own device under gloo,
    which reduces CUDA tensors itself: staging them on the host here doubled
    a two-rank step on one H100 80GB HBM3 at 700 W (``chip_smoke.py`` phase
    22, 66 -> 135 ms)."""
    n = group_size(group)
    if n == 1:
        return [t.detach().clone() for t in tensors]
    dev = _reduce_device(tensors[0])
    flat = torch.cat([t.detach().reshape(-1).float().to(dev) for t in tensors])
    dist.all_reduce(flat, **_on(group))
    flat /= n
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape).to(t.device, t.dtype))
        at += t.numel()
    return out


def all_reduce_sum_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sums ``t`` over the ranks of ``group`` in place (on the rank's card
    under nccl, where ``t`` lies under gloo) and returns it."""
    if group_size(group) == 1:
        return t
    dev = _reduce_device(t)
    if dev == t.device:
        dist.all_reduce(t, **_on(group))
        return t
    buf = t.to(dev)
    dist.all_reduce(buf, **_on(group))
    return t.copy_(buf)


def assert_replicated(tensors: Sequence[torch.Tensor], what: str, group=None) -> None:
    """Raises unless every rank of ``group`` holds the same ``tensors``,
    compared by a checksum: each tensor's float64 sum and sum of squares,
    gathered from every rank and compared exactly."""
    if group_size(group) == 1 or not tensors:
        return
    sums = torch.stack([torch.stack([t.detach().double().sum(),
                                     (t.detach().double() ** 2).sum()])
                        for t in tensors])
    rows = fetch_global(sums[None], group)
    bad = [r for r in range(1, len(rows)) if not np.array_equal(rows[r], rows[0])]
    if bad:
        raise RuntimeError(f"{what} differ between rank 0 and ranks {bad} of the group")


def barrier() -> None:
    """Waits for every rank (nothing without a group)."""
    if process_count() > 1:
        dist.barrier()
