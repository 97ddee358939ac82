"""Device mesh and the model axis's partition rules (port of the JAX
package's ``parallel/mesh.py``).

* axis ``data``: the batch; each data row of a process group trains on its
  slice of every global batch (``parallel/distributed.py``).
* axis ``model``: row-shards the large embedding tables (word, BERT-news,
  entity); their lookups gather over the model group
  (``parallel/sharded_embedding.py``).

:func:`make_mesh` lays devices out as ``(n_data, n_model)``, filled row-major
as JAX's ``reshape`` fills its device array; the ``Recommender`` splits its
corpus cache over the mesh's first axis. A training run's mesh is one of
processes, not devices: :func:`distributed.mesh_groups` gives a rank its
indices and groups.

:func:`row_sharded` is the partition rule of a parameter: a table named by
:data:`DEFAULT_PARTITION_RULES` is split by rows over the model axis when
its rows divide the axis and it has two dimensions; any other tensor is
replicated (the JAX package's ``spec_fits`` fallback).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from pytorch_news_recommender_tpu_torch.config import MeshConfig

# parameter paths (Flax's, ``/``-joined) whose rows shard over ``model``
DEFAULT_PARTITION_RULES: tuple[str, ...] = (
    r"word_embedding/embedding$",
    r"bert_embedding/embedding$",
    r"entity_embedding/embedding$",
)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An array of ``torch.device``s with named axes, as ``jax.sharding.Mesh``
    (``shape`` maps an axis name to its size)."""

    devices: np.ndarray
    axis_names: tuple

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def make_mesh(cfg: MeshConfig = MeshConfig(),
              devices: Optional[Sequence] = None) -> Mesh:
    """``devices`` (default: every CUDA card, which must exist) as a
    ``cfg.mesh_shape(n)`` mesh. A device may repeat (``["cuda:0"] * 4``
    puts four blocks on one card)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices=['cpu'] "
                               "for a mesh on the host")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    shape = cfg.mesh_shape(len(devs))
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape), (cfg.data_axis, cfg.model_axis))


def row_sharded(name: str, shape: Sequence[int], n_model: int) -> bool:
    """Whether the parameter ``name`` (a state-dict key, ``.``-joined, or a
    Flax path) of ``shape`` is split by rows over a model axis of
    ``n_model``: it matches a rule, has two dimensions and its rows divide
    ``n_model``. Otherwise it is replicated."""
    if n_model <= 1 or len(shape) != 2 or shape[0] % n_model:
        return False
    path = name.replace(".", "/")
    return any(re.search(r, path) for r in DEFAULT_PARTITION_RULES)
