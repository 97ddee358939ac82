"""Checkpoints of the whole train state with best-AUC retention (port of the
JAX package's ``train/checkpoint.py``, without Orbax).

Layout under ``directory/``:

* ``config.json``  the run's :class:`Config` (the JAX package's format);
* ``<step>/params.npz``     one float32 array per Flax path
  (``models/convert.py``);
* ``<step>/opt_state.npz``  the optimizer's state (:meth:`Optimizer.state_dict`):
  Adam's ``mu/<path>`` and ``nu/<path>``, or Adafactor's factored
  ``v_row/<path>`` and ``v_col/<path>`` and per-entry ``v/<path>``; with
  gradient accumulation ``acc/<path>``; ``count`` and ``mini_step``;
* ``<step>/state.json``     ``{"step": TrainState.step}``;
* ``<step>/metrics.json``   the numeric metrics given to :meth:`save`.

Retention keeps the ``max_to_keep`` best steps by ``metrics["auc"]`` (a step
without one counts as 0), as the JAX package's Orbax options do. Restore is
exact: parameters, the optimizer's moments and counts, and the step, so a
resumed run continues the optimisation and, since a step's dropout seeds
depend on the step (``train/loop.py``), its randomness too.
``Recommender.from_checkpoint`` serves the best step of such a directory.

In a ``torch.distributed`` group every rank holds the same replicated
state: rank 0 writes (the config and each step), and every rank waits at a
barrier after a save, so that all then see the same steps; every rank
restores. Under a model axis each rank holds row blocks of the sharded
tables and of their moments: on save the ranks of every model group join
their blocks (``all_gather``), so that rank 0 writes the same whole arrays
as a one-process run; on restore every rank reads the whole arrays and keeps
its rows. A model-parallel checkpoint therefore loads in one process, and a
one-process checkpoint resumes under a model axis.
"""

from __future__ import annotations

import json
import pathlib
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

from pytorch_news_recommender_tpu_torch.config import Config
from pytorch_news_recommender_tpu_torch.models.convert import (
    assign, load_params, save_params,
)
from pytorch_news_recommender_tpu_torch.parallel import distributed
from pytorch_news_recommender_tpu_torch.parallel.sharded_embedding import (
    joined_rows, local_rows,
)

_OPT_TREES = ("mu", "nu", "v_row", "v_col", "v", "acc")


def load_config(directory: str | pathlib.Path) -> Config:
    return Config.load(pathlib.Path(directory) / "config.json")


def params_file(directory: str | pathlib.Path) -> pathlib.Path:
    """The weights that ``directory`` serves: its own ``params.npz`` (a flat
    weights directory, ``models/convert.py``), else the best step's."""
    d = pathlib.Path(directory)
    if (d / "params.npz").exists():
        return d / "params.npz"
    return CheckpointManager(d).params_path()


def _save_opt(path: pathlib.Path, opt: Dict[str, Any]) -> None:
    arrays = {f"{tree}/{name.replace('.', '/')}": t.detach().float().cpu().numpy()
              for tree in _OPT_TREES if tree in opt for name, t in opt[tree].items()}
    np.savez(path, count=np.int64(opt["count"]), mini_step=np.int64(opt["mini_step"]),
             **arrays)


def _load_opt(path: pathlib.Path) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    with np.load(path) as z:
        for key in z.files:
            if key in ("count", "mini_step"):
                out[key] = int(z[key])
                continue
            tree, name = key.split("/", 1)
            out.setdefault(tree, {})[name.replace("/", ".")] = torch.from_numpy(z[key])
    return out


class CheckpointManager:
    """Best-AUC checkpoint retention over step directories."""

    def __init__(self, directory: str | pathlib.Path, cfg: Optional[Config] = None,
                 max_to_keep: int = 3):
        self.directory = pathlib.Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        if cfg is not None and distributed.process_index() == 0:
            cfg.save(self.directory / "config.json")

    def steps(self) -> list[int]:
        """The saved steps, in ascending order."""
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.name.isdigit() and (p / "state.json").exists())

    def _auc(self, step: int) -> float:
        return float(self.restore_metrics(step).get("auc", 0.0))

    def save(self, step: int, state, metrics: Dict[str, Any]) -> None:
        """Writes ``state`` (a ``TrainState``) as ``<step>/`` (replacing one
        of the same step), then drops the steps outside the best
        ``max_to_keep`` by AUC. Rank 0 writes; every rank of a group calls
        this (joining its table blocks) and waits for the write."""
        params, opt = self._whole(state)
        if distributed.process_index() == 0:
            self._write(step, state.step, params, opt, metrics)
        distributed.barrier()

    @staticmethod
    def _whole(state) -> tuple:
        """The state's parameters and optimizer state with every row block
        (``state.opt.blocks`` and ``row_moments``) joined over the
        optimizer's model group into the whole table."""
        params, opt = state.params, state.opt.state_dict()
        blocks, group = state.opt.blocks, state.opt.model_group
        if not blocks:
            return params, opt
        opt = dict(opt)
        for tree in state.opt.trees:
            rows = [n for t, n in state.opt.row_moments if t == tree]
            opt[tree] = joined_rows(opt[tree], rows, group)
        return joined_rows(params, blocks, group), opt

    def _write(self, step: int, state_step: int, params, opt,
               metrics: Dict[str, Any]) -> None:
        metrics = {k: float(v) for k, v in metrics.items()
                   if isinstance(v, (int, float)) and not isinstance(v, bool)}
        final = self.directory / str(int(step))
        tmp = self.directory / f".tmp-{int(step)}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        save_params(tmp / "params.npz", params)
        _save_opt(tmp / "opt_state.npz", opt)
        (tmp / "state.json").write_text(json.dumps({"step": int(state_step)}))
        (tmp / "metrics.json").write_text(json.dumps(metrics))
        shutil.rmtree(final, ignore_errors=True)
        tmp.rename(final)
        ranked = sorted(self.steps(), key=lambda s: (self._auc(s), s), reverse=True)
        for s in ranked[self.max_to_keep:]:
            shutil.rmtree(self.directory / str(s))

    def best_step(self) -> Optional[int]:
        steps = self.steps()
        return max(steps, key=lambda s: (self._auc(s), s)) if steps else None

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def _step_or_default(self, step: Optional[int]) -> int:
        if step is None:
            step = self.best_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        return step

    def restore(self, state, step: Optional[int] = None):
        """Loads step ``step`` (default: the best, else the latest) into
        ``state`` (typically a fresh ``Trainer.init_state()``): parameters,
        optimizer state and step; a row block takes its rows of the whole
        table. Returns ``state``."""
        d = self.directory / str(self._step_or_default(step))
        assign(state.model, local_rows(load_params(d / "params.npz"), state.opt.blocks))
        state.opt.load_state_dict(_load_opt(d / "opt_state.npz"))
        state.step = int(json.loads((d / "state.json").read_text())["step"])
        return state

    def restore_metrics(self, step: Optional[int] = None) -> Dict[str, float]:
        d = self.directory / str(self._step_or_default(step))
        return json.loads((d / "metrics.json").read_text())

    def params_path(self, step: Optional[int] = None) -> pathlib.Path:
        """``params.npz`` of step ``step`` (default: the best)."""
        return self.directory / str(self._step_or_default(step)) / "params.npz"

    def close(self) -> None:
        """Nothing is written in the background; kept for the JAX API."""
