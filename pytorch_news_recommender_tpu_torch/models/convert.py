"""Weights between the JAX package's Flax trees and the port's state dicts,
and the port's checkpoint directory.

A Flax path maps to a state-dict key by joining with dots instead of
slashes: ``news_encoder/tower/wqkv`` is ``news_encoder.tower.wqkv``. Layouts
are the same on both sides, so a weight is a plain copy. That holds for
every family: LSTUR's GRU cell under ``nn.scan`` is ``gru/cell/{ir,iz,in,
hr,hz,hn}/...`` and its title conv keeps Flax's ``[k, in, out]`` kernel
(``title_encoder/title_cnn/kernel``); DiSAN's directions are
``disan/{fw,bw}/...`` with their ``b1`` and ``bf``; ``nrms_bert``'s table is
``bert_embedding/embedding``; the GNN's layers are ``gat0``, ``gat1``, ...
(``gat0/gate/kernel``), ``list_rank``'s blocks ``block0``, ... and
Fastformer's layers ``news_tower/layer0/...``.

A flat weights directory holds ``config.json`` (the JAX package's format)
and ``params.npz`` (one float32 array per Flax path); the train state's
checkpoints (``train/checkpoint.py``) keep one ``params.npz`` per step.
"""

from __future__ import annotations

import pathlib
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from pytorch_news_recommender_tpu_torch.config import Config

StateDict = Dict[str, torch.Tensor]


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def from_flax(params: Mapping) -> StateDict:
    """Nested Flax params (numpy leaves) -> the port's state dict."""
    return {path.replace("/", "."): torch.from_numpy(np.array(v, np.float32))
            for path, v in _flatten(params).items()}


def to_flax(state: Mapping[str, torch.Tensor]) -> dict:
    """The port's state dict -> nested Flax params with numpy leaves."""
    tree: dict = {}
    for key, t in state.items():
        *parents, leaf = key.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t.detach().float().cpu().numpy()
    return tree


def assign(model: nn.Module, state: Mapping[str, torch.Tensor]) -> None:
    """Copies ``state`` into ``model``; raises on a missing or unexpected key
    or a shape mismatch, naming each."""
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    unexpected = sorted(set(state) - set(own))
    shapes = [f"{k}: {tuple(state[k].shape)} != {tuple(own[k].shape)}"
              for k in sorted(set(own) & set(state))
              if tuple(state[k].shape) != tuple(own[k].shape)]
    if missing or unexpected or shapes:
        raise ValueError(f"state does not fit {type(model).__name__}: "
                         f"missing {missing}, unexpected {unexpected}, "
                         f"shape mismatches {shapes}")
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})


def save_params(path: str | pathlib.Path, state: Mapping[str, torch.Tensor]) -> None:
    """Writes a flat ``params.npz`` keyed by Flax path."""
    np.savez(path, **{k.replace(".", "/"): t.detach().float().cpu().numpy()
                      for k, t in state.items()})


def load_params(path: str | pathlib.Path) -> StateDict:
    """Reads a ``params.npz`` written by :func:`save_params`."""
    with np.load(path) as z:
        return {k.replace("/", "."): torch.from_numpy(z[k]) for k in z.files}


def save_checkpoint(directory: str | pathlib.Path, cfg: Config,
                    state: Mapping[str, torch.Tensor]) -> None:
    """Writes a flat weights directory: config.json + params.npz."""
    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    cfg.save(d / "config.json")
    save_params(d / "params.npz", state)
