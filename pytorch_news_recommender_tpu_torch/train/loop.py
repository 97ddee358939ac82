"""Training and evaluation engine (port of the JAX package's
``train/loop.py``).

Adam with optional linear warm-up, global-norm clipping, AdamW, Adafactor
and gradient accumulation, written out to follow optax's arithmetic step
for step;
softmax cross-entropy over the candidates with the positive at slot 0, plus
the auxiliary losses of the families that record them (TANR); deduplicated and length-split batches; two-tower evaluation with the
impression-level metrics of ``train/metrics.py``; the fit loop with its eval
cadence, AUC checkpoint floor and early stopping.

PyTorch is stateful, so :class:`TrainState` holds the model itself (its
parameters), the optimizer and the step counter, and :meth:`Trainer.run_step`
updates it in place and returns it. A step's dropout seeds depend on
``(seed, state.step)`` alone, as the JAX package folds the step into its key,
so a run restored from a checkpoint (``train/checkpoint.py``) draws the
masks that the uninterrupted run would have drawn. On a CUDA device the
towers run through the hand-written encoder kernels, forward and backward,
and with ``model.dedup_gather_mxu`` the inverse gathers' backward through the
segment-scatter kernel; on the CPU through their plain versions, which
autograd differentiates.

GNN: the host attaches each dedup batch's neighborhood closure
(``loader.add_gnn_frontier``) in ``fit``'s prefetched feed, and
``run_step`` attaches it to a batch that lacks it; eval encodes the corpus
level by level (``models.common.corpus_encode_levelwise``).

Parallelism on ``torch.distributed`` (``parallel/distributed.py``): the
``world`` ranks form a ``(n_data, n_model)`` mesh, ``n_model`` =
``mesh.model_parallel_size`` (``distributed.mesh_groups``).

* Data axis: each data row trains on its ``batch_size / n_data`` slice of
  every global batch (``loader.train_batches_sliced``, its block via
  ``local_block``) and draws the step's dropout seeds from the same
  generator folded with its **data** index (:func:`step_generator`'s
  ``rank``, ``ops.fused_encoder.shard_seed``), so the model peers of a row
  draw the same masks on the same rows and stay replicas.
* Model axis: the word, BERT and entity tables are split by rows over the
  ranks of a data row (``parallel/sharded_embedding.py``: each rank holds
  its block, and Adam's moments of it); lookups gather over the model
  group by ``model.embedding_lookup``.
* After the backward a block's gradient is averaged over the data group;
  every replicated parameter's, with the loss and the accuracy, over the
  whole world (one ``all_reduce`` of one flat buffer each), so that model
  peers hold the same bits even where a card sums in a varying order.
  Global-norm clipping and Adafactor's statistics over a table's rows sum
  the blocks over the model group. :meth:`Trainer.check_replicas` compares
  replicated tensors over the world and blocks over the data group at
  every evaluation.

Evaluation scores each data row's rows of every batch and gathers the score
blocks over the data group, so every rank computes the same metrics (every
rank encodes the corpus, its model group in lockstep). ``sliced_feed``
takes the same feed in one process, and ``Trainer(replay_ranks=n)`` an
``n``-row run's global batches, every row's block in one multi-block
batch.
"""

from __future__ import annotations

import copy
import dataclasses
import sys
import time
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch

from pytorch_news_recommender_tpu_torch.config import Config, TrainConfig
from pytorch_news_recommender_tpu_torch.data.dataset import DevData, RecDataset
from pytorch_news_recommender_tpu_torch.data.loader import (
    DEFAULT_UNIQUE_BUCKETS,
    GNN_FRONTIER_BUCKETS,
    LengthSplit,
    add_gnn_frontier,
    eval_batches,
    join_blocks,
    local_block,
    pad_batch,
    train_batches,
    train_batches_sliced,
)
from pytorch_news_recommender_tpu_torch.data.prefetch import device_prefetch
from pytorch_news_recommender_tpu_torch.models import build_model
from pytorch_news_recommender_tpu_torch.models.common import RecModel, corpus_encode_levelwise
from pytorch_news_recommender_tpu_torch.models.convert import assign
from pytorch_news_recommender_tpu_torch.models.layers import RankGenerator
from pytorch_news_recommender_tpu_torch.parallel import distributed
from pytorch_news_recommender_tpu_torch.parallel.sharded_embedding import (
    RowBlock, local_rows, shard_tables,
)
from pytorch_news_recommender_tpu_torch.serve import resolve_device
from pytorch_news_recommender_tpu_torch.train import metrics as M

Tensors = Dict[str, torch.Tensor]


def step_generator(seed: int, step: int, rank: int = 0) -> RankGenerator:
    """The CPU generator that draws step ``step``'s dropout seeds: its draws
    are a function of ``(seed, step)`` alone (the JAX package's
    ``fold_in(PRNGKey(seed), step)``; the streams differ), and each seed
    drawn from it for a dropout mask is folded with ``rank``
    (``models.layers.draw_seed``): the data index of the trainer's rank, as
    JAX's sharded encoder folds ``axis_index(data)``."""
    g = RankGenerator()
    g.rank = int(rank)
    return g.manual_seed(((int(seed) & 0xFFFFFFFF) << 32) | (int(step) & 0xFFFFFFFF))


def softmax_ce_loss(scores: torch.Tensor) -> torch.Tensor:
    """(1+K)-way softmax cross-entropy with the positive at slot 0."""
    return -torch.log_softmax(scores.float(), dim=-1)[:, 0].mean()


def training_loss(model: RecModel, scores: torch.Tensor) -> torch.Tensor:
    """The click cross-entropy of ``scores`` plus the auxiliary losses that
    the forward which gave them recorded (``HAS_AUX_LOSS`` families, e.g.
    TANR's topic cross-entropy, weighted where recorded), as the JAX
    package's step adds its ``losses`` collection."""
    loss = softmax_ce_loss(scores)
    if model.HAS_AUX_LOSS:
        for name in sorted(model.aux_losses):
            loss = loss + model.aux_losses[name].mean()
    return loss


def _raise_nonfinite(state, loss: torch.Tensor, n_proc: int = 1) -> None:
    """``debug_nans``: raises ``FloatingPointError`` naming the step and the
    first of the loss and the gradients that is not finite. One device sync;
    on several ranks the flags are summed over the world first, since a row
    block's gradient lives on its model peers only, so every rank raises
    together."""
    named = [("loss", loss)] + [(n, p.grad) for n, p in state.model.named_parameters()
                                if p.grad is not None]
    bad = torch.stack([~torch.isfinite(t).all() for _, t in named]).float()
    if n_proc > 1:
        distributed.all_reduce_sum_(bad)
    bad = bad.tolist()
    if any(bad):
        first = next(n for (n, _), b in zip(named, bad) if b)
        what = "loss" if first == "loss" else f"gradient of {first}"
        raise FloatingPointError(f"debug_nans: non-finite {what} at step {state.step}")


class Optimizer:
    """The JAX package's ``make_optimizer`` as optax computes it:
    ``[clip_by_global_norm] -> adam | adamw | adafactor`` with the
    learning-rate schedule, inside ``MultiSteps`` when ``grad_accum_steps >
    1``.

    * Clipping scales every gradient by ``max / ‖g‖`` when the global norm
      ``‖g‖`` reaches ``max`` (no epsilon), as ``optax.clip_by_global_norm``.
    * The schedule is evaluated at the count before the update, so with
      warm-up the first update uses learning rate 0.
    * ``MultiSteps`` keeps the running mean of ``k`` gradients and applies
      the inner chain once every ``k`` calls; the calls between change no
      parameter and no inner state.
    * A parameter without a gradient counts as a zero gradient, as JAX
      gives one.
    * ``adafactor`` is ``optax.adafactor(schedule)`` at optax 0.2.6's
      defaults (``optax/_src/factorized.py``, ``alias.py``): second moments
      decayed by ``1 - (count + 1)^-0.8`` over ``g² + 1e-30``, factored into
      row and column means where a parameter's second-largest dimension is at
      least 128 (``_factored_dims``), else one per entry (``v``); the update
      ``g / sqrt(v)`` clipped to an RMS of at most 1, scaled by the
      learning rate and by the parameter's RMS (at least 1e-3); no momentum,
      and no weight decay (the JAX package passes none).

    ``blocks`` names the parameters that are this rank's row block of a
    table split over ``model_group`` (``parallel/sharded_embedding.py``):
    their moments are blocks too (Adafactor's factored moment along the
    rows as well; the other factored moment is whole), and every statistic
    over a table's rows (the clipping norm, Adafactor's row means, its
    update RMS and parameter RMS) sums the blocks over the group, so the
    update is the one-process update of the whole table.
    """

    ADAFACTOR_MIN_DIM = 128
    ADAFACTOR_DECAY = 0.8
    ADAFACTOR_EPS = 1e-30
    ADAFACTOR_CLIP = 1.0
    ADAFACTOR_MIN_SCALE = 1e-3

    def __init__(self, params: Mapping[str, torch.nn.Parameter], tc: TrainConfig,
                 blocks: Optional[Mapping[str, RowBlock]] = None, model_group=None):
        if tc.optimizer not in ("adam", "adafactor"):
            raise ValueError(f"unknown optimizer {tc.optimizer!r} "
                             "(expected adam|adafactor)")
        self.params = dict(params)
        self.tc = tc
        self.blocks = dict(blocks or {})
        self.model_group = model_group
        self.b1, self.b2, self.eps = 0.9, 0.999, 1e-8
        zeros = lambda names=None: {n: torch.zeros_like(p) for n, p in self.params.items()  # noqa: E731
                                    if names is None or n in names}
        self.count = 0        # applied updates (the inner chain's and the schedule's count)
        self.mini_step = 0    # MultiSteps position within k
        self.acc = zeros() if tc.grad_accum_steps > 1 else None
        if tc.optimizer == "adam":
            self.trees = ("mu", "nu")
            self.mu, self.nu = zeros(), zeros()
        else:
            self.trees = ("v_row", "v_col", "v")
            self.factored = {n: self._factored_dims(self._full_shape(n))
                             for n in self.params}
            self.v = zeros({n for n, f in self.factored.items() if f is None})
            self.v_row, self.v_col = {}, {}
            for n, f in self.factored.items():
                if f is not None:
                    p = self.params[n]
                    d1, d0 = f
                    self.v_row[n] = torch.zeros(_drop(p.shape, d0), dtype=p.dtype,
                                                device=p.device)
                    self.v_col[n] = torch.zeros(_drop(p.shape, d1), dtype=p.dtype,
                                                device=p.device)
        if self.acc is not None:
            self.trees += ("acc",)
        # (tree, name) of the moments that are row blocks: every moment of a
        # block but the factored one that averages over the table's rows
        self.row_moments = {(t, n) for n in self.blocks for t in self.trees
                            if n in getattr(self, t)
                            and not (t == "v_row" and self.factored[n][1] == 0)
                            and not (t == "v_col" and self.factored[n][0] == 0)}

    def _full_shape(self, n: str) -> tuple:
        shape = tuple(self.params[n].shape)
        rb = self.blocks.get(n)
        return shape if rb is None else (rb.full_rows,) + shape[1:]

    def _mean(self, n: str, t: torch.Tensor, dim: Optional[int] = None,
              rows_axis: bool = True, keepdim: bool = False) -> torch.Tensor:
        """``t.mean(dim)`` over the whole table of ``n`` where ``t`` is a row
        block and the reduced axis (all of them for ``dim=None``) is the
        table's rows: the block sums added over the model group, divided by
        the whole count; else ``t``'s own mean."""
        rb = self.blocks.get(n)
        if rb is None or not rows_axis:
            return t.mean() if dim is None else t.mean(dim=dim, keepdim=keepdim)
        total = t.sum() if dim is None else t.sum(dim=dim, keepdim=keepdim)
        total = distributed.all_reduce_sum_(total.contiguous(), self.model_group)
        count = t.numel() // t.shape[0] * rb.full_rows if dim is None else rb.full_rows
        return total / count

    @classmethod
    def _factored_dims(cls, shape) -> Optional[tuple]:
        """optax's ``_factored_dims``: the axes of the second-largest and the
        largest dimension (numpy's ``argsort`` order), or None when the
        parameter has fewer than two axes or its second-largest dimension is
        below 128."""
        if len(shape) < 2:
            return None
        order = np.argsort(tuple(shape))
        if shape[order[-2]] < cls.ADAFACTOR_MIN_DIM:
            return None
        return int(order[-2]), int(order[-1])

    def learning_rate(self, count: int) -> float:
        tc = self.tc
        if tc.warm_up and count < tc.warm_up_steps:
            return tc.learning_rate * count / tc.warm_up_steps
        return tc.learning_rate

    @torch.no_grad()
    def step(self) -> None:
        """One optimizer call on the parameters' ``.grad``."""
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in self.params.items()}
        k = self.tc.grad_accum_steps
        if k > 1:
            for n, g in grads.items():
                self.acc[n] += (g - self.acc[n]) / (self.mini_step + 1)
            self.mini_step = (self.mini_step + 1) % k
            if self.mini_step != 0:
                return
            grads, self.acc = self.acc, {n: torch.zeros_like(a) for n, a in self.acc.items()}
        clip = self.tc.grad_clip_norm
        if clip > 0:
            norm = self.global_norm(grads)
            grads = {n: torch.where(norm < clip, g, (g / norm) * clip)
                     for n, g in grads.items()}
        lr = self.learning_rate(self.count)
        if self.tc.optimizer == "adafactor":
            self._adafactor(grads, lr)
        else:
            self._adam(grads, lr)
        self.count += 1

    def global_norm(self, grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """``‖g‖`` over every parameter of the whole model: each replicated
        gradient once, the squares of the row blocks summed over the model
        group (a collective when there are blocks)."""
        if not self.blocks:
            return torch.sqrt(sum((g.float() ** 2).sum() for g in grads.values()))
        sq = [(g.float() ** 2).sum() for n, g in grads.items() if n not in self.blocks]
        sq_rows = sum((grads[n].float() ** 2).sum() for n in self.blocks).reshape(1)
        return torch.sqrt(sum(sq) + distributed.all_reduce_sum_(sq_rows, self.model_group)[0])

    def _adam(self, grads: Dict[str, torch.Tensor], lr: float) -> None:
        """optax's adam (adamw with ``weight_decay``) as update ``count + 1``."""
        bc1 = 1.0 - self.b1 ** (self.count + 1)
        bc2 = 1.0 - self.b2 ** (self.count + 1)
        wd = self.tc.weight_decay
        for n, p in self.params.items():
            g = grads[n]
            mu = self.mu[n].mul_(self.b1).add_((1.0 - self.b1) * g)
            nu = self.nu[n].mul_(self.b2).add_((1.0 - self.b2) * g * g)
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if wd > 0:
                update = update + wd * p
            p.add_(update * -lr)

    def _adafactor(self, grads: Dict[str, torch.Tensor], lr: float) -> None:
        """optax's adafactor chain at count ``self.count``, in float32 as
        optax takes it: ``scale_by_factored_rms -> clip_by_block_rms ->
        scale_by_learning_rate -> scale_by_param_block_rms -> scale(-1)``."""
        f32 = np.float32
        rho = f32(1.0) - f32(self.count + 1) ** f32(-self.ADAFACTOR_DECAY)
        keep, new = float(rho), float(f32(1.0) - rho)
        for n, p in self.params.items():
            g = grads[n]
            g2 = g * g + self.ADAFACTOR_EPS
            if self.factored[n] is not None:
                d1, d0 = self.factored[n]
                # a mean reduces a row block's rows where it runs over axis 0
                v_row = self.v_row[n].mul_(keep).add_(
                    self._mean(n, g2, d0, rows_axis=d0 == 0) * new)
                v_col = self.v_col[n].mul_(keep).add_(
                    self._mean(n, g2, d1, rows_axis=d1 == 0) * new)
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_factor = (v_row / self._mean(n, v_row, reduced_d1, rows_axis=d1 == 0,
                                                 keepdim=True)).pow(-0.5)
                col_factor = v_col.pow(-0.5)
                update = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
            else:
                v = self.v[n].mul_(keep).add_(g2 * new)
                update = g * v.pow(-0.5)
            update = update / torch.clamp(
                torch.sqrt(self._mean(n, update * update)) / self.ADAFACTOR_CLIP, min=1.0)
            update = update * lr
            rms = torch.sqrt(self._mean(n, p * p))
            scale = torch.where(rms <= self.ADAFACTOR_MIN_SCALE,
                                torch.full_like(rms, self.ADAFACTOR_MIN_SCALE), rms)
            p.add_(update * scale * -1.0)

    def state_dict(self) -> Dict[str, Any]:
        """The optimizer's moments by parameter name (Adam's ``mu``/``nu``;
        Adafactor's factored ``v_row``/``v_col`` and per-entry ``v``), its
        count (the schedule's too), and ``MultiSteps``' position and
        accumulators (``acc``, with ``grad_accum_steps > 1``). The tensors
        are the optimizer's own, not copies."""
        out: Dict[str, Any] = {"count": self.count, "mini_step": self.mini_step}
        for key in self.trees:
            out[key] = dict(getattr(self, key))
        return out

    @torch.no_grad()
    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        """Copies a :meth:`state_dict` in, onto the parameters' devices;
        raises on another optimizer's state and on missing or unexpected
        names. A row moment given whole (a checkpoint's) is cut to this
        rank's rows."""
        if ("acc" in state) != (self.acc is not None):
            raise ValueError("the optimizer state's gradient accumulation does "
                             "not match grad_accum_steps")
        foreign = [k for k in ("mu", "nu", "v_row", "v_col", "v")
                   if k not in self.trees and state.get(k)]
        if foreign:
            raise ValueError(f"the optimizer state holds {foreign}, which "
                             f"{self.tc.optimizer} does not keep")
        # a tree without entries (no factored parameter) is not saved
        for key in self.trees:
            own = getattr(self, key)
            got = state.get(key, {})
            if set(got) != set(own):
                raise ValueError(f"optimizer state {key!r} names "
                                 f"{sorted(set(got) ^ set(own))} do not match")
            for n, t in got.items():
                t = torch.as_tensor(t)
                if (key, n) in self.row_moments:
                    t = local_rows({n: t}, self.blocks)[n]
                own[n].copy_(t)
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])


def _drop(shape, axis: int) -> tuple:
    """``shape`` without ``axis`` (numpy's ``np.delete`` of one entry)."""
    return tuple(s for i, s in enumerate(shape) if i != axis)


@dataclasses.dataclass
class TrainState:
    """Model (its parameters), optimizer state and step counter; updated in
    place by :meth:`Trainer.run_step`."""

    model: RecModel
    opt: Optimizer
    step: int = 0

    @property
    def params(self) -> Tensors:
        """The port's state dict (``models/convert.py`` converts it)."""
        return self.model.state_dict()


class Trainer:
    """Owns the dataset's device-resident feature tables and runs training
    steps, evaluation and the fit loop on one device: the CUDA card by
    default (which must exist), or ``device="cpu"``. In a
    ``torch.distributed`` group each rank runs one ``Trainer`` on its own
    device, its data row's slice of every batch and, with
    ``mesh.model_parallel_size > 1``, its row blocks of the sharded tables
    (each table module looks up over the mesh it was sharded with). A
    model axis wider than one needs that many processes: in one process it
    raises ``MeshConfig.mesh_shape``'s ``ValueError``.

    ``replay_ranks`` (one process only) trains on the global batches of a
    ``replay_ranks``-rank data-parallel run: every rank's block of each
    batch joined into one multi-block batch (``loader.join_blocks``), which
    ``RecModel.resolve_batch`` encodes block by block at the widths the
    ranks agree on. At dropout 0 it reproduces such a run on one device, up
    to the order of the float additions (the ranks draw their dropout masks
    at their own folded seeds, which one process does not)."""

    def __init__(self, cfg: Config, dataset: RecDataset,
                 device: Optional[str | torch.device] = None, replay_ranks: int = 1):
        tc = cfg.train
        if tc.auto_layouts:
            raise ValueError("auto_layouts chooses XLA memory layouts; it has no "
                             "meaning in the PyTorch port")
        # the multi-process feed: every rank holds the whole dataset, seeds
        # the same permutation and trains on its data row's slice of each
        # batch; the model peers of a row take the same slice
        self.n_proc = distributed.process_count()
        self.n_data, n_model = cfg.mesh.mesh_shape(self.n_proc)
        self.mesh = distributed.mesh_groups(n_model) if self.n_proc > 1 else None
        self.data_idx = self.mesh.data_index if self.mesh is not None else 0
        if replay_ranks > 1 and self.n_proc > 1:
            raise ValueError("replay_ranks replays a data-parallel run in one "
                             f"process, not in a group of {self.n_proc}")
        self._replay = replay_ranks
        self._sliced = self.n_proc > 1 or tc.sliced_feed or replay_ranks > 1
        for name, n in (("batch_size", max(self.n_data, replay_ranks)),
                        ("eval_batch_size", self.n_data)):
            if getattr(tc, name) % n:
                raise ValueError(f"train.{name} {getattr(tc, name)} does not split "
                                 f"over {n} processes")
        self.cfg = cfg
        self.dataset = dataset
        self.device = resolve_device(device)
        self.model_cfg = cfg.model.with_artifact_meta(dataset.meta)
        self.news_feats = {k: torch.as_tensor(v, device=self.device)
                           for k, v in dataset.news.as_dict().items()}
        self._feat_shapes = {k: tuple(v.shape) for k, v in self.news_feats.items()}
        # the family's structure (FEAT_KEYS, truncation lengths); each state
        # has its own instance
        self.model = build_model(self.model_cfg, self._feat_shapes)
        missing = [k for k in self.model.FEAT_KEYS if k not in self.news_feats]
        if missing:
            raise ValueError(
                f"model {self.model_cfg.name!r} needs news feature(s) {missing} "
                f"that this dataset does not provide (available: "
                f"{sorted(self.news_feats)})")
        self._length_split = self._make_length_split()
        self._eval_order = None
        # GNN: the depth of the neighborhood closure attached to dedup
        # batches (the model builds max(1, gnn_layers) GAT layers)
        self._frontier_depth = 0
        if self.model.WANTS_GNN_FRONTIER and dataset.news.neighbors is not None:
            self._frontier_depth = max(1, int(self.model_cfg.gnn_layers))
            if not tc.dedup_batches:
                print("WARNING: GNN family with dedup_batches=False: the frontier "
                      "closure attaches to dedup batches only, and the recursive "
                      "neighborhood expansion encodes 1+K+...+K^depth titles per "
                      "news. Set TrainConfig.dedup_batches=True.", file=sys.stderr)

    def _make_length_split(self) -> Optional[LengthSplit]:
        """Host spec of the length-bucketed unique-news encode (it must
        mirror the model's ``_feat_trunc``); None when the family opts out or
        no threshold is set."""
        if not self.model.LENGTH_SPLIT_OK:
            return None
        thr = self.model._feat_trunc()
        if not thr:
            return None
        news = self.dataset.news
        feat_lens = {k: (getattr(news, k) != 0).sum(axis=1).astype(np.int32)
                     for k in thr}
        return LengthSplit(feat_lens=feat_lens, thresholds=thr)

    # ---- state ----
    def init_state(self, seed: Optional[int] = None,
                   params: Optional[Mapping[str, torch.Tensor]] = None) -> TrainState:
        """A fresh state: ``params`` (a state dict, e.g. ``from_flax`` of
        JAX weights) or Flax's initializers drawn from ``seed`` (default
        ``train.seed``), then the dataset's pretrained tables."""
        model = build_model(self.model_cfg, self._feat_shapes)
        if params is not None:
            assign(model, params)
        else:
            seed = self.cfg.train.seed if seed is None else seed
            model.reset_parameters(torch.Generator().manual_seed(seed))
        self._apply_pretrained(model)
        # every rank drew the whole tables alike; each keeps its row blocks
        blocks = shard_tables(model, self.mesh)
        model.to(self.device)
        return TrainState(model, Optimizer(
            dict(model.named_parameters()), self.cfg.train, blocks,
            self.mesh.model_group if self.mesh is not None else None))

    def _apply_pretrained(self, model: RecModel) -> None:
        """Overwrites embedding tables with the dataset's pretrained matrices
        (GloVe words, entity vectors, and the BERT vectors that start
        ``nrms_bert``'s trainable table, as Flax's init copies them). A
        parameter matches by path suffix and exact shape; a matrix with the
        same rows and fewer columns loads into the first columns, the rest
        zero; a table whose name matches but whose shape does not (a matrix
        built for another vocabulary) raises instead of training from random
        init."""
        ds = self.dataset
        tables = {}
        if ds.word_embeddings is not None:
            tables["word_embedding/embedding"] = ds.word_embeddings
        if ds.entity_embeddings is not None:
            tables["entity_embedding/embedding"] = ds.entity_embeddings
        if ds.news.bert is not None:
            tables["bert_embedding/embedding"] = ds.news.bert
        if not tables:
            return
        loaded: Dict[str, list] = {s: [] for s in tables}
        mismatched: Dict[str, list] = {s: [] for s in tables}
        with torch.no_grad():
            for key, p in model.named_parameters():
                name = key.replace(".", "/")
                for suffix, mat in tables.items():
                    if not name.endswith(suffix):
                        continue
                    if tuple(p.shape) == mat.shape:
                        p.copy_(torch.from_numpy(np.asarray(mat, np.float32)))
                        loaded[suffix].append(name)
                    elif (mat.ndim == 2 and p.ndim == 2 and p.shape[0] == mat.shape[0]
                          and p.shape[1] > mat.shape[1]):
                        p.zero_()
                        p[:, :mat.shape[1]] = torch.from_numpy(np.asarray(mat, np.float32))
                        loaded[suffix].append(f"{name} (widened "
                                              f"{mat.shape[1]}->{p.shape[1]})")
                    else:
                        mismatched[suffix].append((name, tuple(p.shape)))
        problems = [
            f"pretrained table '{s}' of shape {tables[s].shape} matched "
            f"parameter {n} of shape {shp} by name but NOT by shape"
            for s, pairs in mismatched.items() if not loaded[s]
            for n, shp in pairs
        ]
        if problems:
            raise ValueError(
                "; ".join(problems) + " — the embedding artifacts disagree with "
                "the model config (stale GloVe matrix / wrong vocabulary?). "
                "Refusing to train from random init silently.")

    # ---- train ----
    def _to_device(self, batch) -> Tensors:
        return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v,
                                   device=self.device) for k, v in batch.items()}

    def _maybe_frontier(self, batch):
        """``batch`` with the GNN frontier attached (``add_gnn_frontier``,
        widths from ``train.gnn_frontier_buckets``, else
        ``GNN_FRONTIER_BUCKETS``) when the family wants it and the batch is
        a dedup batch without one; else ``batch`` as it is. Host numpy
        arrays or tensors."""
        if not (self._frontier_depth and "unique_ids" in batch
                and "gnn_frontier_ids" not in batch):
            return batch
        uids = batch["unique_ids"]
        uids = uids.cpu().numpy() if torch.is_tensor(uids) else np.asarray(uids)
        front = add_gnn_frontier({"unique_ids": uids}, self.dataset.news.neighbors,
                                 self._frontier_depth,
                                 self.cfg.train.gnn_frontier_buckets or GNN_FRONTIER_BUCKETS)
        return {**batch, **{k: v for k, v in front.items() if k != "unique_ids"}}

    def run_step(self, state: TrainState, batch):
        """One training step on a numpy (or device) batch, its dropout seeds
        drawn from :func:`step_generator` of ``(train.seed + 1,
        state.step)``. Returns ``(state, metrics)``; ``state`` is updated in
        place. With ``skip_nonfinite_updates``, a step whose loss is not
        finite leaves the parameters and the optimizer as they were; the
        step counter advances either way. With ``debug_nans``, a non-finite
        loss or gradient raises ``FloatingPointError`` before the update
        (one device sync a step; without the option the step adds none).

        In a group of several ranks, ``batch`` is this rank's data row's
        block (``loader.local_block``); the gradients, the loss and the
        accuracy are averaged over the ranks before the update (row blocks
        over the data group), and a non-finite mean loss skips the update on
        every rank."""
        batch = self._to_device(self._maybe_frontier(batch))
        model = state.model
        model.zero_grad(set_to_none=True)
        scores = model(batch, self.news_feats, deterministic=False,
                       generator=step_generator(self.cfg.train.seed + 1, state.step,
                                                self.data_idx))
        loss = training_loss(model, scores)
        model.aux_losses = {}
        metrics = {"loss": loss.detach(),
                   "acc": (scores.argmax(dim=-1) == 0).float().mean()}
        skip_nonfinite = self.cfg.train.skip_nonfinite_updates
        if self.n_proc > 1:
            # every rank joins the all-reduce, whatever its own loss
            loss.backward()
            self._all_reduce_grads(state, metrics)
            if self.cfg.train.debug_nans:
                _raise_nonfinite(state, metrics["loss"], self.n_proc)
            skip = skip_nonfinite and not bool(torch.isfinite(metrics["loss"]))
        else:
            skip = skip_nonfinite and not bool(torch.isfinite(loss))
            if not skip:
                loss.backward()
            if self.cfg.train.debug_nans:
                _raise_nonfinite(state, loss)
        if skip_nonfinite:
            metrics["skipped"] = float(skip)
        if not skip:
            state.opt.step()
        model.zero_grad(set_to_none=True)
        state.step += 1
        return state, metrics

    def _all_reduce_grads(self, state: TrainState, metrics: Dict[str, torch.Tensor]) -> None:
        """Replaces every parameter's gradient (0 where it has none) and the
        step's loss and accuracy by their means: the replicated parameters',
        the loss and the accuracy over the whole world, in one ``all_reduce``
        of one flat buffer (the counterpart of the ``psum`` of the JAX
        package's sharded gradients), and the row blocks' over the data
        group, in another. With equal slices the mean of the data rows'
        gradients is the gradient of the global batch's mean loss; the
        model peers of a row hold the same rows, and averaging their
        replicated gradients too gives them the same bits."""
        blocks = state.opt.blocks
        params = list(state.model.named_parameters())
        grad = lambda p: p.grad if p.grad is not None else torch.zeros_like(p)  # noqa: E731
        repl = [p for n, p in params if n not in blocks]
        rows = [p for n, p in params if n in blocks]
        scalars = torch.stack([metrics["loss"].float(), metrics["acc"].float()])
        *grads, scalars = distributed.all_reduce_mean([grad(p) for p in repl] + [scalars])
        for p, g in zip(repl, grads):
            p.grad = g
        if rows:
            for p, g in zip(rows, distributed.all_reduce_mean(
                    [grad(p) for p in rows], self.mesh.data_group)):
                p.grad = g
        metrics["loss"], metrics["acc"] = scalars[0], scalars[1]

    def check_replicas(self, state: TrainState) -> None:
        """Raises unless every rank holds the same parameters and optimizer
        state, and the ranks of each data group the same row blocks and
        their moments (a checksum of each tensor; nothing in one
        process)."""
        opt = state.opt.state_dict()
        blocks = state.opt.blocks
        repl = [p for n, p in state.model.named_parameters() if n not in blocks]
        rows = [p for n, p in state.model.named_parameters() if n in blocks]
        for key in state.opt.trees:
            for n, t in opt[key].items():
                (rows if (key, n) in state.opt.row_moments else repl).append(t)
        distributed.assert_replicated(repl, "the parameters or the optimizer state")
        if rows:
            distributed.assert_replicated(rows, "the table blocks or their moments",
                                          self.mesh.data_group)

    # ---- eval ----
    def _model_of(self, state_or_params) -> RecModel:
        if isinstance(state_or_params, TrainState):
            return state_or_params.model
        if isinstance(state_or_params, RecModel):
            return state_or_params
        # a state dict of whole tables or of this rank's blocks
        model = build_model(self.model_cfg, self._feat_shapes)
        assign(model, local_rows(state_or_params, shard_tables(model, self.mesh)))
        return model.to(self.device)

    @torch.no_grad()
    def compute_news_vectors(self, state_or_params) -> torch.Tensor:
        """The whole corpus encoded once, in chunks of ``eval_encode_chunk``
        news -> ``[N, D]``. With a length split the corpus is encoded in
        length order, chunks made only of short news at the truncated
        length (exact), and put back in id order with one gather. A
        ``CORPUS_LEVELWISE`` family (GNN) encodes level by level
        (``corpus_encode_levelwise``)."""
        model = self._model_of(state_or_params)
        chunk = self.cfg.train.eval_encode_chunk
        if model.CORPUS_LEVELWISE:
            return corpus_encode_levelwise(model, self.news_feats, chunk)
        n = self.dataset.news.n_news
        split = self._length_split
        order = inv = None
        n_short = 0
        if split is not None:
            if self._eval_order is None:
                short = split.is_short(np.arange(n))
                o = np.argsort(~short, kind="stable").astype(np.int64)
                iv = np.empty(n, np.int64)
                iv[o] = np.arange(n)
                self._eval_order = (torch.as_tensor(o, device=self.device),
                                    torch.as_tensor(iv, device=self.device),
                                    int(short.sum()))
            order, inv, n_short = self._eval_order
        trunc = model._feat_trunc() if split is not None else None
        outs = []
        for s in range(0, n, chunk):
            e = min(s + chunk, n)
            ids = torch.zeros(chunk, dtype=torch.int64, device=self.device)
            ids[:e - s] = (order[s:e] if order is not None
                           else torch.arange(s, e, device=self.device))
            outs.append(model.encode_news_ids(
                ids, self.news_feats, True, trunc if s + chunk <= n_short else None))
        vecs = torch.cat(outs)[:n]
        return vecs[inv] if inv is not None else vecs

    @torch.no_grad()
    def score_split(self, state_or_params, data: DevData,
                    max_impressions: Optional[int] = None) -> Dict[int, np.ndarray]:
        """Scores a ragged split in candidate-count buckets: ``{impression
        row: [n_candidates] float32 scores}``; impressions without a
        candidate are absent. Two-tower when the family allows it (the
        corpus encoded once). With the multi-process feed each rank scores
        its data row's rows of every padded batch and the score blocks are
        gathered over the data group in row order, so every rank returns the
        same scores."""
        model = self._model_of(state_or_params)
        bs = self.cfg.train.eval_batch_size
        two_tower = self.cfg.train.eval_two_tower and model.TWO_TOWER
        news_vecs = self.compute_news_vectors(model) if two_tower else None
        rows = distributed.process_local_slice(bs, self.data_idx, self.n_data)
        data_group = self.mesh.data_group if self.mesh is not None else None

        metas: list = []

        def host_iter():
            for eb in eval_batches(data, bs, self.cfg.data.eval_buckets,
                                   max_impressions):
                padded, b = pad_batch(eb.batch, bs)
                metas.append((b, eb))
                yield {k: v[rows] for k, v in padded.items()}

        all_scores: Dict[int, np.ndarray] = {}
        for batch in device_prefetch(host_iter(), self.device):
            b, eb = metas.pop(0)
            if two_tower:
                s = model.score_from_vecs(batch, news_vecs, self.news_feats)
            else:
                s = model(batch, self.news_feats, deterministic=True)
            s = distributed.fetch_global(s.float(), data_group)[:b]
            for j, imp in enumerate(eb.impression_ids):
                all_scores[int(imp)] = s[j, :eb.n_candidates[j]]
        return all_scores

    def evaluate(self, state_or_params, split: Optional[DevData] = None,
                 max_impressions: Optional[int] = None) -> Dict[str, float]:
        """Scores a ragged eval split (:meth:`score_split`) and computes
        impression-level AUC/MRR/nDCG on the host, each impression's scores
        cut to its true candidate count."""
        data = split if split is not None else self.dataset.dev
        if data is None:
            raise ValueError("no dev split to evaluate")
        if max_impressions is None:
            max_impressions = self.cfg.train.max_dev_samples
        all_scores = self.score_split(state_or_params, data, max_impressions)
        labels, scores = [], []
        for imp, sc in all_scores.items():
            if self.cfg.train.debug_nans and not np.isfinite(sc).all():
                raise FloatingPointError(f"debug_nans: non-finite score in eval impression {imp}")
            _, y = data.impression(imp)
            labels.append(y[:len(sc)])
            scores.append(sc)
        out = M.aggregate_metrics(labels, scores)
        out["n_impressions"] = float(len(labels))
        return out

    # ---- full fit loop ----
    def sliced_batches(self, rng: np.random.Generator):
        """One epoch of the multi-process feed (``train_batches_sliced``,
        the GNN frontier built per block at the widths all ranks agree on),
        shuffled by ``rng``: this rank's data row's block of every global
        batch (``local_block``), or with ``replay_ranks`` every row's blocks
        joined. Host numpy batches."""
        tc = self.cfg.train

        def feed(h, n, r):
            return train_batches_sliced(
                self.dataset.train, tc.batch_size, r, process_index=h, process_count=n,
                dedup=tc.dedup_batches,
                unique_buckets=tc.unique_buckets or DEFAULT_UNIQUE_BUCKETS,
                length_split=self._length_split,
                gnn_neighbors=self.dataset.news.neighbors if self._frontier_depth else None,
                gnn_depth=self._frontier_depth, gnn_buckets=tc.gnn_frontier_buckets)
        if self._replay > 1:
            # every block shuffles with the same permutation: copies of
            # rng's state, the last block's feed advancing rng itself
            rngs = [copy.deepcopy(rng) for _ in range(self._replay - 1)] + [rng]
            return map(join_blocks,
                       zip(*(feed(h, self._replay, r) for h, r in enumerate(rngs))))
        return map(lambda b: local_block(b, self.data_idx, self.n_data),
                   feed(self.data_idx, self.n_data, rng))

    def fit(
        self,
        state: Optional[TrainState] = None,
        num_epochs: Optional[int] = None,
        log_fn: Optional[Callable[[Dict[str, Any]], None]] = None,
        checkpoint_cb: Optional[Callable[[TrainState, Dict[str, float], int], None]] = None,
        eval_each_epoch: bool = True,
    ):
        """Epoch loop: eval every ``eval_step`` steps and at each epoch end;
        ``checkpoint_cb`` fires when dev AUC improves past the floor
        (``auc_checkpoint_floor``); early stopping after
        ``require_improvement`` steps without a gain. Returns ``(state,
        history)``."""
        cfg = self.cfg
        if state is None:
            state = self.init_state()
        shuffle_rng = np.random.default_rng(cfg.train.seed)
        epochs = num_epochs if num_epochs is not None else cfg.train.num_epochs
        best_auc = cfg.train.auc_checkpoint_floor
        history = []
        step_i = 0
        best_step = 0
        stop = False
        t0 = time.time()
        log = log_fn or (lambda d: None)

        def maybe_eval(tag):
            nonlocal best_auc, best_step, stop
            if self.dataset.dev is None or len(self.dataset.dev) == 0:
                return
            self.check_replicas(state)
            t_ev = time.time()
            m = self.evaluate(state)
            m["eval_s"] = round(time.time() - t_ev, 2)
            m["tag"] = tag
            m["step"] = step_i
            history.append(m)
            if m["auc"] > best_auc:
                best_auc = m["auc"]
                best_step = step_i
                if checkpoint_cb is not None:
                    t_ck = time.time()
                    checkpoint_cb(state, m, step_i)
                    m["ckpt_s"] = round(time.time() - t_ck, 2)
            elif (cfg.train.require_improvement
                  and step_i - best_step >= cfg.train.require_improvement):
                stop = True
                log({"tag": "early_stop", "step": step_i,
                     "best_step": best_step, "best_auc": best_auc})
            log(m)

        ub = cfg.train.unique_buckets or DEFAULT_UNIQUE_BUCKETS
        for epoch in range(epochs):
            if self._sliced:
                host_iter = self.sliced_batches(shuffle_rng)
            else:
                host_iter = train_batches(self.dataset.train, cfg.train.batch_size,
                                          shuffle_rng, dedup=cfg.train.dedup_batches,
                                          unique_buckets=ub,
                                          length_split=self._length_split)
            # the GNN frontier is built in the prefetch thread, off the step
            for batch in device_prefetch(map(self._maybe_frontier, host_iter),
                                         self.device):
                state, metrics = self.run_step(state, batch)
                step_i += 1
                if step_i % cfg.train.log_every == 0:
                    log({"step": step_i, "epoch": epoch,
                         "loss": float(metrics["loss"]),
                         "acc": float(metrics["acc"]),
                         "elapsed_s": round(time.time() - t0, 2)})
                if cfg.train.eval_step and step_i % cfg.train.eval_step == 0:
                    maybe_eval(f"step{step_i}")
                    if stop:
                        return state, history
            if eval_each_epoch:
                maybe_eval(f"epoch{epoch}")
                if stop:
                    return state, history
        return state, history
