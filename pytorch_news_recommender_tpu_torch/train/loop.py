"""Training and evaluation engine (port of the JAX package's
``train/loop.py``, single device).

Adam with optional linear warm-up, global-norm clipping, AdamW and gradient
accumulation, written out to follow optax's arithmetic step for step;
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

Not ported yet, and refused with the ``ROADMAP.md`` item that ports them:
Adafactor, the multi-process feed (``sliced_feed``), and mesh and model
parallelism.
"""

from __future__ import annotations

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
    pad_batch,
    train_batches,
)
from pytorch_news_recommender_tpu_torch.data.prefetch import device_prefetch
from pytorch_news_recommender_tpu_torch.models import build_model
from pytorch_news_recommender_tpu_torch.models.common import RecModel, corpus_encode_levelwise
from pytorch_news_recommender_tpu_torch.models.convert import assign
from pytorch_news_recommender_tpu_torch.serve import resolve_device
from pytorch_news_recommender_tpu_torch.train import metrics as M

Tensors = Dict[str, torch.Tensor]


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator that draws step ``step``'s dropout seeds: a
    function of ``(seed, step)`` alone (the JAX package's
    ``fold_in(PRNGKey(seed), step)``; the streams differ)."""
    return torch.Generator().manual_seed(
        ((int(seed) & 0xFFFFFFFF) << 32) | (int(step) & 0xFFFFFFFF))


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


class Optimizer:
    """The JAX package's ``make_optimizer`` as optax computes it:
    ``[clip_by_global_norm] -> adam | adamw -> learning-rate schedule``,
    inside ``MultiSteps`` when ``grad_accum_steps > 1``.

    * Clipping scales every gradient by ``max / ‖g‖`` when the global norm
      ``‖g‖`` reaches ``max`` (no epsilon), as ``optax.clip_by_global_norm``.
    * The schedule is evaluated at the count before the update, so with
      warm-up the first update uses learning rate 0.
    * ``MultiSteps`` keeps the running mean of ``k`` gradients and applies
      the inner chain once every ``k`` calls; the calls between change no
      parameter and no inner state.
    * A parameter without a gradient counts as a zero gradient, as JAX
      gives one.
    """

    def __init__(self, params: Mapping[str, torch.nn.Parameter], tc: TrainConfig):
        if tc.optimizer == "adafactor":
            raise NotImplementedError(
                "the adafactor optimizer is not ported yet (ROADMAP.md A.8)")
        if tc.optimizer != "adam":
            raise ValueError(f"unknown optimizer {tc.optimizer!r} "
                             "(expected adam|adafactor)")
        self.params = dict(params)
        self.tc = tc
        self.b1, self.b2, self.eps = 0.9, 0.999, 1e-8
        zeros = lambda: {n: torch.zeros_like(p) for n, p in self.params.items()}  # noqa: E731
        self.mu, self.nu = zeros(), zeros()
        self.count = 0        # applied updates (adam's and the schedule's count)
        self.mini_step = 0    # MultiSteps position within k
        self.acc = zeros() if tc.grad_accum_steps > 1 else None

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
            norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads.values()))
            grads = {n: torch.where(norm < clip, g, (g / norm) * clip)
                     for n, g in grads.items()}
        lr = self.learning_rate(self.count)
        self.count += 1
        bc1 = 1.0 - self.b1 ** self.count
        bc2 = 1.0 - self.b2 ** self.count
        wd = self.tc.weight_decay
        for n, p in self.params.items():
            g = grads[n]
            mu = self.mu[n].mul_(self.b1).add_((1.0 - self.b1) * g)
            nu = self.nu[n].mul_(self.b2).add_((1.0 - self.b2) * g * g)
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if wd > 0:
                update = update + wd * p
            p.add_(update * -lr)

    def state_dict(self) -> Dict[str, Any]:
        """Adam's moments ``mu``/``nu`` by parameter name and its count (the
        warm-up schedule's count too), and ``MultiSteps``' position and
        accumulators (``acc``, with ``grad_accum_steps > 1``). The tensors
        are the optimizer's own, not copies."""
        out: Dict[str, Any] = {"count": self.count, "mini_step": self.mini_step,
                               "mu": dict(self.mu), "nu": dict(self.nu)}
        if self.acc is not None:
            out["acc"] = dict(self.acc)
        return out

    @torch.no_grad()
    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        """Copies a :meth:`state_dict` in, onto the parameters' devices;
        raises on missing or unexpected names."""
        keys = ("mu", "nu") + (("acc",) if self.acc is not None else ())
        if ("acc" in state) != (self.acc is not None):
            raise ValueError("the optimizer state's gradient accumulation does "
                             "not match grad_accum_steps")
        for key in keys:
            own = getattr(self, key)
            if set(state[key]) != set(own):
                raise ValueError(f"optimizer state {key!r} names "
                                 f"{sorted(set(state[key]) ^ set(own))} do not match")
            for n, t in state[key].items():
                own[n].copy_(torch.as_tensor(t))
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])


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
    default (which must exist), or ``device="cpu"``."""

    def __init__(self, cfg: Config, dataset: RecDataset,
                 device: Optional[str | torch.device] = None):
        tc = cfg.train
        if tc.sliced_feed:
            raise NotImplementedError("the multi-process feed (sliced_feed) is "
                                      "not ported yet (ROADMAP.md A.6)")
        if cfg.mesh.model_parallel_size > 1:
            raise NotImplementedError("mesh and model-parallel training are not "
                                      "ported yet (ROADMAP.md A.6)")
        if tc.auto_layouts:
            raise ValueError("auto_layouts chooses XLA memory layouts; it has no "
                             "meaning in the PyTorch port")
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
        model.to(self.device)
        return TrainState(model, Optimizer(dict(model.named_parameters()),
                                           self.cfg.train))

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
        step counter advances either way."""
        batch = self._to_device(self._maybe_frontier(batch))
        model = state.model
        model.zero_grad(set_to_none=True)
        scores = model(batch, self.news_feats, deterministic=False,
                       generator=step_generator(self.cfg.train.seed + 1, state.step))
        loss = training_loss(model, scores)
        model.aux_losses = {}
        metrics = {"loss": loss.detach(),
                   "acc": (scores.argmax(dim=-1) == 0).float().mean()}
        skip = False
        if self.cfg.train.skip_nonfinite_updates:
            skip = not bool(torch.isfinite(loss))
            metrics["skipped"] = float(skip)
        if not skip:
            loss.backward()
            state.opt.step()
        model.zero_grad(set_to_none=True)
        state.step += 1
        return state, metrics

    # ---- eval ----
    def _model_of(self, state_or_params) -> RecModel:
        if isinstance(state_or_params, TrainState):
            return state_or_params.model
        if isinstance(state_or_params, RecModel):
            return state_or_params
        model = build_model(self.model_cfg, self._feat_shapes)
        assign(model, state_or_params)
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
        corpus encoded once)."""
        model = self._model_of(state_or_params)
        bs = self.cfg.train.eval_batch_size
        two_tower = self.cfg.train.eval_two_tower and model.TWO_TOWER
        news_vecs = self.compute_news_vectors(model) if two_tower else None

        metas: list = []

        def host_iter():
            for eb in eval_batches(data, bs, self.cfg.data.eval_buckets,
                                   max_impressions):
                padded, b = pad_batch(eb.batch, bs)
                metas.append((b, eb))
                yield padded

        all_scores: Dict[int, np.ndarray] = {}
        for batch in device_prefetch(host_iter(), self.device):
            b, eb = metas.pop(0)
            if two_tower:
                s = model.score_from_vecs(batch, news_vecs, self.news_feats)
            else:
                s = model(batch, self.news_feats, deterministic=True)
            s = s.float().cpu().numpy()[:b]
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
            _, y = data.impression(imp)
            labels.append(y[:len(sc)])
            scores.append(sc)
        out = M.aggregate_metrics(labels, scores)
        out["n_impressions"] = float(len(labels))
        return out

    # ---- full fit loop ----
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
