"""Training cells: ``Trainer.run_step`` over the feed that ``Trainer.fit``
uses, through ``device_prefetch``, with no evaluation in the window. As in
``fit``, whatever the feed builds for a batch (the dedup layout, the length
split, and for a family with a news graph the GNN frontier) is built in the
prefetch thread, off the stepping thread.

One rank (``traffic["ranks"]`` = 1) runs in the benchmark's process. More
ranks run in processes of their own, one a card, over NCCL through the
program's ``parallel/distributed.initialize``, each on its slice of every
global batch (``Trainer.sliced_batches``); the window stops on every rank
at the same step, agreed over a second (gloo) group.

A rank's run:

1. set-up: the corpus and click log from the seed, the program's
   ``Trainer``, the seeded weights made on the card and handed to
   ``init_state``; then the first three steps through the window's own call
   and feed, recording each step's loss, the gradient Adam got at step one
   (its first moment over ``1 - b1``) and the parameters' change after step
   three, by leaf norm; then warm-up steps;
2. the window: steps until ``--seconds`` have passed on the host clock,
   then one device sync; the rate is all impressions over all that time;
3. with ``--trace 1``, a stretch of steps under ``torch.profiler`` right
   after the window, with the benchmark's spans around the feed's ``next``,
   ``run_step``, the encoder's forward wrapper and the gradient all-reduce.

The epochs chain in one prefetch thread, each reshuffled by the same
generator, as ``fit`` reshuffles; a copy of that generator gives the
reference and the work counts the same rows.
"""

from __future__ import annotations

import copy
import itertools
import os
import tempfile
import time
from typing import Dict, List

import numpy as np

from h100bench import checks as CK
from h100bench import core, counting, devtrace, port, reference, weights
from h100bench import traffic as T

B1 = 0.9
SHUFFLE_STREAM = 7


def _feed(trainer, ds, cfg, rng, sliced: bool):
    """Every epoch's host batches, as ``fit`` makes them: one rank's
    ``train_batches`` with ``trainer._maybe_frontier`` mapped over them (it
    returns a batch as it is for a family without a frontier), or a rank's
    ``sliced_batches``, which build the frontier themselves. Run inside
    ``device_prefetch``, so all of it runs in the prefetch thread."""
    from pytorch_news_recommender_tpu_torch.data.loader import (
        DEFAULT_UNIQUE_BUCKETS, train_batches,
    )

    tc = cfg.train
    for _ in itertools.count():
        if sliced:
            yield from trainer.sliced_batches(rng)
        else:
            yield from map(trainer._maybe_frontier, train_batches(
                ds.train, tc.batch_size, rng, dedup=tc.dedup_batches,
                unique_buckets=tc.unique_buckets or DEFAULT_UNIQUE_BUCKETS,
                length_split=trainer._length_split))


class Rows:
    """The global rows of every step, replayed from a copy of the feed's
    shuffling generator."""

    def __init__(self, rng: np.random.Generator, n: int, batch: int):
        self.rng, self.n, self.batch = rng, n, batch
        self.per_epoch = n // batch
        self.orders: List[np.ndarray] = []

    def step(self, k: int) -> np.ndarray:
        e, j = divmod(k, self.per_epoch)
        while len(self.orders) <= e:
            o = np.arange(self.n)
            self.rng.shuffle(o)
            self.orders.append(o)
        return self.orders[e][j * self.batch:(j + 1) * self.batch]


class Inputs:
    """A run's corpus and click log, and the global rows of every step."""

    def __init__(self, cell: core.Cell, seed: int, ranks: int = 1):
        self.cell, self.seed, self.ranks = cell, seed, ranks
        cfgj = cell.config
        self.fam = reference.family(cfgj["family"])
        counting.family_work(self.fam)   # a family that cannot count its work stops here
        self.model = cfgj["port"]["model"]
        self.corpus = T.make_corpus(cfgj, seed)
        self.log = T.make_click_log(cfgj, cell.traffic, self.corpus, seed)
        self.shuffle = T.rng_for(seed, SHUFFLE_STREAM)
        self.rows = Rows(copy.deepcopy(self.shuffle), len(self.log.browsed),
                         int(cfgj["port"]["train"]["batch_size"]))

    def slices(self, k: int):
        """Step ``k``'s global rows as ``(browsed, candidates)``."""
        rows = self.rows.step(k)
        return self.log.browsed[rows], self.log.candidates[rows]


class RankRun:
    """One rank's system under test and its feed."""

    def __init__(self, cell: core.Cell, seed: int, device: str, rank: int = 0, ranks: int = 1):
        import torch

        from pytorch_news_recommender_tpu_torch.data.prefetch import device_prefetch
        from pytorch_news_recommender_tpu_torch.train.loop import Trainer

        self.inputs = Inputs(cell, seed, ranks)
        self.cell, self.seed, self.rank, self.ranks = cell, seed, rank, ranks
        cfgj = cell.config
        self.cfg = port.config(cfgj, seed)
        self.ds = port.dataset(cfgj, self.inputs.corpus, self.inputs.log)
        self.trainer = Trainer(self.cfg, self.ds, device=device)
        self.device = self.trainer.device
        self.W0 = weights.make(self.inputs.fam.leaves(self.inputs.model, cfgj["corpus"]), seed,
                               self.device)
        self.state = self.trainer.init_state(params=self.W0)
        self.batches = device_prefetch(_feed(self.trainer, self.ds, self.cfg,
                                             self.inputs.shuffle, ranks > 1), self.device)
        self.steps = 0
        self.torch = torch

    def sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def step(self, spans: core.Spans | None = None):
        if spans is None:
            batch = next(self.batches)
            self.state, m = self.trainer.run_step(self.state, batch)
        else:
            batch = spans.wrap("feed_next", next)(self.batches)
            self.state, m = spans.wrap("run_step", self.trainer.run_step)(self.state, batch)
        self.steps += 1
        return m

    def check_steps(self, n: int = 3) -> Dict:
        """The first ``n`` steps, and what the comparison reads of them."""
        losses, grad = [], None
        for k in range(n):
            m = self.step()
            losses.append(float(m["loss"]))
            if k == 0:
                mu = self.state.opt.mu
                grad = CK.norms({name: t / (1 - B1) for name, t in mu.items()})
        params = dict(self.state.model.named_parameters())
        change = CK.norms({name: params[name].detach() - w for name, w in self.W0.items()})
        self.W0 = None   # the reference makes the weights again
        return {"losses": losses, "grad": grad, "change": change}

    def window(self, seconds: float, stop=None) -> Dict:
        """Steps until ``seconds`` have passed (``stop(steps, elapsed)``
        decides on several ranks), then a device sync."""
        torch = self.torch
        bad = torch.zeros((), dtype=torch.int64, device=self.device)
        waits = []
        self.sync()
        first = self.steps
        t0 = time.perf_counter()
        e0 = time.time()
        c0, p0 = time.thread_time(), time.process_time()
        while True:
            tw = time.perf_counter()
            batch = next(self.batches)
            waits.append(time.perf_counter() - tw)
            self.state, m = self.trainer.run_step(self.state, batch)
            self.steps += 1
            bad += (~torch.isfinite(m["loss"])).to(torch.int64)
            elapsed = time.perf_counter() - t0
            if (stop(self.steps - first, elapsed) if stop else elapsed >= seconds):
                break
        self.sync()
        t1 = time.perf_counter()
        # how busy the host was: the stepping thread's and the whole
        # process's CPU seconds over the window's (printed, not compared)
        host = {"main_thread": (time.thread_time() - c0) / (t1 - t0),
                "process": (time.process_time() - p0) / (t1 - t0)}
        return {"first": first, "steps": self.steps - first, "seconds": t1 - t0,
                "start_epoch": e0, "bad_steps": int(bad), "feed_wait": waits,
                "host_cpu_share": host}

    def traced(self, n_steps: int, trace_path: str) -> Dict:
        """``n_steps`` steps under the profiler, spans on; the trace is
        written to ``trace_path``."""
        import pytorch_news_recommender_tpu_torch.models.layers as layers
        from pytorch_news_recommender_tpu_torch.parallel import distributed
        from torch.profiler import ProfilerActivity, profile, record_function

        spans = core.Spans()
        saved = (layers.fused_news_encoder, distributed.all_reduce_mean)
        layers.fused_news_encoder = spans.wrap("encoder_fwd", saved[0])
        distributed.all_reduce_mean = spans.wrap("all_reduce_mean", saved[1])
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        try:
            # the profiler's first use in a process starts its tracer:
            # a short one first, discarded, keeps that out of the stretch
            with profile(activities=acts):
                self.step()
            first = self.steps
            self.sync()
            with profile(activities=acts) as prof:
                with record_function(devtrace.WINDOW):
                    t0 = time.perf_counter()
                    for _ in range(n_steps):
                        self.step(spans)
                    self.sync()
                    wall = time.perf_counter() - t0
            prof.export_chrome_trace(trace_path)
        finally:
            layers.fused_news_encoder, distributed.all_reduce_mean = saved
        return {"first": first, "steps": n_steps, "wall": wall,
                "durations": spans.durations, "counts": spans.counts}

    def close(self) -> None:
        self.batches.close()
        self.trainer = self.state = self.batches = None


def work_of(inp: Inputs, first: int, steps: int, rank_slice: int | None) -> counting.Work:
    """What steps ``first .. first + steps`` needed: of the whole global
    batch (``rank_slice`` None) or of one rank's slice."""
    w = counting.Work()
    lens = port.feature_lengths(inp.corpus)
    for k in range(first, first + steps):
        b, c = inp.slices(k)
        if rank_slice is not None:
            per = len(b) // inp.ranks
            b, c = b[rank_slice * per:(rank_slice + 1) * per], c[rank_slice * per:(rank_slice + 1) * per]
        counting.step_work(w, inp.model, lens, [(b, c)], inp.fam)
    return w


def reference_numbers(cell: core.Cell, seed: int, device, ranks: int, batches,
                      precision: str = "float32", ref=None) -> tuple:
    """The reference's three steps (and, for ``precision`` other than
    float32, the control's numbers against it): ``(ref, numbers)``."""
    from h100bench.reference import common as C
    from h100bench.reference import train as RT

    cfgj = cell.config
    fam = reference.family(cfgj["family"])
    model = cfgj["port"]["model"]
    corpus = T.make_corpus(cfgj, seed)
    feats = port.reference_feats(corpus, device)
    title_len = port.feature_lengths(corpus)["title_len"]
    lr = float(cfgj["port"]["train"]["learning_rate"])

    def one(p):
        W0 = weights.make(fam.leaves(model, cfgj["corpus"]), seed, device)
        out = RT.run(fam, model, lr, port.train_seed(seed), W0, feats, title_len, batches,
                     ranks, p)
        out["change"] = {n: out["params"][n] - W0[n] for n in W0}
        del out["params"]
        return out

    if ref is None:
        ref = one(C.F32)
    if precision == "float32":
        return ref, None
    ctl = one(C.Precision(precision))
    return ref, CK.train_numbers(ctl["losses"], CK.norms(ctl["grad"]),
                                 CK.norms(ctl["change"]), ref)


def run(ctx) -> Dict:
    """One training run of ``ctx.cell``; returns the result's pieces."""
    ranks = int(ctx.cell.traffic.get("ranks", 1))
    if ranks > 1:
        from h100bench.drivers import train_dp

        return train_dp.run(ctx, ranks)
    import torch

    cell = ctx.cell
    sess = RankRun(cell, ctx.seed, ctx.device)
    prog = sess.check_steps()
    warm = int(cell.spec.get("warmup_steps", 20))
    for _ in range(max(0, warm - sess.steps)):
        sess.step()
    sess.sync()
    win = sess.window(ctx.seconds)
    traced = None
    trace_path = None
    if ctx.trace:
        fd, trace_path = tempfile.mkstemp(prefix="h100bench-trace-", suffix=".json")
        os.close(fd)
        traced = sess.traced(int(cell.spec.get("trace_steps", 8)), trace_path)
    peak = torch.cuda.max_memory_allocated(sess.device) if sess.device.type == "cuda" else 0
    sess.close()
    B = sess.cfg.train.batch_size
    out = {"attempted": win["steps"] * B, "failed": win["bad_steps"] * B,
           "setup_s": win["start_epoch"] - ctx.t0, "memory_peak_bytes": peak,
           "metrics": {"train_impressions_per_s": {
               "value": win["steps"] * B / win["seconds"], "unit": "impressions/s"}}}
    step_work = work_of(sess.inputs, win["first"], win["steps"], None)
    if ctx.trace:
        tr = devtrace.load(trace_path)
        os.unlink(trace_path)
        rec = core.Record(kind="train", ranks=1, chips=1, trace=tr,
                          spans={**traced["durations"], "feed_wait": win["feed_wait"]},
                          counts={**traced["counts"], "traced_steps": traced["steps"]},
                          work=work_of(sess.inputs, traced["first"], traced["steps"], None),
                          step_work=step_work, window_s=win["seconds"])
        out["record"] = rec
    if sess.device.type == "cuda":
        torch.cuda.empty_cache()
    batches = [sess.inputs.slices(k) for k in range(3)]
    ref, _ = reference_numbers(cell, ctx.seed, sess.device, 1, batches)
    out["numbers"] = CK.train_numbers(prog["losses"], prog["grad"], prog["change"], ref)
    # what the traffic gave the window's steps (printed, not compared)
    out["numbers"]["inputs_per_step"] = {k: round(v, 1) for k, v in step_work.per_step().items()}
    out["numbers"]["host_cpu_share"] = {k: round(v, 3) for k, v in win["host_cpu_share"].items()}
    return out
