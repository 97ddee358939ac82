"""Serving cells: the program's ``RecommenderServer`` on localhost, as
``cli serve`` runs it with the cell's ``server`` settings (the batching
window, the largest batch, the corpus cache), under open-loop load from
``client.py`` in a process of its own.

Set-up: the corpus and the seeded weights, the ``Recommender`` (its corpus
encode), the daemon with its own warm-up, every candidate width the batcher
pads to and ``top_k`` once more, then the client's warm-up requests. The
window: the schedule of ``traffic.make_requests`` at the traffic's rate,
each request timed from its due time. With ``--trace 1`` the benchmark
wraps the ``Recommender``'s ``score_many`` and ``top_k`` in spans and
profiles one stretch in the middle of the window. After it the daemon
stops, and a sample of the replies drawn from the seed (the longest
``/score`` requests in it) is held to the reference.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, Optional

import numpy as np

from h100bench import checks as CK
from h100bench import core, devtrace, port, reference, weights
from h100bench import traffic as T

SCORE_SAMPLE, LONGEST, TOPK_SAMPLE = 512, 16, 256
CLIENT = core.ROOT / "client.py"


def sample_of(reqs: T.Requests, seed: int) -> np.ndarray:
    """The requests whose replies are checked: up to ``SCORE_SAMPLE``
    ``/score`` requests, the ``LONGEST`` among them, and up to
    ``TOPK_SAMPLE`` ``/top_k`` requests, drawn from the seed."""
    rng = T.rng_for(seed, T.STREAM_SAMPLE)
    score = np.where(reqs.kind == 0)[0]
    topk = np.where(reqs.kind == 1)[0]
    lens = np.diff(reqs.cand_off)[score]
    longest = score[np.argsort(-lens, kind="stable")[:LONGEST]]
    rest = np.setdiff1d(score, longest)
    pick = rng.choice(rest, size=min(len(rest), SCORE_SAMPLE - len(longest)), replace=False)
    top = rng.choice(topk, size=min(len(topk), TOPK_SAMPLE), replace=False)
    return np.sort(np.concatenate([longest, pick, top])).astype(np.int64)


def percentile(values: np.ndarray, q: float) -> float:
    """The nearest-rank ``q``-th percentile; NaN (a failed request) sorts
    last, as a request that never came."""
    v = np.sort(np.where(np.isnan(values), np.inf, values))
    if not len(v):
        return math.nan
    return float(v[max(0, int(math.ceil(q / 100 * len(v))) - 1)])


class Service:
    """The daemon of one seed, up until :meth:`stop`."""

    def __init__(self, cell: core.Cell, seed: int, device: str):
        from pytorch_news_recommender_tpu_torch.serve import Recommender
        from pytorch_news_recommender_tpu_torch.server import RecommenderServer

        self.cell, self.seed = cell, seed
        cfgj = cell.config
        self.fam = reference.family(cfgj["family"])
        self.corpus = T.make_corpus(cfgj, seed)
        s = cell.spec["server"]
        W = weights.make(self.fam.leaves(cfgj["port"]["model"], cfgj["corpus"]), seed, device)
        self.rec = Recommender(port.config(cfgj, seed), port.dataset(cfgj, self.corpus), W,
                               corpus_cache=s["corpus_cache"], device=device)
        del W
        self.device = self.rec.device
        self.srv = RecommenderServer(self.rec, host="127.0.0.1", port=0,
                                     batch_window_ms=float(s["batch_window_ms"]),
                                     max_batch=int(s["max_batch"]))
        self.srv.start(block=False)
        # every width the batcher pads to, and corpus retrieval
        for w in self.rec.widths:
            self.rec.score_many([([1, 2], list(range(1, w + 1)), 0)])
        self.rec.top_k([1, 2], k=int(cell.traffic["k"]))
        self.sync()
        self.spans: Optional[core.Spans] = None

    def sync(self) -> None:
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)

    def instrument(self) -> core.Spans:
        """Spans around the ``Recommender``'s ``score_many`` (counting its
        requests) and ``top_k``."""
        sp = core.Spans()
        self.rec.score_many = sp.wrap("score_many", self.rec.score_many,
                                      count=lambda reqs: len(reqs))
        self.rec.top_k = sp.wrap("top_k", self.rec.top_k)
        self.spans = sp
        return sp

    def load(self, reqs: T.Requests, sample: np.ndarray, lead_s: float = 0.3,
             profile_at: Optional[float] = None, profile_s: float = 1.0,
             trace_path: Optional[str] = None) -> Dict:
        """One window of ``reqs`` from a client process; with
        ``profile_at``, a profiled stretch that many seconds in."""
        fd, path = tempfile.mkstemp(prefix="h100bench-schedule-", suffix=".npz")
        os.close(fd)
        np.savez(path, sample=sample, **reqs.arrays())
        env = {**os.environ, **core.cache_env()}
        proc = subprocess.Popen([sys.executable, str(CLIENT), path, str(self.srv.port)],
                                stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
                                env=env)
        try:
            if proc.stdout.readline().strip() != "ready":
                raise RuntimeError("the load client did not start")
            start = time.time() + lead_s
            if self.spans is not None:
                self.spans.durations.clear()
                self.spans.counts.clear()
                self.spans.intervals.clear()
            proc.stdin.write(f"go {start}\n")
            proc.stdin.flush()
            prof_out = None
            if profile_at is not None:
                prof_out = self._profile(start + profile_at, profile_s, trace_path)
            out, _ = proc.communicate(timeout=float(reqs.due[-1]) + 3 * 60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            os.unlink(path)
        res = json.loads(out.strip().splitlines()[-1])
        res["start_epoch"] = start
        res["profile"] = prof_out
        return res

    def _profile(self, at: float, seconds: float, trace_path: str) -> Dict:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        time.sleep(max(0.0, at - time.time()))
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
        with record_function(devtrace.WINDOW):
            p0 = time.perf_counter()
            time.sleep(seconds)
            self.sync()
            p1 = time.perf_counter()
        prof.stop()
        prof.export_chrome_trace(trace_path)
        return {"perf_start": p0, "perf_end": p1}

    def stop(self) -> None:
        self.srv.stop()
        self.rec = self.srv = None


def replies(res: Dict, reqs: T.Requests, sample: np.ndarray):
    """The sampled replies: ``(score ids, served score arrays)``, ``(top_k
    ids, returned ids, returned scores)``."""
    s_idx, s_val, t_idx, t_ids, t_sc = [], [], [], [], []
    got = res["replies"]
    for i in sample.tolist():
        body = got.get(str(i))
        obj = json.loads(body) if body is not None else None
        if reqs.kind[i] == 0:
            s_idx.append(i)
            s_val.append(None if obj is None else np.asarray(obj["scores"], np.float64))
        else:
            t_idx.append(i)
            t_ids.append(np.zeros(0, np.int64) if obj is None else np.asarray(obj["ids"]))
            t_sc.append(np.zeros(0) if obj is None else np.asarray(obj["scores"], np.float64))
    return s_idx, s_val, t_idx, t_ids, t_sc


def reference_numbers(cell: core.Cell, seed: int, device, reqs: T.Requests,
                      s_idx, s_val, t_idx, t_ids, t_sc, precision: str = "float32") -> Dict:
    """The sample held to the reference (or, for another ``precision``,
    the control's own answers held to it)."""
    import torch

    from h100bench.reference import common as C
    from h100bench.reference import serve as RS

    cfgj = cell.config
    fam = reference.family(cfgj["family"])
    model = cfgj["port"]["model"]
    H = int(cfgj["port"]["data"]["history_len"])
    corpus = T.make_corpus(cfgj, seed)
    feats = port.reference_feats(corpus, device)
    W = weights.make(fam.leaves(model, cfgj["corpus"]), seed, device)
    k = reqs.k

    def answers(p):
        vecs = RS.corpus_vectors(fam, model, W, feats, p)
        u_s = RS.users(fam, model, W, vecs, [reqs.history(i) for i in s_idx], H, False, p)
        sc = RS.scores(u_s, vecs, [reqs.candidates(i) for i in s_idx], p)
        u_t = RS.users(fam, model, W, vecs, [reqs.history(i) for i in t_idx], H, True, p)
        return sc, RS.corpus_scores(u_t, vecs, corpus.n_news, p)

    ref_sc, ref_corpus = answers(C.F32)
    if precision != "float32":
        c_sc, c_corpus = answers(C.Precision(precision))
        top = torch.topk(c_corpus, k, dim=1)
        s_val = c_sc
        t_ids = list(top.indices.cpu().numpy())
        t_sc = list(top.values.cpu().numpy())
    return CK.serve_numbers(s_val, ref_sc, t_ids, t_sc, ref_corpus, k, corpus.n_news)


def latency_metrics(res: Dict, reqs: T.Requests) -> Dict:
    lat = np.asarray(res["latency_s"], np.float64)
    ok = np.asarray(res["status"]) == 200
    lat = np.where(ok, lat, np.nan)
    out = {}
    for name, kind in (("score_p95_ms", 0), ("topk_p95_ms", 1)):
        v = percentile(lat[reqs.kind == kind], 95) * 1e3
        out[name] = {"value": min(v, 1e3 * 60.0), "unit": "ms"}
    return out


def run(ctx) -> Dict:
    import torch

    cell = ctx.cell
    svc = Service(cell, ctx.seed, ctx.device)
    reqs = T.make_requests(cell.traffic, svc.corpus, ctx.seconds, ctx.seed)
    sample = sample_of(reqs, ctx.seed)
    trace_path = None
    if ctx.trace:
        svc.instrument()
        fd, trace_path = tempfile.mkstemp(prefix="h100bench-trace-", suffix=".json")
        os.close(fd)
    res = svc.load(reqs, sample,
                   profile_at=0.4 * ctx.seconds if ctx.trace else None,
                   profile_s=float(cell.spec.get("trace_seconds", 1.0)), trace_path=trace_path)
    peak = torch.cuda.max_memory_allocated(svc.device) if svc.device.type == "cuda" else 0
    spans = svc.spans
    svc.stop()
    status = np.asarray(res["status"])
    late = np.asarray(res["late_s"])
    out = {"attempted": len(reqs), "failed": int((status != 200).sum()),
           "setup_s": res["start_epoch"] - ctx.t0, "memory_peak_bytes": peak,
           "foreign": res["foreign"], "metrics": latency_metrics(res, reqs),
           "client": {"lateness_p95_ms": percentile(late, 95) * 1e3,
                      "lateness_max_ms": float(late.max()) * 1e3}}
    if ctx.trace:
        tr = devtrace.load(trace_path)
        os.unlink(trace_path)
        # the benchmark's spans of every thread, on the trace's clock
        lo_us = tr.window[0]
        p0 = res["profile"]["perf_start"]
        rec = core.Record(kind="serve", trace=tr, spans=dict(spans.durations),
                          counts=dict(spans.counts), window_s=ctx.seconds)
        rec.counts["score_many_calls"] = len(spans.durations.get("score_many", []))
        tr.extra_spans = [(lo_us + (s - p0) * 1e6, lo_us + (e - p0) * 1e6, "h100bench." + n)
                          for n, s, e in spans.intervals]
        tr.extra_spans.sort()
        out["record"] = rec
    if svc.device.type == "cuda":
        torch.cuda.empty_cache()
    s_idx, s_val, t_idx, t_ids, t_sc = replies(res, reqs, sample)
    out["numbers"] = reference_numbers(cell, ctx.seed, svc.device, reqs,
                                       s_idx, s_val, t_idx, t_ids, t_sc)
    return out
