"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the fused encoder kernel from ``pytorch_news_recommender_tpu_torch/
ops/csrc``, holds it against its plain PyTorch version at the serving
shapes in float32 and bfloat16, then serves NRMS at full width (D=300, 10
heads, query dim 200, title 20, history 50, bf16) over HTTP on a seeded
synthetic corpus of 65,238 news (the news count of MIND-small), in both
corpus-cache modes, and checks a sample of the served answers against a
recomputation through the plain version. Prints timings tagged with the
card's name and power limit, the kernel line as JSON, and ends with
``{"ok": true, "device": {...}}``. Any failed phase raises; there is no
result without a CUDA card.
"""

from __future__ import annotations

import concurrent.futures
import http.client
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

N_NEWS = 65_238          # MIND-small's news count; the table adds the pad row
VOCAB = 32_000
D, H, Q = 300, 10, 200
SHAPES = [(4096, 20), (32, 50), (1, 50)]   # corpus chunk, score_many batch, single user
TOLS = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
# a served score may differ from the plain recomputation by this share of the
# sample's largest |score|: bf16 vectors, kernel vs plain rounding points;
# int8 rows add up to amax/254 per element on top
SCORE_TOL = {"native": 2e-2, "int8": 4e-2}
PEAK_BF16_FLOPS, PEAK_F32_FLOPS, PEAK_BYTES = 989e12, 67e12, 3.35e12  # H100 SXM
DEVICE = "cuda"


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def encoder_inputs(seed, M, L, dtype):
    """Seeded masked tokens (rows of 0..L real tokens) and encoder weights."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, L + 1, size=M)
    if M > 1:
        lens[0], lens[1] = 0, L     # an all-pad item and a full one
    else:
        lens[0] = max(lens[0], 1)
    mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.float32)
    x = rng.normal(size=(M, L, D)) * mask[..., None]
    shapes = [(D, 3 * D), (3 * D,), (D, D), (D,), (D, Q), (Q,), (Q,)]
    w = [rng.normal(size=s) * c for s, c in
         zip(shapes, [0.05, 0.01, 0.05, 0.01, 0.05, 0.01, 0.1])]
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=DEVICE)
    return ([t(x).to(dtype), t(mask)] + [t(a).to(dtype) for a in w],
            torch.as_tensor(lens > 0, device=DEVICE))


def bound(M, L, itemsize):
    """(ms, "bytes" | "operations"): the least time for the work, the larger
    of the bytes moved once over the memory rate and the operations over the
    peak rate for the operand type. The kernel does the same work whatever
    the mask, so the shapes decide it."""
    flops = M * (2 * L * D * (3 * D + D + Q) + 4 * H * L * L * (D // H))
    weights = D * 3 * D + 3 * D + D * D + D + D * Q + 2 * Q
    nbytes = (M * L * D + weights + M * D) * itemsize + M * L * 4
    peak = PEAK_BF16_FLOPS if itemsize == 2 else PEAK_F32_FLOPS
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / peak * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def cuda_ms(fn, iters):
    """Mean device time of ``fn()`` over ``iters`` calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def check_kernel(FE):
    """Phase 2: kernel vs plain version at the serving shapes, two dtypes."""
    errs, times = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        for M, L in SHAPES:
            args, valid = encoder_inputs(M * 100 + L, M, L, dtype)
            got = FE.fused_news_encoder(*args, num_heads=H)
            torch.cuda.synchronize()
            expect = FE.fused_news_encoder_reference(*args, num_heads=H)
            err = float((got[valid].float() - expect[valid].float()).abs().max())
            tol = TOLS[dtype]
            torch.testing.assert_close(got[valid].float(), expect[valid].float(),
                                       rtol=tol, atol=tol)
            assert torch.all(got[~valid] == 0), "an all-pad item must pool to 0"
            errs[(str(dtype), M, L)] = err
            if dtype == torch.bfloat16:
                iters = 10 if M > 1000 else 100
                times[(M, L)] = (
                    cuda_ms(lambda: FE.fused_news_encoder(*args, num_heads=H), iters),
                    cuda_ms(lambda: FE.fused_news_encoder_reference(*args, num_heads=H),
                            iters))
            print(f"kernel vs plain {str(dtype):15s} M={M:5d} L={L}: "
                  f"max|err| {err:.3g} (tol {tol})", flush=True)
    return errs, times


def word_dict(n_words):
    """Digit-free tokens ("wab", ...) for word ids 1..n_words-1."""
    def name(i):
        s = ""
        while i:
            i, r = divmod(i, 26)
            s += chr(97 + r)
        return "w" + s
    return {name(i): i for i in range(1, n_words)}


def make_requests(rng, n, n_news):
    return [([int(h) for h in rng.integers(1, n_news, size=rng.integers(0, 51))],
             [int(c) for c in rng.integers(1, n_news, size=rng.integers(5, 301))])
            for _ in range(n)]


def post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", path, body=json.dumps(body))
        resp = conn.getresponse()
        out = json.loads(resp.read())
        assert resp.status == 200, (path, out)
        return out
    finally:
        conn.close()


def plain_tower(rec, FE, tower, x, mask):
    """One tower through the plain version, in the serving dtype."""
    w = [p.to(rec._cd) for p in (tower.wqkv, tower.bqkv, tower.wo, tower.bo,
                                 tower.aw, tower.ab, tower.aq)]
    return FE.fused_news_encoder_reference(x.to(rec._cd), mask, *w,
                                           num_heads=tower.num_heads)


@torch.no_grad()
def plain_news(rec, FE, title):
    """News vectors of ``[n, L]`` title ids through the plain version."""
    enc = rec.model.news_encoder
    tmask = (title != 0).float()
    return plain_tower(rec, FE, enc.tower, enc.word_embedding(title, tmask), tmask)


@torch.no_grad()
def plain_scores(rec, FE, hist, cands):
    """Scores recomputed on the card through the plain version of both
    towers, from the word ids up."""
    ids = torch.as_tensor(rec._pad_history(hist).tolist() + list(cands),
                          device=DEVICE).long()
    vecs = plain_news(rec, FE, rec.news_feats["title"][ids])
    hmask = (ids[:rec.H] != 0).float()
    user = plain_tower(rec, FE, rec.model.user_encoder.tower, vecs[None, :rec.H],
                       hmask[None])[0]
    return (vecs[rec.H:].float() @ user.float()).cpu().numpy()


def serve_run(cfg, ds, params, cache, FE, rng):
    """Phase 3 for one cache mode: start the server, answer requests over
    HTTP, check a sample against the plain version. Returns the
    recommender."""
    from pytorch_news_recommender_tpu_torch.serve import Recommender
    from pytorch_news_recommender_tpu_torch.server import RecommenderServer

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec = Recommender(cfg, ds, params, corpus_cache=cache, device=DEVICE)
    torch.cuda.synchronize()
    startup_s = time.perf_counter() - t0
    srv = RecommenderServer(rec, port=0, batch_window_ms=5.0)
    srv.start(block=False)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        conn.close()
        assert health == {"status": "ok", "model": "nrms", "n_news": N_NEWS + 1,
                          "corpus_cache": cache}, health
        reqs = make_requests(rng, 64, N_NEWS + 1)
        with concurrent.futures.ThreadPoolExecutor(16) as pool:
            futs = [pool.submit(post, srv.port, "/score",
                                {"history": h, "candidates": c}) for h, c in reqs]
            served = [f.result()["scores"] for f in futs]
        for (h, c), s in zip(reqs, served):
            assert len(s) == len(c) and np.all(np.isfinite(s))
        worst = 0.0
        sample = [(h, c, s) for (h, c), s in zip(reqs, served) if h][:12]
        for h, c, s in sample:
            ref = plain_scores(rec, FE, h, c)
            worst = max(worst, float(np.abs(np.asarray(s) - ref).max()
                                     / max(1e-6, np.abs(ref).max())))
        assert worst <= SCORE_TOL[cache], f"served scores off by {worst:.3g} of scale"
        for h, _ in reqs[:8]:
            r = post(srv.port, "/top_k", {"history": h, "k": 10})
            ids, scores = np.asarray(r["ids"]), np.asarray(r["scores"])
            assert len(ids) == 10 and np.all((ids >= 1) & (ids <= N_NEWS))
            assert np.all(np.diff(scores) <= 0) and np.all(np.isfinite(scores))
        words = list(ds.dicts["word"])
        new_ids = []
        for i in range(2):
            title = " ".join(words[100 * i + j] for j in range(8)) + " unknown"
            new_ids.append(post(srv.port, "/add_news", {"title": title})["id"])
            title_ids = torch.as_tensor(rec.tokenize_new_news(title)["title"],
                                        device=DEVICE)[None]
            vec = rec._lookup(torch.as_tensor([new_ids[-1]], device=DEVICE)).float()
            ref = plain_news(rec, FE, title_ids).float()
            tol = TOLS[torch.bfloat16] if cache == "native" else 2 * TOLS[torch.bfloat16]
            torch.testing.assert_close(vec, ref, rtol=tol, atol=tol)
        assert new_ids == [N_NEWS + 1, N_NEWS + 2], new_ids
        r = post(srv.port, "/score", {"history": new_ids + [1, 2], "candidates": new_ids + [3]})
        assert len(r["scores"]) == 3 and np.all(np.isfinite(r["scores"]))
        ref = plain_scores(rec, FE, new_ids + [1, 2], new_ids + [3])
        new_err = float(np.abs(np.asarray(r["scores"]) - ref).max() / np.abs(ref).max())
        assert new_err <= SCORE_TOL[cache], f"fresh-news scores off by {new_err:.3g}"
        print(f"serve[{cache}]: start-up {startup_s:.2f} s, 64 /score + 8 /top_k + "
              f"2 /add_news answered; served vs plain max err {worst:.3g} of scale "
              f"(fresh news {new_err:.3g}; tol {SCORE_TOL[cache]})", flush=True)
        return rec
    finally:
        srv.stop()


def latency(fn, n):
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.percentile(out, 50)), float(np.percentile(out, 99))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    from pytorch_news_recommender_tpu_torch.config import Config, DataConfig
    from pytorch_news_recommender_tpu_torch.data import synthetic
    from pytorch_news_recommender_tpu_torch.models import build_model
    from pytorch_news_recommender_tpu_torch.ops import fused_encoder as FE

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = card()
    tag = f"[{gpu}]"
    print(f"card: {gpu}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    # 1. setup
    t0 = time.perf_counter()
    FE.build()
    print(f"kernel build+load: {time.perf_counter() - t0:.1f} s", flush=True)

    # 2. kernel vs plain
    errs, times = check_kernel(FE)

    # 3. serving end to end, at full width
    cfg = Config(data=DataConfig(dataset="synthetic"))
    t0 = time.perf_counter()
    ds = synthetic.generate(cfg.data, seed=0, n_news=N_NEWS, vocab_size=VOCAB)
    ds.dicts = {"word": word_dict(VOCAB)}
    model = build_model(cfg.model.with_artifact_meta(ds.meta))
    model.reset_parameters(torch.Generator().manual_seed(0))
    params = model.state_dict()
    print(f"corpus + seeded weights: {time.perf_counter() - t0:.1f} s "
          f"({ds.news.n_news} rows, vocab {VOCAB})", flush=True)
    rng = np.random.default_rng(0)
    FE.fused_news_encoder.launches = 0
    rec = serve_run(cfg, ds, params, "native", FE, rng)
    serve_run(cfg, ds, params, "int8", FE, rng)
    launches = FE.fused_news_encoder.launches
    per_encode = math.ceil(ds.news.n_news / cfg.train.eval_encode_chunk)
    assert launches >= 2 * per_encode, (launches, per_encode)
    print(f"fused_encoder_fwd launches on the serving path: {launches} "
          f"({per_encode} per corpus encode)", flush=True)

    # 4. timings
    chunk = cfg.train.eval_encode_chunk
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec._encode_corpus(ds.news.n_news, chunk)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    print(f"{tag} corpus encode: {enc_s * 1e3:.1f} ms for {ds.news.n_news} news "
          f"= {ds.news.n_news / enc_s:.0f} news/s", flush=True)
    batch = [(h, rng.integers(1, N_NEWS, size=300).tolist(), 0)
             for h, _ in make_requests(rng, rec.BATCH_PAD, N_NEWS + 1)]
    p50, p99 = latency(lambda: rec.score_many(batch), 50)
    print(f"{tag} score_many (one batch of {rec.BATCH_PAD} x 300 candidates): "
          f"p50 {p50:.2f} ms, p99 {p99:.2f} ms", flush=True)
    hist = batch[0][0]
    p50, p99 = latency(lambda: rec.top_k(hist, 10), 50)
    print(f"{tag} top_k (k=10 over {rec.n_news} news): p50 {p50:.2f} ms, "
          f"p99 {p99:.2f} ms", flush=True)
    for (M, L), (k_ms, p_ms) in times.items():
        print(f"{tag} fused_encoder_fwd bf16 M={M} L={L}: kernel {k_ms:.4f} ms/launch, "
              f"plain {p_ms:.4f} ms, bound {bound(M, L, 2)[0]:.4f} ms", flush=True)

    k_ms, p_ms = times[SHAPES[0]]
    b_ms, b_by = bound(*SHAPES[0], 2)
    print(json.dumps({"kernels": [{
        "name": "fused_encoder_fwd", "route": "cuda",
        "source": "pytorch_news_recommender_tpu_torch/ops/csrc/fused_encoder.cu",
        "replaces": "pytorch_news_recommender_tpu/ops/pallas/fused_encoder.py:149",
        "launches": launches,
        "max_abs_err": max(v for k, v in errs.items() if "bfloat16" in k[0]),
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
        "shape": {"M": SHAPES[0][0], "L": SHAPES[0][1], "D": D, "H": H, "Q": Q,
                  "dtype": "bfloat16"},
    }]}), flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
