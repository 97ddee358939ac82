"""The port's serving path (``Recommender`` -> ``RecommenderServer`` -> ``cli
serve``) on the CPU against the JAX package's ``Recommender`` with the same
weights. Tolerance 1e-4: both sides run the same float32 chain."""

import http.client
import json

import jax
import numpy as np
import pytest
import torch

from pytorch_news_recommender_tpu.config import synthetic_config as jax_synthetic_config
from pytorch_news_recommender_tpu.data import synthetic as jax_synthetic
from pytorch_news_recommender_tpu.serve import Recommender as JaxRecommender
from pytorch_news_recommender_tpu.train.loop import Trainer
from pytorch_news_recommender_tpu_torch import cli
from pytorch_news_recommender_tpu_torch.config import synthetic_config
from pytorch_news_recommender_tpu_torch.data import synthetic
from pytorch_news_recommender_tpu_torch.models import build_model
from pytorch_news_recommender_tpu_torch.models.convert import from_flax, save_checkpoint
from pytorch_news_recommender_tpu_torch.serve import Recommender
from pytorch_news_recommender_tpu_torch.server import RecommenderServer

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)


def _word_dict(n_words):
    """Digit-free tokens ("wab", ...) for word ids 1..n_words-1."""
    def name(i):
        s = ""
        while i:
            i, r = divmod(i, 26)
            s += chr(97 + r)
        return "w" + s
    return {name(i): i for i in range(1, n_words)}


@pytest.fixture(scope="module")
def served():
    """(JAX recommender, port recommender, port dataset, port state dict)
    over the same seed-5 synthetic corpus and Flax init weights."""
    jcfg = jax_synthetic_config()
    jds = jax_synthetic.generate(jcfg.data, seed=5, n_train=64, n_dev=16)
    jds.dicts = {"word": _word_dict(jds.meta.n_words)}
    params = jax.device_get(Trainer(jcfg, jds).init_state().params)
    cfg = synthetic_config()
    ds = synthetic.generate(cfg.data, seed=5, n_train=64, n_dev=16)
    ds.dicts = {"word": _word_dict(ds.meta.n_words)}
    state = from_flax(params)
    return (JaxRecommender(jcfg, jds, params), Recommender(cfg, ds, state, device="cpu"),
            ds, state)


def _requests(ds):
    reqs = []
    for i in range(6):
        hist = [int(h) for h in ds.dev.browsed_ids[i] if h]
        cands, _ = ds.dev.impression(i)
        reqs.append((hist[: 10 * i], [int(c) for c in cands], 0))
    reqs.append(([1, 2, 3], list(range(1, 41)), 0))   # width 64
    return reqs


def test_corpus_vectors_match(served):
    jrec, rec, _, _ = served
    np.testing.assert_allclose(rec.news_vecs.numpy(), np.asarray(jrec.news_vecs), **TOL)


def test_score_and_score_many_match(served):
    jrec, rec, ds, _ = served
    reqs = _requests(ds)
    for hist, cands, _ in reqs:
        np.testing.assert_allclose(rec.score(hist, cands), jrec.score(hist, cands), **TOL)
    for got, expect in zip(rec.score_many(reqs), jrec.score_many(reqs)):
        np.testing.assert_allclose(got, expect, **TOL)


def _assert_topk_equal(got, expect):
    (ids, scores), (jids, jscores) = got, (np.asarray(expect[0]), np.asarray(expect[1]))
    np.testing.assert_allclose(scores, jscores, **TOL)
    gaps = np.abs(np.diff(jscores))
    # ids may swap only between scores equal within the tolerance
    apart = np.concatenate([[True], gaps > 1e-4]) & np.concatenate([gaps > 1e-4, [True]])
    np.testing.assert_array_equal(ids[apart], jids[apart])


def test_top_k_matches(served):
    jrec, rec, ds, _ = served
    for hist, _, _ in _requests(ds)[1:4]:
        _assert_topk_equal(rec.top_k(hist, 10), jrec.top_k(hist, 10))


def test_int8_cache_matches(served):
    jrec, rec, ds, state = served
    jrec8 = JaxRecommender(jrec.cfg, _jax_ds(ds), jrec.params, corpus_cache="int8")
    rec8 = Recommender(rec.cfg, ds, state, corpus_cache="int8", device="cpu")
    assert rec8.news_vecs is None and rec8.news_q.dtype == torch.int8
    # a float32 rounding tie may move one quantized value by one step
    assert np.abs(rec8.news_q.numpy().astype(int)
                  - np.asarray(jrec8.news_q).astype(int)).max() <= 1
    np.testing.assert_allclose(rec8.news_scale.numpy(), np.asarray(jrec8.news_scale), **TOL)
    for hist, cands, _ in _requests(ds)[:3]:
        np.testing.assert_allclose(rec8.score(hist, cands), jrec8.score(hist, cands),
                                   rtol=1e-3, atol=1e-3)
    _assert_topk_equal(rec8.top_k([1, 2, 3], 10), jrec8.top_k([1, 2, 3], 10))


def _jax_ds(ds):
    out = jax_synthetic.generate(jax_synthetic_config().data, seed=5, n_train=64, n_dev=16)
    out.dicts = ds.dicts
    return out


def test_vectors_file(served, tmp_path):
    _, rec, ds, state = served
    np.savez(tmp_path / "v.npz", news_vectors=rec.news_vecs.numpy())
    frec = Recommender(rec.cfg, ds, state, vectors_file=str(tmp_path / "v.npz"),
                       device="cpu")
    np.testing.assert_array_equal(frec.score([1, 2], [3, 4, 5]), rec.score([1, 2], [3, 4, 5]))
    q8 = Recommender(rec.cfg, ds, state, corpus_cache="int8", device="cpu")
    np.savez(tmp_path / "q.npz", news_q=q8.news_q.numpy(), news_scale=q8.news_scale.numpy())
    with pytest.raises(ValueError, match="int8"):
        Recommender(rec.cfg, ds, state, vectors_file=str(tmp_path / "q.npz"), device="cpu")
    fq = Recommender(rec.cfg, ds, state, corpus_cache="int8",
                     vectors_file=str(tmp_path / "q.npz"), device="cpu")
    np.testing.assert_array_equal(fq.score([1, 2], [3, 4]), q8.score([1, 2], [3, 4]))
    np.savez(tmp_path / "short.npz", news_vectors=rec.news_vecs.numpy()[:10])
    with pytest.raises(ValueError, match="rows"):
        Recommender(rec.cfg, ds, state, vectors_file=str(tmp_path / "short.npz"),
                    device="cpu")


def test_add_news_matches(served):
    shared, _, ds, state = served
    jrec = JaxRecommender(shared.cfg, _jax_ds(ds), shared.params)
    rec = Recommender(shared.cfg, ds, state, device="cpu")
    words = list(ds.dicts["word"])[:5]
    title = " ".join(words[:3]) + " unknown 2024"
    t_rows, j_rows = rec.tokenize_new_news(title), jrec.tokenize_new_news(title)
    for k in t_rows:
        np.testing.assert_array_equal(t_rows[k], j_rows[k])
    np.testing.assert_allclose(rec.encode_new_news(title), jrec.encode_new_news(title), **TOL)
    nid = rec.add_news(title)
    assert nid == jrec.add_news(title) == 401 and rec.n_news == 402
    assert rec.news_vecs.shape[0] == 401 + rec.GROW_BLOCK
    hist = [5, nid]
    np.testing.assert_allclose(rec.score(hist, [nid, 7]), jrec.score(hist, [nid, 7]), **TOL)
    _assert_topk_equal(rec.top_k(hist, 5), jrec.top_k(hist, 5))


def _get(conn, path):
    conn.request("GET", path)
    return json.loads(conn.getresponse().read())


def _post(conn, path, body):
    conn.request("POST", path, body=json.dumps(body))
    return json.loads(conn.getresponse().read())


def test_http_roundtrip(served):
    _, _, ds, state = served
    rec = Recommender(synthetic_config(), ds, state, device="cpu")
    srv = RecommenderServer(rec, port=0, batch_window_ms=2.0)
    srv.start(block=False)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
        r = _get(conn, "/healthz")
        assert r["status"] == "ok" and r["n_news"] == 401
        r = _post(conn, "/score", {"history": [1, 2, 3], "candidates": [4, 5, 6]})
        np.testing.assert_allclose(r["scores"], rec.score([1, 2, 3], [4, 5, 6]), **TOL)
        r = _post(conn, "/top_k", {"history": [1, 2, 3], "k": 4})
        np.testing.assert_array_equal(r["ids"], rec.top_k([1, 2, 3], 4)[0])
        nid = _post(conn, "/add_news", {"title": " ".join(list(ds.dicts["word"])[:4])})["id"]
        r = _post(conn, "/score", {"history": [nid], "candidates": [nid, 1]})
        assert len(r["scores"]) == 2 and np.all(np.isfinite(r["scores"]))
    finally:
        srv.stop()


def test_cli_serve_starts_and_stops(tmp_path):
    cfg = synthetic_config()
    ds = synthetic.generate(cfg.data, seed=0, bert_dim=64, n_users=200,
                            n_neighbors=8, n_test=64)
    model = build_model(cfg.model.with_artifact_meta(ds.meta))
    model.reset_parameters(torch.Generator().manual_seed(0))
    save_checkpoint(tmp_path / "ckpt", cfg, model.state_dict())
    args = cli.build_parser().parse_args(
        ["serve", "--data", "synthetic", "--ckpt", str(tmp_path / "ckpt"),
         "--port", "0", "--device", "cpu", "--corpus-cache", "int8",
         "--batch-window-ms", "1"])
    srv = cli.build_server(args)
    srv.start(block=False)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
        r = _get(conn, "/healthz")
        assert r == {"status": "ok", "model": "nrms", "n_news": ds.news.n_news,
                     "corpus_cache": "int8"}
    finally:
        srv.stop()


def test_entry_points_need_cuda_unless_told_cpu(served, monkeypatch):
    _, rec, ds, state = served
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Recommender(rec.cfg, ds, state)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        Recommender(rec.cfg, ds, state, mesh=object(), device="cpu")
