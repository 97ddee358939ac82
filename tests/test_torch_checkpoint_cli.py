"""The port's workflow around training against the JAX package's:
checkpoints of the whole train state (``train/checkpoint.py``) and a resumed
run's next step, ``cli eval`` / ``submit`` / ``export-vectors`` from the same
Flax weights, the preprocessing commands on the tiny TSVs of
``tests/test_mind.py`` and the event log of ``tests/test_adressa.py``, and
the checkpoint layouts that ``Recommender.from_checkpoint`` serves."""

import argparse
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from test_mind import (
    DEV_BEHAVIORS, DEV_NEWS_TSV, ENTITY_VEC, GLOVE, NEWS_TSV, TRAIN_BEHAVIORS,
)

from pytorch_news_recommender_tpu import cli as jax_cli
from pytorch_news_recommender_tpu.config import DataConfig as JaxDataConfig
from pytorch_news_recommender_tpu.config import synthetic_config as jax_synthetic_config
from pytorch_news_recommender_tpu.data import adressa as jax_adressa
from pytorch_news_recommender_tpu.data import mind as jax_mind
from pytorch_news_recommender_tpu.data import synthetic as jax_synthetic
from pytorch_news_recommender_tpu.train import loop as jax_loop
from pytorch_news_recommender_tpu.train import submit as jax_submit
from pytorch_news_recommender_tpu_torch import cli
from pytorch_news_recommender_tpu_torch.config import synthetic_config
from pytorch_news_recommender_tpu_torch.data import synthetic
from pytorch_news_recommender_tpu_torch.data.dataset import RecDataset
from pytorch_news_recommender_tpu_torch.data.loader import train_batches
from pytorch_news_recommender_tpu_torch.models.convert import from_flax, save_checkpoint
from pytorch_news_recommender_tpu_torch.serve import Recommender
from pytorch_news_recommender_tpu_torch.train.checkpoint import CheckpointManager, load_config
from pytorch_news_recommender_tpu_torch.train.loop import Trainer
from pytorch_news_recommender_tpu_torch.utils.plotting import plot_loss

torch.set_num_threads(2)

# what `--data synthetic` builds in both packages' CLIs
CLI_DATA = dict(seed=0, bert_dim=64, n_users=200, n_neighbors=8, n_test=64)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """(JAX trainer on the CLI's synthetic data, its Flax init params, a flat
    port weights directory holding the same params)."""
    jcfg = jax_synthetic_config()
    jtr = jax_loop.Trainer(jcfg, jax_synthetic.generate(jcfg.data, **CLI_DATA))
    params = jax.device_get(jtr.init_state(seed=0).params)
    ckpt = tmp_path_factory.mktemp("flat")
    save_checkpoint(ckpt, synthetic_config(), from_flax(params))
    return jtr, params, ckpt


def _run(argv, capsys):
    capsys.readouterr()
    assert cli.main(argv) == 0
    return capsys.readouterr().out


def test_cli_eval_equals_jax_trainer(jax_run, capsys):
    jtr, params, ckpt = jax_run
    out = _run(["eval", "--data", "synthetic", "--ckpt", str(ckpt), "--device", "cpu"], capsys)
    got = json.loads(out.strip().splitlines()[-1])
    expect = jtr.evaluate(params)
    assert got.keys() == expect.keys()
    for k in expect:
        np.testing.assert_allclose(got[k], expect[k], rtol=1e-5, atol=1e-5, err_msg=k)


def test_cli_submit_equals_jax_write_submission(jax_run, capsys, tmp_path):
    """Same keys, line for line, and the same rankings; where the port's
    order differs, the JAX scores of the swapped candidates are within 1e-5
    of each other (a tie to float32 rounding)."""
    jtr, params, ckpt = jax_run
    _run(["submit", "--data", "synthetic", "--ckpt", str(ckpt), "--device", "cpu",
          "--out", str(tmp_path / "port.txt")], capsys)
    jax_submit.write_submission(jtr, params, path=tmp_path / "jax.txt")
    jscores = jax_submit.collect_scores(jtr, params, jtr.dataset.test)
    got = (tmp_path / "port.txt").read_text().splitlines()
    expect = (tmp_path / "jax.txt").read_text().splitlines()
    assert len(got) == len(expect) == len(jscores) == CLI_DATA["n_test"]
    rows = sorted(jscores)
    for row, line, jline in zip(rows, got, expect):
        key, ranks = line.split(" ", 1)
        jkey, jranks = jline.split(" ", 1)
        assert key == jkey == str(row + 1)
        if ranks == jranks:
            continue
        ranks = np.asarray(json.loads(ranks))
        by_port_rank = np.asarray(jscores[row])[np.argsort(ranks)]
        assert np.all(np.diff(by_port_rank) <= 1e-5), (line, jline)


def test_cli_export_vectors_equals_jax_export(jax_run, capsys, tmp_path):
    """float32 table within 1e-4 of the JAX trainer's (the tolerance of
    ``test_torch_nrms.py``), and the int8 table of the JAX CLI's formula: the
    same scales to 1e-5 and the same values, give or take one step where a
    value lies on a rounding edge."""
    jtr, params, ckpt = jax_run
    base = ["export-vectors", "--data", "synthetic", "--ckpt", str(ckpt), "--device", "cpu"]
    _run(base + ["--out", str(tmp_path / "f32.npz")], capsys)
    _run(base + ["--out", str(tmp_path / "q.npz"), "--int8"], capsys)
    expect = np.asarray(jtr.compute_news_vectors(params), np.float32)
    got = np.load(tmp_path / "f32.npz")["news_vectors"]
    assert got.dtype == np.float32 and got.shape == expect.shape
    np.testing.assert_allclose(got, expect, rtol=1e-4, atol=1e-4)
    scale = np.maximum(np.abs(expect).max(axis=1, keepdims=True) / 127.0, 1e-12)
    q = np.clip(np.round(expect / scale), -127, 127).astype(np.int8)
    z = np.load(tmp_path / "q.npz")
    assert z["news_q"].dtype == np.int8 and z["news_scale"].dtype == np.float32
    np.testing.assert_allclose(z["news_scale"], scale, rtol=1e-5, atol=1e-9)
    assert np.abs(z["news_q"].astype(int) - q.astype(int)).max() <= 1


def test_exported_vectors_serve(jax_run, capsys, tmp_path):
    """``serve --vectors`` input: the exported tables load into
    ``Recommender(vectors_file=...)`` and score as a fresh encode does."""
    _, _, ckpt = jax_run
    base = ["export-vectors", "--data", "synthetic", "--ckpt", str(ckpt), "--device", "cpu"]
    _run(base + ["--out", str(tmp_path / "f32.npz")], capsys)
    _run(base + ["--out", str(tmp_path / "q.npz"), "--int8"], capsys)
    cfg = load_config(ckpt)
    ds = synthetic.generate(cfg.data, **CLI_DATA)
    ref = Recommender.from_checkpoint(ckpt, ds, device="cpu").score([1, 2, 3], list(range(4, 30)))
    for cache, f, tol in (("native", "f32.npz", 1e-4), ("int8", "q.npz", 4e-2)):
        rec = Recommender.from_checkpoint(ckpt, ds, corpus_cache=cache, device="cpu",
                                          vectors_file=str(tmp_path / f))
        got = rec.score([1, 2, 3], list(range(4, 30)))
        assert np.abs(got - ref).max() <= tol * np.abs(ref).max(), cache


@pytest.fixture(scope="module")
def small():
    cfg = synthetic_config()
    return cfg, synthetic.generate(cfg.data, seed=2, n_train=128, n_dev=16)


@pytest.mark.parametrize("accum", [1, 2])
def test_checkpoint_round_trip_restores_the_whole_state(small, tmp_path, accum):
    cfg, ds = small
    cfg = synthetic_config(**{"train.grad_accum_steps": accum})
    tr = Trainer(cfg, ds, device="cpu")
    state = tr.init_state(seed=0)
    for b in list(train_batches(ds.train, 32, np.random.default_rng(0), dedup=True))[:3]:
        state, _ = tr.run_step(state, b)
    mngr = CheckpointManager(tmp_path / "ckpt", cfg)
    mngr.save(state.step, state, {"auc": 0.6, "loss": 1.0, "tag": "step3"})
    assert mngr.best_step() == mngr.latest_step() == 3
    assert load_config(tmp_path / "ckpt").to_dict() == cfg.to_dict()
    assert mngr.restore_metrics() == {"auc": 0.6, "loss": 1.0}
    restored = mngr.restore(Trainer(cfg, ds, device="cpu").init_state(seed=7))
    assert restored.step == 3
    for k, v in state.params.items():
        assert torch.equal(restored.params[k], v), k
    a, b = state.opt.state_dict(), restored.opt.state_dict()
    assert (a["count"], a["mini_step"]) == (b["count"], b["mini_step"]) == (
        3 // accum, 3 % accum)
    assert ("acc" in a) == ("acc" in b) == (accum > 1)
    for tree in ("mu", "nu", "acc"):
        for k, v in a.get(tree, {}).items():
            assert torch.equal(b[tree][k], v), (tree, k)


def test_retention_keeps_the_best_three_by_auc(small, tmp_path):
    cfg, ds = small
    state = Trainer(cfg, ds, device="cpu").init_state(seed=0)
    mngr = CheckpointManager(tmp_path, cfg)
    for step, auc in [(1, 0.58), (2, 0.70), (3, 0.62), (4, 0.66), (5, 0.60)]:
        state.step = step
        mngr.save(step, state, {"auc": auc})
    assert mngr.steps() == [2, 3, 4]
    assert mngr.best_step() == 2 and mngr.latest_step() == 4
    assert mngr.restore(state).step == 2


def test_resumed_step_equals_the_uninterrupted_step(small, tmp_path):
    """Dropout 0.2: a checkpoint at step k restored into a fresh trainer,
    then one step on a fixed batch, gives bit for bit the loss and the
    parameters of step k + 1 of the run that went on. The same batch at
    another step draws other masks."""
    cfg, ds = small
    assert cfg.model.dropout > 0
    batches = list(train_batches(ds.train, 32, np.random.default_rng(1), dedup=True))[:3]
    tr = Trainer(cfg, ds, device="cpu")
    state = tr.init_state(seed=0)
    for b in batches[:2]:
        state, _ = tr.run_step(state, b)
    mngr = CheckpointManager(tmp_path, cfg)
    mngr.save(state.step, state, {"auc": 0.5})
    state, m = tr.run_step(state, batches[2])
    fresh = Trainer(cfg, ds, device="cpu")
    resumed, mr = fresh.run_step(mngr.restore(fresh.init_state(seed=3)), batches[2])
    assert float(mr["loss"]) == float(m["loss"]) and resumed.step == state.step == 3
    for k, v in state.params.items():
        assert torch.equal(resumed.params[k], v), k
    other = mngr.restore(fresh.init_state(seed=3))
    other.step = 0
    _, mo = fresh.run_step(other, batches[2])
    assert float(mo["loss"]) != float(m["loss"])


def test_flat_and_step_checkpoints_serve_the_same_weights(small, tmp_path, capsys):
    """A flat weights directory (``config.json`` + ``params.npz``, the
    layout before the train-state checkpoints) still serves and evaluates,
    and gives the scores of the step checkpoint of the same weights."""
    cfg, ds = small
    tr = Trainer(cfg, ds, device="cpu")
    state = tr.init_state(seed=4)
    save_checkpoint(tmp_path / "flat", cfg, state.params)
    CheckpointManager(tmp_path / "steps", cfg).save(0, state, {"auc": 0.5})
    scores = [Recommender.from_checkpoint(tmp_path / d, ds, device="cpu").score(
        [1, 2, 3], [4, 5, 6, 7]) for d in ("flat", "steps")]
    np.testing.assert_array_equal(scores[0], scores[1])
    assert np.all(np.isfinite(scores[0]))


def test_cli_train_profiles_and_auto_resumes(tmp_path, capsys):
    """``train`` writes step checkpoints at its evals and a profiler trace;
    ``--auto-resume`` restores the run's latest step and ``--load`` another
    run's best. Every step directory is named after the step of the state
    it holds, in the resumed run too, so the latest step is the newest
    state."""
    save = tmp_path / "save"
    common = ["train", "--data", "synthetic", "--epochs", "1", "--batch-size", "128",
              "--eval-step", "8", "--device", "cpu", "--save-dir", str(save)]
    assert cli.main(common + ["--profile-dir", str(tmp_path / "prof"),
                              "--skip-nonfinite", "--description", "x"]) == 0
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    mngr = CheckpointManager(save / "nrms")
    assert mngr.steps() and min(mngr.steps()) < 2048 // 128, mngr.steps()
    cfg = load_config(save / "nrms")
    assert cfg.train.skip_nonfinite_updates and cfg.description == "x"
    assert cfg.train.eval_step == 8 and cfg.train.batch_size == 128
    first_latest = mngr.latest_step()
    capsys.readouterr()
    assert cli.main(common + ["--auto-resume"]) == 0
    assert f"(step {first_latest})" in capsys.readouterr().err
    held = {s: json.loads((mngr.directory / str(s) / "state.json").read_text())["step"]
            for s in mngr.steps()}
    assert all(s == step for s, step in held.items()), held
    assert mngr.latest_step() > first_latest, held
    assert cli.main(common + ["--save-dir", str(tmp_path / "other"),
                              "--load", str(save / "nrms")]) == 0
    assert "restored checkpoint" in capsys.readouterr().err


def test_cli_serve_mesh_answers_score_and_top_k(tmp_path):
    """``cli serve --mesh --device cpu`` builds a mesh ``Recommender`` over
    the one CPU device (one row block) and answers ``/score`` and ``/top_k``
    over HTTP as the single-device ``Recommender`` does."""
    import http.client

    from pytorch_news_recommender_tpu_torch.models import build_model

    cfg = synthetic_config()
    ds = synthetic.generate(cfg.data, seed=0, bert_dim=64, n_users=200, n_neighbors=8,
                            n_test=64)
    model = build_model(cfg.model.with_artifact_meta(ds.meta))
    model.reset_parameters(torch.Generator().manual_seed(0))
    save_checkpoint(tmp_path / "ckpt", cfg, model.state_dict())
    args = cli.build_parser().parse_args(
        ["serve", "--data", "synthetic", "--ckpt", str(tmp_path / "ckpt"), "--port", "0",
         "--device", "cpu", "--mesh"])
    srv = cli.build_server(args)
    rec = srv.rec
    assert rec.mesh is not None and rec.mesh.shape == {"data": 1, "model": 1}
    assert len(rec.vec_blocks) == 1 and rec.block_rows == ds.news.n_news
    one = Recommender(cfg, ds, model.state_dict(), device="cpu")
    srv.start(block=False)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)

        def post(path, body):
            conn.request("POST", path, body=json.dumps(body))
            return json.loads(conn.getresponse().read())
        r = post("/score", {"history": [1, 2, 3], "candidates": [4, 5, 6]})
        np.testing.assert_array_equal(r["scores"], one.score([1, 2, 3], [4, 5, 6]))
        r = post("/top_k", {"history": [1, 2, 3], "k": 5})
        np.testing.assert_array_equal(r["ids"], one.top_k([1, 2, 3], 5)[0])
    finally:
        srv.stop()


@pytest.mark.parametrize("command", ["train", "submit"])
def test_cli_cluster_flags_need_all_three(command, monkeypatch):
    """``--coordinator`` alone (the JAX CLI's partial spec) is refused
    before anything runs, naming what is missing; ``--no-distributed``
    contradicts explicit flags."""
    monkeypatch.delenv("NEWSREC_NO_DISTRIBUTED", raising=False)
    extra = ["--ckpt", "c"] if command == "submit" else []
    with pytest.raises(SystemExit, match="num_processes"):
        cli.main([command, "--data", "synthetic", "--coordinator", "h:1"] + extra)
    with pytest.raises(SystemExit, match="contradicts"):
        cli.main([command, "--data", "synthetic", "--process-id", "0",
                  "--no-distributed"] + extra)


# ---- preprocessing ----------------------------------------------------------

def _same_dataset(got, expect):
    assert got.meta.to_json() == expect.meta.to_json()
    assert got.news.as_dict().keys() == expect.news.as_dict().keys()
    for k, v in expect.news.as_dict().items():
        np.testing.assert_array_equal(got.news.as_dict()[k], v, err_msg=k)
    for name in ("train", "dev", "test"):
        a, b = getattr(got, name), getattr(expect, name)
        assert (a is None) == (b is None), name
        for f in dataclasses.fields(b) if b is not None else ():
            x, y = getattr(a, f.name), getattr(b, f.name)
            assert (x is None) == (y is None), (name, f.name)
            if y is not None:
                np.testing.assert_array_equal(x, y, err_msg=f"{name}.{f.name}")
    for k in ("word_embeddings", "entity_embeddings"):
        a, b = getattr(got, k), getattr(expect, k)
        assert (a is None) == (b is None), k
        if b is not None:
            np.testing.assert_array_equal(a, b, err_msg=k)
    assert got.dicts == expect.dicts


@pytest.fixture()
def mind_dirs(tmp_path):
    """The TSVs of ``tests/test_mind.py``, with the dev split as a test split
    too."""
    for d, news, beh in [("train", NEWS_TSV, TRAIN_BEHAVIORS),
                         ("dev", DEV_NEWS_TSV, DEV_BEHAVIORS)]:
        (tmp_path / d).mkdir()
        (tmp_path / d / "news.tsv").write_text(news)
        (tmp_path / d / "behaviors.tsv").write_text(beh)
    (tmp_path / "train" / "entity_embedding.vec").write_text(ENTITY_VEC)
    (tmp_path / "glove.txt").write_text(GLOVE)
    return tmp_path


def test_cli_preprocess_and_stats_equal_the_jax_pipeline(mind_dirs, capsys):
    m = mind_dirs
    out = m / "artifacts"
    _run(["preprocess", "--train-dir", str(m / "train"), "--dev-dir", str(m / "dev"),
          "--test-dir", str(m / "dev"), "--glove", str(m / "glove.txt"),
          "--word-embed-size", "4", "--graph-neighbors", "2", "--history-len", "6",
          "--sample-size", "2", "--min-history", "3", "--entity-nums", "3",
          "--word-freq-threshold", "2", "--out", str(out)], capsys)
    cfg = JaxDataConfig(history_len=6, sample_size=2, min_history=3, entity_nums=3,
                        word_freq_threshold=2)
    expect = jax_mind.build_dataset(cfg, m / "train", m / "dev", test_dir=m / "dev",
                                    glove_path=m / "glove.txt", word_embed_size=4,
                                    news_graph_neighbors=2, use_native=False)
    _same_dataset(RecDataset.load(out), expect)
    got = json.loads(_run(["stats", "--artifacts", str(out)], capsys))
    jax_cli.cmd_stats(argparse.Namespace(artifacts=str(out)))
    assert got == json.loads(capsys.readouterr().out)


def test_cli_preprocess_adressa_equals_the_jax_pipeline(tmp_path, capsys):
    """The event log of ``tests/test_adressa.py``'s fixture."""
    rng = np.random.default_rng(0)
    news = [(f"art{i}", f"Nyheter artikkel nummer {i} idag",
             "nyheter|trondheim" if i % 2 else "sport|fotball") for i in range(20)]
    lines = []
    for step in range(300):
        nid, title, cat = news[int(rng.integers(0, len(news)))]
        lines.append(json.dumps({"uid": f"u{rng.integers(0, 8)}", "id": nid, "title": title,
                                 "category1": cat, "time": 1000 + 10 * step}))
    events = tmp_path / "events.jsonl"
    events.write_text("\n".join(lines) + "\n")
    out = tmp_path / "artifacts"
    _run(["preprocess-adressa", "--events", str(events), "--dev-negatives", "5",
          "--history-len", "10", "--sample-size", "3", "--min-history", "3",
          "--graph-neighbors", "3", "--out", str(out)], capsys)
    expect = jax_adressa.build_dataset(
        JaxDataConfig(history_len=10, sample_size=3, min_history=3), [events],
        dev_negatives=5, news_graph_neighbors=3)
    _same_dataset(RecDataset.load(out), expect)


def test_plot_loss_renders_the_metrics_stream(tmp_path):
    pytest.importorskip("matplotlib")
    f = tmp_path / "metrics.jsonl"
    f.write_text("\n".join(json.dumps(r) for r in [
        {"step": 1, "loss": 1.5}, {"step": 2, "loss": 1.2},
        {"step": 2, "auc": 0.6, "tag": "step2"}]) + "\n")
    png = plot_loss(f)
    assert png == tmp_path / "metrics.png" and png.stat().st_size > 0
