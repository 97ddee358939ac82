"""The port's training engine (``train/loop.py``, ``cli train``) against the
JAX package's: the loss, the optimizer against optax, training steps and
evaluation from the same Flax weights, the fit loop's features, and the
train -> checkpoint -> serve round trip."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_news_recommender_tpu.config import Config as JaxConfig
from pytorch_news_recommender_tpu.config import synthetic_config as jax_synthetic_config
from pytorch_news_recommender_tpu.data import synthetic as jax_synthetic
from pytorch_news_recommender_tpu.data.loader import train_batches as jax_train_batches
from pytorch_news_recommender_tpu.train import loop as jax_loop
from pytorch_news_recommender_tpu_torch import cli
from pytorch_news_recommender_tpu_torch.config import Config, synthetic_config
from pytorch_news_recommender_tpu_torch.data import synthetic
from pytorch_news_recommender_tpu_torch.data.loader import train_batches
from pytorch_news_recommender_tpu_torch.models.convert import from_flax
from pytorch_news_recommender_tpu_torch.serve import Recommender
from pytorch_news_recommender_tpu_torch.train.checkpoint import CheckpointManager
from pytorch_news_recommender_tpu_torch.train.loop import (
    Optimizer, Trainer, softmax_ce_loss,
)

torch.set_num_threads(2)

DATA = dict(seed=3, n_train=256, n_dev=48, title_len=(11.5, 4))


def _cfgs(**overrides):
    """The same synthetic config (dropout off) in both packages."""
    over = {"model.dropout": 0.0, **overrides}
    return synthetic_config(**over), jax_synthetic_config(**over)


@pytest.fixture(scope="module")
def pair():
    """(port trainer, JAX trainer, Flax init params), same data and config;
    MIND-like title lengths, so that dedup batches split into a short and a
    long block."""
    cfg, jcfg = _cfgs()
    ds = synthetic.generate(cfg.data, **DATA)
    jds = jax_synthetic.generate(jcfg.data, **DATA)
    jtr = jax_loop.Trainer(jcfg, jds)
    params = jax.device_get(jtr.init_state(seed=0).params)
    return Trainer(cfg, ds, device="cpu"), jtr, params


def test_softmax_ce_loss_equals_jax():
    s = np.random.default_rng(0).normal(size=(7, 6)).astype(np.float32) * 3
    np.testing.assert_allclose(float(softmax_ce_loss(torch.from_numpy(s))),
                               float(jax_loop.softmax_ce_loss(jnp.asarray(s))),
                               rtol=1e-6)


@pytest.mark.parametrize("over", [
    {}, {"weight_decay": 0.01}, {"warm_up": True, "warm_up_steps": 3},
    {"grad_clip_norm": 0.5}, {"grad_accum_steps": 2},
    {"warm_up": True, "warm_up_steps": 2, "grad_clip_norm": 1.0, "weight_decay": 0.1,
     "grad_accum_steps": 2}])
def test_optimizer_matches_optax(over):
    """5 updates of a toy tree with the same gradients: rtol 1e-5, and atol
    1e-6 (2e-5 of one update at lr 0.05) for the float32 rounding of the
    schedule and the bias corrections, which optax takes in float32."""
    d = JaxConfig().to_dict()
    d["train"].update(over, learning_rate=0.05)
    jcfg = JaxConfig.from_dict(d)
    tx = jax_loop.make_optimizer(jcfg)
    rng = np.random.default_rng(1)
    init = {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = Optimizer(tp, Config.from_dict(d).train)
    for _ in range(5):
        g = {k: (rng.normal(size=v.shape) * 2).astype(np.float32) for k, v in init.items()}
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k in init:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-6)


def test_three_steps_track_jax_trainer(pair):
    """From the Flax init weights, on the same dedup + length-split batches:
    losses within 1e-4 each step, parameters within 1e-4 after 3 steps."""
    tr, jtr, params = pair
    state = tr.init_state(params=from_flax(params))
    jstate = jtr.init_state(seed=0)
    batches = list(train_batches(tr.dataset.train, 32, np.random.default_rng(2), dedup=True,
                                 length_split=tr._length_split))[:3]
    jbatches = list(jax_train_batches(jtr.dataset.train, 32, np.random.default_rng(2),
                                      dedup=True, length_split=jtr._length_split))[:3]
    assert all("short_mark" in b for b in batches)
    for b, jb in zip(batches, jbatches):
        state, m = tr.run_step(state, b)
        jstate, jm = jtr.run_step(jstate, jb, jax.random.PRNGKey(0))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4, atol=1e-4)
    assert state.step == 3
    got = state.params
    for k, v in from_flax(jax.device_get(jstate.params)).items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_evaluate_equals_jax_trainer(pair):
    tr, jtr, params = pair
    got = tr.evaluate(from_flax(params))
    expect = jtr.evaluate(params)
    assert got.keys() == expect.keys()
    for k in expect:
        np.testing.assert_allclose(got[k], expect[k], rtol=1e-5, atol=1e-5, err_msg=k)


def test_synthetic_fit_learns():
    cfg = synthetic_config()
    ds = synthetic.generate(cfg.data, seed=1, n_train=768, n_dev=96)
    tr = Trainer(cfg, ds, device="cpu")
    state, history = tr.fit(num_epochs=4)
    assert len(history) == 4
    assert history[-1]["auc"] > 0.75, history[-1]


@pytest.fixture(scope="module")
def small():
    cfg = synthetic_config()
    return cfg, synthetic.generate(cfg.data, seed=0, n_train=128, n_dev=32)


def test_early_stopping_fires(small):
    cfg, ds = small
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, eval_step=1, require_improvement=2, auc_checkpoint_floor=1.0))
    logs = []
    _, history = Trainer(cfg, ds, device="cpu").fit(num_epochs=3, log_fn=logs.append)
    assert any(entry.get("tag") == "early_stop" for entry in logs)
    assert len(history) == 2 < 3 * (len(ds.train) // cfg.train.batch_size)


@pytest.mark.parametrize("floor,expect_saves", [(1.0, False), (0.0, True)])
def test_checkpoint_cb_honours_the_floor(small, floor, expect_saves):
    cfg, ds = small
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, auc_checkpoint_floor=floor))
    saved = []
    Trainer(cfg, ds, device="cpu").fit(
        num_epochs=2, checkpoint_cb=lambda s, m, step: saved.append((step, m["auc"])))
    assert bool(saved) == expect_saves
    assert all(a > floor for _, a in saved)


def test_skip_nonfinite_updates_keeps_the_parameters(small):
    cfg, ds = small
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, skip_nonfinite_updates=True, batch_size=16))
    tr = Trainer(cfg, ds, device="cpu")
    state = tr.init_state(seed=0)
    batch = next(train_batches(ds.train, 16, np.random.default_rng(0)))
    state, m = tr.run_step(state, batch)
    assert m["skipped"] == 0.0
    with torch.no_grad():
        state.model.user_encoder.tower.aq[0] = float("nan")
    before = {k: v.clone() for k, v in state.params.items()}
    mu = {k: v.clone() for k, v in state.opt.mu.items()}
    state, m = tr.run_step(state, batch)
    assert not np.isfinite(float(m["loss"])) and m["skipped"] == 1.0
    for k, v in state.params.items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0, equal_nan=True)
    for k, v in state.opt.mu.items():
        assert torch.equal(v, mu[k])
    assert state.step == 2 and state.opt.count == 1


def test_pretrained_table_loads_widens_and_raises(small):
    cfg, ds = small
    n_words = ds.meta.n_words
    good = np.random.default_rng(0).standard_normal((n_words, 64)).astype(np.float32)
    state = Trainer(cfg, dataclasses.replace(ds, word_embeddings=good),
                    device="cpu").init_state(seed=0)
    np.testing.assert_array_equal(
        state.params["news_encoder.word_embedding.embedding"].numpy(), good)
    narrow = good[:, :48]
    state = Trainer(cfg, dataclasses.replace(ds, word_embeddings=narrow),
                    device="cpu").init_state(seed=0)
    emb = state.params["news_encoder.word_embedding.embedding"].numpy()
    np.testing.assert_array_equal(emb[:, :48], narrow)
    np.testing.assert_array_equal(emb[:, 48:], 0.0)
    bad = Trainer(cfg, dataclasses.replace(ds, word_embeddings=good[:-3]), device="cpu")
    with pytest.raises(ValueError, match="NOT by shape"):
        bad.init_state(seed=0)


@pytest.mark.parametrize("over,error,match", [
    # a model axis of 2 needs two processes: the JAX mesh_shape error
    ({"mesh.model_parallel_size": 2}, ValueError,
     r"n_devices=1 not divisible by model_parallel_size=2"),
    ({"train.auto_layouts": True}, ValueError, "XLA"),
])
def test_later_slices_options_raise(small, over, error, match):
    _, ds = small
    with pytest.raises(error, match=match):
        Trainer(synthetic_config(**over), ds, device="cpu").init_state(seed=0)


@pytest.mark.parametrize("dedup", [False, True])
def test_sliced_feed_fit_matches_plain_feed(small, dedup):
    """``sliced_feed`` in one process (the multi-process feed at one rank,
    as the JAX package's ``test_fit_through_sliced_feed_matches_plain``
    runs it) fits as the plain feed: without dedup the same losses and
    AUC; with dedup the same batches up to the unique buffer's layout, so
    the losses agree within 1e-5."""
    cfg, ds = small
    out = {}
    for sliced in (False, True):
        c = synthetic_config(**{"train.batch_size": 16, "train.eval_batch_size": 8,
                                "train.dedup_batches": dedup, "train.log_every": 1,
                                "train.eval_step": 0, "train.sliced_feed": sliced})
        tr = Trainer(c, ds, device="cpu")
        assert tr._sliced == sliced
        log = []
        state, _ = tr.fit(tr.init_state(seed=0), num_epochs=1, log_fn=log.append,
                          eval_each_epoch=False)
        out[sliced] = ([d["loss"] for d in log if "loss" in d], tr.evaluate(state))
    assert len(out[True][0]) == len(out[False][0]) == len(ds.train) // 16
    np.testing.assert_allclose(out[True][0], out[False][0], rtol=1e-5, atol=1e-6)
    assert out[True][1]["auc"] == pytest.approx(out[False][1]["auc"], abs=1e-6)


def test_gnn_frontier_buckets_set_the_frontier_widths():
    """``train.gnn_frontier_buckets`` sets the widths that the GNN frontier
    is padded to in ``Trainer._maybe_frontier``, the hook of ``run_step``
    and of ``fit``'s feed, as in the JAX trainer (``GNN_FRONTIER_BUCKETS``
    without it); a step and an epoch of ``fit`` run on it; another family
    gets no frontier."""
    from pytorch_news_recommender_tpu_torch.data.loader import GNN_FRONTIER_BUCKETS

    cfg = synthetic_config(**{"model.name": "gnn"})
    ds = synthetic.generate(cfg.data, seed=0, n_train=64, n_dev=0, n_neighbors=4)
    batch = next(train_batches(ds.train, 32, np.random.default_rng(0), dedup=True))
    for buckets, width in ((None, GNN_FRONTIER_BUCKETS[0]), ((96, 640), 640)):
        tr = Trainer(synthetic_config(**{"model.name": "gnn",
                                         "train.gnn_frontier_buckets": buckets}),
                     ds, device="cpu")
        assert tr._frontier_depth == 2
        front = tr._maybe_frontier(batch)
        assert front["gnn_frontier_ids"].shape == (width,)
        assert front["gnn_nbr_pos"].shape == (width, 4)
        assert front["gnn_self_pos"].shape == batch["unique_ids"].shape
        state, m = tr.run_step(tr.init_state(seed=0), batch)
        assert np.isfinite(float(m["loss"]))
        state, _ = tr.fit(state, num_epochs=1, eval_each_epoch=False)
        assert state.step == 3
    nrms = Trainer(synthetic_config(**{"train.gnn_frontier_buckets": (96, 640)}), ds,
                   device="cpu")
    assert nrms._frontier_depth == 0 and nrms._maybe_frontier(batch) is batch


def test_dedup_gather_mxu_trains_on_the_cpu(small):
    """The segment-scatter option (refused before its kernel was ported)
    trains: with dropout off, its step gives the default step's loss and
    parameters to float32 rounding (only the gathers' backward differs)."""
    _, ds = small
    batch = next(train_batches(ds.train, 32, np.random.default_rng(0), dedup=True))
    out = {}
    for mxu in (False, True):
        tr = Trainer(synthetic_config(**{"model.dropout": 0.0,
                                         "model.dedup_gather_mxu": mxu}), ds, device="cpu")
        state = tr.init_state(seed=0)
        state, m = tr.run_step(state, batch)
        assert state.step == 1 and np.isfinite(float(m["loss"]))
        out[mxu] = (float(m["loss"]), state.params)
    assert out[True][0] == out[False][0]
    for k, v in out[False][1].items():
        torch.testing.assert_close(out[True][1][k], v, rtol=1e-5, atol=1e-6, msg=k)


def test_trainer_needs_cuda_unless_told_cpu(small, monkeypatch):
    cfg, ds = small
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg, ds)


def test_cli_train_writes_a_checkpoint_that_serves(tmp_path):
    rc = cli.main(["train", "--data", "synthetic", "--epochs", "1", "--device", "cpu",
                   "--save-dir", str(tmp_path)])
    assert rc == 0
    ckpt = tmp_path / "nrms"
    step = CheckpointManager(ckpt).best_step()
    assert (ckpt / "config.json").exists() and (ckpt / str(step) / "params.npz").exists()
    assert (ckpt / str(step) / "opt_state.npz").exists()
    assert "final" in (ckpt / "metrics.jsonl").read_text()
    cfg = synthetic_config()
    ds = synthetic.generate(cfg.data, seed=0, bert_dim=64, n_users=200, n_neighbors=8,
                            n_test=64)
    rec = Recommender.from_checkpoint(ckpt, ds, device="cpu")
    scores = rec.score([1, 2, 3], [4, 5, 6, 7])
    assert scores.shape == (4,) and np.all(np.isfinite(scores))
