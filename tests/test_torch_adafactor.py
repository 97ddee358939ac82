"""The port's Adafactor (``train/loop.py::Optimizer``, ``optimizer=
"adafactor"``) against ``optax.adafactor`` as the JAX package builds it
(``make_optimizer``), its training step against the JAX Trainer's, and its
state through a checkpoint."""

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
from pytorch_news_recommender_tpu_torch.config import Config, synthetic_config
from pytorch_news_recommender_tpu_torch.data import synthetic
from pytorch_news_recommender_tpu_torch.data.loader import train_batches
from pytorch_news_recommender_tpu_torch.models.convert import from_flax
from pytorch_news_recommender_tpu_torch.train.checkpoint import CheckpointManager
from pytorch_news_recommender_tpu_torch.train.loop import Optimizer, Trainer

torch.set_num_threads(2)

# factored (second-largest dimension >= 128, either axis the larger, a
# square, three axes) and per-entry leaves (a vector, a narrow matrix)
SHAPES = {"table": (512, 48 * 4), "wqkv": (192, 576), "wo": (192, 192),
          "aw": (130, 140), "conv": (3, 130, 160), "bias": (200,),
          "narrow": (64, 300)}


@pytest.mark.parametrize("over", [{}, {"grad_clip_norm": 1.0},
                                  {"grad_accum_steps": 2},
                                  {"grad_clip_norm": 0.5, "grad_accum_steps": 3}])
def test_adafactor_matches_optax(over):
    """6 updates of the same tree with the same gradients: every entry of
    every parameter and second moment within 1e-6 relative of optax's, or
    1e-6 of the tensor's largest entry (an entry near 0 can differ by one
    float32 rounding of the larger entries)."""
    d = JaxConfig().to_dict()
    d["train"].update(over, optimizer="adafactor", learning_rate=0.01)
    tx = jax_loop.make_optimizer(JaxConfig.from_dict(d))
    rng = np.random.default_rng(1)
    init = {k: rng.normal(size=s).astype(np.float32) * (0.01 if k == "bias" else 1.0)
            for k, s in SHAPES.items()}
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = Optimizer(tp, Config.from_dict(d).train)
    assert sorted(opt.v) == ["bias", "narrow"]
    assert sorted(opt.v_row) == sorted(opt.v_col) == ["aw", "conv", "table", "wo", "wqkv"]
    for _ in range(6):
        g = {k: (rng.normal(size=v.shape) * 0.3).astype(np.float32) for k, v in init.items()}
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    def close(ours, theirs, k):
        theirs = np.asarray(theirs)
        np.testing.assert_allclose(ours, theirs, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(theirs).max()), err_msg=k)

    for k in init:
        close(tp[k].detach().numpy(), jp[k], k)
    inner = state.inner_opt_state if hasattr(state, "inner_opt_state") else state
    fact = next(s for s in jax.tree_util.tree_leaves(
        inner, is_leaf=lambda x: hasattr(x, "v_row")) if hasattr(s, "v_row"))
    assert int(fact.count) == opt.count
    for k in init:
        if k in opt.v:
            close(opt.v[k].numpy(), fact.v[k], k)
        else:
            for ours, theirs in ((opt.v_row, fact.v_row), (opt.v_col, fact.v_col)):
                close(ours[k].numpy(), theirs[k], k)


DATA = dict(seed=3, n_train=256, n_dev=48, title_len=(11.5, 4))


@pytest.fixture(scope="module")
def pair():
    """Port and JAX trainers with ``optimizer="adafactor"`` (dropout off, a
    128-wide model so that the word table and the towers' projections
    factor), same data, and the Flax init parameters."""
    over = {"model.dropout": 0.0, "model.word_embed_size": 128,
            "train.optimizer": "adafactor", "train.learning_rate": 0.01}
    cfg, jcfg = synthetic_config(**over), jax_synthetic_config(**over)
    ds = synthetic.generate(cfg.data, **DATA)
    jtr = jax_loop.Trainer(jcfg, jax_synthetic.generate(jcfg.data, **DATA))
    params = jax.device_get(jtr.init_state(seed=0).params)
    return Trainer(cfg, ds, device="cpu"), jtr, params


def test_adafactor_steps_track_jax_trainer(pair):
    """Three steps from the Flax init weights on the same dedup +
    length-split batches: losses within 1e-4 each step and every parameter
    within 1e-4 after them (the key biases' exact-zero gradients move them by
    at most lr times the 1e-3 parameter scale)."""
    tr, jtr, params = pair
    state = tr.init_state(params=from_flax(params))
    assert state.opt.v_row, "no parameter factors at these widths"
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
    got = state.params
    for k, v in from_flax(jax.device_get(jstate.params)).items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_adafactor_checkpoint_round_trip_is_exact(pair, tmp_path):
    """Two steps, a checkpoint, a restore into a fresh state: the factored
    and per-entry moments, the count and the step come back, and the next
    step equals the uninterrupted run's bit for bit."""
    tr, _, params = pair
    batches = list(train_batches(tr.dataset.train, 32, np.random.default_rng(4), dedup=True,
                                 length_split=tr._length_split))[:3]
    state = tr.init_state(params=from_flax(params))
    for b in batches[:2]:
        state, _ = tr.run_step(state, b)
    mngr = CheckpointManager(tmp_path / "ck", tr.cfg)
    mngr.save(state.step, state, {"auc": 0.6})
    restored = mngr.restore(tr.init_state(seed=5))
    assert restored.step == state.step == 2 and restored.opt.count == 2
    for key in ("v_row", "v_col", "v"):
        ours, theirs = getattr(state.opt, key), getattr(restored.opt, key)
        assert sorted(ours) == sorted(theirs) and ours, key
        for n in ours:
            assert torch.equal(ours[n], theirs[n]), (key, n)
    state, m1 = tr.run_step(state, batches[2])
    restored, m2 = tr.run_step(restored, batches[2])
    assert float(m1["loss"]) == float(m2["loss"])
    for k, v in state.params.items():
        assert torch.equal(v, restored.params[k]), k
    # Adam's state does not load into Adafactor
    adam = Trainer(synthetic_config(**{"model.dropout": 0.0, "model.word_embed_size": 128}),
                   tr.dataset, device="cpu")
    with pytest.raises(ValueError, match="does not keep"):
        CheckpointManager(tmp_path / "ck").restore(adam.init_state(seed=0))
