"""``train.debug_nans`` (``cli train --debug-nans``), the fail-fast opposite
of ``--skip-nonfinite``, in the port against the JAX package: a step whose
loss is NaN raises ``FloatingPointError`` in both trainers (JAX through
``jax_debug_nans``, the port through one finiteness check a step), so does
an evaluation with a NaN score, a finite step passes, the option off adds no
check and raises nothing, and both CLIs set the field from the flag.

The NaN comes from the parameters: the Flax init weights with one entry of
the user tower's pooling query ``aq``, drawn from a numpy seed, set to NaN,
so every user vector and every score is NaN.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_news_recommender_tpu import cli as jax_cli
from pytorch_news_recommender_tpu.config import synthetic_config as jax_synthetic_config
from pytorch_news_recommender_tpu.data import synthetic as jax_synthetic
from pytorch_news_recommender_tpu.data.loader import train_batches as jax_train_batches
from pytorch_news_recommender_tpu.train import loop as jax_loop
from pytorch_news_recommender_tpu_torch import cli
from pytorch_news_recommender_tpu_torch.config import synthetic_config
from pytorch_news_recommender_tpu_torch.data import synthetic
from pytorch_news_recommender_tpu_torch.data.loader import train_batches
from pytorch_news_recommender_tpu_torch.models.convert import from_flax
from pytorch_news_recommender_tpu_torch.train import loop

torch.set_num_threads(2)

DATA = dict(seed=3, n_train=64, n_dev=16)
BATCH = 16


def _over(debug):
    return {"model.dropout": 0.0, "train.debug_nans": debug}


def _nan_params(params, seed):
    """``params`` (Flax, on the host) with one entry of the user tower's
    ``aq``, drawn from ``seed``, set to NaN."""
    tower = dict(params["user_encoder"]["tower"])
    aq = np.array(tower["aq"])
    aq[np.random.default_rng(seed).integers(aq.size)] = np.nan
    tower["aq"] = aq
    return {**params, "user_encoder": {**params["user_encoder"], "tower": tower}}


@pytest.fixture
def jax_debug():
    """The JAX trainer with ``debug_nans`` turns on ``jax_debug_nans`` for the
    whole process: set it back afterwards."""
    yield
    jax.config.update("jax_debug_nans", False)


@pytest.fixture(scope="module")
def flax_params():
    """Flax init weights of the JAX trainer (seed 0), on the host."""
    jcfg = jax_synthetic_config(**_over(False))
    jtr = jax_loop.Trainer(jcfg, jax_synthetic.generate(jcfg.data, **DATA))
    return jax.device_get(jtr.init_state(seed=0).params)


def _port(debug, params):
    """(port trainer on the CPU, its state at ``params``, one batch)."""
    cfg = synthetic_config(**_over(debug))
    ds = synthetic.generate(cfg.data, **DATA)
    tr = loop.Trainer(cfg, ds, device="cpu")
    batch = next(train_batches(ds.train, BATCH, np.random.default_rng(0)))
    return tr, tr.init_state(params=from_flax(params)), batch


@pytest.mark.parametrize("seed", [0, 1])
def test_nan_loss_raises_in_both_trainers(jax_debug, flax_params, seed):
    params = _nan_params(flax_params, seed)
    jcfg = jax_synthetic_config(**_over(True))
    jds = jax_synthetic.generate(jcfg.data, **DATA)
    jtr = jax_loop.Trainer(jcfg, jds)
    assert jax.config.jax_debug_nans
    jstate = jtr.init_state(seed=0)
    jstate = jstate.replace(params=jax.tree_util.tree_map(jnp.asarray, params))
    jb = next(jax_train_batches(jds.train, BATCH, np.random.default_rng(0)))
    with pytest.raises(FloatingPointError):
        jtr.run_step(jstate, jb, jax.random.PRNGKey(0))
    jax.config.update("jax_debug_nans", False)

    tr, state, batch = _port(True, params)
    before = {k: v.clone() for k, v in state.params.items()}
    with pytest.raises(FloatingPointError, match="non-finite loss at step 0"):
        tr.run_step(state, batch)
    # it raised before the update
    for k, v in state.params.items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0, equal_nan=True)
    assert state.opt.count == 0


def test_nan_score_raises_in_both_evaluations(jax_debug, flax_params):
    params = _nan_params(flax_params, 2)
    jcfg = jax_synthetic_config(**_over(True))
    jtr = jax_loop.Trainer(jcfg, jax_synthetic.generate(jcfg.data, **DATA))
    with pytest.raises(FloatingPointError):
        jtr.evaluate(jax.tree_util.tree_map(jnp.asarray, params))
    jax.config.update("jax_debug_nans", False)

    tr, _, _ = _port(True, params)
    with pytest.raises(FloatingPointError, match="non-finite score"):
        tr.evaluate(from_flax(params))


def test_finite_step_passes_the_check(flax_params, monkeypatch):
    checks = []
    real = loop._raise_nonfinite
    monkeypatch.setattr(loop, "_raise_nonfinite", lambda *a: checks.append(1) or real(*a))
    tr, state, batch = _port(True, flax_params)
    state, m = tr.run_step(state, batch)
    assert np.isfinite(float(m["loss"])) and state.step == 1 and checks == [1]
    assert np.isfinite(tr.evaluate(state)["auc"])


def test_option_off_adds_no_check_and_raises_nothing(flax_params, monkeypatch):
    checks = []
    monkeypatch.setattr(loop, "_raise_nonfinite", lambda *a: checks.append(1))
    tr, state, batch = _port(False, _nan_params(flax_params, 0))
    state, m = tr.run_step(state, batch)
    assert not np.isfinite(float(m["loss"])) and state.step == 1 and checks == []


@pytest.mark.parametrize("flag", [True, False], ids=["debug-nans", "default"])
def test_cli_train_sets_the_field_as_the_jax_cli_does(flag, monkeypatch):
    """Each CLI's ``train`` parses ``--data synthetic [--debug-nans]`` and
    builds its config (the command itself is stood in)."""
    got = {}
    extra = ["--debug-nans"] if flag else []
    monkeypatch.setattr(cli, "cmd_train",
                        lambda a: got.setdefault("port", cli._build_config(a)) and 0)
    monkeypatch.setattr(jax_cli, "cmd_train",
                        lambda a: got.setdefault("jax", jax_cli._build_config(a)) and 0)
    assert cli.main(["train", "--data", "synthetic", "--device", "cpu", *extra]) == 0
    assert jax_cli.main(["train", "--data", "synthetic", *extra]) == 0
    assert got["port"].train.debug_nans is flag
    assert got["jax"].train.debug_nans is flag
