"""Attention inspection (``utils/inspect.py``, ``cli train --log-attention``)
against the JAX package's ``utils/inspect.py`` on the same weights."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_news_recommender_tpu import models as jax_models
from pytorch_news_recommender_tpu.config import synthetic_config as jax_synthetic_config
from pytorch_news_recommender_tpu.data import synthetic as jax_synthetic
from pytorch_news_recommender_tpu.train import loop as jax_loop
from pytorch_news_recommender_tpu.utils import inspect as jax_inspect
from pytorch_news_recommender_tpu_torch import cli
from pytorch_news_recommender_tpu_torch.config import synthetic_config
from pytorch_news_recommender_tpu_torch.data import synthetic
from pytorch_news_recommender_tpu_torch.data.loader import train_batches
from pytorch_news_recommender_tpu_torch.models.convert import from_flax
from pytorch_news_recommender_tpu_torch.ops import fused_encoder as FE
from pytorch_news_recommender_tpu_torch.train.loop import Trainer
from pytorch_news_recommender_tpu_torch.utils.inspect import (
    attention_maps, attention_summary,
)

torch.set_num_threads(2)

DATA = dict(seed=3, n_train=64, n_dev=8)


def _jax_maps(jtr, params, batch):
    """The JAX CLI's inspection: a model built with ``use_pallas=False``
    applied with the trained parameters."""
    imodel = jax_models.build_model(dataclasses.replace(jtr.model.cfg, use_pallas=False))
    return jax_inspect.attention_maps(imodel, params,
                                      {k: jnp.asarray(v) for k, v in batch.items()},
                                      jtr.news_feats)


def test_attention_maps_and_summary_match_jax():
    """Same Flax weights, same batch: every site's weights within 1e-5 of
    the JAX package's, under the same keys, and the summaries within 1e-5;
    no kernel wrapper is called, and the model scores as before after."""
    cfg, jcfg = synthetic_config(), jax_synthetic_config()
    jtr = jax_loop.Trainer(jcfg, jax_synthetic.generate(jcfg.data, **DATA))
    params = jax.device_get(jtr.init_state(seed=0).params)
    tr = Trainer(cfg, synthetic.generate(cfg.data, **DATA), device="cpu")
    model = tr.init_state(params=from_flax(params)).model
    batch = next(train_batches(tr.dataset.train, 16, np.random.default_rng(0)))
    tb = tr._to_device(batch)
    before = model(tb, tr.news_feats).detach()
    calls = []
    wrapped = FE.fused_news_encoder_reference

    def counting(*a, **k):
        calls.append(1)
        return wrapped(*a, **k)
    FE.fused_news_encoder_reference = counting
    try:
        maps = attention_maps(model, tb, tr.news_feats)
    finally:
        FE.fused_news_encoder_reference = wrapped
    assert not calls, "the inspection path reached the encoder wrapper"
    expect = _jax_maps(jtr, params, batch)
    assert sorted(maps) == sorted(expect) == ["news_encoder/tower", "user_encoder/tower"]
    for k, v in expect.items():
        np.testing.assert_allclose(maps[k], np.asarray(v, np.float32), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    got, want = attention_summary(maps), jax_inspect.attention_summary(expect)
    for k in want:
        for stat in want[k]:
            assert got[k][stat] == pytest.approx(want[k][stat], rel=1e-5, abs=1e-5), (k, stat)
    assert torch.equal(model(tb, tr.news_feats).detach(), before)


def test_cli_train_log_attention_logs_the_jax_sites(tmp_path):
    """``cli train --log-attention`` (the option that raised before) logs
    one line per site of the JAX CLI's inspection, each a distribution's
    summary."""
    assert cli.main(["train", "--data", "synthetic", "--epochs", "1", "--batch-size", "256",
                     "--device", "cpu", "--save-dir", str(tmp_path),
                     "--log-attention"]) == 0
    lines = [json.loads(x) for x in (tmp_path / "nrms" / "metrics.jsonl").read_text()
             .splitlines()]
    att = {x["site"]: x for x in lines if x.get("tag") == "attention"}
    jcfg = jax_synthetic_config()
    jtr = jax_loop.Trainer(jcfg, jax_synthetic.generate(jcfg.data, **DATA))
    batch = next(train_batches(jtr.dataset.train, 16, np.random.default_rng(0)))
    expect = _jax_maps(jtr, jax.device_get(jtr.init_state(seed=0).params), batch)
    assert sorted(att) == sorted(expect)
    for site, a in att.items():
        assert a["seq_len"] == expect[site].shape[-1]
        assert 0.0 <= a["entropy"] <= 1.0 + 1e-6
        assert a["mean"] == pytest.approx(1.0 / a["seq_len"], abs=1e-3)
