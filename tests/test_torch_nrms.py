"""The port's NRMS against the JAX package's, with the Flax init weights
carried over by ``models/convert.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_news_recommender_tpu.config import synthetic_config as jax_synthetic_config
from pytorch_news_recommender_tpu.data import synthetic as jax_synthetic
from pytorch_news_recommender_tpu.train.loop import Trainer
from pytorch_news_recommender_tpu_torch.config import synthetic_config
from pytorch_news_recommender_tpu_torch.data import synthetic
from pytorch_news_recommender_tpu_torch.models import available_models, build_model
from pytorch_news_recommender_tpu_torch.models.convert import (
    assign, from_flax, load_params, save_params, to_flax,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    """(JAX trainer, Flax params, port model with the same weights, port
    dataset)."""
    jcfg = jax_synthetic_config()
    jds = jax_synthetic.generate(jcfg.data, seed=5, n_train=64, n_dev=16)
    trainer = Trainer(jcfg, jds)
    params = jax.device_get(trainer.init_state().params)
    cfg = synthetic_config()
    ds = synthetic.generate(cfg.data, seed=5, n_train=64, n_dev=16)
    model = build_model(cfg.model.with_artifact_meta(ds.meta))
    assign(model, from_flax(params))
    return trainer, params, model.eval(), ds


def _feats(ds):
    return {k: torch.from_numpy(v) for k, v in ds.news.as_dict().items()}


def test_encode_news_ids_matches_flax(pair):
    trainer, params, model, ds = pair
    ids = np.array([[0, 1, 2, 3], [7, 0, 399, 400]], np.int32)
    expect = jax.jit(lambda p, i: trainer.model.apply(
        {"params": p}, i, trainer.news_feats, True, method="encode_news_ids"))(
        params, jnp.asarray(ids))
    with torch.no_grad():
        got = model.encode_news_ids(torch.from_numpy(ids), _feats(ds))
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=1e-4, atol=1e-4)


def test_score_from_vecs_matches_flax(pair):
    trainer, params, model, ds = pair
    rng = np.random.default_rng(0)
    vecs = rng.normal(size=(401, 64)).astype(np.float32)
    batch = {"browsed_ids": rng.integers(0, 401, size=(3, 50)).astype(np.int32),
             "candidate_ids": rng.integers(0, 401, size=(3, 8)).astype(np.int32)}
    batch["browsed_ids"][0, :45] = 0     # a short history
    batch["candidate_ids"][1, 5:] = 0    # padded candidates
    expect = jax.jit(lambda p, b, v: trainer.model.apply(
        {"params": p}, b, v, method="score_from_vecs"))(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(vecs))
    with torch.no_grad():
        got = model.score_from_vecs({k: torch.from_numpy(v) for k, v in batch.items()},
                                    torch.from_numpy(vecs))
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=1e-4, atol=1e-4)


def test_direct_batch_forward_matches_flax(pair):
    trainer, params, model, ds = pair
    batch = {"browsed_ids": ds.dev.browsed_ids[:4],
             "candidate_ids": ds.train.candidate_ids[:4]}
    expect = jax.jit(lambda p, b: trainer.model.apply(
        {"params": p}, b, trainer.news_feats, True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = model({k: torch.from_numpy(v) for k, v in batch.items()}, _feats(ds))
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=1e-4, atol=1e-4)


def test_flax_roundtrip_is_exact(pair):
    _, params, _, _ = pair
    back = to_flax(from_flax(params))
    flat = jax.tree_util.tree_leaves_with_path(params)
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))


def test_save_load_params_roundtrip(pair, tmp_path):
    _, _, model, _ = pair
    save_params(tmp_path / "params.npz", model.state_dict())
    assert "news_encoder/tower/wqkv" in np.load(tmp_path / "params.npz").files
    back = load_params(tmp_path / "params.npz")
    for k, v in model.state_dict().items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)


def test_assign_fails_loudly(pair):
    _, params, model, ds = pair
    state = from_flax(params)
    fresh = build_model(synthetic_config().model.with_artifact_meta(ds.meta))
    missing = dict(state)
    del missing["user_encoder.tower.aq"]
    with pytest.raises(ValueError, match="user_encoder.tower.aq"):
        assign(fresh, missing)
    wrong = dict(state, **{"news_encoder.tower.wo": torch.zeros(3, 3)})
    with pytest.raises(ValueError, match="news_encoder.tower.wo"):
        assign(fresh, wrong)


def test_seeded_init_draws_flax_distributions(pair):
    _, _, _, ds = pair
    cfg = synthetic_config(**{"model.word_embed_size": 300,
                              "model.num_attention_heads": 10,
                              "model.query_vector_dim": 200})
    model = build_model(cfg.model.with_artifact_meta(ds.meta))
    model.reset_parameters(torch.Generator().manual_seed(0))
    t = model.news_encoder.tower
    limit = np.sqrt(6 / (300 + 900))
    assert t.wqkv.abs().max() <= limit and t.wqkv.abs().max() > 0.95 * limit
    assert torch.all(t.bqkv == 0) and t.aq.abs().max() <= 0.1
    emb = model.news_encoder.word_embedding.embedding
    assert torch.all(emb[0] == 0) and abs(float(emb[1:].detach().std()) - 1) < 0.01
    again = build_model(cfg.model.with_artifact_meta(ds.meta))
    again.reset_parameters(torch.Generator().manual_seed(0))
    for k, v in model.state_dict().items():
        assert torch.equal(v, again.state_dict()[k]), k


def test_registry_points_unported_families_at_roadmap():
    """Every family is ported: the port's registry is the JAX package's
    twelve, and an unknown name raises a ``KeyError`` in both."""
    from pytorch_news_recommender_tpu.models import available_models as jax_available
    from pytorch_news_recommender_tpu.models import build_model as jax_build

    assert available_models() == jax_available() and len(available_models()) == 12
    with pytest.raises(KeyError, match="unknown model family 'nope'"):
        build_model(synthetic_config(**{"model.name": "nope"}).model)
    with pytest.raises(KeyError, match="unknown model 'nope'"):
        jax_build(jax_synthetic_config(**{"model.name": "nope"}).model)
