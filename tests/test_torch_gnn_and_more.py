"""The port's ``gnn``, ``fastformer``, ``npa`` and ``list_rank`` pieces
against the JAX package's, on the CPU in float32, from the Flax init
weights: the GNN frontier arrays (exactly), the frontier forward and its
gradients against the recursive forward and JAX's frontier forward, the
levelwise corpus encode, a fresh news item as an isolated node, the
serving refusals that the port keeps from JAX (``fastformer``'s ``top_k``,
NPA's ``Recommender``, ``list_rank`` at ten user heads), ``list_rank``'s
``top_k`` and the family training defaults. Tolerance rtol/atol 1e-4, as
``test_torch_families.py`` holds the families' forwards and steps."""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_news_recommender_tpu import config as jax_config
from pytorch_news_recommender_tpu.config import synthetic_config as jax_synthetic_config
from pytorch_news_recommender_tpu.data import loader as jax_loader
from pytorch_news_recommender_tpu.data import synthetic as jax_synthetic
from pytorch_news_recommender_tpu.models.common import (
    corpus_encode_levelwise as jax_corpus_encode_levelwise,
)
from pytorch_news_recommender_tpu.serve import Recommender as JaxRecommender
from pytorch_news_recommender_tpu.train import loop as jax_loop
from pytorch_news_recommender_tpu_torch import cli, config
from pytorch_news_recommender_tpu_torch.config import synthetic_config
from pytorch_news_recommender_tpu_torch.data import loader, synthetic
from pytorch_news_recommender_tpu_torch.models import build_model
from pytorch_news_recommender_tpu_torch.models.common import corpus_encode_levelwise
from pytorch_news_recommender_tpu_torch.models.convert import from_flax
from pytorch_news_recommender_tpu_torch.serve import Recommender
from pytorch_news_recommender_tpu_torch.train.loop import Trainer, softmax_ce_loss

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)
# a 400-news corpus with 4 graph neighbors per news, 64-wide BERT vectors
# and 50 users: every family of this file reads it
DATA = dict(seed=4, n_train=192, n_dev=32, n_neighbors=4, bert_dim=64, n_users=50)


@functools.lru_cache(maxsize=None)
def _pair(name, **over):
    """(port trainer, JAX trainer, Flax init params) of family ``name`` with
    dropout off, on the same data."""
    over = {"model.name": name, "model.dropout": 0.0, **over}
    cfg, jcfg = synthetic_config(**over), jax_synthetic_config(**over)
    jtr = jax_loop.Trainer(jcfg, jax_synthetic.generate(jcfg.data, **DATA))
    params = jax.device_get(jtr.init_state(seed=0).params)
    return Trainer(cfg, synthetic.generate(cfg.data, **DATA), device="cpu"), jtr, params


def _model(tr, params):
    return tr.init_state(params=from_flax(params)).model.eval()


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _dedup_batches(ds, n, batch_size=32):
    return list(loader.train_batches(ds.train, batch_size, np.random.default_rng(2),
                                     dedup=True))[:n]


def _with_dicts(ds):
    """A copy of ``ds`` with serving dictionaries (digit-free word tokens
    for every word id)."""
    def name(i):
        out = ""
        while i:
            i, r = divmod(i, 26)
            out += chr(97 + r)
        return "w" + out
    ds = copy.copy(ds)
    ds.dicts = {"word": {name(i): i for i in range(1, ds.meta.n_words)}}
    return ds


# ---- the GNN frontier ----

@pytest.mark.parametrize("depth,buckets", [(1, None), (2, None), (2, (256, 512))],
                         ids=["depth1", "depth2", "depth2-own-buckets"])
def test_frontier_arrays_equal_jax(depth, buckets):
    """``add_gnn_frontier`` gives JAX's arrays bit for bit: the closure ids
    with the pad news at slot 0, padded to a rung of ``buckets``, the
    neighbors' positions and the unique slots' positions; a direct batch is
    left as it is."""
    tr, jtr, _ = _pair("gnn")
    nbrs = tr.dataset.news.neighbors
    np.testing.assert_array_equal(nbrs, jtr.dataset.news.neighbors)
    kw = {} if buckets is None else {"buckets": buckets}
    for batch in _dedup_batches(tr.dataset, 3):
        got = loader.add_gnn_frontier(batch, nbrs, depth, **kw)
        expect = jax_loader.add_gnn_frontier(batch, nbrs, depth, **kw)
        assert list(got) == list(expect)
        for k, v in expect.items():
            assert got[k].dtype == np.asarray(v).dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        assert got["gnn_frontier_ids"][0] == 0
        assert len(got["gnn_frontier_ids"]) in (buckets or loader.GNN_FRONTIER_BUCKETS)
    direct = {"browsed_ids": tr.dataset.train.browsed_ids[:2]}
    assert loader.add_gnn_frontier(direct, nbrs, depth) is direct
    assert loader.GNN_FRONTIER_BUCKETS == jax_loader.GNN_FRONTIER_BUCKETS


def test_frontier_forward_and_gradients_match_recursive_and_jax():
    """On a dedup batch, the frontier form's scores and every gradient
    within 1e-4 of the recursive form's (the same batch without the
    frontier) and of JAX's frontier form's."""
    tr, jtr, params = _pair("gnn")
    (batch,) = _dedup_batches(tr.dataset, 1)
    front = tr._maybe_frontier(batch)
    assert "gnn_frontier_ids" in front and "gnn_frontier_ids" not in batch
    assert tr._maybe_frontier(front) is front

    def port(b):
        model = tr.init_state(params=from_flax(params)).model
        scores = model(_t(b), tr.news_feats, deterministic=False,
                       generator=torch.Generator().manual_seed(0))
        softmax_ce_loss(scores).backward()
        return scores.detach(), {k: p.grad for k, p in model.named_parameters()}

    def jax_side(b):
        def loss(p):
            s = jtr.model.apply({"params": p}, _j(b), jtr.news_feats, deterministic=False,
                                rngs={"dropout": jax.random.PRNGKey(0)})
            return jax_loop.softmax_ce_loss(s), s
        grads, s = jax.jit(jax.grad(loss, has_aux=True))(params)
        return np.asarray(s), from_flax(jax.device_get(grads))

    scores, grads = port(front)
    rec_scores, rec_grads = port(batch)
    jscores, jgrads = jax_side(front)
    np.testing.assert_allclose(scores.numpy(), rec_scores.numpy(), **TOL)
    np.testing.assert_allclose(scores.numpy(), jscores, **TOL)
    assert sorted(grads) == sorted(rec_grads) == sorted(jgrads)
    for k, g in jgrads.items():
        np.testing.assert_allclose(grads[k].numpy(), rec_grads[k].numpy(), err_msg=k, **TOL)
        np.testing.assert_allclose(grads[k].numpy(), g.numpy(), err_msg=k, **TOL)
    # both GAT layers and every tower learn from the frontier form
    assert all(float(grads[f"gat{i}.wq"].abs().max()) > 0 for i in range(2))


def test_levelwise_corpus_encode_matches_jax_and_the_recursive_encode():
    """``corpus_encode_levelwise`` over the whole table, in chunks whose
    last one is padded, within 1e-4 of JAX's and of the recursive encode of
    every id; the Trainer's corpus encode is the levelwise one."""
    tr, jtr, params = _pair("gnn")
    model = _model(tr, params)
    got = corpus_encode_levelwise(model, tr.news_feats, 128)
    expect = jax_corpus_encode_levelwise(jtr.model, 2, params, jtr.news_feats, 128)
    assert got.shape == (tr.dataset.news.n_news, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **TOL)
    with torch.no_grad():
        recursive = model.encode_news_ids(torch.arange(tr.dataset.news.n_news),
                                          tr.news_feats)
    np.testing.assert_allclose(got.numpy(), recursive.numpy(), **TOL)
    np.testing.assert_allclose(tr.compute_news_vectors(model).numpy(), got.numpy(),
                               rtol=0, atol=0)


@pytest.fixture(scope="module")
def gnn_served():
    tr, jtr, params = _pair("gnn")
    jrec = JaxRecommender(jtr.cfg, _with_dicts(jtr.dataset), params)
    rec = Recommender(tr.cfg, _with_dicts(tr.dataset), from_flax(params), device="cpu")
    return jrec, rec


def test_gnn_serves_and_ingests_fresh_news_as_jax(gnn_served):
    """The corpus table (levelwise) and scores within 1e-4 of the JAX
    ``Recommender``'s; a fresh news item gets an all-pad neighbor row and
    is encoded as an isolated node, its vector and its scores within 1e-4
    of JAX's; an isolated node's vector equals the levelwise encode of a
    news without neighbors."""
    jrec, rec = gnn_served
    np.testing.assert_allclose(rec.news_vecs.numpy(), np.asarray(jrec._tables()[0]), **TOL)
    hist, cands = [1, 5, 9, 30], [2, 3, 4, 200]
    np.testing.assert_allclose(rec.score(hist, cands), jrec.score(hist, cands), **TOL)
    words = list(rec.dicts["word"])
    title = " ".join(words[10:16])
    rows = rec.tokenize_new_news(title)
    assert rows["neighbors"].shape == (4,) and not rows["neighbors"].any()
    np.testing.assert_allclose(rec.encode_new_news(title), jrec.encode_new_news(title), **TOL)
    nid = rec.add_news(title)
    assert nid == jrec.add_news(title) == rec.n_news - 1
    assert rec.news_feats["neighbors"][nid].abs().sum() == 0
    hist, cands = [nid, 1, 2], [nid, 3, 4]
    np.testing.assert_allclose(rec.score(hist, cands), jrec.score(hist, cands), **TOL)
    # the same title as a corpus news without neighbors, encoded levelwise
    feats = {k: v[:nid + 1] for k, v in rec.news_feats.items()}
    table = corpus_encode_levelwise(rec.model, feats, 256)
    np.testing.assert_allclose(table[nid].float().numpy(), rec.encode_new_news(title), **TOL)


# ---- the serving refusals kept from JAX ----

def test_fastformer_top_k_refused_as_jax():
    """Fastformer has no ``user_encoder``: JAX's ``top_k`` fails with an
    ``AttributeError``; the port's raises a ``ValueError`` naming the
    family, and serves ``score`` (within 1e-4 of JAX's)."""
    tr, jtr, params = _pair("fastformer")
    rec = Recommender(tr.cfg, tr.dataset, from_flax(params), device="cpu")
    jrec = JaxRecommender(jtr.cfg, jtr.dataset, params)
    assert not rec.ranks_corpus
    with pytest.raises(ValueError, match="fastformer"):
        rec.top_k([1, 2, 3], 5)
    with pytest.raises(AttributeError, match="user_encoder"):
        jrec.top_k([1, 2, 3], 5)
    hist, cands = [1, 5, 9, 30], [2, 3, 4, 200]
    np.testing.assert_allclose(rec.score(hist, cands), jrec.score(hist, cands), **TOL)


def test_npa_recommender_refused_in_both_packages(tmp_path):
    """NPA's news vectors depend on the user: both ``Recommender``s raise
    the same ``ValueError``; ``cli train`` and ``eval`` run, ``serve``
    fails as JAX's does."""
    tr, jtr, params = _pair("npa")
    with pytest.raises(ValueError, match="TWO_TOWER=False"):
        JaxRecommender(jtr.cfg, jtr.dataset, params)
    with pytest.raises(ValueError, match="TWO_TOWER=False"):
        Recommender(tr.cfg, tr.dataset, from_flax(params), device="cpu")
    data = ["--data", "synthetic", "--model", "npa", "--device", "cpu"]
    assert cli.main(["train", *data, "--epochs", "1", "--batch-size", "64",
                     "--save-dir", str(tmp_path)]) == 0
    ckpt = str(tmp_path / "npa")
    assert cli.main(["eval", *data, "--ckpt", ckpt]) == 0
    args = cli.build_parser().parse_args(["serve", *data, "--ckpt", ckpt, "--port", "0"])
    with pytest.raises(ValueError, match="TWO_TOWER=False"):
        cli.build_server(args)


@pytest.fixture(scope="module")
def list_rank_served():
    tr, jtr, params = _pair("list_rank")
    jrec = JaxRecommender(jtr.cfg, jtr.dataset, params)
    rec = Recommender(tr.cfg, tr.dataset, from_flax(params), device="cpu")
    return jrec, rec, tr.dataset


def test_list_rank_scores_and_top_k_match_jax(list_rank_served):
    """``score_many`` through the interaction head, and ``top_k`` as the
    JAX ``Recommender`` ranks (the user tower's vector against the cached
    news vectors): the same ids, scores within 1e-4."""
    jrec, rec, ds = list_rank_served
    reqs = []
    for i in range(4):
        cands, _ = ds.dev.impression(i)
        reqs.append(([int(h) for h in ds.dev.browsed_ids[i] if h], [int(c) for c in cands],
                     i))
    for got, (hist, cands, _) in zip(rec.score_many(reqs), reqs):
        np.testing.assert_allclose(got, jrec.score(hist, cands), **TOL)
    for hist, _, _ in reqs[:3]:
        ids, scores = rec.top_k(hist, 10)
        jids, jscores = jrec.top_k(hist, 10)
        np.testing.assert_array_equal(ids, np.asarray(jids))
        np.testing.assert_allclose(scores, np.asarray(jscores), **TOL)


def test_list_rank_at_ten_user_heads_raises_in_both_packages():
    """The JAX defaults, ``list_title_size`` 512 and ``user_heads_num`` 10:
    512 is not a multiple of 10. JAX's ``MultiHeadSelfAttention`` asserts
    it at init; the port raises a ``ValueError`` when it builds the
    tower."""
    over = {"model.name": "list_rank", "model.list_title_size": 512,
            "model.user_heads_num": 10}
    jcfg = jax_synthetic_config(**over)
    jtr = jax_loop.Trainer(jcfg, jax_synthetic.generate(jcfg.data, **DATA))
    with pytest.raises(AssertionError, match="512, 10"):
        jtr.init_state(seed=0)
    cfg = synthetic_config(**over)
    with pytest.raises(ValueError, match="512 is not divisible by 10 heads"):
        Trainer(cfg, synthetic.generate(cfg.data, **DATA), device="cpu")
    assert build_model(synthetic_config(**{**over, "model.user_heads_num": 4}).model,
                       {"bert": (401, 64)}) is not None


# ---- the family training defaults ----

# (family, --lr) pairs; a pair, not a bare family name, so that the
# conftest's family-matrix rule keeps them in the fast tier
DEFAULT_CASES = [(name, lr) for name in ("npa", "fastformer", "nrms", "gnn")
                 for lr in (None, 0.0, 5e-3)]


@pytest.mark.parametrize("case", DEFAULT_CASES, ids=lambda c: f"{c[0]}-lr{c[1]}")
def test_family_defaults_apply_as_jax(case):
    """``apply_family_defaults`` gives JAX's config dict, with and without
    an explicit learning rate; ``cli train``'s config takes the family's
    default unless ``--lr`` is given (0.0 included)."""
    name, lr = case
    assert config.FAMILY_TRAIN_DEFAULTS == jax_config.FAMILY_TRAIN_DEFAULTS
    explicit = {"learning_rate"} if lr is not None else set()
    d = synthetic_config(**{"model.name": name}).to_dict()
    jd = jax_synthetic_config(**{"model.name": name}).to_dict()
    got = config.apply_family_defaults(copy.deepcopy(d), explicit)
    expect = jax_config.apply_family_defaults(copy.deepcopy(jd), explicit)
    assert got["train"] == {k: v for k, v in expect["train"].items() if k in got["train"]}
    argv = ["train", "--data", "synthetic", "--model", name] + (
        [] if lr is None else ["--lr", str(lr)])
    cfg = cli._build_config(cli.build_parser().parse_args(argv))
    default = config.FAMILY_TRAIN_DEFAULTS.get(name, {}).get(
        "learning_rate", synthetic_config().train.learning_rate)
    assert cfg.train.learning_rate == (default if lr is None else lr)
