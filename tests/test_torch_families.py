"""The port's ``nrms_entity``, ``tanr``, ``hierec``, ``naml``,
``nrms_bert``, ``disan``, ``lstur``, ``gnn``, ``fastformer``, ``npa`` and
``list_rank`` families against the JAX package's, on the CPU in float32,
from the Flax init weights carried over by ``models/convert.py``: the news
tower (NPA's user-independent token maps), the two-tower head (not NPA's:
its news vectors depend on the user), the direct and the dedup +
length-split forwards (the dedup form without a split for the families
that opt out of it), one training step (the GNN's through its frontier
form), the evaluation (NPA's scores every batch in full), HieRec's and
NAML's serving, and the CLI. Tolerance rtol/atol 1e-4, as
``test_torch_nrms.py`` holds NRMS. ``test_torch_bert_disan_lstur.py`` and
``test_torch_gnn_and_more.py`` hold the later families' own pieces and
their serving.

The families are parametrized as :class:`Family` objects (not as their
names), one test case each."""

import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_news_recommender_tpu.config import synthetic_config as jax_synthetic_config
from pytorch_news_recommender_tpu.data import synthetic as jax_synthetic
from pytorch_news_recommender_tpu.data.loader import train_batches as jax_train_batches
from pytorch_news_recommender_tpu.serve import Recommender as JaxRecommender
from pytorch_news_recommender_tpu.train import loop as jax_loop
from pytorch_news_recommender_tpu_torch import cli
from pytorch_news_recommender_tpu_torch.config import synthetic_config
from pytorch_news_recommender_tpu_torch.data import synthetic
from pytorch_news_recommender_tpu_torch.data.loader import train_batches
from pytorch_news_recommender_tpu_torch.models import build_model
from pytorch_news_recommender_tpu_torch.models.convert import from_flax, to_flax
from pytorch_news_recommender_tpu_torch.models.tanr import TANR
from pytorch_news_recommender_tpu_torch.serve import Recommender
from pytorch_news_recommender_tpu_torch.train.loop import (
    Trainer, softmax_ce_loss, training_loss,
)

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)
# MIND-like title lengths, so that dedup batches split into a short and a long
# block; entities as the test suite's full synthetic dataset has them
DATA = dict(seed=3, n_train=256, n_dev=48, title_len=(11.5, 4), n_entities=32,
            entity_dim=16)


@dataclasses.dataclass(frozen=True)
class Family:
    name: str

    def __str__(self):
        return f"family:{self.name}"


FAMILIES = [Family("nrms_entity"), Family("tanr"), Family("hierec"), Family("naml"),
            Family("nrms_bert"), Family("disan"), Family("lstur"), Family("gnn"),
            Family("fastformer"), Family("npa"), Family("list_rank")]
# the families whose news vectors do not depend on the user (all but NPA)
TWO_TOWER = [f for f in FAMILIES if f.name != "npa"]
# the data a family reads beside DATA: the BERT vectors of nrms_bert and
# list_rank, the users of LSTUR and NPA, the GNN's graph (4 neighbors a news)
FAMILY_DATA = {"nrms_bert": dict(bert_dim=64), "lstur": dict(n_users=50),
               "gnn": dict(n_neighbors=4), "npa": dict(n_users=50),
               "list_rank": dict(bert_dim=64)}


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(port trainer, JAX trainer, Flax init params) of family ``name``:
    the same synthetic config with dropout off, and the same data."""
    over = {"model.name": name, "model.dropout": 0.0}
    cfg, jcfg = synthetic_config(**over), jax_synthetic_config(**over)
    data = {**DATA, **FAMILY_DATA.get(name, {})}
    ds = synthetic.generate(cfg.data, **data)
    jds = jax_synthetic.generate(jcfg.data, **data)
    jtr = jax_loop.Trainer(jcfg, jds)
    params = jax.device_get(jtr.init_state(seed=0).params)
    return Trainer(cfg, ds, device="cpu"), jtr, params


@pytest.fixture(params=FAMILIES, ids=str)
def pair(request):
    return _pair(request.param.name)


@pytest.fixture(params=TWO_TOWER, ids=str)
def two_tower_pair(request):
    return _pair(request.param.name)


def _model(tr, params):
    return tr.init_state(params=from_flax(params)).model.eval()


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _dedup_batches(tr, jtr, n):
    """The first ``n`` dedup + length-split batches of both packages (no
    split for a family that encodes by id, as ``nrms_bert``)."""
    ours = list(train_batches(tr.dataset.train, 32, np.random.default_rng(2), dedup=True,
                              length_split=tr._length_split))[:n]
    theirs = list(jax_train_batches(jtr.dataset.train, 32, np.random.default_rng(2),
                                    dedup=True, length_split=jtr._length_split))[:n]
    assert (tr._length_split is None) == (jtr._length_split is None)
    assert all(("short_mark" in b) == (tr._length_split is not None) for b in ours)
    return ours, theirs


def test_flax_paths_map_by_the_plain_rule(pair):
    tr, _, params = pair
    state = from_flax(params)
    own = _model(tr, params).state_dict()
    assert sorted(own) == sorted(state)
    for k, v in state.items():
        assert tuple(own[k].shape) == tuple(v.shape), k
    back = to_flax(state)
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))


def test_encode_news_ids_matches_jax(pair):
    """The news tower by id (the GNN's recursive form); for NPA, whose
    pooling depends on the user, its user-independent token maps."""
    tr, jtr, params = pair
    ids = np.array([[0, 1, 2, 3], [7, 0, 399, 400]], np.int32)
    if tr.model_cfg.name == "npa":
        titles = tr.dataset.news.title[ids]
        expect = jax.jit(lambda p, t: jtr.model.apply(
            {"params": p}, t, method=lambda m, t: m._token_maps(t, True)))(
            params, jnp.asarray(titles))
        with torch.no_grad():
            got = _model(tr, params)._token_maps(torch.from_numpy(titles), True, None)
    else:
        expect = jax.jit(lambda p, i: jtr.model.apply(
            {"params": p}, i, jtr.news_feats, True, method="encode_news_ids"))(
            params, jnp.asarray(ids))
        with torch.no_grad():
            got = _model(tr, params).encode_news_ids(torch.from_numpy(ids), tr.news_feats)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **TOL)


def test_score_from_vecs_matches_jax(two_tower_pair):
    tr, jtr, params = two_tower_pair
    rng = np.random.default_rng(0)
    with torch.no_grad():   # the family's news width (NAML's is 2·64 + 2·16)
        width = _model(tr, params).encode_news_ids(torch.ones(1, dtype=torch.int32),
                                                   tr.news_feats).shape[-1]
    vecs = rng.normal(size=(401, width)).astype(np.float32)
    batch = {"browsed_ids": rng.integers(0, 401, size=(3, 50)).astype(np.int32),
             "candidate_ids": rng.integers(0, 401, size=(3, 8)).astype(np.int32)}
    batch["browsed_ids"][0, :45] = 0     # a short history
    batch["browsed_ids"][2] = 0          # an empty one
    batch["candidate_ids"][1, 5:] = 0    # padded candidates
    expect = jax.jit(lambda p, b, v: jtr.model.apply(
        {"params": p}, b, v, jtr.news_feats, method="score_from_vecs"))(
        params, _j(batch), jnp.asarray(vecs))
    with torch.no_grad():
        got = _model(tr, params).score_from_vecs(_t(batch), torch.from_numpy(vecs),
                                                 tr.news_feats)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **TOL)


def test_direct_forward_matches_jax(pair):
    tr, jtr, params = pair
    ds = tr.dataset
    batch = {"browsed_ids": ds.dev.browsed_ids[:4], "candidate_ids": ds.train.candidate_ids[:4]}
    expect = jax.jit(lambda p, b: jtr.model.apply({"params": p}, b, jtr.news_feats, True))(
        params, _j(batch))
    with torch.no_grad():
        got = _model(tr, params)(_t(batch), tr.news_feats)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **TOL)


def test_dedup_length_split_forward_matches_jax(pair):
    tr, jtr, params = pair
    (batch,), (jbatch,) = _dedup_batches(tr, jtr, 1)
    expect = jtr.model.apply({"params": params}, _j(jbatch), jtr.news_feats, True)
    with torch.no_grad():
        got = _model(tr, params)(_t(batch), tr.news_feats)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **TOL)


# the key projections' bias has an exact gradient of 0 (adding one vector to
# every key shifts each row of scores by a constant, which the softmax
# ignores); in float32 it is rounding noise below this, which Adam's first
# step turns into an update of up to ±lr whose sign is the noise's
NOISE_GRAD = 1e-7


def _key_bias(name, p):
    """The entries of parameter ``name`` whose exact gradient is 0: a key
    projection's bias (the middle third of a ``bqkv``, fused q|k|v), and
    the bias of DiSAN's Source2Token logits (``source2token.fc2.bias``: it
    adds one value per dimension to every token's logit, which the softmax
    over the tokens ignores, as for the key bias), and list_rank's scoring
    biases: ``fc.bias`` and the bias of the last block's output LayerNorm
    (``block0`` at the test config's one block) add one value to every
    candidate's score, which the softmax cross-entropy ignores."""
    out = torch.zeros_like(p, dtype=torch.bool)
    if name.endswith("bqkv"):
        n = p.shape[0] // 3
        out[n:2 * n] = True
    if name.endswith("source2token.fc2.bias") or name in ("fc.bias", "block0.ffn.norm.bias"):
        out[:] = True
    return out


def _jax_grads(jtr, params, jbatch):
    """The gradient at ``params`` of the loss the JAX step differentiates
    (``Trainer.train_step_fn``): the click cross-entropy plus the losses the
    model sowed."""
    def loss_fn(p):
        scores, mut = jtr.model.apply({"params": p}, jbatch, jtr.news_feats,
                                      deterministic=False,
                                      rngs={"dropout": jax.random.PRNGKey(0)},
                                      mutable=["losses"])
        aux = jax.tree_util.tree_leaves(mut.get("losses", {}))
        return jax_loop.softmax_ce_loss(scores) + sum(jnp.mean(a) for a in aux)
    return jax.device_get(jax.jit(jax.grad(loss_fn))(params))


def test_run_step_matches_jax(pair):
    """One step on a dedup + length-split batch, dropout 0 but not
    deterministic (TANR records its topic loss only in training): the loss
    and every gradient entry within 1e-4 of JAX's, the entries with an exact
    gradient of 0 (``_key_bias``) below ``NOISE_GRAD`` in both packages;
    every parameter after the update within 1e-4 of optax's update (the JAX
    step's optimizer) of the port's own gradients; and every parameter
    within 1e-4 of the JAX step's, but the zero-gradient entries and those
    whose gradient float32 does not determine (below ``NOISE_GRAD`` in both
    packages and apart by more than a tenth): Adam's first step maps such a
    gradient to an update of up to ±lr that its rounding decides."""
    tr, jtr, params = pair
    (batch,), (jbatch,) = _dedup_batches(tr, jtr, 1)
    model = tr.init_state(params=from_flax(params)).model
    training_loss(model, model(_t(batch), tr.news_feats, deterministic=False,
                               generator=torch.Generator().manual_seed(0))).backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    jgrads = from_flax(_jax_grads(jtr, params, _j(jbatch)))
    assert sorted(grads) == sorted(jgrads)
    undetermined = {}
    for k, g in jgrads.items():
        assert grads[k] is not None, k
        np.testing.assert_allclose(grads[k].numpy(), g.numpy(), err_msg=k, **TOL)
        key = _key_bias(k, g)
        for gg in (grads[k], g):
            assert bool(torch.all(gg[key].abs() < NOISE_GRAD)), k
        tiny = (grads[k].abs() < NOISE_GRAD) & (g.abs() < NOISE_GRAD)
        undetermined[k] = tiny & ((grads[k] - g).abs() > 0.1 * g.abs())
    # the optimizer alone: optax from the JAX step's initial state on the
    # port's gradients (before the JAX step, which donates that state)
    jinit = jtr.init_state(seed=0)
    updates, _ = jtr._tx.update(to_flax(grads), jinit.opt_state, jinit.params)
    same_grads = from_flax(jax.device_get(optax.apply_updates(jinit.params, updates)))
    state, m = tr.run_step(tr.init_state(params=from_flax(params)), batch)
    jstate, jm = jtr.run_step(jtr.init_state(seed=0), jbatch, jax.random.PRNGKey(0))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), **TOL)
    got = state.params
    assert sorted(got) == sorted(same_grads)
    for k, v in same_grads.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), err_msg=k, **TOL)
    expect = from_flax(jax.device_get(jstate.params))
    assert sorted(got) == sorted(expect)
    for k, v in expect.items():
        held = ~(_key_bias(k, v) | undetermined[k])
        np.testing.assert_allclose(got[k][held].numpy(), v[held].numpy(), err_msg=k, **TOL)


def test_evaluate_matches_jax(pair):
    tr, jtr, params = pair
    got = tr.evaluate(from_flax(params))
    expect = jtr.evaluate(params)
    assert got.keys() == expect.keys()
    for k in expect:
        np.testing.assert_allclose(got[k], expect[k], rtol=1e-5, atol=1e-5, err_msg=k)


def test_tanr_loss_counts_the_last_encode_only():
    """In a length-split step the JAX package keeps the topic loss of the
    last encode call (``sow`` with ``reduce_fn=lambda a, b: b``): the long
    block's news alone. The port keeps the same loss."""
    tr, jtr, params = _pair("tanr")
    (batch,), _ = _dedup_batches(tr, jtr, 1)
    model = tr.init_state(params=from_flax(params)).model
    scores = model(_t(batch), tr.news_feats, deterministic=False,
                   generator=torch.Generator().manual_seed(0))
    ws = batch["short_mark"].shape[0]
    long_ids = torch.from_numpy(batch["unique_ids"][ws:]).long()
    with torch.no_grad():
        vec = model.encode_news_ids(long_ids, tr.news_feats)
        logp = torch.log_softmax(model.topic_head(vec).float(), dim=-1)
        categ = tr.news_feats["categ"][long_ids].long()
        real = categ != 0
        ce = -logp[real].gather(-1, categ[real][:, None]).mean()
    assert list(model.aux_losses) == ["topic_ce"]
    topic = model.aux_losses["topic_ce"].detach()
    np.testing.assert_allclose(float(topic), tr.cfg.model.topic_loss_weight * float(ce),
                               rtol=1e-5)
    np.testing.assert_allclose(float(training_loss(model, scores).detach()),
                               float(softmax_ce_loss(scores).detach() + topic), rtol=1e-6)
    # a forward starts with no recorded loss; a deterministic one records none
    with torch.no_grad():
        model(_t(batch), tr.news_feats)
    assert model.aux_losses == {} and TANR.HAS_AUX_LOSS


def test_seeded_init_draws_flax_distributions():
    """Full widths: Dense lecun-normal (truncated at 2 standard deviations),
    the entity table N(0, 1) on every row, AdditiveAttention's query stored
    U(0, 0.2), HieRec's gate zeros; the same seed gives the same weights."""
    cfg = synthetic_config(**{"model.word_embed_size": 300, "model.num_attention_heads": 10,
                              "model.query_vector_dim": 200, "model.entity_embed_size": 100})
    meta = synthetic.generate(cfg.data, seed=0, n_train=8, n_dev=0, n_entities=2000,
                              n_categories=18).meta
    models = {}
    for name in ("nrms_entity", "tanr", "hierec"):
        mcfg = dataclasses.replace(cfg.model, name=name).with_artifact_meta(meta)
        models[name] = build_model(mcfg)
        models[name].reset_parameters(torch.Generator().manual_seed(0))
        again = build_model(mcfg)
        again.reset_parameters(torch.Generator().manual_seed(0))
        for k, v in models[name].state_dict().items():
            assert torch.equal(v, again.state_dict()[k]), (name, k)
    ne = models["nrms_entity"]
    std = np.sqrt(1 / 400) / 0.87962566103423978
    k = ne.fuse.kernel.detach()
    assert k.shape == (400, 300) and float(k.abs().max()) <= 2 * std
    assert abs(float(k.std()) - np.sqrt(1 / 400)) < 0.05 * np.sqrt(1 / 400)
    assert torch.all(ne.fuse.bias == 0)
    emb = ne.entity_embedding.embedding.detach()
    assert emb.shape == (2001, 100) and float(emb[0].abs().max()) > 0
    assert abs(float(emb.std()) - 1) < 0.02
    q = ne.entity_attention.query.detach()
    assert float(q.min()) >= 0 and float(q.max()) <= 0.2 and float(q.max()) > 0.18
    limit = np.sqrt(6 / (100 + 200))
    w = ne.entity_attention.w.detach()
    assert float(w.abs().max()) <= limit and torch.all(ne.entity_attention.b == 0)
    assert models["tanr"].topic_head.kernel.shape == (300, 18)
    assert torch.all(models["hierec"].level_logits == 0)


def test_entity_pad_row_gets_no_gradient():
    tr, jtr, params = _pair("nrms_entity")
    (batch,), _ = _dedup_batches(tr, jtr, 1)
    model = tr.init_state(params=from_flax(params)).model
    softmax_ce_loss(model(_t(batch), tr.news_feats, deterministic=False,
                          generator=torch.Generator().manual_seed(0))).backward()
    g = model.entity_embedding.embedding.grad
    assert torch.all(g[0] == 0) and float(g[1:].abs().max()) > 0


def test_pretrained_entity_vectors_load_into_the_entity_table():
    tr, _, _ = _pair("nrms_entity")
    table = tr.init_state(seed=1).params["entity_embedding.embedding"]
    np.testing.assert_array_equal(table.numpy(), tr.dataset.entity_embeddings)


def test_nrms_entity_needs_entity_features():
    cfg = synthetic_config(**{"model.name": "nrms_entity"})
    ds = synthetic.generate(cfg.data, seed=0, n_train=8, n_dev=0)
    with pytest.raises(ValueError, match="no entity features"):
        Trainer(cfg, ds, device="cpu")
    # the CLI's synthetic data carries no entities, in both packages
    with pytest.raises(ValueError, match="no entity features"):
        cli.main(["train", "--data", "synthetic", "--model", "nrms_entity",
                  "--device", "cpu", "--epochs", "1"])
    jcfg = jax_synthetic_config(**{"model.name": "nrms_entity"})
    jds = jax_synthetic.generate(jcfg.data, seed=0, n_train=8, n_dev=0)
    with pytest.raises(ValueError, match="entity"):
        jax_loop.Trainer(jcfg, jds)


@pytest.fixture(scope="module")
def hierec_served():
    """(JAX recommender, port recommender) of HieRec at the Flax init
    weights, with a gate that weighs the three levels unequally."""
    tr, jtr, params = _pair("hierec")
    params = jax.tree_util.tree_map(np.asarray, params)
    params["level_logits"] = np.array([0.3, -0.2, 0.1], np.float32)
    jrec = JaxRecommender(jtr.cfg, jtr.dataset, params)
    rec = Recommender(tr.cfg, tr.dataset, from_flax(params), device="cpu")
    return jrec, rec, tr.dataset


def _requests(ds):
    reqs = []
    for i in range(6):
        hist = [int(h) for h in ds.dev.browsed_ids[i] if h]
        cands, _ = ds.dev.impression(i)
        reqs.append((hist, [int(c) for c in cands], i))
    reqs.append(([], [1, 2, 3], 0))            # an empty history
    return reqs


def test_hierec_recommender_score_matches_jax(hierec_served):
    """``Recommender.score`` and ``score_many`` hand the feature tables to
    HieRec's head, which gathers the candidates' categories by id."""
    jrec, rec, ds = hierec_served
    reqs = _requests(ds)
    for hist, cands, _ in reqs:
        np.testing.assert_allclose(rec.score(hist, cands), jrec.score(hist, cands), **TOL)
    for got, (hist, cands, _) in zip(rec.score_many(reqs), reqs):
        np.testing.assert_allclose(got, jrec.score(hist, cands), **TOL)


def test_hierec_top_k_ranks_by_the_global_level(hierec_served):
    jrec, rec, ds = hierec_served
    hist = [int(h) for h in ds.dev.browsed_ids[0] if h]
    ids, scores = rec.top_k(hist, 10)
    jids, jscores = jrec.top_k(hist, 10)
    np.testing.assert_array_equal(ids, np.asarray(jids))
    np.testing.assert_allclose(scores, np.asarray(jscores), **TOL)


# each family's class, by name
FAMILY_CLASS = {"tanr": "TANR", "hierec": "HieRec", "naml": "NAML", "nrms_bert": "NRMSBert",
                "disan": "DiSANRec", "lstur": "LSTUR", "gnn": "GNNRec",
                "fastformer": "Fastformer", "list_rank": "ListRank"}


@pytest.mark.parametrize("fam", [Family(n) for n in FAMILY_CLASS], ids=str)
def test_cli_trains_evaluates_and_serves_the_family(fam, tmp_path):
    """``--model`` flows through ``cli train`` / ``eval`` / ``export-vectors``
    and ``serve``'s recommender and daemon on the CPU (the CLI's synthetic
    data carries BERT vectors, users and a graph). NPA, which cannot serve,
    is in ``test_torch_gnn_and_more.py``."""
    data = ["--data", "synthetic", "--model", fam.name, "--device", "cpu"]
    assert cli.main(["train", *data, "--epochs", "1", "--batch-size", "64",
                     "--save-dir", str(tmp_path)]) == 0
    ckpt = str(tmp_path / fam.name)
    assert cli.main(["eval", *data, "--ckpt", ckpt]) == 0
    out = tmp_path / "vecs.npz"
    assert cli.main(["export-vectors", *data, "--ckpt", ckpt, "--out", str(out)]) == 0
    args = cli.build_parser().parse_args(["serve", *data, "--ckpt", ckpt, "--port", "0"])
    srv = cli.build_server(args)
    assert srv.rec.cfg.model.name == fam.name
    assert type(srv.rec.model).__name__ == FAMILY_CLASS[fam.name]
    s = srv.rec.score([1, 2, 3], [4, 5, 6], user_id=7)
    assert s.shape == (3,) and np.all(np.isfinite(s))
    srv.start(block=False)   # the warm-up runs each path the family serves
    srv.stop()


def _with_dicts(ds):
    """A copy of ``ds`` with serving dictionaries: digit-free word tokens
    for every word id, and one category and subcategory name."""
    def name(i):
        out = ""
        while i:
            i, r = divmod(i, 26)
            out += chr(97 + r)
        return "w" + out
    ds = copy.copy(ds)
    ds.dicts = {"word": {name(i): i for i in range(1, ds.meta.n_words)},
                "category": {"sports": 3}, "subcategory": {"golf": 5}}
    return ds


@pytest.fixture(scope="module")
def naml_served():
    """(JAX recommender, port recommender) of NAML at the Flax init weights,
    with serving dictionaries, so that fresh news carries an abstract and a
    category."""
    tr, jtr, params = _pair("naml")
    params = jax.tree_util.tree_map(np.asarray, params)
    # the same corpus without entities: a fresh news item's entity row is
    # data.entity_nums wide, the test corpus's entity table 4 (NAML reads none)
    data = {**DATA, "n_entities": 0, "entity_dim": 0}
    ds = _with_dicts(synthetic.generate(tr.cfg.data, **data))
    jds = _with_dicts(jax_synthetic.generate(jtr.cfg.data, **data))
    jrec = JaxRecommender(jtr.cfg, jds, params)
    rec = Recommender(tr.cfg, ds, from_flax(params), device="cpu")
    return jrec, rec, ds


def test_naml_recommender_score_and_add_news_match_jax(naml_served):
    """``score`` and ``score_many`` run the user tower over the normed
    cached vectors; ``add_news`` encodes a fresh title, abstract, category
    and subcategory through the news tower; every score within 1e-4 of the
    JAX recommender's."""
    jrec, rec, ds = naml_served
    reqs = _requests(ds)
    for hist, cands, _ in reqs:
        np.testing.assert_allclose(rec.score(hist, cands), jrec.score(hist, cands), **TOL)
    for got, (hist, cands, _) in zip(rec.score_many(reqs), reqs):
        np.testing.assert_allclose(got, jrec.score(hist, cands), **TOL)
    words = list(rec.dicts["word"])
    fresh = dict(title=" ".join(words[10:14]), abstract=" ".join(words[100:107]),
                 category="sports", subcategory="golf")
    rows = rec.tokenize_new_news(**fresh)
    assert int(rows["categ"]) == 3 and int(rows["subcateg"]) == 5
    assert int((rows["abst"] != 0).sum()) == 7
    nid = rec.add_news(**fresh)
    assert nid == jrec.add_news(**fresh) == ds.news.n_news   # the table holds the pad row 0
    np.testing.assert_allclose(rec.encode_new_news(**fresh), jrec.encode_new_news(**fresh),
                               **TOL)
    hist, cands = [nid, 1, 2], [nid, 3, 4]
    np.testing.assert_allclose(rec.score(hist, cands), jrec.score(hist, cands), **TOL)


def test_naml_top_k_matches_jax(naml_served):
    """``top_k`` ranks the corpus with the user tower over the cached
    vectors as they are, without ``norm``, as the JAX recommender does
    (ROADMAP C): the same ids, and scores within 1e-4. The normed user
    vector ranks otherwise."""
    jrec, rec, ds = naml_served
    for i in range(3):
        hist = [int(h) for h in ds.dev.browsed_ids[i] if h]
        ids, scores = rec.top_k(hist, 10)
        jids, jscores = jrec.top_k(hist, 10)
        np.testing.assert_array_equal(ids, np.asarray(jids))
        np.testing.assert_allclose(scores, np.asarray(jscores), **TOL)
    b = torch.as_tensor(rec._pad_history(hist)[None])
    with torch.no_grad():
        vecs = rec._lookup(b)
        normed = rec.model.user_encoder(rec.model.norm(vecs), (b != 0).float())
    normed_scores = (normed.float() @ rec.news_vecs.float().T)[0, torch.as_tensor(ids)]
    assert float((normed_scores - torch.as_tensor(scores)).abs().max()) > 1e-3


def test_layer_norm_matches_flax():
    """The port's ``LayerNorm`` against ``flax.linen.LayerNorm(dtype=...)``
    on seeded rows, with a scale and bias other than their init. Rows 1 have
    a mean of 128 on a grid of 1/2, where every partial sum of x and x² is
    exact in float32 whatever the order, and where the fast variance
    ``E[x²] − E[x]²`` that Flax takes differs from the two-pass variance
    (``torch.nn.functional.layer_norm``) by more than 1e-3 in the output.
    Tolerance: 1e-5 in float32 (float32 rounding of the same operations);
    one bf16 step, 2^-7 relative, in bfloat16."""
    import flax.linen as fnn

    from pytorch_news_recommender_tpu_torch.models.layers import LayerNorm

    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 6, 160)).astype(np.float32)
    x[1] = 128.0 + rng.integers(-2, 3, size=(6, 160)) / 2
    scale = rng.normal(size=160).astype(np.float32)
    bias = rng.normal(size=160).astype(np.float32)
    flax_params = {"params": {"scale": scale, "bias": bias}}
    for jdt, tdt, tol in ((jnp.float32, torch.float32, 1e-5),
                          (jnp.bfloat16, torch.bfloat16, 2 ** -7)):
        xj = jnp.asarray(x).astype(jdt)
        expect = np.asarray(fnn.LayerNorm(dtype=jdt).apply(flax_params, xj).astype(jnp.float32))
        norm = LayerNorm(160, tdt)
        with torch.no_grad():
            norm.scale.copy_(torch.from_numpy(scale))
            norm.bias.copy_(torch.from_numpy(bias))
            got = norm(torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt))
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(), expect, rtol=tol, atol=tol)
        if tdt == torch.float32:
            two_pass = torch.nn.functional.layer_norm(
                torch.from_numpy(x), (160,), torch.from_numpy(scale), torch.from_numpy(bias),
                eps=1e-6).numpy()
            assert np.abs(two_pass[1] - expect[1]).max() > 1e-3
            np.testing.assert_allclose(two_pass[[0, 2, 3]], expect[[0, 2, 3]], atol=1e-5)
