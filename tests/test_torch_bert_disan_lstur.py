"""The ``nrms_bert``, ``disan`` and ``lstur`` families' own pieces against
the JAX package's on the CPU (float32, tolerance 1e-4 unless a test says
otherwise), and the serving repairs that LSTUR needs: user ids through
``score`` and ``score_many``, ``top_k``'s refusal, and the fresh-news checks.
The families' shared checks (paths, encode, forwards, a training step,
evaluation, the CLI) are in ``test_torch_families.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_news_recommender_tpu.config import synthetic_config as jax_synthetic_config
from pytorch_news_recommender_tpu.data import synthetic as jax_synthetic
from pytorch_news_recommender_tpu.models import disan as jax_disan
from pytorch_news_recommender_tpu.models import lstur as jax_lstur
from pytorch_news_recommender_tpu.serve import Recommender as JaxRecommender
from pytorch_news_recommender_tpu.train import loop as jax_loop
from pytorch_news_recommender_tpu_torch.config import synthetic_config
from pytorch_news_recommender_tpu_torch.data import synthetic
from pytorch_news_recommender_tpu_torch.models import build_model
from pytorch_news_recommender_tpu_torch.models.convert import assign, from_flax
from pytorch_news_recommender_tpu_torch.models.disan import DiSA, Source2Token
from pytorch_news_recommender_tpu_torch.models.lstur import MaskedGRU
from pytorch_news_recommender_tpu_torch.serve import Recommender
from pytorch_news_recommender_tpu_torch.train.loop import Trainer
from test_torch_families import DATA, _pair, _with_dicts

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)


def _flax(module, *args):
    """Flax init params (numpy) of ``module`` at ``args``, and its output."""
    params = jax.device_get(module.init(jax.random.PRNGKey(0), *args)["params"])
    return params, np.asarray(module.apply({"params": params}, *args))


def _load(module, params):
    assign(module, from_flax(params))
    return module.eval()


def _tokens(rng, B, L, D):
    lens = rng.integers(0, L + 1, size=B)
    lens[0], lens[1] = L, 0          # a full row and an all-pad one
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.float32)
    x = (rng.normal(size=(B, L, D)) * mask[..., None]).astype(np.float32)
    return x, mask


@pytest.mark.parametrize("direction", ["fw", "bw"])
def test_disa_matches_flax(direction):
    """One directional pass: the tanh logits per dimension with the f32
    ``b1`` and ``bf`` (given nonzero values), the strict directional pair
    mask, the softmax over j, the fusion gate; pad tokens zero."""
    rng = np.random.default_rng(1)
    x, mask = _tokens(rng, 4, 9, 16)
    params, expect = _flax(jax_disan.DiSA(12, direction, 0.0, "float32"),
                           jnp.asarray(x), jnp.asarray(mask))
    params = jax.tree_util.tree_map(np.asarray, params)
    params["b1"] = rng.normal(size=12).astype(np.float32) * 0.5
    params["bf"] = rng.normal(size=12).astype(np.float32) * 0.5
    expect = np.asarray(jax_disan.DiSA(12, direction, 0.0, "float32").apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(mask)))
    ours = _load(DiSA(16, 12, direction, 0.0, torch.float32), params)
    with torch.no_grad():
        got = ours(torch.from_numpy(x), torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), expect, **TOL)
    assert np.all(got.numpy()[1] == 0)


def test_source2token_matches_flax():
    rng = np.random.default_rng(2)
    x, mask = _tokens(rng, 5, 7, 24)
    params, expect = _flax(jax_disan.Source2Token(0.0, "float32"), jnp.asarray(x),
                           jnp.asarray(mask))
    ours = _load(Source2Token(24, 0.0, torch.float32), params)
    with torch.no_grad():
        got = ours(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), expect, **TOL)


def test_masked_gru_matches_flax_gru_cell_under_scan():
    """The JAX ``MaskedGRU`` is ``flax.linen.GRUCell`` under ``nn.scan``
    (path ``cell/{ir,iz,in,hr,hz,hn}``); the carry starts at a given state
    and advances only on real steps (left-padded histories, an empty one)."""
    rng = np.random.default_rng(3)
    B, T, D, Hd = 4, 11, 10, 8
    lens = np.array([T, 0, 5, 1])
    mask = (np.arange(T)[None] >= T - lens[:, None]).astype(np.float32)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    h0 = rng.normal(size=(B, Hd)).astype(np.float32)
    args = (jnp.asarray(x), jnp.asarray(mask), jnp.asarray(h0))
    params, expect = _flax(jax_lstur.MaskedGRU(Hd, "float32"), *args)
    assert sorted(params["cell"]) == ["hn", "hr", "hz", "in", "ir", "iz"]
    ours = _load(MaskedGRU(D, Hd, torch.float32), params)
    with torch.no_grad():
        got = ours(*(torch.from_numpy(a) for a in (x, mask, h0)))
    np.testing.assert_allclose(got.numpy(), expect, **TOL)
    np.testing.assert_array_equal(got.numpy()[1], h0[1])   # no real step


# ---- nrms_bert ----------------------------------------------------------------

def test_nrms_bert_table_starts_as_the_bert_vectors_and_frozen_holds_none():
    """Trainable: the table equals ``news_feats["bert"]`` bit for bit after
    init (Flax's init copies it), and trains. Frozen: no table parameter,
    the tower reads the feature, and no gradient reaches it."""
    tr, _, _ = _pair("nrms_bert")
    state = tr.init_state(seed=4)
    table = state.params["bert_embedding.embedding"]
    assert torch.equal(table, torch.from_numpy(tr.dataset.news.bert))
    cfg = synthetic_config(**{"model.name": "nrms_bert", "model.bert_trainable": False,
                              "model.dropout": 0.0})
    frozen = Trainer(cfg, tr.dataset, device="cpu")
    model = frozen.init_state(seed=4).model
    assert not any("bert_embedding" in n for n, _ in model.named_parameters())
    ids = torch.tensor([[3, 0, 7]])
    feats = dict(frozen.news_feats)
    feats["bert"] = feats["bert"].clone().requires_grad_(True)
    model.encode_news_ids(ids, feats).sum().backward()
    assert feats["bert"].grad is not None   # the feature itself, not a parameter
    with torch.no_grad():
        np.testing.assert_allclose(
            model.encode_news_ids(ids, frozen.news_feats).numpy(),
            model.encode_news_feats({"bert": frozen.news_feats["bert"][ids]}).numpy(),
            rtol=0, atol=0)


def test_nrms_bert_at_the_default_config_raises_in_both_packages():
    """``bert_embed_size=512`` with ``user_heads_num=10`` (the JAX
    ``config.py`` defaults): 512 is not a multiple of 10. The port refuses
    it when it builds the user tower; JAX fails at its reshape (ROADMAP C)."""
    over = {"model.name": "nrms_bert", "model.bert_embed_size": 512,
            "model.user_heads_num": 10}
    cfg = synthetic_config(**over)
    ds = synthetic.generate(cfg.data, seed=0, n_train=8, n_dev=0, bert_dim=32)
    with pytest.raises(ValueError, match="not divisible by 10 heads"):
        Trainer(cfg, ds, device="cpu")
    jcfg = jax_synthetic_config(**over)
    jds = jax_synthetic.generate(jcfg.data, seed=0, n_train=8, n_dev=0, bert_dim=32)
    with pytest.raises(TypeError, match="reshape"):
        jax_loop.Trainer(jcfg, jds).init_state(seed=0)


@pytest.fixture(scope="module")
def bert_served():
    tr, jtr, params = _pair("nrms_bert")
    data = {**DATA, "bert_dim": 64, "n_entities": 0, "entity_dim": 0}
    ds = _with_dicts(synthetic.generate(tr.cfg.data, **data))
    jds = _with_dicts(jax_synthetic.generate(jtr.cfg.data, **data))
    return (JaxRecommender(jtr.cfg, jds, params),
            Recommender(tr.cfg, ds, from_flax(params), device="cpu"), ds)


def test_nrms_bert_serves_as_jax_and_refuses_fresh_news(bert_served):
    """``score`` and ``top_k`` match the JAX recommender; ``add_news`` and
    ``encode_new_news`` raise, as in JAX: fresh news needs an external
    vector."""
    jrec, rec, ds = bert_served
    hist = [int(h) for h in ds.dev.browsed_ids[0] if h]
    np.testing.assert_allclose(rec.score(hist, [1, 2, 3]), jrec.score(hist, [1, 2, 3]), **TOL)
    ids, scores = rec.top_k(hist, 5)
    jids, jscores = jrec.top_k(hist, 5)
    np.testing.assert_array_equal(ids, np.asarray(jids))
    np.testing.assert_allclose(scores, np.asarray(jscores), **TOL)
    n = rec.n_news
    for r in (rec, jrec):
        with pytest.raises(ValueError, match="external vector"):
            r.add_news("a fresh title")
        with pytest.raises(ValueError, match="external vector"):
            r.encode_new_news("a fresh title")
    assert rec.n_news == n


# ---- lstur ----------------------------------------------------------------

@pytest.fixture(scope="module")
def lstur_served():
    """(JAX recommender, port recommender, data) of LSTUR at its Flax init
    weights, on the test corpus with 50 users."""
    tr, jtr, params = _pair("lstur")
    return (JaxRecommender(jtr.cfg, jtr.dataset, params),
            Recommender(tr.cfg, tr.dataset, from_flax(params), device="cpu"), tr.dataset)


def test_lstur_score_and_score_many_carry_user_ids_as_jax(lstur_served):
    """``score(..., user_id)`` and ``score_many`` with distinct user ids
    match the JAX recommender; one request scores otherwise as another
    user, and user 0 (unknown) gets the zero long-term vector."""
    jrec, rec, ds = lstur_served
    reqs = []
    for i in range(6):
        hist = [int(h) for h in ds.dev.browsed_ids[i] if h]
        cands, _ = ds.dev.impression(i)
        reqs.append((hist, [int(c) for c in cands], 1 + 7 * i))
    reqs.append(([], [1, 2, 3], 0))
    for hist, cands, uid in reqs:
        np.testing.assert_allclose(rec.score(hist, cands, user_id=uid),
                                   jrec.score(hist, cands, user_id=uid), **TOL)
    for got, (hist, cands, uid) in zip(rec.score_many(reqs), reqs):
        np.testing.assert_allclose(got, jrec.score(hist, cands, user_id=uid), **TOL)
    # a short history keeps the GRU near its initial state, the user's vector
    hist, cands = reqs[0][0][-2:], reqs[0][1]
    assert np.abs(rec.score(hist, cands, user_id=3) - rec.score(hist, cands, user_id=4)).max() \
        > 1e-2


def test_lstur_top_k_raises_a_value_error(lstur_served):
    """LSTUR has no user tower over the cached vectors alone: the port
    refuses ``top_k`` naming the family; the JAX package fails there with an
    ``AttributeError`` (ROADMAP C), so its server cannot start for LSTUR."""
    jrec, rec, ds = lstur_served
    with pytest.raises(ValueError, match="'lstur'"):
        rec.top_k([1, 2, 3], 5)
    assert not rec.ranks_corpus
    with pytest.raises(AttributeError, match="user_encoder"):
        jrec.top_k([1, 2, 3], 5)


@pytest.mark.parametrize("method", ["ini", "con"])
def test_lstur_variants_and_unknown_user_match_jax(method):
    """Both long- and short-term methods against the JAX family on a batch
    with user ids, on the same batch with every user 0 and without
    ``user_ids``; user 0 and a batch without ids give the zero long-term
    vector ('con': the half of the user vector that is the embedding)."""
    over = {"model.name": "lstur", "model.dropout": 0.0,
            "model.long_short_term_method": method}
    cfg, jcfg = synthetic_config(**over), jax_synthetic_config(**over)
    data = {**DATA, "n_users": 50}
    tr = Trainer(cfg, synthetic.generate(cfg.data, **data), device="cpu")
    jtr = jax_loop.Trainer(jcfg, jax_synthetic.generate(jcfg.data, **data))
    params = jax.device_get(jtr.init_state(seed=0).params)
    model = tr.init_state(params=from_flax(params)).model.eval()
    ds = tr.dataset
    base = {"browsed_ids": ds.train.browsed_ids[:6], "candidate_ids": ds.train.candidate_ids[:6]}
    batches = [dict(base, user_ids=ds.train.user_ids[:6]),
               dict(base, user_ids=np.zeros(6, np.int32)), base]
    outs = []
    for b in batches:
        expect = jtr.model.apply({"params": params}, {k: jnp.asarray(v) for k, v in b.items()},
                                 jtr.news_feats, True)
        with torch.no_grad():
            got = model({k: torch.from_numpy(np.asarray(v)) for k, v in b.items()},
                        tr.news_feats)
        np.testing.assert_allclose(got.numpy(), np.asarray(expect), **TOL)
        outs.append(got)
    assert torch.equal(outs[1], outs[2])
    assert float((outs[0] - outs[1]).abs().max()) > 1e-3
    with torch.no_grad():
        long_term = model.user_embedding(torch.zeros(3, dtype=torch.int32))
    assert torch.all(long_term == 0)
    news_dim = cfg.model.num_filters + 2 * cfg.model.cate_embed_size
    # 'ini': GRU and embedding at the news dim; 'con': they split it
    half = news_dim // 2
    assert (model.gru_dim, model.user_embedding.embedding.shape) == (
        (news_dim, (51, news_dim)) if method == "ini" else (half, (51, news_dim - half)))


def test_lstur_without_users_holds_no_user_table():
    """Data without users: no user table (the JAX family makes it only when
    its init batch has ``user_ids``), the same parameter tree as JAX's, and
    every user scores with the zero long-term vector."""
    over = {"model.name": "lstur", "model.dropout": 0.0}
    cfg, jcfg = synthetic_config(**over), jax_synthetic_config(**over)
    tr = Trainer(cfg, synthetic.generate(cfg.data, seed=0, n_train=32, n_dev=0), device="cpu")
    jtr = jax_loop.Trainer(jcfg, jax_synthetic.generate(jcfg.data, seed=0, n_train=32, n_dev=0))
    params = jax.device_get(jtr.init_state(seed=0).params)
    model = tr.init_state(params=from_flax(params)).model.eval()
    assert model.user_embedding is None and "user_embedding" not in params
    b = {"browsed_ids": torch.from_numpy(tr.dataset.train.browsed_ids[:2]),
         "candidate_ids": torch.from_numpy(tr.dataset.train.candidate_ids[:2])}
    with torch.no_grad():
        assert torch.equal(model(dict(b, user_ids=torch.tensor([5, 9])), tr.news_feats),
                           model(b, tr.news_feats))


# ---- the serving repairs, family by family ---------------------------------

def _nrms_recommender():
    cfg = synthetic_config()
    ds = _with_dicts(synthetic.generate(cfg.data, seed=0, n_train=8, n_dev=0))
    model = build_model(cfg.model.with_artifact_meta(ds.meta))
    model.reset_parameters(torch.Generator().manual_seed(0))
    return Recommender(cfg, ds, model.state_dict(), device="cpu"), ds


def test_score_and_score_many_hand_the_user_ids_to_the_head(monkeypatch):
    """Whatever the family, the scoring batch carries the requests' user
    ids (int32, on the recommender's device), as the JAX recommender's."""
    rec, _ = _nrms_recommender()
    seen = []
    head = rec.model.score_impression

    def spy(batch, *args, **kw):
        seen.append(batch["user_ids"].clone())
        return head(batch, *args, **kw)
    monkeypatch.setattr(rec.model, "score_impression", spy)
    rec.score([1, 2], [3, 4], user_id=17)
    rec.score_many([([1], [2, 3], 5), ([4], [5], 0), ([6, 7], [8], 9)])
    assert seen[0].dtype == torch.int32 and seen[0].tolist() == [17]
    assert seen[1].tolist()[:3] == [5, 0, 9] and len(seen[1]) == Recommender.BATCH_PAD


def test_fresh_news_needs_features_that_tokenization_builds():
    """A family whose news tower reads a feature that tokenization cannot
    build refuses a fresh item, as the JAX recommender does, and the corpus
    is left as it was."""
    rec, _ = _nrms_recommender()
    rec.model.FEAT_KEYS = ("title", "neighbors")
    n = rec.n_news
    with pytest.raises(ValueError, match=r"cannot build features \['neighbors'\]"):
        rec.add_news("wab wac")
    with pytest.raises(ValueError, match=r"cannot build features \['neighbors'\]"):
        rec.encode_new_news("wab wac")
    assert rec.n_news == n
