"""The corpus's news graph and the training driver's feed: a corpus without
``graph`` is the one it was before the graph came; a corpus with one draws
a table that keeps its rules and its law; the table reaches the program and
the reference; and the driver's feed builds the GNN frontier as ``fit``'s
does, in the prefetch thread."""

import copy
import hashlib
import json
import time

import numpy as np
import pytest

from h100bench import port, traffic as T
from h100bench.tests.conftest import ROOT

# the corpus's tables and popularity law, hashed as at the commit before
# the graph came (seeds 1 and 3,000,000,011)
PINNED = {("nrms-mind", 1): "515fb61ebb08d721", ("nrms-mind", 3_000_000_011): "b994f91c1932394e",
          ("naml-mind", 1): "0b6229ee634ceefa", ("naml-mind", 3_000_000_011): "edd5bb3fed5f8a8e",
          ("disan-mind", 1): "515fb61ebb08d721",
          ("disan-mind", 3_000_000_011): "b994f91c1932394e"}

CORPUS = {"n_news": 3000, "vocab": 300, "title_width": 20,
          "title_len": {"law": "normal", "mean": 11.5, "std": 4.0, "lo": 1, "hi": 20},
          "n_categories": 6, "n_subcategories": 40, "category_zipf": 1.0,
          "word_zipf": 1.0, "news_zipf": 0.88}


def _digest(c: T.Corpus) -> str:
    h = hashlib.sha256()
    for a in (c.title, c.abst, c.categ, c.subcateg, c.popularity.cdf, c.popularity.ids):
        if a is not None:
            a = np.ascontiguousarray(a)
            h.update(str((a.dtype.str, a.shape)).encode())
            h.update(a.tobytes())
    return h.hexdigest()[:16]


def _config(name: str) -> dict:
    return json.loads((ROOT / "configs" / f"{name}.json").read_text())


def _graph_corpus(seed: int, **graph) -> T.Corpus:
    g = {"neighbors": 8, "group": "subcateg", "sharpness": 1.0, **graph}
    return T.make_corpus({"corpus": {**CORPUS, "graph": g}}, seed)


def _closure(neighbors: np.ndarray, ids: np.ndarray, depth: int = 2) -> np.ndarray:
    cur = reach = np.unique(ids)
    for _ in range(depth):
        cur = np.unique(neighbors[cur])
        reach = np.union1d(reach, cur)
    return reach[reach != 0]


@pytest.mark.parametrize("name,seed", sorted(PINNED))
def test_a_corpus_without_a_graph_is_the_one_before_the_graph(name, seed):
    c = T.make_corpus(_config(name), seed)
    assert c.neighbors is None
    assert _digest(c) == PINNED[name, seed]


@pytest.mark.parametrize("group", ["subcateg", "categ", "none"])
def test_a_graph_keeps_its_rules(group):
    c = _graph_corpus(2 ** 31 + 11, group=group, sharpness=2.0)
    nb = c.neighbors
    assert nb.dtype == np.int32 and nb.shape == (CORPUS["n_news"] + 1, 8)
    assert not nb[0].any()
    assert _digest(c) == _digest(T.make_corpus({"corpus": CORPUS}, 2 ** 31 + 11))
    of = {"subcateg": c.subcateg, "categ": c.categ,
          "none": np.zeros(CORPUS["n_news"] + 1, np.int64)}[group]
    members = np.bincount(of[1:], minlength=of.max() + 1)
    for i in range(1, CORPUS["n_news"] + 1):
        row = nb[i][nb[i] != 0]
        assert i not in row and len(set(row.tolist())) == len(row)
        assert (of[row] == of[i]).all()
        # filled from the front, as full as the group allows
        assert (nb[i][len(row):] == 0).all()
        assert len(row) == min(8, members[of[i]] - 1)


def test_the_graph_follows_the_seed_and_the_degree_law():
    degree = {"law": "lognormal", "median": 4, "sigma": 0.8, "lo": 0, "hi": 8}
    a, b = _graph_corpus(5, degree=degree), _graph_corpus(5, degree=degree)
    assert np.array_equal(a.neighbors, b.neighbors)
    other = _graph_corpus(6, degree=degree)
    assert not np.array_equal(a.neighbors, other.neighbors)
    # every subcategory here has more than 8 other members, so each row
    # fills what the law gives it: the law's quantiles, in a seeded order
    assert np.bincount(a.subcateg[1:])[1:].min() > 8
    for c in (a, other):
        fill = (c.neighbors[1:] != 0).sum(1)
        assert np.array_equal(np.sort(fill), np.sort(T.quantiles(degree, CORPUS["n_news"])))
    assert not np.array_equal((a.neighbors != 0).sum(1), (other.neighbors != 0).sum(1))


def test_a_sharper_graph_has_a_smaller_closure():
    batch = T.make_corpus({"corpus": CORPUS}, 9).popularity.draw(T.rng_for(9, 1), 300)
    sizes = [len(_closure(_graph_corpus(9, sharpness=s).neighbors, batch)) for s in (1, 2, 3)]
    assert sizes[0] > sizes[1] > sizes[2]


@pytest.mark.parametrize("sharpness", [1.0, 2.0])
def test_the_first_neighbour_is_drawn_by_weight_to_the_power_s(sharpness):
    """Over many draws, a row's first neighbour is its group's heaviest
    member, or one of the members below the 2K + 1 heaviest (those whose
    keys the draw makes as arrivals), as often as ``w^s`` says."""
    c = T.make_corpus({"corpus": CORPUS}, 4)
    g = {"neighbors": 8, "group": "subcateg", "sharpness": sharpness}
    w = c.popularity.weights(sharpness)
    members = np.flatnonzero(c.subcateg == np.bincount(c.subcateg[1:]).argmax())
    members = members[np.argsort(-w[members], kind="stable")]
    light, rows = set(members[17:].tolist()), members[17:]
    total, w_light = w[members].sum(), w[members[17:]].sum()
    first = np.stack([T.news_graph(g, c, np.random.default_rng([7, k]))[rows, 0]
                      for k in range(40)])
    assert len(rows) > 200
    top = (first == members[0]).mean()
    assert top == pytest.approx((w[members[0]] / (total - w[rows])).mean(), abs=0.02)
    low = np.isin(first, list(light)).mean()
    assert low == pytest.approx(((w_light - w[rows]) / (total - w[rows])).mean(), abs=0.02)


def test_the_draw_at_mind_scale_fits_in_setup():
    """161,013 news, K=15: under 2 s on the host (it enters ``setup_s``)."""
    cfg = _config("naml-mind")
    corpus = T.make_corpus(cfg, 3_000_000_011)
    g = {"neighbors": 15, "group": "subcateg", "sharpness": 1.0}
    took = []
    for _ in range(2):
        t0 = time.perf_counter()
        nb = T.news_graph(g, corpus, T.rng_for(3_000_000_011, T.STREAM_GRAPH))
        took.append(time.perf_counter() - t0)
    print(f"graph draw at 161,013 news, K=15: {min(took):.3f} s")
    assert nb.shape == (161_014, 15) and min(took) <= 2.0


def test_the_graph_reaches_the_program_and_the_reference():
    cfg = {"port": {}, "corpus": {**CORPUS, "graph": {"neighbors": 6, "group": "categ",
                                                      "sharpness": 1.0}}}
    c = T.make_corpus(cfg, 3)
    ds = port.dataset(cfg, c)
    assert ds.news.neighbors is c.neighbors
    feats = port.reference_feats(c, "cpu")
    assert np.array_equal(feats["neighbors"].numpy(), c.neighbors)
    assert port.feature_lengths(c)["neighbors"] is c.neighbors
    plain = T.make_corpus({"corpus": CORPUS}, 3)
    assert port.dataset(cfg, plain).news.neighbors is None
    assert "neighbors" not in port.reference_feats(plain, "cpu")
    assert "neighbors" not in port.feature_lengths(plain)


# ---- the training driver's feed ------------------------------------------

GNN = {"family": "gnn",
       "port": {"model": {"name": "gnn", "word_embed_size": 40, "num_attention_heads": 4,
                          "user_heads_num": 4, "query_vector_dim": 16, "dropout": 0.2,
                          "gnn_layers": 2, "gnn_neighbors": 4,
                          "compute_dtype": "bfloat16", "param_dtype": "float32"},
                "data": {"n_words_title": 20, "history_len": 10, "sample_size": 5},
                "train": {"batch_size": 64, "learning_rate": 0.001, "optimizer": "adam",
                          "dedup_batches": True, "unique_buckets": [256, 512],
                          "gnn_frontier_buckets": [256, 512, 1024]}},
       "corpus": {**CORPUS, "n_news": 400, "n_subcategories": 9,
                  "graph": {"neighbors": 4, "group": "subcateg", "sharpness": 2.0}}}
LOG = {"impressions": 512,
       "history_len": {"law": "lognormal", "median": 5, "sigma": 1.0, "lo": 1, "hi": 10}}
FRONTIER = ("gnn_frontier_ids", "gnn_nbr_pos", "gnn_self_pos")


def _trainer(cfgj: dict, log: dict, seed: int):
    from pytorch_news_recommender_tpu_torch.train.loop import Trainer

    corpus = T.make_corpus(cfgj, seed)
    cfg = port.config(cfgj, seed)
    ds = port.dataset(cfgj, corpus, T.make_click_log(cfgj, log, corpus, seed))
    return Trainer(cfg, ds, device="cpu"), ds, cfg


def _fit_batches(trainer) -> list:
    """One epoch of the batches ``Trainer.fit`` hands ``run_step``."""
    got = []

    def record(state, batch):
        got.append({k: v.numpy() for k, v in batch.items()})
        return state, {"loss": 0.0, "acc": 0.0}

    trainer.run_step = record
    trainer.fit(state=object(), num_epochs=1, eval_each_epoch=False)
    return got


def test_the_driver_feeds_the_gnn_frontier_as_fit_does():
    from pytorch_news_recommender_tpu_torch.data.prefetch import device_prefetch

    from h100bench.drivers import train as TR

    seed = 2 ** 31 + 21
    trainer, ds, cfg = _trainer(GNN, LOG, seed)
    fit = _fit_batches(copy.copy(trainer))
    assert len(fit) == LOG["impressions"] // 64
    feed = TR._feed(trainer, ds, cfg, np.random.default_rng(cfg.train.seed), False)
    for want in fit:
        got = next(feed)
        assert set(FRONTIER) <= set(got) and set(got) == set(want)
        for k in want:
            assert np.array_equal(np.asarray(got[k]), want[k]), k
    # the frontier comes built from the feed, and run_step trains on it
    batches = device_prefetch(TR._feed(trainer, ds, cfg, T.rng_for(seed, TR.SHUFFLE_STREAM),
                                       False), trainer.device)
    state = trainer.init_state()
    losses = []
    for _ in range(3):
        batch = next(batches)
        assert all(k in batch for k in FRONTIER)
        state, m = trainer.run_step(state, batch)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()


def test_the_nrms_feed_is_as_before(tiny):
    from pytorch_news_recommender_tpu_torch.data.loader import (
        DEFAULT_UNIQUE_BUCKETS, train_batches,
    )

    from h100bench.drivers import train as TR

    cell = tiny.cell("nrms-train-b512")
    trainer, ds, cfg = _trainer(cell.config, cell.traffic, 17)
    rng = T.rng_for(17, TR.SHUFFLE_STREAM)
    feed = TR._feed(trainer, ds, cfg, copy.deepcopy(rng), False)
    tc = cfg.train
    n = len(ds.train) // tc.batch_size
    # the batches of one epoch and the first of the next, on the same generator
    parent = [b for _ in range(2) for b in train_batches(
        ds.train, tc.batch_size, rng, dedup=True,
        unique_buckets=tc.unique_buckets or DEFAULT_UNIQUE_BUCKETS,
        length_split=trainer._length_split)][:n + 1]
    for want in parent:
        got = next(feed)
        assert set(got) == set(want) and not set(FRONTIER) & set(got)
        for k in want:
            assert np.array_equal(got[k], want[k]), k
