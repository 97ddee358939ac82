"""The generators: one seed gives the same inputs; another seed the same
sizes in another order; counting matches hand-worked numbers, and each
family's count matches the formulas it had when the count named the
families."""

import numpy as np
import pytest

from h100bench import counting, reference, traffic as T

CFG = {"port": {"data": {"history_len": 10, "sample_size": 5}},
       "corpus": {"n_news": 300, "vocab": 200, "title_width": 20, "abstract_width": 40,
                  "title_len": {"law": "normal", "mean": 11.5, "std": 4, "lo": 1, "hi": 20},
                  "abstract_len": {"law": "normal", "mean": 43, "std": 15, "lo": 1, "hi": 40},
                  "n_categories": 6, "n_subcategories": 9, "category_zipf": 1.0,
                  "word_zipf": 1.0, "news_zipf": 1.0}}
LOG = {"impressions": 256, "history_len": {"law": "lognormal", "median": 5, "sigma": 1.0,
                                           "lo": 1, "hi": 10}}
SERVE = {"rate_per_s": 200, "topk_share": 0.1, "k": 10,
         "history_len": {"law": "lognormal", "median": 5, "sigma": 1.2, "lo": 1, "hi": 10},
         "candidates": {"law": "lognormal", "median": 20, "sigma": 1.1, "lo": 2, "hi": 300}}


def _all(seed):
    c = T.make_corpus(CFG, seed)
    log = T.make_click_log(CFG, LOG, c, seed)
    r = T.make_requests(SERVE, c, 3.0, seed)
    return [c.title, c.abst, c.categ, c.subcateg, log.browsed, log.candidates,
            *r.arrays().values()]


def test_one_seed_gives_the_same_inputs():
    big = 2 ** 31 + 123_456
    for a, b in zip(_all(big), _all(big)):
        assert np.array_equal(a, b)


def test_another_seed_gives_the_same_sizes_in_another_order():
    a, b = T.make_corpus(CFG, 1), T.make_corpus(CFG, 2)
    la, lb = (a.title != 0).sum(1), (b.title != 0).sum(1)
    assert not np.array_equal(la, lb)
    assert np.array_equal(np.sort(la), np.sort(lb))
    ra, rb = T.make_requests(SERVE, a, 3.0, 1), T.make_requests(SERVE, b, 3.0, 2)
    assert len(ra) == len(rb) == 600
    assert (ra.kind == 1).sum() == (rb.kind == 1).sum() == 60
    assert np.array_equal(np.sort(np.diff(ra.cand_off)), np.sort(np.diff(rb.cand_off)))
    gaps = lambda r: np.sort(np.append(np.diff(r.due), 3.0 - r.due[-1]))  # noqa: E731
    assert np.allclose(gaps(ra), gaps(rb))
    assert ra.due[0] == 0 and ra.due[-1] < 3.0


def test_candidate_counts_keep_their_law():
    q = T.quantiles(SERVE["candidates"], 100_000)
    assert q.min() == 2 and q.max() == 300
    assert 33 < q.mean() < 40          # MIND's mean impression size is about 37
    h = T.quantiles({"law": "lognormal", "median": 20, "sigma": 1.2, "lo": 1, "hi": 50}, 10_000)
    assert 0.15 < (h == 50).mean() < 0.3


def test_tower_counts_match_hand_worked_numbers():
    # two items of 2 and 0 real tokens, D=4, H=2 (dh=2), Q=3:
    # 2*2*4*(16+3) + 4*2*2*2*2 + 2*2*(3+4) = 304 + 64 + 28
    assert counting.tower_flops(np.array([2, 0]), 4, 2, 3) == 396.0
    # bytes: 2 * (2*4 tokens + 4 out + (48 + 12 + 16 + 4 + 12 + 6) weights)
    assert counting.tower_bytes(np.array([2, 0]), 4, 3) == 2 * (8 + 4 + 98)
    w = counting.Work()
    w.add_tower([2, 0], 4, 2, 3)
    assert w.bwd_flops == 792.0 and w.step_flops == 3 * 396.0
    assert counting.roofline_s(989e12, 0) == 1.0
    assert counting.roofline_s(0, 3.35e12 * 2) == 2.0


def test_step_work_counts_each_distinct_news_once():
    lens = {"title_len": np.array([0, 3, 5, 7])}
    model = {"word_embed_size": 4, "num_attention_heads": 2, "query_vector_dim": 3,
             "user_heads_num": 2}
    browsed = np.array([[0, 1, 2], [0, 0, 1]])
    cand = np.array([[3, 1], [2, 3]])
    w = counting.Work()
    counting.step_work(w, model, lens, [(browsed, cand)], reference.family("nrms"))
    expect = (counting.tower_flops(np.array([3, 5, 7]), 4, 2, 3)
              + counting.tower_flops(np.array([2, 1]), 4, 2, 3))
    assert w.fwd_flops == expect
    assert w.other_flops == 2.0 * 4 * 4
    assert (w.news, w.news_tokens, w.history_clicks, w.steps) == (3, 15, 3, 1)


def test_naml_step_work_counts_both_views_and_the_wide_user_tower():
    # D=4, H=2, Q=3 for the text tower; the user tower at 2D + 2E = 12
    # wide, 2 heads of 6, query_vector_dim_large 5
    lens = {"title_len": np.array([0, 3, 5, 7]), "abst_len": np.array([0, 1, 0, 4])}
    model = {"word_embed_size": 4, "num_attention_heads": 2, "query_vector_dim": 3,
             "user_heads_num": 2, "cate_embed_size": 2, "query_vector_dim_large": 5}
    browsed = np.array([[0, 1, 2], [0, 0, 1]])
    cand = np.array([[3, 1], [2, 3]])
    w = counting.Work()
    counting.step_work(w, model, lens, [(browsed, cand)], reference.family("naml"))
    # per user item of l clicks: 2*l*12*(48+5) + 4*2*l*l*6 + 2*l*(5+12)
    # = 1306 l + 48 l^2; histories of 2 and 1: 2804 + 1354
    user = 4158.0
    assert counting.tower_flops(np.array([2, 1]), 12, 2, 5) == user
    assert w.fwd_flops == (counting.tower_flops(np.array([3, 5, 7]), 4, 2, 3)
                           + counting.tower_flops(np.array([1, 0, 4]), 4, 2, 3) + user)
    # bytes: the user tower's 3 clicks and 2 vectors at 12, its weights
    # 3*144 + 36 + 144 + 12 + 60 + 10 = 694, each once
    assert w.fwd_bytes == (counting.tower_bytes(np.array([3, 5, 7]), 4, 3)
                           + counting.tower_bytes(np.array([1, 0, 4]), 4, 3)
                           + 2 * (3 * 12 + 2 * 12 + 694))
    assert w.other_flops == 2.0 * 4 * 12
    assert (w.news, w.news_tokens, w.history_clicks) == (3, 15 + 5, 3)


def _pinned_step_work(acc, model, feats, slices, family):
    """The count as it was when ``counting.step_work`` named the families,
    formulas included, adding one step to ``acc`` in the same order."""

    def flops(lengths, D, H, Q):
        l = np.asarray(lengths, np.float64)
        l = l[l > 0]
        dh = D / H
        return float((2 * l * D * (4 * D + Q) + 4 * H * l * l * dh + 2 * l * (Q + D)).sum())

    def nbytes(lengths, D, Q, calls=1):
        l = np.asarray(lengths, np.float64)
        l = l[l > 0]
        weights = 3 * D * D + 3 * D + D * D + D + D * Q + 2 * Q
        return float(2 * ((l * D).sum() + D * len(l) + calls * weights))

    def tower(lengths, D, H, Q):
        acc["fwd_flops"] += flops(lengths, D, H, Q)
        acc["fwd_bytes"] += nbytes(lengths, D, Q)

    D, H, Q = model["word_embed_size"], model["num_attention_heads"], model["query_vector_dim"]
    for browsed, cand in slices:
        ids = np.unique(np.concatenate([browsed.ravel(), cand.ravel()]))
        ids = ids[ids != 0]
        acc["news"] += len(ids)
        tower(feats["title_len"][ids], D, H, Q)
        acc["news_tokens"] += int(feats["title_len"][ids].sum())
        if family == "naml":
            tower(feats["abst_len"][ids], D, H, Q)
            acc["news_tokens"] += int(feats["abst_len"][ids].sum())
            UD, UQ = 2 * D + 2 * model["cate_embed_size"], model["query_vector_dim_large"]
        else:
            UD, UQ = D, Q
        tower((browsed != 0).sum(1), UD, model["user_heads_num"], UQ)
        acc["history_clicks"] += int((browsed != 0).sum())
        acc["other_flops"] += 2.0 * cand.size * UD
    acc["steps"] += 1


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 5, 977])
@pytest.mark.parametrize("cell,ranks", [("nrms-train-b512", 1), ("naml-train-b512", 1),
                                        ("nrms-train-dp4", 2)])
def test_each_family_counts_what_the_pinned_formulas_count(tiny, cell, ranks, seed):
    """Every number of ``Work`` over a tiny run's steps 2-4, of the whole
    batch and of the last rank's slice, equals the pinned count bit for
    bit."""
    from h100bench import port
    from h100bench.drivers import train as TR

    c = tiny.cell(cell)
    inp = TR.Inputs(c, seed, ranks)
    lens = port.feature_lengths(inp.corpus)
    for rank_slice in (None, ranks - 1) if ranks > 1 else (None,):
        w = TR.work_of(inp, 2, 3, rank_slice)
        acc = dict.fromkeys(("fwd_flops", "fwd_bytes", "other_flops"), 0.0)
        acc.update(dict.fromkeys(("news", "news_tokens", "history_clicks", "steps"), 0))
        for k in range(2, 5):
            br, ca = inp.slices(k)
            if rank_slice is not None:
                per = len(br) // ranks
                br = br[rank_slice * per:(rank_slice + 1) * per]
                ca = ca[rank_slice * per:(rank_slice + 1) * per]
            _pinned_step_work(acc, inp.model, lens, [(br, ca)], c.config["family"])
        assert (w.fwd_flops, w.fwd_bytes, w.other_flops, w.steps) == (
            acc["fwd_flops"], acc["fwd_bytes"], acc["other_flops"], acc["steps"])
        assert w.step_flops == 3 * (acc["fwd_flops"] + acc["other_flops"]) and w.parts == {}
        n = acc["steps"]
        assert w.per_step() == {"news": acc["news"] / n, "news_tokens": acc["news_tokens"] / n,
                                "history_clicks": acc["history_clicks"] / n}
