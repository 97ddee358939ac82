"""The generators: one seed gives the same inputs; another seed the same
sizes in another order; counting matches hand-worked numbers."""

import numpy as np

from h100bench import counting, traffic as T

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
    counting.step_work(w, model, lens, [(browsed, cand)], "nrms")
    expect = (counting.tower_flops(np.array([3, 5, 7]), 4, 2, 3)
              + counting.tower_flops(np.array([2, 1]), 4, 2, 3))
    assert w.fwd_flops == expect
    assert w.other_flops == 2.0 * 4 * 4
