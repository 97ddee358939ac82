"""A model family is taken by files alone: a module registered as
``h100bench.reference.<name>`` counts its own work, parts outside the fused
encoder included, reading the corpus's news graph where there is one; it
draws its own dropout seeds from the step's stream, and may lay out its own
step (``slice_vectors``); one without ``work`` stops the run and names
itself."""

import itertools
import json
import sys
import types

import numpy as np
import pytest
import torch

from h100bench import core, counting, reference
from h100bench.reference import common as C
from h100bench.reference import nrms

PART_FLOPS = 7.0e9


def _stub(name, seeds_a_call=3, with_work=True, own_layout=False):
    """NRMS's towers under another family name; ``encode`` draws
    ``seeds_a_call`` seeds a call and records them, and ``work`` adds a
    named part beside NRMS's count, and where the corpus has a news graph a
    part ``closure`` of one operation per news in the slice's depth-2
    closure. With ``own_layout``, ``slice_vectors`` lays out the step
    itself, replaying the generic layout."""
    mod = types.ModuleType(f"h100bench.reference.{name}")
    mod.FEATS, mod.leaves, mod.user = nrms.FEATS, nrms.leaves, nrms.user
    mod.drawn, mod.laid = [], []

    def encode(p, W, model, feats, seeds=None, rate=0.0):
        if seeds is None:
            return nrms.encode(p, W, model, feats)
        got = [next(seeds) for _ in range(seeds_a_call)]
        mod.drawn.append(got)
        return nrms.encode(p, W, model, feats, iter(got[:1]), rate)

    def work(w, model, lens, news, browsed, cand):
        nrms.work(w, model, lens, news, browsed, cand)
        w.add_part("stub_attention", PART_FLOPS, counting.elementwise_bytes(len(news) * 10))
        if "neighbors" in lens:
            reach = cur = news
            for _ in range(2):
                cur = np.unique(lens["neighbors"][cur])
                reach = np.union1d(reach, cur)
            w.add_part("closure", np.count_nonzero(reach), 0.0)

    def slice_vectors(p, W, model, feats, browsed, cand, title_len, trunc, seeds, rate, device):
        from h100bench.reference import layout as LY
        from h100bench.reference import train as RT

        mod.laid.append(len(browsed))
        return RT._slice_scores(mod, p, W, model, feats, LY.single(browsed, cand, title_len, trunc),
                                seeds, rate, device)

    mod.encode = encode
    if with_work:
        mod.work = work
    if own_layout:
        mod.slice_vectors = slice_vectors
    return mod


class _Trace:
    """One millisecond of device time under every span."""

    def device_s(self, pick):
        return 1e-3


def test_a_named_part_counts_in_the_step_and_not_in_the_encoder(tiny, monkeypatch):
    from h100bench import port
    from h100bench.drivers import train as TR

    monkeypatch.setitem(sys.modules, "h100bench.reference.stubfam", _stub("stubfam"))
    inp = TR.Inputs(tiny.cell("nrms-train-b512"), 11)
    lens = port.feature_lengths(inp.corpus)
    readers = core.Bench().metrics()
    got = {}
    for name in ("nrms", "stubfam"):
        w = counting.Work()
        for k in range(3):
            counting.step_work(w, inp.model, lens, [inp.slices(k)], reference.family(name))
        rec = core.Record(kind="train", trace=_Trace(), work=w, step_work=w, window_s=2.0)
        got[name] = (w, {m: readers[m].read(rec) for m in
                         ("train_mfu_pct", "encoder_fwd_roofline", "encoder_bwd_roofline")})
    (base, r0), (stub, r1) = got["nrms"], got["stubfam"]
    assert stub.parts["stub_attention"][0] == 3 * PART_FLOPS
    assert stub.step_flops == base.step_flops + 3 * (3 * PART_FLOPS)
    assert r1["train_mfu_pct"] - r0["train_mfu_pct"] == pytest.approx(
        100 * 9 * PART_FLOPS / (counting.PEAK_FLOPS * 2.0), rel=1e-9)
    assert (stub.fwd_flops, stub.fwd_bytes) == (base.fwd_flops, base.fwd_bytes)
    assert r1["encoder_fwd_roofline"] == r0["encoder_fwd_roofline"]
    assert r1["encoder_bwd_roofline"] == r0["encoder_bwd_roofline"]


def test_the_step_seeds_reach_encode_in_call_order(tiny, monkeypatch):
    from h100bench import port, weights
    from h100bench import traffic as T
    from h100bench.drivers import train as TR
    from h100bench.reference import layout as LY
    from h100bench.reference import train as RT

    stub = _stub("stubfam")
    monkeypatch.setitem(sys.modules, "h100bench.reference.stubfam", stub)
    cell = tiny.cell("nrms-train-b512")
    seed = 2 ** 31 + 3
    model = cell.config["port"]["model"]
    inp = TR.Inputs(cell, seed)
    batches = [inp.slices(k) for k in range(2)]
    corpus = T.make_corpus(cell.config, seed)
    title_len = port.feature_lengths(corpus)["title_len"]
    W0 = weights.make(stub.leaves(model, cell.config["corpus"]), seed, "cpu")
    RT.run(reference.family("stubfam"), model, 1e-3, port.train_seed(seed), W0,
           port.reference_feats(corpus, "cpu"), title_len, batches)
    trunc = int(model.get("short_title_len") or 0) or None
    expect = []
    for step, (b, c) in enumerate(batches):
        calls = len(LY.single(b, c, title_len, trunc).calls)
        stream = C.step_seeds(port.train_seed(seed), step)
        expect += [list(itertools.islice(stream, 3)) for _ in range(calls)]
    assert len(expect) >= 4 and stub.drawn == expect
    # NRMS itself takes the first seed of each call, as before
    first = C.step_seeds(port.train_seed(seed), 0)
    assert [next(first)] == stub.drawn[0][:1]


def test_a_family_without_work_stops_the_run(tiny, runner, monkeypatch):
    monkeypatch.setitem(sys.modules, "h100bench.reference.nowork",
                        _stub("nowork", with_work=False))
    root = tiny.root
    cfg = json.loads((root / "configs" / "nrms-mind.json").read_text())
    cfg.update(name="nowork-mind", family="nowork")
    (root / "configs" / "nowork-mind.json").write_text(json.dumps(cfg))
    cell = json.loads((root / "workloads" / "nrms-train-b512.json").read_text())
    cell.update(name="nowork-train", config="nowork-mind")
    (root / "workloads" / "nowork-train.json").write_text(json.dumps(cell))
    with pytest.raises(TypeError, match=r"h100bench\.reference\.nowork has no work"):
        runner(tiny, "nowork-train")
    with pytest.raises(TypeError, match=r"h100bench\.reference\.nowork"):
        counting.step_work(counting.Work(), {}, {}, [(np.zeros((1, 1), int),) * 2],
                           reference.family("nowork"))


def _reference_run(cell, fam, seed, ranks=1):
    from h100bench import port, weights
    from h100bench import traffic as T
    from h100bench.drivers import train as TR
    from h100bench.reference import train as RT

    model = cell.config["port"]["model"]
    inp = TR.Inputs(cell, seed, ranks)
    corpus = T.make_corpus(cell.config, seed)
    W0 = weights.make(fam.leaves(model, cell.config["corpus"]), seed, "cpu")
    return RT.run(fam, model, 1e-3, port.train_seed(seed), W0, port.reference_feats(corpus, "cpu"),
                  port.feature_lengths(corpus)["title_len"], [inp.slices(k) for k in range(2)],
                  ranks)


def test_a_family_that_lays_out_its_own_step_replaces_the_generic_layout(tiny, monkeypatch):
    generic, own = _stub("stubfam"), _stub("ownfam", own_layout=True)
    monkeypatch.setitem(sys.modules, "h100bench.reference.stubfam", generic)
    monkeypatch.setitem(sys.modules, "h100bench.reference.ownfam", own)
    cell = tiny.cell("nrms-train-b512")
    seed = 2 ** 31 + 13
    # the CPU's threaded gradient sums differ in their last bits from run to
    # run; its deterministic kernels make two runs of one path equal
    prior = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        a = _reference_run(cell, reference.family("stubfam"), seed)
        b = _reference_run(cell, reference.family("ownfam"), seed)
    finally:
        torch.use_deterministic_algorithms(prior)
    assert own.laid == [cell.config["port"]["train"]["batch_size"]] * 2 and generic.laid == []
    assert own.drawn == generic.drawn and len(own.drawn) >= 2
    assert a["losses"] == b["losses"]
    for key in ("grad", "params"):
        assert a[key].keys() == b[key].keys()
        assert all(torch.equal(a[key][n], b[key][n]) for n in a[key])


def test_an_own_layout_of_one_rank_stops_a_reference_of_several(tiny, monkeypatch):
    monkeypatch.setitem(sys.modules, "h100bench.reference.ownfam", _stub("ownfam", own_layout=True))
    with pytest.raises(ValueError, match=r"h100bench\.reference\.ownfam lays out its own step"):
        _reference_run(tiny.cell("nrms-train-dp4"), reference.family("ownfam"), 5, ranks=2)


def test_a_family_counts_its_work_from_the_news_graph(tiny, monkeypatch):
    from pytorch_news_recommender_tpu_torch.data.loader import add_gnn_frontier

    from h100bench import port
    from h100bench.drivers import train as TR

    monkeypatch.setitem(sys.modules, "h100bench.reference.stubfam", _stub("stubfam"))
    cell = tiny.cell("nrms-train-b512")
    cell.config["corpus"]["graph"] = {"neighbors": 3, "group": "none", "sharpness": 1.0}
    inp = TR.Inputs(cell, 23)
    lens = port.feature_lengths(inp.corpus)
    w = counting.Work()
    expect = 0
    for k in range(2):
        b, c = inp.slices(k)
        counting.step_work(w, inp.model, lens, [(b, c)], reference.family("stubfam"))
        # what the program's frontier encodes: the closure, the pad news and padding aside
        uids = np.unique(np.concatenate([[0], b.ravel(), c.ravel()]))
        front = add_gnn_frontier({"unique_ids": uids}, inp.corpus.neighbors, 2,
                                 (inp.corpus.n_news,))["gnn_frontier_ids"]
        expect += np.count_nonzero(front)
    assert w.parts["closure"] == (expect, 0.0)
    assert 0 < expect < 2 * inp.corpus.n_news - 2
    # a corpus without a graph counts no closure
    plain = TR.Inputs(tiny.cell("nrms-train-b512"), 23)
    w = counting.Work()
    counting.step_work(w, plain.model, port.feature_lengths(plain.corpus), [plain.slices(0)],
                       reference.family("stubfam"))
    assert "closure" not in w.parts
