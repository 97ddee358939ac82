"""The ``gnn-train-b512`` cell at a size the CPU runs in seconds: the
reference's frozen frontier layout against the program's
``loader.add_gnn_frontier``, its step against the program's frontier step
(float32 and bfloat16) and its vectors against the program's recursive
encode, planted faults against the limits, and the ``gat`` work part and
its readers against a count by hand."""

import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from h100bench import core, counting, port, reference, weights
from h100bench import traffic as T
from h100bench.reference import common as C
from h100bench.reference import gnn as RG

CELL = "gnn-train-b512"
SEED = 2 ** 31 + 5
# a graph whose rows hold 0-15 neighbours, so that the mask matters
DEGREE = {"law": "lognormal", "median": 8, "sigma": 0.8, "lo": 0, "hi": 15}
# this size's limits (grad_gap, update_gap, update_gap_median; each leaf over
# its own norm). On the CPU at D=40, seeds 2^31 + 1..8 with full rows and
# 2^31 + 1..12 with DEGREE, the program read at float32 compute up to 1.0e-6
# / 1.0e-6 / 8.5e-8 (seeds 1..3); at bfloat16 up to 0.144 / 0.422 / 2.1e-3.
# The worst leaves are the rounds' wq, wk and a: q·a[:D] is shared by all of
# a news's neighbours and the softmax drops it but where the leaky ReLU
# bends, so their gradients are differences of near-equal terms, which
# bfloat16 rounds. The planted faults read at least 0.52 / 0.14 / 5.7e-3
# (3 seeds each): grad_gap and update_gap_median catch them, update_gap
# does not at this size.
LIMITS = {"float32": {"grad_gap": 1e-4, "update_gap": 1e-4, "update_gap_median": 1e-5},
          "bfloat16": {"grad_gap": 0.3, "update_gap": 0.6, "update_gap_median": 0.004}}


def _set_up(bench, compute_dtype="bfloat16", degree=None):
    """The tiny cell at ``compute_dtype``, its graph's rows filled by
    ``degree`` (None: every row full), with :data:`LIMITS`."""
    root = bench.root
    path = root / "configs" / "gnn-mind.json"
    cfg = json.loads(path.read_text())
    cfg["port"]["model"]["compute_dtype"] = compute_dtype
    if degree is not None:
        cfg["corpus"]["graph"]["degree"] = degree
    path.write_text(json.dumps(cfg))
    path = root / "workloads" / f"{CELL}.json"
    cell = json.loads(path.read_text())
    cell["checks"] = {k: LIMITS[compute_dtype][k] for k in cell["checks"]}
    path.write_text(json.dumps(cell))
    return bench.cell(CELL)


def _numbers(bench, seed=SEED):
    """The training driver's numbers of one short run of the tiny cell."""
    from h100bench import run as R

    ctx = R.Context(bench, bench.cell(CELL), seed, 0.3, False, "cpu", time.time())
    return bench.driver("train").run(ctx)["numbers"]


# ---- the layout -----------------------------------------------------------

def test_the_frozen_layout_is_the_programs_in_the_drivers_feed(tiny):
    """The frontier of each step that the driver's feed hands ``run_step``
    (two epochs' worth of steps, bucket included) against the reference's
    layout of the same step's raw impressions."""
    from h100bench.drivers import train as TR

    cell = _set_up(tiny, degree=DEGREE)
    inp = TR.Inputs(cell, SEED)
    trainer, ds, cfg = _trainer(cell, SEED, inp)
    feed = TR._feed(trainer, ds, cfg, T.rng_for(SEED, TR.SHUFFLE_STREAM), False)
    steps = 2 * inp.rows.per_epoch
    for k in range(steps):
        got = next(feed)
        b, c = inp.slices(k)
        fr = RG.frontier(b, c, inp.corpus.neighbors, 2)
        assert np.array_equal(got["gnn_frontier_ids"], fr.ids)
        assert np.array_equal(got["gnn_nbr_pos"], fr.nbr_pos)
        assert np.array_equal(got["gnn_self_pos"], fr.pos_of[got["unique_ids"]])
        ids = got["unique_ids"]
        assert np.array_equal(fr.pos_of[b], got["gnn_self_pos"][got["browsed_idx"]])
        assert np.array_equal(ids[got["candidate_idx"]], c)


def _trainer(cell, seed, inp):
    from pytorch_news_recommender_tpu_torch.train.loop import Trainer

    cfg = port.config(cell.config, seed)
    ds = port.dataset(cell.config, inp.corpus, inp.log)
    return Trainer(cfg, ds, device="cpu"), ds, cfg


@pytest.mark.parametrize("n_news,batch,depth", [(20_000, 3_000, 2), (60_000, 4_000, 2),
                                                (5_000, 700, 1)])
def test_the_frozen_layout_takes_the_programs_bucket(n_news, batch, depth):
    """Closures past the first rungs of ``GNN_FRONTIER_BUCKETS``: the same
    buffer, positions and width as ``add_gnn_frontier``."""
    from pytorch_news_recommender_tpu_torch.data.loader import (
        GNN_FRONTIER_BUCKETS, add_gnn_frontier,
    )

    assert RG.FRONTIER_BUCKETS == GNN_FRONTIER_BUCKETS
    g = np.random.default_rng(n_news)
    nb = g.integers(1, n_news + 1, (n_news + 1, 6)).astype(np.int32)
    nb[g.random(nb.shape) < 0.2] = 0
    nb[0] = 0
    browsed = g.integers(0, n_news + 1, (batch, 5))
    cand = g.integers(1, n_news + 1, (batch, 2))
    uids = np.unique(np.concatenate([[0], browsed.ravel(), cand.ravel()]))
    want = add_gnn_frontier({"unique_ids": uids.astype(np.int32)}, nb, depth)
    fr = RG.frontier(browsed, cand, nb, depth)
    assert len(fr.ids) > GNN_FRONTIER_BUCKETS[1]
    assert np.array_equal(want["gnn_frontier_ids"], fr.ids)
    assert np.array_equal(want["gnn_nbr_pos"], fr.nbr_pos)
    assert np.array_equal(want["gnn_self_pos"], fr.pos_of[uids])


# ---- the step -------------------------------------------------------------

@pytest.mark.parametrize("compute_dtype,degree", [("float32", None), ("float32", DEGREE),
                                                  ("bfloat16", None), ("bfloat16", DEGREE)])
def test_the_reference_step_matches_the_programs_frontier_step(tiny, runner, compute_dtype,
                                                               degree):
    """Loss, gradient and Adam's update of three steps on the driver's
    frontier feed within :data:`LIMITS` (float32: the first loss within
    1e-6); the cell's own ``checks`` are the ones compared."""
    _set_up(tiny, compute_dtype, degree)
    out = runner(tiny, CELL, seed=SEED)
    assert out["correct"] is True
    committed = json.loads((core.ROOT / "workloads" / f"{CELL}.json").read_text())["checks"]
    assert set(out["checks"]) == set(committed)
    if compute_dtype == "float32":
        assert _numbers(tiny)["loss_gap"] <= 1e-6


def test_the_recursive_encode_agrees(tiny):
    """Dropout off, float32: the program's recursive form (a dedup batch
    without its frontier) gives the reference's scores and gradients."""
    from pytorch_news_recommender_tpu_torch.data.loader import train_batches
    from pytorch_news_recommender_tpu_torch.models.convert import assign
    from pytorch_news_recommender_tpu_torch.models.gnn import GNNRec

    cell = _set_up(tiny, "float32", DEGREE)
    cfgj = cell.config
    model = dict(cfgj["port"]["model"], dropout=0.0)
    corpus = T.make_corpus(cfgj, SEED)
    cfg = port.config(cfgj, SEED)
    W = weights.make(RG.leaves(model, cfgj["corpus"]), SEED, "cpu")
    net = GNNRec(dataclasses.replace(cfg.model, n_words=cfgj["corpus"]["vocab"], dropout=0.0))
    assign(net, W)
    ds = port.dataset(cfgj, corpus, T.make_click_log(cfgj, cell.traffic, corpus, SEED))
    from pytorch_news_recommender_tpu_torch.train.loop import Trainer

    tr = Trainer(cfg, ds, device="cpu")
    batch = next(train_batches(ds.train, 128, np.random.default_rng(1), dedup=True))
    assert "unique_ids" in batch and "gnn_frontier_ids" not in batch
    uids = batch["unique_ids"]
    browsed, cand = uids[batch["browsed_idx"]], uids[batch["candidate_idx"]]
    scores = net(tr._to_device(batch), tr.news_feats, deterministic=True)
    loss = -torch.log_softmax(scores, -1)[:, 0].mean()
    grads = torch.autograd.grad(loss, list(net.parameters()))
    prog = dict(zip([n for n, _ in net.named_parameters()], grads))

    C.strict_fp32()
    Wr = {n: w.clone().requires_grad_(True) for n, w in W.items()}
    feats = port.reference_feats(corpus, "cpu")
    b_vecs, c_vecs = RG.slice_vectors(C.F32, Wr, model, feats, browsed, cand, None, None,
                                      None, 0.0, "cpu")
    b_ids, c_ids = torch.as_tensor(browsed), torch.as_tensor(cand)
    user = RG.user(C.F32, Wr, model, b_vecs, b_ids != 0)
    ref_scores = torch.where(c_ids != 0, C.dot_scores(C.F32, user, c_vecs), C.NEG_INF)
    ref_loss = -torch.log_softmax(ref_scores, -1)[:, 0].mean()
    ref = dict(zip(Wr, torch.autograd.grad(ref_loss, list(Wr.values()))))
    torch.testing.assert_close(scores.detach(), ref_scores.detach(), rtol=1e-5, atol=1e-5)
    assert set(prog) == set(ref)
    for n, g in ref.items():
        torch.testing.assert_close(prog[n], g, rtol=1e-4, atol=1e-6, msg=n)
    assert all(float(prog[f"gat{i}.wk"].abs().max()) > 0 for i in range(2))


def _drop_a_round(mp):
    from pytorch_news_recommender_tpu_torch.models import gnn

    mp.setattr(gnn.GNNRec, "gat_layers", property(lambda self: [self.gat0]))


def _ignore_the_mask(mp):
    from pytorch_news_recommender_tpu_torch.models import gnn

    inner = gnn.GATLayer.forward
    mp.setattr(gnn.GATLayer, "forward", lambda self, s, n, m: inner(self, s, n, torch.ones_like(m)))


def _wk_as_wq(mp):
    from pytorch_news_recommender_tpu_torch.models import gnn

    inner = gnn.GATLayer.forward

    def forward(self, s, n, m):
        wk = self._parameters["wk"]
        self._parameters["wk"] = self.wq
        try:
            return inner(self, s, n, m)
        finally:
            self._parameters["wk"] = wk

    mp.setattr(gnn.GATLayer, "forward", forward)


@pytest.mark.parametrize("fault", [_drop_a_round, _ignore_the_mask, _wk_as_wq])
def test_a_planted_fault_is_not_correct(tiny, runner, monkeypatch, fault):
    _set_up(tiny, "bfloat16", DEGREE)
    fault(monkeypatch)
    assert runner(tiny, CELL, seed=SEED)["correct"] is False


# ---- the work -------------------------------------------------------------

# a hand-built graph over news 1-9, K = 3 (0: no neighbour)
GRAPH = np.array([[0, 0, 0],
                  [2, 3, 0], [1, 4, 5], [6, 0, 0], [7, 8, 9], [1, 0, 0],
                  [3, 2, 0], [0, 0, 0], [9, 1, 2], [4, 0, 0]])
TITLE_LEN = np.array([0, 3, 5, 1, 4, 2, 6, 7, 2, 8])


def _brute(U, D, K=3):
    """The ``gat`` part and the closure by sets, round by round."""
    nbrs = {i: {int(j) for j in GRAPH[i] if j} for i in range(1, 10)}
    S1 = set(U) | {j for u in U for j in nbrs[u]}
    reach = S1 | {j for u in S1 for j in nbrs[u]}
    flops = nbytes = 0
    for S in (S1, set(U)):
        N = {j for x in S for j in nbrs[x]}
        k = sum(len(nbrs[x]) for x in S)
        flops += 4 * D * D + 2 * D * len(S) + 2 * D * len(N) + 2 * D * k + 4 * D * D * len(S)
        nbytes += 2 * D * (len(S) + len(N)) + 2 * D * len(S) + 4 * K * len(S) + 2 * (
            4 * D * D + 3 * D)
    return flops, nbytes, sorted(reach), (len(S1), len(U))


def test_the_work_counts_the_closure_and_the_gat_by_hand():
    D, H, Q = 4, 2, 3
    model = {"word_embed_size": D, "num_attention_heads": H, "user_heads_num": H,
             "query_vector_dim": Q, "gnn_layers": 2}
    lens = {"title_len": TITLE_LEN, "neighbors": GRAPH}
    browsed = np.array([[0, 1], [0, 0]])
    cand = np.array([[3, 1], [3, 0]])
    flops, nbytes, reach, rows = _brute([1, 3], D)
    assert reach == [1, 2, 3, 4, 5, 6] and rows == (4, 2)   # 7, 8, 9 lie 3 hops out
    w = counting.Work()
    counting.step_work(w, model, lens, [(browsed, cand)], reference.family("gnn"))
    assert w.parts == {"gat": (float(flops), float(nbytes))}
    # the tower over the closure's real news at their real lengths, no pad row
    assert w.fwd_flops == (counting.tower_flops(TITLE_LEN[reach], D, H, Q)
                           + counting.tower_flops(np.array([1, 0]), D, H, Q))
    assert w.fwd_bytes == (counting.tower_bytes(TITLE_LEN[reach], D, Q)
                           + counting.tower_bytes(np.array([1, 0]), D, Q))
    assert w.news_tokens == TITLE_LEN[reach].sum() == 21
    assert w.step_flops == 3 * (w.fwd_flops + w.other_flops + flops)
    assert w.per_step() == {"news": 2, "news_tokens": 21, "history_clicks": 1,
                            "closure_news": 6, "frontier_width": 2048,
                            "gat_rows.round1": 4, "gat_rows.round2": 2}


class _Trace:
    """2 ms of device time under the GAT's forward span, 5 under its
    backward's."""

    def device_s(self, pick):
        return (2e-3 if pick("newsrec.gnn.gat") else 0.0) + (
            5e-3 if pick("newsrec.gnn.gat.backward") else 0.0)


@pytest.mark.parametrize("family", ["gnn", "nrms", "disan"])
def test_the_gat_rooflines_read_the_part_and_nothing_without_it(tiny, family):
    from h100bench.drivers import train as TR

    cell = {"gnn": CELL, "nrms": "nrms-train-b512", "disan": "disan-train-b512"}[family]
    inp = TR.Inputs(tiny.cell(cell), 5)
    w = TR.work_of(inp, 0, 2, None)
    readers = core.Bench().metrics()
    rec = core.Record(kind="train", trace=_Trace(), work=w, step_work=w, window_s=1.0)
    fwd, bwd = (readers[n].read(rec) for n in ("gat_fwd_roofline", "gat_bwd_roofline"))
    if family != "gnn":
        assert "gat" not in w.parts and fwd is None and bwd is None
        return
    flops, nbytes = w.parts["gat"]
    assert fwd == pytest.approx(100 * counting.roofline_s(flops, nbytes) / 2e-3, rel=1e-12)
    assert bwd == pytest.approx(100 * counting.roofline_s(2 * flops, 2 * nbytes) / 5e-3,
                                rel=1e-12)
    per = w.per_step()
    assert per["frontier_width"] == 2048 and per["news"] < per["closure_news"] <= 400
    assert per["gat_rows.round2"] == per["news"] < per["gat_rows.round1"] <= per["closure_news"]
