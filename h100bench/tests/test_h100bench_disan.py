"""The ``disan-train-b512`` cell at a size the CPU runs in seconds: the
program against ``reference/disan.py`` (the news tower, its ten dropout
draws a call, the blocks), the ``disan`` work part and its readers, and
``correct`` against planted faults."""

import dataclasses
import itertools
import json

import numpy as np
import pytest
import torch

from h100bench import core, counting, port, reference, weights
from h100bench.reference import common as C
from h100bench.reference import disan as RD

CELL = "disan-train-b512"
SEED = 2 ** 31 + 11


def _program(cfgj, seed, compute_dtype="float32", **model):
    """The program's ``DiSANRec`` at configuration ``cfgj`` with the
    reference's seeded weights, and those weights."""
    from pytorch_news_recommender_tpu_torch.models.convert import assign
    from pytorch_news_recommender_tpu_torch.models.disan import DiSANRec

    cfgj = json.loads(json.dumps(cfgj))
    cfgj["port"]["model"].update(compute_dtype=compute_dtype, **model)
    cfg = port.config(cfgj, seed)
    W = weights.make(RD.leaves(cfgj["port"]["model"], cfgj["corpus"]), seed, "cpu")
    net = DiSANRec(dataclasses.replace(cfg.model, n_words=cfgj["corpus"]["vocab"]))
    assign(net, W)
    return net, cfgj["port"]["model"], cfg.train.seed


def _titles(n, L, vocab, seed):
    g = np.random.default_rng(seed)
    ids = g.integers(1, vocab, (n, L))
    lens = g.integers(0, L + 1, n)
    ids[np.arange(L)[None, :] >= lens[:, None]] = 0
    return torch.as_tensor(ids)


def test_the_tiny_cell_runs_correct(tiny, runner):
    out = runner(tiny, CELL)
    assert out["correct"] is True
    assert set(out["checks"]) == set(json.loads(
        (core.ROOT / "workloads" / f"{CELL}.json").read_text())["checks"])


def test_the_news_tower_equals_the_program_with_the_step_seeds(tiny):
    """Two encode calls of one step at dropout 0.2, float32 compute: the
    program's vectors equal the reference's, each call drawing the next ten
    seeds of the step's stream."""
    from pytorch_news_recommender_tpu_torch.train.loop import step_generator

    cfgj = tiny.cell(CELL).config
    net, model, train_seed = _program(cfgj, SEED, disan_hidden=24)
    W = {n: p.detach() for n, p in net.state_dict().items()}
    a = _titles(9, 7, cfgj["corpus"]["vocab"], 1)
    b = _titles(5, 12, cfgj["corpus"]["vocab"], 2)
    step = 3
    g = step_generator(train_seed + 1, step)
    with torch.no_grad():
        prog = [net.encode_news_feats({"title": t}, deterministic=False, generator=g)
                for t in (a, b)]
    seeds = C.step_seeds(train_seed, step)
    ref = [RD.encode(C.F32, W, model, {"title": t}, seeds, 0.2) for t in (a, b)]
    for p, r in zip(prog, ref):
        assert p.shape == r.shape == (len(p), 48)
        torch.testing.assert_close(p, r, rtol=0, atol=1e-5)
    # both sides have drawn twenty seeds: the next ones agree
    assert int(torch.randint(0, 2 ** 31 - 1, (), generator=g)) == next(seeds)


def test_the_program_draws_ten_seeds_a_call_in_order(tiny, monkeypatch):
    """Each dropout call of the news tower, in call order: the forward
    direction's ``x``, ``rep`` (for ``w1``/``w2``), ``rep`` (for ``wf1``),
    ``res``; the backward direction's the same; Source2Token's ``u`` and
    ``h``; each with the next seed of the step's stream."""
    from pytorch_news_recommender_tpu_torch.models import disan, layers
    from pytorch_news_recommender_tpu_torch.train.loop import step_generator

    cfgj = tiny.cell(CELL).config
    D = cfgj["port"]["model"]["word_embed_size"]
    net, _, train_seed = _program(cfgj, SEED, disan_hidden=24)
    drawn = []

    def dropout(x, rate, deterministic, generator):
        out = layers.dropout(x, rate, deterministic, generator)
        drawn.append((tuple(x.shape), torch.equal(out, x)))
        return out

    monkeypatch.setattr(disan, "dropout", dropout)
    seeds = []
    monkeypatch.setattr(layers, "draw_seed",
                        lambda g, inner=layers.draw_seed: seeds.append(inner(g)) or seeds[-1])
    ids = _titles(6, 5, cfgj["corpus"]["vocab"], 3)
    with torch.no_grad():
        for _ in range(2):
            net.encode_news_feats({"title": ids}, deterministic=False,
                                  generator=step_generator(train_seed + 1, 0))
    shapes = ([(6, 5, D)] + [(6, 5, 24)] * 3) * 2 + [(6, 5, 48)] * 2
    assert [s for s, _ in drawn] == shapes * 2
    assert not any(same for _, same in drawn)
    assert seeds == list(itertools.islice(C.step_seeds(train_seed, 0), 10)) * 2


def test_blocks_change_no_value_and_no_gradient(tiny, monkeypatch):
    cfgj = tiny.cell(CELL).config
    model = dict(cfgj["port"]["model"], disan_hidden=24)
    W = {n: t.clone().requires_grad_(True) for n, t in weights.make(
        RD.leaves(model, cfgj["corpus"]), SEED, "cpu").items()}
    ids = _titles(11, 9, cfgj["corpus"]["vocab"], 4)
    assert RD.block_items(20, 300) == (1 << 26) // (400 * 300)
    out = {}
    for items in (11, 4, 1):
        monkeypatch.setattr(RD, "BLOCK_ELEMENTS", items * 9 * 9 * 24)
        v = RD.encode(C.F32, W, model, {"title": ids}, C.step_seeds(7, 1), 0.2)
        grads = torch.autograd.grad((v * torch.linspace(-1, 1, v.numel()).view_as(v)).sum(),
                                    list(W.values()), allow_unused=True)
        out[items] = (v.detach(), grads)
    v0, g0 = out[11]
    for items in (4, 1):
        v, g = out[items]
        torch.testing.assert_close(v, v0, rtol=0, atol=1e-6)
        for name, a, b in zip(W, g, g0):
            if b is None:
                assert a is None, name
                continue
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, msg=name)


def test_the_disan_part_counts_the_formula_at_hand_worked_lengths():
    # D=4, d=2; items of 3, 5, 1 and 0 real tokens. An item of l tokens:
    # 4*l*4*2 + 32*l*4 + 2*l*(l-1)*2 + 4*l*2 = 168 l + 4 l (l-1):
    # 528 + 920 + 168 = 1616. Bytes: 9 token rows of 4 and 3 vectors of 4
    # in bfloat16, 2*(8 + 16 + 6) + 2*(16 + 4) = 100 weights: 2*(36+12+100)
    lens = {"title_len": np.array([0, 3, 5, 1, 0])}
    model = {"word_embed_size": 4, "disan_hidden": 2, "user_heads_num": 2,
             "query_vector_dim": 3}
    browsed = np.array([[0, 1, 2], [0, 0, 4]])
    cand = np.array([[3, 1], [2, 3]])
    w = counting.Work()
    counting.step_work(w, model, lens, [(browsed, cand)], reference.family("disan"))
    assert w.parts == {"disan": (1616.0, 296.0)}
    assert w.fwd_flops == counting.tower_flops(np.array([2, 1]), 4, 2, 3)
    assert w.fwd_bytes == counting.tower_bytes(np.array([2, 1]), 4, 3)
    assert w.other_flops == 2.0 * 4 * 4
    assert w.step_flops == 3 * (w.fwd_flops + w.other_flops + 1616.0)
    assert (w.news, w.news_tokens, w.history_clicks) == (4, 9, 3)
    # at the cell's widths, D = d = 300, one title of 12 words
    assert RD.disan_flops(np.array([12]), 300, 300) == (
        4 * 12 * 300 * 300 + 32 * 12 * 300 ** 2 + 2 * 12 * 11 * 300 + 4 * 12 * 300)


class _Trace:
    """2 ms of device time under the forward span, 5 under the backward's."""

    def device_s(self, pick):
        return (2e-3 if pick("newsrec.disan.encoder") else 0.0) + (
            5e-3 if pick("newsrec.disan.encoder.backward") else 0.0)


@pytest.mark.parametrize("family", ["disan", "nrms", "naml"])
def test_the_disan_rooflines_read_the_part_and_nothing_without_it(tiny, family):
    from h100bench.drivers import train as TR

    cell = {"disan": CELL, "nrms": "nrms-train-b512", "naml": "naml-train-b512"}[family]
    inp = TR.Inputs(tiny.cell(cell), 5)
    w = TR.work_of(inp, 0, 2, None)
    readers = core.Bench().metrics()
    rec = core.Record(kind="train", trace=_Trace(), work=w, step_work=w, window_s=1.0)
    fwd, bwd = (readers[n].read(rec) for n in ("disan_fwd_roofline", "disan_bwd_roofline"))
    if family != "disan":
        assert "disan" not in w.parts and fwd is None and bwd is None
        return
    flops, nbytes = w.parts["disan"]
    assert fwd == pytest.approx(100 * counting.roofline_s(flops, nbytes) / 2e-3, rel=1e-12)
    assert bwd == pytest.approx(100 * counting.roofline_s(2 * flops, 2 * nbytes) / 5e-3,
                                rel=1e-12)
    # the encoder rooflines see the user tower only
    assert w.fwd_flops == sum(counting.tower_flops(
        (inp.slices(k)[0] != 0).sum(1), 80, 4, 16) for k in range(2))


def _flip_forward_mask(monkeypatch):
    """The forward direction attends as the backward one does."""
    from pytorch_news_recommender_tpu_torch.models import disan

    inner = disan.DiSA.forward

    def forward(self, *a, **k):
        if self.direction != "fw":
            return inner(self, *a, **k)
        self.direction = "bw"
        try:
            return inner(self, *a, **k)
        finally:
            self.direction = "fw"

    monkeypatch.setattr(disan.DiSA, "forward", forward)


def _logits_in_bf16(monkeypatch):
    """The pair logits rounded to bfloat16 before the tanh."""
    from pytorch_news_recommender_tpu_torch.models import disan

    class Torch:
        def __getattr__(self, name):
            return getattr(torch, name)

        @staticmethod
        def tanh(t):
            return torch.tanh(t.to(torch.bfloat16).to(t.dtype))

    monkeypatch.setattr(disan, "torch", Torch())


def _float32_copy(bench):
    """The tiny cell with float32 compute and limits of its own. At
    bfloat16 compute the program already sums the pair products in
    bfloat16 before the float32 bias, so logits rounded to bfloat16 once
    more read as the program's own noise: over seeds 3-7 the program read
    grad_gap 3.3e-3-4.8e-3, that fault 4.6e-3-1.7e-2 (no limit between).
    In float32 the program read under 1e-5 / 5e-6 (grad_gap / update_gap,
    seeds 3-6) and that fault 3.2e-3-6.8e-3 / 6.4e-4-1.3e-3."""
    root = bench.root
    cfg = json.loads((root / "configs" / "disan-mind.json").read_text())
    cfg["port"]["model"]["compute_dtype"] = "float32"
    (root / "configs" / "disan-mind.json").write_text(json.dumps(cfg))
    cell = json.loads((root / "workloads" / f"{CELL}.json").read_text())
    cell["checks"] = {"grad_gap": 5e-4, "update_gap": 2e-4}
    (root / "workloads" / f"{CELL}.json").write_text(json.dumps(cell))


@pytest.mark.parametrize("fault,float32", [(_flip_forward_mask, False),
                                           (_flip_forward_mask, True),
                                           (_logits_in_bf16, True)])
def test_a_planted_fault_is_not_correct(tiny, runner, monkeypatch, fault, float32):
    if float32:
        _float32_copy(tiny)
        assert runner(tiny, CELL)["correct"] is True
    fault(monkeypatch)
    assert runner(tiny, CELL)["correct"] is False
