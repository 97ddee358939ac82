"""The DiSAN news tower's spans (``models/disan.py``, ``utils/tracing.py``):
under ``torch.profiler`` on the CPU, ``newsrec.disan.encoder`` and
``newsrec.disan.encoder.backward`` lie once per encode call of a training
step and hold the tower's forward and backward operators, the backward
range closing with frozen word embeddings too and at the end of a backward
that never reaches the tower's input; with no profiler the graph gains no
node and the outputs and gradients are those of the tower without spans,
bit for bit."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pytorch_news_recommender_tpu_torch.config import synthetic_config
from pytorch_news_recommender_tpu_torch.data import synthetic
from pytorch_news_recommender_tpu_torch.data.loader import train_batches
from pytorch_news_recommender_tpu_torch.models.disan import DiSANRec
from pytorch_news_recommender_tpu_torch.models.layers import RankGenerator
from pytorch_news_recommender_tpu_torch.train.loop import Trainer
from pytorch_news_recommender_tpu_torch.utils import tracing

torch.set_num_threads(2)

FWD, BWD = "newsrec.disan.encoder", "newsrec.disan.encoder.backward"
PARTS = ("newsrec.disan.fw", "newsrec.disan.bw", "newsrec.disan.source2token")


@pytest.fixture(autouse=True)
def _clean():
    tracing.reset()
    yield
    tracing.reset()


def _trainer(freeze: bool) -> Trainer:
    cfg = synthetic_config(**{"model.name": "disan", "model.word_embed_size": 16,
                              "model.dropout": 0.2, "model.short_title_len": 8,
                              "model.freeze_word_embeddings": freeze,
                              "train.batch_size": 32, "train.dedup_batches": True})
    ds = synthetic.generate(cfg.data, seed=5, n_train=64, n_dev=16, title_len=(9.0, 4))
    return Trainer(cfg, ds, device="cpu")


def _profiled_step(tr: Trainer, path, monkeypatch):
    """One ``run_step`` under a CPU profiler: (the exported trace's complete
    events, the news tower's encode calls)."""
    calls = []
    inner = DiSANRec.encode_news_feats

    def encode(self, feats, *a, **k):
        calls.append(tuple(feats["title"].shape))
        return inner(self, feats, *a, **k)

    monkeypatch.setattr(DiSANRec, "encode_news_feats", encode)
    state = tr.init_state(seed=0)
    batch = next(train_batches(tr.dataset.train, tr.cfg.train.batch_size,
                               np.random.default_rng(0), dedup=True,
                               length_split=tr._length_split))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.run_step(state, batch)
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    return events, calls


def _named(events, name):
    return sorted((e for e in events if e["name"] == name and e["cat"] == "user_annotation"),
                  key=lambda e: e["ts"])


def _inside(e, r) -> bool:
    return r["ts"] <= e["ts"] and e["ts"] + e["dur"] <= r["ts"] + r["dur"]


@pytest.mark.parametrize("freeze", [False, True])
def test_each_encode_call_has_its_forward_and_backward_span(tmp_path, monkeypatch, freeze):
    events, calls = _profiled_step(_trainer(freeze), tmp_path / "trace.json", monkeypatch)
    fwd, bwd = _named(events, FWD), _named(events, BWD)
    assert len(calls) == 2 and calls[0][1] < calls[1][1]   # the short and the long block
    assert len(fwd) == len(bwd) == len(calls)
    assert all(r["dur"] > 0 for r in fwd + bwd)
    # the forward ranges lie in the step's forward, the backward ranges in
    # its backward, each holding its own operators
    (forward,), (backward,) = _named(events, "newsrec.train.forward"), _named(
        events, "newsrec.train.backward")
    assert all(_inside(r, forward) for r in fwd) and all(_inside(r, backward) for r in bwd)
    for part in PARTS:
        spans = _named(events, part)
        assert len(spans) == len(fwd) and all(_inside(s, r) for s, r in zip(spans, fwd))
    # each direction's tanh lies in its span; the user tower's tanh outside
    tanh = [e for e in events if e["name"] == "aten::tanh"]
    for part in PARTS[:2]:
        assert [sum(_inside(t, s) for t in tanh) for s in _named(events, part)] == [1] * len(fwd)
    # the tower's backward nodes: per call two directions' tanh, softmax,
    # elu and sigmoid, Source2Token's softmax and elu (the user tower's
    # tanh and softmax lie outside)
    nodes = [e for e in events if e["cat"] == "cpu_op" and e["name"].startswith(
        "autograd::engine::evaluate_function: ") and e["name"].endswith(
        ("TanhBackward0", "SoftmaxBackward0", "EluBackward0", "SigmoidBackward0"))]
    inside = [n for n in nodes if any(_inside(n, r) for r in bwd)]
    assert len(inside) == 10 * len(bwd)
    assert all(n in inside for n in nodes if n["name"].endswith(("EluBackward0",
                                                                  "SigmoidBackward0")))
    # the ranges of two calls do not overlap
    assert fwd[0]["ts"] + fwd[0]["dur"] <= fwd[1]["ts"]
    assert bwd[0]["ts"] + bwd[0]["dur"] <= bwd[1]["ts"]


def _tower():
    torch.manual_seed(0)
    tr = _trainer(False)
    net = tr.init_state(seed=1).model
    ids = torch.as_tensor(tr.dataset.news.title[1:7])
    return net, {"title": ids}


def _plain(net, feats, generator):
    """The tower as it reads with no spans."""
    ids = feats["title"]
    mask = (ids != 0).float()
    x = net.word_embedding(ids, mask)
    *lead, L, D = x.shape
    x, mask = x.reshape(-1, L, D), mask.reshape(-1, L)
    enc = net.disan
    u = torch.cat([enc.fw(x, mask, False, generator), enc.bw(x, mask, False, generator)], -1)
    return enc.source2token(u, mask, False, generator).reshape(*lead, 2 * net.d_h)


def _run(net, feats, fn):
    net.zero_grad(set_to_none=True)
    out = fn(net, feats, RankGenerator().manual_seed(9))
    (out * torch.linspace(-1, 1, out.numel()).view_as(out)).sum().backward()
    grads = {n: p.grad.clone() for n, p in net.named_parameters() if p.grad is not None}
    return out.detach(), grads, out.grad_fn


def _graph(fn) -> list:
    seen, todo, names = set(), [fn], []
    while todo:
        f = todo.pop()
        if f is None or f in seen:
            continue
        seen.add(f)
        names.append(type(f).__name__)
        todo += [g for g, _ in f.next_functions]
    return sorted(names)


def test_without_a_profiler_nothing_changes():
    net, feats = _tower()
    encode = lambda n, f, g: n.encode_news_feats(f, False, g)  # noqa: E731
    out, grads, fn = _run(net, feats, encode)
    out0, grads0, fn0 = _run(net, feats, _plain)
    assert _graph(fn) == _graph(fn0)
    assert not any("Open" in n or "Close" in n for n in _graph(fn))
    assert grads.keys() == grads0.keys() and len(grads) == 21   # the tower's and the table's
    assert torch.equal(out, out0) and all(torch.equal(grads[n], grads0[n]) for n in grads)
    assert tracing.snapshot() == []
    with profile(activities=[ProfilerActivity.CPU]):
        out1, grads1, fn1 = _run(net, feats, encode)
    assert torch.equal(out1, out0) and all(torch.equal(grads1[n], grads0[n]) for n in grads)
    assert len(_graph(fn1)) == len(_graph(fn0)) + 2
    assert [s.name for s in tracing.snapshot()].count(BWD) == 1


def test_a_backward_that_stops_inside_the_tower_closes_its_span():
    net, feats = _tower()
    with profile(activities=[ProfilerActivity.CPU]):
        out = net.encode_news_feats(feats, False, RankGenerator().manual_seed(9))
        torch.autograd.grad(out.sum(), [net.disan.source2token.fc2.kernel])
    spans = [s for s in tracing.snapshot() if s.name == BWD]
    assert len(spans) == 1 and spans[0].end_ns > spans[0].start_ns
