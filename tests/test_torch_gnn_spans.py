"""The GNN's spans (``models/gnn.py``, ``utils/tracing.py``): under
``torch.profiler`` on the CPU, in a training step on the frontier feed,
``newsrec.gnn.titles``, ``newsrec.gnn.gat`` and ``newsrec.gnn.gat.backward``
lie once per step and hold the title tower's and the GAT's forward and
backward operators; with no profiler the graph gains no node and the loss,
the gradients and the scores are those of the frontier form without spans,
bit for bit."""

import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from pytorch_news_recommender_tpu_torch.config import synthetic_config
from pytorch_news_recommender_tpu_torch.data import synthetic
from pytorch_news_recommender_tpu_torch.data.loader import train_batches
from pytorch_news_recommender_tpu_torch.models.gnn import GNNRec
from pytorch_news_recommender_tpu_torch.models.layers import RankGenerator
from pytorch_news_recommender_tpu_torch.train.loop import Trainer, training_loss
from pytorch_news_recommender_tpu_torch.utils import tracing

torch.set_num_threads(2)

TITLES, GAT, BWD = "newsrec.gnn.titles", "newsrec.gnn.gat", "newsrec.gnn.gat.backward"
LAYERS = [1, 2]


@pytest.fixture(autouse=True)
def _clean():
    tracing.reset()
    yield
    tracing.reset()


def _trainer(layers: int) -> Trainer:
    cfg = synthetic_config(**{"model.name": "gnn", "model.word_embed_size": 16,
                              "model.num_attention_heads": 4, "model.user_heads_num": 4,
                              "model.query_vector_dim": 8, "model.dropout": 0.2,
                              "model.gnn_layers": layers, "model.gnn_neighbors": 4,
                              "train.batch_size": 32, "train.dedup_batches": True,
                              "train.gnn_frontier_buckets": (512,)})
    ds = synthetic.generate(cfg.data, seed=5, n_train=64, n_dev=16, n_neighbors=4)
    return Trainer(cfg, ds, device="cpu")


def _batch(tr: Trainer) -> dict:
    """The first dedup batch with its frontier, as the feed hands it over."""
    batch = next(train_batches(tr.dataset.train, tr.cfg.train.batch_size,
                               np.random.default_rng(0), dedup=True))
    return tr._maybe_frontier(batch)


def _named(events, name):
    return sorted((e for e in events if e["name"] == name and e["cat"] == "user_annotation"),
                  key=lambda e: e["ts"])


def _inside(e, r) -> bool:
    return r["ts"] <= e["ts"] and e["ts"] + e["dur"] <= r["ts"] + r["dur"]


def _node(events, name):
    return [e for e in events if e["cat"] == "cpu_op"
            and e["name"] == "autograd::engine::evaluate_function: " + name]


@pytest.mark.parametrize("layers", LAYERS)
def test_a_frontier_step_has_its_title_gat_and_backward_spans(tmp_path, layers):
    tr = _trainer(layers)
    batch = _batch(tr)
    assert "gnn_frontier_ids" in batch
    state = tr.init_state(seed=0)
    path = tmp_path / "trace.json"
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.run_step(state, batch)
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    titles, gat, bwd = (_named(events, n) for n in (TITLES, GAT, BWD))
    assert len(titles) == len(gat) == len(bwd) == 1
    (titles,), (gat,), (bwd,) = titles, gat, bwd
    assert all(r["dur"] > 0 for r in (titles, gat, bwd))
    (forward,), (backward,) = (_named(events, "newsrec.train.forward"),
                               _named(events, "newsrec.train.backward"))
    assert _inside(titles, forward) and _inside(gat, forward) and _inside(bwd, backward)
    assert titles["ts"] + titles["dur"] <= gat["ts"]
    # the GAT's operators: one leaky ReLU and one gate sigmoid a round, all
    # in the forward span; the title tower's pooling tanh in its own span,
    # the user tower's outside both
    for op in ("aten::leaky_relu", "aten::sigmoid"):
        ops = [e for e in events if e["name"] == op]
        assert len(ops) == layers and all(_inside(e, gat) for e in ops)
    tanh = [e for e in events if e["name"] == "aten::tanh"]
    assert [_inside(t, titles) for t in tanh].count(True) == 1
    assert not any(_inside(t, gat) for t in tanh)
    # their backward nodes in the backward span, the towers' tanh outside it
    for name in ("LeakyReluBackward0", "SigmoidBackward0"):
        nodes = _node(events, name)
        assert len(nodes) == layers and all(_inside(n, bwd) for n in nodes)
    # the user tower's backward comes before the GAT's, the title tower's
    # after the GAT's has left
    user_tanh, title_tanh = sorted(_node(events, "TanhBackward0"), key=lambda e: e["ts"])
    assert user_tanh["ts"] + user_tanh["dur"] <= bwd["ts"]
    assert title_tanh["ts"] >= bwd["ts"] + bwd["dur"]
    assert [s.name for s in tracing.snapshot()].count(BWD) == 1


def _plain_frontier(model, batch, news_feats, deterministic, generator):
    """The frontier form's news vectors as they read with no spans."""
    fids, nbr_pos = batch["gnn_frontier_ids"].long(), batch["gnn_nbr_pos"].long()
    titles = model.news_encoder(news_feats["title"][fids], deterministic, generator)
    mask = (fids[nbr_pos] != 0).float()
    h = titles
    for layer in reversed(model.gat_layers):
        h = layer(titles, F.embedding(nbr_pos, h), mask)
    return h[batch["gnn_self_pos"].long()]


def _step(tr, model, batch, plain: bool):
    """The loss, every gradient, the scores and the loss's graph of one
    training forward and backward at dropout 0.2."""
    model.zero_grad(set_to_none=True)
    gen = RankGenerator().manual_seed(9)
    with pytest.MonkeyPatch.context() as mp:
        if plain:
            mp.setattr(GNNRec, "_encode_frontier", _plain_frontier)
        scores = model(batch, tr.news_feats, deterministic=False, generator=gen)
    loss = training_loss(model, scores)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    return loss.detach(), grads, scores.detach(), loss.grad_fn


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


@pytest.mark.parametrize("layers", LAYERS)
def test_without_a_profiler_nothing_changes(layers):
    tr = _trainer(layers)
    batch = tr._to_device(_batch(tr))
    model = tr.init_state(seed=1).model
    loss, grads, scores, fn = _step(tr, model, batch, plain=False)
    loss0, grads0, scores0, fn0 = _step(tr, model, batch, plain=True)
    assert _graph(fn) == _graph(fn0)
    assert not any("Open" in n or "Close" in n for n in _graph(fn))
    assert grads.keys() == grads0.keys() and {f"gat{i}.wk" for i in range(layers)} <= set(grads)
    assert torch.equal(loss, loss0) and torch.equal(scores, scores0)
    assert all(torch.equal(grads[n], grads0[n]) for n in grads)
    assert tracing.snapshot() == []
    with profile(activities=[ProfilerActivity.CPU]):
        loss1, grads1, scores1, fn1 = _step(tr, model, batch, plain=False)
    assert torch.equal(loss1, loss0) and torch.equal(scores1, scores0)
    assert all(torch.equal(grads1[n], grads0[n]) for n in grads)
    assert len(_graph(fn1)) == len(_graph(fn0)) + 2
    assert [s.name for s in tracing.snapshot()].count(BWD) == 1
