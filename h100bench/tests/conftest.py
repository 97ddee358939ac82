"""Shared pieces of the benchmark's own tests: the ``card`` marker, the
checkout on the path, and a tiny copy of the benchmark's data files that
runs its cells on the CPU in seconds."""

from __future__ import annotations

import json
import pathlib
import sys
import time

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT.parent))

from h100bench import core  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    """Skips the test unless a CUDA card is present."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _shrink(kind: str, d: dict) -> dict:
    """The same file at a size the CPU runs in seconds; every other field
    as committed."""
    if kind == "configs":
        d["port"]["model"].update(word_embed_size=40, num_attention_heads=4, user_heads_num=4,
                                  query_vector_dim=16, query_vector_dim_large=24,
                                  cate_embed_size=8)
        d["port"]["data"]["history_len"] = 10
        d["port"]["train"]["batch_size"] = 128
        c = d["corpus"]
        c.update(n_news=400, vocab=300)
        if "n_categories" in c:
            c.update(n_categories=6, n_subcategories=9)
    elif kind == "traffic":
        d["history_len"].update(lo=1, median=5, hi=10)
        if "impressions" in d:
            d["impressions"] = 1024
            d["ranks"] = min(int(d.get("ranks", 1)), 2)
        if "rate_per_s" in d:
            d["rate_per_s"] = 40
            d["candidates"]["hi"] = 40
    elif kind == "workloads":
        d.update(warmup_steps=4, trace_steps=2, chips=min(int(d["chips"]), 2))
        if d["driver"] == "train":
            # this size's own limits for the numbers the cell compares
            # (gradient / change / median leaf's change, each leaf over its
            # own norm): on the CPU at D=40 the program read up to 2.1e-2 /
            # 7.9e-2 / 1.7e-3 over 15 seeds of each configuration, the fp8
            # control at least 4.6e-2 / 2.6e-2 / 6.0e-3, half of each batch
            # left out at least 0.41 / 9.4e-2 / 2.5e-2 (3 seeds), a state
            # left unchanged 1 on the change
            tiny = {"grad_gap": 0.04, "update_gap": 0.25, "update_gap_median": 0.004}
            d["checks"] = {k: tiny[k] for k in d["checks"]}
    return d


def tiny_bench(dst: pathlib.Path) -> core.Bench:
    """A copy of the benchmark's configuration, traffic and workload files
    under ``dst``, shrunk by :func:`_shrink`, with the committed metric
    readers."""
    for kind in ("configs", "traffic", "workloads"):
        (dst / kind).mkdir(parents=True)
        for f in (ROOT / kind).glob("*.json"):
            d = _shrink(kind, json.loads(f.read_text()))
            (dst / kind / f.name).write_text(json.dumps(d))
    (dst / "metrics").symlink_to(ROOT / "metrics")
    return core.Bench(dst)


@pytest.fixture
def tiny(tmp_path):
    return tiny_bench(tmp_path / "bench")


def run_cell(bench: core.Bench, name: str, seed: int = 2 ** 31 + 7, seconds: float = 1.0,
             trace: bool = False, hook=None) -> dict:
    """One run of cell ``name`` on the CPU, past the look for a card;
    returns the parsed result line."""
    from h100bench import run as R

    ctx = R.Context(bench, bench.cell(name), seed, seconds, trace, "cpu", time.time(), hook)
    line, _ = R.execute(ctx)
    return json.loads(line)


@pytest.fixture
def runner():
    """:func:`run_cell`."""
    return run_cell
