"""The port's numpy copies for training (``data/loader.py``,
``train/metrics.py``) against the JAX package's originals, and its device
prefetch on the CPU."""

import numpy as np
import pytest
import torch

from pytorch_news_recommender_tpu.data import loader as jax_loader
from pytorch_news_recommender_tpu.data import synthetic as jax_synthetic
from pytorch_news_recommender_tpu.config import synthetic_config as jax_synthetic_config
from pytorch_news_recommender_tpu.train import metrics as jax_metrics
from pytorch_news_recommender_tpu_torch.config import synthetic_config
from pytorch_news_recommender_tpu_torch.data import loader, synthetic
from pytorch_news_recommender_tpu_torch.data.prefetch import device_prefetch
from pytorch_news_recommender_tpu_torch.train import metrics

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def datasets():
    """The same seeded synthetic corpus from both packages, with MIND-like
    title lengths so that both the short and the long block are used."""
    kw = dict(seed=3, n_train=256, n_dev=40, title_len=(11.5, 4))
    return (synthetic.generate(synthetic_config().data, **kw),
            jax_synthetic.generate(jax_synthetic_config().data, **kw))


def _split(mod, ds, thr=12):
    lens = {"title": (ds.news.title != 0).sum(axis=1).astype(np.int32)}
    return mod.LengthSplit(feat_lens=lens, thresholds={"title": thr})


def _assert_same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a[k].dtype == b[k].dtype, k


@pytest.mark.parametrize("form", ["plain", "split", "all_short", "direct"])
def test_dedup_batch_equals_jax(datasets, form):
    ds, jds = datasets
    batch = {"browsed_ids": ds.train.browsed_ids[:32],
             "candidate_ids": ds.train.candidate_ids[:32]}
    kw = {}
    if form == "split":
        kw = dict(length_split=_split(loader, ds)), dict(length_split=_split(jax_loader, jds))
    elif form == "all_short":
        # every title fits the cutoff: the long block is empty
        kw = (dict(length_split=_split(loader, ds, 20)),
              dict(length_split=_split(jax_loader, jds, 20)))
    elif form == "direct":
        kw = dict(buckets=(4096,)), dict(buckets=(4096,))
    else:
        kw = {}, {}
    got = loader.dedup_batch(batch, **kw[0])
    expect = jax_loader.dedup_batch(batch, **kw[1])
    _assert_same(got, expect)
    if form == "split":
        assert 0 < got["short_mark"].shape[0] < got["unique_ids"].shape[0]
    if form == "all_short":
        assert got["short_mark"].shape[0] == got["unique_ids"].shape[0]
    if form == "direct":
        assert "unique_ids" not in got


def test_train_batches_order_equals_jax(datasets):
    ds, jds = datasets
    got = list(loader.train_batches(ds.train, 64, np.random.default_rng(4), dedup=True,
                                    length_split=_split(loader, ds)))
    expect = list(jax_loader.train_batches(jds.train, 64, np.random.default_rng(4),
                                           dedup=True,
                                           length_split=_split(jax_loader, jds)))
    assert len(got) == len(expect) == 4
    for a, b in zip(got, expect):
        _assert_same(a, b)


def test_eval_batches_and_pad_batch_equal_jax(datasets):
    ds, jds = datasets
    got = list(loader.eval_batches(ds.dev, 16, (8, 16, 32), max_impressions=35))
    expect = list(jax_loader.eval_batches(jds.dev, 16, (8, 16, 32), max_impressions=35))
    assert len(got) == len(expect)
    for a, b in zip(got, expect):
        _assert_same(a.batch, b.batch)
        np.testing.assert_array_equal(a.impression_ids, b.impression_ids)
        np.testing.assert_array_equal(a.n_candidates, b.n_candidates)
        pa, na = loader.pad_batch(a.batch, 16)
        pb, nb = jax_loader.pad_batch(b.batch, 16)
        assert na == nb
        _assert_same(pa, pb)


def test_metrics_equal_jax():
    rng = np.random.default_rng(9)
    labels, scores = [], []
    for _ in range(60):
        n = int(rng.integers(2, 30))
        y = (rng.random(n) < 0.3).astype(np.int8)
        s = np.round(rng.normal(size=n), 1)  # ties included
        labels.append(y)
        scores.append(s)
    assert metrics.aggregate_metrics(labels, scores) == \
        jax_metrics.aggregate_metrics(labels, scores)
    assert metrics.impression_metrics(labels[0], scores[0]) == \
        jax_metrics.impression_metrics(labels[0], scores[0])


def test_prefetch_on_cpu_yields_the_batches(datasets):
    ds, _ = datasets
    host = list(loader.train_batches(ds.train, 64, np.random.default_rng(1), dedup=True))
    got = list(device_prefetch(iter(host), torch.device("cpu")))
    assert len(got) == len(host)
    for a, b in zip(got, host):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k].numpy(), b[k])
