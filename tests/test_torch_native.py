"""The port's C++ fast path (``native/``) against its numpy and pure-Python
paths and against the JAX package's functions on the same inputs, bit for
bit (the port's copy of ``tests/test_native.py``). ``g++`` builds the
library into ``build/native/`` at the first call."""

import numpy as np
import pytest
from test_mind import DEV_BEHAVIORS, DEV_NEWS_TSV, NEWS_TSV, TRAIN_BEHAVIORS

from pytorch_news_recommender_tpu import native as jnative
from pytorch_news_recommender_tpu.data import loader as jloader
from pytorch_news_recommender_tpu.data import mind as jmind
from pytorch_news_recommender_tpu_torch import native
from pytorch_news_recommender_tpu_torch.config import DataConfig
from pytorch_news_recommender_tpu_torch.data import loader, mind


@pytest.fixture()
def fixture_dirs(tmp_path):
    for name, news_txt, beh in [("train", NEWS_TSV, TRAIN_BEHAVIORS),
                                ("dev", DEV_NEWS_TSV, DEV_BEHAVIORS)]:
        d = tmp_path / name
        d.mkdir()
        (d / "news.tsv").write_text(news_txt)
        (d / "behaviors.tsv").write_text(beh)
    return tmp_path


@pytest.fixture()
def cfg():
    return DataConfig(history_len=6, sample_size=2, min_history=3,
                      word_freq_threshold=2)


@pytest.fixture(autouse=True)
def built():
    """The library builds here (g++ is installed); a test that found it
    missing would check nothing."""
    assert native.available(), "the native library did not build"
    assert native.BUILD_DIR.name == "native" and native.BUILD_DIR.parent.name == "build"


def _indexes(fixture_dirs):
    news = mind.NewsTable()
    news.add_split(fixture_dirs / "train" / "news.tsv")
    news.add_split(fixture_dirs / "dev" / "news.tsv")
    users = mind.collect_users([fixture_dirs / "train" / "behaviors.tsv",
                                fixture_dirs / "dev" / "behaviors.tsv"])
    return news.index, users


def test_train_bit_identical(fixture_dirs, cfg):
    news_idx, users = _indexes(fixture_dirs)
    path = fixture_dirs / "train" / "behaviors.tsv"
    py = mind.build_train_samples(path, news_idx, users, cfg, seed=2020)
    got = native.build_train_samples(path, news_idx, users, cfg.history_len,
                                     cfg.sample_size, cfg.min_history, 2020)
    ref = jnative.build_train_samples(path, news_idx, users, cfg.history_len,
                                      cfg.sample_size, cfg.min_history, 2020)
    for a, p, r in zip(got, (py.browsed_ids, py.candidate_ids, py.user_ids), ref):
        np.testing.assert_array_equal(a, p)
        np.testing.assert_array_equal(a, r)


def test_eval_bit_identical(fixture_dirs, cfg):
    news_idx, users = _indexes(fixture_dirs)
    path = fixture_dirs / "dev" / "behaviors.tsv"
    py = mind.build_eval_split(path, news_idx, users, cfg, with_labels=True)
    got = native.build_eval_split(path, news_idx, users, cfg.history_len, True)
    ref = jnative.build_eval_split(path, news_idx, users, cfg.history_len, True)
    for a, p, r in zip(got, (py.browsed_ids, py.user_ids, py.impression_keys,
                             py.offsets, py.cand_flat, py.label_flat), ref):
        np.testing.assert_array_equal(a, p)
        np.testing.assert_array_equal(a, r)


def test_build_dataset_native_matches_python(fixture_dirs, cfg):
    """Train groups, eval splits and the title/abstract word ids of
    ``build_dataset`` are the same arrays on both paths, and the JAX
    package's native build's."""
    a = mind.build_dataset(cfg, fixture_dirs / "train", fixture_dirs / "dev",
                           use_native=True)
    b = mind.build_dataset(cfg, fixture_dirs / "train", fixture_dirs / "dev",
                           use_native=False)
    j = jmind.build_dataset(cfg, fixture_dirs / "train", fixture_dirs / "dev",
                            use_native=True)
    for got in (a, j):
        for split, keys in (("train", ("browsed_ids", "candidate_ids", "user_ids")),
                            ("dev", ("browsed_ids", "cand_flat", "label_flat",
                                     "offsets", "impression_keys"))):
            for k in keys:
                np.testing.assert_array_equal(getattr(getattr(got, split), k),
                                              getattr(getattr(b, split), k), err_msg=k)
        np.testing.assert_array_equal(got.news.title, b.news.title)
        np.testing.assert_array_equal(got.news.abst, b.news.abst)


def test_batch_dedup_bit_identical():
    """The C++ dedup equals ``np.unique(..., return_inverse=True)`` and the
    JAX package's C++ dedup over 50 random batches."""
    rng = np.random.default_rng(7)
    for _ in range(50):
        nb, nc = int(rng.integers(1, 512)), int(rng.integers(1, 64))
        hi = int(rng.integers(2, 3000))
        browsed = rng.integers(0, hi, size=(nb,)).astype(np.int32)
        cand = rng.integers(0, hi, size=(nc,)).astype(np.int32)
        u, uniq, bidx, cidx = native.batch_dedup(browsed, cand)
        ref_u, ref_inv = np.unique(
            np.concatenate([np.zeros(1, np.int32), browsed, cand]), return_inverse=True)
        assert u == len(ref_u)
        np.testing.assert_array_equal(uniq[:u], ref_u)
        np.testing.assert_array_equal(uniq[u:], 0)
        np.testing.assert_array_equal(bidx, ref_inv[1:1 + nb])
        np.testing.assert_array_equal(cidx, ref_inv[1 + nb:])
        for a, r in zip((u, uniq, bidx, cidx), jnative.batch_dedup(browsed, cand)):
            np.testing.assert_array_equal(a, r)


def test_dedup_batch_native_matches_numpy(monkeypatch):
    """``loader.dedup_batch`` gives the same batch with and without the C++
    dedup, and the JAX loader's, with a length split too."""
    rng = np.random.default_rng(3)
    batch = {
        "browsed_ids": rng.integers(0, 500, size=(64, 50)).astype(np.int32),
        "candidate_ids": rng.integers(0, 500, size=(64, 6)).astype(np.int32),
        "user_ids": rng.integers(0, 99, size=(64,)).astype(np.int32),
    }
    lens = rng.integers(1, 21, size=500).astype(np.int32)
    split = loader.LengthSplit({"title": lens}, {"title": 12}, grid=64)
    jsplit = jloader.LengthSplit({"title": lens}, {"title": 12}, grid=64)
    for ls, jls in ((None, None), (split, jsplit)):
        with_native = loader.dedup_batch(batch, buckets=(1024,), length_split=ls)
        ref = jloader.dedup_batch(batch, buckets=(1024,), length_split=jls)
        with monkeypatch.context() as m:
            m.setattr(native, "available", lambda: False)
            without = loader.dedup_batch(batch, buckets=(1024,), length_split=ls)
        assert sorted(with_native) == sorted(without) == sorted(ref)
        for k in with_native:
            np.testing.assert_array_equal(with_native[k], without[k])
            np.testing.assert_array_equal(with_native[k], ref[k])


def test_tokenize_ids_bit_identical():
    """The C++ ASCII tokenizer with the Python fallback reproduces the Python
    id conversion (lowercase, digits deleted so that 'ab1cd' -> 'abcd',
    ``\\w+`` tokens, in-vocab filter, truncate and pad) and the JAX
    package's ``ids_matrix``."""
    vocab = {"covid": 1, "vaccine": 2, "abcd": 3, "team": 4, "big_win": 5,
             "ole": 6, "game": 7}
    texts = ["Covid19 vaccine rollout 2020", "ab1cd plays 99 the game",
             "Team BIG_WIN again, team!", "", "12345", "sølvgutten Ole",
             "team " * 40]
    for length in (4, 20):
        got = mind.ids_matrix(texts, vocab, length, native_mod=native)
        expect = np.zeros((len(texts) + 1, length), np.int32)
        for i, t in enumerate(texts):
            expect[i + 1] = mind._to_ids(t, vocab, length)
        np.testing.assert_array_equal(got, expect)
        np.testing.assert_array_equal(got, mind.ids_matrix(texts, vocab, length))
        np.testing.assert_array_equal(
            got, jmind.ids_matrix(texts, vocab, length, native_mod=jnative))
    # the C++ call flags exactly the non-ASCII row for the fallback
    _, fb = native.tokenize_ids(texts, vocab, 8)
    assert list(np.nonzero(fb)[0]) == [5]


def test_library_builds_into_build_native_and_rebuilds_when_stale(tmp_path, monkeypatch):
    """A fresh build directory gets the library at the first call, and a
    source newer than the library builds it again."""
    lib = tmp_path / "build" / "native" / "libmind_native.so"
    monkeypatch.setattr(native, "BUILD_DIR", lib.parent)
    monkeypatch.setattr(native, "_LIB", lib)
    assert native._build() is None and lib.exists()
    stamp = lib.stat().st_mtime
    assert native._build() is None and lib.stat().st_mtime == stamp  # up to date
    src = tmp_path / "mind_native.cpp"
    src.write_bytes(native._SRC.read_bytes())
    monkeypatch.setattr(native, "_SRC", src)
    import os
    os.utime(src, (stamp + 10, stamp + 10))
    assert native._build() is None and lib.stat().st_mtime > stamp
    assert not list(lib.parent.glob(".libmind_native.*"))  # no temp file left
