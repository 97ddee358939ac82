"""The port's numpy data layer and config against the JAX package's."""

import dataclasses

import numpy as np
import torch

from pytorch_news_recommender_tpu import config as jcfg
from pytorch_news_recommender_tpu.data import mind as jmind
from pytorch_news_recommender_tpu.data import synthetic as jsyn
from pytorch_news_recommender_tpu_torch import config as tcfg
from pytorch_news_recommender_tpu_torch.data import mind as tmind
from pytorch_news_recommender_tpu_torch.data import synthetic as tsyn
from pytorch_news_recommender_tpu_torch.data.dataset import RecDataset

torch.set_num_threads(1)


def _assert_same_arrays(a, b):
    assert type(a).__name__ == type(b).__name__
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x is None or y is None:
            assert x is None and y is None, f.name
        elif dataclasses.is_dataclass(x):
            _assert_same_arrays(x, y)
        elif isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


def test_synthetic_generate_gives_identical_arrays():
    kw = dict(seed=7, n_news=300, n_train=64, n_dev=16, n_test=8,
              bert_dim=16, n_users=20, n_neighbors=4, n_entities=12,
              title_len=(11.5, 3.0))
    j = jsyn.generate(jcfg.synthetic_config().data, **kw)
    t = tsyn.generate(tcfg.synthetic_config().data, **kw)
    for part in ("news", "train", "dev", "test"):
        _assert_same_arrays(getattr(j, part), getattr(t, part))
    np.testing.assert_array_equal(j.entity_embeddings, t.entity_embeddings)
    assert dataclasses.asdict(j.meta) == dataclasses.asdict(t.meta)


def test_config_loads_a_jax_config_json(tmp_path):
    j = jcfg.synthetic_config(**{"model.word_embed_size": 96,
                                 "train.eval_encode_chunk": 128})
    j.save(tmp_path / "config.json")
    t = tcfg.Config.load(tmp_path / "config.json")
    assert t.to_dict() == j.to_dict()
    assert tcfg.large_config().to_dict() == jcfg.large_config().to_dict()


def test_dataset_save_load_roundtrip(tmp_path):
    ds = tsyn.generate(tcfg.synthetic_config().data, seed=2, n_train=32, n_dev=8)
    ds.dicts = {"word": {"alpha": 1, "beta": 2}}
    ds.save(tmp_path)
    back = RecDataset.load(tmp_path)
    for part in ("news", "train", "dev"):
        _assert_same_arrays(getattr(ds, part), getattr(back, part))
    assert back.dicts == ds.dicts and back.meta == ds.meta


def test_tokenizer_matches_jax_package():
    vocab = {"election": 1, "game": 2, "tonight": 3, "stocks": 4}
    for text in ("Election game tonight 2024", "STOCKS: up 3%, game-7!", ""):
        assert tmind.tokenize(text) == jmind.tokenize(text)
        assert tmind._to_ids(text, vocab, 5) == jmind._to_ids(text, vocab, 5)
