"""The port's offline BERT news vectors (``data/bert_vectors.py``) and ``cli
bert-embeds`` against the JAX package's, on a tiny randomly initialised BERT
written to a local directory (``tests/test_bert_vectors.py``'s model), so
nothing is downloaded."""

import numpy as np
import pytest
import torch
from test_mind import DEV_NEWS_TSV, NEWS_TSV

transformers = pytest.importorskip("transformers")

from pytorch_news_recommender_tpu.data import bert_vectors as jax_bv  # noqa: E402
from pytorch_news_recommender_tpu.data.mind import NewsTable as JaxNewsTable  # noqa: E402
from pytorch_news_recommender_tpu_torch import cli  # noqa: E402
from pytorch_news_recommender_tpu_torch.data import bert_vectors as bv  # noqa: E402
from pytorch_news_recommender_tpu_torch.data.mind import NewsTable  # noqa: E402

VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
         "the", "a", "news", "story", "about", "sports", "finance",
         "rocket", "launch", "win", "##s"]
TEXTS = ["the news story", "rocket launch wins", "", "a story about sports finance"]


@pytest.fixture(scope="module")
def bert(tmp_path_factory):
    """(model, tokenizer, the directory they are saved in)."""
    d = tmp_path_factory.mktemp("tiny_bert")
    (d / "vocab.txt").write_text("\n".join(VOCAB))
    tok = transformers.BertTokenizer(str(d / "vocab.txt"))
    cfg = transformers.BertConfig(
        vocab_size=len(VOCAB), hidden_size=32, num_hidden_layers=1,
        num_attention_heads=2, intermediate_size=37,
        max_position_embeddings=64)
    torch.manual_seed(0)
    model = transformers.BertModel(cfg)
    model.save_pretrained(d)
    tok.save_pretrained(d)
    return model, tok, d


@pytest.mark.parametrize("batch_size", [2, 3, 64])
def test_encode_texts_equals_jax_package(bert, batch_size):
    model, tok, _ = bert
    got = bv.encode_texts(TEXTS, model, tok, batch_size=batch_size)
    expect = jax_bv.encode_texts(TEXTS, model, tok, batch_size=batch_size)
    assert got.shape == (len(TEXTS), 32) and got.dtype == np.float32
    np.testing.assert_allclose(got, expect, rtol=1e-6, atol=1e-6)
    # batching does not change a vector (the masked mean ignores padding)
    np.testing.assert_allclose(got, bv.encode_texts(TEXTS, model, tok, batch_size=1),
                               atol=1e-5)


def test_encode_news_table_equals_jax_package(bert):
    """Zero pad row, the title/abstract mean, and the title for a missing
    abstract, as the JAX function computes them."""
    model, tok, _ = bert
    tables = []
    for cls in (NewsTable, JaxNewsTable):
        news = cls()
        news.index = {"N1": 1, "N2": 2}
        news.ids = ["N1", "N2"]
        news.title = ["the sports story", "finance news"]
        news.abstract = ["a story about sports", ""]
        tables.append(news)
    got = bv.encode_news_table(tables[0], model, tok)
    expect = jax_bv.encode_news_table(tables[1], model, tok)
    np.testing.assert_allclose(got, expect, rtol=1e-6, atol=1e-6)
    assert got.shape == (3, 32)
    np.testing.assert_array_equal(got[0], 0.0)
    title = bv.encode_texts(["finance news"], model, tok)[0]
    np.testing.assert_allclose(got[2], title, atol=1e-5)


@pytest.mark.parametrize("with_test_dir", [False, True])
def test_cli_bert_embeds_equals_jax_function(bert, tmp_path, capsys, with_test_dir):
    """``cli bert-embeds`` on the ``save_pretrained`` directory writes the
    vectors of the JAX package's ``build_bert_vectors`` (1e-6), one row per
    news of the splits in first-seen order plus the pad row."""
    _, _, model_dir = bert
    dirs = {"train": NEWS_TSV, "dev": DEV_NEWS_TSV}
    if with_test_dir:
        dirs["test"] = DEV_NEWS_TSV
    for name, tsv in dirs.items():
        (tmp_path / name).mkdir()
        (tmp_path / name / "news.tsv").write_text(tsv)
    argv = ["bert-embeds", "--train-dir", str(tmp_path / "train"),
            "--dev-dir", str(tmp_path / "dev"), "--model-path", str(model_dir),
            "--batch-size", "4", "--out", str(tmp_path / "port" / "news_embeds_32.npz"),
            "--device", "cpu"]
    if with_test_dir:
        argv[5:5] = ["--test-dir", str(tmp_path / "test")]
    assert cli.main(argv) == 0
    assert "news vectors" in capsys.readouterr().out
    got = np.load(tmp_path / "port" / "news_embeds_32.npz")["embeddings"]
    expect = jax_bv.build_bert_vectors(
        [tmp_path / name / "news.tsv" for name in dirs], str(model_dir),
        tmp_path / "jax.npz", batch_size=4)
    np.testing.assert_allclose(got, expect, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, np.load(tmp_path / "jax.npz")["embeddings"],
                               rtol=1e-6, atol=1e-6)
    assert got.shape == (7, 32) and np.all(got[0] == 0) and np.all(np.isfinite(got))


def _news_dirs(tmp_path):
    for name, tsv in (("train", NEWS_TSV), ("dev", DEV_NEWS_TSV)):
        (tmp_path / name).mkdir()
        (tmp_path / name / "news.tsv").write_text(tsv)
    return ["--train-dir", str(tmp_path / "train"), "--dev-dir", str(tmp_path / "dev")]


def test_cli_bert_embeds_runs_on_the_card_by_default(bert, tmp_path, monkeypatch):
    """Without ``--device`` the command runs on the CUDA card, and raises
    where there is none, as every command that runs a model does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["bert-embeds", *_news_dirs(tmp_path), "--model-path", str(bert[2]),
                  "--out", str(tmp_path / "v.npz")])
    assert not (tmp_path / "v.npz").exists()


def test_cli_bert_embeds_on_card_equals_cpu(bert, tmp_path):
    """On the card (the default device) the command writes the CPU run's
    vectors, to float32 rounding."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    argv = ["bert-embeds", *_news_dirs(tmp_path), "--model-path", str(bert[2])]
    assert cli.main([*argv, "--out", str(tmp_path / "card.npz")]) == 0
    assert cli.main([*argv, "--out", str(tmp_path / "cpu.npz"), "--device", "cpu"]) == 0
    got, expect = (np.load(tmp_path / f)["embeddings"] for f in ("card.npz", "cpu.npz"))
    assert got.shape == expect.shape == (7, 32)
    np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-5)
