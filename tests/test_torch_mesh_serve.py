"""The row-sharded corpus cache (``Recommender(mesh=...)``) on the CPU: eight
blocks on the host, against the JAX package's ``Recommender`` on its
8-device mesh (``tests/test_serve.py::test_mesh_serve_mode``) and the port's
single-device ``Recommender``, in both cache modes, before and after
``add_news`` grows the table. The corpus (401 rows) is not a multiple of
the eight blocks, so the pad path runs."""

import jax
import numpy as np
import pytest
import torch

from pytorch_news_recommender_tpu.config import MeshConfig as JaxMeshConfig
from pytorch_news_recommender_tpu.parallel.mesh import make_mesh as jax_make_mesh
from pytorch_news_recommender_tpu.serve import Recommender as JaxRecommender
from pytorch_news_recommender_tpu_torch.config import MeshConfig
from pytorch_news_recommender_tpu_torch.parallel.mesh import make_mesh
from pytorch_news_recommender_tpu_torch.serve import Recommender
from test_torch_serve import TOL, _assert_topk_equal, _jax_ds, _requests, served  # noqa: F401

torch.set_num_threads(1)
MODES = ("native", "int8")


def _three(served, mode):
    """(JAX mesh recommender, port mesh recommender, port single-device
    recommender) in cache mode ``mode``."""
    jrec, rec, ds, state = served
    jm = JaxRecommender(jrec.cfg, _jax_ds(ds), jrec.params, corpus_cache=mode,
                        mesh=jax_make_mesh(JaxMeshConfig()))
    mesh = make_mesh(MeshConfig(), ["cpu"] * 8)
    return (jm, Recommender(rec.cfg, ds, state, corpus_cache=mode, mesh=mesh),
            Recommender(rec.cfg, ds, state, corpus_cache=mode, device="cpu"))


def _tables(rec):
    """The cache's tables as lists of row blocks."""
    return (rec.q_blocks, rec.scale_blocks) if rec.corpus_cache == "int8" else (rec.vec_blocks,)


def _wholes(rec):
    """The cache's whole tables."""
    return (rec.news_q, rec.news_scale) if rec.corpus_cache == "int8" else (rec.news_vecs,)


@pytest.mark.parametrize("mode", MODES)
def test_cache_is_split_into_zero_padded_row_blocks(served, mode):
    """Eight contiguous blocks of 51 rows (401 rows padded to 408 with
    zeros, never replicated), one per mesh device, that join to the
    single-device table."""
    _, rec_m, rec_1 = _three(served, mode)
    assert rec_m.block_rows == 51 and rec_m.n_news == rec_1.n_news == 401
    for blocks, whole in zip(_tables(rec_m), _wholes(rec_1)):
        assert len(blocks) == 8 and all(b.shape[0] == 51 for b in blocks)
        assert all(b.device == torch.device("cpu") for b in blocks)
        joined = torch.cat(blocks)
        torch.testing.assert_close(joined[:401], whole, rtol=0, atol=0)
        assert not joined[401:].any()


@pytest.mark.parametrize("mode", MODES)
def test_single_device_cache_is_one_block(served, mode):
    """Without a mesh the cache is one block of every row on the
    recommender's device, and the whole tables are that block itself; a
    mesh recommender's whole tables join its blocks, pad rows included."""
    _, rec_m, rec_1 = _three(served, mode)
    assert rec_1.block_rows == rec_1.n_news == 401
    for blocks, whole, joined in zip(_tables(rec_1), _wholes(rec_1), _wholes(rec_m)):
        assert len(blocks) == 1 and whole is blocks[0] and whole.shape[0] == 401
        assert joined.shape[0] == 408
        torch.testing.assert_close(joined[:401], whole, rtol=0, atol=0)
    other = rec_1.news_q if mode == "native" else rec_1.news_vecs
    assert other is None


@pytest.mark.parametrize("mode", MODES)
def test_score_and_score_many_match(served, mode):
    """``score`` and ``score_many`` equal the single-device recommender's bit
    for bit (the same rows, gathered from their blocks) and the JAX mesh
    recommender's (1e-4)."""
    jm, rec_m, rec_1 = _three(served, mode)
    reqs = _requests(served[2])
    for hist, cands, _ in reqs:
        got = rec_m.score(hist, cands)
        np.testing.assert_array_equal(got, rec_1.score(hist, cands))
        np.testing.assert_allclose(got, jm.score(hist, cands),
                                   **(TOL if mode == "native" else dict(rtol=1e-3, atol=1e-3)))
    for got, one in zip(rec_m.score_many(reqs), rec_1.score_many(reqs)):
        np.testing.assert_array_equal(got, one)


@pytest.mark.parametrize("mode", MODES)
def test_top_k_matches(served, mode):
    """``top_k`` over the blocks: ids equal the single-device and the JAX
    mesh recommender's (where their scores do not tie), scores 1e-4."""
    jm, rec_m, rec_1 = _three(served, mode)
    for hist, _, _ in _requests(served[2])[1:4]:
        got = rec_m.top_k(hist, 10)
        _assert_topk_equal(got, rec_1.top_k(hist, 10))
        if mode == "native":
            _assert_topk_equal(got, jm.top_k(hist, 10))
        else:
            np.testing.assert_array_equal(got[0], rec_1.top_k(hist, 10)[0])


@pytest.mark.parametrize("mode", MODES)
def test_add_news_across_a_growth(served, mode):
    """Nine fresh news fill the last block's pad rows (401..407) and pass
    the end of the table: the blocks grow by ``GROW_BLOCK`` rows and split
    again; every answer still equals the single-device recommender's, and
    the JAX mesh recommender's ids."""
    jm, rec_m, rec_1 = _three(served, mode)
    words = list(served[2].dicts["word"])
    ids = []
    for i in range(9):
        title = " ".join(words[3 * i:3 * i + 3])
        nid = rec_m.add_news(title)
        assert nid == rec_1.add_news(title) == jm.add_news(title) == 401 + i
        ids.append(nid)
        if i == 6:
            assert rec_m.block_rows == 51
    assert rec_m.block_rows == (408 + rec_m.GROW_BLOCK) // 8 and rec_m.n_news == 410
    for blocks, whole in zip(_tables(rec_m), _wholes(rec_1)):
        torch.testing.assert_close(torch.cat(blocks)[:410], whole[:410], rtol=0, atol=0)
    for hist in ([5, ids[0], ids[-1]], [ids[7], 9, 11, ids[8]]):
        cands = ids + [7, 8]
        np.testing.assert_array_equal(rec_m.score(hist, cands), rec_1.score(hist, cands))
        got = rec_m.top_k(hist, 10)
        _assert_topk_equal(got, rec_1.top_k(hist, 10))
        if mode == "native":
            np.testing.assert_allclose(got[1], np.asarray(jm.top_k(hist, 10)[1]), **TOL)


def test_top_k_ties_go_to_the_lower_id(served):
    """Equal scores in two blocks merge lower id first, as one table ranks
    them: news 60 (block 1) given news 5's vector (block 0) and the top
    score."""
    _, rec, ds, state = served
    rec_m = Recommender(rec.cfg, ds, state, mesh=make_mesh(MeshConfig(), ["cpu"] * 8))
    hist = [1, 2, 3]
    best = int(rec_m.top_k(hist, 1)[0][0])
    for blk, row in ((60 // 51, 60 % 51), (300 // 51, 300 % 51)):
        rec_m.vec_blocks[blk][row] = rec_m.vec_blocks[best // 51][best % 51]
    ids, scores = rec_m.top_k(hist, 3)
    assert sorted({best, 60, 300}) == list(ids) and scores[0] == scores[1] == scores[2]
