"""The port's fused encoder (``ops/fused_encoder.py``) against the JAX
package: its plain version against the Pallas kernel in interpret mode and
against the jnp chain; the wrapper's dispatch; and, on a CUDA card only,
the Hopper kernel against the plain version.

JAX is imported inside the tests that compare with it, so that the card's
tests also run where JAX is not installed; where it is, keep it on the CPU
(on a GPU its float32 products may run in TF32)::

    JAX_PLATFORMS=cpu python -m pytest --noconftest tests/test_torch_fused_encoder.py -q
"""

import pathlib

import numpy as np
import pytest
import torch

from pytorch_news_recommender_tpu_torch.ops import fused_encoder as FE

torch.set_num_threads(1)


def _inputs(seed, M, L, D, Q):
    """Masked tokens with rows of 0..L real tokens, and weights, as numpy."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, L + 1, size=M)
    lens[0], lens[1] = 0, L
    mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.float32)
    x = (rng.normal(size=(M, L, D)) * mask[..., None]).astype(np.float32)
    shapes = [(D, 3 * D), (3 * D,), (D, D), (D,), (D, Q), (Q,), (Q,)]
    scales = [0.05, 0.01, 0.05, 0.01, 0.05, 0.01, 0.1]
    w = [(rng.normal(size=s) * c).astype(np.float32) for s, c in zip(shapes, scales)]
    return x, mask, w, lens


def _torch_plain(x, mask, w, H):
    t = [torch.from_numpy(a) for a in (x, mask, *w)]
    return FE.fused_news_encoder_reference(
        t[0], t[1], *t[2:], num_heads=H).numpy()


@pytest.mark.parametrize("M,L,D,H,Q", [(13, 20, 64, 4, 32), (9, 50, 96, 4, 48)])
def test_plain_matches_jax_pallas_kernel(M, L, D, H, Q):
    """Rows with at least one real token; 2e-4 as the JAX package holds its
    own kernel to the jnp chain."""
    jnp = pytest.importorskip("jax.numpy")
    from pytorch_news_recommender_tpu.ops.pallas.fused_encoder import (
        fused_news_encoder as jax_fused_news_encoder,
    )
    x, mask, w, lens = _inputs(0, M, L, D, Q)
    expect = jax_fused_news_encoder(
        jnp.asarray(x), jnp.asarray(mask), *map(jnp.asarray, w), num_heads=H,
        dropout_rate=0.0, interpret=True)
    valid = lens > 0
    np.testing.assert_allclose(_torch_plain(x, mask, w, H)[valid],
                               np.asarray(expect)[valid], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("M,L,D,H,Q", [(13, 20, 64, 4, 32), (9, 50, 96, 4, 48)])
def test_plain_matches_jnp_chain_on_all_rows(M, L, D, H, Q):
    """All rows, the all-pad item included: the same float32 chain."""
    jax = pytest.importorskip("jax")
    from pytorch_news_recommender_tpu.ops import attention as JA

    @jax.jit
    def chain(x, mask, wqkv, bqkv, wo, bo, aw, ab, aq):
        h = JA.multi_head_self_attention(x, wqkv, bqkv, wo, bo, H, mask)
        return JA.additive_attention(h, aw, ab, aq, mask)

    x, mask, w, _ = _inputs(1, M, L, D, Q)
    expect = chain(x, mask, *w)
    np.testing.assert_allclose(_torch_plain(x, mask, w, H), np.asarray(expect),
                               rtol=1e-5, atol=1e-5)


def test_cpu_tensors_take_the_plain_version_and_build_nothing():
    x, mask, w, _ = _inputs(2, 5, 20, 64, 32)
    t = [torch.from_numpy(a) for a in (x, mask, *w)]
    before = FE.fused_news_encoder.launches
    got = FE.fused_news_encoder(t[0], t[1], *t[2:], num_heads=4)
    np.testing.assert_array_equal(got.numpy(), _torch_plain(x, mask, w, 4))
    assert FE.fused_news_encoder.launches == before
    assert FE._lib.cache_info().currsize == 0


def test_other_devices_raise():
    x, mask, w, _ = _inputs(3, 2, 20, 64, 32)
    t = [torch.from_numpy(a).to("meta") for a in (x, mask, *w)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        FE.fused_news_encoder(t[0], t[1], *t[2:], num_heads=4)


def test_failed_build_raises(monkeypatch, tmp_path):
    import torch.utils.cpp_extension as ext

    def broken(**kw):
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(ext, "load", broken)
    monkeypatch.setattr(FE, "BUILD_DIR", tmp_path / "kernels")
    FE._lib.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc failed"):
        FE.build()
    assert FE._lib.cache_info().currsize == 0


def test_import_loads_no_extension():
    """Importing the port (every module) builds and loads nothing; the
    isolation test checks the same in a fresh interpreter."""
    import pytorch_news_recommender_tpu_torch.cli  # noqa: F401
    import pytorch_news_recommender_tpu_torch.serve  # noqa: F401
    assert FE._lib.cache_info().currsize == 0
    assert "newsrec_fused_encoder" not in pathlib.Path("/proc/self/maps").read_text()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# bf16: the kernel rounds where the TPU kernel does, the plain version where
# the jnp chain does; the two differ by a few bf16 steps (2^-7 at |out| ~ 1)
TOLS = {torch.float32: 2e-4, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,L,D,H,Q", [(13, 20, 64, 4, 32), (9, 50, 96, 4, 48),
                                       (64, 20, 300, 10, 200), (4, 50, 300, 10, 200)])
def test_kernel_matches_plain_on_card(cuda_device, dtype, M, L, D, H, Q):
    x, mask, w, lens = _inputs(4, M, L, D, Q)
    t = [torch.from_numpy(a).to(cuda_device) for a in (x, mask, *w)]
    args = [t[0].to(dtype), t[1], *(a.to(dtype) for a in t[2:])]
    got = FE.fused_news_encoder(*args, num_heads=H)
    torch.cuda.synchronize()
    expect = FE.fused_news_encoder_reference(*args, num_heads=H)
    valid = torch.from_numpy(lens > 0).to(cuda_device)
    tol = TOLS[dtype]
    torch.testing.assert_close(got[valid].float(), expect[valid].float(),
                               rtol=tol, atol=tol)
    assert torch.all(got[~valid] == 0)
