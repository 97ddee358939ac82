"""DiSA's token-pair chain in the port (``ops/disa.py``, and the plain chain
``models/disan.py::disa_pairs_reference``): the plain backward against
autograd through the plain forward, the CPU route (the plain chain, no
kernel launch, nothing built; the kernel wrappers refuse CPU tensors), the
one call a direction makes per encode;
and, on a CUDA card only, the Hopper kernels (``ops/csrc/disa.cu``) against
the plain chain at the ``disan-train-b512`` cell's shapes, their bits across
launches, their launch counts and their longest item.

The JAX package's DiSA has no kernel: ``tests/test_torch_bert_disan_lstur.py``
and ``tests/test_torch_families.py`` hold the plain chain (the CPU route) to
it. Card tests skip without a card::

    python -m pytest tests/test_torch_disa_pairs.py -q
"""

import numpy as np
import pytest
import torch

from pytorch_news_recommender_tpu_torch.models import disan as disan_mod
from pytorch_news_recommender_tpu_torch.models.disan import DiSA, DiSANEncoder
from pytorch_news_recommender_tpu_torch.ops import disa as DP
from pytorch_news_recommender_tpu_torch.ops import kernels as K

torch.set_num_threads(2)

DTYPES = [torch.float32, torch.bfloat16]
DIRECTIONS = ["fw", "bw"]


def _lengths(rng, M, L):
    """Real lengths from N(11.5, 4) (MIND's titles), cut to [0, L]; item 0
    all pad, item 1 one token (its one row has an empty pair set), item 2
    full."""
    lens = np.clip(np.rint(rng.normal(11.5, 4.0, size=M)), 0, L).astype(np.int64)
    lens[:3] = [0, min(1, L), L][:M]
    return lens


def _inputs(seed, M, L, d, dtype, device="cpu"):
    """``dep``, ``head``, ``rep`` ``[M, L, d]`` in ``dtype``, the mask and a
    float32 ``b1``: ``dep + head`` spread so the tanh bends, ``rep`` an elu
    of a normal (pad tokens too, as DiSA gives them), ``b1`` small."""
    rng = np.random.default_rng(seed)
    lens = _lengths(rng, M, L)
    mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.float32)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    dep, head = (t(rng.normal(size=(M, L, d)) * 2.0).to(dtype) for _ in range(2))
    rep = torch.nn.functional.elu(t(rng.normal(size=(M, L, d)))).to(dtype)
    b1 = t(rng.normal(size=d) * 0.3)
    return dep, head, rep, t(mask), b1


def _rel(a, b):
    """max|a - b| / max|b| in float64 (0 where both are 0)."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _plain_grads(dep, head, rep, mask, b1, g, direction, dtype=None):
    """Autograd through the plain forward, its pad query rows masked (the
    kernel's function): ``(ddep, dhead, drep, db1)``; ``dtype`` recasts the
    row operands first (same values, another compute dtype)."""
    leaves = [x.detach().to(dtype or x.dtype).requires_grad_() for x in (dep, head, rep)]
    b = b1.detach().clone().requires_grad_()
    res = disan_mod.disa_pairs_reference(*leaves, mask, b, direction) * mask[..., None].to(
        leaves[0].dtype)
    (res.float() * g.float()).sum().backward()
    return [x.grad for x in leaves] + [b.grad]


def _within_bf16_spread(name, ours, plain, exact):
    """bf16 gradients: the plain chain rounds ``d(att)`` and ``ds`` to bf16
    before its sums, where the kernel's equations keep float32 and round
    each sum once, so neither is a rounding of the other. Both are bf16
    roundings of the float32 chain's gradient (``exact``, the same input
    values): ours must lie within twice the plain chain's own distance from
    it, plus one bf16 step (2^-8 of the largest entry) for the last rounding
    to bf16."""
    spread = _rel(plain, exact)
    assert _rel(ours, exact) <= 2 * spread + 2 ** -8, (name, _rel(ours, exact), spread)


# ---- on the CPU -------------------------------------------------------------

@pytest.mark.parametrize("M,L", [(9, 12), (6, 20), (5, 1), (4, 3)])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("direction", DIRECTIONS)
def test_bwd_reference_matches_autograd_through_plain_forward(direction, dtype, M, L):
    """float32: each of ``ddep``, ``dhead``, ``drep``, ``db1`` within 1e-5
    of its largest entry. bfloat16: within the plain chain's own bf16
    spread (``_within_bf16_spread``)."""
    d = 24
    dep, head, rep, mask, b1 = _inputs(M * 100 + L, M, L, d, dtype)
    g = torch.as_tensor(np.random.default_rng(L).normal(size=(M, L, d)),
                        dtype=torch.float32).to(dtype)
    got = DP.disa_pairs_bwd_reference(g, dep, head, rep, mask, b1, direction)
    plain = _plain_grads(dep, head, rep, mask, b1, g, direction)
    assert [x.dtype for x in got] == [dtype] * 3 + [torch.float32]
    if dtype == torch.float32:
        for name, a, b in zip(("ddep", "dhead", "drep", "db1"), got, plain):
            assert _rel(a, b) <= 1e-5, (name, _rel(a, b))
        return
    exact = _plain_grads(dep, head, rep, mask, b1, g, direction, torch.float32)
    for name, a, b, x in zip(("ddep", "dhead", "drep", "db1"), got, plain, exact):
        _within_bf16_spread(name, a, b, x)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("direction", DIRECTIONS)
def test_cpu_tensors_take_the_plain_chain_and_launch_nothing(direction, dtype, monkeypatch):
    """On the CPU a DiSA direction runs the plain chain, with and without
    autograd (the same bits both ways), and never the kernel wrapper;
    neither launch count moves and no library is built. The wrappers
    refuse CPU tensors: there is no fallback inside them."""
    def kernel(*a):
        raise AssertionError("the kernel wrapper was called on the CPU")

    monkeypatch.setattr(disan_mod, "disa_pairs", kernel)
    before = (DP.disa_pairs.launches, DP.disa_pairs_bwd.launches)
    net = DiSA(16, 12, direction, 0.0, dtype)
    net.reset_parameters(torch.Generator().manual_seed(1))
    dep, head, rep, mask, b1 = _inputs(3, 7, 12, 16, dtype)
    with torch.no_grad():
        plain = net(rep, mask)
    x = rep.clone().requires_grad_()
    out = net(x, mask)
    assert out.grad_fn is not None and torch.equal(out, plain)
    out.float().sum().backward()
    assert x.grad is not None and all(p.grad is not None for p in net.parameters())
    assert (DP.disa_pairs.launches, DP.disa_pairs_bwd.launches) == before
    assert K.lib.cache_info().currsize == 0
    with pytest.raises(ValueError, match="runs on cuda"):
        DP.disa_pairs(dep, head, rep, mask, b1, direction)
    with pytest.raises(ValueError, match="runs on cuda"):
        DP.disa_pairs_bwd(torch.ones_like(rep), dep, head, rep, mask, b1, direction)


def test_each_direction_calls_the_pair_chain_once_per_encode(monkeypatch):
    """DiSANEncoder's forward makes one pair-chain call a direction (on the
    CPU, the plain chain), with ``dep = w1(rep')``, ``head = w2(rep')`` and
    DiSA's own ``b1``."""
    calls = []
    inner = disan_mod.disa_pairs_reference

    def counting(dep, head, rep, rep_mask, b1, direction):
        calls.append((direction, tuple(dep.shape), b1.shape))
        return inner(dep, head, rep, rep_mask, b1, direction)

    monkeypatch.setattr(disan_mod, "disa_pairs_reference", counting)
    enc = DiSANEncoder(16, 8, 0.0, torch.float32)
    enc.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(5, 6, 16)
    mask = torch.ones(5, 6)
    enc(x, mask).sum().backward()
    assert calls == [("fw", (5, 6, 8), (8,)), ("bw", (5, 6, 8), (8,))]


def test_direction_is_checked():
    dep, head, rep, mask, b1 = _inputs(0, 3, 4, 8, torch.float32)
    with pytest.raises(ValueError, match="fw|bw"):
        DP.disa_pairs(dep, head, rep, mask, b1, "up")
    with pytest.raises(ValueError, match="fw|bw"):
        disan_mod.disa_pairs_reference(dep, head, rep, mask, b1, "up")
    with pytest.raises(ValueError, match="fw|bw"):
        DiSA(8, 8, "up", 0.0, torch.float32)


# ---- on the card ------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# the disan-train-b512 cell's two length blocks at d = 300
CELL_SHAPES = [(6144, 12), (4096, 20)]
D_H = 300
# kernel vs plain, max|a - b| / max|b|: float32 differs by the order of f32
# sums and the softmax's unsubtracted maximum; bfloat16 by those, moved
# through the rounding of att and of the outputs to bf16
TOLS = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("M,L", CELL_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("direction", DIRECTIONS)
def test_forward_kernel_matches_plain_on_card(cuda_device, direction, dtype, M, L):
    """``res`` on real rows within TOLS of the plain chain; pad query rows
    0 (the documented difference)."""
    dep, head, rep, mask, b1 = _inputs(M + L, M, L, D_H, dtype, cuda_device)
    with torch.no_grad():
        got = DP.disa_pairs(dep, head, rep, mask, b1, direction)
        expect = disan_mod.disa_pairs_reference(dep, head, rep, mask, b1, direction)
    real = mask > 0
    assert _rel(got[real], expect[real]) < TOLS[dtype], _rel(got[real], expect[real])
    assert torch.all(got[~real] == 0)


@pytest.mark.parametrize("M,L", CELL_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("direction", DIRECTIONS)
def test_backward_kernel_matches_plain_autograd_on_card(cuda_device, direction, dtype, M, L):
    """Through ``DisaPairs``: ``ddep``, ``dhead``, ``drep``, ``db1`` against
    autograd through the plain chain (``g`` zero on pad rows, as DiSA's
    output mask gives it), each within TOLS of its largest entry; in bf16
    also within the plain chain's own bf16 spread, as on the CPU."""
    dep, head, rep, mask, b1 = _inputs(M * 3 + L, M, L, D_H, dtype, cuda_device)
    g = (torch.randn(M, L, D_H, device=cuda_device, generator=torch.Generator(
        cuda_device).manual_seed(L)) * mask[..., None]).to(dtype)
    leaves = [x.clone().requires_grad_() for x in (dep, head, rep, b1)]
    res = DP.disa_pairs(*leaves[:3], mask, leaves[3], direction)
    assert res.grad_fn is not None and type(res.grad_fn).__name__ == "DisaPairsBackward"
    (res.float() * g.float()).sum().backward()
    got = [x.grad for x in leaves]
    plain = _plain_grads(dep, head, rep, mask, b1, g, direction)
    exact = (_plain_grads(dep, head, rep, mask, b1, g, direction, torch.float32)
             if dtype == torch.bfloat16 else None)
    for k, name in enumerate(("ddep", "dhead", "drep", "db1")):
        assert got[k].dtype == plain[k].dtype, name
        assert _rel(got[k], plain[k]) < TOLS[dtype], (name, _rel(got[k], plain[k]))
        if exact is not None:
            _within_bf16_spread(name, got[k], plain[k], exact[k])


@pytest.mark.parametrize("M,L", CELL_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_disa_output_and_weight_gradients_match_plain_on_card(cuda_device, dtype, M, L,
                                                               monkeypatch):
    """A whole DiSA direction pair (``DiSANEncoder`` without dropout) at d =
    300, through the kernels and through the plain chain: the output within
    TOLS; the gradients of the input and of every parameter within TOLS in
    float32, and in bfloat16 within the plain chain's own bf16 spread around
    the float32 plain chain's (``_within_bf16_spread``: ``w2``'s and ``b1``'s
    gradients are small curvature terms, as a shift of a query row's logits
    alike for every key cancels in the softmax, so the plain chain's bf16
    ``ds`` moves them by some percent). A leaf whose plain gradient lies under
    1e-3 of the median leaf's is left out, as the benchmark leaves such
    leaves out: ``source2token.fc2.bias`` has an exact gradient of 0 (a
    softmax over the tokens is blind to a shift of one dimension), so both
    sides read rounding; the kernel's must lie under that too."""
    enc = DiSANEncoder(D_H, D_H, 0.0, dtype).to(cuda_device)
    enc.reset_parameters(torch.Generator().manual_seed(1))
    with torch.no_grad():
        for m in (enc.fw, enc.bw):
            m.b1.normal_(0.0, 0.3, generator=torch.Generator(cuda_device).manual_seed(2))
    rng = np.random.default_rng(M + L)
    mask = torch.as_tensor(np.arange(L)[None, :] < _lengths(rng, M, L)[:, None],
                           dtype=torch.float32, device=cuda_device)
    x = (torch.as_tensor(rng.normal(size=(M, L, D_H)), dtype=torch.float32,
                         device=cuda_device) * mask[..., None]).to(dtype)
    g = torch.as_tensor(rng.normal(size=(M, 2 * D_H)), dtype=torch.float32, device=cuda_device)

    def run(net, xin):
        net.zero_grad(set_to_none=True)
        xs = xin.clone().requires_grad_()
        out = net(xs, mask)
        (out.float() * g).sum().backward()
        return out.detach(), {"x": xs.grad, **{n: p.grad for n, p in net.named_parameters()}}

    before = (DP.disa_pairs.launches, DP.disa_pairs_bwd.launches)
    out_k, grads_k = run(enc, x)
    assert (DP.disa_pairs.launches - before[0], DP.disa_pairs_bwd.launches - before[1]) == (2, 2)
    monkeypatch.setattr(disan_mod, "disa_pairs", disan_mod.disa_pairs_reference)
    out_p, grads_p = run(enc, x)
    valid = mask.sum(1) > 0
    assert _rel(out_k[valid], out_p[valid]) < TOLS[dtype]
    floor = 1e-3 * float(np.median([float(v.abs().max()) for v in grads_p.values()]))
    zero = {n for n, v in grads_p.items() if float(v.abs().max()) < floor}
    assert zero <= {"source2token.fc2.bias"}, zero
    assert all(float(grads_k[n].abs().max()) < floor for n in zero)
    if dtype == torch.bfloat16:
        enc32 = DiSANEncoder(D_H, D_H, 0.0, torch.float32).to(cuda_device)
        enc32.load_state_dict(enc.state_dict())
        exact = run(enc32, x.float())[1]
    for name in set(grads_p) - zero:
        if dtype == torch.float32:
            assert _rel(grads_k[name], grads_p[name]) < TOLS[dtype], (
                name, _rel(grads_k[name], grads_p[name]))
        else:
            _within_bf16_spread(name, grads_k[name], grads_p[name], exact[name])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("direction", DIRECTIONS)
def test_kernels_are_bit_equal_across_launches_on_card(cuda_device, direction, dtype):
    """No atomics, a fixed order of every sum (``db1`` across items too,
    through PyTorch's sum of the kernel's partials)."""
    dep, head, rep, mask, b1 = _inputs(11, 4096, 20, D_H, dtype, cuda_device)
    g = torch.randn(4096, 20, D_H, device=cuda_device).to(dtype) * mask[..., None].to(dtype)
    with torch.no_grad():
        a = DP.disa_pairs(dep, head, rep, mask, b1, direction)
        assert torch.equal(a, DP.disa_pairs(dep, head, rep, mask, b1, direction))
    first = DP.disa_pairs_bwd(g, dep, head, rep, mask, b1, direction)
    again = DP.disa_pairs_bwd(g, dep, head, rep, mask, b1, direction)
    assert all(torch.equal(x, y) for x, y in zip(first, again))


def test_launches_per_encode_in_training_and_without_grad_on_card(cuda_device):
    """One forward launch a direction per encode call; one backward launch
    a direction per training encode, none under ``no_grad``."""
    enc = DiSANEncoder(64, 64, 0.2, torch.bfloat16).to(cuda_device)
    enc.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(32, 12, 64, device=cuda_device).to(torch.bfloat16)
    mask = torch.ones(32, 12, device=cuda_device)
    count = lambda: (DP.disa_pairs.launches, DP.disa_pairs_bwd.launches)  # noqa: E731
    start = count()
    out = enc(x, mask, deterministic=False, generator=torch.Generator().manual_seed(3))
    assert count() == (start[0] + 2, start[1])
    out.float().sum().backward()
    assert count() == (start[0] + 2, start[1] + 2)
    with torch.no_grad():
        enc(x, mask)
    assert count() == (start[0] + 4, start[1] + 2)


@pytest.mark.parametrize("dtype", DTYPES)
def test_longest_item_runs_and_a_longer_one_is_refused_on_card(cuda_device, dtype):
    L = DP.max_len()
    assert L >= 64
    dep, head, rep, mask, b1 = _inputs(5, 24, L, D_H, dtype, cuda_device)
    mask[3:] = 1.0     # full items at the longest length
    with torch.no_grad():
        got = DP.disa_pairs(dep, head, rep, mask, b1, "fw")
        expect = disan_mod.disa_pairs_reference(dep, head, rep, mask, b1, "fw")
    real = mask > 0
    assert _rel(got[real], expect[real]) < TOLS[dtype]
    g = torch.randn_like(rep.float()).to(dtype) * mask[..., None].to(dtype)
    got = DP.disa_pairs_bwd(g, dep, head, rep, mask, b1, "bw")
    expect = _plain_grads(dep, head, rep, mask, b1, g, "bw")
    for a, b in zip(got, expect):
        assert _rel(a, b) < TOLS[dtype]
    long = [t[:, :1].expand(-1, L + 1, -1).contiguous() for t in (dep, head, rep)]
    with pytest.raises(ValueError, match="at most"):
        DP.disa_pairs(*long, torch.ones(24, L + 1, device=cuda_device), b1, "fw")
