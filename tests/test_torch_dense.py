"""``models/layers.py::Dense``'s product: on the CPU, and at compute dtype
float32 anywhere, both operands widened to float32 (the product the JAX
parity tests hold), bit for bit; on a CUDA card at a 16-bit compute dtype
the product in that dtype, on the tensor cores with float32 sums, held to
the same operands' float64 product rounded once, forward and all three
gradients, at the ``disan-train-b512`` cell's shapes; cuBLAS's
reduced-precision reductions off once the module is imported; and every
family built on ``Dense`` trained one step on the card both ways.

Card tests skip without a card::

    python -m pytest tests/test_torch_dense.py -q
"""

import numpy as np
import pytest
import torch

from pytorch_news_recommender_tpu_torch.config import synthetic_config
from pytorch_news_recommender_tpu_torch.data import synthetic
from pytorch_news_recommender_tpu_torch.data.loader import train_batches
from pytorch_news_recommender_tpu_torch.models import layers
from pytorch_news_recommender_tpu_torch.models.layers import Dense
from pytorch_news_recommender_tpu_torch.train.loop import Trainer, training_loss

torch.set_num_threads(2)


def _dense(n_in, n_out, bias, cd, device="cpu", seed=0):
    """A ``Dense`` with Flax's initial kernel and, where it has one, a
    drawn (non-zero) bias."""
    gen = torch.Generator().manual_seed(seed)
    d = Dense(n_in, n_out, cd, bias=bias)
    d.reset_parameters(gen)
    if bias:
        layers._draw(d.bias, lambda t: t.normal_(0.0, 0.5, generator=gen))
    return d.to(device)


def _inputs(rows, n_in, n_out, x_dtype, device, seed=1):
    """``x [rows..., n_in]`` in ``x_dtype`` and the output's gradient
    ``g [rows..., n_out]`` in bf16, both drawn on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(*rows, n_in, generator=gen).to(x_dtype).to(device)
    g = torch.randn(*rows, n_out, generator=gen).to(torch.bfloat16).to(device)
    return x, g


def _widened(d, x):
    """The product with both operands widened to float32, spelled out."""
    cd = d.compute_dtype
    y = torch.matmul(x.to(cd).float(), d.kernel.to(cd).float()).to(cd)
    return y if d.bias is None else y + d.bias.to(cd)


def _run(fn, d, x, g):
    """``fn(d, x)`` forward and backward against ``g``: the output and the
    input's, kernel's and bias's gradients."""
    d.zero_grad(set_to_none=True)
    x = x.detach().clone().requires_grad_()
    y = fn(d, x)
    y.backward(g.to(y.dtype))
    return [y.detach(), x.grad, d.kernel.grad] + ([d.bias.grad] if d.bias is not None else [])


def _same_bits(a, b):
    assert len(a) == len(b)
    for u, v in zip(a, b):
        assert u.dtype == v.dtype and torch.equal(u, v)


# ---- the CPU, and float32 -----------------------------------------------------

@pytest.mark.parametrize("cd", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "bias"])
def test_cpu_16_bit_product_is_the_widened_one_bit_for_bit(cd, x_dtype, bias):
    d = _dense(48, 40, bias, cd)
    x, g = _inputs((6, 5), 48, 40, x_dtype, "cpu")
    before = Dense.tensor_core_products
    ours = _run(Dense.forward, d, x, g)
    assert Dense.tensor_core_products == before
    _same_bits(ours, _run(_widened, d, x, g))
    assert ours[0].dtype == cd and ours[1].dtype == x_dtype


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "bias"])
def test_float32_compute_dtype_is_the_widened_product_bit_for_bit(device, bias):
    if device == "cuda":
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card")
        torch.backends.cuda.matmul.allow_tf32 = False
    d = _dense(48, 40, bias, torch.float32, device)
    x, g = _inputs((6, 5), 48, 40, torch.float32, device)
    before = Dense.tensor_core_products
    ours = _run(Dense.forward, d, x, g)
    assert Dense.tensor_core_products == before
    _same_bits(ours, _run(_widened, d, x, g))


def test_importing_layers_turns_reduced_precision_reductions_off():
    assert layers.Dense is Dense
    assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction is False
    assert torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction is False


# ---- on the card ------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the tensor-core path runs on cuda only")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# DiSA's products over the long block (4,096 news of 20 tokens) at d = 300,
# and Source2Token's at 600 with bias
CELL_ROWS = (4096, 20)
CELL_PRODUCTS = [(300, 300, False), (600, 600, True)]
# float32 sums move an element across a bf16 rounding boundary rarely (0.03%
# of the kernel gradient's over 81,920 rows in a CPU float32 GEMM); partial
# sums added in bf16 move about 60%
MIN_EXACT_SHARE = 0.99


def _bf16_step(ref):
    """The bf16 spacing at each element of ``ref`` (bf16 values), away
    from zero."""
    a = ref.abs().to(torch.bfloat16)
    up = torch.nextafter(a, torch.full_like(a, float("inf")))
    return (up.float() - a.float()).double()


def _hold_to_float64(name, ours, exact, product=None):
    """``ours`` (a bf16-valued tensor) against ``exact`` (float64) rounded
    once to bf16: at least MIN_EXACT_SHARE of the elements equal, and each
    within one bf16 step of its own value, with a floor of 2^-16 of the
    largest element for the float32 sums' rounding, which float64 does not
    have (it matters only where the sum cancels to near 0). Where a bias
    was added to the rounded ``product`` (bf16), one step of the product
    more: the add keeps the product's last step where the bias cancels it."""
    ref = exact.to(torch.bfloat16).cpu()
    ours = ours.detach().double().cpu()
    assert torch.equal(ours.to(torch.bfloat16).double(), ours), f"{name}: not bf16-valued"
    refd = ref.double()
    share = float((ours == refd).double().mean())
    assert share >= MIN_EXACT_SHARE, (name, share)
    allowed = _bf16_step(ref) + 2.0 ** -16 * float(refd.abs().max())
    if product is not None:
        allowed = allowed + _bf16_step(product.cpu())
    over = int(((ours - refd).abs() > allowed).sum())
    assert over == 0, (name, over)


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("n_in,n_out,bias", CELL_PRODUCTS, ids=["300_no_bias", "600_bias"])
def test_card_product_and_gradients_within_one_bf16_step_of_float64(
        cuda_device, n_in, n_out, bias, x_dtype):
    assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction is False
    assert torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction is False
    d = _dense(n_in, n_out, bias, torch.bfloat16, cuda_device)
    x, g = _inputs(CELL_ROWS, n_in, n_out, x_dtype, cuda_device)
    before = Dense.tensor_core_products
    ours = _run(Dense.forward, d, x, g)
    assert Dense.tensor_core_products == before + 1
    _same_bits(ours, _run(Dense.forward, d, x, g))   # two launches, the same bits
    assert Dense.tensor_core_products == before + 2
    y, dx, dk = ours[:3]
    assert y.dtype == torch.bfloat16 and dx.dtype == x_dtype and dk.dtype == torch.float32

    xr = x.to(torch.bfloat16).double().reshape(-1, n_in)
    kr = d.kernel.detach().to(torch.bfloat16).double()
    g64 = g.double().reshape(-1, n_out)
    prod = (xr @ kr).to(torch.bfloat16)
    if bias:   # the bias adds to the rounded product in bf16, as before
        out = prod + d.bias.detach().to(torch.bfloat16)
        _hold_to_float64("output", y.reshape(-1, n_out), out.double(), product=prod)
        _hold_to_float64("bias grad", ours[3], g64.sum(0))
    else:
        _hold_to_float64("output", y.reshape(-1, n_out), prod.double())
    _hold_to_float64("input grad", dx.reshape(-1, n_in), g64 @ kr.T)
    _hold_to_float64("kernel grad", dk, xr.T @ g64)


# the families built on Dense; npa's Denses are float32 by design, and
# lstur's GRU takes its products through its own widened GRUCell._dense3
WIDENED = {"npa", "lstur"}
FAMILIES = ["nrms_entity", "tanr", "nrms_bert", "disan", "lstur", "gnn", "fastformer",
            "npa", "list_rank"]
# the data of tests/test_torch_families.py, which imports JAX and so cannot
# run on the card
FAMILY_DATA = {"nrms_bert": dict(bert_dim=64), "lstur": dict(n_users=50),
               "gnn": dict(n_neighbors=4), "npa": dict(n_users=50),
               "list_rank": dict(bert_dim=64)}
DATA = dict(seed=3, n_train=256, n_dev=48, title_len=(11.5, 4), n_entities=32,
            entity_dim=16)


def _family_step(tr, state, batch):
    """One training forward and backward of ``batch`` (dropout off): the
    loss and the gradients, in float64 on the CPU."""
    model = state.model
    model.zero_grad(set_to_none=True)
    b = tr._to_device(tr._maybe_frontier(batch))
    scores = model(b, tr.news_feats, deterministic=False,
                   generator=torch.Generator().manual_seed(0))
    loss = training_loss(model, scores)
    loss.backward()
    model.aux_losses = {}
    grads = {n: p.grad.double().cpu() for n, p in model.named_parameters()
             if p.grad is not None}
    return float(loss.detach()), grads


@pytest.mark.parametrize("family", FAMILIES)
def test_card_family_step_on_the_tensor_cores_matches_the_widened_step(
        cuda_device, family, monkeypatch):
    """One bf16 step of ``family`` on the card with its products on the
    tensor cores and with every ``Dense`` widened to float32: the loss within
    1e-2 and the whole gradient within 3e-2 of each other (relative), both
    finite, and the tensor cores taken by every family but WIDENED."""
    cfg = synthetic_config(**{"model.name": family, "model.dropout": 0.0,
                              "model.compute_dtype": "bfloat16"})
    ds = synthetic.generate(cfg.data, **{**DATA, **FAMILY_DATA.get(family, {})})
    tr = Trainer(cfg, ds, device=cuda_device)
    state = tr.init_state(seed=0)
    batch = next(iter(train_batches(ds.train, 32, np.random.default_rng(2), dedup=True,
                                    length_split=tr._length_split)))
    before = Dense.tensor_core_products
    loss, grads = _family_step(tr, state, batch)
    products = Dense.tensor_core_products - before
    assert (products == 0) if family in WIDENED else (products > 0), products
    monkeypatch.setattr(Dense, "forward", _widened)
    wloss, wgrads = _family_step(tr, state, batch)
    assert sorted(grads) == sorted(wgrads)
    flat, wflat = (torch.cat([v.flatten() for _, v in sorted(gs.items())])
                   for gs in (grads, wgrads))
    assert np.isfinite(loss) and bool(torch.isfinite(flat).all())
    loss_gap = abs(loss - wloss) / abs(wloss)
    grad_gap = float((flat - wflat).norm() / wflat.norm())
    print(f"{family}: {products} tensor-core products, loss gap {loss_gap:.3g}, "
          f"gradient gap {grad_gap:.3g}")
    assert loss_gap <= 1e-2 and grad_gap <= 3e-2, (loss_gap, grad_gap)
