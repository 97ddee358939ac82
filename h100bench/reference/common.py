"""Plain float32 pieces the families share: the precision of the products,
the attention-and-pooling tower, the word lookup, the dropout masks and
seeds, and Adam.

The rules that decide which mask a token gets are frozen copies of the
program's, written out again here: the per-step seed generator, the rank's
fold of a seed, and the counter hash that the encoder's dropout applies
over blocks of token rows. They are arithmetic on the configuration's seed,
not state of the program.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

NEG_INF = -1e9
FP8_MAX = 448.0   # largest finite float8 e4m3 value


def strict_fp32() -> None:
    """Float32 products stay float32 on the card: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class Precision:
    """Where the reference rounds. ``float32`` rounds nowhere. ``fp8``, the
    control, rounds both operands of every product to float8 e4m3 with one
    scale per tensor (its largest magnitude maps to 448), as an fp8 path
    with float32 sums would: the step below the configuration's bfloat16."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def r(self, t: torch.Tensor) -> torch.Tensor:
        if self.name == "float32":
            return t
        amax = t.detach().abs().amax().clamp_min(1e-30)
        scale = amax / FP8_MAX
        q = (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
        # rounded values forward, the gradient of the identity backward
        return t + (q - t).detach()

    def mm(self, eq: str, *ops: torch.Tensor) -> torch.Tensor:
        return torch.einsum(eq, *(self.r(t.float()) for t in ops))


F32 = Precision("float32")


def tower(p: Precision, W: Dict[str, torch.Tensor], prefix: str, x: torch.Tensor,
          mask: torch.Tensor, heads: int,
          keep_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-head self-attention, the output projection, dropout
    (``keep_scale``: 0 or ``1 / (1 - rate)`` per element), additive pooling
    ``softmax(tanh(h aw + ab) aq)``: ``[M, L, D] -> [M, D]``, with the
    weights ``{prefix}wqkv`` (``[D, 3D]``, used as ``x W``), ``bqkv``,
    ``wo``, ``bo``, ``aw``, ``ab``, ``aq``. An item without a real token
    pools to 0, as the encoder's contract states."""
    w = lambda n: W[prefix + n]  # noqa: E731
    M, L, D = x.shape
    dh = D // heads
    m = mask.float()
    qkv = p.mm("mld,de->mle", x, w("wqkv")) + w("bqkv")
    q, k, v = (t.reshape(M, L, heads, dh).transpose(1, 2) for t in qkv.split(D, dim=-1))
    s = p.mm("mhld,mhkd->mhlk", q, k) / math.sqrt(dh)
    pair = m[:, None, :, None] * m[:, None, None, :]
    a = torch.softmax(torch.where(pair > 0, s, NEG_INF), dim=-1)
    o1 = p.mm("mhlk,mhkd->mhld", a, v).transpose(1, 2).reshape(M, L, D)
    h = p.mm("mld,de->mle", o1, w("wo")) + w("bo")
    if keep_scale is not None:
        h = h * keep_scale
    t = torch.tanh(p.mm("mld,dq->mlq", h, w("aw")) + w("ab"))
    sc = torch.where(m > 0, p.mm("mlq,q->ml", t, w("aq")), NEG_INF)
    out = p.mm("ml,mld->md", torch.softmax(sc, dim=-1), h)
    return torch.where(m.sum(1, keepdim=True) > 0, out, 0.0)


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` for ``ids``; id 0 (pad) looks up zeros."""
    return table[ids.long()] * (ids != 0).unsqueeze(-1).float()


def dot_scores(p: Precision, user: torch.Tensor, cands: torch.Tensor) -> torch.Tensor:
    """``[B, D] x [B, S, D] -> [B, S]``."""
    return p.mm("bd,bsd->bs", user, cands)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


# ---- seeds and masks (frozen copies of the program's rules) ---------------

SEED_STRIDE = 1_000_003   # a data-parallel rank's fold of a dropout seed


def step_seeds(train_seed: int, step: int, rank: int = 0):
    """The dropout seeds a training step draws, in call order: a CPU
    generator seeded with ``((train_seed + 1) << 32) | step``, each draw an
    int32 folded with the rank."""
    g = torch.Generator().manual_seed((((int(train_seed) + 1) & 0xFFFFFFFF) << 32)
                                      | (int(step) & 0xFFFFFFFF))
    while True:
        s = int(torch.randint(0, 2 ** 31 - 1, (), generator=g))
        yield (s + int(rank) * SEED_STRIDE) & 0xFFFFFFFF


def _rows_per_hash_block(L: int, block_news: int = 64, max_rows: int = 1280) -> int:
    under = [q for q in range(1, 256 // L + 1) if (q * L) % 8 == 0 and q * L <= 128]
    over = [q for q in range(1, 256 // L + 1) if (q * L) % 8 == 0 and q * L <= 256]
    P = max(under) if under else (min(over) if over else 1)
    step = P * 8 // math.gcd(P, 8)
    target = min(block_news, max(1, max_rows // L))
    return step * max(1, target // step) * L


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & 0xFFFFFFFF


def hash_keep_scale(seed: int, M: int, L: int, D: int, rate: float,
                    device) -> torch.Tensor:
    """The encoder's dropout of one call over ``M`` items of ``L`` tokens:
    ``[M, L, D]`` of 0 or ``1 / (1 - rate)``, keep where the murmur3
    finalizer of ``(seed + block, row in block, column)`` reaches ``rate *
    2^32``."""
    rows = _rows_per_hash_block(L)
    g = torch.arange(M * L, dtype=torch.int64, device=device)
    row = (g % rows)[:, None]
    sv = ((int(seed) + g // rows) & 0xFFFFFFFF)[:, None]
    col = torch.arange(D, dtype=torch.int64, device=device)[None, :]
    x = _mul32(row, 0x9E3779B1) ^ _mul32(col, 0x85EBCA77) ^ _mul32(sv, 0xC2B2AE3D)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    keep = (x >= int(rate * 2 ** 32)).reshape(M, L, D)
    return torch.where(keep, 1.0 / (1.0 - rate), 0.0)


def rand_keep_scale(seed: int, shape, rate: float, device) -> torch.Tensor:
    """Dropout drawn where the vectors lie: ``torch.rand`` of a generator on
    ``device`` seeded with ``seed``, keep where it reaches ``rate``."""
    drawn = torch.Generator(device=device).manual_seed(int(seed))
    keep = torch.rand(tuple(shape), generator=drawn, device=device) >= rate
    return torch.where(keep, 1.0 / (1.0 - rate), 0.0)


# ---- Adam ----------------------------------------------------------------

class Adam:
    """Adam as optax computes it: ``mu``, ``nu`` decayed by 0.9 and 0.999,
    the update ``(mu / bc1) / (sqrt(nu / bc2) + 1e-8)`` times ``-lr``."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float):
        self.params, self.lr, self.count = params, float(lr), 0
        self.mu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        self.count += 1
        bc1, bc2 = 1.0 - 0.9 ** self.count, 1.0 - 0.999 ** self.count
        for n, p in self.params.items():
            g = grads[n]
            self.mu[n].mul_(0.9).add_(0.1 * g)
            self.nu[n].mul_(0.999).add_(0.001 * g * g)
            p.add_((self.mu[n] / bc1) / (torch.sqrt(self.nu[n] / bc2) + 1e-8) * -self.lr)
