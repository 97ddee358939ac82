"""Seeded random weights, made on the device in one draw.

The reference family names every weight with its shape and law
(``reference/<family>.py::leaves``); one normal draw from a generator on the
device fills a flat float32 buffer, and each weight is a view of it, scaled
by its law. The same seed gives the same weights on the same device, so the
reference makes them again rather than keep a copy."""

from __future__ import annotations

from typing import Dict

import torch

from h100bench.traffic import STREAM_WEIGHTS


def make(leaves, seed: int, device) -> Dict[str, torch.Tensor]:
    """``{name: float32 tensor}`` on ``device`` for ``leaves`` (``(name,
    shape, law)``)."""
    sizes = [int(torch.Size(shape).numel()) for _, shape, _ in leaves]
    g = torch.Generator(device=device).manual_seed(
        (int(seed) * 8 + STREAM_WEIGHTS) % (1 << 63))
    flat = torch.randn(sum(sizes), generator=g, device=device, dtype=torch.float32)
    out, at = {}, 0
    for (name, shape, law), n in zip(leaves, sizes):
        w = flat[at:at + n].view(shape)
        at += n
        if law == "normal_pad0":
            w[0] = 0.0
        elif law != "normal":
            kind, s = law
            w.mul_(s)
            if kind == "one_plus_std":
                w.add_(1.0)
        out[name] = w
    return out
