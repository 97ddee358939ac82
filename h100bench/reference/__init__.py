"""The benchmark's plain reference: float32 PyTorch with TF32 off.

It imports neither JAX nor the JAX package nor the program under test, and
takes nothing the program made. From the benchmark's own inputs (the corpus,
the click log, the requests and the seeded weights) it works out again what
the program derives: the batch layout of each step, the dropout masks, the
news and user vectors, the scores, the loss, the gradients and Adam's
update. ``family(name)`` loads the towers of one model family from
``reference/<name>.py``.
"""

from __future__ import annotations

import importlib


def family(name: str):
    """The reference module of model family ``name``."""
    return importlib.import_module(f"{__name__}.{name}")
