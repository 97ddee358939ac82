"""The port's CUDA kernels as one library: its sources, its build and
loader, and the one way a kernel is launched.

Every ``*.cu`` file under ``csrc`` (:data:`SOURCES`) builds into one
library at the first call that needs it, with ``torch.utils.cpp_extension.load``
for ``sm_90a`` into :data:`BUILD_DIR` (``build/kernels/`` at the root of the
checkout), bound with ``ctypes``: the sources have a plain C interface, so
no PyTorch header is compiled. A new kernel is its ``.cu`` file there and
its op module, which declares the C functions it calls (:func:`declare`);
nothing is built when a module is imported. An experiment that builds a
patched copy of the sources repoints :data:`SOURCES` and :data:`BUILD_DIR`
and calls ``lib.cache_clear()`` before the first launch.
"""

from __future__ import annotations

import ctypes
import functools
import pathlib
import threading
from typing import Callable, Dict, List, Optional, Tuple

import torch

SOURCES = sorted((pathlib.Path(__file__).resolve().parent / "csrc").glob("*.cu"))
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
# Hopper's shared-memory limit for one block (bytes)
MAX_SMEM = 232_448
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# C function name -> (argument types, result type), as the op modules declare them
DECLARED: Dict[str, Tuple[List[type], Optional[type]]] = {}
_COUNT_LOCK = threading.Lock()  # serving threads launch concurrently


def declare(name: str, argtypes, restype: Optional[type] = ctypes.c_int) -> Callable:
    """Declares the library's C function ``name`` with its ``ctypes``
    argument and result types, and returns a callable for it that builds
    and loads the library at its first call. A name is declared once."""
    if name in DECLARED:
        raise ValueError(f"{name} is declared twice")
    DECLARED[name] = (list(argtypes), restype)
    if lib.cache_info().currsize:
        _bind(lib(), name)

    def call(*args):
        return getattr(lib(), name)(*args)

    call.__name__ = call.__qualname__ = name
    return call


def _bind(library: ctypes.CDLL, name: str) -> None:
    fn = getattr(library, name)
    fn.argtypes, fn.restype = DECLARED[name]


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    """Builds (once per checkout and source version) and loads the library,
    with every declared function bound."""
    from torch.utils.cpp_extension import load

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = load(
        name="newsrec_fused_encoder",
        sources=[str(p) for p in SOURCES],
        build_directory=str(BUILD_DIR),
        extra_cuda_cflags=["-O3", "-std=c++17",
                           "-gencode=arch=compute_90a,code=sm_90a"],
        is_python_module=False,
        verbose=False,
    )
    library = ctypes.CDLL(path)
    for name in DECLARED:
        _bind(library, name)
    return library


def build() -> None:
    """Builds and loads the kernels now instead of at their first launch."""
    lib()


_error_string = declare("newsrec_cuda_error_string", [ctypes.c_int], ctypes.c_char_p)


def require_cuda(t: torch.Tensor, what: str, elsewhere: str = "") -> None:
    """Raises ``ValueError`` unless ``t`` is on a CUDA card. Without
    ``elsewhere`` the op's wrapper runs its plain version on the CPU;
    otherwise the op runs on cuda alone and ``elsewhere`` ends the message
    with where its plain version runs."""
    if t.device.type != "cuda":
        where = "cuda" if elsewhere else "cuda or cpu"
        raise ValueError(f"{what} runs on {where}, not {t.device}{elsewhere}")


def launch(fn: Callable, *args, device: torch.device, what: str, counter: Callable,
           wgmma: bool = False) -> None:
    """Launches the declared kernel ``fn(*args, stream)`` on ``device`` and
    its current stream, raises ``RuntimeError`` with the library's error
    string if it returns a CUDA error code, and counts the launch on
    ``counter.launches`` (and on ``counter.wgmma_launches`` where
    ``wgmma``, the launches whose weight products ran on wgmma)."""
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: " + _error_string(rc).decode())
    with _COUNT_LOCK:
        counter.launches += 1
        if wgmma:
            counter.wgmma_launches += 1
