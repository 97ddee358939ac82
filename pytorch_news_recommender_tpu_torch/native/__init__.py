"""ctypes bindings of the C++ fast path of MIND preprocessing and batch
dedup (the port's copy of the JAX package's ``native/``).

``mind_native.cpp`` (a plain C interface, no Python header) is built with
``g++ -O3 -std=c++17 -shared -fPIC`` at first use into ``build/native/`` at
the root of the checkout, and built again when the source is newer than the
library. The build writes a file of its own and renames it into place, so
processes that build at once (test workers, training ranks) never load a
half-written library.

``available()`` is False when the library cannot be built or loaded (no
compiler); the callers then keep their numpy and pure-Python paths, which
give the same arrays bit for bit (same splitmix64 hash-shuffle spec, same
``np.unique`` order; ``tests/test_torch_native.py``).
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import sys
import threading
from typing import Dict, Optional, Tuple

import numpy as np

_SRC = pathlib.Path(__file__).resolve().parent / "mind_native.cpp"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "native"
_LIB = BUILD_DIR / "libmind_native.so"

_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None
_lock = threading.Lock()


def _build() -> Optional[str]:
    """Compiles the library if it is missing or older than its source;
    returns an error string or None."""
    if _LIB.exists() and _LIB.stat().st_mtime >= _SRC.stat().st_mtime:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".libmind_native.{os.getpid()}.{threading.get_ident()}.so"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", str(_SRC), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{type(e).__name__}: {e}"
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return proc.stderr[-2000:]
    os.replace(tmp, _LIB)
    return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        _build_error = _build()
        if _build_error is not None:
            print(f"native build failed, using the Python path: {_build_error}",
                  file=sys.stderr)
            return None
        try:
            lib = ctypes.CDLL(str(_LIB))
        except OSError as e:
            _build_error = f"{type(e).__name__}: {e}"
            print(f"native library failed to load, using the Python path: {e}",
                  file=sys.stderr)
            return None
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        i8p = ctypes.POINTER(ctypes.c_int8)
        lib.mind_free.argtypes = [ctypes.c_void_p]
        lib.mind_free.restype = None
        lib.mind_build_train.restype = ctypes.c_int64
        lib.mind_build_train.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_uint64,
            ctypes.POINTER(i32p), ctypes.POINTER(i32p), ctypes.POINTER(i32p),
        ]
        lib.mind_build_eval.restype = ctypes.c_int64
        lib.mind_build_eval.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(i32p), ctypes.POINTER(i32p), ctypes.POINTER(i64p),
            ctypes.POINTER(i64p), ctypes.POINTER(i32p), ctypes.POINTER(i8p),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.mind_batch_dedup.restype = ctypes.c_int64
        lib.mind_batch_dedup.argtypes = [
            i32p, ctypes.c_int64, i32p, ctypes.c_int64,
            i32p, ctypes.c_int64, i32p, i32p,
        ]
        lib.mind_tokenize_ids.restype = ctypes.c_int64
        lib.mind_tokenize_ids.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int32,
            i32p, ctypes.POINTER(ctypes.c_uint8),
        ]
        _lib = lib
        return lib


def available() -> bool:
    """Whether the C++ library is built and loaded (building it now if
    needed)."""
    return _load() is not None


def _take(lib, ptr, shape, dtype) -> np.ndarray:
    """Copies a malloc'd buffer into numpy and frees it."""
    n = int(np.prod(shape))
    if n == 0 or not ptr:
        if ptr:
            lib.mind_free(ptr)
        return np.zeros(shape, dtype)
    buf = np.ctypeslib.as_array(ptr, shape=(n,))
    out = np.array(buf, dtype=dtype, copy=True).reshape(shape)
    lib.mind_free(ptr)
    return out


def _index_blob(index: Dict[str, int]) -> bytes:
    """An id -> 1-based index dict as a ``'\\n'``-joined blob in index order
    (the C++ side rebuilds the same mapping)."""
    ordered = sorted(index.items(), key=lambda kv: kv[1])
    for i, (_, v) in enumerate(ordered):
        if v != i + 1:
            raise ValueError("the index dict must be dense and 1-based")
    return "\n".join(k for k, _ in ordered).encode("utf-8")


def build_train_samples(
    behaviors_path: str | pathlib.Path,
    news_index: Dict[str, int],
    user_index: Dict[str, int],
    history_len: int,
    sample_size: int,
    min_history: int,
    seed: int,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Train groups ``(browsed [n, H], cand [n, 1+K], user [n])``, or None
    when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    i32p = ctypes.POINTER(ctypes.c_int32)
    browsed_p, cand_p, user_p = i32p(), i32p(), i32p()
    n = lib.mind_build_train(
        str(behaviors_path).encode(), _index_blob(news_index),
        _index_blob(user_index), history_len, sample_size, min_history, seed,
        ctypes.byref(browsed_p), ctypes.byref(cand_p), ctypes.byref(user_p))
    if n < 0:
        raise FileNotFoundError(behaviors_path)
    browsed = _take(lib, browsed_p, (n, history_len), np.int32)
    cand = _take(lib, cand_p, (n, 1 + sample_size), np.int32)
    user = _take(lib, user_p, (n,), np.int32)
    return browsed, cand, user


def build_eval_split(
    behaviors_path: str | pathlib.Path,
    news_index: Dict[str, int],
    user_index: Dict[str, int],
    history_len: int,
    with_labels: bool,
) -> Optional[Tuple[np.ndarray, ...]]:
    """A ragged eval split ``(browsed, user, keys, offsets, cand_flat,
    label_flat)``, or None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i8p = ctypes.POINTER(ctypes.c_int8)
    browsed_p, user_p = i32p(), i32p()
    keys_p, offsets_p = i64p(), i64p()
    cand_p, label_p = i32p(), i8p()
    flat_len = ctypes.c_int64()
    m = lib.mind_build_eval(
        str(behaviors_path).encode(), _index_blob(news_index),
        _index_blob(user_index), history_len, int(with_labels),
        ctypes.byref(browsed_p), ctypes.byref(user_p), ctypes.byref(keys_p),
        ctypes.byref(offsets_p), ctypes.byref(cand_p), ctypes.byref(label_p),
        ctypes.byref(flat_len))
    if m < 0:
        raise FileNotFoundError(behaviors_path)
    n_flat = flat_len.value
    return (
        _take(lib, browsed_p, (m, history_len), np.int32),
        _take(lib, user_p, (m,), np.int32),
        _take(lib, keys_p, (m,), np.int64),
        _take(lib, offsets_p, (m + 1,), np.int64),
        _take(lib, cand_p, (n_flat,), np.int32),
        _take(lib, label_p, (n_flat,), np.int8),
    )


def tokenize_ids(
    texts: "list[str]",
    vocab: Dict[str, int],
    length: int,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Word ids of ``texts`` (lowercase, digits deleted, ``\\w+`` tokens,
    in-vocab words, truncated and padded to ``length``).

    Returns ``(ids [n, length] int32, fallback [n] uint8)``: a flagged row
    (non-ASCII text, where Python's unicode ``\\w`` and ``lower`` may differ
    from the byte rules) must be redone by the caller with the Python path,
    and the result is then the pure-Python loop's bit for bit. None when the
    library is unavailable or a text holds a newline (the rows' separator).
    """
    lib = _load()
    if lib is None:
        return None
    n = len(texts)
    ids = np.zeros((max(n, 1), length), np.int32)
    fallback = np.zeros(max(n, 1), np.uint8)
    if n == 0:
        return ids[:0], fallback[:0]
    if any("\n" in t for t in texts):
        return None
    blob = "\n".join(texts).encode("utf-8")
    i32p = ctypes.POINTER(ctypes.c_int32)
    rc = lib.mind_tokenize_ids(
        blob, n, _index_blob(vocab), length, ids.ctypes.data_as(i32p),
        fallback.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != n:
        return None
    return ids, fallback


def batch_dedup(
    browsed: np.ndarray, cand: np.ndarray,
) -> Optional[Tuple[int, np.ndarray, np.ndarray, np.ndarray]]:
    """Per-batch news dedup, equal bit for bit to ``np.unique(concat([0],
    browsed, cand), return_inverse=True)``: ``(u, uniq_buf, browsed_idx,
    cand_idx)`` with ``uniq_buf[:u]`` the ascending distinct ids (the pad id
    0 always among them), zero past ``u`` (``browsed.size + cand.size + 1``
    slots), and the index arrays ranks into it, shaped like the inputs.
    None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    browsed = np.ascontiguousarray(browsed, np.int32)
    cand = np.ascontiguousarray(cand, np.int32)
    nb, nc = browsed.size, cand.size
    cap = nb + nc + 1
    uniq = np.empty(cap, np.int32)
    bidx = np.empty(nb, np.int32)
    cidx = np.empty(nc, np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u = lib.mind_batch_dedup(
        browsed.ctypes.data_as(i32p), nb, cand.ctypes.data_as(i32p), nc,
        uniq.ctypes.data_as(i32p), cap,
        bidx.ctypes.data_as(i32p), cidx.ctypes.data_as(i32p))
    if u <= 0:
        raise RuntimeError("mind_batch_dedup failed")
    return int(u), uniq, bidx.reshape(browsed.shape), cidx.reshape(cand.shape)
