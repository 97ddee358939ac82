"""The op layer's seam to its CUDA library (``ops/kernels.py``), on the CPU:
every C function an op module declares is defined once under ``ops/csrc``,
with the argument and result types of its declaration, so that a ``ctypes``
binding that disagrees with its C function fails here and not on the card.
Nothing is built."""

import ctypes
import importlib
import pathlib
import pkgutil
import re

import pytest

from pytorch_news_recommender_tpu_torch import ops
from pytorch_news_recommender_tpu_torch.ops import kernels as K

# a C function at the start of a line: result type, name, parameters, then
# its body ("{") or the end of a declaration (";")
C_FUNCTION = re.compile(
    r"^((?:const\s+)?\w+\s*\**)\s*(newsrec_\w+)\s*\(([^)]*)\)\s*([{;])", re.M)
C_TYPES = {"int": ctypes.c_int, "long": ctypes.c_long, "unsigned": ctypes.c_uint32,
           "float": ctypes.c_float, "void": None, "const char*": ctypes.c_char_p}
POINTER = "pointer"


def _c_type(text: str):
    text = " ".join(text.replace("*", "* ").split()).replace(" *", "*")
    if text.endswith("*") and text != "const char*":
        return POINTER
    return C_TYPES[text]


def _c_params(text: str):
    params = [p.strip() for p in text.split(",")]
    if params in ([""], ["void"]):
        return []
    return [_c_type(re.match(r"(.*?)\w+$", p, re.S).group(1)) for p in params]


def _py_type(t):
    if t is ctypes.c_void_p or (t is not None and issubclass(t, ctypes._Pointer)):
        return POINTER
    return t


def test_every_declared_function_is_defined_once_with_its_types():
    """Imports every op module, so that each declares its C functions, and
    parses the library's sources: each declared ``newsrec_*`` function has a
    body in exactly one ``.cu`` file and takes the declaration's argument
    and result types, as does every prototype of it in another file. A
    function that only C calls needs no declaration; a second declaration
    of a name is refused."""
    for mod in pkgutil.iter_modules(ops.__path__):
        importlib.import_module(f"{ops.__name__}.{mod.name}")
    assert "newsrec_cuda_error_string" in K.DECLARED and len(K.DECLARED) >= 20
    before = dict(K.DECLARED)
    with pytest.raises(ValueError, match="declared twice"):
        K.declare("newsrec_cuda_error_string", [ctypes.c_int], ctypes.c_char_p)
    assert K.DECLARED == before

    bodies, prototypes = {}, {}
    for src in K.SOURCES:
        for ret, name, params, end in C_FUNCTION.findall(src.read_text()):
            found = bodies if end == "{" else prototypes
            found.setdefault(name, []).append((src.name, _c_type(ret), _c_params(params)))
    # every source under csrc builds, so a new kernel edits no shared list
    assert K.SOURCES == sorted((pathlib.Path(K.__file__).parent / "csrc").glob("*.cu"))
    for name, (argtypes, restype) in K.DECLARED.items():
        assert len(bodies.get(name, [])) == 1, f"{name} has bodies in {bodies.get(name)}"
        src, ret, params = bodies[name][0]
        assert len(argtypes) == len(params), f"{name}: {len(argtypes)} argtypes, {src} " \
                                             f"takes {len(params)} parameters"
        assert [_py_type(t) for t in argtypes] == params, f"{name}'s argtypes against {src}"
        assert _py_type(restype) == ret, f"{name}'s restype against {src}"
    for name, protos in prototypes.items():
        assert len(bodies.get(name, [])) == 1, f"{name} is declared in C but has no one body"
        for src, ret, params in protos:
            assert (ret, params) == bodies[name][0][1:], f"{name}'s prototype in {src}"
