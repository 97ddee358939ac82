"""The port imports neither JAX nor the JAX package: at run time, and in its
source (the package, ``chip_smoke.py``, ``chip_profile.py`` and
``chip_ablate_encoder.py``). Importing it builds no kernel."""

import ast
import pathlib
import subprocess
import sys

import torch

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "pytorch_news_recommender_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pytorch_news_recommender_tpu")


def _modules():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PKG.rglob("*.py"))


def test_importing_every_module_loads_no_jax():
    mods = _modules()
    assert "pytorch_news_recommender_tpu_torch.serve" in mods and len(mods) >= 15
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "from pytorch_news_recommender_tpu_torch.ops import fused_encoder as FE\n"
        "assert FE._lib.cache_info().currsize == 0  # no kernel built on import\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=ROOT)


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_source_imports_nothing_of_jax():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "chip_profile.py",
                                         ROOT / "chip_ablate_encoder.py"]
    bad = [(str(f.relative_to(ROOT)), name) for f in files for name in _imports(f)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, bad
