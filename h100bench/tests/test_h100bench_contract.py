"""The benchmark's files against ``BENCHMARK.json``, discovery by name, the
result line's schema, and the isolation from JAX."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

from h100bench import core

ROOT = pathlib.Path(__file__).resolve().parents[1]
CHECKOUT = ROOT.parent
SPEC = json.loads((CHECKOUT / "BENCHMARK.json").read_text())


def test_every_entry_has_its_file_and_matches_it():
    bench = core.Bench()
    for c in SPEC["configs"]:
        d = json.loads((CHECKOUT / c["file"]).read_text())
        assert d["name"] == c["name"] and d["source"] == c["source"]
        assert d["reduced"] == c["reduced"]
    for w in SPEC["workloads"]:
        cell = bench.cell(w["name"])
        assert (cell.spec["config"], cell.spec["traffic"], cell.chips, cell.spec["why"]) == (
            w["config"], w["traffic"], w["chips"], w["why"])
    readers = bench.metrics()
    assert {m["name"] for m in SPEC["per_layer"]} <= set(readers)
    for m in SPEC["per_layer"]:
        r = readers[m["name"]]
        assert (r.LAYER, r.UNIT, r.BETTER, r.SOURCE, r.MOVES) == (
            m["layer"], m["unit"], m["better"], m["source"], m["moves"])
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_a_new_config_cell_and_metric_are_found_without_editing(tiny, runner):
    root = tiny.root
    cfg = json.loads((root / "configs" / "nrms-mind.json").read_text())
    cfg["name"] = "nrms-other"
    cfg["port"]["model"]["num_attention_heads"] = 5
    (root / "configs" / "nrms-other.json").write_text(json.dumps(cfg))
    cell = json.loads((root / "workloads" / "nrms-train-b512.json").read_text())
    cell.update(name="nrms-other-train", config="nrms-other")
    (root / "workloads" / "nrms-other-train.json").write_text(json.dumps(cell))
    (root / "metrics").unlink()
    shutil.copytree(ROOT / "metrics", root / "metrics")
    (root / "metrics" / "steps_traced.train.py").write_text(
        'LAYER = "train/loop.py"\nUNIT = "steps"\nBETTER = "higher"\n'
        'SOURCE = "program_counter"\nMOVES = "train_impressions_per_s"\n\n\n'
        'def read(rec):\n    return rec.counts.get("traced_steps")\n')
    out = runner(tiny, "nrms-other-train", trace=True)
    assert out["metrics"]["steps_traced.train"]["value"] == 2
    assert out["correct"] is True


def test_the_result_line_keeps_the_schema(tiny, runner):
    out = runner(tiny, "nrms-train-b512")
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(out["metrics"]) == {"train_impressions_per_s", "setup_s"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(out["device"])
    assert all({"value", "limit"} == set(c) for c in out["checks"].values())
    traced = runner(tiny, "nrms-train-b512", trace=True)
    assert list(traced)[-2:] == ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(traced["device"])
    assert "train_impressions_per_s" not in traced["metrics"]
    assert {"train_mfu_pct", "feed_wait_ms.train", "device_idle_pct.train"} <= set(
        traced["metrics"])
    assert all(len(v) <= 10 for v in traced["breakdown"].values())


def test_foreign_modules_compare_whole_top_level_names():
    assert core.foreign_modules(["pytorch_news_recommender_tpu_torch.serve", "jaxtyping",
                                 "flaxen", "torch"]) == []
    assert core.foreign_modules(["jax.numpy", "pytorch_news_recommender_tpu.config",
                                 "orbax.checkpoint"]) == [
        "jax", "orbax", "pytorch_news_recommender_tpu"]


def test_a_run_with_jax_loaded_prints_no_result(tiny, monkeypatch):
    from h100bench import run as R

    monkeypatch.setitem(sys.modules, "jax", sys.modules["json"])
    ctx = R.Context(tiny, tiny.cell("nrms-train-b512"), 3, 0.5, False, "cpu", 0.0)
    with pytest.raises(SystemExit):
        R.execute(ctx)


def test_the_reference_imports_neither_jax_nor_the_port():
    """Every module of ``reference/``, each family's among them, in a
    process of its own."""
    mods = sorted(p.stem for p in (ROOT / "reference").glob("*.py") if p.stem != "__init__")
    assert {"train", "serve", "nrms", "naml"} <= set(mods)
    code = ("import importlib, sys; sys.path.insert(0, %r)\n"
            "for m in %r: importlib.import_module('h100bench.reference.' + m)\n"
            "tops = {m.split('.')[0] for m in sys.modules}\n"
            "print(sorted(tops & {'jax', 'jaxlib', 'flax', 'optax', 'orbax',\n"
            "  'pytorch_news_recommender_tpu', 'pytorch_news_recommender_tpu_torch'}))"
            % (str(CHECKOUT), mods))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout
    assert out.strip() == "[]"


def test_a_cpu_run_loads_no_jax(tiny, tmp_path):
    """A whole run in a process of its own (the serving cell: the daemon,
    the client process and the reference) holds no JAX."""
    code = ("import sys, json, time; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
            "from conftest import tiny_bench, run_cell\n"
            "import pathlib\n"
            "out = run_cell(tiny_bench(pathlib.Path(%r)), 'nrms-serve-mixed', seconds=1.0)\n"
            "from h100bench import core\n"
            "print(json.dumps([out['correct'], core.foreign_modules()]))"
            % (str(CHECKOUT), str(ROOT / "tests"), str(tmp_path / "b2")))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [True, []]


def test_alone_the_benchmark_prints_no_result(tmp_path):
    """In a directory that holds only ``BENCHMARK.json`` and the benchmark's
    folder, a run fails and prints nothing on standard output."""
    shutil.copytree(ROOT, tmp_path / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "h100bench/run.py", "--workload", "nrms-train-b512",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.card
def test_a_cell_runs_correct_on_the_card(card):
    out = subprocess.run([sys.executable, str(ROOT / "run.py"), "--workload", "nrms-train-b512",
                          "--seed", str(2 ** 31 + 99), "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, timeout=1200, cwd=CHECKOUT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True
