"""The mesh's model axis (``parallel/mesh.py``, ``parallel/sharded_embedding.py``,
``distributed.mesh_groups``, the ``Trainer`` and checkpoints on a ``(n_data,
n_model)`` process mesh) against the JAX package on its virtual CPU mesh.

The port's side runs in two spawns of OS processes over ``gloo`` (two ranks:
a ``(1, 2)`` mesh; four ranks: ``(2, 2)``, and ``(1, 4)`` for the lookups):
each rank writes its results to ``.npz`` files, which the tests hold to the
JAX package's ``sharded_embedding_lookup`` / ``_a2a`` and ``Trainer`` on a
mesh of the same shape (``tests/conftest.py``'s 8 CPU devices), and to one
process of the port."""

import functools
import json
import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_news_recommender_tpu.config import MeshConfig as JaxMeshConfig
from pytorch_news_recommender_tpu.config import synthetic_config as jax_synthetic_config
from pytorch_news_recommender_tpu.data import loader as jloader
from pytorch_news_recommender_tpu.data import synthetic as jax_synthetic
from pytorch_news_recommender_tpu.parallel import mesh as jmesh
from pytorch_news_recommender_tpu.parallel.sharded_embedding import (
    sharded_embedding_lookup as jax_psum,
    sharded_embedding_lookup_a2a as jax_a2a,
)
from pytorch_news_recommender_tpu.train import loop as jax_loop
from pytorch_news_recommender_tpu_torch import cli
from pytorch_news_recommender_tpu_torch.config import MeshConfig, synthetic_config
from pytorch_news_recommender_tpu_torch.data import loader, synthetic
from pytorch_news_recommender_tpu_torch.models.convert import from_flax, load_params, save_params
from pytorch_news_recommender_tpu_torch.ops import fused_encoder as FE
from pytorch_news_recommender_tpu_torch.parallel import mesh as pmesh
from pytorch_news_recommender_tpu_torch.train.checkpoint import CheckpointManager
from pytorch_news_recommender_tpu_torch.train.loop import Trainer

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parents[1]
# The cases and inputs, shared by the test process and the ranks' worker
# (which imports neither JAX nor this file: it runs this text).
_SHARED = r'''
import numpy as np
from pytorch_news_recommender_tpu_torch.config import synthetic_config
from pytorch_news_recommender_tpu_torch.data import synthetic

BASE = {"model.dropout": 0.0, "train.dedup_batches": True,
        "train.unique_buckets": [256, 512, 1024]}
GEN = dict(seed=3, n_train=96, n_dev=24)
FAMILY = {  # family -> (config overrides, data beside GEN)
    "nrms": ({}, {}),
    "nrms_entity": ({"model.name": "nrms_entity"}, dict(n_entities=31, entity_dim=16)),
    "nrms_bert": ({"model.name": "nrms_bert"}, dict(n_news=399, bert_dim=64)),
    "split": ({}, dict(title_len=(11.5, 3.5))),
    "wide": ({"model.word_embed_size": 128, "model.query_vector_dim": 32}, {}),
}
# the lookup cases: JAX's tests/test_sharded_embedding.py inputs
LOOKUPS = {
    "uniform": (0, dict(kind="uniform"), None),
    "overflow": (1, dict(kind="overflow"), 1.0),
    "pads": (0, dict(kind="pads"), 1.0),
}
LOOKUP_SHAPES = ((1, 2), (2, 2), (1, 4))
SCHEDULES = ("auto", "psum", "a2a")

def _lookup_inputs(case):
    seed, spec, _ = LOOKUPS[case]
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((64, 16)).astype(np.float32)
    if spec["kind"] == "uniform":
        ids = rng.integers(0, 64, size=(8, 5)).astype(np.int32)
    elif spec["kind"] == "overflow":
        ids = rng.integers(48, 64, size=(8, 8)).astype(np.int32)
    else:
        ids = np.asarray([0, 16, 32, 48, 1, 17, 33, 49, 2], np.int32)
    return table, ids


def _factor(case, n_model):
    f = LOOKUPS[case][2]
    return float(n_model) if f is None else f


def _cfg(family, **over):
    return synthetic_config(**{**BASE, **FAMILY[family][0], **over})


def _data(family, mod=synthetic, cfg=None):
    cfg = cfg or _cfg(family)
    return mod.generate(cfg.data, **{**GEN, **FAMILY[family][1]})

OPT_CASES = {
    "adam_clip": {"train.grad_clip_norm": 0.05},
    "adafactor": {"train.optimizer": "adafactor"},
}


def _norm(tr, state, batch):
    """The optimizer's global gradient norm of one step's gradients (its
    first update is ``lr * g / |g|`` whatever the clipping's scale)."""
    from pytorch_news_recommender_tpu_torch.train.loop import training_loss
    model = state.model
    model.zero_grad(set_to_none=True)
    training_loss(model, model(tr._to_device(batch), tr.news_feats)).backward()
    norm = float(state.opt.global_norm({n: p.grad for n, p in model.named_parameters()}))
    model.zero_grad(set_to_none=True)
    return norm
'''
exec(_SHARED)

STEP_TOL = dict(rtol=2e-4, atol=2e-5)   # tests/test_sharding.py's
JAX_TOL = dict(rtol=2e-4, atol=1e-4)    # the port's one-process step against JAX
LR = synthetic_config().train.learning_rate
_CLUSTER_VARS = ["WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK",
                 "SLURM_NTASKS", "SLURM_NPROCS", "SLURM_PROCID", "NEWSREC_NO_DISTRIBUTED"]


# ---- the ranks' work ------------------------------------------------------------

_WORKER = r"""
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from pytorch_news_recommender_tpu_torch.parallel import distributed

coord, world, rank, inp, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
assert distributed.initialize(coord, world, rank, backend="gloo")
import shared as T
from pytorch_news_recommender_tpu_torch import cli
from pytorch_news_recommender_tpu_torch.data.loader import local_block, train_batches_sliced
from pytorch_news_recommender_tpu_torch.models import layers
from pytorch_news_recommender_tpu_torch.models.convert import load_params
from pytorch_news_recommender_tpu_torch.parallel import sharded_embedding as SE
from pytorch_news_recommender_tpu_torch.parallel.distributed import MeshGroups, mesh_groups
from pytorch_news_recommender_tpu_torch.train.checkpoint import CheckpointManager
from pytorch_news_recommender_tpu_torch.train.loop import Trainer, step_generator

res = {"rank": rank}

def save(name, arrays):
    np.savez(f"{out}/{name}_r{rank}.npz", **{k: np.asarray(v) for k, v in arrays.items()})

def state_arrays(state, m=None):
    d = {k: v.detach().numpy() for k, v in state.params.items()}
    if m is not None:
        d["__loss"] = np.float32(m["loss"])
    return d

def trainer(family, **over):
    cfg = T._cfg(family, **over)
    return Trainer(cfg, T._data(family, cfg=cfg), device="cpu")

def first_batch(tr, i=0, rng=2):
    for j, b in enumerate(tr.sliced_batches(np.random.default_rng(rng))):
        if j == i:
            return b

# ---- the lookups: (1, 2) on the model groups of (2, 2), (2, 2), (1, 4)
if world == 4:
    for nd, nm in T.LOOKUP_SHAPES:
        if (nd, nm) == (1, 2):
            g = mesh_groups(2)
            mesh = MeshGroups(1, 2, 0, g.model_index, distributed.SOLO, g.model_group)
        else:
            mesh = mesh_groups(nm)
        d = mesh.data_index
        for case in T.LOOKUPS:
            table, ids = T._lookup_inputs(case)
            flat = ids.reshape(-1)
            chunk = nd * nm
            padded = np.concatenate([flat, np.zeros((-len(flat)) % chunk, np.int32)])
            n_local = len(padded) // nd
            local = torch.from_numpy(padded[d * n_local:(d + 1) * n_local])
            n_valid = int(np.clip(len(flat) - d * n_local, 0, n_local))
            rows = 64 // nm
            full = torch.from_numpy(table)
            r = {}
            for sched in ("psum", "a2a"):
                block = full[mesh.model_index * rows:(mesh.model_index + 1) * rows].clone()
                block.requires_grad_(True)
                if sched == "psum":
                    o = SE.sharded_embedding_lookup(block, local, mesh)
                    dropped = 0
                else:
                    o, dropped = SE.sharded_embedding_lookup_a2a(
                        block, local, mesh, capacity_factor=T._factor(case, nm),
                        n_valid=n_valid)
                    dropped = int(dropped)
                (o[:n_valid] ** 2).sum().backward()
                plain = full.clone().requires_grad_(True)
                (torch.nn.functional.embedding(local[:n_valid].long(), plain) ** 2).sum().backward()
                want = plain.grad[mesh.model_index * rows:(mesh.model_index + 1) * rows]
                r[sched] = {"out": o.detach().numpy()[:n_valid], "dropped": dropped,
                            "grad_err": float((block.grad - want).abs().max())
                            if dropped == 0 else None}
            save(f"lookup_{nd}x{nm}_{case}", {f"{s}_out": r[s]["out"] for s in r})
            res[f"lookup_{nd}x{nm}_{case}"] = {
                "data_index": d, "model_index": mesh.model_index,
                "dropped": r["a2a"]["dropped"],
                "grad_err": {s: r[s]["grad_err"] for s in r}}

# ---- one NRMS step under each schedule (dedup batch, dropout 0)
mp = 2
for sched in T.SCHEDULES:
    tr = trainer("nrms", **{"model.embedding_lookup": sched, "mesh.model_parallel_size": mp})
    state = tr.init_state(params=load_params(inp + "/params_nrms.npz"))
    b = first_batch(tr)
    res["dedup"] = "unique_ids" in b
    state, m = tr.run_step(state, b)
    tr.check_replicas(state)
    save(f"step_{sched}", state_arrays(state, m))
    if world == 2:
        # the two-tower eval: the corpus encoded through the schedule's lookups
        res[f"eval_{sched}"] = tr.evaluate(state)

# ---- a2a overflow: a NaN loss, never silent
tr = trainer("nrms", **{"model.embedding_lookup": "a2a", "model.a2a_capacity_factor": 0.02,
                        "mesh.model_parallel_size": mp})
_, m = tr.run_step(tr.init_state(params=load_params(inp + "/params_nrms.npz")), first_batch(tr))
res["overflow_loss"] = float(m["loss"])

if world == 4:
    # a length-split step at (2, 2)
    tr = trainer("split", **{"mesh.model_parallel_size": mp, "model.embedding_lookup": "a2a"})
    tr._length_split = tr._length_split.__class__(tr._length_split.feat_lens,
                                                  tr._length_split.thresholds, grid=64)
    b = first_batch(tr, rng=0)
    res["split_marked"] = "short_mark" in b
    state = tr.init_state(params=load_params(inp + "/params_split.npz"))
    state, m = tr.run_step(state, b)
    save("split", state_arrays(state, m))
    # dropout 0.2: every tower call's seed folds the data index
    tr = trainer("nrms", **{"model.dropout": 0.2, "mesh.model_parallel_size": mp})
    seeds, real = [], layers.fused_news_encoder
    def record(*a, **k):
        if k.get("dropout_rate", 0.0) > 0:
            seeds.append(int(k["seed"]))
        return real(*a, **k)
    layers.fused_news_encoder = record
    state = tr.init_state(seed=0)
    for i, b in zip(range(3), tr.sliced_batches(np.random.default_rng(0))):
        n0 = len(seeds)
        g = step_generator(tr.cfg.train.seed + 1, state.step)
        state, _ = tr.run_step(state, b)
        draws = [int(torch.randint(0, 2 ** 31 - 1, (), generator=g)) for _ in seeds[n0:]]
        res.setdefault("drop_seeds", []).append([seeds[n0:], draws])
    layers.fused_news_encoder = real
    tr.check_replicas(state)
    res["drop_data_index"] = tr.data_idx
    params = dict(state.model.named_parameters())
    res["drop_checksum"] = [float(sum(p.double().sum() for n, p in params.items()
                                      if (n in state.opt.blocks) == b)) for b in (False, True)]
else:
    # a whole table whose rows do not divide the axis, under psum and a2a:
    # padded and cut to the rank's block in the lookup (JAX's in-trace pad)
    gen = torch.Generator().manual_seed(4)
    ids = torch.randint(0, 63, (8, 5), generator=gen)
    whole = torch.randn(63, 16, generator=gen)
    plain = whole.clone().requires_grad_(True)
    want = torch.nn.functional.embedding(ids, plain) * (ids != 0)[..., None]
    (want ** 2).sum().backward()
    for sched in ("psum", "a2a"):
        table = whole.clone().requires_grad_(True)
        got = SE.scheduled_lookup(table, ids, (ids != 0).float(), torch.float32, sched,
                                  mesh=mesh_groups(2))
        (got ** 2).sum().backward()
        res[f"padded_{sched}"] = [float((got - want).abs().max()),
                                  float((table.grad - plain.grad).abs().max())]
    # the entity and BERT tables, row-sharded, through the psum lookup
    for fam in ("nrms_entity", "nrms_bert"):
        tr = trainer(fam, **{"mesh.model_parallel_size": mp})
        state = tr.init_state(params=load_params(inp + f"/params_{fam}.npz"))
        res[f"{fam}_blocks"] = {k: [v.start, v.rows, v.full_rows]
                                for k, v in state.opt.blocks.items()}
        state, m = tr.run_step(state, first_batch(tr))
        save(f"step_{fam}", state_arrays(state, m))
    # Adam with global-norm clipping, and Adafactor, on a 128-wide model
    for name, over in T.OPT_CASES.items():
        tr = trainer("wide", **{**over, "mesh.model_parallel_size": mp})
        state = tr.init_state(params=load_params(inp + "/params_wide.npz"))
        if name == "adam_clip":
            res["norm"] = T._norm(tr, state, first_batch(tr))
        state, m = tr.run_step(state, first_batch(tr))
        save(f"opt_{name}", state_arrays(state, m))
        if name == "adam_clip":
            # a checkpoint written at (1, 2): rank 0 writes the whole tables;
            # a data-parallel Trainer built meanwhile changes neither the
            # groups it joins over nor the eval's lookups
            trainer("wide", **over)
            CheckpointManager(out + "/ckpt", tr.cfg).save(state.step, state, {"auc": 0.5})
            res["ckpt_auc"] = tr.evaluate(state)["auc"]
    # a one-process checkpoint resumed at (1, 2), then one more step
    tr = trainer("wide", **{**T.OPT_CASES["adam_clip"], "mesh.model_parallel_size": mp})
    state = CheckpointManager(inp + "/ckpt1").restore(tr.init_state(seed=7))
    res["resumed_step"] = state.step
    state, m = tr.run_step(state, first_batch(tr, i=1))
    save("resumed", state_arrays(state, m))
    # the CLI on the two ranks
    assert cli.main(["train", "--data", "synthetic", "--epochs", "1", "--batch-size", "256",
                     "--device", "cpu", "--save-dir", out + "/cli", "--model-parallel", "2"]) == 0
    assert cli.main(["submit", "--data", "synthetic", "--ckpt", out + "/cli/nrms", "--device",
                     "cpu", "--out", out + "/submission.txt", "--model-parallel", "2"]) == 0
# every rank past its last collective, then out without the interpreter's
# teardown (gloo's threads may abort it once a peer has gone)
distributed.barrier()
print("RESULT " + json.dumps(res), flush=True)
os._exit(0)
"""

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(inp, out, world):
    """Runs the worker as the ranks of a ``world``-rank gloo group; returns
    their RESULT lines by rank."""
    coord = f"127.0.0.1:{_free_port()}"
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "",
           "PYTHONPATH": os.pathsep.join([str(REPO)] + sys.path[1:])}
    for k in _CLUSTER_VARS:
        env.pop(k, None)
    (out / "shared.py").write_text(_SHARED)
    script = out / "worker.py"
    script.write_text(_WORKER)
    procs = [subprocess.Popen([sys.executable, str(script), coord, str(world), str(r), str(inp),
                               str(out)], env=env, cwd=out, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(world)]
    results = {}
    try:
        for p in procs:
            stdout, err = p.communicate(timeout=400)
            if p.returncode != 0:
                pytest.fail(f"worker rc={p.returncode}\nstdout:{stdout[-3000:]}\n"
                            f"stderr:{err[-6000:]}")
            for line in stdout.splitlines():
                if line.startswith("RESULT "):
                    r = json.loads(line[len("RESULT "):])
                    results[r["rank"]] = r
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert set(results) == set(range(world)), results
    return results


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Weights every rank starts from (the Flax init of each family), and a
    one-process checkpoint after one step, for the resume."""
    d = tmp_path_factory.mktemp("inputs")
    for fam in ("nrms", "nrms_entity", "nrms_bert", "split", "wide"):
        save_params(d / f"params_{fam}.npz", from_flax(_jax_params(fam)))
    cfg = _cfg("wide", **OPT_CASES["adam_clip"])
    tr = Trainer(cfg, _data("wide", cfg=cfg), device="cpu")
    state = tr.init_state(params=load_params(d / "params_wide.npz"))
    state, _ = tr.run_step(state, next(tr.sliced_batches(np.random.default_rng(2))))
    CheckpointManager(d / "ckpt1", cfg).save(state.step, state, {"auc": 0.5})
    return d


@pytest.fixture(scope="module")
def two(inputs, tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh1x2")
    return out, _spawn(inputs, out, 2)


@pytest.fixture(scope="module")
def four(inputs, tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh2x2")
    return out, _spawn(inputs, out, 4)


def _rank(out, name, r):
    with np.load(out / f"{name}_r{r}.npz") as z:
        return {k: z[k] for k in z.files}


# ---- mesh and rules ---------------------------------------------------------------

def test_make_mesh_fills_devices_row_major_as_jax():
    """``make_mesh`` lays devices out as JAX's does, and raises JAX's
    ``ValueError`` when the model axis does not divide them."""
    devs = [f"cpu:{i}" for i in range(8)]
    for mp in (1, 2, 4):
        ours = pmesh.make_mesh(MeshConfig(model_parallel_size=mp), devs)
        theirs = jmesh.make_mesh(JaxMeshConfig(model_parallel_size=mp), jax.devices())
        assert ours.shape == dict(theirs.shape) and ours.axis_names == theirs.axis_names
        np.testing.assert_array_equal(np.vectorize(lambda d: d.index)(ours.devices),
                                      np.vectorize(lambda d: d.id)(theirs.devices))
    with pytest.raises(ValueError, match="n_devices=3 not divisible by model_parallel_size=2"):
        pmesh.make_mesh(MeshConfig(model_parallel_size=2), devs[:3])
    with pytest.raises(ValueError, match="n_devices=3 not divisible by model_parallel_size=2"):
        JaxMeshConfig(model_parallel_size=2).mesh_shape(3)


@pytest.mark.parametrize("name,shape,n_model,sharded", [
    ("news_encoder.word_embedding.embedding", (600, 64), 2, True),
    ("bert_embedding.embedding", (400, 64), 4, True),
    ("entity_embedding.embedding", (32, 16), 2, True),
    ("news_encoder.word_embedding.embedding", (601, 64), 2, False),   # spec_fits
    ("news_encoder.word_embedding.embedding", (600,), 2, False),      # a 1-D moment
    ("news_encoder.word_embedding.embedding", (600, 64), 1, False),
    ("news_encoder.tower.wqkv", (64, 192), 2, False),
    ("category_embedding.embedding", (8, 16), 2, False),
])
def test_row_sharding_rules_follow_jax(name, shape, n_model, sharded):
    """Each rule and ``spec_fits`` fallback: the port's ``row_sharded`` is
    JAX's ``param_shardings`` spec on the same path and shape."""
    assert pmesh.row_sharded(name, shape, n_model) is sharded
    mesh = jmesh.make_mesh(JaxMeshConfig(model_parallel_size=n_model), jax.devices()[:n_model * 2])
    tree = {}
    node = tree
    *parents, leaf = name.split(".")
    for p in parents:
        node = node.setdefault(p, {})
    node[leaf] = np.zeros(shape, np.float32)
    spec = jax.tree_util.tree_leaves(jmesh.param_shardings(tree, mesh),
                                     is_leaf=lambda x: hasattr(x, "spec"))[0].spec
    # a 1-wide model axis splits nothing, whatever the spec
    assert (spec == jax.sharding.PartitionSpec("model", None) and n_model > 1) is sharded


# ---- the lookups against JAX --------------------------------------------------------

def _jax_lookup(nd, nm, case):
    table, ids = _lookup_inputs(case)
    mesh = jmesh.make_mesh(JaxMeshConfig(model_parallel_size=nm), jax.devices()[:nd * nm])
    # JAX's psum lookup splits the ids over the data axis without padding:
    # where they do not divide it, the port's psum is held to jnp.take
    out_p = (jax_psum(jnp.asarray(table), jnp.asarray(ids), mesh) if ids.size % nd == 0
             else jnp.take(jnp.asarray(table), jnp.asarray(ids), axis=0))
    out_a, dropped = jax_a2a(jnp.asarray(table), jnp.asarray(ids), mesh,
                             capacity_factor=_factor(case, nm))
    D = table.shape[1]
    return (np.asarray(out_p).reshape(-1, D), np.asarray(out_a).reshape(-1, D),
            int(dropped), table, ids)


@pytest.mark.parametrize("case", list(LOOKUPS))
@pytest.mark.parametrize("nd,nm", LOOKUP_SHAPES)
def test_lookups_equal_jax(four, nd, nm, case):
    """psum and a2a outputs equal JAX's exactly on every rank (its data
    row's rows), ``dropped`` (summed over the data rows) equals JAX's,
    overflow and pad slots included, and each rank's block gradient equals
    the plain lookup's rows (1e-6) where nothing was dropped."""
    out, res = four
    out_p, out_a, dropped, table, ids = _jax_lookup(nd, nm, case)
    key = f"lookup_{nd}x{nm}_{case}"
    n_local = -(-ids.size // (nd * nm)) * nm
    for r, rr in res.items():
        info = rr[key]
        if nd == 1 and r >= nm:
            continue   # the (1, 2) cases ran on both data rows of (2, 2)
        got = _rank(out, key, r)
        rows = slice(info["data_index"] * n_local, info["data_index"] * n_local + n_local)
        np.testing.assert_array_equal(got["psum_out"], out_p[rows])
        np.testing.assert_array_equal(got["a2a_out"], out_a[rows])
        assert info["grad_err"]["psum"] < 1e-6
        if info["dropped"] == 0:
            assert info["grad_err"]["a2a"] < 1e-6
    total = sum(rr[key]["dropped"] for r, rr in res.items()
                if rr[key]["model_index"] == 0 and (nd > 1 or r < nm))
    assert total == dropped
    if case == "overflow":
        assert dropped > 0
    if case == "pads":
        assert dropped == 0


# ---- one training step against the JAX Trainer ----------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_params(family):
    """Flax init params (seed 0, pretrained tables applied) of ``family``."""
    jcfg = jax_synthetic_config(**{**BASE, **FAMILY[family][0]})
    jtr = jax_loop.Trainer(jcfg, _data(family, jax_synthetic, jcfg))
    return jax.device_get(jtr.init_state(seed=0).params)


def _jax_step(family, nd, nm, batch, **over):
    jcfg = jax_synthetic_config(**{**BASE, **FAMILY[family][0], **over,
                                   "mesh.model_parallel_size": nm})
    mesh = jmesh.make_mesh(jcfg.mesh, jax.devices()[:nd * nm])
    jtr = jax_loop.Trainer(jcfg, _data(family, jax_synthetic, jcfg), mesh=mesh)
    state = jtr.init_state(seed=0)
    state, m = jtr.run_step(state, batch, jax.random.PRNGKey(1))
    return float(m["loss"]), {k.replace(".", "/"): v for k, v in
                              from_flax(jax.device_get(state.params)).items()}


def _global_batch(family, length_split=None, rng=2):
    cfg = _cfg(family)
    batch = next(jloader.train_batches(_data(family, jax_synthetic).train,
                                       cfg.train.batch_size, np.random.default_rng(rng),
                                       dedup=True, unique_buckets=cfg.train.unique_buckets,
                                       length_split=length_split))
    assert "unique_ids" in batch
    return batch


def _port_step(family, nd, **over):
    """One process of the port on the same global batch (``replay_ranks``
    = ``nd``: every data row's block), from the same weights."""
    cfg = _cfg(family, **over)
    tr = Trainer(cfg, _data(family, cfg=cfg), device="cpu", replay_ranks=nd)
    if family == "split":
        tr._length_split = loader.LengthSplit(tr._length_split.feat_lens,
                                              tr._length_split.thresholds, grid=64)
    state = tr.init_state(params=from_flax(_jax_params(family)))
    batch = next(tr.sliced_batches(np.random.default_rng(0 if family == "split" else 2)))
    state, m = tr.run_step(state, batch)
    return float(m["loss"]), {k.replace(".", "/"): v for k, v in state.params.items()}


def _hold_step(out, res, name, nm, refs):
    """Every rank's loss (1e-5) and parameters after the update (each
    table's block against its rows of the whole table) against each
    ``(loss, params, tolerance)`` of ``refs``; the replicated parameters
    are the same bits on every rank, each block on its data group. The
    key projections' bias (the middle third of ``bqkv``) has an exact
    gradient of 0: Adam's first step turns each run's float32 noise into up
    to +-lr, so it is held to that bound."""
    got = {r: _rank(out, name, r) for r in res}
    n_blocks = 0
    for r, arrays in got.items():
        for loss, params, tol in refs:
            assert float(arrays["__loss"]) == pytest.approx(loss, abs=1e-5)
        for k, v in arrays.items():
            if k == "__loss":
                continue
            whole = params[k.replace(".", "/")].shape
            if v.shape != whole:
                assert v.shape[0] * nm == whole[0], k
                rows = slice((r % nm) * v.shape[0], (r % nm + 1) * v.shape[0])
                n_blocks += 1
                np.testing.assert_array_equal(v, got[r % nm][k], err_msg=k)
            else:
                rows = slice(None)
                np.testing.assert_array_equal(v, got[0][k], err_msg=k)
            for _, params, tol in refs:
                want = params[k.replace(".", "/")].numpy()[rows]
                mine = v
                if k.endswith("bqkv"):
                    mine, want = v.copy(), want.copy()
                    key = slice(v.shape[0] // 3, 2 * v.shape[0] // 3)
                    assert np.abs(v[key]).max() <= LR * (1 + 1e-6)
                    mine[key] = want[key] = 0.0
                np.testing.assert_allclose(mine, want, err_msg=f"{name} rank {r} {k}", **tol)
    assert n_blocks >= len(res)


def _refs(family, nd, batch, **over):
    """The port's one-process step (held at the JAX package's own
    sharded-vs-unsharded tolerance) and the JAX Trainer's step on a mesh of
    the same shape (held where the port's one-process step meets it: Adam
    turns a noise-level gradient, as the user tower's ``ab`` has, into an
    update of up to lr, and the two packages' float32 noise differs by up
    to 3.7e-5 there)."""
    return [(*_port_step(family, nd, **over), STEP_TOL),
            (*_jax_step(family, nd, 2, batch, **over), JAX_TOL)]


@pytest.mark.parametrize("sched", SCHEDULES)
def test_step_at_1x2_matches_jax_trainer(two, sched):
    """One NRMS step on a dedup batch at dropout 0 under ``sched`` on a (1,
    2) mesh: the ranks' loss and parameters against one process and the
    JAX Trainer on a (1, 2) mesh."""
    out, res = two
    assert all(r["dedup"] for r in res.values())
    over = {"model.embedding_lookup": sched}
    _hold_step(out, res, f"step_{sched}", 2, _refs("nrms", 1, _global_batch("nrms"), **over))


@pytest.mark.parametrize("sched", SCHEDULES)
def test_eval_at_1x2_matches_one_process(two, sched):
    """After the step, the ranks' evaluation (the corpus encoded through
    ``sched``'s lookups, the score blocks gathered) equals one process's
    evaluation of the same parameters, the ranks' blocks joined."""
    out, res = two
    cfg = _cfg("nrms")
    tr = Trainer(cfg, _data("nrms", cfg=cfg), device="cpu")
    blocks = [_rank(out, f"step_{sched}", r) for r in (0, 1)]
    params = {k: torch.from_numpy(np.concatenate([b[k] for b in blocks]) if k.endswith(
        "word_embedding.embedding") else v) for k, v in blocks[0].items() if k != "__loss"}
    want = tr.evaluate(params)
    for r in res.values():
        got = r[f"eval_{sched}"]
        assert got["n_impressions"] == want["n_impressions"]
        for k in ("auc", "mrr", "ndcg@5", "ndcg@10"):
            assert got[k] == pytest.approx(want[k], abs=1e-6), k


@pytest.mark.parametrize("sched", SCHEDULES)
def test_step_at_2x2_matches_jax_trainer(four, sched):
    """As at (1, 2), on a (2, 2) mesh: each data row its half of the global
    batch."""
    out, res = four
    assert all(r["dedup"] for r in res.values())
    over = {"model.embedding_lookup": sched}
    _hold_step(out, res, f"step_{sched}", 2, _refs("nrms", 2, _global_batch("nrms"), **over))


def test_a2a_overflow_poisons_the_loss(two, four):
    """Capacity factor 0.02: a NaN loss on every rank, never silent zeros
    (the JAX package's ``test_a2a_schedule_overflow_poisons_not_silent``)."""
    for _, res in (two, four):
        assert all(np.isnan(r["overflow_loss"]) for r in res.values())


def test_length_split_step_at_2x2_matches_jax(four):
    """A dedup + length-split step (a2a lookups) at (2, 2) is finite and
    matches the JAX Trainer's step on the same mesh shape and batch."""
    out, res = four
    assert all(r["split_marked"] for r in res.values())
    jcfg = jax_synthetic_config(**{**BASE, "mesh.model_parallel_size": 2})
    jtr = jax_loop.Trainer(jcfg, _data("split", jax_synthetic, jcfg))
    split = jloader.LengthSplit(jtr._length_split.feat_lens, jtr._length_split.thresholds,
                                grid=64)
    batch = _global_batch("split", split, rng=0)
    assert "short_mark" in batch
    refs = _refs("split", 2, batch, **{"model.embedding_lookup": "a2a"})
    assert np.isfinite(refs[1][0])
    _hold_step(out, res, "split", 2, refs)


@pytest.mark.parametrize("sched", ["psum", "a2a"])
def test_whole_table_pads_to_the_axis_in_the_lookup(two, sched):
    """A replicated table whose 63 rows do not divide the axis (JAX's
    ``spec_fits`` fallback) still takes the ``sched`` lookup: zero-padded
    and cut to each rank's block in the lookup, as JAX pads in-trace. The
    values equal the plain masked lookup's exactly, and each rank's table
    gradient is the whole plain gradient (1e-6): the blocks' parts summed
    over the model group."""
    _, res = two
    for r in res.values():
        out_err, grad_err = r[f"padded_{sched}"]
        assert out_err == 0.0 and grad_err < 1e-6


def test_dropout_seeds_fold_the_data_index(four):
    """Dropout 0.2 at (2, 2): every news-tower call's seed is the step
    generator's draw folded with the rank's data index, so model peers draw
    the same masks; they end with the same parameters, and the two data
    rows draw different seeds."""
    _, res = four
    for r, rr in res.items():
        assert rr["drop_data_index"] == r // 2
        for seeds, draws in rr["drop_seeds"]:
            assert seeds and seeds == [FE.shard_seed(x, r // 2) for x in draws]
    for r in (1, 3):
        assert res[r]["drop_seeds"] == res[r - 1]["drop_seeds"]
    assert res[0]["drop_seeds"] != res[2]["drop_seeds"]
    # the replicated parameters alike on every rank, each block on its data group
    assert len({rr["drop_checksum"][0] for rr in res.values()}) == 1
    for r in (2, 3):
        assert res[r]["drop_checksum"][1] == res[r - 2]["drop_checksum"][1]


@pytest.mark.parametrize("family", ["nrms_entity", "nrms_bert"])
def test_entity_and_bert_tables_step_at_1x2(two, family):
    """The entity table and nrms_bert's trainable BERT table, row-sharded,
    look up through the psum path: one step matches the JAX Trainer's on a
    (1, 2) mesh."""
    out, res = two
    for r in res:
        table = f"{'entity' if family == 'nrms_entity' else 'bert'}_embedding.embedding"
        assert table in res[r][f"{family}_blocks"]
    _hold_step(out, res, f"step_{family}", 2, _refs(family, 1, _global_batch(family)))


def _one_process_step(name):
    cfg = _cfg("wide", **OPT_CASES[name])
    tr = Trainer(cfg, _data("wide", cfg=cfg), device="cpu")
    state = tr.init_state(params=from_flax(_jax_params("wide")))
    batch = next(tr.sliced_batches(np.random.default_rng(2)))
    norm = _norm(tr, state, batch)
    state, m = tr.run_step(state, batch)
    return float(m["loss"]), dict(state.params), norm


@pytest.mark.parametrize("name", list(OPT_CASES))
def test_clipping_and_adafactor_use_whole_table_statistics(two, name):
    """Adam with global-norm clipping (the global norm over the whole table
    is one process's, and past the bound) and Adafactor (the word table
    factored: its row means, update RMS and parameter RMS over the whole
    table) at (1, 2): the update equals one process's on the same batch
    (1e-5)."""
    out, res = two
    loss, params, norm = _one_process_step(name)
    if name == "adam_clip":
        # the norm the clipping divides by: the whole table's, not a block's
        assert norm > OPT_CASES[name]["train.grad_clip_norm"]
        for r in res:
            assert res[r]["norm"] == pytest.approx(norm, rel=1e-6)
    for r in res:
        got = _rank(out, f"opt_{name}", r)
        assert float(got.pop("__loss")) == pytest.approx(loss, abs=1e-5)
        for k, v in got.items():
            want = params[k].numpy()
            if v.shape != want.shape:
                want = want[(r % 2) * v.shape[0]:(r % 2 + 1) * v.shape[0]]
            np.testing.assert_allclose(v, want, rtol=1e-5, atol=1e-5, err_msg=k)


def test_checkpoint_at_1x2_loads_in_one_process(two):
    """Rank 0 writes the same whole arrays as one process would: the
    ranks' blocks joined, Adam's moments too; one process restores it and
    evaluates to the ranks' AUC. The ranks built a data-parallel Trainer
    between the step and the save: the state joins over its own model
    group and its tables look up over their own mesh."""
    out, res = two
    cfg = _cfg("wide", **OPT_CASES["adam_clip"])
    tr = Trainer(cfg, _data("wide", cfg=cfg), device="cpu")
    state = CheckpointManager(out / "ckpt").restore(tr.init_state(seed=1))
    blocks = [_rank(out, "opt_adam_clip", r) for r in (0, 1)]
    for k, v in state.params.items():
        want = blocks[0][k]
        if want.shape != v.shape:
            want = np.concatenate([b[k] for b in blocks])
        np.testing.assert_array_equal(v.numpy(), want, err_msg=k)
    table = "news_encoder.word_embedding.embedding"
    assert state.opt.mu[table].shape == state.params[table].shape == (600, 128)
    assert tr.evaluate(state)["auc"] == pytest.approx(res[0]["ckpt_auc"], abs=1e-6)


def test_one_process_checkpoint_resumes_at_1x2(two, inputs):
    """A one-process checkpoint restores at (1, 2), each rank its rows, and
    the next step equals the one-process run's next step (1e-5)."""
    out, res = two
    cfg = _cfg("wide", **OPT_CASES["adam_clip"])
    tr = Trainer(cfg, _data("wide", cfg=cfg), device="cpu")
    state = CheckpointManager(inputs / "ckpt1").restore(tr.init_state(seed=7))
    batches = tr.sliced_batches(np.random.default_rng(2))
    next(batches)
    state, m = tr.run_step(state, next(batches))
    assert all(r["resumed_step"] == 1 for r in res.values())
    for r in res:
        got = _rank(out, "resumed", r)
        assert float(got.pop("__loss")) == pytest.approx(float(m["loss"]), abs=1e-5)
        for k, v in got.items():
            want = state.params[k].numpy()
            if v.shape != want.shape:
                want = want[(r % 2) * v.shape[0]:(r % 2 + 1) * v.shape[0]]
            np.testing.assert_allclose(v, want, rtol=1e-5, atol=1e-6, err_msg=k)


def test_cli_train_and_submit_with_model_parallel_2(two, tmp_path):
    """``cli train --model-parallel 2`` and ``cli submit --model-parallel
    2`` on two ranks: one submission, equal to the file one process writes
    from the same checkpoint (whose config keeps ``model_parallel_size``
    2; ``--model-parallel`` sets the run's own)."""
    out, _ = two
    cfg = json.loads((out / "cli" / "nrms" / "config.json").read_text())
    assert cfg["mesh"]["model_parallel_size"] == 2
    assert cli.main(["submit", "--data", "synthetic", "--ckpt", str(out / "cli" / "nrms"),
                     "--device", "cpu", "--out", str(tmp_path / "one.txt")]) == 0
    two_ranks = (out / "submission.txt").read_text()
    assert two_ranks == (tmp_path / "one.txt").read_text() and len(two_ranks.splitlines()) == 64
