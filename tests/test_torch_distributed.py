"""Data-parallel training on ``torch.distributed`` (``parallel/
distributed.py``, ``loader.train_batches_sliced``, the multi-block
``resolve_batch``, the multi-process ``Trainer``, the rank-folded dropout
seeds, rank-0 checkpoints and submissions) against the JAX package's
multi-process path: the port's copies of ``tests/test_distributed.py``,
``test_distributed_init.py``, ``test_multiprocess.py`` and
``test_pallas_sharding.py``'s per-shard dropout streams. The two-process
runs are two OS processes on the CPU over the ``gloo`` backend."""

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

from pytorch_news_recommender_tpu.config import synthetic_config as jax_synthetic_config
from pytorch_news_recommender_tpu.data import loader as jloader
from pytorch_news_recommender_tpu.data import synthetic as jax_synthetic
from pytorch_news_recommender_tpu.ops.pallas.fused_encoder import (
    SHARD_SEED_STRIDE as JAX_STRIDE,
)
from pytorch_news_recommender_tpu.ops.pallas.fused_encoder import host_dropout_keep
from pytorch_news_recommender_tpu.train import loop as jax_loop
from pytorch_news_recommender_tpu_torch import cli
from pytorch_news_recommender_tpu_torch.config import Config, synthetic_config
from pytorch_news_recommender_tpu_torch.data import loader, synthetic
from pytorch_news_recommender_tpu_torch.models.convert import from_flax
from pytorch_news_recommender_tpu_torch.ops import fused_encoder as FE
from pytorch_news_recommender_tpu_torch.parallel import distributed
from pytorch_news_recommender_tpu_torch.train.loop import Trainer, training_loss

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parents[1]

# the two-process fits: a 96-impression NRMS and a GNN run at batch 16
FIT = {"train.batch_size": 16, "train.eval_batch_size": 8, "train.num_epochs": 1,
       "train.dedup_batches": True, "train.eval_step": 0, "train.log_every": 1,
       "model.dropout": 0.0}
GNN = {"model.name": "gnn", "train.unique_buckets": [64, 128, 256],
       "train.gnn_frontier_buckets": [128, 256, 512, 1024]}
GEN = dict(seed=3, n_train=96, n_dev=24)
GNN_GEN = dict(n_neighbors=8, n_users=50)


# ---- the sliced feed ----------------------------------------------------------

def _sliced(mod, ds, P, h, split=None, gnn=False, buckets=(256, 512, 1024)):
    return list(mod.train_batches_sliced(
        ds.train, 32, np.random.default_rng(5), process_index=h, process_count=P,
        dedup=True, unique_buckets=buckets, length_split=split,
        gnn_neighbors=ds.news.neighbors if gnn else None, gnn_depth=2 if gnn else 0,
        gnn_buckets=(512, 1024, 2048) if gnn else None))


@pytest.mark.parametrize("P", [1, 2, 4])
def test_sliced_batches_equal_jax_for_every_process(P):
    """Every process's batches, array for array, with the dedup width, the
    length split's short width and the GNN frontier agreed across the
    processes; the blocks gather back the raw global batch."""
    cfg = synthetic_config()
    ds = synthetic.generate(cfg.data, seed=11, n_train=96 * 3, n_dev=8, title_len=(11.5, 3.5),
                            n_neighbors=8)
    lens = (ds.news.title != 0).sum(axis=1).astype(np.int32)
    split = loader.LengthSplit({"title": lens}, {"title": 12}, grid=64)
    jsplit = jloader.LengthSplit({"title": lens}, {"title": 12}, grid=64)
    raw = list(loader.train_batches(ds.train, 32, np.random.default_rng(5)))
    saw = set()
    for gnn in (False, True):
        blocks = [_sliced(loader, ds, P, h, split, gnn) for h in range(P)]
        for h in range(P):
            theirs = _sliced(jloader, ds, P, h, jsplit, gnn)
            assert len(blocks[h]) == len(theirs) == len(raw)
            for ours, ref in zip(blocks[h], theirs):
                assert sorted(ours) == sorted(ref)
                for k in ref:
                    np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
        for i, gb in enumerate(raw):
            parts = [blocks[h][i] for h in range(P)]
            if "unique_ids" not in parts[0]:
                continue
            saw.update(k for k in parts[0] if k.endswith("_mark") or k.startswith("gnn"))
            uniq = np.concatenate([b["unique_ids"] for b in parts])
            for key, idx in (("browsed_ids", "browsed_idx"), ("candidate_ids", "candidate_idx")):
                np.testing.assert_array_equal(
                    uniq[np.concatenate([b[idx] for b in parts])], gb[key])
    assert {"short_mark", "gnn_frontier_ids"} <= saw, saw
    if P > 1:
        assert "block_mark" in saw


def _resolve_pair():
    """Port and JAX trainers (dropout off) on one dataset with MIND-like
    title lengths, and the Flax init weights."""
    over = {"model.dropout": 0.0}
    cfg, jcfg = synthetic_config(**over), jax_synthetic_config(**over)
    gen = dict(seed=11, n_train=128, n_dev=8, title_len=(11.5, 3.5))
    tr = Trainer(cfg, synthetic.generate(cfg.data, **gen), device="cpu")
    jtr = jax_loop.Trainer(jcfg, jax_synthetic.generate(jcfg.data, **gen))
    return tr, jtr, jax.device_get(jtr.init_state(seed=0).params)


def test_multi_block_resolve_batch_matches_jax_and_the_ranks_blocks():
    """A two-block batch of the sliced feed (each block split at the agreed
    short width): ``resolve_batch`` gives the JAX model's ids and vectors
    (1e-5), and each rank's own block (``local_block``) resolves to its
    rows of the two-block result (1e-5)."""
    tr, jtr, params = _resolve_pair()
    model = tr.init_state(params=from_flax(params)).model
    split = tr._length_split.__class__(tr._length_split.feat_lens, tr._length_split.thresholds,
                                       grid=64)
    blocks = [list(loader.train_batches_sliced(
        tr.dataset.train, 32, np.random.default_rng(5), process_index=h, process_count=2,
        dedup=True, unique_buckets=(256, 512, 1024), length_split=split))
        for h in range(2)]
    i = next(i for i, b in enumerate(blocks[0]) if "block_mark" in b)
    parts = [blocks[0][i], blocks[1][i]]
    glob = {k: (parts[0][k] if k.endswith("_mark")
                else np.concatenate([p[k] for p in parts])) for k in parts[0]}
    assert glob["block_mark"].shape == (2,) and glob["short_mark"].shape[0] > 0
    with torch.no_grad():
        got = model.resolve_batch(tr._to_device(glob), tr.news_feats)
    expect = jtr.model.apply({"params": params}, {k: jnp.asarray(v) for k, v in glob.items()},
                             jtr.news_feats, True, method="resolve_batch")
    for a, b in zip(got, expect):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    for h in range(2):
        local = loader.local_block(parts[h], h, 2)
        assert "block_mark" not in local
        assert local["short_mark"].shape[0] == glob["short_mark"].shape[0] // 2
        with torch.no_grad():
            mine = model.resolve_batch(tr._to_device(local), tr.news_feats)
        rows = slice(h * 16, (h + 1) * 16)
        for a, b in zip(mine, got):
            np.testing.assert_allclose(a.numpy(), b[rows].numpy(), rtol=1e-5, atol=1e-5)


def test_replay_ranks_trains_on_the_ranks_joined_blocks():
    """``Trainer(replay_ranks=2)`` in one process feeds every rank's block of
    each global batch joined (``join_blocks`` of both ranks' sliced batches,
    array for array, two-block batches among them), and a step on such a
    batch has the mean of the two ranks' block losses and gradients
    (1e-5): the ranks' all-reduced step."""
    tr0, _, params = _resolve_pair()
    cfg = synthetic_config(**{"model.dropout": 0.0, "train.batch_size": 32,
                              "train.unique_buckets": [256, 512, 1024]})
    tr = Trainer(cfg, tr0.dataset, device="cpu", replay_ranks=2)
    tr._length_split = tr0._length_split.__class__(tr0._length_split.feat_lens,
                                                   tr0._length_split.thresholds, grid=64)
    got = list(tr.sliced_batches(np.random.default_rng(5)))
    ranks = [list(loader.train_batches_sliced(
        tr.dataset.train, 32, np.random.default_rng(5), process_index=h, process_count=2,
        dedup=True, unique_buckets=(256, 512, 1024), length_split=tr._length_split))
        for h in range(2)]
    assert len(got) == len(ranks[0]) == len(tr.dataset.train) // 32
    for g, parts in zip(got, zip(*ranks)):
        want = loader.join_blocks(parts)
        assert sorted(g) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(g[k], want[k], err_msg=k)
    i = next(i for i, b in enumerate(got) if "block_mark" in b)

    def loss_and_grads(batch):
        model = tr.init_state(params=from_flax(params)).model
        loss = training_loss(model, model(tr._to_device(batch), tr.news_feats,
                                          deterministic=False,
                                          generator=torch.Generator().manual_seed(0)))
        loss.backward()
        return float(loss.detach()), {k: p.grad.clone() for k, p in model.named_parameters()}
    loss, grads = loss_and_grads(got[i])
    blocks = [loss_and_grads(loader.local_block(ranks[h][i], h, 2)) for h in range(2)]
    assert loss == pytest.approx(np.mean([b[0] for b in blocks]), rel=1e-5)
    for k, g in grads.items():
        mean = (blocks[0][1][k] + blocks[1][1][k]) / 2
        np.testing.assert_allclose(g.numpy(), mean.numpy(), rtol=1e-5, atol=1e-7, err_msg=k)
    with pytest.raises(ValueError, match="does not split"):
        Trainer(synthetic_config(**{"train.batch_size": 15}), tr.dataset, device="cpu",
                replay_ranks=2)


# ---- the process group ----------------------------------------------------------

_CLUSTER_VARS = ["WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK",
                 "SLURM_NTASKS", "SLURM_NPROCS", "SLURM_PROCID", "NEWSREC_NO_DISTRIBUTED"]


@pytest.fixture()
def clean_env(monkeypatch):
    for k in _CLUSTER_VARS:
        monkeypatch.delenv(k, raising=False)


def test_initialize_single_process_is_a_noop(clean_env):
    assert distributed.initialize() is False
    assert not distributed.is_initialized()
    assert (distributed.process_index(), distributed.process_count()) == (0, 1)
    s = distributed.process_local_slice(64)
    assert (s.start, s.stop) == (0, 64)
    assert FE.shard_seed(123, 0) == 123


def test_partial_explicit_spec_raises(clean_env):
    with pytest.raises(ValueError, match="num_processes"):
        distributed.initialize(coordinator_address="127.0.0.1:1234")
    with pytest.raises(ValueError, match="outside"):
        distributed.initialize("127.0.0.1:1234", 2, 2)
    assert not distributed.is_initialized()


@pytest.mark.parametrize("var,value,expect", [
    ("WORLD_SIZE", "2", True),
    ("WORLD_SIZE", "1", False),
    ("WORLD_SIZE", "not-a-number", False),
    ("SLURM_NTASKS", "4", True),
    ("SLURM_NTASKS", "1", False),
    ("SLURM_NPROCS", "2", True),
])
def test_cluster_env_detection(clean_env, monkeypatch, var, value, expect):
    monkeypatch.setenv(var, value)
    assert distributed.cluster_env_detected() is expect


def test_opt_out_vetoes_cluster_env(clean_env, monkeypatch):
    monkeypatch.setenv("SLURM_NTASKS", "4")
    assert distributed.cluster_env_detected() is True
    monkeypatch.setenv("NEWSREC_NO_DISTRIBUTED", "1")
    assert distributed.cluster_env_detected() is False
    assert distributed.initialize() is False
    monkeypatch.setenv("NEWSREC_NO_DISTRIBUTED", "0")
    assert distributed.cluster_env_detected() is True
    # a detected launch without the rendezvous address is refused
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        distributed.initialize()


@pytest.mark.parametrize("backend,device", [("nccl", "meta"), ("gloo", "cpu")])
def test_collectives_hand_the_backend_its_device(monkeypatch, backend, device):
    """Under nccl every buffer handed to a collective lies on the rank's
    card, whatever device its tensors came from (``assert_replicated``'s
    checksums are made on the parameters' device); under gloo the gathers'
    lie on the host and the all-reduce's on its tensors' own device (gloo
    reduces CUDA tensors itself). Here ``meta`` stands for the card:
    ``_comm_device`` is held to ``cuda:<current device>`` for nccl, then
    replaced."""
    monkeypatch.setattr(distributed.dist, "get_backend", lambda *a: backend)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    want = torch.device("cuda", 3) if backend == "nccl" else torch.device("cpu")
    assert distributed._comm_device() == want
    monkeypatch.setattr(distributed, "_comm_device", lambda: torch.device(device))
    monkeypatch.setattr(distributed, "process_count", lambda: 2)
    seen = []

    class Handed(Exception):
        pass

    def record(*tensors):
        seen.extend(t.device.type for t in tensors if torch.is_tensor(t))
        seen.extend(t.device.type for x in tensors if isinstance(x, list) for t in x)
        raise Handed

    monkeypatch.setattr(distributed.dist, "all_gather", record)
    monkeypatch.setattr(distributed.dist, "all_reduce", record)
    x, m = torch.ones(4, 3), torch.ones(4, 3, device="meta")
    for call, expect in ((lambda: distributed.fetch_global(x), device),
                         (lambda: distributed.assert_replicated([x, x[0]], "x"), device),
                         (lambda: distributed.all_reduce_mean([x, x[0]]), device),
                         (lambda: distributed.all_reduce_mean([m, m[0]]), "meta")):
        seen.clear()
        with pytest.raises(Handed):
            call()
        assert seen and set(seen) == {expect}, seen


def test_bare_cuda_device_resolves_to_the_current_card(monkeypatch):
    """A rank that owns card 3 (``torch.cuda.set_device(3)``) gets
    ``cuda:3`` for ``device=None`` and for a bare ``"cuda"``, never an
    unindexed device that a helper thread (the prefetch's, whose current
    card is 0) would place on card 0; an explicit index and the CPU stay as
    given. The CUDA calls are stubbed: this host has no card."""
    from pytorch_news_recommender_tpu_torch.serve import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert resolve_device(None) == resolve_device("cuda") == torch.device("cuda", 3)
    assert resolve_device("cuda:1") == torch.device("cuda", 1)
    assert resolve_device("cpu") == torch.device("cpu")


def test_step_generator_folds_its_rank_into_each_seed():
    """``step_generator(seed, step, rank)`` draws what rank 0's does, and
    each dropout seed drawn from it (``layers.draw_seed``) is the draw
    folded with the rank; a plain ``torch.Generator`` folds nothing."""
    from pytorch_news_recommender_tpu_torch.models.layers import draw_seed
    from pytorch_news_recommender_tpu_torch.train.loop import step_generator
    for rank in (0, 1, 3):
        g0, g = step_generator(7, 2), step_generator(7, 2, rank)
        draws = [int(torch.randint(0, 2 ** 31 - 1, (), generator=g0)) for _ in range(3)]
        assert [draw_seed(g) for _ in range(3)] == [FE.shard_seed(d, rank) for d in draws]
    plain = torch.Generator().manual_seed(4)
    d = int(torch.randint(0, 2 ** 31 - 1, (), generator=torch.Generator().manual_seed(4)))
    assert draw_seed(plain) == d


@pytest.mark.parametrize("rank", [0, 1, 3])
def test_shard_seed_mask_equals_jax_host_dropout_keep(rank):
    """The folded seed is JAX's ``seed + axis_index * SHARD_SEED_STRIDE``
    (the same stride), and its mask the JAX package's ``host_dropout_keep``
    of that seed bit for bit; the ranks' masks differ."""
    assert FE.SHARD_SEED_STRIDE == JAX_STRIDE
    seed, M, L, D, rate = 2 ** 31 - 5, 70, 20, 64, 0.2
    folded = FE.shard_seed(seed, rank)
    assert folded == (seed + rank * JAX_STRIDE) % 2 ** 32
    keep = FE.dropout_keep(folded, M, L, D, rate).numpy()
    np.testing.assert_array_equal(keep, host_dropout_keep(seed + rank * JAX_STRIDE, M, L, D,
                                                          rate))
    if rank:
        assert not np.array_equal(keep, FE.dropout_keep(seed, M, L, D, rate).numpy())


# ---- two processes over gloo --------------------------------------------------------

_WORKER = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from pytorch_news_recommender_tpu_torch.parallel import distributed

coord, world, rank, mode, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
result = {"rank": rank}
if mode == "cli":
    from pytorch_news_recommender_tpu_torch import cli
    flags = ["--coordinator", coord, "--num-processes", str(world), "--process-id", str(rank)]
    assert cli.main(["train", "--data", "synthetic", "--epochs", "1", "--batch-size", "256",
                     "--device", "cpu", "--save-dir", out, "--log-attention"] + flags) == 0
    assert distributed.process_count() == world
    assert cli.main(["submit", "--data", "synthetic", "--ckpt", out + "/nrms", "--device",
                     "cpu", "--out", out + "/submission.txt"] + flags) == 0
    print("RESULT " + json.dumps(result), flush=True)
    sys.exit(0)

assert distributed.initialize(coord, world, rank) is True
assert (distributed.process_index(), distributed.process_count()) == (rank, world)
from pytorch_news_recommender_tpu_torch.config import synthetic_config
from pytorch_news_recommender_tpu_torch.data import synthetic
from pytorch_news_recommender_tpu_torch.data.loader import local_block, train_batches_sliced
from pytorch_news_recommender_tpu_torch.models import layers
from pytorch_news_recommender_tpu_torch.train.checkpoint import CheckpointManager
from pytorch_news_recommender_tpu_torch.train.loop import Trainer, step_generator

FIT, GNN, GEN, GNN_GEN = (json.loads(a) for a in sys.argv[6:10])
for name, over, gen in (("nrms", {}, {}), ("gnn", GNN, GNN_GEN)):
    cfg = synthetic_config(**FIT, **over)
    ds = synthetic.generate(cfg.data, **GEN, **gen)
    tr = Trainer(cfg, ds, device="cpu")
    assert tr._sliced and tr.n_proc == world
    log = []
    state, _ = tr.fit(tr.init_state(seed=0), log_fn=log.append, eval_each_epoch=False)
    m = tr.evaluate(state)
    tr.check_replicas(state)
    r = {"losses": [d["loss"] for d in log if "loss" in d], "auc": m["auc"],
         "n_impressions": m["n_impressions"],
         "checksum": float(sum(p.double().sum() for p in state.model.parameters()))}
    if name == "gnn":
        b = next(train_batches_sliced(
            ds.train, 16, np.random.default_rng(0), process_index=rank, process_count=world,
            dedup=True, unique_buckets=tuple(GNN["train.unique_buckets"]),
            gnn_neighbors=ds.news.neighbors, gnn_depth=tr._frontier_depth,
            gnn_buckets=tuple(GNN["train.gnn_frontier_buckets"])))
        r["frontier_on"] = "gnn_frontier_ids" in b
    else:
        # rank 0 writes the checkpoint, every rank restores it
        mngr = CheckpointManager(out + "/ckpt", cfg)
        mngr.save(state.step, state, m)
        restored = mngr.restore(tr.init_state(seed=1))
        r["ckpt_ok"] = (restored.step == state.step and all(
            torch.equal(a, b) for a, b in zip(state.model.parameters(),
                                              restored.model.parameters())))
        # dropout 0.2: every tower call's seed is the step generator's draw
        # folded with the rank; the ranks' parameters stay equal
        cfg = synthetic_config(**{**FIT, "model.dropout": 0.2})
        tr = Trainer(cfg, ds, device="cpu")
        seeds, real = [], layers.fused_news_encoder
        def record(*a, **k):
            if k.get("dropout_rate", 0.0) > 0:
                seeds.append(int(k["seed"]))
            return real(*a, **k)
        layers.fused_news_encoder = record
        state = tr.init_state(seed=0)
        batches = train_batches_sliced(
            ds.train, 16, np.random.default_rng(0), process_index=rank, process_count=world,
            dedup=True, unique_buckets=tuple(GNN["train.unique_buckets"]),
            length_split=tr._length_split)
        drop_losses = []
        for i, b in zip(range(3), batches):
            n0 = len(seeds)
            g = step_generator(cfg.train.seed + 1, state.step)
            state, mm = tr.run_step(state, local_block(b, rank, world))
            # the draws of the step's news tower calls (the user tower has none)
            draws = [int(torch.randint(0, 2 ** 31 - 1, (), generator=g))
                     for _ in seeds[n0:]]
            drop_losses.append(float(mm["loss"]))
            r.setdefault("drop_seeds", []).append([seeds[n0:], draws])
        layers.fused_news_encoder = real
        tr.check_replicas(state)
        r["drop_losses"] = drop_losses
        # debug_nans with a NaN on rank 1 alone: the step's means carry it,
        # so both ranks raise at the same step
        cfg = synthetic_config(**{**FIT, "train.debug_nans": True})
        tr = Trainer(cfg, ds, device="cpu")
        state = tr.init_state(seed=0)
        if rank == 1:
            with torch.no_grad():
                state.model.user_encoder.tower.aq[0] = float("nan")
        b = next(train_batches_sliced(ds.train, 16, np.random.default_rng(0),
                                      process_index=rank, process_count=world))
        try:
            tr.run_step(state, local_block(b, rank, world))
            r["nan_raised"] = None
        except FloatingPointError as e:
            r["nan_raised"] = str(e)
    result[name] = r
print("RESULT " + json.dumps(result), flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_workers(tmp_path, mode):
    """Runs the worker as ranks 0 and 1 of a gloo group; returns their
    RESULT lines by rank."""
    coord = f"127.0.0.1:{_free_port()}"
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(REPO)] + sys.path[1:]),
           "CUDA_VISIBLE_DEVICES": ""}
    for k in _CLUSTER_VARS:
        env.pop(k, None)
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    extra = [json.dumps(x) for x in (FIT, GNN, GEN, GNN_GEN)]
    procs = [subprocess.Popen([sys.executable, str(script), coord, "2", str(r), mode,
                               str(tmp_path)] + extra, env=env, cwd=tmp_path,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    results = {}
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            if p.returncode != 0:
                pytest.fail(f"worker rc={p.returncode}\nstdout:{out}\nstderr:{err[-4000:]}")
            for line in out.splitlines():
                if line.startswith("RESULT "):
                    r = json.loads(line[len("RESULT "):])
                    results[r["rank"]] = r
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert set(results) == {0, 1}, results
    return results


def _single_process(over, gen):
    """The same fit in one process on the same global batches: both ranks'
    blocks of each (``replay_ranks=2``)."""
    cfg = synthetic_config(**FIT, **over)
    ds = synthetic.generate(cfg.data, **GEN, **gen)
    tr = Trainer(cfg, ds, device="cpu", replay_ranks=2)
    log = []
    state, _ = tr.fit(tr.init_state(seed=0), log_fn=log.append, eval_each_epoch=False)
    return [d["loss"] for d in log if "loss" in d], tr.evaluate(state)


def test_two_process_fit_matches_single_process(tmp_path):
    """NRMS and GNN (the frontier per block) fit on two ranks: both ranks
    log the same losses bit for bit (the all-reduced mean), compute the
    same AUC and hold the same parameters, and match one process fitting
    the same global batches (losses within 1e-4, AUC within 5e-3, as the
    JAX package's two-process test holds its run); rank 0's checkpoint
    restores on both. With dropout 0.2 each rank's tower calls use the step
    generator's draws folded with its rank (``seed + rank * 1,000,003``),
    and the ranks' parameters still agree. With ``debug_nans``, a NaN on one
    rank makes both raise at the same step."""
    res = _run_workers(tmp_path, "fit")
    for name, over, gen in (("nrms", {}, {}), ("gnn", GNN, GNN_GEN)):
        a, b = res[0][name], res[1][name]
        assert a["losses"] == b["losses"] and len(a["losses"]) == GEN["n_train"] // 16
        assert a["auc"] == b["auc"] and a["checksum"] == b["checksum"]
        losses, m = _single_process(over, gen)
        np.testing.assert_allclose(a["losses"], losses, rtol=1e-4, atol=1e-5)
        assert a["n_impressions"] == m["n_impressions"]
        assert abs(a["auc"] - m["auc"]) < 5e-3
    assert res[0]["gnn"]["frontier_on"] and res[1]["gnn"]["frontier_on"]
    assert res[0]["nrms"]["ckpt_ok"] and res[1]["nrms"]["ckpt_ok"]
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["6", "config.json"]
    assert res[0]["nrms"]["drop_losses"] == res[1]["nrms"]["drop_losses"]
    for r in (0, 1):
        assert res[r]["nrms"]["nan_raised"] == "debug_nans: non-finite loss at step 0", r
    for r in (0, 1):
        for seeds, draws in res[r]["nrms"]["drop_seeds"]:
            # every news tower call of the step (the user tower has no dropout)
            assert seeds and seeds == [FE.shard_seed(d, r) for d in draws], (r, seeds, draws)
    s0 = res[0]["nrms"]["drop_seeds"][0][0][0]
    s1 = res[1]["nrms"]["drop_seeds"][0][0][0]
    assert s1 == (s0 + JAX_STRIDE) % 2 ** 32
    np.testing.assert_array_equal(FE.dropout_keep(s1, 8, 20, 64, 0.2).numpy(),
                                  host_dropout_keep(s0 + JAX_STRIDE, 8, 20, 64, 0.2))


def test_two_process_cli_train_and_submit_write_from_rank_0(tmp_path):
    """``cli train --coordinator ... --log-attention`` on two ranks and a
    two-rank ``cli submit``: one metrics log (each attention site once), one
    submission file, equal to the file one process writes from the same
    checkpoint."""
    _run_workers(tmp_path, "cli")
    lines = [json.loads(x) for x in (tmp_path / "nrms" / "metrics.jsonl").read_text()
             .splitlines()]
    sites = [x["site"] for x in lines if x.get("tag") == "attention"]
    assert sorted(sites) == ["news_encoder/tower", "user_encoder/tower"]
    assert sum(1 for x in lines if x.get("tag") == "final") == 1
    two = (tmp_path / "submission.txt").read_text()
    assert cli.main(["submit", "--data", "synthetic", "--ckpt", str(tmp_path / "nrms"),
                     "--device", "cpu", "--out", str(tmp_path / "one.txt")]) == 0
    one = (tmp_path / "one.txt").read_text()
    assert two == one and len(one.splitlines()) == 64
