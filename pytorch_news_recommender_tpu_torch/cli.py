"""Command-line entry point of the port, with the JAX package's subcommands:

* ``preprocess`` / ``preprocess-adressa``: MIND TSVs or Adressa event logs
  -> columnar artifacts (``data/mind.py``, ``data/adressa.py``);
* ``stats``: dataset statistics over built artifacts;
* ``bert-embeds``: per-news BERT sentence vectors from a local HuggingFace
  encoder directory (``data/bert_vectors.py``), for ``preprocess --bert-npz``;
* ``train``: train + periodic dev eval + best-AUC checkpoints of the whole
  train state (``train/checkpoint.py``), with ``--load`` / ``--auto-resume``;
* ``eval``: AUC/MRR/nDCG of a checkpoint on dev or test;
* ``submit``: the MIND leaderboard rank file (``train/submit.py``);
* ``export-vectors``: the corpus vector table (float32, or int8 + scale)
  that ``serve --vectors`` reads;
* ``serve``: the HTTP serving daemon on a checkpoint;
* ``models``: the ported model families.

Every command that runs a model takes ``--device``: the CUDA card by default
(which must exist), ``--device cpu`` for the plain versions. ``eval``,
``submit``, ``export-vectors`` and ``serve`` read the model configuration
from the checkpoint and accept the shared model flags so that one command
line works for all.

``train``, ``eval`` and ``submit`` run over ``torch.distributed``: one
process per rank, from ``torchrun`` (its environment is detected) or with
``--coordinator host:port --num-processes N --process-id R`` on each
process (``--dist-backend gloo`` for ranks that share one card; ``nccl``
is the default where CUDA is available). The ranks form a ``(N / M, M)``
mesh for ``--model-parallel M`` (default 1: data-parallel only): the word,
BERT and entity tables are split by rows over the ``M`` ranks of each data
row. ``eval`` and ``submit`` take the run's own ``--model-parallel``, not
the checkpoint's, so a model-parallel checkpoint also runs in one process.
Rank 0 writes the checkpoints, the metrics log and the submission file.
``train --log-attention`` logs the attention summaries of one batch
through the plain path (``utils/inspect.py``). ``serve --mesh`` splits the
corpus cache by rows over every visible card (over the one device of
``--device cpu``).

Usage: ``python -m pytorch_news_recommender_tpu_torch.cli <command> ...``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--data", required=True,
                   help="artifact dir from `preprocess`, or 'synthetic'")
    p.add_argument("--model", default="nrms",
                   help="model family (see `models` command)")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--eval-batch-size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--no-pallas", action="store_true",
                   help="kept for compatibility: the port always runs its "
                        "kernels on the card")
    p.add_argument("--compute-dtype", default=None,
                   help="bfloat16 or float32")
    p.add_argument("--model-parallel", type=int, default=1)
    p.add_argument("--embed-dim", type=int, default=None)
    p.add_argument("--heads", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda, which must exist)")


def _add_cluster(p: argparse.ArgumentParser) -> None:
    p.add_argument("--coordinator", default=None,
                   help="host:port of rank 0 for a process group started by hand "
                        "(torchrun and SLURM launches are detected without flags)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="the number of processes (with --coordinator)")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's rank (with --coordinator)")
    p.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                   help="process-group backend (default nccl with CUDA, else gloo; "
                        "gloo for ranks that share one card)")
    p.add_argument("--no-distributed", action="store_true",
                   help="run as one process inside a multi-process launch "
                        "(NEWSREC_NO_DISTRIBUTED=1 does the same)")


def _load_dataset(args, cfg):
    if args.data == "synthetic":
        from pytorch_news_recommender_tpu_torch.data import synthetic
        return synthetic.generate(cfg.data, seed=0, bert_dim=64, n_users=200,
                                  n_neighbors=8, n_test=64)
    from pytorch_news_recommender_tpu_torch.data.dataset import RecDataset
    return RecDataset.load(args.data)


def _build_config(args, sample_size=None):
    """The JAX package's config from the common and ``train`` flags."""
    from pytorch_news_recommender_tpu_torch.config import (
        Config, apply_family_defaults, synthetic_config,
    )

    d = (synthetic_config() if args.data == "synthetic" else Config()).to_dict()
    d["model"]["name"] = args.model
    # the family's training defaults, unless --lr is given (0.0 included)
    apply_family_defaults(d, {"learning_rate"} if args.lr is not None else set())
    for flag, attr in (("--embed-dim", "embed_dim"), ("--heads", "heads"),
                       ("--batch-size", "batch_size"),
                       ("--eval-batch-size", "eval_batch_size")):
        v = getattr(args, attr)
        if v is not None and v <= 0:
            raise SystemExit(f"error: {flag} must be a positive integer, got {v}")
    if args.lr is not None:
        d["train"]["learning_rate"] = args.lr
    if args.compute_dtype:
        d["model"]["compute_dtype"] = args.compute_dtype
    if args.embed_dim is not None:
        d["model"]["word_embed_size"] = args.embed_dim
    if args.heads is not None:
        d["model"]["num_attention_heads"] = args.heads
        d["model"]["user_heads_num"] = args.heads
    dd, hh = d["model"]["word_embed_size"], d["model"]["num_attention_heads"]
    if dd % hh:
        raise SystemExit(f"error: word embedding dim D={dd} is not divisible by "
                         f"attention heads H={hh}")
    if args.batch_size is not None:
        d["train"]["batch_size"] = args.batch_size
    if args.eval_batch_size is not None:
        d["train"]["eval_batch_size"] = args.eval_batch_size
    d["mesh"]["model_parallel_size"] = args.model_parallel
    if sample_size is not None:
        d["data"]["sample_size"] = sample_size
    if args.description:
        d["description"] = args.description
    if getattr(args, "debug_nans", False):
        d["train"]["debug_nans"] = True
    if args.skip_nonfinite:
        d["train"]["skip_nonfinite_updates"] = True
    if args.epochs is not None:
        d["train"]["num_epochs"] = args.epochs
    if args.eval_step is not None:
        d["train"]["eval_step"] = args.eval_step
    return Config.from_dict(d)


def cmd_preprocess(args) -> int:
    from pytorch_news_recommender_tpu_torch.config import DataConfig
    from pytorch_news_recommender_tpu_torch.data import mind

    cfg = DataConfig(
        history_len=args.history_len, sample_size=args.sample_size,
        min_history=args.min_history, entity_nums=args.entity_nums,
        word_freq_threshold=args.word_freq_threshold,
    )
    ds = mind.build_dataset(
        cfg, train_dir=args.train_dir, dev_dir=args.dev_dir, test_dir=args.test_dir,
        glove_path=args.glove, word_embed_size=args.word_embed_size,
        bert_npz=args.bert_npz, news_graph_neighbors=args.graph_neighbors,
        seed=args.seed, out_dir=args.out)
    print(f"wrote artifacts to {args.out}: {ds.meta.to_json()}")
    return 0


def cmd_stats(args) -> int:
    """Split sizes, distinct news per split, the dev split's share of news
    unseen in train, history and candidate-count distributions."""
    import numpy as np

    from pytorch_news_recommender_tpu_torch.data.dataset import RecDataset

    ds = RecDataset.load(args.artifacts)
    out = {"n_news": int(ds.news.n_news) - 1, "vocab_words": int(ds.meta.n_words)}
    train_news = set()
    if ds.train is not None:
        t = ds.train
        train_news = set(np.unique(t.candidate_ids)) | set(np.unique(t.browsed_ids))
        train_news.discard(0)
        hist_len = (t.browsed_ids != 0).sum(axis=1)
        out["train"] = {
            "impressions": len(t),
            "distinct_news": len(train_news),
            "history_len_mean": round(float(hist_len.mean()), 2),
            "history_len_p50": int(np.percentile(hist_len, 50)),
            "group_size": int(t.candidate_ids.shape[1]),
        }
    for name in ("dev", "test"):
        split = getattr(ds, name)
        if split is None:
            continue
        snews = set(np.unique(split.cand_flat))
        snews.discard(0)
        cc = split.candidate_counts
        out[name] = {
            "impressions": len(split),
            "distinct_news": len(snews),
            "new_vs_train": len(snews - train_news),
            "candidates_mean": round(float(cc.mean()), 2),
            "candidates_max": int(cc.max()),
        }
        if name == "dev" and split.label_flat is not None:
            out[name]["ctr"] = round(
                float(split.label_flat.sum() / max(len(split.label_flat), 1)), 4)
    print(json.dumps(out, indent=2))
    return 0


def cmd_bert_embeds(args) -> int:
    """Per-news BERT sentence vectors from a local HF encoder directory, in
    place of the reference's bert-as-service job."""
    from pytorch_news_recommender_tpu_torch.data.bert_vectors import build_bert_vectors

    tsvs = [args.train_dir + "/news.tsv", args.dev_dir + "/news.tsv"]
    if args.test_dir:
        tsvs.append(args.test_dir + "/news.tsv")
    emb = build_bert_vectors(tsvs, args.model_path, args.out,
                             batch_size=args.batch_size, max_length=args.max_length,
                             device=args.device)
    print(f"wrote {emb.shape} news vectors to {args.out}")
    return 0


def cmd_preprocess_adressa(args) -> int:
    from pytorch_news_recommender_tpu_torch.config import DataConfig
    from pytorch_news_recommender_tpu_torch.data import adressa

    cfg = DataConfig(history_len=args.history_len, sample_size=args.sample_size,
                     min_history=args.min_history)
    ds = adressa.build_dataset(
        cfg, args.events, train_fraction=args.train_fraction,
        dev_negatives=args.dev_negatives, seed=args.seed, out_dir=args.out,
        news_graph_neighbors=args.graph_neighbors)
    print(f"wrote artifacts to {args.out}: {ds.meta.to_json()}")
    return 0


def _initialize(args) -> int:
    """Brings up the process group of ``--coordinator/--num-processes/
    --process-id`` (or of a launcher's environment) before anything else
    runs; returns this process's rank (0 in a single-process run)."""
    import os

    from pytorch_news_recommender_tpu_torch.parallel import distributed

    if args.no_distributed:
        if any(a is not None for a in (args.coordinator, args.num_processes,
                                       args.process_id)):
            raise SystemExit("error: --no-distributed contradicts the explicit cluster "
                             "flags --coordinator/--num-processes/--process-id")
        os.environ["NEWSREC_NO_DISTRIBUTED"] = "1"
    try:
        up = distributed.initialize(args.coordinator, args.num_processes,
                                    args.process_id, backend=args.dist_backend)
    except ValueError as e:
        raise SystemExit(f"error: {e}")
    if up:
        print(f"process group up: rank {distributed.process_index()} of "
              f"{distributed.process_count()} ({distributed.dist.get_backend()})",
              file=sys.stderr)
    return distributed.process_index()


def cmd_train(args) -> int:
    """Train + periodic dev eval + best-AUC checkpoints."""
    rank = _initialize(args)
    from pytorch_news_recommender_tpu_torch.train.checkpoint import CheckpointManager
    from pytorch_news_recommender_tpu_torch.train.loop import Trainer
    from pytorch_news_recommender_tpu_torch.utils.logging import JsonlLogger
    from pytorch_news_recommender_tpu_torch.utils.plotting import plot_loss

    sample_size = args.sample_size
    if sample_size is None and args.model == "list_rank":
        sample_size = 15  # the reference's listwise default (run_v0.py:44-45)
    cfg = _build_config(args, sample_size)
    ds = _load_dataset(args, cfg)
    trainer = Trainer(cfg, ds, device=args.device)
    state = trainer.init_state(seed=args.seed)
    save_dir = pathlib.Path(args.save_dir) / cfg.model.name
    mngr = CheckpointManager(save_dir, cfg)
    if args.load:
        state = CheckpointManager(args.load).restore(state)
        print(f"restored checkpoint from {args.load} (step {state.step})", file=sys.stderr)
    elif args.auto_resume and mngr.latest_step() is not None:
        # crash-restart recovery: the run's own latest checkpoint, whole
        # (parameters, optimizer state, step)
        state = mngr.restore(state, mngr.latest_step())
        print(f"auto-resumed from {save_dir} (step {state.step})", file=sys.stderr)
    # rank 0 writes the run's log; every rank echoes to stderr
    log = JsonlLogger(save_dir / "metrics.jsonl" if rank == 0 else None)

    def ckpt_cb(state, metrics, _fit_step):
        # keyed by the state's own step, which a resumed run carries on
        # (``fit``'s count restarts at 0 on every call)
        mngr.save(state.step, state, metrics)

    prof = None
    if args.profile_dir:
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if trainer.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
    try:
        state, _ = trainer.fit(state, log_fn=log, checkpoint_cb=ckpt_cb)
    finally:
        if prof is not None:
            prof.stop()
            trace = pathlib.Path(args.profile_dir) / "trace.json"
            trace.parent.mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(trace))
            print(f"profiler trace written to {trace}", file=sys.stderr)
    if args.log_attention:
        # the attention summaries of one batch through the plain path (the
        # kernels never hold the weights), at the trained parameters
        import numpy as np

        from pytorch_news_recommender_tpu_torch.data.loader import train_batches
        from pytorch_news_recommender_tpu_torch.utils.inspect import (
            attention_maps, attention_summary,
        )

        batch = next(train_batches(ds.train, min(64, cfg.train.batch_size),
                                   np.random.default_rng(0), dedup=False))
        maps = attention_maps(state.model, trainer._to_device(batch), trainer.news_feats)
        for site, summ in attention_summary(maps).items():
            log({"tag": "attention", "site": site, **summ})
    if ds.dev is not None and len(ds.dev):
        final = trainer.evaluate(state)
        log({"tag": "final", **final})
        if mngr.latest_step() is None:
            # dev AUC never beat the checkpoint floor: keep the final state
            # anyway, so that eval/submit/serve have something
            mngr.save(state.step, state, final)
    mngr.close()
    if rank == 0:
        png = plot_loss(save_dir / "metrics.jsonl")
        if png is not None:
            print(f"loss curve: {png}", file=sys.stderr)
        print(f"checkpoint: {save_dir}", file=sys.stderr)
    return 0


def _restored(args):
    """(trainer, params) of the checkpoint ``--ckpt``: its best step, or a
    flat weights directory."""
    from pytorch_news_recommender_tpu_torch.models.convert import load_params
    from pytorch_news_recommender_tpu_torch.train.checkpoint import (
        load_config, params_file,
    )
    from pytorch_news_recommender_tpu_torch.train.loop import Trainer

    cfg = load_config(args.ckpt)
    cfg = dataclasses.replace(cfg, mesh=dataclasses.replace(
        cfg.mesh, model_parallel_size=args.model_parallel))
    trainer = Trainer(cfg, _load_dataset(args, cfg), device=args.device)
    return trainer, load_params(params_file(args.ckpt))


def cmd_eval(args) -> int:
    """Metrics of a checkpoint (over the ranks of a process group, each its
    rows of every batch; rank 0 prints them)."""
    rank = _initialize(args)
    trainer, params = _restored(args)
    ds = trainer.dataset
    split = ds.test if args.split == "test" else ds.dev
    metrics = trainer.evaluate(params, split=split, max_impressions=args.max_impressions)
    if rank == 0:
        print(json.dumps(metrics))
    return 0


def cmd_submit(args) -> int:
    """Scores the test split (over the ranks of a process group, each its
    rows of every batch) and writes the rank file from rank 0."""
    rank = _initialize(args)
    from pytorch_news_recommender_tpu_torch.train.submit import write_submission

    trainer, params = _restored(args)
    path = write_submission(trainer, params, path=args.out)
    if rank == 0:
        print(f"saved to {path}")
    return 0


def cmd_export_vectors(args) -> int:
    """Encodes the whole corpus once and writes the vector table to .npz."""
    import numpy as np

    trainer, params = _restored(args)
    vecs = trainer.compute_news_vectors(params).float().cpu().numpy()
    out = {"news_vectors": vecs}
    if args.int8:
        scale = np.maximum(np.abs(vecs).max(axis=1, keepdims=True) / 127.0, 1e-12)
        out = {"news_q": np.clip(np.round(vecs / scale), -127, 127).astype(np.int8),
               "news_scale": scale.astype(np.float32)}
    np.savez_compressed(args.out, **out)
    print(f"saved {vecs.shape[0]} news vectors ({vecs.shape[1]}d, "
          f"{'int8+scale' if args.int8 else 'float32'}) to {args.out}")
    return 0


def build_server(args):
    """The :class:`RecommenderServer` that ``serve`` runs, not yet started."""
    from pytorch_news_recommender_tpu_torch.serve import Recommender
    from pytorch_news_recommender_tpu_torch.server import RecommenderServer
    from pytorch_news_recommender_tpu_torch.train.checkpoint import load_config

    cfg = load_config(args.ckpt)
    ds = _load_dataset(args, cfg)
    mesh = None
    if args.mesh:
        from pytorch_news_recommender_tpu_torch.parallel.mesh import make_mesh
        # every visible card, or the one device asked for when it is not one
        on_host = args.device is not None and not str(args.device).startswith("cuda")
        mesh = make_mesh(dataclasses.replace(cfg.mesh, model_parallel_size=args.model_parallel),
                         [args.device] if on_host else None)
    rec = Recommender.from_checkpoint(args.ckpt, ds,
                                      corpus_cache=args.corpus_cache,
                                      vectors_file=args.vectors,
                                      device=args.device, mesh=mesh)
    return RecommenderServer(rec, host=args.host, port=args.port,
                             batch_window_ms=args.batch_window_ms)


def cmd_serve(args) -> int:
    """Stand up the HTTP serving daemon on a checkpoint."""
    srv = build_server(args)
    rec = srv.rec
    print(f"serving {rec.cfg.model.name} ({rec.n_news} news) on {rec.device} "
          f"at http://{args.host}:{srv.port} — GET /healthz, POST /score, "
          f"POST /top_k, POST /add_news", flush=True)
    try:
        srv.start(block=True)
    except KeyboardInterrupt:
        srv.stop()
    return 0


def cmd_models(args) -> int:
    import importlib

    from pytorch_news_recommender_tpu_torch.config import FAMILY_TRAIN_DEFAULTS
    from pytorch_news_recommender_tpu_torch.models import available_models

    for name in available_models():
        mod = importlib.import_module(
            f"pytorch_news_recommender_tpu_torch.models.{name}")
        doc = (mod.__doc__ or "").strip().splitlines()
        fam = FAMILY_TRAIN_DEFAULTS.get(name)
        tag = ("  [defaults: " + ", ".join(f"{k}={v}" for k, v in fam.items()) + "]"
               if fam else "")
        print(f"{name:12s} {doc[0].rstrip('.') if doc else ''}{tag}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="pytorch_news_recommender_tpu_torch",
        description="News recommendation on PyTorch and CUDA",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("preprocess", help="MIND TSVs -> columnar artifacts")
    p.add_argument("--train-dir", required=True)
    p.add_argument("--dev-dir", required=True)
    p.add_argument("--test-dir", default=None)
    p.add_argument("--glove", default=None, help="GloVe vectors txt")
    p.add_argument("--word-embed-size", type=int, default=300)
    p.add_argument("--bert-npz", default=None,
                   help="precomputed per-news sentence vectors (npz)")
    p.add_argument("--graph-neighbors", type=int, default=0,
                   help="build co-click news graph with this fan-out")
    p.add_argument("--history-len", type=int, default=50)
    p.add_argument("--sample-size", type=int, default=5)
    p.add_argument("--min-history", type=int, default=5)
    p.add_argument("--entity-nums", type=int, default=10)
    p.add_argument("--word-freq-threshold", type=int, default=3,
                   help="min corpus frequency for a vocab word")
    p.add_argument("--seed", type=int, default=2020)
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_preprocess)

    p = sub.add_parser("stats", help="dataset statistics over built artifacts")
    p.add_argument("--artifacts", required=True,
                   help="artifact dir written by preprocess")
    p.set_defaults(fn=cmd_stats)

    p = sub.add_parser("bert-embeds",
                       help="news TSVs -> per-news BERT vectors npz "
                            "(local HF encoder; feeds preprocess --bert-npz)")
    p.add_argument("--train-dir", required=True)
    p.add_argument("--dev-dir", required=True)
    p.add_argument("--test-dir", default=None)
    p.add_argument("--model-path", required=True,
                   help="local HuggingFace encoder checkpoint dir")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--max-length", type=int, default=64)
    p.add_argument("--out", required=True)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda, which must exist)")
    p.set_defaults(fn=cmd_bert_embeds)

    p = sub.add_parser("preprocess-adressa",
                       help="Adressa event JSONL -> columnar artifacts")
    p.add_argument("--graph-neighbors", type=int, default=0,
                   help="build the [N, k] co-click news graph from "
                        "train-period clicks (GNN family)")
    p.add_argument("--events", nargs="+", required=True,
                   help="event JSONL file(s)")
    p.add_argument("--train-fraction", type=float, default=0.9)
    p.add_argument("--dev-negatives", type=int, default=20)
    p.add_argument("--history-len", type=int, default=50)
    p.add_argument("--sample-size", type=int, default=5)
    p.add_argument("--min-history", type=int, default=5)
    p.add_argument("--seed", type=int, default=2020)
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_preprocess_adressa)

    p = sub.add_parser("train", help="train + eval + checkpoint")
    _add_common(p)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--eval-step", type=int, default=None,
                   help="eval (and best-AUC checkpoint) every N steps")
    p.add_argument("--sample-size", type=int, default=None)
    p.add_argument("--seed", type=int, default=422)
    p.add_argument("--save-dir", default="save_model")
    p.add_argument("--load", default=None,
                   help="checkpoint dir whose best step to resume from")
    p.add_argument("--auto-resume", action="store_true",
                   help="restore this run's latest checkpoint from the save "
                        "dir if one exists (crash-restart recovery)")
    p.add_argument("--description", default="")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the run here (trace.json)")
    p.add_argument("--skip-nonfinite", action="store_true",
                   help="skip (not apply) updates whose loss is non-finite")
    p.add_argument("--debug-nans", action="store_true",
                   help="fail fast: raise FloatingPointError at the first non-finite "
                        "loss, gradient or eval score (one device sync a step)")
    p.add_argument("--log-attention", action="store_true",
                   help="log per-site additive-attention weight summaries "
                        "to metrics.jsonl after training")
    _add_cluster(p)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("eval", help="evaluate a checkpoint on dev/test")
    _add_common(p)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--split", choices=("dev", "test"), default="dev")
    p.add_argument("--max-impressions", type=int, default=None)
    _add_cluster(p)
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("serve", help="HTTP serving daemon on a checkpoint")
    _add_common(p)
    p.add_argument("--ckpt", required=True,
                   help="checkpoint dir (its best step), or a dir with "
                        "config.json + params.npz")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--corpus-cache", choices=("native", "int8"),
                   default="native",
                   help="int8 = per-row symmetrically quantized corpus "
                        "vector table (4x smaller than f32)")
    p.add_argument("--vectors", default=None,
                   help="precomputed corpus vectors from `export-vectors` "
                        "(skips the startup corpus encode)")
    p.add_argument("--batch-window-ms", type=float, default=0.0,
                   help="micro-batching window for /score: wait up to this "
                        "long after a request arrives to batch concurrent "
                        "traffic into one device call (0 = off)")
    p.add_argument("--mesh", action="store_true",
                   help="split the corpus cache by rows over every visible card "
                        "(the first axis of a --model-parallel mesh of them)")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("export-vectors",
                       help="encode the corpus and write news vectors (.npz)")
    _add_common(p)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--int8", action="store_true",
                   help="per-row symmetric int8 + f32 scale instead of f32")
    p.set_defaults(fn=cmd_export_vectors)

    p = sub.add_parser("submit", help="write MIND leaderboard rank file")
    _add_common(p)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--out", default=None)
    _add_cluster(p)
    p.set_defaults(fn=cmd_submit)

    p = sub.add_parser("models", help="list ported model families")
    p.set_defaults(fn=cmd_models)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
