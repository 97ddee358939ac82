"""Command-line entry point of the port: ``train``, ``serve`` and ``models``.

``train`` takes the JAX package's ``train`` flags that apply to one process
(the common model flags, ``--epochs``, ``--eval-step``, ``--seed``,
``--save-dir``) and ``--device``; it trains on the CUDA card unless
``--device cpu`` is given, logs to ``<save-dir>/<model>/metrics.jsonl``
and writes the port's checkpoint directory there (``config.json`` +
``params.npz``, see ``models/convert.py``) at each dev-AUC gain past the
floor, or the final state if the floor was never passed. ``serve`` takes the
JAX package's ``serve`` flags and ``--device`` and reads that directory; as
in the JAX package, the model configuration comes from the checkpoint and
the shared model flags are accepted so that one command line works for
both. ``--auto-resume``, ``--load``, the multi-host flags, ``--profile-dir``
and ``--log-attention`` of ``train``, and the other subcommands
(preprocess, eval, submit, export-vectors, ...), are not ported yet
(``ROADMAP.md``).

Usage: ``python -m pytorch_news_recommender_tpu_torch.cli <command> ...``.
"""

from __future__ import annotations

import argparse
import dataclasses
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
                        "kernel on the card")
    p.add_argument("--compute-dtype", default=None,
                   help="bfloat16 or float32")
    p.add_argument("--model-parallel", type=int, default=1)
    p.add_argument("--embed-dim", type=int, default=None)
    p.add_argument("--heads", type=int, default=None)


def _load_dataset(args, cfg):
    if args.data == "synthetic":
        from pytorch_news_recommender_tpu_torch.data import synthetic
        return synthetic.generate(cfg.data, seed=0, bert_dim=64, n_users=200,
                                  n_neighbors=8, n_test=64)
    from pytorch_news_recommender_tpu_torch.data.dataset import RecDataset
    return RecDataset.load(args.data)


def _build_config(args):
    """The JAX package's config from the common flags."""
    from pytorch_news_recommender_tpu_torch.config import Config, synthetic_config

    d = (synthetic_config() if args.data == "synthetic" else Config()).to_dict()
    d["model"]["name"] = args.model
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
    cfg = Config.from_dict(d)
    train = cfg.train
    if args.epochs is not None:
        train = dataclasses.replace(train, num_epochs=args.epochs)
    if args.eval_step is not None:
        train = dataclasses.replace(train, eval_step=args.eval_step)
    return dataclasses.replace(cfg, train=train)


def cmd_train(args) -> int:
    """Train + periodic dev eval + best-AUC checkpoints."""
    from pytorch_news_recommender_tpu_torch.models.convert import save_checkpoint
    from pytorch_news_recommender_tpu_torch.train.loop import Trainer
    from pytorch_news_recommender_tpu_torch.utils.logging import JsonlLogger

    cfg = _build_config(args)
    ds = _load_dataset(args, cfg)
    trainer = Trainer(cfg, ds, device=args.device)
    state = trainer.init_state(seed=args.seed)
    save_dir = pathlib.Path(args.save_dir) / cfg.model.name
    log = JsonlLogger(save_dir / "metrics.jsonl")
    saved = []

    def ckpt_cb(state, metrics, step):
        save_checkpoint(save_dir, cfg, state.params)
        saved.append(step)

    state, _ = trainer.fit(state, log_fn=log, checkpoint_cb=ckpt_cb)
    if ds.dev is not None and len(ds.dev):
        final = trainer.evaluate(state)
        log({"tag": "final", **final})
        if not saved:
            # dev AUC never beat the checkpoint floor: keep the final state
            save_checkpoint(save_dir, cfg, state.params)
    print(f"checkpoint: {save_dir}", file=sys.stderr)
    return 0


def build_server(args):
    """The :class:`RecommenderServer` that ``serve`` runs, not yet started."""
    from pytorch_news_recommender_tpu_torch.models.convert import load_config
    from pytorch_news_recommender_tpu_torch.serve import Recommender
    from pytorch_news_recommender_tpu_torch.server import RecommenderServer

    if args.mesh:
        raise SystemExit("error: --mesh serving is not ported to PyTorch yet "
                         "(see ROADMAP.md)")
    cfg = load_config(args.ckpt)
    ds = _load_dataset(args, cfg)
    rec = Recommender.from_checkpoint(args.ckpt, ds,
                                      corpus_cache=args.corpus_cache,
                                      vectors_file=args.vectors,
                                      device=args.device)
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

    from pytorch_news_recommender_tpu_torch.models import available_models

    for name in available_models():
        mod = importlib.import_module(
            f"pytorch_news_recommender_tpu_torch.models.{name}")
        doc = (mod.__doc__ or "").strip().splitlines()
        print(f"{name:12s} {doc[0].rstrip('.') if doc else ''}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="pytorch_news_recommender_tpu_torch",
        description="News recommendation on PyTorch and CUDA",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("train", help="train + eval + checkpoint (one device)")
    _add_common(p)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--eval-step", type=int, default=None,
                   help="eval (and best-AUC checkpoint) every N steps")
    p.add_argument("--seed", type=int, default=422)
    p.add_argument("--save-dir", default="save_model")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda, which must exist)")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("serve", help="HTTP serving daemon on a checkpoint")
    _add_common(p)
    p.add_argument("--ckpt", required=True,
                   help="checkpoint dir with config.json + params.npz")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--corpus-cache", choices=("native", "int8"),
                   default="native",
                   help="int8 = per-row symmetrically quantized corpus "
                        "vector table (4x smaller than f32)")
    p.add_argument("--vectors", default=None,
                   help="precomputed corpus vectors (.npz with news_vectors, "
                        "or news_q + news_scale); skips the startup encode")
    p.add_argument("--batch-window-ms", type=float, default=0.0,
                   help="micro-batching window for /score: wait up to this "
                        "long after a request arrives to batch concurrent "
                        "traffic into one device call (0 = off)")
    p.add_argument("--mesh", action="store_true",
                   help="not ported yet: raises")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda, which must exist)")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("models", help="list ported model families")
    p.set_defaults(fn=cmd_models)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
