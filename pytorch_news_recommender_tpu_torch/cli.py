"""Command-line entry point of the port: ``serve`` and ``models``.

``serve`` takes the JAX package's ``serve`` flags and ``--device``; it reads
the port's checkpoint directory (``config.json`` + ``params.npz``, see
``models/convert.py``) and serves on the CUDA card unless ``--device cpu``
is given. As in the JAX package, the model configuration comes from the
checkpoint; the shared model flags are accepted so that one command line
works for both. The other subcommands (preprocess, train, eval, submit,
export-vectors, ...) are not ported yet (``ROADMAP.md``).

Usage: ``python -m pytorch_news_recommender_tpu_torch.cli <command> ...``.
"""

from __future__ import annotations

import argparse
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
        description="News recommendation on PyTorch and CUDA (serving)",
    )
    sub = parser.add_subparsers(dest="command", required=True)

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
