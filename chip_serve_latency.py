"""Single-device serving latency of the port on one NVIDIA card.

    python3 chip_serve_latency.py [--calls 200]

Serves NRMS at the width of ``chip_smoke.py``'s serving phases (the JAX
package's defaults, seeded weights) from phase 3's synthetic corpus (65,238
news and the pad row, vocabulary 32,000) with a ``Recommender`` on the card,
in both cache modes, and times ``score_many`` over 32 requests of 300
candidates and ``top_k`` (k=10), each ``--calls`` times after a warm-up of 10
calls, on the host's clock (both return host arrays, so the device work is
inside). Prints the card's name and power limit, then one JSON line:
``{"score_many": {"native": [p50, p99], "int8": [...]}, "top_k": {...}}``
in ms. To compare two checkouts on one card, copy this file into the other's
root and run both, in one call, alternately. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

import chip_smoke as CS


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=200)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_serve_latency: no CUDA device", file=sys.stderr)
        return 2
    from pytorch_news_recommender_tpu_torch.config import Config, DataConfig
    from pytorch_news_recommender_tpu_torch.data import synthetic
    from pytorch_news_recommender_tpu_torch.models import build_model
    from pytorch_news_recommender_tpu_torch.serve import Recommender

    cfg = Config(data=DataConfig(dataset="synthetic"))
    ds = synthetic.generate(cfg.data, seed=0, n_news=CS.N_NEWS, vocab_size=CS.VOCAB)
    model = build_model(cfg.model.with_artifact_meta(ds.meta))
    model.reset_parameters(torch.Generator().manual_seed(0))
    params = model.state_dict()
    rng = np.random.default_rng(4)
    n_rows = CS.N_NEWS + 1
    batch = [(h, rng.integers(1, n_rows, size=300).tolist(), 0)
             for h, _ in CS.make_requests(rng, Recommender.BATCH_PAD, n_rows)]
    hist = batch[0][0]
    out = {"score_many": {}, "top_k": {}}
    for cache in ("native", "int8"):
        rec = Recommender(cfg, ds, params, corpus_cache=cache, device="cuda")
        for name, fn in (("score_many", lambda: rec.score_many(batch)),
                         ("top_k", lambda: rec.top_k(hist, 10))):
            CS.latency(fn, 10)
            out[name][cache] = list(CS.latency(fn, args.calls))
        del rec
    print(CS.card())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
