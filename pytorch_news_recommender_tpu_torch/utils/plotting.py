"""Loss-curve PNG output (the port's copy of the JAX package's
``utils/plotting.py``; reference ``tools.py:55-62`` ``plot_loss``, called at
the end of training, ``train_eval.py:153``).

Reads the JSONL metrics stream the trainer writes (``utils/logging.py``)
instead of an in-memory list, so curves can be (re)rendered for any past run.
"""

from __future__ import annotations

import json
import pathlib
from typing import Optional, Sequence


def plot_loss(
    metrics_jsonl: str | pathlib.Path,
    out_png: Optional[str | pathlib.Path] = None,
    keys: Sequence[str] = ("loss",),
) -> Optional[pathlib.Path]:
    """Render training curves from a metrics JSONL file. Returns the PNG path
    (or None when matplotlib is unavailable — headless-safe no-op)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None

    metrics_jsonl = pathlib.Path(metrics_jsonl)
    steps: list[int] = []
    series: dict[str, list[tuple[int, float]]] = {k: [] for k in keys}
    aucs: list[tuple[int, float]] = []
    for line in metrics_jsonl.read_text().splitlines():
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        step = rec.get("step")
        if step is None:
            continue
        for k in keys:
            if k in rec:
                series[k].append((step, float(rec[k])))
        if "auc" in rec:
            aucs.append((step, float(rec["auc"])))

    fig, ax = plt.subplots(figsize=(8, 4.5))
    for k, pts in series.items():
        if pts:
            xs, ys = zip(*pts)
            ax.plot(xs, ys, label=k)
    ax.set_xlabel("step")
    ax.set_ylabel("loss")
    if aucs:
        ax2 = ax.twinx()
        xs, ys = zip(*aucs)
        ax2.plot(xs, ys, "o--", color="tab:green", label="dev AUC")
        ax2.set_ylabel("dev AUC")
    if any(series[k] for k in keys):
        ax.legend(loc="upper right")
    fig.tight_layout()
    if out_png is None:
        out_png = metrics_jsonl.with_suffix(".png")
    out_png = pathlib.Path(out_png)
    fig.savefig(out_png, dpi=120)
    plt.close(fig)
    return out_png
