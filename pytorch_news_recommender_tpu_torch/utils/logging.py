"""Structured run logging: JSONL metrics + wall-clock timing (the port's
copy of the JAX package's ``utils/logging.py``).

Replaces the reference's print-based loss lines and ``res.txt`` appends
(``MIND_2020/train_eval.py:130-134,274-278``) with machine-readable output.
"""

from __future__ import annotations

import json
import pathlib
import sys
import time
from typing import Any, Dict, Optional


class JsonlLogger:
    """Append metric dicts as JSON lines; optionally echo to stdout."""

    def __init__(self, path: Optional[str | pathlib.Path] = None,
                 echo: bool = True):
        self.path = pathlib.Path(path) if path else None
        self.echo = echo
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)

    def __call__(self, record: Dict[str, Any]) -> None:
        record = dict(record)
        record.setdefault("ts", round(time.time(), 3))
        line = json.dumps(record, default=float)
        if self.path:
            with self.path.open("a") as f:
                f.write(line + "\n")
        if self.echo:
            print(line, file=sys.stderr, flush=True)


class Timer:
    """Context-manager stopwatch (reference ``tools.py:18-27`` decorator)."""

    def __init__(self, name: str = ""):
        self.name = name
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        return False
