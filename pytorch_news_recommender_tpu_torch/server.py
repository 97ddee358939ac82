"""HTTP serving daemon around :class:`serve.Recommender` (port of the JAX
package's ``server.py``, the same stdlib ``http.server`` daemon):

* ``GET  /healthz``     -> {"status": "ok", "model": ..., "n_news": N}
* ``POST /score``       {"history": [ids], "candidates": [ids],
                          "user_id": 0}         -> {"scores": [...]}
* ``POST /top_k``       {"history": [ids], "k": 10}
                                               -> {"ids": [...], "scores": [...]}
* ``POST /add_news``    {"title": str, "abstract": str, "category": str,
                          "subcategory": str, "entities": [qids]}
                                               -> {"id": new_news_id}
  (tokenizes with the persisted preprocessing dictionaries, encodes through
  the news tower, appends to the corpus cache — the id scores immediately)

The threading server overlaps host JSON work across requests; device work
from every thread goes to the card's default stream in order.

Start from the CLI: ``python -m pytorch_news_recommender_tpu_torch.cli serve
--data <artifacts> --ckpt <dir> --port 8000``.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from pytorch_news_recommender_tpu_torch.serve import Recommender

# add_news mutates the Recommender's corpus tables; requests on the
# threading server serialize their mutations here (reads are safe: each
# request path captures a consistent table tuple at call time)
_ADD_LOCK = threading.Lock()


class _ScoreBatcher:
    """Micro-batching window for /score requests.

    Handler threads enqueue ``(history, candidates, user_id)`` and block on
    an event; a single worker drains the queue — waiting up to ``window_ms``
    after the first request to let a batch form (max ``max_batch``) — and
    answers the whole group with ONE ``Recommender.score_many`` call. Under
    load this turns N user-tower launches into one per width bucket; an
    idle daemon still answers each request after at most one window.
    """

    def __init__(self, rec: Recommender, window_ms: float, max_batch: int):
        self.rec = rec
        self.window = window_ms / 1e3
        self.max_batch = max_batch
        self.q: queue.Queue = queue.Queue()
        self._stop = False
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def submit(self, request, timeout: float = 30.0):
        slot = {"evt": threading.Event()}
        self.q.put((slot, request))
        if not slot["evt"].wait(timeout):
            raise TimeoutError("batched scoring timed out")
        if "error" in slot:
            raise slot["error"]
        return slot["result"]

    def _worker(self):
        while not self._stop:
            try:
                first = self.q.get(timeout=0.1)
            except queue.Empty:
                continue
            if first is None:
                return
            batch = [first]
            deadline = time.perf_counter() + self.window
            while len(batch) < self.max_batch:
                remain = deadline - time.perf_counter()
                if remain <= 0:
                    break
                try:
                    item = self.q.get(timeout=remain)
                except queue.Empty:
                    break
                if item is None:
                    self._stop = True
                    break
                batch.append(item)
            try:
                results = self.rec.score_many([r for _, r in batch])
                for (slot, _), res in zip(batch, results):
                    slot["result"] = res
                    slot["evt"].set()
            except Exception as e:  # noqa: BLE001 — surfaced per-request
                for slot, _ in batch:
                    slot["error"] = e
                    slot["evt"].set()

    def stop(self):
        self._stop = True
        self.q.put(None)
        self._thread.join(timeout=5)


def _make_handler(rec: Recommender, batcher: Optional[_ScoreBatcher] = None):
    class Handler(BaseHTTPRequestHandler):
        # quiet by default; the daemon logs one JSONL line per request
        def log_message(self, fmt, *args):  # noqa: N802
            pass

        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802
            if self.path == "/healthz":
                self._reply(200, {
                    "status": "ok",
                    "model": rec.cfg.model.name,
                    "n_news": rec.n_news,
                    "corpus_cache": rec.corpus_cache,
                })
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):  # noqa: N802
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
            except (ValueError, json.JSONDecodeError) as e:
                self._reply(400, {"error": f"bad JSON: {e}"})
                return
            try:
                if self.path == "/score":
                    args = (req.get("history", []), req["candidates"],
                            int(req.get("user_id", 0)))
                    if batcher is not None:
                        scores = batcher.submit(args)
                    else:
                        scores = rec.score(*args)
                    self._reply(200, {"scores": [float(s) for s in scores]})
                elif self.path == "/top_k":
                    ids, scores = rec.top_k(
                        req.get("history", []), k=int(req.get("k", 10)))
                    self._reply(200, {
                        "ids": [int(i) for i in ids],
                        "scores": [float(s) for s in scores],
                    })
                elif self.path == "/add_news":
                    with _ADD_LOCK:
                        nid = rec.add_news(
                            req["title"],
                            abstract=req.get("abstract", ""),
                            category=req.get("category", ""),
                            subcategory=req.get("subcategory", ""),
                            entities=req.get("entities", ()),
                        )
                    self._reply(200, {"id": int(nid)})
                else:
                    self._reply(404, {"error": f"unknown path {self.path}"})
            except KeyError as e:
                self._reply(400, {"error": f"missing field: {e}"})
            except Exception as e:  # surface scoring errors as 500s
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


class RecommenderServer:
    """Owns the HTTP server; ``start()`` runs each request path once first
    (on the card, the first launch builds the kernel)."""

    def __init__(self, rec: Recommender, host: str = "127.0.0.1",
                 port: int = 8000, batch_window_ms: float = 0.0,
                 max_batch: int = 32):
        self.rec = rec
        self.batcher = (_ScoreBatcher(rec, batch_window_ms, max_batch)
                        if batch_window_ms > 0 else None)
        self.httpd = ThreadingHTTPServer(
            (host, port), _make_handler(rec, self.batcher))
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def warmup(self):
        self.rec.score([1, 2], [1, 2, 3])
        if self.rec.ranks_corpus:   # LSTUR serves /score only
            self.rec.top_k([1, 2], k=5)
        if self.batcher is not None:
            self.rec.score_many([([1, 2], [1, 2, 3], 0)])

    def start(self, block: bool = True):
        self.warmup()
        if block:
            self.httpd.serve_forever()
        else:
            self._thread = threading.Thread(
                target=self.httpd.serve_forever, daemon=True)
            self._thread.start()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        if self.batcher is not None:
            self.batcher.stop()
        if self._thread is not None:
            self._thread.join(timeout=5)
