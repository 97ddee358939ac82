"""Open-loop HTTP load for serving cells, in a process of its own.

    python h100bench/client.py <schedule.npz> <port>

Reads the schedule (``traffic.Requests.arrays()`` and ``sample``, the
indices whose replies the benchmark checks), encodes every request body,
sends a few warm-up requests, prints ``ready`` and waits for ``go <epoch>``
on standard input. Each request is then sent at its due time, on a
connection of its own (the daemon speaks HTTP/1.0), whatever the replies
before it; a request is timed from its due time to the end of its reply,
and the dispatcher's lateness (send time less due time) and the time its
connection took to open are kept. Once every
reply has come or timed out (``TIMEOUT_S``), it prints one JSON object and
exits. It needs only the standard library and numpy.
"""

from __future__ import annotations

import asyncio
import json
import sys
import time

import numpy as np

TIMEOUT_S = 60.0
WARMUP = 12
FOREIGN = ("jax", "jaxlib", "flax", "optax", "orbax", "pytorch_news_recommender_tpu")


def bodies(z) -> list:
    """``(path, body bytes)`` of every request of the schedule."""
    out = []
    hist, hoff, cand, coff = z["hist"], z["hist_off"], z["cand"], z["cand_off"]
    k = int(z["k"])
    for i, kind in enumerate(z["kind"]):
        h = hist[hoff[i]:hoff[i + 1]].tolist()
        if kind == 0:
            out.append(("/score", json.dumps(
                {"history": h, "candidates": cand[coff[i]:coff[i + 1]].tolist()}).encode()))
        else:
            out.append(("/top_k", json.dumps({"history": h, "k": k}).encode()))
    return out


async def call(port: int, path: str, body: bytes, connected=None):
    """``(status, reply body)``; status 0 when the connection fails.
    ``connected()`` is called once the connection is open."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    if connected is not None:
        connected()
    try:
        writer.write(b"POST %s HTTP/1.0\r\nHost: 127.0.0.1\r\nContent-Type: application/json"
                     b"\r\nContent-Length: %d\r\n\r\n%s" % (path.encode(), len(body), body))
        await writer.drain()
        data = await reader.read()
    finally:
        writer.close()
    head, _, payload = data.partition(b"\r\n\r\n")
    try:
        status = int(head.split(b" ", 2)[1])
    except (IndexError, ValueError):
        status = 0
    return status, payload


async def main(path: str, port: int) -> dict:
    z = np.load(path)
    reqs = bodies(z)
    due = z["due"].astype(np.float64)
    sample = set(int(i) for i in z["sample"])
    for i in range(min(WARMUP, len(reqs))):
        await call(port, *reqs[i])
    print("ready", flush=True)
    line = await asyncio.get_running_loop().run_in_executor(None, sys.stdin.readline)
    start_epoch = float(line.split()[1])
    n = len(reqs)
    done = np.full(n, np.nan)
    late = np.zeros(n)
    status = np.zeros(n, np.int32)
    connect = np.full(n, np.nan)
    replies = {}
    loop = asyncio.get_running_loop()
    t0 = loop.time() + (start_epoch - time.time())

    async def one(i: int):
        sent = loop.time()

        def connected():
            connect[i] = loop.time() - sent

        try:
            st, payload = await asyncio.wait_for(call(port, *reqs[i], connected), TIMEOUT_S)
        except (OSError, asyncio.TimeoutError):
            st, payload = 0, b""
        done[i] = loop.time() - t0 - due[i]
        status[i] = st
        if i in sample and st == 200:
            replies[i] = payload.decode()

    tasks = []
    for i in range(n):
        wait = t0 + due[i] - loop.time()
        if wait > 0:
            await asyncio.sleep(wait)
        late[i] = loop.time() - t0 - due[i]
        tasks.append(asyncio.create_task(one(i)))
    await asyncio.gather(*tasks)
    mods = {m.split(".", 1)[0] for m in sys.modules}
    return {"latency_s": done.tolist(), "late_s": late.tolist(), "status": status.tolist(),
            "connect_s": connect.tolist(),
            "replies": {str(i): r for i, r in replies.items()},
            "foreign": sorted(mods & set(FOREIGN))}


if __name__ == "__main__":
    out = asyncio.run(main(sys.argv[1], int(sys.argv[2])))
    sys.stdout.write(json.dumps(out) + "\n")
    sys.stdout.flush()
