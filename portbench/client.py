"""The cell's clients, in a process of their own: closed-loop clients on
keep-alive HTTP/1.1 connections to the node's query route, all on one
asyncio loop in one thread, so the load costs one core and the node's
interpreter serves only the node.

    python -m portbench.client      (driven by run.py over its pipes)

Protocol: one JSON line on stdin (``host``, ``port``, ``index``,
``traffic``, ``seed``, ``seconds``); each client sends its warm requests;
the process prints ``ready``; on a ``go`` line each client sends
requests from its window plan until ``seconds`` have passed, every
request sent is awaited (at most ``LATE_S`` past the close), and the
process prints one JSON line: the window's start and end on the host's
monotonic clock, and per request ``[client, template, body, sent,
answered, status, answer]``, the answer in :func:`reference.canonical`
form (None where none came), and the modules it found that the run may
not import.
"""

from __future__ import annotations

import asyncio
import json
import sys
import time

from portbench import guard
from portbench.reference import canonical
from portbench.traffic import WARM, WINDOW, Plan

LATE_S = 60.0


class Conn:
    def __init__(self, host: str, port: int, index: str):
        self.host, self.port = host, port
        self.path = f"/index/{index}/query".encode()
        self.reader = self.writer = None

    async def query(self, body: str) -> tuple[int, bytes]:
        if self.writer is None:
            self.reader, self.writer = await asyncio.open_connection(self.host, self.port)
        data = body.encode()
        self.writer.write(b"POST %s HTTP/1.1\r\nHost: %s\r\nContent-Type: text/plain\r\n"
                          b"Content-Length: %d\r\n\r\n%s"
                          % (self.path, self.host.encode(), len(data), data))
        await self.writer.drain()
        status = int((await self.reader.readline()).split()[1])
        length, close = 0, False
        while True:
            line = await self.reader.readline()
            if line in (b"\r\n", b""):
                break
            k, _, v = line.decode("latin-1").partition(":")
            k = k.strip().lower()
            if k == "content-length":
                length = int(v)
            elif k == "connection" and v.strip().lower() == "close":
                close = True
        payload = await self.reader.readexactly(length)
        if close:
            self.close()
        return status, payload

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()
        self.reader = self.writer = None


async def _client(k: int, cfg: dict, go: asyncio.Event, ready: list, out: list) -> None:
    conn = Conn(cfg["host"], cfg["port"], cfg["index"])
    warm = Plan(cfg["traffic"], cfg["seed"], k, WARM)
    for _ in range(int(cfg["traffic"].get("warm_requests", 0))):
        name, body = warm.next()
        status, payload = await conn.query(body)
        if status != 200:
            raise RuntimeError(f"warm request {body!r}: {status} {payload[:300]!r}")
    ready.append(k)
    await go.wait()
    plan = Plan(cfg["traffic"], cfg["seed"], k, WINDOW)
    while time.monotonic() < cfg["stop_at"]:
        name, body = plan.next()
        rec = [k, name, body, time.monotonic(), None, None, None]
        out.append(rec)
        status, payload = await conn.query(body)
        rec[4], rec[5], rec[6] = time.monotonic(), status, payload
    conn.close()


async def _main(cfg: dict) -> dict:
    go = asyncio.Event()
    ready: list = []
    out: list = []
    n = int(cfg["traffic"]["clients"])
    cfg["stop_at"] = float("inf")
    tasks = [asyncio.ensure_future(_client(k, cfg, go, ready, out)) for k in range(n)]
    while len(ready) < n:
        done = [t for t in tasks if t.done()]
        for t in done:
            t.result()  # a warm request that failed raises here
        await asyncio.sleep(0.01)
    print("ready", flush=True)
    loop = asyncio.get_running_loop()
    line = await loop.run_in_executor(None, sys.stdin.readline)
    if line.strip() != "go":
        raise RuntimeError(f"expected go, got {line!r}")
    t0 = time.monotonic()
    cfg["stop_at"] = t0 + float(cfg["seconds"])
    go.set()
    done, pending = await asyncio.wait(tasks, timeout=float(cfg["seconds"]) + LATE_S)
    for t in pending:
        t.cancel()
    errors = [repr(t.exception()) for t in done if t.exception() is not None]
    reqs = []
    for k, name, body, sent, got, status, payload in out:
        if status == 200:
            answer = [canonical(r) for r in json.loads(payload)["results"]]
        else:
            answer = None if payload is None else payload[:300].decode("utf-8", "replace")
        reqs.append([k, name, body, sent, got, status, answer])
    return {"t0": t0, "t1": cfg["stop_at"], "requests": reqs, "errors": errors,
            "forbidden": guard.forbidden()}


def main() -> None:
    cfg = json.loads(sys.stdin.readline())
    result = asyncio.run(_main(cfg))
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()


if __name__ == "__main__":
    main()
