"""The port's benchmark: one cell of ``BENCHMARK.json``, one run.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The run serves a ``pilosa_tpu_torch`` node
on one card and measures it from a client process:

1. the cell's configuration is drawn on the card from the seed, shard by
   shard (``configs/<name>.data.py``), and packed into row words
   (``pack.py``);
2. the words are loaded into a ``NodeServer(data_dir=None,
   device="cuda")`` through ``convert.load_arrays``: the index lives in
   memory and nothing is written to disk;
3. the client process (``client.py``) sends each client's warm requests,
   the cell's own query shapes, which build the stacks;
4. the window: the clients' closed loops for ``--seconds``; with
   ``--trace 1`` the spans, counters, kernel operands and a
   ``torch.profiler`` trace over it (``observe.py``);
5. the node is stopped and freed, the plain reference
   (``configs/<name>.ref.py``, ``reference.py``) answers every request of
   the window again from the raw records, and the last line of standard
   output is the result.

``setup_s`` runs from the process's start to the window's, and holds a
build of the program's compiled libraries where the checkout has none
yet. The builds stay in the program's build directory inside the
checkout (``build/``), so only a checkout's first run compiles; the
seconds spent loading them, that build included, are reported apart as
``build_s``.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build"


def log(msg: str) -> None:
    """One line of progress on standard error, after the seconds since the
    process started."""
    print(f"[portbench {time.monotonic() - T_START:7.2f} s] {msg}", file=sys.stderr, flush=True)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--timeline", default=None,
                   help="also write each request of the window, [client, template, sent, "
                        "answered, status] with times in seconds from the window's start, "
                        "to this JSON file")
    return p.parse_args(argv)


def shard_seed(seed: int, shard: int) -> int:
    import numpy as np

    a, b = np.random.SeedSequence([int(seed) % (1 << 64), shard]).generate_state(2)
    return int(a) << 32 | int(b)


def shard_records(cfg: dict, shard: int) -> int:
    width = 1 << cfg["shard_width_exp"]
    return min(width, cfg["records"] - shard * width)


def raw_shards(cell, cfg: dict, seed: int, dev):
    """Each shard's raw records, in order, drawn on ``dev`` from the
    seed."""
    import torch

    data = cell.data_module()
    gen = torch.Generator(device=dev)
    for s in range(cfg["shards"]):
        gen.manual_seed(shard_seed(seed, s))
        yield s, data.raw_shard(cfg, gen, shard_records(cfg, s), dev)


LOADERS = 4  # threads copying packed shards into the holder


def load_libraries(dev) -> float:
    """Load the program's compiled libraries, building those the checkout
    lacks: the seconds it took."""
    from pilosa_tpu_torch import nativelib
    from pilosa_tpu_torch.ops import _hostops
    from pilosa_tpu_torch.storage import _native

    t = time.monotonic()
    if dev.type == "cuda":
        from pilosa_tpu_torch.ops import cuda_build

        cuda_build.load()
    for lib in (_hostops, _native):
        try:
            lib.load()
        except nativelib.NativeBuildError as e:
            log(f"{lib.__name__}: {e}; the program takes its fallback")
    return time.monotonic() - t


def load_node(cell, cfg: dict, seed: int, node, dev) -> None:
    """Draw, pack and load every shard of the configuration into
    ``node``'s holder: the card draws and packs shard after shard into a
    ring of pinned buffers while LOADERS threads hand the buffers to
    ``convert.load_arrays``."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from pilosa_tpu_torch.convert import load_arrays
    from portbench import pack

    data = cell.data_module()
    schema = pack.schema(cfg)
    frags = pack.layout(cfg)
    width = 1 << cfg["shard_width_exp"]
    n_rows = sum(len(rows) for _, _, rows in frags)
    ring = [torch.empty((n_rows, width // 32), dtype=torch.int32, pin_memory=dev.type == "cuda")
            for _ in range(2 * LOADERS)]
    busy = [None] * len(ring)
    node.holder.apply_schema(schema)

    def load(s: int, words) -> None:
        part, r0 = {}, 0
        for field, view, rows in frags:
            part[(cfg["index"], field, view, s)] = (rows, words[r0:r0 + len(rows)])
            r0 += len(rows)
        load_arrays(node.holder, schema, part)

    drawn = 0.0
    with ThreadPoolExecutor(LOADERS) as pool:
        for s, raw in raw_shards(cell, cfg, seed, dev):
            t = time.monotonic()
            k = s % len(ring)
            if busy[k] is not None:
                busy[k].result()
            ring[k].copy_(pack.shard_words(cfg, data.columns(cfg, raw), shard_records(cfg, s), width))
            drawn += time.monotonic() - t
            busy[k] = pool.submit(load, s, ring[k].numpy().view("uint32"))
        for f in busy:
            if f is not None:
                f.result()
    log(f"{drawn:.2f} s drawing and packing on the device (waits for a free buffer included)")


def start_clients(cell, cfg: dict, port: int, seed: int, seconds: float) -> subprocess.Popen:
    proc = subprocess.Popen(
        [sys.executable, "-m", "portbench.client"], cwd=ROOT,
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
    )
    proc.stdin.write(json.dumps({
        "host": "127.0.0.1", "port": port, "index": cfg["index"],
        "traffic": cell.traffic, "seed": seed, "seconds": seconds,
    }) + "\n")
    proc.stdin.flush()
    return proc


def percentile(sorted_vals: list[float], q: float) -> float | None:
    """The loadgen report's percentile: the value at rank ceil(q n)."""
    import math

    if not sorted_vals:
        return None
    idx = max(0, min(len(sorted_vals) - 1, math.ceil(q * len(sorted_vals)) - 1))
    return sorted_vals[idx]


def judge(requests: list, ref) -> dict:
    """Every request of the window against the reference: ``failed`` got
    no answer, ``wrong`` an answer that differs."""
    failed = wrong = 0
    first_wrong = None
    for r in requests:
        if r[5] != 200 or r[6] is None:
            failed += 1
        elif r[6] != ref.answer(r[2]):
            wrong += 1
            first_wrong = first_wrong or r[2]
    return {"failed": failed, "wrong": wrong, "first_wrong": first_wrong}


def window_of(cell, cfg: dict, node, seed: int, seconds: float, trace: bool):
    """Warm the started node from the client process, then run the
    window: ``(the clients' result, the trace's readings, the observer,
    setup_s)``."""
    from portbench import observe

    proc = start_clients(cell, cfg, node.server.port, seed, seconds)
    try:
        line = proc.stdout.readline()
        if line.strip() != "ready":
            raise RuntimeError(f"the clients did not get ready: {line!r}")
        log(f"{cell.traffic['clients']} clients warm")
        obs = observe.Observer(node) if trace else None
        if obs is not None:
            obs.open()
        setup_s = time.monotonic() - T_START
        t_go = time.monotonic()
        proc.stdin.write("go\n")
        proc.stdin.flush()
        raw = obs.stop(t_go, seconds) if obs is not None else None
        out = json.loads(proc.stdout.readline())
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return out, raw, obs, setup_s


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             cfg: dict | None = None, timeline: list | None = None) -> tuple[dict, list, dict, list]:
    """One run of ``cell`` (its configuration ``cfg`` where given):
    ``(the result line's object, the forbidden modules either process
    loaded, the comparison's verdict, the client process's errors)``;
    each request's times are added to ``timeline`` where one is given."""
    import torch

    from pilosa_tpu_torch.server.node import NodeServer
    from portbench import guard
    from portbench.reference import Reference

    cfg = cfg or cell.config
    dev = torch.device(device)
    build_s = load_libraries(dev)
    log(f"{build_s:.2f} s loading the program's compiled libraries (builds included)")
    node = NodeServer(data_dir=None, device=device, **cfg.get("node", {}))
    try:
        load_node(cell, cfg, seed, node, dev)
        log(f"{cfg['shards']} shards of {cfg['records']} records drawn and loaded")
        node.start()
        out, raw, obs, setup_s = window_of(cell, cfg, node, seed, seconds, trace)
        t0, t1 = out["t0"], out["t1"]
        reqs = out["requests"]
        log(f"window closed: {len(reqs)} requests")
        if timeline is not None:
            timeline.extend([r[0], r[1], r[3] - t0, None if r[4] is None else r[4] - t0, r[5]]
                            for r in reqs)
        window = breakdown = None
        if obs is not None:
            window, breakdown = obs.window(raw, t0, t1)
            window.requests = reqs
            obs.restore()
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    finally:
        node.stop()
    del node
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    table = cell.ref_module().cell_table(
        cfg, (r for _, r in raw_shards(cell, cfg, seed, dev)), dev)
    verdict = judge(reqs, Reference(table))
    log("reference compared")
    answered = sum(1 for r in reqs if r[5] == 200 and r[4] <= t1)
    lat = sorted((r[4] - r[3]) * 1e3 for r in reqs if r[5] == 200)
    metrics = {}
    if not trace:
        values = {"queries_per_s": answered / (t1 - t0), "p95_ms": percentile(lat, 0.95),
                  "setup_s": setup_s}
        for m in cell.end_to_end:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        bench = cell.bench
        for m in cell.per_layer:
            v = bench.reader(m["name"])(window)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    found = sorted(set(guard.forbidden()) | set(out["forbidden"]))
    checks = {
        "wrong_answers": {"value": verdict["wrong"], "limit": 0},
        "unanswered": {"value": verdict["failed"], "limit": 0},
        "client_errors": {"value": len(out["errors"]), "limit": 0},
    }
    correct = all(c["value"] <= c["limit"] for c in checks.values()) and bool(reqs)
    result = {
        "correct": correct,
        "attempted": len(reqs),
        "failed": verdict["failed"],
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": 1,
            "memory_peak_bytes": peak,
        },
    }
    if window is not None:
        result["device"]["busy_s"] = window.busy_s
        result["device"]["window_s"] = window.traced_s
        result["breakdown"] = breakdown
    result["build_s"] = build_s
    result["checks"] = checks
    return result, found, verdict, out["errors"]


def main(argv=None) -> int:
    args = parse_args(argv)
    from portbench.spec import Benchmark

    cell = Benchmark(ROOT).cell(args.workload)
    os.environ["PILOSA_TPU_SHARD_WIDTH"] = str(cell.config["shard_width_exp"])
    os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    timeline = [] if args.timeline else None
    result, found, verdict, errors = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                              timeline=timeline)
    if timeline is not None:
        Path(args.timeline).parent.mkdir(parents=True, exist_ok=True)
        Path(args.timeline).write_text(json.dumps(timeline))
    if found:
        print(f"portbench: the run imported {', '.join(found)}", file=sys.stderr)
        return 3
    for e in errors:
        print(f"portbench: client error {e}", file=sys.stderr)
    if verdict["first_wrong"]:
        print(f"portbench: first wrong answer: {verdict['first_wrong']}", file=sys.stderr)
    print(f"build_s {result['build_s']} (inside setup_s)", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
