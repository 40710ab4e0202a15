"""Smoke run of pilosa_tpu_torch on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):

1. Device: requires CUDA, prints the card's name and power limit, and
   builds the CUDA kernels from ``pilosa_tpu_torch/ops/csrc`` with nvcc.
2. Kernels: each kernel against its plain PyTorch version on the card,
   with exact equality, at the serving shape (160 shards x 64 rows x
   32768 words), at ragged shapes and on the chunked-gram branch; then
   the kernel, the plain version and (for the gram) ``torch._int_mm`` on
   pre-unpacked int8 operands are timed with CUDA events.
3. End to end: a seeded index at the repo's serving size (bench.py's
   160 shards x 64 rows at shard width 2^20, about 25 % dense, plus a
   second 64-row field for TopN filters) on ``Holder(device="cuda")``,
   served through ``Executor.execute`` and ``execute_batch``: tanimoto
   TopN, a 1024-call batch of mixed pair Counts, Set/Clear writes, and
   the same reads again. Every answer equals a numpy ground truth taken
   from the host mirrors, and every kernel's launch counter must rise.
4. Summary: one ``{"end_to_end": {...}}`` line, one ``{"kernels": [...]}``
   line, the card line, and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent

# The serving shape is defined at the reference's shard width (2^20).
os.environ["PILOSA_TPU_SHARD_WIDTH"] = "20"

S_FULL, R_FULL, W_FULL = 160, 64, 1 << 15
BATCH = 1024
SEED = 20261017
# H100 SXM peaks (NVIDIA data sheet, dense): memory and int8 tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT8_OPS_PER_S = 1979e12
OPS = ["Intersect", "Union", "Difference", "Xor"]
NP_OPS = {
    "Intersect": lambda a, b: a & b,
    "Union": lambda a, b: a | b,
    "Difference": lambda a, b: a & ~b,
    "Xor": lambda a, b: a ^ b,
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` on the card, from CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def random_words(rng, shape, dense: bool):
    """uint32 words from the seed: uniform, or ~25 % dense (a & b)."""
    import numpy as np

    n = int(np.prod(shape))
    a = np.frombuffer(rng.bytes(4 * n), dtype=np.uint32).reshape(shape)
    if not dense:
        return a.copy()
    b = np.frombuffer(rng.bytes(4 * n), dtype=np.uint32).reshape(shape)
    return a & b


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_kernels(stack_np, filt_np, dev):
    import numpy as np
    import torch

    from pilosa_tpu_torch.ops import bitops, kernels as tk

    bits = bitops.to_device(stack_np, dev)
    filt = bitops.to_device(filt_np, dev)
    S, R, W = bits.shape
    rng = np.random.default_rng(SEED + 1)
    report = {}

    def exact(name, got, want):
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        if err != 0:
            raise AssertionError(f"{name}: kernel differs from plain, max |err| {err}")
        return err

    # -- the serving shape
    e_scan = exact("row_scan", tk.row_counts_per_shard(bits),
                   tk.row_counts_per_shard_plain(bits))
    e_mask = exact("masked_row_scan", tk.masked_row_counts_per_shard(bits, filt),
                   tk.masked_row_counts_per_shard_plain(bits, filt))
    full_idx = np.arange(R)
    e_gram = exact("gram", tk.gram_gather(bits, full_idx),
                   tk.gram_gather_plain(bits, full_idx))
    sub_idx = np.sort(rng.choice(R, size=(R * 4) // 7, replace=False))
    exact(f"gram subset U={len(sub_idx)}<R", tk.gram_gather(bits, sub_idx),
          tk.gram_gather_plain(bits, sub_idx))
    log(f"kernels exact at the serving shape {tuple(bits.shape)}")

    # -- ragged shapes: S not a multiple of 8, R below 8 and not a power
    #    of two, W not a multiple of 4, U past one 64-row gram tile
    for (s, r, w) in [(13, 5, W), (3, 7, 130), (9, 150, 256)]:
        b = bitops.to_device(random_words(rng, (s, r, w), dense=True), dev)
        f = bitops.to_device(random_words(rng, (s, w), dense=False), dev)
        exact(f"row_scan {s,r,w}", tk.row_counts_per_shard(b),
              tk.row_counts_per_shard_plain(b))
        exact(f"masked_row_scan {s,r,w}", tk.masked_row_counts_per_shard(b, f),
              tk.masked_row_counts_per_shard_plain(b, f))
        idx = np.sort(rng.choice(r, size=max(1, (2 * r) // 3), replace=False))
        exact(f"gram {s,r,w} U={len(idx)}", tk.gram_gather(b, idx),
              tk.gram_gather_plain(b, idx))
    log("kernels exact at ragged shapes")

    # -- the chunked-gram branch: a shrunken accumulator limit splits the
    #    shard axis into chunks whose int64 sum must equal one launch
    one = tk.pair_gram(bits, list(range(R)))
    saved = tk._GRAM_ACC_LIMIT
    chunk = S // 4 + 1
    tk._GRAM_ACC_LIMIT = chunk * W * 32
    try:
        before = tk.LAUNCHES["gram"]
        chunked = tk.pair_gram(bits, list(range(R)))
        n_chunks = tk.LAUNCHES["gram"] - before
    finally:
        tk._GRAM_ACC_LIMIT = saved
    if dev.type == "cuda" and n_chunks != -(-S // chunk):
        raise AssertionError(f"chunked gram: {n_chunks} launches")
    if not np.array_equal(one, chunked):
        raise AssertionError("chunked gram differs from one launch")
    plain_full = tk.gram_gather_plain(bits, full_idx).cpu().numpy()
    if not np.array_equal(one, plain_full):
        raise AssertionError("pair_gram differs from the plain gram")
    log(f"chunked gram exact ({n_chunks} shard chunks)")

    # -- timings at the serving shape
    t_scan = cuda_ms(lambda: tk.row_counts_per_shard(bits), reps=20)
    t_scan_p = cuda_ms(lambda: tk.row_counts_per_shard_plain(bits), reps=5)
    t_mask = cuda_ms(lambda: tk.masked_row_counts_per_shard(bits, filt), reps=20)
    t_mask_p = cuda_ms(lambda: tk.masked_row_counts_per_shard_plain(bits, filt), reps=5)
    t_gram = cuda_ms(lambda: tk.gram_gather(bits, full_idx), reps=10)
    t_gram_p = cuda_ms(lambda: tk.gram_gather_plain(bits, full_idx), reps=3)
    # the library yardstick: one int8 x int8 -> int32 product over the
    # pre-unpacked operand [R, S*W*32] (unpacked per shard; unpack untimed)
    a8 = torch.empty((R, S * W * 32), dtype=torch.int8, device=dev)
    for s in range(S):
        a8[:, s * W * 32:(s + 1) * W * 32] = tk.unpack_bits(bits[s], torch.int8)
    lib_out = torch._int_mm(a8, a8.T)
    exact("torch._int_mm yardstick", lib_out, tk.gram_gather(bits, full_idx))
    t_lib = cuda_ms(lambda: torch._int_mm(a8, a8.T), reps=10)
    del a8, lib_out
    torch.cuda.empty_cache()

    def bound(nbytes, nops):
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = nops / PEAK_INT8_OPS_PER_S * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    words = S * R * W
    # scans: every word read once, one AND/popc/add per word (counted as
    # 32 one-bit int8-equivalent multiply-adds, 2 ops each)
    b_scan = bound(words * 4 + S * R * 4, 2 * words * 32)
    b_mask = bound(words * 4 + S * W * 4 + S * R * 4, 2 * words * 32)
    # gram: G is symmetric, so the function needs only the R(R+1)/2
    # distinct dot products of length S*W*32 (2 ops per bit each)
    b_gram = bound(words * 4 + R * 4 + R * R * 4, R * (R + 1) * S * W * 32)
    report = {
        "row_scan": dict(max_abs_err=e_scan, ms=t_scan, plain_ms=t_scan_p,
                         bound=b_scan, library_ms=None),
        "masked_row_scan": dict(max_abs_err=e_mask, ms=t_mask, plain_ms=t_mask_p,
                                bound=b_mask, library_ms=None),
        "gram": dict(max_abs_err=e_gram, ms=t_gram, plain_ms=t_gram_p,
                     bound=b_gram, library_ms=t_lib),
    }
    for k, v in report.items():
        log(f"{k}: kernel {v['ms']:.3f} ms, plain {v['plain_ms']:.3f} ms, "
            f"bound {v['bound'][0]:.3f} ms ({v['bound'][1]}), "
            f"library {v['library_ms'] if v['library_ms'] is None else round(v['library_ms'], 3)}")
    log("scans: no single PyTorch call computes a per-row popcount, "
        "so their library_ms is null")
    del bits, filt
    torch.cuda.empty_cache()
    return report


# ---------------------------------------------------------------------------
# Phase 3: the main path, end to end
# ---------------------------------------------------------------------------


def mirror_stack(holder, field: str, n_rows: int, n_shards: int):
    """numpy uint32[S, R, W] of a field's standard view, from the host
    mirrors (the ground truth's source)."""
    import numpy as np

    f = holder.field("i", field)
    view = f.view("standard")
    out = np.zeros((n_shards, n_rows, f.n_words), dtype=np.uint32)
    for s in range(n_shards):
        frag = view.fragment(s)
        if frag is None:
            continue
        ids, mat = frag.rows_matrix_host()
        for k, r in enumerate(ids):
            out[s, r] = mat[k]
    return out


def truth_pair_counts(stack, items, pool):
    """numpy counts of Count(op(Row(a), Row(b))) per item (op, a, b)."""
    import numpy as np

    def one(item):
        op, a, b = item
        return int(np.bitwise_count(NP_OPS[op](stack[:, a], stack[:, b])).sum(dtype=np.int64))

    return list(pool.map(one, items))


def truth_tanimoto_topn(f_stack, g_stack, g_row, threshold, n, pool):
    import numpy as np

    filt = g_stack[:, g_row]
    src = int(np.bitwise_count(filt).sum(dtype=np.int64))

    def row(r):
        inter = int(np.bitwise_count(f_stack[:, r] & filt).sum(dtype=np.int64))
        tot = int(np.bitwise_count(f_stack[:, r]).sum(dtype=np.int64))
        return r, inter, tot

    keep = []
    for r, c, tot in pool.map(row, range(f_stack.shape[1])):
        denom = tot + src - c
        if c >= 1 and denom > 0 and c * 100 >= threshold * denom:
            keep.append((r, c))
    keep.sort(key=lambda p: (-p[1], p[0]))
    return keep[:n]


def main_path(pool, device):
    import numpy as np
    import torch

    from pilosa_tpu_torch import convert
    from pilosa_tpu_torch.exec.executor import Executor
    from pilosa_tpu_torch.ops import kernels as tk
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, SHARD_WORDS

    assert SHARD_WORDS == W_FULL, SHARD_WORDS
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    f_words = random_words(rng, (S_FULL, R_FULL, SHARD_WORDS), dense=True)
    g_words = random_words(rng, (S_FULL, R_FULL, SHARD_WORDS), dense=True)
    schema = [{
        "name": "i",
        "options": {"keys": False, "trackExistence": True},
        "fields": [{"name": "f", "options": {}}, {"name": "g", "options": {}}],
    }]
    rows = list(range(R_FULL))
    fragments = {}
    for s in range(S_FULL):
        fragments[("i", "f", "standard", s)] = (rows, f_words[s])
        fragments[("i", "g", "standard", s)] = (rows, g_words[s])
    holder = convert.holder_from_arrays(schema, fragments, device=device)
    del fragments
    setup_s = time.perf_counter() - t0
    log(f"index built: {S_FULL} shards x {R_FULL} rows x 2^20 columns x 2 fields, "
        f"{f_words.size * 32 / 1e9:.2f}e9 bits per field, "
        f"density {np.bitwise_count(f_words[0]).mean() / 32:.3f}, {setup_s:.1f} s")
    if holder.device.type != torch.device(device).type:
        raise AssertionError(f"holder on {holder.device}")
    ex = Executor(holder)
    qrng = np.random.default_rng(SEED + 2)
    results = {}

    # the same queries run before and after the writes
    g_row = int(qrng.integers(0, R_FULL))
    items = [
        (OPS[int(qrng.integers(0, 4))], int(qrng.integers(0, R_FULL)),
         int(qrng.integers(0, R_FULL)))
        for _ in range(BATCH)
    ]
    calls = [f"Count({op}(Row(f={a}), Row(f={b})))" for op, a, b in items]

    def run_round(tag):
        f_stack = mirror_stack(holder, "f", R_FULL, S_FULL)
        g_stack = mirror_stack(holder, "g", R_FULL, S_FULL)
        # tanimoto TopN on a fresh snapshot: stack build + masked scan +
        # row scan; then warm (stack and row totals cached)
        q = f"TopN(f, Row(g={g_row}), n=10, tanimotoThreshold=10)"
        t = time.perf_counter()
        (got,) = ex.execute("i", q)
        cold_ms = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        (again,) = ex.execute("i", q)
        warm_ms = (time.perf_counter() - t) * 1e3
        want = truth_tanimoto_topn(f_stack, g_stack, g_row, 10, 10, pool)
        for res in (got, again):
            if [(p.id, p.count) for p in res] != want:
                raise AssertionError(f"{tag}: {q} -> {res} != {want}")
        if not want:
            raise AssertionError(f"{tag}: empty TopN answer checks nothing")
        # 1024 mixed pair Counts as one execute_batch (one gram launch),
        # then the same calls in one execute (served from the cached gram)
        t = time.perf_counter()
        batch_out = ex.execute_batch("i", [(c, None) for c in calls])
        batch_s = time.perf_counter() - t
        t = time.perf_counter()
        exec_out = ex.execute("i", " ".join(calls))
        exec_s = time.perf_counter() - t
        want_counts = truth_pair_counts(f_stack, items, pool)
        got_batch = []
        for o in batch_out:
            if isinstance(o, Exception):
                raise o
            got_batch.append(o[0])
        if got_batch != want_counts or exec_out != want_counts:
            bad = sum(g != w for g, w in zip(got_batch, want_counts))
            raise AssertionError(f"{tag}: {bad} of {BATCH} pair counts differ")
        # unfiltered TopN from the maintained counts (no device work)
        (top,) = ex.execute("i", "TopN(g, n=5)")
        tot = np.bitwise_count(g_stack).sum(axis=(0, 2), dtype=np.int64)
        want_top = sorted(((int(r), int(c)) for r, c in enumerate(tot) if c), key=lambda p: (-p[1], p[0]))[:5]
        if [(p.id, p.count) for p in top] != want_top:
            raise AssertionError(f"{tag}: TopN(g, n=5) {top} != {want_top}")
        results[tag] = {
            "topn_tanimoto_cold_ms": cold_ms,
            "topn_tanimoto_warm_ms": warm_ms,
            "pair_batch_execute_batch_s": batch_s,
            "pair_batch_execute_batch_qps": BATCH / batch_s,
            "pair_batch_execute_cached_gram_s": exec_s,
        }
        log(f"{tag}: tanimoto TopN cold {cold_ms:.1f} ms, warm {warm_ms:.1f} ms; "
            f"{BATCH} pair Counts via execute_batch {batch_s * 1e3:.1f} ms "
            f"({BATCH / batch_s:.0f} queries/s), via execute from the cached "
            f"gram {exec_s * 1e3:.1f} ms; all answers equal the numpy truth")

    tk.reset_launches()
    run_round("before_writes")
    writes = [
        ("Set" if qrng.random() < 0.6 else "Clear",
         "f" if qrng.random() < 0.75 else "g",
         int(qrng.integers(0, R_FULL)),
         int(qrng.integers(0, S_FULL * SHARD_WIDTH)))
        for _ in range(64)
    ]
    t = time.perf_counter()
    changed = ex.execute(
        "i", " ".join(f"{op}({col}, {fld}={r})" for op, fld, r, col in writes)
    )
    write_ms = (time.perf_counter() - t) * 1e3
    last = {(fld, r, col): op for op, fld, r, col in writes}
    for (fld, r, col), op in last.items():
        if holder.field("i", fld).get_bit(r, col) != (op == "Set"):
            raise AssertionError(f"write not visible: {op}({col}, {fld}={r})")
    log(f"{len(writes)} Set/Clear writes in one execute: {write_ms:.1f} ms, "
        f"{sum(bool(c) for c in changed)} changed a bit")
    run_round("after_writes")
    launches = dict(tk.LAUNCHES)
    log(f"main-path launches: {launches}")
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {k} was not launched on the main path")
    results["writes_ms"] = write_ms
    results["setup_s"] = setup_s
    results["stack_rebuilds"] = ex.stack_rebuilds
    return launches, results


def main() -> int:
    if not (HERE / "pilosa_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke.py must run from a checkout holding pilosa_tpu_torch/",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available; chip_smoke.py runs on a CUDA card only",
              file=sys.stderr)
        return 1
    import numpy as np

    from pilosa_tpu_torch.ops import cuda_build

    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    cuda_build.load()
    info = cuda_build.build_info
    log(f"kernels {'built' if info['compiled'] else 'loaded'} in "
        f"{info['seconds']:.1f} s: {info['path']}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log("  nvcc: " + line.strip())

    rng = np.random.default_rng(SEED + 3)
    stack = random_words(rng, (S_FULL, R_FULL, W_FULL), dense=True)
    filt = random_words(rng, (S_FULL, W_FULL), dense=False)
    kern = check_kernels(stack, filt, torch.device("cuda"))
    del stack, filt

    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        launches, e2e = main_path(pool, "cuda")

    sources = {
        "row_scan": ("pilosa_tpu_torch/ops/csrc/row_scan.cu",
                     "pilosa_tpu/ops/kernels.py:1537 _row_scan_kernel"),
        "masked_row_scan": ("pilosa_tpu_torch/ops/csrc/masked_row_scan.cu",
                            "pilosa_tpu/ops/kernels.py:1730 _masked_row_scan_kernel"),
        "gram": ("pilosa_tpu_torch/ops/csrc/gram.cu",
                 "pilosa_tpu/ops/kernels.py:651 _gram_pallas_kernel"),
    }
    name, limit = [x.strip() for x in card.split(",", 1)]
    entries = []
    for k, (src, replaces) in sources.items():
        v = kern[k]
        entries.append({
            "name": k,
            "route": "cuda",
            "source": src,
            "replaces": replaces,
            "launches": launches[k],
            "max_abs_err": v["max_abs_err"],
            "match": v["max_abs_err"] == 0,
            "ms": v["ms"],
            "kernel_ms": v["ms"],
            "plain_ms": v["plain_ms"],
            "bound_ms": v["bound"][0],
            "bound_by": v["bound"][1],
            "library_ms": v["library_ms"],
            "card": name,
            "power_limit": limit,
        })
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"end_to_end": e2e}))
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
