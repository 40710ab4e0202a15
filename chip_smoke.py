"""Smoke run of pilosa_tpu_torch on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):

1. Device: requires CUDA, prints the card's name and power limit, and
   builds the four CUDA kernels and the tensor-core rate probe from
   ``pilosa_tpu_torch/ops/csrc`` with nvcc, one process per source; logs
   each kernel's registers and the tensor-core MMA instructions in the
   grams' SASS (``cuobjdump -sass``), which must not be 0.
2. Kernels: each kernel against its plain PyTorch version on the card,
   with exact equality, at the serving shape (160 shards x 64 rows x
   32768 words; the cross gram against a second such stack, with a
   4-mask prefix against 64 rows (the narrow N tile, sides swapped), and
   with 256 masks in the k-level prefix layout; a 300-row self-gram of
   triangular tiles), at ragged shapes and on the chunked branches of the
   gram and the cross gram; then the kernel, the plain version and (for
   the grams) ``torch._int_mm`` on pre-unpacked int8 operands are timed
   with CUDA events around the wrapper, and each kernel's own device
   time is read from ``torch.profiler``. The probe times the card's
   single-bit and int8 MMA forms; the grams' operations bound uses the
   faster single-bit one, as no data sheet gives it. No kernel may time
   below its bound.
3. End to end: a seeded index at the repo's serving size (bench.py's
   160 shards x 64 rows at shard width 2^20, about 25 % dense; a second
   64-row field g and a 4-row field h) on ``Holder(device="cuda")``,
   served through ``Executor.execute`` and ``execute_batch`` in two
   paths, each with every launch count set to 0 just before it and read
   just after. The pair/TopN path: tanimoto TopN, a 1024-call batch of
   mixed pair Counts, writes, the same reads again; every answer equals
   numpy over the host mirrors. The GroupBy path: two-level GroupBy cold
   and warm, the reversed order, one field, a filter, three levels, one
   filtered level, a limit and ``previous`` pages (two and three levels,
   with and without a limit), before and after writes to all three
   fields; every answer equals one computed on the card with torch AND
   and popcount per combination, and a seeded sample of each equals
   numpy. Each query's launches and cache hits are asserted, and every
   kernel of a path must have been launched in it.
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
# rows of the third field h: the served index of bench.py:1553-1555 holds a
# 4-row field beside its 8-row one
H_ROWS = 4
BATCH = 1024
SEED = 20261017
# H100 SXM peaks (NVIDIA data sheet, dense): memory and int8 tensor cores;
# the single-bit rate is measured in the run (mma_rates)
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT8_OPS_PER_S = 1979e12
# rows of the self-gram of triangular tiles checked at the serving S and W
U_TRI = 300
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


def mma_rates(dev):
    """Multiply-adds per second of the card's tensor-core forms for a
    popcount dot product (``ops/csrc/mma_rate.cu``), timed here with CUDA
    events: single-bit AND+popc and int8, each as ``mma.sync`` and as
    ``wgmma``."""
    import ctypes

    import torch

    from pilosa_tpu_torch.ops import cuda_build

    lib = cuda_build.load()
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    rates = {}
    for kind, name, iters in ((0, "mma.sync.m16n8k256.b1.and.popc", 20000),
                              (1, "wgmma.m64n64k256.b1.and.popc", 4000),
                              (2, "mma.sync.m16n8k32.s8", 20000),
                              (3, "wgmma.m64n64k32.s8", 4000)):
        macs = ctypes.c_longlong(0)

        def probe():
            cuda_build.check(lib, "pilosa_mma_rate_probe", lib.pilosa_mma_rate_probe(
                kind, iters, sink.data_ptr(), torch.cuda.current_device(),
                torch.cuda.current_stream().cuda_stream, ctypes.byref(macs)))

        ms = cuda_ms(probe, reps=3)
        rates[name] = macs.value / (ms * 1e-3)
    return rates


def device_ms(fn, reps: int = 5):
    """Mean device milliseconds of the port's kernels in one call of ``fn``
    (``torch.profiler``; the CUDA-event times around the wrapper also hold
    its host work). None when the trace holds no kernel of the port.

    The trace may keep fewer kernel events than the wrappers launched (on
    the H100 it has dropped two of five), so the time is the mean over
    the events it kept, times the launches the wrappers counted per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pilosa_tpu_torch.ops import kernels as tk

    fn()
    torch.cuda.synchronize()
    launched0 = sum(tk.LAUNCHES.values())
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    launched = sum(tk.LAUNCHES.values()) - launched0
    ours = [e for e in prof.key_averages() if "pilosa_" in e.key]
    total = sum(e.device_time_total for e in ours)  # microseconds
    kept = sum(e.count for e in ours)
    if not total or not kept:
        return None
    if kept != launched:
        log(f"profiler kept {kept} of {launched} kernel events; device ms is "
            f"their mean times the launches per call")
    return total / kept * launched / reps / 1e3


def gram_sass_counts():
    """Tensor-core MMA instructions in the SASS of each gram kernel: the
    instantiations of ``pilosa_gram_tiles`` (SELF true: the gram, false:
    the cross gram), by tile."""
    import re

    from pilosa_tpu_torch.ops import cuda_build

    out = {"gram": {}, "cross_gram": {}}
    for fn, n in cuda_build.sass_mma_counts().items():
        m = re.search(r"pilosa_gram_tilesILi(\d+)ELi(\d+)ELb([01])E", fn)
        if m:
            out["gram" if m.group(3) == "1" else "cross_gram"][
                f"{m.group(1)}x{m.group(2)}"] = n
    for k, tiles in out.items():
        if not tiles or min(tiles.values()) == 0:
            raise AssertionError(f"{k}: no tensor-core MMA in the SASS of {tiles}")
    return out


def check_kernels(stack_np, stack2_np, filt_np, dev):
    import numpy as np
    import torch

    from pilosa_tpu_torch.ops import bitops, kernels as tk

    bits = bitops.to_device(stack_np, dev)
    bits2 = bitops.to_device(stack2_np, dev)
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
    # the cross gram of a two-field GroupBy: every row of one stack
    # against every row of another
    cross_plain = tk.cross_gram_gather_plain(bits, bits2, full_idx, full_idx)
    e_cross = exact("cross_gram", tk.cross_gram_gather(bits, bits2, full_idx, full_idx),
                    cross_plain)
    exact("cross_gram subsets", tk.cross_gram_gather(bits2, bits, sub_idx[::-1], full_idx[5:]),
          tk.cross_gram_gather_plain(bits2, bits, sub_idx[::-1], full_idx[5:]))
    log(f"kernels exact at the serving shape {tuple(bits.shape)} "
        f"(cross gram against a second stack {tuple(bits2.shape)})")

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
    # the cross gram: Ua = 5 rows against Ub = 100 (two B tiles) at S = 13,
    # W = 130, with operand A once as a stack and once as the transpose(0, 1)
    # view of a [C, S, W] prefix, read in place
    s, w = 13, 130
    a = bitops.to_device(random_words(rng, (s, 9, w), dense=True), dev)
    b = bitops.to_device(random_words(rng, (s, 150, w), dense=True), dev)
    ia = np.array([8, 0, 3, 3, 6])
    ib = rng.integers(0, 150, size=100)
    exact(f"cross_gram {s, w} Ua=5 Ub=100", tk.cross_gram_gather(a, b, ia, ib),
          tk.cross_gram_gather_plain(a, b, ia, ib))
    pre = bitops.to_device(random_words(rng, (5, s, w), dense=True), dev)
    exact("cross_gram prefix layout C=5",
          tk.cross_gram_gather(pre.transpose(0, 1), b, np.arange(5), ib),
          tk.cross_gram_gather_plain(pre.transpose(0, 1).contiguous(), b,
                                     np.arange(5), ib))
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
    # the same for cross_pair_gram
    tk._GRAM_ACC_LIMIT = chunk * W * 32
    try:
        before = tk.LAUNCHES["cross_gram"]
        chunked = tk.cross_pair_gram(bits, bits2, list(range(R)), list(range(R)))
        n_chunks = tk.LAUNCHES["cross_gram"] - before
    finally:
        tk._GRAM_ACC_LIMIT = saved
    if dev.type == "cuda" and n_chunks != -(-S // chunk):
        raise AssertionError(f"chunked cross gram: {n_chunks} launches")
    if not np.array_equal(chunked, cross_plain.cpu().numpy()):
        raise AssertionError("chunked cross_pair_gram differs from the plain cross gram")
    log(f"chunked cross gram exact ({n_chunks} shard chunks)")

    # the 3-level GroupBy's second level at the serving size: A = 256
    # prefix masks [C, S, W] read in place, B = a 64-row stack
    C2 = 4 * R
    prefix = tk.refine_prefix(tk.gather_prefix(bits, full_idx), bits2,
                              np.arange(C2) % R, (np.arange(C2) * 7) % R)
    level2 = lambda: tk.cross_gram_gather(prefix.transpose(0, 1), bits, np.arange(C2), full_idx)
    e_level2 = exact(f"cross_gram prefix layout C={C2}", level2(),
                     tk.cross_gram_gather_plain(prefix.transpose(0, 1), bits,
                                                np.arange(C2), full_idx))
    t_level2 = cuda_ms(level2, reps=5)
    d_level2 = device_ms(level2)
    del prefix
    torch.cuda.empty_cache()
    log(f"cross gram exact in the prefix layout at C = {C2} (the 3-level GroupBy's "
        "second level)")
    # its first level: 4 masks (the 4-row field h) against 64 rows, the
    # sides swapped so the masks fill one 8-wide N tile
    C1 = H_ROWS
    prefix1 = tk.gather_prefix(bits2, np.arange(C1))
    level1 = lambda: tk.cross_gram_gather(prefix1.transpose(0, 1), bits, np.arange(C1), full_idx)
    plan1 = tk.cross_gram_plan(C1, R, True)
    if (plan1.swap, plan1.tile_n) != (True, 8):
        raise AssertionError(f"Ua = {C1} plan {plan1}")
    e_level1 = exact(f"cross_gram prefix layout C={C1}", level1(),
                     tk.cross_gram_gather_plain(prefix1.transpose(0, 1), bits,
                                                np.arange(C1), full_idx))
    t_level1 = cuda_ms(level1, reps=10)
    d_level1 = device_ms(level1)
    del prefix1
    # a self-gram past one tile: upper-triangle 64 x 64 tiles, mirrored, on
    # unsorted rows of a U_TRI-row stack at the serving S and W
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    wide = torch.randint(-2**31, 2**31, (S, U_TRI, W), dtype=torch.int32, device=dev,
                         generator=gen)
    tri_idx = rng.permutation(U_TRI)
    if not tk.gram_plan(U_TRI, W, True).tri:
        raise AssertionError(f"U = {U_TRI} gram plan is not triangular")
    e_tri = exact(f"gram U={U_TRI} (triangular tiles)", tk.gram_gather(wide, tri_idx),
                  tk.gram_gather_plain(wide, tri_idx))
    t_tri = cuda_ms(lambda: tk.gram_gather(wide, tri_idx), reps=5)
    d_tri = device_ms(lambda: tk.gram_gather(wide, tri_idx), reps=3)
    del wide
    torch.cuda.empty_cache()
    log(f"cross gram exact at Ua = {C1} against Ub = {R} ({plan1}); gram exact at "
        f"U = {U_TRI} over triangular tiles")

    # -- timings at the serving shape
    t_scan = cuda_ms(lambda: tk.row_counts_per_shard(bits), reps=20)
    t_scan_p = cuda_ms(lambda: tk.row_counts_per_shard_plain(bits), reps=5)
    t_mask = cuda_ms(lambda: tk.masked_row_counts_per_shard(bits, filt), reps=20)
    t_mask_p = cuda_ms(lambda: tk.masked_row_counts_per_shard_plain(bits, filt), reps=5)
    t_gram = cuda_ms(lambda: tk.gram_gather(bits, full_idx), reps=10)
    t_gram_p = cuda_ms(lambda: tk.gram_gather_plain(bits, full_idx), reps=3)
    t_cross = cuda_ms(lambda: tk.cross_gram_gather(bits, bits2, full_idx, full_idx), reps=10)
    t_cross_p = cuda_ms(
        lambda: tk.cross_gram_gather_plain(bits, bits2, full_idx, full_idx), reps=3)
    d_scan = device_ms(lambda: tk.row_counts_per_shard(bits))
    d_mask = device_ms(lambda: tk.masked_row_counts_per_shard(bits, filt))
    d_gram = device_ms(lambda: tk.gram_gather(bits, full_idx))
    d_cross = device_ms(lambda: tk.cross_gram_gather(bits, bits2, full_idx, full_idx))
    # the library yardstick: one int8 x int8 -> int32 product over the
    # pre-unpacked operands [R, S*W*32] (unpacked per shard; unpack untimed)
    def unpacked(t):
        out = torch.empty((R, S * W * 32), dtype=torch.int8, device=dev)
        for s in range(S):
            out[:, s * W * 32:(s + 1) * W * 32] = tk.unpack_bits(t[s], torch.int8)
        return out

    a8, b8 = unpacked(bits), unpacked(bits2)
    exact("torch._int_mm yardstick", torch._int_mm(a8, a8.T), tk.gram_gather(bits, full_idx))
    exact("torch._int_mm cross yardstick", torch._int_mm(a8, b8.T), cross_plain)
    t_lib = cuda_ms(lambda: torch._int_mm(a8, a8.T), reps=10)
    t_lib_cross = cuda_ms(lambda: torch._int_mm(a8, b8.T), reps=5)
    del a8, b8
    torch.cuda.empty_cache()

    # the grams run single-bit MMA: their operations go at the faster of
    # the card's two single-bit forms, measured now (2 ops per bit-MAC)
    rates = mma_rates(dev)
    b1_ops_per_s = 2 * max(v for k, v in rates.items() if ".b1." in k)
    for k, v in rates.items():
        log(f"tensor cores, {k}: {v:.4e} multiply-adds/s (measured)")

    def bound(nbytes, nops, ops_per_s=PEAK_INT8_OPS_PER_S):
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = nops / ops_per_s * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    words = S * R * W
    # scans: every word read once, one AND/popc/add per word (counted as
    # 32 one-bit int8-equivalent multiply-adds, 2 ops each)
    b_scan = bound(words * 4 + S * R * 4, 2 * words * 32)
    b_mask = bound(words * 4 + S * W * 4 + S * R * 4, 2 * words * 32)
    # gram: G is symmetric, so the function needs only the R(R+1)/2
    # distinct dot products of length S*W*32 (2 ops per bit each)
    b_gram = bound(words * 4 + R * 4 + R * R * 4, R * (R + 1) * S * W * 32, b1_ops_per_s)
    b_tri = bound(S * U_TRI * W * 4 + U_TRI * 4 + U_TRI ** 2 * 4,
                  U_TRI * (U_TRI + 1) * S * W * 32, b1_ops_per_s)
    # cross gram: no symmetry, so all Ua * Ub dot products; both stacks
    # read once, both index arrays read and the output written once
    def b_cross_of(ua, ub):
        return bound((ua + ub) * S * W * 4 + (ua + ub) * 4 + ua * ub * 4,
                     2 * ua * ub * S * W * 32, b1_ops_per_s)

    b_cross, b_level1, b_level2 = b_cross_of(R, R), b_cross_of(C1, R), b_cross_of(C2, R)
    report = {
        "row_scan": dict(max_abs_err=e_scan, ms=t_scan, device_ms=d_scan,
                         plain_ms=t_scan_p, bound=b_scan, library_ms=None),
        "masked_row_scan": dict(max_abs_err=e_mask, ms=t_mask, device_ms=d_mask,
                                plain_ms=t_mask_p, bound=b_mask, library_ms=None),
        "gram": dict(max_abs_err=max(e_gram, e_tri), ms=t_gram, device_ms=d_gram,
                     plain_ms=t_gram_p, bound=b_gram, library_ms=t_lib,
                     extra={f"u{U_TRI}": (t_tri, d_tri, b_tri)}),
        "cross_gram": dict(max_abs_err=max(e_cross, e_level1, e_level2), ms=t_cross,
                           device_ms=d_cross, plain_ms=t_cross_p, bound=b_cross,
                           library_ms=t_lib_cross,
                           extra={"prefix_c4": (t_level1, d_level1, b_level1),
                                  "prefix_c256": (t_level2, d_level2, b_level2)}),
    }
    for k, v in report.items():
        log(f"{k}: kernel {v['ms']:.3f} ms (device {v['device_ms']}), "
            f"plain {v['plain_ms']:.3f} ms, "
            f"bound {v['bound'][0]:.3f} ms ({v['bound'][1]}), "
            f"library {v['library_ms'] if v['library_ms'] is None else round(v['library_ms'], 3)}")
    log("scans: no single PyTorch call computes a per-row popcount, "
        "so their library_ms is null")
    for k, v in report.items():
        for shape, (t, d, b) in v.get("extra", {}).items():
            log(f"{k} {shape}: kernel {t:.3f} ms (device {d}), bound {b[0]:.3f} ms ({b[1]})")
        for t, d, b in [(v["ms"], v["device_ms"], v["bound"]), *v.get("extra", {}).values()]:
            if min(t, d or t) < b[0]:
                raise AssertionError(f"{k}: {t} ms (device {d}) is below its bound "
                                     f"{b[0]} ms: the bound is wrong")
    report["mma_macs_per_s"] = rates
    del bits, bits2, filt
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


def build_index(device):
    """The served index: fields f and g of R_FULL rows and h of H_ROWS
    rows over S_FULL shards at shard width 2^20, each about 25 % dense,
    on ``Holder(device=device)``."""
    import numpy as np
    import torch

    from pilosa_tpu_torch import convert
    from pilosa_tpu_torch.shardwidth import SHARD_WORDS

    assert SHARD_WORDS == W_FULL, SHARD_WORDS
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    words = {
        "f": random_words(rng, (S_FULL, R_FULL, SHARD_WORDS), dense=True),
        "g": random_words(rng, (S_FULL, R_FULL, SHARD_WORDS), dense=True),
        "h": random_words(rng, (S_FULL, H_ROWS, SHARD_WORDS), dense=True),
    }
    schema = [{
        "name": "i",
        "options": {"keys": False, "trackExistence": True},
        "fields": [{"name": n, "options": {}} for n in words],
    }]
    fragments = {}
    for name, w in words.items():
        rows = list(range(w.shape[1]))
        for s in range(S_FULL):
            fragments[("i", name, "standard", s)] = (rows, w[s])
    holder = convert.holder_from_arrays(schema, fragments, device=device)
    setup_s = time.perf_counter() - t0
    log(f"index built: {S_FULL} shards x 2^20 columns; fields f, g of {R_FULL} "
        f"rows and h of {H_ROWS} rows, {words['f'].size * 32 / 1e9:.2f}e9 bits "
        f"in f, density {np.bitwise_count(words['f'][0]).mean() / 32:.3f}, "
        f"{setup_s:.1f} s")
    if holder.device.type != torch.device(device).type:
        raise AssertionError(f"holder on {holder.device}")
    return holder, setup_s


def apply_writes(ex, holder, qrng, fields, n):
    """``n`` seeded Set/Clear writes over ``fields`` in one execute, each
    field written at least once; checks that every write is visible."""
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    writes = []
    for k in range(n):
        # the first writes cover every field once
        fld = fields[k] if k < len(fields) else fields[int(qrng.integers(0, len(fields)))]
        writes.append((
            "Set" if qrng.random() < 0.6 else "Clear", fld,
            int(qrng.integers(0, H_ROWS if fld == "h" else R_FULL)),
            int(qrng.integers(0, S_FULL * SHARD_WIDTH)),
        ))
    t = time.perf_counter()
    changed = ex.execute(
        "i", " ".join(f"{op}({col}, {fld}={r})" for op, fld, r, col in writes)
    )
    write_ms = (time.perf_counter() - t) * 1e3
    last = {(fld, r, col): op for op, fld, r, col in writes}
    for (fld, r, col), op in last.items():
        if holder.field("i", fld).get_bit(r, col) != (op == "Set"):
            raise AssertionError(f"write not visible: {op}({col}, {fld}={r})")
    log(f"{len(writes)} Set/Clear writes to {'/'.join(dict.fromkeys(fields))} in one execute: "
        f"{write_ms:.1f} ms, {sum(bool(c) for c in changed)} changed a bit")
    return write_ms


def pair_topn_path(pool, ex, holder):
    """The pair-count and TopN path: tanimoto TopN, a 1024-call batch of
    mixed pair Counts and unfiltered TopN, before and after writes to f
    and g."""
    import numpy as np

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

    run_round("before_writes")
    results["writes_ms"] = apply_writes(ex, holder, qrng, ("f", "f", "f", "g"), 64)
    run_round("after_writes")
    return results


def truth_groupby(levels, filt=None):
    """Every non-empty combination of a GroupBy over the device stacks
    ``levels`` (``int32[S, R_l, W]``, row id = row index), in the
    reference's depth-first order, as ``[(row ids, count)]``: torch AND and
    ``bitops.popcount`` per combination of all levels but the last, which
    is counted for all its rows at once. No kernel of the port runs."""
    import itertools

    import torch

    from pilosa_tpu_torch.ops import bitops

    *heads, last = levels
    out = []
    for combo in itertools.product(*(range(h.shape[1]) for h in heads)):
        m = filt
        for h, r in zip(heads, combo):
            m = h[:, r] if m is None else m & h[:, r]
        counts = bitops.count_rows(last & m[:, None]).sum(dim=0, dtype=torch.int64)
        out.extend((combo + (r,), c) for r, c in enumerate(counts.tolist()) if c)
    return out


def check_numpy_sample(what, answer, np_levels, np_filt, pool, rng, k=256):
    """A seeded sample of ``k`` combinations of ``answer`` (all of them when
    there are fewer) recounted with numpy over the host mirrors."""
    import numpy as np

    pick = (range(len(answer)) if len(answer) <= k
            else rng.choice(len(answer), size=k, replace=False))
    items = [answer[int(i)] for i in pick]

    def one(item):
        combo, count = item
        m = np_levels[0][:, combo[0]]
        for lv, r in zip(np_levels[1:], combo[1:]):
            m = m & lv[:, r]
        if np_filt is not None:
            m = m & np_filt
        return int(np.bitwise_count(m).sum(dtype=np.int64)) == count

    bad = sum(not ok for ok in pool.map(one, items))
    if bad:
        raise AssertionError(f"{what}: {bad} of {len(items)} sampled counts differ from numpy")
    return len(items)


def groupby_path(pool, ex, holder, device):
    """Rows and GroupBy at the serving size, before and after writes to f,
    g and h: two fields cold and warm (the cross gram, then its cache),
    the reversed order (the same cache, transposed), one field (the gram),
    a filter and three levels (the k-level engine: one cross gram per level
    over prefix masks), one filtered level (the masked row scan), a limit
    and `previous` pages (cut from the same answers)."""
    import numpy as np
    import torch

    from pilosa_tpu_torch.ops import bitops, kernels as tk

    qrng = np.random.default_rng(SEED + 4)
    on_card = torch.device(device).type == "cuda"
    prev = (int(qrng.integers(R_FULL - 8, R_FULL - 1)), int(qrng.integers(0, R_FULL)))
    prev3 = (1, int(qrng.integers(0, R_FULL)), int(qrng.integers(0, R_FULL)))

    def paged(bound):
        return f"previous=[{', '.join(map(str, bound))}]"

    # name: (query, fields, filter row of h, `previous` bound, limit)
    queries = {
        "two_level": ("GroupBy(Rows(f), Rows(g))", ("f", "g"), None, None, None),
        "transposed": ("GroupBy(Rows(g), Rows(f))", ("g", "f"), None, None, None),
        "same_field": ("GroupBy(Rows(f), Rows(f))", ("f", "f"), None, None, None),
        "filtered": ("GroupBy(Rows(f), Rows(g), filter=Row(h=0))", ("f", "g"), 0, None,
                     None),
        "three_level": ("GroupBy(Rows(h), Rows(g), Rows(f))", ("h", "g", "f"), None, None,
                        None),
        "one_level_filtered": ("GroupBy(Rows(g), filter=Row(h=1))", ("g",), 1, None, None),
        "limit": ("GroupBy(Rows(f), Rows(g), limit=10)", ("f", "g"), None, None, 10),
        "previous_page": (f"GroupBy(Rows(f), Rows(g), {paged(prev)}, limit=10)",
                          ("f", "g"), None, prev, 10),
        "previous_rest": (f"GroupBy(Rows(f), Rows(g), {paged(prev)})", ("f", "g"), None,
                          prev, None),
        "three_level_previous": (f"GroupBy(Rows(h), Rows(g), Rows(f), {paged(prev3)})",
                                 ("h", "g", "f"), None, prev3, None),
    }
    results = {}

    def run_round(tag):
        np_stacks = {
            n: mirror_stack(holder, n, H_ROWS if n == "h" else R_FULL, S_FULL)
            for n in ("f", "g", "h")
        }
        dev_stacks = {n: bitops.to_device(w, torch.device(device))
                      for n, w in np_stacks.items()}
        lat, checked = {}, 0

        def serve(name, launches=None, *, label=None, want_hits=None):
            """Serve one query; ``launches`` maps a kernel to the launches
            the query must make (None: any number); kernels it does not
            name must make none."""
            q, fields, filt_row, bound, limit = queries[name]
            launches0, hits0 = dict(tk.LAUNCHES), ex.crossgram_cache_hits
            t = time.perf_counter()
            (res,) = ex.execute("i", q)
            lat[f"{label or name}_ms"] = (time.perf_counter() - t) * 1e3
            launched = {k: tk.LAUNCHES[k] - launches0[k] for k in tk.LAUNCHES}
            hits = ex.crossgram_cache_hits - hits0
            want = {k: (launches or {}).get(k, 0) for k in tk.LAUNCHES}
            want = {k: launched[k] if n is None else n for k, n in want.items()}
            if on_card and launched != want:
                raise AssertionError(f"{tag}: {q} launched {launched}, not {want}")
            if want_hits is not None and hits != want_hits:
                raise AssertionError(f"{tag}: {q} hit the cross-gram cache {hits} "
                                     f"times, not {want_hits}")
            for gc in res:
                if tuple(fr.field for fr in gc.group) != fields:
                    raise AssertionError(f"{tag}: {q} grouped {gc.group}")
            return q, fields, filt_row, bound, limit, [
                (tuple(fr.row_id for fr in gc.group), gc.count) for gc in res
            ]

        truths = {}

        def check(served_q):
            nonlocal checked
            q, fields, filt_row, bound, limit, got = served_q
            key = (fields, filt_row)
            if key not in truths:
                filt = None if filt_row is None else dev_stacks["h"][:, filt_row]
                truths[key] = truth_groupby([dev_stacks[n] for n in fields], filt)
            want = truths[key]
            if bound is not None:
                want = [it for it in want if it[0] > bound]
            if limit is not None:
                want = want[:limit]
            if not want:
                raise AssertionError(f"{tag}: {q}: empty answer checks nothing")
            if got != want:
                bad = sum(a != b for a, b in zip(got, want)) + abs(len(got) - len(want))
                raise AssertionError(f"{tag}: {q}: {bad} of {len(want)} groups differ "
                                     "from the truth on the card")
            np_filt = None if filt_row is None else np_stacks["h"][:, filt_row]
            checked += check_numpy_sample(f"{tag}: {q}", got,
                                          [np_stacks[n] for n in fields], np_filt, pool,
                                          np.random.default_rng(SEED + len(got)))
            return len(got)

        # two fields: the cold query computes the full cross gram (its rows
        # cover both fields); the warm one and the reversed order are cache
        # hits with no launch
        cross = {"cross_gram": 1}
        n_two = check(serve("two_level", cross, label="two_level_cold", want_hits=0))
        check(serve("two_level", label="two_level_warm", want_hits=1))
        check(serve("transposed", want_hits=1))
        # the gram: f's full gram is launched once per snapshot of f (the
        # pair path may have made it already)
        check(serve("same_field", {"gram": None}, want_hits=0))
        # the k-level engine on the card: one cross gram per level
        n_filt = check(serve("filtered", cross))
        n_three = check(serve("three_level", {"cross_gram": 2}))
        check(serve("one_level_filtered", {"masked_row_scan": 1}))
        # pages are cut from the answer: the cross-gram slot, or the
        # k-level engine again
        check(serve("limit", want_hits=1))
        check(serve("previous_page", want_hits=1))
        check(serve("previous_rest", want_hits=1))
        check(serve("three_level_previous", {"cross_gram": 2}))
        del dev_stacks
        if on_card:
            torch.cuda.empty_cache()
        results[tag] = lat
        log(f"{tag}: GroupBy answers equal the truth on the card ({n_two} two-level, "
            f"{n_filt} filtered, {n_three} three-level groups) and {checked} sampled "
            "combinations equal numpy; " + ", ".join(f"{k} {v:.1f}" for k, v in lat.items()))

    run_round("before_writes")
    results["writes_ms"] = apply_writes(ex, holder, qrng, ("f", "g", "h"), 64)
    run_round("after_writes")
    return results


def drive(path, required, fn):
    """Run one path of the main path with every launch count set to 0 just
    before it; fail if a kernel of the path was not launched in it."""
    from pilosa_tpu_torch.ops import kernels as tk

    tk.reset_launches()
    out = fn()
    launches = dict(tk.LAUNCHES)
    log(f"{path}: launches {launches}")
    for k in required:
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched on the {path} path")
    return launches, out


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
    sass = gram_sass_counts()
    for k, tiles in sass.items():
        log(f"{k}: tensor-core MMA instructions in SASS by tile {tiles}")

    rng = np.random.default_rng(SEED + 3)
    stack = random_words(rng, (S_FULL, R_FULL, W_FULL), dense=True)
    stack2 = random_words(rng, (S_FULL, R_FULL, W_FULL), dense=True)
    filt = random_words(rng, (S_FULL, W_FULL), dense=False)
    kern = check_kernels(stack, stack2, filt, torch.device("cuda"))
    del stack, stack2, filt

    from pilosa_tpu_torch.exec.executor import Executor

    holder, setup_s = build_index("cuda")
    ex = Executor(holder)
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        l_pair, e2e = drive("pair_topn", ("row_scan", "masked_row_scan", "gram"),
                            lambda: pair_topn_path(pool, ex, holder))
        l_group, e2e["groupby"] = drive("groupby", ("gram", "cross_gram", "masked_row_scan"),
                                        lambda: groupby_path(pool, ex, holder, "cuda"))
    e2e["setup_s"] = setup_s
    e2e["stack_rebuilds"] = ex.stack_rebuilds
    e2e["crossgram_cache_hits"] = ex.crossgram_cache_hits
    by_path = {k: {"pair_topn": l_pair[k], "groupby": l_group[k]} for k in l_pair}

    sources = {
        "row_scan": ("pilosa_tpu_torch/ops/csrc/row_scan.cu",
                     "pilosa_tpu/ops/kernels.py:1537 _row_scan_kernel"),
        "masked_row_scan": ("pilosa_tpu_torch/ops/csrc/masked_row_scan.cu",
                            "pilosa_tpu/ops/kernels.py:1730 _masked_row_scan_kernel"),
        "gram": ("pilosa_tpu_torch/ops/csrc/gram.cu",
                 "pilosa_tpu/ops/kernels.py:651 _gram_pallas_kernel"),
        "cross_gram": ("pilosa_tpu_torch/ops/csrc/cross_gram.cu",
                       "pilosa_tpu/ops/kernels.py:1265 _cross_gram_pallas_kernel"),
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
            "launches": sum(by_path[k].values()),
            "launches_by_path": by_path[k],
            "max_abs_err": v["max_abs_err"],
            "match": v["max_abs_err"] == 0,
            "ms": v["ms"],
            "kernel_ms": v["ms"],
            "device_ms": v["device_ms"],
            "plain_ms": v["plain_ms"],
            "bound_ms": v["bound"][0],
            "bound_by": v["bound"][1],
            "library_ms": v["library_ms"],
            "sass_mma": sum(sass.get(k, {}).values()),
            "card": name,
            "power_limit": limit,
        })
        if k in sass:
            entries[-1].update(
                sass_mma_by_tile=sass[k],
                bound_ops_rate="single-bit MMA, measured in this run",
                mma_macs_per_s=kern["mma_macs_per_s"],
            )
        for shape, (t, d, b) in v.get("extra", {}).items():
            entries[-1].update({f"{shape}_ms": t, f"{shape}_device_ms": d,
                                f"{shape}_bound_ms": b[0], f"{shape}_bound_by": b[1]})
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
