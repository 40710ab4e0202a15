"""Smoke run of pilosa_tpu_torch on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

``--resize`` adds the cluster path's steps 8-9 (a node added and one
removed online under load), which take 2-5 minutes more than the run's
time limit leaves room for.

Phases (any failure raises, and the script exits non-zero):

1. Device: requires CUDA, prints the card's name and power limit, and
   builds the six CUDA kernel sources (nine kernels: the tree source holds
   two, the BSI source three) and the tensor-core rate probe from
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
   faster single-bit one, as no data sheet gives it. The tree kernels
   (``tree_count``, ``tree_words``) likewise, at the serving shape (stacks
   of 64, 64, 4 and 1 rows; 64 items of three shapes, the count on its
   staged route) and at ragged ones (W = 130, S = 3, a 0-row stack, absent
   rows, a program at the operand-stack limit, one item, programs longer
   than the kernel stages in shared memory and a tree nested 40 deep; on
   the staged route W = 260 and 132, one item, one tensor as two
   stacks, tiles, items that share no rows, each flat fold and the general
   step loop), timed at the trees path's 1024 items (staged) and on the
   direct route at one item of 300 leaves, one lone three-leaf Intersect
   and 64 items of a nested tree of three operand-stack entries, each shape
   also at slices of 4-64 chunks, with each launch's route, plan and floors
   logged and BMMA counted in the staged kernel's SASS.
   The BSI kernels (``bsi_range``, ``bsi_sum``, ``bsi_extreme``) likewise
   at the serving shape of an int field (160 shards x 22 rows x 32768
   words: depth 20, signed values in three quarters of the columns): the
   range scan in both modes at the main path's flights (Q = 1, 3, 12
   words, 128 counts), the sum under 0, 1, 12 and 64 filters, the extreme
   both ways, filtered and not, and at ragged shapes (one shard, W off
   each kernel's chunk, depths 0, 1 and 63, Q across the query tile, an
   empty exists row); timed at the main path's shapes beside their bounds,
   and at each kernel's head shape beside its plain version (the sum also
   beside ``torch._int_mm`` on pre-unpacked int8 operands).
   No kernel may time below its bound.
3. End to end: a seeded index at the repo's serving size (bench.py's
   160 shards x 64 rows at shard width 2^20, about 25 % dense; a second
   64-row field g, a 4-row field h and the existence field) on
   ``Holder(device="cuda")``, served through ``Executor.execute`` and
   ``execute_batch`` in eight paths and over HTTP in a ninth, each with
   every launch count set to 0
   just before it and read
   just after. The pair/TopN path: tanimoto TopN, a 1024-call batch of
   mixed pair Counts, writes, the same reads again; every answer equals
   numpy over the host mirrors. The GroupBy path: two-level GroupBy cold
   and warm, the reversed order, one field, a filter, three levels, one
   filtered level, a limit and ``previous`` pages (two and three levels,
   with and without a limit), before and after writes to all three
   fields; every answer equals one computed on the card with torch AND
   and popcount per combination, and a seeded sample of each equals
   numpy. Each query's launches and cache hits are asserted. The trees
   path: a 1024-call batch of four Count tree shapes (one tree_count
   launch per shape) through ``execute_batch`` and ``execute``, every
   answer against the plain tree count on the card and a seeded sample
   against numpy, a Count of a Union of 300 rows and a lone Count of a
   three-leaf Intersect (one launch each; numpy), and three bitmap trees
   (one tree_words launch each),
   before and after writes to all three fields; then one Set to one shard
   of f and a cold tanimoto TopN (the stack patched in place of a rebuild,
   ``stack_incremental``), and a Set that creates a row (a rebuild). Every
   kernel of a path must have been launched in it. The bsi path, over int
   fields v (0..1,000,000) and w (-1,000,000..1,000,000) of the same
   index: a lone range Count cold on the host until the warm-up builds
   the stack, then one launch, then the cache; a `><` bitmap; 128 range
   Counts in one launch; Sum (cached on repeat), filtered, and a batch of
   64 filtered Sums (one launch each); Min/Max unfiltered and filtered;
   MinRow/MaxRow; a GroupBy filtered by a condition; then writes to v and
   w, seen by the next Range, Sum and Min/Max. Every answer equals numpy
   on the values decoded from the host mirrors. The mesh path, after it
   (``mesh_path``): (a) ``configure_serving(devices=[cuda:0] * 4)`` and a
   new executor over the served holder, its stacks four slices of 40
   shards, beside a new single-device executor: a filtered, a tanimoto and
   a plain TopN, 64 pair Counts, GroupBy f x g, a three-level GroupBy
   filtered by a row of h, two three-way Intersect Counts, a Union bitmap,
   two range Counts, Sum, Min and Max of v on both, each answer equal
   between them and to the host mirrors' truth and each kernel launched
   four times as often on the mesh; the stack build and a warm batch
   timed on both; 64 writes to f, g and h and 4 to v, and the reads again;
   then ``configure_serving(None)`` and no serving mesh; (b) two processes
   on the card over gloo (``pilosa_tpu_torch/testing/multihost.py``, each
   rank the 80 shards it owns at 64 rows x 32768 words): the executor's
   reads reduced across the ranks, and the spanning reads of one stack
   over both ranks' slices (``pair_gram``, ``row_counts``,
   ``cross_pair_gram``, ``pair_count_batched``, ``pair_count_two_batched``,
   ``masked_row_counts``, ``run_count_batch``, the chunked grams), each
   against the seed's truth; (c) ``init_multihost`` with its default
   backend in a job of one rank: NCCL on the card, not spanning. NCCL
   across cards needs two of them and is not run. The budget path, last:
   the reads below on the paths' executor with no cap (the reference
   answers); then on a fresh executor the process device-memory budget's
   cap below f's, g's and v's stacks together: pair batches on f and g, a
   GroupBy f x g and range Counts on v and w, stacks evicting each other,
   and a shrink of the cap that must free on the card the bytes it
   evicts; then the cap below one
   BSI stack, so the stacks of f, g, v and w are declined: a lone pair
   Count (the native host tier), 64 pair Counts, a filtered TopN (the
   masked row scan per fragment), GroupBys with a limit, `previous` and a
   filter (the recursive path), a tree Count, and a range Count, a `><`
   bitmap, Sum, Min and Max on v (the BSI kernels once per fragment).
   Every answer equals its truth from the host mirrors; after every query
   the budget holds no more than its cap (unless all is pinned) and the
   card no more than the budget counts. Last, the host tier alone: a lone
   cold pair Count over 160 shards native against numpy, and
   ``Fragment.import_bits`` of 2^20 pairs native against numpy. The
   storage path, after it: f, h, v and the existence field, copied from
   the mirrors, written by a fresh holder bound to a ``HolderStore`` on a
   new directory under ``build/`` (every fragment snapshotted), served
   (the pre-close answers), closed and opened again by a second holder
   (the ``open`` timed alone); a 1024-call pair batch, a tanimoto TopN, a
   TopN filtered by a row, GroupBy f x h, a tree Count, a range Count and
   a Sum on v, cold and warm, each equal to the pre-close answer and to
   numpy over the written data, the cold reads' kernels asserted; three
   files decoded and encoded by the native codec and the plain Python
   one, all equal; 64 writes to f and v, closed without a snapshot and
   reopened (the op logs replayed, the next reads see them); an index of
   2^20 column keys and a keyed field of 64 row keys served by key (pair
   Counts, a filtered TopN, a GroupBy, a Row with its column keys), a Set
   with a new key, and after the reopen the same ids and answers.
   The time path, last, on a fresh executor: a time field t of quantum
   YMDH and 8 rows on the served index, loaded through
   ``Field.import_bits`` with a timestamp a bit (a bit in a quarter of the
   columns, over 30 hours: 35 views); windows whose covers are one D view,
   one M view, a D view and 3 H views, 16 H views, 17 H views (the host,
   as in JAX) and none, each window's first Count (its views' stacks
   built) and warm; a 1024-call batch of windowed Counts and Intersects
   with rows of f (one tree_count launch per shape and window), windowed
   bitmaps (tree_words), TopN of f filtered by a window (the scans), a
   GroupBy f x h filtered by a window (the cross gram), Rows with from/to
   and pair Counts over t's standard view (the gram); 64 timestamped Sets
   seen by the next batch through the per-view patch, a Clear from every
   view, Store, SetRowAttrs with TopN by attribute and Options; then t
   deleted, its stacks' bytes leaving the card and the budget, and a new t
   answering from its own data. Every answer equals numpy over the
   generated bits. The http path, last (the served index released
   first): ``NodeServer`` on the storage path's directory (kept for it
   and removed at the end of the script), booted and timed to its first
   answer; over HTTP, cold and warm, each beside the same query
   in-process: the 1024-call pair body, a tree Count, a selective 8-row
   Intersect bitmap (tree_words), the tanimoto and filtered TopNs,
   GroupBy f x h, a range Count, Sum, Min and Max on v and a keyed TopN,
   every answer equal to numpy over the written data; 16 client threads
   on keep-alive connections for 5 s (queries/s, p50/p99, every answer
   equal to its serial one); import-roaring of a new 64-row field on 8
   shards (MB/s, bits/s), a JSON import of 2^19 timestamped pairs into a
   YMDH field read back through windowed Counts (pairs/s), values into an
   int field, /export of one shard of h; /debug/vars' kernels block
   against ``LAUNCHES``, /metrics parsed, /debug/fragments over f's 160
   fragments, a field's DELETE freeing its stack on the card and in the
   budget; then ``python -m pilosa_tpu_torch.cli server`` on the
   directory: /status, a pair batch against numpy with its launch in
   /debug/vars, SIGTERM and exit 0. The http path's node runs with the
   serving plane cut down (``batch_window=0, rescache_entries=0,
   planner_enabled=False``), so its numbers stay comparable; its CLI node
   runs at the defaults. The serving path, last: ``NodeServer`` at JAX's defaults on
   the same directory (the batcher, the result cache, the planner, the QoS
   governor, the prefetcher and the ingest pipeline on): the http path's
   25-query read mix from 16 keep-alive clients for 10 s with the result
   cache emptied, through the batcher and then with it off (queries/s,
   p50/p99, flights, flight sizes and window-close reasons, launches per
   query by kernel, the device's idle share from ``torch.profiler``'s
   kernel intervals and the ledger's ms per launch beside the
   profiler's), then the defaults whole for 4 s; the mix repeated from
   the cache with no launch, a write to f that drops exactly the entries
   reading f (the next answers equal numpy after it), SetRowAttrs and a
   TopN by attribute; a flight of 64 queries sharing one Intersect (the
   planner's CSE counters); flights that evict each other's stacks under
   a cap (the prefetcher's issued and useful counts); import-roaring of a
   64-row field on 8 shards through the pipeline from 4 clients (MB/s,
   uploads, overlap, no failed upload, read back exactly), then again
   beside the prefetch phase's steps (their p50/p99 and prefetches beside
   the same steps alone); and two tenants
   by header, one sending 300-leaf Counts and GroupBys, one lone Counts
   (``/debug/qos``; each tenant's debt equals its device ms in the ledger).
   The obs path, last: ``NodeServer`` on the same directory with every
   observability plane on at JAX's defaults (the flight recorder, the
   metrics history, the black box, the runtime monitor), and one SLO
   objective for a probe tenant set through the node's knobs: the
   25-query mix from 16 keep-alive clients with the result cache emptied,
   one load while the planes' threads run and stop in turn (4 pairs of
   1.25 s windows: each window's queries/s, p50/p99 and idle share, the
   median of the pairs' differences, and the planes' own seconds per
   second from their counters), the flight recorder's top collapsed
   stacks of the on windows for the dispatcher and the handler threads, the
   history's ``dev.device_ms_ps`` integral against the ledger's device ms
   and its ``slo.*.rps`` sum against the requests served; a burst of
   reads under a tiny deadline (one ``deadline-504-spike`` incident whose
   segments show launches), the probe's errors (one burn-edge incident)
   and two tenants (the QoS ladder's incident in the flight recorder);
   then the same load on a node with the planes off. Beside the checks
   after the windows, the incidents and that node's boot, ``python -m pilosa_tpu_torch.cli server`` over a
   small new data directory,
   SIGKILLed and started again (the postmortem line; one bundle with
   ``crashLoop`` 1 holding the first life's launches), stopped by SIGTERM
   and booted clean, then sent SIGSEGV (``last-words.txt`` holds every
   thread's stack), each boot timed to its first answer. The cluster
   path, last: three nodes of the port in one process on the card
   (``replica_n=2``, every plane at JAX's defaults, each on a data
   directory of its own under ``build/``), joined by ``join_static``; the
   storage path's schema created through node 0 and broadcast; each of
   the 160 shards of f, h and v loaded on its two owners through their
   roaring imports, as the storage directory holds them (g of the served
   index left out, and the cut printed; w drawn from the seed); a JSON
   import through node
   0 routed to the owners and read back word for word on both replicas;
   the read mix (less its keyed read, plus GroupBy f x h and f x f) from
   16 keep-alive clients with every result cache emptied, on the mesh
   route (one launch over a holder facade; again with the three nodes'
   samplers stopped) and on the HTTP fan-out: queries/s, p50/p99, idle share, launches per query
   by kernel, mesh dispatches, HTTP sub-requests per query,
   ``mesh_fallbacks`` (0) and the three nodes' planes' own seconds per
   second; a Set through node 1 read through node 0 on both routes and on
   both replicas; keys written through a node that is not the primary and
   read through a third; TopN exactness; node 2 stopped, every read exact
   through the replicas (p99), its breaker open in /debug/vars and in a
   flight-recorder segment, and ``?cluster=true`` events of all three
   nodes before the stop; then membership and anti-entropy (steps 6-7,
   step 7 over f, h and v, w deleted first), and with ``--resize`` a node
   added and one removed (steps 8-9; every node's id is fixed from the
   seed, so each resize moves the same shards from run to run). The loadgen path, last (the earlier
   paths' directories removed first): the load harness's workload index
   at the serving size (seg 160 shards x 64 rows, val, the YMD field ev)
   written to a new directory, one ``NodeServer`` on it, and
   ``LoadHarness`` driving its eight-stage plan with 16 workers over HTTP
   (the report validated, its fingerprint the generator's, no client
   error, every stage but overload at the availability floor, overload
   failing only with 429s); the answers after the run against numpy over
   the node's mirrors; then ``python -m pilosa_tpu_torch.cli`` backup,
   restore into a second node, check, inspect and config, each timed.
4. Summary: one ``{"end_to_end": {...}}`` line, one ``{"kernels": [...]}``
   line, the card line, and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import threading
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


T_START = time.perf_counter()


def log(msg: str) -> None:
    """One line of the run's log, after the seconds since the script
    started."""
    print(f"[{time.perf_counter() - T_START:6.1f} s] {msg}", flush=True)


def sm_clock_hz():
    """The card's highest SM clock in Hz, from nvidia-smi; None when it
    does not say."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    )
    try:
        return float(out.stdout.strip().splitlines()[0]) * 1e6
    except (IndexError, ValueError):
        return None


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


_L2_SCRUB = []


def scrub_l2() -> None:
    """Write over the card's L2 cache (a buffer of twice its size), so the
    next timed call reads its inputs from memory, as its byte bound
    assumes: a call timed right after one that read the same tensors finds
    part of them in L2 and can beat that bound."""
    import torch

    if not _L2_SCRUB:
        l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size", 0) or 50 << 20
        _L2_SCRUB.append(torch.empty(2 * l2, dtype=torch.uint8, device="cuda"))
    _L2_SCRUB[0].fill_(1)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` on the card, from CUDA events, the L2
    cache written over before each timed call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        scrub_l2()
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


def per_call_device_us(events, launched: int, reps: int):
    """Device microseconds of one call, from the trace's kernel events of
    ``reps`` calls: ``(name, start_us, duration_us)`` each. None when no
    event is left.

    An event seen twice (same kernel, same start) counts once, and one of
    no duration (no kernel of the port takes none) not at all. When the
    trace kept one event per launch, the events split into the ``reps``
    calls in start order and the time is the median call's sum. Otherwise
    (the trace has dropped two of five on the H100) it is the mean over
    the events kept, times the launches the wrappers counted per call.
    Returns ``(us, note)``; ``note`` says what was set aside, or is
    empty."""
    seen, kept, dup, empty = set(), [], 0, 0
    for name, start, dur in events:
        if (name, start) in seen:
            dup += 1
        elif dur <= 0:
            empty += 1
        else:
            seen.add((name, start))
            kept.append((start, dur))
    note = []
    if dup or empty:
        note.append(f"the trace held {len(events)} kernel events of the port for "
                    f"{launched} launches: {dup} seen twice and {empty} of no "
                    f"duration set aside")
    if not kept:
        return None, "; ".join(note)
    kept.sort()
    per_call = len(kept) // reps
    if len(kept) == launched and per_call * reps == launched:
        sums = [sum(d for _, d in kept[i * per_call:(i + 1) * per_call])
                for i in range(reps)]
        return statistics.median(sums), "; ".join(note)
    note.append(f"the trace kept {len(kept)} of {launched} kernel events; device "
                f"ms is their mean times the launches per call")
    return sum(d for _, d in kept) / len(kept) * launched / reps, "; ".join(note)


def device_ms(fn, reps: int = 5, traces: int = 3):
    """Device milliseconds of the port's kernels in one call of ``fn``
    (``torch.profiler``; the CUDA-event times around the wrapper also hold
    its host work): the median of ``traces`` traces of ``reps`` calls each,
    each read by :func:`per_call_device_us` from its kernel events. None
    when no trace holds a kernel of the port. The L2 cache is written over
    before each call (:func:`scrub_l2`; its fill is not a kernel of the
    port).

    Now and then (about one trace in a hundred) the H100's trace reads a
    kernel at about half its time, faster than its bytes can leave memory (the unfiltered ``bsi_extreme``
    at 0.104-0.110 ms where every other trace, and CUDA events around the
    same calls queued behind a sleep kernel, read 0.217-0.229 ms), so no
    single trace is taken alone."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pilosa_tpu_torch.ops import kernels as tk

    fn()
    torch.cuda.synchronize()
    readings = []
    for _ in range(traces):
        launched0 = sum(tk.LAUNCHES.values())
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                scrub_l2()
                fn()
            torch.cuda.synchronize()
        launched = sum(tk.LAUNCHES.values()) - launched0
        events = [(e.name, e.time_range.start, e.time_range.elapsed_us())
                  for e in prof.events()
                  if "pilosa_" in e.name and e.device_type != DeviceType.CPU]
        us, note = per_call_device_us(events, launched, reps)
        if note:
            log(note)
        if us is not None:
            readings.append(us / 1e3)
    if not readings:
        return None
    ms = statistics.median(readings)
    if max(readings) > 1.1 * min(readings):
        log(f"device ms of {len(readings)} traces {readings}: the median {ms} is kept")
    return ms


def gram_sass_counts(counts):
    """Tensor-core MMA instructions in the SASS of each gram kernel: the
    instantiations of ``pilosa_gram_tiles`` (SELF true: the gram, false:
    the cross gram), by tile, from ``cuda_build.sass_mma_counts``."""
    import re

    out = {"gram": {}, "cross_gram": {}}
    for fn, n in counts.items():
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
    t_gram_p = cuda_ms(lambda: tk.gram_gather_plain(bits, full_idx), reps=2, warmup=1)
    t_cross = cuda_ms(lambda: tk.cross_gram_gather(bits, bits2, full_idx, full_idx), reps=10)
    t_cross_p = cuda_ms(
        lambda: tk.cross_gram_gather_plain(bits, bits2, full_idx, full_idx), reps=2, warmup=1)
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
    # each product's exact check is its warm-up, then one timed call
    exact("torch._int_mm yardstick", torch._int_mm(a8, a8.T), tk.gram_gather(bits, full_idx))
    exact("torch._int_mm cross yardstick", torch._int_mm(a8, b8.T), cross_plain)
    t_lib = cuda_ms(lambda: torch._int_mm(a8, a8.T), reps=1, warmup=0)
    t_lib_cross = cuda_ms(lambda: torch._int_mm(a8, b8.T), reps=1, warmup=0)
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


# the tree kernels' shapes on the trees path (exec/astbatch.py signatures over
# the stacks named beside them; "e" is the existence field's one row)
TREE_SIGS = {
    "and3": (("intersect", ("row", 0), ("row", 1), ("row", 2)), ("f", "g", "h")),
    "union_of_pairs": (("union", ("intersect", ("row", 0), ("row", 1)),
                        ("difference", ("row", 0), ("row", 1))), ("f", "g")),
    "not": (("difference", ("row", 0), ("row", 1)), ("e", "f")),
    "xor3": (("xor", ("row", 0), ("row", 0), ("row", 0)), ("f",)),
}


def tree_balanced(levels, k=0):
    """A full binary tree of 2**levels leaves over stacks 0-2 in turn,
    operators alternating by level."""
    if levels == 0:
        return ("row", k % 3)
    return (("difference", "union", "xor", "intersect")[levels % 4],
            tree_balanced(levels - 1, 2 * k), tree_balanced(levels - 1, 2 * k + 1))


def direct_tree_shapes(rng, stacks):
    """The tree count's direct-route shapes over stacks f, g and h: ``[(name,
    program, slots)]`` for one item of 300 leaves (seeded rows), the trees
    path's Count of a Union of 300 rows (each stack's rows in turn), a lone
    three-leaf Intersect (a lone Count) and 64 items of a nested tree of
    three operand-stack entries."""
    import numpy as np

    from pilosa_tpu_torch.exec import astbatch

    wide = astbatch.program(("union",) + tuple(("row", k % 3) for k in range(WIDE_LEAVES)))
    rows = np.array([stacks[k].shape[1] for k in wide.leaf_stack])
    and3 = astbatch.program(TREE_SIGS["and3"][0])
    nested = astbatch.program(tree_balanced(3))
    return [("wide300", wide, tree_slots(rng, wide, stacks, 1)),
            ("wide300_path", wide, ((np.arange(WIDE_LEAVES) // 3) % rows).astype(np.int32)[None]),
            ("lone3", and3, tree_slots(rng, and3, stacks, 1)),
            ("nested64", nested, tree_slots(rng, nested, stacks, 64))]


def tree_slots(rng, prog, stacks, B, absent=0.0):
    """int32 [B, L] seeded leaf rows of ``prog`` over ``stacks``; a share
    ``absent`` of them, and every leaf of a 0-row stack, absent (-1)."""
    import numpy as np

    rows = np.array([stacks[k].shape[1] for k in prog.leaf_stack])
    slots = (rng.random((B, prog.n_leaves)) * rows).astype(np.int32)
    if absent:
        slots[rng.random(slots.shape) < absent] = -1
    slots[:, rows == 0] = -1
    return slots


# __popc per clock per SM of compute capability 9.0 (the CUDA C++
# Programming Guide's table of arithmetic instruction throughput), and the
# bytes an SM's shared memory gives per clock
POPC_PER_CLOCK_PER_SM = 16
SMEM_BYTES_PER_CLOCK_PER_SM = 128
# bit multiply-adds of one mma.sync.m16n8k256 (BMMA)
BMMA_BIT_MACS = 16 * 8 * 256


def tree_bound(prog, stacks, slots, words=False):
    """((ms, by), bytes, nominal bytes) of a tree launch over ``slots``
    (``[B, L]``; ``[L]`` for the words). The bound is the least time of any
    route on the card: the distinct rows it names read once and its output
    (counts, or words) written once, against its folds and popcounts priced
    on the tensor cores as the scans price theirs (32 one-bit
    int8-equivalent multiply-adds per word, 2 ops each). The nominal bytes
    are every leaf of every item read from memory. Each route has higher
    floors of its own: see tree_floors."""
    S, _, W = stacks[0].shape
    slots = slots.reshape(-1, prog.n_leaves)
    B, L = slots.shape
    rows = {(int(prog.leaf_stack[l]), int(r)) for l in range(L) for r in set(slots[:, l].tolist())
            if r >= 0}
    # several stacks may be one tensor: count a row of it once
    rows = {(stacks[p].data_ptr(), r) for p, r in rows}
    out_bytes = S * W * 4 if words else B * S * 4
    nbytes = len(rows) * S * W * 4 + out_bytes
    folds = max(1, int((prog.code < 0).sum()))
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 2 * 32 * S * W * B * folds / PEAK_INT8_OPS_PER_S * 1e3
    bound = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return bound, nbytes, B * L * S * W * 4


def tree_floors(prog, stacks, slots, rates):
    """The route ``tree_count`` takes over ``slots``, its plan, and the
    floors of that route in ms (None where nvidia-smi gives no clock or no
    rate was measured), for the log. Staged: the shared-memory reads, from
    the staged table the wrapper uploads (a leaf step of a group loads one
    512-byte warp row per item, or one for the group where the table marks
    its slot TREE_UNIFORM), at SMEM_BYTES_PER_CLOCK_PER_SM; and its
    popcounts (one BMMA per item, padding included, and chunk, at the
    measured mma.sync rate). Direct: the bytes it reads (the rows instance
    each item's distinct rows once, through L2 every present leaf) and
    writes at PEAK_BYTES_PER_S; the rows instance's shared-memory traffic
    (the rows copied in, and one 16-byte read per lane and step, a general
    program's steps padded to whole fours) at SMEM_BYTES_PER_CLOCK_PER_SM;
    and one __popc per item, shard and word at POPC_PER_CLOCK_PER_SM."""
    import numpy as np
    import torch

    from pilosa_tpu_torch.ops import kernels as tk

    launch = tk.tree_count_launch(stacks, prog.code, prog.leaf_stack, slots)
    plan = launch.plan
    S, _, W = stacks[0].shape
    B, L = slots.shape
    clock = sm_clock_hz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chunks = -(-W // tk.TREE_CHUNK_WORDS)
    out = {"route": plan.route, "plan": plan._asdict(), "smem_floor_ms": None,
           "popc_floor_ms": None}
    if plan.route == "staged":
        lay = tk.tree_staged_layout(stacks, launch.rows, launch.remap, launch.program.steps,
                                    plan)
        leaves = [st >> 5 for st in lay.steps.tolist() if st & 3 != tk.TREE_POP_FOLD]
        loads = 0
        # the table's slot blocks, one a tile, follow its row pointers, row
        # words, tile heads and steps
        for block in lay.parts[4 : 4 + lay.tiles]:
            # each group's first slot of each leaf step: one load if uniform
            first = block.reshape(L, -1, tk.TREE_GROUP)[leaves, :, 0]
            loads += int(np.where(first & tk.TREE_UNIFORM, 1, tk.TREE_GROUP).sum())
        out.update(leaf_loads_per_item=loads / B, popc_by="BMMA at the measured mma.sync rate")
        if clock:
            out["smem_floor_ms"] = (loads * S * chunks * tk.TREE_CHUNK_WORDS * 4
                                    / (SMEM_BYTES_PER_CLOCK_PER_SM * sms * clock) * 1e3)
        rate = (rates or {}).get("mma.sync.m16n8k256.b1.and.popc")
        if rate:
            out["popc_floor_ms"] = (lay.n_items * S * chunks
                                    / (rate / BMMA_BIT_MACS) * 1e3)
    else:
        rows = int(launch.items.offsets[-1]) if plan.stages else int((slots >= 0).sum())
        row_bytes = rows * S * W * 4
        out.update(instance="rows" if plan.stages else "through L2", rows_per_item=rows / B,
                   bytes_floor_ms=(row_bytes + B * S * 4) / PEAK_BYTES_PER_S * 1e3,
                   popc_by="__popc at 16 per clock per SM")
        if clock:
            out["popc_floor_ms"] = B * S * W / (POPC_PER_CLOCK_PER_SM * sms * clock) * 1e3
        if clock and plan.stages:
            n = launch.program.steps.size
            loads = n if plan.flat >= 0 else -(-n // 4) * 4
            out["smem_floor_ms"] = ((B * S * W * 4 * loads + row_bytes)
                                    / (SMEM_BYTES_PER_CLOCK_PER_SM * sms * clock) * 1e3)
    return out


def tree_sass_counts(counts):
    """BMMA instructions in the SASS of each instance of the staged tree
    count (``pilosa_tree_count_staged``), from
    ``cuda_build.sass_mma_counts``; fails when one has none."""
    out = {fn: n for fn, n in counts.items() if "pilosa_tree_count_staged" in fn}
    if not out or min(out.values()) == 0:
        raise AssertionError(f"tree_count: no tensor-core MMA in the staged kernel's SASS {out}")
    return out


def forced_tree_plan(change):
    """A context in which tree_count runs ``change(plan)`` of the plan it
    would have taken."""
    from contextlib import contextmanager

    from pilosa_tpu_torch.ops import kernels as tk

    @contextmanager
    def ctx():
        real = tk.tree_plan
        tk.tree_plan = lambda *a, **k: change(real(*a, **k))
        try:
            yield
        finally:
            tk.tree_plan = real

    return ctx()


def forced_range_plan(**change):
    """A context in which bsi_range takes its launch plan with ``change``
    (``chunks``, ``config``, ``vec``) in place of the plan's defaults."""
    from contextlib import contextmanager

    from pilosa_tpu_torch.ops import bsi as tb

    @contextmanager
    def ctx():
        real = tb.range_plan
        tb.range_plan = lambda *a, **k: real(*a, **{**k, **change})
        try:
            yield
        finally:
            tb.range_plan = real

    return ctx()


# bsi_range's composition classes (ops/bsi.py _C_*), by number
RANGE_CLASS_NAMES = ("zero", "exists", "fill_a", "sel_b", "eq", "ne", "bt_same", "bt_mix",
                     "gen1", "gen2")


def range_plan_log(plan):
    """A launch plan of bsi_range for the log: the block shape, and each
    launch's queries, segments ([class, queries]; "~" marks a swapped
    sign selection), mask rows and planes read."""
    import numpy as np

    from pilosa_tpu_torch.ops import bsi as tb

    launches = []
    for launch in plan.launches:
        P = np.frombuffer(launch.param, dtype=tb._RANGE_PARAM)[0]
        segs, q0 = [], 0
        for g in range(int(P["n_seg"])):
            cls, end = int(P["seg_cls"][g]), int(P["seg_end"][g])
            segs.append([RANGE_CLASS_NAMES[cls & 0xFF] + "~" * (cls >> 8), end - q0])
            q0 = end
        launches.append({"queries": int(P["n_q"]), "segments": segs,
                         "mask_rows": int(P["n_rows"]), "depth": launch.depth})
    return {"dmax": plan.dmax, "vec": plan.vec, "grid_x": plan.grid_x, "launches": launches}


def range_query_sass(functions, dmax=20, vec=4):
    """The loop over the queries of one single-side class in bsi_range's
    count instance of ``dmax`` planes and ``vec`` words a thread, from its
    SASS: the loop whose body loads the masks of one bound (``dmax / 4``
    16-byte loads) and popcounts ``vec`` words, the least of them (the
    one-side classes; equality reads both sides). Its instructions by
    opcode at the full depth (every group guard passed), and per (query,
    plane, word); None where no such loop is found."""
    import re
    from collections import Counter

    name = next((fn for fn in functions
                 if f"pilosa_bsi_range_kernelILb1ELi{dmax}ELi{vec}E" in fn), None)
    ins = []
    for line in functions.get(name, []):
        m = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)\s*([^\s;]*)",
                     line)
        if m:
            ins.append((int(m.group(1), 16), m.group(2), m.group(3)))
    best = None
    for addr, op, arg in ins:
        if op.startswith("BRA") and arg.startswith("0x") and int(arg, 16) < addr:
            body = [o for a, o, _ in ins if int(arg, 16) <= a <= addr]
            ops = Counter(o.split(".")[0] for o in body)
            masks = sum(o.startswith("LDS") and ".128" in o for o in body)
            if (masks == dmax // 4 and ops["POPC"] == vec and ops["LOP3"] >= dmax * vec
                    and (best is None or len(body) < sum(best.values()))):
                best = ops
    if best is None:
        return None
    n = sum(best.values())
    return {"instructions": n, "lop3": best["LOP3"],
            "per_query_plane_word": round(n / (dmax * vec), 3),
            "lop3_per_query_plane_word": round(best["LOP3"] / (dmax * vec), 3),
            "by_opcode": dict(best.most_common(10))}


def check_tree_kernels(stack_np, stack2_np, dev, rates=None):
    """The tree kernels against their plain versions: at the serving shape
    (stacks f and g of 64 rows, h of 4 and the existence row; B = 64, three
    tree shapes, the count's staged route) and at ragged ones (W = 130, S =
    3, a 0-row stack, absent rows, a program at the operand-stack limit, B =
    1; on the staged route W = 260 and 132, one item, one tensor as
    two stacks, tiles of rows and of items, items that share no rows); then
    timed at the trees path's batch (1024 three-leaf items, staged), at the
    300-leaf single item (direct) and for one bitmap tree. ``rates``: the
    tensor-core rates of check_kernels, for the BMMA floor."""
    import numpy as np
    import torch

    from pilosa_tpu_torch.exec import astbatch
    from pilosa_tpu_torch.ops import bitops, kernels as tk

    rng = np.random.default_rng(SEED + 7)
    S, _, W = stack_np.shape
    named = {
        "f": bitops.to_device(stack_np, dev),
        "g": bitops.to_device(stack2_np, dev),
        "h": bitops.to_device(random_words(rng, (S, H_ROWS, W), dense=True), dev),
        "e": bitops.to_device(random_words(rng, (S, 1, W), dense=False), dev),
    }

    def exact(name, got, want):
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        if err != 0:
            raise AssertionError(f"{name}: kernel differs from plain, max |err| {err}")
        return err

    def route(stacks, prog, slots):
        return tk.tree_count_launch(stacks, prog.code, prog.leaf_stack, slots).plan.route

    errs = {"tree_count": 0, "tree_words": 0}
    for name in ("and3", "union_of_pairs", "not"):
        sig, names = TREE_SIGS[name]
        stacks = tuple(named[n] for n in names)
        prog = astbatch.program(sig)
        slots = tree_slots(rng, prog, stacks, 64, absent=0.05)
        if route(stacks, prog, slots) != "staged":
            raise AssertionError(f"tree_count {name} B=64: not on the staged route")
        errs["tree_count"] = max(errs["tree_count"], exact(
            f"tree_count {name} B=64", tk.tree_count(stacks, prog.code, prog.leaf_stack, slots),
            tk.tree_count_plain(stacks, prog.code, prog.leaf_stack, slots)))
        errs["tree_words"] = max(errs["tree_words"], exact(
            f"tree_words {name}", tk.tree_words(stacks, prog.code, prog.leaf_stack, slots[0]),
            tk.tree_words_plain(stacks, prog.code, prog.leaf_stack, slots[0])))
    log(f"tree kernels exact at the serving shape {tuple(named['f'].shape)}, 64 items "
        "of three shapes (the count staged)")
    # ragged: W = 130 (the word path), S = 3, a 0-row stack, absent rows, a
    # program at the operand-stack limit (no tree compiles to it: its leaves
    # pushed, then folded with every fold in turn), one item; programs
    # longer than the opcodes and leaf rows the kernel stages in shared
    # memory (300 leaves; 512 leaves at depth 10), and a tree nested 40 deep
    D = tk.TREE_MAX_DEPTH
    folds = (tk.TREE_AND, tk.TREE_OR, tk.TREE_XOR, tk.TREE_ANDNOT, tk.TREE_NOTAND)
    at_limit = astbatch.Program(
        np.array(list(range(D)) + [folds[k % 5] for k in range(D - 1)], np.int32),
        np.arange(D, dtype=np.int32) % 3, D, D)
    chain = ("row", 0)
    for k in range(39):
        chain = (("intersect", "union", "xor", "difference")[k % 4], ("row", k % 3), chain)

    small = tuple(bitops.to_device(random_words(rng, (3, r, 130), dense=True), dev)
                  for r in (5, 0, 1))
    for name, sig, B in (("mixed", ("union", ("difference", ("row", 0), ("row", 1)),
                                    ("intersect", ("row", 2), ("row", 0))), 9),
                         (f"depth {D}", at_limit, 1),
                         ("300 leaves", ("union",) + tuple(("row", k % 3) for k in range(300)), 3),
                         ("512 leaves", tree_balanced(9), 2),
                         ("nested 40", chain, 5)):
        prog = sig if isinstance(sig, astbatch.Program) else astbatch.program(sig)
        slots = tree_slots(rng, prog, small, B, absent=0.2)
        errs["tree_count"] = max(errs["tree_count"], exact(
            f"tree_count {name} (3, 130)", tk.tree_count(small, prog.code, prog.leaf_stack, slots),
            tk.tree_count_plain(small, prog.code, prog.leaf_stack, slots)))
        errs["tree_words"] = max(errs["tree_words"], exact(
            f"tree_words {name} (3, 130)",
            tk.tree_words(small, prog.code, prog.leaf_stack, slots[-1]),
            tk.tree_words_plain(small, prog.code, prog.leaf_stack, slots[-1])))
    log("tree kernels exact at ragged shapes (W = 130, S = 3, a 0-row stack, absent "
        f"rows, depth {D}, B = 1, 300 and 512 leaves, nested 40 deep)")
    # the staged route at ragged shapes, each checked to take it: W = 260
    # (past a whole chunk) and 132, a 0-row stack, absent rows, one and two
    # register entries, one item, one tensor as two stacks, items
    # that share no rows, tiles cut by rows and by items, a chain of 40
    flat3, pairs = TREE_SIGS["and3"][0], TREE_SIGS["union_of_pairs"][0]
    w260 = tuple(bitops.to_device(random_words(rng, (3, r, 260), dense=True), dev)
                 for r in (5, 0, 3))
    w132 = tuple(bitops.to_device(random_words(rng, (2, r, 132), dense=True), dev)
                 for r in (40, 40, 4))
    one_item = lambda p: p._replace(route="staged", vec16=True, stages=2, row_tile=8,
                                    item_tile=8, wsplit=1)
    # tiles of at most 20 rows and 64 items
    small_tiles = {"_TREE_SMEM_LIMIT": tk._tree_staged_smem(20, 64, 3, 3, 2) + 16,
                   "_TREE_ITEM_TILE": 64}
    disjoint = (np.arange(8)[:, None] * 3 + np.arange(3)).astype(np.int32)
    cases = (
        ("flat W=260", flat3, w260, 40, 0.2, None, None, None),
        ("two entries W=260", pairs, w260, 33, 0.1, None, None, None),
        ("one item", flat3, w260, 1, 0.0, one_item, None, None),
        ("two entries, a W split", pairs, w132, 50, 0.1, lambda p: p._replace(wsplit=2), None,
         None),
        ("one tensor as two stacks", flat3, (w132[0], w132[0], w132[2]), 77, 0.1, None, None,
         None),
        ("no shared rows", flat3, w132[:2] + w132[:1], 8, 0.0, one_item, None, disjoint),
        ("tiles", flat3, w132, 300, 0.05, None, small_tiles, None),
        ("chain of 40", chain, w260, 6, 0.2, None, None, None),
        ("Not (ANDNOT) W=260", TREE_SIGS["not"][0], (w260[2], w260[0]), 40, 0.1, None, None,
         None),
        ("Union of four (OR)", ("union", ("row", 2), ("row", 1), ("row", 0), ("row", 1)),
         w132, 45, 0.1, None, None, None),
        ("flat on the step loop", flat3, w260, 40, 0.2, lambda p: p._replace(flat=-1), None,
         None),
    )
    for name, sig, stacks, B, absent, change, shrink, fixed in cases:
        prog = astbatch.program(sig)
        slots = tree_slots(rng, prog, stacks, B, absent=absent) if fixed is None else fixed
        saved = {k: getattr(tk, k) for k in (shrink or {})}
        for k, v in (shrink or {}).items():
            setattr(tk, k, v)
        try:
            with forced_tree_plan(change or (lambda p: p)):
                if route(stacks, prog, slots) != "staged":
                    raise AssertionError(f"tree_count {name}: not on the staged route")
                got = tk.tree_count(stacks, prog.code, prog.leaf_stack, slots)
        finally:
            for k, v in saved.items():
                setattr(tk, k, v)
        errs["tree_count"] = max(errs["tree_count"], exact(
            f"tree_count {name} {tuple(stacks[0].shape)}", got,
            tk.tree_count_plain(stacks, prog.code, prog.leaf_stack, slots)))
    log("tree_count exact on its staged route at ragged shapes (" +
        ", ".join(c[0] for c in cases) + ")")

    # timings at the trees path's shape: 1024 three-leaf items over f, g, h
    sig, names = TREE_SIGS["and3"]
    stacks = tuple(named[n] for n in names)
    prog = astbatch.program(sig)
    slots = tree_slots(rng, prog, stacks, BATCH)
    count = lambda: tk.tree_count(stacks, prog.code, prog.leaf_stack, slots)
    words = lambda: tk.tree_words(stacks, prog.code, prog.leaf_stack, slots[0])
    errs["tree_count"] = max(errs["tree_count"], exact(
        f"tree_count and3 B={BATCH}", count(),
        tk.tree_count_plain(stacks, prog.code, prog.leaf_stack, slots)))
    t_count = cuda_ms(count, reps=10)
    d_count = device_ms(count, reps=3)
    t_count_p = cuda_ms(lambda: tk.tree_count_plain(stacks, prog.code, prog.leaf_stack, slots),
                        reps=2, warmup=1)
    t_words = cuda_ms(words, reps=20)
    d_words = device_ms(words)
    t_words_p = cuda_ms(lambda: tk.tree_words_plain(stacks, prog.code, prog.leaf_stack, slots[0]),
                        reps=5)
    # the W split: each shape of the trees path at 1024 items, with slices
    # of 4 to 64 chunks (the plan takes TREE_SLICE_CHUNKS)
    sweep_rng = np.random.default_rng(SEED + 10)
    sweep = {}
    for shape in ("and3", "union_of_pairs", "not", "xor3"):
        s_sig, s_names = TREE_SIGS[shape]
        s_stacks = tuple(named[n] for n in s_names)
        s_prog = astbatch.program(s_sig)
        s_slots = tree_slots(sweep_rng, s_prog, s_stacks, BATCH)
        sweep[shape] = {}
        for n in (4, 8, 16, 32, 64):
            w = -(-W_FULL // (tk.TREE_CHUNK_WORDS * n))
            with forced_tree_plan(lambda p, w=w: p._replace(wsplit=w)):
                sweep[shape][n] = round(cuda_ms(
                    lambda: tk.tree_count(s_stacks, s_prog.code, s_prog.leaf_stack, s_slots),
                    reps=5), 4)
    log(f"tree_count at {BATCH} items, ms around the wrapper by slice length in chunks "
        f"(TREE_SLICE_CHUNKS = {tk.TREE_SLICE_CHUNKS}): {json.dumps(sweep)}")
    b_count, n_count, nominal_count = tree_bound(prog, stacks, slots)
    b_words, n_words, nominal_words = tree_bound(prog, stacks, slots[0], words=True)
    floors = tree_floors(prog, stacks, slots, rates)
    # the direct route's shapes (direct_tree_shapes); each exact, timed, and
    # timed again (exact each time, ms around the wrapper: the profiler may
    # drop events) at slices of 1024 to 16384 words (the plan takes
    # TREE_DIRECT_SLICE_WORDS) and at each block shape of the rows instance
    # that fits (the plan takes the one with the most warps an SM)
    direct = {}
    for shape, d_prog, d_slots in direct_tree_shapes(rng, stacks):
        B = d_slots.shape[0]
        fn = lambda d_prog=d_prog, d_slots=d_slots: tk.tree_count(
            stacks, d_prog.code, d_prog.leaf_stack, d_slots)
        want = tk.tree_count_plain(stacks, d_prog.code, d_prog.leaf_stack, d_slots)
        errs["tree_count"] = max(errs["tree_count"], exact(f"tree_count {shape}", fn(), want))
        floors_d = tree_floors(d_prog, stacks, d_slots, rates)
        if floors_d["route"] != "direct":
            raise AssertionError(f"tree_count {shape}: not on the direct route")
        t_d, d_d = cuda_ms(fn, reps=10), device_ms(fn, reps=3)
        p_d = cuda_ms(lambda d_prog=d_prog, d_slots=d_slots: tk.tree_count_plain(
            stacks, d_prog.code, d_prog.leaf_stack, d_slots), reps=2, warmup=1)
        b_d, n_d, _ = tree_bound(d_prog, stacks, d_slots)
        plan_d = floors_d["plan"]
        steps, depth = tk.tree_steps(d_prog.code)
        configs = [(f"slice {n}", {"wsplit": -(-W_FULL // n)})
                   for n in (1024, 2048, 4096, 8192, 16384)]
        configs += [(f"{lanes} lanes x {st}", {"stages": st, "lanes": lanes})
                    for lanes in (tk.TREE_ROWS_LANES, tk.TREE_ROWS_LANES // 2)
                    for st in range(1, tk.TREE_ROWS_MAX_STAGES + 1)
                    if plan_d["stages"] and tk._tree_rows_smem(
                        plan_d["row_tile"], steps.size, depth, st, lanes) <= tk._TREE_SMEM_LIMIT]
        sweep_d = {}
        for label, change in configs:
            with forced_tree_plan(lambda p, change=change: p._replace(**change)):
                exact(f"tree_count {shape} at {label}", fn(), want)
                sweep_d[label] = round(cuda_ms(fn, reps=5), 4)
        direct[shape] = (t_d, d_d, b_d, p_d, floors_d, sweep_d)
        log(f"tree_count {shape} (direct, B = {B}): kernel {t_d:.3f} ms (device {d_d}), plain "
            f"{p_d:.3f} ms, bound "
            f"{b_d[0]:.3f} ms ({b_d[1]}; {n_d:.4e} B); route {json.dumps(floors_d)}; ms around "
            f"the wrapper by slice length in words (TREE_DIRECT_SLICE_WORDS = "
            f"{tk.TREE_DIRECT_SLICE_WORDS}) and by block shape, each exact: "
            f"{json.dumps(sweep_d)}")
        if min(t_d, d_d or t_d, *sweep_d.values()) < b_d[0]:
            raise AssertionError(f"tree_count {shape}: {t_d} ms (device {d_d}) is below its "
                                 f"bound {b_d[0]} ms: the bound is wrong")
    report = {
        "tree_count": dict(max_abs_err=errs["tree_count"], ms=t_count, device_ms=d_count,
                           plain_ms=t_count_p, bound=b_count, library_ms=None,
                           bytes={"bound_bytes": n_count, "nominal_bytes": nominal_count,
                                  "items": BATCH},
                           tree_route=floors["route"],
                           extra={k: v[:4] for k, v in direct.items()},
                           extra_routes={k: v[4]["route"] + " " + v[4]["instance"]
                                         for k, v in direct.items()}),
        "tree_words": dict(max_abs_err=errs["tree_words"], ms=t_words, device_ms=d_words,
                           plain_ms=t_words_p, bound=b_words, library_ms=None,
                           bytes={"bound_bytes": n_words, "nominal_bytes": nominal_words,
                                  "items": 1}),
    }
    for k, v in report.items():
        log(f"{k}: kernel {v['ms']:.3f} ms (device {v['device_ms']}), plain "
            f"{v['plain_ms']:.3f} ms, bound {v['bound'][0]:.3f} ms ({v['bound'][1]}; "
            f"{v['bytes']['bound_bytes']:.4e} B read and written, nominal "
            f"{v['bytes']['nominal_bytes']:.4e} B), library None")
        if min(v["ms"], v["device_ms"] or v["ms"]) < v["bound"][0]:
            raise AssertionError(f"{k}: {v['ms']} ms (device {v['device_ms']}) is below "
                                 f"its bound {v['bound'][0]} ms: the bound is wrong")
    log(f"tree_count at {BATCH} items: route {json.dumps(floors)}")
    log("tree kernels: no single PyTorch call evaluates a tree, so their library_ms is null")
    del named, stacks, small, w260, w132
    torch.cuda.empty_cache()
    return report


# ---------------------------------------------------------------------------
# Phase 2b: the BSI kernels (ops/csrc/bsi.cu) against their plain versions
# ---------------------------------------------------------------------------

# the int fields of the served index (bench.py:935's v, 0..1,000,000, and a
# signed twin): base 0, depth 20 each
BSI_FIELDS = {"v": (0, 1_000_000), "w": (-1_000_000, 1_000_000)}
BSI_DEPTH = 20
# the bench's batched range count (bench.py:1466-1525): 128 Count(Row(v <= t))
BSI_Q = 128
# filtered Sums in the bsi path's batch
BSI_SUMS = 64
# 32-bit logic operations (LOP3) per second: the data sheet's float32 rate
# (67 TFLOP/s: 128 lanes per SM, two flops per fused multiply-add) over 4,
# for 64 integer-logic lanes per SM at one operation each
PEAK_INT32_OPS_PER_S = 67e12 / 4


def bsi_stack_np(rng, S, depth, W, empty_exists=False):
    """uint32 ``[S, 2+depth, W]``: about three quarters of the columns hold a
    value, signs and planes uniform."""
    import numpy as np

    out = random_words(rng, (S, 2 + depth, W), dense=False)
    out[:, 0] = 0 if empty_exists else out[:, 0] | random_words(rng, (S, W), dense=False)
    return np.ascontiguousarray(out)


def bsi_flight(rng, n, depth, two=True):
    """``n`` seeded range queries over stored values of ``depth`` bits:
    every comparison, signed bounds, two-bound ranges, out of band."""
    lim = 1 << depth
    cmps = ["<", "<=", ">", ">=", "==", "!="]
    out = []
    for k in range(n):
        def bound():
            mag = lim if rng.random() < 0.1 else int(rng.integers(0, max(1, lim)))
            return -mag if rng.random() < 0.4 else mag
        if two and k % 3 == 1:
            lo, hi = sorted((bound(), bound()))
            out.append([(">=", lo), ("<=", hi)])
        else:
            out.append([(cmps[int(rng.integers(0, 6))], bound())])
    return out


def bsi_range_tables(rng, S, W, depth=BSI_DEPTH):
    """The range scan's timed shapes at an int field of ``depth`` planes:
    ``{shape: (bounds table, count)}`` for the bench's 128 spread ``<=``
    counts, one words launch of seeded conditions at the executor's cap
    (12 at the serving shape), and a lone condition, words and counts."""
    from pilosa_tpu_torch.ops import bsi as tb

    def table_of(queries):
        qmask, _, qmeta, _ = tb.encode_query_bounds(queries, depth)
        return tb.bounds_table(qmask, qmeta)

    cap = min(tb.range_words_cap(S, W), BSI_SUMS)
    lone = table_of([[("<", 500_000)]])
    return {
        f"count_q{BSI_Q}": (table_of([[("<=", int((i + 0.5) * (1 << depth) / BSI_Q))]
                                      for i in range(BSI_Q)]), True),
        f"words_q{cap}": (table_of(bsi_flight(rng, cap, depth)), False),
        "words_q1": (lone, False),
        "count_q1": (lone, True),
    }


def bsi_range_bound(S, depth, W, table, count):
    """((ms, by), popc floor ms) of one bsi_range launch: the stack read once
    and the output written once at PEAK_BYTES_PER_S; against one LOP3 per
    query, bound, plane, side read and word at PEAK_INT32_OPS_PER_S (the
    sides this run's bounds read: lo for </<=, hi for >/>=, both for
    equality, none out of band) and, counting, the popcounts priced as
    the scans price theirs; the POPC pipe's floor for the log."""
    from pilosa_tpu_torch.ops import bsi as tb

    Q = table.shape[0]
    nbytes = S * (2 + depth) * W * 4 + table.nbytes + (Q * S * 4 if count else Q * S * W * 4)
    lo, hi = tb.table_sides(table)
    lops = S * W * depth * int(lo.sum() + hi.sum())
    t = {"bytes": nbytes / PEAK_BYTES_PER_S * 1e3,
         "operations": max(lops / PEAK_INT32_OPS_PER_S,
                           (2 * 32 * Q * S * W if count else 0) / PEAK_INT8_OPS_PER_S) * 1e3}
    by = max(t, key=t.get)
    return (t[by], by), bsi_popc_floor(Q * S * W if count else 0)


def bsi_popc_floor(n_popc):
    """ms of ``n_popc`` 32-bit popcounts at 16 per clock per SM, or None
    where nvidia-smi gives no clock."""
    import torch

    clock = sm_clock_hz()
    if not clock:
        return None
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return n_popc / (POPC_PER_CLOCK_PER_SM * sms * clock) * 1e3


def bsi_sum_bound(S, depth, W, Q, filtered):
    """((ms, by), popc floor ms) of one bsi_sum launch: the stack and the
    filters read once, the counts written once; 2 (depth + 1) popcounts per
    filter and word, priced as the scans price theirs (32 one-bit
    multiply-adds, 2 ops each, on the int8 tensor cores); and their floor
    on the POPC pipe, where this kernel runs them."""
    nbytes = S * (2 + depth) * W * 4 + (Q * S * W * 4 if filtered else 0) + S * Q * (depth + 1) * 8
    n_popc = 2 * (depth + 1) * Q * S * W
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 2 * 32 * n_popc / PEAK_INT8_OPS_PER_S * 1e3
    bound = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return bound, bsi_popc_floor(n_popc)


def bsi_sum_batch_bound(S, depth, W, Q, rate):
    """((ms, by), MMA floor ms) of one bsi_sum_batch launch: the stack and
    Q filter rows read once, the totals written once; its 2 (depth + 1) Q
    S W popcounts priced as bsi_sum prices them (int8 tensor cores); and
    the floor of the same work as single-bit multiply-adds (32 a popcount)
    at the rate ``mma_rates`` measured in this run (None without one)."""
    nbytes = S * (2 + depth) * W * 4 + Q * S * W * 4 + (depth + 1) * 2 * Q * 4
    n_popc = 2 * (depth + 1) * Q * S * W
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 2 * 32 * n_popc / PEAK_INT8_OPS_PER_S * 1e3
    bound = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return bound, (32 * n_popc / rate * 1e3 if rate else None)


def bsi_extreme_bound(S, depth, W, filtered):
    """(ms, by) of one bsi_extreme launch: the stack (and the filter) read
    once, against two LOP3 per plane, branch and word."""
    n_slices = -(-W // 2048)
    nbytes = S * (2 + depth) * W * 4 + (S * W * 4 if filtered else 0) + S * n_slices * 48
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 4 * S * W * depth / PEAK_INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_bsi_kernels(dev, rates=None):
    """The four BSI kernels against their plain versions, exactly: at the
    serving shape (160 shards x 22 rows x 32768 words: depth 20, three
    quarters of the columns holding a signed value), in both modes of the
    range scan at Q = 1, 3, 12 (one words launch of the main path) and 128
    (the bench's count flight), the sum unfiltered and under 1, 12 and 64
    filters, the batched sum under 2, 8 and 64 filters, each as an
    ``[S, Q, W]`` tensor and as rows of a 64-row stack through an index in
    random order with repeats and a -1, the extreme both ways, filtered and
    not; and at ragged shapes (one shard, W off each kernel's chunk, depths
    0, 1 and 63, Q = 1-128, an empty exists row, a sign row of all ones).
    Then each is timed at the main path's shapes with CUDA events around
    the wrapper and torch.profiler's device time beside its bound; at its
    head shape (128 counts, one filter, 64 filters, an unfiltered Max) also
    its plain version and, for the sums, torch._int_mm on pre-unpacked int8
    operands; the batched sum at 8 and 64 filters beside its single-bit MMA
    floor (``rates``: :func:`mma_rates`) and bsi_sum at the same Q. The
    range scan logs its launch plan at each timed shape and its device
    time at each instance and block shape the plan could take, each
    exact."""
    import numpy as np
    import torch

    from pilosa_tpu_torch.ops import bitops, bsi as tb, kernels as tk

    rng = np.random.default_rng(SEED + 7)
    S, depth, W = S_FULL, BSI_DEPTH, W_FULL

    def exact(name, got, want):
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) if got.numel() else 0
        if err != 0 or got.shape != want.shape:
            raise AssertionError(f"{name}: kernel differs from plain, max |err| {err}")
        return err

    def views(stack):
        return stack[:, 2:], stack[:, 0], stack[:, 1]

    def table_of(queries, d):
        qmask, _, qmeta, _ = tb.encode_query_bounds(queries, d)
        return tb.bounds_table(qmask, qmeta)

    stack = bitops.to_device(bsi_stack_np(rng, S, depth, W), dev)
    P, E, G = views(stack)
    errs = {"bsi_range": 0, "bsi_sum": 0, "bsi_extreme": 0, "bsi_sum_batch": 0}
    # the main path's flights: a lone condition, a mixed flight, one words
    # launch at the executor's cap, and the bench's 128 spread thresholds
    # (the timed shapes; their plain results kept for the sweep)
    mixed = table_of(bsi_flight(rng, 3, depth), depth)
    cap = min(tb.range_words_cap(S, W), BSI_SUMS)  # 12 at the serving shape
    range_shapes = bsi_range_tables(rng, S, W)
    lone = range_shapes["words_q1"][0]
    words_cap = range_shapes[f"words_q{cap}"][0]
    spread = range_shapes[f"count_q{BSI_Q}"][0]
    range_want = {}
    for name, table, count in (("words_q1", lone, False), ("count_q1", lone, True),
                               ("Q=3 words", mixed, False), ("Q=3 count", mixed, True),
                               (f"words_q{cap}", words_cap, False),
                               (f"count_q{BSI_Q}", spread, True)):
        want = tb.bsi_range_plain(P, E, G, table, count)
        errs["bsi_range"] = max(errs["bsi_range"], exact(
            f"bsi_range {name}", tb.bsi_range(P, E, G, table, count=count), want))
        if name in range_shapes:
            range_want[name] = want
    filters = bitops.to_device(random_words(rng, (S, BSI_SUMS, W), dense=True), dev)
    for name, f in (("unfiltered", None), ("one filter", filters[:, 0]),
                    (f"{cap} filters", filters[:, :cap]), (f"{BSI_SUMS} filters", filters)):
        errs["bsi_sum"] = max(errs["bsi_sum"], exact(
            f"bsi_sum {name}", tb.bsi_sum(P, E, G, f),
            tb.bsi_sum_plain(P, E, G, None if f is None else tb._filters("", f, S, W, False))))
    # the batched sum: the first Q filters as [S, Q, W], and Q rows of the
    # 64 filters as a stack, through an index in random order with a
    # repeat and a -1
    for q in (2, 8, BSI_SUMS):
        ix = rng.permutation(BSI_SUMS)[:q]
        ix[q // 2] = ix[0]
        ix[-1] = -1
        for form, operand, i in (("[S, Q, W]", filters[:, :q], np.arange(q)),
                                 ("rows", filters, ix)):
            errs["bsi_sum_batch"] = max(errs["bsi_sum_batch"], exact(
                f"bsi_sum_batch Q={q} {form}", tb.bsi_sum_batch(P, E, G, operand, i),
                tb.bsi_sum_batch_plain(P, E, G, operand, i)))
    for maximal in (True, False):
        for f in (None, filters[:, 1]):
            errs["bsi_extreme"] = max(errs["bsi_extreme"], exact(
                f"bsi_extreme maximal={maximal} filtered={f is not None}",
                tb.bsi_extreme(P, E, G, f, maximal=maximal),
                tb.bsi_extreme_plain(P, E, G, f, maximal)))
    log(f"bsi kernels exact at the serving shape {tuple(stack.shape)}: range "
        f"scans Q = 1, 3, {cap} (words) and 1, 3, {BSI_Q} (counts), sums under 0, 1, "
        f"{cap} and {BSI_SUMS} filters, batched sums under 2, 8 and {BSI_SUMS} filters "
        f"(as [S, Q, W] and as rows through an index), extremes both ways")

    # -- ragged shapes
    for (s, d, w, q, empty, ones) in [(1, 1, 130, 1, False, False), (3, 63, 130, 9, False, False),
                                      (2, 20, 1000, 17, False, True), (1, 63, 2100, 3, True, False),
                                      (5, 0, 257, 5, False, False), (4, 20, 3000, 128, False, False)]:
        st = bitops.to_device(bsi_stack_np(rng, s, d, w, empty), dev)
        if ones:  # every value negative
            st[:, 1] = -1
        p, e, g = views(st)
        t = table_of(bsi_flight(rng, q, d), d)
        for count in (False, True):
            exact(f"bsi_range {s, d, w} Q={q} count={count}", tb.bsi_range(p, e, g, t, count=count),
                  tb.bsi_range_plain(p, e, g, t, count))
        fl = bitops.to_device(random_words(rng, (s, q, w), dense=False), dev)
        exact(f"bsi_sum {s, d, w} Q={q}", tb.bsi_sum(p, e, g, fl), tb.bsi_sum_plain(p, e, g, fl))
        exact(f"bsi_sum {s, d, w} unfiltered", tb.bsi_sum(p, e, g), tb.bsi_sum_plain(p, e, g, None))
        for i in (np.arange(q), rng.integers(-1, q, q)):
            exact(f"bsi_sum_batch {s, d, w} Q={q}", tb.bsi_sum_batch(p, e, g, fl, i),
                  tb.bsi_sum_batch_plain(p, e, g, fl, i))
        for maximal in (True, False):
            exact(f"bsi_extreme {s, d, w} maximal={maximal}",
                  tb.bsi_extreme(p, e, g, fl[:, 0], maximal=maximal),
                  tb.bsi_extreme_plain(p, e, g, fl[:, 0], maximal))
    log("bsi kernels exact at ragged shapes (S = 1-5, W = 130-3000, depths 0, 1, 20 "
        "and 63, Q = 1-128, an empty exists row, a sign row of all ones)")

    # -- timings at the main path's shapes; the plain version at the head
    #    shape of each kernel only
    def timed(fn, plain=None, reps=10):
        return (cuda_ms(fn, reps=reps), device_ms(fn),
                *(() if plain is None else (cuda_ms(plain, reps=2, warmup=1),)))

    report = {}
    shapes = {"words_q1": (lone, False), "count_q1": (lone, True),
              f"words_q{cap}": (words_cap, False)}
    t, d, pl = timed(lambda: tb.bsi_range(P, E, G, spread, count=True),
                     lambda: tb.bsi_range_plain(P, E, G, spread, True))
    b, floor = bsi_range_bound(S, depth, W, spread, True)
    extra, floors = {}, {f"count_q{BSI_Q}": floor}
    for shape, (table, count) in shapes.items():
        extra[shape] = (*timed(lambda: tb.bsi_range(P, E, G, table, count=count)),
                        bsi_range_bound(S, depth, W, table, count)[0])
    report["bsi_range"] = dict(
        max_abs_err=errs["bsi_range"], ms=t, device_ms=d, plain_ms=pl, bound=b,
        library_ms=None, extra=extra, popc_floors=floors)
    # each timed shape's plan, and the instances and block shapes the plan
    # could take (planes and words a thread, chunks a block), each exact,
    # in device ms
    for shape, (table, count) in range_shapes.items():
        plan = tb.range_plan(table, depth, W, count, vec=tb._range_vec(P, E, G))
        sweep = {}
        for cfg in [c for c in tb.RANGE_CONFIGS if depth <= c[0]]:
            for chunks in (1, 2, 4):
                with forced_range_plan(chunks=chunks, config=cfg, vec=cfg[1]):
                    fn = lambda: tb.bsi_range(P, E, G, table, count=count)
                    label = f"{cfg[0]}x{cfg[1]} c{chunks}"
                    exact(f"bsi_range {shape} at {label}", fn(), range_want[shape])
                    sweep[label] = device_ms(fn, reps=3)
        best = min(sweep, key=lambda k: sweep[k] or float("inf"))
        log(f"bsi_range {shape}: plan {json.dumps(range_plan_log(plan))}; device ms by "
            f"instance (planes x words a thread) and chunks a block, each exact: "
            f"{json.dumps(sweep)}; fastest {best}")
    del range_want

    # the sum: the main path's filtered Sum (one filter) at the head, with
    # torch._int_mm over the same work as the yardstick (its exact check
    # is its warm-up)
    f1 = filters[:, 0]
    t, d, pl = timed(lambda: tb.bsi_sum(P, E, G, f1),
                     lambda: tb.bsi_sum_plain(P, E, G, tb._filters("", f1, S, W, False)))
    b, floor = bsi_sum_bound(S, depth, W, 1, True)

    def unpacked(rows):  # [S, R, W] -> int8 [R, S*W*32] (unpack untimed)
        out = torch.empty((rows.shape[1], S * W * 32), dtype=torch.int8, device=dev)
        for s in range(S):
            out[:, s * W * 32:(s + 1) * W * 32] = tk.unpack_bits(rows[s], torch.int8)
        return out

    def int_mm_ms(fq):
        """torch._int_mm over the work of the Sums under the filters ``fq``
        (``[S, Q, W]``): the planes and exists rows against each filter's
        two sign columns, padded with zero rows to the multiple of 8 that
        its N must be; held to bsi_sum_batch's totals, then timed once."""
        q = fq.shape[1]
        f_ex = fq & E[:, None, :]
        pad = torch.zeros((S, -(-2 * q // 8) * 8 - 2 * q, W), dtype=f_ex.dtype, device=dev)
        filt8 = unpacked(torch.cat([f_ex & ~G[:, None, :], f_ex & G[:, None, :], pad], dim=1))
        del f_ex, pad
        mm = torch._int_mm(rows8, filt8.T)  # [depth + 1, 2Q padded]
        exact(f"torch._int_mm sum yardstick Q={q}", mm[:, :2 * q].reshape(depth + 1, 2, q),
              tb.bsi_sum_batch(P, E, G, fq, np.arange(q)))
        del mm
        ms = cuda_ms(lambda: torch._int_mm(rows8, filt8.T), reps=1, warmup=0)
        del filt8
        torch.cuda.empty_cache()
        return ms

    rows8 = unpacked(torch.cat([P, E[:, None, :]], dim=1))
    t_lib = int_mm_ms(f1[:, None, :])
    lib_batch = {q: int_mm_ms(filters[:, :q]) for q in (8, BSI_SUMS)}
    del rows8
    torch.cuda.empty_cache()
    extra, floors = {}, {"one_filter": floor}
    for shape, f, q in (("unfiltered", None, 1), (f"q{BSI_SUMS}", filters, BSI_SUMS)):
        b_f = bsi_sum_bound(S, depth, W, q, f is not None)
        extra[shape] = (*timed(lambda: tb.bsi_sum(P, E, G, f)), b_f[0])
        floors[shape] = b_f[1]
    report["bsi_sum"] = dict(
        max_abs_err=errs["bsi_sum"], ms=t, device_ms=d, plain_ms=pl, bound=b,
        library_ms=t_lib, extra=extra, popc_floors=floors)

    # the batched sum at the main path's flights (64 filtered Sums, and 8),
    # the filters as rows of the 64-row stack; bsi_sum, the route it
    # replaces, at the same Q in this run
    rate = (rates or {}).get("mma.sync.m16n8k256.b1.and.popc")
    ix = np.arange(BSI_SUMS)
    t, d = timed(lambda: tb.bsi_sum_batch(P, E, G, filters, ix))
    # (the plain version ran at this shape in the exact checks: no warm-up)
    pl = cuda_ms(lambda: tb.bsi_sum_batch_plain(P, E, G, filters, ix), reps=1, warmup=0)
    b, mma = bsi_sum_batch_bound(S, depth, W, BSI_SUMS, rate)
    old = {f"q{BSI_SUMS}": extra[f"q{BSI_SUMS}"][:2]}
    t8, d8 = timed(lambda: tb.bsi_sum_batch(P, E, G, filters, ix[:8]))
    b8, mma8 = bsi_sum_batch_bound(S, depth, W, 8, rate)
    old["q8"] = timed(lambda: tb.bsi_sum(P, E, G, filters[:, :8]), reps=5)
    report["bsi_sum_batch"] = dict(
        max_abs_err=errs["bsi_sum_batch"], ms=t, device_ms=d, plain_ms=pl, bound=b,
        library_ms=lib_batch[BSI_SUMS], extra={"q8": (t8, d8, b8)},
        mma_floors={f"q{BSI_SUMS}": mma, "q8": mma8},
        library_ms_by_q={f"q{q}": v for q, v in lib_batch.items()},
        bsi_sum_ms_by_q={k: {"ms": v[0], "device_ms": v[1]} for k, v in old.items()},
        popc_floors={f"q{BSI_SUMS}": bsi_sum_bound(S, depth, W, BSI_SUMS, True)[1]})
    popc = report["bsi_sum_batch"]["popc_floors"][f"q{BSI_SUMS}"]
    met = d is not None and d < 2 * b[0] and (popc is None or d < popc)
    log(f"bsi_sum_batch at Q = {BSI_SUMS}: device {d} ms against its bound {b[0]:.4f} ms "
        f"({b[1]}), the POPC pipe's floor {popc} ms and its MMA floor {mma} ms: the design "
        f"target (under the POPC floor, within 2x of the bound) "
        f"{'met' if met else 'missed'}")

    t, d, pl = timed(lambda: tb.bsi_extreme(P, E, G, maximal=True),
                     lambda: tb.bsi_extreme_plain(P, E, G, None, True))
    tf, df = timed(lambda: tb.bsi_extreme(P, E, G, filters[:, 1], maximal=False))
    report["bsi_extreme"] = dict(
        max_abs_err=errs["bsi_extreme"], ms=t, device_ms=d, plain_ms=pl,
        bound=bsi_extreme_bound(S, depth, W, False), library_ms=None,
        extra={"filtered_min": (tf, df, bsi_extreme_bound(S, depth, W, True))})

    for k, v in report.items():
        log(f"{k}: kernel {v['ms']:.3f} ms (device {v['device_ms']}), plain "
            f"{v['plain_ms']:.3f} ms, bound {v['bound'][0]:.3f} ms ({v['bound'][1]}), library "
            f"{v['library_ms'] if v['library_ms'] is None else round(v['library_ms'], 3)}")
        for shape, (tt, dd, bb) in v["extra"].items():
            log(f"{k} {shape}: kernel {tt:.3f} ms (device {dd}), bound {bb[0]:.3f} ms ({bb[1]})")
        if v.get("popc_floors"):
            log(f"{k}: POPC pipe floors (16 a clock an SM at the clock nvidia-smi reads), "
                f"ms by shape {v['popc_floors']}")
        for key, what in (("mma_floors", "single-bit MMA floors at the rate measured in "
                           "this run"), ("library_ms_by_q", "torch._int_mm"),
                          ("bsi_sum_ms_by_q", "bsi_sum (the route it replaces)")):
            if v.get(key):
                log(f"{k}: {what}, ms by shape {v[key]}")
        for tt, dd, bb in [(v["ms"], v["device_ms"], v["bound"]), *v["extra"].values()]:
            if min(tt, dd or tt) < bb[0]:
                raise AssertionError(f"{k}: {tt} ms (device {dd}) is below its bound "
                                     f"{bb[0]} ms: the bound is wrong")
    log("bsi_range and bsi_extreme: no single PyTorch call computes them, so their "
        "library_ms is null")
    log(f"bsi kernels' card: {card_line()}")
    del stack, P, E, G, filters
    torch.cuda.empty_cache()
    return report


# ---------------------------------------------------------------------------
# Phase 3: the main path, end to end
# ---------------------------------------------------------------------------


def mirror_stack(holder, field: str, n_rows: int, n_shards: int):
    """numpy uint32[S, R, W] of a field's standard view, from the host
    mirrors (the ground truth's source), shards copied in parallel."""
    import numpy as np

    f = holder.field("i", field)
    view = f.view("standard")
    out = np.zeros((n_shards, n_rows, f.n_words), dtype=np.uint32)

    def fill(s):
        frag = view.fragment(s)
        if frag is not None:
            ids, mat = frag.rows_matrix_host()
            out[s, ids] = mat

    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        list(pool.map(fill, range(n_shards)))
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
    the int fields of BSI_FIELDS (v: 0..1,000,000, w: -1,000,000..
    1,000,000, depth 20, values in three quarters of the columns), and the
    existence field's row (the union of them all), on
    ``Holder(device=device)``."""
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
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        bsi_words = {n: bsi_field_words(rng, lo, hi, pool) for n, (lo, hi) in BSI_FIELDS.items()}
    schema = [{
        "name": "i",
        "options": {"keys": False, "trackExistence": True},
        "fields": [{"name": n, "options": {}} for n in words] + [
            {"name": n, "options": {"type": "int", "min": lo, "max": hi}}
            for n, (lo, hi) in BSI_FIELDS.items()],
    }]
    fragments = {}
    for name, w in words.items():
        rows = list(range(w.shape[1]))
        for s in range(S_FULL):
            fragments[("i", name, "standard", s)] = (rows, w[s])
    for name, w in bsi_words.items():
        rows = list(range(2 + BSI_DEPTH))
        for s in range(S_FULL):
            fragments[("i", name, "bsig_" + name, s)] = (rows, w[s])
    # the existence field's row 0: every column any field holds, as an
    # import of f, g, h, v and w would have recorded it
    exists = np.zeros((S_FULL, 1, SHARD_WORDS), dtype=np.uint32)
    for w in words.values():
        exists[:, 0] |= np.bitwise_or.reduce(w, axis=1)
    for w in bsi_words.values():
        exists[:, 0] |= w[:, 0]
    for s in range(S_FULL):
        fragments[("i", "_exists", "standard", s)] = ([0], exists[s])
    holder = convert.holder_from_arrays(schema, fragments, device=device)
    setup_s = time.perf_counter() - t0
    log(f"index built: {S_FULL} shards x 2^20 columns; fields f, g of {R_FULL} "
        f"rows and h of {H_ROWS} rows, {words['f'].size * 32 / 1e9:.2f}e9 bits "
        f"in f, density {np.bitwise_count(words['f'][0]).mean() / 32:.3f}; int fields "
        f"{', '.join(f'{n} [{lo}, {hi}]' for n, (lo, hi) in BSI_FIELDS.items())}, depth "
        f"{BSI_DEPTH}, values in {np.bitwise_count(bsi_words['v'][:, 0]).mean() / 32:.3f} "
        f"of the columns; {setup_s:.1f} s")
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


# masks of the 64-bit SWAR popcount: 2-, 4- and 8-bit fields
M1, M2, M4 = 0x5555555555555555, 0x3333333333333333, 0x0F0F0F0F0F0F0F0F


def popcount_rows(words):
    """int64 ``[...]`` set bits of each row of the int32 ``words``
    ``[..., W]`` (W even), which it overwrites: SWAR on int64 views down to
    a count per byte, then the bytes summed."""
    import torch

    y = words.view(torch.int64)
    t = y >> 1
    t &= M1
    y -= t
    t = y >> 2
    t &= M2
    y &= M2
    y += t
    t = y >> 4
    y += t
    y &= M4
    return y.view(torch.uint8).sum(dim=-1, dtype=torch.int64)


def truth_groupby(levels, filt=None):
    """Every non-empty combination of a GroupBy over the device stacks
    ``levels`` (``int32[S, R_l, W]``, row id = row index), in the
    reference's depth-first order, as ``[(row ids, count)]``: torch AND and
    popcount (:func:`popcount_rows`) per combination of all levels but the
    last, which is counted for all its rows at once. No code of the port
    runs."""
    import itertools

    import torch

    *heads, last = levels
    out = []
    for combo in itertools.product(*(range(h.shape[1]) for h in heads)):
        m = filt
        for h, r in zip(heads, combo):
            m = h[:, r] if m is None else m & h[:, r]
        counts = popcount_rows(last & m[:, None]).sum(dim=0)
        out.extend((combo + (r,), c) for r, c in enumerate(counts.tolist()) if c)
    return out


def check_numpy_sample(what, answer, np_levels, np_filt, pool, rng, k=256):
    """A seeded sample of ``k`` combinations of ``answer`` (all of them when
    there are fewer) recounted with numpy over the host mirrors (the rows
    read as 64-bit words: half the elements to AND and count)."""
    import numpy as np

    pick = (range(len(answer)) if len(answer) <= k
            else rng.choice(len(answer), size=k, replace=False))
    items = [answer[int(i)] for i in pick]
    levels = [lv.view(np.uint64) for lv in np_levels]
    filt = None if np_filt is None else np_filt.view(np.uint64)

    def one(item):
        combo, count = item
        rows = [lv[:, r] for lv, r in zip(levels, combo)]
        if filt is not None:
            rows.append(filt)
        m = rows[0] & rows[1] if len(rows) > 1 else rows[0]
        for x in rows[2:]:
            np.bitwise_and(m, x, out=m)
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
            flipped = (fields[::-1], filt_row)
            if key not in truths and len(fields) == 2 and flipped in truths:
                # the same counts with the levels swapped, in depth-first order
                truths[key] = sorted((c[::-1], n) for c, n in truths[flipped])
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


# the trees path's Count shapes (four launch groups) and bitmap trees;
# {a}..{d} are row ids
TREE_COUNTS = (
    "Count(Intersect(Row(f={a}), Row(g={b}), Row(h={c})))",
    "Count(Union(Intersect(Row(f={a}), Row(g={b})), Difference(Row(f={c}), Row(g={d}))))",
    "Count(Not(Row(f={a})))",
    # three leaves of one field: not a pair Count, so not the gram's
    "Count(Xor(Row(f={a}), Row(f={b}), Row(f={c})))",
)
TREE_BITMAPS = (
    "Union(Row(f={a}), Row(g={b}), Row(h={c}))",
    "Difference(Row(f={a}), Row(g={b}))",
    "Not(Row(h={c}))",
)
# a row id no field holds: an absent leaf
ABSENT_ROW = 1000
# a Count of a Union of this many rows of f, g and h (one absent): longer
# than the program head the tree kernel stages in shared memory
WIDE_LEAVES = 300


def mirror_row(m, name, rid):
    """``uint32[S, W]`` words of row ``rid`` of the mirror stack
    ``m[name]``; zeros for a row it does not hold."""
    import numpy as np

    st = m[name]
    return st[:, rid] if rid < st.shape[1] else np.zeros_like(st[:, 0])


def tree_truth_words(shape, m, r):
    """numpy words ``uint32[S, W]`` of Count shape ``shape`` of TREE_COUNTS
    with rows ``r`` over the mirrors ``m`` (stacks by field name, "e" the
    existence row)."""
    a, b, c, d = r
    f, g, h = (lambda rid, n=n: mirror_row(m, n, rid) for n in "fgh")
    if shape == 0:
        return f(a) & g(b) & h(c)
    if shape == 1:
        return (f(a) & g(b)) | (f(c) & ~g(d))
    if shape == 2:
        return mirror_row(m, "e", 0) & ~f(a)
    return f(a) ^ f(b) ^ f(c)


def bitmap_truth_words(shape, m, r):
    """numpy words of bitmap shape ``shape`` of TREE_BITMAPS."""
    a, b, c, _ = r
    if shape == 0:
        return mirror_row(m, "f", a) | mirror_row(m, "g", b) | mirror_row(m, "h", c)
    if shape == 1:
        return mirror_row(m, "f", a) & ~mirror_row(m, "g", b)
    return mirror_row(m, "e", 0) & ~mirror_row(m, "h", c)


TREE_FIELD_ROWS = {"f": R_FULL, "g": R_FULL, "h": H_ROWS}


def tree_queries(qrng):
    """The trees path's queries, drawn from ``qrng``: ``(items, calls,
    bitmaps, bitmap_q, wide, wide_q)``, the 1024 Count items (shape, rows)
    and their PQL calls, the three bitmap trees (shape, rows) and their
    query, and the WIDE_LEAVES leaves (field, row) of the wide Count and
    its query. A row is ABSENT_ROW with odds 1/64."""
    n_rows = TREE_FIELD_ROWS
    leaf_fields = (("f", "g", "h", None), ("f", "g", "f", "g"), ("f", None, None, None),
                   ("f", "f", "f", None))

    def draw(fld):
        if fld is None:
            return 0
        return ABSENT_ROW if qrng.random() < 1 / 64 else int(qrng.integers(0, n_rows[fld]))

    items = []
    for k in range(BATCH):
        shape = k % len(TREE_COUNTS)
        items.append((shape, tuple(draw(f) for f in leaf_fields[shape])))
    calls = [TREE_COUNTS[sh].format(a=r[0], b=r[1], c=r[2], d=r[3]) for sh, r in items]
    bitmaps = [(sh, tuple(draw(f) for f in ("f", "g", "h", None)))
               for sh in range(len(TREE_BITMAPS))]
    bitmap_q = " ".join(TREE_BITMAPS[sh].format(a=r[0], b=r[1], c=r[2]) for sh, r in bitmaps)
    wide = [("fgh"[k % 3], (k // 3) % n_rows["fgh"[k % 3]]) for k in range(WIDE_LEAVES - 1)]
    wide.append(("f", ABSENT_ROW))
    wide_q = "Count(Union(" + ", ".join(f"Row({f}={r})" for f, r in wide) + "))"
    return items, calls, bitmaps, bitmap_q, wide, wide_q


def trees_path(pool, ex, holder, device):
    """Compiled PQL trees at the serving size, before and after writes to
    f, g and h: a 1024-call batch of four Count shapes through
    ``execute_batch`` and ``execute`` (one tree_count launch per shape
    group), every answer against the plain tree count on the card and a
    seeded sample against numpy; a Count of a Union of 300 rows and a lone
    Count of a three-leaf Intersect (one tree_count launch each, on the
    direct route) against numpy; three bitmap trees through ``execute``
    (one tree_words launch each). Then write visibility through the
    incremental stack update: one Set to one shard of f and a cold
    tanimoto TopN (a patched stack, no rebuild), and a Set that creates a
    row (a rebuild)."""
    import numpy as np
    import torch

    from pilosa_tpu_torch.exec import astbatch
    from pilosa_tpu_torch.ops import bitops, kernels as tk
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    qrng = np.random.default_rng(SEED + 6)
    on_card = torch.device(device).type == "cuda"
    n_rows = TREE_FIELD_ROWS
    items, calls, bitmaps, bitmap_q, wide, wide_q = tree_queries(qrng)
    # a lone Count of a three-leaf Intersect (one item on the direct route)
    lone_r = tuple(int(x) for x in np.random.default_rng(SEED + 11).integers(
        0, (n_rows["f"], n_rows["g"], n_rows["h"]))) + (0,)
    lone_q = TREE_COUNTS[0].format(a=lone_r[0], b=lone_r[1], c=lone_r[2])
    # the plain version's signatures and leaf order for each Count shape
    plain_sigs = [TREE_SIGS[n] for n in ("and3", "union_of_pairs", "not", "xor3")]
    plain_rows = (lambda r: r[:3], lambda r: r, lambda r: (0, r[0]), lambda r: r[:3])
    results = {}

    def run_round(tag):
        m = {n: mirror_stack(holder, n, n_rows[n], S_FULL) for n in n_rows}
        m["e"] = mirror_stack(holder, "_exists", 1, S_FULL)
        launches0 = dict(tk.LAUNCHES)
        t = time.perf_counter()
        batch_out = ex.execute_batch("i", [(c, None) for c in calls])
        batch_s = time.perf_counter() - t
        launched = tk.LAUNCHES["tree_count"] - launches0["tree_count"]
        t = time.perf_counter()
        exec_out = ex.execute("i", " ".join(calls))
        exec_s = time.perf_counter() - t
        launched_exec = tk.LAUNCHES["tree_count"] - launches0["tree_count"] - launched
        if on_card and (launched, launched_exec) != (len(TREE_COUNTS),) * 2:
            raise AssertionError(f"{tag}: tree_count launched {launched} / {launched_exec} "
                                 f"times, not once per shape ({len(TREE_COUNTS)})")
        got = []
        for o in batch_out:
            if isinstance(o, Exception):
                raise o
            got.append(o[0])
        if got != exec_out:
            raise AssertionError(f"{tag}: execute_batch and execute differ on "
                                 f"{sum(a != b for a, b in zip(got, exec_out))} trees")
        # every answer against the plain tree count on the card
        dev = {n: bitops.to_device(w, torch.device(device)) for n, w in m.items()}
        for sh, (sig, names) in enumerate(plain_sigs):
            prog = astbatch.program(sig)
            stacks = tuple(dev[n] for n in names)
            idx = [j for j, (s_, _) in enumerate(items) if s_ == sh]
            slots = np.array([[r if r < stacks[prog.leaf_stack[l]].shape[1] else -1
                               for l, r in enumerate(plain_rows[sh](items[j][1]))]
                              for j in idx], dtype=np.int32)
            want = tk.tree_count_plain(stacks, prog.code, prog.leaf_stack, slots)
            want = want.to(torch.int64).sum(dim=1).tolist()
            if [got[j] for j in idx] != want:
                raise AssertionError(f"{tag}: Count shape {sh} differs from the plain tree "
                                     "count on the card")
        del dev
        # a seeded sample against numpy over the mirrors
        pick = np.random.default_rng(SEED + 8).choice(BATCH, size=64, replace=False)

        def one(j):
            sh, r = items[j]
            return int(np.bitwise_count(tree_truth_words(sh, m, r)).sum(dtype=np.int64)) == got[j]

        bad = sum(not ok for ok in pool.map(one, pick.tolist()))
        if bad:
            raise AssertionError(f"{tag}: {bad} of 64 sampled tree counts differ from numpy")
        if not any(got):
            raise AssertionError(f"{tag}: all tree counts are 0")
        # a Count of a Union of WIDE_LEAVES rows: one launch, against numpy
        count0 = tk.LAUNCHES["tree_count"]
        t = time.perf_counter()
        (wide_got,) = ex.execute("i", wide_q)
        wide_ms = (time.perf_counter() - t) * 1e3
        if on_card and tk.LAUNCHES["tree_count"] - count0 != 1:
            raise AssertionError(f"{tag}: the {WIDE_LEAVES}-leaf Count launched tree_count "
                                 f"{tk.LAUNCHES['tree_count'] - count0} times, not once")
        wide_rows = {n: sorted({r for f, r in wide if f == n and r < n_rows[n]}) for n in "fgh"}

        def wide_shard(s_):
            acc = np.zeros(m["f"].shape[2], np.uint32)
            for n, rs in wide_rows.items():
                acc |= np.bitwise_or.reduce(m[n][s_, rs], axis=0)
            return int(np.bitwise_count(acc).sum(dtype=np.int64))

        wide_want = sum(pool.map(wide_shard, range(S_FULL)))
        if wide_got != wide_want:
            raise AssertionError(f"{tag}: the {WIDE_LEAVES}-leaf Count {wide_got} != "
                                 f"numpy {wide_want}")
        # the lone Count: one launch, against numpy
        count0 = tk.LAUNCHES["tree_count"]
        t = time.perf_counter()
        (lone_got,) = ex.execute("i", lone_q)
        lone_ms = (time.perf_counter() - t) * 1e3
        if on_card and tk.LAUNCHES["tree_count"] - count0 != 1:
            raise AssertionError(f"{tag}: the lone Count launched tree_count "
                                 f"{tk.LAUNCHES['tree_count'] - count0} times, not once")
        lone_want = int(np.bitwise_count(tree_truth_words(0, m, lone_r)).sum(dtype=np.int64))
        if lone_got != lone_want:
            raise AssertionError(f"{tag}: the lone Count {lone_got} != numpy {lone_want}")
        # bitmap trees: one tree_words launch each, the words against numpy
        words0 = tk.LAUNCHES["tree_words"]
        t = time.perf_counter()
        rows = ex.execute("i", bitmap_q)
        bitmap_ms = (time.perf_counter() - t) * 1e3
        if on_card and tk.LAUNCHES["tree_words"] - words0 != len(TREE_BITMAPS):
            raise AssertionError(f"{tag}: tree_words launched "
                                 f"{tk.LAUNCHES['tree_words'] - words0} times")
        check_shards = np.random.default_rng(SEED + 9).choice(S_FULL, size=4, replace=False)
        for (sh, r), row in zip(bitmaps, rows):
            want = bitmap_truth_words(sh, m, r)
            if row.count() != int(np.bitwise_count(want).sum(dtype=np.int64)):
                raise AssertionError(f"{tag}: bitmap tree {sh} count differs from numpy")
            for s_ in check_shards.tolist():
                if not np.array_equal(row.segments[s_], want[s_]):
                    raise AssertionError(f"{tag}: bitmap tree {sh} shard {s_} words differ")
        results[tag] = {
            "trees_execute_batch_s": batch_s,
            "trees_execute_batch_qps": BATCH / batch_s,
            "trees_execute_s": exec_s,
            "bitmap_trees_execute_ms": bitmap_ms,
            "wide_count_execute_ms": wide_ms,
            "lone_count_execute_ms": lone_ms,
        }
        log(f"{tag}: {BATCH} tree Counts via execute_batch {batch_s * 1e3:.1f} ms "
            f"({BATCH / batch_s:.0f} queries/s), via execute {exec_s * 1e3:.1f} ms, one "
            f"tree_count per shape; all equal the plain count on the card, 64 sampled "
            f"equal numpy; a {WIDE_LEAVES}-leaf Count {wide_ms:.1f} ms and a lone Count "
            f"{lone_ms:.2f} ms (one launch each), equal numpy; 3 bitmap trees "
            f"{bitmap_ms:.1f} ms, words equal numpy")

    run_round("before_writes")
    results["writes_ms"] = apply_writes(ex, holder, qrng, ("f", "g", "h"), 64)
    run_round("after_writes")

    # write visibility through the incremental update: one Set to one shard
    # of f (a column whose bit is clear), then a cold tanimoto TopN
    g_row = int(qrng.integers(0, R_FULL))
    q = f"TopN(f, Row(g={g_row}), n=10, tanimotoThreshold=10)"
    ex.execute("i", q)
    f_field = holder.field("i", "f")
    shard = int(qrng.integers(0, S_FULL))
    col = next(c for c in range(shard * SHARD_WIDTH, (shard + 1) * SHARD_WIDTH)
               if not f_field.get_bit(3, c))
    vis = {}
    for label, row_id, n_f_rows in (("one_write", 3, R_FULL), ("new_row", R_FULL, R_FULL + 1)):
        inc0, reb0 = ex.stack_incremental, ex.stack_rebuilds
        ex.execute("i", f"Set({col}, f={row_id})")
        t = time.perf_counter()
        (res,) = ex.execute("i", q)
        vis[f"topn_tanimoto_after_{label}_ms"] = (time.perf_counter() - t) * 1e3
        want_inc = (inc0 + 1, reb0) if label == "one_write" else (inc0, reb0 + 1)
        if (ex.stack_incremental, ex.stack_rebuilds) != want_inc:
            raise AssertionError(f"{label}: stack_incremental {ex.stack_incremental}, "
                                 f"stack_rebuilds {ex.stack_rebuilds}, not {want_inc}")
        want = truth_tanimoto_topn(mirror_stack(holder, "f", n_f_rows, S_FULL),
                                   mirror_stack(holder, "g", R_FULL, S_FULL), g_row, 10, 10, pool)
        if [(p.id, p.count) for p in res] != want:
            raise AssertionError(f"{label}: {q} -> {res} != {want}")
    results["write_visibility"] = vis
    log("write visibility: one Set to one shard of f, then a cold tanimoto TopN "
        f"{vis['topn_tanimoto_after_one_write_ms']:.1f} ms (the stack patched, no rebuild); "
        f"a Set creating row {R_FULL}, then the same TopN "
        f"{vis['topn_tanimoto_after_new_row_ms']:.1f} ms (a rebuild); answers equal numpy")
    return results


# ---------------------------------------------------------------------------
# The bsi path: int fields v and w at the serving size
# ---------------------------------------------------------------------------


def bsi_field_words(rng, lo, hi, pool, share=0.75, depth=BSI_DEPTH):
    """uint32 ``[S_FULL, 2 + depth, W_FULL]`` rows of an int field's BSI
    view (exists, sign, planes), about ``share`` of the columns (three
    quarters by default) holding a value drawn uniformly from [lo, hi]
    (base 0), packed with numpy shard by shard from per-shard seeds."""
    import numpy as np

    width = W_FULL * 32
    seeds = rng.integers(0, 2**63, size=S_FULL)
    out = np.zeros((S_FULL, 2 + depth, W_FULL), dtype=np.uint32)

    def pack(bits):
        return np.packbits(bits, axis=-1, bitorder="little").view(np.uint32)

    def one(s):
        r = np.random.default_rng(int(seeds[s]))
        vals = r.integers(lo, hi + 1, size=width)
        exists = r.random(width) < share
        mag = np.where(exists, np.abs(vals), 0).astype("<u4")
        out[s, 0] = pack(exists)
        out[s, 1] = pack(exists & (vals < 0))
        # bit k of every magnitude: its little-endian bytes unpacked, one
        # transpose to [32, width]
        bits = np.unpackbits(mag.view(np.uint8).reshape(width, 4), axis=1, bitorder="little")
        out[s, 2:] = pack(np.ascontiguousarray(bits.T[:depth]))

    list(pool.map(one, range(S_FULL)))
    return out


def decode_bsi(holder, name, pool, into=None, shards=range(S_FULL), index="i"):
    """Every column's value of int field ``name`` (of ``index``), decoded from the host
    mirrors' rows with ``np.unpackbits`` one shard at a time: ``(values
    int64 [S, 2^20], exists bool [S, 2^20])``; with ``into``, those arrays
    again with only ``shards`` decoded anew. It reads the rows by id
    (exists 0, sign 1, plane k at 2 + k) and nothing of the port's BSI
    code."""
    import numpy as np

    f = holder.field(index, name)
    view = f.view("bsig_" + name)
    depth = f.bit_depth
    width = f.n_words * 32
    vals, ex = into if into is not None else (
        np.zeros((S_FULL, width), dtype=np.int64), np.zeros((S_FULL, width), dtype=bool))

    def unpack(words):
        return np.unpackbits(words.view(np.uint8), bitorder="little").astype(bool)

    def one(s):
        frag = view.fragment(s)
        if frag is None:
            return
        ids, mat = frag.rows_matrix_host()
        rows = dict(zip(ids, mat))
        zero = np.zeros(f.n_words, dtype=np.uint32)
        mag = np.zeros(width, dtype=np.int64)
        for k in range(depth):
            mag |= unpack(rows.get(2 + k, zero)).astype(np.int64) << k
        ex[s] = unpack(rows.get(0, zero))
        vals[s] = np.where(unpack(rows.get(1, zero)), -mag, mag)

    list(pool.map(one, shards))
    return vals, ex


def set_row_bits(holder, field, row, pool):
    """bool ``[S, 2^20]`` columns of row ``row`` of a set field's mirrors."""
    import numpy as np

    view = holder.field("i", field).view("standard")
    out = np.zeros((S_FULL, W_FULL * 32), dtype=bool)

    def one(s):
        frag = view.fragment(s)
        if frag is not None:
            out[s] = np.unpackbits(frag.row_words_host(row).view(np.uint8),
                                   bitorder="little").astype(bool)

    list(pool.map(one, range(S_FULL)))
    return out


def by_shard(pool, fn):
    """``[fn(s) for s in range(S_FULL)]``, shards in parallel on ``pool``."""
    return list(pool.map(fn, range(S_FULL)))


def truth_count(pool, mask):
    """Set columns of ``mask(s)`` (bool ``[2^20]``) over every shard."""
    import numpy as np

    return sum(by_shard(pool, lambda s: int(np.count_nonzero(mask(s)))))


def truth_sum(pool, vals, mask):
    """``(sum, count)`` of the values under ``mask(s)`` over every shard."""
    parts = by_shard(pool, lambda s: (int(vals[s][mask(s)].sum()), int(mask(s).sum())))
    return sum(p[0] for p in parts), sum(p[1] for p in parts)


def truth_extreme(pool, vals, mask, maximal):
    """``(extreme, count)`` of the values under ``mask(s)``: each shard's
    extreme and its count, then the extreme of those and the counts of the
    shards that reach it; ``(0, 0)`` when no column is set."""
    def one(s):
        live = vals[s][mask(s)]
        if not live.size:
            return None
        best = live.max() if maximal else live.min()
        return int(best), int((live == best).sum())

    parts = [p for p in by_shard(pool, one) if p is not None]
    if not parts:
        return 0, 0
    best = (max if maximal else min)(b for b, _ in parts)
    return best, sum(c for b, c in parts if b == best)


def truth_words(pool, mask):
    """uint32 ``[S, W]`` words of ``mask(s)`` over every shard."""
    import numpy as np

    return np.stack(by_shard(pool, lambda s: np.packbits(
        mask(s), bitorder="little").view(np.uint32)))


def truth_filtered_sums(f_mirror, vals, ex, rows, dev, pool, rng, k=8):
    """``[(sum, count)]`` of ``Sum(Row(f=r), field=...)`` for each r of
    ``rows``: the unpacked rows of f (``f_mirror``, from the host mirrors)
    times the decoded values and the exists column, in float64 on the card
    (exact: every partial sum is an integer below 2^53); no code of the
    port runs. A seeded sample of ``k`` rows is recounted with numpy on the
    int64 values."""
    import numpy as np
    import torch

    vals_d = torch.from_numpy(np.where(ex, vals, 0)).to(dev)
    ex_d = torch.from_numpy(ex).to(dev)
    words_d = torch.from_numpy(np.ascontiguousarray(f_mirror[:, rows]).view(np.int32)).to(dev)
    shifts = torch.arange(32, dtype=torch.int32, device=dev)
    acc = torch.zeros((len(rows), 2), dtype=torch.float64, device=dev)
    for s in range(S_FULL):
        bits = ((words_d[s, :, :, None] >> shifts) & 1).reshape(len(rows), -1)
        acc += bits.to(torch.float64) @ torch.stack([vals_d[s], ex_d[s]], dim=1).to(torch.float64)
    truth = [(int(a), int(b)) for a, b in torch.round(acc).to(torch.int64).tolist()]
    del vals_d, ex_d, words_d

    pick = sorted(int(i) for i in rng.choice(len(rows), size=min(k, len(rows)), replace=False))

    def one(s):
        ve = np.where(ex[s], vals[s], 0)
        out = []
        for i in pick:
            m = np.unpackbits(f_mirror[s, rows[i]].view(np.uint8), bitorder="little").view(bool)
            out.append((int(ve[m].sum()), int(ex[s][m].sum())))
        return out

    parts = by_shard(pool, one)
    for j, i in enumerate(pick):
        want = (sum(p[j][0] for p in parts), sum(p[j][1] for p in parts))
        if truth[i] != want:
            raise AssertionError(f"filtered-sum truth of row {rows[i]}: card {truth[i]}, "
                                 f"numpy {want}")
    return truth


def bsi_path(pool, ex, holder, device, keep=None):
    """The BSI path at the serving size: a lone Count(Row(v < 500000)) cold
    (the host tier, no launch) until the warm-up builds the stack, then on
    the card and from the aggregate cache; a `><` bitmap; one execute_batch
    of 128 range Counts (one count launch); Sum unfiltered (then cached),
    filtered, a batch of 64 filtered Sums (one bsi_sum_batch launch, f's
    rows read in place from its resident stack), the same 64 as lone
    queries (one bsi_sum launch each), and a batch of 8 Sums filtered by
    trees made on the host (one launch); Min/Max of v and w, unfiltered and
    filtered;
    MinRow/MaxRow of f; a GroupBy of f and g filtered by Row(v > 250000)
    (one words launch, then the GroupBy kernels); then Set/Clear writes to
    v and w, each seen by the next Range, Sum and Min/Max. Every answer
    equals numpy on values decoded from the host mirrors, which go into
    ``keep`` (by field) as they stand after the writes."""
    import numpy as np
    import torch

    from pilosa_tpu_torch.ops import bitops, kernels as tk
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    on_card = torch.device(device).type == "cuda"
    qrng = np.random.default_rng(SEED + 9)
    lat = {"served_s": 0.0}
    t0 = time.perf_counter()
    truth = {n: decode_bsi(holder, n, pool) for n in BSI_FIELDS}
    lat["truth_decode_s"] = time.perf_counter() - t0
    for n in BSI_FIELDS:
        if holder.field("i", n).bit_depth != BSI_DEPTH:
            raise AssertionError(f"{n}: depth {holder.field('i', n).bit_depth}")

    def serve(q, launches, batch=None):
        """``(results, ms)`` of ``q`` (or of ``execute_batch`` over
        ``batch``); on the card, the BSI launches must be ``launches``
        (kernels it does not name: none; None: any number)."""
        before = dict(tk.LAUNCHES)
        t = time.perf_counter()
        if batch is None:
            res = ex.execute("i", q)
        else:
            res = ex.execute_batch("i", [(x, None) for x in batch])
            bad = [r for r in res if isinstance(r, Exception)]
            if bad:
                raise AssertionError(f"{batch[0]}...: {bad[0]!r}")
            res = [r[0] for r in res]
        ms = (time.perf_counter() - t) * 1e3
        lat["served_s"] += ms / 1e3
        made = {k: tk.LAUNCHES[k] - before[k]
                for k in ("bsi_range", "bsi_sum", "bsi_extreme", "bsi_sum_batch")}
        want = None if launches is None else {k: launches.get(k, 0) for k in made}
        if on_card and want is not None and made != want:
            raise AssertionError(f"{q or batch[0]}: BSI launches {made}, not {want}")
        return res, ms

    def check(what, got, want):
        if got != want:
            raise AssertionError(f"{what}: {got} != {want}")

    def valcount(r):
        return (r.value, r.count)

    def reads_round(tag, fresh, vals, exv, valw, exw):
        """Range, Sum and Min/Max of v and w against the truth: each one
        launch when ``fresh`` (a new snapshot), else from the cache (the
        count is the batch's last, which the cache keeps: it holds
        Executor._BSI_AGG_SLOTS scalars, and the batch's 128 counts pushed
        the lone count out)."""
        for label, q, kernel, want in (
            ("count", f"Count(Row(v <= {ts[-1]}))", "bsi_range",
             truth_count(pool, lambda s: exv[s] & (vals[s] <= ts[-1]))),
            ("sum_v", "Sum(field=v)", "bsi_sum", truth_sum(pool, vals, lambda s: exv[s])),
            ("max_v", "Max(field=v)", "bsi_extreme",
             truth_extreme(pool, vals, lambda s: exv[s], True)),
            ("min_w", "Min(field=w)", "bsi_extreme",
             truth_extreme(pool, valw, lambda s: exw[s], False)),
        ):
            (r,), ms = serve(q, {kernel: 1} if fresh else {})
            check(f"{tag} {q}", r if isinstance(r, int) else valcount(r), want)
            lat[f"{tag}_{label}_ms"] = ms

    vals, exv = truth["v"]
    valw, exw = truth["w"]

    # -- a lone range count: cold on the host, the warm-up, the card, the cache
    q = "Count(Row(v < 500000))"
    want = truth_count(pool, lambda s: exv[s] & (vals[s] < 500_000))
    cold = []
    for _ in range(ex._BSI_SINGLE_WARM - 1):
        rebuilds = ex.stack_rebuilds
        (n,), ms = serve(q, {})
        check("cold count", n, want)
        cold.append(ms)
        if ex.stack_rebuilds != rebuilds:
            raise AssertionError("a cold lone count built the stack")
    lat["count_cold_ms"] = cold
    rebuilds = ex.stack_rebuilds
    (n,), lat["count_warmup_ms"] = serve(q, {"bsi_range": 1})
    check("warm-up count", n, want)
    if ex.stack_rebuilds != rebuilds + 1:
        raise AssertionError("the warm-up did not build the stack")
    (n,), lat["count_warm_ms"] = serve(q, {"bsi_range": 1})
    check("warm count", n, want)
    hits = ex.bsi_agg_cache_hits
    (n,), lat["count_cached_ms"] = serve(q, {})
    check("cached count", n, want)
    if ex.bsi_agg_cache_hits != hits + 1:
        raise AssertionError("a repeat count missed the aggregate cache")

    # -- a bitmap
    (row,), lat["bitmap_between_ms"] = serve("Row(v >< [250000, 750000])", {"bsi_range": 1})
    want_words = truth_words(pool, lambda s: exv[s] & (vals[s] >= 250_000)
                             & (vals[s] <= 750_000))
    for s in range(S_FULL):
        if not np.array_equal(row.segments[s], want_words[s]):
            raise AssertionError(f"Row(v >< [250000, 750000]) shard {s} words differ")

    # -- the bench's flight: 128 range counts, one launch
    ts = [int((i + 0.5) * 1_000_001 / BSI_Q) for i in range(BSI_Q)]
    counts, lat["batch_counts_ms"] = serve(
        None, {"bsi_range": 1}, batch=[f"Count(Row(v <= {t}))" for t in ts])
    cum = np.cumsum(sum(by_shard(pool, lambda s: np.bincount(vals[s][exv[s]],
                                                             minlength=1_000_001))))
    check(f"{BSI_Q} range counts", counts, [int(cum[t]) for t in ts])

    # -- Sum: unfiltered (then cached), filtered, a batch of filtered Sums
    (s,), lat["sum_ms"] = serve("Sum(field=v)", {"bsi_sum": 1})
    want = truth_sum(pool, vals, lambda s: exv[s])
    check("sum", valcount(s), want)
    (s,), lat["sum_cached_ms"] = serve("Sum(field=v)", {})
    check("cached sum", valcount(s), want)
    f3 = set_row_bits(holder, "f", 3, pool)
    (s,), lat["sum_filtered_ms"] = serve("Sum(Row(f=3), field=v)", {"bsi_sum": 1})
    check("filtered sum", valcount(s), truth_sum(pool, vals, lambda s: exv[s] & f3[s]))
    # a flight of filtered Sums: one bsi_sum_batch launch reading f's rows
    # in place from its resident stack
    shards = list(range(S_FULL))
    if not ex._stack_cached(holder.field("i", "f"), shards):
        serve("Count(Intersect(Row(f=0), Row(f=1))) Count(Union(Row(f=2), Row(f=3)))", None)
        log("bsi: f's stack was not resident; a pair batch built it")
    if not ex._stack_cached(holder.field("i", "f"), shards):
        raise AssertionError("bsi: f's stack is not resident for the flight")
    flight = [f"Sum(Row(f={r}), field=v)" for r in range(BSI_SUMS)]
    sums, lat["batch_sums_ms"] = serve(None, {"bsi_sum_batch": 1}, batch=flight)
    f_mirror = mirror_stack(holder, "f", R_FULL + 1, S_FULL)
    want_sums = truth_filtered_sums(f_mirror, vals, exv, list(range(BSI_SUMS)),
                                    torch.device(device), pool, qrng)
    check(f"{BSI_SUMS} filtered sums", [valcount(x) for x in sums], want_sums)
    # the route the flight had before: the same Sums one at a time, each
    # filter made on the host and one bsi_sum launch
    t = time.perf_counter()
    lone = [valcount(serve(q, {"bsi_sum": 1})[0][0]) for q in flight]
    lat["lone_sums_ms"] = (time.perf_counter() - t) * 1e3
    check(f"{BSI_SUMS} lone filtered sums", lone, want_sums)
    # 8 Sums whose filters are trees, made on the host: one launch
    # (twice: the first flight also pins its host buffer)
    g_mirror = mirror_stack(holder, "g", R_FULL, S_FULL)
    tree_flight = [f"Sum(Intersect(Row(f={r}), Row(g={r + 1})), field=v)" for r in range(8)]
    trees, lat["batch_tree_sums_ms"] = serve(None, {"bsi_sum_batch": 1}, batch=tree_flight)
    again, lat["batch_tree_sums_again_ms"] = serve(None, {"bsi_sum_batch": 1}, batch=tree_flight)
    want_trees = truth_filtered_sums(f_mirror[:, :8] & g_mirror[:, 1:9], vals, exv,
                                     list(range(8)), torch.device(device), pool, qrng, k=2)
    check("8 tree-filtered sums", [valcount(x) for x in trees], want_trees)
    check("8 tree-filtered sums again", [valcount(x) for x in again], want_trees)

    # -- Min/Max, unfiltered and filtered; MinRow/MaxRow of f
    g5 = set_row_bits(holder, "g", 5, pool)
    for label, q, (vv, mask, maximal) in (
        ("min_v", "Min(field=v)", (vals, lambda s: exv[s], False)),
        ("max_v", "Max(field=v)", (vals, lambda s: exv[s], True)),
        ("min_w", "Min(field=w)", (valw, lambda s: exw[s], False)),
        ("max_w", "Max(field=w)", (valw, lambda s: exw[s], True)),
        ("min_v_filtered", "Min(Row(f=3), field=v)", (vals, lambda s: exv[s] & f3[s], False)),
        ("max_w_filtered", "Max(Row(g=5), field=w)", (valw, lambda s: exw[s] & g5[s], True)),
    ):
        (r,), lat[f"{label}_ms"] = serve(q, {"bsi_extreme": 1})
        check(q, valcount(r), truth_extreme(pool, vv, mask, maximal))
    f_counts = np.bitwise_count(f_mirror).sum(axis=(0, 2), dtype=np.int64)
    live = np.flatnonzero(f_counts)
    for label, q, rid in (("minrow", "MinRow(field=f)", live.min()),
                          ("maxrow", "MaxRow(field=f)", live.max())):
        (p,), lat[f"{label}_ms"] = serve(q, {})
        check(q, (p.id, p.count), (int(rid), int(f_counts[rid])))

    # -- a GroupBy filtered by a condition: one words launch, then the
    #    GroupBy kernels; every combination against torch on the card, a
    #    sample against numpy
    filt_np = truth_words(pool, lambda s: exv[s] & (vals[s] > 250_000))
    (groups,), lat["groupby_filtered_ms"] = serve(
        "GroupBy(Rows(f), Rows(g), filter=Row(v > 250000))", {"bsi_range": 1})
    answer = [(tuple(fr.row_id for fr in gc.group), gc.count) for gc in groups]
    dev = torch.device(device)
    want_groups = truth_groupby([bitops.to_device(f_mirror, dev), bitops.to_device(g_mirror, dev)],
                                bitops.to_device(filt_np, dev))
    if answer != want_groups:
        raise AssertionError("filtered GroupBy differs from the torch truth")
    checked = check_numpy_sample("GroupBy filtered by v", answer, [f_mirror, g_mirror], filt_np,
                                 pool, qrng)
    del f_mirror, g_mirror
    if on_card:
        torch.cuda.empty_cache()

    reads_round("cached", False, vals, exv, valw, exw)

    # -- writes to v and w in a few shards (the stacks are patched), each
    #    seen by the next Range, Sum and Min/Max
    held_v = np.flatnonzero(exv[7])
    held_w = np.flatnonzero(exw[11])
    cols = {
        "set_v_max": 3 * SHARD_WIDTH + int(qrng.integers(0, SHARD_WIDTH)),
        "set_v_zero": 5 * SHARD_WIDTH + int(qrng.integers(0, SHARD_WIDTH)),
        "clear_v": 7 * SHARD_WIDTH + int(held_v[int(qrng.integers(0, len(held_v)))]),
        "set_w_min": 11 * SHARD_WIDTH + int(qrng.integers(0, SHARD_WIDTH)),
        "clear_w": 11 * SHARD_WIDTH + int(held_w[int(qrng.integers(0, len(held_w)))]),
    }
    writes = (f"Set({cols['set_v_max']}, v=1000000) Set({cols['set_v_zero']}, v=0) "
              f"Clear({cols['clear_v']}, v=0) Set({cols['set_w_min']}, w=-1000000) "
              f"Clear({cols['clear_w']}, w=5)")
    patched, rebuilt = ex.stack_incremental, ex.stack_rebuilds
    t = time.perf_counter()
    ex.execute("i", writes)
    lat["writes_ms"] = (time.perf_counter() - t) * 1e3
    fv, fw = holder.field("i", "v"), holder.field("i", "w")
    check("written values", (fv.value(cols["set_v_max"]), fv.value(cols["set_v_zero"]),
                             fv.value(cols["clear_v"]), fw.value(cols["set_w_min"]),
                             fw.value(cols["clear_w"])),
          ((1_000_000, True), (0, True), (0, False), (-1_000_000, True), (0, False)))
    # the written shards decoded anew from the mirrors
    written = sorted({c // SHARD_WIDTH for c in cols.values()})
    truth = {n: decode_bsi(holder, n, pool, into=truth[n], shards=written) for n in BSI_FIELDS}
    if keep is not None:
        keep.update(truth)
    reads_round("after_writes", True, *truth["v"], *truth["w"])
    if (ex.stack_incremental - patched, ex.stack_rebuilds - rebuilt) != (2, 0):
        raise AssertionError(f"after the writes: stack_incremental +"
                             f"{ex.stack_incremental - patched}, stack_rebuilds +"
                             f"{ex.stack_rebuilds - rebuilt}, not +2 and +0")
    log(f"bsi: a lone Count(Row(v < 500000)) cold on the host "
        f"{', '.join(f'{x:.0f}' for x in cold)} ms, the warm-up (stack build and launch) "
        f"{lat['count_warmup_ms']:.0f} ms, warm {lat['count_warm_ms']:.1f} ms, cached "
        f"{lat['count_cached_ms']:.2f} ms; {BSI_Q} range counts in one launch "
        f"{lat['batch_counts_ms']:.1f} ms; Sum {lat['sum_ms']:.1f} ms (cached "
        f"{lat['sum_cached_ms']:.2f}), filtered {lat['sum_filtered_ms']:.1f} ms, "
        f"{BSI_SUMS} filtered Sums in a batch {lat['batch_sums_ms']:.1f} ms (one "
        f"bsi_sum_batch launch, f's rows in place; as {BSI_SUMS} lone queries "
        f"{lat['lone_sums_ms']:.1f} ms), 8 Sums filtered by trees made on the host in a "
        f"batch {lat['batch_tree_sums_ms']:.1f} ms (one launch; again "
        f"{lat['batch_tree_sums_again_ms']:.1f} ms); Max(v) "
        f"{lat['max_v_ms']:.1f} ms; GroupBy filtered by v {lat['groupby_filtered_ms']:.0f} ms "
        f"({checked} combinations sampled against numpy); writes seen by the next Range, "
        f"Sum and Min/Max (stacks patched); every answer equals numpy; queries "
        f"{lat['served_s']:.1f} s of the path, the truth decoded in "
        f"{lat['truth_decode_s']:.1f} s")
    return lat


# ---------------------------------------------------------------------------
# The mesh path: the multi-device layer on the one card
# ---------------------------------------------------------------------------

# slices of the local mesh on the one card, and the writes between rounds
MESH_SLICES = 4
MESH_WRITES = 64
# the two gloo ranks' job: shards, rows and words (each rank owns half),
# and the seconds each rank may take
MESH_RANK_SHARDS = S_FULL
MESH_RANK_TIMEOUT = 300
# the NCCL probe's seconds
MESH_NCCL_TIMEOUT = 120


def mesh_answer(r):
    """A result of either executor as comparable data; a Row as its words
    by shard."""
    if isinstance(r, list):
        return [mesh_answer(x) for x in r]
    if hasattr(r, "segments"):
        return ("row", {s: bytes(memoryview(w)) for s, w in sorted(r.segments.items())})
    if hasattr(r, "group"):
        return ("group", tuple(fr.row_id for fr in r.group), int(r.count))
    if hasattr(r, "id") and hasattr(r, "count"):
        return ("pair", int(r.id), int(r.count))
    if hasattr(r, "value"):
        return ("valcount", int(r.value), int(r.count))
    return int(r)


def mesh_truths(pool, holder, device, decoded, reads, args):
    """Each read's answer from the host mirrors, in :func:`mesh_answer`'s
    form: the set fields' rows copied to the card and counted there with
    torch AND and popcount (:func:`popcount_rows`, :func:`truth_groupby`),
    the Union's words and the BSI answers in numpy on the host (v decoded
    from the mirrors); no code of the port runs."""
    import numpy as np
    import torch

    from pilosa_tpu_torch.ops import bitops

    mirrors = {"f": mirror_stack(holder, "f", R_FULL + 1, S_FULL),
               "g": mirror_stack(holder, "g", R_FULL, S_FULL),
               "h": mirror_stack(holder, "h", H_ROWS, S_FULL)}
    f, g, h = (bitops.to_device(mirrors[n], torch.device(device)) for n in "fgh")
    vals, exv = decoded["v"]

    def popc(x):  # set bits of each row of x [S, ..., W], summed over shards
        return popcount_rows(x.clone(memory_format=torch.contiguous_format)).sum(dim=0)

    def rows_under(filt):  # each row of f's count under filt [S, W] (None: all)
        return popc(f if filt is None else f & filt[:, None]).tolist()

    def top(counts, n):
        keep = sorted(((r, c) for r, c in enumerate(counts) if c), key=lambda p: (-p[1], p[0]))
        return [("pair", r, c) for r, c in keep[:n]]

    def tanimoto(g_row, threshold, n):
        inter, tot = rows_under(g[:, g_row]), rows_under(None)
        src = int(popc(g[:, g_row]))
        keep = [(r, c) for r, c in enumerate(inter)
                if c >= 1 and tot[r] + src - c > 0 and c * 100 >= threshold * (tot[r] + src - c)]
        keep.sort(key=lambda p: (-p[1], p[0]))
        return [("pair", r, c) for r, c in keep[:n]]

    a, b, c, hr = args["rows"]
    ops = {"Intersect": torch.bitwise_and, "Union": torch.bitwise_or,
           "Xor": torch.bitwise_xor, "Difference": lambda x, y: x & ~y}
    out = {
        "topn_filtered": [top(rows_under(g[:, 1]), 5)],
        "topn_tanimoto": [tanimoto(2, 10, 5)],
        "topn": [top(rows_under(None), 5)],
        "pairs": [int(popc(ops[op](f[:, x], f[:, y]))) for op, x, y in args["pairs"]],
        "intersect3": [int(popc(f[:, a] & g[:, b] & h[:, hr])),
                       int(popc(f[:, b] & g[:, c] & h[:, (hr + 1) % H_ROWS]))],
        "union_bitmap": [("row", {s: bytes(memoryview(mirrors["f"][s, a] | mirrors["g"][s, c]))
                                  for s in range(S_FULL)})],
        "bsi_range": [truth_count(pool, lambda s: exv[s] & (vals[s] < 500000)),
                      truth_count(pool, lambda s: exv[s] & (vals[s] > 250000))],
        "bsi_sum": [("valcount", *truth_sum(pool, vals, lambda s: exv[s]))],
        "bsi_minmax": [("valcount", *truth_extreme(pool, vals, lambda s: exv[s], False)),
                       ("valcount", *truth_extreme(pool, vals, lambda s: exv[s], True))],
        "bsi_sum_flight": [("valcount", *vc) for vc in truth_filtered_sums(
            mirrors["f"], vals, exv, list(range(BSI_SUMS)), torch.device(device), pool,
            np.random.default_rng(SEED + 19), k=2)],
        "groupby": [[("group", combo, n) for combo, n in truth_groupby([f, g])]],
        "groupby3_filtered": [[("group", combo, n) for combo, n in
                               truth_groupby([h, g, f], h[:, 1])]],
    }
    del f, g, h
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    assert set(out) == set(reads), sorted(set(reads) ^ set(out))
    return out


def mesh_local(pool, holder, device, decoded, on_timed=None):
    """(a) A mesh of MESH_SLICES slices on the one card
    (``configure_serving(devices=[cuda:0] * 4)``) and a new executor over
    the served holder, beside a new single-device executor on it: the main
    path's reads on both, in turns, each answer equal between them and to
    the host mirrors' truth, each kernel launched MESH_SLICES times as
    often on the mesh; then MESH_WRITES writes to f, g and h and 4 to v,
    and the same reads again. Every stack of the mesh's executor is
    MESH_SLICES slices of S_FULL / MESH_SLICES shards. The stack build and
    a warm batch on the host clock, against the single-device executor's;
    ``on_timed()`` runs once they are timed."""
    import gc

    import numpy as np
    import torch

    from pilosa_tpu_torch.ops import kernels as tk
    from pilosa_tpu_torch.parallel import mesh as mesh_mod
    from pilosa_tpu_torch.parallel import sharded
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card and dev.index is None:
        dev = torch.device("cuda", 0)
    slices = [dev] * MESH_SLICES
    qrng = np.random.default_rng(SEED + 18)
    one, four = kernel_executor(holder), kernel_executor(holder)

    def mesh(ex):
        """Serve ``ex`` on its layout: the mesh for ``four``, none for
        ``one`` (both resolve the serving mesh at each stack build)."""
        mesh_mod.configure_serving(None, devices=slices if ex is four else None)

    rows = [int(x) for x in qrng.integers(0, R_FULL, 3)] + [int(qrng.integers(0, H_ROWS))]
    a, b, c, hr = rows
    pairs = [(OPS[int(qrng.integers(0, 4))], int(qrng.integers(0, R_FULL)),
              int(qrng.integers(0, R_FULL))) for _ in range(64)]
    # the order makes the tanimoto TopN's row totals a row scan (the pair
    # batch after it caches f's full gram, whose diagonal would serve them)
    reads = {
        "topn_filtered": "TopN(f, Row(g=1), n=5)",
        "topn_tanimoto": "TopN(f, Row(g=2), tanimotoThreshold=10, n=5)",
        "topn": "TopN(f, n=5)",
        "pairs": " ".join(f"Count({op}(Row(f={x}), Row(f={y})))" for op, x, y in pairs),
        "groupby": "GroupBy(Rows(f), Rows(g))",
        "groupby3_filtered": "GroupBy(Rows(h), Rows(g), Rows(f), filter=Row(h=1))",
        "intersect3": (f"Count(Intersect(Row(f={a}), Row(g={b}), Row(h={hr}))) "
                       f"Count(Intersect(Row(f={b}), Row(g={c}), Row(h={(hr + 1) % H_ROWS})))"),
        "union_bitmap": f"Union(Row(f={a}), Row(g={c}))",
        "bsi_range": "Count(Row(v < 500000)) Count(Row(v > 250000))",
        "bsi_sum": "Sum(field=v)",
        "bsi_minmax": "Min(field=v) Max(field=v)",
        # the bsi path's flight: f's rows in place from its resident stack
        "bsi_sum_flight": " ".join(f"Sum(Row(f={r}), field=v)" for r in range(BSI_SUMS)),
    }
    args = {"rows": rows, "pairs": pairs}
    lat = {}
    shards = list(range(S_FULL))

    def timed_build(ex, name):
        mesh(ex)
        if on_card:
            torch.cuda.synchronize()
        t = time.perf_counter()
        got = ex._field_stack(holder.field("i", name), shards)
        if on_card:
            torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3, got[1]

    lat["stack_build_one_ms"], _ = timed_build(one, "g")
    lat["stack_build_mesh_ms"], g4 = timed_build(four, "g")
    if not (sharded.is_sharded(g4) and len(g4.slices) == MESH_SLICES):
        raise AssertionError(f"mesh: g's stack is {g4!r}")

    def round_(tag):
        truths = mesh_truths(pool, holder, device, decoded, reads, args)
        launched = {}
        for name, q in reads.items():
            got = {}
            for ex in (one, four):
                mesh(ex)
                before = dict(tk.LAUNCHES)
                t = time.perf_counter()
                got[ex is four] = mesh_answer(ex.execute("i", q))
                lat[f"{tag}_{name}_{'mesh' if ex is four else 'one'}_ms"] = (
                    time.perf_counter() - t) * 1e3
                launched[ex is four] = {k: tk.LAUNCHES[k] - before[k] for k in tk.LAUNCHES}
            if got[True] != got[False]:
                raise AssertionError(f"mesh {tag}: {name}: the mesh's answer differs from "
                                     "the single-device executor's")
            if got[True] != truths[name]:
                raise AssertionError(f"mesh {tag}: {name}: the answer differs from the "
                                     "mirrors' truth")
            want = {k: MESH_SLICES * n for k, n in launched[False].items()}
            if on_card and launched[True] != want:
                raise AssertionError(f"mesh {tag}: {name} launched {launched[True]} on the "
                                     f"mesh, not {want} ({MESH_SLICES} x one device's)")
            log(f"mesh {tag}: {name}: equal on both and to the truth; launches "
                f"{ {k: n for k, n in launched[True].items() if n} } on the mesh")
        mesh(four)
        stacks = [e["dev"] for caches in four._stacks.values() for e in caches.values()]
        per = S_FULL // MESH_SLICES
        bad = [s for s in stacks if not sharded.is_sharded(s) or len(s.slices) != MESH_SLICES
               or any(t.shape[0] != per for t in s.slices)]
        if not stacks or bad:
            raise AssertionError(f"mesh {tag}: stacks not {MESH_SLICES} slices of {per} "
                                 f"shards: {bad[:2]}")
        lat[f"{tag}_stacks"] = len(stacks)

    try:
        round_("before_writes")
        # warm batches: every read again in one execute_batch, three times
        for ex in (one, four):
            mesh(ex)
            times = []
            for _ in range(3):
                t = time.perf_counter()
                res = ex.execute_batch("i", [(q, None) for q in reads.values()])
                times.append((time.perf_counter() - t) * 1e3)
                if any(isinstance(r, Exception) for r in res):
                    raise AssertionError(f"mesh: a warm batch failed: {res}")
            lat[f"warm_batch_{'mesh' if ex is four else 'one'}_ms"] = statistics.median(times)
        if on_timed is not None:
            on_timed()
        mesh(four)
        lat["writes_ms"] = apply_writes(four, holder, qrng, ("f", "g", "h"), MESH_WRITES)
        vcols = [int(x) for x in qrng.choice(S_FULL * SHARD_WIDTH, 4, replace=False)]
        four.execute("i", " ".join(f"Set({col}, v={int(qrng.integers(0, 1_000_000))})"
                                   for col in vcols))
        decode_bsi(holder, "v", pool, into=decoded["v"],
                   shards=sorted({col // SHARD_WIDTH for col in vcols}))
        round_("after_writes")
        lat["stack_incremental"] = four.stack_incremental
    finally:
        mesh_mod.configure_serving(None)
        # the two executors' stacks leave the card and the budget before
        # the budget path counts them
        for ex in (one, four):
            ex.release_stacks()
        del one, four
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    if mesh_mod.serving_mesh() is not None:
        raise AssertionError("mesh: configure_serving(None) left a serving mesh on one card")
    log(f"mesh (a): {MESH_SLICES} slices on {dev}: every read equal to one device's and "
        f"to the truth, {MESH_SLICES} x the launches; g's stack built in "
        f"{lat['stack_build_mesh_ms']:.1f} ms on the mesh, {lat['stack_build_one_ms']:.1f} ms "
        f"on one device; a warm batch of the reads {lat['warm_batch_mesh_ms']:.1f} ms on the "
        f"mesh, {lat['warm_batch_one_ms']:.1f} ms on one device; patches "
        f"{lat['stack_incremental']}")
    return lat


def mesh_gloo(device):
    """(b) Two processes on the one card over gloo, each rank the worker of
    ``pilosa_tpu_torch.testing.multihost`` with CUDA tensors and the hand
    kernels: it owns the shards with ``shard % 2 == rank`` of
    MESH_RANK_SHARDS (R_FULL rows, W_FULL words), answers the executor's
    reads on them and reduces them across the ranks, then runs the
    spanning checks; each against the seed's truth. Fails on a non-zero
    exit or a timeout."""
    import tempfile

    build = HERE / "build"
    build.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=build, prefix="mesh-pg-") as tmp:
        env = dict(os.environ, PYTHONPATH=str(HERE))
        procs = [subprocess.Popen(
            [sys.executable, "-m", "pilosa_tpu_torch.testing.multihost", "--rank", str(rank),
             "--init", f"file://{tmp}/store", "--device", device, "--backend", "gloo",
             "--shards", str(MESH_RANK_SHARDS), "--rows", str(R_FULL),
             "--words", str(W_FULL), "--seed", str(SEED)],
            cwd=HERE, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ) for rank in (0, 1)]
        outs = ["", ""]
        try:
            for k, p in enumerate(procs):
                outs[k], _ = p.communicate(timeout=MESH_RANK_TIMEOUT)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
                p.communicate()
            raise AssertionError(f"mesh (b): a rank took over {MESH_RANK_TIMEOUT} s")
    for k, (p, out) in enumerate(zip(procs, outs)):
        for line in out.splitlines()[-12:]:
            log(f"  rank {k}: {line}")
        if p.returncode != 0 or f"proc{k} OK" not in out:
            raise AssertionError(f"mesh (b): rank {k} exited {p.returncode}")
    secs = time.perf_counter() - t0
    log(f"mesh (b): two ranks over gloo on one card passed the spanning checks in {secs:.1f} s")
    return {"seconds": secs}


def mesh_nccl(device):
    """(c) ``init_multihost()`` with the default backend in a job of one
    rank: NCCL forms its group on the card, one ``all_reduce`` sums, and
    the mesh reads as not spanning. NCCL across cards needs two of them."""
    import socket

    with socket.socket() as so:
        so.bind(("127.0.0.1", 0))
        port = so.getsockname()[1]
    probe = (
        "import torch\n"
        "from pilosa_tpu_torch.parallel import mesh as m\n"
        f"g = m.init_multihost('tcp://127.0.0.1:{port}', 1, 0)\n"
        "d = torch.distributed\n"
        "assert d.get_backend() == 'nccl', d.get_backend()\n"
        "assert not m.mesh_spans_processes(g) and g.size == torch.cuda.device_count(), g\n"
        "t = torch.arange(4, device='cuda', dtype=torch.int64)\n"
        "d.all_reduce(t)\n"
        "assert t.tolist() == [0, 1, 2, 3], t\n"
        "d.destroy_process_group()\n"
        "print('nccl OK', g.devices)\n"
    )
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", probe], cwd=HERE, capture_output=True, text=True,
                       env=dict(os.environ, PYTHONPATH=str(HERE)), timeout=MESH_NCCL_TIMEOUT)
    if r.returncode != 0 or "nccl OK" not in r.stdout:
        raise AssertionError(f"mesh (c): the one-rank NCCL group failed: {r.stdout}{r.stderr}")
    secs = time.perf_counter() - t0
    log(f"mesh (c): {r.stdout.strip()}, one rank, default backend, in {secs:.1f} s")
    return {"seconds": secs}


def mesh_path(pool, holder, device, decoded):
    """The mesh path: (a) :func:`mesh_local`; (b) :func:`mesh_gloo` and (c)
    :func:`mesh_nccl` (on the card only) in their own processes, started
    once (a) has timed its stack build and warm batch, beside the rest of
    it."""
    import torch

    out = {}
    with ThreadPoolExecutor(max_workers=2) as bg:
        started = {}

        def start():
            if torch.device(device).type == "cuda":
                started["gloo"] = bg.submit(mesh_gloo, device)
                started["nccl"] = bg.submit(mesh_nccl, device)

        out["local"] = mesh_local(pool, holder, device, decoded, on_timed=start)
        for k, fut in started.items():
            out[k] = fut.result()
    return out


# ---------------------------------------------------------------------------
# The budget path: the device-memory budget at the serving size
# ---------------------------------------------------------------------------

# lone cold pair Counts timed on the host tier, and (row, column) pairs of
# the timed import into one fragment
HOST_TIER_REPS = 5
IMPORT_PAIRS = 1 << 20


def budget_truths(pool, holder, dev, v_truth):
    """Every truth the budget path holds its answers to, computed once from
    the host mirrors before it runs (no write happens in the path): pair
    counts, a tanimoto TopN and a tree Count with numpy, the GroupBys with
    torch AND and popcount on the card (the stacks uploaded for it freed
    again; the filtered 3-level one only as far as its limit needs) and
    w's existence row counted; v's values are ``v_truth``, as the bsi path
    decoded them from the mirrors after its writes. No code of the port
    runs."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    qrng = np.random.default_rng(SEED + 11)
    # the trees path created row R_FULL of f in one shard
    f_rows = 1 + max(max(frag.row_ids())
                     for frag in holder.field("i", "f").view("standard").fragments.values())
    m = {name: mirror_stack(holder, name, n_rows, S_FULL)
         for name, n_rows in (("f", f_rows), ("g", R_FULL), ("h", H_ROWS))}
    t = {"f_rows": f_rows, "seconds": {"mirrors": time.perf_counter() - t0}}
    t0 = time.perf_counter()
    t["items"] = {
        fld: [(OPS[int(qrng.integers(0, 4))], int(qrng.integers(0, m[fld].shape[1])),
               int(qrng.integers(0, m[fld].shape[1]))) for _ in range(64)]
        for fld in ("f", "g")
    }
    t["pairs"] = {fld: truth_pair_counts(m[fld], items, pool)
                  for fld, items in t["items"].items()}
    t["lone"] = t["items"]["f"][0], t["pairs"]["f"][0]
    t["g_row"] = int(qrng.integers(0, R_FULL))
    t["topn"] = truth_tanimoto_topn(m["f"], m["g"], t["g_row"], 10, 10, pool)
    t["tree"] = int(sum(by_shard(pool, lambda s: int(np.bitwise_count(
        m["f"][s, 1] & m["g"][s, 2] & m["h"][s, 3]).sum(dtype=np.int64)))))
    t["w_notnull"] = int(sum(by_shard(pool, lambda s: int(np.bitwise_count(
        holder.field("i", "w").view("bsig_w").fragment(s).row_words_host(0)).sum()))))
    t["seconds"]["numpy"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with torch.no_grad():
        up = {k: torch.from_numpy(v.view(np.int32)).to(dev) for k, v in m.items()}
        t["groupby_fg"] = truth_groupby([up["f"], up["g"]])
        hgf = []
        for hr in range(H_ROWS):  # depth first, until the limit of 20 is met
            for gr in range(R_FULL):
                if len(hgf) < 20:
                    hgf.extend(((hr, gr) + c[0], c[1]) for c in truth_groupby(
                        [up["f"]], filt=up["h"][:, hr] & up["g"][:, gr] & up["g"][:, 3]))
        t["groupby_hgf20"] = hgf[:20]
        del up
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    t["seconds"]["groupby"] = time.perf_counter() - t0
    t["v"] = v_truth
    return t, m


def budget_path(pool, ex_main, holder, device, v_truth):
    """The device-memory budget at the serving size (``core/membudget.py``;
    the process budget configured through ``membudget.configure`` and
    restored after). The reference answers first: the declined phase's
    reads on ``ex_main``, the executor of the other paths, with no cap.
    Then a fresh executor whose lone conditions take the stack at once
    (``_BSI_SINGLE_WARM = 0``) serves, with its stacks admitted to the
    budget:

    * eviction phase: a cap of f's and g's stacks and half of v's, so f's
      and g's do not both fit beside v's: 64-call pair batches on f and
      on g, a 2-level GroupBy f x g, range Counts on v and w, and f's
      pair batch again; then a shrink of the cap (``set_cap``), which must
      free on the card at least the bytes it evicts;
    * declined phase: the cap below one BSI stack, so the stacks of f, g,
      v and w are declined and each fragment's copy cycles through the
      budget: a lone pair Count (the native host tier), a 64-call pair
      batch, a filtered TopN, 2-level GroupBys with a limit and with
      `previous`, a 3-level GroupBy with a filter, a tree Count, and on v
      a range Count, a `><` bitmap, Sum, Min and Max (each BSI read one
      launch per fragment).

    After every query its answer equals its truth (and, declined, the
    reference answer), the budget's bytes stay within the cap (unless
    everything is pinned) and the card holds no more than the budget
    counts. Last, the host tier alone: a lone cold pair Count over 160
    shards on the native library against the numpy plain version, and
    ``Fragment.import_bits`` of 2^20 pairs into one 64-row fragment
    native against numpy, the two fragments equal."""
    import gc

    import numpy as np
    import torch

    from pilosa_tpu_torch.core import membudget, residency
    from pilosa_tpu_torch.core.fragment import Fragment
    from pilosa_tpu_torch.exec.executor import STACK_DECLINED, Executor
    from pilosa_tpu_torch.ops import bitops, kernels as tk

    on_card = torch.device(device).type == "cuda"
    t_path = time.perf_counter()
    t0 = time.perf_counter()
    truth, mirrors = budget_truths(pool, holder, device, v_truth)
    lat = {"truth_s": time.perf_counter() - t0, "truth_parts_s": truth["seconds"],
           "queries": {}}
    W = holder.n_words
    f_bytes = S_FULL * truth["f_rows"] * W * 4
    g_bytes = S_FULL * R_FULL * W * 4
    bsi_bytes = S_FULL * (2 + BSI_DEPTH) * W * 4
    cap_evict = f_bytes + g_bytes + bsi_bytes // 2
    cap_decline = bsi_bytes * 85 // 100
    prev_cap = membudget.default_budget(device).cap
    vals, exv = truth["v"]

    def mem():
        if not on_card:
            return 0
        torch.cuda.synchronize()
        gc.collect()
        return torch.cuda.memory_allocated(device)

    def pairs_q(fld):
        return " ".join(f"Count({op}(Row({fld}={a}), Row({fld}={b})))"
                        for op, a, b in truth["items"][fld])

    def after(combos, bound):
        return [c for c in combos if c[0] > tuple(bound)]

    lo, hi = 250_000, 750_000
    v_mask = {
        "lt": lambda s: exv[s] & (vals[s] < 500_000),
        "bt": lambda s: exv[s] & (vals[s] >= lo) & (vals[s] <= hi),
        "all": lambda s: exv[s],
    }
    v_count = truth_count(pool, v_mask["lt"])
    fg = truth["groupby_fg"]
    prev_fg = [40, 10]
    (lone_op, lone_a, lone_b), lone_n = truth["lone"]
    declined_reads = [
        ("lone pair Count", f"Count({lone_op}(Row(f={lone_a}), Row(f={lone_b})))", [lone_n]),
        ("64 pair Counts on f", pairs_q("f"), truth["pairs"]["f"]),
        ("filtered TopN", f"TopN(f, Row(g={truth['g_row']}), n=10, tanimotoThreshold=10)",
         [truth["topn"]]),
        ("GroupBy f x g, limit 12", "GroupBy(Rows(f), Rows(g), limit=12)", [fg[:12]]),
        ("GroupBy f x g after previous, limit 12",
         f"GroupBy(Rows(f), Rows(g), previous={prev_fg}, limit=12)",
         [after(fg, prev_fg)[:12]]),
        ("GroupBy h x g x f filtered, limit 20",
         "GroupBy(Rows(h), Rows(g), Rows(f), filter=Row(g=3), limit=20)",
         [truth["groupby_hgf20"]]),
        ("tree Count", "Count(Intersect(Row(f=1), Row(g=2), Row(h=3)))", [truth["tree"]]),
        ("range Count on v", "Count(Row(v < 500000))", [v_count]),
        ("`><` bitmap on v", f"Row(v >< [{lo}, {hi}])", [truth_words(pool, v_mask["bt"])]),
        ("Sum of v", "Sum(field=v)", [truth_sum(pool, vals, v_mask["all"])]),
        ("Min of v", "Min(field=v)", [truth_extreme(pool, vals, v_mask["all"], False)]),
        ("Max of v", "Max(field=v)", [truth_extreme(pool, vals, v_mask["all"], True)]),
    ]

    def norm(res):
        out = []
        for r in res:
            if hasattr(r, "segments"):
                zero = np.zeros(W, dtype=np.uint32)
                out.append(np.stack([np.asarray(r.segments.get(s, zero)) for s in range(S_FULL)]))
            elif hasattr(r, "value"):
                out.append((r.value, r.count))
            elif isinstance(r, list) and r and hasattr(r[0], "group"):
                out.append([(tuple(fr.row_id for fr in g.group), g.count) for g in r])
            elif isinstance(r, list):
                out.append([(p.id, p.count) for p in r])
            else:
                out.append(r)
        return out

    def same(a, b):
        return len(a) == len(b) and all(
            np.array_equal(x, y) if isinstance(x, np.ndarray) else x == y
            for x, y in zip(a, b))

    # -- the reference answers: the other paths' executor, no cap
    t0 = time.perf_counter()
    membudget.configure(None)
    reference = {}
    for name, q, want in declined_reads:
        t = time.perf_counter()
        reference[name] = norm(ex_main.execute("i", q))
        if not same(reference[name], want):
            raise AssertionError(f"budget reference: {name}: answer differs from its truth")
        log(f"  budget reference: {name}: {(time.perf_counter() - t) * 1e3:.1f} ms")
    lat["reference_s"] = time.perf_counter() - t0

    budget = membudget.configure(cap_evict)
    tracker = residency.configure()
    ex = kernel_executor(holder)
    # conditions go to the stack (or per fragment) at once: the warm-up of
    # a lone cold condition is the bsi path's subject, not this one's
    ex._BSI_SINGLE_WARM = 0
    base = mem()

    def run(phase, name, q, want, cap):
        ev0, rb0, dec0, fl0 = (ex.stack_evictions, ex.stack_rebuilds, ex.stacks_declined,
                               ex.bsi_fragment_launches)
        before = dict(tk.LAUNCHES)
        t = time.perf_counter()
        res = norm(ex.execute("i", q))
        ms = (time.perf_counter() - t) * 1e3
        if not same(res, want):
            raise AssertionError(f"budget {phase}: {name}: answer differs from its truth")
        if phase == "declined" and not same(res, reference[name]):
            raise AssertionError(f"budget {phase}: {name}: differs from the uncapped answer")
        used, pinned = budget.used(), budget.pinned_bytes()
        if used > cap:
            if pinned < used:
                raise AssertionError(f"budget {phase}: {name}: {used} bytes held over the cap "
                                     f"{cap} with {pinned} pinned")
            log(f"  budget {phase}: {name}: {used} bytes over the cap {cap}, every entry pinned")
        alloc = mem() - base
        launches = {k: tk.LAUNCHES[k] - before[k] for k in tk.LAUNCHES
                    if tk.LAUNCHES[k] > before[k]}
        row = {"ms": ms, "evictions": ex.stack_evictions - ev0,
               "rebuilds": ex.stack_rebuilds - rb0, "declined": ex.stacks_declined - dec0,
               "fragment_launches": ex.bsi_fragment_launches - fl0, "launches": launches,
               "used": used, "pinned": pinned, "allocated": alloc}
        lat["queries"].setdefault(phase, []).append({"name": name, **row})
        log(f"  budget {phase}: {name}: {ms:.1f} ms, launches {launches}, stacks evicted "
            f"{row['evictions']}, rebuilt {row['rebuilds']}, declined {row['declined']}, "
            f"per-fragment BSI {row['fragment_launches']}; budget {used / 1e9:.3f} GB "
            f"({pinned / 1e9:.3f} pinned), the card holds {alloc / 1e9:.3f} GB more than "
            f"before the phase")
        if on_card and alloc > used + (256 << 20):
            raise AssertionError(f"budget {phase}: {name}: the card holds {alloc} bytes, the "
                                 f"budget {used}: an evicted tensor is still alive")
        return row

    # -- eviction phase
    t0 = time.perf_counter()
    log(f"budget: cap {cap_evict / 1e9:.3f} GB (f {f_bytes / 1e9:.3f}, g "
        f"{g_bytes / 1e9:.3f}, a BSI stack {bsi_bytes / 1e9:.3f} GB)")
    for fld in ("f", "g"):
        run("eviction", f"64 pair Counts on {fld}", pairs_q(fld), truth["pairs"][fld], cap_evict)
    run("eviction", "GroupBy f x g", "GroupBy(Rows(f), Rows(g))", [fg], cap_evict)
    run("eviction", "range Counts on v and w", "Count(Row(v < 500000)) Count(Row(w != null))",
        [v_count, truth["w_notnull"]], cap_evict)
    run("eviction", "64 pair Counts on f", pairs_q("f"), truth["pairs"]["f"], cap_evict)
    if not any(r["evictions"] and r["rebuilds"] for r in lat["queries"]["eviction"]):
        raise AssertionError("budget: no query of the eviction phase evicted and rebuilt")
    # a shrink evicts the colder stacks: the card's memory falls by at
    # least the bytes the budget releases
    shrink = bsi_bytes + bsi_bytes // 2
    used0, ev0, a0 = budget.used(), ex.stack_evictions, mem()
    budget.set_cap(shrink)
    a1 = mem()
    freed = used0 - budget.used()
    log(f"budget: cap shrunk to {shrink / 1e9:.3f} GB: {ex.stack_evictions - ev0} stacks "
        f"evicted, {freed / 1e9:.3f} GB released by the budget, {(a0 - a1) / 1e9:.3f} GB "
        f"freed on the card")
    if freed <= 0 or (on_card and a0 - a1 < freed):
        raise AssertionError(f"budget: evicting {freed} bytes freed {a0 - a1} of the card")
    lat["shrink_released_bytes"], lat["shrink_card_freed_bytes"] = freed, a0 - a1
    lat["eviction_s"] = time.perf_counter() - t0
    lat["eviction_budget"] = budget.snapshot()
    log(f"budget: eviction phase {lat['eviction_s']:.1f} s; budget "
        f"{json.dumps(lat['eviction_budget'])}")

    # -- declined phase
    t0 = time.perf_counter()
    budget.set_cap(cap_decline)
    for name, q, want in declined_reads:
        row = run("declined", name, q, want, cap_decline)
        if name.endswith("on v") or name.endswith("of v"):
            if on_card and sum(row["launches"].get(k, 0) for k in
                               ("bsi_range", "bsi_sum", "bsi_extreme")) < S_FULL:
                raise AssertionError(f"budget declined: {name}: BSI launches "
                                     f"{row['launches']}, not one per fragment")
            if row["fragment_launches"] < S_FULL:
                raise AssertionError(f"budget declined: {name}: "
                                     f"{row['fragment_launches']} per-fragment launches")
    for fld in ("f", "g", "v", "w"):
        field = holder.field("i", fld)
        st = (ex._bsi_stack(field, list(range(S_FULL))) if field.is_bsi()
              else ex._field_stack(field, list(range(S_FULL))))
        if st is not STACK_DECLINED:
            raise AssertionError(f"budget declined: {fld}'s stack was not declined")
    lat["declined_s"] = time.perf_counter() - t0
    lat["declined_budget"] = budget.snapshot()
    lat["residency"] = tracker.snapshot()
    log(f"budget: declined phase {lat['declined_s']:.1f} s under a {cap_decline / 1e9:.3f} GB "
        f"cap; budget {json.dumps(lat['declined_budget'])}; residency "
        f"{json.dumps(lat['residency'])}")

    # -- the host tier alone
    t0 = time.perf_counter()
    view = holder.field("i", "f").view("standard")
    shards = list(range(S_FULL))
    op = lone_op.lower()
    native, plain = [], []
    for _ in range(HOST_TIER_REPS):
        t = time.perf_counter()
        n_native = ex._host_pair_count(view, lone_a, lone_b, op, shards)
        native.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        n_plain = sum(bitops.pair_count_host_plain(
            view.fragment(s).row_words_host(lone_a), view.fragment(s).row_words_host(lone_b),
            op) for s in shards)
        plain.append((time.perf_counter() - t) * 1e3)
        if n_native != lone_n or n_plain != lone_n:
            raise AssertionError(f"host tier: {n_native}, plain {n_plain}, truth {lone_n}")
    rng = np.random.default_rng(SEED + 12)
    rows = rng.integers(0, R_FULL, IMPORT_PAIRS).astype(np.uint64)
    cols = rng.integers(0, W * 32, IMPORT_PAIRS)
    imp_native = []
    for _ in range(3):
        fa = Fragment(n_words=W, device=device)
        t = time.perf_counter()
        na = fa.import_bits(rows, cols)
        imp_native.append((time.perf_counter() - t) * 1e3)
    fb = Fragment(n_words=W, device=device)
    t = time.perf_counter()
    nb = fb.import_bits_plain(rows, cols)
    imp_plain = (time.perf_counter() - t) * 1e3
    (ia, ma), (ib, mb) = fa.rows_matrix_host(), fb.rows_matrix_host()
    if na != nb or ia != ib or not np.array_equal(ma, mb):
        raise AssertionError("import_bits: native and numpy fragments differ")
    lat["host_tier"] = {
        "cpu_count": os.cpu_count(), "pair_count_native_ms": native,
        "pair_count_plain_ms": plain, "import_native_ms": imp_native,
        "import_plain_ms": imp_plain, "import_changed_bits": int(na),
    }
    log(f"host tier ({os.cpu_count()} CPUs): a lone cold {lone_op} pair Count over {S_FULL} "
        f"shards native {statistics.median(native):.2f} ms (median of {HOST_TIER_REPS}; "
        f"{', '.join(f'{x:.2f}' for x in native)}), numpy {statistics.median(plain):.2f} ms "
        f"({', '.join(f'{x:.2f}' for x in plain)}); import_bits of {IMPORT_PAIRS} pairs into "
        f"one {R_FULL}-row fragment native {statistics.median(imp_native):.1f} ms (median of "
        f"3), numpy {imp_plain:.1f} ms, the fragments equal; {time.perf_counter() - t0:.1f} s")
    del mirrors
    membudget.configure(prev_cap)
    lat["path_s"] = time.perf_counter() - t_path
    log(f"budget path: {lat['path_s']:.1f} s (truths {lat['truth_s']:.1f} s: "
        f"{json.dumps(truth['seconds'])}, reference {lat['reference_s']:.1f} s, eviction "
        f"{lat['eviction_s']:.1f} s, declined {lat['declined_s']:.1f} s)")
    return lat



# ---------------------------------------------------------------------------
# The storage path: the served index written to a data directory, reopened
# and served again; op-log replay; a keyed index
# ---------------------------------------------------------------------------

# the keyed index: column keys (ids 1..2^20, two shards) and row keys of a
# keyed field, and the pair Counts of its batch
# data directories the storage path leaves for the http path; main
# removes them at its end, whatever happened
STORAGE_DIRS: list = []
KEY_COLS = 1 << 20
KEY_ROWS = 64
KEY_PAIRS = 64
# writes to f and v made before the op-log reopen
STORAGE_WRITES = 64


def storage_data(holder):
    """The schema of index ``i`` with f, h and v (and its existence field),
    and every fragment of theirs as ``(row ids, words)`` copied from the
    served holder's host mirrors: the data the storage path writes."""
    schema = [{
        "name": "i",
        "options": {"keys": False, "trackExistence": True},
        "fields": [{"name": "f", "options": {}}, {"name": "h", "options": {}},
                   {"name": "v", "options": {"type": "int", "min": BSI_FIELDS["v"][0],
                                             "max": BSI_FIELDS["v"][1]}}],
    }]
    fragments = {}
    for field, view in (("f", "standard"), ("h", "standard"), ("_exists", "standard"),
                        ("v", "bsig_v")):
        for s, frag in holder.field("i", field).view(view).fragments.items():
            fragments[("i", field, view, s)] = frag.rows_matrix_host()
    return schema, fragments


def fragments_of(holder):
    """Every fragment of every index of ``holder``."""
    return [frag for idx in holder.indexes.values() for f in idx.fields.values()
            for v in f.views.values() for frag in v.fragments.values()]


def storage_truths(pool, holder, v_truth, items, h_rows):
    """numpy over the data the storage path writes (the served holder's
    mirrors): :func:`truths_of` f's and h's stacks, and f's stack."""
    f_rows = 1 + max(max(frag.row_ids())
                     for frag in holder.field("i", "f").view("standard").fragments.values())
    f = mirror_stack(holder, "f", f_rows, S_FULL)
    h = mirror_stack(holder, "h", H_ROWS, S_FULL)
    return truths_of(pool, f, h, v_truth, items, h_rows), f


def truths_of(pool, f, h, v_truth, items, h_rows):
    """numpy over f's and h's stacks (uint32 ``[S, R, W]``) and v's values:
    the pair counts of ``items`` on f, each f row's total and its count
    under each h row (the TopNs and the GroupBy f x h), a tree Count, and
    the range Count and Sum of v from ``v_truth``."""
    import numpy as np

    f_rows = f.shape[1]

    def per_shard(s):
        tot = np.bitwise_count(f[s]).sum(axis=1, dtype=np.int64)
        under = np.stack([np.bitwise_count(f[s] & h[s, q]).sum(axis=1, dtype=np.int64)
                          for q in range(H_ROWS)])
        tree = int(np.bitwise_count((f[s, 1] & h[s, 2]) | (f[s, 3] & ~f[s, 4]))
                   .sum(dtype=np.int64))
        return tot, under, tree

    parts = by_shard(pool, per_shard)
    tot = sum(p[0] for p in parts)
    under = sum(p[1] for p in parts)
    vals, exv = v_truth
    t = {
        "f_rows": f_rows, "items": items, "pairs": truth_pair_counts(f, items, pool),
        "tot": tot, "under": under, "tree": sum(p[2] for p in parts),
        "range": truth_count(pool, lambda s: exv[s] & (vals[s] < 500_000)),
        "sum": truth_sum(pool, vals, lambda s: exv[s]),
    }
    h_tan, h_filt = h_rows
    src = int(np.bitwise_count(h[:, h_tan]).sum(dtype=np.int64))
    tan = []
    for r in range(f_rows):
        c = int(under[h_tan, r])
        denom = int(tot[r]) + src - c
        if c >= 1 and denom > 0 and c * 100 >= 10 * denom:
            tan.append((r, c))
    # as answer_of gives them: an unkeyed field's pairs and groups carry None
    t["tanimoto"] = [(r, c, None) for r, c in sorted(tan, key=lambda p: (-p[1], p[0]))[:10]]
    filt = [(r, int(c)) for r, c in enumerate(under[h_filt]) if c]
    t["filtered"] = [(r, c, None) for r, c in sorted(filt, key=lambda p: (-p[1], p[0]))[:10]]
    t["groupby"] = [((r, q), int(under[q, r]), (None, None)) for r in range(f_rows)
                    for q in range(H_ROWS) if under[q, r]]
    return t


def storage_reads(truth, h_rows):
    """The reads the storage path serves on the index it wrote, each as
    ``(name, query or list of queries for execute_batch, kernels it must
    launch cold, answer)``."""
    h_tan, h_filt = h_rows
    pair_calls = [f"Count({op}(Row(f={a}), Row(f={b})))" for op, a, b in truth["items"]]
    return [  # the TopNs first: after the gram, row totals come from its diagonal
        ("tanimoto TopN", f"TopN(f, Row(h={h_tan}), n=10, tanimotoThreshold=10)",
         ("masked_row_scan", "row_scan"), truth["tanimoto"]),
        ("filtered TopN", f"TopN(f, Row(h={h_filt}), n=10)", ("masked_row_scan",),
         truth["filtered"]),
        (f"{len(pair_calls)} pair Counts", pair_calls, ("gram",), truth["pairs"]),
        ("GroupBy f x h", "GroupBy(Rows(f), Rows(h))", ("cross_gram",), truth["groupby"]),
        ("tree Count", "Count(Union(Intersect(Row(f=1), Row(h=2)), "
         "Difference(Row(f=3), Row(f=4))))", ("tree_count",), truth["tree"]),
        ("range Count on v", "Count(Row(v < 500000))", ("bsi_range",), truth["range"]),
        ("Sum of v", "Sum(field=v)", ("bsi_sum",), truth["sum"]),
    ]


def answer_of(res):
    """A result in plain Python values, keys included."""
    if isinstance(res, list):
        return [answer_of(r) for r in res]
    if hasattr(res, "segments"):
        return (res.columns().tolist(), res.keys)
    if hasattr(res, "value"):
        return (res.value, res.count)
    if hasattr(res, "group"):
        return (tuple(g.row_id for g in res.group), res.count,
                tuple(g.row_key for g in res.group))
    if hasattr(res, "rows"):
        return (res.rows, res.keys)
    if hasattr(res, "key"):
        return (res.id, res.count, res.key)
    return res


def serve_reads(ex, index, reads, tag, lat, on_card, cold):
    """Serve ``reads`` on ``ex`` over ``index``: each answer (keys
    included, :func:`answer_of`) against its truth, its latency in
    ``lat[tag]``, and, ``cold``, each kernel it names launched; returns the
    answers by name."""
    from pilosa_tpu_torch.ops import kernels as tk

    out = {}
    lat[tag] = {}
    for name, q, kernels, want in reads:
        before = dict(tk.LAUNCHES)
        t = time.perf_counter()
        if isinstance(q, list):
            res = ex.execute_batch(index, [(c, None) for c in q])
            bad = [r for r in res if isinstance(r, Exception)]
            if bad:
                raise bad[0]
            got = [r[0] for r in res]
        else:
            (got,) = ex.execute(index, q)
        lat[tag][name] = (time.perf_counter() - t) * 1e3
        made = {k: tk.LAUNCHES[k] - before[k] for k in tk.LAUNCHES if tk.LAUNCHES[k] > before[k]}
        out[name] = answer_of(got)
        if out[name] != want:
            raise AssertionError(f"storage {tag}: {name}: {str(out[name])[:200]} != "
                                 f"{str(want)[:200]}")
        if on_card and cold:
            missing = [k for k in kernels if k not in made]
            if missing:
                raise AssertionError(f"storage {tag}: {name}: launched {made}, not {missing}")
        log(f"  storage {tag}: {name}: {lat[tag][name]:.1f} ms, launches {made}")
    return out


def storage_path(pool, holder, device, v_truth):
    """Storage and keys at the serving size (``storage/disk.py``,
    ``storage/fragmentfile.py``, ``storage/translatelog.py``):

    1. write: a fresh holder bound to a ``HolderStore`` on a new directory
       under ``build/`` (the free bytes checked first), loaded with f, h, v
       and the existence field copied from the served holder's mirrors;
       every fragment snapshotted through its ``FragmentFile`` (in
       parallel), ``sync()``; the reads below served on it (the pre-close
       answers), then ``close()``;
    2. reopen: a second holder and executor open the directory (the
       ``open`` timed alone: each file decoded straight into its
       fragment's row words); the reads served cold and warm, every answer
       equal to the pre-close one and to numpy over the written data;
       three files decoded and encoded by the native codec and by the
       plain Python one, all equal;
    3. writes: 64 Set/Clear and value writes to f and v through the
       executor, the holder closed without a snapshot and reopened: the
       op logs replay them, and the next reads see them;
    4. keys: an index with column keys (2^20 keys, ids 1..2^20 over two
       shards) and a keyed field of 64 row keys, served by key (pair
       Counts, a filtered TopN whose pairs carry keys, a GroupBy with row
       keys, a Row bitmap with its column keys), a Set with a new column
       key, then a reopen: the same keys give the same ids and answers.

    The reads: a 1024-call pair batch on f, a tanimoto TopN, a TopN
    filtered by a row, GroupBy f x h, a tree Count, and a range Count and
    Sum on v, each cold read asserting the kernels it launched. ``v_truth``
    is the bsi path's decode of v, updated here in place by the writes.

    The directory stays for the http path, which serves it next: returns
    the path's numbers and what the http path needs (the directory, f's
    stack after the writes, h's stack, the pair items, the h rows and the
    keyed reads' truths); the caller removes the directory."""
    import gc
    import shutil
    import tempfile

    import numpy as np
    import torch

    from pilosa_tpu_torch import convert
    from pilosa_tpu_torch.core.field import FieldOptions
    from pilosa_tpu_torch.core.holder import Holder
    from pilosa_tpu_torch.ops import kernels as tk
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
    from pilosa_tpu_torch.storage import roaring
    from pilosa_tpu_torch.storage.disk import HolderStore

    on_card = torch.device(device).type == "cuda"
    t_path = time.perf_counter()
    qrng = np.random.default_rng(SEED + 13)
    W = holder.n_words
    lat = {}

    schema, fragments = storage_data(holder)
    data_bytes = sum(w.nbytes for _, w in fragments.values())
    items = [(OPS[int(qrng.integers(0, 4))], int(qrng.integers(0, R_FULL)),
              int(qrng.integers(0, R_FULL))) for _ in range(BATCH)]
    h_rows = (int(qrng.integers(0, H_ROWS)), int(qrng.integers(0, H_ROWS)))
    t0 = time.perf_counter()
    truth, f_np = storage_truths(pool, holder, v_truth, items, h_rows)
    lat["truth_s"] = time.perf_counter() - t0
    reads = storage_reads(truth, h_rows)

    root = HERE / "build"
    root.mkdir(exist_ok=True)
    free = shutil.disk_usage(root).free
    need = 2 * data_bytes + (1 << 30)
    if free < need:
        raise AssertionError(f"storage: {free} bytes free under {root}, {need} needed")
    data_dir = tempfile.mkdtemp(prefix="storage-", dir=root)
    STORAGE_DIRS.append(data_dir)
    log(f"storage: {data_bytes / 1e9:.3f} GB of mirror words to write under {data_dir} "
        f"({free / 1e9:.1f} GB free)")

    def open_store():
        h = Holder(device=device)
        st = HolderStore(h, data_dir)
        t = time.perf_counter()
        st.open()
        return h, st, time.perf_counter() - t

    def executor(h, st):
        ex = kernel_executor(h, translator=st.translator)
        ex._BSI_SINGLE_WARM = 0  # a lone range Count takes the stack at once
        return ex

    def release():
        gc.collect()
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    # -- 1. write
    t0 = time.perf_counter()
    h_np = mirror_stack(holder, "h", H_ROWS, S_FULL)
    h1 = Holder(device=device)
    st1 = HolderStore(h1, data_dir)
    st1.open()
    convert.load_arrays(h1, schema, fragments)
    del fragments
    frags = fragments_of(h1)
    list(pool.map(lambda fr: fr.store.snapshot(), frags))
    st1.sync()
    lat["write_s"] = time.perf_counter() - t0
    lat["file_bytes"] = sum(os.path.getsize(fr.store.path) for fr in frags)
    lat["files"] = len(frags)
    log(f"storage: wrote {len(frags)} fragment files, {lat['file_bytes'] / 1e9:.3f} GB, "
        f"in {lat['write_s']:.2f} s (load and snapshot)")
    pre = serve_reads(executor(h1, st1), "i", reads, "pre_close", lat, on_card, cold=True)
    t = time.perf_counter()
    st1.close()
    lat["close_s"] = time.perf_counter() - t
    del h1, st1, frags
    release()

    # -- 2. reopen
    h2, st2, lat["open_s"] = open_store()
    n_frags = len(fragments_of(h2))
    log(f"storage: open of {n_frags} fragments in {lat['open_s']:.2f} s")
    if n_frags != lat["files"]:
        raise AssertionError(f"storage: reopened {n_frags} fragments, wrote {lat['files']}")
    ex2 = executor(h2, st2)
    for tag, cold in (("reopen_cold", True), ("reopen_warm", False)):
        got = serve_reads(ex2, "i", reads, tag, lat, on_card, cold)
        if got != pre:
            bad = [k for k in pre if got[k] != pre[k]]
            raise AssertionError(f"storage {tag}: {bad} differ from the pre-close answers")

    # the codec: native against the plain Python codec on three files
    codec = {}
    for field, view in (("f", "standard"), ("h", "standard"), ("v", "bsig_v")):
        frag = h2.field("i", field).view(view).fragment(0)
        with open(frag.store.path, "rb") as fh:
            data = fh.read()
        rids, words = frag.snapshot_rows()
        t = time.perf_counter()
        pos_n, ops_n = roaring.deserialize_with_opcount(data)
        dec_n = time.perf_counter() - t
        t = time.perf_counter()
        pos_p, ops_p = roaring._deserialize_py(data)
        dec_p = time.perf_counter() - t
        t = time.perf_counter()
        ids_w, words_w, ops_w = roaring.decode_rows(data, W)
        dec_w = time.perf_counter() - t
        t = time.perf_counter()
        enc_n = roaring.serialize_rows(rids, words)
        enc_ns = time.perf_counter() - t
        t = time.perf_counter()
        enc_p = roaring._serialize_py(pos_p)
        enc_ps = time.perf_counter() - t
        if not (np.array_equal(pos_n, pos_p) and ops_n == ops_p == ops_w == 0):
            raise AssertionError(f"storage codec: {field}: native and plain decode differ")
        if not (np.array_equal(ids_w, rids) and np.array_equal(words_w, words)):
            raise AssertionError(f"storage codec: {field}: word decode differs")
        if not enc_n == enc_p == data:
            raise AssertionError(f"storage codec: {field}: native and plain bytes differ")
        codec[field] = {"bytes": len(data), "bits": int(pos_p.size),
                        "decode_native_ms": dec_n * 1e3, "decode_plain_ms": dec_p * 1e3,
                        "decode_words_ms": dec_w * 1e3, "encode_native_ms": enc_ns * 1e3,
                        "encode_plain_ms": enc_ps * 1e3}
        log(f"  storage codec: {field}/{view} shard 0, {len(data)} bytes, {pos_p.size} bits: "
            f"decode native {dec_n * 1e3:.1f} ms, plain {dec_p * 1e3:.1f} ms, into words "
            f"{dec_w * 1e3:.2f} ms; encode native {enc_ns * 1e3:.1f} ms, plain "
            f"{enc_ps * 1e3:.1f} ms; all equal")
    lat["codec"] = codec

    # -- 3. writes, replayed from the op logs
    wr = np.random.default_rng(SEED + 14)
    vals, exv = v_truth
    writes, calls = [], []
    for k in range(STORAGE_WRITES):
        col = int(wr.integers(0, S_FULL * SHARD_WIDTH))
        if k % 4 == 3:
            val = int(wr.integers(BSI_FIELDS["v"][0], BSI_FIELDS["v"][1] + 1))
            writes.append(("v", col, val))
            calls.append(f"Set({col}, v={val})")
        else:
            op = "Set" if wr.random() < 0.6 else "Clear"
            row = int(wr.integers(0, R_FULL))
            writes.append(("f", col, (op, row)))
            calls.append(f"{op}({col}, f={row})")
    t = time.perf_counter()
    ex2.execute("i", " ".join(calls))
    lat["writes_ms"] = (time.perf_counter() - t) * 1e3
    for fld, col, arg in writes:  # the truth follows the writes
        s, off = divmod(col, SHARD_WIDTH)
        if fld == "v":
            vals[s][off], exv[s][off] = arg, True
        elif arg[0] == "Set":
            f_np[s, arg[1], off >> 5] |= np.uint32(1 << (off & 31))
        else:
            f_np[s, arg[1], off >> 5] &= ~np.uint32(1 << (off & 31))
    logged = sum(1 for fr in fragments_of(h2) if fr.store.op_n)
    if not logged:
        raise AssertionError("storage: the writes reached no op log")
    wrote_rows = sorted({arg[1] for fld, _, arg in writes if fld == "f"})
    w_items = [(OPS[int(wr.integers(0, 4))], wrote_rows[int(wr.integers(0, len(wrote_rows)))],
                int(wr.integers(0, R_FULL))) for _ in range(KEY_PAIRS)]
    w_reads = [
        (f"{KEY_PAIRS} pair Counts on written rows",
         [f"Count({op}(Row(f={a}), Row(f={b})))" for op, a, b in w_items], ("gram",),
         truth_pair_counts(f_np, w_items, pool)),
        ("range Count on v", "Count(Row(v < 500000))", ("bsi_range",),
         truth_count(pool, lambda s: exv[s] & (vals[s] < 500_000))),
        ("Sum of v", "Sum(field=v)", ("bsi_sum",), truth_sum(pool, vals, lambda s: exv[s])),
    ]
    after = serve_reads(ex2, "i", w_reads, "after_writes", lat, on_card, cold=False)

    # -- 4. keys: built on the same store, closed with the writes above
    t0 = time.perf_counter()
    h2.create_index("k", keys=True).create_field("kf", FieldOptions(keys=True))
    col_keys = [f"user{i:07d}" for i in range(1, KEY_COLS + 1)]
    row_keys = [f"attr{j:02d}" for j in range(KEY_ROWS)]
    t = time.perf_counter()
    col_ids = st2.translator.translate_keys("k", "", col_keys)
    row_ids = st2.translator.translate_keys("k", "kf", row_keys)
    lat["keys_translate_s"] = time.perf_counter() - t
    if col_ids != list(range(1, KEY_COLS + 1)) or row_ids != list(range(1, KEY_ROWS + 1)):
        raise AssertionError("storage keys: ids are not allocated from 1 in order")
    kw = random_words(np.random.default_rng(SEED + 15), (2, KEY_ROWS, W), dense=True)
    kw[0, :, 0] &= ~np.uint32(1)  # column 0 has no key
    kw[1, :, 1:] = 0  # shard 1 holds only column 2^20
    kw[1, :, 0] &= np.uint32(1)
    rows = list(range(1, KEY_ROWS + 1))
    convert.load_arrays(h2, [], {("k", "kf", "standard", s): (rows, kw[s]) for s in (0, 1)})
    for s in (0, 1):
        h2.field("k", "kf").view("standard").fragment(s).store.snapshot()
    lat["keys_build_s"] = time.perf_counter() - t0
    kitems = [(int(wr.integers(0, KEY_ROWS)), int(wr.integers(0, KEY_ROWS)))
              for _ in range(KEY_PAIRS)]
    k_filt, k_row = int(wr.integers(0, KEY_ROWS)), int(wr.integers(0, KEY_ROWS))
    new_key = "user-new"

    def keyed_reads():
        """The keyed reads, their truths from ``kw`` as it stands."""
        counts = np.bitwise_count(kw).sum(axis=(0, 2), dtype=np.int64)
        under = np.bitwise_count(kw & kw[:, k_filt][:, None]).sum(axis=(0, 2),
                                                                 dtype=np.int64)
        top = sorted(((j, int(c)) for j, c in enumerate(under) if c),
                     key=lambda p: (-p[1], p[0]))
        cols = [s * SHARD_WIDTH + int(c) for s in (0, 1)
                for c in np.flatnonzero(np.unpackbits(kw[s, k_row].view(np.uint8),
                                                      bitorder="little"))]
        return [
            (f"{KEY_PAIRS} pair Counts by key",
             [f'Count(Intersect(Row(kf="{row_keys[a]}"), Row(kf="{row_keys[b]}")))'
              for a, b in kitems], ("gram",),
             [int(np.bitwise_count(kw[:, a] & kw[:, b]).sum(dtype=np.int64))
              for a, b in kitems]),
            ("filtered TopN by key", f'TopN(kf, Row(kf="{row_keys[k_filt]}"), n=5)',
             ("masked_row_scan",), [(j + 1, c, row_keys[j]) for j, c in top[:5]]),
            ("GroupBy with row keys", "GroupBy(Rows(kf))", (),
             [((j + 1,), int(c), (row_keys[j],)) for j, c in enumerate(counts) if c]),
            ("Row bitmap with column keys", f'Row(kf="{row_keys[k_row]}")', (),
             (cols, [col_keys[c - 1] if c <= KEY_COLS else new_key for c in cols])),
        ]

    ek = executor(h2, st2)
    keyed = serve_reads(ek, "k", keyed_reads(), "keys_cold", lat, on_card, cold=True)
    t = time.perf_counter()
    (changed,) = ek.execute("k", f'Set("{new_key}", kf="{row_keys[k_row]}")')
    lat["keys_set_ms"] = (time.perf_counter() - t) * 1e3
    if not changed or st2.translator.translate_key("k", "", new_key, create=False) != \
            KEY_COLS + 1:
        raise AssertionError("storage keys: Set with a new column key")
    kw[1, k_row, 0] |= np.uint32(2)  # column 2^20 + 1, the new key's id
    keyed = serve_reads(ek, "k", keyed_reads(), "keys_after_set", lat, on_card, cold=False)
    t = time.perf_counter()
    st2.close()
    lat["close_with_log_s"] = time.perf_counter() - t
    del h2, st2, ex2, ek
    release()

    # -- 3 and 4 after the reopen: the op logs and the keys log replayed
    h3, st3, lat["reopen_with_log_s"] = open_store()
    log(f"storage: reopen with {logged} op logs and {KEY_COLS + KEY_ROWS + 1} keys to "
        f"replay in {lat['reopen_with_log_s']:.2f} s")
    for fld, col, arg in writes:
        if fld == "v":
            got = h3.field("i", "v").value(col)
            if got != (vals[col // SHARD_WIDTH][col % SHARD_WIDTH], True):
                raise AssertionError(f"storage: Set({col}, v=...) not replayed: {got}")
    ex3 = executor(h3, st3)
    if serve_reads(ex3, "i", w_reads, "replayed", lat, on_card, cold=True) != after:
        raise AssertionError("storage: reads after the replay differ")
    tr = st3.translator
    if (tr.translate_keys("k", "", col_keys[:: KEY_COLS // 64], create=False)
            != col_ids[:: KEY_COLS // 64]
            or tr.translate_keys("k", "kf", row_keys, create=False) != row_ids
            or tr.translate_key("k", "", new_key, create=False) != KEY_COLS + 1):
        raise AssertionError("storage keys: the reopened store maps keys to other ids")
    if serve_reads(executor(h3, st3), "k", keyed_reads(), "keys_reopen_cold", lat, on_card,
                   cold=True) != keyed:
        raise AssertionError("storage keys: answers after the reopen differ")
    st3.close()
    del h3, st3, ex3
    release()
    lat["path_s"] = time.perf_counter() - t_path
    log(f"storage path: {lat['path_s']:.1f} s (truth {lat['truth_s']:.1f} s, write "
        f"{lat['write_s']:.1f} s, {lat['file_bytes'] / 1e9:.3f} GB in {lat['files']} files; "
        f"open {lat['open_s']:.2f} s; keys translated {lat['keys_translate_s']:.1f} s; reopen "
        f"with logs {lat['reopen_with_log_s']:.2f} s)")
    hand = {"data_dir": data_dir, "f": f_np, "h": h_np, "items": items, "h_rows": h_rows,
            "keyed_reads": keyed_reads}
    return lat, hand


# ---------------------------------------------------------------------------
# The time path: a time field of quantum YMDH at the serving size
# ---------------------------------------------------------------------------

T_ROWS = 8
T_HOURS = 30
T_EPOCH = "2024-01-01T00:00"
# (name, from, to): covers of one D view, one M view, a D view and 3 H
# views, exactly 16 H views (astbatch.MAX_TIME_COVER), 17 H views (declined
# to the host, as in JAX) and none
T_WINDOWS = (
    ("day", "2024-01-01T00:00", "2024-01-02T00:00"),
    ("month", "2024-01-01T00:00", "2024-02-01T00:00"),
    ("day_hours", "2024-01-01T00:00", "2024-01-02T03:00"),
    ("hours16", "2024-01-01T04:00", "2024-01-01T20:00"),
    ("hours17", "2024-01-01T03:00", "2024-01-01T20:00"),
    ("empty", "2024-01-01T05:00", "2024-01-01T05:00"),
)
T_COVER_LEN = {"day": 1, "month": 1, "day_hours": 4, "hours16": 16, "hours17": 17, "empty": 0}
T_BATCHED = ("day", "month", "day_hours", "hours16")
# the rows of f that windowed Intersects name
T_F_ROWS = (3, 17, 40, 62)
T_WRITES = 64
T_WRITE_HOUR = 7


def mem_available() -> int:
    """Bytes of ``MemAvailable`` in ``/proc/meminfo``."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def window_hours(fr, to):
    """``[a, b)``: the window as hours since T_EPOCH."""
    import numpy as np

    e = np.datetime64(T_EPOCH).astype("datetime64[h]")
    return tuple(int((np.datetime64(x).astype("datetime64[h]") - e).astype(np.int64))
                 for x in (fr, to))


class TimeTruth:
    """The generated bits (``rows``, ``cols``, ``hours``: each column holds
    at most one bit of t) and what numpy makes of them, independent of the
    port: per (row, hour) counts, overall and of the columns that row x of
    f holds, the words of a window's row, and the row totals."""

    def __init__(self, rows, cols, hours, f_rows):
        import numpy as np

        from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

        self.width, self.shift = SHARD_WIDTH, np.uint64(SHARD_WIDTH.bit_length() - 1)
        self.rows, self.cols, self.hours = rows, cols, hours
        self.f_rows = f_rows  # x -> uint32 [S, W] words of f's row x
        self.hist = np.zeros((T_ROWS, T_HOURS), dtype=np.int64)
        self.hist_f = {x: np.zeros((T_ROWS, T_HOURS), dtype=np.int64) for x in f_rows}
        self._add(rows, cols, hours, 1)

    def _add(self, rows, cols, hours, sign):
        import numpy as np

        key = rows.astype(np.int64) * T_HOURS + hours
        n = T_ROWS * T_HOURS
        self.hist += sign * np.bincount(key, minlength=n).reshape(T_ROWS, T_HOURS)
        shard = (cols >> self.shift).astype(np.int64)
        off = (cols & np.uint64(self.width - 1)).astype(np.int64)
        for x, fx in self.f_rows.items():
            inf = ((fx[shard, off >> 5] >> (off & 31).astype(np.uint32)) & 1).astype(bool)
            self.hist_f[x] += sign * np.bincount(key[inf], minlength=n).reshape(T_ROWS, T_HOURS)

    def write(self, rows, cols, hours, sign=1):
        import numpy as np

        if sign > 0:
            self.rows = np.concatenate([self.rows, rows])
            self.cols = np.concatenate([self.cols, cols])
            self.hours = np.concatenate([self.hours, hours])
        else:
            keep = ~np.isin(self.cols, cols)
            self.rows, self.cols, self.hours = self.rows[keep], self.cols[keep], self.hours[keep]
        self._add(rows, cols, hours, sign)

    def count(self, r, fr, to, x=None):
        a, b = window_hours(fr, to)
        a, b = max(a, 0), min(b, T_HOURS)
        h = self.hist if x is None else self.hist_f[x]
        return int(h[r, a:b].sum()) if b > a else 0

    def total(self, r):
        return int(self.hist[r].sum())

    def mask(self, r, fr, to, shards=None):
        """uint32 ``[S, W]`` words of row ``r`` over the window, or
        ``{shard: [W] words}`` for the given shards."""
        import numpy as np

        a, b = window_hours(fr, to)
        cols = self.cols[(self.rows == r) & (self.hours >= a) & (self.hours < b)]

        def words(c, n_bits):
            bits = np.zeros(n_bits, dtype=bool)
            bits[c.astype(np.int64)] = True
            return np.packbits(bits, bitorder="little").view(np.uint32)

        if shards is None:
            return words(cols, S_FULL * self.width).reshape(S_FULL, -1)
        return {s: words(cols[(cols >> self.shift) == s] & np.uint64(self.width - 1),
                         self.width) for s in shards}


def time_load(holder, pool):
    """Field t (quantum YMDH, T_ROWS rows) on the serving index: a bit in
    about a quarter of the columns, in one of T_ROWS rows, stamped with one
    of T_HOURS consecutive hours from T_EPOCH, loaded through
    ``Field.import_bits(rows, cols, timestamps=...)`` (timed)."""
    import numpy as np

    from pilosa_tpu_torch.core.field import FieldOptions
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    # the host mirrors of 35 views (a fragment holds at least 8 rows), the
    # generated bits and the import's temporaries (about 18 bytes a column)
    need = int((T_HOURS + 5) * S_FULL * max(8, T_ROWS) * SHARD_WIDTH // 8 * 1.1
               + S_FULL * SHARD_WIDTH * 18 + (1 << 30))
    avail = mem_available()
    log(f"time: MemAvailable {avail / 2**30:.1f} GiB; the load needs about "
        f"{need / 2**30:.1f} GiB")
    if avail < need:
        raise MemoryError(f"MemAvailable {avail} bytes, the time path needs {int(need)}")
    rng = np.random.default_rng(SEED + 17)
    n = S_FULL * SHARD_WIDTH
    b = rng.integers(0, 1 << 16, size=n, dtype=np.uint16)
    cols = np.flatnonzero((b & 3) == 0).astype(np.uint64)
    rows = ((b[cols] >> 2) & (T_ROWS - 1)).astype(np.uint64)
    del b
    hours = rng.integers(0, T_HOURS, size=cols.size)
    stamps = np.datetime64(T_EPOCH).astype("datetime64[h]") + hours
    t = holder.index("i").create_field("t", FieldOptions(field_type="time", time_quantum="YMDH"))
    t0 = time.perf_counter()
    t.import_bits(rows, cols, timestamps=stamps)
    import_s = time.perf_counter() - t0
    n_views = len(t.views)
    del stamps, t
    f_view = holder.field("i", "f").view("standard")
    f_rows = {x: np.stack([f_view.fragment(s).row_words_host(x) for s in range(S_FULL)])
              for x in T_F_ROWS}
    truth = TimeTruth(rows, cols, hours, f_rows)
    log(f"time: loaded t, {cols.size} bits ({cols.size / n:.4f} of the columns) in {n_views} "
        f"views through import_bits with timestamps in {import_s:.2f} s")
    return truth, import_s, n_views


def time_path(pool, ex, holder, device):
    """Time-quantum views at the serving size: a field t of quantum YMDH
    and T_ROWS rows, 160 shards x 2^20 columns, loaded with about 42 M
    timestamped bits over 30 hours (35 views: standard, Y, M, 2 D, 30 H);
    windows whose covers are one D view, one M view, a D view and 3 H
    views, 16 H views, 17 H views and none. Reads, each against numpy over
    the generated bits: each window's first Count (its cover's stacks
    built) and warm; a 1024-call batch of windowed Counts and Intersects
    with rows of f (one tree_count launch per shape and window), before
    and after writes; windowed bitmaps (tree_words); TopN of f filtered by
    a window, plain and tanimoto (the scans); GroupBy f x h filtered by a
    window (the cross gram); Rows with from/to; pair Counts over t's
    standard view (the gram). Writes: 64 timestamped Sets seen by the next
    batch through the per-view patch, a Clear from every view, Store,
    SetRowAttrs with TopN by attribute, and Options. Last, t deleted: its
    stacks leave the card and the budget, and a new t answers from its own
    data. ``ex`` is a fresh executor, so the scans' caches start empty."""
    import gc

    import numpy as np
    import torch

    from pilosa_tpu_torch.core import membudget
    from pilosa_tpu_torch.core.field import FieldOptions
    from pilosa_tpu_torch.exec.result import result_to_json
    from pilosa_tpu_torch.ops import kernels as tk
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    on_card = torch.device(device).type == "cuda"
    t_path = time.perf_counter()
    lat = {}
    truth, lat["import_s"], lat["views"] = time_load(holder, pool)
    t_field = holder.field("i", "t")
    covers = {}
    for name, fr, to in T_WINDOWS:
        from pilosa_tpu_torch.core import timequantum

        covers[name] = timequantum.view_cover(t_field, fr, to, "standard")
        if len(covers[name]) != T_COVER_LEN[name]:
            raise AssertionError(f"window {name}: cover {covers[name]}")
        log(f"time: window {name} [{fr}, {to}): cover of {len(covers[name])} views "
            f"{covers[name][:3]}{' ...' if len(covers[name]) > 3 else ''}")
    del t_field
    win = {name: (fr, to) for name, fr, to in T_WINDOWS}

    def w_arg(name):
        fr, to = win[name]
        return f"from={fr}, to={to}"

    def launched(before, *names):
        return {k: tk.LAUNCHES[k] - before[k] for k in names}

    def expect(tag, got, want):
        if on_card and got != want:
            raise AssertionError(f"time: {tag}: launches {got}, not {want}")

    # -- each window's first Count (two calls demand the stacks), then warm
    qrng = np.random.default_rng(SEED + 18)
    first = {}
    for name, _, _ in T_WINDOWS:
        r = int(qrng.integers(0, T_ROWS))
        q = f"Count(Row(t={r}, {w_arg(name)}))"
        want = truth.count(r, *win[name])
        b0 = dict(tk.LAUNCHES)
        rb0 = ex.stack_rebuilds
        t0 = time.perf_counter()
        got = ex.execute("i", f"{q} {q}")
        cold_ms = (time.perf_counter() - t0) * 1e3
        batched = name in T_BATCHED
        expect(f"{name} first Count", launched(b0, "tree_count"), {"tree_count": int(batched)})
        built = ex.stack_rebuilds - rb0
        warm = []
        for _ in range(3):
            b0 = dict(tk.LAUNCHES)
            t0 = time.perf_counter()
            (w_got,) = ex.execute("i", q)
            warm.append((time.perf_counter() - t0) * 1e3)
            expect(f"{name} warm Count", launched(b0, "tree_count"), {"tree_count": int(batched)})
            if w_got != want:
                raise AssertionError(f"time: {q} warm -> {w_got} != numpy {want}")
        if got != [want, want]:
            raise AssertionError(f"time: {q} -> {got} != numpy {want}")
        first[name] = {"first_ms": cold_ms, "stacks_built": built,
                       "warm_ms": statistics.median(warm), "cover": len(covers[name])}
        log(f"time: window {name}: first Count {cold_ms:.1f} ms ({built} stacks built), warm "
            f"{statistics.median(warm):.2f} ms, {'tree_count' if batched else 'host'}; = numpy")
    lat["windows"] = first

    # -- the 1024-call windowed batch
    items = []
    for _ in range(BATCH):
        name = T_BATCHED[int(qrng.integers(0, len(T_BATCHED)))]
        r = int(qrng.integers(0, T_ROWS))
        x = T_F_ROWS[int(qrng.integers(0, len(T_F_ROWS)))] if qrng.random() < 0.5 else None
        items.append((name, r, x))

    def batch_round(tag):
        calls = [f"Count(Row(t={r}, {w_arg(n)}))" if x is None else
                 f"Count(Intersect(Row(t={r}, {w_arg(n)}), Row(f={x})))" for n, r, x in items]
        b0 = dict(tk.LAUNCHES)
        t0 = time.perf_counter()
        out = ex.execute_batch("i", [(c, None) for c in calls])
        s = time.perf_counter() - t0
        got = launched(b0, "tree_count", "tree_words")
        expect(f"{tag} batch", got, {"tree_count": 2 * len(T_BATCHED), "tree_words": 0})
        for (n, r, x), o in zip(items, out):
            if isinstance(o, Exception):
                raise o
            want = truth.count(r, *win[n], x=x)
            if o != [want]:
                raise AssertionError(f"time: {tag}: Count over {n}, row {r}, f {x}: {o} != {want}")
        log(f"time: {tag}: {BATCH} windowed Counts and Intersects via execute_batch "
            f"{s * 1e3:.1f} ms ({BATCH / s:.0f} queries/s), launches {got}; all equal numpy")
        return {"batch_s": s, "batch_qps": BATCH / s, "tree_count_launches": got["tree_count"]}

    lat["batch_cold"] = batch_round("batch (f's stack built)")
    lat["batch"] = batch_round("batch warm")

    # -- windowed bitmaps through tree_words, words against numpy
    bitmaps = [("hours16", 2), ("day_hours", 5), ("month", 0), ("day", 7)]
    b0 = dict(tk.LAUNCHES)
    t0 = time.perf_counter()
    out = ex.execute_batch("i", [(f"Row(t={r}, {w_arg(n)})", None) for n, r in bitmaps])
    lat["bitmaps_ms"] = (time.perf_counter() - t0) * 1e3
    expect("bitmaps", launched(b0, "tree_words"), {"tree_words": len(bitmaps)})
    check = np.random.default_rng(SEED + 19).choice(S_FULL, size=min(4, S_FULL), replace=False)
    for (n, r), (row,) in zip(bitmaps, out):
        if row.count() != truth.count(r, *win[n]):
            raise AssertionError(f"time: Row(t={r}) over {n}: count {row.count()}")
        want = truth.mask(r, *win[n], shards=check.tolist())
        for s in check.tolist():
            if not np.array_equal(row.segments[s], want[s]):
                raise AssertionError(f"time: Row(t={r}) over {n}: shard {s} words differ")
    log(f"time: {len(bitmaps)} windowed bitmaps via execute_batch {lat['bitmaps_ms']:.1f} ms, "
        f"one tree_words launch each; counts and sampled words equal numpy")

    # -- TopN of f filtered by a window: tanimoto (row scan), then plain
    f_np = mirror_stack(holder, "f", R_FULL + 1, S_FULL)
    for tag, name, r, extra, threshold in (("tanimoto", "month", 3, ", tanimotoThreshold=2", 2),
                                           ("plain", "hours16", 6, "", 0)):
        q = f"TopN(f, Row(t={r}, {w_arg(name)}), n=10{extra})"
        b0 = dict(tk.LAUNCHES)
        t0 = time.perf_counter()
        (res,) = ex.execute("i", q)
        lat[f"topn_{tag}_ms"] = (time.perf_counter() - t0) * 1e3
        got = launched(b0, "masked_row_scan", "row_scan")
        expect(f"TopN {tag}", got, {"masked_row_scan": 1, "row_scan": int(tag == "tanimoto")})
        filt = truth.mask(r, *win[name])
        want = truth_tanimoto_topn(f_np, filt[:, None], 0, threshold, 10, pool)
        if [(p.id, p.count) for p in res] != want:
            raise AssertionError(f"time: {q} -> {res} != {want}")
        log(f"time: {q} {lat[f'topn_{tag}_ms']:.1f} ms, launches {got}; equals numpy")

    # -- GroupBy f x h filtered by a window (the k-level engine)
    name, r = "day_hours", 1
    q = f"GroupBy(Rows(f), Rows(h), filter=Row(t={r}, {w_arg(name)}))"
    b0 = dict(tk.LAUNCHES)
    t0 = time.perf_counter()
    (res,) = ex.execute("i", q)
    lat["groupby_ms"] = (time.perf_counter() - t0) * 1e3
    got = launched(b0, "cross_gram")
    if on_card and got["cross_gram"] < 1:
        raise AssertionError(f"time: {q}: launches {got}")
    dev = torch.device(device)
    f_dev = torch.from_numpy(f_np.view(np.int32)).to(dev)
    h_dev = torch.from_numpy(mirror_stack(holder, "h", H_ROWS, S_FULL).view(np.int32)).to(dev)
    filt_dev = torch.from_numpy(truth.mask(r, *win[name]).view(np.int32)).to(dev)
    want = truth_groupby([f_dev, h_dev], filt_dev)
    del f_dev, h_dev, filt_dev
    if [(tuple(fr.row_id for fr in g.group), g.count) for g in res] != want:
        raise AssertionError(f"time: {q}: {len(res)} groups differ from the truth")
    log(f"time: {q} {lat['groupby_ms']:.1f} ms, {len(res)} groups, launches {got}; equal "
        f"the card's AND and popcount per combination")

    # -- Rows with from/to, and pair Counts over t's standard view (the gram)
    for name in ("hours16", "empty", "day"):
        (res,) = ex.execute("i", f"Rows(t, {w_arg(name)})")
        want = [r for r in range(T_ROWS) if truth.count(r, *win[name]) > 0]
        if res.rows != want:
            raise AssertionError(f"time: Rows(t) over {name}: {res.rows} != {want}")
    pairs = [(OPS[int(qrng.integers(0, 4))], int(qrng.integers(0, T_ROWS)),
              int(qrng.integers(0, T_ROWS))) for _ in range(64)]
    b0 = dict(tk.LAUNCHES)
    t0 = time.perf_counter()
    out = ex.execute_batch("i", [(f"Count({op}(Row(t={a}), Row(t={b_})))", None)
                                 for op, a, b_ in pairs])
    lat["pair_counts_ms"] = (time.perf_counter() - t0) * 1e3
    expect("t pair Counts", launched(b0, "gram"), {"gram": 1})
    for (op, a, b_), o in zip(pairs, out):
        ta, tb = truth.total(a), truth.total(b_)
        # each column holds at most one bit of t
        want = {"Intersect": ta if a == b_ else 0, "Union": ta if a == b_ else ta + tb,
                "Difference": 0 if a == b_ else ta, "Xor": 0 if a == b_ else ta + tb}[op]
        if o != [want]:
            raise AssertionError(f"time: Count({op}(Row(t={a}), Row(t={b_}))) {o} != {want}")
    log(f"time: Rows(t) with from/to equal numpy; 64 pair Counts over t's standard view "
        f"{lat['pair_counts_ms']:.1f} ms, one gram launch; equal the row totals")

    # -- writes: 64 timestamped Sets, seen by the next batch (the per-view patch)
    wrng = np.random.default_rng(SEED + 20)
    cand = wrng.integers(0, S_FULL * SHARD_WIDTH, 4 * T_WRITES).astype(np.uint64)
    cand = np.unique(cand[~np.isin(cand, truth.cols)])[:T_WRITES]
    w_rows = wrng.integers(0, T_ROWS, cand.size).astype(np.uint64)
    stamp = f"2024-01-01T{T_WRITE_HOUR:02d}:00"
    inc0, reb0 = ex.stack_incremental, ex.stack_rebuilds
    t0 = time.perf_counter()
    changed = ex.execute("i", " ".join(f"Set({c}, t={r}, {stamp})" for c, r in zip(
        cand.tolist(), w_rows.tolist())))
    lat["writes_ms"] = (time.perf_counter() - t0) * 1e3
    if not all(changed):
        raise AssertionError("time: a timestamped Set changed nothing")
    truth.write(w_rows, cand, np.full(cand.size, T_WRITE_HOUR))
    lat["batch_after_writes"] = batch_round("batch after 64 timestamped Sets")
    patched = ex.stack_incremental - inc0
    if patched < 3 or ex.stack_rebuilds != reb0:
        raise AssertionError(f"time: after the writes {patched} stacks patched, "
                             f"{ex.stack_rebuilds - reb0} rebuilt")
    log(f"time: {cand.size} Sets with a timestamp in one execute {lat['writes_ms']:.1f} ms; "
        f"the next batch patched {patched} stacks, rebuilt none")
    # Clear from the standard view and every time view
    c0, r0 = int(cand[0]), int(w_rows[0])
    (cleared,) = ex.execute("i", f"Clear({c0}, t={r0})")
    t_field = holder.field("i", "t")
    left = [v.name for v in t_field.views.values() if v.get_bit(r0, c0)]
    del t_field
    if not cleared or left:
        raise AssertionError(f"time: Clear({c0}, t={r0}) left the bit in {left}")
    truth.write(w_rows[:1], cand[:1], np.full(1, T_WRITE_HOUR), sign=-1)
    q = f"Count(Row(t={r0}, {w_arg('hours16')}))"
    if ex.execute("i", q) != [truth.count(r0, *win["hours16"])]:
        raise AssertionError(f"time: {q} after the Clear differs from numpy")
    # Store a window as a row of a new field s
    name, r = "day_hours", 4
    want = truth.count(r, *win[name])
    res = ex.execute("i", f"Store(Row(t={r}, {w_arg(name)}), s=0) Count(Row(s=0))")
    if res[1] != want or holder.field("i", "s") is None:
        raise AssertionError(f"time: Store then Count(Row(s=0)) {res} != {want}")
    # row attributes, TopN by attribute (maintained counts, then the masked scan)
    b0 = dict(tk.LAUNCHES)
    x = T_F_ROWS[0]
    res = ex.execute("i", 'SetRowAttrs(t, 1, tier="gold") SetRowAttrs(t, 4, tier="silver") '
                          'TopN(t, attrName=tier, attrValues=["gold"]) '
                          f'TopN(t, Row(f={x}), attrName=tier)')
    want_f = sorted(((r_, int(truth.hist_f[x][r_].sum())) for r_ in (1, 4)),
                    key=lambda p: (-p[1], p[0]))
    if ([(p.id, p.count) for p in res[2]] != [(1, truth.total(1))]
            or [(p.id, p.count) for p in res[3]] != want_f):
        raise AssertionError(f"time: TopN by attribute {res[2:]} != {want_f}")
    expect("filtered TopN of t", launched(b0, "masked_row_scan"), {"masked_row_scan": 1})
    # Options
    res = result_to_json(ex.execute(
        "i", f"Options(Row(t=1, {w_arg('day')}), excludeColumns=true) "
             f"Options(Row(t=1, {w_arg('day')}), excludeRowAttrs=true)"))
    if res[0] != {"attrs": {"tier": "gold"}, "columns": []} or res[1]["attrs"] != {} \
            or len(res[1]["columns"]) != truth.count(1, *win["day"]):
        raise AssertionError(f"time: Options -> {str(res)[:200]}")
    log("time: Clear left the bit in no view; Store, SetRowAttrs with TopN by attribute and "
        "Options equal numpy")

    # -- delete t: its stacks leave the card and the budget
    budget = membudget.default_budget(device)
    t_field = holder.field("i", "t")
    live = sum(e["dev"].numel() * e["dev"].element_size()
               for _, e in list(ex._stacks.get(t_field, {}).items()))
    n_live = len(ex._stacks.get(t_field, {}))
    del t_field
    gc.collect()
    if on_card:
        torch.cuda.synchronize()
    used0 = budget.snapshot()["usedBytes"]
    alloc0 = torch.cuda.memory_allocated() if on_card else 0
    t0 = time.perf_counter()
    if not holder.index("i").delete_field("t"):
        raise AssertionError("time: delete_field('t') found no field")
    gc.collect()
    lat["delete_s"] = time.perf_counter() - t0
    if on_card:
        torch.cuda.synchronize()
    used1 = budget.snapshot()["usedBytes"]
    alloc1 = torch.cuda.memory_allocated() if on_card else 0
    if used0 - used1 < live or (on_card and alloc0 - alloc1 < live):
        raise AssertionError(f"time: deleting t freed {used0 - used1} budget bytes and "
                             f"{alloc0 - alloc1} card bytes, less than its {live} live")
    lat.update(deleted_stacks=n_live, deleted_bytes=live, budget_freed=used0 - used1,
               card_freed=alloc0 - alloc1)
    t_new = holder.index("i").create_field(
        "t", FieldOptions(field_type="time", time_quantum="YMDH"))
    t_new.import_bits([2, 2, 5], [11, 12, 13], timestamps=np.array(
        ["2024-01-01T10", "2024-01-01T11", "2023-03-01T00"], dtype="datetime64[h]"))
    del t_new
    q = f"Count(Row(t=2, {w_arg('hours16')}))"
    if ex.execute("i", f"{q} {q}") != [2, 2]:
        raise AssertionError(f"time: {q} over the new t is not its own data")
    log(f"time: t deleted: {n_live} live stacks of {live / 1e9:.3f} GB; the budget freed "
        f"{(used0 - used1) / 1e9:.3f} GB and the card {(alloc0 - alloc1) / 1e9:.3f} GB; a new "
        "t answers from its own data")
    lat["path_s"] = time.perf_counter() - t_path
    log(f"time path: {lat['path_s']:.1f} s (import {lat['import_s']:.2f} s)")
    return lat


# ---------------------------------------------------------------------------
# The http path: one node serving the storage path's directory over HTTP
# ---------------------------------------------------------------------------

HTTP_CLIENTS = 16
# the http path's 16-client window (5 s before the loadgen path needed the
# time; a depth cut, see DEPTH_CUTS)
HTTP_SECONDS = 4.0
HTTP_WARM_REPS = 3
# the 64-row field the http path imports through import-roaring, its shards
R_IMPORT_ROWS, R_IMPORT_SHARDS = 64, 8
# (row, column, timestamp) pairs of the JSON import into a YMDH field (2^20
# before the loadgen path and the batched sum needed the time; a depth cut,
# see DEPTH_CUTS)
TT_PAIRS = 1 << 18
TT_ROWS, TT_HOURS = 4, 6
# values of the JSON import into an int field
U_VALUES = 1 << 18


def norm_answer(a):
    """An :func:`answer_of` answer in the form :func:`norm_json` gives the
    same result's JSON: rows by columns (or keys), pairs and groups by id
    (or key) and count."""
    if isinstance(a, tuple) and len(a) == 2 and isinstance(a[0], list):
        return ("row", a[1] if a[1] is not None else a[0])
    if isinstance(a, tuple) and len(a) == 2:
        return ("vc", a[0], a[1])
    if isinstance(a, list):
        out = []
        for e in a:
            if isinstance(e, tuple) and len(e) == 3 and isinstance(e[0], tuple):
                out.append(("group", tuple(k if k is not None else i
                                           for i, k in zip(e[0], e[2])), e[1]))
            elif isinstance(e, tuple) and len(e) == 3:
                out.append(("pair", e[2] if e[2] is not None else e[0], e[1]))
            else:
                out.append(norm_answer(e))
        return out
    return a


def norm_json(j):
    """One result of an HTTP answer in :func:`norm_answer`'s form."""
    if isinstance(j, dict) and "value" in j:
        return ("vc", j["value"], j["count"])
    if isinstance(j, dict) and ("columns" in j or "keys" in j):
        return ("row", j["keys"] if "keys" in j else j["columns"])
    if isinstance(j, list):
        out = []
        for e in j:
            if isinstance(e, dict) and "group" in e:
                out.append(("group", tuple(g.get("rowKey", g.get("rowID"))
                                           for g in e["group"]), e["count"]))
            elif isinstance(e, dict) and "count" in e:
                out.append(("pair", e.get("key", e.get("id")), e["count"]))
            else:
                out.append(norm_json(e))
        return out
    return j


class HttpClient:
    """One keep-alive connection to a node: ``post``/``get`` return
    ``(status, body bytes)``; ``query`` the decoded results of a PQL body."""

    def __init__(self, port: int, timeout: float = 120.0):
        import http.client

        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)

    def request(self, method, path, body=None, ctype="application/json", headers=None):
        self.conn.request(method, path, body=body,
                          headers={"Content-Type": ctype, **(headers or {})})
        r = self.conn.getresponse()
        return r.status, r.read()

    def get(self, path):
        return self.request("GET", path)

    def post(self, path, body, ctype="application/json", headers=None):
        if isinstance(body, (dict, list)):
            body = json.dumps(body).encode()
        elif isinstance(body, str):
            body = body.encode()
        return self.request("POST", path, body, ctype, headers)

    def query(self, index, pql):
        code, body = self.post(f"/index/{index}/query", pql, "text/plain")
        if code != 200:
            raise AssertionError(f"http: {pql[:80]}: {code} {body[:300]!r}")
        return json.loads(body)["results"]

    def close(self):
        self.conn.close()


def http_reads(truth, keyed, h_rows, sel_rows, bsi):
    """The reads the http path posts, each ``(name, PQL body, index, answer
    in norm_answer form)``: a 1024-call pair Count body, a tree Count, a
    selective 8-row Intersect bitmap, the TopNs, GroupBy f x h, a range
    Count, Sum, Min and Max on v, and a keyed filtered TopN."""
    h_tan, h_filt = h_rows
    pair_body = " ".join(f"Count({op}(Row(f={a}), Row(f={b})))" for op, a, b in truth["items"])
    sel_q = "Intersect(" + ", ".join(f"Row(f={r})" for r in sel_rows[0]) + ")"
    k_name, k_q, _, k_want = keyed
    return [
        ("tanimoto TopN", f"TopN(f, Row(h={h_tan}), n=10, tanimotoThreshold=10)", "i",
         norm_answer(truth["tanimoto"])),
        ("filtered TopN", f"TopN(f, Row(h={h_filt}), n=10)", "i", norm_answer(truth["filtered"])),
        (f"{len(truth['items'])} pair Counts", pair_body, "i", truth["pairs"]),
        ("GroupBy f x h", "GroupBy(Rows(f), Rows(h))", "i", norm_answer(truth["groupby"])),
        ("tree Count", "Count(Union(Intersect(Row(f=1), Row(h=2)), "
         "Difference(Row(f=3), Row(f=4))))", "i", truth["tree"]),
        ("8-row Intersect", sel_q, "i", ("row", sel_rows[1])),
        ("range Count on v", "Count(Row(v < 500000))", "i", truth["range"]),
        ("Sum of v", "Sum(field=v)", "i", ("vc",) + tuple(truth["sum"])),
        ("Min of v", "Min(field=v)", "i", ("vc",) + tuple(bsi["min"])),
        ("Max of v", "Max(field=v)", "i", ("vc",) + tuple(bsi["max"])),
        ("keyed " + k_name, k_q, "k", norm_answer(k_want)),
    ]


def http_path(pool, device, hand, v_truth):
    """One node over HTTP (``server/node.py``, ``server/http.py``,
    ``server/api.py``) on the storage path's directory:

    1. boot: ``NodeServer`` in-process on the directory (port 0, the
       metric service expvar), timed to the first answer (``open``, then a
       first Count, whose stacks are built then);
    2. reads, cold and warm, each answer against numpy over the written
       data, and each warm one beside the same query in-process on the
       node's executor (the cost of HTTP): the 1024-call pair body, a tree
       Count, a selective 8-row Intersect bitmap (about 2.5 k columns),
       the tanimoto and filtered TopNs, GroupBy f x h, a range Count, Sum,
       Min and Max on v, and a keyed TopN on the 2^20-key index;
    3. concurrency: 16 client threads on keep-alive connections post a
       mixed read mix for 5 s, every answer equal to its serial answer:
       queries/s and p50/p99 latency;
    4. writes, each read back over HTTP against numpy: import-roaring of a
       new 64-row field r on 8 shards at 25 % density (MB/s, bits/s), a
       JSON import of 2^20 (row, column, timestamp) pairs over 6 hours
       into a YMDH field (pairs/s; read back through windowed Counts), a
       JSON import of values into an int field (both fields deleted
       after), and /export of one shard of h;
    5. the node's reports: /debug/vars' kernels block equals ``LAUNCHES``,
       /metrics parses, /debug/fragments lists f's 160 fragments with
       their residency, and a DELETE of r frees its stacks' bytes on the
       card and in the budget;
    6. the CLI: the node stopped and its tensors released, ``python -m
       pilosa_tpu_torch.cli server`` on the directory as a subprocess:
       /status, one Count against its truth, its launch in /debug/vars,
       then SIGTERM, and exit 0 within 30 s."""
    import gc
    import re
    import signal
    import socket
    import threading

    import numpy as np
    import torch

    from pilosa_tpu_torch.core import membudget
    from pilosa_tpu_torch.exec.result import result_to_json
    from pilosa_tpu_torch.obs.stats import MemStatsClient
    from pilosa_tpu_torch.ops import kernels as tk
    from pilosa_tpu_torch.server.node import NodeServer
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
    from pilosa_tpu_torch.storage import roaring

    on_card = torch.device(device).type == "cuda"
    t_path = time.perf_counter()
    out = {}
    data_dir = hand["data_dir"]
    f_np, h_np = hand["f"], hand["h"]
    vals, exv = v_truth
    rng = np.random.default_rng(SEED + 21)
    t0 = time.perf_counter()
    truth = truths_of(pool, f_np, h_np, v_truth, hand["items"], hand["h_rows"])
    truth["items"] = hand["items"]
    bsi = {"min": truth_extreme(pool, vals, lambda s: exv[s], False),
           "max": truth_extreme(pool, vals, lambda s: exv[s], True)}
    sel = [int(r) for r in rng.choice(f_np.shape[1], 8, replace=False)]
    sel_words = np.bitwise_and.reduce(f_np[:, sel], axis=1)
    sel_cols = [s * SHARD_WIDTH + int(c) for s in range(S_FULL)
                for c in np.flatnonzero(np.unpackbits(sel_words[s].view(np.uint8),
                                                      bitorder="little"))]
    keyed = [r for r in hand["keyed_reads"]() if r[0].startswith("filtered TopN")][0]
    reads = http_reads(truth, keyed, hand["h_rows"], (sel, sel_cols), bsi)
    # the serving path serves the same reads
    hand.update(reads=reads, truth=truth, sel=(sel, sel_cols))
    out["truth_s"] = time.perf_counter() - t0
    log(f"http: truths in {out['truth_s']:.1f} s; the 8-row Intersect holds "
        f"{len(sel_cols)} columns")

    def release():
        gc.collect()
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    # -- 1. boot
    t0 = time.perf_counter()
    # the serving plane cut down, so this path's numbers stay comparable
    # across versions; the serving path below runs the defaults
    node = NodeServer(data_dir=data_dir, device=device, port=0, stats_client=MemStatsClient(),
                      batch_window=0, rescache_entries=0, planner_enabled=False)
    out["open_s"] = time.perf_counter() - t0
    node.start()
    ex = node.api.executor
    ex._BSI_SINGLE_WARM = 0  # a lone range Count takes the stack at once, as in storage
    cli = HttpClient(node.server.port)
    try:
        first = cli.query("i", "Count(Row(h=0))")
        out["boot_to_first_answer_s"] = time.perf_counter() - t0
        want = int(np.bitwise_count(h_np[:, 0]).sum(dtype=np.int64))
        if first != [want]:
            raise AssertionError(f"http: first Count {first} != {want}")
        log(f"http: node open in {out['open_s']:.2f} s, first answer at "
            f"{out['boot_to_first_answer_s']:.2f} s")

        # -- 2. reads, cold and warm, beside in-process
        lat = {}
        for name, q, index, want in reads:
            before = dict(tk.LAUNCHES)
            t = time.perf_counter()
            got = cli.query(index, q)
            cold = (time.perf_counter() - t) * 1e3
            made = {k: tk.LAUNCHES[k] - before[k] for k in tk.LAUNCHES
                    if tk.LAUNCHES[k] > before[k]}
            # the pair body answers one Count a call, every other read one result
            norm = got if name.endswith("pair Counts") else norm_json(got[0])
            if norm != want:
                raise AssertionError(f"http: {name}: {str(norm)[:200]} != {str(want)[:200]}")
            warm = []
            for _ in range(HTTP_WARM_REPS):
                t = time.perf_counter()
                again = cli.query(index, q)
                warm.append((time.perf_counter() - t) * 1e3)
                if again != got:
                    raise AssertionError(f"http: {name}: a warm answer differs")
            inproc = []
            for _ in range(HTTP_WARM_REPS):
                t = time.perf_counter()
                res = ex.execute(index, q)
                inproc.append((time.perf_counter() - t) * 1e3)
            if result_to_json(res) != got:
                raise AssertionError(f"http: {name}: the in-process answer differs")
            lat[name] = {"cold_ms": cold, "warm_ms": statistics.median(warm),
                         "inproc_ms": statistics.median(inproc), "cold_launches": made}
            log(f"  http: {name}: cold {cold:.2f} ms, warm {lat[name]['warm_ms']:.3f} ms, "
                f"in-process {lat[name]['inproc_ms']:.3f} ms, launches {made}")
        out["reads"] = lat
        pair_name = reads[2][0]
        out["pair_body_qps"] = len(truth["items"]) / (lat[pair_name]["warm_ms"] / 1e3)

        # -- 3. concurrency: serial answers first, then 16 clients
        mix = read_mix(reads, hand["items"])
        serial = {n: cli.query(index, q) for n, q, index in mix}
        stop = time.perf_counter() + HTTP_SECONDS
        lats: list = [[] for _ in range(HTTP_CLIENTS)]
        errors: list = []

        def client(c):
            conn = HttpClient(node.server.port)
            crng = np.random.default_rng(SEED + 100 + c)
            try:
                while time.perf_counter() < stop:
                    n, q, index = mix[int(crng.integers(0, len(mix)))]
                    t = time.perf_counter()
                    got = conn.query(index, q)
                    lats[c].append(time.perf_counter() - t)
                    if got != serial[n]:
                        errors.append(f"{n}: {str(got)[:100]}")
                        return
            except Exception as e:  # reported below, after every client stopped
                errors.append(repr(e))
            finally:
                conn.close()

        t = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,)) for c in range(HTTP_CLIENTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=HTTP_SECONDS + 120)
        wall = time.perf_counter() - t
        if any(th.is_alive() for th in threads) or errors:
            raise AssertionError(f"http: concurrent clients: {errors[:3]}")
        every = np.array([x for per in lats for x in per]) * 1e3
        out["concurrency"] = {
            "clients": HTTP_CLIENTS, "seconds": wall, "queries": int(every.size),
            "qps": every.size / wall, "p50_ms": float(np.percentile(every, 50)),
            "p99_ms": float(np.percentile(every, 99)), "mix": len(mix),
        }
        log(f"http: {HTTP_CLIENTS} clients: {every.size} queries in {wall:.1f} s, "
            f"{out['concurrency']['qps']:.0f} queries/s, p50 {out['concurrency']['p50_ms']:.2f} "
            f"ms, p99 {out['concurrency']['p99_ms']:.2f} ms, all equal to the serial answers")

        # -- 4. writes
        code, body = cli.post("/index/i/field/r", {})
        if code != 200:
            raise AssertionError(f"http: create r: {code} {body!r}")
        r_words = random_words(rng, (R_IMPORT_SHARDS, R_IMPORT_ROWS, W_FULL), dense=True)
        payloads = [roaring.serialize_rows(np.arange(R_IMPORT_ROWS, dtype=np.uint64),
                                           r_words[s]) for s in range(R_IMPORT_SHARDS)]
        n_bits = int(np.bitwise_count(r_words).sum(dtype=np.int64))
        t = time.perf_counter()
        changed = 0
        for s, data in enumerate(payloads):
            code, body = cli.post(f"/index/i/field/r/import-roaring/{s}", data,
                                  "application/octet-stream")
            if code != 200:
                raise AssertionError(f"http: import-roaring {s}: {code} {body[:200]!r}")
            changed += json.loads(body)["changed"]
        dt = time.perf_counter() - t
        n_bytes = sum(len(d) for d in payloads)
        if changed != n_bits:
            raise AssertionError(f"http: import-roaring changed {changed}, wrote {n_bits} bits")
        r_rows = [int(x) for x in rng.choice(R_IMPORT_ROWS, 4, replace=False)]
        got = cli.query("i", " ".join(f"Count(Row(r={x}))" for x in r_rows))
        want = [int(np.bitwise_count(r_words[:, x]).sum(dtype=np.int64)) for x in r_rows]
        if got != want:
            raise AssertionError(f"http: import-roaring read back {got} != {want}")
        out["import_roaring"] = {"bytes": n_bytes, "bits": n_bits, "seconds": dt,
                                 "mb_per_s": n_bytes / dt / 1e6, "bits_per_s": n_bits / dt}
        log(f"http: import-roaring of {n_bits} bits, {n_bytes / 1e6:.1f} MB on "
            f"{R_IMPORT_SHARDS} shards in {dt:.2f} s: {n_bytes / dt / 1e6:.1f} MB/s, "
            f"{n_bits / dt / 1e6:.1f} M bits/s")

        # a pair batch on r builds its stack, which the DELETE below frees
        got = cli.query("i", " ".join(f"Count(Intersect(Row(r={a}), Row(r={b})))"
                                      for a, b in zip(r_rows, r_rows[1:])))
        want = [int(np.bitwise_count(r_words[:, a] & r_words[:, b]).sum(dtype=np.int64))
                for a, b in zip(r_rows, r_rows[1:])]
        if got != want:
            raise AssertionError(f"http: pair Counts on r {got} != {want}")
        del payloads

        code, body = cli.post("/index/i/field/tt", {"options": {"type": "time",
                                                               "timeQuantum": "YMDH"}})
        if code != 200:
            raise AssertionError(f"http: create tt: {code} {body!r}")
        tt_rows = rng.integers(0, TT_ROWS, TT_PAIRS)
        tt_cols = rng.integers(0, S_FULL * SHARD_WIDTH, TT_PAIRS)
        tt_hours = rng.integers(0, TT_HOURS, TT_PAIRS)
        stamps = [f"2024-01-{1 + h // 24:02d}T{h % 24:02d}:00" for h in range(TT_HOURS)]
        body = json.dumps({"rowIDs": tt_rows.tolist(), "columnIDs": tt_cols.tolist(),
                           "timestamps": [stamps[h] for h in tt_hours.tolist()]}).encode()
        t = time.perf_counter()
        code, resp = cli.post("/index/i/field/tt/import", body)
        dt = time.perf_counter() - t
        if code != 200:
            raise AssertionError(f"http: time import: {code} {resp[:200]!r}")
        out["import_json_time"] = {"pairs": TT_PAIRS, "bytes": len(body), "seconds": dt,
                                   "pairs_per_s": TT_PAIRS / dt}
        windows = [(0, TT_HOURS), (1, 4), (2, 3), (5, 6)]
        qs, want = [], []
        for r in range(TT_ROWS):
            for a, b in windows:
                lo = f"2024-01-{1 + a // 24:02d}T{a % 24:02d}:00"
                hi = f"2024-01-{1 + b // 24:02d}T{b % 24:02d}:00"
                qs.append(f"Count(Row(tt={r}, from={lo}, to={hi}))")
                m = (tt_rows == r) & (tt_hours >= a) & (tt_hours < b)
                want.append(int(np.unique(tt_cols[m]).size))
        got = cli.query("i", " ".join(qs))
        if got != want:
            raise AssertionError(f"http: windowed Counts {got} != {want}")
        log(f"http: JSON import of {TT_PAIRS} timestamped pairs ({len(body) / 1e6:.1f} MB) in "
            f"{dt:.2f} s: {TT_PAIRS / dt:.0f} pairs/s; {len(qs)} windowed Counts equal numpy")
        del body

        code, body = cli.post("/index/i/field/u", {"options": {"type": "int", "min": -1000,
                                                              "max": 1_000_000}})
        if code != 200:
            raise AssertionError(f"http: create u: {code} {body!r}")
        u_cols = rng.choice(S_FULL * SHARD_WIDTH, U_VALUES, replace=False)
        u_vals = rng.integers(-1000, 1_000_001, U_VALUES)
        t = time.perf_counter()
        code, resp = cli.post("/index/i/field/u/import", {"columnIDs": u_cols.tolist(),
                                                          "values": u_vals.tolist()})
        out["import_json_values_s"] = time.perf_counter() - t
        if code != 200:
            raise AssertionError(f"http: value import: {code} {resp[:200]!r}")
        got = cli.query("i", "Sum(field=u) Count(Row(u > 500000)) Min(field=u)")
        want = [{"value": int(u_vals.sum()), "count": U_VALUES}, int((u_vals > 500_000).sum()),
                {"value": int(u_vals.min()), "count": int((u_vals == u_vals.min()).sum())}]
        if got != want:
            raise AssertionError(f"http: int field u read back {got} != {want}")

        s_exp = int(rng.integers(0, S_FULL))
        t = time.perf_counter()
        code, csv = cli.get(f"/export?index=i&field=h&shard={s_exp}")
        out["export_s"] = time.perf_counter() - t
        want_lines = [f"{r},{s_exp * SHARD_WIDTH + int(c)}" for r in range(H_ROWS)
                      for c in np.flatnonzero(np.unpackbits(h_np[s_exp, r].view(np.uint8),
                                                            bitorder="little"))]
        if code != 200 or csv.decode().splitlines() != want_lines:
            raise AssertionError(f"http: export of h shard {s_exp} differs from numpy")
        log(f"http: values into u and /export of h shard {s_exp} ({len(want_lines)} lines, "
            f"{out['export_s']:.2f} s) equal numpy")
        # the written fields go, so the CLI below opens what the node opened
        for fld in ("tt", "u"):
            code, body = cli.request("DELETE", f"/index/i/field/{fld}")
            if code != 200:
                raise AssertionError(f"http: DELETE {fld}: {code} {body!r}")

        # -- 5. the node's reports
        code, body = cli.get("/debug/vars")
        kern = json.loads(body)["kernels"]
        launched = {k: v["launches"] for k, v in kern.items()}
        if launched != dict(tk.LAUNCHES):
            raise AssertionError(f"http: /debug/vars kernels {launched} != {tk.LAUNCHES}")
        if on_card and any(v["launches"] and v["deviceMs"] <= 0 for v in kern.values()):
            raise AssertionError(f"http: a launched kernel has no device ms: {kern}")
        out["debug_vars_kernels"] = kern
        # the ledger's device ms a launch (its CUDA event pairs), beside
        # each kernel's own device time in the kernel line
        out["ledger_ms_per_launch"] = {k: v["deviceMs"] / v["launches"]
                                       for k, v in kern.items() if v["launches"]}
        log(f"http: the ledger's device ms a launch {json.dumps(out['ledger_ms_per_launch'])}")
        code, text = cli.get("/metrics")
        for line in text.decode().splitlines():
            if line and not line.startswith("#") and not re.match(
                    r"^[a-zA-Z_:][\w:]*(\{.*\})? \S+( # .*)?$", line):
                raise AssertionError(f"http: /metrics line does not parse: {line[:120]}")
        t = time.perf_counter()
        code, body = cli.get("/debug/fragments?index=i&field=f")
        out["debug_fragments_s"] = time.perf_counter() - t
        frags = json.loads(body)
        if code != 200 or frags["totals"]["fragments"] != S_FULL:
            raise AssertionError(f"http: /debug/fragments lists {frags['totals']}")
        out["f_fragments_resident"] = frags["totals"]["deviceResident"]
        out["f_bits"] = frags["totals"]["bits"]
        if out["f_bits"] != int(np.bitwise_count(f_np).sum(dtype=np.int64)):
            raise AssertionError("http: /debug/fragments counts other bits than numpy")
        budget = membudget.default_budget()
        release()
        used0 = budget.used()
        alloc0 = torch.cuda.memory_allocated() if on_card else 0
        code, body = cli.request("DELETE", "/index/i/field/r")
        if code != 200:
            raise AssertionError(f"http: DELETE r: {code} {body!r}")
        release()
        freed = used0 - budget.used()
        r_stack = R_IMPORT_ROWS * S_FULL * W_FULL * 4
        if freed < r_stack or (on_card and alloc0 - torch.cuda.memory_allocated() < r_stack):
            raise AssertionError(f"http: DELETE r freed {freed} bytes of the budget, "
                                 f"{alloc0 - torch.cuda.memory_allocated() if on_card else 0} "
                                 f"on the card; its stack holds {r_stack}")
        out["delete_freed_bytes"] = freed
        log(f"http: /debug/vars kernels equal LAUNCHES, /metrics parses, /debug/fragments "
            f"lists {S_FULL} fragments of f ({out['f_fragments_resident']} on the card) in "
            f"{out['debug_fragments_s']:.2f} s, DELETE r freed {freed} bytes")
    finally:
        cli.close()
        node.stop()
    del node, ex
    release()

    # -- 6. the CLI, on the same directory
    with socket.socket() as so:
        so.bind(("127.0.0.1", 0))
        port = so.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(HERE))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "pilosa_tpu_torch.cli", "server", "-d", data_dir,
         "--bind", f"127.0.0.1:{port}", "--device", device],
        cwd=HERE, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        while True:
            try:
                sc = HttpClient(port, timeout=10)
                code, _ = sc.get("/status")
                break
            except OSError:
                if proc.poll() is not None:
                    raise AssertionError(f"http: the CLI server exited: {proc.communicate()}")
                if time.perf_counter() - t0 > 120:
                    raise AssertionError("http: the CLI server did not answer in 120 s")
                time.sleep(0.2)
        out["cli_boot_s"] = time.perf_counter() - t0
        # two pair Counts of f in one body: a stack of f and one gram launch
        calls = [f"Count({op}(Row(f={a}), Row(f={b})))" for op, a, b in hand["items"][:2]]
        got = sc.query("i", " ".join(calls) + " Count(Row(h=1))")
        want = truth["pairs"][:2] + [int(np.bitwise_count(h_np[:, 1]).sum(dtype=np.int64))]
        if code != 200 or got != want:
            raise AssertionError(f"http: the CLI server answered {got}, not {want}")
        kern = json.loads(sc.get("/debug/vars")[1])["kernels"]
        if on_card and sum(v["launches"] for v in kern.values()) < 1:
            raise AssertionError(f"http: the CLI server launched nothing: {kern}")
        sc.close()
        t = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        stdout, stderr = proc.communicate(timeout=30)
        out["cli_stop_s"] = time.perf_counter() - t
        if proc.returncode != 0:
            raise AssertionError(f"http: the CLI server exited {proc.returncode}: {stderr[-500:]}")
        out["cli_launches"] = {k: v["launches"] for k, v in kern.items() if v["launches"]}
        log(f"http: CLI server up in {out['cli_boot_s']:.1f} s, answered, launches "
            f"{out['cli_launches']}, stopped by SIGTERM in {out['cli_stop_s']:.1f} s (exit 0)")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
    out["path_s"] = time.perf_counter() - t_path
    log(f"http path: {out['path_s']:.1f} s")
    return out


def read_mix(reads, items):
    """The 25-query read mix of the http and serving paths: every read of
    :func:`http_reads` but the pair body and the GroupBy, and 16 lone pair
    Counts, each ``(name, PQL, index)``."""
    mix = [(n, q, index) for n, q, index, _ in reads
           if not n.endswith("pair Counts") and not n.startswith("GroupBy")]
    mix += [(f"pair {k}", f"Count({op}(Row(f={a}), Row(f={b})))", "i")
            for k, (op, a, b) in enumerate(items[:16])]
    return mix


SERVE_CLIENTS = 16
# each of the serving path's two 16-client windows (10 s before the
# cluster path's elastic steps needed the time, 5 s before the loadgen
# path did), the defaults' window and the QoS tenants' (4 s each before)
SERVE_SECONDS = 4.0
SERVE_DEFAULT_SECONDS = 3.0
QOS_SECONDS = 3.0
QOS_LEAVES = 300
PLANNER_FLIGHT = 64
INGEST_CLIENTS = 4
# steps of the prefetch phase's reads alone, and at least as many beside an import
IMPORT_READ_STEPS = 4
# steps of the prefetch phase, alternating shard sets; odd, so the last is
# over all shards
PREFETCH_STEPS = 5


def busy_union_us(intervals):
    """Microseconds covered by the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for a, b in sorted(intervals):
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def serving_path(pool, device, hand, v_truth):
    """One node at JAX's serving defaults (``server/batcher.py``,
    ``exec/rescache.py``, ``exec/planner.py``, ``server/qos.py``,
    ``server/prefetch.py``, ``ingest/``) on the storage path's directory:

    1. boot, the defaults checked, and the 25-query read mix answered
       once against numpy (its serial answers);
    2. coalescing: 16 keep-alive clients for 10 s with the result cache
       emptied, through the batcher and then with it off (the API's
       ``batch_window=0`` route): queries/s, p50/p99, flights, their sizes
       and close reasons, launches per query by kernel, every answer equal
       to its serial one; on the card ``torch.profiler`` over each run for
       the device's idle share (1 - the union of the card's activity
       intervals over wall time) and its kernels' ms per launch beside the
       ledger's, and the prefetches issued, useful and wasted; then the
       defaults whole (cache on) for 4 s;
    3. the result cache: the mix again from the cache with no launch; a
       Set on f drops exactly the entries reading f and the next answers
       equal numpy after it; SetRowAttrs and a TopN by that attribute;
    4. the planner: 64 queries sharing an ``Intersect(Row(f=..),
       Row(h=..))`` posted at once over HTTP while a lone query's flight
       holds the dispatcher, so the batcher forms one flight of 64 (its
       window widened for the phase, so a pause of the dispatcher thread
       does not close it on age before it pops the 64); with
       the planner on and off, twice each: the flight's dispatch time, its
       launches, cseHits and cseShared, every answer equal to numpy;
    5. prefetch: a cap that holds one of f's stacks over all shards and
       over all but one, and steps of 4 clients posting at once,
       alternating between them: issued, useful and wasted from
       /debug/vars (useful/issued >= 0.5), answers exact;
    6. ingest: import-roaring of a 64-row field on 8 shards through the
       pipeline from 4 clients: MB/s, bits/s, uploads, coalesced uploads,
       overlap, ``upload_errors == 0``, the fragments' device copies in
       the budget, every row read back exactly; then step 5's steps of
       pair Counts, 4 alone and as many as fit beside the same import
       again: p50/p99, prefetches issued, useful, wasted and claimed by a
       dispatch, answers exact;
    7. QoS: tenants by header, one sending 300-leaf Counts and GroupBys,
       one lone Counts: /debug/qos, each tenant's debt equal to its device
       ms in the ledger, any degraded answer marked."""
    import gc
    import threading

    import numpy as np
    import torch

    from pilosa_tpu_torch.core import membudget, residency
    from pilosa_tpu_torch.obs import devledger
    from pilosa_tpu_torch.obs.stats import MemStatsClient
    from pilosa_tpu_torch.ops import kernels as tk
    from pilosa_tpu_torch.server.node import NodeServer
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
    from pilosa_tpu_torch.storage import roaring

    on_card = torch.device(device).type == "cuda"
    t_path = time.perf_counter()
    out = {}
    f_np, h_np = hand["f"], hand["h"]
    reads, truth, items = hand["reads"], hand["truth"], hand["items"]
    mix = read_mix(reads, items)
    want_of = {n: w for n, _, _, w in reads}
    for k in range(16):
        want_of[f"pair {k}"] = truth["pairs"][k]
    rng = np.random.default_rng(SEED + 31)

    def check(name, got):
        norm = norm_json(got[0]) if not name.startswith("pair ") else got[0]
        if norm != want_of[name]:
            raise AssertionError(f"serving: {name}: {str(norm)[:200]} != "
                                 f"{str(want_of[name])[:2000]}")

    # -- 1. boot at the defaults
    t0 = time.perf_counter()
    node = NodeServer(data_dir=hand["data_dir"], device=device, port=0,
                      stats_client=MemStatsClient())
    node.start()
    out["open_s"] = time.perf_counter() - t0
    api, ex = node.api, node.api.executor
    ex._BSI_SINGLE_WARM = 0  # as on the http path
    b = api.batcher
    if not (b is not None and b.window == 0.002 and b.max_batch == 64 and api.qos is not None
            and api.qos.enabled and ex.rescache.max_entries == 512 and ex.planner.enabled
            and api.prefetcher is not None and api.ingest.uploader is not None):
        raise AssertionError("serving: the node is not at the serving defaults")
    cli = HttpClient(node.server.port)
    flights: list = []
    dispatch = b._dispatch
    # while it holds a test, the next flight waits in the dispatcher until
    # the test passes (as a flight in progress holds the dispatcher while
    # the next one queues); then it is dropped
    hold: list = []
    holding = threading.Event()

    def counted_dispatch(batch, reason):
        if hold:
            until = hold.pop()
            holding.set()
            t_end = time.perf_counter() + 60
            while not until() and time.perf_counter() < t_end:
                time.sleep(0.0005)
        t = time.perf_counter()
        try:
            return dispatch(batch, reason)
        finally:
            flights.append((len(batch), reason, time.perf_counter() - t))

    b._dispatch = counted_dispatch
    try:
        serial = {}
        for n, q, index in mix:
            got = cli.query(index, q)
            check(n, got)
            serial[n] = got
        log(f"serving: node at the defaults open in {out['open_s']:.2f} s; the "
            f"{len(mix)}-query mix equals numpy")

        # -- 2. coalescing, the cache emptied; then the defaults whole
        def clients(seconds, tag):
            ledger0 = tk.telemetry_snapshot()
            launches0 = dict(tk.LAUNCHES)
            n_flights = len(flights)
            res0 = residency.default_tracker().snapshot()
            lats = [[] for _ in range(SERVE_CLIENTS)]
            errors = []
            stop = [0.0]

            def client(c):
                conn = HttpClient(node.server.port)
                crng = np.random.default_rng(SEED + 200 + c)
                try:
                    while time.perf_counter() < stop[0]:
                        n, q, index = mix[int(crng.integers(0, len(mix)))]
                        t = time.perf_counter()
                        got = conn.query(index, q)
                        lats[c].append(time.perf_counter() - t)
                        if got != serial[n]:
                            errors.append(f"{n}: {str(got)[:100]}")
                            return
                except Exception as e:  # reported below, after every client stopped
                    errors.append(repr(e))
                finally:
                    conn.close()

            prof = None
            if on_card:
                from torch.profiler import ProfilerActivity, profile

                prof = profile(activities=[ProfilerActivity.CUDA])
                prof.__enter__()
            t = time.perf_counter()
            stop[0] = t + seconds
            threads = [threading.Thread(target=client, args=(c,))
                       for c in range(SERVE_CLIENTS)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=seconds + 120)
            if on_card:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t
            if prof is not None:
                prof.__exit__(None, None, None)
            if any(th.is_alive() for th in threads) or errors:
                raise AssertionError(f"serving: {tag}: clients: {errors[:3]}")
            every = np.array([x for per in lats for x in per]) * 1e3
            nq = int(every.size)
            made = {k: tk.LAUNCHES[k] - launches0[k] for k in tk.LAUNCHES}
            ledger1 = tk.telemetry_snapshot()
            led_ms = sum(ledger1[k]["deviceMs"] - ledger0[k]["deviceMs"] for k in ledger1)
            led_n = sum(made.values())
            mine = flights[n_flights:]
            reasons = {}
            for _, r, _ in mine:
                reasons[r] = reasons.get(r, 0) + 1
            res1 = residency.default_tracker().snapshot()
            res = {
                "clients": SERVE_CLIENTS, "seconds": wall, "queries": nq,
                "qps": nq / wall, "p50_ms": float(np.percentile(every, 50)),
                "p99_ms": float(np.percentile(every, 99)),
                "flights": len(mine),
                "mean_flight": (sum(x for x, _, _ in mine) / len(mine)) if mine else None,
                "max_flight": max((x for x, _, _ in mine), default=None),
                "close_reasons": reasons,
                "prefetch": {k: res1[k] - res0[k] for k in (
                    "prefetchIssued", "prefetchUseful", "prefetchWasted")},
                "launches_per_query": {k: v / nq for k, v in made.items() if v},
                "ledger_ms_per_launch": led_ms / led_n if led_n else None,
                "idle_share": "not measured",
                "profiler_ms_per_launch": "not measured",
            }
            if prof is not None:
                dev_ev = [e for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA]
                ours = [e for e in dev_ev if "pilosa_" in e.name]
                busy = busy_union_us([(e.time_range.start, e.time_range.end) for e in dev_ev])
                res["idle_share"] = 1.0 - busy / (wall * 1e6)
                res["profiler_kernel_events"] = len(ours)
                res["profiler_ms_per_launch"] = (
                    sum(e.time_range.end - e.time_range.start for e in ours) / len(ours) / 1e3
                    if ours else None)
            log(f"serving: {tag}: {nq} queries in {wall:.1f} s, {res['qps']:.0f} queries/s, "
                f"p50 {res['p50_ms']:.2f} ms, p99 {res['p99_ms']:.2f} ms, {len(mine)} "
                f"flights (mean {res['mean_flight']}, max {res['max_flight']}, closes "
                f"{reasons}), launches a query {json.dumps(res['launches_per_query'])}, "
                f"idle share {res['idle_share']}, ledger ms/launch "
                f"{res['ledger_ms_per_launch']}, profiler ms/launch "
                f"{res['profiler_ms_per_launch']}, prefetch {json.dumps(res['prefetch'])}; "
                f"every answer equal to its serial one")
            return res

        ex.rescache.max_entries = 0
        ex.rescache.clear()
        out["coalesced"] = clients(SERVE_SECONDS, "batcher on, cache emptied")
        api.batcher = None  # the API's direct route, as batch_window=0 gives
        try:
            out["direct"] = clients(SERVE_SECONDS, "batch_window=0, cache emptied")
        finally:
            api.batcher = b
        if out["coalesced"]["max_flight"] is None or out["coalesced"]["max_flight"] < 2:
            raise AssertionError("serving: no flight held more than one query")
        ex.rescache.max_entries = 512
        out["defaults"] = clients(SERVE_DEFAULT_SECONDS, "the defaults (cache on)")

        # -- 3. the result cache
        for n, q, index in mix:  # the entries (most are there already)
            cli.query(index, q)
        hits0, l0 = ex.rescache.hits, dict(tk.LAUNCHES)
        for n, q, index in mix:
            if cli.query(index, q) != serial[n]:
                raise AssertionError(f"serving: cached {n} differs")
        if dict(tk.LAUNCHES) != l0 or ex.rescache.hits - hits0 != len(mix):
            raise AssertionError(f"serving: the repeats launched {tk.LAUNCHES} or hit "
                                 f"{ex.rescache.hits - hits0} of {len(mix)}")
        reading_f = len(ex.rescache._by_field.get(("i", "f"), ()))
        entries0, inv0 = len(ex.rescache), ex.rescache.invalidations
        op, a, b_row = items[0]
        sel_rows = set(hand["sel"][0])
        w_row = next(r for r in range(f_np.shape[1]) if r not in sel_rows)
        s_w = min(3, S_FULL - 1)
        col = int(np.flatnonzero(~np.unpackbits(f_np[s_w, w_row].view(np.uint8),
                                                bitorder="little").astype(bool))[0])
        code, body = cli.post("/index/i/query", f"Set({s_w * SHARD_WIDTH + col}, f={w_row})",
                              "text/plain")
        if code != 200 or json.loads(body)["results"] != [True]:
            raise AssertionError(f"serving: Set: {code} {body!r}")
        f_np[s_w, w_row, col // 32] |= np.uint32(1 << (col % 32))
        dropped = ex.rescache.invalidations - inv0
        if dropped != reading_f or len(ex.rescache) != entries0 - reading_f:
            raise AssertionError(f"serving: the write dropped {dropped} entries; {reading_f} "
                                 f"read f")
        t = time.perf_counter()
        t2 = truths_of(pool, f_np, h_np, v_truth, items[:16], hand["h_rows"])
        truth_s = time.perf_counter() - t
        want_of["tanimoto TopN"] = norm_answer(t2["tanimoto"])
        want_of["filtered TopN"] = norm_answer(t2["filtered"])
        want_of["tree Count"] = t2["tree"]
        for k in range(16):
            want_of[f"pair {k}"] = t2["pairs"][k]
        for n, q, index in mix:
            got = cli.query(index, q)
            check(n, got)
            serial[n] = got
        code, body = cli.post("/index/i/query", 'SetRowAttrs(f, 3, shelf="top")', "text/plain")
        if code != 200:
            raise AssertionError(f"serving: SetRowAttrs: {code} {body!r}")
        got = cli.query("i", 'TopN(f, n=5, attrName="shelf", attrValues=["top"])')
        if got != [[{"id": 3, "count": int(t2["tot"][3])}]]:
            raise AssertionError(f"serving: TopN by attribute {got}")
        out["rescache"] = {"entries_reading_f": reading_f, "dropped_by_write": dropped,
                           "snapshot": ex.rescache.snapshot(), "truth_s": truth_s}
        log(f"serving: the mix again from the cache, no launch; Set on f dropped the "
            f"{dropped} entries reading f of {entries0}; the next answers equal numpy; "
            f"TopN by attribute {got}")

        # -- 4. the planner: one flight of 64 over HTTP sharing one
        # Intersect, with the planner on and off
        pa, hb = 5, 1
        shared = f"Intersect(Row(f={pa}), Row(h={hb}))"
        qs = [f"Count(Union({shared}, Row(f={k})))" for k in range(PLANNER_FLIGHT)]

        def union_counts(s):
            base = f_np[s, pa] & h_np[s, hb]
            return np.bitwise_count(base[None, :] | f_np[s, :PLANNER_FLIGHT]).sum(
                axis=1, dtype=np.int64)

        want = [int(x) for x in sum(by_shard(pool, union_counts))]
        conns = [HttpClient(node.server.port) for _ in range(PLANNER_FLIGHT + 1)]

        def planner_flight(enabled):
            """The 64 queries posted at once from 64 connections while a lone
            query's flight holds the dispatcher, so the batcher forms them
            into one flight: its dispatch time, launches and CSE counters."""
            ex.planner.enabled = enabled
            ex.rescache.clear()
            p0, l0, u0 = ex.planner.snapshot(), dict(tk.LAUNCHES), ex.shared_stack_uploads
            n0 = len(flights)
            got = [None] * PLANNER_FLIGHT
            errs = []

            def post(k):
                try:
                    got[k] = conns[k].query("i", qs[k])[0]
                except Exception as e:  # reported below
                    errs.append(repr(e))

            holding.clear()

            def queued():  # the lone query in dispatch and the 64 behind it
                with b._lock:
                    return b._depth >= PLANNER_FLIGHT + 1

            hold.append(queued)
            lone = threading.Thread(
                target=lambda: conns[-1].query("i", f"Count(Row(h={H_ROWS - 1}))"))
            lone.start()
            if not holding.wait(30):
                raise AssertionError("serving: planner: the lone flight never dispatched")
            ths = [threading.Thread(target=post, args=(k,)) for k in range(PLANNER_FLIGHT)]
            t = time.perf_counter()
            for th in ths:
                th.start()
            for th in ths + [lone]:
                th.join(120)
            wall = time.perf_counter() - t
            if errs or got != want:
                raise AssertionError(f"serving: planner {enabled}: {errs[:2]} {got[:4]} "
                                     f"!= {want[:4]}")
            mine = [x for x in flights[n0:] if x[0] > 1]
            if [x[:2] for x in mine] != [(PLANNER_FLIGHT, "size")]:
                raise AssertionError(f"serving: planner {enabled}: flights {flights[n0:]}")
            p1 = ex.planner.snapshot()
            return {"dispatch_ms": mine[0][2] * 1e3, "wall_ms": wall * 1e3,
                    "launches": {k: v - l0[k] for k, v in tk.LAUNCHES.items() if v - l0[k]},
                    "cseHits": p1["cseHits"] - p0["cseHits"],
                    "cseShared": p1["cseShared"] - p0["cseShared"],
                    "shared_stacks": ex.shared_stack_uploads - u0}

        # the 64 are queued before the window opens, so it closes on size;
        # a wider window only keeps a pause of the dispatcher thread (the
        # interpreter's switch interval is 5 ms) from cutting it on age
        b.window = 0.25
        try:
            runs = [(on, planner_flight(on)) for on in (True, False, True, False)]
        finally:
            b.window = 0.002
            ex.planner.enabled = True
            for c in conns:
                c.close()
        pv = json.loads(cli.get("/debug/vars")[1])["planner"]
        on_runs = [r for on, r in runs if on]
        off_runs = [r for on, r in runs if not on]
        out["planner"] = {"on": on_runs, "off": off_runs, "cseHits": pv["cseHits"],
                          "cseShared": pv["cseShared"]}
        if any(r["cseHits"] < 1 or r["shared_stacks"] != 1
               or (on_card and not r["launches"].get("tree_count")) for r in on_runs):
            raise AssertionError(f"serving: the flight's consumers left the shared stack or "
                                 f"the tree kernel: {on_runs}")
        for on, r in runs:
            log(f"serving: one flight of {PLANNER_FLIGHT} over HTTP sharing {shared}, planner "
                f"{'on' if on else 'off'}: dispatch {r['dispatch_ms']:.2f} ms, all answered in "
                f"{r['wall_ms']:.1f} ms, launches {json.dumps(r['launches'])}, cseHits "
                f"{r['cseHits']}, cseShared {r['cseShared']}, shared stacks "
                f"{r['shared_stacks']}; every answer equal to numpy")

        # -- 5. prefetch under an evicting cap
        budget = membudget.default_budget()
        cap0 = budget.cap
        f_rows = f_np.shape[1]
        # the index's shards (the http path's imports may have reached more
        # than f's): a query without shards stacks over all of them
        n_all = len(ex.holder.index("i").available_shards())
        stack_all = n_all * f_rows * W_FULL * 4
        stack_sub = (n_all - 1) * f_rows * W_FULL * 4
        h_stack = n_all * H_ROWS * W_FULL * 4
        cap = stack_all + stack_sub // 2 + 2 * h_stack
        res0 = json.loads(cli.get("/debug/vars")[1])["residency"]
        budget.set_cap(cap)
        sub = sorted(ex.holder.index("i").available_shards())[1:]
        try:
            # every query a new one (a repeat would come from the result
            # cache, with no flight); the last step over all shards, so f's
            # full stack stays for the QoS phase
            picks = rng.permutation(64 * H_ROWS)
            steps = []
            pconns = [HttpClient(node.server.port) for _ in range(4)]
            for k in range(PREFETCH_STEPS):
                shards = None if k % 2 == 0 else sub
                use = [x for x in sub if x < S_FULL] if shards else range(S_FULL)
                r_k = residency.default_tracker().snapshot()
                answers = [None] * 4
                wants = [None] * 4

                def step_client(j, k=k, shards=shards, use=use):
                    # 4 clients, each one query a step, all at once
                    a_r, h_r = divmod(int(picks[4 * k + j]), H_ROWS)
                    wants[j] = int(sum(np.bitwise_count(f_np[s, a_r] & h_np[s, h_r]).sum(
                        dtype=np.int64) for s in use))
                    q = f"Count(Intersect(Row(f={a_r}), Row(h={h_r})))"
                    body = {"query": q, "shards": shards} if shards else q
                    code, resp = pconns[j].post("/index/i/query", body,
                                                "application/json" if shards else "text/plain")
                    answers[j] = (json.loads(resp)["results"][0] if code == 200
                                  else (code, resp[:200]))

                ths = [threading.Thread(target=step_client, args=(j,)) for j in range(4)]
                for th in ths:
                    th.start()
                for th in ths:
                    th.join(120)
                if answers != wants:
                    raise AssertionError(f"serving: prefetch step {k}: {answers} != {wants}")
                r_k1 = residency.default_tracker().snapshot()
                steps.append({x: r_k1[x] - r_k[x] for x in (
                    "prefetchIssued", "prefetchUseful", "prefetchUploads", "prefetchWasted",
                    "deviceHits", "deviceMisses")})
            for c in pconns:
                c.close()
        finally:
            budget.set_cap(cap0)
        api.ingest.uploader.flush(30)
        res1 = json.loads(cli.get("/debug/vars")[1])["residency"]
        issued = res1["prefetchIssued"] - res0["prefetchIssued"]
        useful = res1["prefetchUseful"] - res0["prefetchUseful"]
        wasted = res1["prefetchWasted"] - res0["prefetchWasted"]
        out["prefetch"] = {"cap": cap, "issued": issued, "useful": useful, "wasted": wasted,
                           "steps": steps,
                           "useful_frac": useful / issued if issued else None,
                           "evictions": ex.stack_evictions,
                           "errors": res1["prefetchErrors"] - res0["prefetchErrors"]}
        if not issued or useful / issued < 0.5 or out["prefetch"]["errors"]:
            raise AssertionError(f"serving: prefetch issued {issued}, useful {useful}, "
                                 f"errors {out['prefetch']['errors']}, by step {steps}")
        log(f"serving: prefetch under a cap of {cap} bytes: issued {issued}, useful {useful} "
            f"({useful / issued:.2f}), wasted {wasted}, stack evictions {ex.stack_evictions}, "
            f"answers exact; "
            f"by step {json.dumps(steps)}")

        # -- 6. ingest through the pipeline
        code, body = cli.post("/index/i/field/r2", {})
        if code != 200:
            raise AssertionError(f"serving: create r2: {code} {body!r}")
        r_words = random_words(rng, (R_IMPORT_SHARDS, R_IMPORT_ROWS, W_FULL), dense=True)
        payloads = [roaring.serialize_rows(np.arange(R_IMPORT_ROWS, dtype=np.uint64),
                                           r_words[s]) for s in range(R_IMPORT_SHARDS)]
        n_bits = int(np.bitwise_count(r_words).sum(dtype=np.int64))
        ing0 = json.loads(cli.get("/debug/vars")[1])["ingest"]
        used0 = budget.used()
        changed = [0] * R_IMPORT_SHARDS
        errs = []

        def importer(c):
            conn = HttpClient(node.server.port)
            try:
                for s in range(c, R_IMPORT_SHARDS, INGEST_CLIENTS):
                    code, body = conn.post(f"/index/i/field/r2/import-roaring/{s}", payloads[s],
                                           "application/octet-stream")
                    if code != 200:
                        errs.append(f"{s}: {code} {body[:200]!r}")
                        return
                    changed[s] = json.loads(body)["changed"]
            finally:
                conn.close()

        t = time.perf_counter()
        ths = [threading.Thread(target=importer, args=(c,)) for c in range(INGEST_CLIENTS)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=300)
        dt = time.perf_counter() - t
        api.ingest.uploader.flush(60)
        if errs or sum(changed) != n_bits:
            raise AssertionError(f"serving: import {errs[:2]} changed {sum(changed)} of {n_bits}")
        ing1 = json.loads(cli.get("/debug/vars")[1])["ingest"]
        up0, up1 = ing0["uploader"], ing1["uploader"]
        n_bytes = sum(len(d) for d in payloads)
        out["ingest"] = {
            "bytes": n_bytes, "bits": n_bits, "seconds": dt, "mb_per_s": n_bytes / dt / 1e6,
            "bits_per_s": n_bits / dt,
            "uploads": up1["uploads"] - up0["uploads"],
            "uploads_coalesced": up1["uploadsCoalesced"] - up0["uploadsCoalesced"],
            "upload_errors": up1["uploadErrors"] - up0["uploadErrors"],
            "overlap_frac": up1["overlapFrac"], "h2d_bytes": up1["h2dBytes"] - up0["h2dBytes"],
            "pinned": up1["pinnedSlots"], "budget_bytes_added": budget.used() - used0,
        }
        if out["ingest"]["upload_errors"] != 0 or up1["uploadErrors"] != 0:
            raise AssertionError(f"serving: failed uploads {out['ingest']}")
        frags = json.loads(cli.get("/debug/fragments?index=i&field=r2")[1])
        out["ingest"]["fragments_on_card"] = frags["totals"]["deviceResident"]
        r_rows = [int(x) for x in rng.choice(R_IMPORT_ROWS, 8, replace=False)]
        got = cli.query("i", " ".join(f"Count(Row(r2={x}))" for x in r_rows)
                        + " " + " ".join(f"Count(Intersect(Row(r2={x}), Row(r2={y})))"
                                         for x, y in zip(r_rows, r_rows[1:])))
        want = ([int(np.bitwise_count(r_words[:, x]).sum(dtype=np.int64)) for x in r_rows]
                + [int(np.bitwise_count(r_words[:, x] & r_words[:, y]).sum(dtype=np.int64))
                   for x, y in zip(r_rows, r_rows[1:])])
        if got != want:
            raise AssertionError(f"serving: r2 read back {got} != {want}")
        log(f"serving: import-roaring of {n_bits} bits, {n_bytes / 1e6:.1f} MB on "
            f"{R_IMPORT_SHARDS} shards from {INGEST_CLIENTS} clients in {dt:.2f} s: "
            f"{n_bytes / dt / 1e6:.1f} MB/s, {n_bits / dt / 1e6:.1f} M bits/s; uploads "
            f"{out['ingest']['uploads']} (coalesced {out['ingest']['uploads_coalesced']}), "
            f"overlap {up1['overlapFrac']}, upload errors 0, {out['ingest']['fragments_on_card']}"
            f" fragments on the card (+{out['ingest']['budget_bytes_added']} budget bytes); "
            f"read back exactly")
        cli.request("DELETE", "/index/i/field/r2")

        # -- 6b. reads beside the import: step 5's traffic (steps of 4
        # clients posting pair Counts over f and h at once, all over one
        # shard set, alternating from step to step under its evicting cap,
        # so each step's stack is cold and prefetched), alone and then while
        # the same import runs again. The uploader serves ingest first, so
        # the prefetches queue behind it; a dispatch claims one still queued
        # and builds its stack itself
        pairs = [divmod(int(x), H_ROWS) for x in rng.choice(64 * H_ROWS, 16, replace=False)]
        use_sub = [x for x in sub if x < S_FULL]
        truths = {}
        for a_r, h_r in pairs:
            per = np.bitwise_count(f_np[:, a_r] & h_np[:, h_r]).sum(axis=-1, dtype=np.int64)
            truths[(a_r, h_r, False)] = int(per.sum())
            truths[(a_r, h_r, True)] = int(per[use_sub].sum())
        sconns = [HttpClient(node.server.port) for _ in range(4)]
        srng = np.random.default_rng(SEED + 500)

        def pair_step(shards, lats, rerrs):
            def one(j, a_r, h_r):
                q = f"Count(Intersect(Row(f={a_r}), Row(h={h_r})))"
                body = {"query": q, "shards": shards} if shards else q
                t = time.perf_counter()
                code, resp = sconns[j].post("/index/i/query", body,
                                            "application/json" if shards else "text/plain")
                lats.append(time.perf_counter() - t)
                got = json.loads(resp)["results"][0] if code == 200 else (code, resp[:200])
                if got != truths[(a_r, h_r, bool(shards))]:
                    rerrs.append(f"{q} over {'sub' if shards else 'all'}: {got}")

            picks = [pairs[int(x)] for x in srng.integers(0, len(pairs), 4)]
            ths = [threading.Thread(target=one, args=(j, *picks[j])) for j in range(4)]
            for th in ths:
                th.start()
            for th in ths:
                th.join(120)

        def reads_beside(tag, job):
            """Steps until ``job`` (run on a thread) has ended, and at least
            :data:`IMPORT_READ_STEPS`."""
            lats, rerrs, box = [], [], {}

            def run_job():
                try:
                    job()
                except BaseException as e:  # raised below
                    box["err"] = e

            r0, claims0 = residency.default_tracker().snapshot(), ex.prefetch_claims
            jt = threading.Thread(target=run_job)
            t = time.perf_counter()
            jt.start()
            k = 0
            while k < IMPORT_READ_STEPS or jt.is_alive():
                pair_step(None if k % 2 == 0 else sub, lats, rerrs)
                k += 1
            jt.join(300)
            dt = time.perf_counter() - t
            r1 = residency.default_tracker().snapshot()
            if rerrs or "err" in box or len(lats) != 4 * k:
                raise AssertionError(f"serving: reads {tag}: {rerrs[:2]} {box.get('err')!r}")
            lat = np.array(lats) * 1e3
            res = {"seconds": dt, "steps": k, "queries": int(lat.size),
                   "p50_ms": float(np.percentile(lat, 50)),
                   "p99_ms": float(np.percentile(lat, 99)), "max_ms": float(lat.max()),
                   "prefetch": {x: r1[x] - r0[x] for x in (
                       "prefetchIssued", "prefetchUseful", "prefetchWasted")},
                   "claims": ex.prefetch_claims - claims0}
            log(f"serving: step 5's pair Counts {tag}: {k} steps of 4 in {dt:.2f} s, p50 "
                f"{res['p50_ms']:.1f} ms, p99 {res['p99_ms']:.1f} ms, max {res['max_ms']:.1f} ms;"
                f" prefetch {json.dumps(res['prefetch'])}, claimed by a dispatch "
                f"{res['claims']}; answers exact")
            return res

        def import_again():
            code, body = cli.post("/index/i/field/r2", {})
            if code != 200:
                raise AssertionError(f"serving: create r2 again: {code} {body!r}")
            changed[:] = [0] * R_IMPORT_SHARDS
            ths = [threading.Thread(target=importer, args=(c,)) for c in range(INGEST_CLIENTS)]
            for th in ths:
                th.start()
            for th in ths:
                th.join(timeout=300)
            api.ingest.uploader.flush(60)

        entries0 = ex.rescache.max_entries
        ex.rescache.max_entries = 0
        ex.rescache.clear()
        budget.set_cap(cap)
        try:
            alone = reads_beside("alone", lambda: None)
            beside = reads_beside("beside the import", import_again)
        finally:
            budget.set_cap(cap0)
            ex.rescache.max_entries = entries0
            for c in sconns:
                c.close()
        if errs or sum(changed) != n_bits:
            raise AssertionError(f"serving: import again {errs[:2]} changed {sum(changed)} "
                                 f"of {n_bits}")
        out["reads_beside_import"] = {"alone": alone, "import": beside}
        del payloads, r_words
        cli.request("DELETE", "/index/i/field/r2")

        # -- 7. QoS: two tenants by header
        q0 = json.loads(cli.get("/debug/qos")[1])
        degraded = []
        qerrs = []
        per_tenant = {"heavy": 0, "light": 0}
        stop = time.perf_counter() + QOS_SECONDS

        def tenant_client(tenant, c):
            conn = HttpClient(node.server.port)
            crng = np.random.default_rng(SEED + 300 + c)
            hdr = {devledger.TENANT_HEADER: tenant}
            try:
                while time.perf_counter() < stop:
                    if tenant == "heavy":
                        if crng.random() < 0.7:
                            rows = crng.integers(0, 64, QOS_LEAVES)
                            q = "Count(Union(" + ", ".join(f"Row(f={r})" for r in rows) + "))"
                        elif crng.random() < 0.5:
                            q = "GroupBy(Rows(f), Rows(h))"
                        else:
                            q = f"GroupBy(Rows(h), filter=Row(f={int(crng.integers(0, 64))}))"
                    else:
                        q = (f"Count(Intersect(Row(f={int(crng.integers(0, 64))}), "
                             f"Row(h={int(crng.integers(0, H_ROWS))})))")
                    code, body = conn.post("/index/i/query", q, "text/plain", hdr)
                    if code == 429:
                        continue
                    if code != 200:
                        qerrs.append(f"{tenant}: {code} {body[:200]!r}")
                        return
                    resp = json.loads(body)
                    if "degraded" in resp:
                        degraded.append(resp["degraded"])
                    per_tenant[tenant] += 1
            finally:
                conn.close()

        ths = [threading.Thread(target=tenant_client, args=(t, c))
               for c, t in enumerate(["heavy"] * 4 + ["light"] * 4)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=QOS_SECONDS + 120)
        if qerrs or any(d is not True for d in degraded):
            raise AssertionError(f"serving: tenants {qerrs[:2]} degraded marks {degraded[:3]}")
        devledger.ledger().settle()
        api.qos.tick()
        qos = json.loads(cli.get("/debug/qos")[1])
        totals = devledger.tenant_totals()
        conserv = {}
        for tname in ("heavy", "light"):
            debt = qos["tenants"][tname]["debtMs"]
            led = totals.get(tname, {"deviceMs": 0.0})["deviceMs"]
            conserv[tname] = (debt, led)
            if abs(debt - led) > 1e-3:
                raise AssertionError(f"serving: tenant {tname} debt {debt} != ledger {led}")
        out["qos"] = {"queries": per_tenant, "debt_vs_ledger_ms": conserv,
                      "degraded": len(degraded),
                      "tenants": {k: v for k, v in qos["tenants"].items()
                                  if k in ("heavy", "light")},
                      "transitions": qos["transitions"], "before": q0["episodes"]}
        log(f"serving: QoS: queries {per_tenant}, debt against the ledger's device ms "
            f"{conserv}, degraded {len(degraded)}; /debug/qos "
            f"{json.dumps(out['qos']['tenants'])}")
        out["batcher"] = b.snapshot()
        # the mix's answers as the serving path leaves the data (after its
        # Set on f), for the obs path
        hand["want_of"] = dict(want_of)
    finally:
        b._dispatch = dispatch
        cli.close()
        node.stop()
    del node, api, ex
    gc.collect()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    out["path_s"] = time.perf_counter() - t_path
    log(f"serving path: {out['path_s']:.1f} s")
    return out


OBS_CLIENTS = 16
# the planes-off node's load
OBS_SECONDS = 2.5
# the planes on against stopped on one node: pairs of windows, seconds each
OBS_PAIRS, OBS_WINDOW = 4, 1.25
# the 504 burst: one more than the flight recorder's spike threshold of 5
OBS_SPIKE = 6
# the probe tenant's deadline errors: under the spike threshold
OBS_PROBE = 4
# two tenants contend past the QoS ladder's 2 s stage hold
OBS_QOS_SECONDS = 3.0
OBS_TOP_STACKS = 5
# the kernels the obs path's read mix launches
OBS_KERNELS = ("row_scan", "masked_row_scan", "gram", "tree_count", "tree_words",
               "bsi_range", "bsi_sum", "bsi_extreme")
# the CLI's small data directory: shards and rows of its field f
CLI_SHARDS, CLI_ROWS = 4, 8


def wait_until(what, pred, timeout):
    """Poll ``pred`` every 10 ms until it is true; fail after ``timeout`` s."""
    t_end = time.perf_counter() + timeout
    while not pred():
        if time.perf_counter() > t_end:
            raise AssertionError(f"obs: timed out waiting for {what}")
        time.sleep(0.01)


def set_planes(node, on):
    """Stop (or start again) a node's sampler threads in place: the flight
    recorder, the metrics history and the black box's writer."""
    if on:
        node.flightrec.start()
        node.history.start()
        node.blackbox.start()
        return
    node.flightrec.stop()
    node.history.stop()
    bb = node.blackbox
    bb._stop.set()
    if bb._thread is not None:
        bb._thread.join(10)
    bb._thread = None


class CardBusy:
    """``torch.profiler`` over a run on the card, giving the idle share of
    any window of it: 1 - the union of the card's activity intervals over
    the window's wall time. A marker kernel launched at a known host time
    ties the profiler's clock to ``time.perf_counter``. Off the card every
    share is "not measured"."""

    def __init__(self, device):
        import torch

        self.device = device
        self.on_card = torch.device(device).type == "cuda"
        self.spans = None

    def __enter__(self):
        import torch

        if self.on_card:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
            torch.cuda.synchronize()
            self.t_mark = time.perf_counter()
            torch.ones(1, device=self.device)  # the marker: the run's first kernel
        return self

    def __exit__(self, *exc):
        import torch

        if not self.on_card:
            return
        torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        dev = sorted((e.time_range.start, e.time_range.end) for e in self.prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA)
        if dev:
            base = dev[0][0]
            self.spans = [(self.t_mark + (a - base) / 1e6, self.t_mark + (b - base) / 1e6)
                          for a, b in dev]

    def idle_share(self, t0, t1):
        if self.spans is None:
            return "not measured"
        busy = busy_union_us([(max(a, t0) * 1e6, min(b, t1) * 1e6)
                              for a, b in self.spans if b > t0 and a < t1])
        return 1.0 - busy / ((t1 - t0) * 1e6)


def mix_clients(port, mix, serial, stop, seed, clients=OBS_CLIENTS):
    """``clients`` keep-alive client threads (not started) posting the
    read mix until ``stop`` is set, every answer checked against its
    serial one: (threads, each client's (answered at, latency s) records,
    errors)."""
    import threading

    import numpy as np

    recs = [[] for _ in range(clients)]
    errors = []

    def client(c):
        conn = HttpClient(port)
        crng = np.random.default_rng(seed + c)
        try:
            while not stop.is_set():
                n, q, index = mix[int(crng.integers(0, len(mix)))]
                t = time.perf_counter()
                got = conn.query(index, q)
                t1 = time.perf_counter()
                recs[c].append((t1, t1 - t))
                if got != serial[n]:
                    errors.append(f"{n}: {str(got)[:300]} != {str(serial[n])[:300]}")
                    return
        except Exception as e:  # reported by the caller, after every client stopped
            errors.append(repr(e))
        finally:
            conn.close()

    return [threading.Thread(target=client, args=(c,)) for c in range(clients)], recs, errors


def window_stats(recs, t0, t1, busy):
    """Queries/s, p50/p99 and the idle share of the answers in [t0, t1)."""
    import numpy as np

    lat = np.array([d for per in recs for at, d in per if t0 <= at < t1]) * 1e3
    if not lat.size:
        raise AssertionError(f"obs: no answer in a window of {t1 - t0:.2f} s")
    return {"seconds": t1 - t0, "queries": int(lat.size), "qps": lat.size / (t1 - t0),
            "p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99)),
            "idle_share": busy.idle_share(t0, t1)}


def obs_load(port, mix, serial, seconds, device, tag):
    """16 keep-alive clients posting the read mix for ``seconds``: queries/s,
    p50/p99 and, on the card, the idle share; every answer must equal its
    serial one."""
    import threading

    stop = threading.Event()
    with CardBusy(device) as busy:
        threads, recs, errors = mix_clients(port, mix, serial, stop, SEED + 300)
        t = time.perf_counter()
        for th in threads:
            th.start()
        time.sleep(seconds)
        stop.set()
        for th in threads:
            th.join(timeout=120)
        t_end = time.perf_counter()
    if any(th.is_alive() for th in threads) or errors:
        raise AssertionError(f"obs: {tag}: clients: {errors[:3]}")
    res = window_stats(recs, t, t_end, busy)
    res["clients"] = OBS_CLIENTS
    log(f"obs: {tag}: {res['queries']} queries in {res['seconds']:.1f} s, {res['qps']:.1f} "
        f"queries/s, p50 {res['p50_ms']:.2f} ms, p99 {res['p99_ms']:.2f} ms, idle share "
        f"{res['idle_share']}; every answer equal to its serial one")
    return res


def plane_costs(node):
    """The planes' own seconds so far, from their counters: the flight
    recorder's ticks and the seconds its thread spent sampling and closing
    segments, the history's sampling seconds, the black box's checkpoint
    seconds."""
    return {"flightrec_ticks": node.flightrec.ticks,
            "flightrec_s": node.flightrec.busy_seconds,
            "history_s": node.history.stats()["sampleSeconds"],
            "blackbox_s": node.blackbox.stats()["checkpointSeconds"]}


def obs_ab(node, mix, serial, device):
    """The planes' cost on one node under one continuous load: 16 clients
    post the read mix while the planes run and stop in turn, in
    :data:`OBS_PAIRS` pairs of :data:`OBS_WINDOW`-second windows (on, off,
    on, off, ...; a window starts once the planes' threads have started or
    joined). See :func:`planes_ab`."""
    return planes_ab([node], mix, serial, device, "obs", OBS_PAIRS, OBS_WINDOW,
                     alternate=False)


def planes_ab(nodes, mix, serial, device, tag, pairs, window, alternate):
    """The planes' cost on ``nodes`` under one continuous load of 16 clients
    against the first node: the planes of every node run and stop in turn,
    in ``pairs`` pairs of ``window``-second windows, each pair running then
    stopped, or with ``alternate`` stopped then running every other pair
    (so what a window leaves to the next one lifts either side alike). Each
    window's queries/s, p50/p99 and idle share; the median of the pairs'
    differences (running less stopped); the flight recorders' own seconds
    per second of the running windows, summed over the nodes, from their
    counters (the history's and the black box's are read over the node's
    life: their first sample after a restart waits a cadence)."""
    import threading

    import numpy as np

    def costs():
        return [plane_costs(nd) for nd in nodes]

    order = [k % 2 == (1 if alternate and (k // 2) % 2 else 0) for k in range(2 * pairs)]
    stop = threading.Event()
    windows = []
    cost = {}
    with CardBusy(device) as busy:
        threads, recs, errors = mix_clients(nodes[0].server.port, mix, serial, stop,
                                            SEED + 300)
        if not order[0]:  # the planes run on entry
            for nd in nodes:
                set_planes(nd, False)
        for th in threads:
            th.start()
        t_w = time.perf_counter()
        c_w = costs()
        try:
            for k, on in enumerate(order):
                time.sleep(max(0.0, t_w + window - time.perf_counter()))
                t_end = time.perf_counter()
                windows.append((on, t_w, t_end))
                if on:
                    for a, b in zip(c_w, costs()):
                        for key, v in b.items():
                            cost[key] = cost.get(key, 0) + v - a[key]
                if k + 1 < len(order) and order[k + 1] != on:
                    for nd in nodes:
                        set_planes(nd, not on)
                t_w = time.perf_counter()
                c_w = costs()
        finally:
            stop.set()
            for th in threads:
                th.join(timeout=120)
            for nd in nodes:
                if not order[-1]:
                    set_planes(nd, True)
    if any(th.is_alive() for th in threads) or errors:
        raise AssertionError(f"{tag}: planes on/off: clients: {errors[:3]}")
    res = {"on": [], "off": [], "first_on": order[::2]}
    for on, t0, t1 in windows:
        res["on" if on else "off"].append(window_stats(recs, t0, t1, busy))
    on_wall = sum(w["seconds"] for w in res["on"])
    res["queries"] = sum(len(per) for per in recs)
    res["t0"], res["t1"] = windows[0][1], windows[-1][2]
    for key in ("qps", "p50_ms", "p99_ms"):
        d = [a[key] - b[key] for a, b in zip(res["on"], res["off"])]
        res[f"median_diff_{key}"] = float(np.median(d))
    res["median_ratio_qps"] = float(np.median([a["qps"] / b["qps"]
                                               for a, b in zip(res["on"], res["off"])]))
    res["plane_seconds"] = cost
    res["flightrec_s_per_s"] = cost["flightrec_s"] / on_wall
    res["planes_s_per_s"] = sum(cost[k] for k in ("flightrec_s", "history_s",
                                                  "blackbox_s")) / on_wall
    res["flightrec_tick_ms"] = (cost["flightrec_s"] / cost["flightrec_ticks"] * 1e3
                                if cost["flightrec_ticks"] else None)
    for i, (a, b) in enumerate(zip(res["on"], res["off"])):
        log(f"{tag}: pair {i} ({'running first' if res['first_on'][i] else 'stopped first'}): "
            f"planes on {a['qps']:.1f} q/s p50 {a['p50_ms']:.2f} p99 {a['p99_ms']:.2f} ms idle "
            f"{a['idle_share']} | stopped {b['qps']:.1f} q/s p50 {b['p50_ms']:.2f} p99 "
            f"{b['p99_ms']:.2f} ms idle {b['idle_share']}")
    log(f"{tag}: planes on against stopped, {len(nodes)} node(s), {pairs} pairs of {window} s "
        f"under one load of {OBS_CLIENTS} clients: median of the pairs' differences "
        f"{res['median_diff_qps']:.2f} queries/s (median ratio {res['median_ratio_qps']:.4f}), "
        f"p50 {res['median_diff_p50_ms']:.2f} ms, p99 {res['median_diff_p99_ms']:.2f} ms; the "
        f"flight recorders' own seconds per second of the on windows "
        f"{res['flightrec_s_per_s']:.5f}, every plane's {res['planes_s_per_s']:.5f} "
        f"({json.dumps(cost)}; a tick {res['flightrec_tick_ms']} ms); every answer equal to "
        f"its serial one")
    return res


def top_stacks(segments, t0, t1):
    """The flight recorder's collapsed stacks over the segments that ended
    in [t0, t1], for the dispatcher thread (``query-batcher``) and the HTTP
    handler threads: each class's samples, the top stacks with their share
    of that class's samples (a segment keeps only its 20 hottest stacks
    over every thread, so each class's kept share is printed too)."""
    stacks, threads = {}, {}
    for seg in segments:
        if not (t0 <= seg["at"] <= t1 + 0.5):
            continue
        for k, v in seg["profile"]["stacks"].items():
            stacks[k] = stacks.get(k, 0) + v
        for k, v in seg["profile"]["threads"].items():
            threads[k] = threads.get(k, 0) + v
    out = {}
    for cls, mark, is_thread in (
        ("dispatcher", "batcher.py:_run", lambda n: n == "query-batcher"),
        ("handlers", "socketserver.py:process_request_thread",
         lambda n: "process_request_thread" in n),
    ):
        samples = sum(v for n, v in threads.items() if is_thread(n))
        mine = sorted(((v, k) for k, v in stacks.items() if mark in k), reverse=True)
        kept = sum(v for v, _ in mine)
        out[cls] = {
            "samples": samples,
            "kept_share": kept / samples if samples else None,
            "top": [{"share": v / samples if samples else None,
                     "leaf": ";".join(k.split(";")[-6:])} for v, k in mine[:OBS_TOP_STACKS]],
        }
    return out


class CliLives:
    """``python -m pilosa_tpu_torch.cli server`` over a small new data
    directory, in three lives: life 1 loads it, answers, checkpoints and is
    SIGKILLed; life 2 prints the postmortem line, serves the bundle
    (``crashLoop`` 1, the first life's launches) and stops on SIGTERM with
    exit 0; life 3 boots clean and is sent SIGSEGV, leaving every thread's
    stack in ``last-words.txt``. Lives 2 and 3 are timed from boot to their
    first answer; life 1 boots in the background while the obs path's
    in-process node opens (:meth:`start`)."""

    def __init__(self, device, data, body):
        import tempfile

        import torch

        self.device, self.data, self.body = device, data, body
        self.on_card = torch.device(device).type == "cuda"
        (HERE / "build").mkdir(exist_ok=True)
        self.root = Path(tempfile.mkdtemp(prefix="obs-cli-", dir=HERE / "build"))
        STORAGE_DIRS.append(str(self.root))
        self.data_dir = str(self.root / "data")
        self.cfg = self.root / "config.json"
        # the black box checkpoints every 0.25 s, so a short life leaves a spool
        self.cfg.write_text(json.dumps({"blackbox": {"interval": 0.25}}))
        self.procs = []
        self.out = {}
        self.stopped = False
        self._lock = threading.Lock()

    def start(self, life):
        """Start life ``life``; :meth:`up` waits for its first answer."""
        import socket

        with socket.socket() as so:
            so.bind(("127.0.0.1", 0))
            port = so.getsockname()[1]
        log_path = self.root / f"life{life}.log"
        with self._lock, open(log_path, "w") as logf:
            if self.stopped:  # the path failed: no new life after stop()
                raise AssertionError("obs: the CLI lives were stopped")
            t0 = time.perf_counter()
            proc = subprocess.Popen(
                [sys.executable, "-m", "pilosa_tpu_torch.cli", "server", "-d", self.data_dir,
                 "--bind", f"127.0.0.1:{port}", "--device", self.device, "-c", str(self.cfg)],
                cwd=HERE, env=dict(os.environ, PYTHONPATH=str(HERE)), stdout=logf,
                stderr=subprocess.STDOUT, text=True)
            self.procs.append(proc)
        self.life = (life, proc, port, t0, log_path)

    def up(self):
        """Wait until the current life answers /status: (proc, client, boot
        time, log path)."""
        life, proc, port, t0, log_path = self.life

        def answering():
            try:
                probe = HttpClient(port, timeout=5)
                try:
                    probe.get("/status")
                finally:
                    probe.close()
                return True
            except OSError:
                if proc.poll() is not None:
                    raise AssertionError(f"obs: CLI life {life} exited: "
                                         f"{log_path.read_text()[-2000:]}")
                return False

        wait_until(f"CLI life {life} to answer", answering, 120)
        return proc, HttpClient(port), t0, log_path

    def answer(self, sc, life):
        if sc.query("i", self.body) != self.data["answers"]:
            raise AssertionError(f"obs: CLI life {life} answered wrong")

    def load(self):
        """Life 1, once up: load the data and answer; its black box then
        checkpoints every 0.25 s while the in-process loads run."""
        proc, sc, _, _ = self.up()
        try:
            sc.post("/index/i", {})
            sc.post("/index/i/field/f", {})
            code, body = sc.post("/index/i/field/f/import", self.data["import"])
            if code != 200:
                raise AssertionError(f"obs: CLI import: {code} {body[:200]!r}")
            self.answer(sc, 1)
            kern = json.loads(sc.get("/debug/vars")[1])["kernels"]
            self.launched = sum(v["launches"] for v in kern.values())
            if self.on_card and self.launched < 1:
                raise AssertionError(f"obs: CLI life 1 launched nothing: {kern}")
            self.seen = json.loads(sc.get("/debug/vars")[1])["blackbox"]["checkpoints"]
        finally:
            sc.close()

    def run(self):
        """Life 1 (started by :meth:`start`, loaded by :meth:`load`) killed
        after two more checkpoints, then lives 2 and 3."""
        import signal

        out = self.out
        try:
            proc, sc, _, _ = self.up()
            launched = self.launched
            wait_until("a checkpoint after the queries", lambda: json.loads(
                sc.get("/debug/vars")[1])["blackbox"]["checkpoints"] >= self.seen + 2, 10)
            sc.close()
            proc.kill()
            proc.wait(30)

            self.start(2)
            proc, sc, t0, log2 = self.up()
            self.answer(sc, 2)
            out["dirty_boot_to_answer_s"] = time.perf_counter() - t0
            line = [x for x in log2.read_text().splitlines() if "died dirty" in x]
            code, body = sc.get("/debug/postmortem")
            pm = json.loads(body)
            bundle = pm["postmortem"]
            if (not line or code != 200 or len(pm["postmortems"]) != 1
                    or bundle["crashLoop"] != 1):
                raise AssertionError(f"obs: CLI postmortem: {line} {code} "
                                     f"{json.dumps(pm['postmortems'])[:300]}")
            dev = bundle["devledger"] or {}
            kern_launches = sum(v for k, v in dev.items()
                                if k.startswith("site.kernels.") and k.endswith(".launches"))
            if self.on_card and kern_launches < launched:
                raise AssertionError(f"obs: the bundle's ledger holds {kern_launches} kernel "
                                     f"launches, the first life made {launched}")
            out["postmortem"] = {"line": line[0], "crashLoop": bundle["crashLoop"],
                                 "segments": bundle["segments"], "torn": bundle["torn"],
                                 "events": len(bundle["events"]),
                                 "kernel_launches": kern_launches,
                                 "first_life_launches": launched}
            sc.close()
            t = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            if proc.wait(30) != 0:
                raise AssertionError(f"obs: CLI life 2 exited {proc.returncode} on SIGTERM")
            out["sigterm_stop_s"] = time.perf_counter() - t

            self.start(3)
            proc, sc, t0, log3 = self.up()
            self.answer(sc, 3)
            out["clean_boot_to_answer_s"] = time.perf_counter() - t0
            pm = json.loads(sc.get("/debug/postmortem")[1])
            if "died dirty" in log3.read_text() or len(pm["postmortems"]) != 1:
                raise AssertionError("obs: the boot after SIGTERM was not clean")
            # the connection stays open, so no handler thread is exiting
            # while the fatal-signal handler walks every thread's stack
            proc.send_signal(signal.SIGSEGV)
            rc = proc.wait(30)
            sc.close()
            words = (Path(self.data_dir) / "_blackbox" / "last-words.txt").read_text()
            n_threads = words.count("Thread 0x") + words.count("Current thread 0x")
            if rc == 0 or "Fatal Python error" not in words or n_threads < 5:
                raise AssertionError(f"obs: SIGSEGV: exit {rc}, {n_threads} thread stacks, "
                                     f"last words {words[:300]!r}")
            out["sigsegv"] = {"exit": rc, "threads_in_last_words": n_threads}
        finally:
            self.stop()
        log(f"obs: CLI: postmortem after SIGKILL {json.dumps(out['postmortem'])}; boot to the "
            f"first answer {out['dirty_boot_to_answer_s']:.2f} s dirty, "
            f"{out['clean_boot_to_answer_s']:.2f} s clean; SIGTERM exit 0 in "
            f"{out['sigterm_stop_s']:.2f} s; SIGSEGV exit {rc}, {n_threads} thread stacks in "
            f"last-words.txt")
        return out

    def run_in_thread(self):
        """:meth:`run` on a thread of its own; :meth:`join` takes its result."""
        box = {}

        def go():
            try:
                box["out"] = self.run()
            except BaseException as e:  # raised again by join()
                box["err"] = e

        th = threading.Thread(target=go, name="cli-lives", daemon=True)
        th.box = box
        th.start()
        return th

    def join(self, th):
        th.join(300)
        if th.is_alive():
            raise AssertionError("obs: the CLI lives did not end")
        if "err" in th.box:
            raise th.box["err"]
        return th.box["out"]

    def stop(self):
        with self._lock:
            self.stopped = True
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait(30)


def cli_data(rng):
    """The CLI's small data: f's bits as an import body, and the answers of
    :data:`cli_calls` from numpy."""
    import numpy as np

    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    n = 4000
    rows = rng.integers(0, CLI_ROWS, n)
    cols = rng.integers(0, CLI_SHARDS * SHARD_WIDTH, n)
    sets = [set(cols[rows == r].tolist()) for r in range(CLI_ROWS)]
    answers = [len(sets[a] & sets[b]) for a, b in CLI_PAIRS] + [len(sets[1])]
    return {"import": {"rowIDs": rows.tolist(), "columnIDs": cols.tolist()},
            "answers": answers}


CLI_PAIRS = [(0, 1), (2, 3), (4, 5), (6, 7)]


def obs_path(pool, device, hand, v_truth):
    """Every observability plane of the node on, against the same load with
    them off, and the crash-and-restart cycle of ``cli server``."""
    import numpy as np

    from pilosa_tpu_torch.ops import kernels as tk

    t_path = time.perf_counter()
    # the CLI's first life boots while the node opens
    body = " ".join(f"Count(Intersect(Row(f={a}), Row(f={b})))" for a, b in CLI_PAIRS)
    lives = CliLives(device, cli_data(np.random.default_rng(SEED + 41)),
                     body + " Count(Row(f=1))")
    lives.start(1)
    try:
        out = obs_nodes(device, hand, lives)
    finally:
        lives.stop()
    out["launches"] = {k: v for k, v in tk.LAUNCHES.items() if v}
    out["path_s"] = time.perf_counter() - t_path
    log(f"obs path: {out['path_s']:.1f} s")
    return out


def obs_nodes(device, hand, lives):
    """The obs path's in-process nodes: every plane on (the planes on and
    stopped in turn under one load, stacks, history and incidents), then a
    node with the planes off; the CLI's lives run beside the checks after
    the windows, the incidents and that node's boot."""
    import gc

    import numpy as np
    import torch

    from pilosa_tpu_torch.obs import devledger
    from pilosa_tpu_torch.server.node import NodeServer

    on_card = torch.device(device).type == "cuda"
    out = {}
    reads, items, want_of = hand["reads"], hand["items"], hand["want_of"]
    mix = read_mix(reads, items)
    led = devledger.ledger()

    def check(name, got):
        norm = norm_json(got[0]) if not name.startswith("pair ") else got[0]
        if norm != want_of[name]:
            raise AssertionError(f"obs: {name}: {str(norm)[:200]} != {str(want_of[name])[:200]}")

    def serial_of(cli):
        serial = {}
        for n, q, index in mix:
            got = cli.query(index, q)
            check(n, got)
            serial[n] = got
        return serial

    # -- 1. every plane on, at JAX's defaults; the probe tenant's objective
    # and no objective on read.other (the class a deadline 504 lands in),
    # so only the probe's errors burn a budget
    t0 = time.perf_counter()
    node = NodeServer(data_dir=hand["data_dir"], device=device, port=0, slo_objectives={
        "read.other": None, "tenants": {"probe": {"read.other": {"availability": 0.999}}}})
    node.start()
    boot_s = time.perf_counter() - t0
    fr, hist, bb = node.flightrec, node.history, node.blackbox
    if not (fr.sample_interval == 0.025 and fr.segment_seconds == 1.0
            and fr.max_segments == 60 and fr.spike_504 == 5 and hist.cadence == 1.0
            and bb.interval == 5.0 and node.runtime_monitor.interval == 10.0
            and node.api.batcher is not None and node.api.qos is not None):
        raise AssertionError("obs: the node's planes are not at JAX's defaults")
    ex = node.api.executor
    cli = HttpClient(node.server.port)
    try:
        ex.rescache.max_entries = 0
        ex.rescache.clear()
        serial = serial_of(cli)
        log(f"obs: node with every plane on open in {boot_s:.2f} s; the {len(mix)}-query "
            f"mix equals numpy")
        lives.load()  # the CLI's first life is up and loaded: no boot beside the loads
        # a fresh history sample just before the load and one after it
        n0 = hist.stats()["samples"]
        wait_until("a history sample", lambda: hist.stats()["samples"] > n0, 3)
        seq0 = hist.query(limit=1)["nextSeq"] - 1
        led.settle()
        c0 = led.counters()
        out["ab"] = ab = obs_ab(node, mix, serial, device)
        # the CLI's lives go on beside the checks below, the incidents and
        # the planes-off node's boot (so their boot times are taken beside
        # those), and end before that node's load
        lives_th = lives.run_in_thread()
        # one sample after the load: its answers are back, so every launch
        # it made has ended and that sample folds them all; a handler records
        # its request's SLO just after the answer leaves, hence the pause.
        # The history stopped in the off windows: the first sample after
        # each restart holds the rates over the gap, so the integrals cover
        # the whole load
        time.sleep(0.05)
        n1 = hist.stats()["samples"]
        wait_until("a history sample after the load",
                   lambda: hist.stats()["samples"] >= n1 + 1, 3)
        led.settle()
        c1 = led.counters()
        code, body = cli.get(f"/debug/history?series=dev.*,slo.*&since={seq0}")
        series = json.loads(body)["series"]
        if code != 200 or "dev.device_ms_ps" not in series:
            raise AssertionError(f"obs: /debug/history: {code} {list(series)[:10]}")

        def integral(pts):
            return sum(v * (pts[i][0] - pts[i - 1][0])
                       for i, (_, v) in enumerate(pts) if i and v is not None)

        dev_pts = series["dev.device_ms_ps"]
        dev_int = integral(dev_pts)
        dev_delta = c1["deviceMs"] - c0["deviceMs"]
        tol = max((v for _, v in dev_pts if v is not None), default=0.0) * hist.cadence
        rps = {k: integral(v) for k, v in series.items()
               if k.endswith(".rps") and "@" not in k}
        served = sum(rps.values())
        out["history"] = {"device_ms_integral": dev_int, "ledger_device_ms": dev_delta,
                          "tolerance_ms": tol, "rps_integral": served,
                          "requests_served": ab["queries"], "samples": len(dev_pts)}
        log(f"obs: history: dev.device_ms_ps integral {dev_int:.3f} ms against the ledger's "
            f"{dev_delta:.3f} (tolerance {tol:.3f}, one cadence); slo rps integral "
            f"{served:.2f} against {ab['queries']} requests served")
        if abs(dev_int - dev_delta) > tol or (on_card and dev_delta <= 0):
            raise AssertionError(f"obs: history {json.dumps(out['history'])}")
        if abs(served - ab["queries"]) > 0.5:
            raise AssertionError(f"obs: slo rps {json.dumps(rps)}")
        # the recorder ran in the on windows only
        wall = time.time() - time.perf_counter()
        out["stacks"] = top_stacks(fr.segments_snapshot(60), ab["t0"] + wall, ab["t1"] + wall)
        for cls, v in out["stacks"].items():
            log(f"obs: {cls}: {v['samples']} samples, kept share {v['kept_share']}")
            for e in v["top"]:
                log(f"obs:   {e['share']:.3f} {e['leaf']}")


        # -- 2. incidents: two tenants contend (the QoS ladder's incident)
        # while a 504 burst and the probe's errors go in
        def incidents(kind):
            return [b for b in node.api.incidents_snapshot()["incidents"]
                    if b["trigger"]["type"] == kind]

        heavy = [(n, q, index) for n, q, index in mix if not n.startswith("pair")]

        def tenant_load(name, n_clients, seconds):
            import threading

            errs = []

            def run(c):
                conn = HttpClient(node.server.port)
                crng = np.random.default_rng(SEED + 400 + c)
                t_end = time.perf_counter() + seconds
                try:
                    pool_ = heavy if name == "heavy" else mix
                    while time.perf_counter() < t_end:
                        n, q, index = pool_[int(crng.integers(0, len(pool_)))]
                        code, body = conn.post(f"/index/{index}/query", q, "text/plain",
                                               headers={devledger.TENANT_HEADER: name})
                        if code == 200:
                            j = json.loads(body)
                            if not j.get("degraded") and j["results"] != serial[n]:
                                errs.append(n)
                        elif code != 429:
                            errs.append(f"{n}: {code}")
                finally:
                    conn.close()

            return [threading.Thread(target=run, args=(c,)) for c in range(n_clients)], errs

        ths_h, err_h = tenant_load("heavy", 8, OBS_QOS_SECONDS)
        ths_l, err_l = tenant_load("light", 2, OBS_QOS_SECONDS)
        for th in ths_h + ths_l:
            th.start()
        # the burst just after a segment boundary, so one segment holds it
        seg = fr.segments_snapshot(1)[-1]["seq"]
        wait_until("a segment boundary",
                   lambda: fr.segments_snapshot(1)[-1]["seq"] > seg, 3)
        for _ in range(OBS_SPIKE):
            code, _ = cli.post("/index/i/query?timeout=0.000001", "Count(Row(h=0))",
                               "text/plain")
            if code != 504:
                raise AssertionError(f"obs: a read under a tiny deadline answered {code}")
        wait_until("the 504 spike incident", lambda: incidents("deadline-504-spike"), 4)
        [spike] = incidents("deadline-504-spike")
        detail = json.loads(cli.get(f"/debug/incidents?id={spike['id']}")[1])
        segs = detail["segments"]
        dispatch = max(s.get("kernelDispatchDelta", 0) for s in segs)
        dl_launches = max(s.get("devledgerDelta", {}).get("launches", 0) for s in segs)
        if on_card and (dispatch <= 0 or dl_launches <= 0):
            raise AssertionError(f"obs: the spike's segments show no launch: "
                                 f"{dispatch}, {dl_launches}")
        # the probe tenant's errors: one burn-rate edge
        for _ in range(OBS_PROBE):
            code, _ = cli.post("/index/i/query?timeout=0.000001", "Count(Row(h=0))",
                               "text/plain", headers={devledger.TENANT_HEADER: "probe"})
            if code != 504:
                raise AssertionError(f"obs: the probe's read answered {code}")
        wait_until("the burn-edge incident", lambda: incidents("slo-alert"), 4)
        [burn] = incidents("slo-alert")
        for th in ths_h + ths_l:
            th.join(OBS_QOS_SECONDS + 120)
        if err_h or err_l:
            raise AssertionError(f"obs: QoS tenants: {err_h[:3]} {err_l[:3]}")
        wait_until("the QoS incident", lambda: incidents("qos-pressure"), 3)
        qos_inc = incidents("qos-pressure")
        all_inc = node.api.incidents_snapshot()["incidents"]
        kinds = {}
        for b in all_inc:
            kinds[b["trigger"]["type"]] = kinds.get(b["trigger"]["type"], 0) + 1
        if kinds.get("deadline-504-spike") != 1 or kinds.get("slo-alert") != 1:
            raise AssertionError(f"obs: incidents {kinds}")
        bbs = bb.stats()
        hs = hist.stats()
        # each plane's own seconds per wall second at its cadence: the
        # recorder's from the on windows, the others' a sample's or a
        # checkpoint's mean cost over the node's life
        out["plane_s_per_s"] = steady = {
            "flightrec": ab["flightrec_s_per_s"],
            "history": hs["sampleSeconds"] / max(1, hs["samples"]) / hist.cadence,
            "blackbox": bbs["checkpointSeconds"] / max(1, bbs["checkpoints"]) / bb.interval}
        log(f"obs: the planes' own seconds per wall second {sum(steady.values()):.5f} "
            f"({json.dumps(steady)}; history {hs['samples']} samples in "
            f"{hs['sampleSeconds']} s, black box {bbs['checkpoints']} checkpoints in "
            f"{bbs['checkpointSeconds']} s)")
        out["incidents"] = {
            "kinds": kinds,
            "spike": {"count": spike["trigger"]["count"], "segments": len(segs),
                      "kernelDispatchDelta_max": dispatch,
                      "devledgerDelta_launches_max": dl_launches},
            "burn": burn["trigger"], "qos": qos_inc[0]["trigger"],
            "blackbox": {k: bbs[k] for k in ("checkpoints", "checkpointSeconds",
                                              "syncFlushes", "segments", "bytes")},
            "history": hist.stats(),
        }
        log(f"obs: incidents {json.dumps(kinds)}; spike {json.dumps(out['incidents']['spike'])};"
            f" burn {json.dumps(burn['trigger'])}; QoS {json.dumps(qos_inc[0]['trigger'])}; "
            f"black box {json.dumps(out['incidents']['blackbox'])}; history "
            f"{json.dumps(hist.stats())}")
    finally:
        cli.close()
        node.stop()
    del node, ex, fr, hist, bb
    gc.collect()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    # -- 3. the same load on a node with the planes off
    t0 = time.perf_counter()
    node = NodeServer(data_dir=hand["data_dir"], device=device, port=0, flight_recorder=False,
                      history_enabled=False, blackbox_enabled=False)
    node.start()
    boot_off = time.perf_counter() - t0
    cli = HttpClient(node.server.port)
    try:
        node.api.executor.rescache.max_entries = 0
        node.api.executor.rescache.clear()
        serial = serial_of(cli)
        log(f"obs: node with the planes off open in {boot_off:.2f} s; the mix equals numpy")
        out["cli"] = lives.join(lives_th)
        out["planes_off"] = obs_load(node.server.port, mix, serial, OBS_SECONDS, device,
                                     "16 clients, planes off, cache emptied")
    finally:
        cli.close()
        node.stop()
    del node
    gc.collect()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    on = ab["on"]
    off = out["planes_off"]
    log(f"obs: planes on (the on windows, one node) / off (a node without them): "
        f"{sum(w['queries'] for w in on) / sum(w['seconds'] for w in on):.1f} / "
        f"{off['qps']:.1f} queries/s; p99 of the on windows "
        f"{[round(w['p99_ms'], 1) for w in on]} / {off['p99_ms']:.1f} ms; idle share "
        f"{[w['idle_share'] for w in on]} / {off['idle_share']}")

    return out


# ---------------------------------------------------------------------------
# The cluster path: three nodes of the port in one process on the card
# ---------------------------------------------------------------------------

CLUSTER_NODES, CLUSTER_REPLICAS = 3, 2
# seconds of each route's 16-client load (6 before the elastic steps' reads
# needed the time, 4 before the loadgen path did), and of the failover
# reads' load (3 before)
CLUSTER_SECONDS, CLUSTER_FAILOVER_SECONDS = 2.0, 2.0
# the routing check's small field: rows and shards
CLUSTER_R_ROWS, CLUSTER_R_SHARDS = 8, 8
# host bytes kept free beside the cluster's mirrors
CLUSTER_HOST_MARGIN = 6 << 30
# rows of f in the same-field GroupBy (the gram on the HTTP route's per-call
# legs, where pair Counts take the tree kernel or the host tier)
CLUSTER_FF_ROWS = 8
# the planes' cost on the mesh route: pairs of windows of this many seconds,
# running and stopped, the order turned every other pair (2 pairs before the
# loadgen path needed the time)
CLUSTER_AB_PAIRS, CLUSTER_AB_WINDOW = 1, 1.5


def cluster_node_dir(k, root):
    """A new data directory under ``root`` for the cluster path's node ``k``,
    its ``.id`` file holding an id fixed from :data:`SEED` (derived, not
    searched for): the shards each resize moves follow the ids, so with
    random ids a step moved 2.1-4.0 GB from run to run."""
    import hashlib
    import tempfile

    d = tempfile.mkdtemp(prefix=f"cluster{k}-", dir=root)
    STORAGE_DIRS.append(d)
    with open(os.path.join(d, ".id"), "w") as fh:
        fh.write(hashlib.sha256(f"chip_smoke cluster node {SEED} {k}".encode()).hexdigest()[:32])
    return d


def cluster_nodes(device, n, root):
    """``n`` port nodes at JAX's defaults (``replica_n=2``), each on a data
    directory of its own under ``root`` (:func:`cluster_node_dir`), started
    and joined by ``join_static`` with node 0 the coordinator, as
    ``InProcessCluster`` joins them."""
    from pilosa_tpu_torch.server.node import NodeServer

    nodes = []
    for k in range(n):
        d = cluster_node_dir(k, root)
        node = NodeServer(data_dir=d, device=device, port=0, replica_n=CLUSTER_REPLICAS)
        node.start()
        nodes.append(node)
    members = sorted((nd.node_id, nd.uri) for nd in nodes)
    for nd in nodes:
        nd.join_static(members, nodes[0].node_id)
    return nodes


def cluster_sources(hand, pool):
    """The cluster's data, ``{(field, view): [S] of (row ids, words)}``: f, h
    and v as the storage path's directory holds them after the earlier
    paths (opened on the CPU and read from its mirrors), and w drawn anew
    from the seed with the served index's generator; with the numpy truth
    of w's Sum."""
    import numpy as np

    from pilosa_tpu_torch.core.holder import Holder
    from pilosa_tpu_torch.storage.disk import HolderStore

    store = HolderStore(Holder(device="cpu"), hand["data_dir"])
    store.open()
    try:
        src = {}
        for field, view in (("f", "standard"), ("h", "standard"), ("v", "bsig_v")):
            frags = store.holder.field("i", field).view(view).fragments
            src[(field, view)] = [frags[s].rows_matrix_host() for s in range(S_FULL)]
    finally:
        store.close()
    rng = np.random.default_rng(SEED + 51)
    truth = {}
    w = bsi_field_words(rng, *BSI_FIELDS["w"], pool)
    src[("w", "bsig_w")] = [(list(range(2 + BSI_DEPTH)), w[s]) for s in range(S_FULL)]

    def w_sum(s):
        neg = w[s, 1]
        tot = 0
        for k in range(BSI_DEPTH):
            plane = w[s, 2 + k]
            tot += (int(np.bitwise_count(plane & ~neg).sum(dtype=np.int64))
                    - int(np.bitwise_count(plane & neg).sum(dtype=np.int64))) << k
        return tot, int(np.bitwise_count(w[s, 0]).sum(dtype=np.int64))

    parts = by_shard(pool, w_sum)
    truth["Sum(field=w)"] = ("vc", sum(p[0] for p in parts), sum(p[1] for p in parts))
    return src, truth


class StageClock:
    """Seconds spent in named methods, summed over the threads that call
    them, while the clock is installed: each ``(name, class, method)`` is
    wrapped in place on entry and restored on exit."""

    def __init__(self, stages):
        self.stages = stages
        self.seconds = {name: 0.0 for name, _, _ in stages}
        self.calls = {name: 0 for name, _, _ in stages}
        self._lock = threading.Lock()
        self._saved = []

    def __enter__(self):
        for name, cls, attr in self.stages:
            orig = cls.__dict__[attr]

            def timed(*a, _orig=orig, _name=name, **k):
                t = time.perf_counter()
                try:
                    return _orig(*a, **k)
                finally:
                    dt = time.perf_counter() - t
                    with self._lock:
                        self.seconds[_name] += dt
                        self.calls[_name] += 1

            setattr(cls, attr, timed)
            self._saved.append((cls, attr, orig))
        return self

    def __exit__(self, *exc):
        for cls, attr, orig in self._saved:
            setattr(cls, attr, orig)


def cluster_load(pool, nodes, src):
    """Each shard of each field to its owners by the port's own placement,
    through each owner's roaring import (``remote=true``: applied there, as
    a peer's forwarded slice is), so each owner's first fragment of a shard
    broadcasts the shard to its peers; the payloads are encoded on ``pool``
    and every owner's import runs at once, so each node's import pool (2
    workers, JAX's default) stays busy. Returns (seconds, payload bytes,
    the load's stages: thread-seconds summed over the threads of each of
    encoding the payloads, the nodes' decode into staging, the fragments'
    apply, of it the op-log writes, the snapshots, and the uploads to the
    card)."""
    import numpy as np

    from pilosa_tpu_torch.core.fragment import Fragment
    from pilosa_tpu_torch.storage import roaring
    from pilosa_tpu_torch.storage.fragmentfile import FragmentFile

    placement = nodes[0].cluster
    by_id = {nd.node_id: nd for nd in nodes}
    enc = [0.0]
    lock = threading.Lock()
    t0 = time.perf_counter()

    def encode(job):
        key, s, (ids, words) = job
        t = time.perf_counter()
        blob = roaring.serialize_rows(np.asarray(ids, dtype=np.uint64), words)
        with lock:
            enc[0] += time.perf_counter() - t
        return key, s, blob

    def put(item):
        (field, view), s, blob, owner = item
        by_id[owner].api.import_roaring("i", field, s, blob, view=view, remote=True)
        return len(blob)

    def node_seconds():
        return (sum(nd.api.ingest.decode_seconds for nd in nodes),
                sum(nd.api.ingest.uploader.upload_seconds for nd in nodes))

    dec0, up0 = node_seconds()
    jobs = [(key, s, rows) for key, per in src.items() for s, rows in enumerate(per)]
    clock = StageClock((("apply", Fragment, "import_row_words"),
                        ("op_log", FragmentFile, "end_batch"),
                        ("snapshot", FragmentFile, "snapshot")))
    with clock, ThreadPoolExecutor(max_workers=4 * len(nodes)) as importers:
        puts = [importers.submit(put, (key, s, blob, o.id))
                for key, s, blob in pool.map(encode, jobs)
                for o in placement.shard_nodes("i", s)]
        sent = sum(f.result() for f in puts)
        for nd in nodes:
            if not nd.api.ingest.uploader.flush(120):
                raise AssertionError("cluster: an uploader did not drain")
    dec1, up1 = node_seconds()
    stages = {"encode_s": enc[0], "decode_s": dec1 - dec0, "upload_s": up1 - up0}
    stages.update({f"{k}_s": v for k, v in clock.seconds.items()})
    stages.update({f"{k}_calls": v for k, v in clock.calls.items()})
    return time.perf_counter() - t0, sent, stages


def cluster_counters(nodes):
    """Per node: the query-route requests it served, its mesh dispatches and
    fallbacks."""
    out = []
    for nd in nodes:
        c = nd.holder.stats.snapshot()["counters"]
        d = nd.api.dist
        out.append((c.get("http_requests{route:query}", 0), d.mesh_dispatches, d.mesh_fallbacks))
    return out


def cluster_load_window(nodes, mix, serial, seconds, device, tag):
    """16 keep-alive clients against node 0 for ``seconds``: queries/s,
    p50/p99, the idle share, launches a query by kernel, mesh dispatches,
    HTTP sub-requests a query (the peers' query-route requests), mesh
    fallbacks, and the planes' own seconds a second over the three nodes;
    every answer equal to its serial one."""
    from pilosa_tpu_torch.ops import kernels as tk

    stop = threading.Event()
    c0, l0 = cluster_counters(nodes), dict(tk.LAUNCHES)
    p0 = [plane_costs(nd) for nd in nodes if nd.flightrec is not None]
    with CardBusy(device) as busy:
        threads, recs, errors = mix_clients(nodes[0].server.port, mix, serial, stop,
                                            SEED + 500)
        t = time.perf_counter()
        for th in threads:
            th.start()
        time.sleep(seconds)
        stop.set()
        for th in threads:
            th.join(timeout=120)
        t_end = time.perf_counter()
    if any(th.is_alive() for th in threads) or errors:
        raise AssertionError(f"cluster: {tag}: clients: {errors[:3]}")
    res = window_stats(recs, t, t_end, busy)
    nq = res["queries"]
    c1 = cluster_counters(nodes)
    made = {k: tk.LAUNCHES[k] - l0[k] for k in tk.LAUNCHES}
    p1 = [plane_costs(nd) for nd in nodes if nd.flightrec is not None]
    spent = sum(b[k] - a[k] for a, b in zip(p0, p1)
                for k in ("flightrec_s", "history_s", "blackbox_s"))
    ticks = sum(b["flightrec_ticks"] - a["flightrec_ticks"] for a, b in zip(p0, p1))
    rec_s = sum(b["flightrec_s"] - a["flightrec_s"] for a, b in zip(p0, p1))
    res.update(
        clients=OBS_CLIENTS,
        launches_per_query={k: v / nq for k, v in made.items() if v},
        launched=sorted(k for k, v in made.items() if v),
        mesh_dispatches=sum(b[1] - a[1] for a, b in zip(c0, c1)),
        http_subrequests_per_query=sum(b[0] - a[0] for a, b in zip(c0[1:], c1[1:])) / nq,
        mesh_fallbacks=sum(b[2] for b in c1),
        planes_s_per_s=spent / (t_end - t),
        flightrec_ticks_per_s=ticks / (t_end - t),
        flightrec_ms_per_tick=rec_s * 1e3 / ticks if ticks else None,
    )
    log(f"cluster: {tag}: {nq} queries in {res['seconds']:.1f} s, {res['qps']:.1f} "
        f"queries/s, p50 {res['p50_ms']:.2f} ms, p99 {res['p99_ms']:.2f} ms, idle share "
        f"{res['idle_share']}; launches a query {json.dumps(res['launches_per_query'])}; "
        f"mesh dispatches {res['mesh_dispatches']}, HTTP sub-requests a query "
        f"{res['http_subrequests_per_query']:.3f}, mesh_fallbacks {res['mesh_fallbacks']}; "
        f"the planes {res['planes_s_per_s']:.4f} s a second over the three nodes "
        f"({res['flightrec_ticks_per_s']:.1f} flight-recorder ticks a second, "
        f"{res['flightrec_ms_per_tick']} ms a tick); every answer equal to its serial one")
    if res["mesh_fallbacks"]:
        raise AssertionError(f"cluster: {tag}: mesh_fallbacks {res['mesh_fallbacks']}")
    return res


def set_mesh(nodes, on):
    """The mesh route on or off on every node (a node's distributed
    executor as ``mesh_dispatch`` leaves it)."""
    for nd in nodes:
        if nd.api.dist is not None and not nd._stopped:
            nd.api.dist.mesh_enabled = on


# the elastic steps (6-9): the membership monitors' probe cadence is JAX's
# default; the anti-entropy step's diverged fragments and bits a fragment;
# the bits a cleared or set row gets; the rows the resize's writer cycles
ELASTIC_AE_FRAGMENTS, ELASTIC_AE_BITS = 4, 1500
ELASTIC_WR_ROWS = 4
# clients posting the read mix during each resize (16 before the mesh path
# and 4 before the batched sum needed the time: each flip's stack rebuilds
# queued behind their reads)
ELASTIC_CLIENTS = 2
# the writer's pause between writes (at most about 200 a second)
ELASTIC_WR_PAUSE = 0.005
# seconds the membership steps wait at most for a DOWN or READY mark
ELASTIC_MARK_TIMEOUT = 60.0
# steps 8-9 (a node added and one removed online, 2-5 minutes): run with
# ``--resize`` only, since the script outgrew the run's time limit with them
CLUSTER_RESIZE = False


def elastic_stages(which):
    """The methods a resize or an anti-entropy round spends its time in,
    for a :class:`StageClock` (thread-seconds summed over the threads that
    ran them, the 16 clients' stack builds among them)."""
    from pilosa_tpu_torch.cluster.antientropy import HolderSyncer
    from pilosa_tpu_torch.cluster.client import InternalClient
    from pilosa_tpu_torch.cluster.resize import ResizeCoordinator
    from pilosa_tpu_torch.core.fragment import Fragment
    from pilosa_tpu_torch.exec.executor import Executor
    from pilosa_tpu_torch.server.api import API

    if which == "antientropy":
        return (("fragment", HolderSyncer, "sync_fragment"),
                ("blocks", Fragment, "blocks"),
                ("remote_blocks", InternalClient, "fragment_blocks"),
                ("block_data", InternalClient, "block_data"),
                ("merge", HolderSyncer, "_merge_block"),
                ("apply", HolderSyncer, "_apply_local"),
                ("push", HolderSyncer, "_push_remote"))
    return (("inventory", ResizeCoordinator, "_gather_inventory"),
            ("fetch", API, "migrate_fetch"),
            ("pull", API, "_migrate_pull_from"),
            ("apply", API, "_apply_roaring"),
            ("delta_apply", API, "_apply_delta_ops"),
            ("flip", ResizeCoordinator, "_broadcast_flip"),
            ("finalize", API, "migrate_finalize"),
            ("late", ResizeCoordinator, "_migrate_late"),
            ("commit", ResizeCoordinator, "_commit_membership"),
            ("clean", API, "_clean_unowned_fragments"),
            ("stack_builds", Executor, "_field_stack"))


def clock_report(clock):
    return {name: {"s": round(clock.seconds[name], 3), "calls": clock.calls[name]}
            for name in clock.seconds}


def wait_for(what, pred, timeout):
    """Seconds until ``pred()`` holds, polled every 5 ms; raises after
    ``timeout``."""
    t = time.perf_counter()
    while not pred():
        if time.perf_counter() - t > timeout:
            raise AssertionError(f"cluster: {what} not within {timeout:.0f} s")
        time.sleep(0.005)
    return time.perf_counter() - t


def fragment_keys(node):
    """{(field, view, shard): fragment} a node holds."""
    out = {}
    idx = node.holder.index("i")
    for fname in idx.field_names(include_internal=True):
        field = idx.field(fname)
        for vname in field.view_names():
            for s, frag in field.view(vname).fragments.items():
                out[(fname, vname, int(s))] = frag
    return out


def check_holdings(nodes, fields, tag, pool, f_np):
    """Each node holds exactly the fragments the port's placement gives it,
    for every shard of the served fields, and the replicas of each hold
    equal words in every row with a bit (compared on ``pool``; f's against
    ``f_np`` too where they differ); (fragments checked, fragments a
    node)."""
    import numpy as np

    placement = nodes[0].cluster
    held = [fragment_keys(nd) for nd in nodes]
    jobs = []
    for (field, view) in fields:
        for s in range(S_FULL):
            owners = {o.id for o in placement.shard_nodes("i", s)}
            have = {nd.node_id for nd, h in zip(nodes, held) if (field, view, s) in h}
            if have != owners:
                raise AssertionError(f"cluster: {tag}: shard {s} of {field} held by "
                                     f"{sorted(have)}, owned by {sorted(owners)}")
            jobs.append((field, view, s, [(k, h[(field, view, s)]) for k, (nd, h)
                                          in enumerate(zip(nodes, held))
                                          if nd.node_id in owners]))

    def nonzero_rows(frag):
        # a row cleared to zero stays in its fragment's slot map, but a
        # roaring copy (a migration's snapshot) carries no empty row
        ids, words = frag.snapshot_rows()
        keep = words.any(axis=1)
        return ids[keep], words[keep]

    def differs(job):
        field, view, s, reps = job
        mats = [(k, nonzero_rows(frag)) for k, frag in reps]
        (k0, (ids0, w0)), rest = mats[0], mats[1:]
        for k, (ids, w) in rest:
            if not (np.array_equal(ids, ids0) and np.array_equal(w, w0)):
                detail = []
                for kk, (i, ww) in mats:
                    d = {"node": kk, "rows": len(i), "bits": int(np.bitwise_count(ww).sum())}
                    if field == "f":
                        d["bits_off_truth"] = int(sum(
                            np.bitwise_count(ww[j] ^ f_np[s, int(r)]).sum()
                            for j, r in enumerate(i) if int(r) < f_np.shape[1]))
                    detail.append(d)
                return f"shard {s} of {field}: {detail}"
        return None

    bad = [d for d in pool.map(differs, jobs) if d is not None]
    if bad:
        raise AssertionError(f"cluster: {tag}: replicas differ: {bad[:4]}")
    return len(jobs), [len(h) for h in held]


def device_holdings(nodes):
    """{(node id, field, view, shard): (fragment, device bytes)} of every
    fragment with a device copy."""
    out = {}
    for nd in nodes:
        for key, frag in fragment_keys(nd).items():
            if frag._device is not None:
                out[(nd.node_id,) + key] = (frag, frag._device_nbytes())
    return out


def card_bytes(device):
    import gc

    import torch

    from pilosa_tpu_torch.core import membudget

    gc.collect()
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    budget = membudget.default_budget(torch.device(device))
    return budget.used(), torch.cuda.memory_allocated() if on_card else None, budget.snapshot()


def resize_under_load(ctx, tag, run, writer_node, rows):
    """``run()`` (one resize) while ELASTIC_CLIENTS clients post the read
    mix to node 0
    and a writer sets bits of ``wr``'s ``rows`` through ``writer_node``,
    one shard after another: (the resize's seconds, the window's stats, the
    acknowledged writes)."""
    import threading

    nodes = ctx["nodes"]
    stop = threading.Event()
    acked, werr = [], []

    def writer():
        from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

        cli = HttpClient(writer_node.server.port)
        k = 0
        try:
            while not stop.is_set():
                row = rows[k % len(rows)]
                col = (k % S_FULL) * SHARD_WIDTH + (k // S_FULL) % SHARD_WIDTH
                if cli.query("i", f"Set({col}, wr={row})") != [True]:
                    werr.append(f"Set({col}, wr={row}) answered False")
                    return
                acked.append((row, col))
                k += 1
                time.sleep(ELASTIC_WR_PAUSE)
        except Exception as e:  # reported by the caller, after the resize
            werr.append(repr(e))
        finally:
            cli.close()

    with CardBusy(ctx["device"]) as busy:
        threads, recs, errors = mix_clients(nodes[0].server.port, ctx["mix"], ctx["serial"],
                                            stop, SEED + 700, ELASTIC_CLIENTS)
        wt = threading.Thread(target=writer)
        for th in threads + [wt]:
            th.start()
        t0 = time.perf_counter()
        try:
            run()
        finally:
            t1 = time.perf_counter()
            stop.set()
            for th in threads + [wt]:
                th.join(timeout=120)
    if any(th.is_alive() for th in threads + [wt]) or errors or werr:
        raise AssertionError(f"cluster: {tag}: clients: {(errors + werr)[:3]}")
    res = window_stats(recs, t0, t1, busy)
    res["writes_acked"] = len(acked)
    return t1 - t0, res, acked


def check_acked(nodes, acked, tag):
    """Every acknowledged write of the resize's writer on every replica of
    its shard: the writes missing from a replica."""
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    placement = nodes[0].cluster
    by_id = {nd.node_id: nd for nd in nodes}
    missing = 0
    for row, col in acked:
        s = col // SHARD_WIDTH
        for o in placement.shard_nodes("i", s):
            frag = by_id[o.id].holder.fragment("i", "wr", "standard", s)
            if frag is None or not frag.get_bit(row, col % SHARD_WIDTH):
                missing += 1
    return missing


def moved_bytes(nodes):
    """Snapshot bytes the nodes pulled as migration targets so far."""
    return sum(nd.holder.stats.snapshot()["counters"].get("migrate_snapshot_bytes", 0)
               for nd in nodes)


def cluster_elastic(ctx):
    """Steps 7-9 of the cluster path on the loaded cluster (step 6 runs
    inside step 5): anti-entropy, then, with :data:`CLUSTER_RESIZE`, a
    node added and one removed online."""
    import numpy as np

    from pilosa_tpu_torch.ops import kernels as tk
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    nodes, clis, device, card = ctx["nodes"], ctx["clis"], ctx["device"], ctx["card"]
    on_card, serial_of, check_extra = ctx["on_card"], ctx["serial_of"], ctx["check_extra"]
    out = {}
    n0 = nodes[0]
    # the diverged set row goes into a field no read of the mix touches
    set_field = "ae"
    served = ctx["fields"]

    def mesh_and_http(tag, required):
        """Every read of the mix and the extra reads on both routes, each
        against numpy: first on the facades, stacks and result caches the
        step left behind (one kept past a flip would answer from the old
        owners), then cold, followed by 16 clients on the mesh route for a
        window, as step 3 ran the route: (the kernels the mesh route's cold
        pass and window launched, the window's stats). ``required`` must be
        among them."""
        for route in ("mesh", "http"):
            set_mesh(nodes, route == "mesh")
            serial_of(clis[0])
            check_extra(f"{tag}, {route} route, as the step left it")
        # cold, as step 3 ran it: no facade, stack or cache of the earlier
        # steps (which kernels a pass launches follows the caches' warmth)
        for nd in nodes:
            nd.api.dist.forget_placement()
            nd.api.executor.release_stacks()
        for route in ("http", "mesh"):
            set_mesh(nodes, route == "mesh")
            for d in (nd.api.dist for nd in nodes):
                for fex in list(d._mesh_cache.values()):
                    fex.rescache.clear()
            l0 = dict(tk.LAUNCHES)
            serial_of(clis[0])
            check_extra(f"{tag}, {route} route")
        window = cluster_load_window(nodes, ctx["mix"], ctx["serial"], CLUSTER_SECONDS, device,
                                     f"mesh route {tag}")
        launched = sorted(k for k in tk.LAUNCHES if tk.LAUNCHES[k] > l0[k])
        fallbacks = sum(nd.api.dist.mesh_fallbacks for nd in nodes)
        if fallbacks:
            raise AssertionError(f"cluster: {tag}: mesh_fallbacks {fallbacks}")
        missing = [k for k in required if k not in launched]
        if on_card and missing:
            raise AssertionError(f"cluster: {tag}: the mesh route launched no {missing} "
                                 f"(launched {launched})")
        return launched, {k: window[k] for k in ("qps", "p50_ms", "p99_ms", "idle_share",
                                                 "queries")}

    # -- 7. anti-entropy: one replica of 4 fragments diverged directly
    rng = np.random.default_rng(SEED + 71)
    if set_field == "ae":
        n0.api.create_field("i", "ae")
    shards = [int(s) for s in rng.choice(S_FULL, ELASTIC_AE_FRAGMENTS, replace=False)]
    # h fragments only (one f fragment before the script's time limit
    # needed the time, two before the loadgen path did: the round merges a
    # diverged block's 64 dense rows of f, 16.8 M pairs, in 20-55 s)
    plan = [("h", shards[0], "clear"), ("h", shards[1], "clear"), ("h", shards[2], "clear"),
            (set_field, shards[3], "set")]
    by_id = {nd.node_id: nd for nd in nodes}
    before_set = clis[0].query("i", f"Count(Row({set_field}=6))")[0]
    diverged = []
    n_set = 0
    for field, s, how in plan:
        replica = by_id[n0.cluster.shard_nodes("i", s)[0].id]
        frag = replica.holder.field("i", field).create_view_if_not_exists(
            "standard").create_fragment_if_not_exists(s)
        row = 6 if how == "set" else int(rng.choice(frag.row_ids()))
        words = frag.row_words_host(row)
        bits = np.unpackbits(words.view(np.uint8), bitorder="little").astype(bool)
        pool_cols = np.flatnonzero(~bits if how == "set" else bits)
        cols = rng.choice(pool_cols, min(ELASTIC_AE_BITS, len(pool_cols)), replace=False)
        frag.import_bits(np.full(len(cols), row, dtype=np.uint64), cols.astype(np.int64),
                         clear=how == "clear")
        if how == "set":
            n_set = len(cols)
        diverged.append((field, s, how, len(cols)))
    syncers = [nd.syncer() for nd in nodes]
    t0 = time.perf_counter()
    with StageClock(elastic_stages("antientropy")) as ae_clock:
        rounds = [sy.sync_holder() for sy in syncers]
    ae_s = time.perf_counter() - t0
    log(f"cluster: step 7: the round took {ae_s:.2f} s; its stages in thread-seconds "
        f"{json.dumps(clock_report(ae_clock))}")
    tot = {k: sum(r[k] for r in rounds) for k in rounds[0]}
    for field, s, _how, _n in diverged:
        owners = [by_id[o.id] for o in n0.cluster.shard_nodes("i", s)]
        mats = [o.holder.fragment("i", field, "standard", s).snapshot_rows() for o in owners]
        if not all(np.array_equal(m[0], mats[0][0]) and np.array_equal(m[1], mats[0][1])
                   for m in mats[1:]):
            raise AssertionError(f"cluster: anti-entropy: the replicas of shard {s} of "
                                 f"{field} differ after the round")
    got_set = clis[0].query("i", f"Count(Row({set_field}=6))")[0]
    if got_set != before_set + n_set:
        raise AssertionError(f"cluster: anti-entropy: Count(Row({set_field}=6)) {got_set} != "
                             f"{before_set} + {n_set}")
    launched, _ = mesh_and_http("after anti-entropy", ())
    if on_card and not launched:
        raise AssertionError("cluster: after anti-entropy: the mesh route launched nothing")
    out["antientropy"] = {
        "round_s": ae_s, "diverged": diverged,
        "blocks_compared": sum(sy.blocks_compared for sy in syncers),
        "blocks_repaired": tot["blocks_diff"], "bits_set": tot["bits_set"],
        "bits_cleared": tot["bits_cleared"], "fragments_visited": tot["fragments"],
        "block_pairs": sum(sy.block_pairs for sy in syncers),
        "block_bytes": sum(sy.block_bytes for sy in syncers),
        "mesh_launched": launched, "stages": clock_report(ae_clock),
    }
    log(f"cluster: step 7, anti-entropy on {card}: one replica of {len(diverged)} "
        f"fragments diverged ({diverged}); a sync_holder round on the {len(nodes)} nodes in "
        f"{ae_s:.2f} s: {out['antientropy']['blocks_compared']} blocks compared, "
        f"{tot['blocks_diff']} repaired, {tot['bits_set']} bits set and "
        f"{tot['bits_cleared']} cleared, {out['antientropy']['block_pairs']} (row, col) pairs "
        f"in {out['antientropy']['block_bytes']} bytes of block data; the replicas equal "
        f"word for word; every read exact on both routes, the mesh route launching "
        f"{launched}")

    # -- 8. a node added online, then 9. a node removed, each under load
    if not CLUSTER_RESIZE:
        return out
    n0.api.create_field("i", "wr")
    for step, tag in ((8, "add"), (9, "remove")):
        before = cluster_load_window(nodes, ctx["mix"], ctx["serial"], CLUSTER_SECONDS,
                                     device, f"before the {tag}")
        dev0 = device_holdings(nodes)
        b0, m0, _ = card_bytes(device)
        moved0 = moved_bytes(nodes)
        if tag == "add":
            from pilosa_tpu_torch.server.node import NodeServer

            d = cluster_node_dir(len(nodes), ctx["root"])
            joiner = NodeServer(data_dir=d, device=device, port=0, replica_n=CLUSTER_REPLICAS)
            joiner.start()
            joiner.api.executor.rescache.max_entries = 0
            ctx["all_nodes"].append(joiner)
            joiner.start_membership()

            def run(j=joiner):
                n0.resize_coordinator().add_node(j.node_id, j.uri)
        else:
            leaving = nodes[1]

            def run(x=leaving):
                n0.resize_coordinator().remove_node(x.node_id)
        # the writer goes through node 1 while a node joins, and through the
        # joiner while node 1 leaves
        with StageClock(elastic_stages("resize")) as rz_clock:
            resize_s, during, acked = resize_under_load(
                ctx, tag, run, nodes[1] if tag == "add" else nodes[-1],
                range(ELASTIC_WR_ROWS) if tag == "add"
                else range(ELASTIC_WR_ROWS, 2 * ELASTIC_WR_ROWS))
        log(f"cluster: step {step}: the resize took {resize_s:.2f} s; {len(acked)} writes "
            f"acknowledged; reads p50 {during['p50_ms']:.2f} ms, p99 {during['p99_ms']:.2f} ms; "
            f"its stages in thread-seconds {json.dumps(clock_report(rz_clock))}")
        moved = moved_bytes(nodes + ([joiner] if tag == "add" else [])) - moved0
        if tag == "add":
            nodes.append(joiner)
            clis.append(HttpClient(joiner.server.port))
        else:
            nodes.remove(leaving)
            clis.pop(1).close()
            leaving.stop()
        for nd in nodes:
            if len(nd.cluster.nodes) != len(nodes) or nd.cluster.state != "NORMAL" \
                    or nd.cluster.resize_pending:
                raise AssertionError(f"cluster: {tag}: a node's membership did not commit")
        # before any anti-entropy: the migration's catch-up and finalize
        # alone must have carried every acknowledged write
        missing = check_acked(nodes, acked, tag)
        if missing:
            raise AssertionError(f"cluster: {tag}: {missing} of {len(acked)} acknowledged "
                                 f"writes missing from a replica after the resize")
        checked, per_node = check_holdings(nodes, served, tag, ctx["pool"], ctx["f_np"])
        launched, after = mesh_and_http(f"after the {tag}", ctx["step3_required"])
        held1 = {(nd.node_id,) + key for nd in nodes for key in fragment_keys(nd)}
        dropped = {k: v for k, v in dev0.items() if k not in held1 and k[0] in
                   {nd.node_id for nd in nodes}}
        released = sum(b for _, b in dropped.values())
        from pilosa_tpu_torch.core import membudget

        bud = membudget.default_budget(nodes[0].holder.device)
        for (nid, *key), (frag, _b) in dropped.items():
            if frag._device is not None or frag._budget_key in bud._entries:
                raise AssertionError(f"cluster: {tag}: the dropped fragment {key} of "
                                     f"{nid[:8]} kept its device copy")
        del dev0, dropped
        b1, m1, snap = card_bytes(device)
        if on_card and (m1 - m0) - (b1 - b0) > (256 << 20):
            raise AssertionError(f"cluster: {tag}: the card's memory grew "
                                 f"{(m1 - m0) / 1e6:.1f} MB against the budget's "
                                 f"{(b1 - b0) / 1e6:.1f} MB")
        if tag == "remove":
            events = n0.holder.events.since(0)["events"]
            if any(e["type"] == "resize-data-loss" for e in events) or any(
                    k.startswith("resize_data_loss_fragments")
                    for k in n0.holder.stats.snapshot()["counters"]):
                raise AssertionError("cluster: remove: the data-loss journal is not empty")
        res = {
            "resize_s": resize_s, "bytes_moved": moved, "mb_per_s": moved / resize_s / 1e6,
            "before": {k: before[k] for k in ("qps", "p50_ms", "p99_ms", "idle_share",
                                              "queries")},
            "during": {k: during[k] for k in ("qps", "p50_ms", "p99_ms", "idle_share",
                                              "queries", "writes_acked")},
            "acked_missing": missing,
            "fragments_checked": checked, "fragments_per_node": per_node,
            "device_bytes_released": released, "budget_used": [b0, b1],
            "memory_allocated": [m0, m1], "budget": snap, "mesh_launched": launched,
            "after": after, "step3_launched": ctx["step3_launched"],
            "stages": clock_report(rz_clock),
            "members": len(nodes),
        }
        out[f"resize_{tag}"] = res
        log(f"cluster: step {step}, a node {'added' if tag == 'add' else 'removed'} on "
            f"{card}: the resize took {resize_s:.2f} s and moved {moved / 1e9:.3f} GB "
            f"({res['mb_per_s']:.1f} MB/s) under {ELASTIC_CLIENTS} clients and a writer; "
            f"reads p50 "
            f"{during['p50_ms']:.2f} ms, p99 {during['p99_ms']:.2f} ms, {during['qps']:.1f} "
            f"queries/s during it against p50 {before['p50_ms']:.2f} ms, p99 "
            f"{before['p99_ms']:.2f} ms, {before['qps']:.1f} queries/s before; "
            f"{len(acked)} writes acknowledged, {missing} missing from a replica; {after['qps']:.1f} queries/s, p99 {after['p99_ms']:.2f} ms after it; "
            f"{checked} shards of the served fields held exactly by their owners, "
            f"replicas equal; {released / 1e9:.3f} GB of dropped fragments' device copies "
            f"released (budget {b0 / 1e9:.3f} -> {b1 / 1e9:.3f} GB, memory_allocated "
            f"{m0 if m0 is None else round(m0 / 1e9, 3)} -> "
            f"{m1 if m1 is None else round(m1 / 1e9, 3)} GB); every read exact on both "
            f"routes, the mesh route launching {launched} ({ctx['step3_launched']} in "
            f"step 3)")
    return out


def cluster_path(pool, device, hand):
    """Three nodes of the port in one process on the card
    (``cluster/``, ``parallel/meshplace.py``, ``server/node.py`` with
    ``replica_n=2``, every plane at JAX's defaults, each on a data
    directory of its own):

    1. boot and ``join_static``; the served index's schema (f of 64 rows,
       h, v and w of depth 20, the existence field; not g, which no read of
       the mix touches: a ``reduced:`` line) created through node 0 and
       broadcast; each of the 160 shards (2^20 columns) loaded on its two
       owners by the port's placement through their imports (f, h and v as
       the storage path's directory holds them after the earlier paths, w
       drawn anew from the seed), every node then knowing all 160 shards of
       every field; the load's stages timed;
    2. routing: one JSON import of a small field on 8 shards through node
       0 over HTTP, routed in binary to the owners, read back word for
       word from both replicas of every shard;
    3. the 26-query read mix (the serving path's, less its keyed read, plus
       GroupBy f x h and a GroupBy of f's first 8 rows with themselves, the
       gram's read on the HTTP route's per-call legs) from 16 keep-alive
       clients against node 0 with every result cache emptied, on the mesh
       route (one launch over a holder facade) and on the HTTP fan-out
       (``mesh_dispatch`` off on every node), with w's Sum: every
       answer against numpy; on the mesh route, the three nodes' planes
       running and stopped in alternating pairs of windows under one load;
    4. writes: a Set through node 1 read through node 0 on both routes and
       found on both replicas (then cleared through node 2); a keyed field
       written through a node that is not the translation primary and read
       through a third; TopN exactness where the true top row is second on
       every node's shard (the mesh route) and where it is second on one
       node only (both routes);
    5. failover: node 2 stopped; every read of the mix exact through its
       replicas under 16 clients (p99), node 2's breaker open in node 0's
       /debug/vars and in a flight-recorder segment, ``?cluster=true`` on
       /debug/events listing the three nodes' events before the stop and
       node 2 unreachable after;
    6. membership (``start_membership`` on the three nodes before step 5's
       stop, JAX's probe cadence): the time until nodes 0 and 1 mark node 2
       DOWN; the HTTP route's reads then skip it by its state; node 2
       restarted on its data directory, the time until both mark it READY,
       its first answer exact;
    Every node's id is fixed from :data:`SEED` (:func:`cluster_node_dir`).
    Steps 7-9 run over f, h and v: w, which no read of the mix touches, is
    deleted after step 6 (a ``reduced:`` line says so).

    7. anti-entropy: one replica of 4 fragments diverged directly (bits of
       three h fragments cleared, bits of a row no read of the mix touches
       set), one
       ``sync_holder`` round on every node; the replicas equal word for
       word, every read exact on both routes, the mesh route launching
       kernels;
    8. (with ``--resize``, :data:`CLUSTER_RESIZE`) a fourth node joins
       online through node 0's resize coordinator while
       16 clients post the read mix and a writer sets bits through node 1:
       the resize's seconds, bytes and MB/s, the reads' p50/p99 during it
       against a window before; then every acknowledged write on both of
       its replicas, each node holding exactly what the placement gives it,
       the replicas equal, the dropped fragments' device copies released
       (the budget and ``memory_allocated``), every read exact on both
       routes, and the mesh route's pass and 16-client window launching
       every kernel step 3 requires of it, with no mesh fallback;
    9. node 1, alive, removed the same way (the writer through the
       joiner), with the same checks and an empty data-loss journal."""
    import gc

    import numpy as np
    import torch

    from pilosa_tpu_torch.ops import kernels as tk
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    on_card = torch.device(device).type == "cuda"
    t_path = time.perf_counter()
    out = {}
    reads, items, want_of = hand["reads"], hand["items"], dict(hand["want_of"])
    mix = [m for m in read_mix(reads, items) if m[2] == "i"]
    mix += [("GroupBy f x h", "GroupBy(Rows(f), Rows(h))", "i"),
            (f"GroupBy f x f ({CLUSTER_FF_ROWS} rows)",
             f"GroupBy(Rows(f, limit={CLUSTER_FF_ROWS}), Rows(f, limit={CLUSTER_FF_ROWS}))",
             "i")]
    f_np, h_np = hand["f"], hand["h"]

    # -- host memory: replica 2 keeps two host mirrors of every field, beside
    # the sources
    bsi_bytes = S_FULL * (2 + BSI_DEPTH) * W_FULL * 4
    need = (CLUSTER_REPLICAS + 1) * (f_np.nbytes + h_np.nbytes + 2 * bsi_bytes)
    need += CLUSTER_HOST_MARGIN
    avail = mem_available()
    if avail < need:
        raise AssertionError("cluster: too little host memory for two mirrors of f, h, "
                             "v and w")
    # g, the served index's second 64-row field, is not loaded: no read of the
    # mix touches it, and its 2.7 GB on the owners cost the load about a third
    msg = ("cluster path: g not loaded (was loaded on its owners and read once a step "
           "through step 6), for the loadgen path's time")
    out["reduced"] = [msg]
    log("reduced: " + msg)
    out["host_bytes_needed"], out["host_bytes_available"] = need, avail
    log(f"cluster: {avail / 1e9:.1f} GB of host memory available, {need / 1e9:.1f} GB "
        f"reckoned for {CLUSTER_REPLICAS} mirrors of the served index's fields and their "
        f"sources")

    def grams_of(s):
        under = np.stack([np.bitwise_count(f_np[s] & h_np[s, q]).sum(axis=1, dtype=np.int64)
                          for q in range(H_ROWS)])
        ff = np.stack([np.bitwise_count(f_np[s, :CLUSTER_FF_ROWS] & f_np[s, r]).sum(
            axis=1, dtype=np.int64) for r in range(CLUSTER_FF_ROWS)])
        return under, ff

    t0 = time.perf_counter()
    src_job = pool.submit(cluster_sources, hand, pool)
    parts = by_shard(pool, grams_of)
    under, ff = sum(p[0] for p in parts), sum(p[1] for p in parts)
    want_of["GroupBy f x h"] = [("group", (r, q), int(under[q, r]))
                                for r in range(f_np.shape[1]) for q in range(H_ROWS)
                                if under[q, r]]
    want_of[mix[-1][0]] = [("group", (a, b), int(ff[a, b]))
                           for a in range(CLUSTER_FF_ROWS) for b in range(CLUSTER_FF_ROWS)
                           if ff[a, b]]
    src, extra_truth = src_job.result()
    out["sources_s"] = time.perf_counter() - t0

    root = HERE / "build"
    root.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    nodes = cluster_nodes(device, CLUSTER_NODES, root)
    out["boot_s"] = time.perf_counter() - t0
    # every node this path starts, stopped at its end
    all_nodes = list(nodes)
    card = card_line() if on_card else "cpu, no power limit"
    try:
        n0, n1, n2 = nodes
        for nd in nodes:
            d, c, fr = nd.api.dist, nd.client, nd.flightrec
            if not (nd.cluster.replica_n == 2 and d is not None and d.mesh_enabled
                    and c.timeout == 30.0 and c.retry_budget == 2
                    and c.breaker_threshold == 5 and c.breaker_cooldown == 2.0
                    and fr is not None and fr.sample_interval == 0.025
                    and nd.history is not None and nd.blackbox is not None
                    and nd.api.batcher is not None and nd.api.qos is not None
                    and type(nd.api.executor.translator).__name__ == "PrimaryTranslateStore"):
                raise AssertionError("cluster: a node is not at JAX's defaults")
        clis = [HttpClient(nd.server.port) for nd in nodes]

        # -- 1. schema through node 0, broadcast; the load
        # every result cache emptied before the first query, so the mesh
        # route's facade executors are made with none (they take the local
        # executor's setting)
        for nd in nodes:
            nd.api.executor.rescache.max_entries = 0
            nd.api.executor.rescache.clear()
        api0 = n0.api
        api0.create_index("i")
        for name in ("f", "h"):
            api0.create_field("i", name)
        for name, (lo, hi) in BSI_FIELDS.items():
            api0.create_field("i", name, {"type": "int", "min": lo, "max": hi})
        if len({json.dumps(nd.api.schema(), sort_keys=True) for nd in nodes}) != 1:
            raise AssertionError("cluster: the schema broadcast left the nodes apart")
        load_s, load_bytes, stages = cluster_load(pool, nodes, src)
        del src
        gc.collect()
        amap = [nd.api.available_shards_map()["i"] for nd in nodes]
        for m in amap:
            for field in m:
                if m[field] != list(range(S_FULL)):
                    raise AssertionError(f"cluster: a node knows {len(m[field])} shards of "
                                         f"{field}")
        held = [sum(len(v.fragments) for v in nd.holder.field("i", "f").views.values())
                for nd in nodes]
        out["load"] = {"seconds": load_s, "bytes": load_bytes, "f_fragments_per_node": held,
                       "mb_per_s": load_bytes / load_s / 1e6, "stages": stages}
        log(f"cluster: {CLUSTER_NODES} nodes booted in {out['boot_s']:.2f} s; sources "
            f"{out['sources_s']:.1f} s; {load_bytes / 1e9:.2f} GB of roaring payloads to "
            f"the owners in {load_s:.1f} s ({out['load']['mb_per_s']:.1f} MB/s); f's "
            f"fragments a node {held}; every node knows all {S_FULL} shards of every field; "
            f"the load's stages in thread-seconds (summed over the threads that ran them; "
            f"apply holds the op log): {json.dumps(stages)}")

        # -- 2. routing: one JSON import through node 0, routed to the owners
        rrng = np.random.default_rng(SEED + 61)
        api0.create_field("i", "r")
        n_bits = 40_000
        r_rows = rrng.integers(0, CLUSTER_R_ROWS, n_bits).astype(np.uint64)
        r_cols = (rrng.integers(0, CLUSTER_R_SHARDS, n_bits) * SHARD_WIDTH
                  + rrng.integers(0, SHARD_WIDTH, n_bits)).astype(np.uint64)
        code, body = clis[0].post("/index/i/field/r/import", {
            "rowIDs": r_rows.tolist(), "columnIDs": r_cols.tolist()})
        if code != 200:
            raise AssertionError(f"cluster: the routed import: {code} {body[:200]!r}")
        for s in range(CLUSTER_R_SHARDS):
            m = (r_cols // SHARD_WIDTH) == s
            want = np.zeros((CLUSTER_R_ROWS, W_FULL), dtype=np.uint32)
            offs = (r_cols[m] % SHARD_WIDTH).astype(np.int64)
            np.bitwise_or.at(want, (r_rows[m].astype(np.int64), offs // 32),
                             (np.uint32(1) << (offs % 32).astype(np.uint32)))
            owners = {o.id for o in n0.cluster.shard_nodes("i", s)}
            for nd in nodes:
                frag = nd.holder.fragment("i", "r", "standard", s)
                if nd.node_id in owners:
                    got = np.stack([frag.row_words_host(r) for r in range(CLUSTER_R_ROWS)])
                    if not np.array_equal(got, want):
                        raise AssertionError(f"cluster: shard {s} of r differs on an owner")
                elif frag is not None and frag.row_ids():
                    raise AssertionError(f"cluster: shard {s} of r on a node that does not "
                                         f"own it")
        r_truth = int(np.bitwise_count(np.unique(r_cols[r_rows == 3])).size)
        if clis[0].query("i", "Count(Row(r=3))") != [r_truth]:
            raise AssertionError("cluster: Count(Row(r=3)) after the routed import")
        api0.delete_field("i", "r")
        log(f"cluster: a JSON import of {n_bits} bits on {CLUSTER_R_SHARDS} shards through "
            f"node 0, routed to the owners, equals numpy word for word on both replicas of "
            f"every shard")

        def check(name, got):
            norm = norm_json(got[0]) if not name.startswith("pair ") else got[0]
            if norm != want_of[name]:
                raise AssertionError(f"cluster: {name}: {str(norm)[:2000]} != "
                                     f"{str(want_of[name])[:2000]}")

        def serial_of(cli):
            serial = {}
            for n, q, index in mix:
                got = cli.query(index, q)
                check(n, got)
                serial[n] = got
            return serial

        def check_extra(tag):
            """w's read (a field the mix does not touch)."""
            for q, want in extra_truth.items():
                got = clis[0].query("i", q)[0]
                if norm_json(got) != want:
                    raise AssertionError(f"cluster: {tag}: {q}: {got} != {want}")

        # -- 3. the mesh route, then the HTTP fan-out
        routes = {}
        for route in ("mesh", "http"):
            set_mesh(nodes, route == "mesh")
            for d in (nd.api.dist for nd in nodes):
                for fex in list(d._mesh_cache.values()):
                    fex.rescache.clear()
            l0 = dict(tk.LAUNCHES)
            serial = serial_of(clis[0])
            check_extra(f"{route} route")
            routes[route] = cluster_load_window(nodes, mix, serial, CLUSTER_SECONDS, device,
                                                f"{route} route")
            routes[route]["serial"] = serial
            # the route's launches over its serial pass and its load: the
            # stacks' gram, row-count and aggregate caches answer repeats
            routes[route]["launched_in_route"] = sorted(
                k for k in tk.LAUNCHES if tk.LAUNCHES[k] > l0[k])
            if route == "mesh":
                # what the planes (three flight recorders, histories and
                # black boxes) take from the route: running and stopped in
                # alternating pairs of windows under one load
                routes["mesh_planes_ab"] = planes_ab(
                    nodes, mix, serial, device, "cluster: mesh route", CLUSTER_AB_PAIRS,
                    CLUSTER_AB_WINDOW, alternate=True)
        if routes["mesh"]["mesh_dispatches"] <= 0 or routes["mesh"][
                "http_subrequests_per_query"] != 0:
            raise AssertionError("cluster: the mesh route took HTTP legs")
        if routes["http"]["mesh_dispatches"] != 0:
            raise AssertionError("cluster: the HTTP route dispatched on the mesh")
        if on_card:
            for k in OBS_KERNELS + ("cross_gram",):
                if k not in routes["mesh"]["launched_in_route"]:
                    raise AssertionError(f"cluster: the mesh route launched no {k}")
            if not routes["mesh"]["launches_per_query"]:
                raise AssertionError("cluster: the mesh route's load launched no kernel")
            for k in ("masked_row_scan", "gram", "tree_count"):
                if k not in routes["http"]["launched_in_route"]:
                    raise AssertionError(f"cluster: the HTTP route launched no {k}")
        log(f"cluster: kernels launched on the mesh route "
            f"{routes['mesh']['launched_in_route']}, on the HTTP route's per-call legs "
            f"{routes['http']['launched_in_route']}")
        out["mesh"] = {k: v for k, v in routes["mesh"].items() if k != "serial"}
        out["http"] = {k: v for k, v in routes["http"].items() if k != "serial"}
        ab = routes["mesh_planes_ab"]
        out["mesh_planes_ab"] = {k: v for k, v in ab.items() if k not in ("t0", "t1")}
        # a sub-request's cost: the capacity the HTTP route loses a query
        # against the mesh route, over its sub-requests a query
        out["http_ms_per_subrequest"] = (
            (1 / out["http"]["qps"] - 1 / out["mesh"]["qps"]) * 1e3
            / out["http"]["http_subrequests_per_query"])
        log(f"cluster: the HTTP route's cost: {out['http_ms_per_subrequest']:.2f} ms of the "
            f"node's serving time a sub-request")
        serial = routes["mesh"]["serial"]

        # -- 4. writes: a Set through node 1, read through node 0 on both routes
        f_rows = f_np.shape[1]
        row = f_rows - 1
        s_w = 7
        col = int(np.flatnonzero(~np.unpackbits(f_np[s_w, row].view(np.uint8),
                                                bitorder="little").astype(bool))[0])
        before = clis[0].query("i", f"Count(Row(f={row}))")[0]
        if clis[1].query("i", f"Set({s_w * SHARD_WIDTH + col}, f={row})") != [True]:
            raise AssertionError("cluster: the Set through node 1")
        owners = {o.id for o in n0.cluster.shard_nodes("i", s_w)}
        for nd in nodes:
            frag = nd.holder.fragment("i", "f", "standard", s_w)
            if (nd.node_id in owners) != bool(frag is not None and frag.get_bit(row, col)):
                raise AssertionError("cluster: the Set is not on exactly the two replicas")
        for route in ("mesh", "http"):
            set_mesh(nodes, route == "mesh")
            if clis[0].query("i", f"Count(Row(f={row}))") != [before + 1]:
                raise AssertionError(f"cluster: the Set read through node 0 on the {route} "
                                     f"route")
        if clis[2].query("i", f"Clear({s_w * SHARD_WIDTH + col}, f={row})") != [True]:
            raise AssertionError("cluster: the Clear through node 2")
        set_mesh(nodes, True)
        if clis[0].query("i", f"Count(Row(f={row}))") != [before]:
            raise AssertionError("cluster: the Clear read through node 0")
        log(f"cluster: a Set through node 1 read through node 0 on both routes and found on "
            f"both replicas; cleared through node 2")

        # a keyed field written through a node that is not the primary
        primary = n0.cluster.translate_primary().id
        writer = next(k for k, nd in enumerate(nodes) if nd.node_id != primary)
        reader = next(k for k, nd in enumerate(nodes)
                      if nd.node_id != primary and k != writer)
        api0.create_index("kk", {"keys": True})
        api0.create_field("kk", "kf", {"keys": True})
        keyed_writes = [(f"user{k}", ("red", "blue", "green")[k % 3]) for k in range(30)]
        body = " ".join(f'Set("{c}", kf="{r}")' for c, r in keyed_writes)
        clis[writer].query("kk", body)
        for color in ("red", "blue", "green"):
            want = sorted(c for c, r in keyed_writes if r == color)
            got = clis[reader].query("kk", f'Row(kf="{color}")')[0]
            if sorted(got["keys"]) != want:
                raise AssertionError(f"cluster: keyed Row({color}) through a third node")
        ids = {json.dumps(nd.api.translate_keys("kk", "kf", ["red", "blue", "green"]))
               for nd in nodes}
        if len(ids) != 1:
            raise AssertionError("cluster: the nodes map the keys to other ids")
        log(f"cluster: keys written through node {writer} (not the primary) read through "
            f"node {reader}; every node maps them alike")

        # TopN exactness: the true top row second on every node's shard (one
        # launch over the facade), and second on one node only (both routes)
        api0.create_field("i", "tn")
        by_primary = {}
        for s in range(S_FULL):
            by_primary.setdefault(n0.cluster.primary_shard_node("i", s).id, s)
        trio = sorted(by_primary.values())[:3]
        bits = []
        for k, s in enumerate(trio):
            base = s * SHARD_WIDTH
            bits += [(1 + k, base + c) for c in range(4)]
            bits += [(9, base + 100 + c) for c in range(3)]
        n0.api.import_bits("i", "tn", {"rowIDs": [r for r, _ in bits],
                                       "columnIDs": [c for _, c in bits]})
        set_mesh(nodes, True)
        got = clis[0].query("i", "TopN(tn, n=1)")[0]
        if got != [{"id": 9, "count": 9}]:
            raise AssertionError(f"cluster: TopN(tn, n=1) on the mesh route: {got}")
        api0.create_field("i", "tm")
        a, b = trio[0], trio[1]
        bits = [(1, a * SHARD_WIDTH + c) for c in range(4)]
        bits += [(9, a * SHARD_WIDTH + 100 + c) for c in range(3)]
        bits += [(9, b * SHARD_WIDTH + c) for c in range(3)] + [(2, b * SHARD_WIDTH + 100)]
        n0.api.import_bits("i", "tm", {"rowIDs": [r for r, _ in bits],
                                       "columnIDs": [c for _, c in bits]})
        for route in ("mesh", "http"):
            set_mesh(nodes, route == "mesh")
            got = clis[0].query("i", "TopN(tm, n=1) TopN(tm, n=2)")
            if got != [[{"id": 9, "count": 6}], [{"id": 9, "count": 6}, {"id": 1, "count": 4}]]:
                raise AssertionError(f"cluster: TopN(tm) on the {route} route: {got}")
        set_mesh(nodes, True)
        for name in ("tn", "tm"):
            api0.delete_field("i", name)
        log("cluster: TopN exact where the top row is second on every node's shard (mesh "
            "route) and where it is second on one node (both routes)")

        # -- 5. failover: the merged events first, then node 2 stopped
        merged = json.loads(clis[0].get("/debug/events?cluster=true")[1])
        seen = {e["node"] for e in merged["events"]}
        if seen != {nd.node_id for nd in nodes} or merged["nodes"] != CLUSTER_NODES:
            raise AssertionError(f"cluster: ?cluster=true lists events of {len(seen)} nodes")
        n2_netloc = n2.uri.split("//", 1)[1]
        # 6 (starts here): every node probes its peers at JAX's cadence
        for nd in nodes:
            nd.start_membership()
        n2_id, n2_dir, n2_port = n2.node_id, n2.store.path, n2.server.port
        marks = {}

        def watch(state, since):
            def both():
                return all(nd.cluster.node(n2_id).state == state for nd in (n0, n1))
            marks[state] = since + wait_for(f"node 2 {state} on nodes 0 and 1", both,
                                            ELASTIC_MARK_TIMEOUT)

        n2.stop()
        t_stop = time.perf_counter()
        watcher = threading.Thread(target=watch, args=("DOWN", 0.0))
        watcher.start()
        t0 = time.perf_counter()
        serial_of(clis[0])  # every read exact through the replicas
        fail = cluster_load_window(nodes, mix, serial, CLUSTER_FAILOVER_SECONDS, device,
                                   "failover (node 2 stopped)")
        fail["first_pass_s"] = time.perf_counter() - t0
        dv = json.loads(clis[0].get("/debug/vars")[1])
        if dv["dist"]["breakers"].get(n2_netloc) not in ("open", "half-open"):
            raise AssertionError(f"cluster: node 2's breaker in /debug/vars: "
                                 f"{dv['dist']['breakers']}")
        # a segment that closed after the breaker opened carries its state
        t_seg = time.perf_counter()
        segs = []
        while time.perf_counter() - t_seg < 5.0:
            segs = [s for s in n0.flightrec.segments_snapshot()
                    if s.get("breakers", {}).get(n2_netloc) == "open"]
            if segs:
                break
            time.sleep(0.1)
        if not segs:
            raise AssertionError("cluster: no flight-recorder segment shows node 2's "
                                 "breaker open")
        merged = json.loads(clis[0].get("/debug/events?cluster=true")[1])
        if [u["node"] for u in merged["unreachable"]] != [n2.node_id]:
            raise AssertionError(f"cluster: unreachable after the stop: "
                                 f"{merged['unreachable']}")
        fail["breaker"] = dv["dist"]["breakers"][n2_netloc]
        out["failover"] = fail
        log(f"cluster: node 2 stopped: every read exact through its replicas; its breaker "
            f"{fail['breaker']} in node 0's /debug/vars and open in {len(segs)} "
            f"flight-recorder segments; ?cluster=true lists it unreachable")

        # -- 6. membership: node 2 DOWN, then restarted and READY
        watcher.join(timeout=ELASTIC_MARK_TIMEOUT + 5)
        if "DOWN" not in marks:
            raise AssertionError("cluster: membership: node 2 was not marked DOWN")
        down_s = marks["DOWN"]
        if n0.cluster.state != "DEGRADED" or n1.cluster.state != "DEGRADED":
            raise AssertionError("cluster: membership: the cluster is not DEGRADED")
        set_mesh(nodes, False)
        n0.api.dist._partition_log.clear()
        serial_of(clis[0])
        parts = list(n0.api.dist._partition_log)
        set_mesh(nodes, True)
        if not parts or any(p["httpNodes"] > 1 for p in parts):
            raise AssertionError("cluster: membership: the HTTP route still asked node 2")
        from pilosa_tpu_torch.server.node import NodeServer

        t_restart = time.perf_counter()
        n2 = NodeServer(data_dir=n2_dir, device=device, port=n2_port,
                        replica_n=CLUSTER_REPLICAS)
        n2.start()
        all_nodes.append(n2)
        if n2.node_id != n2_id:
            raise AssertionError("cluster: membership: node 2 came back under another id")
        n2.api.executor.rescache.max_entries = 0
        n2.join_static(sorted((nd.node_id, nd.uri) for nd in (n0, n1, n2)), n0.node_id)
        n2.start_membership()
        nodes[2] = n2
        boot_s = time.perf_counter() - t_restart
        watch("READY", boot_s)
        clis[2].close()
        clis[2] = HttpClient(n2.server.port)
        first = mix[0]
        t_first = time.perf_counter()
        check(first[0], clis[2].query(first[2], first[1]))
        first_s = time.perf_counter() - t_first
        if n0.cluster.state != "NORMAL" or n1.cluster.state != "NORMAL":
            raise AssertionError("cluster: membership: the cluster is not NORMAL again")
        out["membership"] = {"down_s": down_s, "restart_boot_s": boot_s,
                             "ready_s": marks["READY"], "first_answer_s": first_s,
                             "first_answer": first[0], "http_partitions_checked": len(parts)}
        log(f"cluster: step 6, membership on {card}: nodes 0 and 1 marked the stopped node 2 "
            f"DOWN {down_s:.2f} s after its stop; the HTTP route's {len(parts)} reads then "
            f"asked only the live replicas; node 2 restarted on its data directory booted in "
            f"{boot_s:.2f} s and was READY on nodes 0 and 1 {marks['READY']:.2f} s after the "
            f"restart began; its first answer ({first[0]}) exact in {first_s * 1e3:.1f} ms")

        # -- 7-9 run over f, h and v: w (no read of the mix touches it) goes
        # first
        log("reduced: cluster step 7 diverges three fragments of h, was two of f and one of h "
            "(for the loadgen path's and a slower machine's time)")
        out["reduced"].append("cluster step 7: no f fragment diverged, was two")
        if not CLUSTER_RESIZE:
            msg = ("cluster steps 8-9 (a node added and one removed online under load) not "
                   "run, were run by default; --resize runs them (for a slower machine's time)")
            out["reduced"].append(msg)
            log("reduced: " + msg)
        cut_bytes = S_FULL * W_FULL * 4 * (2 + BSI_DEPTH)
        kept_bytes = S_FULL * W_FULL * 4 * (f_np.shape[1] + H_ROWS + 2 + BSI_DEPTH)
        api0.delete_field("i", "w")
        extra_truth.clear()
        msg = (f"cluster steps 7-9 run over f, h and v ({kept_bytes / 1e9:.2f} GB a replica), "
               f"was f, h, v and w ({(kept_bytes + cut_bytes) / 1e9:.2f} GB a replica): w "
               f"deleted after step 6, its reads checked through step 6")
        out["reduced"].append(msg)
        log("reduced: " + msg)
        log(f"cluster: node ids fixed from SEED: {[nd.node_id[:8] for nd in nodes]}")

        # -- 7-9. anti-entropy, then a node added and one removed online
        out.update(cluster_elastic({
            "nodes": nodes, "all_nodes": all_nodes, "clis": clis, "device": device,
            "card": card, "on_card": on_card, "serial_of": serial_of,
            "check_extra": check_extra, "mix": mix, "serial": serial,
            "fields": [("f", "standard"), ("h", "standard"), ("v", "bsig_v")],
            "root": root, "pool": pool, "f_np": f_np,
            "step3_launched": routes["mesh"]["launched_in_route"],
            "step3_required": OBS_KERNELS + ("cross_gram",),
        }))
        for cli in clis:
            cli.close()
    finally:
        for nd in all_nodes:
            nd.stop()
    del nodes, all_nodes
    gc.collect()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    out["launches"] = {k: v for k, v in tk.LAUNCHES.items() if v}
    out["path_s"] = time.perf_counter() - t_path
    log(f"cluster path: {out['path_s']:.1f} s")
    return out


# -- the loadgen path ----------------------------------------------------------

# the load harness's plan: eight stages of 5 s from 16 workers, at the base
# open-loop rate (ops/s) of the command line's plan, warm at half of it and
# overload at twice it
LOADGEN_SECONDS = 22.0
LOADGEN_WORKERS = 16
LOADGEN_PLAN_RATE = 100.0
# the base rate this path offers: at the serving size a Row answer carries
# about 42 M columns (some 400 MB of JSON) and a Range(val < b) answer up to half
# that, so one node sustains about 10 ops/s of the plan's mix on an H100
# (at a base rate of 50 the stages ran 224 s for their nominal 40, at 10
# they ran 92 s, at 5 they ran 51 s)
LOADGEN_RATE = 4.0
# shards of the Row whose JSON encoding is timed both ways (a slice of a
# seg row: the list path takes seconds at the full 160)
LOADGEN_ROW_COST_SHARDS = 20
# rows of the time field ev loaded before the run, and its shards: the low
# shards, where most of the workload's zipfian columns (and so its set_tq
# writes) fall
LOADGEN_EV_ROWS, LOADGEN_EV_SHARDS = 8, 16
# one bit in this many columns a row of ev, each on one day of 2026-01
LOADGEN_EV_EVERY = 64
# the share of the columns holding a value of val
LOADGEN_VAL_SHARE = 0.25
# the reads held to numpy after the run: Range(val < b) bounds and
# (row, first day, last day exclusive) windows of ev
LOADGEN_VAL_BOUNDS = (-4000, -1, 0, 2048)
LOADGEN_EV_WINDOWS = ((0, 1, 2), (1, 3, 10), (5, 1, 29), (40, 7, 9))
# the kernels the loadgen path must launch (a CPU rehearsal of the path
# calls these wrappers)
LOADGEN_KERNELS = ("row_scan", "gram", "bsi_range", "tree_count")


class NodeTarget:
    """One ``NodeServer`` as the schema and preload target of
    ``loadgen.prepare_schema``/``preload`` (the calls ``InProcessCluster``
    offers, on node 0's API)."""

    def __init__(self, node):
        self.nodes = [node]

    def create_index(self, name, options=None):
        self.nodes[0].api.create_index(name, options or {})

    def create_field(self, index, field, options=None):
        self.nodes[0].api.create_field(index, field, options or {})

    def import_bits(self, index, field, bits):
        self.nodes[0].api.import_bits(index, field, {
            "rowIDs": [r for r, _ in bits], "columnIDs": [c for _, c in bits]})

    def import_values(self, index, field, cols, values):
        self.nodes[0].api.import_bits(index, field, {"columnIDs": list(cols),
                                                     "values": list(values)})


def loadgen_data(pool, cfg):
    """The workload's unkeyed index at the serving size, as ``(schema,
    {(index, field, view, shard): (row ids, words)}, ev's (rows, columns,
    days))``: seg 160 shards x 64 rows about 25 % dense, val's BSI rows
    with a value in [-4096, 4096] in a quarter of the columns, and the
    existence field over both; ev's bits are timestamped, so the holder's
    time import makes its views."""
    import numpy as np

    from pilosa_tpu_torch.loadgen import workload

    lo, hi = workload.BSI_VAL_MIN, workload.BSI_VAL_MAX
    depth = max(abs(lo), abs(hi)).bit_length()
    rng = np.random.default_rng(SEED + 171)
    seg_seeds = rng.integers(0, 2**63, size=S_FULL)

    def seg_shard(s):
        r = np.random.default_rng(int(seg_seeds[s]))
        return random_words(r, (cfg.n_rows, W_FULL), dense=True)

    seg = by_shard(pool, seg_shard)
    val = bsi_field_words(rng, lo, hi, pool, share=LOADGEN_VAL_SHARE, depth=depth)
    n_ev = LOADGEN_EV_SHARDS * W_FULL * 32 // LOADGEN_EV_EVERY
    ev_rows = rng.integers(0, LOADGEN_EV_ROWS, n_ev).astype(np.uint64)
    ev_cols = rng.integers(0, LOADGEN_EV_SHARDS * W_FULL * 32, n_ev).astype(np.uint64)
    ev_days = rng.integers(1, workload.N_TQ_DAYS + 1, n_ev)
    ev_std = np.zeros((LOADGEN_EV_SHARDS, W_FULL), dtype=np.uint32)
    np.bitwise_or.at(ev_std, ((ev_cols // (W_FULL * 32)).astype(np.int64),
                              ((ev_cols % (W_FULL * 32)) // 32).astype(np.int64)),
                     np.uint32(1) << (ev_cols % 32).astype(np.uint32))
    frags = {}
    for s in range(S_FULL):
        frags[(cfg.index, "seg", "standard", s)] = (list(range(cfg.n_rows)), seg[s])
        frags[(cfg.index, "val", "bsig_val", s)] = (list(range(2 + depth)), val[s])
        exists = np.bitwise_or.reduce(seg[s], axis=0) | val[s, 0]
        if s < LOADGEN_EV_SHARDS:
            exists |= ev_std[s]
        frags[(cfg.index, "_exists", "standard", s)] = ([0], exists[None])
    schema = [{
        "name": cfg.index,
        "options": {"keys": False, "trackExistence": True},
        "fields": [
            {"name": "seg", "options": {}},
            {"name": "ev", "options": {"type": "time", "timeQuantum": "YMD"}},
            {"name": "val", "options": {"type": "int", "min": lo, "max": hi}},
        ],
    }]
    return schema, frags, (ev_rows, ev_cols, ev_days)


def loadgen_truths(pool, holder, cfg):
    """numpy over the node's host mirrors: each seg row's count, the values
    of val (decoded from its rows) and the columns of each ev row a day."""
    import numpy as np

    from pilosa_tpu_torch.loadgen import workload

    seg_view = holder.field(cfg.index, "seg").view("standard")

    def seg_counts(s):
        ids, words = seg_view.fragment(s).rows_matrix_host()
        out = np.zeros(cfg.n_rows + 1, dtype=np.int64)
        np.add.at(out, np.minimum(np.asarray(ids, dtype=np.int64), cfg.n_rows),
                  np.bitwise_count(words).sum(axis=1, dtype=np.int64))
        return out

    counts = sum(by_shard(pool, seg_counts))[:cfg.n_rows]
    vals, exists = decode_bsi(holder, "val", pool, index=cfg.index)
    ev = holder.field(cfg.index, "ev")

    def ev_row_days(row, d1, d2):
        """Set columns of ``row`` over the day views of [d1, d2)."""
        total = 0
        for s in range(S_FULL):
            acc = None
            for d in range(d1, d2):
                view = ev.view(f"standard_{workload.TIME_BASE_YEAR}"
                               f"{workload.TIME_BASE_MONTH:02d}{d:02d}")
                frag = None if view is None else view.fragment(s)
                if frag is None:
                    continue
                w = frag.row_words_host(row)
                acc = w.copy() if acc is None else acc | w
            if acc is not None:
                total += int(np.bitwise_count(acc).sum(dtype=np.int64))
        return total

    return counts, vals, exists, ev_row_days


def loadgen_path(pool, device):
    """The load harness (``pilosa_tpu_torch/loadgen``) driving one node of
    the port at the serving size, then the command line's client
    subcommands against it:

    1. data: the workload's index ``slo_bench`` written to a new directory
       under ``build/`` through a ``HolderStore`` from seeded words: seg
       (160 shards x 64 rows, about 25 % dense, a 1.34 GB stack), val (a
       value in the workload's [-4096, 4096] in a quarter of the columns),
       ev (a YMD time field: 8 rows over the first 16 shards, one bit in 64
       columns a row, each on a day of 2026-01) and the existence field;
    2. one ``NodeServer`` in this process at JAX's defaults on that
       directory (the process's, since the oversubscribed stage sets the
       process's device budget), with the harness command line's SLO
       windows and QoS time scale; ``prepare_schema`` makes the keyed index
       and ``preload`` adds its zipfian bits and values;
    3. ``LoadHarness([node.uri], WorkloadConfig(seed=SEED, n_rows=64,
       n_cols=160 x 2^20), default_stages(40, 100, 16))``: eight stages of
       5 s, 16 workers, the report validated, its fingerprint the one the
       port's generator gives for the same seed and stages, no client
       error, every stage but overload at the 0.99 availability floor and
       overload failing only with the governor's 429;
    4. the answers, once the writes settled, against numpy over the node's
       host mirrors: every seg row's Count, TopN, GroupBy, Counts of
       ``Range(val < b)`` and of ``Range(ev=r, t1, t2)``;
    5. ``python -m pilosa_tpu_torch.cli``: ``backup -i slo_keys``,
       ``restore`` of the tar into a second node on the card booted on an
       empty directory (its keyed TopN and Counts equal the first node's),
       ``check`` and ``inspect`` of three of seg's fragment files, and
       ``config`` with the node's settings."""
    import gc
    import shutil
    import tempfile

    import numpy as np
    import torch

    from pilosa_tpu_torch import convert
    from pilosa_tpu_torch.core.holder import Holder
    from pilosa_tpu_torch.loadgen import __main__ as lg_main
    from pilosa_tpu_torch.loadgen import harness, report, workload
    from pilosa_tpu_torch.server.node import NodeServer
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
    from pilosa_tpu_torch.storage.disk import HolderStore

    on_card = torch.device(device).type == "cuda"
    card = card_line() if on_card else "cpu, no power limit"
    t_path = time.perf_counter()
    out = {"card": card}
    cfg = workload.WorkloadConfig(seed=SEED, n_rows=R_FULL, n_cols=S_FULL * SHARD_WIDTH)
    stages = lg_main.default_stages(LOADGEN_SECONDS, LOADGEN_RATE, LOADGEN_WORKERS,
                                    n_cols=cfg.n_cols, n_rows=cfg.n_rows)
    if LOADGEN_RATE < LOADGEN_PLAN_RATE:
        msg = (f"loadgen base rate {LOADGEN_RATE:g} ops/s, was {LOADGEN_PLAN_RATE:g}: the "
               f"node sustains less at the serving size, where each Row answer carries a "
               f"seg row's columns (a quarter of {cfg.n_cols}) as JSON; the data is not cut")
        out["reduced"] = [msg]
        log("reduced: " + msg)

    # -- the sequence, fixed before the first byte goes out
    t0 = time.perf_counter()
    zipf = workload.Zipf(cfg.n_cols, cfg.zipf_theta)
    out["zipf_s"] = time.perf_counter() - t0
    ev_share = float(zipf._cdf[LOADGEN_EV_SHARDS * SHARD_WIDTH - 1])
    del zipf
    t0 = time.perf_counter()
    per_stage = harness.LoadHarness(["http://unused"], cfg, stages).generate()
    want_fp = workload.fingerprint([op for ops in per_stage for op in ops])
    out["generate_s"] = time.perf_counter() - t0
    out["ops_planned"] = sum(len(ops) for ops in per_stage)
    del per_stage
    log(f"loadgen: the column sampler's CDF ({cfg.n_cols} float64 entries, "
        f"{cfg.n_cols * 8 / 1e9:.2f} GB) built in {out['zipf_s']:.2f} s; the plan's "
        f"{out['ops_planned']} ops generated (three samplers) in {out['generate_s']:.2f} s, "
        f"fingerprint {want_fp[:16]}; {ev_share:.3f} of the zipfian columns fall in ev's "
        f"{LOADGEN_EV_SHARDS} shards")

    # -- 1. the data, through a HolderStore
    root = HERE / "build"
    root.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    schema, frags, (ev_rows, ev_cols, ev_days) = loadgen_data(pool, cfg)
    out["data_s"] = time.perf_counter() - t0
    data_bytes = sum(w.nbytes for _, w in frags.values())
    free = shutil.disk_usage(root).free
    if free < 2 * data_bytes + (1 << 30):
        raise AssertionError(f"loadgen: {free} bytes free under {root}, "
                             f"{2 * data_bytes + (1 << 30)} needed")
    data_dir = tempfile.mkdtemp(prefix="loadgen-", dir=root)
    STORAGE_DIRS.append(data_dir)
    t0 = time.perf_counter()
    h = Holder(device="cpu")
    st = HolderStore(h, data_dir)
    st.open()
    convert.load_arrays(h, schema, frags)
    del frags
    out["load_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ts = (np.datetime64(f"{workload.TIME_BASE_YEAR}-{workload.TIME_BASE_MONTH:02d}-01")
          + (ev_days - 1).astype("timedelta64[D]")).astype("datetime64[s]")
    h.field(cfg.index, "ev").import_bits(ev_rows, ev_cols, timestamps=ts)
    out["ev_import_s"] = time.perf_counter() - t0
    out["ev_bits"] = int(len(ev_rows))
    t0 = time.perf_counter()
    written = fragments_of(h)
    list(pool.map(lambda fr: fr.store.snapshot(), written))
    st.sync()
    st.close()
    out["write_s"] = time.perf_counter() - t0
    out["files"] = len(written)
    out["file_bytes"] = sum(os.path.getsize(fr.store.path) for fr in written)
    out["mirror_bytes"] = data_bytes
    del h, st, written, ev_rows, ev_cols, ev_days
    gc.collect()
    log(f"loadgen: data {data_bytes / 1e9:.3f} GB of words drawn in {out['data_s']:.2f} s, "
        f"loaded in {out['load_s']:.2f} s, ev's {out['ev_bits']} timestamped bits imported "
        f"in {out['ev_import_s']:.2f} s; {out['files']} fragment files, "
        f"{out['file_bytes'] / 1e9:.3f} GB, written in {out['write_s']:.2f} s")

    # -- 2. one node on the directory, the keyed index and the preload
    knobs = {"slo_burn_rules": lg_main.SHORT_BURN_RULES, "slo_slot_seconds": 1.0,
             "slo_latency_window": 60.0, "slo_objectives": lg_main.OVERLOAD_OBJECTIVES}
    nodes = []
    try:
        t0 = time.perf_counter()
        node = NodeServer(data_dir=data_dir, device=device, port=0, **knobs)
        node.start()
        nodes.append(node)
        target = NodeTarget(node)
        lg_main.tune_qos(target)
        out["boot_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        harness.prepare_schema(target, cfg)
        harness.preload(target, cfg)
        out["preload_s"] = time.perf_counter() - t0
        log(f"loadgen: the node booted on the directory in {out['boot_s']:.2f} s; schema and "
            f"preload (4096 zipfian bits, their values) in {out['preload_s']:.2f} s")

        # -- 3. the harness
        t0 = time.perf_counter()
        rep = harness.LoadHarness([node.uri], cfg, stages).run()
        out["run_s"] = time.perf_counter() - t0
        report.validate_report(rep)
        keep = ("throughputOpsPerSec", "totalOps", "clientErrors", "sequenceFingerprint",
                "wallSeconds", "opsByTenant")
        out["report"] = {k: rep[k] for k in keep}
        out["report"]["ops"] = {c: {k: v[k] for k in ("count", "errors", "p50Ms", "p99Ms",
                                                      "p999Ms", "serviceP50Ms")}
                                for c, v in rep["ops"].items()}
        out["report"]["stages"] = [
            {k: stg[k] for k in ("name", "ops", "okOps", "clientErrors", "availability",
                                 "availabilityOk", "deviceBudget", "residency", "rescache",
                                 "planner", "devcosts", "qos")} for stg in rep["stages"]]
        log(f"loadgen: on {card}: {rep['totalOps']} ops in {rep['wallSeconds']:.2f} s, "
            f"{rep['throughputOpsPerSec']:.1f} ops/s, {rep['clientErrors']} client errors, "
            f"fingerprint {rep['sequenceFingerprint'][:16]} (the generator's "
            f"{want_fp[:16]}); base rate {LOADGEN_RATE} ops/s")
        for c, v in rep["ops"].items():
            log(f"loadgen:   {c:<14} n={v['count']:<5} err={v['errors']:<4} "
                f"p50 {v['p50Ms']:.2f} ms, p99 {v['p99Ms']:.2f} ms, p999 {v['p999Ms']:.2f} ms, "
                f"service p50 {v['serviceP50Ms']:.2f} ms ({card})")
        for stg in rep["stages"]:
            log(f"loadgen:   stage {stg['name']:<14} availability {stg['availability']:.4f} "
                f"({stg['okOps']}/{stg['ops']}, {stg['clientErrors']} client errors), budget "
                f"{stg['deviceBudget']}; residency {json.dumps(stg['residency'])}; rescache "
                f"{json.dumps(stg['rescache'])}; planner {json.dumps(stg['planner'])}; devcosts "
                f"{json.dumps(stg['devcosts'])}; qos {json.dumps(stg['qos'])} ({card})")
        for t, row in rep["opsByTenant"].items():
            log(f"loadgen:   tenant {t:<10} n={row['count']} shed={row['shed']} "
                f"errors={row['errors']} p99 {row['p99Ms']} ms ({card})")
        nominal = sum(stg.duration for stg in stages)
        if out["run_s"] > 1.5 * nominal:
            log(f"loadgen: the stages ran {out['run_s']:.1f} s against {nominal:.0f} s "
                f"nominal: the node sustains less than the offered rate")
        if rep["sequenceFingerprint"] != want_fp:
            raise AssertionError(f"loadgen: fingerprint {rep['sequenceFingerprint']} != "
                                 f"the generator's {want_fp}")
        if rep["clientErrors"]:
            raise AssertionError(f"loadgen: {rep['clientErrors']} client errors")
        for stg in rep["stages"]:
            if stg["name"] != "overload" and not stg["availabilityOk"]:
                raise AssertionError(f"loadgen: stage {stg['name']} availability "
                                     f"{stg['availability']} under the floor")
        for t in lg_main.OVERLOAD_TENANTS:
            row = rep["opsByTenant"].get(t)
            if row is None or row["errors"] != row["shed"]:
                raise AssertionError(f"loadgen: overload: tenant {t} failed otherwise than "
                                     f"with the governor's 429: {row}")
        [ov] = [stg for stg in rep["stages"] if stg["name"] == "overload"]
        shed = sum(rep["opsByTenant"][t]["shed"] for t in lg_main.OVERLOAD_TENANTS)
        if ov["okOps"] + shed != ov["ops"]:
            raise AssertionError(f"loadgen: overload: {ov['ops']} ops, {ov['okOps']} ok, "
                                 f"{shed} shed")

        # -- 4. the answers against numpy over the node's mirrors
        t0 = time.perf_counter()
        node.api.executor.rescache.clear()
        cli = HttpClient(node.server.port)
        counts, vals, exists, ev_row_days = loadgen_truths(pool, node.holder, cfg)
        got = [cli.query(cfg.index, f"Count(Row(seg={r}))")[0] for r in range(cfg.n_rows)]
        if got != counts.tolist():
            bad = [r for r in range(cfg.n_rows) if got[r] != counts[r]]
            raise AssertionError(f"loadgen: Count(Row(seg=r)) differs from numpy at rows {bad}")
        top = cli.query(cfg.index, "TopN(seg, n=5)")[0]
        want_top = sorted(counts.tolist(), reverse=True)[:5]
        if [p["count"] for p in top] != want_top or any(
                counts[p["id"]] != p["count"] for p in top):
            raise AssertionError(f"loadgen: TopN(seg, n=5) {top} against counts {want_top}")
        gb = norm_json(cli.query(cfg.index, "GroupBy(Rows(seg), limit=8)")[0])
        want_gb = [("group", (r,), int(counts[r])) for r in range(cfg.n_rows) if counts[r]][:8]
        if gb != want_gb:
            raise AssertionError(f"loadgen: GroupBy(Rows(seg), limit=8) {gb} != {want_gb}")
        for b in LOADGEN_VAL_BOUNDS:
            want = int(np.count_nonzero(exists & (vals < b)))
            got = cli.query(cfg.index, f"Count(Range(val < {b}))")[0]
            if got != want:
                raise AssertionError(f"loadgen: Count(Range(val < {b})) {got} != {want}")
        for r, d1, d2 in LOADGEN_EV_WINDOWS:
            t1 = f"{workload.TIME_BASE_YEAR}-{workload.TIME_BASE_MONTH:02d}-{d1:02d}T00:00"
            t2 = f"{workload.TIME_BASE_YEAR}-{workload.TIME_BASE_MONTH:02d}-{d2:02d}T00:00"
            want = ev_row_days(r, d1, d2)
            got = cli.query(cfg.index, f"Count(Range(ev={r}, {t1}, {t2}))")[0]
            if got != want:
                raise AssertionError(f"loadgen: Count(Range(ev={r}, {t1}, {t2})) {got} != "
                                     f"{want}")
        del vals, exists
        out["truths_s"] = time.perf_counter() - t0
        log(f"loadgen: every seg row's Count, TopN, GroupBy, {len(LOADGEN_VAL_BOUNDS)} "
            f"Range(val < b) and {len(LOADGEN_EV_WINDOWS)} Range(ev=...) Counts equal numpy "
            f"over the node's mirrors after the run ({out['truths_s']:.2f} s)")

        # -- 5. the command line against the node
        env = dict(os.environ, PYTHONPATH=str(HERE))
        host = f"127.0.0.1:{node.server.port}"
        cli_s = {}

        def run_cli(name, *argv):
            t = time.perf_counter()
            r = subprocess.run([sys.executable, "-m", "pilosa_tpu_torch.cli", *argv],
                               cwd=HERE, env=env, capture_output=True, text=True, timeout=300)
            cli_s[name] = time.perf_counter() - t
            if r.returncode != 0:
                raise AssertionError(f"loadgen: cli {name} exited {r.returncode}: "
                                     f"{r.stdout[-800:]} {r.stderr[-800:]}")
            return r.stdout, r.stderr

        tar = os.path.join(data_dir + "-cli", "slo_keys.tar")
        os.makedirs(os.path.dirname(tar))
        STORAGE_DIRS.append(os.path.dirname(tar))
        run_cli("backup", "backup", "--host", host, "-i", cfg.keys_index, "-o", tar)
        empty = tempfile.mkdtemp(prefix="loadgen-restore-", dir=root)
        STORAGE_DIRS.append(empty)
        node2 = NodeServer(data_dir=empty, device=device, port=0)
        node2.start()
        nodes.append(node2)
        run_cli("restore", "restore", "--host", f"127.0.0.1:{node2.server.port}", tar)
        cli2 = HttpClient(node2.server.port)
        keyed = cli.query(cfg.keys_index, "TopN(tag, n=1000)")[0]
        if not keyed or cli2.query(cfg.keys_index, "TopN(tag, n=1000)")[0] != keyed:
            raise AssertionError("loadgen: the restored node's keyed TopN differs")
        body = " ".join(f'Count(Row(tag="{p["key"]}"))' for p in keyed)
        if cli2.query(cfg.keys_index, body) != cli.query(cfg.keys_index, body):
            raise AssertionError("loadgen: the restored node's keyed Counts differ")
        cli2.close()
        seg_view = node.holder.field(cfg.index, "seg").view("standard")
        files = [seg_view.fragment(s).store.path for s in (0, S_FULL // 2, S_FULL - 1)]
        conf = os.path.join(os.path.dirname(tar), "node.json")
        settings = {"data-dir": data_dir, "bind": host, "device": device,
                    "cluster": {"replicas": 1}}
        with open(conf, "w") as fh:
            json.dump(settings, fh)
        # the three offline subcommands at once, each its own process
        with ThreadPoolExecutor(max_workers=3) as clis:
            jobs = [clis.submit(run_cli, "check", "check", *files),
                    clis.submit(run_cli, "inspect", "inspect", *files),
                    clis.submit(run_cli, "config", "config", "-c", conf)]
            (checked, _), (inspected, _), (shown, _) = [j.result() for j in jobs]
        if checked.count(": OK (") != len(files):
            raise AssertionError(f"loadgen: cli check: {checked}")
        if inspected.count("containers: ") != len(files):
            raise AssertionError(f"loadgen: cli inspect: {inspected}")
        shown = json.loads(shown)
        if any(shown[k] != v for k, v in settings.items() if k != "cluster") or \
                shown["cluster"]["replicas"] != 1:
            raise AssertionError(f"loadgen: cli config: {shown}")
        cli.close()

        # -- what a Row answer's JSON costs: a slice of seg's row 0 encoded
        # by the query route (the columns as text, natively) and through
        # result_to_json and json.dumps, byte for byte equal
        from pilosa_tpu_torch.exec import result as res_mod

        sl = res_mod.Row({s: seg_view.fragment(s).row_words_host(0)
                          for s in range(LOADGEN_ROW_COST_SHARDS)}, W_FULL)
        t = time.perf_counter()
        fast = res_mod.response_json({"results": [sl]})
        t1 = time.perf_counter()
        slow = (json.dumps({"results": res_mod.result_to_json([sl])}) + "\n").encode()
        t2 = time.perf_counter()
        if fast != slow:
            raise AssertionError("loadgen: the query route's Row JSON differs from json.dumps")
        out["row_json"] = {"shards": LOADGEN_ROW_COST_SHARDS, "bytes": len(fast),
                           "response_json_s": t1 - t, "json_dumps_s": t2 - t1}
        del sl, fast, slow
        log(f"loadgen: a Row answer over {LOADGEN_ROW_COST_SHARDS} shards "
            f"({out['row_json']['bytes']} bytes of JSON): {t1 - t:.3f} s through the query "
            f"route's encoder, {t2 - t1:.3f} s through result_to_json and json.dumps, "
            f"byte for byte equal")
        out["cli_s"] = cli_s
        out["keyed_rows"] = len(keyed)
        log(f"loadgen: cli on {card}: backup -i {cfg.keys_index} {cli_s['backup']:.2f} s, "
            f"restore into a second node {cli_s['restore']:.2f} s ({len(keyed)} keyed rows, "
            f"TopN and Counts equal), at once: check {cli_s['check']:.2f} s and inspect "
            f"{cli_s['inspect']:.2f} s of three seg fragment files, config "
            f"{cli_s['config']:.2f} s")
    finally:
        for nd in nodes:
            nd.stop()
    del nodes
    gc.collect()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    out["path_s"] = time.perf_counter() - t_path
    log(f"loadgen path: {out['path_s']:.1f} s")
    return out


def kernel_executor(holder, **kw):
    """An executor for the in-process paths: the result cache and the
    flight planner off, so each read reaches the kernel paths and their own
    caches, whose launches and hits those paths assert (the serving path
    runs the defaults)."""
    from pilosa_tpu_torch.exec.executor import Executor

    return Executor(holder, rescache_entries=0, planner_enabled=False, **kw)


def drive(path, required, fn):
    """Run one path of the main path with every launch count set to 0 just
    before it; fail if a kernel of the path was not launched in it."""
    from pilosa_tpu_torch.ops import kernels as tk

    tk.reset_launches()
    t = time.perf_counter()
    out = fn()
    launches = dict(tk.LAUNCHES)
    log(f"{path}: launches {launches}, {time.perf_counter() - t:.1f} s")
    for k in required:
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched on the {path} path")
    return launches, out


def main() -> int:
    global CLUSTER_RESIZE
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of pilosa_tpu_torch on one CUDA card")
    ap.add_argument("--resize", action="store_true",
                    help="also run the cluster path's steps 8-9: a node added and one "
                         "removed online under load (2-5 minutes more)")
    CLUSTER_RESIZE = ap.parse_args().resize
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
    # cuobjdump reads the SASS while numpy draws the kernels' stacks
    with ThreadPoolExecutor(max_workers=1) as one:
        functions = one.submit(cuda_build.sass)
        rng = np.random.default_rng(SEED + 3)
        stack = random_words(rng, (S_FULL, R_FULL, W_FULL), dense=True)
        stack2 = random_words(rng, (S_FULL, R_FULL, W_FULL), dense=True)
        filt = random_words(rng, (S_FULL, W_FULL), dense=False)
        functions = functions.result()
    counts = cuda_build.sass_mma_counts(functions)
    log(f"bsi_range: the count instance's loop of one query of one bound side (20 planes, "
        f"4 words a thread) in SASS: {json.dumps(range_query_sass(functions))}")
    sass = gram_sass_counts(counts)
    for k, tiles in sass.items():
        log(f"{k}: tensor-core MMA instructions in SASS by tile {tiles}")
    sass["tree_count"] = tree_sass_counts(counts)
    log(f"tree_count: tensor-core MMA instructions in the staged kernel's SASS "
        f"{sass['tree_count']}")
    sass["bsi_sum_batch"] = {fn: n for fn, n in counts.items() if "pilosa_bsi_sum_batch" in fn}
    if not sass["bsi_sum_batch"] or min(sass["bsi_sum_batch"].values()) == 0:
        raise AssertionError(f"bsi_sum_batch: no tensor-core MMA in its SASS "
                             f"{sass['bsi_sum_batch']}")
    log(f"bsi_sum_batch: tensor-core MMA instructions in SASS by instance "
        f"{sass['bsi_sum_batch']}")
    t = time.perf_counter()
    kern = check_kernels(stack, stack2, filt, torch.device("cuda"))
    log(f"scan and gram kernels checked and timed in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    kern.update(check_tree_kernels(stack, stack2, torch.device("cuda"), kern["mma_macs_per_s"]))
    log(f"tree kernels checked and timed in {time.perf_counter() - t:.1f} s")
    del stack, stack2, filt
    t = time.perf_counter()
    kern.update(check_bsi_kernels(torch.device("cuda"), kern["mma_macs_per_s"]))
    log(f"bsi kernels checked and timed in {time.perf_counter() - t:.1f} s")

    try:
        return serve(kern, sass, card, t_start)
    finally:
        import shutil

        for d in STORAGE_DIRS:
            shutil.rmtree(d, ignore_errors=True)


# each kernel: its source, and the TPU kernel (or XLA code) it replaces
SOURCES = {
    "row_scan": ("pilosa_tpu_torch/ops/csrc/row_scan.cu",
                 "pilosa_tpu/ops/kernels.py:1537 _row_scan_kernel"),
    "masked_row_scan": ("pilosa_tpu_torch/ops/csrc/masked_row_scan.cu",
                        "pilosa_tpu/ops/kernels.py:1730 _masked_row_scan_kernel"),
    "gram": ("pilosa_tpu_torch/ops/csrc/gram.cu",
             "pilosa_tpu/ops/kernels.py:651 _gram_pallas_kernel"),
    "cross_gram": ("pilosa_tpu_torch/ops/csrc/cross_gram.cu",
                   "pilosa_tpu/ops/kernels.py:1265 _cross_gram_pallas_kernel"),
    "tree_count": ("pilosa_tpu_torch/ops/csrc/tree_eval.cu",
                   "pilosa_tpu/exec/astbatch.py:243 _count_scan (XLA, no pallas_call)"),
    "tree_words": ("pilosa_tpu_torch/ops/csrc/tree_eval.cu",
                   "pilosa_tpu/exec/astbatch.py:259 compiled (XLA, no pallas_call)"),
    "bsi_range": ("pilosa_tpu_torch/ops/csrc/bsi.cu",
                  "pilosa_tpu/ops/bsi.py:525 _range_count_batch_kernel and :475 "
                  "_range_batch_kernel (XLA, no pallas_call)"),
    "bsi_sum": ("pilosa_tpu_torch/ops/csrc/bsi.cu",
                "pilosa_tpu/ops/bsi.py:145 sum_count (XLA, no pallas_call)"),
    "bsi_sum_batch": ("pilosa_tpu_torch/ops/csrc/bsi_sum_batch.cu",
                      "pilosa_tpu/ops/bsi.py:628 _sum_batch_kernel (XLA, no pallas_call)"),
    "bsi_extreme": ("pilosa_tpu_torch/ops/csrc/bsi.cu",
                    "pilosa_tpu/ops/bsi.py:211 _min_max_fused (XLA, no pallas_call)"),
}


# depths cut to pay for the loadgen and mesh paths' and the batched sum's
# seconds: (what, was, is, for which path); the cluster path logs its own four cuts (g not
# loaded, w out of steps 7-9, no f fragment diverged in step 7, steps 8-9 only with
# --resize) where it makes them
DEPTH_CUTS = (
    ("http path: the 16-client window, s", 5.0, HTTP_SECONDS, "the loadgen path's"),
    ("serving path: each 16-client window, s", 5.0, SERVE_SECONDS, "the loadgen path's"),
    ("serving path: the defaults' window, s", 4.0, SERVE_DEFAULT_SECONDS,
     "the loadgen path's"),
    ("serving path: the QoS tenants' window, s", 4.0, QOS_SECONDS, "the loadgen path's"),
    ("cluster path: each 16-client window, s", 4.0, CLUSTER_SECONDS,
     "the loadgen and mesh paths'"),
    ("cluster path: the failover window, s", 3.0, CLUSTER_FAILOVER_SECONDS,
     "the loadgen path's"),
    ("cluster path: pairs of windows, planes on and off", 2, CLUSTER_AB_PAIRS,
     "the loadgen path's"),
    ("http path: timestamped pairs of the JSON import", 1 << 20, TT_PAIRS,
     "the loadgen path's and the batched sum's"),
    ("cluster steps 8-9: clients reading during each resize", 16, ELASTIC_CLIENTS,
     "the mesh path's and the batched sum's"),
    ("loadgen path: the plan's nominal seconds", 40.0, LOADGEN_SECONDS,
     "the mesh path's and the batched sum's"),
)


def serve(kern, sass, card, t_start) -> int:
    """The main path's thirteen paths on the served index, then the
    summary lines."""
    import gc

    import torch

    for what, was, now, why in DEPTH_CUTS:
        if now != was:
            log(f"reduced: {what} {now}, was {was} (for {why} time)")

    holder, setup_s = build_index("cuda")
    ex = kernel_executor(holder)
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        l_pair, e2e = drive("pair_topn", ("row_scan", "masked_row_scan", "gram"),
                            lambda: pair_topn_path(pool, ex, holder))
        l_group, e2e["groupby"] = drive("groupby", ("gram", "cross_gram", "masked_row_scan"),
                                        lambda: groupby_path(pool, ex, holder, "cuda"))
        l_trees, e2e["trees"] = drive("trees", ("tree_count", "tree_words"),
                                      lambda: trees_path(pool, ex, holder, "cuda"))
        decoded = {}
        l_bsi, e2e["bsi"] = drive("bsi", ("bsi_range", "bsi_sum", "bsi_extreme", "bsi_sum_batch"),
                                  lambda: bsi_path(pool, ex, holder, "cuda", decoded))
        l_mesh, e2e["mesh"] = drive("mesh", tuple(sorted(SOURCES)),
                                    lambda: mesh_path(pool, holder, "cuda", decoded))
        e2e["setup_s"] = setup_s
        e2e["stack_rebuilds"] = ex.stack_rebuilds
        e2e["stack_incremental"] = ex.stack_incremental
        e2e["crossgram_cache_hits"] = ex.crossgram_cache_hits
        e2e["bsi_agg_cache_hits"] = ex.bsi_agg_cache_hits
        l_budget, e2e["budget"] = drive(
            "budget", ("bsi_range", "bsi_sum", "bsi_extreme", "masked_row_scan", "gram",
                       "cross_gram"),
            lambda: budget_path(pool, ex, holder, "cuda", decoded["v"]))
        l_storage, (e2e["storage"], hand) = drive(
            "storage", ("gram", "cross_gram", "row_scan", "masked_row_scan", "tree_count",
                        "bsi_range", "bsi_sum"),
            lambda: storage_path(pool, holder, "cuda", decoded["v"]))
        l_time, e2e["time"] = drive(
            "time", ("tree_count", "tree_words", "row_scan", "masked_row_scan", "gram",
                     "cross_gram"),
            lambda: time_path(pool, kernel_executor(holder), holder, "cuda"))
        # the served index's tensors go before the node opens its own copy
        del ex, holder
        gc.collect()
        torch.cuda.empty_cache()
        # (no flight of filtered Sums in the http reads either)
        l_http, e2e["http"] = drive(
            "http", tuple(k for k in sorted(l_pair) if k != "bsi_sum_batch"),
            lambda: http_path(pool, "cuda", hand, decoded["v"]))
        # (the serving mix holds no flight of filtered Sums: bsi_sum_batch is
        # the bsi and mesh paths')
        l_serving, e2e["serving"] = drive(
            "serving", tuple(k for k in sorted(SOURCES) if k != "bsi_sum_batch"),
            lambda: serving_path(pool, "cuda", hand, decoded["v"]))
        l_obs, e2e["obs"] = drive(
            "obs", OBS_KERNELS, lambda: obs_path(pool, "cuda", hand, decoded["v"]))
        l_cluster, e2e["cluster"] = drive(
            "cluster", OBS_KERNELS + ("cross_gram",),
            lambda: cluster_path(pool, "cuda", hand))
        del decoded, hand
        # the earlier paths' directories go before the loadgen path writes its own
        import shutil

        for d in STORAGE_DIRS:
            shutil.rmtree(d, ignore_errors=True)
        STORAGE_DIRS.clear()
        l_loadgen, e2e["loadgen"] = drive(
            "loadgen", LOADGEN_KERNELS, lambda: loadgen_path(pool, "cuda"))
    name, limit = [x.strip() for x in card.split(",", 1)]
    e2e["http"].update(card=name, power_limit=limit)
    e2e["serving"].update(card=name, power_limit=limit)
    e2e["obs"].update(card=name, power_limit=limit)
    e2e["cluster"].update(card=name, power_limit=limit)
    e2e["loadgen"].update(card=name, power_limit=limit)
    e2e["mesh"].update(card=name, power_limit=limit)
    by_path = {k: {"pair_topn": l_pair[k], "groupby": l_group[k], "trees": l_trees[k],
                   "bsi": l_bsi[k], "mesh": l_mesh[k], "budget": l_budget[k], "storage": l_storage[k],
                   "time": l_time[k], "http": l_http[k], "serving": l_serving[k],
                   "obs": l_obs[k], "cluster": l_cluster[k], "loadgen": l_loadgen[k]}
               for k in l_pair}

    entries = []
    for k, (src, replaces) in SOURCES.items():
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
            "card": name,
            "power_limit": limit,
        })
        if k in sass:  # the kernels whose SASS this run reads
            entries[-1]["sass_mma"] = sum(sass[k].values())
        if k in ("gram", "cross_gram"):
            entries[-1].update(
                sass_mma_by_tile=sass[k],
                bound_ops_rate="single-bit MMA, measured in this run",
                mma_macs_per_s=kern["mma_macs_per_s"],
            )
        for key in ("mma_floors", "library_ms_by_q", "bsi_sum_ms_by_q"):  # the batched sum
            if key in v:
                entries[-1][key] = v[key]
        if "tree_route" in v:  # the tree count: the plan's route at each shape
            entries[-1].update(sass_mma_by_instance=sass[k], tree_route=v["tree_route"],
                               **{f"{sh}_tree_route": r for sh, r in v["extra_routes"].items()})
        for shape, (t, d, b, *plain) in v.get("extra", {}).items():
            entries[-1].update({f"{shape}_ms": t, f"{shape}_device_ms": d,
                                f"{shape}_bound_ms": b[0], f"{shape}_bound_by": b[1]})
            if plain:  # the tree count's direct shapes
                entries[-1][f"{shape}_plain_ms"] = plain[0]
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
