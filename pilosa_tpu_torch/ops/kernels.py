"""Batched kernels of the serving path (counterpart of
``pilosa_tpu/ops/kernels.py``).

Four hand-written CUDA kernels (``ops/csrc``) replace the four Pallas
kernels of the JAX package:

* the **row scan** ``out[s, r] = Σ_w popc(bits[s, r, w])`` — row totals
  for tanimoto TopN (:func:`row_counts_per_shard`, :func:`row_counts`);
* the **masked row scan** ``out[s, r] = Σ_w popc(bits[s, r, w] & filt[s, w])``
  — filtered TopN (:func:`masked_row_counts_per_shard`,
  :func:`masked_row_counts`);
* the **self-gram with a fused gather**
  ``G[i, j] = Σ_s Σ_w popc(bits[s, idx[i], w] & bits[s, idx[j], w])`` — a
  whole batch of ``Count(op(Row, Row))`` queries in one launch
  (:func:`gram_gather`, :func:`pair_gram`);
* the **cross gram with two fused gathers**
  ``C[i, j] = Σ_s Σ_w popc(a[s, ia[i], w] & b[s, ib[j], w])`` — every
  combination count of a two-field GroupBy, and one level of the k-level
  GroupBy over its prefix masks (:func:`cross_gram_gather`,
  :func:`cross_pair_gram`, :func:`combo_counts_gram`).

A fifth, ``ops/csrc/tree_eval.cu``, has no Pallas kernel behind it: it
replaces the XLA programs of ``pilosa_tpu/exec/astbatch.py`` that evaluate a
compiled PQL tree over field stacks, as the per-shard counts of a batch of
``Count(tree)`` calls (:func:`tree_count`, on the route and plan
:func:`tree_plan` picks: the batch's distinct rows staged once per shard,
or, item by item, each item's distinct rows staged once per shard and
slice or read through L2) or one tree's words (:func:`tree_words`).

The two grams share one tile loop (``ops/csrc/gram_tile.cuh``) that runs
on the tensor cores as single-bit MMA (AND + popcount of the packed
words); the wrapper picks each launch's plan (:class:`GramPlan`: tile
shape, orientation, copy width, triangular tiles) from the shapes.

Each kernel wrapper checks device, dtype, shape and contiguity. Given a
tensor on the CPU it computes the kernel's plain PyTorch version (the
``*_plain`` function beside it); given a CUDA tensor it launches the
kernel or raises. The plain versions are the contract the kernels are
held to on the card. Every launch goes through :func:`_launching`, the
wrappers' funnel: it counts the launch in ``LAUNCHES`` (under a lock, as
HTTP handler threads launch at once), books it on the kernel's device
ledger site with a CUDA event pair for its device time, and adds a record
to the active query profile.

Stacks are ``int32[S, R, W]``: bit-identical views of the host's
``uint32`` words. Every wrapper that reads a stack also takes a
``parallel/sharded.py`` ``ShardedStack`` (the stack cut over a serving
mesh, the counterpart of JAX's ``shard_map`` path): it launches the same
kernel once per slice and reduces the slices' outputs, counts summed in
int64, per-shard rows or words joined in shard order; on a mesh that
spans processes the int64 totals are then summed across them
(``torch.distributed.all_reduce``), where JAX carries uint32 (hi, lo)
pairs through an int32 psum.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
import time
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from pilosa_tpu_torch.obs import devledger, qprofile
from pilosa_tpu_torch.ops import bitops, cuda_build
from pilosa_tpu_torch.parallel import sharded as _sh

_TORCH_OPS = {
    "intersect": lambda a, b: a & b,
    "union": lambda a, b: a | b,
    "difference": lambda a, b: a & ~b,
    "xor": lambda a, b: a ^ b,
}

# kernel name -> launches so far (one per kernel launch, nowhere else)
LAUNCHES = {
    "row_scan": 0, "masked_row_scan": 0, "gram": 0, "cross_gram": 0,
    "tree_count": 0, "tree_words": 0,
    # ops/bsi.py's kernels
    "bsi_range": 0, "bsi_sum": 0, "bsi_extreme": 0, "bsi_sum_batch": 0,
}


_LAUNCH_LOCK = threading.Lock()
# kernel name -> its device ledger site (launches, device ms, by principal)
_DL_SITES = {name: devledger.site(f"kernels.{name}") for name in LAUNCHES}


def reset_launches() -> None:
    """Zero ``LAUNCHES`` and the kernels' ledger sites together, so the
    ``kernels`` block's launches and device ms count the same launches."""
    with _LAUNCH_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        devledger.ledger().reset_sites(site.name for site in _DL_SITES.values())


def launch_total() -> int:
    """All kernel launches counted in ``LAUNCHES`` so far, read under the
    launch lock: the flight recorder's ``kernelDispatchDelta``. It reads no
    event pair, so it never waits for the card."""
    with _LAUNCH_LOCK:
        return sum(LAUNCHES.values())


def telemetry_snapshot() -> dict:
    """The ``kernels`` block of ``/debug/vars``: per kernel, its launches
    (``LAUNCHES``) and the device milliseconds the ledger read for them
    from their CUDA event pairs."""
    sites = devledger.ledger().site_device_ms()
    with _LAUNCH_LOCK:
        launches = dict(LAUNCHES)
    return {
        name: {
            "launches": n,
            "deviceMs": round(sites.get(f"kernels.{name}", (0, 0.0))[1], 3),
        }
        for name, n in launches.items()
    }


def prometheus_text() -> str:
    """``pilosa_kernel_launches`` and ``pilosa_kernel_device_ms`` per
    kernel, for ``/metrics``."""
    snap = telemetry_snapshot()
    out = []
    for metric, key, help_text in (
        ("kernel_launches", "launches", "hand-written kernel launches"),
        ("kernel_device_ms", "deviceMs", "device milliseconds of kernel launches"),
    ):
        out.append(f"# HELP pilosa_{metric} {help_text}")
        out.append(f"# TYPE pilosa_{metric} counter")
        out.extend(
            f'pilosa_{metric}{{kernel="{name}"}} {row[key]}'
            for name, row in sorted(snap.items())
        )
    return "\n".join(out) + "\n"


# the start event of the launch this thread is about to make (_launching
# sets it, _launch records it right before the C call)
_starts = threading.local()


@contextlib.contextmanager
def _launching(name: str, device: torch.device):
    """Bracket one launch of kernel ``name`` on ``device``: CUDA events
    before and after it on the current stream (read later, by the ledger's
    snapshot), and, once the launch returned, its count in ``LAUNCHES``, its
    ledger booking and its profile record. A launch that raises is not
    counted. The start event is recorded by :func:`_launch` just before the
    C call, so the pair spans the launch and not the library's load before
    it (the first launch of a process builds the kernels there)."""
    stream = torch.cuda.current_stream(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    _starts.pending = (start, stream)
    try:
        yield
    finally:
        _starts.pending = None
    end.record(stream)
    wall = time.perf_counter() - t0
    with _LAUNCH_LOCK:
        LAUNCHES[name] += 1
    # the kernel's name is its launches' sig class: the flight planner
    # prices the device lane of a pair Count by kernels.gram's "gram"
    _DL_SITES[name].record_cuda_launch(start, end, wall, sig=name)
    qprofile.record_kernel(kernel=name, lane="cuda", wall_ms=round(wall * 1e3, 3))


def _check_words(name: str, t, ndim: int) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t).__name__}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 words, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def _is_cpu(name: str, *ts: torch.Tensor) -> bool:
    """True for CPU tensors, False for CUDA tensors on one device; raises
    for mixed devices or any other device type."""
    dev = ts[0].device
    for t in ts[1:]:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    return False


def _launch(fn: str, *args) -> None:
    lib = cuda_build.load()
    call = getattr(lib, fn)
    pending = getattr(_starts, "pending", None)
    if pending is not None:
        _starts.pending = None
        pending[0].record(pending[1])
    cuda_build.check(lib, fn, call(*args))


def _stream(device: torch.device) -> int:
    """The current CUDA stream of a tensor's device as a raw handle (the one
    ``torch.cuda.current_stream(device).cuda_stream`` gives, without making
    a Stream object)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


# ---------------------------------------------------------------------------
# Row scan
# ---------------------------------------------------------------------------


def row_counts_per_shard_plain(bits: torch.Tensor) -> torch.Tensor:
    """Plain version of the row scan: ``int32[S, R]``."""
    return bitops.count_rows(bits)


def row_counts_per_shard(bits: torch.Tensor) -> torch.Tensor:
    """``int32[S, R]`` per-shard row popcounts (exact per shard: a row of
    one shard holds at most 2^31 - 1 bits at every supported width)."""
    if _sh.is_sharded(bits):
        return _sh.cat(bits, _sh.per_slice(bits, row_counts_per_shard), 0)
    _check_words("row_counts_per_shard", bits, 3)
    if _is_cpu("row_counts_per_shard", bits):
        return row_counts_per_shard_plain(bits)
    S, R, W = bits.shape
    out = torch.empty((S, R), dtype=torch.int32, device=bits.device)
    if out.numel() == 0:
        return out
    if W == 0:
        return out.zero_()
    with _launching("row_scan", bits.device):
        _launch(
            "pilosa_row_scan", bits.data_ptr(), out.data_ptr(), S, R, W,
            bits.device.index, _stream(bits.device),
        )
    return out


def _int32_safe(bits: torch.Tensor) -> bool:
    """Cross-shard per-row totals fit int32 when S * shard_bits < 2^31."""
    S, _, W = bits.shape
    return S * W * 32 < 2**31


def row_counts(bits: torch.Tensor) -> torch.Tensor:
    """Per-row popcounts over all shards, on the stack's device:
    ``int32[R]`` when totals fit int32, else ``int64[R]``; ``int64[R]``
    for a sharded stack (on its first slice's device; on a spanning mesh
    summed over the processes)."""
    if _sh.is_sharded(bits):
        return _sh.total(bits, _sh.per_slice(
            bits, lambda t: row_counts_per_shard(t).sum(dim=0, dtype=torch.int64)))
    per_shard = row_counts_per_shard(bits)
    dtype = torch.int32 if _int32_safe(bits) else torch.int64
    return per_shard.sum(dim=0, dtype=dtype)


def row_counts_supported(bits) -> bool:
    """Whether :func:`row_counts` can serve this stack: always. JAX's
    declines a spanning stack whose totals pass int32 even per one-shard
    psum slice; the port sums int64 across processes, so none passes."""
    return True


def stack_spans_processes(x) -> bool:
    """Whether ``x`` is a sharded stack whose mesh includes other
    processes' devices: the guard of the paths whose kernels return
    per-shard outputs (the bitmap trees and the k-level GroupBy's combos),
    which decline such a stack as in JAX."""
    return _sh.is_sharded(x) and x.spans


def topn_counts(bits, n: int):
    """``(counts, slots)`` int64 numpy: the ``n`` largest row totals of
    the stack (:func:`row_counts`), ties to the lower slot, as JAX's
    ``lax.top_k`` orders them."""
    counts = row_counts(bits).to(torch.int64).cpu().numpy()
    n = min(n, counts.shape[0])
    slots = np.argsort(-counts, kind="stable")[:n]
    return counts[slots], slots


# ---------------------------------------------------------------------------
# Masked row scan
# ---------------------------------------------------------------------------


def masked_row_counts_per_shard_plain(
    bits: torch.Tensor, filt: torch.Tensor
) -> torch.Tensor:
    """Plain version of the masked row scan: ``int32[S, R]``."""
    return bitops.count_rows(bits & filt[:, None, :])


def masked_row_counts_per_shard(
    bits: torch.Tensor, filt: torch.Tensor
) -> torch.Tensor:
    """``int32[S, R]`` per-shard popcounts of every row ANDed with the
    shard's filter row ``filt[s]`` (``int32[S, W]``)."""
    if _sh.is_sharded(bits):
        return _sh.cat(bits, _sh.per_slice(bits, masked_row_counts_per_shard, filt), 0)
    _check_words("masked_row_counts_per_shard", bits, 3)
    _check_words("masked_row_counts_per_shard", filt, 2)
    S, R, W = bits.shape
    if tuple(filt.shape) != (S, W):
        raise ValueError(
            f"masked_row_counts_per_shard: filter shape {tuple(filt.shape)} "
            f"!= {(S, W)}"
        )
    if _is_cpu("masked_row_counts_per_shard", bits, filt):
        return masked_row_counts_per_shard_plain(bits, filt)
    out = torch.empty((S, R), dtype=torch.int32, device=bits.device)
    if out.numel() == 0:
        return out
    if W == 0:
        return out.zero_()
    with _launching("masked_row_scan", bits.device):
        _launch(
            "pilosa_masked_row_scan", bits.data_ptr(), filt.data_ptr(),
            out.data_ptr(), S, R, W, bits.device.index, _stream(bits.device),
        )
    return out


def masked_row_counts(bits: torch.Tensor, filt: torch.Tensor) -> np.ndarray:
    """``int64[R]`` numpy: per-row popcount of (row & filter) summed over
    shards in int64 (and over the processes of a spanning mesh)."""
    if _sh.is_sharded(bits):
        return _sh.total(bits, _sh.per_slice(
            bits, lambda t, f: masked_row_counts_per_shard(t, f).sum(dim=0, dtype=torch.int64),
            filt,
        )).cpu().numpy()
    per_shard = masked_row_counts_per_shard(bits, filt)
    return per_shard.sum(dim=0, dtype=torch.int64).cpu().numpy()


# ---------------------------------------------------------------------------
# Self-gram with a fused gather
# ---------------------------------------------------------------------------

# Past this many distinct rows the gram itself gets big (U^2) and its
# O(U^2) work outgrows the O(B) scan — callers use pair_count_batched.
GRAM_MAX_ROWS = 4096

# Largest pair total an int32 gram accumulator may reach (tests shrink it
# to exercise the chunked path on small shapes).
_GRAM_ACC_LIMIT = 2**31 - 1

# bytes of float64 0/1 operands the plain gram unpacks per step
_PLAIN_GRAM_UNPACK_BYTES = 256 << 20

_SHIFTS32 = torch.arange(32, dtype=torch.int32)


def _gram_int32_safe(s: int, w: int) -> bool:
    """A pair's total fits int32 while S * W * 32 <= the limit."""
    return s * w * 32 <= _GRAM_ACC_LIMIT


def unpack_bits(words: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``int32[..., W]`` -> ``dtype[..., W*32]`` 0/1, little-endian bit
    order (bit b of word w is column 32*w + b)."""
    shifts = _SHIFTS32.to(words.device)
    bits = (words.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(*words.shape[:-1], words.shape[-1] * 32).to(dtype)


def _idx_array(idx, R: int, name: str = "gram_gather") -> np.ndarray:
    arr = np.asarray(idx, dtype=np.int64).reshape(-1)
    if arr.size and (arr.min() < 0 or arr.max() >= R):
        raise ValueError(f"{name}: row index out of range [0, {R})")
    return arr.astype(np.int32)


# ---------------------------------------------------------------------------
# Launch plans of the two grams (ops/csrc/gram_tile.cuh: single-bit MMA
# tiles of TM x TN outputs, fed by cp.async copies of 16 or 4 bytes)
# ---------------------------------------------------------------------------

# N sides of a tile; the M side is 64 rows, or 128 or 256 beside N = 64
_TILE_N = (8, 16, 32, 64)
_CROSS_TILES = ((64, 8), (64, 16), (64, 32), (64, 64), (128, 64), (256, 64))


class GramPlan(NamedTuple):
    """How one gram launch runs: which operand is the MMA's M side (swap:
    the second), the copy width (16-byte copies, else 4-byte), triangular
    self-gram tiles mirrored in the epilogue, and the tile shape."""

    swap: bool
    vec16: bool
    tri: bool
    tile_m: int
    tile_n: int


def _tile_n(n: int) -> int:
    """The narrowest N side that holds ``n`` rows (64 past that)."""
    return next((t for t in _TILE_N if t >= n), _TILE_N[-1])


def _copies16(w: int, *operands: torch.Tensor) -> bool:
    """16-byte copies read whole aligned chunks of every row at every
    shard: each operand's base 16-byte aligned, its shard and row strides
    and W multiples of 4 words."""
    return w % 4 == 0 and all(
        t.data_ptr() % 16 == 0 and t.stride(0) % 4 == 0 and t.stride(1) % 4 == 0
        for t in operands
    )


def gram_plan(u: int, w: int, vec16: bool) -> GramPlan:
    """The self-gram's plan: up to 64 rows are one 64 x tile_n tile whose
    N rows are its first M rows (staged once); more are the upper-triangle
    64 x 64 tiles, each off-diagonal one mirrored."""
    if u <= 64:
        return GramPlan(False, vec16, False, 64, _tile_n(u))
    return GramPlan(False, vec16, True, 64, 64)


def cross_gram_plan(ua: int, ub: int, vec16: bool) -> GramPlan:
    """The cross gram's plan: the larger side on the MMA's M, the smaller
    on N in the narrowest tile that holds it; with N = 64, an M side of up
    to 256 rows in one tile, so each operand's k-slab is read once."""
    m, n = max(ua, ub), min(ua, ub)
    tn = _tile_n(n)
    tm = 64 if tn < 64 or m <= 64 else 128 if m <= 128 else 256
    return GramPlan(ub > ua, vec16, False, tm, tn)


def _check_plan(plan: GramPlan, ua: int, ub: int, w: int, *, self_gram=False) -> None:
    """Raise ``ValueError`` for a plan the C entry refuses."""
    ok = (plan.tile_m, plan.tile_n) in _CROSS_TILES and not (plan.vec16 and w % 4)
    if self_gram:
        ok = ok and plan.tile_m == 64 and not plan.swap and ua == ub and (
            plan.tile_n == 64 if plan.tri else ua <= plan.tile_n
        )
    else:
        ok = ok and not plan.tri
    if not ok:
        raise ValueError(f"gram plan {plan} cannot run at {ua} x {ub} rows, W = {w}")


def gram_gather_plain(bits: torch.Tensor, idx) -> torch.Tensor:
    """Plain version of the gram: ``int32[U, U]``, the cross gram of the
    stack with itself."""
    return cross_gram_gather_plain(bits, bits, idx, idx)


def gram_gather(bits: torch.Tensor, idx) -> torch.Tensor:
    """``int32[U, U]`` gram over the stack rows named by ``idx`` (host
    ints in ``[0, R)``), read in place: no gathered copy is made. The
    caller keeps each pair's total within int32 (:func:`pair_gram`).
    A sharded stack's slices are summed on its first slice's device."""
    if not _sh.is_sharded(bits):
        _check_words("gram_gather", bits, 3)
    S, R, W = bits.shape
    if not _gram_int32_safe(S, W):
        raise ValueError(
            f"gram_gather: S*W*32 = {S * W * 32} exceeds the int32 "
            "accumulator; chunk the shard axis (pair_gram does)"
        )
    if _sh.is_sharded(bits):
        return _sh.total(bits, _sh.per_slice(bits, lambda t: gram_gather(t, idx))).to(torch.int32)
    if _is_cpu("gram_gather", bits):
        return gram_gather_plain(bits, idx)
    host_idx = _idx_array(idx, R)
    U = host_idx.size
    out = torch.zeros((U, U), dtype=torch.int32, device=bits.device)
    if U == 0 or S == 0 or W == 0:
        return out
    plan = gram_plan(U, W, _copies16(W, bits))
    _check_plan(plan, U, U, W, self_gram=True)
    dev_idx = torch.from_numpy(host_idx).to(bits.device)
    with _launching("gram", bits.device):
        _launch(
            "pilosa_gram_gather", bits.data_ptr(), dev_idx.data_ptr(),
            out.data_ptr(), S, R, W, U, bits.device.index, _stream(bits.device),
            int(plan.vec16), int(plan.tri), plan.tile_n,
        )
    return out


def pair_gram(bits: torch.Tensor, row_idx) -> np.ndarray | None:
    """``int64 numpy [U, U]`` intersection counts between every pair of
    the rows named by ``row_idx``, summed over all shards — the one-launch
    answer to a batch of pair-count queries. None when ``row_idx`` is too
    wide for the gram path (> GRAM_MAX_ROWS). Shard chunks keep each
    launch's totals int32-exact; chunks are summed in int64."""
    U = len(row_idx)
    if U == 0 or U > GRAM_MAX_ROWS:
        return None
    idx = np.asarray(row_idx, dtype=np.int32)
    if _sh.is_sharded(bits):  # the chunking within each slice
        return _sh.total_host(bits, _sh.per_slice(
            bits, lambda t: _shard_chunked(t.shape, lambda s: gram_gather(t[s], idx))))
    return _shard_chunked(bits.shape, lambda s: gram_gather(bits[s], idx))


def _shard_chunked(shape, launch) -> np.ndarray:
    """``int64 numpy`` sum of ``launch(shard_slice)`` over the shard axis
    of a ``[S, R, W]`` stack, in chunks small enough that each launch's
    int32 totals are exact (one launch when the whole axis is)."""
    S, _, W = shape
    if _gram_int32_safe(S, W):
        return launch(slice(None)).cpu().numpy().astype(np.int64)
    chunk = max(1, _GRAM_ACC_LIMIT // (W * 32))
    total = launch(slice(0, chunk)).cpu().numpy().astype(np.int64)
    for c0 in range(chunk, S, chunk):
        total += launch(slice(c0, c0 + chunk)).cpu().numpy()
    return total


def pair_counts_from_gram(
    gram: np.ndarray, pa: np.ndarray, pb: np.ndarray, op: str
) -> np.ndarray:
    """Evaluate a batch of pair-op counts from gram entries.  ``pa/pb``
    index into the gram's row-subset coordinates."""
    g = gram[pa, pb]
    if op == "intersect":
        return g
    da = gram[pa, pa]
    if op == "difference":
        return da - g
    db = gram[pb, pb]
    if op == "union":
        return da + db - g
    if op == "xor":
        return da + db - 2 * g
    raise ValueError(f"unknown pair op: {op}")


# ---------------------------------------------------------------------------
# Batched pair count (plain torch ops; the JAX package runs it in XLA)
# ---------------------------------------------------------------------------

# bytes of gathered [S, b, W] operands per step
_PAIR_BATCH_BYTES = 256 << 20


def pair_count_batched(
    bits: torch.Tensor, ras, rbs, *, op: str = "intersect"
) -> torch.Tensor:
    """``int32[B, S]`` per-shard partials of ``popc(op(row ras[i], row
    rbs[i]))`` — the answer when a batch names more than GRAM_MAX_ROWS
    distinct rows. Callers sum over shards in int64. On a spanning mesh
    the answer is the ``int64[B]`` totals, summed over the processes."""
    return pair_count_two_batched(bits, bits, ras, rbs, op=op)


def pair_count_two_batched(
    bits_a: torch.Tensor, bits_b: torch.Tensor, ras, rbs, *,
    op: str = "intersect",
) -> torch.Tensor:
    """``int32[B, S]`` per-shard partials of ``popc(op(bits_a row ras[i],
    bits_b row rbs[i]))`` over two stacks of one shard axis — the
    two-field GroupBy's answer when the cross gram declines. Sharded
    stacks give the slices' partials joined in shard order, or ``int64[B]``
    totals on a spanning mesh, as :func:`pair_count_batched`."""
    _sh.same_layout("pair_count_two_batched", bits_a, bits_b)
    if _sh.is_sharded(bits_a):
        def one(a, b):
            return pair_count_two_batched(a, b, ras, rbs, op=op)

        if bits_a.spans:
            return _sh.total(bits_a, _sh.per_slice(
                bits_a, lambda a, b: one(a, b).sum(dim=1, dtype=torch.int64), bits_b))
        return _sh.cat(bits_a, _sh.per_slice(bits_a, one, bits_b), 1)
    _check_words("pair_count_two_batched", bits_a, 3)
    _check_words("pair_count_two_batched", bits_b, 3)
    _is_cpu("pair_count_two_batched", bits_a, bits_b)  # raises on mixed devices
    fn = _TORCH_OPS.get(op)
    if fn is None:
        raise ValueError(f"unknown pair op: {op}")
    S, _, W = bits_a.shape
    ra = torch.as_tensor(np.asarray(ras, np.int64)).to(bits_a.device)
    rb = torch.as_tensor(np.asarray(rbs, np.int64)).to(bits_a.device)
    B = ra.numel()
    out = torch.empty((B, S), dtype=torch.int32, device=bits_a.device)
    step = max(1, _PAIR_BATCH_BYTES // max(1, 2 * S * W * 4))
    for b0 in range(0, B, step):
        b1 = min(B, b0 + step)
        words = fn(bits_a[:, ra[b0:b1]], bits_b[:, rb[b0:b1]])  # [S, b, W]
        out[b0:b1] = bitops.count_rows(words).T
    return out


# ---------------------------------------------------------------------------
# Cross gram with two fused gathers
# ---------------------------------------------------------------------------


def _check_operand(name: str, t) -> None:
    """A cross-gram operand: ``int32[S, R, W]`` whose W words per row are
    contiguous. Its shard and row strides are free, so a contiguous stack
    and the ``transpose(0, 1)`` view of a contiguous ``[C, S, W]`` prefix
    are both read in place."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t).__name__}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 words, got {t.dtype}")
    if t.dim() != 3:
        raise ValueError(f"{name}: expected 3 dims, got shape {tuple(t.shape)}")
    if t.shape[2] > 1 and t.stride(2) != 1:
        raise ValueError(f"{name}: the words of a row must be contiguous")


def cross_gram_gather_plain(
    bits_a: torch.Tensor, bits_b: torch.Tensor, ia, ib
) -> torch.Tensor:
    """Plain version of the cross gram: ``int32[Ua, Ub]``. Unpacks word
    blocks of the gathered rows to 0/1 float64 and multiplies; float64
    sums are exact below 2^53, far above the int32 totals the caller
    allows."""
    S, Ra, W = bits_a.shape
    Rb = bits_b.shape[1]
    dev = bits_a.device
    sa = torch.from_numpy(_idx_array(ia, Ra, "cross_gram").astype(np.int64)).to(dev)
    sb = torch.from_numpy(_idx_array(ib, Rb, "cross_gram").astype(np.int64)).to(dev)
    Ua, Ub = sa.numel(), sb.numel()
    acc = torch.zeros((Ua, Ub), dtype=torch.float64, device=dev)
    if Ua == 0 or Ub == 0 or S == 0 or W == 0:
        return acc.to(torch.int32)
    # the gram (one operand, one subset) unpacks its rows once
    same = bits_a is bits_b and torch.equal(sa, sb)
    wb = max(1, min(W, _PLAIN_GRAM_UNPACK_BYTES // (max(Ua, Ub) * 32 * 8)))
    for s in range(S):
        rows_a = bits_a[s].index_select(0, sa)
        rows_b = rows_a if same else bits_b[s].index_select(0, sb)
        for w0 in range(0, W, wb):
            xa = unpack_bits(rows_a[:, w0 : w0 + wb], torch.float64)
            xb = xa if same else unpack_bits(rows_b[:, w0 : w0 + wb], torch.float64)
            acc += xa @ xb.T
    return acc.to(torch.int32)


def cross_gram_gather(
    bits_a: torch.Tensor, bits_b: torch.Tensor, ia, ib
) -> torch.Tensor:
    """``int32[Ua, Ub]`` cross gram between the rows ``ia`` of ``bits_a``
    and the rows ``ib`` of ``bits_b`` (host ints), over one shard axis
    and one word width. Both operands are read in place through their
    strides (see :func:`_check_operand`): no gathered or transposed copy
    is made. The caller keeps each total within int32. Sharded operands
    (of one layout) are summed over their slices on the first slice's
    device."""
    _sh.same_layout("cross_gram_gather", bits_a, bits_b)
    if _sh.is_sharded(bits_a):
        S, _, W = bits_a.shape
        if not _gram_int32_safe(S, W):
            raise ValueError(
                f"cross_gram_gather: S*W*32 = {S * W * 32} exceeds the int32 accumulator"
            )
        return _sh.total(bits_a, _sh.per_slice(
            bits_a, lambda a, b: cross_gram_gather(a, b, ia, ib), bits_b)).to(torch.int32)
    _check_operand("cross_gram_gather", bits_a)
    _check_operand("cross_gram_gather", bits_b)
    S, Ra, W = bits_a.shape
    if (bits_b.shape[0], bits_b.shape[2]) != (S, W):
        raise ValueError(
            f"cross_gram_gather: operand shapes {tuple(bits_a.shape)} and "
            f"{tuple(bits_b.shape)} differ in shards or words"
        )
    if not _gram_int32_safe(S, W):
        raise ValueError(
            f"cross_gram_gather: S*W*32 = {S * W * 32} exceeds the int32 "
            "accumulator; chunk the shard axis (cross_pair_gram does)"
        )
    if _is_cpu("cross_gram_gather", bits_a, bits_b):
        return cross_gram_gather_plain(bits_a, bits_b, ia, ib)
    host_a = _idx_array(ia, Ra, "cross_gram")
    host_b = _idx_array(ib, bits_b.shape[1], "cross_gram")
    Ua, Ub = host_a.size, host_b.size
    dev = bits_a.device
    out = torch.zeros((Ua, Ub), dtype=torch.int32, device=dev)
    if Ua == 0 or Ub == 0 or S == 0 or W == 0:
        return out
    plan = cross_gram_plan(Ua, Ub, _copies16(W, bits_a, bits_b))
    _check_plan(plan, Ua, Ub, W)
    dev_a = torch.from_numpy(host_a).to(dev)
    dev_b = torch.from_numpy(host_b).to(dev)
    with _launching("cross_gram", dev):
        _launch(
            "pilosa_cross_gram_gather",
            bits_a.data_ptr(), bits_a.stride(0), bits_a.stride(1),
            dev_a.data_ptr(), Ua,
            bits_b.data_ptr(), bits_b.stride(0), bits_b.stride(1),
            dev_b.data_ptr(), Ub,
            out.data_ptr(), S, W, dev.index, _stream(dev),
            int(plan.swap), int(plan.vec16), plan.tile_m, plan.tile_n,
        )
    return out


def cross_pair_gram(
    bits_a: torch.Tensor, bits_b: torch.Tensor, idx_a, idx_b
) -> np.ndarray | None:
    """``int64 numpy [Ua, Ub]`` cross-field intersection counts between
    the named row subsets, summed over all shards; None when a subset is
    too wide (> GRAM_MAX_ROWS; callers use the batched scans). Shard
    chunks keep each launch's totals int32-exact; chunks are summed in
    int64."""
    Ua, Ub = len(idx_a), len(idx_b)
    if Ua == 0 or Ub == 0 or max(Ua, Ub) > GRAM_MAX_ROWS:
        return None
    ia = np.asarray(idx_a, dtype=np.int32)
    ib = np.asarray(idx_b, dtype=np.int32)
    _sh.same_layout("cross_pair_gram", bits_a, bits_b)
    if _sh.is_sharded(bits_a):
        return _sh.total_host(bits_a, _sh.per_slice(
            bits_a,
            lambda a, b: _shard_chunked(a.shape, lambda s: cross_gram_gather(a[s], b[s], ia, ib)),
            bits_b,
        ))
    return _shard_chunked(
        bits_a.shape, lambda s: cross_gram_gather(bits_a[s], bits_b[s], ia, ib)
    )


# ---------------------------------------------------------------------------
# GroupBy combination counts over running prefix masks (reference
# executor.go:3057-3230 runs one intersectionCount per combination; here
# one launch per level)
# ---------------------------------------------------------------------------


def _prefix_sharded(prefix, bits) -> bool:
    """Whether a GroupBy level runs over sharded operands (the prefix
    masks a ``[C, S, W]`` sharded stack, shard axis 1), which a spanning
    mesh declines: the combos are per-shard outputs."""
    if not _sh.is_sharded(bits):
        if _sh.is_sharded(prefix):
            raise ValueError("GroupBy prefix: sharded masks over a whole stack")
        return False
    if stack_spans_processes(bits):
        raise ValueError("GroupBy combos over a process-spanning stack are declined")
    if prefix is not None and (not _sh.is_sharded(prefix) or prefix.bounds != bits.bounds):
        raise ValueError("GroupBy prefix: masks and stack of different layouts")
    return True


def gather_prefix(bits: torch.Tensor, idx) -> torch.Tensor:
    """Level-0 prefix masks: the stack rows ``idx`` as ``int32[C, S, W]``
    (a sharded stack's as sharded masks, shard axis 1)."""
    if _prefix_sharded(None, bits):
        return _sh.ShardedStack(
            _sh.per_slice(bits, lambda t: gather_prefix(t, idx)), bits.bounds,
            (len(idx), bits.shape[0], bits.shape[2]), bits.mesh, axis=1,
        )
    sel = torch.as_tensor(np.asarray(idx, np.int64)).to(bits.device)
    return bits.index_select(1, sel).transpose(0, 1).contiguous()


def refine_prefix(prefix: torch.Tensor, bits: torch.Tensor, cis, ris) -> torch.Tensor:
    """Next level's surviving prefix masks
    ``prefix[cis[i]] & bits[:, ris[i]]`` as ``int32[C', S, W]``, built in
    steps of _PAIR_BATCH_BYTES so the gathered operands never exceed one
    step beside the output."""
    if _prefix_sharded(prefix, bits):
        parts = _sh.per_slice(bits, lambda t, p: refine_prefix(p, t, cis, ris), prefix)
        return _sh.ShardedStack(parts, bits.bounds, (len(cis),) + tuple(prefix.shape[1:]),
                                bits.mesh, axis=1)
    ci = torch.as_tensor(np.asarray(cis, np.int64)).to(prefix.device)
    ri = torch.as_tensor(np.asarray(ris, np.int64)).to(prefix.device)
    _, S, W = prefix.shape
    n = ci.numel()
    out = torch.empty((n, S, W), dtype=prefix.dtype, device=prefix.device)
    step = max(1, _PAIR_BATCH_BYTES // max(1, 2 * S * W * 4))
    for c0 in range(0, n, step):
        c1 = min(n, c0 + step)
        torch.bitwise_and(
            prefix.index_select(0, ci[c0:c1]),
            bits.index_select(1, ri[c0:c1]).transpose(0, 1),
            out=out[c0:c1],
        )
    return out


def mask_prefix(prefix, filt) -> None:
    """``prefix &= filt`` in place over every combo (``filt`` ``[S, W]``,
    cut at a sharded prefix's bounds)."""
    if _sh.is_sharded(prefix):
        for p, f in zip(prefix.slices, _sh.split(prefix, filt)):
            p &= f[None]
    else:
        prefix &= filt[None]


def combo_counts(prefix: torch.Tensor, bits: torch.Tensor, idx) -> torch.Tensor:
    """``int32[C, Rl, S]`` per-shard counts of every (prefix combo, row)
    intersection ``popc(prefix[c] & bits[:, idx[r]])``, one row of the
    level at a time, so peak memory is one ``[C, S, W]`` intermediate."""
    if _prefix_sharded(prefix, bits):
        return _sh.cat(bits, _sh.per_slice(bits, lambda t, p: combo_counts(p, t, idx), prefix), 2)
    sel = np.asarray(idx, np.int64).reshape(-1)
    C, S, _ = prefix.shape
    out = torch.empty((C, sel.size, S), dtype=torch.int32, device=prefix.device)
    for k, r in enumerate(sel.tolist()):
        out[:, k] = bitops.count_rows(prefix & bits[:, r][None])
    return out


def combo_counts_gram(prefix: torch.Tensor, bits: torch.Tensor, idx) -> np.ndarray | None:
    """``int64 numpy [C, Rl]`` totals of every (prefix combo, row)
    intersection as ONE cross-gram launch, the prefix read in place in its
    ``[C, S, W]`` layout. None when a total could wrap int32, the level is
    too small (C * Rl < 32) or either side is wider than GRAM_MAX_ROWS;
    callers then use :func:`combo_counts`."""
    C = prefix.shape[0]
    S, _, W = bits.shape
    n = len(idx)
    if not _gram_int32_safe(S, W) or C * n < 32:
        return None
    if max(C, n) > GRAM_MAX_ROWS:
        return None
    if _prefix_sharded(prefix, bits):
        return _sh.total_host(bits, _sh.per_slice(bits, lambda t, p: cross_gram_gather(
            p.transpose(0, 1), t, np.arange(C), idx).cpu().numpy(), prefix))
    out = cross_gram_gather(prefix.transpose(0, 1), bits, np.arange(C), idx)
    return out.cpu().numpy().astype(np.int64)


# ---------------------------------------------------------------------------
# Tree evaluation: the compiled PQL trees of exec/astbatch.py
# (ops/csrc/tree_eval.cu)
# ---------------------------------------------------------------------------

# Operand-stack entries the tree kernel holds per word (tree_eval.cu holds
# the same number). exec/astbatch.program orders a tree so that it needs at
# most floor(log2(leaves)) + 1 entries, so every tree whose slots fit int32
# fits; the wrappers raise on a deeper program.
TREE_MAX_DEPTH = 32

# Postfix opcodes: a value >= 0 pushes that leaf; these pop two operands
# (a below b) and push the fold.
TREE_AND, TREE_OR, TREE_XOR, TREE_ANDNOT, TREE_NOTAND = -1, -2, -3, -4, -5
_TREE_FOLDS = {
    TREE_AND: lambda a, b: a & b,
    TREE_OR: lambda a, b: a | b,
    TREE_XOR: lambda a, b: a ^ b,
    TREE_ANDNOT: lambda a, b: a & ~b,
    TREE_NOTAND: lambda a, b: ~a & b,
}

# bytes of [S, b, W] operands the plain tree evaluation holds per step
_PLAIN_TREE_BYTES = 256 << 20

# The staged route of the tree count (tree_eval.cu, pilosa_tree_count_staged;
# these numbers match its defines): words of a row per shared-memory stage
# (one warp step, 32 lanes x 16 bytes), items per single-bit MMA accumulator,
# and the most leaves and operand-stack entries (with a leaf followed by a
# fold applied to the top) it takes.
TREE_CHUNK_WORDS = 128
TREE_GROUP = 8
TREE_STAGED_MAX_LEAVES = 64
TREE_STAGED_MAX_DEPTH = 2
TREE_STAGED_WARPS = 16
# Steps of a flat chain the staged route runs on an instance of its own:
# a push, then leaf folds of one fold (AND, OR, XOR or ANDNOT).
TREE_FLAT_STEPS = 4
# Step kinds of a program on the staged route: push a leaf, fold a leaf into
# the top, fold the top into the entry below. A step is kind | fold << 2 |
# leaf << 5, with fold = -opcode - 1.
TREE_PUSH, TREE_LEAF_FOLD, TREE_POP_FOLD = 0, 1, 2
# A staged slot's flag: every item of its group of TREE_GROUP names that row.
TREE_UNIFORM = 1 << 30
# Items of one tile, and the bytes of shared memory a tile's slots and
# accumulators may take.
_TREE_ITEM_TILE = 1024
_TREE_SLOT_BYTES = 48 << 10
# Dynamic shared memory one block may have on sm_90 (tests shrink it to cut
# batches into several tiles).
_TREE_SMEM_LIMIT = 232448
# Chunks of a block's slice of a shard's words: the W split is the shard's
# chunks over this. chip_smoke.py times the trees path's four shapes at
# slices of 4-64 chunks; 32 was the fastest for three of them on an H100.
TREE_SLICE_CHUNKS = 32
# The direct route (tree_eval.cu, pilosa_tree_count; these numbers match its
# defines): the most lanes of a rows-instance block (16 bytes of each row a
# lane per stage) and stages of its ring, and the words of a block's slice
# of a shard (chip_smoke.py times the direct shapes at slices of 1024-16384
# words, and at each block shape).
TREE_ROWS_LANES = 64
TREE_ROWS_MAX_STAGES = 4
TREE_DIRECT_SLICE_WORDS = 4096
# What one SM of an H100 holds: threads and blocks.
_SM_THREADS, _SM_BLOCKS = 2048, 32


def tree_depth(code, n_leaves: int) -> int:
    """The operand-stack depth of a postfix program; ``ValueError`` when
    the program is malformed (a leaf outside ``[0, n_leaves)``, an unknown
    opcode, a fold with fewer than two operands, or not exactly one result)."""
    top = depth = 0
    for op in np.asarray(code).tolist():
        if op >= 0:
            if op >= n_leaves:
                raise ValueError(f"tree program: leaf {op} of {n_leaves}")
            top += 1
            depth = max(depth, top)
        elif op in _TREE_FOLDS:
            if top < 2:
                raise ValueError("tree program: a fold with fewer than two operands")
            top -= 1
        else:
            raise ValueError(f"tree program: unknown opcode {op}")
    if top != 1:
        raise ValueError(f"tree program leaves {top} results, not one")
    return depth


def tree_steps(code) -> tuple[np.ndarray, int]:
    """``(steps, depth)``: a valid postfix program as the staged route runs
    it, a leaf followed by a fold folded into the top of the operand stack
    (as the direct route does), and the entries that evaluation needs."""
    ops = np.asarray(code).tolist()
    steps: list[int] = []
    n = depth = k = 0
    while k < len(ops):
        op = ops[k]
        nxt = ops[k + 1] if k + 1 < len(ops) else 0
        if op >= 0 and n > 0 and nxt < 0:
            steps.append(TREE_LEAF_FOLD | (-nxt - 1) << 2 | op << 5)
            k += 2
            continue
        if op >= 0:
            steps.append(TREE_PUSH | op << 5)
            n += 1
        else:
            steps.append(TREE_POP_FOLD | (-op - 1) << 2)
            n -= 1
        depth = max(depth, n)
        k += 1
    return np.array(steps, dtype=np.int32), depth


class TreeProgram(NamedTuple):
    """A checked program: its operand-stack depth, its steps and the
    entries they need, the fold of a flat chain of at most TREE_FLAT_STEPS
    steps and of one of any length (-1: not one), and the least and
    greatest stack its leaves name."""

    depth: int
    steps: np.ndarray
    staged_depth: int
    flat: int
    chain: int
    stack_range: tuple


def tree_flat(steps: np.ndarray, max_steps: int | None = TREE_FLAT_STEPS) -> int:
    """The fold (0-3: AND, OR, XOR, ANDNOT) of a flat chain of at most
    ``max_steps`` steps (None: any number), a push then leaf folds of that
    one fold; -1 for any other program."""
    kinds, folds = steps & 3, (steps >> 2) & 7
    if (max_steps is not None and steps.size > max_steps) or kinds[0] != TREE_PUSH:
        return -1
    if steps.size == 1:
        return 0
    if (kinds[1:] != TREE_LEAF_FOLD).any() or (folds[1:] != folds[1]).any() or folds[1] > 3:
        return -1
    return int(folds[1])


@lru_cache(maxsize=1024)
def _tree_program(code: bytes, leaf_stack: bytes) -> TreeProgram:
    ops = np.frombuffer(code, dtype=np.int64)
    leaves = np.frombuffer(leaf_stack, dtype=np.int64)
    depth = tree_depth(ops, leaves.size)
    steps, staged_depth = tree_steps(ops)
    steps.flags.writeable = False
    return TreeProgram(depth, steps, staged_depth, tree_flat(steps), tree_flat(steps, None),
                       (int(leaves.min()), int(leaves.max())))


def _check_tree(name: str, stacks, code, leaf_stack, slots, slot_dims: int):
    """Checked ``(stacks, code, leaf_stack, slots, program)``: ``stacks`` a
    non-empty sequence of contiguous ``int32[S, R_p, W]`` tensors of one S
    and W on one device; ``code`` a postfix program within the kernel's
    operand-stack depth; ``leaf_stack`` int ``[L]`` in ``[0, P)``;
    ``slots`` host int32 ``[B, L]`` (``[L]`` when ``slot_dims`` is 1) below
    each leaf's row count (negative: an absent row). The program's checks
    are cached on its bytes."""
    stacks = tuple(stacks)
    if not stacks:
        raise ValueError(f"{name}: no stacks")
    for t in stacks:
        _check_words(name, t, 3)
    S, _, W = stacks[0].shape
    for t in stacks[1:]:
        if (t.shape[0], t.shape[2]) != (S, W):
            raise ValueError(
                f"{name}: stack shapes {tuple(stacks[0].shape)} and "
                f"{tuple(t.shape)} differ in shards or words"
            )
    if W * 32 >= 2**31:
        raise ValueError(f"{name}: a shard of {W} words could overflow int32 counts")
    code = np.asarray(code, dtype=np.int64).reshape(-1)
    leaf_stack = np.asarray(leaf_stack, dtype=np.int64).reshape(-1)
    L = leaf_stack.size
    if L == 0:
        raise ValueError(f"{name}: a program with no leaves")
    prog = _tree_program(code.tobytes(), leaf_stack.tobytes())
    if prog.depth > TREE_MAX_DEPTH:
        raise ValueError(
            f"{name}: the program needs {prog.depth} stack entries (limit {TREE_MAX_DEPTH})"
        )
    if prog.stack_range[0] < 0 or prog.stack_range[1] >= len(stacks):
        raise ValueError(f"{name}: leaf stack index out of range [0, {len(stacks)})")
    slots = np.asarray(slots)
    if slots.dtype != np.int32:
        raise TypeError(f"{name}: expected int32 slots, got {slots.dtype}")
    if slots.ndim != slot_dims or slots.shape[-1] != L:
        raise ValueError(f"{name}: slots of shape {slots.shape} for {L} leaves")
    rows = np.array([t.shape[1] for t in stacks], dtype=np.int64)[leaf_stack]
    if slots.size and (slots >= rows).any():
        raise ValueError(f"{name}: a slot past its stack's rows")
    return stacks, code, leaf_stack, np.ascontiguousarray(slots), prog


def _tree_leaf_plain(bits: torch.Tensor, col: np.ndarray) -> torch.Tensor:
    """``int32[S, b, W]``: rows ``col`` of ``bits``, zeros where a slot is
    negative."""
    S, R, W = bits.shape
    absent = col < 0
    if R == 0:
        return torch.zeros((S, col.size, W), dtype=torch.int32, device=bits.device)
    idx = torch.from_numpy(np.where(absent, 0, col).astype(np.int64)).to(bits.device)
    rows = bits.index_select(1, idx)
    if absent.any():
        rows[:, torch.from_numpy(absent).to(bits.device)] = 0
    return rows


def _tree_eval_plain(stacks, code, leaf_stack, slots: np.ndarray) -> torch.Tensor:
    """The program's words ``int32[S, b, W]`` for the slot rows ``slots``
    (``[b, L]``), with torch ops."""
    st: list[torch.Tensor] = []
    for op in code.tolist():
        if op >= 0:
            st.append(_tree_leaf_plain(stacks[int(leaf_stack[op])], slots[:, op]))
        else:
            b = st.pop()
            st.append(_TREE_FOLDS[op](st.pop(), b))
    return st[0]


def tree_count_plain(stacks, code, leaf_stack, slots) -> torch.Tensor:
    """Plain version of the tree count: ``int32[B, S]``, items evaluated in
    steps of _PLAIN_TREE_BYTES."""
    stacks, code, leaf_stack, slots, prog = _check_tree(
        "tree_count_plain", stacks, code, leaf_stack, slots, 2
    )
    S, _, W = stacks[0].shape
    B = slots.shape[0]
    out = torch.zeros((B, S), dtype=torch.int32, device=stacks[0].device)
    step = max(1, _PLAIN_TREE_BYTES // max(1, (prog.depth + 2) * S * W * 4))
    for b0 in range(0, B, step):
        words = _tree_eval_plain(stacks, code, leaf_stack, slots[b0 : b0 + step])
        out[b0 : b0 + step] = bitops.count_rows(words).T
    return out


def tree_words_plain(stacks, code, leaf_stack, slots) -> torch.Tensor:
    """Plain version of the tree words: ``int32[S, W]``."""
    stacks, code, leaf_stack, slots, _ = _check_tree(
        "tree_words_plain", stacks, code, leaf_stack, slots, 1
    )
    return _tree_eval_plain(stacks, code, leaf_stack, slots[None])[:, 0].contiguous()


# Bytes of a table the direct route's C entries take from host memory as
# the kernel's parameter (tree_eval.cu holds the same number); a longer
# table is uploaded.
TREE_PARAM_BYTES = 256


def _pack(parts) -> bytes:
    """The host arrays ``parts`` one after another (each in C order)."""
    return b"".join(a.tobytes() for a in parts)


def _upload(buf: bytes, device) -> torch.Tensor:
    """``buf`` on ``device``, copied from pinned memory on the current
    stream without waiting for the host: the caching host allocator keeps
    the pinned buffer until the copy that read it has run, and a kernel on
    the same stream reads the table after the copy."""
    host = torch.empty(len(buf), dtype=torch.uint8, pin_memory=True)
    ctypes.memmove(host.data_ptr(), buf, len(buf))
    return host.to(device, non_blocking=True)


def _tree_table(parts, device):
    """The host arrays ``parts`` packed as one table, as the direct route's
    C entries take it: ``(pointer, host_bytes, owner)``, host bytes when the
    table fits TREE_PARAM_BYTES (host_bytes > 0: it goes to the kernel as
    its parameter), else an upload on ``device`` (host_bytes 0). ``owner``
    holds the memory while the call runs."""
    buf = _pack(parts)
    if len(buf) <= TREE_PARAM_BYTES:
        return buf, len(buf), buf
    table = _upload(buf, device)
    return table.data_ptr(), 0, table


def _tree_row_offsets(stacks) -> np.ndarray:
    """int64 ``[P, 2]``: for each stack, the first of the stacks that are
    one tensor (one data pointer and row count) with it, and where that
    stack's rows start in one numbering of all the stacks' rows."""
    keys = [(t.data_ptr(), t.shape[1]) for t in stacks]
    out, start = [], 0
    for k in keys:
        out.append((keys.index(k), start))
        start += k[1]
    return np.array(out, dtype=np.int64).reshape(-1, 2)


def tree_row_ids(stacks, leaf_stack, slots: np.ndarray) -> np.ndarray:
    """int64 ``[B, L]``: each slot's row as one number over all the stacks'
    rows (stacks that are one tensor share their rows, under the ordinal of
    the first); -1 where a slot is absent."""
    off = _tree_row_offsets(stacks)
    ids = off[off[np.asarray(leaf_stack, dtype=np.int64), 0], 1][None, :] + slots
    ids[slots < 0] = -1
    return ids


def _tree_id_rows(stacks, ids: np.ndarray) -> np.ndarray:
    """int64 ``[n, 2]``: the (stack ordinal, row) of each row id."""
    start = _tree_row_offsets(stacks)[:, 1]
    p = np.searchsorted(start, ids, side="right") - 1
    return np.stack([p, ids - start[p]], axis=1)


def _tree_distinct(ids: np.ndarray):
    """``(uniq, remap)``: the distinct row ids, ascending, and ``ids`` as
    int32 indices into them (-1 where absent)."""
    present = ids >= 0
    named = np.zeros(int(ids.max()) + 1 if ids.size else 0, dtype=bool)
    named[ids[present]] = True
    remap = np.full(ids.shape, -1, dtype=np.int32)
    remap[present] = (np.cumsum(named) - 1)[ids[present]]
    return np.flatnonzero(named), remap


def tree_distinct_rows(stacks, leaf_stack, slots: np.ndarray):
    """``(rows, remap)``: the distinct rows a batch names, and its slots as
    indices into them. ``rows`` is int64 ``[U, 2]`` of (stack ordinal, row),
    sorted; stacks that are one tensor (one data pointer and row count)
    share their rows, under the ordinal of the first. ``remap`` is int32
    ``[B, L]``, -1 where a slot is absent."""
    uniq, remap = _tree_distinct(tree_row_ids(stacks, leaf_stack, slots))
    return _tree_id_rows(stacks, uniq), remap


class TreeItems(NamedTuple):
    """Each item's distinct rows, each named by one of its leaves: item b's
    are named by ``leaf[offsets[b] : offsets[b + 1]]`` (flat indices ``b *
    L + l`` into the slots), in order of row id; ``local`` int32 ``[B, L]``
    is each leaf's index among its item's rows (-1: absent), ``rows_max``
    the most rows an item has."""

    offsets: np.ndarray
    leaf: np.ndarray
    local: np.ndarray
    rows_max: int


def _tree_one_item(uniq: np.ndarray, remap: np.ndarray) -> TreeItems:
    """The rows of a batch of one item, from its distinct rows
    (:func:`_tree_distinct`)."""
    present = np.flatnonzero(remap[0] >= 0)
    leaf = np.empty(uniq.size, dtype=np.int64)
    leaf[remap[0, present]] = present
    return TreeItems(np.array([0, uniq.size], np.int32), leaf, remap, uniq.size)


def tree_item_rows(ids: np.ndarray) -> TreeItems:
    """The distinct rows of each item of a batch (row ids ``[B, L]``, -1
    absent: :func:`tree_row_ids`), each listed once however often its
    leaves name it."""
    B, L = ids.shape
    if B == 1:  # the batch's distinct rows are the item's
        return _tree_one_item(*_tree_distinct(ids))
    local = np.full(ids.shape, -1, dtype=np.int32)
    order = np.argsort(ids, axis=1, kind="stable")
    srt = np.take_along_axis(ids, order, axis=1)
    new = srt >= 0
    new[:, 1:] &= srt[:, 1:] != srt[:, :-1]
    np.put_along_axis(local, order, np.where(srt >= 0, np.cumsum(new, axis=1) - 1, -1), axis=1)
    counts = new.sum(axis=1)
    offsets = np.zeros(B + 1, np.int32)
    np.cumsum(counts, out=offsets[1:])
    return TreeItems(offsets, (order + L * np.arange(B)[:, None])[new], local,
                     int(counts.max()) if B else 0)


class TreeDirect(NamedTuple):
    """A direct launch's host arrays (tree_eval.cu's direct table), its
    rows, and the index an absent leaf names."""

    parts: list
    n_rows: int
    rows_max: int


def tree_direct_layout(stacks, leaf_stack, slots: np.ndarray, steps: np.ndarray,
                       items: TreeItems | None = None, rows_max: int | None = None) -> TreeDirect:
    """The direct table of a batch: each item's rows (their words at shard 0
    and per shard), where each item's rows start, and each item's steps with
    every leaf's operand its row's index among the item's rows. With
    ``items`` (:func:`tree_item_rows`) an item lists each distinct row once;
    without, every leaf is a row of its item. An absent leaf (and a fold of
    the top) names ``rows_max`` (default: the most rows an item has)."""
    W = stacks[0].shape[2]
    B, L = slots.shape
    base = np.array([t.data_ptr() for t in stacks], dtype=np.int64)
    per = np.array([t.shape[1] * W for t in stacks], dtype=np.int64)
    p = np.asarray(leaf_stack, dtype=np.int64)
    if items is None:  # every leaf a row (an absent one never read)
        ptr = (base[p] + np.maximum(slots, 0) * (4 * W)).reshape(-1)
        stride = np.tile(per[p], B)
        offsets = np.arange(0, B * L + 1, L, dtype=np.int32)
        local = np.where(slots >= 0, np.arange(L, dtype=np.int32), -1)
        most = L
    else:  # each row at the leaf that names it
        p = p[items.leaf % L]
        ptr = base[p] + slots.reshape(-1)[items.leaf] * (4 * W)
        stride = per[p]
        offsets, local, most = items.offsets, items.local, items.rows_max
    absent = most if rows_max is None else rows_max
    # each step's operand: its leaf's row, or (column L) the absent index
    operand = np.full((B, L + 1), absent, dtype=np.int32)
    np.copyto(operand[:, :L], local, where=local >= 0)
    src, op = _tree_step_operands(steps.tobytes(), L)
    item_steps = op | (operand[:, src] << 5)
    return TreeDirect([ptr, stride, offsets, item_steps], ptr.size, absent)


@lru_cache(maxsize=1024)
def _tree_step_operands(steps: bytes, L: int) -> tuple:
    """``(src, op)`` of a program's int32 steps: each step's leaf (column
    L, the absent index, for a fold of the top) and its kind and fold."""
    st = np.frombuffer(steps, dtype=np.int32)
    src = np.where((st & 3) == TREE_POP_FOLD, L, st >> 5)
    op = st & 31
    src.flags.writeable = op.flags.writeable = False
    return src, op


def _leaf_distinct(remap: np.ndarray) -> np.ndarray:
    """Distinct values (absent counting as one) of each leaf's column."""
    L = remap.shape[1]
    n = int(remap.max()) + 2 if remap.size else 1
    seen = np.bincount((remap + 1 + n * np.arange(L)).reshape(-1), minlength=n * L)
    return np.count_nonzero(seen.reshape(L, n), axis=1)


def tree_item_order(remap: np.ndarray) -> np.ndarray:
    """int64 ``[B]``: the items in staging order, sorted by their row
    indices with the leaf of fewest distinct rows first (ties: the earlier
    leaf), so that the items of one warp's group share leaves."""
    B, L = remap.shape
    distinct = _leaf_distinct(remap)
    primary_last = sorted(range(L), key=lambda l: (distinct[l], l), reverse=True)
    n = int(remap.max()) + 2 if remap.size else 1
    if n ** L < 2**62:  # one packed key
        key = np.zeros(B, dtype=np.int64)
        for l in reversed(primary_last):
            key = key * n + (remap[:, l] + 1)
        return np.argsort(key, kind="stable")
    return np.lexsort([remap[:, l] for l in primary_last])


def tree_tiles(remap: np.ndarray, order: np.ndarray, row_tile: int, item_tile: int):
    """The items, in staging order, cut into consecutive tiles of at most
    ``item_tile`` items that name at most ``row_tile`` distinct rows (each
    item names at most ``row_tile``)."""
    n_rows = int(remap.max()) + 1 if remap.size else 0
    if n_rows <= row_tile:
        return [order[i : i + item_tile] for i in range(0, order.size, item_tile)]
    tiles, start, rows = [], 0, set()
    for i, b in enumerate(order.tolist()):
        mine = {u for u in remap[b].tolist() if u >= 0}
        grown = rows | mine
        if i > start and (i - start == item_tile or len(grown) > row_tile):
            tiles.append(order[start:i])
            start, grown = i, mine
        rows = grown
    tiles.append(order[start:])
    return tiles


class TreePlan(NamedTuple):
    """How one tree_count launch runs; ``wsplit`` blocks per (item or
    tile, shard), each a slice of the shard's chunks. ``route`` "direct":
    item by item, 16-byte or word loads (``vec16``); ``stages`` 0 reads the
    leaves through L2, else each chunk of the item's (at most ``row_tile``)
    distinct rows is staged in a ring of that many shared-memory stages by
    blocks of ``lanes`` (16 bytes of a row each), with ``flat`` the fold of
    a flat chain of any length run on its own instance (-1: the general
    step loop). "staged": tiles of at most ``item_tile`` items naming at
    most ``row_tile`` distinct rows, each chunk of those rows staged once
    per shard in a ring of ``stages`` stages; ``flat`` the fold of a flat
    chain of at most TREE_FLAT_STEPS steps run on its own instance."""

    route: str
    vec16: bool
    stages: int = 0
    row_tile: int = 0
    item_tile: int = 0
    wsplit: int = 1
    flat: int = -1
    lanes: int = 0


def _pad(n: int, m: int) -> int:
    return -(-n // m) * m


def _tree_staged_smem(rows: int, items: int, L: int, n_steps: int, stages: int) -> int:
    """Dynamic shared-memory bytes of a staged block (tree_eval.cu,
    tree_smem): the stage ring (the rows and a zero row), row pointers,
    steps, slots, and each group's accumulator (32 lanes x 8 bytes)."""
    return (stages * (rows + 1) * TREE_CHUNK_WORDS * 4 + _pad(8 * rows, 16)
            + _pad(4 * n_steps, 16) + 4 * L * items + 32 * items)


def _tree_staged_fits(L: int, vec16: bool, staged_depth: int) -> bool:
    """Whether the staged route can run a program of ``L`` leaves and
    ``staged_depth`` register entries at all (its 16-byte copies, its
    registers and its leaf limit)."""
    return vec16 and staged_depth <= TREE_STAGED_MAX_DEPTH and L <= TREE_STAGED_MAX_LEAVES


def _tree_shares_rows(B: int, L: int, U: int, vec16: bool, staged_depth: int) -> bool:
    """Whether a batch is one for the staged route: it can run the program
    and every distinct row serves at least two leaf reads."""
    return _tree_staged_fits(L, vec16, staged_depth) and U > 0 and B * L >= 2 * U


def _tree_rows_smem(rows: int, n_steps: int, depth: int, stages: int,
                    lanes: int = TREE_ROWS_LANES) -> int:
    """Dynamic shared-memory bytes of a block of the direct route's rows
    instance (tree_eval.cu, tree_rows_smem): the stage ring (the item's rows
    and a zero row, 16 bytes a lane each), row pointers, steps in whole
    int4s, and the operand stack below the top (16 bytes a lane per
    entry)."""
    return (stages * (rows + 1) * lanes * 16 + _pad(8 * rows, 16)
            + 16 * -(-n_steps // 4) + (depth - 1) * lanes * 16)


def _tree_rows_warps(smem: int, lanes: int) -> int:
    """Warps of rows-instance blocks of ``lanes`` and ``smem`` bytes that one
    SM holds (its shared memory, threads and blocks)."""
    if smem > _TREE_SMEM_LIMIT:
        return 0
    return min(_SM_BLOCKS, _SM_THREADS // lanes, _TREE_SMEM_LIMIT // smem) * lanes // 32


@lru_cache(maxsize=1024)
def _tree_rows_shape(rows: int, n_steps: int, depth: int, smem_limit: int) -> tuple:
    """``(warps, stages, lanes)`` of the rows-instance block shape that puts
    the most warps on an SM, then the most stages, then the most lanes
    (warps 0: none fits). ``smem_limit`` (_TREE_SMEM_LIMIT) keys the cache."""
    return max((_tree_rows_warps(_tree_rows_smem(rows, n_steps, depth, st, n), n), st, n)
               for st in range(1, TREE_ROWS_MAX_STAGES + 1)
               for n in (TREE_ROWS_LANES, TREE_ROWS_LANES // 2))


def tree_direct_plan(rows: int, W: int, vec16: bool, depth: int, n_steps: int,
                     chain: int = -1) -> TreePlan:
    """The direct route's plan for items of at most ``rows`` distinct rows
    and a program of ``n_steps`` steps needing ``depth`` entries: the rows
    instance where the rows are 16-byte and fit shared memory, with the
    block shape (TREE_ROWS_LANES lanes or half as many, a ring of 1 to
    TREE_ROWS_MAX_STAGES stages) that puts the most warps on an SM, then
    the most stages, then the most lanes (a flat chain, ``chain``, on its
    own instance); else through L2. Slices of TREE_DIRECT_SLICE_WORDS
    words."""
    wsplit = max(1, -(-W // TREE_DIRECT_SLICE_WORDS))
    if vec16:
        warps, stages, lanes = _tree_rows_shape(rows, n_steps, depth, _TREE_SMEM_LIMIT)
        if warps:
            return TreePlan("direct", True, stages, rows, 0, wsplit, chain, lanes)
    return TreePlan("direct", vec16, 0, 0, 0, wsplit)


def tree_plan(B: int, L: int, U: int, S: int, W: int, vec16: bool, staged_depth: int,
              n_steps: int, flat: int = -1, item_rows: int | None = None,
              chain: int = -1) -> TreePlan:
    """The tree count's launch plan for ``B`` items of ``L`` leaves naming
    ``U`` distinct rows at ``S`` shards of ``W`` words. Staged where
    :func:`_tree_shares_rows`: the item tile from the slot budget, the row
    tile and stages from shared memory (2 stages at least, 4 at most),
    slices of TREE_SLICE_CHUNKS chunks; a flat chain (``flat``,
    :func:`tree_flat`) on its own instance. Direct otherwise
    (:func:`tree_direct_plan`, for items of at most ``item_rows`` distinct
    rows, default ``min(L, U)``, and the fold ``chain`` of a flat chain of
    any length)."""
    rows = min(L, U) if item_rows is None else item_rows
    direct = tree_direct_plan(rows, W, vec16, staged_depth, n_steps, chain)
    if not _tree_shares_rows(B, L, U, vec16, staged_depth):
        return direct
    item_tile = min(_pad(B, TREE_GROUP), _TREE_ITEM_TILE,
                    _TREE_SLOT_BYTES // (4 * (L + 8)) // TREE_GROUP * TREE_GROUP)
    fixed = _pad(4 * n_steps, 16) + 4 * (L + 8) * item_tile

    def fit(stages):  # rows a block holds with this many stages
        row = stages * TREE_CHUNK_WORDS * 4
        return (_TREE_SMEM_LIMIT - fixed - 8 - row) // (row + 8)

    row_tile = min(U, fit(2))
    if row_tile < min(L, U) or item_tile < TREE_GROUP:  # one item's rows must fit
        return direct
    stages = max(st for st in (2, 3, 4) if fit(st) >= row_tile)
    wsplit = -(-W // (TREE_CHUNK_WORDS * TREE_SLICE_CHUNKS))
    return TreePlan("staged", True, stages, row_tile, item_tile, wsplit, flat)


def _check_tree_plan(plan: TreePlan, L: int, W: int, n_steps: int, staged_depth: int,
                     chain: int | None = None) -> None:
    """Raise ``ValueError`` for a plan the C entries refuse, or (given the
    program's ``chain``, :func:`tree_flat` of any length) a flat instance
    the program is not a chain of."""
    if plan.route == "direct" and plan.stages == 0:
        ok = (not (plan.vec16 and W % 4) and plan.wsplit >= 1 and plan.flat == -1
              and plan.lanes == 0)
    elif plan.route == "direct":
        ok = (plan.vec16 and W % 4 == 0 and 1 <= plan.stages <= 4 and plan.row_tile >= 0
              and plan.lanes in (TREE_ROWS_LANES, TREE_ROWS_LANES // 2)
              and plan.wsplit >= 1 and -1 <= plan.flat <= 3
              and (plan.flat < 0 or staged_depth == 1)
              and (chain is None or plan.flat in (-1, chain))
              and _tree_rows_smem(plan.row_tile, n_steps, staged_depth, plan.stages,
                                  plan.lanes) <= _TREE_SMEM_LIMIT)
    else:
        ok = (plan.route == "staged" and plan.vec16 and W % 4 == 0
              and 2 <= plan.stages <= 4 and plan.row_tile >= 1
              and plan.item_tile > 0 and plan.item_tile % TREE_GROUP == 0
              and plan.wsplit >= 1
              and L <= TREE_STAGED_MAX_LEAVES and staged_depth <= TREE_STAGED_MAX_DEPTH
              and -1 <= plan.flat <= 3
              and (plan.flat < 0 or (staged_depth == 1 and n_steps <= TREE_FLAT_STEPS))
              and _tree_staged_smem(plan.row_tile, plan.item_tile, L, n_steps,
                                    plan.stages) <= _TREE_SMEM_LIMIT)
    if not ok:
        raise ValueError(f"tree plan {plan} cannot run {L} leaves at W = {W}")


def tree_flat_order(steps: np.ndarray, remap: np.ndarray, flat: int) -> np.ndarray:
    """A flat chain's steps with its leaves in the order of fewest distinct
    rows first, so that the leaves a whole group shares come first; ANDNOT
    keeps its minuend first. The chain's fold makes the order free."""
    leaves = (steps >> 5).tolist()
    distinct = _leaf_distinct(remap)
    fixed = 1 if flat == 3 else 0
    leaves[fixed:] = sorted(leaves[fixed:], key=lambda l: (distinct[l], l))
    return np.array([TREE_PUSH | leaves[0] << 5]
                    + [TREE_LEAF_FOLD | flat << 2 | l << 5 for l in leaves[1:]], dtype=np.int32)


class TreeStaged(NamedTuple):
    """A staged launch's host arrays (tree_eval.cu's staged table), the
    steps in it, and its sizes: the largest tile's rows and padded items."""

    parts: list
    steps: np.ndarray
    tiles: int
    n_rows: int
    n_items: int
    rows_max: int
    items_max: int


def tree_staged_layout(stacks, rows: np.ndarray, remap: np.ndarray, steps: np.ndarray,
                       plan: TreePlan) -> TreeStaged:
    """The staged table of a batch: items in staging order cut into tiles
    (:func:`tree_item_order`, :func:`tree_tiles`), each tile's rows, its
    slots as indices into them ([L][items], padded to whole groups with
    absent slots; an absent slot names the tile's zero row, index = its row
    count; TREE_UNIFORM marks a group of TREE_GROUP items that name one row)
    and each item's row of the output (-1 for padding)."""
    W = stacks[0].shape[2]
    L = remap.shape[1]
    order = tree_item_order(remap)
    if plan.flat >= 0:
        steps = tree_flat_order(steps, remap, plan.flat)
    heads, row_ids, slot_blocks, ids = [], [], [], []
    n_rows = n_items = 0
    for items in tree_tiles(remap, order, plan.row_tile, plan.item_tile):
        sub = remap[items]
        if items.size == remap.shape[0]:  # one tile: its rows are all the rows
            mine = np.arange(rows.shape[0])
            local = sub
        else:
            mine = np.unique(sub[sub >= 0])
            local = np.searchsorted(mine, sub)
        m = _pad(items.size, TREE_GROUP)
        block = np.full((L, m), mine.size, dtype=np.int32)
        block[:, : items.size] = np.where(sub >= 0, local, mine.size).T
        grouped = block.reshape(L, -1, TREE_GROUP)
        block |= np.repeat((grouped == grouped[:, :, :1]).all(axis=2), TREE_GROUP, axis=1) \
            * np.int32(TREE_UNIFORM)
        item_ids = np.full(m, -1, dtype=np.int32)
        item_ids[: items.size] = items
        heads.append((n_rows, mine.size, n_items, m))
        row_ids.append(mine)
        slot_blocks.append(block.reshape(-1))
        ids.append(item_ids)
        n_rows += mine.size
        n_items += m
    tile_rows = rows[np.concatenate(row_ids)]
    base = np.array([t.data_ptr() for t in stacks], dtype=np.int64)
    per = np.array([t.shape[1] for t in stacks], dtype=np.int64)
    parts = [
        base[tile_rows[:, 0]] + tile_rows[:, 1] * W * 4,
        per[tile_rows[:, 0]] * W,
        np.array(heads, dtype=np.int32),
        steps,
        *slot_blocks,
        *ids,
    ]
    return TreeStaged(parts, steps, len(heads), n_rows, n_items,
                      max(h[1] for h in heads), max(h[3] for h in heads))


class TreeLaunch(NamedTuple):
    """What the tree count launches for a batch: the checked program, the
    batch's distinct rows and remapped slots (:func:`tree_distinct_rows`,
    where the program could take the staged route), each item's distinct
    rows (:func:`tree_item_rows`, 16-byte rows on the direct route; None for
    word-by-word rows, which take it through L2) and the plan."""

    program: TreeProgram
    rows: np.ndarray | None
    remap: np.ndarray | None
    items: TreeItems | None
    plan: TreePlan


def _tree_launch(stacks, leaf_stack, slots, prog: TreeProgram) -> TreeLaunch:
    S, _, W = stacks[0].shape
    B, L = slots.shape
    vec16 = _copies16(W, *stacks)
    rows = remap = items = None
    U = L
    ids = tree_row_ids(stacks, leaf_stack, slots) if vec16 else None
    if vec16 and (B == 1 or _tree_staged_fits(L, vec16, prog.staged_depth)):
        uniq, remap = _tree_distinct(ids)
        U = uniq.size
    if vec16 and not _tree_shares_rows(B, L, U, vec16, prog.staged_depth):
        items = _tree_one_item(uniq, remap) if B == 1 else tree_item_rows(ids)
    plan = tree_plan(B, L, U, S, W, vec16, prog.staged_depth, prog.steps.size, prog.flat,
                     item_rows=None if items is None else items.rows_max, chain=prog.chain)
    _check_tree_plan(plan, L, W, prog.steps.size, prog.staged_depth, prog.chain)
    if plan.route == "staged":
        rows = _tree_id_rows(stacks, uniq)
    return TreeLaunch(prog, rows, remap, items, plan)


def tree_count_launch(stacks, code, leaf_stack, slots) -> TreeLaunch:
    """The :class:`TreeLaunch` :func:`tree_count` makes of these arguments
    on their device (for a report of its route and floors)."""
    stacks, _, leaf_stack, slots, prog = _check_tree(
        "tree_count", stacks, code, leaf_stack, slots, 2
    )
    return _tree_launch(stacks, leaf_stack, slots, prog)


def _tree_per_slice(stacks, fn, code, leaf_stack, slots) -> list:
    """``fn`` over each slice of sharded ``stacks``: the k-th slices of
    every stack, in order."""
    stacks = tuple(stacks)
    _sh.same_layout("tree", *stacks)
    return _sh.per_slice(stacks[0], lambda *parts: fn(parts, code, leaf_stack, slots),
                         *stacks[1:])


def tree_count(stacks, code, leaf_stack, slots) -> torch.Tensor:
    """``int32[B, S]`` per-shard popcounts of the postfix tree ``code`` for
    each slot row of ``slots`` (host int32 ``[B, L]``; leaf ``l`` of item
    ``b`` is row ``slots[b, l]`` of ``stacks[leaf_stack[l]]``, absent when
    negative), in one launch on the route :func:`tree_plan` picks. Callers
    sum over shards in int64. Sharded stacks (of one layout): one launch a
    slice, the partials joined in shard order."""
    if _sh.is_sharded(stacks[0]):
        return _sh.cat(stacks[0], _tree_per_slice(stacks, tree_count, code, leaf_stack, slots), 1)
    stacks, code, leaf_stack, slots, prog = _check_tree(
        "tree_count", stacks, code, leaf_stack, slots, 2
    )
    if _is_cpu("tree_count", *stacks):
        return tree_count_plain(stacks, code, leaf_stack, slots)
    S, _, W = stacks[0].shape
    B, L = slots.shape
    dev = stacks[0].device
    if B == 0 or S == 0 or W == 0:
        return torch.zeros((B, S), dtype=torch.int32, device=dev)
    _, rows, remap, items, plan = _tree_launch(stacks, leaf_stack, slots, prog)
    if plan.route == "direct":  # the C entry zeroes out
        out = torch.empty((B, S), dtype=torch.int32, device=dev)
        if items is None and plan.vec16:
            items = tree_item_rows(tree_row_ids(stacks, leaf_stack, slots))
        if plan.stages and items.rows_max > plan.row_tile:
            raise ValueError(f"tree plan {plan} stages fewer rows than an item's "
                             f"{items.rows_max}")
        lay = tree_direct_layout(stacks, leaf_stack, slots, prog.steps, items,
                                 plan.row_tile if plan.stages else None)
        ptr, host_bytes, _owner = _tree_table(lay.parts, dev)
        with _launching("tree_count", dev):
            _launch(
                "pilosa_tree_count", ptr, host_bytes, B, lay.n_rows, prog.steps.size,
                prog.staged_depth, S, W, int(plan.vec16), lay.rows_max, plan.stages,
                plan.lanes, plan.wsplit, plan.flat, out.data_ptr(), dev.index, _stream(dev),
            )
    else:
        out = torch.zeros((B, S), dtype=torch.int32, device=dev)
        lay = tree_staged_layout(stacks, rows, remap, prog.steps, plan)
        table = _upload(_pack(lay.parts), dev)
        with _launching("tree_count", dev):
            _launch(
                "pilosa_tree_count_staged", table.data_ptr(), lay.tiles, lay.n_rows,
                lay.n_items, prog.steps.size, L, prog.staged_depth, S, W, plan.stages,
                lay.rows_max, lay.items_max, plan.wsplit, plan.flat, out.data_ptr(),
                dev.index, _stream(dev),
            )
    return out


def tree_words(stacks, code, leaf_stack, slots) -> torch.Tensor:
    """``int32[S, W]`` words of the postfix tree ``code`` for one slot row
    (host int32 ``[L]``), in one launch (one a slice of sharded stacks,
    joined in shard order)."""
    if _sh.is_sharded(stacks[0]):
        return _sh.cat(stacks[0], _tree_per_slice(stacks, tree_words, code, leaf_stack, slots), 0)
    stacks, code, leaf_stack, slots, prog = _check_tree(
        "tree_words", stacks, code, leaf_stack, slots, 1
    )
    if _is_cpu("tree_words", *stacks):
        return tree_words_plain(stacks, code, leaf_stack, slots)
    S, _, W = stacks[0].shape
    dev = stacks[0].device
    out = torch.empty((S, W), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    lay = tree_direct_layout(stacks, leaf_stack, slots[None], prog.steps)
    ptr, host_bytes, _owner = _tree_table(lay.parts, dev)
    vec16 = _copies16(W, *stacks) and out.data_ptr() % 16 == 0
    with _launching("tree_words", dev):
        _launch(
            "pilosa_tree_words", ptr, host_bytes, lay.n_rows, prog.steps.size,
            prog.staged_depth, S, W, int(vec16), out.data_ptr(), dev.index, _stream(dev),
        )
    return out
