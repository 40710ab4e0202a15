"""Bit-sliced-index (BSI) integer fields (counterpart of
``pilosa_tpu/ops/bsi.py``).

An int field stores each value bit-sliced (reference fragment.go:90-96):
an exists row, a sign row and ``depth`` magnitude planes, LSB first.
Values are offset from the field's base, sign/magnitude: stored = value -
base, the sign row holds stored < 0 and the planes hold abs(stored).

Four hand-written CUDA kernels (``ops/csrc/bsi.cu`` and
``ops/csrc/bsi_sum_batch.cu``) replace the XLA programs of the JAX
package, none of which is a Pallas kernel:

* **bsi_range** (:func:`bsi_range`) evaluates ``Q`` encoded range
  predicates (:func:`encode_query_bounds`) in one pass over the planes,
  as per-shard counts ``int32[Q, S]`` or result words ``int32[Q, S, W]``.
  It answers :func:`range_batch` and :func:`range_count_batch`, and
  through them every single condition (:func:`range_eq`,
  :func:`range_lt`, :func:`range_gt`, :func:`range_between`). The host
  compiles each flight once (:func:`range_plan`): the queries sorted by
  composition class (:func:`query_classes`) into the kernel's parameter
  block, each with the output row it writes in the caller's order.
* **bsi_sum** (:func:`bsi_sum`) writes per shard the popcounts
  ``int32[S, Q, depth+1, 2]`` of every plane ANDed with ``exists & filter_q``
  and split by sign, plus the exists counts; :func:`sum_count` and
  :func:`sum_host` combine them on the host in Python ints, so totals past
  2^63 stay exact.
* **bsi_sum_batch** (:func:`bsi_sum_batch`) answers a flight of filtered
  Sums at once on the tensor cores (single-bit MMA): the totals
  ``[depth+1, 2, Q]`` over the shards, each filter a row of any
  ``[S, R, W]`` operand read in place through an index array, so a
  ``Row`` of a resident stack needs no copy; :func:`sum_batch_host`
  combines them as :func:`sum_host` does.
* **bsi_extreme** (:func:`bsi_extreme`) narrows both sign branches of
  Min/Max from the top plane down, per shard and slice of
  BSI_EXTREME_SLICE words, writing ``(has_a, has_b, mag_a, cnt_a, mag_b,
  cnt_b)`` in 64 bits; :func:`min_max_host` takes the extreme over them
  and sums the counts that reach it, which is JAX's narrowing across all
  shards.

Each kernel wrapper checks device, dtype, shape and layout and counts its
launches in ``kernels.LAUNCHES``. Given CPU tensors it computes the
kernel's plain PyTorch version (``*_plain`` beside it); given CUDA tensors
it launches the kernel or raises.

Operands are int32 word views: ``planes[S, depth, W]`` with
``exists``/``sign``/filters ``[S, W]``, or one shard's ``[depth, W]`` and
``[W]``. Each row must be contiguous and a shard's planes ``W`` words
apart, so the slices ``bits[:, 2:]``, ``bits[:, 0]`` and ``bits[:, 1]`` of a
BSI stack ``[S, 2+depth, W]`` reach the kernels without a copy. ``~`` on
int32 is the bitwise complement; counts go through ``bitops.popcount``.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from pilosa_tpu_torch.ops import bitops, kernels
from pilosa_tpu_torch.parallel import sharded as _sh

# ---------------------------------------------------------------------------
# Query bounds (the batched encoding of the JAX package, unchanged)
# ---------------------------------------------------------------------------

_ONES32 = np.uint32(0xFFFFFFFF)
_KSHIFT = np.arange(64)  # plane-index shifts for magnitude-bit expansion
_ZERO_META = [0] * 11    # shared all-zero meta row for padding slots

# comparison ops consumable by encode_query_bounds; "any" is the identity
# bound (matches every existing column)
_CMP_OPS = ("<", "<=", ">", ">=", "==", "!=", "any")

# qmeta channel indices (full-word masks); bit c of a bounds-table flag
# word is channel c
_M_A0 = 0      # lo accumulator init: 0 = strict (<), ONES = non-strict (<=)
_M_B0 = 1      # hi accumulator init: 0 = strict (>), ONES = non-strict (>=)
_M_OOB = 2     # |bound| >= 2^depth: forces A=ONES, B=0
_M_FNEG = 3    # unconditionally include negative columns
_M_FNON = 4    # unconditionally include non-negative columns
_M_SNEG = 5    # apply the compare term to negative columns
_M_SNON = 6    # apply the compare term to non-negative columns
_M_XOR = 7     # invert the compare term (!=)
_M_SELA = 8    # term reads A
_M_SELB = 9    # term reads B
_M_SELC = 10   # term reads A & B (==/!= equality)
_M_CH = 11


def condition_bounds(op: str, value) -> list[tuple[str, int]]:
    """A PQL condition op as 1-2 ``(cmp, stored_bound)`` bounds for
    :func:`encode_query_bounds`. ``value`` is already base-adjusted;
    ``!= None`` (not-null) is the unconditional bound. Raises ValueError
    for unsupported shapes."""
    if op == "!=" and value is None:
        return [("any", 0)]
    if op in ("<", "<=", ">", ">=", "==", "!="):
        if value is None:
            raise ValueError(f"condition {op} requires a value")
        return [(op, int(value))]
    if op == "><":
        lo, hi = value
        return [(">=", int(lo)), ("<=", int(hi))]
    if op in ("<x<", "<=x<", "<x<=", "<=x<="):
        lo, hi = value
        lo_op, hi_op = op.split("x")
        return [
            (">=" if lo_op == "<=" else ">", int(lo)),
            ("<=" if hi_op == "<=" else "<", int(hi)),
        ]
    raise ValueError(f"unsupported condition op: {op}")


def encode_query_bounds(queries, depth: int, q_pad: int | None = None):
    """Per-query bound lists as ``(qmask[P,B,depth], qinv[P,B,depth],
    qmeta[P,B,11])`` uint32 full-word masks, padded to ``q_pad`` queries
    (padding rows select nothing), and ``need = (lo, hi)``: which borrow
    accumulators any bound reads. ``qmask`` holds each bound's magnitude
    bits per plane, ``qinv`` their complement and ``qmeta`` the ``_M_*``
    channels; ``B`` is the largest bound count of the flight. Out-of-band
    bounds (``|bound| >= 2^depth``) and "any" read no accumulator."""
    Q = len(queries)
    P = Q if q_pad is None else q_pad
    if P < Q:
        raise ValueError("q_pad smaller than the query count")
    for bounds in queries:
        if not 1 <= len(bounds) <= 2:
            raise ValueError("each query takes 1-2 bounds")
    B = max((len(b) for b in queries), default=1)
    mags = [0] * (P * B)
    meta_rows = [_ZERO_META] * (P * B)
    need_lo = need_hi = False
    lim = 1 << depth
    for qi, bounds in enumerate(queries):
        for j in range(B):
            # a missing second bound is the neutral "any" (r & exists)
            cmp_, bound = bounds[j] if j < len(bounds) else ("any", 0)
            meta = [0] * _M_CH
            meta_rows[qi * B + j] = meta
            if cmp_ == "any":
                meta[_M_FNEG] = meta[_M_FNON] = 1
                continue
            if cmp_ not in _CMP_OPS:
                raise ValueError(f"unsupported comparison: {cmp_}")
            mag = abs(int(bound))
            neg = bound < 0
            oob = mag >= lim
            if oob:
                meta[_M_OOB] = 1
            else:
                mags[qi * B + j] = mag
            meta[_M_SNEG if neg else _M_SNON] = 1
            if cmp_ in ("==", "!="):
                meta[_M_A0] = meta[_M_B0] = 1
                meta[_M_SELC] = 1
                if cmp_ == "!=":
                    meta[_M_XOR] = 1
                    meta[_M_FNON if neg else _M_FNEG] = 1
                lo = hi = not oob
            else:
                # value-space </<= of a non-negative bound (or >/>= of a
                # negative one) is the lo side of the magnitude compare;
                # the mirrored cases are the hi side. The opposite sign
                # class matches unconditionally for </<= nonneg and >/>=
                # neg (fill), and never otherwise.
                lo = (cmp_[0] == "<") != neg
                hi = not lo
                if cmp_.endswith("="):
                    meta[_M_A0 if lo else _M_B0] = 1
                meta[_M_SELA if lo else _M_SELB] = 1
                if cmp_[0] == ("<" if not neg else ">"):
                    meta[_M_FNON if neg else _M_FNEG] = 1
                lo, hi = lo and not oob, hi and not oob
            need_lo = need_lo or lo
            need_hi = need_hi or hi
    mag_arr = np.asarray(mags, np.int64).reshape(P, B, 1)
    qmask = ((mag_arr >> _KSHIFT[:depth]) & 1).astype(np.uint32) * _ONES32
    qmeta = np.asarray(meta_rows, np.uint32).reshape(P, B, _M_CH) * _ONES32
    qinv = ~qmask
    return qmask, qinv, qmeta, (need_lo, need_hi)


def bounds_table(qmask: np.ndarray, qmeta: np.ndarray) -> np.ndarray:
    """The table bsi_range reads: ``int32[P, B, 3]``, one ``(flags,
    mag_lo, mag_hi)`` entry per encoded bound, where bit c of ``flags`` is
    meta channel c and ``mag`` the bound's magnitude (its ``qmask`` bits)
    as a 64-bit number in two halves."""
    P, B, depth = qmask.shape
    bits = (np.asarray(qmask) != 0).astype(np.uint64)
    mag = (bits << np.arange(depth, dtype=np.uint64)).sum(axis=-1, dtype=np.uint64)
    flags = ((np.asarray(qmeta) != 0).astype(np.int64) << np.arange(_M_CH)).sum(axis=-1)
    out = np.empty((P, B, 3), dtype=np.int32)
    out[..., 0] = flags
    out[..., 1] = (mag & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    out[..., 2] = (mag >> np.uint64(32)).astype(np.uint32).view(np.int32)
    return out


def _table_entry(table: np.ndarray, q: int, b: int) -> tuple[int, int]:
    """(flags, magnitude) of one bound of the table."""
    flags, lo, hi = (int(x) for x in table[q, b])
    return flags, (lo & 0xFFFFFFFF) | ((hi & 0xFFFFFFFF) << 32)


def table_sides(table: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per bound, whether it reads the lo borrow accumulator (</<= and
    equality) and the hi one (>/>= and equality); out of band, neither."""
    flags = np.asarray(table)[..., 0].astype(np.int64)
    live = (flags >> _M_OOB) & 1 == 0
    lo = live & (((flags >> _M_SELA) | (flags >> _M_SELC)) & 1 == 1)
    hi = live & (((flags >> _M_SELB) | (flags >> _M_SELC)) & 1 == 1)
    return lo, hi


def _queries_table(queries, depth: int) -> np.ndarray:
    qmask, _, qmeta, _ = encode_query_bounds(queries, depth)
    return bounds_table(qmask, qmeta)


def _eq_table(value_abs: int, negative: bool, depth: int) -> np.ndarray:
    """One equality bound on the sign class ``negative`` selects,
    ``-0`` included (the encoder spells a bound's sign with its value)."""
    flags = (1 << _M_A0) | (1 << _M_B0) | (1 << _M_SELC)
    flags |= 1 << (_M_SNEG if negative else _M_SNON)
    mag = int(value_abs)
    if mag >= 1 << depth:
        flags |= 1 << _M_OOB
        mag = 0
    entry = np.array([flags, mag & 0xFFFFFFFF, mag >> 32], dtype=np.uint32)
    return entry.view(np.int32).reshape(1, 1, 3)


# ---------------------------------------------------------------------------
# Operands
# ---------------------------------------------------------------------------


def _check_rows(name: str, t, ndim: int) -> None:
    """int32, ``ndim`` dims, each row (the last axis) contiguous."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t).__name__}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 words, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if t.numel() and t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name}: rows must be contiguous")


def _operands(name: str, planes, exists, sign, depth: int | None = None):
    """``(planes[S, depth, W], exists[S, W], sign[S, W], one_shard)``:
    one shard's ``[depth, W]``/``[W]`` operands gain a shard axis of 1,
    and ``planes`` is cut to its first ``depth`` planes. Sharded operands
    pass as they are (the kernel wrappers check each slice), ``planes``
    cut alike."""
    if _sh.is_sharded(planes):
        _sh.same_layout(name, planes, exists, sign)
        if depth is not None:
            if not 0 <= depth <= planes.shape[1]:
                raise ValueError(f"{name}: depth {depth} of {planes.shape[1]} planes")
            planes = planes[:, :depth]
        return planes, exists, sign, False
    one = isinstance(planes, torch.Tensor) and planes.dim() == 2
    _check_rows(name, planes, 2 if one else 3)
    _check_rows(name, exists, 1 if one else 2)
    _check_rows(name, sign, 1 if one else 2)
    if one:
        planes, exists, sign = planes[None], exists[None], sign[None]
    if depth is not None:
        if not 0 <= depth <= planes.shape[1]:
            raise ValueError(f"{name}: depth {depth} of {planes.shape[1]} planes")
        planes = planes[:, :depth]
    S, D, W = planes.shape
    if D > 1 and planes.stride(1) != W:
        raise ValueError(f"{name}: a shard's planes must be {W} words apart")
    for t in (exists, sign):
        if tuple(t.shape) != (S, W):
            raise ValueError(f"{name}: row shape {tuple(t.shape)} != {(S, W)}")
    return planes, exists, sign, one


def _filters(name: str, filt, S: int, W: int, one: bool):
    """Filters as ``[S, Q, W]``: one filter ``[S, W]`` becomes ``[S, 1,
    W]``; one shard's ``[W]`` or ``[Q, W]`` gains its shard axis."""
    if not isinstance(filt, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(filt).__name__}")
    if one:
        filt = filt.reshape(1, 1, -1) if filt.dim() == 1 else filt[None]
    elif filt.dim() == 2:
        filt = filt[:, None, :]
    _check_rows(name, filt, 3)
    if filt.shape[0] != S or filt.shape[2] != W:
        raise ValueError(f"{name}: filter shape {tuple(filt.shape)} against {(S, W)}")
    return filt


def _cpu(name: str, *ts) -> bool:
    return kernels._is_cpu(name, *[t for t in ts if t is not None])


# ---------------------------------------------------------------------------
# bsi_range: Q encoded predicates, counts or words
# ---------------------------------------------------------------------------

# queries a launch's parameter block holds (bsi.cu BSI_RANGE_PQ), and the
# queries a launch takes: a longer flight is cut
_RANGE_PARAM_Q = 256
BSI_RANGE_MAX_Q = _RANGE_PARAM_Q
# bytes of [Q, S, W] result words a caller materialises per launch
# (JAX's _COUNT_BATCH_VMAP_LIMIT): words-mode flights are cut to fit
RANGE_WORDS_BYTES = 256 << 20


def range_words_cap(S: int, W: int) -> int:
    """Queries per words-mode launch within RANGE_WORDS_BYTES."""
    return max(1, RANGE_WORDS_BYTES // max(1, S * W * 4))


def _bound_words(planes, neg, non, flags: int, mag: int) -> torch.Tensor:
    """Columns matching one encoded bound: the two LSB-first borrow
    accumulators (A = magnitude </<= bound, B = magnitude >/>= bound),
    composed by the flag channels with the sign split and fill."""
    def m(c):  # channel c as a full int32 word
        return -1 if (flags >> c) & 1 else 0

    A = torch.full_like(neg, m(_M_A0))
    B = torch.full_like(neg, m(_M_B0))
    if not m(_M_OOB):
        for k in range(planes.shape[1]):
            p = planes[:, k]
            if (mag >> k) & 1:
                A, B = A | ~p, B & p
            else:
                A, B = A & ~p, B | p
    A = A | m(_M_OOB)
    B = B & ~m(_M_OOB)
    term = m(_M_XOR) ^ ((m(_M_SELA) & A) | (m(_M_SELB) & B) | (m(_M_SELC) & A & B))
    sel = (m(_M_SNEG) & neg) | (m(_M_SNON) & non)
    return (m(_M_FNEG) & neg) | (m(_M_FNON) & non) | (sel & term)


def bsi_range_plain(planes, exists, sign, table: np.ndarray, count: bool) -> torch.Tensor:
    """Plain version of bsi_range over stacked operands: ``int32[Q, S]``
    per-shard counts, or ``int32[Q, S, W]`` words."""
    neg = exists & sign
    non = exists & ~sign
    out = []
    for q in range(table.shape[0]):
        r = None
        for b in range(table.shape[1]):
            rb = _bound_words(planes, neg, non, *_table_entry(table, q, b))
            r = rb if r is None else r & rb
        out.append(bitops.count_rows(r) if count else r)
    S, _, W = planes.shape
    if not out:
        return torch.zeros((0, S) if count else (0, S, W), dtype=torch.int32,
                           device=planes.device)
    return torch.stack(out)


# ---------------------------------------------------------------------------
# bsi_range's launch plan: the flight compiled once on the host
# ---------------------------------------------------------------------------

# Composition classes (bsi.cu BSI_C_*): a query's result as a fixed
# function of its borrow accumulators (A, B of its first bound, A1, B1 of
# its second) and its sign classes, sel (the non-negative columns, or the
# negative ones when swapped) and fil (the other).
_C_ZERO = 0     # 0
_C_EXISTS = 1   # sel | fil
_C_FILL_A = 2   # fil | (sel & A)
_C_SEL_B = 3    # sel & B
_C_EQ = 4       # sel & A & B
_C_NE = 5       # fil | (sel & ~(A & B))
_C_BT_SAME = 6  # sel & B & A1
_C_BT_MIX = 7   # (fil & A) | (sel & A1)
_C_GEN1 = 8     # (neg & Tn(A, B)) | (non & To(A, B)), truth tables from the flags
_C_GEN2 = 9     # the same, ANDed with the second bound's
# bounds whose magnitudes a class compares with the planes
_C_BOUNDS = np.array((0, 0, 1, 1, 1, 1, 2, 2, 1, 2))

# truth tables over (A, B), bit A + 2B: A, B, A & B, ~(A & B)
_TT_A, _TT_B, _TT_AB, _TT_NAB = 0xA, 0xC, 0x8, 0x7
# a bound's (Tn, To), its result on negative and on non-negative columns,
# -> (class, swap) of the query of that bound alone
_ONE_BOUND = {
    (0xF, _TT_A): (_C_FILL_A, 0), (_TT_A, 0xF): (_C_FILL_A, 1),
    (0x0, _TT_B): (_C_SEL_B, 0), (_TT_B, 0x0): (_C_SEL_B, 1),
    (0x0, _TT_AB): (_C_EQ, 0), (_TT_AB, 0x0): (_C_EQ, 1),
    (0xF, _TT_NAB): (_C_NE, 0), (_TT_NAB, 0xF): (_C_NE, 1),
}

# segments a launch's parameter block holds (one per class and swap)
RANGE_LAUNCH_SEGS = 16
# threads a block (bsi.cu BSI_RANGE_THREADS), and the chunks (RANGE_THREADS
# * vec words) a block walks
RANGE_THREADS = 128
RANGE_BLOCK_CHUNKS = 2
# shared memory of a block: the warps' counters and the expanded masks
_RANGE_SMEM = 48 * 1024
# (planes a thread holds, words a thread) of the kernel's instances
RANGE_CONFIGS = ((20, 4), (32, 2), (64, 1))

# bsi.cu's BsiRangeParam
_RANGE_PARAM = np.dtype([
    ("n_seg", "<i4"), ("n_q", "<i4"), ("n_rows", "<i4"), ("pad", "<i4"),
    ("seg_cls", "<i4", (RANGE_LAUNCH_SEGS,)), ("seg_end", "<i4", (RANGE_LAUNCH_SEGS,)),
    ("row", "<i4", (_RANGE_PARAM_Q,)), ("dest", "<i4", (_RANGE_PARAM_Q,)),
    ("gen", "<u4", (_RANGE_PARAM_Q,)), ("init", "<u4", (_RANGE_PARAM_Q, 4)),
    ("mag", "<u8", (_RANGE_PARAM_Q, 2)),
], align=True)
assert _RANGE_PARAM.itemsize == 11408


def _bound_truth(flags: int) -> tuple[int, int]:
    """``(Tn, To)``: what an encoded bound selects among the negative and
    among the non-negative columns, as truth tables over its borrow
    accumulators (bit A + 2B); out of band, A and B are fixed (A = 1, B =
    0), so both tables are constant."""
    def ch(c):
        return (flags >> c) & 1

    tn = to = 0
    for a in (0, 1):
        for b in (0, 1):
            A, B = (1, 0) if ch(_M_OOB) else (a, b)
            term = ch(_M_XOR) ^ ((ch(_M_SELA) & A) | (ch(_M_SELB) & B) | (ch(_M_SELC) & A & B))
            tn |= (ch(_M_FNEG) | (ch(_M_SNEG) & term)) << (a + 2 * b)
            to |= (ch(_M_FNON) | (ch(_M_SNON) & term)) << (a + 2 * b)
    return tn, to


_ANY_FLAGS = (1 << _M_FNEG) | (1 << _M_FNON)  # a bound that selects every value


@lru_cache(maxsize=None)
def _pair_class(f0: int, f1: int) -> tuple[int, int, int, int, int]:
    """``(class, swap, bound, bound, gen)`` of a query of two bounds with
    flag words ``f0``, ``f1``: its composition class, its sign selection,
    the bounds (0, 1; -1: none) it compares with the planes in the class's
    order, and (GEN classes) their truth tables, Tn and To of each bound in
    4 bits each. A bound that selects every column holding a value is
    dropped; the query is ZERO where a bound selects no negative column and
    a bound no non-negative one."""
    live = [(b, *_bound_truth(f)) for b, f in enumerate((f0, f1))]
    live = [(b, tn, to) for b, tn, to in live if not tn == to == 0xF]
    if any(tn == 0 for _, tn, _ in live) and any(to == 0 for _, _, to in live):
        return _C_ZERO, 0, -1, -1, 0
    if not live:
        return _C_EXISTS, 0, -1, -1, 0
    gen = sum((tn | to << 4) << (8 * j) for j, (_, tn, to) in enumerate(live))
    forms = [_ONE_BOUND.get((tn, to)) for _, tn, to in live]
    if len(live) == 1:
        if forms[0] is not None:
            return (*forms[0], live[0][0], -1, 0)
        return _C_GEN1, 0, live[0][0], -1, gen
    by_form = dict(zip(forms, (b for b, _, _ in live)))
    for sw in (0, 1):
        if set(forms) == {(_C_SEL_B, sw), (_C_FILL_A, sw)}:
            return _C_BT_SAME, sw, by_form[(_C_SEL_B, sw)], by_form[(_C_FILL_A, sw)], 0
    if set(forms) == {(_C_FILL_A, 1), (_C_FILL_A, 0)}:
        return _C_BT_MIX, 0, by_form[(_C_FILL_A, 1)], by_form[(_C_FILL_A, 0)], 0
    return _C_GEN2, 0, 0, 1, gen


def query_classes(table: np.ndarray):
    """``(cls, swap, bounds, gen)`` of every query of a bounds table, int64
    ``[Q]``, ``[Q]``, ``[Q, 2]``, ``[Q]`` (:func:`_pair_class` of its flag
    words; a one-bound table's second bound selects every value)."""
    flags = np.asarray(table)[..., 0].astype(np.int64) & ((1 << _M_CH) - 1)
    second = flags[:, 1] if flags.shape[1] == 2 else _ANY_FLAGS
    pairs, inverse = np.unique(flags[:, 0] << _M_CH | second, return_inverse=True)
    out = np.array([_pair_class(p >> _M_CH, p & ((1 << _M_CH) - 1)) for p in pairs.tolist()],
                   dtype=np.int64).reshape(-1, 5)[inverse.reshape(-1)]
    return out[:, 0], out[:, 1], out[:, 2:4], out[:, 4]


class RangeLaunch(NamedTuple):
    """One bsi_range launch: the kernel's parameter block, the caller's
    index of each of its queries in plan order, and the planes it reads
    (0 when none of its queries compares with them)."""

    param: bytes
    queries: np.ndarray
    depth: int


class RangePlan(NamedTuple):
    """A flight's launches and their block shape: ``dmax`` planes and
    ``vec`` words a thread (one of RANGE_CONFIGS), ``grid_x`` blocks of
    RANGE_THREADS threads a shard."""

    launches: tuple
    dmax: int
    vec: int
    grid_x: int


# each field's offset in 32-bit words of the parameter block
_PARAM_AT = {name: _RANGE_PARAM.fields[name][1] // 4 for name in _RANGE_PARAM.names}


def _range_param(table: np.ndarray, idx: np.ndarray, cls, swap, bounds, gen) -> tuple:
    """The parameter block (_RANGE_PARAM) of one launch of queries ``idx``
    (in plan order), and its mask rows."""
    P = np.zeros(_RANGE_PARAM.itemsize // 4, dtype=np.uint32)
    n = idx.size
    c = cls[idx]
    nb = _C_BOUNDS[c]
    key = c | swap[idx] << 8
    ends = np.append(np.flatnonzero(key[1:] != key[:-1]) + 1, n)  # at most 15 segments
    n_rows = int(nb.sum())
    P[:3] = ends.size, n, n_rows

    def put(name, values):
        at = _PARAM_AT[name]
        P[at : at + values.size] = values.ravel()

    put("seg_cls", key[ends - 1])
    put("seg_end", ends)
    put("row", (np.cumsum(nb) - nb) | nb << 16)
    put("dest", idx)
    put("gen", gen[idx])
    b = bounds[idx]  # [n, 2]
    entry = np.asarray(table)[idx[:, None], np.maximum(b, 0)].view(np.uint32)  # [n, 2, 3]
    has = b >= 0
    init = np.zeros((n, 2, 2), dtype=np.uint32)
    for j, channel in enumerate((_M_A0, _M_B0)):  # 0 or ~0: strict or not
        init[..., j] = np.where(has & ((entry[..., 0] >> channel) & 1).astype(bool),
                                0xFFFFFFFF, 0)
    put("init", init)
    put("mag", np.where(has[..., None], entry[..., 1:], 0))  # lo, hi words of each bound
    return P.tobytes(), n_rows


def range_plan(table: np.ndarray, depth: int, W: int, count: bool, *, vec: int = 4,
               chunks: int | None = None, config: tuple[int, int] | None = None) -> RangePlan:
    """The launches of bsi_range for bounds ``table`` over ``depth``
    planes of ``W`` words a shard: the queries sorted by composition class
    and sign selection (:func:`query_classes`), in launches of at most
    BSI_RANGE_MAX_Q queries and of masks that fit a block's shared memory;
    in count mode the ZERO queries are left out (their counts stay zero).
    ``vec``: the words a thread may load at once (:func:`_range_vec`);
    blocks of ``chunks`` (RANGE_BLOCK_CHUNKS) chunks each, ``config`` one
    of RANGE_CONFIGS (by default the first that holds the depth and the
    words a thread the layout allows)."""
    chunks = RANGE_BLOCK_CHUNKS if chunks is None else chunks
    if config is None:
        config = next(c for c in RANGE_CONFIGS
                      if depth <= c[0] and c[1] <= vec and W % c[1] == 0 or c[1] == 1)
    dmax, v = config
    if config not in RANGE_CONFIGS or depth > dmax or W % v or v > vec:
        raise ValueError(f"bsi_range: configuration {config} at depth {depth}, W {W}")
    cls, swap, bounds, gen = query_classes(table)
    keep = np.flatnonzero(cls != _C_ZERO) if count else np.arange(cls.size)
    order = keep[np.lexsort((keep, swap[keep], cls[keep]))]
    rows = np.cumsum(_C_BOUNDS[cls[order]])
    groups = -(-depth // 4)
    counters = 4 * _RANGE_PARAM_Q * (RANGE_THREADS // 32) if count else 0  # a row a warp
    row_cap = (_RANGE_SMEM - counters) // (16 * groups) if groups else 1 << 30
    per_launch = min(BSI_RANGE_MAX_Q, _RANGE_PARAM_Q)
    launches, start = [], 0
    while start < order.size:
        before = rows[start - 1] if start else 0
        end = min(start + per_launch, order.size,
                  max(start + 1, int(np.searchsorted(rows, before + row_cap, side="right"))))
        idx = order[start:end]
        param, n_rows = _range_param(table, idx, cls, swap, bounds, gen)
        launches.append(RangeLaunch(param, idx, depth if n_rows else 0))
        start = end
    n_chunks = -(-W // (RANGE_THREADS * v)) if W else 0
    grid_x = max(1, -(-n_chunks // chunks))
    return RangePlan(tuple(launches), dmax, v, grid_x)


def _range_vec(*ts) -> int:
    """The most words (4, 2 or 1) a thread may load or store at once: every
    row of the tensors ``ts`` starts aligned to that many words (W and the
    shard strides multiples of it)."""
    for v in (4, 2):
        if ts[0].shape[-1] % v == 0 and all(
                t.data_ptr() % (4 * v) == 0
                and not (t.dim() > 1 and t.shape[0] > 1 and t.stride(0) % v) for t in ts):
            return v
    return 1


def bsi_range(planes, exists, sign, table: np.ndarray, *, count: bool) -> torch.Tensor:
    """The predicates of bounds ``table`` (``int32[Q, B, 3]``, B 1 or 2,
    :func:`bounds_table`) over every column: per-shard match counts
    ``int32[Q, S]`` when ``count`` (exact: a shard holds at most 2^31 - 1
    columns), else the result words ``int32[Q, S, W]`` (one shard's
    operands: ``[Q]`` and ``[Q, W]``). On the card, one launch per plan
    launch (:func:`range_plan`), each query written to its own row.
    Sharded operands: the plan's launches once a slice, the outputs
    joined in shard order."""
    if _sh.is_sharded(planes):
        _sh.same_layout("bsi_range", planes, exists, sign)
        return _sh.cat(planes, _sh.per_slice(
            planes, lambda p, e, s: bsi_range(p, e, s, table, count=count), exists, sign), 1)
    planes, exists, sign, one = _operands("bsi_range", planes, exists, sign)
    table = np.ascontiguousarray(table, dtype=np.int32)
    if table.ndim != 3 or table.shape[1] not in (1, 2) or table.shape[2] != 3:
        raise ValueError(f"bsi_range: bounds table shape {table.shape}")
    if _cpu("bsi_range", planes, exists, sign):
        out = bsi_range_plain(planes, exists, sign, table, count)
    else:
        S, depth, W = planes.shape
        Q = table.shape[0]
        dev = planes.device
        shape = (Q, S) if count else (Q, S, W)
        out = (torch.zeros if count else torch.empty)(shape, dtype=torch.int32, device=dev)
        if Q and S and W:
            vec = _range_vec(planes, exists, sign, *(() if count else (out,)))
            plan = range_plan(table, depth, W, count, vec=vec)
            for launch in plan.launches:
                with kernels._launching("bsi_range", dev):
                    kernels._launch(
                        "pilosa_bsi_range", launch.param, len(launch.param),
                        planes.data_ptr(), planes.stride(0), exists.data_ptr(),
                        exists.stride(0), sign.data_ptr(), sign.stride(0), launch.depth,
                        S, W, plan.dmax, plan.vec, plan.grid_x, int(count),
                        out.data_ptr(), Q, dev.index, kernels._stream(dev),
                    )
    return out[:, 0] if one else out


def range_batch(planes, exists, sign, queries, *, depth: int) -> torch.Tensor:
    """Batched Range: ``int32[Q, S, W]`` result words for ``queries``
    (lists of bounds, see :func:`condition_bounds`), one bsi_range launch.
    JAX pads Q to a power of two; the kernel needs no padding, so the
    result has exactly Q slices."""
    planes, exists, sign, one = _operands("range_batch", planes, exists, sign, depth)
    out = bsi_range(planes, exists, sign, _queries_table(queries, depth), count=False)
    return out[:, 0] if one else out


def range_count_batch(planes, exists, sign, queries, *, depth: int) -> list[int]:
    """Batched Count(Range): per-query match counts, the per-shard int32
    partials summed in int64."""
    planes, exists, sign, _ = _operands("range_count_batch", planes, exists, sign, depth)
    counts = bsi_range(planes, exists, sign, _queries_table(queries, depth), count=True)
    return [int(c) for c in counts.sum(dim=1, dtype=torch.int64).tolist()]


def _range_one(name, planes, exists, sign, depth: int, table) -> torch.Tensor:
    """The result words of the one query of ``table``."""
    planes, exists, sign, one = _operands(name, planes, exists, sign, depth)
    out = bsi_range(planes, exists, sign, table, count=False)[0]
    return out[0] if one else out


def range_eq(planes, exists, sign, *, value_abs: int, negative: bool, depth: int):
    """Columns whose stored value == ±value_abs (reference fragment.go:1286)."""
    return _range_one("range_eq", planes, exists, sign, depth,
                      _eq_table(value_abs, negative, depth))


def range_lt(planes, exists, sign, *, value: int, depth: int, allow_eq: bool):
    """Columns with stored value < value (<= when allow_eq); the sign
    split of the reference's rangeLT (fragment.go:1378-1445)."""
    table = _queries_table([[("<=" if allow_eq else "<", int(value))]], depth)
    return _range_one("range_lt", planes, exists, sign, depth, table)


def range_gt(planes, exists, sign, *, value: int, depth: int, allow_eq: bool):
    """Columns with stored value > value (>= when allow_eq); reference
    fragment.go:1447-1514."""
    table = _queries_table([[(">=" if allow_eq else ">", int(value))]], depth)
    return _range_one("range_gt", planes, exists, sign, depth, table)


def range_between(planes, exists, sign, *, lo: int, hi: int, depth: int):
    """lo <= stored <= hi (reference fragment.go:1516-1534 rangeBetween)."""
    table = _queries_table([[(">=", int(lo)), ("<=", int(hi))]], depth)
    return _range_one("range_between", planes, exists, sign, depth, table)


# ---------------------------------------------------------------------------
# bsi_sum: per-shard plane popcounts under Q filters
# ---------------------------------------------------------------------------


def bsi_sum_plain(planes, exists, sign, filters) -> torch.Tensor:
    """Plain version of bsi_sum over stacked operands (``filters``
    ``[S, Q, W]``, or None for the exists row): ``int32[S, Q, depth+1, 2]``."""
    S, depth, W = planes.shape
    if filters is None:
        filters = exists[:, None, :]
    Q = filters.shape[1]
    out = torch.zeros((S, Q, depth + 1, 2), dtype=torch.int32, device=planes.device)
    for q in range(Q):
        f = exists & filters[:, q]
        pos, neg = f & ~sign, f & sign
        for k in range(depth):
            p = planes[:, k]
            out[:, q, k, 0] = bitops.count_rows(p & pos)
            out[:, q, k, 1] = bitops.count_rows(p & neg)
        out[:, q, depth, 0] = bitops.count_rows(pos)
        out[:, q, depth, 1] = bitops.count_rows(neg)
    return out


def bsi_sum(planes, exists, sign, filters=None) -> torch.Tensor:
    """Per-shard popcounts ``int32[S, Q, depth+1, 2]``: entry ``[s, q, k,
    c]`` counts the columns of plane k (k < depth), or every column (k =
    depth), within ``exists & filters[s, q]``, non-negative (c = 0) or
    negative (c = 1). ``filters`` is ``[S, Q, W]``, one filter ``[S, W]``,
    or None to count under the exists row alone (one shard: ``[Q, W]``,
    ``[W]``; the result keeps its shard axis of 1). Sharded operands: one
    launch a slice, joined in shard order."""
    if _sh.is_sharded(planes):
        _sh.same_layout("bsi_sum", planes, exists, sign)
        return _sh.cat(planes, _sh.per_slice(planes, bsi_sum, exists, sign, filters), 0)
    planes, exists, sign, one = _operands("bsi_sum", planes, exists, sign)
    S, depth, W = planes.shape
    if filters is not None:
        filters = _filters("bsi_sum", filters, S, W, one)
    if _cpu("bsi_sum", planes, exists, sign, filters):
        return bsi_sum_plain(planes, exists, sign, filters)
    dev = planes.device
    Q = 1 if filters is None else filters.shape[1]
    out = torch.zeros((S, Q, depth + 1, 2), dtype=torch.int32, device=dev)
    if not (Q and S and W):
        return out
    # unfiltered: the exists row is its own filter (f = exists & exists)
    f, f_s, f_q = (exists, exists.stride(0), 0) if filters is None else (
        filters, filters.stride(0), filters.stride(1))
    with kernels._launching("bsi_sum", dev):
        kernels._launch(
            "pilosa_bsi_sum", planes.data_ptr(), planes.stride(0), exists.data_ptr(),
            exists.stride(0), sign.data_ptr(), sign.stride(0), f.data_ptr(), f_s, f_q,
            Q, depth, S, W, out.data_ptr(), dev.index, kernels._stream(dev),
        )
    return out


def _place_value(pos: np.ndarray, neg: np.ndarray) -> int:
    """``sum_k (pos[k] - neg[k]) << k`` in Python ints."""
    return sum(int(c) << k for k, c in enumerate(pos.tolist())) - sum(
        int(c) << k for k, c in enumerate(neg.tolist())
    )


def sum_count(planes, exists, sign, filter_words, *, depth: int):
    """``(pos_counts[depth, S], neg_counts[depth, S], count[S])`` int32
    per-shard popcounts over ``exists & filter_words`` (one shard:
    ``[depth]``, ``[depth]``, scalar), as JAX's sum_count returns them."""
    planes, exists, sign, one = _operands("sum_count", planes, exists, sign, depth)
    if not _sh.is_sharded(planes):  # a sharded stack's wrapper cuts the filter
        filter_words = _filters("sum_count", filter_words, planes.shape[0], planes.shape[2], one)
    out = bsi_sum(planes, exists, sign, filter_words)
    pos = out[:, 0, :depth, 0].T
    neg = out[:, 0, :depth, 1].T
    count = out[:, 0, depth].sum(dim=1, dtype=torch.int32)
    if one:
        pos, neg, count = pos[:, 0], neg[:, 0], count[0]
    if not depth:  # JAX's shape for no planes
        pos = neg = torch.zeros((0,), dtype=torch.int32, device=out.device)
    return pos, neg, count


def sum_host(planes, exists, sign, filter_words, *, depth: int) -> tuple[int, int]:
    """Exact ``(sum of stored values, count)`` over ``exists &
    filter_words``, one bsi_sum launch and one copy to the host."""
    planes, exists, sign, one = _operands("sum_host", planes, exists, sign, depth)
    filt = filter_words if _sh.is_sharded(planes) else _filters(
        "sum_host", filter_words, planes.shape[0], planes.shape[2], one)
    acc = bsi_sum(planes, exists, sign, filt)[:, 0].to(torch.int64).sum(dim=0).cpu().numpy()
    return _place_value(acc[:depth, 0], acc[:depth, 1]), int(acc[depth].sum())


# ---------------------------------------------------------------------------
# bsi_sum_batch: a flight's filtered Sums in one launch, on the tensor cores
# ---------------------------------------------------------------------------

# int32 ceiling of one bsi_sum_batch launch's totals (JAX's fused Sum
# accumulator, the per-plane popcounts summed across shards on the device):
# past it, the wrapper launches shard chunks and sums them in int64
_SUM_BATCH_ACC_LIMIT = 2**31 - 1
# the deepest field bsi_sum_batch takes (bsi_sum's limit)
BSI_SUM_BATCH_MAX_DEPTH = 64


def sum_batch_supported(S: int, W: int) -> bool:
    """Whether one bsi_sum_batch launch may take the whole stack (JAX's
    decline gate: its accumulator holds S * W * 32 columns in int32)."""
    return S * W * 32 <= _SUM_BATCH_ACC_LIMIT


def _filter_rows(name: str, filt_bits, filt_idx, S: int, W: int, one: bool):
    """``(int32[S, R, W] operand, int32 numpy index)``: the operand's
    shard and row strides are free, its words contiguous; each index is a
    row of it or -1 (a zero row)."""
    if isinstance(filt_bits, torch.Tensor) and one and filt_bits.dim() == 2:
        filt_bits = filt_bits[None]
    _check_rows(name, filt_bits, 3)
    if filt_bits.shape[0] != S or filt_bits.shape[2] != W:
        raise ValueError(f"{name}: filter shape {tuple(filt_bits.shape)} against {(S, W)}")
    idx = np.asarray(filt_idx, dtype=np.int64).reshape(-1)
    R = filt_bits.shape[1]
    if idx.size and (idx.min() < -1 or idx.max() >= R):
        raise ValueError(f"{name}: filter index out of range [-1, {R})")
    return filt_bits, idx.astype(np.int32)


def bsi_sum_batch_plain(planes, exists, sign, filt_bits, filt_idx) -> torch.Tensor:
    """Plain version of bsi_sum_batch over stacked operands: ``int64[depth
    + 1, 2, Q]``, the sign-split rows ANDed with every live filter and
    counted, a few filters at a time."""
    S, depth, W = planes.shape
    idx = np.asarray(filt_idx, dtype=np.int64).reshape(-1)
    dev = planes.device
    out = torch.zeros((depth + 1, 2, idx.size), dtype=torch.int64, device=dev)
    live = np.flatnonzero(idx >= 0)
    if not (live.size and S and W):
        return out
    classes = (exists & ~sign, exists & sign)
    for c0 in range(0, live.size, 8):
        sel = live[c0:c0 + 8]
        f = filt_bits.index_select(1, torch.from_numpy(idx[sel]).to(dev))  # [S, L, W]
        cols = torch.from_numpy(sel).to(dev)
        for k in range(depth + 1):
            for c, m in enumerate(classes):
                a = m if k == depth else planes[:, k] & m
                n = bitops.popcount(a[:, None, :] & f).sum(dim=(0, 2), dtype=torch.int64)
                out[k, c].index_copy_(0, cols, n)
    return out


def _sum_batch_launch(planes, exists, sign, filt_bits, idx: np.ndarray) -> torch.Tensor:
    """One bsi_sum_batch launch (the plain version on the CPU): int64
    totals of a shard chunk whose totals fit int32."""
    if _cpu("bsi_sum_batch", planes, exists, sign, filt_bits):
        return bsi_sum_batch_plain(planes, exists, sign, filt_bits, idx)
    S, depth, W = planes.shape
    dev = planes.device
    out = torch.zeros((depth + 1, 2, idx.size), dtype=torch.int32, device=dev)
    if not (idx.size and S and W):
        return out.to(torch.int64)
    reads = [exists, sign, filt_bits] + ([planes] if depth else [])
    # 16-byte copies: every row aligned at every shard
    vec16 = (W % 4 == 0 and filt_bits.stride(1) % 4 == 0
             and all(t.data_ptr() % 16 == 0 and t.stride(0) % 4 == 0 for t in reads))
    dev_idx = kernels._upload(idx.tobytes(), dev)  # from pinned memory, no wait
    with kernels._launching("bsi_sum_batch", dev):
        kernels._launch(
            "pilosa_bsi_sum_batch", planes.data_ptr(), planes.stride(0), W,
            exists.data_ptr(), exists.stride(0), sign.data_ptr(), sign.stride(0),
            filt_bits.data_ptr(), filt_bits.stride(0), filt_bits.stride(1),
            dev_idx.data_ptr(), idx.size, depth, S, W, int(vec16), out.data_ptr(),
            dev.index, kernels._stream(dev),
        )
    return out.to(torch.int64)


def bsi_sum_batch(planes, exists, sign, filt_bits, filt_idx) -> torch.Tensor:
    """Every filtered Sum of a flight at once: ``int64[depth + 1, 2, Q]``
    totals over the shards, entry ``[k, c, q]`` counting the columns of
    plane k (k < depth), or every column (k = depth), within ``exists &
    filter_q``, non-negative (c = 0) or negative (c = 1). Filter q is row
    ``filt_idx[q]`` of ``filt_bits`` (``int32[S, R, W]``, read in place
    through its shard and row strides, so the rows of a resident stack or
    an ``[S, Q, W]`` tensor alike), a zero row where the index is -1. One
    launch while ``S * W * 32`` fits int32, else one per shard chunk,
    summed in int64. Sharded operands: one launch a slice (the filter
    operand sharded alike, or a tensor over the logical shard axis, cut at
    the stack's bounds), the totals summed in int64."""
    if _sh.is_sharded(planes):
        _sh.same_layout("bsi_sum_batch", planes, exists, sign)
        return _sh.total(planes, _sh.per_slice(
            planes, lambda p, e, s, f: bsi_sum_batch(p, e, s, f, filt_idx),
            exists, sign, filt_bits))
    planes, exists, sign, one = _operands("bsi_sum_batch", planes, exists, sign)
    S, depth, W = planes.shape
    if depth > BSI_SUM_BATCH_MAX_DEPTH:
        raise ValueError(f"bsi_sum_batch: depth {depth} over {BSI_SUM_BATCH_MAX_DEPTH}")
    filt_bits, idx = _filter_rows("bsi_sum_batch", filt_bits, filt_idx, S, W, one)
    chunk = max(S, 1) if sum_batch_supported(S, W) else max(1, _SUM_BATCH_ACC_LIMIT // (W * 32))
    total = None
    for s0 in range(0, max(S, 1), chunk):
        s1 = s0 + chunk
        part = _sum_batch_launch(planes[s0:s1], exists[s0:s1], sign[s0:s1],
                                 filt_bits[s0:s1], idx)
        total = part if total is None else total + part
    return total


def sum_batch_host(planes, exists, sign, filters, *, depth: int, idx=None
                   ) -> list[tuple[int, int]]:
    """Batched Sum: ``[(sum, count), ...]`` per filter, one bsi_sum_batch
    launch (one per shard chunk past the int32 totals). ``filters`` is
    ``[S, Q, W]`` (pass exists rows for unfiltered queries), or with
    ``idx`` the operand whose rows ``idx`` (-1: none) are the filters; the
    place-value combine in Python ints, so totals past 2^63 stay exact."""
    planes, exists, sign, one = _operands("sum_batch_host", planes, exists, sign, depth)
    if one and filters.dim() == 2:
        filters = filters[None]
    if idx is None:
        idx = np.arange(filters.shape[1])
    acc = bsi_sum_batch(planes, exists, sign, filters, idx).cpu().numpy()
    return [
        (_place_value(acc[:depth, 0, q], acc[:depth, 1, q]), int(acc[depth, :, q].sum()))
        for q in range(acc.shape[2])
    ]


# ---------------------------------------------------------------------------
# bsi_extreme: Min/Max narrowing per shard and slice
# ---------------------------------------------------------------------------

# words per bsi_extreme block (256 threads x 8 words)
BSI_EXTREME_SLICE = 2048


def _sliced(t: torch.Tensor, n: int) -> torch.Tensor:
    """``[S, W]`` -> ``[S, n, BSI_EXTREME_SLICE]``, zero-padded."""
    S, W = t.shape
    return F.pad(t, (0, n * BSI_EXTREME_SLICE - W)).reshape(S, n, BSI_EXTREME_SLICE)


def bsi_extreme_plain(planes, exists, sign, filt, maximal: bool) -> torch.Tensor:
    """Plain version of bsi_extreme over stacked operands: ``int64[S, n,
    6]``, one entry per slice of BSI_EXTREME_SLICE words."""
    S, depth, W = planes.shape
    n = -(-W // BSI_EXTREME_SLICE)
    f = exists if filt is None else exists & filt
    neg, non = f & sign, f & ~sign
    a, b = (_sliced(non, n), _sliced(neg, n)) if maximal else (_sliced(neg, n), _sliced(non, n))
    has_a, has_b = (a != 0).any(dim=-1), (b != 0).any(dim=-1)
    mag_a = torch.zeros((S, n), dtype=torch.int64, device=planes.device)
    mag_b = torch.zeros_like(mag_a)
    for k in reversed(range(depth)):
        p = _sliced(planes[:, k], n)
        ha, hb = a & p, b & ~p
        any_a, any_b = (ha != 0).any(dim=-1), (hb != 0).any(dim=-1)
        a = torch.where(any_a[..., None], ha, a)
        b = torch.where(any_b[..., None], hb, b)
        mag_a |= any_a.to(torch.int64) << k
        mag_b |= (~any_b).to(torch.int64) << k
    cnt_a = bitops.popcount(a).sum(dim=-1, dtype=torch.int64)
    cnt_b = bitops.popcount(b).sum(dim=-1, dtype=torch.int64)
    return torch.stack([
        has_a.to(torch.int64), has_b.to(torch.int64),
        torch.where(has_a, mag_a, 0), cnt_a,
        torch.where(has_b, mag_b, 0), cnt_b,
    ], dim=-1)


def bsi_extreme(planes, exists, sign, filt=None, *, maximal: bool) -> torch.Tensor:
    """Both sign branches of Min/Max per shard and slice of
    BSI_EXTREME_SLICE words, within ``exists & filt`` (None: exists):
    ``int64[S, n, 6]`` rows ``(has_a, has_b, mag_a, cnt_a, mag_b, cnt_b)``.
    Branch a is the non-negative columns for Max and the negative ones for
    Min, narrowed to its largest magnitude; branch b the other class,
    narrowed to its smallest. ``cnt`` counts the slice's columns at that
    magnitude; a slice without candidates has magnitude and count 0.
    Sharded operands: one launch a slice, joined in shard order, so that
    :func:`extreme_combine` narrows every slice's candidates at once."""
    if _sh.is_sharded(planes):
        _sh.same_layout("bsi_extreme", planes, exists, sign)
        return _sh.cat(planes, _sh.per_slice(
            planes, lambda p, e, s, f: bsi_extreme(p, e, s, f, maximal=maximal),
            exists, sign, filt), 0)
    planes, exists, sign, one = _operands("bsi_extreme", planes, exists, sign)
    S, depth, W = planes.shape
    if filt is not None:
        filt = _filters("bsi_extreme", filt, S, W, one)
        if filt.shape[1] != 1:
            raise ValueError("bsi_extreme: one filter per shard")
        filt = filt[:, 0]
    if _cpu("bsi_extreme", planes, exists, sign, filt):
        return bsi_extreme_plain(planes, exists, sign, filt, maximal)
    dev = planes.device
    n = -(-W // BSI_EXTREME_SLICE)
    out = torch.zeros((S, n, 6), dtype=torch.int64, device=dev)
    if not (S and n):
        return out
    f, f_s = (exists, exists.stride(0)) if filt is None else (filt, filt.stride(0))
    with kernels._launching("bsi_extreme", dev):
        kernels._launch(
            "pilosa_bsi_extreme", planes.data_ptr(), planes.stride(0), exists.data_ptr(),
            exists.stride(0), sign.data_ptr(), sign.stride(0), f.data_ptr(), f_s,
            depth, S, W, int(maximal), out.data_ptr(), dev.index, kernels._stream(dev),
        )
    return out


def extreme_combine(rows: np.ndarray, maximal: bool) -> tuple[int, int]:
    """``(stored value, count)`` from bsi_extreme rows (any leading shape):
    branch a's largest magnitude when any row has candidates there, else
    branch b's smallest, with the counts of the rows that reach it summed;
    ``(0, 0)`` with no candidates. Each row's extreme is its slice's, so
    this is the narrowing over all of them at once."""
    r = np.asarray(rows, dtype=np.int64).reshape(-1, 6)
    has_a, has_b = r[:, 0] != 0, r[:, 1] != 0
    if has_a.any():
        mag = int(r[has_a, 2].max())
        cnt = int(r[has_a & (r[:, 2] == mag), 3].sum())
        return (mag if maximal else -mag), cnt
    if has_b.any():
        mag = int(r[has_b, 4].min())
        cnt = int(r[has_b & (r[:, 4] == mag), 5].sum())
        return (-mag if maximal else mag), cnt
    return 0, 0


def min_max_host(planes, exists, sign, filter_words, *, depth: int, maximal: bool):
    """Min/Max (reference fragment.go:1152-1225 minUnsigned/maxUnsigned
    with the sign split): ``(stored value, count)``, or ``(0, 0)`` when no
    column of ``exists & filter_words`` holds a value. One bsi_extreme
    launch and one copy of its rows to the host; magnitudes are exact to
    depth 63."""
    planes, exists, sign, one = _operands("min_max_host", planes, exists, sign, depth)
    if one and filter_words is not None:
        filter_words = filter_words[None]  # the shard axis the operands gained
    rows = bsi_extreme(planes, exists, sign, filter_words, maximal=maximal)
    return extreme_combine(rows.cpu().numpy(), maximal)


def extreme_mag(planes, candidates, *, depth: int, maximal: bool):
    """``(magnitude, surviving candidate words)`` of the largest (or
    smallest) magnitude among ``candidates``, narrowed across every shard
    at once; ``(0, candidates)`` when there are none. The magnitude is a
    Python int, exact to depth 63 (JAX's int32 keeps bits 0-30)."""
    c = candidates
    nonempty = bool((c != 0).any())
    mag = 0
    for k in reversed(range(depth)):
        p = planes[..., k, :]
        hit = c & (p if maximal else ~p)
        any_hit = bool((hit != 0).any())
        if any_hit:
            c = hit
        if any_hit == maximal:
            mag |= 1 << k
    return (mag if nonempty else 0), c
