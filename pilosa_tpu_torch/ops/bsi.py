"""Bit-sliced-index (BSI) integer fields (counterpart of
``pilosa_tpu/ops/bsi.py``).

An int field stores each value bit-sliced (reference fragment.go:90-96):
an exists row, a sign row and ``depth`` magnitude planes, LSB first.
Values are offset from the field's base, sign/magnitude: stored = value -
base, the sign row holds stored < 0 and the planes hold abs(stored).

Three hand-written CUDA kernels (``ops/csrc/bsi.cu``) replace the XLA
programs of the JAX package, none of which is a Pallas kernel:

* **bsi_range** (:func:`bsi_range`) evaluates ``Q`` encoded range
  predicates (:func:`encode_query_bounds`) in one pass over the planes,
  as per-shard counts ``int32[Q, S]`` or result words ``int32[Q, S, W]``.
  It answers :func:`range_batch` and :func:`range_count_batch`, and
  through them every single condition (:func:`range_eq`,
  :func:`range_lt`, :func:`range_gt`, :func:`range_between`).
* **bsi_sum** (:func:`bsi_sum`) writes per shard the popcounts
  ``int32[S, Q, depth+1, 2]`` of every plane ANDed with ``exists & filter_q``
  and split by sign, plus the exists counts; :func:`sum_count`,
  :func:`sum_host` and :func:`sum_batch_host` combine them on the host in
  Python ints, so totals past 2^63 stay exact.
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

import numpy as np
import torch
import torch.nn.functional as F

from pilosa_tpu_torch.ops import bitops, kernels

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


def table_need(table: np.ndarray) -> tuple[bool, bool]:
    """Which borrow accumulators any bound of a table reads."""
    lo, hi = table_sides(table)
    return bool(lo.any()), bool(hi.any())


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
    and ``planes`` is cut to its first ``depth`` planes."""
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

# queries per count-mode launch: the kernel keeps one shared counter each
BSI_RANGE_MAX_Q = 1024
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


def _upload_table(table: np.ndarray, device) -> torch.Tensor:
    return kernels._upload(np.ascontiguousarray(table, np.int32).tobytes(), device)


def bsi_range(planes, exists, sign, table: np.ndarray, *, count: bool) -> torch.Tensor:
    """The predicates of bounds ``table`` (``int32[Q, B, 3]``, B 1 or 2,
    :func:`bounds_table`) over every column: per-shard match counts
    ``int32[Q, S]`` when ``count`` (exact: a shard holds at most 2^31 - 1
    columns), else the result words ``int32[Q, S, W]`` (one shard's
    operands: ``[Q]`` and ``[Q, W]``)."""
    planes, exists, sign, one = _operands("bsi_range", planes, exists, sign)
    table = np.ascontiguousarray(table, dtype=np.int32)
    if table.ndim != 3 or table.shape[1] not in (1, 2) or table.shape[2] != 3:
        raise ValueError(f"bsi_range: bounds table shape {table.shape}")
    if _cpu("bsi_range", planes, exists, sign):
        out = bsi_range_plain(planes, exists, sign, table, count)
    else:
        S, depth, W = planes.shape
        Q, NB, _ = table.shape
        dev = planes.device
        shape = (Q, S) if count else (Q, S, W)
        out = (torch.zeros if count else torch.empty)(shape, dtype=torch.int32, device=dev)
        if Q and S and W:
            need_lo, need_hi = table_need(table)
            step = BSI_RANGE_MAX_Q if count else Q
            for q0 in range(0, Q, step):
                part = table[q0 : q0 + step]
                tab = _upload_table(part, dev)
                kernels._launch(
                    "pilosa_bsi_range", planes.data_ptr(), planes.stride(0),
                    exists.data_ptr(), exists.stride(0), sign.data_ptr(), sign.stride(0),
                    tab.data_ptr(), len(part), NB, int(need_lo), int(need_hi), int(count),
                    depth, S, W, out[q0:].data_ptr(), dev.index, kernels._stream(dev),
                )
                kernels.LAUNCHES["bsi_range"] += 1
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
    ``[W]``; the result keeps its shard axis of 1)."""
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
    kernels._launch(
        "pilosa_bsi_sum", planes.data_ptr(), planes.stride(0), exists.data_ptr(),
        exists.stride(0), sign.data_ptr(), sign.stride(0), f.data_ptr(), f_s, f_q,
        Q, depth, S, W, out.data_ptr(), dev.index, kernels._stream(dev),
    )
    kernels.LAUNCHES["bsi_sum"] += 1
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
    out = bsi_sum(planes, exists, sign, _filters("sum_count", filter_words,
                                                 planes.shape[0], planes.shape[2], one))
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
    filt = _filters("sum_host", filter_words, planes.shape[0], planes.shape[2], one)
    acc = bsi_sum(planes, exists, sign, filt)[:, 0].to(torch.int64).sum(dim=0).cpu().numpy()
    return _place_value(acc[:depth, 0], acc[:depth, 1]), int(acc[depth].sum())


# int32 ceiling of JAX's fused Sum accumulator (per-plane popcounts summed
# across shards on the device); the port's counts stay per shard, so no
# caller of the port gates on it
_SUM_BATCH_ACC_LIMIT = 2**31 - 1


def sum_batch_supported(S: int, W: int) -> bool:
    """Whether the batched Sum may take the whole stack at once (JAX's
    decline gate: its accumulator holds S * W * 32 columns in int32)."""
    return S * W * 32 <= _SUM_BATCH_ACC_LIMIT


def sum_batch_host(planes, exists, sign, filters, *, depth: int) -> list[tuple[int, int]]:
    """Batched Sum: ``[(sum, count), ...]`` per filter of ``filters``
    (``[S, Q, W]``; pass exists rows for unfiltered queries), one bsi_sum
    launch; the place-value combine in Python ints."""
    planes, exists, sign, one = _operands("sum_batch_host", planes, exists, sign, depth)
    if one:
        filters = filters[None]
    acc = bsi_sum(planes, exists, sign, filters).to(torch.int64).sum(dim=0).cpu().numpy()
    return [
        (_place_value(a[:depth, 0], a[:depth, 1]), int(a[depth].sum())) for a in acc
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
    magnitude; a slice without candidates has magnitude and count 0."""
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
    kernels._launch(
        "pilosa_bsi_extreme", planes.data_ptr(), planes.stride(0), exists.data_ptr(),
        exists.stride(0), sign.data_ptr(), sign.stride(0), f.data_ptr(), f_s,
        depth, S, W, int(maximal), out.data_ptr(), dev.index, kernels._stream(dev),
    )
    kernels.LAUNCHES["bsi_extreme"] += 1
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
    planes, exists, sign, _ = _operands("min_max_host", planes, exists, sign, depth)
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
