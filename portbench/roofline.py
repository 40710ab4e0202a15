"""The yardstick's arithmetic: the card's peak, each measured kernel's
least bytes per launch (from ``chip_smoke.py``'s ``b_cross_of``,
``tree_bound``, ``bsi_sum_batch_bound`` and ``bsi_range_bound``, bytes
only), and the union of device intervals (``busy_union_us``).

A launch's least time is the bytes its operands need at the peak rate:
each distinct input row read once and each output written once, at the
stack's S and W. Nothing here imports the program: the functions take
shapes and host index arrays.
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM, data sheet: HBM3 bandwidth
PEAK_BYTES_PER_S = 3.35e12


def least_seconds(nbytes: int) -> float:
    return nbytes / PEAK_BYTES_PER_S


def cross_gram_bytes(S: int, W: int, ua: int, ub: int) -> int:
    """One cross-gram launch: ``ua`` and ``ub`` distinct rows read once,
    both index arrays read and the ``[ua, ub]`` int32 output written."""
    return (ua + ub) * S * W * 4 + (ua + ub) * 4 + ua * ub * 4


def tree_count_bytes(S: int, W: int, distinct_rows: int, B: int) -> int:
    """One tree-count launch over ``B`` items: the distinct rows its items
    name read once, ``[B, S]`` int32 counts written."""
    return distinct_rows * S * W * 4 + B * S * 4


def tree_distinct_rows(stack_ids, leaf_stack, slots) -> int:
    """Distinct (stack, row) pairs that ``slots`` (``[B, L]``, negative:
    absent) name through ``leaf_stack`` (leaf -> stack); ``stack_ids``
    identifies each stack's storage, so a tensor passed twice counts its
    rows once."""
    slots = np.asarray(slots).reshape(-1, len(leaf_stack))
    rows = set()
    for leaf, p in enumerate(np.asarray(leaf_stack).tolist()):
        col = np.unique(slots[:, leaf])
        rows.update((stack_ids[p], int(r)) for r in col if r >= 0)
    return len(rows)


def bsi_sum_batch_bytes(S: int, depth: int, W: int, filters: int, Q: int) -> int:
    """One batched-Sum launch: the stack (exists, sign, ``depth`` planes)
    and ``filters`` distinct filter rows read once, the ``(depth + 1) x 2
    x Q`` int32 totals written."""
    return S * (2 + depth) * W * 4 + filters * S * W * 4 + (depth + 1) * 2 * Q * 4


def bsi_range_bytes(S: int, depth: int, W: int, table_bytes: int, Q: int, count: bool) -> int:
    """One range scan over ``Q`` queries: the stack and the bounds table
    read once, ``[Q, S]`` counts or ``[Q, S, W]`` words written."""
    return S * (2 + depth) * W * 4 + table_bytes + (Q * S * 4 if count else Q * S * W * 4)


def busy_union(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``(start, end)`` intervals clipped to
    ``[lo, hi]``."""
    total, end = 0.0, lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def idle_gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The gaps of ``[lo, hi]`` that no interval covers, in time order."""
    gaps, end = [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if hi > end:
        gaps.append((end, hi))
    return gaps
