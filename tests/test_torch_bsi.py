"""The port's ``ops/bsi.py`` and its BSI storage against ``pilosa_tpu`` on
the CPU.

Every function of ``pilosa_tpu_torch/ops/bsi.py`` that has a JAX namesake
is held to it exactly, on the same seeded numpy stacks: the bounds of
each condition op, the encoded flights (Q = 1, 3 and 5, JAX's pow2
padding inert), the single conditions, the batched ranges, the sums and
Min/Max, at depths 0, 1, 20, 40 and 63 with signed and out-of-range
bounds and empty candidate sets. The bounds table that the range kernel
reads (``bounds_table``) is decoded in numpy and evaluated with the
kernel's own recurrence, against JAX. The extreme kernel's per-slice rows,
combined by the host code the card path uses, equal JAX's narrowing
across all shards, also where the shards' extremes differ. The kernels
themselves are held to these plain versions on the card in
``tests/test_torch_cuda.py``.
"""

# the port's lock witness, installed before the port is imported so that its
# module-level locks are wrapped too (pilosa_tpu_torch/testing/lockwitness.py)
from pilosa_tpu_torch.testing import lockwitness as port_lockwitness

port_lockwitness.install()
# the module fixture that asserts no new inversion among the port's locks
from pilosa_tpu_torch.testing.lockwitness import no_new_inversion  # noqa: F401

import numpy as np
import pytest
import torch

from pilosa_tpu.core import field as jfield
from pilosa_tpu.core import fragment as jfragment
from pilosa_tpu.ops import bsi as jb
from pilosa_tpu_torch.core import field as tfield
from pilosa_tpu_torch.core import fragment as tfragment
from pilosa_tpu_torch.ops import bsi as tb
from pilosa_tpu_torch.ops import kernels as tk

DEPTHS = [0, 1, 20, 40, 63]
CMPS = ["<", "<=", ">", ">=", "==", "!="]


def _words(rng, *shape) -> np.ndarray:
    return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _stack(rng, S, depth, W):
    """(planes, exists, sign) uint32: random planes and signs, about three
    quarters of the columns holding a value."""
    planes = _words(rng, S, depth, W)
    exists = _words(rng, S, W) | _words(rng, S, W)
    sign = _words(rng, S, W)
    return planes, exists, sign


def _bound(rng, depth, oob_share=0.15):
    """A signed stored bound: in band mostly, out of band sometimes."""
    lim = 1 << depth
    if rng.random() < oob_share:
        mag = lim + int(rng.integers(0, 3))
    elif depth == 0:
        mag = 0
    else:
        mag = int(rng.integers(0, 2**62)) % lim
    return -mag if rng.random() < 0.4 else mag


def _queries(rng, n, depth):
    """``n`` bound lists: every comparison, two-bound ranges, "any"."""
    out = []
    for k in range(n):
        r = k % 4
        if r == 0:
            out.append([(CMPS[int(rng.integers(0, 6))], _bound(rng, depth))])
        elif r == 1:
            lo, hi = sorted((_bound(rng, depth), _bound(rng, depth)))
            out.append([(">=", lo), ("<=", hi)])
        elif r == 2:
            out.append([(CMPS[int(rng.integers(0, 6))], _bound(rng, depth)),
                        (CMPS[int(rng.integers(0, 6))], _bound(rng, depth))])
        else:
            out.append([("any", 0)] if rng.random() < 0.3 else [("!=", _bound(rng, depth))])
    return out


# -- bounds -----------------------------------------------------------------


@pytest.mark.parametrize("op,value", [
    ("<", 5), ("<=", -5), (">", 0), (">=", 7), ("==", -3), ("!=", 4), ("!=", None),
    ("><", [-4, 9]), ("<x<", [1, 8]), ("<=x<", [-2, 8]), ("<x<=", [1, -8]),
    ("<=x<=", [3, 3]),
])
def test_condition_bounds_match_jax(op, value):
    assert tb.condition_bounds(op, value) == jb.condition_bounds(op, value)


@pytest.mark.parametrize("op,value", [("==", None), ("<", None), ("~", 3), ("x", [1, 2])])
def test_condition_bounds_refuse_as_jax_does(op, value):
    with pytest.raises((ValueError, TypeError)) as want:
        jb.condition_bounds(op, value)
    with pytest.raises(want.type):
        tb.condition_bounds(op, value)


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("Q,pad", [(1, None), (3, 4), (5, 8), (5, None)])
def test_encode_query_bounds_matches_jax(depth, Q, pad):
    rng = np.random.default_rng(depth * 10 + Q)
    queries = _queries(rng, Q, depth)
    got = tb.encode_query_bounds(queries, depth, q_pad=pad)
    want = jb.encode_query_bounds(queries, depth, q_pad=pad)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    assert got[3] == want[3]


@pytest.mark.parametrize("queries,pad", [
    ([[("<", 1)]] * 3, 2), ([[]], None), ([[("<", 1)] * 3], None), ([[("~", 1)]], None),
])
def test_encode_query_bounds_refuses_as_jax_does(queries, pad):
    with pytest.raises(ValueError):
        jb.encode_query_bounds(queries, 8, q_pad=pad)
    with pytest.raises(ValueError):
        tb.encode_query_bounds(queries, 8, q_pad=pad)


def _emulate_table(planes, exists, sign, table) -> np.ndarray:
    """The bounds table read entry by entry, as the range plan reads it:
    flags and the two magnitude halves per bound, each plane folded into
    the borrow accumulators with the kernel's three-input functions, the
    flag channels composed as JAX composes them; uint32 ``[Q, S, W]``
    words."""
    ones = np.uint32(0xFFFFFFFF)
    neg, non = exists & sign, exists & ~sign
    out = []
    for q in range(table.shape[0]):
        r = np.full(exists.shape, ones)
        for b in range(table.shape[1]):
            flags = int(table[q, b, 0])
            mag = (int(table[q, b, 1]) & 0xFFFFFFFF) | ((int(table[q, b, 2]) & 0xFFFFFFFF) << 32)

            def m(c):
                return ones if (flags >> c) & 1 else np.uint32(0)

            A = np.full(exists.shape, m(0))
            B = np.full(exists.shape, m(1))
            for k in range(planes.shape[1]):
                p = planes[:, k]
                bm = ones if (mag >> k) & 1 else np.uint32(0)
                A = (~p & (A | bm)) | (A & bm)
                B = (p & (B | ~bm)) | (B & ~bm)
            A, B = A | m(2), B & ~m(2)
            term = m(7) ^ ((m(8) & A) | (m(9) & B) | (m(10) & A & B))
            sel = (m(5) & neg) | (m(6) & non)
            r &= (m(3) & neg) | (m(4) & non) | (sel & term)
        out.append(r)
    return np.stack(out)


@pytest.mark.parametrize("depth", DEPTHS)
def test_bounds_table_read_as_the_kernel_reads_it_matches_jax(depth):
    rng = np.random.default_rng(100 + depth)
    planes, exists, sign = _stack(rng, 3, depth, 40)
    queries = _queries(rng, 11, depth)
    qmask, _, qmeta, need = tb.encode_query_bounds(queries, depth)
    table = tb.bounds_table(qmask, qmeta)
    assert table.shape == (11, 2, 3) and table.dtype == np.int32
    lo, hi = tb.table_sides(table)
    assert (bool(lo.any()), bool(hi.any())) == need
    got = _emulate_table(planes, exists, sign, table)
    want = np.asarray(jb.range_batch(planes, exists, sign, queries, depth=depth))[:11]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        _np(tb.bsi_range_plain(_t(planes), _t(exists), _t(sign), table, False)), want)


# -- the batched ranges -----------------------------------------------------


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("Q", [1, 3, 5])
def test_range_batch_and_counts_match_jax(depth, Q):
    rng = np.random.default_rng(depth + 7 * Q)
    planes, exists, sign = _stack(rng, 4, depth, 33)
    queries = _queries(rng, Q, depth)
    before = dict(tk.LAUNCHES)
    got = tb.range_batch(_t(planes), _t(exists), _t(sign), queries, depth=depth)
    want = np.asarray(jb.range_batch(planes, exists, sign, queries, depth=depth))
    assert got.shape == (Q, 4, 33) and want.shape[0] >= Q  # JAX pads to a pow2
    np.testing.assert_array_equal(_np(got), want[:Q])
    assert tb.range_count_batch(_t(planes), _t(exists), _t(sign), queries, depth=depth) == (
        jb.range_count_batch(planes, exists, sign, queries, depth=depth))
    # one shard, [depth, W] operands
    got1 = tb.range_batch(_t(planes[2]), _t(exists[2]), _t(sign[2]), queries, depth=depth)
    np.testing.assert_array_equal(_np(got1), want[:Q, 2])
    assert tk.LAUNCHES == before  # CPU tensors: the plain versions, no launch


@pytest.mark.parametrize("depth", [1, 20, 63])
def test_pow2_padding_rows_select_nothing(depth):
    rng = np.random.default_rng(depth)
    planes, exists, sign = _stack(rng, 2, depth, 20)
    queries = _queries(rng, 5, depth)
    qmask, _, qmeta, _ = tb.encode_query_bounds(queries, depth, q_pad=8)
    table = tb.bounds_table(qmask, qmeta)
    words = tb.bsi_range(_t(planes), _t(exists), _t(sign), table, count=False)
    counts = tb.bsi_range(_t(planes), _t(exists), _t(sign), table, count=True)
    assert not words[5:].any() and not counts[5:].any()
    np.testing.assert_array_equal(
        _np(words[:5]), np.asarray(jb.range_batch(planes, exists, sign, queries, depth=depth))[:5])


# -- the range kernel's launch plan -------------------------------------------


# the accumulators each composition class reads (bsi.cu bsi_lo0, bsi_hi0,
# bsi_lo1, bsi_hi1): (A, B, A1, B1)
_C_SIDES = ((0, 0, 0, 0), (0, 0, 0, 0), (1, 0, 0, 0), (0, 1, 0, 0), (1, 1, 0, 0), (1, 1, 0, 0),
            (0, 1, 1, 0), (1, 0, 1, 0), (1, 1, 0, 0), (1, 1, 1, 1))


def _emulate_plan(plan, planes, exists, sign, Q, count) -> np.ndarray:
    """The launches of a range plan read back as ``ops/csrc/bsi.cu`` reads
    them: each launch's parameter block decoded, each bound's magnitude
    expanded into full-word masks in groups of four planes (zero planes
    and zero bits past the depth), each segment's queries folded with its
    class's sides and epilogue against its sign selection, and each result
    written to its query's row in the caller's order (every row once).
    int64 ``[Q, S]`` counts or uint32 ``[Q, S, W]`` words."""
    ones = np.uint32(0xFFFFFFFF)
    S, _, W = planes.shape
    out = np.zeros((Q, S) if count else (Q, S, W), dtype=np.int64 if count else np.uint32)
    seen = np.zeros(Q, dtype=int)
    neg, non = exists & sign, exists & ~sign
    zero = np.zeros_like(neg)

    def tt(t, a, b):
        w = [ones if (t >> j) & 1 else np.uint32(0) for j in range(4)]
        return (b & ((a & w[3]) | (~a & w[2]))) | (~b & ((a & w[1]) | (~a & w[0])))

    for launch in plan.launches:
        P = np.frombuffer(launch.param, dtype=tb._RANGE_PARAM)[0]
        planes_k = [planes[:, k] for k in range(launch.depth)]
        planes_k += [zero] * (-launch.depth % 4)
        q0 = 0
        for g in range(int(P["n_seg"])):
            cls, swap = int(P["seg_cls"][g]) & 0xFF, int(P["seg_cls"][g]) >> 8
            sel, fil = (neg, non) if swap else (non, neg)
            lo0, hi0, lo1, hi1 = _C_SIDES[cls]
            for i in range(q0, int(P["seg_end"][g])):
                row, nb = int(P["row"][i]) & 0xFFFF, int(P["row"][i]) >> 16
                assert nb == tb._C_BOUNDS[cls] and row + nb <= int(P["n_rows"])
                A, B, A1, B1 = (np.full_like(neg, w) for w in P["init"][i])
                for k, p in enumerate(planes_k):
                    m = [ones if (int(P["mag"][i, j]) >> k) & 1 else np.uint32(0)
                         for j in range(2)]
                    A = (~p & (A | m[0])) | (A & m[0]) if lo0 else A
                    B = (p & (B | ~m[0])) | (B & ~m[0]) if hi0 else B
                    A1 = (~p & (A1 | m[1])) | (A1 & m[1]) if lo1 else A1
                    B1 = (p & (B1 | ~m[1])) | (B1 & ~m[1]) if hi1 else B1
                t = int(P["gen"][i])
                r = {
                    tb._C_ZERO: lambda: zero,
                    tb._C_EXISTS: lambda: sel | fil,
                    tb._C_FILL_A: lambda: fil | (sel & A),
                    tb._C_SEL_B: lambda: sel & B,
                    tb._C_EQ: lambda: sel & A & B,
                    tb._C_NE: lambda: fil | (sel & ~(A & B)),
                    tb._C_BT_SAME: lambda: sel & B & A1,
                    tb._C_BT_MIX: lambda: (fil & A) | (sel & A1),
                    tb._C_GEN1: lambda: (fil & tt(t, A, B)) | (sel & tt(t >> 4, A, B)),
                    tb._C_GEN2: lambda: ((fil & tt(t, A, B) & tt(t >> 8, A1, B1))
                                         | (sel & tt(t >> 4, A, B) & tt(t >> 12, A1, B1))),
                }[cls]()
                dest = int(P["dest"][i])
                seen[dest] += 1
                out[dest] = np.unpackbits(r.view(np.uint8), axis=-1).sum(-1) if count else r
            q0 = int(P["seg_end"][g])
        assert q0 == int(P["n_q"])
        np.testing.assert_array_equal(np.asarray(P["dest"][:q0]), launch.queries)
    return out, seen


def _edge_queries(rng, n, depth):
    """``n`` queries mixing one- and two-bound ones: every comparison,
    signed and out-of-band bounds, between of either sign, "any"."""
    out = []
    for k in range(n):
        r = k % 5
        if r == 1:
            lo, hi = sorted((_bound(rng, depth), _bound(rng, depth)))
            out.append([(">=" if rng.random() < 0.5 else ">", lo),
                        ("<=" if rng.random() < 0.5 else "<", hi)])
        elif r == 3:
            out.append([(CMPS[int(rng.integers(0, 6))], _bound(rng, depth)),
                        (CMPS[int(rng.integers(0, 6))], _bound(rng, depth))])
        elif r == 4 and rng.random() < 0.2:
            out.append([("any", 0)])
        else:
            out.append([(CMPS[int(rng.integers(0, 6))], _bound(rng, depth))])
    return out


# (depth, Q): the depths of a stored value from 0 to 63, and Q at one query,
# around a group of 8, the bench's 128, and around and past BSI_RANGE_MAX_Q
_PLAN_CASES = [(0, 9), (1, 9), (20, 9), (31, 9), (32, 9), (63, 9), (20, 1), (20, 7), (20, 8),
               (20, 128), (20, 255), (20, 256), (20, 257), (63, 300), (33, 40)]


@pytest.mark.parametrize("depth,Q", _PLAN_CASES)
def test_range_plan_read_as_the_kernel_reads_it_matches_jax(depth, Q):
    rng = np.random.default_rng(7000 + 100 * depth + Q)
    planes, exists, sign = _stack(rng, 2, depth, 8)
    queries = _edge_queries(rng, Q, depth)
    table = tb._queries_table(queries, depth)
    want_words = np.asarray(jb.range_batch(planes, exists, sign, queries, depth=depth))[:Q]
    want_counts = jb.range_count_batch(planes, exists, sign, queries, depth=depth)
    configs = [c for c in tb.RANGE_CONFIGS if depth <= c[0]]
    assert configs
    for config in configs:
        for count in (False, True):
            plan = tb.range_plan(table, depth, 8, count, config=config)
            launched = int(((tb.query_classes(table)[0] != tb._C_ZERO) | (not count)).sum())
            assert sum(launch.queries.size for launch in plan.launches) == launched
            assert len(plan.launches) >= -(-launched // tb.BSI_RANGE_MAX_Q)
            got, seen = _emulate_plan(plan, planes, exists, sign, Q, count)
            if count:
                # ZERO queries are not launched: their counts stay zero
                assert ((seen == 1) | (seen == 0) & (got.sum(-1) == 0)).all()
                assert got.sum(-1).tolist() == want_counts
            else:
                assert (seen == 1).all()
                np.testing.assert_array_equal(got, want_words)
    # the wrapper's plain path at the same edges
    np.testing.assert_array_equal(
        _np(tb.range_batch(_t(planes), _t(exists), _t(sign), queries, depth=depth)), want_words)
    assert tb.range_count_batch(_t(planes), _t(exists), _t(sign), queries,
                                depth=depth) == want_counts


# one query of each class, and its sign selection: (bounds, class, swap)
_CLASS_CASES = [
    ([("<", 5)], tb._C_FILL_A, 0), ([("<=", 5)], tb._C_FILL_A, 0),
    ([(">", -5)], tb._C_FILL_A, 1), ([(">=", -5)], tb._C_FILL_A, 1),
    ([(">", 5)], tb._C_SEL_B, 0), ([(">=", 0)], tb._C_SEL_B, 0),
    ([("<", -5)], tb._C_SEL_B, 1), ([("<=", -5)], tb._C_SEL_B, 1),
    ([("==", 5)], tb._C_EQ, 0), ([("==", -5)], tb._C_EQ, 1),
    ([("!=", 5)], tb._C_NE, 0), ([("!=", -5)], tb._C_NE, 1),
    ([(">=", 2), ("<=", 9)], tb._C_BT_SAME, 0), ([(">", -9), ("<", -2)], tb._C_BT_SAME, 1),
    ([("<=", 9), (">=", 2)], tb._C_BT_SAME, 0), ([(">=", -2), ("<=", 9)], tb._C_BT_MIX, 0),
    ([("<", 9), (">", -2)], tb._C_BT_MIX, 0), ([(">=", 2), ("<=", -9)], tb._C_ZERO, 0),
    ([("any", 0)], tb._C_EXISTS, 0), ([("<", 1 << 20)], tb._C_EXISTS, 0),
    ([("!=", -(1 << 20))], tb._C_EXISTS, 0), ([(">", 1 << 20)], tb._C_ZERO, 0),
    ([("==", 1 << 20)], tb._C_ZERO, 0), ([("<", -(1 << 20))], tb._C_ZERO, 0),
    ([("<", 5), ("any", 0)], tb._C_FILL_A, 0), ([(">=", -(1 << 20)), ("<=", 9)], tb._C_FILL_A, 0),
    ([("<", 5), ("<", 9)], tb._C_GEN2, 0), ([("==", 3), ("!=", -3)], tb._C_GEN2, 0),
]


@pytest.mark.parametrize("bounds,cls,swap", _CLASS_CASES)
def test_query_class_of_each_composition(bounds, cls, swap):
    depth = 20
    table = tb._queries_table([bounds], depth)
    got_cls, got_swap, live, _ = (a[0] for a in tb.query_classes(table))
    assert (got_cls, got_swap) == (cls, swap)
    # a one-bound query carries no padding bound
    assert (live >= 0).sum() == tb._C_BOUNDS[cls]
    rng = np.random.default_rng(len(bounds) + cls)
    planes, exists, sign = _stack(rng, 2, depth, 5)
    want = np.asarray(jb.range_batch(planes, exists, sign, [bounds], depth=depth))[:1]
    plan = tb.range_plan(table, depth, 5, False)
    np.testing.assert_array_equal(_emulate_plan(plan, planes, exists, sign, 1, False)[0], want)


@pytest.mark.parametrize("depth", [1, 20, 63])
def test_range_plan_of_hand_made_flags_matches_the_plain_version(depth):
    # flag words no condition encodes (the bounds table is the kernel's
    # contract): the GEN classes evaluate their truth tables
    rng = np.random.default_rng(depth)
    planes, exists, sign = _stack(rng, 3, depth, 7)
    Q = 40
    table = np.zeros((Q, 2, 3), dtype=np.int32)
    table[..., 0] = rng.integers(0, 1 << tb._M_CH, size=(Q, 2))
    mags = rng.integers(0, 1 << min(depth, 62), size=(Q, 2), dtype=np.int64)
    table[..., 1] = (mags & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    table[..., 2] = (mags >> 32).astype(np.uint32).view(np.int32)
    classes = set(tb.query_classes(table)[0].tolist())
    assert {tb._C_GEN1, tb._C_GEN2} <= classes
    for count in (False, True):
        want = _np(tb.bsi_range_plain(_t(planes), _t(exists), _t(sign), table, count))
        for config in [c for c in tb.RANGE_CONFIGS if depth <= c[0] and 7 % c[1] == 0]:
            plan = tb.range_plan(table, depth, 7, count, config=config)
            got, _ = _emulate_plan(plan, planes, exists, sign, Q, count)
            np.testing.assert_array_equal(got, want.astype(got.dtype))


def test_range_plan_sorts_by_class_and_cuts_launches():
    depth = 63
    queries = ([[("<", 9)]] * 5 + [[(">", 3), ("<", 40)]] * 3 + [[("==", -2)]] * 4
               + [[(">", 1 << 63)]] * 2) * 30
    table = tb._queries_table(queries, depth)
    Q = len(queries)
    for count in (False, True):
        plan = tb.range_plan(table, depth, 1000, count, config=(64, 1))
        order = np.concatenate([launch.queries for launch in plan.launches])
        cls, swap = tb.query_classes(table)[:2]
        zero = np.flatnonzero(cls == tb._C_ZERO).tolist()
        assert sorted(order.tolist() + (zero if count else [])) == list(range(Q))
        keys = list(zip(cls[order].tolist(), swap[order].tolist()))
        assert keys == sorted(keys)  # one segment per class and swap
        for launch in plan.launches:
            P = np.frombuffer(launch.param, dtype=tb._RANGE_PARAM)[0]
            assert int(P["n_q"]) == launch.queries.size <= tb.BSI_RANGE_MAX_Q
            # the warps' counters and the masks of a launch fit a block's
            # shared memory
            counters = 4 * tb._RANGE_PARAM_Q * tb.RANGE_THREADS // 32 if count else 0
            assert counters + int(P["n_rows"]) * 16 * 16 <= tb._RANGE_SMEM
            assert launch.depth == (depth if int(P["n_rows"]) else 0)
        assert len(plan.launches) >= 2
        assert (plan.dmax, plan.vec) == (64, 1)
        assert plan.grid_x == -(-1000 // (tb.RANGE_THREADS * tb.RANGE_BLOCK_CHUNKS))


@pytest.mark.parametrize("depth,W,vec,config", [
    (20, 32768, 4, (20, 4)), (21, 32768, 4, (32, 2)), (17, 1000, 4, (20, 4)),
    (20, 32768, 2, (32, 2)), (32, 100, 2, (32, 2)), (33, 100, 2, (64, 1)), (20, 101, 1, (64, 1)),
    (0, 8, 2, (32, 2)), (63, 8, 1, (64, 1)), (20, 1002, 4, (32, 2)),
])
def test_range_plan_config(depth, W, vec, config):
    table = tb._queries_table([[("<", 1)]], depth)
    plan = tb.range_plan(table, depth, W, True, vec=vec)
    assert (plan.dmax, plan.vec) == config
    with pytest.raises(ValueError):  # the planes past what a thread holds
        tb.range_plan(table, 65, W, True, vec=vec)


# -- the single conditions --------------------------------------------------


@pytest.mark.parametrize("depth", [0, 1, 20, 63])
@pytest.mark.parametrize("one_shard", [False, True])
def test_single_conditions_match_jax(depth, one_shard):
    rng = np.random.default_rng(depth + 50 * one_shard)
    planes, exists, sign = _stack(rng, 3, depth, 24)
    if one_shard:
        planes, exists, sign = planes[1], exists[1], sign[1]
    P, E, G = _t(planes), _t(exists), _t(sign)
    lim = 1 << depth
    values = sorted({0, 1, -1, lim - 1, -(lim - 1), lim, -lim, _bound(rng, depth),
                     _bound(rng, depth)})
    for v in values:
        for eq in (False, True):
            np.testing.assert_array_equal(
                _np(tb.range_lt(P, E, G, value=v, depth=depth, allow_eq=eq)),
                np.asarray(jb.range_lt(planes, exists, sign, value=v, depth=depth, allow_eq=eq)))
            np.testing.assert_array_equal(
                _np(tb.range_gt(P, E, G, value=v, depth=depth, allow_eq=eq)),
                np.asarray(jb.range_gt(planes, exists, sign, value=v, depth=depth, allow_eq=eq)))
        for negative in (False, True):  # -0 included: sign set, magnitude 0
            np.testing.assert_array_equal(
                _np(tb.range_eq(P, E, G, value_abs=abs(v), negative=negative, depth=depth)),
                np.asarray(jb.range_eq(planes, exists, sign, value_abs=abs(v),
                                       negative=negative, depth=depth)))
    for lo, hi in [(values[0], values[-1]), (0, 0), (-1, 1), (values[-1], values[0])]:
        np.testing.assert_array_equal(
            _np(tb.range_between(P, E, G, lo=lo, hi=hi, depth=depth)),
            np.asarray(jb.range_between(planes, exists, sign, lo=lo, hi=hi, depth=depth)))


def test_conditions_read_fewer_planes_than_the_stack_holds():
    rng = np.random.default_rng(4)
    planes, exists, sign = _stack(rng, 2, 9, 16)
    got = tb.range_lt(_t(planes), _t(exists), _t(sign), value=37, depth=6, allow_eq=True)
    want = jb.range_lt(planes, exists, sign, value=37, depth=6, allow_eq=True)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


# -- sums -------------------------------------------------------------------


@pytest.mark.parametrize("depth", DEPTHS)
def test_sums_match_jax(depth):
    rng = np.random.default_rng(200 + depth)
    planes, exists, sign = _stack(rng, 3, depth, 30)
    P, E, G = _t(planes), _t(exists), _t(sign)
    for fw in (exists, _words(rng, 3, 30), np.zeros((3, 30), np.uint32)):
        assert tb.sum_host(P, E, G, _t(fw), depth=depth) == jb.sum_host(
            planes, exists, sign, fw, depth=depth)
        for g, w in zip(tb.sum_count(P, E, G, _t(fw), depth=depth),
                        jb.sum_count(planes, exists, sign, fw, depth=depth)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # one shard
    for g, w in zip(tb.sum_count(P[0], E[0], G[0], E[0], depth=depth),
                    jb.sum_count(planes[0], exists[0], sign[0], exists[0], depth=depth)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    filters = _words(rng, 3, 5, 30)
    filters[:, 2] = exists  # an unfiltered query among filtered ones
    assert tb.sum_batch_host(P, E, G, _t(filters), depth=depth) == jb.sum_batch_host(
        planes, exists, sign, filters, depth=depth)


def test_sums_past_int64_stay_exact():
    """Depth 63 with every plane full: the total exceeds 2^63 and is held
    to Python ints, as JAX holds it."""
    S, W = 2, 8
    planes = np.full((S, 63, W), 0xFFFFFFFF, np.uint32)
    exists = np.full((S, W), 0xFFFFFFFF, np.uint32)
    sign = np.zeros((S, W), np.uint32)
    n = S * W * 32
    got = tb.sum_host(_t(planes), _t(exists), _t(sign), _t(exists), depth=63)
    assert got == (((1 << 63) - 1) * n, n) == jb.sum_host(planes, exists, sign, exists, depth=63)


@pytest.mark.parametrize("S,W", [(160, 32768), (161, 32768), (1, 1 << 26)])
def test_sum_batch_supported_matches_jax(S, W):
    assert tb.sum_batch_supported(S, W) == jb.sum_batch_supported(S, W)


# -- Min / Max ----------------------------------------------------------------


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("maximal", [False, True])
def test_min_max_match_jax(depth, maximal):
    rng = np.random.default_rng(300 + depth + maximal)
    planes, exists, sign = _stack(rng, 3, depth, 40)
    P, E, G = _t(planes), _t(exists), _t(sign)
    nonneg_only = exists & ~sign
    for fw in (exists, _words(rng, 3, 40) & _words(rng, 3, 40), np.zeros_like(exists),
               nonneg_only, exists & sign):
        assert tb.min_max_host(P, E, G, _t(fw), depth=depth, maximal=maximal) == (
            jb.min_max_host(planes, exists, sign, fw, depth=depth, maximal=maximal))
    for cand in (nonneg_only, np.zeros_like(exists)):
        mag, c = tb.extreme_mag(P, _t(cand), depth=depth, maximal=maximal)
        jmag, jc = jb.extreme_mag(planes, cand, depth=depth, maximal=maximal)
        # JAX keeps the magnitude's bits 0-30 in int32; the port all of them
        assert mag & 0x7FFFFFFF == int(jmag) and (depth > 31 or mag == int(jmag))
        np.testing.assert_array_equal(_np(c), np.asarray(jc))


def _from_values(values, exists_mask, depth):
    """uint32 (planes[S, depth, W], exists, sign) holding int ``values``
    ``[S, W*32]`` where ``exists_mask``."""
    mag = np.abs(values).astype(np.uint64)

    def pack(bits):
        return np.packbits(bits.astype(np.uint8), axis=-1, bitorder="little").view(np.uint32)

    planes = np.stack([pack(((mag >> np.uint64(k)) & np.uint64(1)).astype(bool) & exists_mask)
                       for k in range(depth)], axis=1)
    return planes, pack(exists_mask), pack((values < 0) & exists_mask)


@pytest.mark.parametrize("maximal", [False, True])
@pytest.mark.parametrize("W", [40, 5000])
def test_extreme_rows_combined_equal_jax_narrowing_across_shards(maximal, W):
    """Shards (and, at W = 5000, slices of 2048 words) whose extremes
    differ: some reach the global extreme, with different counts, some
    stop short, one holds no value; the per-slice rows of the plain
    bsi_extreme, combined by the card path's host code, give JAX's value
    and count, and the numpy truth's."""
    rng = np.random.default_rng(W + maximal)
    S, depth = 5, 12
    values = rng.integers(-900, 900, size=(S, W * 32))
    ex = rng.random((S, W * 32)) < 0.7
    ex[3] = False
    values[0, 5:7] = 2000 if maximal else -2000  # the extreme, twice in shard 0
    values[2, -3] = 2000 if maximal else -2000  # and once in shard 2's last slice
    ex[0, 5:7] = ex[2, -3] = True
    values[4] = np.where(values[4] > 0, values[4] // 2, values[4])  # stops short
    planes, exists, sign = _from_values(values, ex, depth)
    rows = tb.bsi_extreme(_t(planes), _t(exists), _t(sign), maximal=maximal)
    assert rows.shape == (S, -(-W // tb.BSI_EXTREME_SLICE), 6)
    got = tb.extreme_combine(rows.numpy(), maximal)
    assert got == jb.min_max_host(planes, exists, sign, exists, depth=depth, maximal=maximal)
    live = values[ex]
    best = live.max() if maximal else live.min()
    assert got == (int(best), int((live == best).sum())) == ((2000 if maximal else -2000), 3)
    per_shard = [tb.extreme_combine(rows[s].numpy(), maximal) for s in range(S)]
    assert per_shard[3] == (0, 0) and len({v for v, _ in per_shard}) > 2


@pytest.mark.parametrize("depth", [31, 32, 47, 63])
def test_min_max_past_int32_magnitudes_match_jax(depth):
    rng = np.random.default_rng(depth)
    S, W = 2, 4
    lim = (1 << depth) - 1
    values = np.array([int(rng.integers(0, 2**62)) % lim for _ in range(S * W * 32)],
                      dtype=np.int64).reshape(S, W * 32)
    values[:, ::3] *= -1
    values[1, 7] = lim
    values[0, 9] = -lim
    planes, exists, sign = _from_values(values, np.ones_like(values, bool), depth)
    for maximal in (False, True):
        got = tb.min_max_host(_t(planes), _t(exists), _t(sign), _t(exists), depth=depth,
                              maximal=maximal)
        assert got == jb.min_max_host(planes, exists, sign, exists, depth=depth,
                                      maximal=maximal)
        assert got == ((lim, 1) if maximal else (-lim, 1))


# -- the wrappers' checks -----------------------------------------------------


def test_wrappers_refuse_bad_operands():
    rng = np.random.default_rng(1)
    planes, exists, sign = (_t(a) for a in _stack(rng, 2, 4, 16))
    qmask, _, qmeta, _ = tb.encode_query_bounds([[("<", 3)]], 4)
    table = tb.bounds_table(qmask, qmeta)
    with pytest.raises(TypeError):
        tb.bsi_range(planes.to(torch.int64), exists, sign, table, count=True)
    with pytest.raises(ValueError):
        tb.bsi_range(planes, exists[:, :8], sign, table, count=True)
    with pytest.raises(ValueError):  # rows not contiguous
        tb.bsi_sum(planes, exists, sign, torch.zeros(2, 32, dtype=torch.int32)[:, ::2])
    with pytest.raises(ValueError):  # a shard's planes not W words apart
        tb.bsi_extreme(torch.zeros(2, 4, 32, dtype=torch.int32)[:, :, :16], exists, sign,
                       maximal=True)
    with pytest.raises(ValueError):  # a bounds table of three bounds
        tb.bsi_range(planes, exists, sign, np.zeros((1, 3, 3), np.int32), count=True)
    with pytest.raises(ValueError):  # no other device than the CPU and CUDA
        tb.bsi_sum(planes.to("meta"), exists.to("meta"), sign.to("meta"))


# -- storage: fragment, view and field against JAX ----------------------------


def test_bit_depth_base_and_value_range_match_jax():
    for lo, hi in [(0, 1_000_000), (-1_000_000, 1_000_000), (100, 200), (-50, -10), (0, 0),
                   (-(2**62), 2**62)]:
        j = jfield.Field("i", "v", jfield.FieldOptions(field_type="int", min_=lo, max_=hi))
        t = tfield.Field("i", "v", tfield.FieldOptions(field_type="int", min_=lo, max_=hi),
                         device="cpu")
        assert (t.base, t.bit_depth, t.value_range()) == (j.base, j.bit_depth, j.value_range())
    for v in (0, 1, -1, 255, 256, -(2**40), 2**63 - 1):
        assert tfield.bit_depth_of(v) == jfield.bit_depth_of(v)
    assert (tfragment.BSI_EXISTS_BIT, tfragment.BSI_SIGN_BIT, tfragment.BSI_OFFSET_BIT) == (
        jfragment.BSI_EXISTS_BIT, jfragment.BSI_SIGN_BIT, jfragment.BSI_OFFSET_BIT)


def test_field_writes_match_jax():
    """set_value/clear_value/import_values (with a depth that grows) leave
    both packages' BSI fragments with the same rows and values."""
    rng = np.random.default_rng(8)
    opts = dict(field_type="int", min_=-300, max_=700)
    j = jfield.Field("i", "v", jfield.FieldOptions(**opts), n_words=16)
    t = tfield.Field("i", "v", tfield.FieldOptions(**opts), n_words=16, device="cpu")
    cols = rng.integers(0, 3 * 512, 200)
    for c, v in zip(cols, rng.integers(-300, 701, 200)):
        assert t.set_value(int(c), int(v)) == j.set_value(int(c), int(v))
    for c in cols[:30]:
        assert t.clear_value(int(c)) == j.clear_value(int(c))
    big = rng.integers(-(2**20), 2**20, 50)  # past the options: the depth grows
    t.import_values(cols[40:90], big)
    j.import_values(cols[40:90], big)
    t.import_values(cols[95:99], [0, 0, 0, 0], clear=True)
    j.import_values(cols[95:99], [0, 0, 0, 0], clear=True)
    assert t.bit_depth == j.bit_depth > 10
    for c in range(0, 3 * 512, 7):
        assert t.value(c) == j.value(c)
    jv, tv = j.view(j.bsi_view_name()), t.view(t.bsi_view_name())
    assert tv.name == jv.name == "bsig_v"
    for shard, jf in jv.fragments.items():
        ids, mat = jf.rows_matrix_host()
        tids, tmat = tv.fragment(shard).rows_matrix_host()
        got = dict(zip(tids, tmat))
        for r, words in zip(ids, mat):
            np.testing.assert_array_equal(got.get(r, np.zeros_like(words)), words)
        planes, e, s = tv.fragment(shard).bsi_tensors_host(t.bit_depth)
        jp, je_, js = jf.bsi_tensors_host(j.bit_depth)
        np.testing.assert_array_equal(planes, jp)
        np.testing.assert_array_equal(e, je_)
        np.testing.assert_array_equal(s, js)
    with pytest.raises(ValueError):
        t.set_value(1, 701)
    with pytest.raises(ValueError):
        t.set_bit(1, 1)
