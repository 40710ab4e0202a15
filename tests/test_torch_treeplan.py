"""The host side of the tree count's launch (``pilosa_tpu_torch/ops/kernels.py``):
the launch plan, the distinct-row list and slot remap, the item order and
tiles, each item's distinct rows, and the tables of both routes, read back
in numpy the way ``ops/csrc/tree_eval.cu`` reads them and evaluated as its
kernels evaluate them.

Seeded data only, no card: the emulated counts are held to the plain tree
count and to ``pilosa_tpu``'s ``run_count_batch`` (JAX on the CPU) exactly.
The kernels themselves are held to the plain count on the card in
``tests/test_torch_cuda.py``.
"""

import gc

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pilosa_tpu.exec import astbatch as jast
from pilosa_tpu_torch.exec import astbatch as tast
from pilosa_tpu_torch.ops import kernels as tk


@pytest.fixture(scope="module", autouse=True)
def _freeze_what_came_before():
    """Freeze what is alive when the module's tests begin (the imports'
    objects, above all JAX's), so that the collection after each test
    scans only what the tests made; unfreeze and collect at the end."""
    gc.collect()
    gc.freeze()
    yield
    gc.unfreeze()
    gc.collect()


@pytest.fixture(autouse=True)
def _collect_after_each_test():
    """Collect each test's garbage at its end, where no lock is held: the
    JAX holders' and executors' device-budget entries release their bytes
    in finalizers that take the budget's lock, and left to a later
    collection they may run while another test's code holds a lock (a
    collection can start at any allocation)."""
    yield
    gc.collect()


_FLAT3 = ("intersect", ("row", 0), ("row", 1), ("row", 2))
_PAIRS = ("union", ("intersect", ("row", 0), ("row", 1)),
          ("difference", ("row", 0), ("row", 1)))
_NOT = ("difference", ("row", 0), ("row", 1))
_MIXED = ("union", ("difference", ("row", 0), ("row", 1)), ("intersect", ("row", 2), ("row", 0)))
_FOLDS = {0: np.bitwise_and, 1: np.bitwise_or, 2: np.bitwise_xor,
          3: lambda a, b: a & ~b, 4: lambda a, b: ~a & b}


def _chain(n):
    sig = ("row", 0)
    for k in range(n - 1):
        sig = (("intersect", "union", "xor", "difference")[k % 4], ("row", k % 3), sig)
    return sig


def _stacks(rng, S, W, rows):
    return tuple(
        torch.from_numpy(
            rng.integers(0, 2**32, size=(S, r, W), dtype=np.uint64).astype(np.uint32).view(np.int32)
        )
        for r in rows
    )


def _slots(rng, prog, stacks, B, absent):
    rows = np.array([stacks[k].shape[1] for k in prog.leaf_stack])
    slots = (rng.random((B, prog.n_leaves)) * rows).astype(np.int32)
    slots[rng.random(slots.shape) < absent] = -1
    slots[:, rows == 0] = -1
    return slots


# -- the plan ---------------------------------------------------------------


def _plan_ok(plan, B, L, U, S, W, n_steps):
    """The plan's invariants: what the C entry checks, and tiles that hold
    the batch."""
    tk._check_tree_plan(plan, L, W, n_steps, 1)
    if plan.route == "direct":
        assert plan.wsplit == -(-W // tk.TREE_DIRECT_SLICE_WORDS)
        assert plan.stages == 0 or tk._tree_rows_smem(plan.row_tile, n_steps, 1, plan.stages,
                                                      plan.lanes) <= tk._TREE_SMEM_LIMIT
        return
    assert plan.row_tile <= U and plan.item_tile <= max(tk.TREE_GROUP, -(-B // 8) * 8)
    assert tk._tree_staged_smem(plan.row_tile, plan.item_tile, L, n_steps,
                                plan.stages) <= tk._TREE_SMEM_LIMIT
    # a stage more would not fit, unless the ring is at its longest
    assert plan.stages == 4 or tk._tree_staged_smem(
        plan.row_tile, plan.item_tile, L, n_steps, plan.stages + 1) > tk._TREE_SMEM_LIMIT
    assert plan.wsplit == -(-W // (tk.TREE_CHUNK_WORDS * tk.TREE_SLICE_CHUNKS))


@pytest.mark.parametrize(
    "B,L,U,S,W,vec16,depth,route,stages,row_tile,item_tile",
    [
        # the trees path: 1024 items of three leaves over 132 distinct rows
        (1024, 3, 132, 160, 32768, True, 1, "staged", 2, 132, 1024),
        # the same over few rows: the longest ring
        (1024, 3, 9, 160, 32768, True, 1, "staged", 4, 9, 1024),
        # more items than a tile, and not a whole group
        (3001, 2, 65, 160, 32768, True, 1, "staged", 4, 65, 1024),
        (13, 3, 5, 3, 132, True, 2, "staged", 4, 5, 16),
        # distinct rows past one tile: the row tile at two stages
        (4096, 4, 900, 160, 32768, True, 2, "staged", 2, 176, 1024),
        # 64 leaves: the slot budget cuts the item tile, and the rows a tile
        (4096, 64, 180, 16, 4096, True, 1, "staged", 2, 177, 168),
        # direct: the word route (through L2); a deep program, too many
        # leaves, no shared rows and every slot absent (each item's rows
        # staged: at most min(L, U) of them; with none, the longest ring);
        # more rows than a block stages (through L2)
        (1024, 3, 132, 160, 32770, False, 1, "direct", 0, 0, 0),
        (1024, 8, 132, 160, 32768, True, 3, "direct", 1, 8, 0),
        (4, 300, 132, 160, 32768, True, 1, "direct", 1, 132, 0),
        (4, 300, 500, 160, 32768, True, 1, "direct", 1, 300, 0),
        (4, 600, 500, 160, 32768, True, 1, "direct", 0, 0, 0),
        (1, 3, 3, 160, 32768, True, 1, "direct", 1, 3, 0),
        (64, 3, 0, 160, 32768, True, 1, "direct", 4, 0, 0),
    ],
)
def test_tree_plan(B, L, U, S, W, vec16, depth, route, stages, row_tile, item_tile):
    n_steps = L
    plan = tk.tree_plan(B, L, U, S, W, vec16, depth, n_steps)
    assert (plan.route, plan.stages, plan.row_tile, plan.item_tile) == (
        route, stages, row_tile, item_tile)
    _plan_ok(plan, B, L, U, S, W, n_steps)


@pytest.mark.parametrize(
    "rows,W,vec16,depth,n_steps,chain,stages,lanes,wsplit,flat",
    [
        # one item of 300 leaves naming about 104 rows: the rows instance,
        # its flat OR chain on its own instance; one stage of 64 lanes puts
        # 4 warps on an SM
        (104, 32768, True, 1, 300, 1, 1, 64, 8, 1),
        # from 111 rows one stage of 32 lanes puts 3 on an SM, 64 lanes 2
        # (the trees path's 300-leaf Count names 132 rows); at 223 two of
        # each, and 64 lanes win the tie; the most rows 32 lanes hold, and
        # one more, through L2
        (110, 32768, True, 1, 300, 1, 1, 64, 8, 1),
        (111, 32768, True, 1, 300, 1, 1, 32, 8, 1),
        (132, 32768, True, 1, 300, 1, 1, 32, 8, 1),
        (223, 32768, True, 1, 300, 1, 1, 64, 8, 1),
        (443, 32768, True, 1, 300, 1, 1, 32, 8, 1),
        (444, 32768, True, 1, 300, 1, 0, 0, 8, -1),
        # a lone three-leaf Intersect, a nested tree, a program at the
        # operand-stack limit (its stack in shared memory)
        (3, 32768, True, 1, 3, 0, 1, 64, 8, 0),
        (8, 32768, True, 3, 11, -1, 1, 64, 8, -1),
        (20, 32768, True, 32, 600, -1, 1, 64, 8, -1),
        # slices: one, a last partial one, the word route through L2
        (3, 4096, True, 1, 3, 0, 1, 64, 1, 0),
        (3, 4100, True, 1, 3, 0, 1, 64, 2, 0),
        (3, 130, False, 1, 3, 0, 0, 0, 1, -1),
        (3, 8193, False, 2, 3, -1, 0, 0, 3, -1),
    ],
)
def test_tree_direct_plan(rows, W, vec16, depth, n_steps, chain, stages, lanes, wsplit, flat):
    plan = tk.tree_direct_plan(rows, W, vec16, depth, n_steps, chain)
    assert plan.route == "direct" and plan.vec16 == vec16
    assert (plan.stages, plan.lanes, plan.wsplit, plan.flat) == (stages, lanes, wsplit, flat)
    assert plan.row_tile == (rows if stages else 0)
    tk._check_tree_plan(plan, 3, W, n_steps, depth, chain)
    # the block shape that puts the most warps on an SM; through L2 where
    # none fits
    def warps(st, n):
        return tk._tree_rows_warps(tk._tree_rows_smem(rows, n_steps, depth, st, n), n)

    shapes = [(warps(st, n), st, n) for st in range(1, tk.TREE_ROWS_MAX_STAGES + 1)
              for n in (64, 32)]
    assert (plan.stages > 0) == (vec16 and max(shapes)[0] > 0)
    if plan.stages:
        assert warps(plan.stages, plan.lanes) == max(shapes)[0]


def test_tree_plan_direct_rows_follow_the_items():
    """tree_plan sizes the rows instance by the most rows one item names,
    and sends an item of more rows than fit through L2."""
    B, L, U, S, W = 1, 300, 104, 160, 32768
    assert tk.tree_plan(B, L, U, S, W, True, 1, L, chain=1) == tk.TreePlan(
        "direct", True, 1, 104, 0, 8, 1, 64)
    assert tk.tree_plan(4, L, 500, S, W, True, 1, L, item_rows=104, chain=1).row_tile == 104
    assert tk.tree_plan(4, L, 500, S, W, True, 1, L, item_rows=132, chain=1).lanes == 32
    assert tk.tree_plan(4, 600, 500, S, W, True, 1, 600, item_rows=450, chain=1).stages == 0


@pytest.mark.parametrize("S,W", [(160, 32768), (3, 32768), (1, 32768), (160, 4096), (7, 132)])
def test_tree_plan_w_split_fills_the_waves(S, W):
    plan = tk.tree_plan(1024, 3, 132, S, W, True, 1, 3)
    chunks = -(-W // tk.TREE_CHUNK_WORDS)
    # slices of TREE_SLICE_CHUNKS chunks, the last one shorter, none empty
    slice_ = -(-chunks // plan.wsplit)
    assert plan.wsplit == -(-chunks // tk.TREE_SLICE_CHUNKS)
    assert slice_ <= tk.TREE_SLICE_CHUNKS and (plan.wsplit - 1) * slice_ < chunks
    if S * chunks >= 8 * 132 * tk.TREE_SLICE_CHUNKS:
        # a shard count that could fill an H100's SMs many times over does
        assert S * plan.wsplit >= 8 * 132


@pytest.mark.parametrize(
    "plan,L,W,depth",
    [
        (tk.TreePlan("direct", True), 3, 130, 1),  # 16-byte loads at W = 130
        (tk.TreePlan("staged", False, 2, 8, 64, 1), 3, 128, 1),
        (tk.TreePlan("staged", True, 2, 8, 64, 1), 3, 132 + 2, 1),
        (tk.TreePlan("staged", True, 1, 8, 64, 1), 3, 128, 1),
        (tk.TreePlan("staged", True, 5, 8, 64, 1), 3, 128, 1),
        (tk.TreePlan("staged", True, 2, 0, 64, 1), 3, 128, 1),  # no rows
        (tk.TreePlan("staged", True, 2, 8, 60, 1), 3, 128, 1),  # not whole groups
        (tk.TreePlan("staged", True, 2, 8, 64, 0), 3, 128, 1),
        (tk.TreePlan("staged", True, 2, 8, 64, 1), 65, 128, 1),
        (tk.TreePlan("staged", True, 2, 8, 64, 1), 3, 128, 3),
        (tk.TreePlan("staged", True, 4, 400, 64, 1), 3, 128, 1),  # past shared memory
        (tk.TreePlan("tiled", True, 2, 8, 64, 1), 3, 128, 1),
        # the flat instances: one entry, at most TREE_FLAT_STEPS steps,
        # folds 0-3
        (tk.TreePlan("staged", True, 2, 8, 64, 1, 0), 3, 128, 2),
        (tk.TreePlan("staged", True, 2, 8, 64, 1, 4), 3, 128, 1),
        (tk.TreePlan("staged", True, 2, 8, 64, 1, 1), 5, 128, 1),
        # the direct route: no slice; through L2 with a flat instance; the
        # rows instance on word-by-word rows, with a ring of 5 stages,
        # past shared memory, with fold 4, or flat with two entries
        (tk.TreePlan("direct", True, 0, 0, 0, 0), 3, 128, 1),
        (tk.TreePlan("direct", True, 2, 8, 0, 0), 3, 128, 1),
        (tk.TreePlan("direct", True, 0, 0, 0, 1, 1), 3, 128, 1),
        (tk.TreePlan("direct", False, 2, 8, 0, 1), 3, 128, 1),
        (tk.TreePlan("direct", True, 2, 8, 0, 1), 3, 132 + 2, 1),
        (tk.TreePlan("direct", True, 5, 8, 0, 1, -1, 64), 3, 128, 1),
        (tk.TreePlan("direct", True, 2, 200, 0, 1), 3, 128, 1),
        (tk.TreePlan("direct", True, 2, 8, 0, 1, 4, 64), 3, 128, 1),
        (tk.TreePlan("direct", True, 2, 8, 0, 1, 0, 64), 3, 128, 2),
        # lanes: none or 16 on the rows instance, some through L2, a ring of
        # 32 lanes past shared memory
        (tk.TreePlan("direct", True, 2, 8, 0, 1), 3, 128, 1),
        (tk.TreePlan("direct", True, 2, 8, 0, 1, -1, 16), 3, 128, 1),
        (tk.TreePlan("direct", True, 0, 0, 0, 1, -1, 64), 3, 128, 1),
        (tk.TreePlan("direct", True, 2, 240, 0, 1, -1, 32), 3, 128, 1),
    ],
)
def test_tree_plan_check_refuses_what_the_kernel_cannot_run(plan, L, W, depth):
    with pytest.raises(ValueError, match="tree plan"):
        tk._check_tree_plan(plan, L, W, L, depth)


def test_tree_plan_check_refuses_a_flat_instance_of_another_chain():
    plan = tk.TreePlan("direct", True, 2, 8, 0, 1, 1, 64)  # an OR chain
    tk._check_tree_plan(plan, 3, 128, 3, 1, chain=1)
    tk._check_tree_plan(plan._replace(flat=-1), 3, 128, 3, 1, chain=1)
    for chain in (0, 2, -1):
        with pytest.raises(ValueError, match="tree plan"):
            tk._check_tree_plan(plan, 3, 128, 3, 1, chain=chain)


# -- programs as steps ------------------------------------------------------


def _run_steps(steps, leaves):
    top = leaves[steps[0] >> 5]
    below = []
    for st in steps[1:].tolist():
        kind, f, leaf = st & 3, (st >> 2) & 7, st >> 5
        if kind == tk.TREE_POP_FOLD:
            top = _FOLDS[f](below.pop(), top)
        elif kind == tk.TREE_LEAF_FOLD:
            top = _FOLDS[f](top, leaves[leaf])
        else:
            below.append(top)
            top = leaves[leaf]
    assert not below
    return top


def _run_postfix(code, leaves):
    st = []
    for op in code.tolist():
        if op >= 0:
            st.append(leaves[op])
        else:
            b = st.pop()
            st.append(_FOLDS[-op - 1](st.pop(), b))
    return st[0]


@pytest.mark.parametrize("sig", [_FLAT3, _PAIRS, _NOT, _MIXED, _chain(40),
                                 ("union",) + tuple(("row", k % 3) for k in range(300)),
                                 ("difference", ("row", 0), ("union", ("row", 1), ("row", 2)),
                                  ("row", 1))],
                         ids=lambda s: str(s)[:40])
def test_tree_steps_evaluate_as_the_postfix_program(sig):
    p = tast.program(sig)
    steps, depth = tk.tree_steps(p.code)
    assert steps[0] & 3 == tk.TREE_PUSH
    assert 1 <= depth <= p.depth
    leaves = np.random.default_rng(len(p.code)).integers(
        0, 2**32, size=(p.n_leaves, 64), dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(_run_steps(steps, leaves), _run_postfix(p.code, leaves))


def test_tree_steps_of_the_trees_path():
    """A flat tree is one push and leaf folds: one register entry."""
    steps, depth = tk.tree_steps(tast.program(_FLAT3).code)
    assert steps.tolist() == [tk.TREE_PUSH, tk.TREE_LEAF_FOLD | 1 << 5,
                              tk.TREE_LEAF_FOLD | 2 << 5] and depth == 1
    assert tk.tree_steps(tast.program(_PAIRS).code)[1] == 2


@pytest.mark.parametrize(
    "sig,flat",
    [
        (_FLAT3, 0),
        (("union", ("row", 0), ("row", 1)), 1),
        (("xor", ("row", 0), ("row", 0), ("row", 0)), 2),
        (_NOT, 3),
        (("intersect",) + tuple(("row", k % 3) for k in range(4)), 0),
        (("intersect",) + tuple(("row", k % 3) for k in range(5)), -1),  # past 4 steps
        (_PAIRS, -1),  # two entries
        (_MIXED, -1),
        (("difference", ("row", 0), ("union", ("row", 1), ("row", 2))), -1),
    ],
    ids=lambda v: str(v)[:40],
)
def test_tree_flat(sig, flat):
    assert tk.tree_flat(tk.tree_steps(tast.program(sig).code)[0]) == flat


def test_tree_program_is_cached_and_read_only():
    p = tast.program(_PAIRS)
    code, leaf_stack = p.code.astype(np.int64), p.leaf_stack.astype(np.int64)
    tk._tree_program(code.tobytes(), leaf_stack.tobytes())
    before = tk._tree_program.cache_info()
    prog = tk._tree_program(code.tobytes(), leaf_stack.tobytes())
    assert tk._tree_program.cache_info().hits == before.hits + 1
    assert not prog.steps.flags.writeable
    assert (prog.depth, prog.staged_depth, prog.flat, prog.stack_range) == (3, 2, -1, (0, 1))
    # the wrappers check the leaf stacks against the stacks given, after the depth
    stacks = (torch.zeros((1, 2, 4), dtype=torch.int32),)
    with pytest.raises(ValueError, match="out of range"):
        tk.tree_count(stacks, p.code, p.leaf_stack, np.zeros((1, 4), np.int32))


# -- distinct rows, item order, tiles ----------------------------------------


def _named(stacks, p, r):
    """The (tensor, row) a stack ordinal and row name."""
    return stacks[p].data_ptr(), stacks[p].shape[1], int(r)


@pytest.mark.parametrize(
    "rows,alias,B,absent,seed",
    [
        ((64, 64, 4), None, 256, 0.0, 0),
        ((5, 0, 1), None, 40, 0.2, 1),  # a 0-row stack: its leaves absent
        ((6, 6, 3), (0, 0, 2), 64, 0.1, 2),  # one tensor as two stacks
        ((6, 6, 3), (1, 0, 1), 33, 0.5, 3),
        ((1,), None, 9, 0.0, 4),
    ],
)
def test_distinct_rows_and_remap_round_trip(rows, alias, B, absent, seed):
    rng = np.random.default_rng(seed)
    base = _stacks(rng, 2, 8, rows)
    stacks = base if alias is None else tuple(base[k] for k in alias)
    L = 4
    leaf_stack = rng.integers(0, len(stacks), size=L)
    n = np.array([stacks[k].shape[1] for k in leaf_stack])
    slots = (rng.random((B, L)) * n).astype(np.int32)
    slots[rng.random(slots.shape) < absent] = -1
    slots[:, n == 0] = -1
    uniq, remap = tk.tree_distinct_rows(stacks, leaf_stack, slots)
    assert remap.shape == slots.shape and remap.dtype == np.int32
    np.testing.assert_array_equal(remap < 0, slots < 0)
    # every remapped leaf names the original (tensor, row)
    for b, l in zip(*np.nonzero(slots >= 0)):
        p, r = uniq[remap[b, l]]
        assert _named(stacks, p, r) == _named(stacks, leaf_stack[l], slots[b, l])
    # each (tensor, row) once, every listed row named
    names = [_named(stacks, p, r) for p, r in uniq]
    assert len(set(names)) == len(names)
    assert set(remap[remap >= 0].tolist()) == set(range(len(uniq)))
    if alias is not None:
        assert all(names.count(_named(stacks, alias.index(alias[p]), r)) == 1 for p, r in uniq)


@pytest.mark.parametrize("B,L,seed", [(1024, 3, 0), (37, 4, 1), (1, 2, 2), (500, 7, 3)])
def test_item_order_and_its_inverse(B, L, seed):
    rng = np.random.default_rng(seed)
    # leaf l draws from 4 ** (l % 3 + 1) rows, some absent
    remap = np.stack([rng.integers(-1, 4 ** (l % 3 + 1), size=B) for l in range(L)],
                     axis=1).astype(np.int32)
    order = tk.tree_item_order(remap)
    assert sorted(order.tolist()) == list(range(B))
    inverse = np.empty(B, np.int64)
    inverse[order] = np.arange(B)
    np.testing.assert_array_equal(remap[order][inverse], remap)
    # sorted lexicographically, the leaf of fewest distinct rows first
    distinct = [np.unique(remap[:, l]).size for l in range(L)]
    keys = sorted(range(L), key=lambda l: (distinct[l], l))
    ranked = [tuple(row) for row in remap[order][:, keys].tolist()]
    assert ranked == sorted(ranked)


@pytest.mark.parametrize("row_tile,item_tile", [(1000, 1024), (1000, 64), (12, 1024), (4, 40)])
def test_tiles_hold_their_limits(row_tile, item_tile):
    rng = np.random.default_rng(row_tile + item_tile)
    remap = np.stack([rng.integers(-1, n, size=300) for n in (3, 20, 40)],
                     axis=1).astype(np.int32)
    order = tk.tree_item_order(remap)
    tiles = tk.tree_tiles(remap, order, row_tile, item_tile)
    np.testing.assert_array_equal(np.concatenate(tiles), order)
    for items in tiles:
        assert 0 < items.size <= item_tile
        sub = remap[items]
        assert np.unique(sub[sub >= 0]).size <= row_tile
    if row_tile < 60:
        assert len(tiles) > 1


# -- the staged table, read back as the kernel reads it -----------------------


def _emulate_staged(stacks, steps, lay, B, L):
    """``int64[B, S]``: the staged kernel's count over the table bytes of
    ``lay`` (each tile's rows, item by item and step by step)."""
    S, _, W = stacks[0].shape
    buf = b"".join(np.ascontiguousarray(a).tobytes() for a in lay.parts)
    n_rows, n_items, tiles, n_steps = lay.n_rows, lay.n_items, lay.tiles, steps.size
    rowptr = np.frombuffer(buf, np.int64, n_rows, 0)
    rowstride = np.frombuffer(buf, np.int64, n_rows, 8 * n_rows)
    ints = np.frombuffer(buf, np.int32, offset=16 * n_rows)
    assert ints.size == 4 * tiles + n_steps + n_items * (L + 1)
    head = ints[: 4 * tiles].reshape(tiles, 4)
    np.testing.assert_array_equal(ints[4 * tiles : 4 * tiles + n_steps], lay.steps)
    if not np.array_equal(lay.steps, steps):  # a flat chain, its leaves reordered
        assert tk.tree_flat(lay.steps) == tk.tree_flat(steps) >= 0
        assert sorted((lay.steps >> 5).tolist()) == sorted((steps >> 5).tolist())
        if tk.tree_flat(steps) == 3:  # ANDNOT keeps its minuend first
            assert lay.steps[0] == steps[0]
    steps = lay.steps
    slots = ints[4 * tiles + n_steps :][: n_items * L]
    ids = ints[4 * tiles + n_steps + n_items * L :]
    words = [(t.data_ptr(), t.numpy().view(np.uint32).reshape(-1)) for t in stacks]

    def row(k):  # [S, W] words of tile row k
        addr = int(rowptr[k])
        base, flat = next((b, f) for b, f in words if b <= addr < b + 4 * f.size)
        start = (addr - base) // 4
        return flat[start + np.arange(S)[:, None] * int(rowstride[k]) + np.arange(W)]

    zero = np.zeros((S, W), np.uint32)
    out = np.zeros((B, S), np.int64)
    assert head[:, 1].max() == lay.rows_max and head[:, 3].max() == lay.items_max
    for row_off, rows, item_off, items in head.tolist():
        assert items % tk.TREE_GROUP == 0
        tile = [row(row_off + r) for r in range(rows)] + [zero]  # the zero row: absent
        sl = slots[item_off * L : (item_off + items) * L].reshape(L, items)
        uniform = (sl & tk.TREE_UNIFORM) != 0
        sl = sl & (tk.TREE_UNIFORM - 1)
        assert sl.max() <= rows
        groups = sl.reshape(L, -1, tk.TREE_GROUP)
        flags = uniform.reshape(groups.shape)
        np.testing.assert_array_equal(flags.any(axis=2), flags.all(axis=2))
        np.testing.assert_array_equal(flags.all(axis=2), (groups == groups[:, :, :1]).all(axis=2))
        leaves = [np.stack([tile[u] for u in sl[l]]) for l in range(L)]
        counts = np.bitwise_count(_run_steps(steps, leaves)).sum(axis=2, dtype=np.int64)
        for i, b in enumerate(ids[item_off : item_off + items].tolist()):
            if b >= 0:
                out[b] += counts[i]
    return out


@pytest.mark.parametrize(
    "S,W,rows,alias,sig,B,absent,shrink",
    [
        (3, 132, (5, 7, 1), None, _FLAT3, 40, 0.2, False),
        (2, 260, (9, 0, 3), None, _PAIRS, 33, 0.1, False),
        (4, 128, (6,), None, ("xor", ("row", 0), ("row", 0), ("row", 0)), 17, 0.0, False),
        (2, 132, (6, 4), (0, 0, 1), _FLAT3, 50, 0.1, False),  # one tensor as two stacks
        (3, 136, (4, 6, 2), None, _chain(40), 6, 0.2, False),
        # flat chains, their leaves reordered: Not (ANDNOT), a Union of four
        (2, 128, (1, 12), None, _NOT, 64, 0.1, False),
        (2, 132, (3, 9, 5), None, ("union", ("row", 2), ("row", 1), ("row", 0), ("row", 1)), 45,
         0.1, False),
        # distinct rows and items past one tile
        (2, 132, (40, 40, 4), None, _FLAT3, 200, 0.05, True),
        (2, 132, (30, 30), None, _PAIRS, 300, 0.0, True),
    ],
)
def test_staged_table_counts_as_the_plain_tree(monkeypatch, S, W, rows, alias, sig, B, absent,
                                               shrink):
    rng = np.random.default_rng(S * W + B)
    base = _stacks(rng, S, W, rows)
    stacks = base if alias is None else tuple(base[k] for k in alias)
    p = tast.program(sig)
    slots = _slots(rng, p, stacks, B, absent)
    steps, depth = tk.tree_steps(p.code)
    uniq, remap = tk.tree_distinct_rows(stacks, p.leaf_stack, slots)
    if shrink:  # a tile of at most 20 rows and 64 items
        monkeypatch.setattr(tk, "_TREE_SMEM_LIMIT",
                            tk._tree_staged_smem(20, 64, p.n_leaves, steps.size, 2) + 16)
        monkeypatch.setattr(tk, "_TREE_ITEM_TILE", 64)
    plan = tk.tree_plan(B, p.n_leaves, len(uniq), S, W, True, depth, steps.size,
                        flat=tk.tree_flat(steps))
    assert plan.route == "staged" and plan.flat == tk.tree_flat(steps)
    tk._check_tree_plan(plan, p.n_leaves, W, steps.size, depth)
    lay = tk.tree_staged_layout(stacks, uniq, remap, steps, plan)
    if shrink:
        assert lay.tiles > 1 and lay.rows_max <= 20 and lay.items_max <= 64
    got = _emulate_staged(stacks, steps, lay, B, p.n_leaves)
    want = tk.tree_count_plain(stacks, p.code, p.leaf_stack, slots).numpy()
    np.testing.assert_array_equal(got, want)
    if min(rows) > 0:  # pilosa_tpu's run_count_batch indexes every stack
        j_stacks = tuple(jnp.asarray(t.numpy().view(np.uint32)) for t in stacks)
        np.testing.assert_array_equal(got.sum(axis=1),
                                      jast.run_count_batch(sig, j_stacks, slots))


def test_staged_table_of_items_that_share_no_rows():
    """A plan may stage a batch whose items share nothing (the wrapper's
    plan sends it to the direct route); the table still counts right."""
    rng = np.random.default_rng(9)
    stacks = _stacks(rng, 2, 132, (24, 24, 24))
    p = tast.program(_FLAT3)
    slots = (np.arange(8)[:, None] * 3 + np.arange(3)).astype(np.int32)
    steps, depth = tk.tree_steps(p.code)
    uniq, remap = tk.tree_distinct_rows(stacks, p.leaf_stack, slots)
    assert len(uniq) == 24
    assert tk.tree_plan(8, 3, 24, 2, 132, True, depth, 3).route == "direct"
    plan = tk.TreePlan("staged", True, 2, 24, 8, 1)
    tk._check_tree_plan(plan, 3, 132, steps.size, depth)
    lay = tk.tree_staged_layout(stacks, uniq, remap, steps, plan)
    got = _emulate_staged(stacks, steps, lay, 8, 3)
    np.testing.assert_array_equal(got, tk.tree_count_plain(stacks, p.code, p.leaf_stack, slots))


# -- each item's distinct rows, and the direct table read back ----------------


@pytest.mark.parametrize("B,L,n,seed", [(1, 300, 40, 0), (1, 4, 9, 1), (37, 6, 5, 2),
                                        (64, 8, 300, 3), (5, 3, 1, 4)])
def test_item_rows_list_each_row_of_an_item_once(B, L, n, seed):
    rng = np.random.default_rng(seed)
    remap = rng.integers(-1, n, size=(B, L)) * 7  # row ids; -7: absent
    remap[remap < 0] = -1
    items = tk.tree_item_rows(remap)
    assert items.offsets[0] == 0 and items.offsets[-1] == items.leaf.size
    np.testing.assert_array_equal(items.local < 0, remap < 0)
    for b in range(B):
        leaves = items.leaf[items.offsets[b] : items.offsets[b + 1]]
        assert ((leaves // L) == b).all()  # the item's own leaves
        mine = remap.reshape(-1)[leaves]
        np.testing.assert_array_equal(mine, np.unique(remap[b][remap[b] >= 0]))
        present = remap[b] >= 0
        np.testing.assert_array_equal(mine[items.local[b][present]], remap[b][present])
    assert items.rows_max == int(np.diff(items.offsets).max())


def _emulate_direct(stacks, lay, B, n_steps):
    """``int64[B, S]``: the direct kernels' count over the table bytes of
    ``lay`` (each item's steps with their operand stack, a leaf read from
    the item's rows; an operand of ``rows_max`` or past the item's rows is
    a zero leaf)."""
    S, _, W = stacks[0].shape
    buf = b"".join(np.ascontiguousarray(a).tobytes() for a in lay.parts)
    n = lay.n_rows
    rowptr = np.frombuffer(buf, np.int64, n, 0)
    rowstride = np.frombuffer(buf, np.int64, n, 8 * n)
    ints = np.frombuffer(buf, np.int32, offset=16 * n)
    assert ints.size == B + 1 + B * n_steps
    item_rows = ints[: B + 1]
    steps = ints[B + 1 :].reshape(B, n_steps)
    words = [(t.data_ptr(), t.numpy().view(np.uint32).reshape(-1)) for t in stacks]

    def row(k):
        addr = int(rowptr[k])
        base, flat = next((b, f) for b, f in words if b <= addr < b + 4 * f.size)
        start = (addr - base) // 4
        return flat[start + np.arange(S)[:, None] * int(rowstride[k]) + np.arange(W)]

    zero = np.zeros((S, W), np.uint32)
    out = np.zeros((B, S), np.int64)
    for b in range(B):
        r0, nb = int(item_rows[b]), int(item_rows[b + 1] - item_rows[b])
        assert nb <= lay.rows_max
        top, below = None, []
        for st in steps[b].tolist():
            kind, f, r = st & 3, (st >> 2) & 7, st >> 5
            leaf = row(r0 + r) if r < nb else zero
            if kind == tk.TREE_POP_FOLD:
                assert r == lay.rows_max
                top = _FOLDS[f](below.pop(), top)
            elif kind == tk.TREE_LEAF_FOLD:
                top = _FOLDS[f](top, leaf)
            else:
                if top is not None:
                    below.append(top)
                top = leaf
        assert not below
        out[b] = np.bitwise_count(top).sum(axis=1, dtype=np.int64)
    return out


_WIDE = ("union",) + tuple(("row", k % 3) for k in range(300))


@pytest.mark.parametrize(
    "S,W,rows,alias,sig,B,absent,fixed",
    [
        # the 300-leaf Union (each distinct row listed once), a lone Intersect
        (2, 132, (9, 7, 4), None, _WIDE, 1, 0.05, None),
        (3, 128, (5, 7, 1), None, _FLAT3, 1, 0.0, None),
        # XOR and ANDNOT chains that repeat a row: it folds every time
        (2, 128, (6,), None, ("xor", ("row", 0), ("row", 0), ("row", 0), ("row", 0)), 3, 0.0,
         [[2, 2, 2, 5], [1, 3, 1, 1], [4, 4, 4, 4]]),
        (2, 128, (6,), None, ("difference", ("row", 0), ("row", 0), ("row", 0)), 3, 0.0,
         [[2, 3, 3], [1, 1, 4], [5, 0, 0]]),
        # absent rows and a 0-row stack; one tensor as two stacks
        (3, 132, (5, 0, 1), None, _MIXED, 9, 0.2, None),
        (2, 132, (6, 4), (0, 0, 1), _FLAT3, 5, 0.1, None),
        # items that share no rows; nested 40 deep; 512 leaves at depth 10
        (2, 132, (24, 24, 24), None, _FLAT3, 8, 0.0,
         (np.arange(8)[:, None] * 3 + np.arange(3)).tolist()),
        (3, 136, (4, 6, 2), None, _chain(40), 6, 0.2, None),
        (2, 128, (5, 3, 2), None, "balanced9", 2, 0.1, None),
    ],
)
@pytest.mark.parametrize("dedupe", [True, False])
def test_direct_table_counts_as_the_plain_tree(S, W, rows, alias, sig, B, absent, fixed, dedupe):
    rng = np.random.default_rng(S * W + B)
    base = _stacks(rng, S, W, rows)
    stacks = base if alias is None else tuple(base[k] for k in alias)
    if sig == "balanced9":
        def balanced(levels, k=0):
            if levels == 0:
                return ("row", k % 3)
            return (("difference", "union", "xor", "intersect")[levels % 4],
                    balanced(levels - 1, 2 * k), balanced(levels - 1, 2 * k + 1))
        sig = balanced(9)
    p = tast.program(sig)
    slots = _slots(rng, p, stacks, B, absent) if fixed is None else np.array(fixed, np.int32)
    steps, depth = tk.tree_steps(p.code)
    if dedupe:
        items = tk.tree_item_rows(tk.tree_row_ids(stacks, p.leaf_stack, slots))
        plan = tk.tree_direct_plan(items.rows_max, W, True, depth, steps.size,
                                   tk.tree_flat(steps, None))
        lay = tk.tree_direct_layout(stacks, p.leaf_stack, slots, steps, items,
                                    plan.row_tile if plan.stages else None)
        # each item lists each of its rows once, and names every row it lists
        # (the rows instance copies them all)
        for b in range(B):
            r0, r1 = items.offsets[b], items.offsets[b + 1]
            pairs = set(zip(lay.parts[0][r0:r1].tolist(), lay.parts[1][r0:r1].tolist()))
            assert len(pairs) == r1 - r0 <= lay.rows_max
            named = lay.parts[3][b] >> 5
            assert set(named[named < r1 - r0].tolist()) == set(range(r1 - r0))
    else:  # every leaf a row of its item, as tree_words and word rows take it
        lay = tk.tree_direct_layout(stacks, p.leaf_stack, slots, steps)
        assert lay.n_rows == B * p.n_leaves and lay.rows_max == p.n_leaves
    got = _emulate_direct(stacks, lay, B, steps.size)
    want = tk.tree_count_plain(stacks, p.code, p.leaf_stack, slots).numpy()
    np.testing.assert_array_equal(got, want)
    if min(rows) > 0:  # pilosa_tpu's run_count_batch indexes every stack
        j_stacks = tuple(jnp.asarray(t.numpy().view(np.uint32)) for t in stacks)
        np.testing.assert_array_equal(got.sum(axis=1),
                                      jast.run_count_batch(sig, j_stacks, slots))


def test_direct_launch_of_a_wide_item():
    """The 300-leaf Union's launch: one item, its distinct rows listed
    once, the flat OR instance with a stage of exactly that many rows."""
    rng = np.random.default_rng(5)
    stacks = _stacks(rng, 2, 4096, (64, 64, 4))
    p = tast.program(_WIDE)
    slots = _slots(rng, p, stacks, 1, 0.0)
    launch = tk.tree_count_launch(stacks, p.code, p.leaf_stack, slots)
    U = len({(int(p.leaf_stack[l]), int(slots[0, l])) for l in range(p.n_leaves)})
    assert launch.items.rows_max == U and launch.rows is None  # no staged route to plan
    assert launch.plan == tk.TreePlan("direct", True, 1, U, 0, 1, 1, 64)
    # word rows: through L2, no distinct rows
    w130 = _stacks(rng, 2, 130, (64, 64, 4))
    launch = tk.tree_count_launch(w130, p.code, p.leaf_stack, slots)
    assert launch.rows is None and launch.items is None
    assert launch.plan == tk.TreePlan("direct", False, 0, 0, 0, 1)
