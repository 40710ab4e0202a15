"""The port's compiled PQL trees (``pilosa_tpu_torch/exec/astbatch.py`` and
the executor's ``_batch_general``) against ``pilosa_tpu``.

Seeded data only. The same trees are matched by both packages (equal
signatures, leaves and stack pairs), the same stacks and slots run through
both ``run_count_batch`` and ``run_bitmap`` (JAX on the CPU; the port's
wrappers compute the tree kernel's plain version on CPU tensors), and the
same queries run through both executors. Counts are integers: every
comparison is exact. Spies on the port's kernel wrappers show which tier
answered: one tree-kernel call per (signature, stacks) group, none for a
cold lone tree, and trees of any width and nesting on the kernel.
"""

# the port's lock witness, installed before the port is imported so that its
# module-level locks are wrapped too (pilosa_tpu_torch/testing/lockwitness.py)
from pilosa_tpu_torch.testing import lockwitness as port_lockwitness

port_lockwitness.install()
# the module fixture that asserts no new inversion among the port's locks
from pilosa_tpu_torch.testing.lockwitness import no_new_inversion  # noqa: F401

import gc

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pilosa_tpu import pql as jpql
from pilosa_tpu.core.holder import Holder as JaxHolder
from pilosa_tpu.exec import astbatch as jast
from pilosa_tpu.exec.executor import ExecuteError as JaxExecuteError
from pilosa_tpu.exec.executor import Executor as JaxExecutor
from pilosa_tpu_torch import convert, pql as tpql
from pilosa_tpu_torch.exec import astbatch as tast
from pilosa_tpu_torch.exec.executor import ExecuteError, Executor as TorchExecutor
from pilosa_tpu_torch.ops import kernels as tk
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, SHARD_WORDS


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


N_SHARDS = 3
N_ROWS = 7
N_COLS = N_SHARDS * SHARD_WIDTH

# tests/test_astbatch.py:47-58
TREES = [
    "Intersect(Row(f=0), Row(f=1), Row(f=2))",
    "Union(Row(f=0), Row(f=1), Row(f=2), Row(f=3))",
    "Difference(Row(f=0), Row(f=1), Row(f=2))",
    "Xor(Row(f=0), Row(f=4))",
    "Union(Intersect(Row(f=0), Row(g=1)), Difference(Row(f=2), Row(g=0)))",
    "Not(Row(f=3))",
    "Intersect(Row(f=1), Not(Union(Row(f=2), Row(g=2))))",
    # absent rows ride through as zero rows
    "Union(Row(f=0), Row(f=999))",
    "Difference(Row(f=0), Row(f=999))",
]


def _norm(r):
    if isinstance(r, Exception):
        return ("error", type(r).__name__)
    if isinstance(r, list):
        return [_norm(x) for x in r]
    if hasattr(r, "columns") and hasattr(r, "segments"):
        return ("row", [int(c) for c in r.columns()])
    if isinstance(r, (bool, int, np.integer)):
        return r if isinstance(r, bool) else int(r)
    raise TypeError(type(r))


def _build(seed: int):
    """(jax executor, port executor, rng): fields f and g of N_ROWS rows
    over N_SHARDS shards; existence from Set writes to f, g and h (a field
    with a single row, which few trees name)."""
    rng = np.random.default_rng(seed)
    jh = JaxHolder()
    idx = jh.create_index("i")
    for name in ("f", "g", "h"):
        idx.create_field(name)
    for fname, n_bits in (("f", 4000), ("g", 2500)):
        rows = rng.integers(0, N_ROWS, size=n_bits).astype(np.uint64)
        cols = rng.integers(0, N_COLS, size=n_bits).astype(np.uint64)
        idx.field(fname).import_bits(rows, cols)
    je = JaxExecutor(jh, rescache_entries=0)
    sets = []
    for _ in range(300):
        col = int(rng.integers(0, N_COLS))
        fld = ("f", "g", "h")[int(rng.integers(0, 3))]
        sets.append(f"Set({col}, {fld}={0 if fld == 'h' else int(rng.integers(0, N_ROWS))})")
    je.execute("i", " ".join(sets))
    fragments = {}
    for fname, field in idx.fields.items():
        for vname, view in field.views.items():
            for shard, frag in view.fragments.items():
                fragments[("i", fname, vname, shard)] = frag.rows_matrix_host()
    th = convert.holder_from_arrays(jh.schema(), fragments, device="cpu")
    # the result cache off: these tests hold the kernel paths and their
    # own caches, which a result-cache hit on a repeat query would skip
    return je, TorchExecutor(th, rescache_entries=0), rng


def _same(je, te, query, shards=None):
    want = _norm(je.execute("i", query, shards=shards))
    got = _norm(te.execute("i", query, shards=shards))
    assert got == want, query
    return got


def _random_tree(rng, depth=0):
    if depth >= 3 or rng.random() < 0.3:
        kind = int(rng.integers(0, 10))
        if kind == 0:
            return f"Row(g={int(rng.integers(0, N_ROWS + 2))})"
        if kind == 1:
            return "Row(nope=1)"  # no such field: declines
        if kind == 2:
            return "Row(h=0)"
        return f"Row(f={int(rng.integers(0, N_ROWS + 2))})"  # some rows absent
    r = rng.random()
    if r < 0.15:
        return f"Not({_random_tree(rng, depth + 1)})"
    if r < 0.2:
        return f"Shift({_random_tree(rng, depth + 1)}, n=3)"  # declines
    op = ("Intersect", "Union", "Difference", "Xor")[int(rng.integers(0, 4))]
    kids = ", ".join(_random_tree(rng, depth + 1) for _ in range(int(rng.integers(1, 4))))
    return f"{op}({kids})"


class _Spy:
    """Counts calls of port kernel wrappers (the CPU launches nothing)."""

    def __init__(self, monkeypatch, *names):
        self.calls = dict.fromkeys(names, 0)
        for name in names:
            real = getattr(tk, name)

            def wrapped(*a, _real=real, _name=name, **k):
                self.calls[_name] += 1
                return _real(*a, **k)

            monkeypatch.setattr(tk, name, wrapped)


@pytest.fixture(scope="module")
def built():
    return _build(3)


# -- (a) signatures ---------------------------------------------------------


def _match_both(je, te, text):
    """(jax, port) match results of one call: (sig, leaves, pairs)."""
    out = []
    for mod, pql, ex in ((jast, jpql, je), (tast, tpql, te)):
        call = pql.parse(text).calls[0]
        idx = ex.holder.index("i")
        leaves, pairs = [], []
        if call.name == "Count":
            sig = mod.match_count(idx, call, leaves, pairs)
        else:
            sig = mod.match_tree(idx, call, leaves, pairs)
        out.append((sig, leaves, pairs) if sig is not None else None)
    return out


def _signature_cases():
    rng = np.random.default_rng(2026)
    trees = list(TREES) + [_random_tree(rng) for _ in range(200)]
    return trees + [f"Count({t})" for t in trees] + ["Count(Row(f=1))"]


def test_signatures_match_jax(built):
    je, te, _ = built
    matched = 0
    for text in _signature_cases():
        want, got = _match_both(je, te, text)
        assert got == want, text
        matched += want is not None
    assert matched > 150  # most random trees are compilable


# -- (b) run_count_batch and run_bitmap ---------------------------------------

SIGS = [
    ("intersect", ("row", 0), ("row", 1), ("row", 2)),
    ("union", ("intersect", ("row", 0), ("row", 1)), ("difference", ("row", 0), ("row", 1))),
    ("difference", ("row", 2), ("row", 0)),
    ("xor", ("row", 0), ("row", 0), ("row", 0)),
    ("difference", ("row", 0), ("row", 1), ("row", 2), ("row", 1)),
    ("union", ("row", 1)),
]


def _chain(n):
    """A right-nested tree of ``n`` leaves, one node per level."""
    sig = ("row", 0)
    for k in range(n - 1):
        op = ("intersect", "union", "xor", "difference")[k % 4]
        sig = (op, ("row", k % 3), sig)
    return sig


def _balanced(levels, k=0):
    """A full binary tree of 2**levels leaves, the operators alternating by
    level (a difference whose subtrahend needs more entries than its
    minuend among them)."""
    if levels == 0:
        return ("row", k % 3)
    op = ("difference", "union", "xor", "intersect")[levels % 4]
    return (op, _balanced(levels - 1, 2 * k), _balanced(levels - 1, 2 * k + 1))


# programs whose evaluation order differs from the traversal order: a
# subtrahend before its minuend (NOTAND), subtrahends ORed first
REORDERED = [
    ("difference", ("row", 0), ("union", ("row", 1), ("row", 2)), ("row", 1)),
    ("difference", ("row", 0), ("xor", ("row", 1), ("row", 2)),
     ("intersect", ("row", 2), ("row", 0))),
]
LARGE = [_chain(40), _balanced(5), ("union",) + tuple(("row", k % 3) for k in range(300))]


def _stacks(rng, rows=(5, 7, 1), S=N_SHARDS, W=SHARD_WORDS):
    return [
        rng.integers(0, 2**32, size=(S, r, W), dtype=np.uint64).astype(np.uint32)
        for r in rows
    ]


def _slots(rng, sig, stacks_np, B):
    p = tast.program(sig)
    rows = np.array([stacks_np[k].shape[1] for k in p.leaf_stack])
    slots = (rng.random((B, p.n_leaves)) * rows).astype(np.int32)
    slots[rng.random((B, p.n_leaves)) < 0.2] = -1  # absent rows
    return slots


@pytest.mark.parametrize("sig", SIGS + REORDERED + LARGE, ids=lambda s: str(s)[:60])
def test_run_count_batch_and_bitmap_match_jax(sig, monkeypatch):
    rng = np.random.default_rng(len(str(sig)))
    stacks_np = _stacks(rng)
    slots = _slots(rng, sig, stacks_np, 9)
    j_stacks = tuple(jnp.asarray(s) for s in stacks_np)
    t_stacks = tuple(torch.from_numpy(s.view(np.int32)) for s in stacks_np)
    want = jast.run_count_batch(sig, j_stacks, slots)
    spy = _Spy(monkeypatch, "tree_count", "tree_words")
    got = tast.run_count_batch(sig, t_stacks, slots)
    assert spy.calls == {"tree_count": 1, "tree_words": 0}
    np.testing.assert_array_equal(got, want)
    for row in slots[:3]:
        w = np.asarray(jast.run_bitmap(sig, j_stacks, row))
        g = tast.run_bitmap(sig, t_stacks, row).numpy().view(np.uint32)
        np.testing.assert_array_equal(g, w)


def test_plain_tree_matches_numpy_with_an_empty_stack():
    """A 0-row stack (every slot -1) and slot -1 leaves are zero leaves."""
    rng = np.random.default_rng(5)
    stacks_np = _stacks(rng, rows=(4, 0), S=2, W=130)
    sig = ("union", ("difference", ("row", 0), ("row", 1)), ("row", 1))
    slots = np.array([[1, -1, -1], [-1, -1, -1], [3, -1, -1]], np.int32)
    t_stacks = tuple(torch.from_numpy(s.view(np.int32)) for s in stacks_np)
    p = tast.program(sig)
    got = tk.tree_count(t_stacks, p.code, p.leaf_stack, slots).numpy()
    want = np.zeros((3, 2), np.int64)
    for b, (a, _, _) in enumerate(slots):
        if a >= 0:
            want[b] = np.bitwise_count(stacks_np[0][:, a]).sum(axis=1)
    np.testing.assert_array_equal(got, want)
    words = tk.tree_words(t_stacks, p.code, p.leaf_stack, slots[2]).numpy().view(np.uint32)
    np.testing.assert_array_equal(words, stacks_np[0][:, 3])


def test_program_is_cached_on_the_signature():
    sig = ("intersect", ("row", 0), ("row", 1), ("row", 0))
    tast.program(sig)
    before = tast.program.cache_info()
    p = tast.program(sig)
    assert tast.program.cache_info().hits == before.hits + 1
    assert p.code.tolist() == [0, 1, tk.TREE_AND, 2, tk.TREE_AND]
    assert p.leaf_stack.tolist() == [0, 1, 0] and p.depth == 2


@pytest.mark.parametrize(
    "sig,code",
    [
        (REORDERED[0],
         [1, 2, tk.TREE_OR, 0, tk.TREE_NOTAND, 3, tk.TREE_ANDNOT]),
        (REORDERED[1],
         [1, 2, tk.TREE_XOR, 3, 4, tk.TREE_AND, tk.TREE_OR, 0, tk.TREE_NOTAND]),
        (("union", ("row", 0), ("intersect", ("row", 1), ("row", 2))),
         [1, 2, tk.TREE_AND, 0, tk.TREE_OR]),
    ],
    ids=["subtrahend-first", "subtrahends-ored", "deeper-child-first"],
)
def test_program_evaluates_the_deeper_child_first(sig, code):
    assert tast.program(sig).code.tolist() == code


@pytest.mark.parametrize("seed", range(3))
def test_program_depth_is_logarithmic_in_the_leaves(seed):
    """Every tree, however nested, needs at most floor(log2(L)) + 1 operand
    stack entries, and so fits the kernel's TREE_MAX_DEPTH."""
    rng = np.random.default_rng(seed)

    def tree(d):
        if d > 12 or rng.random() < 0.25:
            return ("row", int(rng.integers(0, 3)))
        op = ("intersect", "union", "xor", "difference")[int(rng.integers(0, 4))]
        return (op,) + tuple(tree(d + 1) for _ in range(int(rng.integers(1, 4))))

    for sig in [tree(0) for _ in range(60)] + LARGE + [_balanced(8)]:
        p = tast.program(sig)
        assert p.depth <= int(np.log2(p.n_leaves)) + 1 <= tk.TREE_MAX_DEPTH, sig
    assert tast.program(_balanced(8)).depth == 9


@pytest.mark.parametrize(
    "code,leaves,msg",
    [
        ([0, 1], 2, "results"),
        ([0, tk.TREE_AND], 1, "fewer than two"),
        ([0, 1, -9], 2, "unknown opcode"),
        ([0, 3, tk.TREE_OR], 2, "leaf 3"),
    ],
)
def test_malformed_programs_raise(code, leaves, msg):
    with pytest.raises(ValueError, match=msg):
        tk.tree_depth(code, leaves)


def test_wrapper_refuses_programs_past_its_limits():
    stacks = (torch.zeros((2, 3, 8), dtype=torch.int32),)
    # no tree compiles to this: TREE_MAX_DEPTH + 1 leaves pushed, then folded
    n = tk.TREE_MAX_DEPTH + 1
    code = np.array(list(range(n)) + [tk.TREE_OR] * (n - 1), np.int32)
    leaf_stack = np.zeros(n, np.int32)
    slots = np.zeros((1, n), np.int32)
    for fn in (tk.tree_count, tk.tree_count_plain):
        with pytest.raises(ValueError, match="stack entries"):
            fn(stacks, code, leaf_stack, slots)
    with pytest.raises(ValueError, match="stack entries"):
        tk.tree_words(stacks, code, leaf_stack, slots[0])
    # one entry less runs
    n -= 1
    code = np.array(list(range(n)) + [tk.TREE_OR] * (n - 1), np.int32)
    got = tk.tree_count(stacks, code, leaf_stack[:n], slots[:, :n])
    assert got.tolist() == [[0, 0]]
    p = tast.program(SIGS[0])
    with pytest.raises(ValueError, match="past its stack"):
        tk.tree_count(stacks * 3, p.code, p.leaf_stack, np.full((1, 3), 3, np.int32))
    with pytest.raises(TypeError, match="int32 slots"):
        tk.tree_count(stacks * 3, p.code, p.leaf_stack, np.zeros((1, 3), np.int64))


# -- (c) both executors -------------------------------------------------------


@pytest.mark.parametrize("tree", TREES)
def test_count_and_bitmap_trees_match(built, tree):
    je, te, _ = built
    _same(je, te, f"Count({tree}) Count({tree})")
    _same(je, te, f"{tree} {tree}")
    _same(je, te, f"Count({tree}) {tree}", shards=[0, 2])


@pytest.mark.parametrize("seed", range(2))
def test_execute_batch_of_random_trees_matches(seed):
    je, te, rng = _build(40 + seed)
    queries = []
    for k in range(40):
        tree = _random_tree(rng)
        q = f"Count({tree})" if k % 3 else tree
        queries.append((q, None if k % 5 else [1, 2]))
    want = _norm(je.execute_batch("i", queries))
    got = _norm(te.execute_batch("i", queries))
    assert got == want


def test_write_barrier_and_mixed_calls_match(monkeypatch):
    je, te, _ = _build(7)
    spy = _Spy(monkeypatch, "tree_count", "tree_words")
    # the Counts after the write must see it: they are not batched
    q = ("Set(17, f=0) Count(Union(Row(f=0), Row(f=1), Row(f=2))) "
         "Count(Union(Row(f=0), Row(f=1), Row(f=2)))")
    _same(je, te, q)
    assert spy.calls["tree_count"] == 0
    # counts and a bitmap tree share the stacks of f and g
    _same(je, te,
          "Count(Intersect(Row(f=0), Row(f=1), Row(g=0))) "
          "Union(Row(f=0), Row(g=1), Row(g=2)) "
          "Count(Intersect(Row(f=2), Row(f=3), Row(g=1)))")
    assert spy.calls == {"tree_count": 1, "tree_words": 1}
    # Not through the existence field, after more writes
    _same(je, te, "Set(99, g=5) Clear(17, f=0)")
    _same(je, te, "Count(Not(Row(f=3))) Count(Not(Union(Row(f=3), Row(g=5)))) "
                  "Not(Row(g=999))")
    assert spy.calls == {"tree_count": 3, "tree_words": 2}


def test_cold_single_call_stays_on_the_host_tier(monkeypatch):
    je, te, _ = _build(8)
    spy = _Spy(monkeypatch, "tree_count", "tree_words")
    _same(je, te, "Count(Intersect(Row(f=1), Row(g=2), Row(h=0)))")
    _same(je, te, "Xor(Row(f=1), Row(g=2))")
    assert spy.calls == {"tree_count": 0, "tree_words": 0}
    assert te.stack_rebuilds == 0
    # two calls demand the stacks; afterwards a lone call rides them
    _same(je, te, "Xor(Row(f=1), Row(g=2)) Count(Xor(Row(f=1), Row(g=3)))")
    _same(je, te, "Count(Intersect(Row(f=1), Row(g=2), Row(f=0)))")
    assert spy.calls == {"tree_count": 2, "tree_words": 1}


def test_time_range_leaf_is_not_ported():
    """Time-range leaves are ported: on a field without a time quantum the
    batch declines the leaf and both executors raise JAX's error (windowed
    reads on a time field: tests/test_torch_time.py)."""
    je, te, _ = _build(9)
    leaf = "Row(f=1, from='2010-01-01T00:00', to='2011-01-01T00:00')"
    query = f"Count(Intersect({leaf}, Row(f=2))) " * 2
    with pytest.raises(JaxExecuteError) as want:
        je.execute("i", query)
    with pytest.raises(ExecuteError, match="has no time quantum") as got:
        te.execute("i", query)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("shape", ["nested", "wide"])
def test_wide_and_deep_trees_ride_the_kernel(monkeypatch, shape):
    """A tree nested 40 deep and a Union of 300 rows are answered by one
    tree-kernel call each, as any other matched tree, never by the host
    tier."""
    je, te, _ = _build(10)
    if shape == "nested":
        tree = "Row(f=0)"
        for k in range(40):
            op = ("Intersect", "Union", "Xor", "Difference", "Not")[k % 5]
            tree = (f"Not({tree})" if op == "Not"
                    else f"{op}(Row(f={k % N_ROWS}), Row(g={(k + 1) % N_ROWS}), {tree})")
    else:
        tree = "Union(" + ", ".join(
            f"Row({'fg'[k % 2]}={k % (N_ROWS + 1)})" for k in range(300)) + ")"
    spy = _Spy(monkeypatch, "tree_count", "tree_words")
    _same(je, te, f"Count({tree}) Count({tree}) {tree} {tree}")
    assert spy.calls == {"tree_count": 1, "tree_words": 2}


# -- (d) one launch per group ---------------------------------------------------


def test_one_tree_count_per_signature_and_stacks(monkeypatch):
    je, te, rng = _build(11)
    spy = _Spy(monkeypatch, "tree_count", "tree_words")
    shapes = [
        "Count(Intersect(Row(f={a}), Row(g={b}), Row(h=0)))",
        "Count(Union(Intersect(Row(f={a}), Row(g={b})), Difference(Row(f={b}), Row(g={a}))))",
        "Count(Not(Row(f={a})))",
        "Count(Xor(Row(f={a}), Row(f={b}), Row(f={a})))",
        # the first shape over other stacks: a group of its own
        "Count(Intersect(Row(g={a}), Row(f={b}), Row(h=0)))",
    ]
    queries = []
    for k in range(50):
        a, b = (int(x) for x in rng.integers(0, N_ROWS + 1, size=2))
        queries.append((shapes[k % len(shapes)].format(a=a, b=b), None))
    # the flight planner off: it would sort the fifth shape's children as
    # the first's, one group for both (below)
    te.planner.enabled = False
    got = _norm(te.execute_batch("i", queries))
    assert spy.calls == {"tree_count": len(shapes), "tree_words": 0}
    assert got == _norm(je.execute_batch("i", queries))
    te.planner.enabled = True
    spy.calls = {k: 0 for k in spy.calls}
    uploads = te.shared_stack_uploads
    assert _norm(te.execute_batch("i", queries)) == got
    # the reorder merges the fifth shape's group into the first's; the
    # Counts whose whole child the planner shared read the flight's shared
    # stack, one group more; a shared subtree is a tree_words launch where
    # the lane choice sends it to the card
    shared = te.planner.snapshot()["cseShared"]
    assert shared >= 1 and te.shared_stack_uploads == uploads + 1
    assert spy.calls["tree_count"] == len(shapes) and spy.calls["tree_words"] <= shared, (
        spy.calls, shared)
    assert te.planner.reorders >= 1
