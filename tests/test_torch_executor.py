"""The port's Executor against ``pilosa_tpu.exec.executor.Executor``.

A seeded differential workload in the style of
``tests/test_fuzz_executor.py``: one JAX holder is written through its
executor and exported row by row; the port's holder is built from those
arrays with ``convert.holder_from_arrays`` (on the CPU). Then the same
reads and interleaved writes run through both executors, through
``execute`` and ``execute_batch``, and every answer must be equal: pair
count batches (gram path, subset grams, the declined-gram scans), lone
counts, Intersect/Union/Difference/Xor/Not/Shift trees, and filtered,
tanimoto and unfiltered TopN with ``n``, ``ids`` and ``threshold``. Writes
to a few shards patch the cached stacks (the incremental update), and the
caches computed from the old snapshot must not answer after them.
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

from pilosa_tpu.core.field import FieldOptions as JaxFieldOptions
from pilosa_tpu.core.holder import Holder as JaxHolder
from pilosa_tpu.exec.executor import Executor as JaxExecutor
from pilosa_tpu.ops import kernels as jk
from pilosa_tpu_torch import convert
from pilosa_tpu_torch.exec.executor import ExecuteError, Executor as TorchExecutor
from pilosa_tpu_torch.ops import kernels as tk
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH


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
OPS = ["Intersect", "Union", "Difference", "Xor"]


def _norm(r):
    """Results of either package as plain comparable data."""
    if isinstance(r, Exception):
        return ("error", type(r).__name__)
    if isinstance(r, list):
        return [_norm(x) for x in r]
    if hasattr(r, "columns") and hasattr(r, "segments"):
        return ("row", [int(c) for c in r.columns()], dict(r.attrs))
    if hasattr(r, "id") and hasattr(r, "count"):
        return ("pair", int(r.id), int(r.count))
    if hasattr(r, "group") and hasattr(r, "count"):
        return ("group", [(g.field, int(g.row_id)) for g in r.group], int(r.count))
    if isinstance(r, (bool, int, np.integer)):
        return r if isinstance(r, bool) else int(r)
    raise TypeError(type(r))


def _build(seed: int):
    """(jax executor, port executor) over the same seeded data."""
    rng = np.random.default_rng(seed)
    jh = JaxHolder()
    idx = jh.create_index("i")
    idx.create_field("f")
    idx.create_field("g")
    idx.create_field("m", JaxFieldOptions(field_type="mutex"))
    idx.create_field("b", JaxFieldOptions(field_type="bool"))
    je = JaxExecutor(jh)
    n_cols = N_SHARDS * SHARD_WIDTH
    for fname, density in (("f", 3000), ("g", 1500)):
        rows = rng.integers(0, N_ROWS, size=density).astype(np.uint64)
        cols = rng.integers(0, n_cols, size=density).astype(np.uint64)
        idx.field(fname).import_bits(rows, cols)
    sets = []
    for _ in range(150):
        col = int(rng.integers(0, n_cols))
        sets.append(f"Set({col}, f={int(rng.integers(0, N_ROWS))})")
        sets.append(f"Set({col}, m={int(rng.integers(0, 3))})")
        sets.append(f"Set({col}, b={'true' if rng.integers(0, 2) else 'false'})")
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
    if depth >= 2 or rng.random() < 0.35:
        kind = int(rng.integers(0, 4))
        if kind == 0:
            return f"Row(g={int(rng.integers(0, N_ROWS))})"
        if kind == 1:
            return f"Row(b={'true' if rng.integers(0, 2) else 'false'})"
        return f"Row(f={int(rng.integers(0, N_ROWS + 1))})"
    r = rng.random()
    if r < 0.12:
        return f"Not({_random_tree(rng, depth + 1)})"
    if r < 0.22:
        return f"Shift({_random_tree(rng, depth + 1)}, n={int(rng.integers(0, 40))})"
    op = OPS[int(rng.integers(0, 4))]
    kids = ", ".join(_random_tree(rng, depth + 1) for _ in range(int(rng.integers(2, 4))))
    return f"{op}({kids})"


def _pair_counts(rng, n, rows=N_ROWS + 1):
    return [
        f"Count({OPS[int(rng.integers(0, 4))]}(Row(f={int(rng.integers(0, rows))}), "
        f"Row(f={int(rng.integers(0, rows))})))"
        for _ in range(n)
    ]


def test_holder_from_arrays_matches_schema_and_rows():
    je, te, _ = _build(0)
    assert te.holder.schema() == je.holder.schema()
    for fname in ("f", "g", "m", "b", "_exists"):
        jv = je.holder.field("i", fname).view("standard")
        tv = te.holder.field("i", fname).view("standard")
        assert sorted(jv.fragments) == sorted(tv.fragments)
        for s in jv.fragments:
            j_ids, j_mat = jv.fragments[s].rows_matrix_host()
            t_ids, t_mat = tv.fragments[s].rows_matrix_host()
            assert j_ids == t_ids
            np.testing.assert_array_equal(j_mat, t_mat)


@pytest.mark.parametrize("seed", range(3))
def test_pair_count_batches_match(seed):
    je, te, rng = _build(seed)
    for _ in range(3):
        _same(je, te, " ".join(_pair_counts(rng, 40)))
    assert te.stack_rebuilds >= 1
    # subset batches: two distinct rows of seven, repeated until the full
    # gram is cached, then served from it
    for _ in range(4):
        a, b = (int(x) for x in rng.choice(N_ROWS, size=2, replace=False))
        _same(je, te, f"Count(Intersect(Row(f={a}), Row(f={b}))) "
                      f"Count(Xor(Row(f={b}), Row(f={a})))")
    assert te.gram_cache_hits >= 1


@pytest.mark.parametrize("seed", range(2))
def test_pair_counts_through_declined_gram_match(monkeypatch, seed):
    # more distinct rows than the gram takes: the batched scans answer
    monkeypatch.setattr(jk, "GRAM_MAX_ROWS", 2)
    monkeypatch.setattr(tk, "GRAM_MAX_ROWS", 2)
    je, te, rng = _build(10 + seed)
    _same(je, te, " ".join(_pair_counts(rng, 30)))
    _same(je, te, " ".join(_pair_counts(rng, 30)), shards=[0, 2])


@pytest.mark.parametrize("seed", range(2))
def test_execute_batch_matches(seed):
    je, te, rng = _build(20 + seed)
    queries = []
    for k in range(24):
        if k % 6 == 5:
            queries.append((_random_tree(rng), None))
        elif k % 6 == 4:
            queries.append(("Count(Row(f=1)) TopN(f, Row(g=2), n=3)", [0, 1]))
        elif k % 6 == 3:
            queries.append(("Count(Rows(f))", None))  # fails in both
        else:
            queries.append((" ".join(_pair_counts(rng, 3)), None))
    want = _norm(je.execute_batch("i", queries))
    got = _norm(te.execute_batch("i", queries))
    for q, g, w in zip(queries, got, want):
        if isinstance(w, tuple) and w[0] == "error":
            assert isinstance(g, tuple) and g[0] == "error", q
        else:
            assert g == w, q


@pytest.mark.parametrize("seed", range(3))
def test_lone_counts_and_trees_match(seed):
    je, te, rng = _build(30 + seed)
    for q in _pair_counts(rng, 8):  # lone counts cross the gram warm-up
        _same(je, te, q)
    for r in range(N_ROWS + 1):
        _same(je, te, f"Count(Row(f={r}))")
    for _ in range(25):
        tree = _random_tree(rng)
        _same(je, te, tree)
        _same(je, te, f"Count({tree})")
        _same(je, te, tree, shards=[1, 2])


@pytest.mark.parametrize("seed", range(3))
def test_topn_matches(seed):
    je, te, rng = _build(40 + seed)
    filters = ["Row(g=1)", "Union(Row(g=2), Row(g=3))", "Not(Row(g=0))", "Row(g=99)"]
    for filt in filters:
        _same(je, te, f"TopN(f, {filt})")
        _same(je, te, f"TopN(f, {filt}, n=3)")
        _same(je, te, f"TopN(f, {filt}, threshold=40)")
        _same(je, te, f"TopN(f, {filt}, ids=[0, 2, 5, 50])")
        _same(je, te, f"TopN(f, {filt}, tanimotoThreshold={int(rng.integers(1, 60))})")
        _same(je, te, f"TopN(f, {filt}, n=2)", shards=[0, 2])
    _same(je, te, "TopN(f)")
    _same(je, te, "TopN(f, n=4)")
    _same(je, te, "TopN(g, ids=[1, 3, 77])")
    _same(je, te, "TopN(m, n=2) TopN(b)")


@pytest.mark.parametrize("shards", [None, [N_SHARDS + 4]])
def test_filtered_topn_over_rowless_field_matches(shards):
    """A filtered TopN whose field holds no rows over the shards asked for
    (every row cleared, or a shard with no fragment) answers empty, as the
    JAX package does."""
    je, te, _ = _build(45)
    clear = " ".join(f"ClearRow(f={r})" for r in range(N_ROWS))
    _same(je, te, clear)
    for q in ("TopN(f, Row(g=1))", "TopN(f, Row(g=2), tanimotoThreshold=5)",
              "TopN(f, Not(Row(g=0)), ids=[0, 3])"):
        _same(je, te, q, shards=shards)


@pytest.mark.parametrize("seed", range(3))
def test_interleaved_writes_match(seed):
    je, te, rng = _build(50 + seed)
    n_cols = N_SHARDS * SHARD_WIDTH
    for _ in range(12):
        writes = []
        for _ in range(int(rng.integers(1, 6))):
            col = int(rng.integers(0, n_cols))
            r = int(rng.integers(0, N_ROWS + 2))
            kind = rng.random()
            if kind < 0.5:
                writes.append(f"Set({col}, f={r})")
            elif kind < 0.8:
                writes.append(f"Clear({col}, f={r})")
            elif kind < 0.9:
                writes.append(f"Set({col}, m={r % 3})")
            else:
                writes.append(f"ClearRow(f={r})")
        reads = _pair_counts(rng, 6) + [
            f"TopN(f, Row(g={int(rng.integers(0, N_ROWS))}), tanimotoThreshold=5)",
            "TopN(f, n=3)",
            f"Count({_random_tree(rng)})",
        ]
        # reads before, between and after writes in one query
        _same(je, te, " ".join(reads[:3] + writes + reads[3:]))
        _same(je, te, " ".join(reads))
        _same(je, te, "Count(Not(Row(f=0))) TopN(m) TopN(b)")


def test_errors_match():
    je, te, _ = _build(60)
    for q in [
        "Count()",
        "Count(Row(nope=1))",
        "Intersect()",
        "TopN(nope)",
        "TopN(f, Row(g=1), Row(g=2))",
        "TopN(f, tanimotoThreshold=101)",
        "Row(f=1, g=2) Foo()",
        # a range condition on a set field (int fields are served)
        "Row(f > 3)",
    ]:
        with pytest.raises(Exception) as want:
            je.execute("i", q)
        with pytest.raises(ExecuteError) as got:
            te.execute("i", q)
        assert type(got.value).__name__ == type(want.value).__name__, q


@pytest.mark.parametrize(
    "query",
    [
        # the time-range forms on a field without a time quantum
        pytest.param(
            "Rows(f, from='2010-01-01T00:00', to='2011-01-01T00:00')", id="Rows(f)"
        ),
        pytest.param(
            "GroupBy(Rows(f, from='2010-01-01T00:00'))", id="GroupBy(Rows(f))"
        ),
        "Options(Row(f=1), excludeColumns=true)",
        "Store(Row(f=1), f=9)",
        "SetRowAttrs(f, 1, x=2)",
        "Row(f=1, from='2010-01-01T00:00', to='2011-01-01T00:00')",
        "TopN(f, attrName='x')",
        "Set(5, f=1, 2010-01-01T00:00)",
    ],
)
def test_unported_calls_raise(query):
    """The calls an earlier slice refused are ported: each answers as JAX
    does, in ``result_to_json`` form, or raises JAX's error (f has no time
    quantum)."""
    from pilosa_tpu.exec.result import result_to_json as jax_json
    from pilosa_tpu_torch.exec.result import result_to_json as torch_json

    je, te, _ = _build(61)
    outs = []
    for ex, to_json in ((je, jax_json), (te, torch_json)):
        try:
            outs.append(to_json(ex.execute("i", query)))
        except Exception as e:  # both must fail alike
            outs.append(("error", type(e).__name__, str(e)))
    assert outs[1] == outs[0], query


def test_keyed_index_raises():
    """A keyed index is served; an integer column on it raises JAX's
    error."""
    from pilosa_tpu_torch.core.holder import Holder

    h = Holder(device="cpu")
    h.create_index("k", keys=True).create_field("f")
    ex = TorchExecutor(h)
    with pytest.raises(ExecuteError, match="column value must be a string when index "
                       "'keys' option enabled"):
        ex.execute("k", "Set(1, f=1)")
    assert ex.execute("k", 'Set("a", f=1)') == [True]
    assert ex.execute("k", "Row(f=1)")[0].keys == ["a"]


# -- the incremental stack update (counterparts of
#    tests/test_executor_batch.py:155-200)

_PAIRS_Q = "Count(Intersect(Row(f=0), Row(f=1))) Count(Union(Row(f=2), Row(f=3)))"


def test_interleaved_writes_update_stack_incrementally():
    """Writes to rows the stack holds, in one shard, patch that shard's
    block into the cached stack instead of rebuilding it."""
    je, te, _ = _build(70)
    _same(je, te, _PAIRS_Q)
    rebuilds0 = te.stack_rebuilds
    for i in range(4):
        _same(je, te, f"Set({100 + i}, f=0) Set({100 + i}, f=1) Clear({200 + i}, f=2)")
        _same(je, te, _PAIRS_Q)
    assert te.stack_incremental == 4
    assert te.stack_rebuilds == rebuilds0


def test_new_row_forces_full_rebuild():
    je, te, _ = _build(71)
    _same(je, te, _PAIRS_Q)
    r0 = te.stack_rebuilds
    _same(je, te, "Set(77, f=40)")  # row 40 did not exist
    got = _same(je, te, _PAIRS_Q + " Count(Intersect(Row(f=40), Row(f=40)))")
    assert got[2] == 1
    assert te.stack_rebuilds == r0 + 1 and te.stack_incremental == 0


def test_writes_to_most_shards_force_full_rebuild():
    """Past half of the shards changed, one rebuild replaces the patch."""
    je, te, _ = _build(72)
    _same(je, te, _PAIRS_Q)
    r0 = te.stack_rebuilds
    _same(je, te, f"Set(5, f=0) Set({SHARD_WIDTH + 5}, f=1)")  # 2 of 3 shards
    _same(je, te, _PAIRS_Q)
    assert te.stack_rebuilds == r0 + 1 and te.stack_incremental == 0
    _same(je, te, f"Set({2 * SHARD_WIDTH + 6}, f=1)")  # 1 of 3 shards
    _same(je, te, _PAIRS_Q)
    assert te.stack_rebuilds == r0 + 1 and te.stack_incremental == 1


@pytest.mark.parametrize("cache", ["gram", "rowcounts", "crossgram"])
def test_stale_caches_cannot_answer_after_a_write(cache):
    """A full gram, the row totals and a cross gram cached on a stack
    snapshot answer repeat queries; after a write patches the stack they
    belong to the old snapshot and must not answer."""
    je, te, rng = _build(73)
    query = {
        # every row of f: the full gram is computed and cached
        "gram": " ".join(
            f"Count({OPS[k % 4]}(Row(f={k % N_ROWS}), Row(f={(3 * k + 1) % N_ROWS})))"
            for k in range(12)
        ),
        "rowcounts": "TopN(f, Row(g=1), tanimotoThreshold=5)",
        "crossgram": "GroupBy(Rows(f), Rows(g))",
    }[cache]
    for _ in range(2):
        _same(je, te, query)
    entry = next(iter(te._stacks[te.holder.field("i", "f")].values()))
    if cache == "crossgram":
        assert te.crossgram_cache_hits >= 1
    else:
        assert entry.get(cache) is not None
    # writes to shard 0 that move the answers: f gains columns of g's row
    # 1 and loses some of its own
    g1 = [int(c) for c in je.execute("i", "Row(g=1)")[0].columns() if c < SHARD_WIDTH]
    f0 = [int(c) for c in je.execute("i", "Row(f=0)")[0].columns() if c < SHARD_WIDTH]
    writes = [f"Set({c}, f={k % N_ROWS})" for k, c in enumerate(g1[:20])]
    writes += [f"Clear({c}, f=0)" for c in f0[:20]]
    rebuilds = te.stack_rebuilds
    _same(je, te, " ".join(writes))
    _same(je, te, query)
    assert te.stack_incremental >= 1 and te.stack_rebuilds == rebuilds
    _assert_caches_current(te)
    if cache == "crossgram":
        # and a write to the partner field, which patches g's stack
        _same(je, te, " ".join(f"Set({c}, g={k % N_ROWS})" for k, c in enumerate(f0[20:40])))
        _same(je, te, query)
        _same(je, te, "GroupBy(Rows(g), Rows(f))")
        assert te.stack_incremental >= 2 and te.stack_rebuilds == rebuilds
        _assert_caches_current(te)


def _assert_caches_current(te):
    """Every gram, row-total vector and cross gram cached on a stack entry
    describes the snapshot the entry serves now."""
    for entries in te._stacks.values():
        for e in entries.values():
            bits = e["dev"]
            R = bits.shape[1]
            if e.get("gram") is not None:
                np.testing.assert_array_equal(e["gram"], tk.pair_gram(bits, list(range(R))))
            if e.get("rowcounts") is not None:
                np.testing.assert_array_equal(e["rowcounts"], tk.row_counts(bits).numpy())
            for ref, g in (e.get("crossgram") or {}).values():
                partner = ref()
                if partner is not None:
                    np.testing.assert_array_equal(g, tk.cross_pair_gram(
                        bits, partner, list(range(R)), list(range(partner.shape[1]))))
