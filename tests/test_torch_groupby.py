"""Rows and GroupBy of the port's Executor against
``pilosa_tpu.exec.executor.Executor``.

A seeded differential workload in the style of
``tests/test_torch_executor.py``: one JAX holder is written through its
executor and carried over with ``convert.holder_from_arrays`` (on the
CPU). The same Rows and GroupBy queries, interleaved with Set/Clear
writes, run through both executors' ``execute`` and ``execute_batch``,
and every answer must be equal. Spies on the port's kernel wrappers show
which branch answered: the cross gram (two fields), the gram (one field),
the batched pair scans (a declined gram), the row scans (one level) and
the k-level prefix engine (a filter or three levels, in pieces when the
prefix budget is small). No GroupBy reads rows from the host mirrors.
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
from pilosa_tpu.exec.executor import ExecuteError as JaxExecuteError
from pilosa_tpu.exec.executor import Executor as JaxExecutor
from pilosa_tpu.ops import kernels as jk
from pilosa_tpu_torch import convert
from pilosa_tpu_torch.exec.executor import ExecuteError, Executor as TorchExecutor
from pilosa_tpu_torch.exec.result import Row
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
N_COLS = N_SHARDS * SHARD_WIDTH


def _norm(r):
    """Results of either package as plain comparable data."""
    if isinstance(r, Exception):
        return ("error", type(r).__name__)
    if isinstance(r, list):
        return [_norm(x) for x in r]
    if hasattr(r, "group") and hasattr(r, "count"):
        return ("group", [(g.field, int(g.row_id)) for g in r.group], int(r.count))
    if hasattr(r, "rows") and hasattr(r, "keys"):
        return ("rows", [int(x) for x in r.rows])
    if isinstance(r, (bool, int, np.integer)):
        return r if isinstance(r, bool) else int(r)
    raise TypeError(type(r))


def _build(seed: int):
    """(jax executor, port executor, rng) over the same seeded data: set
    fields f and g of N_ROWS rows, h of 3 rows, a bool field b, dense
    enough that most 3-level combinations are non-empty and some are
    empty."""
    rng = np.random.default_rng(seed)
    jh = JaxHolder()
    idx = jh.create_index("i")
    for name in ("f", "g", "h"):
        idx.create_field(name)
    idx.create_field("b", JaxFieldOptions(field_type="bool"))
    for fname, n_rows, n_bits in (("f", N_ROWS, 12000), ("g", N_ROWS, 9000), ("h", 3, 9000)):
        rows = rng.integers(0, n_rows, size=n_bits).astype(np.uint64)
        cols = rng.integers(0, N_COLS, size=n_bits).astype(np.uint64)
        idx.field(fname).import_bits(rows, cols)
    je = JaxExecutor(jh)
    sets = []
    for _ in range(120):
        col = int(rng.integers(0, N_COLS))
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


def _answer(ex, query, shards):
    try:
        return _norm(ex.execute("i", query, shards=shards))
    except Exception as e:  # both packages must fail alike
        return ("error", type(e).__name__, str(e))


def _same(je, te, query, shards=None):
    want = _answer(je, query, shards)
    got = _answer(te, query, shards)
    assert got == want, query
    return got


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

    def delta(self, fn):
        before = dict(self.calls)
        fn()
        return {k: self.calls[k] - before[k] for k in self.calls}


def _set_col(je, rng, field: str) -> int:
    """A column that some row of ``field`` holds."""
    cols = je.execute("i", f"Row({field}={int(rng.integers(0, 3))})")[0].columns()
    return int(cols[int(rng.integers(0, len(cols)))])


def _rows_queries(je, rng):
    return [
        "Rows(f)",
        "Rows(h)",
        "Rows(b)",
        f"Rows(f, column={_set_col(je, rng, 'f')})",
        f"Rows(f, column={int(rng.integers(0, N_COLS))})",
        f"Rows(g, column={_set_col(je, rng, 'g')}, limit=2)",
        f"Rows(f, previous={int(rng.integers(0, N_ROWS))})",
        "Rows(f, previous=2, limit=3)",
        "Rows(b, previous=false)",
        "Rows(f, limit=0)",
        "Rows(nope)",
    ]


def _groupby_queries(je, rng):
    a, b = (int(x) for x in rng.integers(0, N_ROWS, size=2))
    return [
        "GroupBy(Rows(f))",
        "GroupBy(Rows(f), Rows(g))",
        "GroupBy(Rows(g), Rows(f))",
        "GroupBy(Rows(f), Rows(f))",
        "GroupBy(Rows(f), Rows(g), limit=5)",
        f"GroupBy(Rows(f), Rows(g), previous=[{a}, {b}])",
        f"GroupBy(Rows(f), Rows(g), previous=[{a}, {b}], limit=4)",
        f"GroupBy(Rows(f), Rows(g), filter=Row(h={int(rng.integers(0, 3))}))",
        "GroupBy(Rows(h), Rows(g), Rows(f))",
        "GroupBy(Rows(f), Rows(g), Rows(h), limit=7)",
        "GroupBy(Rows(f, limit=3), Rows(g, previous=2), Rows(h))",
        "GroupBy(Rows(b), Rows(h), previous=[false, 1])",
        f"GroupBy(Rows(f), Rows(h), filter=Not(Row(g={a})))",
        f"GroupBy(Rows(f, column={_set_col(je, rng, 'f')}), Rows(g))",
    ]


@pytest.mark.parametrize("seed", range(2))
def test_rows_match(seed):
    je, te, rng = _build(seed)
    for q in _rows_queries(je, rng):
        _same(je, te, q)
        _same(je, te, q, shards=[0, 2])


@pytest.mark.parametrize("seed", range(3))
def test_groupby_match(seed, monkeypatch):
    je, te, rng = _build(10 + seed)
    spy = _Spy(monkeypatch, "cross_gram_gather", "gram_gather", "combo_counts_gram")
    for q in _groupby_queries(je, rng):
        _same(je, te, q)
    _same(je, te, "GroupBy(Rows(f), Rows(g)) GroupBy(Rows(h), Rows(g), Rows(f))",
          shards=[1, 2])
    assert spy.calls["cross_gram_gather"] >= 1
    assert spy.calls["gram_gather"] >= 1
    assert spy.calls["combo_counts_gram"] >= 1


@pytest.mark.parametrize("seed", range(3))
def test_groupby_interleaved_with_writes_match(seed):
    je, te, rng = _build(20 + seed)
    queries = _groupby_queries(je, rng)
    for _ in range(8):
        writes = []
        for _ in range(int(rng.integers(1, 6))):
            col = int(rng.integers(0, N_COLS))
            fld = ("f", "g", "h")[int(rng.integers(0, 3))]
            r = int(rng.integers(0, 3 if fld == "h" else N_ROWS + 1))
            op = "Set" if rng.random() < 0.6 else "Clear"
            writes.append(f"{op}({col}, {fld}={r})")
        reads = [queries[int(k)] for k in rng.choice(len(queries), size=3, replace=False)]
        _same(je, te, " ".join(reads[:1] + writes + reads[1:] + ["Rows(f)"]))
        _same(je, te, " ".join(reads))


@pytest.mark.parametrize("seed", range(2))
def test_groupby_execute_batch_matches(seed):
    je, te, rng = _build(30 + seed)
    gq = _groupby_queries(je, rng)
    rq = _rows_queries(je, rng)
    queries = []
    for k in range(18):
        if k % 6 == 5:
            col = int(rng.integers(0, N_COLS))
            queries.append((f"Set({col}, g={int(rng.integers(0, N_ROWS))}) {gq[1]}", None))
        elif k % 3 == 1:
            queries.append((rq[k % len(rq)], [0, 1] if k % 2 else None))
        else:
            queries.append((gq[k % len(gq)] + " Count(Intersect(Row(f=1), Row(g=2)))", None))
    want = _norm(je.execute_batch("i", queries))
    got = _norm(te.execute_batch("i", queries))
    for q, g, w in zip(queries, got, want):
        if isinstance(w, tuple) and w[0] == "error":
            assert isinstance(g, tuple) and g[0] == "error", q
        else:
            assert g == w, q


def test_repeat_groupby_served_from_cross_gram(monkeypatch):
    je, te, _ = _build(40)
    spy = _Spy(monkeypatch, "cross_pair_gram")
    q = "GroupBy(Rows(f), Rows(g))"
    # every row of both fields: the full cross gram is computed at once
    assert spy.delta(lambda: _same(je, te, q)) == {"cross_pair_gram": 1}
    hits = te.crossgram_cache_hits
    for _ in range(3):
        assert spy.delta(lambda: _same(je, te, q)) == {"cross_pair_gram": 0}
    assert te.crossgram_cache_hits == hits + 3
    # the reversed order is the same slot, transposed
    assert spy.delta(lambda: _same(je, te, "GroupBy(Rows(g), Rows(f))")) == {
        "cross_pair_gram": 0
    }
    assert te.crossgram_cache_hits == hits + 4
    # a subset of rows is sliced from the cached gram too
    _same(je, te, "GroupBy(Rows(f, limit=2), Rows(g, previous=3))")
    assert te.crossgram_cache_hits == hits + 5


def test_subset_groupby_invests_after_reuse(monkeypatch):
    je, te, _ = _build(41)
    spy = _Spy(monkeypatch, "cross_pair_gram")
    q = "GroupBy(Rows(f, limit=2), Rows(g, limit=2))"
    for _ in range(te._GRAM_CACHE_MIN_REUSE):
        _same(je, te, q)
    assert te.crossgram_cache_hits == 0
    _same(je, te, q)  # the full gram is invested here
    assert spy.calls["cross_pair_gram"] == te._GRAM_CACHE_MIN_REUSE + 1
    _same(je, te, q)
    assert te.crossgram_cache_hits == 1


@pytest.mark.parametrize("written", ["f", "g"])
def test_write_to_either_field_drops_the_cross_gram(monkeypatch, written):
    je, te, rng = _build(42)
    spy = _Spy(monkeypatch, "cross_pair_gram")
    q = "GroupBy(Rows(f), Rows(g))"
    _same(je, te, q)
    _same(je, te, q)
    # a column that row 1 of the written field does not hold yet
    col = next(
        c for c in map(int, rng.integers(0, N_COLS, size=64))
        if not te.holder.field("i", written).get_bit(1, c)
    )
    _same(je, te, f"Set({col}, {written}=1)")
    hits = te.crossgram_cache_hits
    assert spy.delta(lambda: _same(je, te, q)) == {"cross_pair_gram": 1}
    assert spy.delta(lambda: _same(je, te, "GroupBy(Rows(g), Rows(f))")) == {
        "cross_pair_gram": 0
    }
    assert te.crossgram_cache_hits == hits + 1


def test_declined_gram_takes_the_pair_scans(monkeypatch):
    monkeypatch.setattr(jk, "GRAM_MAX_ROWS", 2)
    monkeypatch.setattr(tk, "GRAM_MAX_ROWS", 2)
    je, te, _ = _build(50)
    spy = _Spy(monkeypatch, "pair_count_two_batched", "combo_counts", "cross_gram_gather")
    _same(je, te, "GroupBy(Rows(f), Rows(g))")
    _same(je, te, "GroupBy(Rows(g), Rows(f), limit=9)", shards=[0, 2])
    _same(je, te, "GroupBy(Rows(f), Rows(f))")
    _same(je, te, "GroupBy(Rows(h), Rows(g), Rows(f))")
    _same(je, te, "GroupBy(Rows(f), Rows(g), filter=Row(h=1))")
    assert spy.calls["pair_count_two_batched"] >= 3  # same field delegates to it
    assert spy.calls["combo_counts"] >= 2
    assert spy.calls["cross_gram_gather"] == 0


def _mask_bytes(te):
    return N_SHARDS * te.holder.n_words * 4


def _no_host_counts(monkeypatch):
    """Make counting on the host mirrors (intersecting or counting a Row)
    fail for the rest of the test."""

    def refuse(*a, **k):
        raise AssertionError("a GroupBy counted rows on the host mirrors")

    monkeypatch.setattr(Row, "intersect", refuse)
    monkeypatch.setattr(Row, "count", refuse)


def test_shrunk_prefix_budget_chunks_the_batch(monkeypatch):
    je, te, _ = _build(51)
    budget = 6 * _mask_bytes(te)  # three masks a level at two levels, two at three
    monkeypatch.setattr(TorchExecutor, "_groupby_prefix_budget", lambda self, dev: budget)
    spy = _Spy(monkeypatch, "gather_prefix", "combo_counts_gram", "refine_prefix")
    sizes = []
    for name in ("gather_prefix", "refine_prefix"):
        counted = getattr(tk, name)

        def sized(*a, _f=counted, **k):
            out = _f(*a, **k)
            sizes.append(out.shape[0])
            return out

        monkeypatch.setattr(tk, name, sized)
    # seven rows of f in pieces of three masks
    assert spy.delta(lambda: _same(je, te, "GroupBy(Rows(f), Rows(g), filter=Row(h=0))")) == {
        "gather_prefix": 3, "combo_counts_gram": 3, "refine_prefix": 0,
    }
    assert max(sizes) == 3
    sizes.clear()
    # three rows of h in pieces of two, then their survivors in pieces of two
    d = spy.delta(lambda: _same(je, te, "GroupBy(Rows(h), Rows(g), Rows(f))"))
    assert d["gather_prefix"] == 2
    assert d["refine_prefix"] >= 2
    assert d["combo_counts_gram"] == d["gather_prefix"] + d["refine_prefix"]
    assert max(sizes) == 2
    _same(je, te, "GroupBy(Rows(f, limit=2), Rows(h), Rows(g), limit=11)")
    _same(je, te, "GroupBy(Rows(h), Rows(g), Rows(f), previous=[1, 3, 2])")


def test_one_level_groupby_takes_the_row_scans(monkeypatch):
    je, te, _ = _build(52)
    _no_host_counts(monkeypatch)
    spy = _Spy(monkeypatch, "row_counts", "masked_row_counts")
    assert spy.delta(lambda: _same(je, te, "GroupBy(Rows(f))")) == {
        "row_counts": 1, "masked_row_counts": 0,
    }
    _same(je, te, "GroupBy(Rows(b))", shards=[0, 2])
    _same(je, te, "GroupBy(Rows(f), previous=[3])")
    _same(je, te, "GroupBy(Rows(f, previous=1), limit=2)")
    for h in range(3):
        assert spy.delta(
            lambda: _same(je, te, f"GroupBy(Rows(g), filter=Row(h={h}))")
        ) == {"row_counts": 0, "masked_row_counts": 1}
    _same(je, te, "GroupBy(Rows(g), filter=Row(h=0), previous=[2], limit=3)", shards=[1])


@pytest.mark.parametrize(
    "query", ["GroupBy(Rows(f), Rows(g))", "GroupBy(Rows(f), Rows(f))",
              "GroupBy(Rows(h), Rows(g), Rows(f))"],
)
def test_pages_are_cut_from_the_batch(monkeypatch, query):
    """Paging with `previous` walks the whole answer, page by page, and each
    page is counted on the stacks (no host reads)."""
    je, te, _ = _build(53)
    full = _same(je, te, query)[0]

    def paged(bound, limit=""):
        return query[:-1] + f", previous=[{', '.join(map(str, bound))}]{limit})"

    # a bound inside the answer, without a limit: the rest of the answer
    bound = [rid for _, rid in full[3][1]]
    assert _same(je, te, paged(bound))[0] == full[4:]
    _no_host_counts(monkeypatch)
    spy = _Spy(monkeypatch, "cross_pair_gram", "pair_gram", "combo_counts_gram")
    pages, bound = [], None
    while True:
        q = query[:-1] + ", limit=5)" if bound is None else paged(bound, ", limit=5")
        page = _same(je, te, q)[0]
        if not page:
            break
        pages.extend(page)
        bound = [rid for _, rid in page[-1][1]]
    assert pages == full
    if "Rows(h)" in query:
        assert spy.calls["combo_counts_gram"] >= 2 * (len(full) // 5)
    else:
        assert te.crossgram_cache_hits + te.gram_cache_hits >= len(full) // 5


def test_groupby_errors_match():
    je, te, _ = _build(60)
    for q in [
        "GroupBy()",
        "GroupBy(Row(f=1))",
        "GroupBy(Rows(f), Count(Row(f=1)))",
        "GroupBy(Rows(nope), Rows(f))",
        "GroupBy(Rows(f), Rows(g), previous=[1])",
        "GroupBy(Rows(f), previous=['a'])",
        "Rows(f, column='x')",
        "Rows(f, previous='x')",
    ]:
        with pytest.raises(Exception) as want:
            je.execute("i", q)
        with pytest.raises(ExecuteError) as got:
            te.execute("i", q)
        assert type(got.value).__name__ == type(want.value).__name__, q
        assert str(got.value) == str(want.value), q


@pytest.mark.parametrize(
    "query",
    [
        "Rows(f, from='2010-01-01T00:00', to='2011-01-01T00:00')",
        "Rows(f, to='2011-01-01T00:00')",
        "GroupBy(Rows(f), Rows(g, from='2010-01-01T00:00'))",
    ],
)
def test_rows_with_time_range_is_not_ported(query):
    """Rows() with from/to is ported: on a field without a time quantum
    both executors raise JAX's error (time fields:
    tests/test_torch_time.py)."""
    je, te, _ = _build(61)
    with pytest.raises(JaxExecuteError) as want:
        je.execute("i", query)
    with pytest.raises(ExecuteError, match="has no time quantum") as got:
        te.execute("i", query)
    assert str(got.value) == str(want.value)
