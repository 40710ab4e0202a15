"""BSI queries of the port's Executor against ``pilosa_tpu``'s.

One JAX holder with set fields f and g and int fields v (0..1000, base 0),
w (-1000..1000, signed) and z (100..200, base 100) is written through its
executor and carried over with ``convert.holder_from_arrays`` (on the
CPU). Both executors answer the same PQL and every answer must be equal:
Range and ``Row(v ...)`` conditions of every op with signed and
out-of-range bounds, their Counts, Sum/Min/Max filtered and not,
MinRow/MaxRow, a GroupBy filtered by a condition, ``execute_batch`` mixes
that engage the batched BSI lane (with an item that must fail alone),
writes followed by reads (the aggregate cache misses after a write, and
an import past the field's range grows the depth), and the cold host tier
against the stack. Spies on the kernel wrappers of ``ops/bsi.py`` show
which branch answered.
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
from pilosa_tpu_torch import convert
from pilosa_tpu_torch.exec.executor import Executor as TorchExecutor
from pilosa_tpu_torch.ops import bsi as tb
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
N_COLS = N_SHARDS * SHARD_WIDTH
INT_FIELDS = {"v": (0, 1000), "w": (-1000, 1000), "z": (100, 200)}


def _norm(r):
    """Results of either package as plain comparable data."""
    if isinstance(r, Exception):
        return ("error", type(r).__name__)
    if isinstance(r, list):
        return [_norm(x) for x in r]
    if hasattr(r, "columns"):
        return ("row", [int(c) for c in r.columns()])
    if hasattr(r, "group"):
        return ("group", [(g.field, int(g.row_id)) for g in r.group], int(r.count))
    if hasattr(r, "value") and hasattr(r, "count"):
        return ("valcount", int(r.value), int(r.count))
    if hasattr(r, "id") and hasattr(r, "count"):
        return ("pair", int(r.id), int(r.count))
    if isinstance(r, (bool, int, np.integer)):
        return r if isinstance(r, bool) else int(r)
    raise TypeError(type(r))


def _build(seed: int):
    """(jax executor, port executor, rng) over the same seeded data."""
    rng = np.random.default_rng(seed)
    jh = JaxHolder()
    idx = jh.create_index("i")
    for name in ("f", "g"):
        idx.create_field(name)
    for name, (lo, hi) in INT_FIELDS.items():
        idx.create_field(name, JaxFieldOptions(field_type="int", min_=lo, max_=hi))
    for name, n_rows in (("f", 6), ("g", 4)):
        rows = rng.integers(0, n_rows, size=6000).astype(np.uint64)
        cols = rng.integers(0, N_COLS, size=6000).astype(np.uint64)
        idx.field(name).import_bits(rows, cols)
    je = JaxExecutor(jh)
    writes = []
    for name, (lo, hi) in INT_FIELDS.items():
        for c, x in zip(rng.integers(0, N_COLS, 700), rng.integers(lo, hi + 1, 700)):
            writes.append(f"Set({int(c)}, {name}={int(x)})")
    # the extremes, several times each, in different shards
    for k, c in enumerate(rng.integers(0, N_COLS, 8)):
        writes.append(f"Set({int(c)}, w={-1000 if k % 2 else 1000})")
    je.execute("i", " ".join(writes))
    fragments = {}
    for fname, field in idx.fields.items():
        for vname, view in field.views.items():
            for shard, frag in view.fragments.items():
                fragments[("i", fname, vname, shard)] = frag.rows_matrix_host()
    th = convert.holder_from_arrays(jh.schema(), fragments, device="cpu")
    for name in INT_FIELDS:
        assert th.field("i", name).bit_depth == idx.field(name).bit_depth
    # the result cache off: these tests hold the kernel paths and their
    # own caches, which a result-cache hit on a repeat query would skip
    return je, TorchExecutor(th, rescache_entries=0), rng


def _answer(ex, query, shards=None):
    try:
        return _norm(ex.execute("i", query, shards=shards))
    except Exception as e:  # the same error type in both packages
        return _norm(e)


def _conditions(name):
    """Every condition op on an int field, bounds signed, at the field's
    range edges and past its depth."""
    lo, hi = INT_FIELDS[name]
    mid = (lo + hi) // 2
    out = [
        f"Row({name} {op} {v})"
        for op in ("<", "<=", ">", ">=", "==", "!=")
        for v in (lo, mid, hi, lo - 1, hi + 1, -5000, 5000, -3, 0)
    ]
    return out + [
        f"Row({name} != null)", f"Range({name} >< [{lo}, {mid}])",
        f"Row({name} >< [{mid}, {lo}])", f"Row({lo - 7} < {name} < {mid})",
        f"Row({lo} <= {name} < {hi})", f"Row({mid} < {name} <= {hi + 9})",
        f"Row({-4000} <= {name} <= {4000})",
    ]


@pytest.fixture(scope="module")
def built():
    return _build(17)


@pytest.mark.parametrize("name", list(INT_FIELDS))
def test_conditions_and_counts_match_jax(built, name):
    je, te, _ = built
    te._BSI_SINGLE_WARM = je._BSI_SINGLE_WARM = 0  # every query on the stack
    for q in _conditions(name):
        assert _answer(te, q) == _answer(je, q), q
        cq = f"Count({q})"
        assert _answer(te, cq) == _answer(je, cq), cq
    for q in ("Row(v == null)", "Row(f > 3)", "Count(Row(v >< 5))"):
        assert _answer(te, q) == _answer(je, q) and _answer(te, q)[0] == "error", q
    assert _answer(te, "Row(v > 10)", shards=[0, 2]) == _answer(je, "Row(v > 10)", shards=[0, 2])


@pytest.mark.parametrize("name", list(INT_FIELDS))
def test_aggregates_match_jax(built, name):
    je, te, _ = built
    queries = [
        f"{call}({filt}field={name})"
        for filt in ("", "Row(f=1), ", "Row(f=5), ", f"Row({name} > 0), ", "Row(g=9), ")
        for call in ("Sum", "Min", "Max")
    ]
    queries += ["MinRow(field=f)", "MaxRow(field=g)", "MinRow(field=v)", "Sum(field=f)",
                "Min(field=nosuch)", "Sum(Row(f=1), Row(f=2), field=v)"]
    for q in queries:
        assert _answer(te, q) == _answer(je, q), q
    assert _answer(te, "Sum(field=v)", shards=[1]) == _answer(je, "Sum(field=v)", shards=[1])


def test_groupby_filtered_by_a_condition_matches_jax(built):
    je, te, _ = built
    for q in ("GroupBy(Rows(f), filter=Row(v > 250))",
              "GroupBy(Rows(f), Rows(g), filter=Row(w < -100))",
              "GroupBy(Rows(g), Rows(f), filter=Row(-50 <= z < 170), limit=7)"):
        assert _answer(te, q) == _answer(je, q), q


class _Spy:
    """Counts the calls of the three kernel wrappers of ops/bsi.py and
    records each call's query count."""

    def __init__(self, monkeypatch):
        self.calls = {"bsi_range": [], "bsi_sum": [], "bsi_extreme": []}
        for name in self.calls:
            real = getattr(tb, name)

            def spy(*a, _real=real, _name=name, **k):
                if _name == "bsi_range":
                    self.calls[_name].append(len(a[3]))
                elif _name == "bsi_sum":
                    f = a[3] if len(a) > 3 else k.get("filters")
                    self.calls[_name].append(1 if f is None or f.dim() == 2 else f.shape[1])
                else:
                    self.calls[_name].append(1)
                return _real(*a, **k)

            monkeypatch.setattr(tb, name, spy)

    def clear(self):
        for v in self.calls.values():
            v.clear()


def test_batch_mixes_match_jax_and_share_launches(monkeypatch):
    je, te, _ = _build(23)
    spy = _Spy(monkeypatch)
    ranges = [f"Row(v < {t})" for t in (100, 400, 800)]
    counts = [f"Count(Row(v <= {t}))" for t in range(0, 1000, 90)]
    sums = ["Sum(field=v)", "Sum(Row(f=1), field=v)", "Sum(Row(f=2), field=v)",
            "Sum(Row(g=0), field=v)"]
    groupbys = ["GroupBy(Rows(f), filter=Row(v > 300))", "GroupBy(Rows(g), filter=Row(v < 40))"]
    others = ["Min(field=w)", "Max(Row(f=3), field=w)", "Row(w != null)"]
    # a Sum with two inputs fails alone among v's Sums; a malformed range
    # sends w's conditions to the per-call path, which raises it alone
    bad = ["Sum(Row(f=1), Row(f=2), field=v)", "Row(w >< 5)"]
    batch = [(q, None) for q in ranges + counts + sums + groupbys + others + bad]
    got = _norm(te.execute_batch("i", batch))
    assert got == _norm(je.execute_batch("i", batch))
    assert [g[0] for g in got[-2:]] == ["error", "error"]
    assert all(isinstance(g, list) for g in got[:-2])  # flight-mates answered
    # one words launch for v's conditions and GroupBy filters, one count
    # launch for the counts, one sum launch for each of the three filtered
    # Sums and one for the unfiltered Sum, and one extreme launch each for
    # Min and Max
    assert sorted(spy.calls["bsi_range"]) == [len(ranges) + len(groupbys), len(counts)]
    assert spy.calls["bsi_sum"] == [1, 1, 1, 1]
    assert len(spy.calls["bsi_extreme"]) == 2
    assert te.bsi_batch_item_errors >= 1
    # again: the unfiltered aggregates and the counts come from the cache
    spy.clear()
    hits = te.bsi_agg_cache_hits
    assert _norm(te.execute_batch("i", batch)) == got
    assert spy.calls["bsi_extreme"] == [1] and spy.calls["bsi_sum"] == [1, 1, 1]
    assert spy.calls["bsi_range"] == [len(ranges) + len(groupbys)]
    assert te.bsi_agg_cache_hits >= hits + len(counts) + 2


@pytest.mark.parametrize("n_filters", [3, 4])
def test_filtered_sums_batch_one_launch_each(monkeypatch, n_filters):
    """The batched lane evaluates each filtered Sum's filter once and gives
    it one single-filter launch; the unfiltered Sum shares the cached
    aggregate with its repeat."""
    je, te, _ = _build(29)
    spy = _Spy(monkeypatch)
    batch = [(f"Sum(Row(f={r}), field=w)", None) for r in range(n_filters - 1)] + [
        ("Sum(Row(g=1), field=w)", None), ("Sum(field=w)", None), ("Sum(field=w)", None)]
    hits = te.bsi_agg_cache_hits
    filters = te.bsi_stack_launches
    assert _norm(te.execute_batch("i", batch)) == _norm(je.execute_batch("i", batch))
    assert spy.calls["bsi_sum"] == [1] * (n_filters + 1)
    assert te.bsi_agg_cache_hits == hits + 1
    assert te.bsi_stack_launches == filters + n_filters + 1


def test_writes_are_seen_by_the_next_read(monkeypatch):
    je, te, rng = _build(31)
    spy = _Spy(monkeypatch)
    reads = ("Count(Row(v < 500)) Sum(field=v) Min(field=v) Max(field=w) "
             "Row(w >< [-10, 10]) Sum(Row(f=2), field=z)")
    assert _answer(te, reads) == _answer(je, reads)  # the stacks are built
    assert _answer(te, reads) == _answer(je, reads)  # and warm
    cached = te.bsi_agg_cache_hits
    for k in range(6):
        # four neighbouring columns of one shard: the stacks are patched
        shard = int(rng.integers(0, N_SHARDS))
        c = shard * SHARD_WIDTH + int(rng.integers(0, SHARD_WIDTH - 4))
        writes = (f"Set({c}, v={int(rng.integers(0, 1001))}) Set({c + 1}, w=-1000) "
                  f"Clear({c + 2}, v=3) Set({c}, z=150) Clear({c + 3}, w=0)")
        assert _answer(te, writes) == _answer(je, writes)
        spy.clear()
        rebuilds, patched = te.stack_rebuilds, te.stack_incremental
        assert _answer(te, reads) == _answer(je, reads), k
        # the writes made new snapshots: nothing of the reads came from the
        # cache, every kernel ran, and the stacks were patched, not rebuilt
        assert te.bsi_agg_cache_hits == cached
        assert all(spy.calls.values()) and te.stack_rebuilds == rebuilds
        assert te.stack_incremental > patched
    # Set out of the field's range is refused by both
    assert _answer(te, "Set(3, v=1001)") == _answer(je, "Set(3, v=1001)")


def test_an_import_past_the_range_grows_the_depth():
    je, te, rng = _build(37)
    reads = "Count(Row(v > 900)) Sum(field=v) Max(field=v) Min(field=v) Count(Row(v < -1))"
    assert _answer(te, reads) == _answer(je, reads)
    depth, rebuilds = te.holder.field("i", "v").bit_depth, te.stack_rebuilds
    cols = rng.integers(0, N_COLS, 40)
    values = rng.integers(-(2**40), 2**40, 40)
    for h in (je.holder, te.holder):
        h.field("i", "v").import_values(cols, values)
    assert te.holder.field("i", "v").bit_depth == je.holder.field("i", "v").bit_depth > depth
    assert _answer(te, reads) == _answer(je, reads)
    assert te.stack_rebuilds > rebuilds  # the depth is part of the stack's key
    for q in (f"Row(v == {int(values[3])})", f"Count(Row(v >= {int(values[5])}))"):
        assert _answer(te, q) == _answer(je, q), q


def test_cold_conditions_run_on_the_host_until_the_warm_up(monkeypatch):
    je, te, _ = _build(41)
    host_tier = []
    real = tb.bsi_range

    def where(*a, **k):
        # the stack tier counts its launch before it computes
        host_tier.append(te.bsi_stack_launches == launches[0])
        return real(*a, **k)

    launches = [te.bsi_stack_launches]
    monkeypatch.setattr(tb, "bsi_range", where)
    q = "Count(Row(v < 500))"
    answers = []
    for k in range(te._BSI_SINGLE_WARM + 2):
        launches[0] = te.bsi_stack_launches
        rebuilds = te.stack_rebuilds
        answers.append(_answer(te, q))
        assert answers[-1] == _answer(je, q)
        if k < te._BSI_SINGLE_WARM - 1:  # cold: the mirrors, no stack
            assert te.stack_rebuilds == rebuilds and te.bsi_stack_launches == launches[0]
        elif k == te._BSI_SINGLE_WARM - 1:  # the warm-up builds the stack
            assert te.stack_rebuilds == rebuilds + 1 and te.bsi_stack_launches > launches[0]
    assert len(set(map(str, answers))) == 1
    assert host_tier[: te._BSI_SINGLE_WARM - 1] == [True] * (te._BSI_SINGLE_WARM - 1)
    # after the warm-up: the stack computes once, then the cache answers
    assert len(host_tier) == te._BSI_SINGLE_WARM + 1
    assert te.bsi_agg_cache_hits >= 1
