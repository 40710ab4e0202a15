"""Time-quantum views and the rest of the executor, the port against
``pilosa_tpu``.

Both packages get the same seeded bits with timestamps. JAX imports them
with its per-bit loop, the port with its grouped import, and every view's
fragments must be equal; the grouped import is also held to the port's
plain version (JAX's loop) bit for bit. Then the same queries run through
both executors and their answers must be equal in ``result_to_json``
form: time-range ``Row``s and ``Count``s alone and inside trees for each
quantum, covers of 1, 16 and 17 views, empty ranges and open bounds,
``Rows(from, to)`` and GroupBy over such Rows, Set with a timestamp, Clear
over time views, Store, the attrs calls, TopN by attribute, Options and
the deletes. JAX answers each query alone on its host path; the port
answers the same queries in one ``execute_batch``, where spies show the
windowed calls on the tree kernel, each leaf over its own view's stack.
Last, data directories with time views written by either package open in
the other, and after a snapshot the files are byte-equal.
"""

# the port's lock witness, installed before the port is imported so that its
# module-level locks are wrapped too (pilosa_tpu_torch/testing/lockwitness.py)
from pilosa_tpu_torch.testing import lockwitness as port_lockwitness

port_lockwitness.install()
# the module fixture that asserts no new inversion among the port's locks
from pilosa_tpu_torch.testing.lockwitness import no_new_inversion  # noqa: F401

import gc
import shutil
import weakref
from datetime import datetime, timedelta, timezone
from pathlib import Path

import numpy as np
import pytest

from pilosa_tpu.core.field import FieldOptions as JaxFieldOptions
from pilosa_tpu.core.holder import Holder as JaxHolder
from pilosa_tpu.core import timequantum as jtq
from pilosa_tpu.exec.executor import Executor as JaxExecutor
from pilosa_tpu.exec.result import result_to_json as jax_json
from pilosa_tpu.storage.disk import HolderStore as JaxStore
from pilosa_tpu_torch import convert
from pilosa_tpu_torch.core import membudget
from pilosa_tpu_torch.core.field import FieldOptions as TorchFieldOptions
from pilosa_tpu_torch.core.holder import Holder as TorchHolder
from pilosa_tpu_torch.exec import astbatch
from pilosa_tpu_torch.exec.executor import ExecuteError, Executor as TorchExecutor
from pilosa_tpu_torch.exec.result import result_to_json as torch_json
from pilosa_tpu_torch.ops import kernels as tk
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
from pilosa_tpu_torch.storage.disk import HolderStore as TorchStore

N_SHARDS = 3
T_ROWS = 5
QUANTUMS = ["Y", "YM", "YMD", "YMDH", "MD", "DH", "H"]

# the instants bits are stamped with: across a year, months, days and hours
_H = timedelta(hours=1)
STAMPS = (
    [datetime(2022, 6, 15, 10)]
    + [datetime(2023, 12, 31, 20) + k * _H for k in range(34)]
    + [datetime(2024, 2, 29, 12), datetime(2024, 3, 1, 1)]
)

# (from, to) windows, None for an open bound
WINDOWS = [
    ("2024-01-01T00:00", "2024-01-02T00:00"),  # a day
    ("2024-01-01T03:00", "2024-01-01T19:00"),  # 16 hours
    ("2024-01-01T03:00", "2024-01-01T20:00"),  # 17 hours
    ("2023-12-31T22:00", "2024-01-02T03:00"),  # hours, a day, hours
    ("2022-01-01T00:00", "2025-01-01T00:00"),  # years
    ("2024-01-01T00:00", "2024-03-01T00:00"),  # months
    ("2024-01-01T05:00", "2024-01-01T05:00"),  # empty
    (None, "2024-01-01T12:00"),
    ("2024-01-01T12:00", None),
]


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
    JAX holders' device-budget entries release their bytes in finalizers
    that take the budget's lock, and left to a later collection they may
    run while another test's code holds a lock."""
    yield
    gc.collect()


def _json(r, pkg="torch"):
    if isinstance(r, Exception):
        return ("error", type(r).__name__)
    return jax_json(r) if pkg == "jax" else torch_json(r)


def _answers(ex, query, shards=None):
    pkg = "jax" if isinstance(ex, JaxExecutor) else "torch"
    try:
        return _json(ex.execute("i", query, shards=shards), pkg)
    except Exception as e:  # both packages must fail alike
        return _json(e)


def _bits(seed: int, n: int = 900):
    """(rows, cols, timestamps): seeded bits over N_SHARDS shards, a tenth
    of them without a timestamp."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, T_ROWS, n).astype(np.uint64)
    cols = rng.integers(0, N_SHARDS * SHARD_WIDTH, n).astype(np.uint64)
    pick = rng.integers(0, len(STAMPS), n)
    ts = [None if rng.random() < 0.1 else STAMPS[k] for k in pick]
    return rows, cols, ts


def _holders(q: str, seed: int = 1, plain: bool = False, pkgs=("jax", "torch")):
    """(JAX holder, port holder) with a time field t of quantum ``q`` and a
    set field f, the same bits imported into each (those of ``pkgs``)."""
    out = []
    rows, cols, ts = _bits(seed)
    frng = np.random.default_rng(seed + 100)
    f_rows = frng.integers(0, 4, 600).astype(np.uint64)
    f_cols = frng.integers(0, N_SHARDS * SHARD_WIDTH, 600).astype(np.uint64)
    for pkg in pkgs:
        h = JaxHolder() if pkg == "jax" else TorchHolder(device="cpu")
        FO = JaxFieldOptions if pkg == "jax" else TorchFieldOptions
        idx = h.create_index("i")
        t = idx.create_field("t", FO(field_type="time", time_quantum=q))
        f = idx.create_field("f")
        (t.import_bits_plain if plain and pkg == "torch" else t.import_bits)(rows, cols, timestamps=ts)
        f.import_bits(f_rows, f_cols)
        # the existence field as an import would not record it: Not() reads it
        for c in np.unique(np.concatenate([cols, f_cols])).tolist():
            idx.add_column_existence(int(c))
        out.append(h)
    return out


def _mirror(frag):
    ids, words = frag.rows_matrix_host()
    order = [i for i in np.argsort(ids) if words[i].any()]
    return [int(ids[i]) for i in order], words[order]


def _same_fragments(a, b):
    """Every view and fragment of ``a`` and ``b`` holds the same bits."""
    fa = {(i.name, f.name, v.name, s): fr for i in a.indexes.values()
          for f in i.fields.values() for v in f.views.values() for s, fr in v.fragments.items()}
    fb = {(i.name, f.name, v.name, s): fr for i in b.indexes.values()
          for f in i.fields.values() for v in f.views.values() for s, fr in v.fragments.items()}
    assert sorted(fa) == sorted(fb)
    for k in fa:
        ia, wa = _mirror(fa[k])
        ib, wb = _mirror(fb[k])
        assert ia == ib and np.array_equal(wa, wb), k


def _window(fr, to):
    return "".join(f", {k}={v}" for k, v in (("from", fr), ("to", to)) if v is not None)


# a cover longer than this is left out of the read tests: under an hourly
# quantum alone the years window covers some 26,000 views, each read on the
# host by both executors (the 17-view cover already takes that path)
_READ_COVER_MAX = 400


def _queries(rng, field):
    out = []
    for fr, to in WINDOWS:
        cover = jtq.view_cover(field, fr, to, "standard")
        if cover is not None and len(cover) > _READ_COVER_MAX:
            continue
        w = _window(fr, to)
        r = int(rng.integers(0, T_ROWS))
        x = int(rng.integers(0, 4))
        out += [
            f"Row(t={r}{w})",
            f"Count(Row(t={r}{w}))",
            f"Count(Row(t={T_ROWS + 3}{w}))",  # an absent row
            f"Count(Intersect(Row(t={r}{w}), Row(f={x})))",
            f"Union(Row(t={r}{w}), Row(f={x}))",
            f"Count(Not(Row(t={r}{w})))",
            f"Count(Difference(Row(f={x}), Row(t={r}{w}), Row(t={(r + 1) % T_ROWS}{w})))",
            f"Rows(t{w})",
            f"GroupBy(Rows(t{w}), Rows(f))",
            f"GroupBy(Rows(f), Rows(t{w}), filter=Row(t={r}{w}))",
        ]
    return out


# -- imports


@pytest.mark.parametrize("q", QUANTUMS)
def test_import_and_windowed_reads_match_jax(q, monkeypatch):
    """Equal views and fragments after the import; then every windowed read
    of both executors equal, the port's in one batch on the tree kernels,
    each leaf over its own view's stack."""
    jh, th = _holders(q)
    _same_fragments(th, jh)
    je, te = JaxExecutor(jh), TorchExecutor(th)
    queries = _queries(np.random.default_rng(len(q)), jh.field("i", "t"))
    want = [_answers(je, qq) for qq in queries]
    launches = {"tree_count": 0, "tree_words": 0}
    for name in launches:
        real = getattr(tk, name)

        def spy(*a, _real=real, _name=name):
            launches[_name] += 1
            return _real(*a)

        monkeypatch.setattr(tk, name, spy)
    views_read = []
    real_stack = TorchExecutor._field_stack

    def stack_spy(self, field, shards, view_name="standard", fixed_rows=None):
        views_read.append((field.name, view_name))
        return real_stack(self, field, shards, view_name, fixed_rows)

    monkeypatch.setattr(TorchExecutor, "_field_stack", stack_spy)
    got = [_json(r) for r in te.execute_batch("i", [(qq, None) for qq in queries])]
    assert got == want
    assert launches["tree_count"] > 0 and launches["tree_words"] > 0
    assert any(f == "t" and v.startswith("standard_") for f, v in views_read)
    # and one by one, on the host tier
    assert [_answers(te, qq) for qq in queries] == want


def test_cover_lengths_and_what_the_batch_declines():
    """Covers of 1, 16 and 17 views under YMDH; the batch signs up to
    MAX_TIME_COVER views, an empty range never."""
    jh, th = _holders("YMDH")
    t = th.field("i", "t")
    idx = th.index("i")
    for (fr, to), n in (((("2024-01-01T00:00", "2024-01-02T00:00")), 1),
                        (("2024-01-01T03:00", "2024-01-01T19:00"), 16),
                        (("2024-01-01T03:00", "2024-01-01T20:00"), 17),
                        (("2024-01-01T05:00", "2024-01-01T05:00"), 0)):
        cover = jtq.view_cover(jh.field("i", "t"), fr, to, "standard")
        assert len(cover) == n
        from pilosa_tpu_torch.pql import parse

        call = parse(f"Count(Row(t=1, from={fr}, to={to}))").calls[0]
        sig = astbatch.match_count(idx, call, [], [])
        assert (sig is not None) == (0 < n <= astbatch.MAX_TIME_COVER)
    assert t.view_names() == jh.field("i", "t").view_names()


@pytest.mark.parametrize("form", ["datetimes", "datetime64", "aware", "segments"])
def test_grouped_import_equals_plain_and_jax(form):
    """The grouped import against the port's plain version (JAX's per-bit
    loop) and against JAX, bit for bit, in every view; timestamps as
    ``datetime``s, a ``datetime64`` array, timezone-aware ``datetime``s
    (their wall clock), or with the batch pre-split by shard."""
    rows, cols, ts = _bits(7, 2000)
    holders = {}
    for kind in ("jax", "grouped", "plain"):
        h = JaxHolder() if kind == "jax" else TorchHolder(device="cpu")
        FO = JaxFieldOptions if kind == "jax" else TorchFieldOptions
        t = h.create_index("i").create_field("t", FO(field_type="time", time_quantum="YMDH"))
        arg = ts
        if kind == "grouped" and form == "datetime64":
            arg = np.array(["NaT" if x is None else np.datetime64(x, "us") for x in ts],
                           dtype="datetime64[us]")
        if kind != "jax" and form == "aware":
            tz = timezone(timedelta(hours=-5))
            arg = [None if x is None else x.replace(tzinfo=tz) for x in ts]
        kw = {}
        if form == "segments":
            shards = cols // SHARD_WIDTH
            kw["segments"] = [(int(s), rows[shards == s], cols[shards == s] % SHARD_WIDTH)
                              for s in np.unique(shards)]
        imp = t.import_bits_plain if kind == "plain" else t.import_bits
        imp(rows, cols, timestamps=arg, **kw)
        # then a clear of part of the standard view
        imp(rows[:300], cols[:300], clear=True)
        holders[kind] = h
    _same_fragments(holders["grouped"], holders["plain"])
    _same_fragments(holders["grouped"], holders["jax"])


def test_import_errors_and_other_field_types():
    for FO, H in ((JaxFieldOptions, JaxHolder), (TorchFieldOptions, TorchHolder)):
        h = H() if H is JaxHolder else H(device="cpu")
        idx = h.create_index("i")
        t = idx.create_field("t", FO(field_type="time", time_quantum="YMD"))
        with pytest.raises(ValueError, match="clear is not supported with timestamps"):
            t.import_bits([1], [2], timestamps=[datetime(2024, 1, 1)], clear=True)
    th = TorchHolder(device="cpu")
    idx = th.create_index("i")
    t = idx.create_field("t", TorchFieldOptions(field_type="time", time_quantum="YMD"))
    jh = JaxHolder()
    jidx = jh.create_index("i")
    jt = jidx.create_field("t", JaxFieldOptions(field_type="time", time_quantum="YMD"))
    # an import through each package's ingest pipeline lands alike
    from pilosa_tpu.ingest import IngestPipeline as JaxPipeline
    from pilosa_tpu.server.importpool import ImportPool as JaxPool
    from pilosa_tpu_torch.ingest import IngestPipeline as TorchPipeline
    from pilosa_tpu_torch.server.importpool import ImportPool as TorchPool

    for field, Pool, Pipeline in ((t, TorchPool, TorchPipeline), (jt, JaxPool, JaxPipeline)):
        pool = Pool(workers=2, depth=4)
        pipe = Pipeline(pool)
        try:
            field.import_bits([1, 2, 1], [2, SHARD_WIDTH + 3, 9], pipeline=pipe,
                              timestamps=[datetime(2024, 1, 1), None, datetime(2024, 3, 2)])
            field.import_bits([1], [9], clear=True, pipeline=pipe)
        finally:
            pipe.close()
            pool.close()
    # mutex, no standard view, and a field without a quantum, as in JAX
    for h, FO, ix in ((jh, JaxFieldOptions, jidx), (th, TorchFieldOptions, idx)):
        m = ix.create_field("m", FO(field_type="mutex", time_quantum="YM"))
        m.import_bits([1, 2, 1, 3], [5, 5, 9, 70000 % SHARD_WIDTH],
                      timestamps=[datetime(2024, 1, 1), None, datetime(2024, 5, 1), None])
        n = ix.create_field("n", FO(time_quantum="D", no_standard_view=True))
        n.import_bits([1, 2], [5, 6], timestamps=[datetime(2024, 1, 1), datetime(2024, 1, 2)])
        p = ix.create_field("p")
        p.import_bits([1, 2], [5, 6], timestamps=[datetime(2024, 1, 1), None])
        assert p.view_names() == ["standard"]
    _same_fragments(th, jh)
    # n's rows live in its time views only: GroupBy counts them 0 everywhere
    je, te = JaxExecutor(jh), TorchExecutor(th)
    w = "from=2024-01-01T00:00, to=2024-01-03T00:00"
    for q in [f"Rows(n, {w})", f"Count(Row(n=1, {w}))", f"Row(n=2, {w})",
              f"GroupBy(Rows(n, {w}), Rows(p))", f"GroupBy(Rows(p), Rows(n, {w}))",
              f"GroupBy(Rows(n, {w}))", f"GroupBy(Rows(p), Rows(n, {w}), filter=Row(p=1))"]:
        assert _answers(te, q) == _answers(je, q), q


# -- writes through the executor


def test_set_with_timestamp_clear_and_faults_match_jax():
    """Set with a timestamp writes every view of its quantum, Clear removes
    the bit from the standard view and every time view; errors as JAX's."""
    jh, th = _holders("YMDH", seed=3)
    je, te = JaxExecutor(jh), TorchExecutor(th)
    w = _window("2024-01-01T00:00", "2024-01-03T00:00")
    for q in ["Set(5, t=1, 2024-01-01T07:00) Set(6, t=1, 2023-12-31T23:00)",
              f"Count(Row(t=1{w})) Row(t=1{w})",
              "Clear(5, t=1) Clear(6, t=1)",
              f"Count(Row(t=1{w})) Row(t=1, from=2024-01-01T07:00, to=2024-01-01T08:00)",
              "Set(7, f=1, 2024-01-01T07:00)",  # no quantum: ValueError
              "Row(f=1, from=2024-01-01T00:00, to=2024-01-02T00:00)",
              "Set(8, t=1, 2024-13-01T00:00)",
              "Rows(f, from=2024-01-01T00:00)",
              "Rows(t, from=2024-01-01T00:00, column=5)",
              "ClearRow(t=2) Rows(t) Rows(t, from=2024-01-01T00:00)",
              # row 2 is in the time views only now: it counts 0 everywhere
              "GroupBy(Rows(t, from=2024-01-01T00:00), Rows(f))",
              "GroupBy(Rows(f), Rows(t, from=2024-01-01T00:00), filter=Row(f=1))",
              "GroupBy(Rows(t, from=2024-01-01T00:00))"]:
        assert _answers(te, q) == _answers(je, q), q
    _same_fragments(th, jh)
    # every bit of column 5 is gone from t's views
    for v in th.field("i", "t").views.values():
        frag = v.fragment(0)
        assert frag is None or not frag.get_bit(1, 5), v.name


def test_clear_after_opening_a_jax_data_dir(tmp_path):
    """A data directory JAX wrote with time views, opened by the port: a
    Clear reaches every time view, and both directories stay byte-equal
    after the same Clear in each."""
    jpath = tmp_path / "jax"
    holder = JaxHolder()
    store = JaxStore(holder, str(jpath))
    store.open()
    idx = holder.create_index("i")
    idx.create_field("t", JaxFieldOptions(field_type="time", time_quantum="YMDH"))
    JaxExecutor(holder).execute(
        "i", "Set(5, t=1, 2024-01-01T07:00) Set(9, t=1, 2024-01-01T07:00) Set(5, t=2, 2023-05-01T00:00)")
    store.close()
    tpath = tmp_path / "torch"
    shutil.copytree(jpath, tpath)
    for pkg, path in (("jax", jpath), ("torch", tpath)):
        h = JaxHolder() if pkg == "jax" else TorchHolder(device="cpu")
        st = (JaxStore if pkg == "jax" else TorchStore)(h, str(path))
        st.open()
        ex = JaxExecutor(h) if pkg == "jax" else TorchExecutor(h)
        assert ex.execute("i", "Clear(5, t=1)") == [True]
        t = h.field("i", "t")
        assert len(t.views) == 9  # the standard view and 8 time views
        assert [v.name for v in t.views.values() if v.get_bit(1, 5)] == [], pkg
        got = _json(ex.execute(
            "i", "Row(t=1, from=2024-01-01T00:00, to=2024-01-02T00:00)"
                 " Row(t=2, from=2023-01-01T00:00, to=2024-01-01T00:00)"), pkg)
        assert got == [{"attrs": {}, "columns": [9]}, {"attrs": {}, "columns": [5]}], pkg
        st.close()
    assert _tree(tpath) == _tree(jpath)


def test_a_batched_leaf_reads_its_own_view(monkeypatch):
    """A leaf that names a time view is counted over that view's stack, not
    over the standard view's (the signature here is made by hand, so the
    check holds whatever the matcher signs)."""
    (jh,) = _holders("YMDH", seed=2, pkgs=("jax",))
    fragments = {
        ("i", f.name, v.name, sh): frag.rows_matrix_host()
        for f in jh.index("i").fields.values() for v in f.views.values()
        for sh, frag in v.fragments.items()
    }
    th = convert.holder_from_arrays(jh.schema(), fragments, device="cpu")
    te = TorchExecutor(th)
    view = "standard_20240101"
    frags = th.field("i", "t").view(view).fragments
    want = sum(int(np.bitwise_count(fr.row_words_host(1)).sum()) for fr in frags.values())
    std = sum(int(np.bitwise_count(fr.row_words_host(1)).sum())
              for fr in th.field("i", "t").view("standard").fragments.values())
    assert 0 < want < std

    def match_count(idx, call, leaves, pairs):
        leaves += [("t", view, 1), ("t", view, 1)]
        pairs.append(("t", view))
        return ("union", ("row", 0), ("row", 0))

    monkeypatch.setattr(astbatch, "match_count", match_count)
    calls = []
    real = tk.tree_count
    monkeypatch.setattr(tk, "tree_count", lambda *a: calls.append(a) or real(*a))
    got = te.execute_batch("i", [("Count(Row(t=1))", None)] * 2)
    assert got == [[want], [want]] and len(calls) == 1


def test_store_attrs_topn_and_options_match_jax():
    jh, th = _holders("YMD", seed=4)
    je, te = JaxExecutor(jh), TorchExecutor(th)
    w = _window("2024-01-01T00:00", "2024-01-02T00:00")
    for q in [f"Store(Row(t=1{w}), s=0) Count(Row(s=0)) Row(s=0)",
              f"Store(Intersect(Row(t=2{w}), Row(f=1)), f=9) Row(f=9)",
              f"Store(Row(t=1{w}), s=0)",  # unchanged: False
              "Store(Row(t=1), s=x)",
              "SetRowAttrs(t, 1, color=\"red\", n=3) SetRowAttrs(t, 2, color=\"blue\")",
              "SetRowAttrs(t, 3, color=\"red\") SetRowAttrs(t, 3, color=null)",
              "SetColumnAttrs(5, name=\"five\") SetColumnAttrs(70000, name=\"big\", k=1)",
              "TopN(t, attrName=color) TopN(t, attrName=color, attrValues=[\"red\"])",
              f"TopN(t, Row(f=1), n=2, attrName=color)",
              "TopN(t, Row(f=2), tanimotoThreshold=1, attrName=n, attrValues=[3])",
              "Row(t=1) Options(Row(t=1), excludeRowAttrs=true)",
              "Options(Row(t=1), excludeColumns=true)",
              f"Options(Union(Row(t=1{w}), Row(f=1)), columnAttrs=true)",
              "Options(Row(t=1), columnAttrs=true, excludeRowAttrs=true)",
              "Options(Count(Row(t=1)), shards=[0, 2])",
              f"Options(Row(t=1{w}), shards=[1])",
              "Options(Row(t=1), Row(t=2))",
              "SetRowAttrs(nope, 1, x=1)"]:
        assert _answers(te, q) == _answers(je, q), q
    _same_fragments(th, jh)


def test_deletes_and_fragment_accessor_match_jax():
    jh, th = _holders("YM", seed=5)
    for h in (jh, th):
        idx = h.index("i")
        g0 = idx.generation
        assert h.fragment("i", "t", "standard_202401", 0) is not None
        assert h.fragment("i", "t", "standard_209901", 0) is None
        assert h.fragment("i", "nope", "standard", 0) is None
        assert h.field("i", "t").delete_view("standard_202401")
        assert not h.field("i", "t").delete_view("standard_202401")
        assert idx.delete_field("t") and not idx.delete_field("t")
        assert idx.generation == g0 + 1 and "t" not in idx.fields
        assert h.delete_index("i") and not h.delete_index("i") and h.index_names() == []


def test_a_deleted_field_leaves_the_budget(monkeypatch):
    """A deleted field's stacks leave the budget once nothing holds it, and
    a new field of the same name answers from its own data."""
    budget = membudget.configure(None)
    try:
        _, th = _holders("YMDH", seed=6)
        te = TorchExecutor(th)
        w = _window("2023-12-31T22:00", "2024-01-02T03:00")
        queries = [(f"Count(Row(t={r}{w}))", None) for r in range(T_ROWS)] * 2
        first = [r[0] for r in te.execute_batch("i", queries)]
        used = budget.used()
        assert used > 0 and te.stack_rebuilds >= 3
        ref = weakref.ref(th.field("i", "t"))
        th.index("i").delete_field("t")
        gc.collect()
        assert ref() is None
        assert budget.used() < used
        idx = th.index("i")
        t = idx.create_field("t", TorchFieldOptions(field_type="time", time_quantum="YMDH"))
        t.import_bits([0], [3], timestamps=[datetime(2024, 1, 1, 5)])
        again = [r[0] for r in te.execute_batch("i", queries)]
        assert again == [1, 0, 0, 0, 0] * 2 and first != again
    finally:
        membudget.configure(None)


# -- data directories


def _tree(path: Path) -> dict:
    return {str(p.relative_to(path)): p.read_bytes()
            for p in sorted(path.rglob("*")) if p.is_file() and p.name != ".id"}


def _write_dir(path: Path, pkg: str, snapshot: bool):
    holder = JaxHolder() if pkg == "jax" else TorchHolder(device="cpu")
    store = (JaxStore if pkg == "jax" else TorchStore)(holder, str(path))
    store.open()
    FO = JaxFieldOptions if pkg == "jax" else TorchFieldOptions
    idx = holder.create_index("i")
    t = idx.create_field("t", FO(field_type="time", time_quantum="YMDH"))
    rows, cols, ts = _bits(8, 600)
    t.import_bits(rows, cols, timestamps=ts)
    ex = JaxExecutor(holder) if pkg == "jax" else TorchExecutor(holder)
    ex.execute("i", "Set(11, t=2, 2024-01-01T09:00) Clear(11, t=2)"
                    " Set(12, t=4, 2024-02-29T12:00)")
    if snapshot:
        for f in idx.fields.values():
            for v in f.views.values():
                for frag in v.fragments.values():
                    frag.store.snapshot()
    store.close()
    return holder


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_time_views_open_in_the_other_package(tmp_path, writer, reader):
    wrote = _write_dir(tmp_path / writer, writer, snapshot=False)
    holder = JaxHolder() if reader == "jax" else TorchHolder(device="cpu")
    store = (JaxStore if reader == "jax" else TorchStore)(holder, str(tmp_path / writer))
    store.open()
    assert holder.schema() == wrote.schema()
    _same_fragments(holder, wrote)
    assert len(holder.field("i", "t").views) > 30
    store.close()


def test_groupby_after_a_reopen_skips_rows_the_standard_view_lost(tmp_path):
    """A row cleared from the standard view (ClearRow) stays in the time
    views; after a snapshot and a reopen the standard view no longer holds
    it at all, and a GroupBy over windowed Rows counts it 0, as in JAX."""
    answers = {}
    for pkg in ("jax", "torch"):
        holder = JaxHolder() if pkg == "jax" else TorchHolder(device="cpu")
        Store = JaxStore if pkg == "jax" else TorchStore
        Exe = JaxExecutor if pkg == "jax" else TorchExecutor
        FO = JaxFieldOptions if pkg == "jax" else TorchFieldOptions
        store = Store(holder, str(tmp_path / pkg))
        store.open()
        idx = holder.create_index("i")
        idx.create_field("t", FO(field_type="time", time_quantum="YMD"))
        idx.create_field("f")
        Exe(holder).execute("i", "Set(3, t=1, 2024-01-01T00:00) Set(4, t=2, 2024-01-01T00:00)"
                                 " Set(3, f=0) Set(4, f=0) ClearRow(t=2)")
        for f in idx.fields.values():
            for v in f.views.values():
                for frag in v.fragments.values():
                    frag.store.snapshot()
        store.close()
        holder = JaxHolder() if pkg == "jax" else TorchHolder(device="cpu")
        store = Store(holder, str(tmp_path / pkg))
        store.open()
        ex = Exe(holder)
        w = "from=2024-01-01T00:00, to=2024-01-02T00:00"
        answers[pkg] = [_answers(ex, q) for q in (
            f"Rows(t, {w})", f"GroupBy(Rows(t, {w}), Rows(f))", f"GroupBy(Rows(t, {w}))",
            f"GroupBy(Rows(f), Rows(t, {w}), filter=Row(f=0))")]
        store.close()
    assert answers["torch"] == answers["jax"]
    assert answers["torch"][0] == [{"rows": [1, 2]}]


def test_time_view_files_are_byte_equal_after_a_snapshot(tmp_path):
    for pkg in ("jax", "torch"):
        _write_dir(tmp_path / pkg, pkg, snapshot=True)
    jt, tt = _tree(tmp_path / "jax"), _tree(tmp_path / "torch")
    assert sorted(tt) == sorted(jt)
    assert [n for n in tt if tt[n] != jt[n]] == []
    assert sum("standard_" in n for n in tt) > 30 * N_SHARDS // 2
