"""The port's executor over a serving mesh against JAX's: the counterpart
of ``tests/test_mesh_executor.py`` and of ``__graft_entry__``'s
``dryrun_multichip``.

JAX lays its stacks over the eight virtual CPU devices of
``tests/conftest.py``; the port over ``configure_serving(devices=[cpu] *
8)``, as ``ShardedStack``s of eight slices, the shard axis (12 shards)
padded to 16. The same seeded data and the same queries, with writes
between them, go through both executors, and every answer must be equal:
batched pair Counts, TopN (plain, filtered, tanimoto), GroupBy over two
and three levels (filtered), tree Counts and bitmap trees, BSI range
Counts, Sum, Min and Max. Spies show the wrappers launching once a slice.
Last, every kernel wrapper that reads a stack is held over a
``ShardedStack`` of 1, 3 and 8 slices (3 divides no shard count here, so
the padding shows) to the same wrapper over the whole stack
(``pilosa_tpu_torch/testing/meshcases.py``).
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

import jax
from pilosa_tpu.core.field import FieldOptions as JaxFieldOptions
from pilosa_tpu.core.holder import Holder as JaxHolder
from pilosa_tpu.exec.executor import Executor as JaxExecutor
from pilosa_tpu.ops import kernels as jk
from pilosa_tpu_torch import convert
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.exec.executor import Executor as TorchExecutor
from pilosa_tpu_torch.ops import bsi as tb
from pilosa_tpu_torch.ops import kernels as tk
from pilosa_tpu_torch.parallel import mesh as mesh_mod
from pilosa_tpu_torch.parallel import sharded
from pilosa_tpu_torch.testing import meshcases


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
    """Collect each test's garbage at its end, where no lock is held (the
    JAX executors' budget finalizers take the budget's lock)."""
    yield
    gc.collect()


@pytest.fixture(autouse=True)
def eight():
    """The port's serving mesh: eight CPU slices, JAX's eight devices'
    counterpart; the default again after each test."""
    mesh_mod.configure_serving(None, devices=["cpu"] * 8)
    yield mesh_mod.serving_mesh()
    mesh_mod.configure_serving(None)


N_SHARDS = 12


def _norm(r):
    """Results of either package as plain comparable data."""
    if isinstance(r, list):
        return [_norm(x) for x in r]
    if hasattr(r, "columns") and hasattr(r, "segments"):
        return ("row", [int(c) for c in r.columns()])
    if hasattr(r, "id") and hasattr(r, "count"):
        return ("pair", int(r.id), int(r.count))
    if hasattr(r, "group") and hasattr(r, "count"):
        return ("group", [(g.field, int(g.row_id)) for g in r.group], int(r.count))
    if hasattr(r, "value") and hasattr(r, "count"):
        return ("valcount", int(r.value), int(r.count))
    if isinstance(r, (bool, int, np.integer)):
        return r if isinstance(r, bool) else int(r)
    raise TypeError(type(r))


@pytest.fixture()
def pair():
    """(JAX executor, port executor) over the same seeded index: f of 5
    rows and g of 3 over 12 shards (so the stacks pad to 16 over 8
    slices) and an int field v."""
    rng = np.random.default_rng(11)
    jh = JaxHolder()
    idx = jh.create_index("i")
    idx.create_field("f")
    idx.create_field("g")
    idx.create_field("v", JaxFieldOptions(field_type="int", min_=-50, max_=900))
    je = JaxExecutor(jh)
    width = jh.n_words * 32
    n_cols = N_SHARDS * width
    # f and g from a shared pool of columns, so combinations intersect
    pool = rng.integers(0, n_cols, size=3000)
    idx.field("f").import_bits(rng.integers(0, 5, size=2400).astype(np.uint64),
                               rng.choice(pool, size=2400).astype(np.uint64))
    idx.field("g").import_bits(rng.integers(0, 3, size=1200).astype(np.uint64),
                               rng.choice(pool, size=1200).astype(np.uint64))
    vcols = rng.choice(n_cols, size=500, replace=False)
    idx.field("v").import_values(vcols, rng.integers(-50, 900, size=500))
    fragments = {}
    for fname, field in idx.fields.items():
        for vname, view in field.views.items():
            for shard, frag in view.fragments.items():
                fragments[("i", fname, vname, shard)] = frag.rows_matrix_host()
    th = convert.holder_from_arrays(jh.schema(), fragments, device="cpu")
    # the result cache off: the kernel paths answer every repeat
    return je, TorchExecutor(th, rescache_entries=0)


def _same(je, te, query):
    want = _norm(je.execute("i", query))
    got = _norm(te.execute("i", query))
    assert got == want, query
    return got


class _Spy:
    """Counts a kernel wrapper's calls on whole tensors (the slices of a
    sharded stack) while it is installed."""

    def __init__(self, monkeypatch, module, name):
        self.calls = 0
        real = getattr(module, name)

        def spy(first, *a, **k):
            if not sharded.is_sharded(first) and not (
                    isinstance(first, tuple) and sharded.is_sharded(first[0])):
                self.calls += 1
            return real(first, *a, **k)

        monkeypatch.setattr(module, name, spy)


def _slices(te):
    return [e["dev"] for caches in te._stacks.values() for e in caches.values()]


def test_serving_mesh_exists(eight):
    assert eight is not None and eight.size == len(jax.devices()) == 8
    assert eight.axis_names == ("shards",)
    assert not mesh_mod.mesh_spans_processes(eight)
    mesh_mod.configure_serving(None)
    assert mesh_mod.serving_mesh() is None  # one CPU: the plain path


def test_field_stack_is_mesh_sharded(pair):
    je, te = pair
    jf = je.holder.index("i").field("f")
    tf = te.holder.field("i", "f")
    shards = sorted(je.holder.index("i").available_shards())
    _, jbits = je._field_stack(jf, shards)
    _, tbits = te._field_stack(tf, shards)
    assert sharded.is_sharded(tbits) and len(tbits.slices) == 8
    assert tuple(tbits.shape) == tuple(jbits.shape) and tbits.shape[0] == 16
    assert len(jbits.sharding.device_set) == 8 and jk.shards_axis_of(jbits) is not None
    assert np.array_equal(tbits.cpu().numpy().view(np.uint32), np.asarray(jbits))
    assert tbits.bounds == tuple((2 * k, 2 * k + 2) for k in range(8))


def test_batched_counts_match(pair, monkeypatch):
    je, te = pair
    spy = _Spy(monkeypatch, tk, "gram_gather")
    ops = ["Intersect", "Union", "Difference", "Xor"]
    q = " ".join(f"Count({ops[k % 4]}(Row(f={a}), Row(f={b})))"
                 for k, (a, b) in enumerate([(0, 1), (2, 3), (1, 4), (0, 0), (4, 2), (3, 1)]))
    _same(je, te, q)
    assert spy.calls == 8  # one gram launch a slice


def test_topn_matches(pair, monkeypatch):
    je, te = pair
    spy = _Spy(monkeypatch, tk, "masked_row_counts_per_shard")
    for q in ("TopN(f, n=3)", "TopN(f, Row(g=1), n=4)", "TopN(g, Row(f=0))",
              "TopN(f, Row(g=2), tanimotoThreshold=5)"):
        _same(je, te, q)
    assert spy.calls == 3 * 8


def test_groupby_matches(pair, monkeypatch):
    je, te = pair
    spy = _Spy(monkeypatch, tk, "cross_gram_gather")
    for q in ("GroupBy(Rows(f), Rows(g))", "GroupBy(Rows(g), Rows(f))",
              "GroupBy(Rows(f), Rows(f))", "GroupBy(Rows(f))",
              "GroupBy(Rows(f), Rows(g), filter=Row(f=2))",
              "GroupBy(Rows(f), Rows(g), Rows(f))",
              "GroupBy(Rows(g), Rows(f), Rows(g), filter=Row(f=4))",
              "GroupBy(Rows(f), Rows(g), limit=4)"):
        _same(je, te, q)
    assert spy.calls > 0 and spy.calls % 8 == 0


def test_trees_match(pair, monkeypatch):
    je, te = pair
    counts = _Spy(monkeypatch, tk, "tree_count")
    words = _Spy(monkeypatch, tk, "tree_words")
    q = ("Count(Intersect(Row(f=0), Row(f=1), Row(g=2))) "
         "Count(Intersect(Row(f=2), Row(f=3), Row(g=0))) "
         "Count(Union(Row(f=4), Row(g=1), Row(g=2))) "
         "Count(Union(Row(f=1), Row(g=0), Row(g=1))) "
         "Union(Row(f=0), Row(g=1)) Difference(Row(f=1), Row(g=2)) "
         "Count(Not(Row(f=3))) Count(Not(Row(f=1)))")
    for _ in range(2):
        _same(je, te, q)
    assert counts.calls > 0 and counts.calls % 8 == 0
    assert words.calls > 0 and words.calls % 8 == 0


def test_bsi_matches(pair, monkeypatch):
    je, te = pair
    spies = [_Spy(monkeypatch, tb, n) for n in ("bsi_range", "bsi_sum", "bsi_extreme")]
    for q in ("Count(Row(v > 100)) Count(Row(v < 0)) Count(Row(v >< [10, 300]))",
              "Count(Row(v > 100))", "Count(Row(v > 100))", "Row(v == 7) Row(v != 8)",
              "Sum(field=v) Min(field=v) Max(field=v)",
              "Sum(Row(f=1), field=v) Min(Row(g=2), field=v) Max(Row(f=0), field=v)",
              "GroupBy(Rows(f), filter=Row(v > 400))"):
        _same(je, te, q)
    assert all(s.calls > 0 and s.calls % 8 == 0 for s in spies), [s.calls for s in spies]


def test_writes_invalidate_sharded_stack(pair):
    je, te = pair
    q = ("Count(Intersect(Row(f=0), Row(f=1))) Count(Intersect(Row(f=2), Row(f=3))) "
         "TopN(f, Row(g=0), n=5) Sum(field=v) Count(Union(Row(f=0), Row(g=2)))")
    for _ in range(2):
        before = _same(je, te, q)
    old = {id(t) for st in _slices(te) for t in st.slices}
    width = je.holder.n_words * 32
    col = 5 * width + 17  # shard 5: the third slice of eight
    w = f"Set({col}, f=0) Set({col}, f=1) Set({col}, v=12)"
    je.execute("i", w)
    te.execute("i", w)
    after = _same(je, te, q)
    assert after != before  # the write is seen, as JAX sees it
    assert te.stack_incremental > 0
    # a patch copies only the slice holding shard 5
    stacks = _slices(te)
    kept = [sum(id(t) in old for t in st.slices) for st in stacks]
    assert all(k in (7, 8) for k in kept), kept
    assert any(k == 7 for k in kept)


@pytest.mark.parametrize("n_devices", [4, 8])
def test_dryrun_multichip(n_devices):
    """``dryrun_multichip``'s counterpart: a mesh of n slices over a real
    holder, its stacks laid over all n, and the serving reads against the
    host mirrors."""
    mesh_mod.configure_serving(None, devices=["cpu"] * n_devices)
    holder = Holder(device="cpu")
    idx = holder.create_index("i")
    idx.create_field("f")
    idx.create_field("g")
    ex = TorchExecutor(holder, rescache_entries=0)
    rng = np.random.default_rng(1)
    width = holder.n_words * 32
    pool = rng.integers(0, (n_devices + 2) * width, size=200)
    writes = [f"Set({int(c)}, f={r})" for r in range(4)
              for c in rng.choice(pool, size=60, replace=False)]
    writes += [f"Set({int(c)}, g={r})" for r in range(3)
               for c in rng.choice(pool, size=30, replace=False)]
    ex.execute("i", " ".join(writes))
    assert mesh_mod.serving_mesh().size == n_devices
    shards = sorted(idx.available_shards())
    _, bits = ex._field_stack(idx.field("f"), shards)
    assert len(bits.slices) == n_devices and bits.shape[0] % n_devices == 0
    fv, gv = idx.field("f").view("standard"), idx.field("g").view("standard")

    def truth(a, b, va, vb):
        return sum(int(np.bitwise_count(va.fragment(s).row_words_host(a)
                                        & vb.fragment(s).row_words_host(b)).sum())
                   for s in shards if va.fragment(s) is not None and vb.fragment(s) is not None)

    pairs = [(0, 1), (2, 3), (1, 2)]
    got = ex.execute("i", " ".join(f"Count(Intersect(Row(f={a}), Row(f={b})))" for a, b in pairs))
    assert got == [truth(a, b, fv, fv) for a, b in pairs]
    groups = ex.execute("i", "GroupBy(Rows(f), Rows(g))")[0]
    want = [((a, b), truth(a, b, fv, gv)) for a in range(4) for b in range(3)]
    assert [((g.group[0].row_id, g.group[1].row_id), g.count) for g in groups] == \
        [w for w in want if w[1]]


def test_mesh_of_another_device_type_raises():
    """A mesh set outright on another device type than the holder's
    raises at the stack build: no work moves there unasked."""
    mesh_mod.configure_serving(None, devices=["meta"] * 2)
    holder = Holder(device="cpu")
    holder.create_index("i").create_field("f")
    ex = TorchExecutor(holder, rescache_entries=0)
    ex.execute("i", "Set(1, f=1) Set(2, f=2)")
    with pytest.raises(ValueError, match="serving mesh"):
        ex.execute("i", "Count(Intersect(Row(f=1), Row(f=2))) "
                   "Count(Intersect(Row(f=2), Row(f=1)))")


def test_mixed_layouts_raise():
    ops = meshcases.Operands("cpu", S=4)
    whole = ops.bits
    split = meshcases.layout("cpu", 2)(ops.bits2)
    with pytest.raises(ValueError, match="mixed"):
        tk.pair_count_two_batched(whole, split, [0], [1])
    with pytest.raises(ValueError, match="layouts"):
        tk.cross_gram_gather(split, meshcases.layout("cpu", 4)(whole), [0], [1])
    with pytest.raises(IndexError):
        split[0]


_OPERANDS = {}


@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("case", sorted(meshcases.CASES))
def test_wrapper_over_sharded_stack(case, n):
    """Each wrapper over a stack laid over n slices answers as over the
    whole stack (the per-shard answers' padded shards zero)."""
    ops = _OPERANDS.setdefault("cpu", meshcases.Operands("cpu"))
    whole, got = meshcases.run_case(case, ops, n)
    assert whole.shape == got.shape and np.array_equal(whole, got), case



def test_spanning_stacks_decline_as_in_jax(pair, monkeypatch):
    """Stacks read as spanning processes (``stack_spans_processes``
    forced): the bitmap trees, the k-level GroupBy and the batched BSI
    lane decline to their per-call paths, a tree Count batch sums its
    slices' totals (the spanning count program), and every answer still
    equals JAX's."""
    je, te = pair
    monkeypatch.setattr(tk, "stack_spans_processes", sharded.is_sharded)
    words = _Spy(monkeypatch, tk, "tree_words")
    combos = _Spy(monkeypatch, tk, "combo_counts_gram")
    counts = _Spy(monkeypatch, tk, "tree_count")
    for q in ("Union(Row(f=0), Row(g=1)) Xor(Row(f=2), Row(g=0))",
              "Count(Intersect(Row(f=0), Row(g=2))) Count(Intersect(Row(f=3), Row(g=1)))",
              "GroupBy(Rows(f), Rows(g), Rows(f), filter=Row(g=0))",
              "Count(Row(v > 100)) Count(Row(v < 300)) Sum(field=v) Max(field=v)"):
        _same(je, te, q)
    assert words.calls == 0 and combos.calls == 0
    assert counts.calls == 8
