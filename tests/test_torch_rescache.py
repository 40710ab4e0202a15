"""The port's semantic result cache (``pilosa_tpu_torch/exec/rescache.py``)
against ``pilosa_tpu/exec/rescache.py``, on the CPU.

One seeded index is built in both packages (the JAX holder written through
its executor, the port's built from the JAX fragments' rows), and one
scripted run of reads and writes goes through both executors: repeat
reads, flights through ``execute_batch``, point writes (Set, Clear,
ClearRow, Store), field imports, SetRowAttrs and SetColumnAttrs, a write
to another field, and the stale (degraded-tier) lookup. After every step
the answers and the cache's counters (hits, misses, invalidations,
promotions, demotions, maintained hits, degraded hits, stores, evictions,
entries) must be equal; there is no tolerance. The module also checks the
pure parts alike (canonical forms, the field sets a call reads, the
version vector), and that a hit's copy shares no array with the cache.
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

from pilosa_tpu.core.holder import Holder as JaxHolder
from pilosa_tpu.exec import rescache as jr
from pilosa_tpu.exec.executor import Executor as JaxExecutor
from pilosa_tpu.pql import parse as jax_parse
from pilosa_tpu_torch import convert
from pilosa_tpu_torch.exec import rescache as tr
from pilosa_tpu_torch.exec.executor import Executor as TorchExecutor
from pilosa_tpu_torch.exec.result import Row
from pilosa_tpu_torch.pql import parse as torch_parse
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH


@pytest.fixture(scope="module", autouse=True)
def _freeze_what_came_before():
    gc.collect()
    gc.freeze()
    yield
    gc.unfreeze()
    gc.collect()


@pytest.fixture(autouse=True)
def _collect_after_each_test():
    yield
    gc.collect()


N_SHARDS = 3
N_ROWS = 6
COUNTERS = ("entries", "hits", "misses", "invalidations", "promotions", "demotions",
            "maintainedHits", "degradedHits", "stores", "evictions")


def _norm(r):
    if isinstance(r, Exception):
        return ("error", type(r).__name__)
    if isinstance(r, tuple):  # normalized already
        return r
    if isinstance(r, list):
        return [_norm(x) for x in r]
    if hasattr(r, "columns") and hasattr(r, "segments"):
        return ("row", [int(c) for c in r.columns()], dict(r.attrs))
    if hasattr(r, "id") and hasattr(r, "count") and not hasattr(r, "value"):
        return ("pair", int(r.id), int(r.count))
    if hasattr(r, "value") and hasattr(r, "count"):
        return ("vc", int(r.value), int(r.count))
    if hasattr(r, "group") and hasattr(r, "count"):
        return ("group", [(g.field, int(g.row_id)) for g in r.group], int(r.count))
    if hasattr(r, "rows"):
        return ("rows", list(r.rows))
    if isinstance(r, (bool, int, np.integer)) or r is None:
        return r if isinstance(r, bool) or r is None else int(r)
    raise TypeError(type(r))


def _build(seed: int, entries: int = 512, demote: int = 64):
    rng = np.random.default_rng(seed)
    jh = JaxHolder()
    idx = jh.create_index("i")
    for name in ("f", "g"):
        idx.create_field(name)
    je = JaxExecutor(jh, rescache_entries=entries, rescache_demote_deltas=demote)
    n_cols = N_SHARDS * SHARD_WIDTH
    for name, n in (("f", 2500), ("g", 1200)):
        idx.field(name).import_bits(
            rng.integers(0, N_ROWS, n).astype(np.uint64),
            rng.integers(0, n_cols, n).astype(np.uint64),
        )
    cols = rng.integers(0, n_cols, 60)
    je.execute("i", " ".join(f"Set({int(c)}, f={int(c) % N_ROWS})" for c in cols))
    fragments = {}
    for fname, field in idx.fields.items():
        for vname, view in field.views.items():
            for shard, frag in view.fragments.items():
                fragments[("i", fname, vname, shard)] = frag.rows_matrix_host()
    th = convert.holder_from_arrays(jh.schema(), fragments, device="cpu")
    te = TorchExecutor(th, rescache_entries=entries, rescache_demote_deltas=demote)
    return je, te, rng


def _counters(ex):
    snap = ex.rescache.snapshot()
    return {k: snap[k] for k in COUNTERS}


def _step(je, te, what, fn):
    want, got = fn(je), fn(te)
    assert _norm(got) == _norm(want), what
    assert _counters(te) == _counters(je), (what, _counters(je), _counters(te))


READS = [
    "Count(Intersect(Row(f=1), Row(f=2)))",
    "Count(Union(Row(f=0), Row(g=3)))",
    "Intersect(Row(g=1), Row(f=2))",
    "Intersect(Row(f=2), Row(g=1))",  # the same entry: children sorted
    "TopN(f)",
    "TopN(f, n=2)",
    "TopN(g, Row(f=1), n=3)",
    "GroupBy(Rows(f), Rows(g))",
    "Rows(f)",
    "Count(Not(Row(f=0)))",
    "Row(f=3)",
]


def _script(rng):
    n_cols = N_SHARDS * SHARD_WIDTH
    c = [int(x) for x in rng.integers(0, n_cols, 12)]
    imp_rows = rng.integers(0, N_ROWS, 80).astype(np.uint64)
    imp_cols = rng.integers(0, n_cols, 80).astype(np.uint64)
    q = lambda text: ("query", lambda ex, t=text: ex.execute("i", t))  # noqa: E731
    steps = [q(r) for r in READS] + [q(r) for r in READS]
    steps += [q("TopN(f)"), q("TopN(f)"), q("GroupBy(Rows(f), Rows(g))")]  # promote
    steps += [
        ("batch", lambda ex: [
            _norm(x) for x in ex.execute_batch(
                "i", [(r, None) for r in READS] + [(READS[0], [0, 1])]
            )
        ]),
        q(f"Set({c[0]}, f=1)"),  # a point write: the f entries go
    ]
    steps += [q(r) for r in READS]
    steps += [
        q(f"Set({c[1]}, g=4)"),  # a write to g only
        q("TopN(f)"),
        q("Count(Union(Row(f=0), Row(g=3)))"),
        q(f"Clear({c[0]}, f=1)"),
        q("TopN(f)"),
        ("import f", lambda ex: ex.holder.index("i").field("f").import_bits(imp_rows, imp_cols)),
        q("TopN(f)"),
        q("TopN(f, n=2)"),
        q("Count(Intersect(Row(f=1), Row(f=2)))"),
        q("SetRowAttrs(f, 1, color=\"red\")"),
        q("Row(f=3)"),
        q("TopN(f, attrName=\"color\", attrValues=[\"red\"])"),
        q(f"SetColumnAttrs({c[2]}, name=\"x\")"),
        q("Row(f=3)"),
        q("Store(Row(f=2), f=5)"),
        q("ClearRow(f=5)"),
        q("Rows(f)"),
    ]
    steps += [q(f"Set({x}, f={k % N_ROWS})") for k, x in enumerate(c[3:])]
    steps += [q("TopN(f)"), q("GroupBy(Rows(f), Rows(g))"), q("TopN(f, Row(g=1))")]
    steps += [
        ("stale", lambda ex: ex.rescache_degraded("i", _parse(ex)("TopN(f) GroupBy(Rows(f))"))),
        ("stale miss", lambda ex: ex.rescache_degraded("i", _parse(ex)("TopN(g, n=1)"))),
        ("probe", lambda ex: ex.rescache_probe("i", _parse(ex)("TopN(f) Rows(f)"))),
    ]
    return steps


def _parse(ex):
    return jax_parse if isinstance(ex, JaxExecutor) else torch_parse


@pytest.mark.parametrize("entries,demote", [(512, 64), (512, 2), (4, 64)])
def test_scripted_reads_and_writes_count_as_jax(entries, demote):
    je, te, rng = _build(5, entries, demote)
    for what, fn in _script(rng):
        _step(je, te, what, fn)
    snap = te.rescache.snapshot()
    assert snap["hits"] > 0 and snap["invalidations"] > 0
    if demote == 2:
        assert snap["demotions"] > 0
    if entries == 4:
        assert snap["evictions"] > 0
    else:
        assert snap["promotions"] > 0


@pytest.mark.parametrize("text", READS + [
    "Count(Xor(Row(g=1), Row(f=1), Row(f=2)))",
    "TopN(f, attrName=\"a\", attrValues=[1])",
    "Set(1, f=1)",
    "Options(Row(f=1), excludeColumns=true)",
    "Sum(field=f)",
])
def test_canonical_forms_and_field_sets_equal_jax(text):
    je, te, _ = _build(2)
    jq, tq = jax_parse(text).calls[0], torch_parse(text).calls[0]
    jidx, tidx = je.holder.index("i"), te.holder.index("i")
    assert tr.canonical_str(tq) == jr.canonical_str(jq)
    assert tr.collect_fields(tidx, tq) == jr.collect_fields(jidx, jq)
    assert tr.subtree_key(tidx, tq) == jr.subtree_key(jidx, jq)
    fields = jr.collect_fields(jidx, jq)
    if fields:
        jv = jr.version_vector(jidx, fields, None)
        tv = tr.version_vector(tidx, fields, None)
        # (field, view, shard) alike; epochs are each process's own
        assert [v[:3] for v in tv] == [v[:3] for v in jv]


def test_hit_copies_share_no_array_with_the_cache():
    _, te, _ = _build(3)
    first = te.execute("i", "Row(f=2)")[0]
    hit = te.execute("i", "Row(f=2)")[0]
    assert te.rescache.snapshot()["hits"] == 1
    for shard, seg in hit.segments.items():
        seg[:] = 0  # the caller writes into its copy
    again = te.execute("i", "Row(f=2)")[0]
    assert again.columns().tolist() == first.columns().tolist() != []
    row = Row({0: np.arange(4, dtype=np.uint32)}, 4)
    row.attrs = {"a": 1}
    c = tr.copy_result(row)
    assert c.segments[0] is not row.segments[0] and c.attrs is not row.attrs
    assert np.array_equal(c.segments[0], row.segments[0])


def test_entries_zero_keeps_nothing_and_answers_alike():
    je, te, rng = _build(4, entries=0)
    for text in READS * 2:
        _step(je, te, text, lambda ex, t=text: ex.execute("i", t))
    assert te.rescache.snapshot()["entries"] == 0
