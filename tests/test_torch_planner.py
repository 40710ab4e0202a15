"""The port's flight planner (``pilosa_tpu_torch/exec/planner.py``) against
``pilosa_tpu/exec/planner.py``, on the CPU.

The same seeded index in both packages, the same flights through
``execute_batch``: the CSE counters (subtrees shared, consumers served
beyond the first), the reorders, and the answers must be equal, and equal
with the planner off. The lane choice gets the same injected prices in
both (the device lane's ``devledger.measured_ms`` patched, the host lane's
EWMA noted by hand): its verdicts and overrides must be equal; the
executors' own host-lane notes must count alike. ``container_profile``,
which the reorder prices from, must equal JAX's fragment by fragment.
"""

import gc

import numpy as np
import pytest

from pilosa_tpu.core.holder import Holder as JaxHolder
from pilosa_tpu.exec import planner as jp
from pilosa_tpu.exec.executor import Executor as JaxExecutor
from pilosa_tpu_torch import convert
from pilosa_tpu_torch.exec import planner as tp
from pilosa_tpu_torch.exec.executor import Executor as TorchExecutor
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
N_ROWS = 8
PLAN_KEYS = ("cseHits", "cseShared", "reorders", "laneOverrides", "errors")


def _norm(r):
    if isinstance(r, Exception):
        return ("error", type(r).__name__, str(r))
    if isinstance(r, list):
        return [_norm(x) for x in r]
    if hasattr(r, "columns") and hasattr(r, "segments"):
        return ("row", [int(c) for c in r.columns()])
    if hasattr(r, "id") and hasattr(r, "count"):
        return ("pair", int(r.id), int(r.count))
    if hasattr(r, "group") and hasattr(r, "count"):
        return ("group", [(g.field, int(g.row_id)) for g in r.group], int(r.count))
    return int(r)


def _build(seed: int, planner_enabled: bool = True):
    rng = np.random.default_rng(seed)
    jh = JaxHolder()
    idx = jh.create_index("i")
    n_cols = N_SHARDS * SHARD_WIDTH
    # fields of very different densities, so the reorder has work
    for name, n in (("f", 4000), ("g", 600), ("h", 60)):
        idx.create_field(name)
        idx.field(name).import_bits(
            rng.integers(0, N_ROWS, n).astype(np.uint64),
            rng.integers(0, n_cols, n).astype(np.uint64),
        )
    JaxExecutor(jh).execute("i", " ".join(f"Set({c}, f=1)" for c in range(0, n_cols, 97)))
    fragments = {}
    for fname, field in idx.fields.items():
        for vname, view in field.views.items():
            for shard, frag in view.fragments.items():
                fragments[("i", fname, vname, shard)] = frag.rows_matrix_host()
    th = convert.holder_from_arrays(jh.schema(), fragments, device="cpu")
    kw = dict(planner_enabled=planner_enabled, rescache_entries=0)
    return JaxExecutor(jh, **kw), TorchExecutor(th, **kw), rng


def _flight(rng, n=24):
    """A dashboard fan-in: every query shares Intersect(Row(f=1), Row(g=2))
    (in either child order), some share a Union too, mixed with plain
    reads; commutative children arrive densest first."""
    shared = ["Intersect(Row(f=1), Row(g=2))", "Intersect(Row(g=2), Row(f=1))"]
    out = []
    for k in range(n):
        s = shared[k % 2]
        r = int(rng.integers(0, N_ROWS))
        kind = k % 6
        if kind == 0:
            out.append(f"Count(Union({s}, Row(h={r})))")
        elif kind == 1:
            out.append(f"Count(Intersect(Row(f={r}), Row(g={r}), Row(h={r}), {s}))")
        elif kind == 2:
            out.append(f"Difference({s}, Row(f={r}), Row(h={r}))")
        elif kind == 3:
            out.append(f"Count(Xor(Union(Row(f=0), Row(g=0)), {s}))")
        elif kind == 4:
            out.append(s)  # a whole top-level call shared
        else:
            out.append(f"Count(Intersect(Row(f={r}), Row(h={r}))) TopN(g, n=2)")
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_flight_cse_and_reorders_count_as_jax(seed):
    je, te, rng = _build(seed)
    flight = _flight(rng)
    shards = [None] * (len(flight) - 4) + [[0, 2]] * 4
    want = je.execute_batch("i", list(zip(flight, shards)))
    got = te.execute_batch("i", list(zip(flight, shards)))
    assert _norm(got) == _norm(want)
    js, ts = je.planner.snapshot(), te.planner.snapshot()
    assert {k: ts[k] for k in PLAN_KEYS} == {k: js[k] for k in PLAN_KEYS}
    assert ts["cseShared"] >= 1 and ts["cseHits"] >= 1 and ts["reorders"] >= 1
    # the same flight with the planner off answers alike
    je0, te0, _ = _build(seed, planner_enabled=False)
    assert _norm(te0.execute_batch("i", list(zip(flight, shards)))) == _norm(want)
    assert te0.planner.snapshot()["cseHits"] == 0


def test_container_profile_equals_jax():
    je, te, _ = _build(4)
    for fname in ("f", "g", "h"):
        jv = je.holder.index("i").field(fname).view("standard")
        tv = te.holder.index("i").field(fname).view("standard")
        for shard in sorted(jv.fragments):
            jf, tf = jv.fragments[shard], tv.fragments[shard]
            assert tf.container_profile(containers=False) == jf.container_profile(
                containers=False
            )
            assert tf.container_profile() == jf.container_profile()
            # cached under (epoch, version): one write moves it
            tf.set_bit(7, 5)
            jf.set_bit(7, 5)
            assert tf.container_profile() == jf.container_profile()


PRICES = [
    # (device (launches, ms) or None, host (samples, ms) or None, heuristic)
    (None, (9, 2.0), False),
    ((9, 0.5), None, False),
    ((2, 0.5), (9, 2.0), False),
    ((9, 0.5), (9, 2.0), False),
    ((9, 3.0), (9, 2.0), True),
    ((9, 2.0), (9, 2.0), False),
    ((4, 1.0), (4, 1.5), True),
]


@pytest.mark.parametrize("op_class", ["pair_count", "tree_count", "other"])
def test_lane_choice_with_injected_prices_equals_jax(monkeypatch, op_class):
    je, te, _ = _build(5)
    for dev, host, heuristic in PRICES:
        for mod, ex in ((jp, je), (tp, te)):
            monkeypatch.setattr(mod.devledger, "measured_ms", lambda site, cls, d=dev: d)
            ex.planner.lanes._host.clear()
            if host is not None:
                ex.planner.lanes._host[op_class] = list(host)
        assert te.planner.choose_lane(op_class, heuristic) == je.planner.choose_lane(
            op_class, heuristic
        )
    assert te.planner.lane_overrides == je.planner.lane_overrides
    if op_class != "other":
        assert te.planner.lane_overrides >= 1
    # the disabled planner keeps the heuristic
    te.planner.enabled = False
    assert te.planner.choose_lane(op_class, True) is True


def test_host_lane_notes_and_lane_overrides_in_the_executor_equal_jax(monkeypatch):
    """Lone cold pair and tree Counts note the host lane's price in both
    executors alike; once a device price below it is injected, the warm-up
    gates give way to it in both."""
    je, te, _ = _build(6)
    lone = ["Count(Intersect(Row(f=1), Row(f=2)))", "Count(Union(Row(g=1), Row(h=2)))",
            "Count(Xor(Row(f=3), Row(f=4)))", "Count(Intersect(Row(g=2), Row(f=0), Row(h=1)))"]
    for q in lone * 2:
        assert _norm(te.execute("i", q)) == _norm(je.execute("i", q)), q
    jh = {k: v["samples"] for k, v in je.planner.snapshot()["lanes"]["host"].items()}
    th = {k: v["samples"] for k, v in te.planner.snapshot()["lanes"]["host"].items()}
    assert th == jh and th
    for mod in (jp, tp):
        monkeypatch.setattr(mod.devledger, "measured_ms", lambda site, cls: (100, 1e-6))
    for ex in (je, te):
        for cls in ex.planner.lanes._host:
            ex.planner.lanes._host[cls] = [100, 10.0]
    for q in lone:
        assert _norm(te.execute("i", q)) == _norm(je.execute("i", q)), q
    assert te.planner.lane_overrides == je.planner.lane_overrides >= 1
    assert te.stack_rebuilds >= 1


def test_shared_node_declines_the_kernel_path_and_is_never_cached():
    """A graft node is never cached, and the kernel path no longer declines
    it: it is a leaf of the flight's shared stack, and the tree kernel's
    answer equals the host algebra's and the ungrafted query's."""
    _, te, _ = _build(7)
    idx = te.holder.index("i")
    row = te.execute("i", "Intersect(Row(f=1), Row(g=2))")[0]
    node = tp.make_shared(row)
    from pilosa_tpu_torch.exec import astbatch, executor, rescache
    from pilosa_tpu_torch.pql.ast import Call

    tree = Call("Count", {}, [Call("Union", {}, [node, Call("Row", {"h": 1}, [])])])
    leaves, pairs = [], []
    assert astbatch.match_count(idx, tree, leaves, pairs) == (
        "union", ("row", 0), ("row", 1))
    assert pairs == [(tp.SHARED, ""), ("h", "standard")]
    assert leaves[0] == (tp.SHARED, "", id(row))
    assert rescache.collect_fields(idx, tree) is None
    assert tp.contains_shared(tree) and not tp.contains_shared(tree.children[0].children[1])
    assert tp.shared_rows(tree, {}) == {id(row): row}
    want = te.execute("i", "Count(Union(Intersect(Row(f=1), Row(g=2)), Row(h=1)))")[0]
    assert te._execute_call(idx, tree, None) == want
    te._field_stack(idx.field("h"), te._shards_for(idx, None))  # a live stack
    got = [executor._UNSET]
    uploads = te.shared_stack_uploads
    te._batch_general(idx, [tree], None, got)
    assert got == [want] and te.shared_stack_uploads == uploads + 1
