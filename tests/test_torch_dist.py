"""A three-node cluster of the port against a three-node JAX cluster, on
the CPU.

A port ``InProcessCluster`` (``replica_n=2``, ``device="cpu"``) and a JAX
one are fed the same schema and the same seeded imports, routed through
node 0, and must give equal JSON through every node, once on the mesh
route (the default: the nodes of one process answer each other's shards
in one executor call over a holder facade) and once on the HTTP fan-out
(``mesh_dispatch=False`` on every node): Count trees, bitmap calls, TopN
(the second pass's exactness case too), Rows, GroupBy, the BSI
conditions, Sum, Min and Max; Set, Clear, ClearRow, Store and
SetRowAttrs, each found on every replica; a keyed index written through a
node that is not the translation primary and read through a third; the
write cap; and the remote available shards each node learned.

The port alone must also keep answers exact with a node stopped, fail
over to a replica when the fault registry resets a peer's connections,
read on the mesh route a write made through a peer, and let a device
fault raised on the mesh route propagate instead of demoting it to HTTP.

Every wait is bounded by the client's own timeout; the clusters are
module fixtures whose teardown stops every node; nothing depends on wall
time. The module freezes what came before it and collects after each
test, as the other parity files do.
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

from pilosa_tpu.testing.cluster import InProcessCluster as JaxCluster
from pilosa_tpu_torch.cluster import dist as tdist
from pilosa_tpu_torch.exec.executor import ExecuteError
from pilosa_tpu_torch.ops import kernels as tk
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
from pilosa_tpu_torch.testing.cluster import InProcessCluster as TorchCluster

SEED = 1515
N_SHARDS = 8
# the samplers off: they change no answer, and their threads would only
# load the other test workers
KNOBS = {"replica_n": 2, "flight_recorder": False, "history_enabled": False}
# a short client timeout bounds every wait on a stopped or faulted peer
CLIENT_TIMEOUT = 5.0


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


def _data():
    rng = np.random.default_rng(SEED)
    n = 6000
    cols = rng.integers(0, N_SHARDS * SHARD_WIDTH, n).astype(np.uint64)
    rows = rng.integers(0, 8, n).astype(np.uint64)
    gcols = rng.integers(0, N_SHARDS * SHARD_WIDTH, 2000).astype(np.uint64)
    grows = rng.integers(0, 4, 2000).astype(np.uint64)
    vcols = np.unique(rng.integers(0, N_SHARDS * SHARD_WIDTH, 900)).astype(np.uint64)
    vals = rng.integers(-50, 1000, len(vcols)).astype(np.int64)
    return cols, rows, gcols, grows, vcols, vals


def _load(cl):
    cols, rows, gcols, grows, vcols, vals = _data()
    cl.create_index("i")
    cl.create_field("i", "f")
    cl.create_field("i", "g")
    cl.create_field("i", "v", {"type": "int", "min": -100, "max": 1000})
    api = cl.nodes[0].api
    api.import_bits("i", "f", {"rowIDs": rows, "columnIDs": cols})
    api.import_bits("i", "g", {"rowIDs": grows, "columnIDs": gcols})
    api.import_bits("i", "v", {"columnIDs": vcols, "values": vals})
    # the second pass of TopN: row 29 is no node's first, but the global one
    owner0 = cl.owner_of("i", 0).node_id
    shard_b = next(s for s in range(1, 64) if cl.owner_of("i", s).node_id != owner0)
    base = shard_b * SHARD_WIDTH
    bits = [(21, c) for c in range(4)] + [(29, 100 + c) for c in range(3)]
    bits += [(29, base + c) for c in range(3)] + [(22, base + 100)]
    cl.create_field("i", "t")
    api.import_bits("i", "t", {"rowIDs": [r for r, _ in bits], "columnIDs": [c for _, c in bits]})
    # a keyed index; keys are allocated through the translation primary
    cl.create_index("k", {"keys": True})
    cl.create_field("k", "kf", {"keys": True})
    return cl


def _cluster(pkg, mesh):
    if pkg == "torch":
        cl = TorchCluster(3, device="cpu", mesh_dispatch=mesh, **KNOBS)
    else:
        cl = JaxCluster(3, mesh_dispatch=mesh, **KNOBS)
    for n in cl.nodes:
        n.client.timeout = CLIENT_TIMEOUT
    return _load(cl)


@pytest.fixture(scope="module", params=["mesh", "http"])
def pair(request):
    mesh = request.param == "mesh"
    j = _cluster("jax", mesh)
    t = _cluster("torch", mesh)
    try:
        yield request.param, j, t
    finally:
        t.close()
        j.close()


READS = [
    "Count(Row(f=1))",
    "Count(Intersect(Row(f=1), Row(f=2)))",
    "Count(Union(Row(f=1), Row(g=2), Row(f=5)))",
    "Count(Difference(Row(f=3), Row(g=1)))",
    "Count(Xor(Row(f=4), Row(f=6)))",
    "Count(Not(Row(f=7)))",
    "Row(g=3)",
    "Intersect(Row(f=2), Row(g=0))",
    "Union(Row(f=0), Row(g=1))",
    "TopN(f, n=3)",
    "TopN(f, Row(g=1), n=4)",
    "TopN(t, n=1)",
    "TopN(t, n=2)",
    "TopN(t, n=3)",
    "Rows(f)",
    "Rows(g, limit=2)",
    "GroupBy(Rows(f))",
    "GroupBy(Rows(f), Rows(g))",
    "GroupBy(Rows(g), filter=Row(f=1))",
    "Count(Row(v > 500))",
    "Row(v < 0)",
    "Count(Row(-10 < v < 200))",
    "Sum(field=v)",
    "Sum(Row(f=1), field=v)",
    "Min(field=v)",
    "Max(field=v)",
    "Max(Row(g=2), field=v)",
    "MinRow(field=f)",
    "MaxRow(field=f)",
    "Count(Row(f=1)) TopN(g, n=2) Sum(field=v)",
]


# Reads whose JAX answer on the HTTP route is wrong: JAX's reducer takes a
# tie of MinRow (and Min) for a win, so one partial's count replaces the
# others' where several nodes hold the least row. The port sums the tie;
# its answer is held to the numpy truth instead.
JAX_TIE_FAULT = {"MinRow(field=f)"}


def _min_row_truth():
    cols, rows, *_ = _data()
    r = int(rows.min())
    return {"results": [{"count": len(set(cols[rows == r].tolist())), "id": r}]}


@pytest.mark.parametrize("q", range(len(READS)))
def test_reads_equal_jax_through_every_node(pair, q):
    route, j, t = pair
    pql = READS[q]
    for node in range(3):
        got = t.query(node, "i", pql)
        if pql in JAX_TIE_FAULT:
            assert got == _min_row_truth(), (route, node, pql)
            continue
        want = j.query(node, "i", pql)
        assert got == want, (route, node, pql)


# Reads of ``Options(..., shards=[...])`` whose JAX answer is wrong on the
# HTTP route: JAX's coordinator maps the call over every available shard and
# each remote leg re-applies the Options' list, so every replica counts each
# listed shard it holds (244 for 122 at replica_n=2). The port's coordinator
# partitions the listed shards and each leg keeps to its partition, so these
# reads are held, on both routes, to one port holder with the same data.
JAX_OPTIONS_SHARDS_FAULT = [
    "Options(Count(Row(f=3)), shards=[1, 2, 3, 4])",
    "Options(Count(Row(f=3)), shards=[1])",
    "Options(Sum(field=v), shards=[1, 2])",
    "Options(Sum(Row(f=1), field=v), shards=[0, 5, 7])",
    "Options(TopN(f, n=2), shards=[1, 2])",
    "Options(TopN(f, Row(g=1), n=3), shards=[2, 3, 6])",
    "Options(Count(Row(f=3)), shards=[1, 99])",
]


@pytest.fixture(scope="module")
def one_holder():
    """One port API over one holder, fed the same data as the clusters."""
    from pilosa_tpu_torch.core.holder import Holder
    from pilosa_tpu_torch.server.api import API

    api = API(Holder(device="cpu"), batch_window=0)
    cols, rows, gcols, grows, vcols, vals = _data()
    api.create_index("i", {})
    api.create_field("i", "f", {})
    api.create_field("i", "g", {})
    api.create_field("i", "v", {"type": "int", "min": -100, "max": 1000})
    api.import_bits("i", "f", {"rowIDs": rows, "columnIDs": cols})
    api.import_bits("i", "g", {"rowIDs": grows, "columnIDs": gcols})
    api.import_bits("i", "v", {"columnIDs": vcols, "values": vals})
    try:
        yield api
    finally:
        api.close()


@pytest.mark.parametrize("q", range(len(JAX_OPTIONS_SHARDS_FAULT)))
def test_options_shards_equal_one_holder(pair, one_holder, q):
    route, _j, t = pair
    pql = JAX_OPTIONS_SHARDS_FAULT[q]
    want = one_holder.query("i", pql)
    assert want["results"][0] not in (0, [], None), pql
    for node in range(3):
        assert t.query(node, "i", pql) == want, (route, node, pql)


def test_min_ties_sum_across_partials():
    from pilosa_tpu_torch.exec.result import Pair, ValCount
    from pilosa_tpu_torch.pql import parse

    call = parse("Min(field=v)").calls[0]
    parts = [ValCount(3, 2), ValCount(5, 1), ValCount(3, 4), None, ValCount(0, 0)]
    assert tdist._reduce(call, parts) == ValCount(3, 6)
    assert tdist._reduce(parse("Max(field=v)").calls[0], parts) == ValCount(5, 1)
    pairs = [Pair(id=2, count=5), Pair(id=2, count=7), Pair(id=4, count=1)]
    assert tdist._reduce(parse("MinRow(field=f)").calls[0], pairs) == Pair(id=2, count=12)
    assert tdist._reduce(parse("MaxRow(field=f)").calls[0], pairs) == Pair(id=4, count=1)


def test_routes_took_their_way(pair):
    route, j, t = pair
    for node in range(3):
        t.query(node, "i", "Count(Intersect(Row(f=1), Row(f=3))) TopN(f, n=2)")
    snaps = [n.api.dist.snapshot() for n in t.nodes]
    assert all(s["meshFallbacks"] == 0 for s in snaps)
    if route == "mesh":
        assert all(s["meshEnabled"] for s in snaps)
        assert sum(s["meshDispatches"] for s in snaps) >= 3
        assert set(snaps[0]["placement"]) >= {n.node_id for n in t.nodes}
    else:
        assert not any(s["meshEnabled"] for s in snaps)
        assert sum(s["meshDispatches"] for s in snaps) == 0
        fan = t.nodes[0].holder.stats.snapshot()["counters"]
        assert any(k.startswith("dist_http_fanout_total") for k in fan), fan


def test_local_executors_stack_only_the_shards_their_node_holds(pair):
    """A node's fields now report its peers' shards too; its own executor
    still stacks only shards the node holds (the fan-out passes each node
    its own shard list), never a stack padded with a peer's shards."""
    route, _, t = pair
    for node in range(3):
        t.query(node, "i", "TopN(f, Row(g=1), n=2) Count(Intersect(Row(f=1), Row(f=2)))")
    for n in t.nodes:
        held = {s for s in range(N_SHARDS) if n.cluster.owns_shard(n.node_id, "i", s)}
        ex = n.api.executor
        keys = [k for caches in list(ex._stacks.values()) for k in list(caches)]
        assert route == "mesh" or keys
        for shards, _view, _rows in keys:
            assert set(shards) <= held, (n.node_id, shards, held)


def test_remote_available_shards_equal_jax(pair):
    _, j, t = pair
    for node in range(3):
        tj = j.nodes[node].api.available_shards_map()
        tt = t.nodes[node].api.available_shards_map()
        assert tt == tj
        assert tt["i"]["f"] == list(range(N_SHARDS))
        f = t.nodes[node].holder.field("i", "f")
        local = set().union(*(v.available_shards() for v in f.views.values()))
        # every node knows the shards its peers hold, and holds only its own
        assert local < set(range(N_SHARDS)) and f.remote_available_shards
        owned = {s for s in range(N_SHARDS)
                 if t.nodes[node].cluster.owns_shard(t.nodes[node].node_id, "i", s)}
        assert local == owned
    assert t.nodes[1].api.shards_max() == j.nodes[1].api.shards_max()


WRITES = [
    ("Set({c}, f=11)", "Count(Row(f=11)) Row(f=11)"),
    ("Set({c}, f=11) Set({c2}, f=11) Clear({c}, f=11)", "Row(f=11)"),
    ("Store(Row(f=1), f=12)", "Count(Row(f=12)) Count(Intersect(Row(f=12), Row(f=1)))"),
    ("ClearRow(f=12)", "Count(Row(f=12))"),
    ("SetRowAttrs(f, 2, color=\"red\", n=3)", "Row(f=2) TopN(f, n=2)"),
    ("Set({c}, v=77)", "Sum(field=v) Min(field=v) Max(field=v)"),
]


@pytest.mark.parametrize("w", range(len(WRITES)))
def test_writes_land_on_every_replica_as_in_jax(pair, w):
    _, j, t = pair
    c = 3 * SHARD_WIDTH + 17 + w
    c2 = 5 * SHARD_WIDTH + 2 + w
    write, read = WRITES[w]
    write = write.format(c=c, c2=c2)
    node = (w % 2) + 1  # through a node that is not the coordinator
    assert t.query(node, "i", write) == j.query(node, "i", write)
    for reader in range(3):
        assert t.query(reader, "i", read) == j.query(reader, "i", read), (write, reader)
    if write.startswith("Set(") and "f=11" in write:
        shard = c // SHARD_WIDTH
        owners = {n.id for n in t.nodes[0].cluster.shard_nodes("i", shard)}
        want = "Clear" not in write
        for n in t.nodes:
            frag = n.holder.fragment("i", "f", "standard", shard)
            if n.node_id in owners:
                assert frag is not None and frag.get_bit(11, c % SHARD_WIDTH) == want
            else:
                assert frag is None or not frag.get_bit(11, c % SHARD_WIDTH)
    if write.startswith("SetRowAttrs"):
        for n in t.nodes:
            assert n.holder.field("i", "f").row_attrs.attrs(2) == {"color": "red", "n": 3}
    if write.startswith("Store"):
        # every replica of every shard holds the stored row
        for s in range(N_SHARDS):
            owners = [n for n in t.nodes
                      if n.cluster.owns_shard(n.node_id, "i", s)]
            words = [n.holder.fragment("i", "f", "standard", s).row_words_host(12)
                     for n in owners]
            assert len(owners) == 2
            np.testing.assert_array_equal(words[0], words[1])


def test_keyed_index_through_a_non_primary_node(pair):
    _, j, t = pair
    primary = t.coordinator_id
    writer = next(i for i, n in enumerate(t.nodes) if n.node_id != primary)
    reader = next(i for i, n in enumerate(t.nodes)
                  if n.node_id != primary and i != writer)
    w = 'Set("alice", kf="red") Set("bob", kf="red") Set("bob", kf="blue")'
    jw = next(i for i, n in enumerate(j.nodes) if n.node_id != j.coordinator_id)
    jr = next(i for i, n in enumerate(j.nodes) if n.node_id != j.coordinator_id and i != jw)
    assert t.query(writer, "k", w) == j.query(jw, "k", w)
    for q in ('Row(kf="red")', 'Count(Row(kf="blue"))', "TopN(kf)", "Rows(kf)"):
        got, want = t.query(reader, "k", q), j.query(jr, "k", q)
        if q.startswith("Row("):
            got["results"][0]["keys"].sort()
            want["results"][0]["keys"].sort()
        assert got == want, q
    # the ids came from the primary: every node maps the keys alike
    ids = [n.api.translate_keys("k", "kf", ["red", "blue"]) for n in t.nodes]
    assert ids[0] == ids[1] == ids[2]
    log = t.nodes[[n.node_id for n in t.nodes].index(primary)].api.translate_log(0)
    assert log["len"] >= 4 and len(log["entries"]) == log["len"]


def test_the_write_cap_answers_as_jax(pair):
    _, j, t = pair
    for cl in (j, t):
        cl.nodes[0].api.executor.max_writes_per_request = 2
    try:
        q = "Set(1, f=13) Set(2, f=13) Set(3, f=13)"
        errs = []
        for cl in (j, t):
            with pytest.raises(Exception) as e:
                cl.query(0, "i", q)
            errs.append((type(e.value).__name__, str(e.value), getattr(e.value, "code", None)))
        assert errs[0] == errs[1]
        assert t.query(0, "i", "Count(Row(f=13))") == {"results": [0]}
    finally:
        for cl in (j, t):
            cl.nodes[0].api.executor.max_writes_per_request = 5000


def test_schema_broadcast_reaches_every_node(pair):
    _, j, t = pair
    t.nodes[2].api.create_field("i", "late")
    assert all(n.holder.field("i", "late") is not None for n in t.nodes)
    t.nodes[1].api.delete_field("i", "late")
    assert all(n.holder.field("i", "late") is None for n in t.nodes)
    assert [n.api.schema() for n in t.nodes][0] == t.nodes[2].api.schema()
    status = t.nodes[1].api.status()
    assert status["coordinator"] == t.coordinator_id and not status["resizePending"]
    assert len(status["nodes"]) == 3 and status["state"] == "NORMAL"


# -- the port alone -------------------------------------------------------------


@pytest.fixture(scope="module")
def lone():
    cl = TorchCluster(3, device="cpu", **KNOBS)
    for n in cl.nodes:
        n.client.timeout = CLIENT_TIMEOUT
    try:
        yield _load(cl)
    finally:
        cl.close()


def _truth():
    cols, rows, gcols, grows, vcols, vals = _data()
    f1 = set(cols[rows == 1].tolist())
    f2 = set(cols[rows == 2].tolist())
    return {"Count(Row(f=1))": len(f1),
            "Count(Intersect(Row(f=1), Row(f=2)))": len(f1 & f2),
            "Sum(field=v)": {"value": int(vals.sum()), "count": len(vals)}}


def _check_truth(cl, node):
    truth = _truth()
    for q, want in truth.items():
        assert cl.query(node, "i", q)["results"] == [want], q


def test_a_reset_peer_fails_over_to_a_replica(lone):
    for n in lone.nodes:
        n.api.dist.mesh_enabled = False  # every leg over HTTP
    rule = lone.inject_fault("reset", node=1, route="/index/*")
    try:
        for _ in range(2):
            _check_truth(lone, 0)
        assert rule.hits > 0
        events = lone.nodes[0].api.cluster_events()["events"]
        assert any(e["type"] == "fault-injected" for e in events)
    finally:
        lone.clear_faults()
        for n in lone.nodes:
            n.api.dist.mesh_enabled = True
    _check_truth(lone, 0)


def test_a_write_through_a_peer_is_read_on_the_mesh_route(lone):
    before = lone.query(0, "i", "Count(Row(f=5))")["results"][0]
    dist0 = lone.nodes[0].api.dist
    d0 = dist0.mesh_dispatches
    cols = [s * SHARD_WIDTH + 9 for s in range(N_SHARDS)]
    cols = [c for c in cols if not _has_bit(lone, 5, c)]
    lone.query(1, "i", " ".join(f"Set({c}, f=5)" for c in cols))
    assert lone.query(0, "i", "Count(Row(f=5))")["results"][0] == before + len(cols)
    assert dist0.mesh_dispatches > d0
    got = lone.query(2, "i", "Row(f=5)")["results"][0]["columns"]
    assert set(cols) <= set(got)


def _has_bit(cl, row, col):
    shard = col // SHARD_WIDTH
    for n in cl.nodes:
        frag = n.holder.fragment("i", "f", "standard", shard)
        if frag is not None and frag.get_bit(row, col % SHARD_WIDTH):
            return True
    return False


def test_a_device_fault_on_the_mesh_route_propagates(lone, monkeypatch):
    def cuda_fault(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(tk, "masked_row_counts", cuda_fault)
    dist0 = lone.nodes[0].api.dist
    q = "TopN(f, Row(g=1), n=2)"
    with pytest.raises(RuntimeError, match="CUDA error"):
        dist0.execute("i", q)
    with pytest.raises(RuntimeError, match="CUDA error"):
        lone.query(0, "i", q)
    assert dist0.snapshot()["meshFallbacks"] == 0
    monkeypatch.undo()
    assert lone.query(0, "i", "Count(Row(f=1))")["results"] == [_truth()["Count(Row(f=1))"]]


def test_which_faults_are_the_devices():
    # a launch a wrapper refuses, raised inside the kernel wrappers
    import torch

    with pytest.raises(TypeError) as refused:
        tk.row_counts(torch.zeros((2, 3), dtype=torch.int64))
    assert tdist._device_fault(refused.value)
    assert tdist._device_fault(RuntimeError("CUDA error: out of memory"))
    assert tdist._device_fault(torch.cuda.OutOfMemoryError("x"))
    try:
        try:
            raise RuntimeError("CUDA error: misaligned address")
        except RuntimeError as e:
            raise ExecuteError("wrapped") from e
    except ExecuteError as wrapped:
        assert tdist._device_fault(wrapped)
    # what JAX demotes stays demoted
    assert not tdist._device_fault(ExecuteError("index not found: i"))
    assert not tdist._device_fault(KeyError("f"))


def _subprofiles(tree):
    out = list(tree.get("subprofiles", []))
    for child in tree.get("children", []):
        out += _subprofiles(child)
    return out


def test_http_legs_carry_the_callers_context(lone, monkeypatch):
    """The fan-out pool's threads run in a copy of the caller's context:
    the query profile reaches them (each peer's sub-profile is grafted
    under the coordinator's tree), and so does the request's deadline
    (forwarded to the peers as the remaining budget's header)."""
    from pilosa_tpu_torch import deadline
    from pilosa_tpu_torch.cluster import client as tclient

    for n in lone.nodes:
        n.api.dist.mesh_enabled = False
    sent = []
    real = tclient.InternalClient._do_full

    def spy(self, method, uri, path, *a, **k):
        sent.append((path, deadline.remaining()))
        return real(self, method, uri, path, *a, **k)

    monkeypatch.setattr(tclient.InternalClient, "_do_full", spy)
    try:
        resp = lone.nodes[0].api.query("i", "Count(Row(f=1))", profile=True)
        assert resp["results"] == [_truth()["Count(Row(f=1))"]]
        subs = _subprofiles(resp["profile"]["tree"])
        assert subs and {s["node"] for s in subs} <= {n.node_id for n in lone.nodes[1:]}
        sent.clear()
        with deadline.scope(30.0):
            lone.query(0, "i", "Count(Row(f=2))")
        legs = [r for p, r in sent if p.startswith("/index/")]
        assert legs and all(r is not None and 0 < r <= 30.0 for r in legs)
    finally:
        for n in lone.nodes:
            n.api.dist.mesh_enabled = True


def test_the_prefetcher_idles_on_a_node_with_peers(lone):
    """A clustered node's flights run on the facade executor, so the
    batcher never hands a query to its prefetcher (which warms the local
    executor's stacks, over shards that now include the peers'); alone, it
    does."""
    calls = []
    for n in lone.nodes:
        assert n.api.prefetcher is not None and not n.api.batcher.prefetching
        n.api.prefetcher.prefetch_query = lambda *a, **k: calls.append(a) or 0
    try:
        assert lone.query(0, "i", "Count(Row(f=1))")["results"] == [_truth()["Count(Row(f=1))"]]
    finally:
        for n in lone.nodes:
            del n.api.prefetcher.prefetch_query
    assert calls == []
    solo = TorchCluster(1, device="cpu", **KNOBS)
    try:
        assert solo.nodes[0].api.batcher.prefetching
    finally:
        solo.close()


def test_peer_messages_of_later_planes_name_them(lone):
    """The resize and membership planes' messages now apply, as on a JAX
    node: none answers 501, and an unknown type still answers 400."""
    from pilosa_tpu_torch.server.api import ApiError

    api = lone.nodes[1].api
    members = [{"id": n.node_id, "uri": n.uri} for n in lone.nodes]
    epoch = api.cluster.epoch
    api.receive_message({"type": "resize-prepare", "nodes": members, "epoch": epoch + 1})
    assert api.cluster.resize_pending
    api.receive_message({"type": "epoch-flip", "index": "i", "shard": 0, "epoch": epoch + 1})
    api.receive_message({"type": "resize-cancel", "reason": "test"})
    assert not api.cluster.resize_pending
    for msg in ({"type": "node-event"}, {"type": "resize-instruction"},
                {"type": "resize-instruction-complete"},
                {"type": "update-coordinator", "coordinator": lone.nodes[0].node_id}):
        assert api.receive_message(msg) == {}
    assert api.cluster.coordinator_id == lone.nodes[0].node_id
    with pytest.raises(ApiError) as e:
        api.receive_message({"type": "no-such-message"})
    assert e.value.code == 400
    api.receive_message({"type": "node-state", "node": lone.nodes[2].node_id, "state": "DOWN"})
    assert api.state == "DEGRADED"
    api.receive_message({"type": "node-state", "node": lone.nodes[2].node_id, "state": "READY"})
    assert api.state == "NORMAL"
    _check_truth(lone, 1)


# last: it stops a node of the module's cluster
def test_reads_stay_exact_with_a_node_stopped(lone):
    _check_truth(lone, 0)
    lone.stop_node(2)
    for _ in range(3):
        for node in (0, 1):
            _check_truth(lone, node)
    stopped = lone.nodes[2]
    netloc = stopped.uri.split("//")[1]
    # the mesh route lost the stopped node's registration: its shards went
    # over HTTP, failed, and went to the replicas
    assert lone.nodes[0].client.breaker_states().get(netloc) in ("open", "half-open")
    assert lone.nodes[0].api.dist.snapshot()["meshFallbacks"] == 0
