"""The port's placement, state machine, topology file, wire and fault
registry against the JAX package's, on the CPU.

Seeded keys, shards and topologies go through both packages' functions,
which must agree exactly: ``jump_hash`` and ``partition_hash``;
``shard_nodes``, ``primary_shard_node`` and ``shards_by_node`` for
``replica_n`` 1-3 with fixed node ids; the state machine's transitions;
topology and ``.id`` files written by one package and read by the other;
every wire result type (the port's rows from ``int32`` views too); the
``PTI1`` binary import encoded by one package and decoded by the other,
byte-equal; and the fault registry's seeded firing and hook points.
Nothing here depends on wall time.
"""

import json

import numpy as np
import pytest

from pilosa_tpu.cluster import cluster as jcluster
from pilosa_tpu.cluster import hash as jhash
from pilosa_tpu.cluster import topology as jtopo
from pilosa_tpu.cluster import wire as jwire
from pilosa_tpu.exec import result as jres
from pilosa_tpu.testing import faults as jfaults
from pilosa_tpu_torch.cluster import client as tclient
from pilosa_tpu_torch.cluster import cluster as tcluster
from pilosa_tpu_torch.cluster import hash as thash
from pilosa_tpu_torch.cluster import topology as ttopo
from pilosa_tpu_torch.cluster import wire as twire
from pilosa_tpu_torch.exec import result as tres
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
from pilosa_tpu_torch.storage import fragmentfile as tff
from pilosa_tpu_torch.testing import faults as tfaults

SEED = 15
NODE_IDS = [f"node-{c}" for c in "qbzamtr"]


# -- hashing ----------------------------------------------------------------


@pytest.mark.parametrize("n_buckets", [1, 2, 3, 5, 8, 64, 257])
def test_jump_hash_equals_jax(n_buckets):
    rng = np.random.default_rng(SEED + n_buckets)
    keys = [int(k) for k in rng.integers(0, 2**63, 500)] + list(range(50)) + [2**64 - 1]
    assert [thash.jump_hash(k, n_buckets) for k in keys] == [
        jhash.jump_hash(k, n_buckets) for k in keys
    ]


def test_jump_hash_refuses_no_buckets():
    with pytest.raises(ValueError):
        thash.jump_hash(1, 0)


@pytest.mark.parametrize("partition_n", [1, 16, 256])
def test_partition_hash_equals_jax(partition_n):
    rng = np.random.default_rng(SEED)
    shards = [int(s) for s in rng.integers(0, 2**40, 300)] + list(range(200))
    for index in ("i", "serving", "ключ", "a" * 40):
        assert [thash.partition_hash(index, s, partition_n) for s in shards] == [
            jhash.partition_hash(index, s, partition_n) for s in shards
        ]
    assert thash.fnv1a64(b"pilosa") == jhash.fnv1a64(b"pilosa")


# -- placement ----------------------------------------------------------------


def _pair(ids, replica_n, partition_n=256):
    nodes = [(i, f"http://h{k}:1") for k, i in enumerate(ids)]
    j = jcluster.Cluster(ids[0], replica_n=replica_n, partition_n=partition_n)
    t = tcluster.Cluster(ids[0], replica_n=replica_n, partition_n=partition_n)
    j.set_static([jtopo.Node(id=i, uri=u) for i, u in nodes])
    t.set_static([ttopo.Node(id=i, uri=u) for i, u in nodes])
    return j, t


@pytest.mark.parametrize("replica_n", [1, 2, 3])
@pytest.mark.parametrize("n_nodes", [1, 2, 3, 5, 7])
def test_placement_equals_jax(n_nodes, replica_n):
    rng = np.random.default_rng(SEED * 100 + n_nodes * 10 + replica_n)
    ids = [NODE_IDS[i] for i in rng.permutation(len(NODE_IDS))[:n_nodes]]
    j, t = _pair(ids, replica_n)
    shards = sorted({int(s) for s in rng.integers(0, 5000, 400)})
    for index in ("i", "serving"):
        for s in shards:
            assert [n.id for n in t.shard_nodes(index, s)] == [
                n.id for n in j.shard_nodes(index, s)
            ]
            assert t.primary_shard_node(index, s).id == j.primary_shard_node(index, s).id
            assert t.partition(index, s) == j.partition(index, s)
        assert t.shards_by_node(index, shards) == j.shards_by_node(index, shards)
        for nid in ids:
            assert t.owned_shards(nid, index, shards) == j.owned_shards(nid, index, shards)
    for p in range(256):
        assert [n.id for n in t.partition_nodes(p)] == [n.id for n in j.partition_nodes(p)]
    assert t.translate_primary().id == j.translate_primary().id
    assert t.status() == j.status()
    assert t.nodes_info() == j.nodes_info()


def test_placement_during_a_resize_equals_jax():
    j, t = _pair(NODE_IDS[:3], 2)
    pending = NODE_IDS[:4]
    ej = j.begin_resize([jtopo.Node(id=i) for i in pending])
    et = t.begin_resize([ttopo.Node(id=i) for i in pending])
    assert ej == et
    for s in (0, 5, 9):
        assert j.flip_shard("i", s, ej) and t.flip_shard("i", s, et)
    assert not t.flip_shard("i", 11, et + 1) and not j.flip_shard("i", 11, ej + 1)
    for s in range(40):
        assert [n.id for n in t.shard_nodes("i", s)] == [n.id for n in j.shard_nodes("i", s)]
    assert t.status() == j.status()
    j.abort_resize()
    t.abort_resize()
    assert t.status() == j.status()


# -- the state machine --------------------------------------------------------


@pytest.mark.parametrize("replica_n", [1, 2, 3])
def test_state_machine_equals_jax(replica_n):
    j, t = _pair(NODE_IDS[:4], replica_n)
    seen = {"j": [], "t": []}
    j.on_state_change = seen["j"].append
    t.on_state_change = seen["t"].append
    steps = [
        ("mark", NODE_IDS[1], jtopo.NODE_STATE_DOWN),
        ("mark", NODE_IDS[2], jtopo.NODE_STATE_DOWN),
        ("mark", NODE_IDS[3], jtopo.NODE_STATE_DOWN),
        ("mark", NODE_IDS[1], jtopo.NODE_STATE_READY),
        ("set", jcluster.STATE_RESIZING, None),
        ("mark", NODE_IDS[2], jtopo.NODE_STATE_READY),
        ("set", jcluster.STATE_NORMAL, None),
        ("mark", NODE_IDS[3], jtopo.NODE_STATE_READY),
    ]
    for kind, a, b in steps:
        if kind == "mark":
            j.mark_node_state(a, b)
            t.mark_node_state(a, b)
        else:
            j.set_state(a)
            t.set_state(a)
        assert t.state == j.state and t.determine_state() == j.determine_state()
    assert seen["t"] == seen["j"] and seen["t"]
    # a membership commit ends in NORMAL and reaches the hook
    j.set_state(jcluster.STATE_RESIZING)
    t.set_state(tcluster.STATE_RESIZING)
    j.set_static([jtopo.Node(id=i) for i in NODE_IDS[:2]])
    t.set_static([ttopo.Node(id=i) for i in NODE_IDS[:2]])
    assert t.state == j.state == tcluster.STATE_NORMAL
    assert seen["t"] == seen["j"]
    standalone = tcluster.Cluster("solo")
    assert standalone.state == jcluster.Cluster("solo").state == tcluster.STATE_NORMAL
    assert tcluster.Cluster("a", disabled=False).state == tcluster.STATE_STARTING


def test_membership_edits_equal_jax():
    j, t = _pair(NODE_IDS[:3], 2)
    for c in (j, t):
        c.add_node(type(c.nodes[0])(id="node-0", uri="http://x:1"))
        c.add_node(type(c.nodes[0])(id="node-0", uri="http://x:2"))  # kept once
        assert c.remove_node(NODE_IDS[1]) and not c.remove_node("nobody")
    assert t.nodes_info() == j.nodes_info()
    assert t.is_coordinator == j.is_coordinator and t.local_node.id == j.local_node.id


# -- topology and node id files ----------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_topology_file_reads_in_both_packages(tmp_path, writer):
    W, R = (jtopo, ttopo) if writer == "jax" else (ttopo, jtopo)
    topo = W.Topology(["n3", "n1"])
    topo.add("n2")
    topo.add("n1")
    topo.remove("n9")
    topo.save(str(tmp_path))
    raw = (tmp_path / ".topology").read_bytes()
    back = R.Topology.load(str(tmp_path))
    assert back.node_ids == ["n1", "n2", "n3"] and back.contains("n2")
    back.save(str(tmp_path / "again"))
    assert (tmp_path / "again" / ".topology").read_bytes() == raw
    assert json.loads(raw) == {"nodeIDs": ["n1", "n2", "n3"]}
    assert R.Topology.load(str(tmp_path / "none")).node_ids == []
    nid = W.load_or_create_node_id(str(tmp_path / "d"))
    assert R.load_or_create_node_id(str(tmp_path / "d")) == nid
    assert len(R.load_or_create_node_id(None)) == 32


def test_node_dicts_equal_jax():
    d = {"id": "a", "uri": "http://h:1", "isCoordinator": True, "state": "DOWN"}
    assert ttopo.Node.from_dict(d).to_dict() == jtopo.Node.from_dict(d).to_dict() == d
    assert ttopo.Node.from_dict({"id": "b"}).to_dict() == jtopo.Node.from_dict({"id": "b"}).to_dict()
    assert sorted([ttopo.Node("z"), ttopo.Node("a")])[0].id == "a"


# -- the wire -------------------------------------------------------------------


def _rows(rng):
    W = SHARD_WIDTH // 32
    segs = {int(s): rng.integers(0, 2**32, W, dtype=np.uint64).astype(np.uint32)
            for s in rng.choice(50, 3, replace=False)}
    return segs


def _results(pkg, segs, int32_view=False):
    r = pkg
    row_segs = {s: (w.view(np.int32) if int32_view else w) for s, w in segs.items()}
    return [
        r.Row(row_segs),
        r.Row({}),
        r.ValCount(value=-17, count=4),
        r.ValCount(),
        r.Pair(id=9, count=3),
        r.Pair(id=0, key="k", count=1),
        r.RowIdentifiers(rows=[1, 5, 9]),
        r.RowIdentifiers(rows=[], keys=["a", "b"]),
        r.GroupCount(group=[r.FieldRow(field="f", row_id=2),
                            r.FieldRow(field="g", row_id=0, row_key="x")], count=7),
        [r.Pair(id=1, count=2), r.Pair(id=3, count=1)],
        [],
        True,
        False,
        12345678901,
        None,
        "s",
        np.int64(42),
    ]


@pytest.mark.parametrize("int32_view", [False, True])
def test_wire_results_equal_jax(int32_view):
    rng = np.random.default_rng(SEED)
    segs = _rows(rng)
    t_enc = twire.encode_results(_results(tres, segs, int32_view))
    j_enc = jwire.encode_results(_results(jres, segs))
    assert json.dumps(t_enc, sort_keys=True) == json.dumps(j_enc, sort_keys=True)
    # each package decodes the other's encoding to the same results
    t_dec = twire.decode_results(json.loads(json.dumps(j_enc)))
    j_dec = jwire.decode_results(json.loads(json.dumps(t_enc)))
    for t, j in zip(t_dec, j_dec):
        if isinstance(t, tres.Row):
            assert sorted(t.segments) == sorted(j.segments)
            for s in t.segments:
                assert t.segments[s].dtype == np.uint32
                assert t.segments[s].flags.writeable
                np.testing.assert_array_equal(t.segments[s], np.asarray(j.segments[s]))
            assert t.count() == sum(int(np.unpackbits(
                np.asarray(j.segments[s]).view(np.uint8)).sum()) for s in j.segments)
        elif isinstance(t, list):
            assert [x.to_dict() for x in t] == [x.to_dict() for x in j]
        elif hasattr(t, "to_dict"):
            assert t.to_dict() == j.to_dict()
        else:
            assert t == j


def test_wire_refuses_unknown_types():
    with pytest.raises(TypeError):
        twire.encode_result(object())
    with pytest.raises(TypeError):
        twire.decode_result({"type": "nope"})


def _import_requests(rng):
    W = SHARD_WIDTH
    n = 3000
    cols = rng.integers(0, 9 * W, n, dtype=np.uint64)
    rows = rng.integers(0, 70, n, dtype=np.uint64)
    return [
        {"rowIDs": rows, "columnIDs": cols, "_width": W},
        {"rowIDs": rows[:10].tolist(), "columnIDs": cols[:10].tolist(), "clear": True,
         "remote": True, "_width": W},
        {"columnIDs": cols[:500], "values": rng.integers(-1000, 1000, 500)},
        {"columnIDs": cols[:5], "values": [1, 2, 3, 4, 5], "clear": True, "remote": True},
        {"rowIDs": [], "columnIDs": [], "_width": W},
    ]


@pytest.mark.parametrize("case", range(5))
def test_pti1_import_equals_jax_both_ways(case):
    req = _import_requests(np.random.default_rng(SEED))[case]
    tb = twire.encode_import(dict(req))
    jb = jwire.encode_import(dict(req))
    assert tb is not None and tb == jb and tb[:4] == b"PTI1"
    # each package decodes the other's body to equal requests
    t, j = twire.decode_import(jb), jwire.decode_import(tb)
    assert set(t) == set(j)
    for k in t:
        if k == "_segments":
            assert len(t[k]) == len(j[k])
            for a, b in zip(t[k], j[k]):
                assert a[0] == b[0]
                np.testing.assert_array_equal(a[1], b[1])
                np.testing.assert_array_equal(a[2], b[2])
        elif isinstance(t[k], np.ndarray):
            assert t[k].dtype == j[k].dtype
            np.testing.assert_array_equal(t[k], j[k])
        else:
            assert t[k] == j[k]
    # the decoded pairs are the request's, as a set (one bit a position)
    back = twire.decode_import(tb)
    if "rowIDs" in req and len(req["rowIDs"]):
        got = set(zip(back["rowIDs"].tolist(), back["columnIDs"].tolist()))
        want = set(zip(np.asarray(req["rowIDs"]).tolist(), np.asarray(req["columnIDs"]).tolist()))
        assert got == want
    if "values" in req:
        np.testing.assert_array_equal(back["values"], np.asarray(req["values"]))


def test_pti1_declines_what_jax_declines():
    for req in ({"rowKeys": ["a"], "columnIDs": [1]},
                {"rowIDs": [1], "columnIDs": [1], "timestamps": ["2020-01-01T00:00"]},
                {"rowIDs": [1]},
                {"rowIDs": [1], "columnIDs": [2]},  # no width
                {"rowIDs": [2**62], "columnIDs": [2], "_width": 8}):
        assert twire.encode_import(dict(req)) is None
        assert jwire.encode_import(dict(req)) is None
    with pytest.raises(ValueError):
        twire.decode_import(b"XXXX" + bytes(8))


def test_migrate_frames_equal_jax():
    h = {"ops": 3, "pending": 1}
    assert twire.encode_migrate_frame(h, b"abc") == jwire.encode_migrate_frame(h, b"abc")
    assert twire.decode_migrate_frame(jwire.encode_migrate_frame(h, b"x")) == (h, b"x")
    with pytest.raises(ValueError):
        twire.decode_migrate_frame(b"PTI1")


# -- the fault registry -------------------------------------------------------


def test_fault_registry_fires_as_jax_does():
    out = {}
    for name, mod in (("jax", jfaults), ("torch", tfaults)):
        reg = mod.FaultRegistry(seed=SEED)
        fired = []
        reg.on_fire = lambda kind, target, _f=fired: _f.append((kind, target))
        reg.add("error", peer="127.0.0.1:9*", route="/index/*", code=502, p=0.5)
        reg.add("reset", peer="127.0.0.1:81*", times=2)
        seq = []
        for k in range(40):
            netloc = "127.0.0.1:9101" if k % 2 else "127.0.0.1:8100"
            try:
                got = reg.network_fault(netloc, "/index/i/query", 1.0)
                seq.append(None if got is None else got[0])
            except ConnectionResetError:
                seq.append("reset")
        out[name] = (seq, fired)
    assert out["torch"] == out["jax"]
    assert "reset" in out["torch"][0] and 502 in out["torch"][0]


def test_disk_write_fault_reaches_the_fragment_files(tmp_path):
    from pilosa_tpu_torch.core.fragment import Fragment

    frag = Fragment("i", "f", "standard", 0, SHARD_WIDTH // 32, device="cpu")
    store = tff.FragmentFile(frag, str(tmp_path / "0"))
    store.open()
    frag.set_bit(1, 2)
    reg = tfaults.install(tfaults.FaultRegistry())
    try:
        rule = reg.add("disk_write_fail", path="*/0", times=1)
        with pytest.raises(OSError, match="fault-injected"):
            frag.set_bit(1, 3)
        frag.set_bit(1, 4)  # the rule fired its one time
        assert rule.hits == 1
        reg.add("crash", stage="target:*")
        with pytest.raises(tfaults.CrashError):
            tfaults.stage_fault("target:apply")
        tfaults.stage_fault("source:chunk")
    finally:
        tfaults.uninstall(reg)
        store.close()
    assert tfaults.active() is None
    tfaults.disk_write_fault(str(tmp_path / "0"))  # no registry: a no-op


def test_slow_fault_times_out_like_jax():
    for mod in (jfaults, tfaults):
        reg = mod.FaultRegistry()
        reg.add("slow", delay=5.0)
        with pytest.raises(TimeoutError):
            reg.network_fault("h:1", "/x", 0.0)


def test_circuit_breaker_walks_its_states():
    from pilosa_tpu_torch.obs.events import EventJournal

    journal = EventJournal()
    br = tclient.CircuitBreaker("h:1", threshold=2, cooldown=0.0, journal=journal)
    assert br.allow() and br.state == tclient.BREAKER_CLOSED
    br.record_failure()
    assert br.state == tclient.BREAKER_CLOSED
    br.record_failure()
    assert br.state == tclient.BREAKER_OPEN
    assert br.allow() and br.state == tclient.BREAKER_HALF_OPEN  # cooldown 0
    assert not br.allow()  # one probe at a time
    br.record_success()
    assert br.state == tclient.BREAKER_CLOSED
    kinds = [e["data"]["to"] for e in journal.since(0)["events"]]
    assert kinds == ["open", "half-open", "closed"]
