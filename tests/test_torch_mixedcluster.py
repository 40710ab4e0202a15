"""One JAX node and one port node form one cluster, on the CPU.

A JAX ``NodeServer`` and a port ``NodeServer`` (``device="cpu"``) are
joined by ``join_static``, once with the JAX node as the coordinator (and
so the translation primary) and once with the port node. Each package's
placement registry holds only its own holders, so every leg between the
two nodes is HTTP: JSON queries with wire results, the binary ``PTI1``
import, roaring imports to every replica, schema and shard broadcasts,
and key translation through the primary. Queries through either node
must answer as a two-node JAX cluster fed the same requests does.
"""

import gc

import numpy as np
import pytest

from pilosa_tpu.server.node import NodeServer as JaxNode
from pilosa_tpu.storage import roaring as jax_roaring
from pilosa_tpu.testing.cluster import InProcessCluster as JaxCluster
from pilosa_tpu_torch.server.node import NodeServer as TorchNode
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

SEED = 2215
N_SHARDS = 6
CLIENT_TIMEOUT = 5.0
# the samplers off: they change no answer, and their threads would only
# load the other test workers
QUIET = {"flight_recorder": False, "history_enabled": False}


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


class _Pair:
    """Two started nodes joined into one cluster; ``nodes[0]`` is the
    coordinator."""

    def __init__(self, nodes):
        self.nodes = nodes
        for n in nodes:
            n.client.timeout = CLIENT_TIMEOUT
        members = sorted((n.node_id, n.uri) for n in nodes)
        for n in nodes:
            n.join_static(members, nodes[0].node_id)

    def close(self):
        for n in self.nodes:
            n.stop()


def _mixed(coordinator):
    j = JaxNode(replica_n=2, port=0, **QUIET)
    t = TorchNode(replica_n=2, port=0, device="cpu", **QUIET)
    for n in (j, t):
        n.start()
    return _Pair([j, t] if coordinator == "jax" else [t, j])


def _feed(nodes):
    """The same requests, through alternating nodes: schema through the
    second node, imports routed through each, keyed writes through the
    node that is not the primary."""
    rng = np.random.default_rng(SEED)
    a, b = nodes[0].api, nodes[1].api
    b.create_index("i")
    b.create_field("i", "f")
    a.create_field("i", "g")
    b.create_field("i", "v", {"type": "int", "min": -10, "max": 500})
    cols = rng.integers(0, N_SHARDS * SHARD_WIDTH, 4000).astype(np.uint64)
    rows = rng.integers(0, 6, 4000).astype(np.uint64)
    a.import_bits("i", "f", {"rowIDs": rows[:2000], "columnIDs": cols[:2000]})
    b.import_bits("i", "f", {"rowIDs": rows[2000:], "columnIDs": cols[2000:]})
    gcols = rng.integers(0, N_SHARDS * SHARD_WIDTH, 800).astype(np.uint64)
    b.import_bits("i", "g", {"rowIDs": (gcols % 3).astype(np.uint64), "columnIDs": gcols})
    vcols = np.unique(rng.integers(0, N_SHARDS * SHARD_WIDTH, 300)).astype(np.uint64)
    a.import_bits("i", "v", {"columnIDs": vcols,
                             "values": rng.integers(-10, 500, len(vcols))})
    # a roaring import through the second node reaches both replicas
    pos = np.unique(rng.integers(0, 4 * SHARD_WIDTH, 300)).astype(np.uint64)
    b.import_roaring("i", "g", 2, jax_roaring.serialize(pos))
    a.create_index("k", {"keys": True})
    b.create_field("k", "kf", {"keys": True})
    b.query("k", 'Set("ann", kf="x") Set("bo", kf="x") Set("cy", kf="y")')
    a.query("k", 'Set("dee", kf="y")')
    b.import_bits("k", "kf", {"rowKeys": ["z", "x"], "columnKeys": ["eve", "ann"]})


QUERIES = [
    ("i", "Count(Row(f=1))"),
    ("i", "Count(Intersect(Row(f=1), Row(g=2)))"),
    ("i", "Count(Not(Row(f=3)))"),
    ("i", "Row(g=1)"),
    ("i", "TopN(f, n=3)"),
    ("i", "TopN(f, Row(g=0), n=2)"),
    ("i", "Rows(f)"),
    ("i", "GroupBy(Rows(f), Rows(g))"),
    ("i", "Sum(field=v) Max(field=v) Count(Row(v > 200))"),
    ("i", "Set(77, f=5) Clear(3, f=5) Count(Row(f=5))"),
    ("k", "TopN(kf)"),
    ("k", 'Count(Row(kf="x")) Count(Row(kf="y")) Count(Row(kf="z"))'),
    ("k", "Rows(kf)"),
]


@pytest.fixture(scope="module", params=["jax", "torch"])
def clusters(request):
    mixed = _mixed(request.param)
    ref = JaxCluster(2, replica_n=2, **QUIET)
    for n in ref.nodes:
        n.client.timeout = CLIENT_TIMEOUT
    try:
        _feed(mixed.nodes)
        _feed(ref.nodes)
        yield request.param, mixed, ref
    finally:
        mixed.close()
        ref.close()


@pytest.mark.parametrize("q", range(len(QUERIES)))
def test_mixed_cluster_answers_as_jax(clusters, q):
    _, mixed, ref = clusters
    index, pql = QUERIES[q]
    for k in range(2):
        got = mixed.nodes[k].api.query(index, pql)
        want = ref.nodes[k].api.query(index, pql)
        assert got == want, (k, pql)


def test_every_cross_package_leg_was_http(clusters):
    coord, mixed, _ = clusters
    torch_node = next(n for n in mixed.nodes if isinstance(n, TorchNode))
    torch_node.api.query("i", "Count(Row(f=2)) TopN(f, n=2)")
    snap = torch_node.api.dist.snapshot()
    assert snap["meshFallbacks"] == 0
    # the port's registry holds its own node only: the mesh route never
    # reaches past it, and the JAX node's shards go over HTTP
    assert list(snap["placement"]) == [torch_node.node_id]
    assert all(p["meshNodes"] <= 1 for p in snap["recentPartitions"])
    assert any(p["httpNodes"] for p in snap["recentPartitions"])


def test_schema_shards_and_keys_agree_across_packages(clusters):
    coord, mixed, _ = clusters
    j = next(n for n in mixed.nodes if isinstance(n, JaxNode))
    t = next(n for n in mixed.nodes if isinstance(n, TorchNode))
    assert t.api.schema() == j.api.schema()
    assert t.api.available_shards_map() == j.api.available_shards_map()
    assert t.api.available_shards_map()["i"]["f"] == list(range(N_SHARDS))
    # replica_n=2 on two nodes: each holds every shard it was sent
    for s in range(N_SHARDS):
        for n in (j, t):
            assert n.holder.fragment("i", "f", "standard", s) is not None
    assert t.api.translate_keys("k", "kf", ["x", "y", "z"]) == j.api.translate_keys(
        "k", "kf", ["x", "y", "z"])
    assert t.api.translate_keys("k", "", ["ann", "eve"]) == j.api.translate_keys(
        "k", "", ["ann", "eve"])
    status = t.api.status()
    assert status["coordinator"] == mixed.nodes[0].node_id
    assert {n["id"] for n in status["nodes"]} == {j.node_id, t.node_id}


def test_cluster_events_merge_both_packages(clusters):
    _, mixed, _ = clusters
    for n in mixed.nodes:
        merged = n.api.cluster_events(0)
        assert merged["nodes"] == 2 and merged["unreachable"] == []
        assert {e["node"] for e in merged["events"]} == {m.node_id for m in mixed.nodes}
