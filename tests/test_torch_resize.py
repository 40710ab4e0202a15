"""The port's elastic cluster against the JAX package's, on the CPU: block
checksums, anti-entropy, and the online resize with its migration
sessions, journal, data-loss journal and watchdog (the counterparts of
``tests/test_antientropy_resize.py``).

A port ``InProcessCluster`` (``device="cpu"``) and a JAX one take the same
seeded numpy data and the same steps (``add_node``, ``remove_node``,
``sync_all``, faults through ``testing/faults.stage_fault``). After each
step every answer must equal JAX's and a numpy truth, every node must hold
exactly the fragments its placement gives it, the replicas of a fragment
must be equal word for word, and each fragment must hold the same words in
both packages. Node ids are random in both packages, so the two clusters
place shards differently; the comparison is by fragment, not by node.

Writes made while a resize runs race it differently in each package, so
those cases are held to an independent truth: the writes each cluster
acknowledged. Every wait is bounded by the client's timeout; the samplers
are off (they change no answer). The module freezes what came before it
and collects after each test, as the other parity files do.
"""

# the port's lock witness, installed before the port is imported so that its
# module-level locks are wrapped too (pilosa_tpu_torch/testing/lockwitness.py)
from pilosa_tpu_torch.testing import lockwitness as port_lockwitness

port_lockwitness.install()
# the module fixture that asserts no new inversion among the port's locks
from pilosa_tpu_torch.testing.lockwitness import no_new_inversion  # noqa: F401

import gc
import json
import os
import threading
import time

import numpy as np
import pytest

from pilosa_tpu.core.fragment import Fragment as JaxFragment
from pilosa_tpu.testing.cluster import InProcessCluster as JaxCluster
from pilosa_tpu_torch.cluster import broadcast as bc
from pilosa_tpu_torch.cluster import resize as rz
from pilosa_tpu_torch.cluster.client import InternalClient
from pilosa_tpu_torch.cluster.resize import ResizeError
from pilosa_tpu_torch.core.fragment import HASH_BLOCK_SIZE
from pilosa_tpu_torch.core.fragment import Fragment as TorchFragment
from pilosa_tpu_torch.server.api import ApiError
from pilosa_tpu_torch.server.node import ResizeWatchdog
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
from pilosa_tpu_torch.testing import faults as tfaults
from pilosa_tpu_torch.testing.cluster import InProcessCluster as TorchCluster

KNOBS = {"flight_recorder": False, "history_enabled": False}
CLIENT_TIMEOUT = 5.0
READS = [
    "Count(Row(f=1))",
    "Count(Intersect(Row(f=0), Row(f=3)))",
    "Row(f=2)",
    "TopN(f, n=3)",
    "GroupBy(Rows(f))",
    "Sum(field=v)",
    "Count(Row(v > 100))",
]


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


def _cluster(pkg: str, n: int, **kw):
    if pkg == "torch":
        cl = TorchCluster(n, device="cpu", **KNOBS, **kw)
    else:
        cl = JaxCluster(n, **KNOBS, **kw)
    for node in cl.nodes:
        node.client.timeout = CLIENT_TIMEOUT
    return cl


def _both(n: int, **kw):
    return {pkg: _cluster(pkg, n, **kw) for pkg in ("jax", "torch")}


def _close(cls: dict) -> None:
    for cl in cls.values():
        cl.close()


def _data(seed: int, n_shards: int):
    rng = np.random.default_rng(seed)
    n = 2500
    cols = rng.integers(0, n_shards * SHARD_WIDTH, n).astype(np.uint64)
    rows = rng.integers(0, 5, n).astype(np.uint64)
    vcols = np.unique(rng.integers(0, n_shards * SHARD_WIDTH, 300)).astype(np.uint64)
    vals = rng.integers(0, 1000, len(vcols)).astype(np.int64)
    return cols, rows, vcols, vals


def _load(cl, seed: int, n_shards: int) -> None:
    cols, rows, vcols, vals = _data(seed, n_shards)
    cl.create_index("i")
    cl.create_field("i", "f")
    cl.create_field("i", "v", {"type": "int", "min": 0, "max": 1000})
    api = cl.nodes[0].api
    api.import_bits("i", "f", {"rowIDs": rows.tolist(), "columnIDs": cols.tolist()})
    api.import_bits("i", "v", {"columnIDs": vcols.tolist(), "values": vals.tolist()})


def _truth(seed: int, n_shards: int) -> dict:
    cols, rows, vcols, vals = _data(seed, n_shards)
    f = {r: set(cols[rows == r].tolist()) for r in range(5)}
    return {
        "Count(Row(f=1))": len(f[1]),
        "Count(Intersect(Row(f=0), Row(f=3)))": len(f[0] & f[3]),
        "Sum(field=v)": {"value": int(vals.sum()), "count": len(vals)},
        "Count(Row(v > 100))": int((vals > 100).sum()),
    }


def _check_reads(cls: dict, seed: int, n_shards: int) -> None:
    """Every node of the port answers as JAX's node 0 and the truth."""
    truth = _truth(seed, n_shards)
    for q in READS:
        want = cls["jax"].query(0, "i", q)
        if q in truth:
            assert want["results"] == [truth[q]], q
        for i in range(len(cls["torch"].nodes)):
            assert cls["torch"].query(i, "i", q) == want, (i, q)


def _fragments(cl, index: str = "i") -> dict:
    """(field, view, shard) -> {row: words} with zero rows dropped; the
    replicas of each fragment must hold equal words."""
    out: dict = {}
    for node in cl.nodes:
        idx = node.holder.index(index)
        if idx is None:
            continue
        for fname in idx.field_names(include_internal=True):
            field = idx.field(fname)
            for vname in field.view_names():
                for shard, frag in field.view(vname).fragments.items():
                    rows = frag.to_host_rows()
                    key = (fname, vname, int(shard))
                    if key in out:
                        assert _rows_equal(out[key], rows), (key, node.node_id)
                    else:
                        out[key] = rows
    return out


def _bits(frag) -> int:
    return sum(int(np.bitwise_count(w).sum()) for w in frag.to_host_rows().values())


def _rows_equal(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(np.array_equal(a[r], b[r]) for r in a)


def _check_fragments(cls: dict, index: str = "i") -> None:
    j, t = _fragments(cls["jax"], index), _fragments(cls["torch"], index)
    assert set(j) == set(t)
    for key in j:
        assert _rows_equal(j[key], t[key]), key


def _held(node, index: str, field: str, view: str = "standard") -> set:
    f = node.holder.field(index, field)
    if f is None or f.view(view) is None:
        return set()
    return set(f.view(view).fragments)


def _check_placement(cl, index: str, field: str, n_shards: int) -> None:
    for node in cl.nodes:
        owned = {s for s in range(n_shards) if node.cluster.owns_shard(node.node_id, index, s)}
        assert _held(node, index, field) == owned, node.node_id


def _event_types(node) -> list:
    return [e["type"] for e in node.holder.events.since(0)["events"]]


# -- block checksums -----------------------------------------------------------


@pytest.mark.parametrize("seed,n_rows,density", [(1, 3, 0.01), (2, 140, 0.05), (3, 260, 0.3)])
def test_block_checksums_and_data_equal_jax(seed, n_rows, density):
    rng = np.random.default_rng(seed)
    n_words = 64
    frags = [JaxFragment("i", "f", "standard", 0, n_words=n_words),
             TorchFragment("i", "f", "standard", 0, n_words=n_words, device="cpu")]
    rows = rng.choice(3 * HASH_BLOCK_SIZE, n_rows, replace=False)
    for r in rows:
        cols = np.flatnonzero(rng.random(n_words * 32) < density)
        for frag in frags:
            frag.import_bits(np.full(len(cols), r, dtype=np.uint64), cols.astype(np.int64))
    # a cleared row stays in the slot map with no bits: no block of its own
    for frag in frags:
        frag.set_bit(2 * HASH_BLOCK_SIZE + 99, 1)
        frag.clear_bit(2 * HASH_BLOCK_SIZE + 99, 1)
    jb, tb = frags[0].blocks(), frags[1].blocks()
    assert tb == jb and tb
    for b in jb:
        jr, jc = frags[0].block_data(b["id"])
        tr, tc = frags[1].block_data(b["id"])
        assert tr.tolist() == list(jr) and tc.tolist() == list(jc)
    before = tb[0]["checksum"]
    frags[1].set_bit(int(rows.min()), n_words * 32 - 1)
    assert frags[1].blocks()[0]["checksum"] != before


def test_block_data_travels_as_packed_binary():
    cl = _cluster("torch", 1)
    try:
        node = cl.nodes[0]
        cl.create_index("bw")
        cl.create_field("bw", "f")
        rng = np.random.default_rng(2)
        bits = [(r, int(c)) for r in range(40) for c in rng.integers(0, 3000, size=250)]
        cl.import_bits("bw", "f", bits)
        shard = sorted(_held(node, "bw", "f"))[0]
        frag = node.holder.fragment("bw", "f", "standard", shard)
        client = InternalClient()
        binary = client.block_data(node.uri, "bw", "f", "standard", shard, 0, width=frag.shard_width)
        legacy = client.block_data(node.uri, "bw", "f", "standard", shard, 0)
        assert binary["rows"].tolist() == legacy["rows"]
        assert binary["cols"].tolist() == legacy["cols"]
        assert len(legacy["rows"]) > 5000
        packed = node.api.fragment_block_data_binary(
            {"index": "bw", "field": "f", "shard": shard, "block": 0}
        )
        assert packed is not None and len(packed) * 3 < len(json.dumps(legacy).encode())
    finally:
        cl.close()


# -- anti-entropy --------------------------------------------------------------


@pytest.mark.parametrize("seed", [11, 12])
def test_antientropy_repairs_diverged_replicas(seed):
    cls = _both(2, replica_n=2)
    try:
        rng = np.random.default_rng(seed)
        diverge_set = [(int(r), int(c)) for r, c in zip(rng.integers(5, 9, 40), rng.integers(0, 4000, 40))]
        stats = {}
        for pkg, cl in cls.items():
            _load(cl, seed, 4)
            frag0 = cl.nodes[0].holder.fragment("i", "f", "standard", 0)
            frag1 = cl.nodes[1].holder.fragment("i", "f", "standard", 0)
            # bypass replication: bits set on node 0, and bits cleared on
            # node 1, as writes one replica lost
            for r, c in diverge_set:
                frag0.set_bit(r, c)
            cleared = [(r, c) for r in range(5) for c in range(2000) if frag1.get_bit(r, c)][:30]
            for r, c in cleared:
                frag1.clear_bit(r, c)
            assert _bits(frag0) != _bits(frag1)
            stats[pkg] = cl.sync_all()
            assert stats[pkg]["bits_set"] >= 1, pkg
            again = cl.sync_all()
            assert again["bits_set"] == 0 and again["bits_cleared"] == 0, pkg
        assert stats["torch"] == stats["jax"]
        _check_fragments(cls)
        _check_reads(cls, seed, 4)
    finally:
        _close(cls)


def test_antientropy_creates_missing_replica_fragment():
    cls = _both(2, replica_n=2)
    try:
        for cl in cls.values():
            cl.create_index("i")
            cl.create_field("i", "f")
            f0 = cl.nodes[0].holder.field("i", "f")
            f0.create_view_if_not_exists("standard").create_fragment_if_not_exists(3).set_bit(0, 42)
            assert cl.nodes[1].holder.fragment("i", "f", "standard", 3) is None
            cl.nodes[0].syncer().sync_holder()
            rep = cl.nodes[1].holder.fragment("i", "f", "standard", 3)
            assert rep is not None and rep.get_bit(0, 42)
        _check_fragments(cls)
    finally:
        _close(cls)


def test_antientropy_schema_sync_heals_missed_broadcast():
    cl = _cluster("torch", 2, replica_n=1)
    try:
        cl.nodes[0].api._create_index("lost", broadcast=False)
        cl.nodes[0].api._create_field("lost", "f", broadcast=False)
        assert cl.nodes[1].holder.index("lost") is None
        cl.nodes[1].syncer().sync_holder()
        assert cl.nodes[1].holder.field("lost", "f") is not None
    finally:
        cl.close()


def test_antientropy_survives_unencodable_row_ids():
    cls = _both(2, replica_n=2)
    try:
        for pkg, cl in cls.items():
            cl.create_index("i")
            cl.create_field("i", "f")
            cl.import_bits("i", "f", [(1, 10), (2, 20)])
            frag0 = cl.nodes[0].holder.fragment("i", "f", "standard", 0)
            frag0.set_bit(2**63, 3)  # beyond the position wire format
            frag0.set_bit(9, 123)  # an encodable divergence in the same pass
            stats = cl.sync_all()
            assert stats["bits_set"] >= 1, pkg
            assert cl.nodes[1].holder.fragment("i", "f", "standard", 0).get_bit(9, 123)
            # node 1's own pass pulls the large row as JSON and sets it
            assert cl.nodes[1].holder.fragment("i", "f", "standard", 0).get_bit(2**63, 3), pkg
    finally:
        _close(cls)


def test_attr_anti_entropy_converges():
    cl = _cluster("torch", 3, replica_n=2)
    try:
        cl.create_index("ai")
        cl.create_field("ai", "af")
        n0 = cl.nodes[0]
        n0.holder.index("ai").field("af").row_attrs.set_attrs(7, {"name": "seven", "rank": 1})
        n0.holder.index("ai").column_attrs.set_attrs(123, {"tag": "x"})
        stats = cl.sync_all()
        assert stats["attrs_merged"] >= 2
        for n in cl.nodes:
            assert n.holder.index("ai").field("af").row_attrs.attrs(7) == {"name": "seven", "rank": 1}
            assert n.holder.index("ai").column_attrs.attrs(123) == {"tag": "x"}
    finally:
        cl.close()


def test_antientropy_repair_reaches_the_stacks_and_the_result_cache():
    """A repaired bit is read by the next query on both routes: the repair
    went through the fragment's mutators and invalidated the result
    cache, so neither a cached stack nor a cached partial hides it."""
    cl = _cluster("torch", 2, replica_n=2)
    try:
        _load(cl, 5, 4)
        q = "Count(Row(f=4))"
        base = cl.query(0, "i", q)["results"][0]
        for node in cl.nodes:
            node.api.query("i", q)  # warm the stacks and the cache
        frag1 = cl.nodes[1].holder.fragment("i", "f", "standard", 1)
        lost = next(c for c in range(SHARD_WIDTH) if not frag1.get_bit(4, c))
        frag1.set_bit(4, lost)  # on one replica only
        cl.sync_all()
        for i in range(2):
            assert cl.query(i, "i", q)["results"] == [base + 1], i
            frag = cl.nodes[i].holder.fragment("i", "f", "standard", 1)
            assert frag.get_bit(4, lost)
    finally:
        cl.close()


# -- resize --------------------------------------------------------------------


@pytest.mark.parametrize("seed,n_shards", [(21, 12), (22, 7)])
def test_resize_add_node_moves_fragments_and_preserves_data(seed, n_shards):
    cls = _both(2, replica_n=1)
    try:
        for cl in cls.values():
            _load(cl, seed, n_shards)
        _check_reads(cls, seed, n_shards)
        for pkg, cl in cls.items():
            cl.add_node()
            for n in cl.nodes:
                assert len(n.cluster.nodes) == 3 and n.cluster.state == "NORMAL", pkg
            _check_placement(cl, "i", "f", n_shards)
        _check_fragments(cls)
        _check_reads(cls, seed, n_shards)
    finally:
        _close(cls)


@pytest.mark.parametrize("replica_n", [1, 2])
def test_resize_remove_node_preserves_data(replica_n):
    seed, n_shards = 31, 10
    cls = _both(3, replica_n=replica_n)
    try:
        for pkg, cl in cls.items():
            _load(cl, seed, n_shards)
            victim = next(i for i, n in enumerate(cl.nodes) if n.node_id != cl.coordinator_id)
            cl.remove_node(victim)
            for n in cl.nodes:
                assert len(n.cluster.nodes) == 2 and n.cluster.state == "NORMAL", pkg
            _check_placement(cl, "i", "f", n_shards)
        _check_fragments(cls)
        _check_reads(cls, seed, n_shards)
    finally:
        _close(cls)


def test_resize_transfers_bsi_bit_depth():
    cls = _both(2, replica_n=1)
    try:
        vals = {s * SHARD_WIDTH + 3: 1000 + s * 77 for s in range(8)}
        for cl in cls.values():
            cl.create_index("bz")
            cl.create_field("bz", "v", {"type": "int", "min": 0, "max": 100000})
            for col, val in vals.items():
                cl.query(0, "bz", f"Set({col}, v={val})")
            cl.add_node()
        want = {"value": sum(vals.values()), "count": len(vals)}
        for i in range(3):
            assert cls["torch"].query(i, "bz", "Sum(field=v)")["results"] == [want]
            assert cls["jax"].query(i, "bz", "Sum(field=v)")["results"] == [want]
        _check_fragments(cls, "bz")
    finally:
        _close(cls)


def test_resize_with_disk_persistence():
    cl = _cluster("torch", 2, replica_n=1, with_disk=True)
    try:
        cl.create_index("dz")
        cl.create_field("dz", "f")
        cl.import_bits("dz", "f", [(0, s * SHARD_WIDTH) for s in range(8)])
        cl.add_node()
        for i in range(3):
            assert cl.query(i, "dz", "Count(Row(f=0))")["results"] == [8]
        for i, n in enumerate(cl.nodes):
            frag_dir = f"{cl._tmp.name}/node{i}/dz/f/views/standard/fragments"
            on_disk = {int(f) for f in os.listdir(frag_dir)} if os.path.isdir(frag_dir) else set()
            assert on_disk == _held(n, "dz", "f"), i
    finally:
        cl.close()


def test_resize_then_write_then_query():
    cls = _both(2, replica_n=1)
    try:
        for cl in cls.values():
            cl.create_index("rw")
            cl.create_field("rw", "f")
            cl.import_bits("rw", "f", [(1, s * SHARD_WIDTH) for s in range(6)])
            cl.add_node()
            cl.query(0, "rw", f"Set({6 * SHARD_WIDTH + 2}, f=1)")
        for i in range(3):
            assert cls["torch"].query(i, "rw", "Count(Row(f=1))") == cls["jax"].query(0, "rw", "Count(Row(f=1))")
        assert cls["torch"].query(1, "rw", "Count(Row(f=1))")["results"] == [7]
        _check_fragments(cls, "rw")
    finally:
        _close(cls)


def test_resize_stays_online_under_concurrent_writes():
    """Held to the writes the port acknowledged: the cluster never leaves
    NORMAL, every acknowledged write reads back from both of its replicas
    before any anti-entropy (which then finds nothing to repair), and the
    coordinator's journal shows the per-fragment timeline."""
    cl = _cluster("torch", 2, replica_n=2)
    try:
        cl.create_index("on")
        cl.create_field("on", "f")
        n_shards = 8
        base = [(0, s * SHARD_WIDTH + s) for s in range(n_shards)]
        cl.import_bits("on", "f", base)
        accepted: list[int] = []
        errors: list[Exception] = []
        stop = threading.Event()

        def writer():
            k = 0
            while not stop.is_set():
                col = (k % n_shards) * SHARD_WIDTH + 1000 + k
                try:
                    cl.query(0, "on", f"Set({col}, f=0)")
                    accepted.append(col)
                except Exception as e:  # graftlint: disable=exception-hygiene -- collected and asserted empty below
                    errors.append(e)
                k += 1

        t = threading.Thread(target=writer, daemon=True)
        t.start()
        try:
            new = cl.add_node()
        finally:
            stop.set()
            t.join(timeout=10)
        assert not errors, errors[:3]
        assert accepted
        for n in cl.nodes:
            assert n.cluster.state == "NORMAL"
            assert "cluster-state" not in _event_types(n), n.node_id
        # before any anti-entropy: the migration alone carried every write
        for col in accepted:
            shard = col // SHARD_WIDTH
            holders = [n for n in cl.nodes if n.cluster.owns_shard(n.node_id, "on", shard)]
            assert len(holders) == 2
            for n in holders:
                assert n.holder.fragment("on", "f", "standard", shard).get_bit(0, col % SHARD_WIDTH)
        want = len({c for _, c in base} | set(accepted))
        for i in range(3):
            assert cl.query(i, "on", "Count(Row(f=0))")["results"] == [want], i
        stats = cl.sync_all()
        assert stats["bits_set"] == 0 and stats["bits_cleared"] == 0, stats
        types = _event_types(cl.coordinator)
        for t_ in ("resize-start", "migrate-fragment", "epoch-flip", "resize-commit"):
            assert t_ in types, t_
        assert _held(new, "on", "f")
    finally:
        cl.close()


@pytest.mark.parametrize("write", ["Set", "import"])
def test_a_write_planned_before_a_flip_and_applied_after_the_finalize_reaches_the_new_owner(
        write):
    """Held to the writes the port acknowledged: a write whose node planned
    it on a shard's old owner, and whose leg reached that owner only after
    the new owner's finalize had closed the migration session (so no delta
    carries it), is on the new owner when the resize commits, before any
    anti-entropy. The node that planned it takes the flip before the
    finalize, and writes to the owners the shard gained meanwhile."""
    from pilosa_tpu_torch.cluster import dist as dmod
    from pilosa_tpu_torch.server import api as amod

    cl = _cluster("torch", 2, replica_n=1)
    try:
        cl.create_index("rw")
        cl.create_field("rw", "f")
        n_shards = 8
        cl.import_bits("rw", "f", [(0, s * SHARD_WIDTH) for s in range(n_shards)])
        col_of: dict[int, int] = {}
        planned, finalized = threading.Event(), threading.Event()
        errors: list[str] = []
        threads: list[threading.Thread] = []
        real_flip = rz.ResizeCoordinator._broadcast_flip
        real_submit = dmod.DistributedExecutor._submit_writes
        real_import = amod.API.import_bits
        real_finalize = amod.API.migrate_finalize

        def held(marked):
            if marked:
                planned.set()
                assert finalized.wait(CLIENT_TIMEOUT)

        def submit(self, index_name, call, by_node):
            held(index_name == "rw" and f"{col_of.get('col')}" in str(call))
            return real_submit(self, index_name, call, by_node)

        def import_bits(self, index, field, req):
            # an owner's leg, local or remote
            held(index == "rw" and bool(req.get("remote"))
                 and col_of.get("col") in [int(c) for c in req["columnIDs"]])
            return real_import(self, index, field, req)

        def finalize(self, req):
            out = real_finalize(self, req)
            if any(ins.get("index") == "rw" and int(ins.get("shard", -1)) == col_of.get("shard")
                   for ins in req.get("instructions") or []):
                finalized.set()
            return out

        def flip(self, nodes, index, shard, epoch):
            if index == "rw" and not col_of:
                col = shard * SHARD_WIDTH + 77
                col_of.update(col=col, shard=shard)

                def go():
                    try:
                        if write == "Set":
                            cl.query(0, "rw", f"Set({col}, f=1)")
                        else:
                            cl.nodes[0].api.import_bits(
                                "rw", "f", {"rowIDs": [1], "columnIDs": [col]})
                    except Exception as e:  # graftlint: disable=exception-hygiene -- collected and asserted empty below
                        errors.append(repr(e))

                threads.append(threading.Thread(target=go, daemon=True))
                threads[0].start()
                assert planned.wait(CLIENT_TIMEOUT)  # planned on the old owner
            real_flip(self, nodes, index, shard, epoch)

        rz.ResizeCoordinator._broadcast_flip = flip
        dmod.DistributedExecutor._submit_writes = submit
        amod.API.import_bits = import_bits
        amod.API.migrate_finalize = finalize
        try:
            cl.add_node()
        finally:
            rz.ResizeCoordinator._broadcast_flip = real_flip
            dmod.DistributedExecutor._submit_writes = real_submit
            amod.API.import_bits = real_import
            amod.API.migrate_finalize = real_finalize
        threads[0].join(CLIENT_TIMEOUT)
        assert not errors and finalized.is_set(), errors
        col, shard = col_of["col"], col_of["shard"]
        owners = [n for n in cl.nodes if n.cluster.owns_shard(n.node_id, "rw", shard)]
        assert owners
        for n in owners:
            frag = n.holder.fragment("rw", "f", "standard", shard)
            assert frag is not None and frag.get_bit(1, col % SHARD_WIDTH), n.node_id
        for i in range(3):
            assert cl.query(i, "rw", "Count(Row(f=1))")["results"] == [1], i
    finally:
        cl.close()


def test_resize_source_crash_retries_and_completes():
    cls = _both(2, replica_n=1)
    try:
        for pkg, cl in cls.items():
            cl.create_index("sc")
            cl.create_field("sc", "f")
            cl.import_bits("sc", "f", [(0, s * SHARD_WIDTH) for s in range(8)])
            fault = cl.inject_fault("crash", stage="source:begin", times=1)
            cl.add_node()
            assert fault.hits == 1, pkg
            for i in range(3):
                assert cl.query(i, "sc", "Count(Row(f=0))")["results"] == [8], pkg
            stats = cl.sync_all()
            assert stats["bits_set"] == 0 and stats["bits_cleared"] == 0, pkg
        _check_fragments(cls, "sc")
    finally:
        _close(cls)


def test_resize_resume_after_coordinator_crash():
    cl = _cluster("torch", 3, replica_n=1, with_disk=True)
    try:
        cl.create_index("cr")
        cl.create_field("cr", "f")
        n_shards = 10
        cl.import_bits("cr", "f", [(3, s * SHARD_WIDTH) for s in range(n_shards)])
        victim = next(n for n in cl.nodes if n.node_id != cl.coordinator_id)
        cl.inject_fault("crash", stage="coordinator:flip", times=1)
        with pytest.raises(tfaults.CrashError):
            cl.coordinator.resize_coordinator().remove_node(victim.node_id)
        journal_path = os.path.join(cl.coordinator.store.path, "resize.json")
        assert os.path.exists(journal_path)
        for i in range(3):
            assert cl.query(i, "cr", "Count(Row(f=3))")["results"] == [n_shards], i
        assert cl.coordinator.api.resize_resume()["resumed"] is True
        assert not os.path.exists(journal_path)
        survivors = [n for n in cl.nodes if n is not victim]
        for n in survivors:
            assert len(n.cluster.nodes) == 2 and n.cluster.state == "NORMAL"
            assert not n.cluster.resize_pending
        for i, n in enumerate(cl.nodes):
            if n is not victim:
                assert cl.query(i, "cr", "Count(Row(f=3))")["results"] == [n_shards]
        types = _event_types(cl.coordinator)
        assert "resize-resume" in types and "resize-commit" in types
    finally:
        cl.close()


def test_resize_resume_without_journal_is_an_error():
    cl = _cluster("torch", 2, replica_n=1)
    try:
        with pytest.raises(ApiError, match="no interrupted resize"):
            cl.coordinator.api.resize_resume()
    finally:
        cl.close()


def test_resize_abort_recommits_the_membership():
    cl = _cluster("torch", 2, replica_n=1)
    try:
        follower = next(n for n in cl.nodes if n.node_id != cl.coordinator_id)
        msg = {
            "type": bc.MSG_RESIZE_PREPARE, "epoch": follower.cluster.epoch + 1,
            "nodes": [{"id": n.id, "uri": n.uri} for n in follower.cluster.nodes],
        }
        for n in cl.nodes:
            n.api.receive_message(msg)
        assert all(n.cluster.resize_pending for n in cl.nodes)
        assert cl.coordinator.api.resize_abort() == {"aborted": True}
        for n in cl.nodes:
            assert not n.cluster.resize_pending and n.cluster.state == "NORMAL"
        with pytest.raises(ApiError, match="coordinator"):
            follower.api.resize_abort()
    finally:
        cl.close()


def test_resize_aborts_when_surviving_member_unreachable():
    cl = _cluster("torch", 3, replica_n=2)
    try:
        for n in cl.nodes:
            n.client.timeout = 2.0
        cl.create_index("ab")
        cl.create_field("ab", "f")
        cl.import_bits("ab", "f", [(1, s * SHARD_WIDTH) for s in range(6)])
        bystander = next(i for i, n in enumerate(cl.nodes) if n.node_id != cl.coordinator_id)
        cl.pause_node(bystander)
        try:
            with pytest.raises(ResizeError, match="surviving member"):
                cl.add_node()
        finally:
            cl.resume_node(bystander)
        for n in cl.nodes:
            assert len(n.cluster.nodes) == 3 and not n.cluster.resize_pending
        for i in range(3):
            assert cl.query(i, "ab", "Count(Row(f=1))")["results"] == [6]
    finally:
        cl.close()


def test_resize_dead_node_removal_journals_data_loss():
    """Held to an independent truth: the shards the dead node held alone
    are gone, and exactly those are journaled and counted."""
    cl = _cluster("torch", 3, replica_n=1)
    try:
        for n in cl.nodes:
            n.client.timeout = 2.0
        cl.create_index("dl")
        cl.create_field("dl", "f")
        n_shards = 12
        cl.import_bits("dl", "f", [(0, s * SHARD_WIDTH) for s in range(n_shards)])
        vi = next(i for i, n in enumerate(cl.nodes)
                  if n.node_id != cl.coordinator_id and _held(n, "dl", "f"))
        victim = cl.nodes[vi]
        lost = _held(victim, "dl", "f")
        n_lost = len(lost) + len(_held(victim, "dl", "_exists"))
        cl.pause_node(vi)
        victim.stop()
        cl.nodes.pop(vi)
        cl.coordinator.resize_coordinator().remove_node(victim.node_id)
        loss = [e for e in cl.coordinator.holder.events.since(0)["events"]
                if e["type"] == "resize-data-loss"]
        assert loss and loss[0]["data"]["count"] == n_lost
        assert loss[0]["data"]["node"] == victim.node_id
        counters = cl.coordinator.holder.stats.snapshot()["counters"]
        assert any(k.startswith("resize_data_loss_fragments") and v == n_lost
                   for k, v in counters.items()), counters
        for i in range(2):
            assert cl.query(i, "dl", "Count(Row(f=0))")["results"] == [n_shards - len(lost)]
    finally:
        cl.close()


def test_resize_watchdog_recovers_missed_commit():
    cl = _cluster("torch", 2, replica_n=1)
    try:
        follower = next(n for n in cl.nodes if n.node_id != cl.coordinator_id)
        assert follower.resize_watchdog is not None  # on by default
        assert follower.resize_watchdog.deadline == 15.0
        follower.api.receive_message({
            "type": bc.MSG_RESIZE_PREPARE,
            "epoch": follower.cluster.epoch + 1,
            "nodes": [{"id": n.id, "uri": n.uri} for n in follower.cluster.nodes]
            + [{"id": "zzz-ghost", "uri": "http://127.0.0.1:1"}],
        })
        assert follower.cluster.resize_pending
        wd = ResizeWatchdog(follower, deadline=0.01)
        wd._tick()  # arms the timer
        time.sleep(0.02)
        wd._tick()  # past the deadline: asks the coordinator and recovers
        assert not follower.cluster.resize_pending
        assert follower.cluster.state == "NORMAL"
        acts = [e["data"].get("action") for e in follower.holder.events.since(0)["events"]
                if e["type"] == "resize-watchdog"]
        assert "recovered" in acts, acts
    finally:
        cl.close()


def test_a_flip_releases_the_facades_stacks_and_reads_the_new_owners():
    """At each flip of a resize, node 0's mesh route releases the stacks of
    every facade it had (their owners changed) and the next read builds a
    new facade's stacks over the new owners, answering exactly."""
    cl = _cluster("torch", 3, replica_n=2)
    try:
        _load(cl, 51, 8)
        for node in cl.nodes:
            node.api.executor.rescache.max_entries = 0
        dist = cl.nodes[0].api.dist
        q = "TopN(f, Row(f=3), n=4)"
        want = cl.query(0, "i", q)
        assert sum(ex.stack_rebuilds for ex in dist._mesh_cache.values()) == 1
        counts = {"reads": 0, "released": 0}
        real_flip = rz.ResizeCoordinator._broadcast_flip

        def flip(self, nodes, index, shard, epoch):
            before = list(dist._mesh_cache.values())
            real_flip(self, nodes, index, shard, epoch)
            # every node, node 0 among them, took the flip
            assert not any(caches for ex in before for caches in ex._stacks.values())
            counts["released"] += len(before)
            assert cl.query(0, "i", q) == want  # read through the new owners
            now = list(dist._mesh_cache.values())
            assert now and not any(ex in before for ex in now)
            assert sum(ex.stack_rebuilds for ex in now) >= 1
            counts["reads"] += 1

        rz.ResizeCoordinator._broadcast_flip = flip
        # one shard group at a time, so that each flip finds the facade the
        # read after the flip before it built
        workers, rz.ResizeCoordinator._GROUP_WORKERS = rz.ResizeCoordinator._GROUP_WORKERS, 1
        try:
            cl.add_node()
        finally:
            rz.ResizeCoordinator._broadcast_flip = real_flip
            rz.ResizeCoordinator._GROUP_WORKERS = workers
        assert counts["reads"] >= 2 and counts["released"] >= counts["reads"], counts
        assert cl.query(0, "i", q) == want
    finally:
        cl.close()


# -- migration sessions --------------------------------------------------------


def test_migration_session_tap_covers_writes_after_the_cut():
    """A write that lands after the snapshot cut reaches the target through
    the delta, through the memory tap of a fragment with no store, and the
    replayed fragment equals the source's (and JAX's replay of the same)."""
    from pilosa_tpu_torch.cluster.migration import MemoryTapLog, MigrationRegistry
    from pilosa_tpu_torch.storage import roaring

    src = TorchFragment("i", "f", "standard", 0, n_words=64, device="cpu")
    src.import_bits(np.array([1, 1, 2], np.uint64), np.array([3, 900, 5]))
    reg = MigrationRegistry("n0")
    session = reg.begin(src, ("i", "f", "standard", 0))
    assert isinstance(src.store, MemoryTapLog)
    src.set_bit(7, 11)
    src.clear_bit(1, 900)
    src.import_bits(np.array([3, 3], np.uint64), np.array([1, 2000]))
    blob, count, pending = session.delta()
    assert count == 4 and pending == 0
    dst = TorchFragment("i", "f", "standard", 0, n_words=64, device="cpu")
    rows, words, _ = roaring.decode_rows(session.chunk(0, session.size), 64)
    dst.import_row_words(rows, words)
    for op, payload, _ in roaring.decode_ops(blob, 0):
        pos = np.atleast_1d(np.asarray(payload, dtype=np.uint64))
        dst.import_bits(pos // np.uint64(2048), (pos % np.uint64(2048)).astype(np.int64),
                        clear=op in (roaring.OP_REMOVE, roaring.OP_REMOVE_BATCH))
    assert _rows_equal(dst.to_host_rows(), src.to_host_rows())
    reg.end(session.token)
    assert src.store is None
    assert reg.snapshot_summary()["active"] == 0


@pytest.mark.parametrize("with_disk", [False, True])
def test_an_import_into_an_empty_fragment_under_migration_reaches_the_delta(with_disk):
    """A bulk import into an empty fragment loads it whole and logs no op;
    while a migration session streams that fragment, the import goes
    through the mutators instead, so the session's delta carries every bit
    of it, on a node with a data directory and on one without."""
    from pilosa_tpu_torch.storage import roaring

    cl = _cluster("torch", 1, replica_n=1, with_disk=with_disk)
    try:
        cl.create_index("em")
        cl.create_field("em", "f")
        api = cl.nodes[0].api
        frag = api.holder.field("em", "f").create_view_if_not_exists(
            "standard").create_fragment_if_not_exists(2)
        session = api.migrations.begin(frag, ("em", "f", "standard", 2))
        rows, _words, _ = roaring.decode_rows(session.chunk(0, session.size), frag.n_words)
        assert len(rows) == 0
        rng = np.random.default_rng(62)
        cols = np.unique(rng.integers(0, SHARD_WIDTH, 300)).astype(np.uint64)
        pos = np.concatenate([np.uint64(r) * np.uint64(SHARD_WIDTH) + cols for r in (1, 4)])
        assert api.import_roaring("em", "f", 2, roaring.serialize(pos))["changed"] == len(pos)
        blob, count, pending = session.delta()
        assert count == len(pos) and pending == 0
        got = np.concatenate([
            np.atleast_1d(np.asarray(payload, dtype=np.uint64))
            for op, payload, _ in roaring.decode_ops(blob, 0)
            if op in (roaring.OP_ADD, roaring.OP_ADD_BATCH)
        ])
        assert np.array_equal(np.sort(got), np.sort(pos))
        api.migrations.end(session.token)
        # with no session the same import into an empty fragment loads it whole
        other = api.holder.field("em", "f").create_view_if_not_exists(
            "standard").create_fragment_if_not_exists(3)
        api.import_roaring("em", "f", 3, roaring.serialize(pos))
        assert _bits(other) == _bits(frag) == len(pos)
    finally:
        cl.close()


def test_resize_keeps_imports_into_empty_fragments_after_the_cut():
    """Held to the imports the port acknowledged: a roaring import into a
    fragment that was empty when its migration's snapshot was cut, made
    before its shard flips (it lands on the old owner) and after (on the
    new one), reads back from every owner once the resize commits."""
    from pilosa_tpu_torch.storage import roaring

    cl = _cluster("torch", 2, replica_n=1)
    try:
        n_shards = 8
        cl.create_index("em")
        cl.create_field("em", "f")
        for s in range(n_shards):
            # an empty fragment on the shard's owner, in the resize's inventory
            cl.query(0, "em", f"Set({s * SHARD_WIDTH + 5}, f=9)")
            cl.query(0, "em", f"Clear({s * SHARD_WIDTH + 5}, f=9)")
        rng = np.random.default_rng(63)
        acked: dict[int, set] = {}
        real_flip = rz.ResizeCoordinator._broadcast_flip

        def imp(shard, row):
            cols = np.unique(rng.integers(0, SHARD_WIDTH, 200)).astype(np.uint64)
            pos = np.uint64(row) * np.uint64(SHARD_WIDTH) + cols
            cl.nodes[0].api.import_roaring("em", "f", shard, roaring.serialize(pos))
            acked.setdefault(shard, set()).update(
                (row, int(c) + shard * SHARD_WIDTH) for c in cols)

        def flip(self, nodes, index, shard, epoch):
            if index == "em":
                imp(shard, 1)  # after the cut, before the flip: the old owner
            real_flip(self, nodes, index, shard, epoch)
            if index == "em":
                imp(shard, 2)  # after the flip, before the commit: the new owner

        rz.ResizeCoordinator._broadcast_flip = flip
        try:
            cl.add_node()
        finally:
            rz.ResizeCoordinator._broadcast_flip = real_flip
        assert acked, "no shard of em moved"
        for shard, bits in acked.items():
            owners = [n for n in cl.nodes if n.cluster.owns_shard(n.node_id, "em", shard)]
            assert owners
            for n in owners:
                frag = n.holder.fragment("em", "f", "standard", shard)
                assert frag is not None, (shard, n.node_id)
                got = {(r, int(c) + shard * SHARD_WIDTH) for r, w in frag.to_host_rows().items()
                       for c in np.flatnonzero(np.unpackbits(
                           w.view(np.uint8), bitorder="little"))}
                assert bits <= got, (shard, n.node_id, len(bits - got))
        _check_placement(cl, "em", "f", n_shards)
        want = len({b for bits in acked.values() for b in bits if b[0] == 1})
        for i in range(3):
            assert cl.query(i, "em", "Count(Row(f=1))")["results"] == [want], i
    finally:
        cl.close()


def test_chunk_prefetcher_resumes_where_it_failed():
    from pilosa_tpu_torch.ingest.pipeline import ChunkPrefetcher

    data = bytes(range(256)) * 40
    fails = {"left": 1}

    def fetch(off):
        if off >= 3000 and fails["left"]:
            fails["left"] -= 1
            raise OSError("source went away")
        return data[off:off + 1000]

    got = bytearray()
    pf = ChunkPrefetcher(fetch, size=len(data), chunk_bytes=1000)
    with pytest.raises(OSError):
        for _off, blob in pf:
            got += blob
    pf.close()
    assert pf.next_offset == 3000 == len(got)
    pf = ChunkPrefetcher(fetch, size=len(data), chunk_bytes=1000, start=pf.next_offset)
    for _off, blob in pf:
        got += blob
    pf.close()
    assert bytes(got) == data


def test_clean_unowned_fragments_leaves_the_budget():
    """The fragments a removed shard left behind leave through the
    residency manager: their budget bytes and the stacks over the old
    shard sets are released."""
    from pilosa_tpu_torch.core import membudget

    cl = _cluster("torch", 2, replica_n=1)
    try:
        _load(cl, 41, 8)
        budget = membudget.default_budget(cl.nodes[0].holder.device)
        for n in cl.nodes:
            n.api.query("i", "Count(Row(f=1)) TopN(f, Row(f=2), n=2)")
        for n in cl.nodes:
            for s in _held(n, "i", "f"):
                n.holder.fragment("i", "f", "standard", s).device_bits()
        used = budget.used()
        cl.add_node()
        assert budget.used() < used
        for n in cl.nodes:
            for s in _held(n, "i", "f"):
                frag = n.holder.fragment("i", "f", "standard", s)
                frag.device_bits()
                frag.check_invariants(device=True)
        _check_placement(cl, "i", "f", 8)
        assert cl.query(2, "i", "Count(Row(f=1))")["results"] == [_truth(41, 8)["Count(Row(f=1))"]]
    finally:
        cl.close()
