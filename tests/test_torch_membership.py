"""The port's membership monitor against the JAX package's, on the CPU (the
counterparts of ``tests/test_membership.py``): confirm-down retries, the
probe's transitions and the cluster state they drive, who broadcasts, the
round robin, and a real node stopped and started again under the monitor's
thread.

Each case runs the same steps against both packages' monitors over a
stubbed client and a stubbed broadcaster, and requires the same outcome.
The in-process cases use the port's cluster alone: a stopped node's peers
must mark it DOWN, reads must skip it by its state, and a node restarted
on its data directory must come back READY with its answers exact.
"""

# the port's lock witness, installed before the port is imported so that its
# module-level locks are wrapped too (pilosa_tpu_torch/testing/lockwitness.py)
from pilosa_tpu_torch.testing import lockwitness as port_lockwitness

port_lockwitness.install()
# the module fixture that asserts no new inversion among the port's locks
from pilosa_tpu_torch.testing.lockwitness import no_new_inversion  # noqa: F401

import time

import pytest

from pilosa_tpu.cluster import cluster as jcluster
from pilosa_tpu.cluster import membership as jmembership
from pilosa_tpu.cluster import topology as jtopology
from pilosa_tpu_torch.cluster import cluster as tcluster
from pilosa_tpu_torch.cluster import membership as tmembership
from pilosa_tpu_torch.cluster import topology as ttopology
from pilosa_tpu_torch.server.node import NodeServer
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
from pilosa_tpu_torch.testing.cluster import InProcessCluster

PKGS = {
    "jax": (jcluster, jmembership, jtopology),
    "torch": (tcluster, tmembership, ttopology),
}
KNOBS = {"flight_recorder": False, "history_enabled": False}


class StubClient:
    """Liveness controlled per uri; counts the version probes."""

    def __init__(self):
        self.alive: dict[str, bool] = {}
        self.probes: dict[str, int] = {}

    def version(self, uri):
        self.probes[uri] = self.probes.get(uri, 0) + 1
        if not self.alive.get(uri, True):
            raise ConnectionError("down")
        return {"version": "test"}


class StubBroadcaster:
    def __init__(self):
        self.sent = []

    def send_sync(self, msg):
        self.sent.append(msg)


def _cluster(pkg: str, replica_n: int = 2):
    cl_mod, _mon, topo = PKGS[pkg]
    c = cl_mod.Cluster("a", replica_n=replica_n, disabled=False)
    c.coordinator_id = "a"
    c.set_static([topo.Node(id=n, uri=f"http://{n}") for n in "abc"])
    return c


def _monitor(pkg: str, c, client, **kw):
    return PKGS[pkg][1].MembershipMonitor(c, client, **kw)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_confirm_down_requires_all_retries_failing(pkg):
    c = _cluster(pkg)
    client = StubClient()
    mon = _monitor(pkg, c, client, confirm_retries=5, confirm_interval=0.001)
    client.alive["http://b"] = False
    assert mon.confirm_node_down(c.node("b")) is True
    assert client.probes["http://b"] == 5

    calls = {"n": 0}

    class FlakyClient(StubClient):
        def version(self, uri):
            calls["n"] += 1
            if calls["n"] < 3:
                raise ConnectionError("slow start")
            return {}

    mon2 = _monitor(pkg, c, FlakyClient(), confirm_retries=10, confirm_interval=0.001)
    assert mon2.confirm_node_down(c.node("b")) is False
    assert calls["n"] == 3


def _transitions(pkg: str, replica_n: int, coordinator: str, down: str):
    """The states, events and broadcasts a probe drives, as plain data."""
    c = _cluster(pkg, replica_n)
    c.coordinator_id = coordinator
    for n in c.nodes:
        n.is_coordinator = n.id == coordinator
    client, bcast, events = StubClient(), StubBroadcaster(), []
    mon = _monitor(
        pkg, c, client, broadcaster=bcast, confirm_retries=2, confirm_interval=0.001,
        on_change=lambda nid, st: events.append((nid, st)),
    )
    out = []
    client.alive[f"http://{down}"] = False
    out.append(mon.probe_node(c.node(down)))
    out.append((c.node(down).state, c.state))
    client.alive[f"http://{down}"] = True
    out.append(mon.probe_node(c.node(down)))
    out.append((c.node(down).state, c.state))
    return out, events, [(m["type"], m["node"], m["state"]) for m in bcast.sent]


@pytest.mark.parametrize(
    "replica_n,coordinator,down",
    [(2, "a", "b"), (1, "a", "b"), (3, "a", "c"), (2, "b", "c")],
)
def test_probe_transitions_equal_jax(replica_n, coordinator, down):
    got = _transitions("torch", replica_n, coordinator, down)
    assert got == _transitions("jax", replica_n, coordinator, down)
    states, events, sent = got
    assert states[1][0] == "DOWN" and states[3] == ("READY", "NORMAL")
    assert events == [(down, "DOWN"), (down, "READY")]
    # only the coordinator disseminates
    assert bool(sent) == (coordinator == "a")


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_probe_once_round_robins_peers(pkg):
    c = _cluster(pkg)
    client = StubClient()
    mon = _monitor(pkg, c, client)
    for _ in range(4):
        mon.probe_once()
    assert client.probes == {"http://b": 2, "http://c": 2}


def test_a_stopped_node_goes_down_and_comes_back_ready(tmp_path):
    """The coordinator's monitor marks a stopped node DOWN and tells the
    other member; reads skip it by its state and stay exact; a node
    restarted on its data directory comes back READY, its first answer
    exact."""
    with InProcessCluster(3, replica_n=2, device="cpu", with_disk=True, **KNOBS) as cl:
        for n in cl.nodes:
            n.client.timeout = 2.0
        cl.create_index("m")
        cl.create_field("m", "f")
        bits = [(1, s * SHARD_WIDTH + s) for s in range(9)]
        cl.import_bits("m", "f", bits)
        coord = cl.coordinator
        mons = [n.start_membership(probe_interval=0.05, confirm_retries=2, confirm_interval=0.01)
                for n in cl.nodes]
        assert mons[0] is cl.nodes[0].start_membership()  # idempotent
        vi = next(i for i, n in enumerate(cl.nodes) if n is not coord)
        victim = cl.nodes[vi]
        victim_id, data_dir, uri = victim.node_id, victim.store.path, victim.uri
        survivor = next(n for n in cl.nodes if n is not coord and n is not victim)
        cl.stop_node(vi)
        deadline = time.time() + 15
        while time.time() < deadline and not all(
            n.cluster.node(victim_id).state == "DOWN" for n in (coord, survivor)
        ):
            time.sleep(0.05)
        for n in (coord, survivor):
            assert n.cluster.node(victim_id).state == "DOWN"
            assert n.cluster.state == "DEGRADED"
        for n in (coord, survivor):
            assert n.api.query("m", "Count(Row(f=1))")["results"] == [9]
        # the same node id, data directory and port
        port = int(uri.rsplit(":", 1)[1])
        back = NodeServer(data_dir=data_dir, device="cpu", port=port, replica_n=2, **KNOBS)
        back.start()
        cl.nodes[vi] = back
        assert back.node_id == victim_id
        back.join_static([(n.node_id, n.uri) for n in cl.nodes], cl.coordinator_id)
        deadline = time.time() + 15
        while time.time() < deadline and not all(
            n.cluster.node(victim_id).state == "READY" for n in (coord, survivor)
        ):
            time.sleep(0.05)
        for n in (coord, survivor):
            assert n.cluster.node(victim_id).state == "READY"
            assert n.cluster.state == "NORMAL"
        assert back.api.query("m", "Count(Row(f=1))")["results"] == [9]
        for n in cl.nodes:
            if n.membership is not None:
                n.membership.stop()
        assert all(m._thread is None for m in mons)
