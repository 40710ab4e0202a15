"""Multi-node in-process cluster (counterpart of
``pilosa_tpu/testing/cluster.py``; reference: test/pilosa.go
MustRunCluster :344-400, test/cluster.go).

Boots n real ``NodeServer``s in threads of this process, with real HTTP
listeners on auto-bound ports, fixes a static membership (node 0 is the
coordinator), and offers the conveniences of the reference's
``test.Cluster``: schema through any node, shard-routed imports, queries
against every node, and deterministic fault injection. Every node knob
passes through to ``NodeServer``, whose defaults are JAX's; the nodes run
on ``cuda`` unless the caller passes ``device="cpu"``. With ``mesh_dispatch=True`` (the default) every
node registers its holder in the process's placement map, so the nodes
answer each other's shards on the mesh route, one launch on the card,
instead of over HTTP. ``add_node`` and ``remove_node`` resize the cluster
online through the coordinator (``cluster/resize.py``), and ``sync_all``
runs one anti-entropy pass on every node.
"""

from __future__ import annotations

import tempfile
import urllib.parse

from pilosa_tpu_torch.server.node import NodeServer
from pilosa_tpu_torch.shardwidth import SHARD_WORDS
from pilosa_tpu_torch.testing import faults


class InProcessCluster:
    def __init__(
        self,
        n: int,
        replica_n: int = 1,
        device: str = "cuda",
        n_words: int = SHARD_WORDS,
        with_disk: bool = False,
        **node_kw,
    ):
        """``node_kw`` goes to every ``NodeServer`` as it is, so each knob
        keeps the node's default (JAX's). In-process nodes share the card,
        so the mesh route (``cluster/dist.py``) serves by default; a run of
        the HTTP fan-out passes ``mesh_dispatch=False``. The black box only
        engages on ``with_disk`` clusters (a diskless node has nowhere to
        survive a crash)."""
        self._tmp = tempfile.TemporaryDirectory() if with_disk else None
        # every node, a joining one too, is built with the same knobs
        self._node_kw = dict(
            device=device, replica_n=replica_n, n_words=n_words, **node_kw
        )
        self._next_node_num = n
        self.nodes: list[NodeServer] = []
        for i in range(n):
            data_dir = f"{self._tmp.name}/node{i}" if self._tmp else None
            node = NodeServer(data_dir=data_dir, **self._node_kw)
            node.start()
            self.nodes.append(node)
        members = [(s.node_id, s.uri) for s in self.nodes]
        members.sort()
        self.coordinator_id = self.nodes[0].node_id
        for s in self.nodes:
            s.join_static(members, self.coordinator_id)
        self._faults: faults.FaultRegistry | None = None

    def __enter__(self) -> "InProcessCluster":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __len__(self) -> int:
        return len(self.nodes)

    def __getitem__(self, i: int) -> NodeServer:
        return self.nodes[i]

    @property
    def coordinator(self) -> NodeServer:
        for s in self.nodes:
            if s.node_id == self.coordinator_id:
                return s
        raise RuntimeError("coordinator not in cluster")

    # -- conveniences (reference test/cluster.go) ---------------------------

    def create_index(self, name: str, options: dict | None = None) -> None:
        self.nodes[0].api.create_index(name, options or {})

    def create_field(self, index: str, field: str, options: dict | None = None) -> None:
        self.nodes[0].api.create_field(index, field, options or {})

    def query(self, node: int, index: str, pql: str, profile: bool = False) -> dict:
        return self.nodes[node].api.query(index, pql, profile=profile)

    def import_bits(self, index: str, field: str, bits: list[tuple[int, int]]) -> None:
        """Route (row, col) pairs through node 0's import coordinator
        (reference test/pilosa.go ImportBits :256-294 routes to owners)."""
        self.nodes[0].api.import_bits(
            index,
            field,
            {
                "rowIDs": [r for r, _ in bits],
                "columnIDs": [c for _, c in bits],
            },
        )

    def import_values(
        self, index: str, field: str, cols: list[int], values: list[int]
    ) -> None:
        """Route (col, value) pairs into an int field through node 0's
        import coordinator (the BSI twin of :meth:`import_bits`)."""
        self.nodes[0].api.import_bits(
            index,
            field,
            {"columnIDs": list(cols), "values": list(values)},
        )

    def owner_of(self, index: str, shard: int) -> NodeServer:
        node_id = self.nodes[0].cluster.primary_shard_node(index, shard).id
        for s in self.nodes:
            if s.node_id == node_id:
                return s
        raise RuntimeError("owner not found")

    def add_node(self) -> NodeServer:
        """Boot a fresh node and resize it into the cluster through the
        coordinator (reference server/cluster_test.go node-join tests)."""
        data_dir = f"{self._tmp.name}/node{self._next_node_num}" if self._tmp else None
        self._next_node_num += 1
        node = NodeServer(data_dir=data_dir, **self._node_kw)
        node.start()
        try:
            self.coordinator.resize_coordinator().add_node(node.node_id, node.uri)
        except Exception:
            node.stop()
            raise
        self.nodes.append(node)
        return node

    def remove_node(self, i: int) -> None:
        """Resize node ``i`` out through the coordinator, then stop it."""
        node = self.nodes[i]
        self.coordinator.resize_coordinator().remove_node(node.node_id)
        node.stop()
        self.nodes.pop(i)

    def sync_all(self) -> dict:
        """Run one anti-entropy pass on every node; returns summed stats."""
        total: dict[str, int] = {}
        for n in self.nodes:
            for k, v in n.syncer().sync_holder().items():
                total[k] = total.get(k, 0) + v
        return total

    # -- deterministic fault injection (testing/faults.py) -------------------

    def fault_registry(self, seed: int = 0) -> faults.FaultRegistry:
        """The cluster's installed fault registry (created + installed
        lazily; ``seed`` only applies to the first call).  Every rule
        firing is journaled on the coordinator so chaos runs read as one
        timeline: fault fired -> breaker opened -> job aborted."""
        if self._faults is None:
            self._faults = faults.install(faults.FaultRegistry(seed=seed))
            from pilosa_tpu_torch.obs import events as ev

            journal = self.nodes[0].holder.events if self.nodes else None
            if journal is not None:
                self._faults.on_fire = lambda kind, target: journal.record(
                    ev.EVENT_FAULT_INJECTED, kind=kind, target=target
                )
        return self._faults

    def inject_fault(
        self,
        kind: str,
        node: int | None = None,
        peer: str | None = None,
        route: str | None = None,
        path: str | None = None,
        stage: str | None = None,
        delay: float = 0.0,
        code: int = 503,
        times: int | None = None,
        p: float = 1.0,
        seed: int = 0,
    ) -> faults.Fault:
        """Add one fault rule; returns it for later ``remove``/``hits``
        inspection.  ``node`` is an index into ``self.nodes`` and is
        shorthand for ``peer=<that node's netloc>`` (network kinds) —
        use ``peer``/``route``/``path`` fnmatch patterns for anything
        finer.  Example::

            cl.inject_fault("reset", node=1, route="/index/*", times=2)
            cl.inject_fault("slow", node=2, delay=5.0)
            cl.inject_fault("disk_write_fail", path="*/ci/cf/*")
        """
        if node is not None:
            if peer is not None:
                raise ValueError("pass node OR peer, not both")
            peer = urllib.parse.urlsplit(self.nodes[node].uri).netloc
        return self.fault_registry(seed=seed).add(
            kind, peer=peer, route=route, path=path, stage=stage,
            delay=delay, code=code, times=times, p=p,
        )

    def clear_faults(self) -> None:
        if self._faults is not None:
            self._faults.clear()

    def stop_node(self, i: int) -> None:
        """Hard-stop one node (fault injection — the reference uses pumba
        pause in internal/clustertests)."""
        self.nodes[i].stop()

    def pause_node(self, i: int) -> None:
        """Make a node drop all requests without stopping it (the pumba
        pause analogue: process alive, network dead)."""
        self.nodes[i].server.pause()

    def resume_node(self, i: int) -> None:
        self.nodes[i].server.resume()

    def close(self) -> None:
        if self._faults is not None:
            faults.uninstall(self._faults)
            self._faults = None
        for s in self.nodes:
            try:
                s.stop()
            except Exception:  # graftlint: disable=exception-hygiene -- harness teardown: a node the test already killed must not abort cleanup of the rest
                pass
        if self._tmp is not None:
            self._tmp.cleanup()
