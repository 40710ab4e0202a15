"""Placement map: which cluster nodes' shards this process can read
directly (counterpart of ``pilosa_tpu/parallel/meshplace.py``).

The cluster layer needs to know, per owner node, whether that node's
fragments are addressable from this process, that is, whether they live
in this process beside the card the serving executor launches on. When
they are, ``cluster/dist.py`` plans those shards into one local
partition: one launch of the ported kernels over a read-only holder
facade (``cluster/meshexec.py``) instead of an HTTP relay. On one H100
that is how several in-process nodes share the card.

A node advertises itself by registering its holder here on ``start()``
and withdrawing on ``stop()`` (``server/node.py``). With one process per
host only the local node ever registers, so the registry is a no-op and
every peer stays on the HTTP fan-out. In an ``InProcessCluster`` every
member registers, so the whole cluster collapses onto the one card.

The map is process-global rather than per-cluster: being in the same
process is the locality that makes a peer's fragments readable, and node
ids are unique across live in-process clusters.
"""

from __future__ import annotations

import itertools
import os
import threading


class MeshHandle:
    """One registered node: its holder plus a generation stamp that
    changes on every (re-)registration, so placement-keyed executor
    caches invalidate when a node restarts with a fresh holder."""

    __slots__ = ("node_id", "holder", "generation")

    def __init__(self, node_id: str, holder, generation: int):
        self.node_id = node_id
        self.holder = holder
        self.generation = generation


class MeshPlacement:
    def __init__(self):
        self._lock = threading.Lock()
        self._handles: dict[str, MeshHandle] = {}
        self._gen = itertools.count(1)

    def register(self, node_id: str, holder) -> None:
        with self._lock:
            self._handles[node_id] = MeshHandle(node_id, holder, next(self._gen))

    def unregister(self, node_id: str) -> None:
        with self._lock:
            self._handles.pop(node_id, None)

    def handle(self, node_id: str) -> MeshHandle | None:
        with self._lock:
            return self._handles.get(node_id)

    def snapshot(self) -> dict:
        """Placement map for /debug/vars: node id -> registration info."""
        with self._lock:
            return {
                nid: {"generation": h.generation}
                for nid, h in sorted(self._handles.items())
            }


_placement = MeshPlacement()


def default_placement() -> MeshPlacement:
    return _placement


def enabled() -> bool:
    """Mesh dispatch switch: ``PILOSA_MESH_DISPATCH=0`` sends every
    fan-out to the HTTP relay without touching any node's settings."""
    return os.environ.get("PILOSA_MESH_DISPATCH", "1").lower() not in (
        "0", "false", "no", "off",
    )
