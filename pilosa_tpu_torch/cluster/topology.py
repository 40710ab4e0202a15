"""Nodes and persisted topology (reference: cluster.go Node/Topology,

Counterpart of ``pilosa_tpu/cluster/topology.py``, the port's own copy.
.topology file cluster.go:1632-1667, .id file holder.go:599-619).

The reference persists the set of known node IDs as a protobuf
``.topology`` file so a restarted cluster refuses to serve until every
remembered node has rejoined. This build persists the same facts as JSON.
"""

from __future__ import annotations

import json
import os
import uuid
from dataclasses import dataclass, field


NODE_STATE_READY = "READY"
NODE_STATE_DOWN = "DOWN"


@dataclass(order=True)
class Node:
    """One cluster member (reference cluster.go Node). Ordering is by id —
    the reference keeps nodes sorted by ID so jump-hash placement is
    stable across all members (cluster.go Nodes sort)."""

    id: str
    uri: str = field(compare=False, default="")
    is_coordinator: bool = field(compare=False, default=False)
    state: str = field(compare=False, default=NODE_STATE_READY)

    def to_dict(self) -> dict:
        return {
            "id": self.id,
            "uri": self.uri,
            "isCoordinator": self.is_coordinator,
            "state": self.state,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Node":
        return cls(
            id=d["id"],
            uri=d.get("uri", ""),
            is_coordinator=d.get("isCoordinator", False),
            state=d.get("state", NODE_STATE_READY),
        )


class Topology:
    """Persisted remembered-membership (reference cluster.go:1632-1667)."""

    def __init__(self, node_ids: list[str] | None = None):
        self.node_ids: list[str] = sorted(node_ids or [])

    def contains(self, node_id: str) -> bool:
        return node_id in self.node_ids

    def add(self, node_id: str) -> None:
        if node_id not in self.node_ids:
            self.node_ids.append(node_id)
            self.node_ids.sort()

    def remove(self, node_id: str) -> None:
        if node_id in self.node_ids:
            self.node_ids.remove(node_id)

    # -- persistence --------------------------------------------------------

    @staticmethod
    def path(data_dir: str) -> str:
        return os.path.join(data_dir, ".topology")

    def save(self, data_dir: str) -> None:
        os.makedirs(data_dir, exist_ok=True)
        tmp = self.path(data_dir) + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"nodeIDs": self.node_ids}, f)
        os.replace(tmp, self.path(data_dir))

    @classmethod
    def load(cls, data_dir: str) -> "Topology":
        p = cls.path(data_dir)
        if not os.path.exists(p):
            return cls()
        with open(p) as f:
            return cls(json.load(f).get("nodeIDs", []))


def load_or_create_node_id(data_dir: str | None) -> str:
    """Stable node identity across restarts (reference holder.go:599-619
    ``.id`` file). Ephemeral (memory-only) when data_dir is None."""
    if data_dir is None:
        return uuid.uuid4().hex
    os.makedirs(data_dir, exist_ok=True)
    p = os.path.join(data_dir, ".id")
    if os.path.exists(p):
        with open(p) as f:
            return f.read().strip()
    node_id = uuid.uuid4().hex
    with open(p, "w") as f:
        f.write(node_id)
    return node_id
