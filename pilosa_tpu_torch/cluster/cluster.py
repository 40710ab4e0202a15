"""Cluster state machine + shard placement (reference: cluster.go).

Counterpart of ``pilosa_tpu/cluster/cluster.py``, the port's own copy.

States and transitions follow cluster.go:46-51 (STARTING / NORMAL /
DEGRADED / RESIZING) with `determine_state` mirroring
determineClusterState (cluster.go:547-558): losing fewer than ReplicaN
nodes degrades reads; losing ReplicaN or more makes data unavailable and
drops the cluster back to STARTING.

Placement is the two-level hash of hash.py. All placement methods are
pure functions of the sorted node list, so every member computes the same
answers without coordination (the reference relies on the same property,
cluster.go:858-934).
"""

from __future__ import annotations

import threading

from pilosa_tpu_torch.cluster.hash import jump_hash, partition_hash
from pilosa_tpu_torch.cluster.topology import NODE_STATE_DOWN, Node

STATE_STARTING = "STARTING"
STATE_NORMAL = "NORMAL"
STATE_DEGRADED = "DEGRADED"
STATE_RESIZING = "RESIZING"

DEFAULT_PARTITION_N = 256  # reference cluster.go:44
DEFAULT_REPLICA_N = 1  # reference cluster.go:237


class Cluster:
    """Membership + placement + state (reference cluster.go:178 cluster)."""

    def __init__(
        self,
        node_id: str,
        uri: str = "",
        replica_n: int = DEFAULT_REPLICA_N,
        partition_n: int = DEFAULT_PARTITION_N,
        coordinator_id: str | None = None,
        disabled: bool = True,
    ):
        self._lock = threading.RLock()
        self.node_id = node_id
        self.replica_n = max(1, replica_n)
        self.partition_n = partition_n
        # disabled=True is the reference's Cluster.Disabled static mode
        # (cluster.go:204, setStatic :2000): membership fixed at boot, no
        # join/leave protocol.
        self.disabled = disabled
        self.coordinator_id = coordinator_id or node_id
        self.state = STATE_NORMAL if disabled else STATE_STARTING
        self.nodes: list[Node] = [
            Node(id=node_id, uri=uri, is_coordinator=(self.coordinator_id == node_id))
        ]
        self.on_state_change = None  # hook: fn(new_state)
        # In-flight online resize: while a migration runs the cluster
        # keeps serving from ``nodes``, but shards whose transfer has
        # completed flip — one (index, shard) at a time — onto the
        # ``pending_nodes`` placement.  ``epoch`` is a monotonic fence:
        # every flip/commit/abort bumps it, so a node can reject stale
        # flip broadcasts from an aborted resize generation.
        self.pending_nodes: list[Node] | None = None
        self.flipped: set[tuple[str, int]] = set()
        self.epoch = 0

    # -- membership ---------------------------------------------------------

    def node(self, node_id: str) -> Node | None:
        for n in self.nodes:
            if n.id == node_id:
                return n
        return None

    @property
    def local_node(self) -> Node:
        n = self.node(self.node_id)
        assert n is not None
        return n

    @property
    def is_coordinator(self) -> bool:
        return self.node_id == self.coordinator_id

    def add_node(self, node: Node) -> None:
        """Insert keeping the list sorted by id (placement stability)."""
        with self._lock:
            if self.node(node.id) is not None:
                return
            node.is_coordinator = node.id == self.coordinator_id
            self.nodes.append(node)
            self.nodes.sort()

    def remove_node(self, node_id: str) -> bool:
        with self._lock:
            n = self.node(node_id)
            if n is None:
                return False
            self.nodes.remove(n)
            return True

    def set_static(self, nodes: list[Node]) -> None:
        """Fix membership at boot (reference setStatic cluster.go:2000).
        Also the resize-commit landing point: committing a membership
        resolves any in-flight per-shard flip state."""
        with self._lock:
            self.nodes = sorted(nodes, key=lambda n: n.id)
            for n in self.nodes:
                n.is_coordinator = n.id == self.coordinator_id
            if self.pending_nodes is not None:
                self.pending_nodes = None
                self.flipped = set()
                self.epoch += 1
            changed = self.state != STATE_NORMAL
            self.state = STATE_NORMAL
        # The implicit RESIZING->NORMAL edge of a membership commit must
        # reach the observer hook like any explicit set_state call.
        if changed and self.on_state_change is not None:
            self.on_state_change(STATE_NORMAL)

    # -- online resize (per-shard flips instead of a cluster-wide gate) -----

    def begin_resize(self, pending_nodes: list[Node], epoch: int | None = None) -> int:
        """Arm an in-flight resize: placement stays on the current
        membership until individual shards flip.  Returns the new epoch
        (the coordinator broadcasts it; followers pass it back in so
        every node agrees on the fence value)."""
        with self._lock:
            # A re-prepare on the SAME epoch is a coordinator resuming an
            # interrupted resize: shards it already flipped must stay
            # flipped, or routing would snap back to the old ring while
            # the targets already drained their sessions.
            same = (
                self.pending_nodes is not None
                and epoch is not None
                and epoch == self.epoch
            )
            self.pending_nodes = sorted(pending_nodes, key=lambda n: n.id)
            if not same:
                self.flipped = set()
            self.epoch = epoch if epoch is not None else self.epoch + 1
            return self.epoch

    def flip_shard(self, index: str, shard: int, epoch: int | None = None) -> bool:
        """Move one shard's placement onto the pending membership.
        Rejected (returns False) when no resize is armed or the flip
        rides a stale epoch — a crashed-and-aborted resize generation
        must not flip shards of a later one."""
        with self._lock:
            if self.pending_nodes is None:
                return False
            if epoch is not None and epoch != self.epoch:
                return False
            self.flipped.add((index, int(shard)))
            return True

    def abort_resize(self) -> None:
        """Drop the pending membership: every shard — flipped or not —
        goes back to the current placement (the data still lives there;
        targets only ever held copies until commit)."""
        with self._lock:
            if self.pending_nodes is None:
                return
            self.pending_nodes = None
            self.flipped = set()
            self.epoch += 1

    @property
    def resize_pending(self) -> bool:
        return self.pending_nodes is not None

    # -- state machine ------------------------------------------------------

    def set_state(self, state: str) -> None:
        with self._lock:
            if state == self.state:
                return
            self.state = state
        if self.on_state_change is not None:
            self.on_state_change(state)

    def determine_state(self) -> str:
        """reference determineClusterState cluster.go:547-558."""
        with self._lock:
            down = sum(1 for n in self.nodes if n.state == NODE_STATE_DOWN)
            if down == 0:
                return STATE_NORMAL
            if down < self.replica_n:
                return STATE_DEGRADED
            return STATE_STARTING

    def mark_node_state(self, node_id: str, state: str) -> None:
        n = self.node(node_id)
        if n is not None:
            n.state = state
        if self.state != STATE_RESIZING:
            self.set_state(self.determine_state())

    # -- placement (reference cluster.go:847-934) ---------------------------

    def partition(self, index: str, shard: int) -> int:
        return partition_hash(index, shard, self.partition_n)

    def _ring_nodes(self, ring: list[Node], partition_id: int) -> list[Node]:
        n = len(ring)
        if n == 0:
            return []
        primary = jump_hash(partition_id, n)
        count = min(self.replica_n, n)
        return [ring[(primary + i) % n] for i in range(count)]

    def partition_nodes(self, partition_id: int) -> list[Node]:
        """Primary + replicas for a partition: jump-hash picks the primary
        ordinal; ReplicaN consecutive ring nodes follow (reference
        cluster.go:878-898)."""
        with self._lock:
            return self._ring_nodes(self.nodes, partition_id)

    def shard_nodes(self, index: str, shard: int) -> list[Node]:
        """Owner set for one shard — the single point every read/write
        route derives from.  During an online resize a flipped shard
        resolves over the pending membership, so routing follows each
        per-shard ownership flip the moment it lands, with no
        cluster-wide gate."""
        with self._lock:
            ring = self.nodes
            if self.pending_nodes is not None and (index, int(shard)) in self.flipped:
                ring = self.pending_nodes
            return self._ring_nodes(ring, self.partition(index, shard))

    def primary_shard_node(self, index: str, shard: int) -> Node:
        return self.shard_nodes(index, shard)[0]

    def owns_shard(self, node_id: str, index: str, shard: int) -> bool:
        return any(n.id == node_id for n in self.shard_nodes(index, shard))

    def owned_shards(self, node_id: str, index: str, shards) -> list[int]:
        return [s for s in shards if self.owns_shard(node_id, index, s)]

    def shards_by_node(self, index: str, shards) -> dict[str, list[int]]:
        """Primary-owner grouping for query fan-out (reference
        shardsByNode executor.go:2438)."""
        out: dict[str, list[int]] = {}
        for s in shards:
            out.setdefault(self.primary_shard_node(index, s).id, []).append(s)
        return out

    def translate_primary(self) -> Node | None:
        """Key-translation primary = the coordinator's node in this build.

        (The reference uses the previous ring node, cluster.go:1971-1996;
        with a static sorted membership the coordinator is an equivalent
        deterministic, well-known choice.)"""
        return self.node(self.coordinator_id)

    # -- status -------------------------------------------------------------

    def nodes_info(self) -> list[dict]:
        with self._lock:
            return [n.to_dict() for n in self.nodes]

    def status(self) -> dict:
        with self._lock:
            return {
                "state": self.state,
                "replicaN": self.replica_n,
                "partitionN": self.partition_n,
                "coordinator": self.coordinator_id,
                "nodes": [n.to_dict() for n in self.nodes],
                "epoch": self.epoch,
                "resizePending": self.pending_nodes is not None,
                "flippedShards": len(self.flipped),
            }
