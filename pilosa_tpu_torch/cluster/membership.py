"""Heartbeat membership + failure detection — the gossip analogue
(counterpart of ``pilosa_tpu/cluster/membership.py``, the port's own copy).

The reference detects failures with memberlist UDP/TCP probes
(reference gossip/gossip.go:554-575 probe tuning) and suppresses false
leaves with an HTTP ``/version`` double-check, 10 retries, before the
coordinator accepts a NodeLeave (reference cluster.go:1699-1768
confirmNodeDown / ReceiveEvent).  The reaction is the cluster state
machine: losing fewer than ReplicaN nodes puts the cluster in DEGRADED
(reads keep working via replica failover in the distributed executor);
losing more makes data unavailable (reference determineClusterState
cluster.go:547-558).

A static cluster has no use for full gossip dissemination — membership
only changes through the coordinator-driven resize protocol — so the
monitor keeps the two parts that still matter on a multi-host cluster:

* **liveness probing**: every node round-robins ``GET /version`` over its
  peers (the memberlist probe), marking peers DOWN after confirmation
  retries and READY again the moment a probe succeeds;
* **event delivery**: the coordinator turns confirmed transitions into a
  ``node-state`` broadcast so every member converges on the same view,
  and recomputes the cluster state machine (the follower path simply
  applies the broadcast — reference server.go:633-643 NodeEvent
  handling).
"""

from __future__ import annotations

import logging
import random
import threading
import zlib

from pilosa_tpu_torch.cluster import broadcast as bc
from pilosa_tpu_torch.cluster.cluster import Cluster, STATE_RESIZING
from pilosa_tpu_torch.cluster.topology import NODE_STATE_DOWN, NODE_STATE_READY
from pilosa_tpu_torch.obs import events as ev

logger = logging.getLogger(__name__)


class MembershipMonitor:
    """Round-robin peer prober with confirm-down double-checking."""

    def __init__(
        self,
        cluster: Cluster,
        client,
        broadcaster=None,
        probe_interval: float = 1.0,
        confirm_retries: int = 10,  # reference cluster.go:1702
        confirm_interval: float = 0.1,
        on_change=None,
        journal=None,
    ):
        self.cluster = cluster
        self.client = client
        self.broadcaster = broadcaster
        self.journal = journal  # EventJournal, optional
        self.probe_interval = probe_interval
        self.confirm_retries = confirm_retries
        self.confirm_interval = confirm_interval
        self.on_change = on_change  # fn(node_id, new_state)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._rr = 0
        # Per-node seed: every prober jitters its confirm cadence
        # differently, but each node's sequence replays deterministically.
        self._rng = random.Random(zlib.crc32(cluster.node_id.encode()))

    # -- probing ------------------------------------------------------------

    def _peers(self):
        return [n for n in self.cluster.nodes if n.id != self.cluster.node_id]

    def probe_once(self) -> None:
        """Probe the next peer in round-robin order."""
        peers = self._peers()
        if not peers:
            return
        self._rr = (self._rr + 1) % len(peers)
        self.probe_node(peers[self._rr])

    def probe_node(self, node) -> bool:
        """Probe one peer and apply the state transition. Returns liveness."""
        alive = self._ping(node)
        if alive and node.state == NODE_STATE_DOWN:
            self._transition(node, NODE_STATE_READY)
        elif not alive and node.state != NODE_STATE_DOWN:
            if self.confirm_node_down(node):
                # Membership may have changed while we were confirming
                # (e.g. the node was resized out); only mark members.
                if self.cluster.node(node.id) is not None:
                    self._transition(node, NODE_STATE_DOWN)
                return False
        return alive

    def _ping(self, node) -> bool:
        try:
            self.client.version(node.uri)
            return True
        except Exception:
            return False

    def confirm_node_down(self, node) -> bool:
        """Double-check with retries before declaring a peer dead
        (reference confirmNodeDown cluster.go:1699-1726). True = down.

        The inter-probe wait backs off exponentially (capped at 4x the
        base interval) with jitter, so the cluster's probers don't hammer
        a dying peer in lockstep — a peer that is merely restarting gets
        quieter retries spread over the same overall confirmation window
        order of magnitude."""
        for attempt in range(self.confirm_retries):
            if self._stop.is_set():
                return False  # shutting down: never declare peers dead
            if self._ping(node):
                return False
            wait = min(
                self.confirm_interval * (2 ** attempt),
                4 * self.confirm_interval,
            ) * (0.5 + self._rng.random())
            if self._stop.wait(wait):
                return False
        return True

    # -- transitions ---------------------------------------------------------

    def _transition(self, node, state: str) -> None:
        logger.info("node %s -> %s", node.id, state)
        if self.journal is not None:
            self.journal.record(
                ev.EVENT_NODE_STATE, peer=node.id, state=state
            )
        self.cluster.mark_node_state(node.id, state)
        if self.on_change is not None:
            try:
                self.on_change(node.id, state)
            except Exception:
                logger.exception("membership on_change hook failed")
        # The coordinator disseminates so every member converges without
        # full gossip (followers apply MSG_NODE_STATE; reference
        # server.go:633-643). During a resize the resize protocol owns
        # state broadcasts.
        if (
            self.broadcaster is not None
            and self.cluster.is_coordinator
            and self.cluster.state != STATE_RESIZING
        ):
            try:
                self.broadcaster.send_sync(
                    {"type": bc.MSG_NODE_STATE, "node": node.id, "state": state}
                )
            except Exception:
                # Unreachable peers miss the update; their own probes and
                # the next successful broadcast re-converge the view.
                logger.warning(
                    "node-state broadcast failed (view re-converges on "
                    "next probe cycle)",
                    exc_info=True,
                )

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def run():
            while not self._stop.wait(self.probe_interval):
                try:
                    self.probe_once()
                except Exception:
                    logger.exception("membership probe failed")

        self._thread = threading.Thread(
            target=run, name="membership-monitor", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
