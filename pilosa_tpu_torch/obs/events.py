"""Cluster event journal: a bounded ring of typed control-plane events.

The reference exposes its control plane through log lines and the
diagnostics phone-home payload; debugging a production cluster means
asking a node "what happened here in the last hour" — membership churn,
resize phases, anti-entropy rounds, breaker flips, snapshot compactions,
injected faults.  This journal is that surface: every control-plane
subsystem records typed events into a per-node ring buffer with
monotonic sequence numbers, served at ``/debug/events?since=<seq>``.

Cursor semantics: sequence numbers start at 1 and never repeat.  A
consumer polls ``since=<last nextSeq>`` and is guaranteed gap-free,
duplicate-free delivery as long as it keeps up with the ring; when the
ring has dropped events past the cursor the response says so
(``truncated``) instead of silently skipping — the consumer knows its
timeline has a hole rather than believing a quiet cluster.

The coordinator's ``/debug/events?cluster=true`` view fans out to every
peer and merges the per-node journals into one cluster timeline ordered
by wall-clock time (each event keeps its origin node id and per-node
seq, so per-node ordering is still exact even when clocks skew).

Counterpart of ``pilosa_tpu/obs/events.py``, without what only its
cluster and serving planes call.
"""

from __future__ import annotations

import threading
import time
from collections import deque

# -- event types -------------------------------------------------------------

EVENT_NODE_START = "node-start"          # this process came up
EVENT_MEMBERSHIP_SET = "membership-set"  # static membership fixed at join
EVENT_NODE_JOIN = "node-join"            # a member appeared in a commit
EVENT_NODE_LEAVE = "node-leave"          # a member left in a commit
EVENT_NODE_STATE = "node-state"          # peer READY/DOWN transition
EVENT_CLUSTER_STATE = "cluster-state"    # NORMAL/DEGRADED/RESIZING/...
EVENT_RESIZE_START = "resize-start"
EVENT_RESIZE_PHASE = "resize-phase"
EVENT_RESIZE_COMMIT = "resize-commit"
EVENT_RESIZE_ABORT = "resize-abort"
EVENT_RESIZE_RESUME = "resize-resume"      # journaled plan re-dispatched
EVENT_RESIZE_DATA_LOSS = "resize-data-loss"  # dead removal dropped fragments
EVENT_RESIZE_WATCHDOG = "resize-watchdog"  # node self-healed a missed commit
EVENT_MIGRATE_FRAGMENT = "migrate-fragment"  # one fragment's migration done
EVENT_EPOCH_FLIP = "epoch-flip"            # per-shard ownership flipped
EVENT_ANTIENTROPY_ROUND = "antientropy-round"
EVENT_CIRCUIT_BREAKER = "circuit-breaker"
EVENT_SNAPSHOT = "snapshot"              # fragment op-log compaction
EVENT_FAULT_INJECTED = "fault-injected"  # testing/faults.py rule fired
EVENT_INCIDENT = "incident"              # flight recorder auto-capture
EVENT_QOS = "qos-transition"             # pressure-ladder stage change
EVENT_NODE_STOP = "node-stop"            # orderly shutdown began
EVENT_NODE_CRASH = "node-crash-detected"  # previous life died dirty


class EventJournal:
    """Thread-safe bounded ring of typed events with monotonic seqs."""

    def __init__(self, capacity: int = 1024, node_id: str = ""):
        self.capacity = max(1, int(capacity))
        self.node_id = node_id  # settable later, once the id is known
        self._lock = threading.Lock()
        self._ring: deque[dict] = deque(maxlen=self.capacity)
        self._seq = 0
        self.dropped = 0  # events evicted by the ring bound

    # -- producers -----------------------------------------------------------

    def record(self, type: str, **data) -> dict:
        """Append one event; returns it (already sealed — callers must
        not mutate).  Never raises: the journal is an observability
        sink, and a failed record must not take down the subsystem
        that emitted it."""
        with self._lock:
            self._seq += 1
            event = {
                "seq": self._seq,
                "ts": time.time(),
                "node": self.node_id,
                "type": type,
                "data": data,
            }
            if len(self._ring) == self.capacity:
                self.dropped += 1
            self._ring.append(event)
            return event

    # -- consumers -----------------------------------------------------------

    @property
    def last_seq(self) -> int:
        with self._lock:
            return self._seq

    def since(self, seq: int = 0, limit: int | None = None) -> dict:
        """Events with sequence number strictly greater than ``seq``.

        Returns ``{"events", "nextSeq", "firstSeq", "lastSeq",
        "truncated"}``.  ``nextSeq`` is the cursor for the next poll
        (pass it back as ``since=``).  ``truncated`` is True when the
        ring evicted events the cursor never saw — the consumer's
        timeline has a gap it should surface, not paper over.  With
        ``limit``, at most that many events return and ``nextSeq``
        points at the last one delivered, so a chunked consumer resumes
        without gaps or duplicates."""
        seq = max(0, int(seq))
        with self._lock:
            events = [e for e in self._ring if e["seq"] > seq]
            oldest = self._ring[0]["seq"] if self._ring else self._seq + 1
            # The cursor missed events iff some seq in (seq, oldest)
            # existed but was evicted.
            truncated = seq + 1 < oldest and self._seq >= oldest
            last = self._seq
        if limit is not None and len(events) > max(0, int(limit)):
            events = events[: max(0, int(limit))]
        next_seq = events[-1]["seq"] if events else max(seq, 0)
        if not events and seq < last:
            next_seq = last  # everything past the cursor was evicted
        return {
            "events": events,
            "nextSeq": next_seq,
            "firstSeq": oldest if events or truncated else None,
            "lastSeq": last,
            "truncated": truncated,
        }

    def snapshot_summary(self) -> dict:
        """Cheap block for /debug/vars."""
        with self._lock:
            return {
                "lastSeq": self._seq,
                "retained": len(self._ring),
                "capacity": self.capacity,
                "dropped": self.dropped,
            }


def merge_timelines(per_node: list[list[dict]]) -> list[dict]:
    """Merge several nodes' event lists into one timeline ordered by
    wall-clock time (ties broken by node id then per-node seq, so the
    merge is deterministic under clock skew)."""
    merged = [e for events in per_node for e in events]
    merged.sort(key=lambda e: (e.get("ts", 0.0), e.get("node", ""), e.get("seq", 0)))
    return merged
