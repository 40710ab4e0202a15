"""Typed control-plane messages (reference: broadcast.go, server.go:549-682).

Counterpart of ``pilosa_tpu/cluster/broadcast.py``, the port's own copy.

The reference frames 16 protobuf message types with a 1-byte type prefix
(broadcast.go:55-83) and fans them out with parallel HTTP POSTs
(Server.SendSync server.go:646-667). This build frames them as JSON
``{"type": ..., ...payload}`` on ``POST /internal/cluster/message``.
Schema mutations broadcast so every node can serve any query's metadata;
data-plane traffic never rides this path.
"""

from __future__ import annotations

import concurrent.futures
from typing import Protocol

# Message types (reference broadcast.go:55-72)
MSG_CREATE_INDEX = "create-index"
MSG_DELETE_INDEX = "delete-index"
MSG_CREATE_FIELD = "create-field"
MSG_DELETE_FIELD = "delete-field"
MSG_CREATE_VIEW = "create-view"
MSG_DELETE_VIEW = "delete-view"
MSG_CREATE_SHARD = "create-shard"  # reference CreateShardMessage view.go:239-261
MSG_CLUSTER_STATUS = "cluster-status"
MSG_NODE_STATE = "node-state"
MSG_NODE_EVENT = "node-event"
MSG_RESIZE_INSTRUCTION = "resize-instruction"
MSG_RESIZE_COMPLETE = "resize-instruction-complete"
MSG_RESIZE_PREPARE = "resize-prepare"    # pending membership announced
MSG_EPOCH_FLIP = "epoch-flip"            # per-shard ownership flip
MSG_RESIZE_CANCEL = "resize-cancel"      # pending membership dropped
MSG_SET_COORDINATOR = "set-coordinator"
MSG_UPDATE_COORDINATOR = "update-coordinator"
MSG_SCHEMA = "schema"
MSG_RECALCULATE_CACHES = "recalculate-caches"


class Broadcaster(Protocol):
    """reference broadcast.go:30-34 broadcaster."""

    def send_sync(self, msg: dict) -> None: ...

    def send_to(self, node, msg: dict) -> None: ...


class NopBroadcaster:
    """reference broadcast.go:41-52 — lets a Holder/Field run standalone
    with zero network (used pervasively by unit tests)."""

    def send_sync(self, msg: dict) -> None:
        pass

    def send_to(self, node, msg: dict) -> None:
        pass


class HTTPBroadcaster:
    """Parallel fan-out to every peer (reference Server.SendSync
    server.go:646-667)."""

    def __init__(self, cluster, client, local_node_id: str):
        self.cluster = cluster
        self.client = client
        self.local_node_id = local_node_id

    def send_sync(self, msg: dict) -> None:
        peers = [n for n in self.cluster.nodes if n.id != self.local_node_id]
        if not peers:
            return
        with concurrent.futures.ThreadPoolExecutor(max_workers=len(peers)) as ex:
            errs = list(
                ex.map(lambda n: self._send_one(n, msg), peers)
            )
        for e in errs:
            if e is not None:
                raise e

    def _send_one(self, node, msg: dict):
        try:
            self.client.send_message(node.uri, msg)
            return None
        except Exception as e:  # collected, reported by send_sync
            return e

    def send_to(self, node, msg: dict) -> None:
        self.client.send_message(node.uri, msg)
