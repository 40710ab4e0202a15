"""Distributed query execution: per-shard map-reduce over cluster nodes
(counterpart of ``pilosa_tpu/cluster/dist.py``; reference:
executor.go:2416-2611 mapReduce/mapper/remoteExec).

The coordinator of a query (whichever node received it):

1. translates keys to ids once (reference executor.go:116-209),
2. fans each call out shard-wise: local shards run on this node's
   executor, remote shard groups travel as re-serialized PQL with
   ``remote=true`` and the target's shard list (reference remoteExec),
   except when the owner's holder lives in this process
   (``parallel/meshplace.py``): such groups are folded with the local
   group into one executor call over a read-only holder facade
   (``cluster/meshexec.py``), so one stack per field over every assigned
   shard feeds one launch of each ported kernel on the card, with no
   sockets,
3. reduces the per-call partials (union of disjoint-shard bitmap
   segments, count sums, TopN and GroupBy merges),
4. retries a failed node's shards against the remaining replicas
   (reference executor.go:2495-2506), and
5. translates ids to keys in the final results.

Point writes (Set/Clear/attrs) are applied synchronously on every replica
of the target shard (reference executor.go:2140-2207); row and attribute
writes with no shard affinity broadcast to all nodes.

A failure of the mesh route demotes the rest of the query to the HTTP
fan-out, as JAX's does, with one exception: a fault of the device (a
CUDA error, or a launch a kernel wrapper refused) propagates to the
caller, so no fallback can hide a kernel fault (:func:`_device_fault`).
Fan-out legs run on a pool whose threads copy the caller's
``contextvars`` context, so the forwarded deadline, the tenant, the trace
span and the query profile cross the thread hop.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextvars
import logging
import os
import threading
from typing import Any, Callable

import torch

from pilosa_tpu_torch import deadline, pql
from pilosa_tpu_torch.cluster.client import ClientError
from pilosa_tpu_torch.cluster.cluster import Cluster
from pilosa_tpu_torch.cluster.meshexec import MeshHolderView
from pilosa_tpu_torch.cluster.topology import NODE_STATE_DOWN
from pilosa_tpu_torch.cluster.wire import decode_results, u32_words
from pilosa_tpu_torch.exec.executor import ExecuteError, Executor, IndexNotFoundError
from pilosa_tpu_torch.exec.result import GroupCount, Pair, Row, RowIdentifiers, ValCount
from pilosa_tpu_torch.obs import devledger, qprofile, tracing
from pilosa_tpu_torch import ops as ops_pkg
from pilosa_tpu_torch.parallel import meshplace
from pilosa_tpu_torch.pql.ast import Call

# Device ledger site of the mesh route's dispatches: the window wraps the
# whole facade call; the kernels inside book on their own sites.
_DL_MESH = devledger.site("cluster.mesh_dispatch")

logger = logging.getLogger(__name__)

# Calls whose result is a Row bitmap (reference executeBitmapCallShard
# dispatch, executor.go:653-680).
_BITMAP_CALLS = {
    "Row", "Range", "Difference", "Intersect", "Union", "Xor", "Not", "Shift",
}
# Point writes fanned to all replicas of one shard.
_POINT_WRITES = {"Set", "Clear", "SetColumnAttrs"}
# Writes with no single-shard affinity, broadcast to every node.
_BROADCAST_WRITES = {"SetRowAttrs"}
# Shard-distributed writes that must hit every replica of every shard.
_SHARD_WRITES = {"ClearRow", "Store"}


class NoAvailableReplicaError(ExecuteError):
    pass


_OPS_DIR = os.path.dirname(os.path.abspath(ops_pkg.__file__)) + os.sep


def _device_fault(exc: BaseException) -> bool:
    """True when ``exc`` (or an exception it chains from) is a fault of
    the device: a CUDA error (torch's, or one a hand kernel's launch
    reported), an out-of-memory on the card, or an exception raised
    inside the kernel wrappers (``pilosa_tpu_torch/ops``: a launch the
    wrapper refused). Such a fault is never demoted to the HTTP route."""
    accel = getattr(torch, "AcceleratorError", None)
    seen = set()
    e = exc
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        if isinstance(e, torch.cuda.OutOfMemoryError):
            return True
        if accel is not None and isinstance(e, accel):
            return True
        if isinstance(e, RuntimeError) and "CUDA" in str(e):
            return True
        tb = e.__traceback__
        while tb is not None:
            if os.path.abspath(tb.tb_frame.f_code.co_filename).startswith(_OPS_DIR):
                return True
            tb = tb.tb_next
        e = e.__cause__ or e.__context__
    return False


class DistributedExecutor:
    """Cluster-aware executor wrapping the single-node Executor."""

    # One fan-out pool per process would serialize independent queries'
    # fans behind each other; per-executor keeps isolation simple and the
    # thread count small (pool threads only block on remote HTTP I/O).
    _FANOUT_WORKERS = 8
    # Distinct shard assignments worth keeping warm facade executors for
    # (assignments only change on membership/breaker events, so steady
    # state uses exactly one entry).
    _MESH_CACHE_ENTRIES = 8
    # a read overtaken by membership commits this many times in a row runs
    # once more without the check
    _MEMBERSHIP_RETRIES = 3
    # Cached mesh plans (one per distinct (index, shard-set)); bigger
    # than the facade cache because plans are tiny and every served
    # index's steady-state shard set deserves a slot.
    _PLAN_CACHE_ENTRIES = 64

    def __init__(
        self, holder, cluster: Cluster, client, translator=None,
        local_executor: Executor | None = None,
    ):
        self.holder = holder
        self.cluster = cluster
        self.client = client
        # share the API's executor when given: serving caches are
        # field-level either way, but the per-executor counters
        # (/debug/vars serving_cache) must reflect the queries actually
        # executed.  translator only applies when WE build the executor —
        # a supplied one keeps its own.
        if local_executor is not None and translator is not None:
            if local_executor.translator is not translator:
                # hard error (not assert: compiled out under -O) — a
                # mismatched translator would silently mistranslate keys
                raise ValueError(
                    "local_executor was built with a different translator"
                )
        self.local = local_executor or Executor(holder, translator=translator)
        # Lazily created: single-node paths never pay for pool threads.
        # Request threads (ThreadingHTTPServer) race on init and against
        # close(), so both go through _pool_lock and a closed flag.
        self._pool: concurrent.futures.ThreadPoolExecutor | None = None
        self._pool_lock = threading.Lock()
        self._closed = False
        # Cluster-on-mesh dispatch: owner groups whose node is registered
        # in the process placement map (parallel/meshplace.py) execute as
        # one executor call over a holder facade instead of an HTTP
        # relay.  The per-instance flag lets a single executor opt out
        # (tests that exercise the HTTP plane) without touching the
        # process-wide registry or env kill switch.
        self.mesh_enabled = meshplace.enabled()
        # Facade executors are cached per shard assignment so their
        # field-stack caches stay warm across queries; bounded LRU since
        # assignments churn during resizes.
        self._mesh_cache: collections.OrderedDict = collections.OrderedDict()
        self._mesh_cache_lock = threading.Lock()
        # Mesh PLAN cache: shard->owner grouping is pure python hashing
        # (fnv + jump per shard per query) that dominates the dispatch
        # cost at high qps; plans are reused while the placement token
        # (membership + resize progress) is unchanged, and every hit
        # re-verifies the owners' registry handles so a withdrawn or
        # restarted peer forces a replan.
        self._plan_cache: collections.OrderedDict = collections.OrderedDict()
        self._plan_cache_lock = threading.Lock()
        self._partition_log: collections.deque = collections.deque(maxlen=32)
        self.mesh_dispatches = 0
        self.mesh_fallbacks = 0
        # membership commits seen, and the reads run again because one
        # overtook them (_read_retries)
        self.membership_changes = 0
        self.membership_retries = 0

    def _fanout_pool(self) -> concurrent.futures.ThreadPoolExecutor:
        with self._pool_lock:
            if self._closed:
                raise ExecuteError("executor is shut down")
            if self._pool is None:
                self._pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=self._FANOUT_WORKERS,
                    thread_name_prefix="pilosa-fanout",
                )
            return self._pool

    def _submit(self, fn, *args):
        """Submit to the fan-out pool under the CALLER's contextvars
        context, so the active trace span crosses the thread hop and
        remote spans still join the coordinator's trace (reference
        tracing/opentracing.go:58-66 header injection)."""
        ctx = contextvars.copy_context()
        return self._fanout_pool().submit(ctx.run, fn, *args)

    def close(self) -> None:
        with self._pool_lock:
            self._closed = True
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False)

    @property
    def single(self) -> bool:
        return len(self.cluster.nodes) <= 1

    # -- entry points -------------------------------------------------------

    def execute(
        self,
        index_name: str,
        query: str | pql.Query,
        shards: list[int] | None = None,
    ) -> list[Any]:
        if self.single:
            return self.local.execute(index_name, query, shards=shards)
        idx = self.holder.index(index_name)
        if idx is None:
            raise IndexNotFoundError(f"index not found: {index_name}")
        q = pql.parse(query) if isinstance(query, str) else query
        # the write cap guards the COORDINATOR boundary for clustered
        # queries too (reference executor.go:138 runs for every Execute)
        if (
            self.local.max_writes_per_request > 0
            and len(q.write_calls()) > self.local.max_writes_per_request
        ):
            from pilosa_tpu_torch.exec.executor import TooManyWritesError

            raise TooManyWritesError("too many write commands")
        # coordinator-side span (reference executor.go:117); remote fan-out
        # joins it via injected headers in InternalClient._do
        with tracing.start_span("executor.Execute").set_tag("index", index_name):
            return self._read_retries(
                lambda: self._execute_calls(index_name, idx, q, shards), q
            )

    def _execute_calls(self, index_name: str, idx, q: pql.Query, shards) -> list[Any]:
        results = []
        for call in q.calls:
            tcall = call.clone()
            self.local._translate_call(idx, tcall)
            # per-call span, matching the single-node executor's loop
            # (executor.go:298 executeCall) — profiles and traces of
            # clustered queries then show the same per-call shape
            with tracing.start_span(f"executor.execute{tcall.name}"):
                results.append(
                    self._execute_call(index_name, idx, tcall, shards)
                )
        return [
            self.local._translate_result(idx, c, r)
            for c, r in zip(q.calls, results)
        ]

    def rescache_probe(
        self,
        index_name: str,
        q: pql.Query,
        shards: list[int] | None = None,
    ) -> list[Any] | None:
        """Batcher-side semantic cache probe (server/batcher.py).  Only
        the single-node case probes the local full-result cache: on a
        multi-node coordinator a local probe cannot observe remote
        owners' fragment versions, so correctness rides the per-owner
        partial caches underneath (_map_partials / mesh facade) and the
        remote nodes' own executors instead."""
        if self.single:
            return self.local.rescache_probe(index_name, q, shards)
        return None

    def rescache_degraded(
        self,
        index_name: str,
        q: pql.Query,
        shards: list[int] | None = None,
    ) -> list[Any] | None:
        """Degraded-tier probe for the QoS governor (server/qos.py).
        Last-known FULL-result entries only exist on the single-node
        path (same reasoning as :meth:`rescache_probe`): a multi-node
        coordinator falls through and the staged tenant's query runs
        at its reduced weight instead."""
        if self.single:
            return self.local.rescache_degraded(index_name, q, shards)
        return None

    def execute_remote(
        self, index_name: str, query: str | pql.Query, shards: list[int] | None
    ) -> list[Any]:
        """Mapped-node entry (reference Remote:true re-entry,
        executor.go:2520-2555): keys were translated at the coordinator,
        so run raw calls over our shard list and return raw results."""
        idx = self.holder.index(index_name)
        if idx is None:
            raise IndexNotFoundError(f"index not found: {index_name}")
        q = pql.parse(query) if isinstance(query, str) else query
        out = []
        for c in q.calls:
            if c.name == "Options" and shards is not None:
                # the leg keeps to the shards it was sent: a list of the
                # Options' own would count every replica's copy again
                c = _without_shards(c)
            with tracing.start_span(f"executor.execute{c.name}"):
                out.append(self.local._execute_call(idx, c, shards))
        return out

    # -- per-call routing ---------------------------------------------------

    def _execute_call(
        self, index_name: str, idx, call: Call, shards: list[int] | None
    ) -> Any:
        if call.name in _POINT_WRITES:
            return self._execute_point_write(index_name, idx, call)
        if call.name in _BROADCAST_WRITES:
            return self._execute_broadcast_write(index_name, idx, call)
        all_shards = self.local._shards_for(idx, shards)
        if call.name in _SHARD_WRITES:
            return self._execute_shard_write(index_name, idx, call, all_shards)
        if call.name == "Options":
            call, all_shards = _options_shards(call, idx, all_shards)
        inner = (
            call.children[0]
            if call.name == "Options" and call.children
            else call
        )
        if inner.name == "TopN":
            return self._execute_topn_distributed(
                index_name, idx, call, inner, all_shards
            )
        return self._map_reduce(index_name, idx, call, all_shards)

    def _execute_topn_distributed(
        self, index_name: str, idx, call: Call, inner: Call,
        shards: list[int],
    ) -> list[Pair]:
        """Two-phase distributed TopN (reference executor.go:884-999):
        phase 1 gathers each node's top-n candidates (per-node lists are
        threshold-filtered and truncated to n, so a row ranked n+1 on
        every node but top-k globally would be missed); phase 2
        re-queries ALL nodes for the exact counts of the union of
        candidate ids (``ids=`` disables per-node truncation), so the
        final merge ranks every candidate by its true global count
        before truncating."""
        partials = self._map_partials(index_name, idx, call, shards)
        n, has_n = inner.uint_arg("n")
        _, has_ids = inner.uint_slice_arg("ids")
        if not has_n or not n or has_ids or self.single:
            return _reduce(call, partials)
        cand = sorted({p.id for part in partials for p in (part or [])})
        if not cand:
            return []
        refetch = call.clone()
        target = (
            refetch.children[0]
            if refetch.name == "Options" and refetch.children
            else refetch
        )
        target.args["ids"] = cand
        target.args.pop("n", None)
        partials2 = self._map_partials(index_name, idx, refetch, shards)
        merged = _reduce_topn(refetch, partials2)  # no n -> full merge
        return merged[:n]

    def _shard_of_write(self, call: Call) -> int:
        col, ok = call.uint_arg("_col")
        if not ok:
            raise ExecuteError(f"{call.name}() column argument required")
        return col // (self.holder.n_words * 32)

    def _submit_writes(
        self, index_name: str, call: Call, by_node: dict[str, list[int] | None]
    ) -> dict:
        """Launch a write on several nodes CONCURRENTLY (the reference
        fans replica writes from the coordinating goroutine,
        executor.go:2140-2207); the caller overlaps its local apply and
        then collects with ``_collect_writes``."""
        return {
            self._submit(
                self.client.query_node,
                self._node_by_id(node_id).uri,
                index_name,
                str(call),
                nshards if nshards is not None else [],
            ): node_id
            for node_id, nshards in by_node.items()
        }

    def _node_by_id(self, node_id: str):
        """Resolve a node for fan-out, including JOINING nodes: during an
        online resize a flipped shard routes to a pending-ring member
        that is not in ``cluster.nodes`` until the commit lands."""
        n = self.cluster.node(node_id)
        if n is None and self.cluster.pending_nodes is not None:
            for p in self.cluster.pending_nodes:
                if p.id == node_id:
                    return p
        if n is None:
            raise NoAvailableReplicaError(f"unknown fan-out node {node_id}")
        return n

    @staticmethod
    def _collect_writes(futures: dict) -> list[Any]:
        """Remote raw results; any node failure propagates WITH the
        failing node named — synchronous replica writes must not silently
        drop a replica."""
        out = []
        for f in concurrent.futures.as_completed(futures):
            try:
                out.append(decode_results(f.result()["wireResults"])[0])
            except ClientError as e:
                raise ClientError(
                    f"replica write failed on node {futures[f]}: {e}", e.code
                ) from e
        return out

    def _execute_point_write(self, index_name: str, idx, call: Call) -> Any:
        """Apply on every replica of the shard (reference
        executor.go:2140-2207 executeSetBitField), and on every owner the
        shard gained while the write ran (:func:`owners_written`)."""
        shard = self._shard_of_write(call)
        result = None
        for owners in owners_written(lambda: self.cluster.shard_nodes(index_name, shard)):
            remote: dict[str, list[int] | None] = {
                n.id: [shard] for n in owners if n.id != self.cluster.node_id
            }
            futures = self._submit_writes(index_name, call, remote)
            if len(remote) < len(owners):
                r = self.local._execute_call(idx, call, [shard])
                result = r if result is None else (result or r)
            for r in self._collect_writes(futures):
                result = r if result is None else (result or r)
        return result

    def _execute_broadcast_write(self, index_name: str, idx, call: Call) -> Any:
        remote: dict[str, list[int] | None] = {
            n.id: None for n in self.cluster.nodes if n.id != self.cluster.node_id
        }
        futures = self._submit_writes(index_name, call, remote)
        result = self.local._execute_call(idx, call, None)
        self._collect_writes(futures)
        return result

    def _execute_shard_write(
        self, index_name: str, idx, call: Call, shards: list[int]
    ) -> Any:
        """ClearRow/Store on every replica of every shard so replicas
        never diverge (the reference reaches the same end state via
        mapReduce + anti-entropy repair)."""
        changed = False
        for pairs in owners_written(lambda: [
            (node.id, s) for s in shards for node in self.cluster.shard_nodes(index_name, s)
        ]):
            by_replica: dict[str, list[int]] = {}
            for node_id, s in pairs:
                by_replica.setdefault(node_id, []).append(s)
            local_shards = by_replica.pop(self.cluster.node_id, None)
            futures = self._submit_writes(index_name, call, by_replica)
            if local_shards is not None:
                changed |= bool(self.local._execute_call(idx, call, local_shards))
            changed |= any(bool(r) for r in self._collect_writes(futures))
        return changed

    # -- map-reduce (reference executor.go:2454-2611) -----------------------

    def _map_reduce(
        self, index_name: str, idx, call: Call, shards: list[int]
    ) -> Any:
        return _reduce(call, self._map_partials(index_name, idx, call, shards))

    def _map_partials(
        self, index_name: str, idx, call: Call, shards: list[int]
    ) -> list[Any]:
        pql_text = str(call)
        span = tracing.start_span("executor.mapReduce").set_tag("call", call.name)
        span.set_tag("shards", len(shards))
        with span:
            bad_nodes: set[str] = set()
            partials: list[Any] = []
            pending = list(shards)
            # Partition ladder: mesh route -> HTTP relay -> replica
            # failover.  A mesh failure mid-query demotes the REST of the
            # query to HTTP (mesh_allowed flips) — it never fails the
            # caller.
            mesh_allowed = self._mesh_on()
            stats = self.holder.stats
            decision = {
                "call": call.name, "index": index_name,
                "shards": len(shards), "meshNodes": 0, "meshShards": 0,
                "httpNodes": 0, "httpShards": 0, "localShards": 0,
                "meshFallback": False,
            }
            while pending:
                # Fail the whole fan-out fast once the request's budget
                # is spent — re-mapping shards onto replicas is pointless
                # work the caller will never see.
                deadline.check(f"mapping {call.name} over {index_name}")
                try:
                    groups = self._group_by_live_owner(
                        index_name, pending, bad_nodes
                    )
                except NoAvailableReplicaError:
                    if not self.cluster.resize_pending:
                        raise
                    # Mid-resize a shard can flip between grouping and
                    # failover: the node that just failed may no longer
                    # be in the (post-flip) owner set at all.  Re-group
                    # once against the current ring with a clean slate.
                    groups = self._group_by_live_owner(
                        index_name, pending, set()
                    )
                pending = []
                # The local shard group ALWAYS runs inline on this
                # request thread — a saturated fan-out pool (slow remote
                # I/O) must never queue purely-local work behind sockets.
                # Mesh-local groups inherit the same invariant: the
                # facade call below is inline too, only true HTTP
                # legs ride the pool.
                local_shards = groups.pop(self.cluster.node_id, None)
                mesh_groups = (
                    self._mesh_owner_handles(groups) if mesh_allowed else {}
                )
                http_reason = (
                    "disabled" if not self._mesh_on()
                    else "mesh_error" if not mesh_allowed
                    else "off_mesh"
                )
                # Remote nodes are queried CONCURRENTLY (one pool task per
                # node, the reference's goroutine-per-node mapper,
                # executor.go:2520-2555) while the mesh + local groups run
                # on the request thread; results are collected in arrival
                # order and failed nodes' shards re-mapped onto remaining
                # replicas for the next loop pass.
                futures = {
                    self._submit(
                        self._query_remote,
                        self._node_by_id(node_id).uri,
                        node_id,
                        index_name,
                        pql_text,
                        nshards,
                    ): (node_id, nshards)
                    for node_id, nshards in groups.items()
                }
                for nshards in groups.values():
                    stats.count_with_tags(
                        "dist_http_fanout_total", 1, 1.0,
                        (f"reason:{http_reason}",),
                    )
                    decision["httpNodes"] += 1
                    decision["httpShards"] += len(nshards)
                if mesh_groups:
                    try:
                        partials.append(
                            self._mesh_execute(
                                index_name, call, mesh_groups, local_shards
                            )
                        )
                        decision["meshNodes"] += len(mesh_groups) + bool(
                            local_shards
                        )
                        decision["meshShards"] += sum(
                            len(sh) for _, sh in mesh_groups.values()
                        ) + len(local_shards or ())
                        local_shards = None  # folded into the launch
                    except Exception as e:
                        # a fault of the device propagates: no fallback
                        # may hide a kernel fault
                        if _device_fault(e):
                            raise
                        # Fallback ladder: the mesh path must never fail
                        # a query the HTTP relay can still answer: log
                        # the evidence, demote to HTTP, re-map.
                        logger.exception(
                            "mesh dispatch failed for %s on %r; "
                            "falling back to HTTP fan-out",
                            call.name, index_name,
                        )
                        stats.count("dist_mesh_fallback_total", 1)
                        self.mesh_fallbacks += 1
                        decision["meshFallback"] = True
                        mesh_allowed = False
                        for _, nshards in mesh_groups.values():
                            pending.extend(nshards)
                if local_shards is not None:
                    decision["localShards"] += len(local_shards)
                    # local partial through the semantic cache: repeat
                    # fan-outs reuse this node's partial under its own
                    # fragment version subvector (exec/rescache.py)
                    partials.append(
                        self.local.cached_execute_call(idx, call, local_shards)
                    )
                if futures:
                    fanout = tracing.start_span("dist.httpFanout")
                    fanout.set_tag("peers", len(futures))
                    fanout.set_tag("reason", http_reason)
                    with fanout:
                        for fut in concurrent.futures.as_completed(futures):
                            node_id, nshards = futures[fut]
                            try:
                                partials.append(fut.result())
                            except ClientError:
                                # Failover: re-map this node's shards onto
                                # remaining replicas (reference
                                # executor.go:2495-2506).
                                bad_nodes.add(node_id)
                                pending.extend(nshards)
            self._partition_log.append(decision)
            if not partials:
                partials = [self.local._execute_call(idx, call, [])]
            return partials

    # -- cluster-on-mesh dispatch -----------------------------------------

    def _mesh_on(self) -> bool:
        return self.mesh_enabled and meshplace.enabled()

    def _mesh_owner_handles(self, groups: dict) -> dict:
        """Pop every owner group whose node is registered as mesh-local;
        returns node id -> (placement handle, shards).  What remains in
        ``groups`` is the off-mesh HTTP remainder."""
        placement = meshplace.default_placement()
        out = {}
        for node_id in list(groups):
            h = placement.handle(node_id)
            if h is not None:
                out[node_id] = (h, groups.pop(node_id))
        return out

    def _mesh_executor_for(self, owners: dict) -> Executor:
        """Facade executor for one shard assignment (node id ->
        (holder, generation, shards)); cached so repeated queries over a
        stable assignment keep their device stacks warm."""
        key = tuple(sorted(
            (nid, gen, tuple(sorted(sh)))
            for nid, (holder, gen, sh) in owners.items()
        ))
        with self._mesh_cache_lock:
            hit = self._mesh_cache.get(key)
            if hit is not None:
                self._mesh_cache.move_to_end(key)
                return hit
            view = MeshHolderView(
                self.holder,
                {
                    nid: (holder, tuple(sorted(sh)))
                    for nid, (holder, gen, sh) in owners.items()
                },
            )
            ex = Executor(
                view,
                translator=self.local.translator,
                rescache_entries=self.local.rescache.max_entries,
                rescache_promote_hits=self.local.rescache.promote_hits,
                rescache_demote_deltas=self.local.rescache.demote_deltas,
            )
            self._mesh_cache[key] = ex
            stale = [
                k for k in self._mesh_cache
                if k != key and not self._generations_live(k)
            ]
            dropped = [self._mesh_cache.pop(k) for k in stale]
            while len(self._mesh_cache) > self._MESH_CACHE_ENTRIES:
                dropped.append(self._mesh_cache.popitem(last=False)[1])
        # a facade over a holder that left the placement map (a stopped or
        # restarted node) is never asked again: its stacks leave the card
        for old in dropped:
            old.release_stacks()
        return ex

    def _generations_live(self, key: tuple) -> bool:
        """Whether every owner of a facade's assignment is still registered
        under the generation the facade was built on (the local holder,
        generation 0, always is)."""
        placement = meshplace.default_placement()
        for nid, gen, _shards in key:
            if gen == 0:
                continue
            h = placement.handle(nid)
            if h is None or h.generation != gen:
                return False
        return True

    def _mesh_execute(
        self, index_name: str, call: Call, mesh_groups: dict,
        local_shards: list[int] | None,
    ) -> Any:
        """Answer every mesh-local owner group (plus the coordinator's
        own shards, folded in) as ONE executor call over the holder
        facade — inline on the request thread, same invariant as the
        plain local group."""
        owners = {
            nid: (h.holder, h.generation, nshards)
            for nid, (h, nshards) in mesh_groups.items()
        }
        if local_shards:
            # generation 0: the coordinator's holder identity is tied to
            # this executor's lifetime, not a registry entry
            owners[self.cluster.node_id] = (self.holder, 0, local_shards)
        shards = sorted(s for _, _, sh in owners.values() for s in sh)
        ex = self._mesh_executor_for(owners)
        fidx = ex.holder.index(index_name)
        if fidx is None:
            raise IndexNotFoundError(f"index not found: {index_name}")
        span = tracing.start_span("dist.meshDispatch")
        span.set_tag("call", call.name).set_tag("nodes", len(owners))
        span.set_tag("shards", len(shards))
        with span, qprofile.span(
            "meshDispatch", nodes=len(owners), shards=len(shards)
        ), _DL_MESH.launch(
            sig=f"{call.name} nodes{len(owners)} shards{len(shards)}"
        ):
            # through the facade executor's own semantic cache: the
            # partial is keyed by the owners' REAL fragment versions
            # (MeshView resolves to live fragments), and the facade
            # executor itself is cached per shard assignment, so a
            # resize epoch / shard flip rotates to a fresh cache while
            # fragment epochs fence any survivor entries
            out = ex.cached_execute_call(fidx, call, shards)
        self.mesh_dispatches += 1
        self.holder.stats.count("dist_mesh_local_total", 1)
        return out

    def mesh_complete(
        self,
        index_name: str,
        query: pql.Query,
        shards: list[int] | None = None,
    ) -> bool:
        """True when every owner of the query's shards is a slice of the
        local mesh — such a read can ride the continuous-batching plane
        (server/batcher.py) because it dispatches as one facade call
        with no HTTP subrequests to wait on."""
        if self.single or not self._mesh_on():
            return False
        if query.write_calls():
            return False
        idx = self.holder.index(index_name)
        if idx is None:
            return False
        return self._plan_mesh_batch(index_name, idx, shards) is not None

    def _placement_token(self) -> tuple:
        """Validity fence for cached mesh plans: changes whenever the
        shard->owner mapping can change — membership (node ids), resize
        epoch, or per-shard flip progress mid-resize."""
        cl = self.cluster
        flips = len(cl.flipped) if cl.pending_nodes is not None else -1
        return (cl.epoch, flips, tuple(n.id for n in cl.nodes))

    def _plan_mesh_batch(self, index_name: str, idx, shards: list[int] | None):
        """Partition one batched query; returns (assignment key, owners,
        shard list) when the whole query is mesh-resolvable, else None.

        The owner grouping is cached per (index, shard set) under a
        placement token — grouping hashes every shard through the ring
        per call, which would otherwise dominate the mesh hot path.  A
        cache hit still re-resolves every peer's registry handle, so a
        withdrawn/restarted node invalidates the plan immediately."""
        try:
            shard_list = self.local._shards_for(idx, shards)
        except ExecuteError:
            return None
        token = self._placement_token()
        ckey = (index_name, tuple(shard_list))
        placement = meshplace.default_placement()
        with self._plan_cache_lock:
            hit = self._plan_cache.get(ckey)
            if hit is not None:
                self._plan_cache.move_to_end(ckey)
        if hit is not None and hit[0] == token:
            owners = {}
            for nid, nshards in hit[1].items():
                if nid == self.cluster.node_id:
                    owners[nid] = (self.holder, 0, nshards)
                    continue
                h = placement.handle(nid)
                if h is None:
                    owners = None  # peer left the mesh; replan below
                    break
                owners[nid] = (h.holder, h.generation, nshards)
            if owners:
                key = tuple(sorted(
                    (nid, gen, tuple(sorted(sh)))
                    for nid, (holder, gen, sh) in owners.items()
                ))
                return key, owners, shard_list
        try:
            groups = self._group_by_live_owner(index_name, shard_list, set())
        except ExecuteError:
            return None
        local = groups.pop(self.cluster.node_id, None)
        owners = {}
        for nid, nshards in groups.items():
            h = placement.handle(nid)
            if h is None:
                return None
            owners[nid] = (h.holder, h.generation, nshards)
        if local:
            owners[self.cluster.node_id] = (self.holder, 0, local)
        if not owners:
            return None
        with self._plan_cache_lock:
            self._plan_cache[ckey] = (
                token,
                {
                    nid: tuple(sorted(sh))
                    for nid, (holder, gen, sh) in owners.items()
                },
            )
            while len(self._plan_cache) > self._PLAN_CACHE_ENTRIES:
                self._plan_cache.popitem(last=False)
        key = tuple(sorted(
            (nid, gen, tuple(sorted(sh)))
            for nid, (holder, gen, sh) in owners.items()
        ))
        return key, owners, shard_list

    def execute_batch(
        self, index_name: str, queries: list[tuple]
    ) -> list[Any]:
        """Cross-request micro-batch entry (server/batcher.py): queries
        whose shard owners all resolve to the local mesh dispatch as one
        facade ``Executor.execute_batch`` per assignment, demuxed
        per query; everything else (off-mesh owners, writes, planning
        failures) falls back to the per-query distributed path.  Result
        slots mirror ``Executor.execute_batch``: a list of per-call
        results, or an Exception instance for that query alone."""
        if self.single:
            return self.local.execute_batch(index_name, queries)
        idx = self.holder.index(index_name)
        if idx is None:
            err = IndexNotFoundError(f"index not found: {index_name}")
            return [err for _ in queries]
        out: list[Any] = [None] * len(queries)
        fallback: list[tuple] = []  # (slot, query, shards)
        flights: dict[tuple, list] = {}  # assignment key -> [(slot, q, shard_list)]
        plans: dict[tuple, dict] = {}  # assignment key -> owners
        span = tracing.start_span("executor.ExecuteBatch")
        span.set_tag("index", index_name).set_tag("queries", len(queries))
        with span:
            seen = self.membership_changes
            for slot, (query, qshards) in enumerate(queries):
                try:
                    q = pql.parse(query) if isinstance(query, str) else query
                except Exception as e:  # parse errors belong to their slot
                    out[slot] = e
                    continue
                plan = None
                if self._mesh_on() and not q.write_calls():
                    plan = self._plan_mesh_batch(index_name, idx, qshards)
                if plan is None:
                    fallback.append((slot, q, qshards))
                    continue
                key, owners, shard_list = plan
                plans[key] = owners
                flights.setdefault(key, []).append((slot, q, shard_list))
            for key, items in flights.items():
                try:
                    ex = self._mesh_executor_for(plans[key])
                    mspan = tracing.start_span("dist.meshDispatch")
                    mspan.set_tag("queries", len(items))
                    with mspan, qprofile.span(
                        "meshDispatch", queries=len(items)
                    ), _DL_MESH.launch(sig=f"batch q{len(items)}"):
                        got = ex.execute_batch(
                            index_name,
                            [(q, list(sh)) for _, q, sh in items],
                        )
                    for (slot, _, _), res in zip(items, got):
                        out[slot] = res
                    self.mesh_dispatches += 1
                    self.holder.stats.count(
                        "dist_mesh_local_total", len(items)
                    )
                    self._partition_log.append({
                        "call": "<batch>", "index": index_name,
                        "queries": len(items),
                        "meshNodes": len(plans[key]),
                        "meshShards": sum(
                            len(sh) for _, _, sh in plans[key].values()
                        ),
                        "httpNodes": 0, "httpShards": 0, "localShards": 0,
                        "meshFallback": False,
                    })
                except Exception as e:
                    if _device_fault(e):
                        raise
                    # Same fallback ladder as _map_partials: a mesh
                    # failure demotes this flight to per-query HTTP.
                    logger.exception(
                        "mesh batch dispatch failed on %r; "
                        "re-running %d queries individually",
                        index_name, len(items),
                    )
                    self.holder.stats.count("dist_mesh_fallback_total", 1)
                    self.mesh_fallbacks += 1
                    fallback.extend(
                        (slot, q, list(sh)) for slot, q, sh in items
                    )
            if self.membership_changes != seen:
                # a membership commit overtook the flights: their reads go
                # again on the new ring
                self.membership_retries += 1
                self.holder.stats.count("dist_membership_retries_total", 1)
                again = {slot for slot, _, _ in fallback}
                fallback.extend(
                    (slot, q, list(sh))
                    for items in flights.values() for slot, q, sh in items
                    if slot not in again
                )
            for slot, q, qshards in fallback:
                try:
                    out[slot] = self.execute(index_name, q, shards=qshards)
                except Exception as e:  # isolate per query, like Executor
                    out[slot] = e
        return out

    def snapshot(self) -> dict:
        """/debug/vars ``dist`` block: placement map plus recent per-call
        partition decisions (docs/serving.md "Cluster on the mesh")."""
        return {
            "meshEnabled": self._mesh_on(),
            "singleNode": self.single,
            "placement": meshplace.default_placement().snapshot(),
            "meshDispatches": self.mesh_dispatches,
            "meshFallbacks": self.mesh_fallbacks,
            "membershipRetries": self.membership_retries,
            "recentPartitions": list(self._partition_log),
            # facade executors' partial caches, aggregated: mesh-leg
            # repeats served without launching again
            "meshRescache": self._mesh_rescache_totals(),
        }

    def note_membership(self) -> None:
        """A membership commit landed: a read that began before it may have
        been planned on owners that are about to drop its fragments."""
        with self._mesh_cache_lock:
            self.membership_changes += 1

    def _read_retries(self, run, q: pql.Query):
        """``run()`` for a read, again while a membership commit overtakes
        it (at most :attr:`_MEMBERSHIP_RETRIES` times): an old owner drops
        its fragments only after every member has the new ring, so a read
        that saw no commit from start to end read every fragment it
        planned on."""
        if q.write_calls():
            return run()
        for _ in range(self._MEMBERSHIP_RETRIES):
            seen = self.membership_changes
            out = run()
            if self.membership_changes == seen:
                return out
            self.membership_retries += 1
            self.holder.stats.count("dist_membership_retries_total", 1)
        return run()

    def forget_placement(self) -> None:
        """Drop the facade executors and the cached plans: the shard ->
        owner map moved (an epoch flip, a commit or a cancel). A facade
        executor is keyed on its owners' assignment, so a stale one is
        never asked again, but its stacks would stay on the card until it
        went: they are released here, and the next read builds its stacks
        over the new owners."""
        with self._mesh_cache_lock:
            executors = list(self._mesh_cache.values())
            self._mesh_cache.clear()
        with self._plan_cache_lock:
            self._plan_cache.clear()
        for ex in executors:
            ex.release_stacks()

    def _mesh_rescache_totals(self) -> dict:
        totals = {"hits": 0, "misses": 0, "invalidations": 0, "entries": 0}
        with self._mesh_cache_lock:
            executors = list(self._mesh_cache.values())
        for ex in executors:
            snap = ex.rescache.snapshot()
            totals["hits"] += snap["hits"]
            totals["misses"] += snap["misses"]
            totals["invalidations"] += snap["invalidations"]
            totals["entries"] += snap["entries"]
        return totals

    def _query_remote(
        self,
        uri: str,
        node_id: str,
        index_name: str,
        pql_text: str,
        shards: list[int],
    ) -> Any:
        """One fan-out leg: remote query plus sub-profile graft.  When the
        coordinator's query is being profiled the remote node returns its
        own profile dict in the response envelope, and we hang it off the
        current span so ``?profile=true`` shows the whole cluster tree."""
        want = qprofile.profiling()
        # real tracing span (not just a profile node): the remote node's
        # http.query span parents to THIS span, so a cluster-assembled
        # trace shows coordinator -> fanout -> peer as one tree
        fanout = tracing.start_span("dist.fanout")
        fanout.set_tag("peer", node_id).set_tag("shards", len(shards))
        with fanout, qprofile.span("fanout", node=node_id, shards=len(shards)):
            resp = self.client.query_node(
                uri, index_name, pql_text, shards, profile=want
            )
            if want:
                qprofile.add_subprofile(node_id, resp.get("profile"))
            return decode_results(resp["wireResults"])[0]

    def _peer_available(self, node) -> bool:
        """Circuit-breaker routing check — local node is always
        available (no transport involved), and a client without breakers
        (NopInternalClient, test doubles) never vetoes a peer."""
        if node.id == self.cluster.node_id:
            return True
        check = getattr(self.client, "peer_available", None)
        if check is None:
            return True
        return check(node.uri)

    def _group_by_live_owner(
        self, index_name: str, shards: list[int], bad_nodes: set[str]
    ) -> dict[str, list[int]]:
        groups: dict[str, list[int]] = {}
        for s in shards:
            owner = None
            fallback = None
            for node in self.cluster.shard_nodes(index_name, s):
                if node.id in bad_nodes or node.state == NODE_STATE_DOWN:
                    continue
                # Two-pass selection: prefer a replica whose circuit
                # breaker admits traffic, so fan-outs route around a
                # flapping peer BEFORE membership confirms it down; if
                # every live replica is tripped, degrade gracefully and
                # use the first anyway (it may have just recovered, and
                # failover still covers us if it hasn't).
                if fallback is None:
                    fallback = node
                if self._peer_available(node):
                    owner = node
                    break
            if owner is None:
                owner = fallback
            if owner is None:
                raise NoAvailableReplicaError(
                    f"no available replica for shard {s} of {index_name!r}"
                )
            groups.setdefault(owner.id, []).append(s)
        return groups


# -- reduce functions (reference executor.go per-call reduceFns) ------------


def owners_written(owners_now):
    """Yield the owners a write still has to reach, until it has reached
    every owner ``owners_now()`` names: first all of them, then, each time
    the caller has written the batch yielded, those the shard -> owner map
    gained meanwhile (an item is a node, or anything the map lists).

    An online resize moves a shard's writes to its new owners at the
    shard's flip (``cluster/resize.py``). A write planned on the old
    owners reaches a new one through the migration's delta tap, but only
    while the tap's session is open, and the target closes it after every
    node took the flip. So a write whose old owners applied it after that
    is in no delta: by then the planning node took the flip too, and the
    new owners come out of its next look at the map."""
    done: set = set()
    while True:
        todo = [o for o in owners_now() if _owner_key(o) not in done]
        if not todo:
            return
        yield todo
        done.update(_owner_key(o) for o in todo)


def _owner_key(owner):
    return getattr(owner, "id", owner)


def _without_shards(call: Call) -> Call:
    """An Options call without its ``shards`` argument."""
    out = call.clone()
    out.args.pop("shards", None)
    return out


def _options_shards(call: Call, idx, shards: list[int]) -> tuple[Call, list[int]]:
    """The coordinator's view of ``Options(..., shards=[...])``: the listed
    shards, of those the index has, replace the request's, as they do on
    one holder; the call then goes out without the list, so that each leg
    answers only the shards of the partition it is sent."""
    listed, has = call.uint_slice_arg("shards")
    if not has:
        return call, shards
    return _without_shards(call), sorted(set(listed) & set(idx.available_shards()))


def _reduce(call: Call, partials: list[Any]) -> Any:
    name = call.name
    if name == "Options" and call.children:
        name = call.children[0].name
    fn = _REDUCERS.get(name)
    if fn is None:
        if name in _BITMAP_CALLS:
            fn = _reduce_rows_union
        else:
            raise ExecuteError(f"no reducer for call {call.name!r}")
    return fn(call, partials)


def _reduce_rows_union(call: Call, partials: list[Any]) -> Row:
    out = Row({})
    for p in partials:
        if p is not None:
            # a local row's words may be an int32 view; a decoded remote
            # row's are uint32: merge them as uint32, bit for bit
            out = out.union(Row({s: u32_words(w) for s, w in p.segments.items()},
                                p.n_words))
    return out


def _reduce_count(call: Call, partials: list[Any]) -> int:
    return sum(int(p) for p in partials if p is not None)


def _reduce_sum(call: Call, partials: list[Any]) -> ValCount:
    out = ValCount()
    for p in partials:
        if p is not None:
            out = ValCount(out.value + p.value, out.count + p.count)
    return out


def _beats(a, b, maximal: bool) -> bool:
    """Whether extreme ``a`` strictly beats ``b``; a tie is neither, and
    the reducers below sum the tied partials' counts. (JAX's reducers test
    ``(a > b) == maximal``, which takes a tie of Min and MinRow for a win,
    so a node's count replaces the others' instead of adding to them.)"""
    return a > b if maximal else a < b


def _reduce_min_max(maximal: bool) -> Callable:
    def fn(call: Call, partials: list[Any]) -> ValCount:
        out = None
        for p in partials:
            if p is None or p.count == 0:
                continue
            if out is None or _beats(p.value, out.value, maximal):
                out = ValCount(p.value, p.count)
            elif p.value == out.value:
                out = ValCount(out.value, out.count + p.count)
        return out or ValCount()

    return fn


def _reduce_min_max_row(maximal: bool) -> Callable:
    def fn(call: Call, partials: list[Any]) -> Pair:
        out = None
        for p in partials:
            if p is None or p.count == 0:
                continue
            if out is None or _beats(p.id, out.id, maximal):
                out = Pair(id=p.id, key=p.key, count=p.count)
            elif p.id == out.id:
                out = Pair(id=out.id, key=out.key, count=out.count + p.count)
        return out or Pair()

    return fn


def _reduce_topn(call: Call, partials: list[Any]) -> list[Pair]:
    counts: dict[int, int] = {}
    for p in partials:
        for pair in p or []:
            counts[pair.id] = counts.get(pair.id, 0) + pair.count
    n, _ = call.uint_arg("n")
    pairs = sorted(
        (Pair(id=i, count=c) for i, c in counts.items()),
        key=lambda pr: (-pr.count, pr.id),
    )
    if n:
        pairs = pairs[:n]
    return pairs


def _reduce_rows_call(call: Call, partials: list[Any]) -> RowIdentifiers:
    ids: set[int] = set()
    for p in partials:
        if p is not None:
            ids.update(p.rows)
    rows = sorted(ids)
    limit, ok = call.uint_arg("limit")
    if ok and limit is not None:
        rows = rows[:limit]
    return RowIdentifiers(rows=rows)


def _reduce_groupby(call: Call, partials: list[Any]) -> list[GroupCount]:
    merged: dict[tuple, GroupCount] = {}
    for p in partials:
        for gc in p or []:
            key = tuple((g.field, g.row_id, g.row_key) for g in gc.group)
            if key in merged:
                merged[key] = GroupCount(gc.group, merged[key].count + gc.count)
            else:
                merged[key] = GroupCount(gc.group, gc.count)
    out = sorted(
        merged.values(), key=lambda gc: [g.row_id for g in gc.group]
    )
    limit, ok = call.uint_arg("limit")
    if ok and limit is not None:
        out = out[:limit]
    return [gc for gc in out if gc.count > 0]


def _reduce_bool_or(call: Call, partials: list[Any]) -> bool:
    return any(bool(p) for p in partials if p is not None)


def _reduce_first(call: Call, partials: list[Any]) -> Any:
    return partials[0] if partials else None


_REDUCERS: dict[str, Callable] = {
    "Count": _reduce_count,
    "Sum": _reduce_sum,
    "Min": _reduce_min_max(False),
    "Max": _reduce_min_max(True),
    "MinRow": _reduce_min_max_row(False),
    "MaxRow": _reduce_min_max_row(True),
    "TopN": _reduce_topn,
    "Rows": _reduce_rows_call,
    "GroupBy": _reduce_groupby,
    "ClearRow": _reduce_bool_or,
    "Store": _reduce_bool_or,
    "Set": _reduce_bool_or,
    "Clear": _reduce_bool_or,
    "SetRowAttrs": _reduce_first,
    "SetColumnAttrs": _reduce_first,
}
