"""Programmatic API surface of one node (counterpart of
``pilosa_tpu/server/api.py``; reference: api.go).

Every HTTP route lands here. Methods are state-gated like the reference
(api.go:100-124 validAPIMethods): during STARTING only status-ish methods
work, during RESIZING only fragment transfer and abort. The state is the
cluster's when the node has one; a standalone node sits in NORMAL.

Served as the JAX node serves by default: read-only queries
ride the continuous-batching plane (``server/batcher.py``: flights of
concurrent queries through ``Executor.execute_batch``, the result cache
and the flight planner inside it) behind the QoS governor
(``server/qos.py``) and the flight prefetcher (``server/prefetch.py``);
writes take the direct path; imports go through the staged ingest
pipeline (``ingest/``), whose applies invalidate the result cache. The
knobs and their defaults are JAX's (``batch_window=0.002``,
``batch_max_size=64``, ``rescache_entries=512``, ``planner_enabled=True``,
``qos_enabled=True``); ``batch_window=0`` (or ``batch_max_size<=1``) sends
every query the direct way. The node installs the observability planes
(``diagnostics``, ``flightrec``, ``history``, ``blackbox``); the API reads
them for ``/debug/history``, ``/debug/incidents``, ``/debug/postmortem``
and ``/internal/diagnostics``, and the QoS governor's incidents reach the
flight recorder.

With a cluster (``cluster``, ``client`` and ``broadcaster``, which
``NodeServer`` always passes) the API is a cluster member, as JAX's is:
queries go through the distributed executor (``cluster/dist.py``), whose
mesh-complete reads ride the batcher; ``remote=True`` sub-queries answer
in wire form; schema changes broadcast to the peers; imports route each
shard's slice to its replicas; peer messages (``receive_message``) apply
schema, shard, state and node news; key translation reaches the primary;
and ``?cluster=true`` merges events, history, traces and postmortems from
every peer. The elastic planes are JAX's: block checksums and block data
for anti-entropy, the source and target halves of an online migration
(``migrate_*``, ``cluster/migration.py``), the resize protocol's messages
(prepare, epoch flip, cancel, the membership commit, after which the node
drops what it no longer owns, its device copies through the residency
manager) and the operator's resize calls (abort, remove-node, resume,
set-coordinator).
"""

from __future__ import annotations

import io
import logging
import os
import random
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from pilosa_tpu_torch import __version__, deadline, pql
from pilosa_tpu_torch.cluster import broadcast as bc
from pilosa_tpu_torch.cluster import migration, wire
from pilosa_tpu_torch.cluster.client import ClientError
from pilosa_tpu_torch.cluster.dist import DistributedExecutor, owners_written
from pilosa_tpu_torch.cluster.migration import MigrationRegistry
from pilosa_tpu_torch.cluster.topology import Node as ClusterNode
from pilosa_tpu_torch.cluster.wire import encode_results
from pilosa_tpu_torch.core import membudget, residency, timequantum
from pilosa_tpu_torch.core.field import FieldOptions
from pilosa_tpu_torch.core.fragment import BSI_OFFSET_BIT
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.core.view import VIEW_STANDARD
from pilosa_tpu_torch.exec.executor import ExecuteError, Executor
from pilosa_tpu_torch.exec.result import result_to_json
from pilosa_tpu_torch.ingest import IngestPipeline
from pilosa_tpu_torch.ingest.pipeline import ChunkPrefetcher
from pilosa_tpu_torch.obs import devledger, qprofile, slo
from pilosa_tpu_torch.obs import events as ev
from pilosa_tpu_torch.ops import bitops
from pilosa_tpu_torch.server import qos as qos_mod
from pilosa_tpu_torch.server.batcher import QueryBatcher
from pilosa_tpu_torch.server.importpool import ImportPool
from pilosa_tpu_torch.server.prefetch import FlightPrefetcher
from pilosa_tpu_torch.server.qos import QosGovernor
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH_EXP
from pilosa_tpu_torch.storage import roaring
from pilosa_tpu_torch.storage.disk import HolderStore
from pilosa_tpu_torch.testing import faults

logger = logging.getLogger(__name__)

# Cluster states (reference cluster.go:46-51).
STATE_STARTING = "STARTING"
STATE_NORMAL = "NORMAL"
STATE_DEGRADED = "DEGRADED"
STATE_RESIZING = "RESIZING"

# Methods valid in non-NORMAL states (reference api.go:100-124).
_STARTING_METHODS = {
    "Status", "Info", "Version", "Schema", "ClusterMessage", "Hosts",
}
_RESIZING_METHODS = {
    "Status", "Info", "Version", "ClusterMessage", "Hosts",
    "FragmentData", "ResizeAbort",
}


class ApiError(Exception):
    def __init__(self, msg: str, code: int = 400):
        super().__init__(msg)
        self.code = code


class NotFoundError(ApiError):
    def __init__(self, msg: str):
        super().__init__(msg, 404)


class ConflictError(ApiError):
    def __init__(self, msg: str):
        super().__init__(msg, 409)


class API:
    """reference api.go:74 NewAPI, for one node."""

    def __init__(
        self,
        holder: Holder | None = None,
        store: HolderStore | None = None,
        cluster=None,
        client=None,
        broadcaster=None,
        import_workers: int = 2,
        import_queue_depth: int = 16,
        max_writes_per_request: int | None = None,
        batch_window: float = 0.002,
        batch_max_size: int = 64,
        rescache_entries: int = 512,
        planner_enabled: bool = True,
        qos_enabled: bool = True,
    ):
        self.holder = holder if holder is not None else Holder()
        self.store = store
        self.cluster = cluster
        self.client = client
        self.broadcaster = broadcaster
        translator = store.translator if store is not None else None
        self.executor = Executor(
            self.holder,
            translator=translator,
            max_writes_per_request=max_writes_per_request,
            rescache_entries=rescache_entries,
            planner_enabled=planner_enabled,
        )
        # the cluster-aware executor (reference executor.go mapReduce); it
        # answers through the local executor while the cluster has one node
        self.dist = None
        if cluster is not None and client is not None:
            self.dist = DistributedExecutor(
                self.holder, cluster, client, translator=translator,
                local_executor=self.executor,
            )
        self._lock = threading.RLock()
        self._state = STATE_NORMAL
        # source-side migration sessions (cluster/migration.py), and the
        # target's held pulls awaiting the post-flip finalize drain
        self.migrations = MigrationRegistry(self._node_id())
        self._migrate_pulls: dict[tuple, dict] = {}
        self._migrate_lock = threading.Lock()
        # the in-process mirror of the resize journal (cluster/resize.py;
        # a node with a data dir also keeps it on disk)
        self._resize_journal: dict | None = None
        # Slow-query ring (reference long-query-time, upgraded to full
        # profiles at /debug/slow-queries); the server sets the threshold.
        self.slow_queries = qprofile.SlowQueryLog()
        # the observability planes NodeServer installs: the diagnostics
        # collector (None 404s /internal/diagnostics), the flight recorder
        # and incident engine (None serves /debug/incidents empty), the
        # metrics history (None 404s /debug/history) and the black box
        # (None, without a data dir, 404s /debug/postmortem)
        self.diagnostics = None
        self.flightrec = None
        self.history = None
        self.blackbox = None
        # Bounded import worker pool: concurrency limit + backpressure
        # (reference api.go:66-96 importWorkerPoolSize default 2,
        # importWorker :313-348).
        self.import_pool = ImportPool(
            workers=import_workers, depth=import_queue_depth,
            jobs=self.holder.jobs, stats=self.holder.stats,
        )
        # the staged ingest pipeline over the pool (ingest/): decode into
        # staging buffers, coalesced applies, uploads to the card on the
        # uploader's own stream
        self.ingest = IngestPipeline(self.import_pool, stats=self.holder.stats)
        # an apply invalidates the result cache's entries of the field it
        # wrote, in the same group commit (exec/rescache.py)
        self.ingest.on_apply = lambda frag: self.executor.rescache.note_write(
            frag.index, frag.field
        )
        # the serving plane: the QoS governor (weighted-fair admission
        # debited by measured device ms, and the deprioritize/degrade/shed
        # ladder), the flight prefetcher on the uploader's low-priority
        # lane, and the batcher that coalesces reads into flights.
        # batch_window <= 0 or batch_max_size <= 1 leaves it off.
        self.batcher = None
        self.prefetcher = None
        self.qos = None
        if batch_window > 0 and batch_max_size > 1:
            self.qos = QosGovernor(
                stats=self.holder.stats,
                enabled=qos_enabled,
                slo_fn=lambda: self.holder.slo,
                ledger_fn=devledger.tenant_totals,
                journal_fn=lambda: self.holder.events,
                # read live: the flight recorder is installed after the API
                incident_fn=lambda trig: (
                    self.flightrec.capture_incident(trig)
                    if self.flightrec is not None
                    else None
                ),
            )
            if self.ingest.uploader is not None:
                # it warms the local executor's stacks; the batcher leaves
                # it idle while the node has peers (QueryBatcher.prefetching)
                self.prefetcher = FlightPrefetcher(
                    self.holder, self.ingest.uploader, self.executor
                )
            # on a clustered node the plane fronts the distributed executor,
            # whose batches collapse to the local executor on one node and
            # run mesh-complete flights as one facade call
            self.batcher = QueryBatcher(
                self.dist if self.dist is not None else self.executor,
                stats=self.holder.stats,
                window=batch_window,
                max_batch=batch_max_size,
                prefetcher=self.prefetcher,
                qos=self.qos,
            )
        # the pool /debug/fragments computes its census on (made at first
        # need)
        self._pool: ThreadPoolExecutor | None = None

    @property
    def state(self) -> str:
        if self.cluster is not None:
            return self.cluster.state
        return self._state

    @state.setter
    def state(self, value: str) -> None:
        if self.cluster is not None:
            self.cluster.set_state(value)
        else:
            self._state = value

    def _broadcast(self, msg: dict) -> None:
        """Best-effort control-plane fan-out: a peer that misses a schema
        message re-converges through the join handshake and anti-entropy. Raising here would leave the committed local
        change un-broadcast for ever, since a client's retry meets the
        ConflictError before it could broadcast again."""
        if self.broadcaster is None:
            return
        try:
            self.broadcaster.send_sync(msg)
        except Exception as e:
            logger.warning("broadcast %s failed: %s", msg.get("type"), e)

    # -- state gating (reference api.go:100-124) ---------------------------

    def _validate(self, method: str) -> None:
        if self.state in (STATE_NORMAL, STATE_DEGRADED):
            return
        allowed = (
            _STARTING_METHODS if self.state == STATE_STARTING else _RESIZING_METHODS
        )
        if method not in allowed:
            raise ApiError(
                f"api method {method} not allowed in state {self.state}", 503
            )

    # -- queries ------------------------------------------------------------

    def query(
        self,
        index: str,
        pql_text: str,
        shards: list[int] | None = None,
        remote: bool = False,
        profile: bool = False,
        encode: bool = True,
    ) -> dict:
        """reference api.go:134 Query. ``encode=False`` leaves the results as
        the executor's objects, for ``exec/result.response_json`` (the HTTP
        route's encoder). ``remote=True`` marks a mapped
        sub-query from another node's coordinator (reference Remote:true
        QueryRequest): keys arrive translated, and the results return in
        wire form for the caller's reduce. ``profile=True`` returns the
        per-query call tree (spans, kernel launches, cache hits, remote
        sub-profiles) under ``"profile"`` beside the results; a profile is
        also collected, without being returned, whenever the slow-query log
        is armed."""
        self._validate("Query")
        # a spent budget fails fast; DeadlineExceeded stays outside the
        # ApiError catch below so the transport maps it to 504
        deadline.check(f"query on {index!r}")
        if remote:
            # a fan-out sub-query: the user's request is on the
            # coordinator's budget, not on a read class of this node
            slo.note_class(slo.OP_INTERNAL)
        prof = None
        if profile or self.slow_queries.enabled:
            node_id = self.cluster.node_id if self.cluster is not None else ""
            prof = qprofile.QueryProfile(index, pql_text, node_id=node_id)
        t0 = time.perf_counter()
        err = None
        try:
            with qprofile.activate(prof):
                try:
                    if remote and self.dist is not None:
                        results = self.dist.execute_remote(index, pql_text, shards)
                        resp = {"wireResults": encode_results(results)}
                    else:
                        results = self._execute_query(index, pql_text, shards)
                        resp = {"results": result_to_json(results) if encode else results}
                        # an answer from the degraded tier is marked (the
                        # batcher notes it for this request)
                        if qos_mod.take_degraded():
                            resp["degraded"] = True
                except (ExecuteError, pql.ParseError, ValueError, TypeError) as e:
                    err = str(e)
                    raise ApiError(str(e))
        except BaseException as e:
            if err is None:
                err = repr(e)  # timeouts etc. still land in the slow log
            raise
        finally:
            if prof is not None:
                prof.finish(time.perf_counter() - t0, error=err)
                self.slow_queries.observe(prof)
        if prof is not None and profile:
            resp["profile"] = prof.to_dict()
        return resp

    def _execute_query(self, index: str, pql_text: str, shards):
        q = pql.parse(pql_text)
        # the SLO op class rides a contextvar to the HTTP layer's
        # recording point (this thread handles the whole request)
        op_class = slo.classify_query(q)
        slo.note_class(op_class)
        # every launch this query causes books under (tenant, index,
        # op_class) on the device ledger: inline, or in a flight (which
        # snapshots the principal at submit)
        with devledger.principal_scope(index, op_class):
            batcher = self.batcher
            dist = self.dist
            # a read rides the batcher when it resolves on this node or on
            # the mesh route (one facade call); writes, and fan-outs with
            # an owner outside this process, take the direct path
            if batcher is not None and batcher.accepts(q):
                if dist is None or dist.single or dist.mesh_complete(index, q, shards):
                    return batcher.submit(index, q, shards=shards)
            if dist is not None:
                return dist.execute(index, q, shards=shards)
            return self.executor.execute(index, q, shards=shards)

    # -- schema CRUD (reference api.go:161-495) -----------------------------

    def schema(self) -> dict:
        self._validate("Schema")
        return {"indexes": self.holder.schema()}

    def apply_schema(self, schema: dict) -> None:
        self._validate("ApplySchema")
        self.holder.apply_schema(schema.get("indexes", []))
        self._sync()

    def create_index(
        self, name: str, options: dict | None = None, broadcast: bool = True
    ) -> dict:
        self._validate("CreateIndex")
        return self._create_index(name, options, broadcast)

    def _create_index(
        self, name: str, options: dict | None = None, broadcast: bool = True
    ) -> dict:
        options = options or {}
        with self._lock:
            if self.holder.index(name) is not None:
                raise ConflictError("index already exists")
            try:
                idx = self.holder.create_index(
                    name,
                    keys=options.get("keys", False),
                    track_existence=options.get("trackExistence", True),
                )
            except ValueError as e:
                raise ApiError(str(e))
        self._sync()
        if broadcast:
            self._broadcast(
                {"type": bc.MSG_CREATE_INDEX, "index": name, "options": options}
            )
        return idx.to_dict()

    def delete_index(self, name: str, broadcast: bool = True) -> None:
        self._validate("DeleteIndex")
        self._delete_index(name, broadcast)

    def _delete_index(self, name: str, broadcast: bool = True) -> None:
        if not self.holder.delete_index(name):
            raise NotFoundError("index not found")
        if self.store is not None:
            self.store.delete_index_dir(name)
        if broadcast:
            self._broadcast({"type": bc.MSG_DELETE_INDEX, "index": name})

    def index_info(self, name: str) -> dict:
        self._validate("Index")
        idx = self.holder.index(name)
        if idx is None:
            raise NotFoundError("index not found")
        return idx.to_dict()

    def create_field(
        self,
        index: str,
        field: str,
        options: dict | None = None,
        broadcast: bool = True,
    ) -> dict:
        self._validate("CreateField")
        return self._create_field(index, field, options, broadcast)

    def _create_field(
        self,
        index: str,
        field: str,
        options: dict | None = None,
        broadcast: bool = True,
    ) -> dict:
        idx = self.holder.index(index)
        if idx is None:
            raise NotFoundError("index not found")
        if idx.field(field) is not None:
            raise ConflictError("field already exists")
        try:
            f = idx.create_field(field, FieldOptions.from_dict(options or {}))
        except ValueError as e:
            raise ApiError(str(e))
        self._sync()
        if broadcast:
            self._broadcast(
                {
                    "type": bc.MSG_CREATE_FIELD,
                    "index": index,
                    "field": field,
                    "options": options or {},
                }
            )
        return f.to_dict()

    def delete_field(self, index: str, field: str, broadcast: bool = True) -> None:
        self._validate("DeleteField")
        self._delete_field(index, field, broadcast)

    def _delete_field(self, index: str, field: str, broadcast: bool = True) -> None:
        idx = self.holder.index(index)
        if idx is None:
            raise NotFoundError("index not found")
        if not idx.delete_field(field):
            raise NotFoundError("field not found")
        if self.store is not None:
            self.store.delete_field_dir(index, field)
        if broadcast:
            self._broadcast(
                {"type": bc.MSG_DELETE_FIELD, "index": index, "field": field}
            )

    def field_info(self, index: str, field: str) -> dict:
        self._validate("Field")
        f = self.holder.field(index, field)
        if f is None:
            raise NotFoundError("field not found")
        return f.to_dict()

    # -- imports (reference api.go:919-1112 Import/ImportValue,
    #    :367-427 ImportRoaring) --------------------------------------------

    def import_bits(self, index: str, field: str, req: dict) -> None:
        """JSON bulk import: rowIDs/rowKeys + columnIDs/columnKeys
        (+ timestamps), or columnIDs/columnKeys + values for int fields;
        ``clear`` clears instead. The per-shard applies ride the ingest
        pipeline: submitted to the bounded import pool (reference
        api.go:313-348 backpressure) before any is awaited, each applied
        fragment handed to the uploader, all under one import-drain
        record. In a cluster the receiving node coordinates the import
        (reference api.go:919-1112): it translates keys once, splits the
        batch by shard, and sends each slice to every replica owning its
        shard (api.go:964-995), marked ``remote`` so receivers do not
        forward it again."""
        self._validate("Import")
        deadline.check(f"import into {index!r}/{field!r}")
        idx = self.holder.index(index)
        if idx is None:
            raise NotFoundError("index not found")
        f = idx.field(field)
        if f is None:
            raise NotFoundError("field not found")
        cols = req.get("columnIDs")
        if cols is None:
            keys = req.get("columnKeys")
            if keys is None:
                raise ApiError("columnIDs or columnKeys required")
            if not idx.keys:
                raise ApiError("columnKeys given but index does not use keys")
            cols = self.executor.translator.translate_keys(index, "", keys)
        cols = np.asarray(cols, dtype=np.uint64)
        if not req.get("remote") and self._route_import(index, f, req, cols):
            return
        with self.import_pool.drain_scope():
            self._apply_import(idx, f, index, field, req, cols)

    def _apply_import(self, idx, f, index: str, field: str, req: dict, cols) -> None:
        clear = req.get("clear", False)
        if "values" in req:
            if not f.is_bsi():
                raise ApiError(f"field {field!r} is not an int field")
            values = np.asarray(req["values"], dtype=np.int64)
            if len(values) != len(cols):
                raise ApiError("columns/values length mismatch")
            if len(values) and (
                int(values.min()) < f.options.min or int(values.max()) > f.options.max
            ):
                raise ApiError("value out of field range")
            f.import_values(cols, values, clear=clear, pipeline=self.ingest)
        else:
            rows = req.get("rowIDs")
            if rows is None:
                keys = req.get("rowKeys")
                if keys is None:
                    raise ApiError("rowIDs or rowKeys required")
                if not f.keys:
                    raise ApiError("rowKeys given but field does not use keys")
                rows = self.executor.translator.translate_keys(index, field, keys)
            if len(rows) != len(cols):
                raise ApiError("rows/columns length mismatch")
            timestamps = req.get("timestamps")
            ts = None if timestamps is None else _timestamps(timestamps)
            f.import_bits(
                np.asarray(rows, dtype=np.uint64), cols, timestamps=ts, clear=clear,
                pipeline=self.ingest, segments=req.get("_segments"),
            )
        ef = idx.existence_field()
        if ef is not None and not clear:
            ef.import_bits(np.zeros(len(cols), dtype=np.uint64), cols, pipeline=self.ingest)

    def _route_import(self, index: str, f, req: dict, cols: np.ndarray) -> bool:
        """Cluster import routing (reference api.go:964-995). True when the
        batch was split and sent shard-wise to the owning nodes; False when
        the caller applies it wholly here."""
        if (
            self.cluster is None
            or self.client is None
            or len(self.cluster.nodes) <= 1
        ):
            return False
        translator = self.executor.translator
        values = req.get("values")
        rows = None
        if values is None:
            rows = req.get("rowIDs")
            if rows is None:
                keys = req.get("rowKeys")
                if keys is None:
                    raise ApiError("rowIDs or rowKeys required")
                if not f.keys:
                    raise ApiError("rowKeys given but field does not use keys")
                rows = translator.translate_keys(index, f.name, keys)
            rows = np.asarray(rows, dtype=np.uint64)
            if len(rows) != len(cols):
                raise ApiError("rows/columns length mismatch")
        else:
            values = np.asarray(values, dtype=np.int64)
            if len(values) != len(cols):
                raise ApiError("columns/values length mismatch")
        timestamps = req.get("timestamps")
        width = f.n_words * 32
        shards = cols // np.uint64(width)
        node_uri: dict[str, str] = {}

        def owners_now():
            out = []
            for s in np.unique(shards):
                for node in self.cluster.shard_nodes(index, int(s)):
                    node_uri[node.id] = node.uri
                    out.append((node.id, int(s)))
            return out

        # every owner the batch's shards gained while it was sent gets its
        # slice too (dist.owners_written)
        for pairs in owners_written(owners_now):
            node_masks: dict[str, np.ndarray] = {}
            for node_id, s in pairs:
                m = shards == np.uint64(s)
                node_masks[node_id] = (
                    m if node_id not in node_masks else (node_masks[node_id] | m)
                )
            # every node's slice goes out before errors are reported, so one
            # dead replica cannot leave a later node's slice undelivered
            errors: list[str] = []
            for node_id, mask in node_masks.items():
                # numpy slices ride through: the local apply takes them as
                # they are and the client encodes them in binary ("_width"
                # lets it build roaring positions; the JSON fallback makes
                # lists)
                sub: dict = {
                    "columnIDs": cols[mask],
                    "remote": True,
                    "_width": width,
                }
                if values is not None:
                    sub["values"] = values[mask]
                else:
                    sub["rowIDs"] = rows[mask]
                if timestamps is not None:
                    sub["timestamps"] = [timestamps[i] for i in np.nonzero(mask)[0]]
                if req.get("clear"):
                    sub["clear"] = True
                try:
                    if node_id == self.cluster.node_id:
                        self.import_bits(index, f.name, sub)
                    else:
                        self.client.import_bits(node_uri[node_id], index, f.name, sub)
                except Exception as e:
                    errors.append(f"{node_id}: {e}")
            if errors:
                raise ApiError(
                    "import partially failed on node(s): " + "; ".join(errors), 500
                )
        return True

    def import_roaring(
        self, index: str, field: str, shard: int, data: bytes,
        clear: bool = False, view: str = VIEW_STANDARD, remote: bool = False,
    ) -> dict:
        """Binary roaring import, the highest-throughput ingest path
        (reference api.go:367-427), staged: decoded on the handler thread
        into a staging buffer of the ingest pipeline as row words (no
        positions), merged on the import pool (queued payloads of one
        fragment group-commit into one apply, whose summed ``changed`` they
        share), then uploaded to the card while the next payload merges;
        one import-drain record spans it."""
        self._validate("ImportRoaring")
        f = self.holder.field(index, field)
        if f is None:
            raise NotFoundError("field not found")
        if (
            not remote
            and self.cluster is not None
            and self.client is not None
            and len(self.cluster.nodes) > 1
        ):
            # in a cluster the payload is applied on every replica of the
            # shard (reference api.go:400-404)
            changed = 0
            errors: list[str] = []
            # and every owner the shard gained while it was sent
            # (dist.owners_written), whose changed count is not the payload's
            first = True
            for batch in owners_written(lambda: self.cluster.shard_nodes(index, shard)):
                for node in batch:
                    try:
                        if node.id == self.cluster.node_id:
                            got = self.import_roaring(
                                index, field, shard, data, clear=clear, view=view,
                                remote=True,
                            )["changed"]
                        else:
                            resp = self.client.import_roaring(
                                node.uri, index, field, shard, data, clear=clear,
                                view=view,
                            )
                            got = resp.get("changed") if isinstance(resp, dict) else None
                        # every replica applies the same payload: any
                        # replica's changed count is the changed count
                        if first and got is not None:
                            changed = got
                    except Exception as e:
                        errors.append(f"{node.id}: {e}")
                first = False
            if errors:
                raise ApiError(
                    "import-roaring failed on replica(s): " + "; ".join(errors),
                    500,
                )
            return {"changed": changed}
        with self.import_pool.drain_scope():
            try:
                buf = self.ingest.decode_roaring(data, f.n_words)
            except roaring.RoaringError as e:
                raise ApiError(f"bad roaring payload: {e}")

            def apply_group(payloads):
                # one merge a payload under one pool job: the summed
                # "changed" equals a concatenate-then-merge's, and the
                # group pays one device sync
                changed = 0
                frag = None
                for b in payloads:
                    result, frag = self._apply_roaring_rows(
                        index, f, shard, b.row_ids, b.rows, clear, view
                    )
                    changed += result["changed"]
                return {"changed": changed}, frag

            handle = self.ingest.submit_segment(
                (index, f.name, view, int(shard), bool(clear)),
                buf,
                apply_group,
                release=lambda b: b.release(),
            )
            return handle.wait()

    def _apply_roaring_rows(
        self, index: str, f, shard: int, row_ids: np.ndarray, words: np.ndarray,
        clear: bool, view: str,
    ) -> tuple[dict, object]:
        """Merge decoded roaring rows into the shard's fragment (JAX
        ``_apply_roaring_positions``); ``(result, fragment)``, so the
        pipeline hands the applied fragment to the upload stage.
        ``changed`` counts the bits flipped, as JAX's does."""
        frag = f.create_view_if_not_exists(view).create_fragment_if_not_exists(shard)
        if not clear and len(row_ids) and frag.load_if_empty(row_ids, words):
            # a fragment with no bit yet (a bulk load's, a migration
            # target's) takes the rows whole and writes them as its
            # snapshot, where a merge would log every position (8 bytes
            # each) and snapshot later
            if frag.store is not None:
                frag.store.snapshot()
            changed = int(np.bitwise_count(words).sum(dtype=np.int64))
        else:
            changed = frag.import_row_words(row_ids, words, clear=clear)
        self._rows_applied(index, f, shard, row_ids, words, clear, view)
        return {"changed": int(changed)}, frag

    def _rows_applied(
        self, index: str, f, shard: int, row_ids: np.ndarray, words: np.ndarray,
        clear: bool, view: str,
    ) -> None:
        """What rows merged into a fragment imply beside it: an int field's
        bit depth, and the existence of their columns."""
        if view.startswith("bsig_") and f.is_bsi() and len(row_ids):
            # the schema carries only the options: the bit depth grows to
            # the planes the payload holds (reference field.go:1050-1067)
            f.grow_bit_depth(int(row_ids.max()) - BSI_OFFSET_BIT + 1)
        idx = self.holder.index(index)
        ef = idx.existence_field() if idx is not None else None
        if ef is not None and not clear and len(row_ids):
            cols = np.bitwise_or.reduce(words, axis=0)
            ef.create_view_if_not_exists(VIEW_STANDARD).create_fragment_if_not_exists(
                shard
            ).import_row_words(np.zeros(1, dtype=np.uint64), cols[None])

    # -- export (reference api.go:499-573 ExportCSV) ------------------------

    def export_csv(self, index: str, field: str, shard: int | None = None) -> str:
        self._validate("ExportCSV")
        f = self.holder.field(index, field)
        if f is None:
            raise NotFoundError("field not found")
        v = f.view(VIEW_STANDARD)
        out = io.StringIO()
        translator = self.executor.translator
        idx = self.holder.index(index)
        if v is None:
            return ""
        for s in sorted(v.fragments) if shard is None else [shard]:
            frag = v.fragment(s)
            if frag is None:
                continue
            width = frag.shard_width
            for row in frag.row_ids():
                row_out = translator.translate_id(index, field, row) if f.keys else row
                for c in bitops.unpack_columns(frag.row_words_host(row)):
                    col = int(c) + s * width
                    if idx is not None and idx.keys:
                        col_out = translator.translate_id(index, "", col)
                    else:
                        col_out = col
                    out.write(f"{row_out},{col_out}\n")
        return out.getvalue()

    # -- node info (reference api.go:1114-1342) -----------------------------

    def _nodes_info(self) -> list[dict]:
        if self.cluster is not None:
            return self.cluster.nodes_info()
        return [{"id": self._node_id(), "uri": "", "isCoordinator": True, "state": "READY"}]

    def status(self) -> dict:
        self._validate("Status")
        # the schema and the shard map ride along for the peers' status
        # exchange (the reference's NodeStatus, gossip.go:321-357)
        out = {
            "state": self.state,
            "nodes": self._nodes_info(),
            "localID": self._node_id(),
            "schema": self.holder.schema(),
            "availableShards": self.available_shards_map(),
        }
        if self.cluster is not None:
            # resize visibility, read by the peers' resize watchdogs
            out["coordinator"] = self.cluster.coordinator_id
            out["epoch"] = self.cluster.epoch
            out["resizePending"] = self.cluster.resize_pending
        return out

    def info(self) -> dict:
        self._validate("Info")
        return {"shardWidth": 1 << SHARD_WIDTH_EXP, "shardWidthExp": SHARD_WIDTH_EXP}

    def version(self) -> dict:
        return {"version": __version__}

    def hosts(self) -> list[dict]:
        self._validate("Hosts")
        return self._nodes_info()

    def shards_max(self) -> dict:
        """reference api.go MaxShards /internal/shards/max."""
        return {
            "standard": {
                name: max(idx.available_shards(), default=0)
                for name, idx in self.holder.indexes.items()
            }
        }

    # -- fragments ----------------------------------------------------------

    def fragment_data(self, index: str, field: str, view: str, shard: int) -> bytes:
        """Whole-fragment snapshot as a roaring blob (reference
        api.go FragmentData)."""
        self._validate("FragmentData")
        frag = self.holder.fragment(index, field, view, shard)
        if frag is None:
            raise NotFoundError(
                f"fragment not found: {index}/{field}/{view}/{shard}"
            )
        return roaring.serialize_rows(*frag.snapshot_rows())

    def available_shards_map(self) -> dict:
        """{index: {field: [shards]}} of the shards available cluster-wide
        as this node knows them (reference field.go AvailableShards: local
        and remote)."""
        out: dict = {}
        for iname in self.holder.index_names():
            idx = self.holder.index(iname)
            if idx is None:
                continue
            out[iname] = {
                fname: sorted(idx.field(fname).available_shards())
                for fname in idx.field_names(include_internal=True)
                if idx.field(fname) is not None
            }
        return out

    def merge_available_shards(self, shard_map: dict) -> None:
        """Merge a peer's shard-availability map (reference
        field.go:331-345 AddRemoteAvailableShards)."""
        for iname, fields in (shard_map or {}).items():
            idx = self.holder.index(iname)
            if idx is None:
                continue
            for fname, shards in fields.items():
                field = idx.field(fname)
                if field is not None:
                    field.add_remote_available_shards(shards)

    def fragment_details(
        self, index: str | None = None, field: str | None = None
    ) -> dict:
        """Per-fragment storage and residency introspection, a holder-level
        aggregate, and the device budget block (/debug/fragments)."""
        tracker = residency.default_tracker()
        found = []
        now = time.time()
        for iname in self.holder.index_names():
            if index is not None and iname != index:
                continue
            idx = self.holder.index(iname)
            if idx is None:
                continue
            for fname in idx.field_names(include_internal=True):
                if field is not None and fname != field:
                    continue
                fld = idx.field(fname)
                if fld is None:
                    continue
                for vname in fld.view_names():
                    view = fld.view(vname)
                    found.extend(
                        (iname, fname, vname, shard, view.fragments[shard])
                        for shard in sorted(view.fragments)
                    )
        # the census reads every word of a fragment: on a pool, and cached
        # per fragment version (Fragment.container_profile, which the flight
        # planner reads too) so repeat polls of an unchanged index are cheap
        fragments = list(self._census_pool().map(
            lambda a: self._fragment_detail(*a, tracker, now), found
        ))
        totals = {
            "fragments": len(fragments),
            "bits": sum(f["bits"] for f in fragments),
            "hostBytes": sum(f["hostBytes"] for f in fragments),
            "deviceResident": sum(1 for f in fragments if f["deviceResident"]),
            "deviceBytes": sum(f["deviceBytes"] for f in fragments),
            "opLogLength": sum(f["opLogLength"] for f in fragments),
            "version": sum(f["version"] for f in fragments),
            "pinned": sum(1 for f in fragments if f["pinned"]),
            "staging": sum(
                1 for f in fragments if f["residency"] == residency.STATE_STAGING
            ),
        }
        return {
            "fragments": fragments,
            "totals": totals,
            "device": membudget.default_budget().snapshot(),
            "residency": tracker.snapshot(),
        }

    def _census_pool(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=min(8, os.cpu_count() or 1), thread_name_prefix="census"
                )
            return self._pool

    def _fragment_detail(self, iname, fname, vname, shard, frag, tracker, now) -> dict:
        census = frag.container_profile(containers=True)
        return _fragment_detail_of(frag, census, tracker, now, (iname, fname, vname, shard))

    # -- observability planes -----------------------------------------------

    def events_since(self, since: int = 0, limit: int | None = None) -> dict:
        """This node's event journal past cursor ``since``."""
        return self.holder.events.since(since, limit)

    def _peers(self) -> list:
        """The other members with a known URI (the cluster merges' fan-out)."""
        if self.cluster is None or self.client is None:
            return []
        return [
            n for n in self.cluster.nodes
            if n.id != self.cluster.node_id and n.uri
        ]

    def cluster_events(self, since: int = 0) -> dict:
        """Cluster timeline: every peer's local journal, merged into one
        time-ordered view. An unreachable peer is reported, not fatal: its
        missing events read as missing, the contract of a truncated
        cursor."""
        per_node = [self.holder.events.since(since)["events"]]
        unreachable = []
        for node in self._peers():
            try:
                remote = self.client.debug_events(node.uri, since)
            except Exception as e:
                unreachable.append({"node": node.id, "error": str(e)})
                continue
            per_node.append(remote.get("events", []))
        return {
            "events": ev.merge_timelines(per_node),
            "nodes": len(per_node),
            "unreachable": unreachable,
        }

    def jobs_snapshot(self, kind: str | None = None) -> dict:
        """Background-job records (active + bounded history)."""
        return self.holder.jobs.snapshot(kind)

    def cluster_history(self, series=None, step: float | None = None) -> dict:
        """Cluster-merged metrics history: every peer's local rings merged
        into one wall-clock-aligned timeline. Every node is downsampled onto
        the same absolute ``floor(t/step)*step`` grid (by default the local
        cadence), so the samplers' phases drop out; points nest per node id
        under each series. Unreachable peers are reported, not fatal."""
        step = float(step) if step is not None else (
            self.history.cadence if self.history is not None else 1.0
        )
        local = self.history_query(series=series, step=step)
        merged: dict[str, dict[str, list]] = {}
        nodes: list[str] = []
        unreachable = []

        def fold(node_id: str, snap: dict | None) -> None:
            if not snap:
                return
            nodes.append(node_id)
            for name, pts in snap.get("series", {}).items():
                merged.setdefault(name, {})[node_id] = pts

        local_id = (
            self.cluster.node_id if self.cluster is not None
            else (local or {}).get("node", "")
        )
        fold(local_id, local)
        for node in self._peers():
            try:
                remote = self.client.debug_history(node.uri, series=series, step=step)
            except Exception as e:
                unreachable.append({"node": node.id, "error": str(e)})
                continue
            fold(remote.get("node") or node.id, remote)
        return {
            "cluster": True,
            "step": step,
            "nodes": nodes,
            "series": merged,
            "unreachable": unreachable,
        }

    def qos_snapshot(self) -> dict:
        """Cost-governed admission state (/debug/qos): per-tenant
        weighted-fair queue rows, ladder stages, shed and degraded counts
        and recent transitions (server/qos.py)."""
        if self.qos is None:
            return {"enabled": False, "tenants": {}, "transitions": []}
        return self.qos.snapshot()

    def history_query(
        self,
        series=None,
        since: int | None = None,
        step: float | None = None,
        limit: int | None = None,
    ) -> dict | None:
        """This node's metrics-history window (obs/history.py); None when
        the history plane is disabled."""
        if self.history is None:
            return None
        return self.history.query(
            series=series, since=since, step=step, limit=limit
        )

    def slo_snapshot(self) -> dict:
        """Live per-op-class objective state (/debug/slo)."""
        return self.holder.slo.snapshot()

    def traces_snapshot(self, limit: int = 100) -> dict:
        """This node's kept-trace summaries + store counters."""
        store = self.holder.traces
        return {"traces": store.summaries(limit), "store": store.snapshot()}

    def trace_detail(self, trace_id: str) -> dict | None:
        """One kept trace's spans; None when not kept."""
        return self.holder.traces.detail(trace_id)

    def trace_spans(self, trace_id: str) -> dict:
        """Local spans for one trace id, kept or recent (the peer leg of
        :meth:`cluster_trace`)."""
        return {"spans": self.holder.traces.spans_for(trace_id)}

    def cluster_traces(self, limit: int = 100) -> dict:
        """Kept-trace summaries from every node, merged newest first
        (unreachable peers are reported, not fatal)."""
        per_node = [self.holder.traces.summaries(limit)]
        unreachable = []
        for node in self._peers():
            try:
                remote = self.client.debug_traces(node.uri, limit=limit)
            except Exception as e:
                unreachable.append({"node": node.id, "error": str(e)})
                continue
            per_node.append(remote.get("traces", []))
        merged = [t for traces in per_node for t in traces]
        merged.sort(key=lambda t: t.get("at", 0.0), reverse=True)
        return {
            "traces": merged[:limit],
            "nodes": len(per_node),
            "unreachable": unreachable,
        }

    def cluster_trace(self, trace_id: str) -> dict:
        """One trace assembled cluster-wide: every node's spans under the
        id (kept or merely recent: a fast remote leg of a slow coordinator
        trace lives only in the peer's recent tier), merged into one
        list."""
        spans = list(self.holder.traces.spans_for(trace_id))
        detail = self.holder.traces.detail(trace_id)
        nodes = 1
        unreachable = []
        for node in self._peers():
            try:
                remote = self.client.debug_trace_spans(node.uri, trace_id)
            except Exception as e:
                unreachable.append({"node": node.id, "error": str(e)})
                continue
            spans.extend(remote.get("spans", []))
            nodes += 1
        spans.sort(key=lambda s: (s.get("startUnixMs", 0), s.get("node", "")))
        out = {
            "traceId": trace_id,
            "spans": spans,
            "nodes": nodes,
            "unreachable": unreachable,
        }
        if detail is not None:
            out["summary"] = {k: v for k, v in detail.items() if k != "spans"}
        return out

    # -- fragment internals (reference api.go:590-660 fragment block
    #    endpoints; used by anti-entropy sync and resize) -------------------

    def _fragment(self, index: str, field: str, view: str, shard: int):
        frag = self.holder.fragment(index, field, view, shard)
        if frag is None:
            raise NotFoundError(
                f"fragment not found: {index}/{field}/{view}/{shard}"
            )
        return frag

    def fragment_blocks(self, index: str, field: str, view: str, shard: int) -> dict:
        self._validate("FragmentBlocks")
        return {"blocks": self._fragment(index, field, view, shard).blocks()}

    def _block_pairs(self, req: dict):
        frag = self._fragment(
            req["index"], req["field"], req.get("view", VIEW_STANDARD),
            int(req["shard"]),
        )
        rows, cols = frag.block_data(int(req["block"]))
        return frag, rows, cols

    def fragment_block_data(self, req: dict) -> dict:
        self._validate("FragmentBlockData")
        _frag, rows, cols = self._block_pairs(req)
        return {"rows": rows.tolist(), "cols": cols.tolist()}

    def fragment_block_data_binary(self, req: dict) -> bytes | None:
        """Packed-binary block payload: the block's set bits as a roaring
        blob of row*width+col positions (JAX's wire format). None when a
        row id exceeds the position encoding (the caller answers JSON)."""
        self._validate("FragmentBlockData")
        frag, rows, cols = self._block_pairs(req)
        width = frag.shard_width
        max_row = (2**64 - 1 - (width - 1)) // width
        if len(rows) and int(rows.max()) > max_row:
            return None
        # block_data is row-major, so the positions are already sorted
        positions = rows * np.uint64(width) + cols.astype(np.uint64)
        return roaring.serialize(positions)

    def _attr_store(self, index: str, field: str | None):
        idx = self.holder.index(index)
        if idx is None:
            raise ApiError(f"index not found: {index}", 404)
        if not field:
            return idx.column_attrs
        f = idx.field(field)
        if f is None:
            raise ApiError(f"field not found: {field}", 404)
        return f.row_attrs

    def attr_blocks(self, index: str, field: str | None) -> dict:
        """Attr block checksums for anti-entropy diff (reference
        api.go:590-660; attr.go:81-120)."""
        self._validate("FragmentBlocks")
        store = self._attr_store(index, field)
        return {
            "blocks": [
                {"id": bid, "checksum": chk.hex()}
                for bid, chk in store.blocks()
            ]
        }

    def attr_block_data(self, req: dict) -> dict:
        self._validate("FragmentBlockData")
        store = self._attr_store(req["index"], req.get("field"))
        return {
            "attrs": {
                str(k): v
                for k, v in store.block_data(int(req["block"])).items()
            }
        }

    def fragment_inventory(self) -> list[dict]:
        """Every fragment this node holds, for resize planning (reference
        fragsByHost cluster.go:687)."""
        self._validate("FragmentData")
        out = []
        for iname in self.holder.index_names():
            idx = self.holder.index(iname)
            if idx is None:
                continue
            for fname in idx.field_names(include_internal=True):
                field = idx.field(fname)
                if field is None:
                    continue
                for vname in field.view_names():
                    for shard in sorted(field.view(vname).fragments):
                        out.append(
                            {"index": iname, "field": fname, "view": vname, "shard": shard}
                        )
        return out

    def _apply_roaring(self, index: str, f, shard: int, data: bytes, clear: bool, view: str) -> dict:
        """Local roaring apply on the calling thread, free of the state
        gate: the landing path of a migrated snapshot. The blob decodes
        straight into row words, merged through the fragment's mutators
        (versions, stack patches and the result cache follow)."""
        try:
            row_ids, words, _op_n = roaring.decode_rows(data, f.n_words)
        except roaring.RoaringError as e:
            raise ApiError(f"bad roaring payload: {e}")
        result, _frag = self._apply_roaring_rows(
            index, f, shard, row_ids, words, clear, view
        )
        self.executor.rescache.note_write(index, f.name)
        return result

    def _apply_positions(
        self, index: str, f, shard: int, positions: np.ndarray, clear: bool, view: str
    ) -> int:
        """Merge shard-local positions row*width+col (JAX
        ``_apply_roaring_positions``); the bits it flipped."""
        width = np.uint64(f.n_words * 32)
        rows = positions // width
        cols = (positions % width).astype(np.int64)
        frag = f.create_view_if_not_exists(view).create_fragment_if_not_exists(shard)
        changed = frag.import_bits(rows, cols, clear=clear)
        if view.startswith("bsig_") and f.is_bsi() and len(rows):
            f.grow_bit_depth(int(rows.max()) - BSI_OFFSET_BIT + 1)
        idx = self.holder.index(index)
        ef = idx.existence_field() if idx is not None else None
        if ef is not None and not clear and len(cols):
            ef.import_bits(
                np.zeros(len(cols), dtype=np.uint64),
                cols.astype(np.uint64) + np.uint64(shard) * width,
            )
        self.executor.rescache.note_write(index, f.name)
        return int(changed)

    def resize_fetch(self, req: dict) -> dict:
        """Fetch and install the listed fragments from their source nodes
        (reference followResizeInstruction cluster.go:1272-1381)."""
        self._validate("FragmentData")
        if self.client is None:
            raise ApiError("no internal client configured", 500)
        if req.get("schema"):
            # a joining node installs the schema before any fragment lands
            # (reference cluster.go:1304-1323)
            self.holder.apply_schema(req["schema"])
            self._sync()
        instructions = req.get("instructions", [])
        job = self.holder.jobs.start("resize-fetch")
        job.set_phase("fetch")
        job.set_progress(fragments_total=len(instructions))
        fetched = 0
        try:
            for ins in instructions:
                index, fname = ins["index"], ins["field"]
                f = self.holder.field(index, fname)
                if f is None:
                    raise ApiError(
                        f"resize target missing schema for {index}/{fname}", 500
                    )
                data = self.client.retrieve_fragment(
                    ins["sourceURI"], index, fname, ins["view"], int(ins["shard"])
                )
                self._apply_roaring(index, f, int(ins["shard"]), data, False, ins["view"])
                fetched += 1
                job.advance(fragments_done=1, bytes_moved=len(data))
        except Exception as e:
            job.finish("aborted", error=f"{type(e).__name__}: {e}")
            raise
        job.finish("done")
        return {"fetched": fetched}

    # -- online migration (snapshot stream + op-log catch-up) ---------------
    #
    # Per-fragment migration for the online resize (cluster/resize.py):
    # the target pulls a pinned snapshot cut in resumable chunks
    # (ChunkPrefetcher overlaps the fetch with the apply), then replays
    # op-log deltas in bounded catch-up rounds while writes keep landing
    # on the source. Sessions stay open on the source until the post-flip
    # finalize drain. ``faults.stage_fault`` hooks mark every phase
    # boundary, so chaos tests can kill any participant at any point.

    _CATCHUP_ROUNDS = 5
    _SOURCE_ATTEMPTS = 3
    # pulls (and finalize drains) of one instruction list run at once
    _PULL_WORKERS = 8

    def _migration(self, token: str):
        try:
            return self.migrations.get(token)
        except KeyError as e:
            raise NotFoundError(str(e))

    def migrate_begin(self, req: dict) -> dict:
        """Source side: open a migration session: pin a snapshot cut and
        install the op-log delta tap (cluster/migration.py)."""
        self._validate("FragmentData")
        faults.stage_fault("source:begin")
        index, field = req["index"], req["field"]
        view = req.get("view", VIEW_STANDARD)
        shard = int(req["shard"])
        frag = self._fragment(index, field, view, shard)
        session = self.migrations.begin(frag, (index, field, view, shard))
        session.chunk_bytes = int(req.get("chunkBytes") or 0) or None
        store = frag.store
        return {
            "token": session.token,
            "size": session.size,
            "opN": int(getattr(store, "op_n", 0)),
        }

    def migrate_chunk(self, token: str, offset: int) -> bytes:
        """Source side: one snapshot chunk. Offset-addressed reads are
        idempotent, so a retried or restarted target resumes mid-stream."""
        self._validate("FragmentData")
        faults.stage_fault("source:chunk")
        session = self._migration(token)
        return session.chunk(int(offset), session.chunk_bytes or migration.CHUNK_BYTES)

    def migrate_delta(self, token: str) -> bytes:
        """Source side: drain one op-log catch-up round as a binary migrate
        frame (its header carries the ops in the blob and those pending)."""
        self._validate("FragmentData")
        faults.stage_fault("source:delta")
        session = self._migration(token)
        blob, count, pending = session.delta()
        return wire.encode_migrate_frame({"ops": count, "pending": pending}, blob)

    def migrate_end(self, token: str) -> dict:
        """Source side: close a session (uninstalls the delta tap)."""
        self._validate("FragmentData")
        self.migrations.end(token)
        return {}

    def migrate_fetch(self, req: dict) -> dict:
        """Target side: pull every listed fragment (snapshot stream and
        catch-up rounds) and HOLD the source sessions open; the
        coordinator flips ownership, then ``migrate_finalize`` drains the
        tail. A crash here aborts only this target's instructions; its held
        source sessions expire through the registry's TTL."""
        self._validate("FragmentData")
        if self.client is None:
            raise ApiError("no internal client configured", 500)
        if req.get("schema"):
            self.holder.apply_schema(req["schema"])
            self._sync()
        instructions = req.get("instructions", [])
        job = self.holder.jobs.start("migrate-fetch", fragments=len(instructions))
        job.set_phase("snapshot")
        job.set_progress(fragments_total=len(instructions))

        def pull(ins):
            p = self._migrate_pull(ins, job)
            job.advance(fragments_done=1)
            return p

        # a shard's fragments are pulled at once (JAX pulls them in turn):
        # each pull waits mostly on its source's answers
        pulls, failure = [], None
        with ThreadPoolExecutor(
            max_workers=max(1, min(self._PULL_WORKERS, len(instructions)))
        ) as workers:
            for fut in [workers.submit(pull, ins) for ins in instructions]:
                try:
                    pulls.append(fut.result())
                except Exception as e:  # the first failure is raised below
                    failure = failure or e
        if failure is not None:
            for p in pulls:
                try:
                    self.client.migrate_end(p["uri"], p["token"])
                except Exception:  # graftlint: disable=exception-hygiene -- best-effort cleanup of held source sessions; the TTL sweep covers the rest
                    pass
            job.finish("aborted", error=f"{type(failure).__name__}: {failure}")
            raise failure
        with self._migrate_lock:
            for p in pulls:
                self._migrate_pulls[p["key"]] = p
        job.finish("done")
        return {"fetched": len(pulls)}

    def _migrate_pull(self, ins: dict, job) -> dict:
        """Pull one fragment, trying each listed source holder in turn (a
        dead source retries with seeded backoff, then the next replica
        takes over)."""
        index, fname = ins["index"], ins["field"]
        view = ins.get("view", VIEW_STANDARD)
        shard = int(ins["shard"])
        f = self.holder.field(index, fname)
        if f is None:
            raise ApiError(f"migrate target missing schema for {index}/{fname}", 500)
        sources = list(ins.get("sourceURIs") or [])
        if ins.get("sourceURI") and ins["sourceURI"] not in sources:
            sources.append(ins["sourceURI"])
        if not sources:
            raise ApiError(f"no source for {index}/{fname}/{shard}", 500)
        chunk_bytes = int(ins.get("chunkBytes") or migration.CHUNK_BYTES)
        # seeded by the fragment key: a chaos run's retry cadence replays
        # identically (testing/faults.py contract)
        rng = random.Random(zlib.crc32(f"{index}/{fname}/{view}/{shard}".encode()))
        last_err: Exception | None = None
        for uri in sources:
            for attempt in range(self._SOURCE_ATTEMPTS):
                try:
                    return self._migrate_pull_from(
                        uri, index, f, view, shard, chunk_bytes, job
                    )
                except (ClientError, OSError) as e:
                    last_err = e
                    if attempt < self._SOURCE_ATTEMPTS - 1:
                        time.sleep(0.05 * (2 ** attempt) * (0.5 + rng.random()))
            logger.warning(
                "migrate pull of %s/%s/%s/%s from %s failed: %s",
                index, fname, view, shard, uri, last_err,
            )
        raise ApiError(
            f"migrate pull failed from every source for "
            f"{index}/{fname}/{view}/{shard}: {last_err}", 500
        )

    def _migrate_pull_from(
        self, uri: str, index: str, f, view: str, shard: int, chunk_bytes: int, job,
    ) -> dict:
        begin = self.client.migrate_begin(
            uri, index, f.name, view, shard, chunk_bytes=chunk_bytes
        )
        token, size = begin["token"], int(begin["size"])
        try:
            buf = bytearray()
            pf = ChunkPrefetcher(
                lambda off: self.client.migrate_chunk(uri, token, off),
                size=size, chunk_bytes=chunk_bytes,
            )
            try:
                for _off, blob in pf:
                    buf += blob
                    job.advance(bytes_moved=len(blob))
            finally:
                pf.close()
            faults.stage_fault("target:apply")
            self.holder.stats.count("migrate_snapshot_bytes", len(buf))
            if buf:
                self._apply_roaring(index, f, shard, bytes(buf), False, view)
            # bounded catch-up: writes kept landing on the source during the
            # snapshot stream; replay the accrued op-log delta until the lag
            # reaches zero (or the rounds run out: the post-flip finalize
            # drain is the backstop either way)
            job.set_phase("catch-up")
            lag = 0
            for _round in range(self._CATCHUP_ROUNDS):
                faults.stage_fault("target:catchup")
                header, blob = self.client.migrate_delta(uri, token)
                if blob:
                    self._apply_delta_ops(index, f, shard, view, blob)
                lag = int(header.get("pending", 0))
                job.annotate(catchup_lag=lag, catchup_ops=int(header.get("ops", 0)))
                if lag == 0:
                    break
            return {
                "key": (index, f.name, view, shard),
                "uri": uri,
                "token": token,
                "lag": lag,
            }
        except Exception:
            try:
                self.client.migrate_end(uri, token)
            except Exception:  # graftlint: disable=exception-hygiene -- cleanup of a failed pull; the session TTL covers an unreachable source
                pass
            raise

    def _apply_delta_ops(self, index: str, f, shard: int, view: str, blob: bytes) -> int:
        """Replay raw op-log records IN ORDER onto the local fragment, the
        catch-up half of migration. In-order replay makes an overlap with
        the snapshot cut harmless: the same ops apply in the order the
        source applied them, and set and clear are idempotent."""
        applied = 0
        for op_type, payload, _opn in roaring.decode_ops(blob, 0):
            if op_type in (roaring.OP_ADD, roaring.OP_REMOVE):
                positions = np.array([payload], dtype=np.uint64)
            elif op_type in (roaring.OP_ADD_BATCH, roaring.OP_REMOVE_BATCH):
                positions = np.asarray(payload, dtype=np.uint64)
            else:
                positions = roaring.deserialize(payload)
            if not len(positions):
                continue
            clear = op_type in (
                roaring.OP_REMOVE, roaring.OP_REMOVE_BATCH, roaring.OP_REMOVE_ROARING,
            )
            self._apply_positions(index, f, shard, positions, clear, view)
            applied += 1
        return applied

    def migrate_finalize(self, req: dict) -> dict:
        """Target side, after the flip: drain the final op-log delta from
        each held source session and close it. An unreachable source is
        not fatal: anti-entropy heals whatever tail it buffered."""
        self._validate("FragmentData")
        instructions = req.get("instructions")
        with self._migrate_lock:
            if instructions is None:
                pulls = list(self._migrate_pulls.values())
                self._migrate_pulls.clear()
            else:
                pulls = []
                for ins in instructions:
                    key = (
                        ins["index"], ins["field"],
                        ins.get("view", VIEW_STANDARD), int(ins["shard"]),
                    )
                    p = self._migrate_pulls.pop(key, None)
                    if p is not None:
                        pulls.append(p)
        def drain(p) -> int:
            faults.stage_fault("target:finalize")
            index, fname, view, shard = p["key"]
            f = self.holder.field(index, fname)
            try:
                _header, blob = self.client.migrate_delta(p["uri"], p["token"])
                n = 0
                if blob and f is not None:
                    n = self._apply_delta_ops(index, f, int(shard), view, blob)
                self.client.migrate_end(p["uri"], p["token"])
                return n
            except (ClientError, OSError) as e:
                logger.warning(
                    "finalize drain of %s from %s failed (anti-entropy"
                    " heals the tail): %s", p["key"], p["uri"], e,
                )
                return 0

        with ThreadPoolExecutor(max_workers=max(1, min(self._PULL_WORKERS, len(pulls)))) as w:
            drained = sum(w.map(drain, pulls))
        return {"finalized": len(pulls), "ops": drained}

    def _clean_unowned_fragments(self) -> int:
        """Drop the fragments this node no longer owns after a membership
        change (reference holderCleaner holder.go:898-926). Each device
        copy leaves through the residency manager and the budget
        (``View.drop_fragment``); the stacks and partials built over the
        old shard sets go with them."""
        if self.cluster is None:
            return 0
        dropped = 0
        for iname in self.holder.index_names():
            idx = self.holder.index(iname)
            if idx is None:
                continue
            for fname in idx.field_names(include_internal=True):
                field = idx.field(fname)
                if field is None:
                    continue
                for vname in field.view_names():
                    view = field.view(vname)
                    for shard in sorted(view.fragments):
                        if not self.cluster.owns_shard(self.cluster.node_id, iname, shard):
                            view.drop_fragment(shard)
                            if self.store is not None:
                                self.store.delete_fragment(iname, fname, vname, shard)
                            dropped += 1
        if dropped:
            self._forget_topology()
        return dropped

    def _forget_topology(self) -> None:
        """Release what was built for the old placement: the local
        executor's stacks and partials, and the distributed executor's
        facade executors and plans (a facade keyed on the old owners would
        hold its stacks on the card until the cache's LRU reached it)."""
        self.executor.release_stacks()
        self.executor.rescache.clear()
        if self.dist is not None:
            self.dist.forget_placement()


    # -- peer messages (reference server.go:549-643 receiveMessage) --------

    def receive_message(self, msg: dict) -> dict:
        """Apply a typed control-plane message from a peer. The handlers
        call the ``_``-prefixed internals: a cluster message must apply
        even where this node's own state gates the public method (a peer
        in STARTING taking the coordinator's schema). The resize
        protocol's messages (prepare, epoch flip, cancel, and the
        membership commit: a cluster status with ``nodes``) move this
        node's placement as JAX's do; an unknown type answers 400."""
        self._validate("ClusterMessage")
        t = msg.get("type")
        if t == bc.MSG_CREATE_INDEX:
            try:
                self._create_index(msg["index"], msg.get("options"), broadcast=False)
            except ConflictError:
                pass
        elif t == bc.MSG_DELETE_INDEX:
            try:
                self._delete_index(msg["index"], broadcast=False)
            except NotFoundError:
                pass
        elif t == bc.MSG_CREATE_FIELD:
            if self.holder.index(msg["index"]) is not None:
                try:
                    self._create_field(
                        msg["index"], msg["field"], msg.get("options"),
                        broadcast=False,
                    )
                except ConflictError:
                    pass
        elif t == bc.MSG_DELETE_FIELD:
            try:
                self._delete_field(msg["index"], msg["field"], broadcast=False)
            except NotFoundError:
                pass
        elif t == bc.MSG_CREATE_VIEW:
            f = self.holder.field(msg["index"], msg["field"])
            if f is not None:
                f.create_view_if_not_exists(msg["view"])
        elif t == bc.MSG_DELETE_VIEW:
            f = self.holder.field(msg["index"], msg["field"])
            if f is not None:
                f.delete_view(msg["view"])
        elif t == bc.MSG_CREATE_SHARD:
            f = self.holder.field(msg["index"], msg["field"])
            if f is not None:
                f.add_remote_available_shards([int(msg["shard"])])
        elif t == bc.MSG_CLUSTER_STATUS:
            self._apply_cluster_status(msg)
        elif t == bc.MSG_RESIZE_PREPARE:
            # per-fragment migration begins: remember the PENDING
            # membership and epoch, so flips route flipped shards onto the
            # new ring while the rest stays put; the cluster state stays
            # NORMAL, so reads and writes keep flowing
            if self.cluster is not None:
                pending = [
                    ClusterNode(id=n["id"], uri=n.get("uri", ""))
                    for n in msg.get("nodes", [])
                ]
                epoch = self.cluster.begin_resize(pending, msg.get("epoch"))
                self.holder.events.record(
                    ev.EVENT_RESIZE_PHASE, phase="prepare", epoch=epoch
                )
        elif t == bc.MSG_EPOCH_FLIP:
            # one shard's ownership flips to the pending ring
            if self.cluster is not None and self.cluster.flip_shard(
                msg["index"], int(msg["shard"]), msg.get("epoch")
            ):
                self.holder.events.record(
                    ev.EVENT_EPOCH_FLIP, index=msg["index"],
                    shard=int(msg["shard"]), epoch=msg.get("epoch"),
                )
                self._forget_placement()
        elif t == bc.MSG_RESIZE_CANCEL:
            if self.cluster is not None:
                self.cluster.abort_resize()
                self.holder.events.record(
                    ev.EVENT_RESIZE_ABORT, reason=msg.get("reason", "")
                )
                self._forget_placement()
        elif t in (bc.MSG_NODE_STATE, bc.MSG_NODE_EVENT):
            # a node event carries a node and its state as the membership
            # monitor's broadcast does; one without them changes nothing
            if self.cluster is not None and msg.get("node") and msg.get("state"):
                self.cluster.mark_node_state(msg["node"], msg["state"])
        elif t in (bc.MSG_SET_COORDINATOR, bc.MSG_UPDATE_COORDINATOR):
            # the coordinator, and with it the translation primary, moved
            # (reference SetCoordinatorMessage, server.go:549-643)
            if self.cluster is not None and msg.get("coordinator"):
                self.cluster.coordinator_id = msg["coordinator"]
                for n in self.cluster.nodes:
                    n.is_coordinator = n.id == msg["coordinator"]
        elif t in (bc.MSG_RESIZE_INSTRUCTION, bc.MSG_RESIZE_COMPLETE):
            # the reference's resize job messages: the online resize sends
            # its instructions as migrate calls instead, and JAX's node
            # accepts these without effect, as this one does
            pass
        elif t == bc.MSG_RECALCULATE_CACHES:
            pass  # row counts are exact and maintained: nothing to rebuild
        else:
            raise ApiError(f"unknown cluster message type: {t!r}")
        return {}

    def _apply_cluster_status(self, msg: dict) -> None:
        """A cluster status; with ``nodes`` it is the resize coordinator's
        membership commit (reference mergeClusterStatus
        cluster.go:1918-1978), after which each member drops what it no
        longer owns."""
        if self.cluster is None:
            if msg.get("availableShards"):
                self.merge_available_shards(msg["availableShards"])
            return
        nodes = msg.get("nodes")
        if nodes:
            if msg.get("coordinator"):
                self.cluster.coordinator_id = msg["coordinator"]
            self.cluster.disabled = False
            old_ids = {n.id for n in self.cluster.nodes}
            new_ids = {n["id"] for n in nodes}
            for nid in sorted(new_ids - old_ids):
                self.holder.events.record(ev.EVENT_NODE_JOIN, peer=nid)
            for nid in sorted(old_ids - new_ids):
                self.holder.events.record(ev.EVENT_NODE_LEAVE, peer=nid)
            self.cluster.set_static(
                [ClusterNode(id=n["id"], uri=n.get("uri", "")) for n in nodes]
            )
            self._forget_placement()
            if self.dist is not None:
                self.dist.note_membership()
        self.cluster.set_state(msg["state"])
        if msg.get("availableShards"):
            self.merge_available_shards(msg["availableShards"])
        still_member = not nodes or any(n["id"] == self.cluster.node_id for n in nodes)
        if (
            nodes and msg["state"] == STATE_NORMAL and still_member
            and not msg.get("deferCleanup")
        ):
            # a removed node keeps its data (the reference expects it to
            # shut down; its fragments were re-sourced). A port coordinator
            # sends the commit twice and the drop waits for the second,
            # when every member routes on the new ring (cluster/resize.py)
            self._clean_unowned_fragments()

    def _forget_placement(self) -> None:
        """The shard -> owner map moved: the distributed executor's facade
        executors and plans were built for the old owners."""
        if self.dist is not None:
            self.dist.forget_placement()

    # -- resize (reference api.go:1192-1256) --------------------------------

    def resize_abort(self) -> dict:
        """Abort or clear a resize: re-commit the CURRENT membership with
        state NORMAL on every reachable node (reference api.go:1249
        ResizeAbort); the operator's recovery from a coordinator that died
        mid-resize. Valid only on the coordinator."""
        self._validate("ResizeAbort")
        if self.cluster is None:
            raise ApiError("cluster not configured", 400)
        if not self.cluster.is_coordinator:
            raise ApiError("resize-abort must run on the coordinator", 400)
        from pilosa_tpu_torch.cluster.resize import ResizeCoordinator

        rc = ResizeCoordinator(self.cluster, self.client, self)
        nodes = list(self.cluster.nodes)
        rc._commit_membership(nodes, nodes)
        # the operator abandoned the interrupted plan: drop the journal, so
        # a later resume() cannot replay a dead resize
        rc._delete_journal()
        return {"aborted": True}

    def resize_remove_node(self, node_id: str) -> dict:
        """Remove a node through the resize protocol (reference
        api.go:1214 RemoveNode). Valid only on the coordinator."""
        self._validate("RemoveNode")
        if self.cluster is None:
            raise ApiError("cluster not configured", 400)
        if not self.cluster.is_coordinator:
            raise ApiError("remove-node must run on the coordinator", 400)
        if self.cluster.node(node_id) is None:
            raise ApiError(f"unknown node: {node_id}", 400)
        from pilosa_tpu_torch.cluster.resize import ResizeCoordinator, ResizeError

        try:
            ResizeCoordinator(self.cluster, self.client, self).remove_node(node_id)
        except ResizeError as e:
            raise ApiError(str(e), 400)
        return {"removed": node_id}

    def resize_resume(self) -> dict:
        """Resume an interrupted resize from the persisted journal.
        Valid only on the coordinator."""
        if self.cluster is None:
            raise ApiError("cluster not configured", 400)
        if not self.cluster.is_coordinator:
            raise ApiError("resize-resume must run on the coordinator", 400)
        from pilosa_tpu_torch.cluster.resize import ResizeCoordinator, ResizeError

        try:
            return ResizeCoordinator(self.cluster, self.client, self).resume()
        except ResizeError as e:
            raise ApiError(str(e), 400)

    def set_coordinator(self, node_id: str) -> dict:
        """Move the coordinator (and with it the translation primary) to
        ``node_id`` and broadcast it (reference api.go:1192-1256). Used for
        a takeover after a dead coordinator: any surviving node accepts
        this call."""
        if self.cluster is None:
            raise ApiError("cluster not configured", 400)
        if self.cluster.node(node_id) is None:
            raise ApiError(f"unknown node: {node_id}", 400)
        self.cluster.coordinator_id = node_id
        for n in self.cluster.nodes:
            n.is_coordinator = n.id == node_id
        if self.broadcaster is not None:
            try:
                self.broadcaster.send_sync(
                    {"type": bc.MSG_SET_COORDINATOR, "coordinator": node_id}
                )
            except Exception:
                # best effort: a takeover runs BECAUSE a node is dead; the
                # survivors converged, and the dead node relearns the
                # coordinator from a cluster status when it rejoins
                logger.warning("set-coordinator broadcast incomplete", exc_info=True)
        return {"coordinator": node_id}

    # -- key translation ----------------------------------------------------

    def translate_keys(self, index: str, field: str | None, keys: list[str]) -> list[int]:
        self._validate("TranslateKeys")
        return self.executor.translator.translate_keys(index, field or "", keys)

    def translate_ids(self, index: str, field: str | None, ids: list[int]) -> list[str]:
        self._validate("TranslateKeys")
        return self.executor.translator.translate_ids(index, field or "", ids)

    def translate_log(self, offset: int) -> dict:
        """The entry log since ``offset`` of the local store, and its
        length, for a replica's streaming pull (reference
        translate.go:91-97; a replica detects a restarted, shorter primary
        log by the length)."""
        self._validate("TranslateKeys")
        translator = self.executor.translator
        local = getattr(translator, "local", translator)
        entries, new_offset = local.log_entries(int(offset))
        return {
            "entries": [list(e) for e in entries],
            "offset": new_offset,
            "len": local.log_len(),
        }

    def translate_restore(self, entries: list) -> dict:
        """Install exact (index, field, key, id) mappings, the restore half
        of a backup's translation dump. In a cluster the restore goes to
        the translation primary: only its store allocates new ids, so a
        replica installing alone would let the primary allocate colliding
        ids; replicas then converge by the log pull."""
        self._validate("TranslateKeys")
        translator = self.executor.translator
        if (
            self.cluster is not None
            and self.client is not None
            and hasattr(translator, "_is_primary")
            and not translator._is_primary()
        ):
            primary = self.cluster.translate_primary()
            return self.client.translate_restore(primary.uri, entries)
        local = getattr(translator, "local", translator)
        for index, field, key, id_ in entries:
            local.set_mapping(index, field, [key], [int(id_)])
        return {"restored": len(entries)}

    # -- incident plane (flight recorder, /debug/incidents) -----------------

    def incidents_snapshot(self) -> dict:
        if self.flightrec is None:
            return {"enabled": False, "incidents": []}
        return self.flightrec.incidents_snapshot()

    def incident_detail(self, incident_id: str) -> dict | None:
        if self.flightrec is None:
            return None
        return self.flightrec.incident_detail(incident_id)

    # -- postmortem plane (black box, /debug/postmortem) --------------------

    def postmortem_snapshot(self, postmortem_id: str | None = None) -> dict | None:
        """Sealed crash bundles from this node's black box: the retained
        summaries and the newest bundle in full, or one bundle by id. None
        when the black box is disabled (no data dir) or the id is
        unknown."""
        if self.blackbox is None:
            return None
        if postmortem_id is not None:
            return self.blackbox.postmortem_detail(postmortem_id)
        return self.blackbox.postmortems()

    def cluster_postmortems(self) -> dict:
        """Every node's postmortem summaries, merged newest first
        (unreachable peers are reported, not fatal). A full bundle stays
        one ``?id=`` GET away on the node that owns it."""
        local_id = self.cluster.node_id if self.cluster is not None else ""
        local = self.postmortem_snapshot() or {"postmortems": []}
        merged = [
            dict(s, node=s.get("node") or local_id)
            for s in local.get("postmortems", [])
        ]
        nodes = 1
        unreachable = []
        for node in self._peers():
            try:
                remote = self.client.debug_postmortem(node.uri)
            except Exception as e:
                unreachable.append({"node": node.id, "error": str(e)})
                continue
            nodes += 1
            for s in remote.get("postmortems", []):
                merged.append(dict(s, node=s.get("node") or node.id))
        merged.sort(key=lambda s: s.get("assembledAt") or 0.0, reverse=True)
        return {
            "cluster": True,
            "postmortems": merged,
            "nodes": nodes,
            "unreachable": unreachable,
        }

    # -- lifecycle ------------------------------------------------------------

    def _node_id(self) -> str:
        if self.store is not None:
            return self.store.node_id()
        return "local"

    def _sync(self) -> None:
        if self.store is not None:
            self.store.sync()

    def close(self) -> None:
        self.migrations.close()  # detaches any live delta taps
        if self.dist is not None:
            self.dist.close()
        if self.batcher is not None:
            self.batcher.close()  # drains the admission queue first
        self.ingest.close()  # flushes pending device uploads
        self.import_pool.close()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
        if self.store is not None:
            self.store.close()


def _timestamps(timestamps: list) -> np.ndarray:
    """JSON timestamps (PQL time strings or unix seconds; empty for none)
    as ``datetime64[s]`` (NaT for none), the fast form of
    ``Field.import_bits``: each distinct value parsed once."""
    nat = np.datetime64("NaT", "s").astype(np.int64)
    seconds: dict = {}

    def one(t):
        if not t:
            return nat
        v = seconds.get(t)
        if v is None:
            v = seconds[t] = np.datetime64(timequantum.parse_time(t), "s").astype(np.int64)
        return v

    return np.fromiter(map(one, timestamps), dtype=np.int64, count=len(timestamps)).view(
        "datetime64[s]"
    )


def _fragment_detail_of(frag, census, tracker, now, names) -> dict:
    """One /debug/fragments row: storage shape (``census``: bits and the
    roaring container census of the host mirror), op-log length, and
    device residency."""
    iname, fname, vname, shard = names
    with frag._lock:
        host_bytes = frag._host.nbytes
        device_resident = frag._device is not None
        device_bytes = frag._device_nbytes() if device_resident else 0
        counts_cached = frag._counts is not None
        mut_version = frag.version
        mut_epoch = frag.epoch
        res_state = tracker.state_of(frag)
        res_pinned = frag._res_pinned
        res_heat = round(tracker.heat_of(frag), 3)
    store = frag.store
    last_snap = getattr(store, "last_snapshot_at", None)
    return {
        "index": iname,
        "field": fname,
        "view": vname,
        "shard": shard,
        "rows": census["rows"],
        "bits": census["bits"],
        "containers": census["containers"],
        "hostBytes": host_bytes,
        "deviceResident": device_resident,
        "deviceBytes": device_bytes,
        "countsCached": counts_cached,
        "opLogLength": getattr(store, "op_n", 0) if store is not None else 0,
        # never resets: the fragment's mutation counter, fenced by its
        # process-unique epoch (the cache-correctness pair)
        "version": mut_version,
        "epoch": mut_epoch,
        "residency": res_state,
        "pinned": res_pinned,
        "heat": res_heat,
        "lastSnapshotAge": now - last_snap if last_snap else None,
    }
