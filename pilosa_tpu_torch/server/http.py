"""HTTP transport of one node (counterpart of ``pilosa_tpu/server/http.py``;
reference: http/handler.go).

Route surface (reference handler.go:276-314):

    GET  /  /version  /status  /info  /schema      POST /schema
    GET  /metrics  /debug  /debug/vars  /debug/history  /debug/slo
         /debug/qos  /debug/slow-queries  /debug/threads  /debug/profile
         /debug/memory  /debug/events  /debug/traces  /debug/incidents
         /debug/postmortem  /debug/devcosts  /debug/jobs  /debug/fragments
         /internal/diagnostics
    POST /index/{index}                  create index (GET, DELETE)
    POST /index/{index}/query            PQL body -> {"results": [...]};
         a JSON envelope {"query", "shards", "remote", "profile"}, and
         with "remote" (a peer's fan-out leg) -> {"wireResults": [...]}
    POST /index/{index}/field/{field}    create field (GET, DELETE)
    POST /index/{index}/field/{field}/import    JSON batch, or the binary
         PTI1 body a peer forwards (cluster/wire.py)
    POST /index/{index}/field/{field}/import-roaring/{shard}  binary roaring
         (?remote=true: apply here, do not route to the replicas)
    GET  /export?index=&field=[&shard=]  CSV
    GET  /internal/shards/max  /internal/fragment/data  /internal/nodes
         /internal/translate/log  /internal/fragments
         /internal/fragment/blocks  /internal/attr/blocks
         /internal/migrate/chunk
    POST /internal/translate/keys  /internal/translate/ids
         /internal/translate/restore  /internal/cluster/message
         /recalculate-caches  /internal/fragment/block/data
         /internal/attr/block/data  /internal/resize/fetch
         /internal/migrate/{begin,delta,end,fetch,finalize}
    POST /cluster/resize/{set-coordinator,abort,remove-node,resume}

``?cluster=true`` on /debug/events, /debug/traces, /debug/history and
/debug/postmortem merges every peer's answer. Every other path answers
404. A query shed by the QoS governor answers 429 with Retry-After.

JSON replaces the reference's protobuf codec as the wire format; the
roaring import payload is binary-compatible with reference clients.
"""

from __future__ import annotations

import gzip as gzip_mod
import json
import logging
import math
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from pilosa_tpu_torch import __version__, deadline
from pilosa_tpu_torch.cluster import wire
from pilosa_tpu_torch.core import membudget, residency, translate
from pilosa_tpu_torch.deadline import DeadlineExceeded
from pilosa_tpu_torch.exec.result import response_json
from pilosa_tpu_torch.obs import devledger, slo, sysinfo, tracestore, tracing
from pilosa_tpu_torch.obs.stats import prometheus_text
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.server.api import API, ApiError
from pilosa_tpu_torch.server.qos import ShedError

logger = logging.getLogger(__name__)

# SLO op class by route, for routes whose class is knowable from the
# path alone; query routes are classified by the API layer (it has the
# parsed call tree) via slo.note_class, which takes precedence.
_SLO_ROUTE_CLASS = {
    "query": slo.OP_READ_OTHER,
    "import_": slo.OP_IMPORT,
    "import_roaring": slo.OP_IMPORT,
    "translate_keys": slo.OP_TRANSLATE,
    "translate_ids": slo.OP_TRANSLATE,
}

# GET /debug discoverability index: every registered debug surface with
# a one-line description (there are 10+ — nobody remembers them all).
_DEBUG_ENDPOINTS: list[tuple[str, str]] = [
    ("/debug/vars",
     "expvar-style dump: counters, histograms, kernels, device budget"),
    ("/debug/history",
     "ring-buffer metrics history (?series=glob&since=&step=&cluster=true)"),
    ("/debug/slo",
     "per-op-class latency quantiles, error budgets, burn-rate alerts"),
    ("/debug/qos",
     "cost-governed admission: per-tenant queues, shed/degrade ladder"),
    ("/debug/events",
     "typed cluster event journal (?since= cursor, ?cluster=true merge)"),
    ("/debug/traces",
     "tail-sampled trace store (?id= spans, ?cluster=true assembly)"),
    ("/debug/incidents",
     "flight-recorder bundles: alert edges, 504 spikes, trend incidents"),
    ("/debug/postmortem",
     "sealed crash bundles from the black box (?id=, ?cluster=true merge)"),
    ("/debug/devcosts",
     "device cost ledger: launches, device ms, transfers per site+tenant"),
    ("/debug/slow-queries",
     "bounded worst-offender log with full execution profiles"),
    ("/debug/jobs", "background-job progress: import drains"),
    ("/debug/fragments",
     "per-fragment container stats, op-log length, device residency"),
    ("/debug/threads", "per-thread stack dump"),
    ("/debug/profile",
     "sampled CPU profile, flamegraph-collapsed (?seconds=&interval_ms=)"),
    ("/debug/memory", "RSS, host mirror bytes, device budget, GC state"),
]

_ROUTES: list[tuple[str, re.Pattern, str]] = [
    ("GET", re.compile(r"^/$"), "root"),
    ("GET", re.compile(r"^/version$"), "version"),
    ("GET", re.compile(r"^/status$"), "status"),
    ("GET", re.compile(r"^/info$"), "info"),
    ("GET", re.compile(r"^/schema$"), "get_schema"),
    ("POST", re.compile(r"^/schema$"), "post_schema"),
    ("GET", re.compile(r"^/metrics$"), "metrics"),
    ("GET", re.compile(r"^/debug$"), "debug_index"),
    ("GET", re.compile(r"^/debug/vars$"), "debug_vars"),
    ("GET", re.compile(r"^/debug/history$"), "debug_history"),
    ("GET", re.compile(r"^/debug/slo$"), "debug_slo"),
    ("GET", re.compile(r"^/debug/qos$"), "debug_qos"),
    ("GET", re.compile(r"^/debug/slow-queries$"), "debug_slow_queries"),
    ("GET", re.compile(r"^/debug/threads$"), "debug_threads"),
    ("GET", re.compile(r"^/debug/profile$"), "debug_profile"),
    ("GET", re.compile(r"^/debug/memory$"), "debug_memory"),
    ("GET", re.compile(r"^/debug/events$"), "debug_events"),
    ("GET", re.compile(r"^/debug/traces$"), "debug_traces"),
    ("GET", re.compile(r"^/debug/incidents$"), "debug_incidents"),
    ("GET", re.compile(r"^/debug/postmortem$"), "debug_postmortem"),
    ("GET", re.compile(r"^/debug/devcosts$"), "debug_devcosts"),
    ("GET", re.compile(r"^/debug/jobs$"), "debug_jobs"),
    ("GET", re.compile(r"^/debug/fragments$"), "debug_fragments"),
    ("GET", re.compile(r"^/internal/diagnostics$"), "diagnostics"),  # graftlint: disable=dispatch-parity -- operator debug endpoint (curl/monitoring), never called node-to-node
    ("GET", re.compile(r"^/export$"), "export"),
    ("POST", re.compile(r"^/index/(?P<index>[^/]+)/query$"), "query"),
    ("POST", re.compile(r"^/index/(?P<index>[^/]+)/field/(?P<field>[^/]+)/import$"), "import_"),
    ("POST", re.compile(r"^/index/(?P<index>[^/]+)/field/(?P<field>[^/]+)/import-roaring/(?P<shard>\d+)$"), "import_roaring"),
    ("POST", re.compile(r"^/index/(?P<index>[^/]+)/field/(?P<field>[^/]+)$"), "create_field"),
    ("GET", re.compile(r"^/index/(?P<index>[^/]+)/field/(?P<field>[^/]+)$"), "get_field"),
    ("DELETE", re.compile(r"^/index/(?P<index>[^/]+)/field/(?P<field>[^/]+)$"), "delete_field"),
    ("POST", re.compile(r"^/index/(?P<index>[^/]+)$"), "create_index"),
    ("GET", re.compile(r"^/index/(?P<index>[^/]+)$"), "get_index"),
    ("DELETE", re.compile(r"^/index/(?P<index>[^/]+)$"), "delete_index"),
    ("GET", re.compile(r"^/internal/shards/max$"), "shards_max"),
    ("POST", re.compile(r"^/internal/translate/keys$"), "translate_keys"),
    ("POST", re.compile(r"^/internal/translate/ids$"), "translate_ids"),
    ("GET", re.compile(r"^/internal/translate/log$"), "translate_log"),
    ("POST", re.compile(r"^/internal/translate/restore$"), "translate_restore"),
    ("POST", re.compile(r"^/internal/cluster/message$"), "cluster_message"),
    ("GET", re.compile(r"^/internal/nodes$"), "nodes"),
    ("POST", re.compile(r"^/recalculate-caches$"), "recalculate_caches"),
    ("GET", re.compile(r"^/internal/fragment/data$"), "fragment_data"),
    ("POST", re.compile(r"^/cluster/resize/set-coordinator$"), "set_coordinator"),
    ("POST", re.compile(r"^/cluster/resize/abort$"), "resize_abort"),
    ("POST", re.compile(r"^/cluster/resize/remove-node$"), "remove_node"),
    ("POST", re.compile(r"^/cluster/resize/resume$"), "resize_resume"),
    ("GET", re.compile(r"^/internal/attr/blocks$"), "attr_blocks"),
    ("POST", re.compile(r"^/internal/attr/block/data$"), "attr_block_data"),
    ("GET", re.compile(r"^/internal/fragment/blocks$"), "fragment_blocks"),
    ("POST", re.compile(r"^/internal/fragment/block/data$"), "fragment_block_data"),
    ("GET", re.compile(r"^/internal/fragments$"), "fragments"),
    ("POST", re.compile(r"^/internal/resize/fetch$"), "resize_fetch"),
    ("POST", re.compile(r"^/internal/migrate/begin$"), "migrate_begin"),
    ("GET", re.compile(r"^/internal/migrate/chunk$"), "migrate_chunk"),
    ("POST", re.compile(r"^/internal/migrate/delta$"), "migrate_delta"),
    ("POST", re.compile(r"^/internal/migrate/end$"), "migrate_end"),
    ("POST", re.compile(r"^/internal/migrate/fetch$"), "migrate_fetch"),
    ("POST", re.compile(r"^/internal/migrate/finalize$"), "migrate_finalize"),
]


class Handler(BaseHTTPRequestHandler):
    api: API = None  # set by make_server
    long_query_time: float = 0.0
    default_deadline: float = 0.0  # seconds; 0 = no default deadline
    protocol_version = "HTTP/1.1"
    # TCP_NODELAY on accepted sockets (socketserver applies this in
    # StreamRequestHandler.setup): with keep-alive connections (the
    # pooled internal client), Nagle + the peer's delayed ACK would add
    # ~40 ms to every small response
    disable_nagle_algorithm = True

    # -- plumbing -----------------------------------------------------------

    def log_message(self, fmt, *args):  # route through logging, not stderr
        logger.debug(fmt, *args)

    # gzip floor: tiny bodies cost more in header + CPU than they save
    _GZIP_MIN_BYTES = 512

    def _send(
        self,
        code: int,
        body: bytes,
        content_type: str = "application/json",
        headers: dict | None = None,
        gzip_ok: bool = False,
    ) -> None:
        if (
            gzip_ok
            and len(body) >= self._GZIP_MIN_BYTES
            and "gzip" in (self.headers.get("Accept-Encoding") or "")
        ):
            body = gzip_mod.compress(body, compresslevel=1)
            headers = dict(headers or {})
            headers["Content-Encoding"] = "gzip"
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _send_json(
        self,
        code: int,
        obj,
        headers: dict | None = None,
        gzip_ok: bool = False,
    ) -> None:
        self._send(
            code, (json.dumps(obj) + "\n").encode(), headers=headers,
            gzip_ok=gzip_ok,
        )

    def _body(self) -> bytes:
        length = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(length) if length else b""

    def _json_body(self) -> dict:
        raw = self._body()
        if not raw:
            return {}
        try:
            return json.loads(raw)
        except json.JSONDecodeError as e:
            raise ApiError(f"invalid json: {e}")

    def _cluster_flag(self) -> bool:
        return self.query_params.get("cluster", ["false"])[0].lower() in (
            "1", "true", "yes",
        )

    def _request_budget(self) -> float | None:
        """Deadline budget for this request, by precedence: explicit
        ``timeout=`` query param (seconds) > ``X-Pilosa-Deadline`` header
        (remaining budget forwarded by an upstream node) > the server's
        configured default.  None/0 disables the deadline — malformed
        values fall through rather than erroring, matching header
        semantics (a bad deadline must not reject the request)."""
        raw = self.query_params.get("timeout", [None])[0]
        budget = deadline.from_header(raw)
        if budget is None:
            budget = deadline.from_header(self.headers.get(deadline.HEADER))
        if budget is None and self.default_deadline > 0:
            budget = self.default_deadline
        return budget

    def _dispatch(self, method: str) -> None:
        if getattr(type(self), "paused", None) is not None and type(self).paused.is_set():
            # Fault injection: emulate a paused process (reference uses
            # pumba pause in internal/clustertests) — drop the connection
            # without responding so clients see timeouts/resets.
            self.close_connection = True
            try:
                self.connection.close()
            except OSError:
                pass
            return
        parsed = urlparse(self.path)
        self.query_params = parse_qs(parsed.query)
        for m, rx, name in _ROUTES:
            if m != method:
                continue
            match = rx.match(parsed.path)
            if match:
                t0 = time.monotonic()
                # Route this request's spans into THIS node's trace
                # store (contextvar: in-process multi-node clusters share
                # the process-global tracer but not their stores).
                store_token = tracestore._active_store.set(
                    getattr(self.api.holder, "traces", None)
                )
                # Join an incoming cross-node trace, or root a new one
                # (reference http/handler.go extracts opentracing headers).
                parent = tracing.get_tracer().extract_headers(self.headers)
                span = tracing.start_span(f"http.{name}", child_of=parent)
                span.set_tag("method", method).set_tag("path", parsed.path)
                # Error budget: server-attributed failures only.  504s
                # (a spent deadline) and 500s burn budget; 4xx
                # client mistakes don't.
                slo_error = False
                # span lifecycle is manual (not `with span:`) so the
                # op-class and error verdict — known only after the
                # handler ran — are tagged BEFORE finish(): the tail-
                # sampling decision at root completion reads both.
                span.__enter__()
                try:
                    # Tenant attribution: the device cost ledger books
                    # every launch this request causes under the header's
                    # tenant (canonical "(default)" when untagged); the
                    # contextvar rides into the api and executor layers.
                    with devledger.tenant_scope(
                        self.headers.get(devledger.TENANT_HEADER)
                    ), deadline.scope(self._request_budget()):
                        getattr(self, "r_" + name)(**match.groupdict())
                except ShedError as e:
                    # QoS load shed (server/qos.py stage 3): explicit
                    # 429 + Retry-After, NEVER a silent 504 — and a 4xx,
                    # so backpressure does not burn the error budget it
                    # exists to protect.
                    retry = max(1, math.ceil(e.retry_after))
                    self.api.holder.stats.count_with_tags(
                        "http_shed", 1, 1.0, (f"tenant:{e.tenant}",)
                    )
                    self._send_json(
                        429,
                        {"error": str(e), "retryAfter": retry},
                        headers={"Retry-After": str(retry)},
                    )
                except DeadlineExceeded as e:
                    # Distinct from ApiError (400-family): a spent budget
                    # is a timeout, not a client mistake (reference maps
                    # context.DeadlineExceeded similarly).
                    slo_error = True
                    self.api.holder.stats.count(
                        "http_deadline_exceeded", 1, 1.0
                    )
                    self._send_json(504, {"error": f"deadline exceeded: {e}"})
                except ApiError as e:
                    slo_error = e.code >= 500
                    self._send_json(e.code, {"error": str(e)})
                except BrokenPipeError:
                    pass
                except Exception as e:  # internal error
                    slo_error = True
                    logger.exception("internal error")
                    self._send_json(500, {"error": f"internal: {e}"})
                finally:
                    elapsed = time.monotonic() - t0
                    op_class = slo.take_class() or _SLO_ROUTE_CLASS.get(
                        name, slo.OP_OTHER
                    )
                    span.set_tag("op_class", op_class)
                    if slo_error:
                        span.set_tag("error", True)
                    span.__exit__(None, None, None)
                    tracestore._active_store.reset(store_token)
                    # Per-tenant SLO dimension: the request also lands
                    # under "op_class@tenant" (obs/slo.py) so a single
                    # tenant's objective/error budget is trackable —
                    # the QoS ladder's per-victim pressure signal.
                    tenant = devledger.clean_tenant(
                        self.headers.get(devledger.TENANT_HEADER)
                    )
                    self.api.holder.slo.observe(
                        op_class, elapsed, slo_error, tenant=tenant
                    )
                    self.api.holder.stats.count_with_tags(
                        "http_requests", 1, 1.0, (f"route:{name}",)
                    )
                    self.api.holder.stats.timing("http_request", elapsed)
                    if self.long_query_time and elapsed > self.long_query_time:
                        logger.warning(
                            "long query %.3fs: %s %s", elapsed, method, self.path
                        )
                return
        self._send_json(404, {"error": "not found"})

    def do_GET(self):
        self._dispatch("GET")

    def do_POST(self):
        self._dispatch("POST")

    def do_DELETE(self):
        self._dispatch("DELETE")

    # -- routes -------------------------------------------------------------

    def r_root(self):
        self._send_json(200, {"message": "pilosa-tpu server. See /schema, /status, /index/{index}/query."})

    def r_version(self):
        self._send_json(200, self.api.version())

    def r_status(self):
        self._send_json(200, self.api.status())

    def r_info(self):
        self._send_json(200, self.api.info())

    def r_get_schema(self):
        self._send_json(200, self.api.schema())

    def r_metrics(self):
        """Prometheus text exposition (reference http/handler.go:282): the
        holder's stats client, the kernel launches, key translation, the
        SLO plane, the device ledger and the build identity."""
        stats = self.api.holder.stats
        if hasattr(stats, "gauge"):
            # process and device-budget gauges refresh at scrape time, so
            # no background poller is needed
            info = sysinfo.SystemInfo()
            stats.gauge("process_uptime_seconds", round(info.process_uptime(), 3))
            stats.gauge("process_start_time_seconds", info.process_start_time())
            dev = membudget.default_budget().snapshot()
            stats.gauge("device_used_bytes", dev["usedBytes"])
            stats.gauge("device_cap_bytes", dev["capBytes"] or 0)
            stats.gauge("device_entries", dev["entries"])
            stats.gauge("device_evictions", dev["evictions"])
            res = residency.default_tracker().snapshot()
            stats.gauge("device_hits", res["deviceHits"])
            stats.gauge("device_misses", res["deviceMisses"])
            # the flight prefetcher's yield (server/prefetch.py)
            stats.gauge("device_prefetch_issued", res["prefetchIssued"])
            stats.gauge("device_prefetch_useful", res["prefetchUseful"])
            stats.gauge("device_pins", dev["pins"])
            stats.gauge("device_pinned_entries", dev["pinnedEntries"])
            stats.gauge("device_pinned_bytes", dev["pinnedBytes"])
        # histogram buckets carry exemplars of traces the tail sampler
        # kept, so every exemplar id resolves at /debug/traces?id=
        filt = self.api.holder.traces.kept_ids().__contains__
        text = (
            prometheus_text(stats, exemplar_filter=filt)
            + kernels.prometheus_text()
            + prometheus_text(translate.translate_stats)
            + self.api.holder.slo.prometheus_text(exemplar_filter=filt)
            + devledger.prometheus_text()
            + sysinfo.build_info_text(__version__)
        )
        self._send(
            200,
            text.encode(),
            content_type="text/plain; version=0.0.4",
            gzip_ok=True,
        )

    def r_debug_vars(self):
        """expvar-style dump (reference http/handler.go:281): the stats
        client's snapshot, the executor's serving-cache counters, kernel
        launches with their device ms, the device budget, residency, the
        device ledger, events, SLO summary, key translation and the
        process identity."""
        stats = self.api.holder.stats
        snap = dict(stats.snapshot()) if hasattr(stats, "snapshot") else {}
        ex = self.api.executor
        snap["serving_cache"] = {
            "gram_hits": ex.gram_cache_hits,
            "rowcount_hits": ex.rowcount_cache_hits,
            "crossgram_hits": ex.crossgram_cache_hits,
            "bsi_agg_hits": ex.bsi_agg_cache_hits,
            "stack_rebuilds": ex.stack_rebuilds,
            "stack_incremental": ex.stack_incremental,
            "bsi_stack_launches": ex.bsi_stack_launches,
            "stack_evictions": ex.stack_evictions,
            "stacks_declined": ex.stacks_declined,
            "bsi_fragment_launches": ex.bsi_fragment_launches,
        }
        # the result cache (hits, misses, invalidations, maintained views)
        # and the flight planner (CSE, reorders, lane prices)
        snap["rescache"] = ex.rescache.snapshot()
        snap["planner"] = ex.planner.snapshot()
        snap["kernels"] = kernels.telemetry_snapshot()
        snap["device"] = membudget.default_budget().snapshot()
        snap["residency"] = residency.default_tracker().snapshot()
        snap["devledger"] = devledger.snapshot()
        snap["events"] = self.api.holder.events.snapshot_summary()
        snap["slo"] = self.api.holder.slo.summary()
        snap["translate"] = translate.telemetry_snapshot()
        if self.api.batcher is not None:
            # the serving plane: queue depth, window knobs, flights
            snap["batcher"] = self.api.batcher.snapshot()
        if self.api.qos is not None:
            # cost-governed admission: per-tenant WFQ and ladder stages
            snap["qos"] = self.api.qos_snapshot()
        # the ingest plane: pool, staging occupancy, upload overlap
        snap["ingest"] = self.api.ingest.snapshot()
        # source-side migration sessions: each fragment's pending delta ops
        # are the live catch-up lag of an online resize
        snap["migrations"] = self.api.migrations.snapshot_summary()
        dist = self.api.dist
        if dist is not None:
            # cluster-on-mesh routing: the placement map, the mesh route's
            # dispatches and fallbacks, recent per-call partition decisions
            # (mesh, HTTP, local), and the peers' breaker states
            snap["dist"] = dist.snapshot()
            states = getattr(self.api.client, "breaker_states", None)
            snap["dist"]["breakers"] = states() if states is not None else {}
        # process identity: pid, version, uptime (/info is the host's)
        snap["process"] = sysinfo.SystemInfo().process_block(__version__)
        blackbox = self.api.blackbox
        if blackbox is not None:
            # the black-box writer's self-accounting: checkpoints and
            # their cost, spool size, crash-loop state (obs/blackbox.py)
            snap["blackbox"] = blackbox.stats()
        self._send_json(200, snap)

    def r_debug_qos(self):
        """Cost-governed admission state: per-tenant weighted-fair queues
        (debt, cost estimate, effective weight), ladder stages, shed and
        degraded counts and recent transitions (server/qos.py)."""
        self._send_json(200, self.api.qos_snapshot())

    def r_debug_slo(self):
        """Live SLO state: per-op-class latency quantiles, windowed
        availability, burn rates, alert firing, pass/fail verdicts."""
        self._send_json(200, self.api.slo_snapshot())

    def r_debug_index(self):
        """Debug-surface directory: every /debug/* endpoint with a
        one-line description."""
        self._send_json(200, {
            "endpoints": [
                {"path": p, "desc": d} for p, d in _DEBUG_ENDPOINTS
            ],
        })

    def r_debug_history(self):
        """Ring-buffer metrics history (obs/history.py): ?series= glob
        filter, ?since= base-seq cursor (gap-honest `truncated` flag),
        ?step= downsampling (tier selection + mean buckets), ?limit= the
        newest samples."""
        series = self.query_params.get("series", [None])[0]
        try:
            since_raw = self.query_params.get("since", [None])[0]
            since = int(since_raw) if since_raw is not None else None
            step_raw = self.query_params.get("step", [None])[0]
            step = float(step_raw) if step_raw is not None else None
            limit_raw = self.query_params.get("limit", [None])[0]
            limit = int(limit_raw) if limit_raw is not None else None
        except ValueError:
            self._send_json(400, {"error": "bad since/step/limit"})
            return
        if self._cluster_flag():
            self._send_json(
                200, self.api.cluster_history(series=series, step=step),
                gzip_ok=True,
            )
            return
        snap = self.api.history_query(
            series=series, since=since, step=step, limit=limit
        )
        if snap is None:
            self._send_json(404, {"error": "metrics history disabled"})
            return
        self._send_json(200, snap, gzip_ok=True)

    def r_debug_incidents(self):
        """Flight-recorder incident bundles (alert-edge, 504-spike, trend
        and QoS captures): the list, or one full bundle with ?id=."""
        incident_id = self.query_params.get("id", [None])[0]
        if incident_id:
            detail = self.api.incident_detail(incident_id)
            if detail is None:
                self._send_json(
                    404, {"error": f"incident {incident_id} not found"}
                )
            else:
                self._send_json(200, detail)
            return
        self._send_json(200, self.api.incidents_snapshot())

    def r_debug_postmortem(self):
        """Sealed crash bundles from the black box (obs/blackbox.py): a
        bare GET returns the retained summaries and the newest bundle in
        full; ?id= one bundle; ?cluster=true merges every peer's
        summaries."""
        if self._cluster_flag():
            self._send_json(200, self.api.cluster_postmortems(), gzip_ok=True)
            return
        pm_id = self.query_params.get("id", [None])[0]
        snap = self.api.postmortem_snapshot(pm_id)
        if snap is None:
            if pm_id:
                self._send_json(
                    404, {"error": f"postmortem {pm_id} not found"}
                )
            else:
                self._send_json(
                    404, {"error": "black box disabled (no data dir)"}
                )
            return
        self._send_json(200, snap, gzip_ok=True)

    def r_diagnostics(self):
        """Diagnostics snapshot (reference diagnostics.go payload; the
        local endpoint replaces the reference's phone-home POST)."""
        diag = self.api.diagnostics
        if diag is None:
            self._send_json(404, {"error": "diagnostics not enabled"})
            return
        self._send_json(200, diag.snapshot())

    def r_debug_events(self):
        """Event journal past ?since=<seq> (gap-free cursor resume);
        ?cluster=true merges every peer's journal into one timeline."""
        try:
            since = int(self.query_params.get("since", ["0"])[0])
            limit_raw = self.query_params.get("limit", [None])[0]
            limit = int(limit_raw) if limit_raw is not None else None
        except ValueError:
            self._send_json(400, {"error": "bad since/limit"})
            return
        if self._cluster_flag():
            self._send_json(200, self.api.cluster_events(since))
            return
        self._send_json(200, self.api.events_since(since, limit))

    def r_debug_traces(self):
        """Tail-sampled trace store: kept-trace list, ?id=<32hex> span
        detail (with &spans=true: the raw local spans, kept or recent),
        ?cluster=true the peers' too (with an id: one trace's spans from
        every node; without: the kept summaries merged)."""
        trace_id = self.query_params.get("id", [None])[0]
        try:
            limit = int(self.query_params.get("limit", ["100"])[0])
        except ValueError:
            self._send_json(400, {"error": "bad limit"})
            return
        if self._cluster_flag():
            if trace_id:
                self._send_json(200, self.api.cluster_trace(trace_id), gzip_ok=True)
            else:
                self._send_json(200, self.api.cluster_traces(limit), gzip_ok=True)
            return
        if trace_id:
            if self.query_params.get("spans", ["false"])[0].lower() in (
                "1", "true", "yes",
            ):
                # raw local spans, kept or recent, 200 even when empty
                self._send_json(
                    200, self.api.trace_spans(trace_id), gzip_ok=True
                )
                return
            detail = self.api.trace_detail(trace_id)
            if detail is None:
                self._send_json(404, {"error": f"trace {trace_id} not kept"})
            else:
                self._send_json(200, detail, gzip_ok=True)
            return
        self._send_json(200, self.api.traces_snapshot(limit), gzip_ok=True)

    def r_debug_devcosts(self):
        """Device cost ledger: per-site and per-(tenant, index, op_class)
        launch, device-time and transfer accounting with rates
        (obs/devledger.py)."""
        self._send_json(200, devledger.snapshot())

    def r_debug_jobs(self):
        """Background-job records: active + bounded history, with phase,
        progress counters, rates and ETA (?kind= filters)."""
        kind = self.query_params.get("kind", [None])[0]
        self._send_json(200, self.api.jobs_snapshot(kind))

    def r_debug_fragments(self):
        """Per-fragment storage/residency introspection
        (?index=&field= filter)."""
        index = self.query_params.get("index", [None])[0]
        field = self.query_params.get("field", [None])[0]
        self._send_json(200, self.api.fragment_details(index, field))

    def r_debug_slow_queries(self):
        """Bounded worst-offender log of queries over the server's
        slow-query threshold (reference's long-query-time logging,
        handler.go:246-248, upgraded to a structured endpoint: each
        entry keeps the full execution profile of the offending
        query)."""
        self._send_json(200, self.api.slow_queries.snapshot())

    def r_debug_threads(self):
        """Per-thread stack dump — the pprof goroutine-profile analogue
        (reference mounts net/http/pprof, http/handler.go:280)."""
        import sys
        import traceback

        frames = sys._current_frames()
        out = []
        for t in threading.enumerate():
            frame = frames.get(t.ident)
            out.append(
                {
                    "name": t.name,
                    "daemon": t.daemon,
                    "stack": traceback.format_stack(frame) if frame else [],
                }
            )
        self._send_json(200, {"threads": out, "count": len(out)})

    def r_debug_profile(self):
        """CPU sampling profile of every thread for ?seconds=N (cap 30);
        flamegraph-collapsed stacks — the net/http/pprof profile-
        endpoint role (reference http/handler.go:280).  The request
        thread does the sampling; the threaded server keeps serving."""
        from pilosa_tpu_torch.obs import profile

        try:
            seconds = float(self.query_params.get("seconds", ["2"])[0])
            interval = (
                float(self.query_params.get("interval_ms", ["5"])[0]) / 1e3
            )
            if not (math.isfinite(seconds) and math.isfinite(interval)):
                raise ValueError
            if seconds <= 0 or interval <= 0:
                raise ValueError
        except ValueError:
            self._send_json(400, {"error": "bad seconds/interval_ms"})
            return
        # clamp BOTH ways: a huge interval would park this server thread
        # in time.sleep far past the seconds cap
        interval = min(max(0.001, interval), 1.0)
        # The sampler blocks this request thread for the whole window:
        # cap it by the caller's remaining deadline budget (at 90%, so
        # serialization still fits) instead of sampling into a 504.
        deadline.check("debug/profile")
        rem = deadline.remaining()
        if rem is not None:
            seconds = min(seconds, max(0.05, rem * 0.9))
        self._send_json(200, profile.sample(seconds, interval))

    def r_debug_memory(self):
        """Heap/memory snapshot: RSS, host mirror bytes by index, device
        budget accounting, GC state — the pprof heap-profile role
        shaped to this runtime's actual memory owners."""
        from pilosa_tpu_torch.obs import profile

        self._send_json(200, profile.memory_snapshot(self.api.holder))

    def r_post_schema(self):
        self.api.apply_schema(self._json_body())
        self._send_json(200, {})

    def r_query(self, index: str):
        """Accepts either a raw PQL body or a JSON envelope
        ``{"query": ..., "shards": [...], "remote": bool, "profile":
        bool}``, the latter the node-to-node fan-out form (reference
        QueryRequest, internal/public.proto)."""
        body = self._body()
        remote = False
        profile = False
        shards = None
        pql = body.decode()
        if self.headers.get("Content-Type", "").startswith("application/json"):
            try:
                obj = json.loads(pql or "{}")
            except json.JSONDecodeError:
                obj = None  # raw PQL sent with a JSON content type
            if isinstance(obj, dict):
                pql = obj.get("query", "")
                shards = obj.get("shards")
                remote = bool(obj.get("remote"))
                profile = bool(obj.get("profile"))
        if "shards" in self.query_params:
            shards = [
                int(s)
                for part in self.query_params["shards"]
                for s in part.split(",")
                if s
            ]
        if self.query_params.get("profile", [""])[0].lower() in ("1", "true"):
            profile = True
        resp = self.api.query(
            index, pql, shards=shards, remote=remote, profile=profile, encode=False
        )
        if "results" in resp:
            self._send(200, response_json(resp))
        else:  # a remote leg's wire results
            self._send_json(200, resp)

    def r_create_index(self, index: str):
        body = self._json_body()
        self._send_json(200, self.api.create_index(index, body.get("options", {})))

    def r_get_index(self, index: str):
        self._send_json(200, self.api.index_info(index))

    def r_delete_index(self, index: str):
        self.api.delete_index(index)
        self._send_json(200, {})

    def r_create_field(self, index: str, field: str):
        body = self._json_body()
        self._send_json(200, self.api.create_field(index, field, body.get("options", {})))

    def r_get_field(self, index: str, field: str):
        self._send_json(200, self.api.field_info(index, field))

    def r_delete_field(self, index: str, field: str):
        self.api.delete_field(index, field)
        self._send_json(200, {})

    def r_import_(self, index: str, field: str):
        if self.headers.get("Content-Type", "").startswith("application/octet-stream"):
            body = self._body()
            try:
                req = wire.decode_import(body)
            except Exception as e:
                # malformed client input, not a server fault (the JSON
                # path answers 400 the same way)
                raise ApiError(f"bad binary import payload: {e}")
        else:
            req = self._json_body()
        self.api.import_bits(index, field, req)
        self._send_json(200, {})

    def r_import_roaring(self, index: str, field: str, shard: str):
        clear = self.query_params.get("clear", ["false"])[0] == "true"
        remote = self.query_params.get("remote", ["false"])[0] == "true"
        view = self.query_params.get("view", ["standard"])[0]
        result = self.api.import_roaring(
            index, field, int(shard), self._body(), clear=clear, view=view,
            remote=remote,
        )
        self._send_json(200, result)

    def r_fragment_data(self):
        p = {k: v[0] for k, v in self.query_params.items()}
        data = self.api.fragment_data(
            p["index"], p["field"], p.get("view", "standard"), int(p["shard"])
        )
        self._send(200, data, content_type="application/octet-stream")

    def r_export(self):
        index = self.query_params.get("index", [None])[0]
        field = self.query_params.get("field", [None])[0]
        if not index or not field:
            raise ApiError("index and field query params required")
        shard = self.query_params.get("shard", [None])[0]
        csv = self.api.export_csv(index, field, int(shard) if shard else None)
        self._send(200, csv.encode(), content_type="text/csv")

    def r_shards_max(self):
        self._send_json(200, self.api.shards_max())

    def r_translate_keys(self):
        body = self._json_body()
        ids = self.api.translate_keys(
            body.get("index", ""), body.get("field", ""), body.get("keys", [])
        )
        self._send_json(200, {"ids": ids})

    def r_translate_ids(self):
        body = self._json_body()
        keys = self.api.translate_ids(
            body.get("index", ""), body.get("field", ""), body.get("ids", [])
        )
        self._send_json(200, {"keys": keys})

    def r_translate_log(self):
        try:
            offset = int(self.query_params.get("offset", ["0"])[0])
        except ValueError:
            raise ApiError("bad offset")
        self._send_json(200, self.api.translate_log(offset))

    def r_translate_restore(self):
        body = self._json_body()
        self._send_json(200, self.api.translate_restore(body.get("entries", [])))

    def r_cluster_message(self):
        self._send_json(200, self.api.receive_message(self._json_body()))

    def r_nodes(self):
        self._send_json(200, self.api.hosts())

    def r_recalculate_caches(self):
        # reference POST /recalculate-caches; counts here are exact and
        # maintained, so there is nothing to rebuild
        self._send_json(200, {})

    # -- the elastic planes: blocks, migration and resize ------------------

    def r_fragments(self):
        self._send_json(200, {"fragments": self.api.fragment_inventory()})

    def r_resize_fetch(self):
        self._send_json(200, self.api.resize_fetch(self._json_body()))

    def r_migrate_begin(self):
        self._send_json(200, self.api.migrate_begin(self._json_body()))

    def r_migrate_chunk(self):
        p = {k: v[0] for k, v in self.query_params.items()}
        data = self.api.migrate_chunk(p["token"], int(p.get("offset", 0)))
        self._send(200, data, content_type="application/octet-stream")

    def r_migrate_delta(self):
        body = self._json_body()
        frame = self.api.migrate_delta(body.get("token", ""))
        self._send(200, frame, content_type="application/octet-stream")

    def r_migrate_end(self):
        body = self._json_body()
        self._send_json(200, self.api.migrate_end(body.get("token", "")))

    def r_migrate_fetch(self):
        self._send_json(200, self.api.migrate_fetch(self._json_body()))

    def r_migrate_finalize(self):
        self._send_json(200, self.api.migrate_finalize(self._json_body()))

    def r_resize_resume(self):
        self._send_json(200, self.api.resize_resume())

    def r_attr_blocks(self):
        p = {k: v[0] for k, v in self.query_params.items()}
        self._send_json(200, self.api.attr_blocks(p["index"], p.get("field") or None))

    def r_attr_block_data(self):
        self._send_json(200, self.api.attr_block_data(self._json_body()))

    def r_fragment_blocks(self):
        p = {k: v[0] for k, v in self.query_params.items()}
        self._send_json(
            200,
            self.api.fragment_blocks(
                p["index"], p["field"], p.get("view", "standard"), int(p["shard"])
            ),
        )

    def r_fragment_block_data(self):
        body = self._json_body()
        # binary when the peer accepts it (packed roaring positions); JSON
        # for unencodable row ids or a peer that does not
        if "application/octet-stream" in (self.headers.get("Accept") or ""):
            data = self.api.fragment_block_data_binary(body)
            if data is not None:
                self._send(200, data, content_type="application/octet-stream")
                return
        self._send_json(200, self.api.fragment_block_data(body))

    def r_set_coordinator(self):
        body = self._json_body()
        self._send_json(200, self.api.set_coordinator(body.get("id", "")))

    def r_resize_abort(self):
        self._send_json(200, self.api.resize_abort())

    def r_remove_node(self):
        body = self._json_body()
        self._send_json(200, self.api.resize_remove_node(body.get("id", "")))


class Server:
    """HTTP server wrapper: bind, serve in background, close.

    With ``tls_cert``/``tls_key`` the listener speaks HTTPS (reference
    TLS config server/config.go:36-152; node URIs become https://)."""

    def __init__(
        self,
        api: API,
        host: str = "localhost",
        port: int = 10101,
        long_query_time: float = 0.0,
        tls_cert: str | None = None,
        tls_key: str | None = None,
        default_deadline: float = 0.0,
        slow_query_time: float = 0.0,
    ):
        if slow_query_time > 0:
            api.slow_queries.threshold = slow_query_time
        handler = type(
            "BoundHandler",
            (Handler,),
            {
                "api": api,
                "long_query_time": long_query_time,
                "default_deadline": default_deadline,
                "paused": threading.Event(),
            },
        )

        class _Listener(ThreadingHTTPServer):
            # socketserver's default listen backlog of 5 resets
            # connections the accept loop hasn't reached yet
            request_queue_size = 1024

        self.httpd = _Listener((host, port), handler)
        self.tls = bool(tls_cert)
        if tls_cert:
            import ssl

            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(tls_cert, tls_key)
            self.httpd.socket = ctx.wrap_socket(
                self.httpd.socket, server_side=True
            )
        self.api = api
        self._thread: threading.Thread | None = None

    def pause(self) -> None:
        """Stop answering requests (connections drop) until resume() —
        fault injection mirroring pumba pause in the reference's
        internal/clustertests."""
        self.httpd.RequestHandlerClass.paused.set()

    def resume(self) -> None:
        self.httpd.RequestHandlerClass.paused.clear()

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def serve_background(self) -> None:
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def close(self) -> None:
        # a closed server answers nothing, as a stopped process: a request
        # arriving on a kept-alive connection (a peer's pooled client) has
        # its connection dropped, not served by a handler thread that
        # outlives the listener
        self.pause()
        if self._thread is not None:
            # shutdown() waits for the serving loop, so only a started
            # server is asked to
            self.httpd.shutdown()
        self.httpd.server_close()
        self.api.close()
