"""Per-node trace store with tail-based sampling (Dapper §4: keep the
traces that mattered — errors and tail-latency outliers — decided at
trace completion, not at trace start like head sampling).

Spans reach the store through :func:`feed`, installed as the tracing
module's span sink; which *store* a span lands in is carried by a
context variable activated per HTTP request (so multi-node in-process
test clusters route each node's spans to that node's own store — a
process-global store would merge them).

Retention is two-tier:

* ``_kept`` — traces that passed the tail policy (error, slow per the
  SLO latency objective for the request's op class, or a deterministic
  1-in-N baseline).  These are what ``GET /debug/traces`` lists and
  what metric exemplars point at.
* ``_recent`` — the spans of *every* recently completed trace,
  regardless of the local tail decision.  A coordinator assembling one
  trace cluster-wide (``?cluster=true``) asks every node for spans by
  trace id; the remote leg of a slow query is often itself fast, so the
  remote node would have dropped it from ``_kept`` — ``_recent`` is the
  short-lived memory that makes cross-node assembly work anyway.

The baseline decision hashes the trace id, so every node that touches a
trace makes the SAME keep/drop call — a baseline-kept trace is kept
whole across the cluster (Dapper's coherent-sampling property).

Counterpart of ``pilosa_tpu/obs/tracestore.py``, without what only its
cluster plane calls.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time
from collections import OrderedDict

from pilosa_tpu_torch.obs import tracing

# Fallback slow-keep threshold for spans with no op class or no latency
# objective (matches slo.DEFAULT_OBJECTIVES' read.other tier).
DEFAULT_SLOW_SECONDS = 0.250

_active_store: contextvars.ContextVar["TraceStore | None"] = (
    contextvars.ContextVar("pilosa_trace_store", default=None)
)


@contextlib.contextmanager
def activate(store: "TraceStore | None"):
    """Route spans finished inside this context into ``store``."""
    token = _active_store.set(store)
    try:
        yield store
    finally:
        _active_store.reset(token)


def feed(span) -> None:
    """tracing span sink: deliver one finished span to the active store."""
    store = _active_store.get()
    if store is not None:
        store.observe(span)


tracing.set_span_sink(feed)


def _span_dict(span, node_id: str) -> dict:
    # Rendered lazily at READ time (/debug/traces), never on the span
    # hot path: the store retains Span objects and pays the hex
    # formatting + tag copy only for traces somebody actually asks for.
    return {
        "traceId": f"{span.context.trace_id & (2**128 - 1):032x}",
        "spanId": f"{span.context.span_id & (2**64 - 1):016x}",
        "parentId": (
            f"{span.parent_id & (2**64 - 1):016x}" if span.parent_id else None
        ),
        "name": span.name,
        "node": node_id,
        "startUnixMs": span.start_unix_ns // 1_000_000,
        "durationMs": round((span.duration or 0.0) * 1e3, 3),
        "tags": {
            k: v for k, v in span.tags.items() if k != "logs"
        },
    }


def baseline_kept(trace_id: int, baseline_n: int) -> bool:
    """Deterministic 1-in-N keep from the trace id alone — the same
    verdict on every node (Fibonacci-hash mix)."""
    if baseline_n <= 0:
        return False
    if baseline_n == 1:
        return True
    mixed = (trace_id * 0x9E3779B97F4A7C15) & (2**64 - 1)
    return mixed % baseline_n == 0


class TraceStore:
    """Bounded per-node store of completed traces (tail-sampled)."""

    def __init__(
        self,
        slo=None,
        capacity: int = 256,
        recent_capacity: int = 512,
        baseline_n: int = 128,
        pending_limit: int = 1024,
    ):
        self.slo = slo  # SLOTracker: latency objectives = slow thresholds
        self.node_id = ""
        self.capacity = max(1, int(capacity))
        self.recent_capacity = max(1, int(recent_capacity))
        self.baseline_n = int(baseline_n)
        self.pending_limit = max(16, int(pending_limit))
        # on_keep(op_class, seconds, trace_id_hex): exemplar hook —
        # the Holder wires this to the SLO tracker's histogram buckets.
        self.on_keep = None
        self._lock = threading.Lock()
        self._pending: OrderedDict[int, list] = OrderedDict()
        self._kept: OrderedDict[int, dict] = OrderedDict()
        self._recent: OrderedDict[int, list[dict]] = OrderedDict()
        self._stats = {"completed": 0, "kept": 0, "dropped": 0,
                       "kept_error": 0, "kept_slow": 0, "kept_baseline": 0,
                       "pending_evicted": 0}

    # -- ingest --------------------------------------------------------------

    def observe(self, span) -> None:
        """Called (via the span sink) for every finished span."""
        try:
            self._observe(span)
        except Exception:  # graftlint: disable=exception-hygiene -- observability must never fail the traced request
            pass

    def _observe(self, span) -> None:
        tid = span.context.trace_id
        with self._lock:
            self._pending.setdefault(tid, []).append(span)
            # bound the in-flight set: a span whose root never finishes
            # (crashed handler, dropped client) must not leak forever
            while len(self._pending) > self.pending_limit:
                self._pending.popitem(last=False)
                self._stats["pending_evicted"] += 1
            if not getattr(span, "local_root", False):
                return
            spans = self._pending.pop(tid, [span])
        self._complete(tid, span, spans)

    def _complete(self, tid: int, root, spans: list) -> None:
        duration = root.duration or 0.0
        op_class = root.tags.get("op_class")
        error = bool(root.tags.get("error"))
        reason = self._tail_reason(tid, op_class, duration, error)
        with self._lock:
            self._stats["completed"] += 1
            self._recent[tid] = spans
            while len(self._recent) > self.recent_capacity:
                self._recent.popitem(last=False)
            if reason is None:
                self._stats["dropped"] += 1
                return
            self._stats["kept"] += 1
            self._stats[f"kept_{reason}"] += 1
            self._kept[tid] = {
                "traceId": f"{tid & (2**128 - 1):032x}",
                "root": root.name,
                "opClass": op_class,
                "error": error,
                "durationMs": round(duration * 1e3, 3),
                "reason": reason,
                "at": time.time(),
                "spans": spans,
            }
            while len(self._kept) > self.capacity:
                self._kept.popitem(last=False)
        hook = self.on_keep
        if hook is not None and op_class:
            try:
                hook(op_class, duration, f"{tid & (2**128 - 1):032x}")
            except Exception:  # graftlint: disable=exception-hygiene -- exemplar wiring must not fail the request
                pass

    def _tail_reason(self, tid, op_class, duration, error) -> str | None:
        if error:
            return "error"
        if duration > self._slow_threshold(op_class):
            return "slow"
        if baseline_kept(tid, self.baseline_n):
            return "baseline"
        return None

    def _slow_threshold(self, op_class) -> float:
        slo = self.slo
        if slo is not None and op_class:
            obj = slo.objectives.get(op_class)
            if obj is not None and obj.latency_p99 is not None:
                return obj.latency_p99
        return DEFAULT_SLOW_SECONDS

    # -- queries -------------------------------------------------------------

    def kept_ids(self) -> set[str]:
        with self._lock:
            return {rec["traceId"] for rec in self._kept.values()}

    def summaries(self, limit: int = 100) -> list[dict]:
        """Newest-first kept-trace summaries (no span bodies)."""
        with self._lock:
            recs = list(self._kept.values())[-limit:]
        return [
            {k: v for k, v in rec.items() if k != "spans"}
            for rec in reversed(recs)
        ]

    def detail(self, trace_id_hex: str) -> dict | None:
        try:
            tid = int(trace_id_hex, 16)
        except (TypeError, ValueError):
            return None
        with self._lock:
            rec = self._kept.get(tid)
            if rec is None:
                return None
            out = {k: v for k, v in rec.items() if k != "spans"}
            spans = list(rec["spans"])
        out["spans"] = [_span_dict(s, self.node_id) for s in spans]
        return out

    def spans_for(self, trace_id_hex: str) -> list[dict]:
        """All spans this node holds for one trace — kept OR merely
        recent (the cross-node assembly path)."""
        try:
            tid = int(trace_id_hex, 16)
        except (TypeError, ValueError):
            return []
        with self._lock:
            rec = self._kept.get(tid)
            if rec is not None:
                spans = list(rec["spans"])
            else:
                spans = list(self._recent.get(tid, ()))
        return [_span_dict(s, self.node_id) for s in spans]

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "node": self.node_id,
                "capacity": self.capacity,
                "baselineN": self.baseline_n,
                "kept": len(self._kept),
                "pending": len(self._pending),
                "stats": dict(self._stats),
            }

    def blackbox_snapshot(self, limit: int = 32) -> dict:
        """Black-box checkpoint block: kept-trace summaries (no span
        bodies — the spool is bounded) plus the store's counters."""
        return {
            "summaries": self.summaries(limit),
            "snapshot": self.snapshot(),
        }
