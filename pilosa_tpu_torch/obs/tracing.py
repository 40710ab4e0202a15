"""Distributed tracing (reference: tracing/tracing.go:22-50 Tracer/Span
interface + global tracer, tracing/opentracing/opentracing.go:31-76
Jaeger adapter with HTTP header inject/extract for cross-node traces).

The reference instruments ~80 spans across the executor, fragment
imports, API, and syncers via ``tracing.StartSpanFromContext``. Here the
active span is carried in a ``contextvars.ContextVar`` (the Python
analogue of ctx-carried spans), with explicit header inject/extract at
the node boundary so a query fanned out over HTTP appears as one trace:

    coordinator: api.query span  ─ inject → X-Trace-Id/X-Span-Id headers
    remote node: extract → handler span (child, same trace id)

Backends: :class:`NopTracer` (zero-cost default, like the reference's
default no-op tracer), :class:`RecordingTracer` (in-process ring buffer)
and :class:`ExportingTracer` (head-sampled, forwarding finished spans to
an exporter such as ``obs/export.py``'s OTLP one). Finished spans also
reach the per-node trace store through the span sink
(obs/tracestore.py). Counterpart of ``pilosa_tpu/obs/tracing.py``.
"""

from __future__ import annotations

import contextvars
import random
import threading
import time
from collections import deque

from pilosa_tpu_torch.obs import qprofile

TRACE_HEADER = "X-Pilosa-Trace-Id"
SPAN_HEADER = "X-Pilosa-Span-Id"
TRACEPARENT_HEADER = "traceparent"

# Id minting (W3C trace-context widths: 128-bit trace ids, 64-bit span
# ids).  A per-process RNG — NOT a counter — so two nodes never mint the
# same trace id.
_id_lock = threading.Lock()
_id_rng = random.Random()


def _new_trace_id() -> int:
    with _id_lock:
        while True:
            tid = _id_rng.getrandbits(128)
            if tid:  # the zero id is invalid on the wire (W3C §3.2.2.3)
                return tid


def _new_span_id() -> int:
    with _id_lock:
        while True:
            sid = _id_rng.getrandbits(64)
            if sid:
                return sid


_active_span: contextvars.ContextVar["Span | None"] = contextvars.ContextVar(
    "pilosa_active_span", default=None
)

# Optional span sink: called with every finished span AFTER the tracer's
# own ``_record``.  This is how the per-node TraceStore observes spans
# without replacing the configured tracer (obs/tracestore.py installs
# itself here at import-time of the store module).
_span_sink = None


def set_span_sink(sink) -> None:
    global _span_sink
    _span_sink = sink


class SpanContext:
    """Wire-propagatable identity of a span.  ``remote`` marks a context
    extracted from incoming headers: a span whose parent is remote is a
    *local root* — the first span of this trace on this node — which is
    where tail-sampling decisions attach."""

    __slots__ = ("trace_id", "span_id", "remote")

    def __init__(self, trace_id: int, span_id: int, remote: bool = False):
        self.trace_id = trace_id
        self.span_id = span_id
        self.remote = remote


class Span:
    """One timed operation (reference tracing.Span :44-50)."""

    def __init__(self, tracer: "Tracer", name: str, parent: SpanContext | None):
        self.tracer = tracer
        self.name = name
        self.parent_id = parent.span_id if parent else 0
        # local root = no parent at all, or a parent extracted from the
        # wire (the first span of the trace on THIS node)
        self.local_root = parent is None or parent.remote
        trace_id = parent.trace_id if parent else _new_trace_id()
        self.context = SpanContext(trace_id, _new_span_id())
        self.start = time.monotonic()
        # wall-clock anchor, taken once at span start: exporters must not
        # re-derive it at export time (batched exports would skew it)
        self.start_unix_ns = time.time_ns()
        self.duration = None
        self.tags: dict = {}
        self._token = None
        self._phandle = None

    def set_tag(self, key: str, value) -> "Span":
        self.tags[key] = value
        return self

    def log_kv(self, **fields) -> None:
        self.tags.setdefault("logs", []).append((time.monotonic(), fields))

    def finish(self) -> None:
        if self.duration is None:
            self.duration = time.monotonic() - self.start
            self.tracer._record(self)
            if _span_sink is not None:
                _span_sink(self)

    # context-manager + ambient-activation protocol.  Every span is
    # also mirrored into the active QueryProfile (if any) — this runs
    # for the NopTracer too, which is how ``?profile=true`` sees the
    # call tree without a tracing backend configured.
    def __enter__(self) -> "Span":
        self._token = _active_span.set(self)
        self._phandle = qprofile.span_enter(self.name)
        return self

    def __exit__(self, *exc) -> None:
        qprofile.span_exit(self._phandle, self.tags)
        self._phandle = None
        if self._token is not None:
            _active_span.reset(self._token)
            self._token = None
        self.finish()


class Tracer:
    """reference tracing.Tracer :32-41."""

    def start_span(
        self, name: str, child_of: SpanContext | None = None
    ) -> Span:
        if child_of is None:
            parent = _active_span.get()
            child_of = parent.context if parent is not None else None
        return Span(self, name, child_of)

    def inject_headers(self, ctx: SpanContext, headers: dict) -> None:
        """opentracing.go:58-66 InjectHTTPHeaders — native headers plus a
        W3C ``traceparent`` (version 00, sampled flag set) for interop."""
        headers[TRACE_HEADER] = str(ctx.trace_id)
        headers[SPAN_HEADER] = str(ctx.span_id)
        headers[TRACEPARENT_HEADER] = format_traceparent(ctx)

    def extract_headers(self, headers) -> SpanContext | None:
        """opentracing.go:68-76 ExtractHTTPHeaders.  Native headers win;
        falls back to W3C ``traceparent``."""
        trace_id = headers.get(TRACE_HEADER)
        span_id = headers.get(SPAN_HEADER)
        if trace_id and span_id:
            try:
                return SpanContext(int(trace_id), int(span_id), remote=True)
            except ValueError:
                return None
        return parse_traceparent(headers.get(TRACEPARENT_HEADER))

    def _record(self, span: Span) -> None:
        pass


class NopTracer(Tracer):
    pass


class RecordingTracer(Tracer):
    """Ring-buffer recorder (Jaeger-exporter stand-in)."""

    def __init__(self, capacity: int = 4096):
        self._lock = threading.Lock()
        self.spans: deque[Span] = deque(maxlen=capacity)

    def _record(self, span: Span) -> None:
        with self._lock:
            self.spans.append(span)

    def finished(self, name: str | None = None) -> list[Span]:
        with self._lock:
            return [s for s in self.spans if name is None or s.name == name]

    def traces(self) -> dict[int, list[Span]]:
        """Finished spans grouped by trace id, in finish order."""
        with self._lock:
            out: dict[int, list[Span]] = {}
            for s in self.spans:
                out.setdefault(s.context.trace_id, []).append(s)
            return out


class ExportingTracer(RecordingTracer):
    """Samples spans at the root and forwards finished spans to an
    exporter (reference tracing/opentracing/opentracing.go:31-76 Jaeger
    adapter + sampler config server/config.go:139-145).

    Sampling is head-based per trace: the root span's trace id decides,
    so a trace is exported whole or not at all."""

    def __init__(self, exporter, sample_rate: float = 1.0, capacity: int = 4096):
        super().__init__(capacity)
        self.exporter = exporter
        self.sample_rate = max(0.0, min(1.0, sample_rate))

    def _sampled(self, trace_id: int) -> bool:
        if self.sample_rate >= 1.0:
            return True
        if self.sample_rate <= 0.0:
            return False
        # cheap deterministic hash of the trace id -> [0, 1)
        return ((trace_id * 2654435761) & 0xFFFFFFFF) / 2**32 < self.sample_rate

    def _record(self, span: Span) -> None:
        super()._record(span)
        if self._sampled(span.context.trace_id):
            self.exporter.export(span)

    def close(self) -> None:
        self.exporter.close()


def format_traceparent(ctx: SpanContext) -> str:
    """W3C trace-context header: 00-<32hex trace>-<16hex span>-<flags>."""
    return f"00-{ctx.trace_id & (2**128 - 1):032x}-{ctx.span_id & (2**64 - 1):016x}-01"


def parse_traceparent(value) -> SpanContext | None:
    """Parse a W3C ``traceparent`` header; ``None`` on anything invalid
    (wrong field widths, non-hex, all-zero ids, reserved version ff)."""
    if not value:
        return None
    parts = value.strip().split("-")
    if len(parts) < 4:
        return None
    version, trace_hex, span_hex = parts[0], parts[1], parts[2]
    if len(version) != 2 or len(trace_hex) != 32 or len(span_hex) != 16:
        return None
    if version.lower() == "ff":
        return None
    try:
        int(version, 16)
        trace_id = int(trace_hex, 16)
        span_id = int(span_hex, 16)
    except ValueError:
        return None
    if not trace_id or not span_id:
        return None
    return SpanContext(trace_id, span_id, remote=True)


# Global tracer (reference tracing.GlobalTracer :22-29).
_global = Tracer.__new__(NopTracer)  # type: ignore[assignment]


def get_tracer() -> Tracer:
    return _global


def set_tracer(t: Tracer) -> None:
    global _global
    _global = t


def start_span(name: str, child_of: SpanContext | None = None) -> Span:
    """reference tracing.StartSpanFromContext — ambient parenting via the
    context variable when ``child_of`` is not given."""
    return _global.start_span(name, child_of)


def active_span() -> Span | None:
    return _active_span.get()
