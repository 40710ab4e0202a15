"""Span exporter: OTLP/HTTP JSON (reference
tracing/opentracing/opentracing.go:31-76 — the Jaeger agent adapter;
OTLP is its modern equivalent and needs no vendor SDK). Counterpart of
``pilosa_tpu/obs/export.py``, the same code.

Spans batch in a bounded queue and a background thread POSTs
``{"resourceSpans": [...]}`` to ``<endpoint>/v1/traces``.  Export is
strictly best-effort: a down collector drops batches, never blocks or
fails the serving path.
"""

from __future__ import annotations

import json
import queue
import threading
import time
import urllib.request

_SERVICE = "pilosa-tpu"


def _otlp_span(span) -> dict:
    # The span records its wall-clock anchor once at start; deriving it
    # here from time.time_ns() would skew every batched span by however
    # long it sat in the export queue.
    start_ns = getattr(span, "start_unix_ns", None)
    if start_ns is None:  # foreign span object without the anchor
        start_ns = int(time.time_ns() - (time.monotonic() - span.start) * 1e9)
    dur_ns = int((span.duration or 0.0) * 1e9)
    # OTLP status from the error tag the HTTP layer stamps before
    # finish: 2 = STATUS_CODE_ERROR, 0 = STATUS_CODE_UNSET
    status = {"code": 2} if span.tags.get("error") else {"code": 0}
    return {
        "status": status,
        "traceId": f"{span.context.trace_id & (2**128 - 1):032x}",
        "spanId": f"{span.context.span_id & (2**64 - 1):016x}",
        "parentSpanId": (
            f"{span.parent_id:016x}" if span.parent_id else ""
        ),
        "name": span.name,
        "kind": 1,  # SPAN_KIND_INTERNAL
        "startTimeUnixNano": str(start_ns),
        "endTimeUnixNano": str(start_ns + dur_ns),
        "attributes": [
            {
                "key": str(k),
                "value": {"stringValue": str(v)},
            }
            for k, v in span.tags.items()
            if k != "logs"
        ],
    }


class OTLPSpanExporter:
    def __init__(
        self,
        endpoint: str,
        batch_size: int = 64,
        flush_interval: float = 2.0,
        timeout: float = 5.0,
    ):
        self.endpoint = endpoint.rstrip("/")
        self.batch_size = batch_size
        self.flush_interval = flush_interval
        self.timeout = timeout
        self._q: "queue.Queue" = queue.Queue(maxsize=4096)
        self._stop = threading.Event()
        self.exported = 0
        self.dropped = 0
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def export(self, span) -> None:
        try:
            self._q.put_nowait(_otlp_span(span))
        except queue.Full:
            self.dropped += 1

    def _run(self) -> None:
        batch: list[dict] = []
        last = time.monotonic()
        while not self._stop.is_set():
            timeout = max(0.05, self.flush_interval - (time.monotonic() - last))
            try:
                batch.append(self._q.get(timeout=timeout))
            except queue.Empty:
                pass
            if batch and (
                len(batch) >= self.batch_size
                or time.monotonic() - last >= self.flush_interval
            ):
                self._post(batch)
                batch = []
                last = time.monotonic()
        if batch:
            self._post(batch)

    def _post(self, batch: list[dict]) -> None:
        body = json.dumps(
            {
                "resourceSpans": [
                    {
                        "resource": {
                            "attributes": [
                                {
                                    "key": "service.name",
                                    "value": {"stringValue": _SERVICE},
                                }
                            ]
                        },
                        "scopeSpans": [
                            {
                                "scope": {"name": _SERVICE},
                                "spans": batch,
                            }
                        ],
                    }
                ]
            }
        ).encode()
        req = urllib.request.Request(
            self.endpoint + "/v1/traces",
            data=body,
            method="POST",
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout):
                self.exported += len(batch)
        except Exception:
            self.dropped += len(batch)

    def flush(self, deadline: float = 5.0) -> None:
        """Best-effort wait for the queue to drain (tests)."""
        t0 = time.monotonic()
        while not self._q.empty() and time.monotonic() - t0 < deadline:
            time.sleep(0.02)
        # one more interval so the in-flight batch posts
        time.sleep(min(self.flush_interval + 0.1, deadline))

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)
