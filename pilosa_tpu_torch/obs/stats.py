"""Stats client (reference: stats/stats.go:31-65 StatsClient interface).

The reference defines a small tagged-metrics interface with pluggable
backends — expvar (stats/stats.go:84+), statsd/DataDog (statsd/statsd.go:48)
and Prometheus (prometheus/prometheus.go:52) — selected by the
``metric.service`` config key (server/server.go:397-411), with
``NopStatsClient`` as the zero default so instrumented code never
nil-checks.

Here the in-memory :class:`MemStatsClient` doubles as the expvar backend
(``/debug/vars`` JSON dump) and the Prometheus backend (text exposition via
:func:`prometheus_text`, served at ``/metrics`` — reference
http/handler.go:282). statsd wire output is out of scope (no egress), but
the interface point where it would plug in is the same.

Counterpart of ``pilosa_tpu/obs/stats.py``, the same code.
"""

from __future__ import annotations

import threading
import time
from typing import Iterable

from pilosa_tpu_torch.obs import tracing


def _ambient_trace_id() -> str | None:
    """The active span's trace id (32-hex) — the exemplar candidate a
    histogram observation records for its bucket."""
    span = tracing.active_span()
    if span is None:
        return None
    return f"{span.context.trace_id & (2**128 - 1):032x}"


class StatsClient:
    """Tagged metrics interface (reference stats/stats.go:31-65)."""

    def with_tags(self, *tags: str) -> "StatsClient":
        return self

    def count(self, name: str, value: int = 1, rate: float = 1.0) -> None:
        raise NotImplementedError

    def count_with_tags(
        self, name: str, value: int, rate: float, tags: Iterable[str]
    ) -> None:
        raise NotImplementedError

    def gauge(self, name: str, value: float) -> None:
        raise NotImplementedError

    def histogram(self, name: str, value: float) -> None:
        raise NotImplementedError

    def set_value(self, name: str, value: str) -> None:
        raise NotImplementedError

    def timing(self, name: str, seconds: float) -> None:
        raise NotImplementedError


class NopStatsClient(StatsClient):
    """Zero-cost default (reference stats.NopStatsClient)."""

    def count(self, name, value=1, rate=1.0):
        pass

    def count_with_tags(self, name, value, rate, tags):
        pass

    def gauge(self, name, value):
        pass

    def histogram(self, name, value):
        pass

    def set_value(self, name, value):
        pass

    def timing(self, name, seconds):
        pass


NOP = NopStatsClient()


# Prometheus-style cumulative bucket bounds.  Log-spaced seconds: the
# sub-ms bounds (50/100/250/500 µs) resolve the measured serving-cache
# floor of 0.07-0.16 ms/op (BENCH_r05) — without them every read-path
# latency collapses into the first bucket and p999 is meaningless — and
# the top end still covers multi-second cluster queries.
HISTOGRAM_BUCKETS = (
    0.00005, 0.0001, 0.00025, 0.0005,
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


class _Histo:
    __slots__ = ("count", "total", "min", "max", "buckets", "exemplars")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.buckets = [0] * len(HISTOGRAM_BUCKETS)
        # per-bucket exemplar candidate (trace_id_hex, value, unix_ts);
        # index len(HISTOGRAM_BUCKETS) is the +Inf bucket.  "Candidate"
        # because keep/drop is the trace store's tail decision — the
        # renderer filters against the kept set at scrape time.
        self.exemplars: list[tuple[str, float, float] | None] = [None] * (
            len(HISTOGRAM_BUCKETS) + 1
        )

    def observe(self, v: float, trace_id: str | None = None) -> None:
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        tight = len(HISTOGRAM_BUCKETS)  # +Inf unless a bound catches v
        for i, bound in enumerate(HISTOGRAM_BUCKETS):
            if v <= bound:
                self.buckets[i] += 1
                if i < tight:
                    tight = i
        if trace_id is not None:
            # tightest bucket only (OpenMetrics: one exemplar per bucket)
            self.exemplars[tight] = (trace_id, v, time.time())

    def to_dict(self) -> dict:
        buckets = {
            str(b): c for b, c in zip(HISTOGRAM_BUCKETS, self.buckets)
        }
        # Cumulative +Inf bucket: observations above the largest bound
        # land only here, so the bucket map always sums to count.
        buckets["+Inf"] = self.count
        return {
            "count": self.count,
            "sum": self.total,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
            "buckets": buckets,
        }


class MemStatsClient(StatsClient):
    """Thread-safe in-memory aggregator; the expvar/prometheus backend.

    Tag handling mirrors the reference's Prometheus backend, which turns
    ``"index:foo"`` tags into ``{index="foo"}`` labels
    (prometheus/prometheus.go:52+). Keys are (name, sorted-tags).
    """

    def __init__(self, tags: tuple[str, ...] = ()):
        self._lock = threading.Lock()
        self._tags = tuple(sorted(tags))
        # shared across with_tags children
        self._counters: dict[tuple[str, tuple[str, ...]], float] = {}
        self._gauges: dict[tuple[str, tuple[str, ...]], float] = {}
        self._histograms: dict[tuple[str, tuple[str, ...]], _Histo] = {}
        self._sets: dict[tuple[str, tuple[str, ...]], set[str]] = {}

    def with_tags(self, *tags: str) -> "MemStatsClient":
        child = MemStatsClient.__new__(MemStatsClient)
        child._lock = self._lock
        child._tags = tuple(sorted(set(self._tags) | set(tags)))
        child._counters = self._counters
        child._gauges = self._gauges
        child._histograms = self._histograms
        child._sets = self._sets
        return child

    def _key(self, name: str, extra: Iterable[str] = ()) -> tuple[str, tuple[str, ...]]:
        if extra:
            return name, tuple(sorted(set(self._tags) | set(extra)))
        return name, self._tags

    def count(self, name, value=1, rate=1.0):
        k = self._key(name)
        with self._lock:
            self._counters[k] = self._counters.get(k, 0) + value

    def count_with_tags(self, name, value, rate, tags):
        k = self._key(name, tags)
        with self._lock:
            self._counters[k] = self._counters.get(k, 0) + value

    def gauge(self, name, value):
        with self._lock:
            self._gauges[self._key(name)] = value

    def histogram(self, name, value):
        k = self._key(name)
        trace_id = _ambient_trace_id()
        with self._lock:
            h = self._histograms.get(k)
            if h is None:
                h = self._histograms[k] = _Histo()
            h.observe(value, trace_id)

    def get_counter(self, name: str, tags: Iterable[str] = ()) -> float:
        """Current value of one counter (0.0 when never incremented) —
        the flight recorder diffs these per segment."""
        k = self._key(name, tags)
        with self._lock:
            return self._counters.get(k, 0)

    def set_value(self, name, value):
        k = self._key(name)
        with self._lock:
            self._sets.setdefault(k, set()).add(value)

    def timing(self, name, seconds):
        self.histogram(name + "_seconds", seconds)

    # -- exposition ---------------------------------------------------------

    def snapshot(self) -> dict:
        """expvar-style JSON dump (reference ``/debug/vars``)."""

        def label(k):
            name, tags = k
            return name if not tags else name + "{" + ",".join(tags) + "}"

        with self._lock:
            return {
                "counters": {label(k): v for k, v in self._counters.items()},
                "gauges": {label(k): v for k, v in self._gauges.items()},
                "histograms": {
                    label(k): h.to_dict() for k, h in self._histograms.items()
                },
                "sets": {label(k): len(s) for k, s in self._sets.items()},
            }


class StatsDClient(StatsClient):
    """UDP statsd/DataDog backend (reference statsd/statsd.go:48 — the
    DataDog dogstatsd client with tag support, selected by
    ``metric.service = "statsd"``/``"datadog"``).

    Wire format per datagram: ``pilosa.<name>:<value>|<type>[|@rate][|#tags]``
    — counters ``c``, gauges ``g``, histograms/timings ``h``/``ms``,
    sets ``s``.  Fire-and-forget: send failures are swallowed (a
    metrics sink must never take the server down), matching the
    reference client's behavior."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 8125,
        prefix: str = "pilosa.",
        tags: tuple[str, ...] = (),
    ):
        import socket

        self._addr = (host, port)
        self._prefix = prefix
        self._tags = tuple(tags)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.setblocking(False)

    def with_tags(self, *tags: str) -> "StatsDClient":
        child = object.__new__(StatsDClient)
        child._addr = self._addr
        child._prefix = self._prefix
        child._sock = self._sock
        child._tags = self._tags + tuple(tags)
        return child

    def _send(
        self, name: str, value, typ: str, rate: float = 1.0,
        tags: Iterable[str] = (),
    ) -> None:
        msg = f"{self._prefix}{name}:{value}|{typ}"
        if rate != 1.0:
            msg += f"|@{rate}"
        all_tags = self._tags + tuple(tags)
        if all_tags:
            msg += "|#" + ",".join(all_tags)
        try:
            self._sock.sendto(msg.encode(), self._addr)
        except OSError:
            pass  # fire-and-forget

    def count(self, name, value=1, rate=1.0):
        self._send(name, value, "c", rate)

    def count_with_tags(self, name, value, rate, tags):
        self._send(name, value, "c", rate, tags)

    def gauge(self, name, value):
        self._send(name, value, "g")

    def histogram(self, name, value):
        self._send(name, value, "h")

    def set_value(self, name, value):
        self._send(name, value, "s")

    def timing(self, name, seconds):
        self._send(name, round(seconds * 1e3, 3), "ms")

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


def _prom_name(name: str) -> str:
    return "".join(c if c.isalnum() or c == "_" else "_" for c in name)


def _prom_escape(value: str) -> str:
    """Escape a label VALUE per the Prometheus text exposition spec:
    backslash, double-quote, and line-feed.  Tenant/index names are
    user-controlled, so a hostile ``evil"} 1`` tenant must not be able
    to forge metric lines or break strict scrapers."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _prom_labels(tags: tuple[str, ...]) -> str:
    if not tags:
        return ""
    parts = []
    for t in tags:
        k, _, v = t.partition(":")
        parts.append(f'{_prom_name(k)}="{_prom_escape(v)}"')
    return "{" + ",".join(parts) + "}"


def _prom_le_labels(tags: tuple[str, ...], bound) -> str:
    """Labels with the histogram ``le`` bucket bound merged in."""
    parts = []
    for t in tags:
        k, _, v = t.partition(":")
        parts.append(f'{_prom_name(k)}="{_prom_escape(v)}"')
    parts.append(f'le="{bound}"')
    return "{" + ",".join(parts) + "}"


# -- metric descriptions (# HELP) -------------------------------------------
#
# Registry keyed by the EXPOSED metric name (after the pilosa_ prefix
# and name mangling).  prometheus_text emits "# HELP" only for metrics
# registered here, immediately before the "# TYPE" line, so unregistered
# families keep byte-identical output.
_HELP: dict[str, str] = {}
_HELP_LOCK = threading.Lock()


def describe(name: str, text: str) -> None:
    """Register a one-line description for an exposed metric family
    (e.g. ``describe("pilosa_set_bit", "bits set via PQL Set()")``)."""
    with _HELP_LOCK:
        _HELP[name] = str(text)


def _help_escape(text: str) -> str:
    # HELP text escapes backslash and line-feed only (quotes are legal)
    return text.replace("\\", "\\\\").replace("\n", "\\n")


describe("pilosa_set_bit", "bits set via PQL Set() writes")
describe("pilosa_clear_bit", "bits cleared via PQL Clear() writes")
describe("pilosa_query_durationSeconds",
         "end-to-end PQL query latency through the executor")
describe("pilosa_http_request_durationSeconds",
         "HTTP request latency by route")
describe("pilosa_http_deadline_exceeded",
         "requests that ran out of deadline budget (504)")
describe("pilosa_serving_cache_hit",
         "warm repeat reads answered from the per-snapshot host cache")
describe("pilosa_batcher_depth", "queued requests inside the micro-batcher")
describe("pilosa_slo_error_budget_burn_rate",
         "per-class SRE multi-window error-budget burn rate")
describe("pilosa_dev_device_ms",
         "measured on-device milliseconds from the device cost ledger")
describe("pilosa_qos_shed_total",
         "requests shed (429) by the cost-governed admission ladder")
describe("pilosa_history_samples",
         "metrics-history sampler ticks recorded into the ring TSDB")
describe("pilosa_history_trend_incidents",
         "trend-detector incidents fired through the flight recorder")


def exemplar_suffix(
    ex: tuple[str, float, float] | None, exemplar_filter
) -> str:
    """OpenMetrics exemplar suffix for one bucket line, or "" — only
    exemplars whose trace survived tail sampling are exposed (the filter
    is membership in the trace store's kept set).  ``None`` filter means
    exemplars are off (plain exposition, the pre-exemplar output)."""
    if ex is None or exemplar_filter is None:
        return ""
    trace_id, value, ts = ex
    if not exemplar_filter(trace_id):
        return ""
    return f' # {{trace_id="{trace_id}"}} {value} {round(ts, 3)}'


def prometheus_text(client: StatsClient, exemplar_filter=None) -> str:
    """Render a MemStatsClient in Prometheus text exposition format
    (reference prometheus/prometheus.go:52, route http/handler.go:282).
    With ``exemplar_filter`` (a trace-id predicate), histogram bucket
    lines carry OpenMetrics ``# {trace_id="..."}`` exemplars for kept
    traces, so an operator jumps from a latency bucket straight to
    ``/debug/traces?id=``."""
    if not isinstance(client, MemStatsClient):
        return ""
    out: list[str] = []
    with client._lock:
        counters = dict(client._counters)
        gauges = dict(client._gauges)
        histos = {
            k: (h.count, h.total, list(h.buckets), list(h.exemplars))
            for k, h in client._histograms.items()
        }
        sets = {k: len(s) for k, s in client._sets.items()}
    seen: set[str] = set()

    with _HELP_LOCK:
        helps = dict(_HELP)

    def typ(name: str, t: str) -> None:
        if name not in seen:
            seen.add(name)
            h = helps.get(name)
            if h is not None:
                out.append(f"# HELP {name} {_help_escape(h)}")
            out.append(f"# TYPE {name} {t}")

    for (name, tags), v in sorted(counters.items()):
        n = "pilosa_" + _prom_name(name)
        typ(n, "counter")
        out.append(f"{n}{_prom_labels(tags)} {v}")
    for (name, tags), v in sorted(gauges.items()):
        n = "pilosa_" + _prom_name(name)
        typ(n, "gauge")
        out.append(f"{n}{_prom_labels(tags)} {v}")
    for (name, tags), (cnt, total, buckets, exemplars) in sorted(
        histos.items()
    ):
        n = "pilosa_" + _prom_name(name)
        typ(n, "histogram")
        for i, (bound, bcnt) in enumerate(zip(HISTOGRAM_BUCKETS, buckets)):
            ex = exemplar_suffix(exemplars[i], exemplar_filter)
            out.append(f"{n}_bucket{_prom_le_labels(tags, bound)} {bcnt}{ex}")
        ex = exemplar_suffix(exemplars[-1], exemplar_filter)
        out.append(f'{n}_bucket{_prom_le_labels(tags, "+Inf")} {cnt}{ex}')
        out.append(f"{n}_count{_prom_labels(tags)} {cnt}")
        out.append(f"{n}_sum{_prom_labels(tags)} {total}")
    for (name, tags), card in sorted(sets.items()):
        n = "pilosa_" + _prom_name(name) + "_cardinality"
        typ(n, "gauge")
        out.append(f"{n}{_prom_labels(tags)} {card}")
    return "\n".join(out) + "\n"
