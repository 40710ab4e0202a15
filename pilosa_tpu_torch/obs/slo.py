"""SLO plane: per-op-class latency quantiles and availability error
budgets at the HTTP/API boundary.

Every request is classified into an op class — read queries by their
top-level PQL call (``read.count``/``read.topn``/``read.row``/
``read.range``/``read.groupby``/``read.other``), ``write`` for any
query carrying a write call, ``import`` for the bulk paths,
``translate`` for key translation, ``internal`` for node↔node fan-out
sub-requests, ``other`` for everything else.  Per class the tracker
maintains:

* sliding-window latency quantiles (p50/p99/p999) over log-linear
  sub-ms buckets (10 µs floor — finer than obs/stats.py's histogram,
  which is what makes a 0.07-0.16 ms/op serving floor resolvable);
* availability over the multi-window multi-burn-rate scheme of the
  Google SRE Workbook (ch. 5): a "fast" page rule (1 h long / 5 m
  short windows at 14.4× budget burn) and a "slow" ticket rule
  (3 d / 6 h at 1×).  A rule fires only when BOTH its windows burn
  above the factor — the short window makes the alert reset quickly,
  the long window makes it ignore blips.

Errors are server-attributed failures: 5xx responses and deadline
504s — which is how batcher queue expiries and bypass timeouts
(server/batcher.py) land on the budget.  4xx client mistakes do not
burn budget.

Exposition: ``/debug/slo`` (full snapshot), ``pilosa_slo_*`` series in
``/metrics`` (rendered by :meth:`SLOTracker.prometheus_text`), and an
``slo`` block in ``/debug/vars``.

The op class crosses the API→HTTP layer boundary through a
contextvar (:func:`note_class`/:func:`take_class`): the API layer has
the parsed query, the HTTP layer has the response outcome and the
clock.  ThreadingHTTPServer runs one thread per connection and each
thread has its own context, so a class noted during dispatch is read
back by the same request's ``finally``.

Counterpart of ``pilosa_tpu/obs/slo.py``.
"""

from __future__ import annotations

import contextvars
import math
import threading
import time

from pilosa_tpu_torch.obs import devledger

# -- op classes ---------------------------------------------------------

OP_READ_COUNT = "read.count"
OP_READ_TOPN = "read.topn"
OP_READ_ROW = "read.row"
OP_READ_RANGE = "read.range"
OP_READ_GROUPBY = "read.groupby"
OP_READ_OTHER = "read.other"
OP_WRITE = "write"
OP_IMPORT = "import"
OP_TRANSLATE = "translate"
OP_INTERNAL = "internal"
OP_OTHER = "other"

_READ_CLASS_BY_CALL = {
    "Count": OP_READ_COUNT,
    "TopN": OP_READ_TOPN,
    "Row": OP_READ_ROW,
    "Range": OP_READ_RANGE,
    "GroupBy": OP_READ_GROUPBY,
}


def classify_query(query) -> str:
    """Op class of a parsed PQL query: any write call makes the whole
    request a write (strict in-order semantics mean the write dominates
    the request's fate); otherwise the FIRST top-level call names the
    read class."""
    if query.write_calls():
        return OP_WRITE
    calls = getattr(query, "calls", ())
    if calls:
        return _READ_CLASS_BY_CALL.get(calls[0].name, OP_READ_OTHER)
    return OP_READ_OTHER


# The API layer notes the class mid-dispatch; the HTTP layer's finally
# takes (and clears) it.  Default None = fall back to the route class.
_op_class: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "slo_op_class", default=None
)


def note_class(op_class: str) -> None:
    _op_class.set(op_class)


def take_class() -> str | None:
    c = _op_class.get()
    if c is not None:
        _op_class.set(None)
    return c


# -- per-tenant dimension ------------------------------------------------

# A tenant-scoped objective class is spelled "op_class@tenant": the
# tracker records a tenant's request under BOTH the base class and the
# tenant class, so global burn math is undisturbed while a tenant can
# carry its own objective/error budget (the QoS governor's per-victim
# signal, server/qos.py).
_TENANT_SEP = "@"

# Distinct non-default tenants auto-tracked without an explicit
# objective; bounds the /metrics class cardinality.
_MAX_TRACKED_TENANTS = 32


def tenant_class(op_class: str, tenant: str) -> str:
    return f"{op_class}{_TENANT_SEP}{tenant}"


# -- latency buckets ----------------------------------------------------

# Log-linear bounds (1/2.5/5 per decade), 10 µs .. 60 s.  Finer at the
# bottom than obs/stats.py HISTOGRAM_BUCKETS: quantile interpolation
# needs resolution below the serving floor, not just a bucket edge at it.
LATENCY_BOUNDS: tuple[float, ...] = tuple(
    round(m * 10.0**e, 10)
    for e in range(-5, 2)
    for m in (1.0, 2.5, 5.0)
) + (60.0,)
_N_BUCKETS = len(LATENCY_BOUNDS) + 1  # + overflow


class Objective:
    """One class's targets: availability (success ratio) and optionally
    a p99 latency bound in seconds."""

    __slots__ = ("availability", "latency_p99")

    def __init__(self, availability: float, latency_p99: float | None = None):
        if not (0.0 < availability < 1.0):
            raise ValueError("availability target must be in (0, 1)")
        self.availability = availability
        self.latency_p99 = latency_p99

    def to_dict(self) -> dict:
        return {
            "availability": self.availability,
            "latencyP99Ms": (
                self.latency_p99 * 1e3 if self.latency_p99 is not None else None
            ),
        }


class BurnRule:
    """One multi-window alert rule: fires when budget burn exceeds
    ``factor``× in BOTH the long and short windows (SRE Workbook ch. 5
    "multiwindow, multi-burn-rate alerts")."""

    __slots__ = ("name", "long", "short", "factor")

    def __init__(self, name: str, long: float, short: float, factor: float):
        self.name = name
        self.long = float(long)
        self.short = float(short)
        self.factor = float(factor)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "longWindow": _window_name(self.long),
            "shortWindow": _window_name(self.short),
            "factor": self.factor,
        }


DEFAULT_BURN_RULES: tuple[BurnRule, ...] = (
    BurnRule("fast", long=3600.0, short=300.0, factor=14.4),
    BurnRule("slow", long=259200.0, short=21600.0, factor=1.0),
)

# Objectives by class; classes absent here (other/internal) are tracked
# for volume/latency but carry no objective and never fail a verdict.
DEFAULT_OBJECTIVES: dict[str, Objective] = {
    OP_READ_COUNT: Objective(0.999, 0.050),
    OP_READ_TOPN: Objective(0.999, 0.100),
    OP_READ_ROW: Objective(0.999, 0.050),
    OP_READ_RANGE: Objective(0.999, 0.100),
    OP_READ_GROUPBY: Objective(0.99, 0.250),
    OP_READ_OTHER: Objective(0.99, 0.250),
    OP_WRITE: Objective(0.999, 0.050),
    OP_IMPORT: Objective(0.99, 1.0),
    OP_TRANSLATE: Objective(0.999, 0.050),
}


def _window_name(seconds: float) -> str:
    s = int(round(seconds))
    if s % 86400 == 0:
        return f"{s // 86400}d"
    if s % 3600 == 0:
        return f"{s // 3600}h"
    if s % 60 == 0:
        return f"{s // 60}m"
    return f"{s}s"


def _bucket_of(v: float) -> int:
    # LATENCY_BOUNDS is tiny (~22); linear scan beats bisect's call
    # overhead at this size and is branch-predictable for fast requests.
    for i, bound in enumerate(LATENCY_BOUNDS):
        if v <= bound:
            return i
    return _N_BUCKETS - 1


class _Ring:
    """Fixed ring of time slots covering ``window`` seconds; each slot
    is [abs_slot_idx, total, errors, bucket_counts].  A slot is lazily
    reset the first time an observation lands in a new time slice, so
    idle periods cost nothing."""

    __slots__ = ("slot_seconds", "slots")

    def __init__(self, window: float, slot_seconds: float):
        n = max(2, int(math.ceil(window / slot_seconds)) + 1)
        self.slot_seconds = slot_seconds
        self.slots: list[list] = [
            [-1, 0, 0, None] for _ in range(n)
        ]

    def observe(self, now: float, error: bool, bucket: int | None) -> None:
        idx = int(now / self.slot_seconds)
        slot = self.slots[idx % len(self.slots)]
        if slot[0] != idx:
            slot[0] = idx
            slot[1] = 0
            slot[2] = 0
            slot[3] = None
        slot[1] += 1
        if error:
            slot[2] += 1
        if bucket is not None:
            counts = slot[3]
            if counts is None:
                counts = slot[3] = [0] * _N_BUCKETS
            counts[bucket] += 1

    def sum_window(self, now: float, window: float) -> tuple[int, int]:
        """(total, errors) over the trailing ``window`` seconds."""
        lo = int((now - window) / self.slot_seconds) + 1
        hi = int(now / self.slot_seconds)
        total = errors = 0
        slots = self.slots
        n = len(slots)
        if hi - lo + 1 < n:
            # walk only the slot indices the window can cover — a
            # short window over a long-lived ring (e.g. the 5m burn
            # window over the 3d ring) is a tiny fraction of it
            for idx in range(lo, hi + 1):
                slot = slots[idx % n]
                if slot[0] == idx:
                    total += slot[1]
                    errors += slot[2]
        else:
            for slot in slots:
                if lo <= slot[0] <= hi:
                    total += slot[1]
                    errors += slot[2]
        return total, errors

    def merged_buckets(self, now: float, window: float) -> list[int]:
        lo = int((now - window) / self.slot_seconds) + 1
        hi = int(now / self.slot_seconds)
        out = [0] * _N_BUCKETS
        slots = self.slots
        n = len(slots)
        if hi - lo + 1 < n:
            candidates = [
                slot
                for idx in range(lo, hi + 1)
                for slot in (slots[idx % n],)
                if slot[0] == idx and slot[3] is not None
            ]
        else:
            candidates = [
                s for s in slots if lo <= s[0] <= hi and s[3] is not None
            ]
        for slot in candidates:
            counts = slot[3]
            for i in range(_N_BUCKETS):
                out[i] += counts[i]
        return out


def _quantile(buckets: list[int], q: float) -> float | None:
    """Interpolated quantile from per-bucket counts (not cumulative).
    Overflow observations report the top bound — a floor, stated as
    such in the snapshot (``p* >= 60s`` is still actionable)."""
    total = sum(buckets)
    if total == 0:
        return None
    rank = q * total
    cum = 0.0
    for i, c in enumerate(buckets):
        if c == 0:
            continue
        if cum + c >= rank:
            if i >= len(LATENCY_BOUNDS):
                return LATENCY_BOUNDS[-1]
            lo = LATENCY_BOUNDS[i - 1] if i > 0 else 0.0
            hi = LATENCY_BOUNDS[i]
            frac = (rank - cum) / c
            return lo + (hi - lo) * frac
        cum += c
    return LATENCY_BOUNDS[-1]


class _ClassState:
    __slots__ = ("total", "errors", "ring", "lat_buckets", "lat_sum",
                 "exemplars")

    def __init__(self, slot_seconds: float, max_window: float):
        self.total = 0
        self.errors = 0
        self.ring = _Ring(max_window, slot_seconds)
        # lifetime (non-windowed) duration histogram for the Prometheus
        # exposition — monotone, so scrapers can rate() it; the windowed
        # ring stays the quantile source.  Per-bucket counts, cumulated
        # at render time.
        self.lat_buckets = [0] * _N_BUCKETS
        self.lat_sum = 0.0
        # per-bucket (trace_id_hex, seconds, unix_ts): most recent trace
        # the tail sampler KEPT that landed in this bucket
        self.exemplars: list[tuple[str, float, float] | None] = (
            [None] * _N_BUCKETS
        )


class SLOTracker:
    """Thread-safe SLO accounting, one instance per Holder (wired like
    the event journal / job tracker).

    ``slot_seconds`` trades ring memory for window edge accuracy; the
    default 5 s keeps the 3 d ring at ~52k slots of four small fields
    per active class.  Tests shrink windows via ``burn_rules`` and
    ``latency_window`` so burn behavior is observable in milliseconds.
    """

    def __init__(
        self,
        objectives: dict[str, Objective] | None = None,
        burn_rules: tuple[BurnRule, ...] | None = None,
        slot_seconds: float = 5.0,
        latency_window: float = 300.0,
        budget_period: float = 30 * 86400.0,
    ):
        self.objectives = dict(
            DEFAULT_OBJECTIVES if objectives is None else objectives
        )
        self.burn_rules = tuple(
            DEFAULT_BURN_RULES if burn_rules is None else burn_rules
        )
        self.slot_seconds = float(slot_seconds)
        self.latency_window = float(latency_window)
        self.budget_period = float(budget_period)
        windows = {r.long for r in self.burn_rules} | {
            r.short for r in self.burn_rules
        }
        self._windows = tuple(sorted(windows))
        self._max_window = max(
            max(windows, default=latency_window), latency_window
        )
        self._lock = threading.Lock()
        self._classes: dict[str, _ClassState] = {}
        self._tenants_seen: set[str] = set()
        self.started = time.monotonic()

    # -- recording -----------------------------------------------------

    def observe(
        self,
        op_class: str,
        seconds: float,
        error: bool = False,
        tenant: str | None = None,
    ) -> None:
        """Record one request.  With ``tenant`` set, the request also
        lands under the tenant-scoped class ``op_class@tenant`` —
        always when that class carries an objective, and for up to
        ``_MAX_TRACKED_TENANTS`` distinct non-default tenants besides
        (cardinality stays bounded; the default tenant's traffic IS
        the base class, so it gets no duplicate row)."""
        bucket = _bucket_of(seconds)
        now = time.monotonic()
        with self._lock:
            keys = [op_class]
            if tenant:
                tkey = tenant_class(op_class, tenant)
                track = tkey in self.objectives
                if not track and tenant != devledger.DEFAULT_TENANT:
                    if tenant in self._tenants_seen:
                        track = True
                    elif len(self._tenants_seen) < _MAX_TRACKED_TENANTS:
                        self._tenants_seen.add(tenant)
                        track = True
                if track:
                    keys.append(tkey)
            for key in keys:
                st = self._classes.get(key)
                if st is None:
                    st = self._classes[key] = _ClassState(
                        self.slot_seconds, self._max_window
                    )
                st.total += 1
                if error:
                    st.errors += 1
                st.ring.observe(now, error, bucket)
                st.lat_buckets[bucket] += 1
                st.lat_sum += seconds

    def attach_exemplar(
        self, op_class: str, seconds: float, trace_id: str
    ) -> None:
        """Record a tail-KEPT trace as the exemplar for its latency
        bucket (wired from TraceStore.on_keep): /metrics bucket lines
        then point at a trace /debug/traces can actually serve."""
        bucket = _bucket_of(seconds)
        with self._lock:
            st = self._classes.get(op_class)
            if st is None:
                st = self._classes[op_class] = _ClassState(
                    self.slot_seconds, self._max_window
                )
            st.exemplars[bucket] = (trace_id, seconds, time.time())

    # -- exposition ----------------------------------------------------

    def _class_names(self) -> list[str]:
        names = set(self.objectives) | set(self._classes)
        return sorted(names)

    def series_sample(self) -> dict:
        """Cheap per-tick sample for the metrics-history ring
        (obs/history.py): active classes only, the latency window
        only.

        ``snapshot()`` walks every objective class across every burn
        window — exposition-grade work, wrong for a ~1 s sampler
        cadence.  This touches only classes that have observed traffic
        and only short-window slots, so its cost tracks live
        cardinality, not objective/burn-rule configuration."""
        now = time.monotonic()
        out: dict[str, dict] = {}
        with self._lock:
            for name, st in self._classes.items():
                obj = self.objectives.get(name)
                total, errors = st.ring.sum_window(
                    now, self.latency_window
                )
                merged = st.ring.merged_buckets(now, self.latency_window)
                p50 = _quantile(merged, 0.50)
                p99 = _quantile(merged, 0.99)
                ratio = errors / total if total else 0.0
                d = {
                    # lifetime counters: the sampler turns these into
                    # per-second rates by differencing ticks
                    "total": st.total,
                    "errors": st.errors,
                    "availability": 1.0 - ratio,
                    "p50Ms": p50 * 1e3 if p50 is not None else None,
                    "p99Ms": p99 * 1e3 if p99 is not None else None,
                }
                if obj is not None:
                    d["burnRate"] = ratio / (1.0 - obj.availability)
                out[name] = d
        return out

    def snapshot(self) -> dict:
        """Full live objective state — the /debug/slo payload."""
        now = time.monotonic()
        out_classes: dict[str, dict] = {}
        with self._lock:
            names = self._class_names()
            for name in names:
                st = self._classes.get(name)
                obj = self.objectives.get(name)
                budget = 1.0 - obj.availability if obj is not None else None
                win_out: dict[str, dict] = {}
                for w in self._windows:
                    total, errors = (
                        st.ring.sum_window(now, w) if st is not None else (0, 0)
                    )
                    ratio = errors / total if total else 0.0
                    d = {
                        "total": total,
                        "errors": errors,
                        "errorRatio": ratio,
                        "availability": 1.0 - ratio,
                    }
                    if budget:
                        burn = ratio / budget
                        d["burnRate"] = burn
                        # fraction of the budget_period error budget this
                        # window's burn consumes, were it sustained only
                        # for the window (SRE Workbook's accounting)
                        d["budgetConsumed"] = burn * (w / self.budget_period)
                    win_out[_window_name(w)] = d
                alerts = {}
                for rule in self.burn_rules:
                    lt, le = (
                        st.ring.sum_window(now, rule.long)
                        if st is not None
                        else (0, 0)
                    )
                    sht, she = (
                        st.ring.sum_window(now, rule.short)
                        if st is not None
                        else (0, 0)
                    )
                    firing = False
                    if budget and lt and sht:
                        firing = (
                            (le / lt) / budget >= rule.factor
                            and (she / sht) / budget >= rule.factor
                        )
                    alerts[rule.name] = firing
                merged = (
                    st.ring.merged_buckets(now, self.latency_window)
                    if st is not None
                    else [0] * _N_BUCKETS
                )
                lat_count = sum(merged)
                p50 = _quantile(merged, 0.50)
                p99 = _quantile(merged, 0.99)
                p999 = _quantile(merged, 0.999)
                latency_ok = None
                if obj is not None and obj.latency_p99 is not None and p99 is not None:
                    latency_ok = p99 <= obj.latency_p99
                ok = None
                if obj is not None:
                    ok = not any(alerts.values()) and latency_ok is not False
                out_classes[name] = {
                    "objective": obj.to_dict() if obj is not None else None,
                    "total": st.total if st is not None else 0,
                    "errors": st.errors if st is not None else 0,
                    "windows": win_out,
                    "latency": {
                        "window": _window_name(self.latency_window),
                        "count": lat_count,
                        "p50Ms": p50 * 1e3 if p50 is not None else None,
                        "p99Ms": p99 * 1e3 if p99 is not None else None,
                        "p999Ms": p999 * 1e3 if p999 is not None else None,
                    },
                    "alerts": alerts,
                    "latencyOk": latency_ok,
                    "ok": ok,
                }
        return {
            "slotSeconds": self.slot_seconds,
            "latencyWindow": _window_name(self.latency_window),
            "budgetPeriod": _window_name(self.budget_period),
            "burnRules": [r.to_dict() for r in self.burn_rules],
            "uptimeSeconds": now - self.started,
            "classes": out_classes,
        }

    def pressure(self) -> dict:
        """The QoS governor's control-loop tap (server/qos.py): the
        objective-bearing classes burning (a rule firing) or violating
        their latency objective now. Tenant-scoped classes (``op@tenant``)
        appear like any other, so the ladder sees one victim's budget
        burning."""
        snap = self.snapshot()
        alerts: list[tuple[str, str]] = []
        latency: list[str] = []
        for name, c in snap["classes"].items():
            if c["objective"] is None:
                continue
            for rule, firing in c["alerts"].items():
                if firing:
                    alerts.append((name, rule))
            if c["latencyOk"] is False:
                latency.append(name)
        return {"alerts": alerts, "latency": latency}

    def summary(self) -> dict:
        """Compact block for /debug/vars: totals and verdicts only."""
        snap = self.snapshot()
        return {
            "classes": {
                name: {
                    "total": c["total"],
                    "errors": c["errors"],
                    "p99Ms": c["latency"]["p99Ms"],
                    "ok": c["ok"],
                    "alerts": c["alerts"],
                }
                for name, c in snap["classes"].items()
            },
            "burnRules": snap["burnRules"],
        }

    def prometheus_text(self, exemplar_filter=None) -> str:
        """``pilosa_slo_*`` series for the /metrics scrape.  Rendered
        directly from the tracker (no MemStatsClient round trip): the
        windowed gauges are recomputed at scrape time and the counters
        are monotone from the lifetime totals.  With ``exemplar_filter``
        the per-class duration histogram carries OpenMetrics
        ``# {trace_id="..."}`` exemplars for tail-kept traces."""
        snap = self.snapshot()
        out: list[str] = []

        def typ(name: str, t: str) -> None:
            out.append(f"# TYPE {name} {t}")

        typ("pilosa_slo_requests_total", "counter")
        for name, c in snap["classes"].items():
            out.append(
                f'pilosa_slo_requests_total{{class="{name}"}} {c["total"]}'
            )
        typ("pilosa_slo_errors_total", "counter")
        for name, c in snap["classes"].items():
            out.append(
                f'pilosa_slo_errors_total{{class="{name}"}} {c["errors"]}'
            )
        typ("pilosa_slo_objective_availability", "gauge")
        for name, c in snap["classes"].items():
            if c["objective"] is not None:
                out.append(
                    f'pilosa_slo_objective_availability{{class="{name}"}}'
                    f' {c["objective"]["availability"]}'
                )
        typ("pilosa_slo_availability", "gauge")
        for name, c in snap["classes"].items():
            for wname, w in c["windows"].items():
                out.append(
                    f'pilosa_slo_availability{{class="{name}",window="{wname}"}}'
                    f' {w["availability"]}'
                )
        typ("pilosa_slo_burn_rate", "gauge")
        for name, c in snap["classes"].items():
            for wname, w in c["windows"].items():
                if "burnRate" in w:
                    out.append(
                        f'pilosa_slo_burn_rate{{class="{name}",window="{wname}"}}'
                        f' {w["burnRate"]}'
                    )
        typ("pilosa_slo_error_budget_consumed", "gauge")
        for name, c in snap["classes"].items():
            for wname, w in c["windows"].items():
                if "budgetConsumed" in w:
                    out.append(
                        "pilosa_slo_error_budget_consumed"
                        f'{{class="{name}",window="{wname}"}}'
                        f' {w["budgetConsumed"]}'
                    )
        typ("pilosa_slo_latency_seconds", "gauge")
        for name, c in snap["classes"].items():
            lat = c["latency"]
            for q, key in (("0.5", "p50Ms"), ("0.99", "p99Ms"), ("0.999", "p999Ms")):
                v = lat[key]
                if v is not None:
                    out.append(
                        f'pilosa_slo_latency_seconds{{class="{name}",quantile="{q}"}}'
                        f" {v / 1e3}"
                    )
        typ("pilosa_slo_alert", "gauge")
        for name, c in snap["classes"].items():
            for rule, firing in c["alerts"].items():
                out.append(
                    f'pilosa_slo_alert{{class="{name}",rule="{rule}"}}'
                    f" {1 if firing else 0}"
                )
        # Lifetime per-class duration histogram (distinct name from the
        # pilosa_slo_latency_seconds quantile gauges above): the series
        # that carries bucket exemplars pointing into /debug/traces.
        from pilosa_tpu_torch.obs.stats import exemplar_suffix

        with self._lock:
            hist = {
                name: (list(st.lat_buckets), st.lat_sum, list(st.exemplars))
                for name, st in self._classes.items()
            }
        typ("pilosa_slo_request_duration_seconds", "histogram")
        base = "pilosa_slo_request_duration_seconds"
        for name in sorted(hist):
            buckets, total, exemplars = hist[name]
            cum = 0
            for i, bound in enumerate(LATENCY_BOUNDS):
                cum += buckets[i]
                ex = exemplar_suffix(exemplars[i], exemplar_filter)
                out.append(
                    f'{base}_bucket{{class="{name}",le="{bound}"}} {cum}{ex}'
                )
            cum += buckets[-1]
            ex = exemplar_suffix(exemplars[-1], exemplar_filter)
            out.append(f'{base}_bucket{{class="{name}",le="+Inf"}} {cum}{ex}')
            out.append(f'{base}_count{{class="{name}"}} {cum}')
            out.append(f'{base}_sum{{class="{name}"}} {total}')
        return "\n".join(out) + "\n"


def objectives_from_dict(spec: dict) -> dict[str, Objective]:
    """Build an objectives map from a plain-dict config (NodeServer /
    InProcessCluster knob): ``{class: {"availability": 0.999,
    "latencyP99Ms": 50}}``.  Starts from the defaults; a class mapped
    to None drops its objective.

    The PER-TENANT dimension rides a ``"tenants"`` sub-spec::

        {"tenants": {"victim": {"read.count": {"availability": 0.99,
                                               "latencyP99Ms": 500}}}}

    which expands to tenant-scoped classes (``read.count@victim``) —
    the tracker then budgets that tenant's traffic separately and the
    QoS pressure ladder can defend it by name."""
    spec = dict(spec or {})
    tenants = spec.pop("tenants", None) or {}
    out = dict(DEFAULT_OBJECTIVES)

    def build(o):
        lat_ms = o.get("latencyP99Ms")
        return Objective(
            o.get("availability", 0.999),
            lat_ms / 1e3 if lat_ms is not None else None,
        )

    for name, o in spec.items():
        if o is None:
            out.pop(name, None)
            continue
        out[name] = build(o)
    for tenant, classes in tenants.items():
        for name, o in (classes or {}).items():
            key = tenant_class(name, tenant)
            if o is None:
                out.pop(key, None)
                continue
            out[key] = build(o)
    return out
