"""Per-query profiling plane (``?profile=true``).

The reference Pilosa answers "where did my milliseconds go" with ~80
Jaeger spans; our TPU-native executor adds a dimension the Go lineage
never had — every call may run on one of three dispatch lanes (Pallas
kernel, XLA fallback, host op) with compile caches, serving caches and
host<->device transfers in between.  This module makes that attributable
to an individual query:

* a :class:`QueryProfile` collector carried in a ``contextvars.ContextVar``
  (the same ambient-context pattern as ``tracing._active_span``), so the
  executor, the kernels and the fan-out client all report into the query
  that is actually running — including across ``dist._submit`` worker
  threads, which copy the context;
* ``tracing.Span.__enter__/__exit__`` mirror every span into the profile
  tree, so per-PQL-call wall times and fan-out structure come for free
  from the existing instrumentation;
* ``ops/kernels.py``'s launch funnel appends a record per kernel launch
  (kernel, lane, wall ms) via :func:`record_kernel`;
* a node's tree keeps the ``subprofiles`` slot a cluster's coordinator
  grafts remote trees into, so the tree reads as JAX's;
* :class:`SlowQueryLog` keeps full profiles of the worst recent queries
  for ``/debug/slow-queries`` (reference: the ``long-query-time`` log
  line, upgraded from a log line to a ring of call trees).

Everything here is stdlib-only so ``tracing`` can import it without
cycles, and every hook is a no-op costing one ContextVar read when no
profile is active.

Counterpart of ``pilosa_tpu/obs/qprofile.py``, without what only its
cluster plane calls.
"""

from __future__ import annotations

import contextvars
import threading
import time

# Bound the per-profile kernel-record count: a pathological query
# (k-level GroupBy over thousands of combos) must not balloon the
# response or the slow-query ring.
MAX_KERNEL_RECORDS = 256

_active: contextvars.ContextVar["QueryProfile | None"] = contextvars.ContextVar(
    "pilosa_query_profile", default=None
)
_current_node: contextvars.ContextVar["_PNode | None"] = contextvars.ContextVar(
    "pilosa_profile_node", default=None
)


class _PNode:
    """One node of the profile call tree (mirrors one tracing span)."""

    __slots__ = ("name", "tags", "duration_ms", "children", "kernels",
                 "stats", "subprofiles")

    def __init__(self, name: str):
        self.name = name
        self.tags: dict = {}
        self.duration_ms: float | None = None
        self.children: list[_PNode] = []
        self.kernels: list[dict] = []
        self.stats: dict[str, float] = {}
        self.subprofiles: list[dict] = []

    def to_dict(self) -> dict:
        d: dict = {"name": self.name, "duration_ms": self.duration_ms}
        if self.tags:
            d["tags"] = {k: v for k, v in self.tags.items() if k != "logs"}
        if self.stats:
            d["stats"] = dict(self.stats)
        if self.kernels:
            d["kernels"] = list(self.kernels)
        if self.children:
            d["children"] = [c.to_dict() for c in self.children]
        if self.subprofiles:
            d["subprofiles"] = list(self.subprofiles)
        return d


class QueryProfile:
    """Collector for one query execution on one node.

    Tree mutation happens on the request thread and on fan-out pool
    threads (``dist._submit`` copies the context, so each worker's
    ``_current_node`` points at its own ``fanout`` child) — the lock
    guards the shared aggregates."""

    def __init__(self, index: str = "", query: str = "", node_id: str = ""):
        self.index = index
        self.query = query
        self.node_id = node_id
        self.started_at = time.time()
        self.duration_ms: float | None = None
        self.error: str | None = None
        self.root = _PNode("query")
        self._lock = threading.Lock()
        self._kernel_records = 0
        self._kernel_dropped = 0
        # ambient trace id (32-hex) captured at collection start: links
        # each slow-query-log entry to its /debug/traces record (lazy
        # import — tracing imports this module)
        from pilosa_tpu_torch.obs import tracing

        span = tracing.active_span()
        self.trace_id: str | None = (
            f"{span.context.trace_id & (2**128 - 1):032x}"
            if span is not None
            else None
        )

    def finish(self, elapsed: float, error: str | None = None) -> None:
        self.duration_ms = elapsed * 1e3
        self.error = error

    def to_dict(self) -> dict:
        d = {
            "node": self.node_id,
            "index": self.index,
            "query": self.query,
            "startedAt": self.started_at,
            "duration_ms": self.duration_ms,
            "tree": self.root.to_dict(),
        }
        if self.trace_id is not None:
            d["traceId"] = self.trace_id
        if self.error is not None:
            d["error"] = self.error
        if self._kernel_dropped:
            d["kernelRecordsDropped"] = self._kernel_dropped
        return d


def profiling() -> bool:
    """True when a profile collector is active in this context."""
    return _active.get() is not None


def span_enter(name: str):
    """Open a profile tree node; returns an opaque handle for
    :func:`span_exit`, or ``None`` when no profile is active.  Called by
    ``tracing.Span.__enter__`` for every span regardless of tracer."""
    prof = _active.get()
    if prof is None:
        return None
    parent = _current_node.get() or prof.root
    node = _PNode(name)
    with prof._lock:
        parent.children.append(node)
    token = _current_node.set(node)
    return node, token, time.perf_counter()


def span_exit(handle, tags: dict | None = None) -> None:
    if handle is None:
        return
    node, token, t0 = handle
    node.duration_ms = (time.perf_counter() - t0) * 1e3
    if tags:
        node.tags.update(tags)
    _current_node.reset(token)


class span:
    """Profile-only span context manager for sites that are too hot or
    too fine-grained for a tracing span (fan-out legs, cache probes).
    Costs one ContextVar read when inactive."""

    __slots__ = ("_name", "_tags", "_handle")

    def __init__(self, name: str, **tags):
        self._name = name
        self._tags = tags
        self._handle = None

    def __enter__(self) -> "span":
        if _active.get() is not None:
            self._handle = span_enter(self._name)
        return self

    def __exit__(self, *exc) -> None:
        span_exit(self._handle, self._tags)
        self._handle = None


def record_kernel(**rec) -> None:
    """Append one kernel-dispatch record to the current tree node
    (called from ``ops/kernels.py`` on every instrumented dispatch)."""
    prof = _active.get()
    if prof is None:
        return
    node = _current_node.get() or prof.root
    with prof._lock:
        if prof._kernel_records >= MAX_KERNEL_RECORDS:
            prof._kernel_dropped += 1
            return
        prof._kernel_records += 1
        node.kernels.append(rec)


def annotate(name: str, duration_ms: float | None = None, **tags) -> None:
    """Append a pre-measured child span to the current profile node.

    For stages timed OUTSIDE the request's own context: the batcher's
    dispatcher thread measures queue wait and batch dispatch without an
    active profile, and the submitting thread records those numbers
    into its own profile after wake-up.  No-op without a profile."""
    prof = _active.get()
    if prof is None:
        return
    parent = _current_node.get() or prof.root
    node = _PNode(name)
    node.duration_ms = duration_ms
    if tags:
        node.tags.update(tags)
    with prof._lock:
        parent.children.append(node)


def incr(name: str, n: float = 1) -> None:
    """Bump a per-node counter (serving-cache hits and friends)."""
    prof = _active.get()
    if prof is None:
        return
    node = _current_node.get() or prof.root
    with prof._lock:
        node.stats[name] = node.stats.get(name, 0) + n


def add_subprofile(node_id: str, tree: dict | None) -> None:
    """Graft a profile dict under the current node: the batcher's shared
    flight profile under each profiled member (``server/batcher.py``)."""
    prof = _active.get()
    if prof is None or not tree:
        return
    node = _current_node.get() or prof.root
    with prof._lock:
        node.subprofiles.append({"node": node_id, "profile": tree})


class activate:
    """Install ``profile`` as the ambient collector for a ``with`` block
    (no-op when ``profile`` is None)."""

    __slots__ = ("_profile", "_token", "_node_token")

    def __init__(self, profile: QueryProfile | None):
        self._profile = profile
        self._token = None
        self._node_token = None

    def __enter__(self) -> QueryProfile | None:
        if self._profile is not None:
            self._token = _active.set(self._profile)
            self._node_token = _current_node.set(self._profile.root)
        return self._profile

    def __exit__(self, *exc) -> None:
        if self._token is not None:
            _current_node.reset(self._node_token)
            _active.reset(self._token)
            self._token = None
            self._node_token = None


class SlowQueryLog:
    """Bounded ring of the worst recent query profiles (reference
    ``long-query-time`` config; served at ``/debug/slow-queries``)."""

    def __init__(self, threshold: float = 0.0, capacity: int = 32):
        self.threshold = threshold
        self.capacity = capacity
        self._lock = threading.Lock()
        self._entries: list[dict] = []

    @property
    def enabled(self) -> bool:
        return self.threshold > 0.0

    def observe(self, profile: QueryProfile) -> None:
        if not self.enabled or profile.duration_ms is None:
            return
        if profile.duration_ms < self.threshold * 1e3:
            return
        entry = {
            "index": profile.index,
            "query": profile.query,
            "elapsed_ms": profile.duration_ms,
            "at": profile.started_at,
            "profile": profile.to_dict(),
        }
        with self._lock:
            self._entries.append(entry)
            if len(self._entries) > self.capacity:
                # keep the worst `capacity` of the recent window
                self._entries.sort(key=lambda e: -e["elapsed_ms"])
                del self._entries[self.capacity:]

    def snapshot(self) -> dict:
        with self._lock:
            worst = sorted(self._entries, key=lambda e: -e["elapsed_ms"])
            return {
                "threshold": self.threshold,
                "count": len(worst),
                "queries": worst,
            }

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
