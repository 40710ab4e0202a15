"""Continuous-batching serving plane: coalesce concurrent queries into
micro-batched dispatches (counterpart of ``pilosa_tpu/server/batcher.py``).

Without it every HTTP handler thread runs its own query: each pays its
own host fan-out, and the handler threads launch kernels at once, so the
launches of one query interleave with every other's. This is the gap
continuous batching closed for inference servers (Orca's iteration-level
scheduling, vLLM's admission queue): the engine is fast, the front end
feeds it one request at a time.

Shape: handler threads (ThreadingHTTPServer is thread-per-connection)
:meth:`QueryBatcher.submit` their parsed read-only query and park on an
event; a single dispatcher thread collects an adaptive window of queued
requests and runs them as ONE ``Executor.execute_batch`` pass — the
``_batch_pair_counts``/``_batch_general``/``_batch_bsi`` paths share
launches across *requests*, not just within one request's call list —
then demultiplexes per-request results (or per-request errors) back to
the parked handlers. Every launch of a flight comes from that one
dispatcher thread; TopN and GroupBy calls run one by one there.

Window policy — the window closes on whichever fires first:

* ``size``   — the batch reached ``max_batch``;
* ``age``    — ``window`` seconds elapsed since collection began;
* ``empty``  — the queue is empty and nobody is mid-submit: a lone
  client must never pay window dead time;
* ``deadline`` — a collected request is too close to its budget to
  wait out the rest of the window;
* ``drain``  — shutdown: :meth:`close` stops admission and the
  dispatcher finishes everything already queued before exiting.

Deadline accounting (deadline.py): a request whose budget is already
spent 504s at admission without queuing; one that cannot survive the
window bypasses the queue and dispatches immediately on its own thread;
one that expires while queued is completed with DeadlineExceeded without
paying any device work. The dispatch itself runs under the most generous
remaining budget in the flight (each request re-checks its OWN budget on
wake-up, so a tight budget never truncates a neighbor's work, and an
expired one still 504s).

Observability: ``pilosa_batcher_*`` metrics (depth gauge, window closes
by reason, batch-size distribution, queue-wait histogram, deadline
bypasses/expiries) and per-request ``?profile=true`` attribution — a
``batcher.queueWait`` span tagged with batch size and close reason, a
``batcher.dispatch`` span, and the flight's shared execution profile
grafted as a sub-profile (kernel records of the batched launches, and the
planner's per-flight ``planner.flight`` note).

Write-bearing queries never enter the plane (strict in-order semantics
stay on the per-request path). On a node with peers the plane fronts the
distributed executor (``cluster/dist.py``): queries whose shard owners all
live in this process (``mesh_complete``) are admitted, and a flight of
them runs as one facade call through ``DistributedExecutor.execute_batch``;
fan-outs with an owner outside the process keep the direct path.

Admission is COST-GOVERNED, not FIFO (server/qos.py): each tenant has
a virtual-time weighted-fair queue whose debt is debited by the
device ledger's measured per-tenant device-ms, and the governor's pressure
ladder can deprioritize, degrade (TopN/GroupBy from last-known
semantic-cache entries, marked in the response) or shed (429 +
Retry-After via :class:`~pilosa_tpu_torch.server.qos.ShedError`) an
aggressor tenant when SLO burn alerts fire. The governor object IS
the queue — it presents ``put``/``get``/``empty`` to the dispatcher
loop below, so window policy and drain semantics are unchanged. A
flight's launches are split across the principals that rode it, in
proportion to their query count (``devledger.weighted_scope``).
"""

from __future__ import annotations

import logging
import queue
import threading
import time

from pilosa_tpu_torch import deadline
from pilosa_tpu_torch.deadline import DeadlineExceeded
from pilosa_tpu_torch.obs import devledger, qprofile
from pilosa_tpu_torch.server import qos as qos_mod

logger = logging.getLogger(__name__)

_STOP = object()


class _Flight:
    """One queued request: the demux slot its handler thread parks on."""

    __slots__ = (
        "index", "query", "shards", "event", "result", "error", "enqueued",
        "deadline_at", "profiling", "principal", "batch_size", "reason",
        "queue_wait", "dispatch_ms", "batch_profile",
    )

    def __init__(self, index: str, query, shards):
        self.index = index
        self.query = query
        self.shards = shards
        self.event = threading.Event()
        self.result: list | None = None
        self.error: BaseException | None = None
        self.enqueued = time.monotonic()
        # Snapshots of the request's ambient context: the dispatcher
        # thread has neither the deadline nor the profile contextvar.
        self.deadline_at = deadline.at()
        self.profiling = qprofile.profiling()
        # (tenant, index, op_class) for the device cost ledger: the
        # dispatcher attributes the shared batched launch fractionally
        # across every principal whose queries rode the flight.
        self.principal = devledger.current_principal()
        self.batch_size = 0
        self.reason = ""
        self.queue_wait = 0.0
        self.dispatch_ms = 0.0
        self.batch_profile: dict | None = None


class QueryBatcher:
    """Admission queue + dispatcher thread in front of an Executor."""

    def __init__(
        self,
        executor,
        stats=None,
        window: float = 0.002,
        max_batch: int = 64,
        prefetcher=None,
        qos=None,
    ):
        self.executor = executor
        # Flight-driven predictive prefetch (server/prefetch.py): the
        # admission queue knows a flight's full (index, query, shards)
        # set before any kernel launches, so not-yet-resident fragments
        # are staged on the ingest uploader — submit-time staging
        # overlaps the PREVIOUS flight's compute; the window-close pass
        # catches members whose submit-time staging was dropped.
        self.prefetcher = prefetcher
        # gauge/histogram exist on MemStatsClient but not on every
        # StatsClient implementation; degrade to no metrics, not errors
        self.stats = stats if hasattr(stats, "gauge") else None
        self.window = float(window)
        self.max_batch = int(max_batch)
        # The QoS governor doubles as the admission queue: per-tenant
        # virtual-time weighted-fair queues behind the queue.Queue
        # surface the dispatcher loop expects.  A standalone batcher
        # (no server wiring) gets a ladder-disabled governor — WFQ
        # scheduling is always on, pressure control needs SLO/ledger
        # taps. Its depth is bounded by the HTTP handler threads: each
        # blocks on its own flight's result before submitting again.
        self.qos = qos if qos is not None else qos_mod.QosGovernor(
            stats=stats, enabled=False
        )
        self._q = self.qos
        self._lock = threading.Lock()
        self._closed = False
        self._depth = 0  # submitted, not yet demuxed (includes in-flight)
        self._depth_peak = 0  # high-water mark since last take_depth_peak
        self.dispatched = 0  # flights dispatched (observability)
        self.coalesced = 0  # requests that shared a flight with >=1 other
        self.rescache_demux = 0  # members served from the semantic cache
        # the dispatcher is context-free by design: each _Flight snapshots
        # deadline_at/profiling/principal at submit and _dispatch rebuilds
        # the scopes per flight
        self._thread = threading.Thread(
            target=self._run, name="query-batcher", daemon=True
        )
        self._thread.start()

    @property
    def prefetching(self) -> bool:
        """The prefetcher warms the local executor's stacks. A node with
        peers runs its flights on the mesh route's facade executor, and
        over an index whose shards include the peers' the local executor
        would stack shards the node does not hold, so it does not prefetch
        while the executor it fronts has peers."""
        return self.prefetcher is not None and getattr(self.executor, "single", True)

    # -- admission (handler threads) ----------------------------------------

    def accepts(self, query) -> bool:
        """Read-only parsed queries ride the batch; writes keep strict
        in-order per-request semantics on the direct path."""
        return not self._closed and not query.write_calls()

    def _count_expired(self, tenant: str, reason: str) -> None:
        """Per-tenant, per-reason expiry counter (``batcher_expired``
        keeps its original meaning: expired while queued).  Incident
        bundles can then tell shed (qos_shed) from expired apart."""
        if self.stats is not None:
            self.stats.count_with_tags(
                "batcher_expired_by",
                1,
                1.0,
                (f"tenant:{tenant}", f"reason:{reason}"),
            )

    @staticmethod
    def _degradable(query) -> bool:
        """Only TopN/GroupBy ride the degraded tier: those are the
        shapes the result cache maintains views for, so a last-known
        answer is a meaningful dashboard, not a stale scalar."""
        calls = getattr(query, "calls", None)
        return bool(calls) and all(
            getattr(c, "name", "") in ("TopN", "GroupBy") for c in calls
        )

    def submit(self, index: str, query, shards=None) -> list:
        """Block the calling handler thread until its flight lands;
        returns the query's results or raises its error.  Runs in the
        request's own deadline scope and profile context."""
        tenant = devledger.current_tenant()
        try:
            deadline.check("batcher admission")
        except DeadlineExceeded:
            self._count_expired(tenant, "admission")
            raise
        # Admission control FIRST: a stage-3 tenant is shed (429 +
        # Retry-After upstream) before it can reach the deadline-bypass
        # or cache-probe fast paths — backpressure must not be dodged
        # by tightening the request budget.
        decision = self.qos.admit(
            tenant, can_degrade=self._degradable(query)
        )
        if decision == qos_mod.DEGRADE:
            stale = getattr(self.executor, "rescache_degraded", None)
            served = stale(index, query, shards) if stale is not None else None
            if served is not None:
                # explicitly-marked degraded tier: API.query() stamps
                # the response envelope from this request-scoped note
                qos_mod.note_degraded()
                self.qos.note_degraded_served(tenant)
                return served
            # no last-known answer: fall through and run it for real
            # (at the tenant's stage-reduced weight)
        if deadline.would_expire_within(self.window):
            # Too close to the budget to queue: dispatch-now beats
            # queue-then-504 (the request still pays only its own work).
            if self.stats is not None:
                self.stats.count("batcher_deadline_bypass", 1, 1.0)
            return self.executor.execute(index, query, shards=shards)
        # Semantic cache probe (exec/rescache.py): a member whose every
        # call hits demuxes instantly — no flight, no queue wait, no
        # device launch.  The probe runs on the handler thread with the
        # profile context live, so ?profile=true carries the
        # rescache.lookup span.
        probe = getattr(self.executor, "rescache_probe", None)
        if probe is not None:
            cached = probe(index, query, shards)
            if cached is not None:
                self.rescache_demux += 1
                if self.stats is not None:
                    self.stats.count("batcher_rescache_demux", 1, 1.0)
                return cached
        if self.prefetching:
            try:
                # stage this query's cold fragments NOW (handler thread,
                # profile context live -> residency.prefetch span): the
                # upload rides the uploader while the current flight
                # computes, instead of stalling this one's dispatch
                self.prefetcher.prefetch_query(index, query, shards)
            except Exception:
                logger.debug("prefetch failed", exc_info=True)
        item = _Flight(index, query, shards)
        with self._lock:
            direct = self._closed
            if not direct:
                self._depth += 1
                if self._depth > self._depth_peak:
                    self._depth_peak = self._depth
                if self.stats is not None:
                    self.stats.gauge("batcher_depth", self._depth)
                # put under the lock (never blocks: unbounded queue) so
                # close()'s _STOP is strictly FIFO-after every admission
                self._q.put(item)
        if direct:
            return self.executor.execute(index, query, shards=shards)
        rem = deadline.remaining()
        if not item.event.wait(rem if rem is not None else None):
            # our own budget died while queued/dispatching; the
            # dispatcher will still demux into the abandoned slot
            self._count_expired(tenant, "dispatch-wait")
            raise DeadlineExceeded("deadline exceeded (batched dispatch)")
        qprofile.annotate(
            "batcher.queueWait",
            duration_ms=item.queue_wait * 1e3,
            batchSize=item.batch_size,
            closeReason=item.reason,
        )
        qprofile.annotate("batcher.dispatch", duration_ms=item.dispatch_ms)
        if item.batch_profile is not None:
            qprofile.add_subprofile("batcher", item.batch_profile)
        deadline.check("batched response")
        if item.error is not None:
            raise item.error
        return item.result

    # -- dispatcher thread ---------------------------------------------------

    def _run(self) -> None:
        stopping = False
        while not stopping:
            first = self._q.get()
            if first is _STOP:
                break
            batch, reason = self._collect(first)
            stopping = reason == "drain"
            if self.prefetching:
                try:
                    # window close: the flight's full shard set is known;
                    # re-stage anything whose submit-time prefetch was
                    # dropped while the uploader serviced ingest
                    self.prefetcher.prefetch_flight(
                        [(f.index, f.query, f.shards) for f in batch]
                    )
                except Exception:
                    logger.debug("flight prefetch failed", exc_info=True)
            self._dispatch(batch, reason)
            # governor control loop rides the dispatcher cadence (it
            # has no thread of its own); admission paths tick it too,
            # so a quiet dispatcher still relaxes the ladder
            self.qos.maybe_tick()

    def _urgent(self, item: _Flight) -> bool:
        return (
            item.deadline_at is not None
            and item.deadline_at - time.monotonic() <= self.window
        )

    def _collect(self, first: _Flight) -> tuple[list[_Flight], str]:
        """Adaptive window: grow the batch until size, age, queue-empty
        or a deadline-urgent member closes it (whichever first)."""
        batch = [first]
        urgent = self._urgent(first)
        t_close = time.monotonic() + self.window
        while True:
            if len(batch) >= self.max_batch:
                return batch, "size"
            if urgent:
                return batch, "deadline"
            rem = t_close - time.monotonic()
            if rem <= 0:
                return batch, "age"
            with self._lock:
                idle = self._q.empty() and self._depth <= len(batch)
            if idle:
                # nobody queued or mid-submit: the window must not add
                # dead time (the lone-client latency guarantee)
                return batch, "empty"
            try:
                nxt = self._q.get(timeout=rem)
            except queue.Empty:
                return batch, "age"
            if nxt is _STOP:
                return batch, "drain"
            batch.append(nxt)
            urgent = urgent or self._urgent(nxt)

    def _dispatch(self, batch: list[_Flight], reason: str) -> None:
        now = time.monotonic()
        n = len(batch)
        self.dispatched += 1
        if n > 1:
            self.coalesced += n
        stats = self.stats
        if stats is not None:
            stats.count_with_tags(
                "batcher_window_close", 1, 1.0, (f"reason:{reason}",)
            )
            stats.histogram("batcher_batch_size", n)
        ready: list[_Flight] = []
        for item in batch:
            item.reason = reason
            item.batch_size = n
            item.queue_wait = now - item.enqueued
            if stats is not None:
                stats.timing("batcher_queue_wait", item.queue_wait)
            if item.deadline_at is not None and item.deadline_at <= now:
                # expired while queued: 504 without paying device work
                item.error = DeadlineExceeded(
                    "deadline exceeded (expired in batch queue)"
                )
                if stats is not None:
                    stats.count("batcher_expired", 1, 1.0)
                self._count_expired(item.principal[0], "batch-queue")
            else:
                ready.append(item)
        t0 = time.monotonic()
        try:
            if ready:
                budgets = [
                    f.deadline_at for f in ready if f.deadline_at is not None
                ]
                # Dispatch under the most GENEROUS budget in the flight
                # (each member re-checks its own on wake-up); one
                # budget-less member means an uncapped dispatch.
                budget = (
                    max(budgets) - t0 if len(budgets) == len(ready) else None
                )
                with deadline.scope(budget):
                    self._execute(ready)
        except BaseException as e:
            # a dispatch bug must never strand parked handler threads
            logger.exception("batch dispatch failed")
            for item in ready:
                if item.error is None and item.result is None:
                    item.error = e
        finally:
            dispatch_ms = (time.monotonic() - t0) * 1e3
            for item in batch:
                item.dispatch_ms = dispatch_ms
                item.event.set()
            with self._lock:
                self._depth -= n
                if stats is not None:
                    stats.gauge("batcher_depth", self._depth)

    def _execute(self, ready: list[_Flight]) -> None:
        # one flight may interleave indexes; each index group is one
        # execute_batch pass
        by_index: dict[str, list[_Flight]] = {}
        for item in ready:
            by_index.setdefault(item.index, []).append(item)
        for index, items in by_index.items():
            prof = None
            if any(item.profiling for item in items):
                # shared execution profile for the flight: kernel
                # records of the batched launch, grafted under every
                # profiled member as a sub-profile
                prof = qprofile.QueryProfile(
                    index, f"<batch of {len(items)}>"
                )
            # Weighted ledger attribution: one batched launch, split
            # across the distinct principals riding this flight in
            # proportion to their query count.
            counts: dict[tuple, int] = {}
            for item in items:
                counts[item.principal] = counts.get(item.principal, 0) + 1
            weights = [
                (p, n / len(items)) for p, n in counts.items()
            ]
            t0 = time.perf_counter()
            # window-close planning runs inside execute_batch (after the
            # cache probe, before the batched passes); snapshotting the
            # planner's monotonic counters around the dispatch turns
            # them into per-flight deltas on the shared profile
            # the planner lives on the local Executor either way (a node
            # with peers hands the batcher its distributed executor)
            pl = getattr(self.executor, "planner", None) or getattr(
                getattr(self.executor, "local", None), "planner", None
            )
            before = (
                (pl.cse_hits, pl.cse_shared, pl.reorders, pl.lane_overrides)
                if pl is not None
                else None
            )
            with qprofile.activate(prof), devledger.weighted_scope(weights):
                outs = self.executor.execute_batch(
                    index, [(item.query, item.shards) for item in items]
                )
                if prof is not None and before is not None:
                    qprofile.annotate(
                        "planner.flight",
                        0.0,
                        cseHits=pl.cse_hits - before[0],
                        cseShared=pl.cse_shared - before[1],
                        reorders=pl.reorders - before[2],
                        laneOverrides=pl.lane_overrides - before[3],
                    )
            prof_dict = None
            if prof is not None:
                prof.finish(time.perf_counter() - t0)
                prof_dict = prof.to_dict()
            for item, out in zip(items, outs):
                if isinstance(out, BaseException):
                    item.error = out
                else:
                    item.result = out
                if item.profiling:
                    item.batch_profile = prof_dict

    # -- lifecycle / introspection ------------------------------------------

    def take_depth_peak(self) -> int:
        """Depth high-water mark since the last call, then reset — the
        flight recorder's per-segment congestion signal (the live gauge
        misses bursts shorter than a scrape interval)."""
        with self._lock:
            peak = self._depth_peak
            self._depth_peak = self._depth
            return peak

    def snapshot(self) -> dict:
        """Serving-plane block for /debug/vars."""
        with self._lock:
            depth = self._depth
        return {
            "depth": depth,
            "window": self.window,
            "maxBatch": self.max_batch,
            "batches": self.dispatched,
            "coalesced": self.coalesced,
            "rescacheDemux": self.rescache_demux,
        }

    def close(self) -> None:
        """Stop admission and drain: every already-queued request is
        dispatched (or deadline-504'd) before the dispatcher exits."""
        with self._lock:
            if self._closed:
                already = True
            else:
                already = False
                self._closed = True
                self._q.put(_STOP)
        if not already or self._thread.is_alive():
            self._thread.join(timeout=30)
