"""Cost-governed multi-tenant QoS: weighted-fair admission, load
shedding, and degraded serving tiers (counterpart of
``pilosa_tpu/server/qos.py``).

A batcher that admits strictly FIFO lets one hot tenant occupy every
slot of every flight while the devledger (obs/devledger.py) measures the
damage and the SLO tracker (obs/slo.py) records the burn, with nothing to
close the loop.  This module is the controller: classic weighted-fair queueing in virtual time (WFQ/DRF,
the same family as the iteration-level admission schedulers the
batcher docstring cites), with tenant debt debited by MEASURED
per-tenant device-ms from the ledger rather than by query counts.

Scheduling — per-tenant virtual-time queues:

* every tenant carries a virtual start time ``vstart``; the scheduler
  always pops the tenant with the least ``vstart`` (global arrival
  sequence breaks ties, so equal-debt tenants stay FIFO);
* popping charges the tenant's estimated per-query device cost divided
  by its effective weight — cheap tenants interleave tightly, a tenant
  whose queries each burn milliseconds of device time falls behind in
  virtual time and yields slots;
* cost estimates are reconciled from the devledger on every governor
  tick: measured device-ms deltas per tenant, divided by the queries
  served since the last tick.  Debt accounting is EXACT — every
  measured millisecond lands in some tenant's ``debt_ms`` (the
  conservation property tests/test_qos.py holds the governor to);
* a tenant going idle re-enters at ``max(vstart, vtime)``: sleeping
  never banks credit (the standard WFQ catch-up rule).

Pressure ladder — three stages per tenant, driven by SLO pressure
(burn alerts firing or latency objectives violated) and the ledger's
view of who is paying for it:

1. **deprioritize** — the aggressor's effective weight is divided by
   ``down_factor``; it still runs, behind everyone else;
2. **degrade** — the aggressor's TopN/GroupBy queries are served from
   maintained views / last-known semantic-cache entries
   (exec/rescache.py ``lookup_stale``), explicitly marked
   ``"degraded": true`` in the response envelope;
3. **shed** — admission raises :class:`ShedError`, which the HTTP
   layer maps to ``429`` with a ``Retry-After`` header.  Never a
   silent 504: shed responses are attributed, counted per tenant, and
   do not burn the tenant's error budget (4xx are client-visible
   backpressure, not server failures).

An "aggressor" is only ever named when at least two tenants are
active and one of them owns a dominant share (``aggressor_share``) of
the measured device-ms rate — a single-tenant node under load is slow,
not abusive, and the ladder stays out of the way.

Every transition is journaled (obs/events.py) and surfaces in
``/debug/qos``; the FIRST escalation of a pressure episode hands one
incident to ``incident_fn`` (the node's flight recorder, through the
API; a no-op where the recorder is off).

In the port the debt is the device time of the kernels each tenant's
queries launched, read from the launches' CUDA event pairs
(``devledger.tenant_totals``); pairs still running on the card are read
at a later tick, so no measured millisecond is lost or counted twice.
"""

from __future__ import annotations

import contextvars
import queue
import threading
import time
from collections import deque

from pilosa_tpu_torch.obs import devledger

ADMIT = "admit"
DEGRADE = "degrade"

_MAX_TENANTS = 128  # governor state rows; beyond this, new tenants fold
_OVERFLOW_TENANT = "~overflow"
_MAX_TRANSITIONS = 32  # recent ladder transitions kept for /debug/qos

_STAGE_NAMES = ("normal", "deprioritized", "degraded", "shedding")


class ShedError(Exception):
    """Admission refused under stage-3 pressure; HTTP maps this to
    429 + Retry-After (server/http.py) — never a silent 504."""

    def __init__(self, tenant: str, retry_after: float):
        super().__init__(
            f"tenant {tenant!r} is being shed under device pressure; "
            f"retry after {retry_after:g}s"
        )
        self.tenant = tenant
        self.retry_after = float(retry_after)


# Request-scoped marker: the batcher sets it when a query was served
# from the degraded tier; API.query() takes it and stamps the response
# envelope (same note/take pattern as obs/slo.py note_class).
_degraded: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "pilosa_qos_degraded", default=False
)


def note_degraded() -> None:
    _degraded.set(True)


def take_degraded() -> bool:
    served = _degraded.get()
    if served:
        _degraded.set(False)
    return served


class _TenantState:
    """Per-tenant scheduler + ladder state (all mutation under the
    governor's condition lock)."""

    __slots__ = (
        "name", "weight", "stage", "stage_since", "vstart", "queue",
        "admitted", "served", "shed", "degraded", "debt_ms", "cost_est",
        "rate_ewma", "served_since_debit", "last_active",
        "admits_since_tick", "admits_last_tick", "admit_ewma",
    )

    def __init__(self, name: str, weight: float, now: float):
        self.name = name
        self.weight = max(float(weight), 1e-6)
        self.stage = 0
        self.stage_since = now
        self.vstart = 0.0
        self.queue: deque = deque()  # (seq, flight) arrival order
        self.admitted = 0  # admission decisions that let the query in
        self.served = 0  # flights actually popped by the dispatcher
        self.shed = 0  # 429s issued
        self.degraded = 0  # queries served from the degraded tier
        self.debt_ms = 0.0  # cumulative MEASURED device-ms (ledger)
        self.cost_est = 1.0  # EWMA device-ms per served query
        self.rate_ewma = 0.0  # EWMA device-ms per governor tick
        self.served_since_debit = 0
        self.last_active = now
        self.admits_since_tick = 0  # admission ATTEMPTS (incl. shed)
        self.admits_last_tick = 0  # attempts seen by the previous tick
        self.admit_ewma = 0.0  # EWMA attempts per governor tick

    def offered_load(self) -> float:
        """Estimated device-ms per tick this tenant is ASKING for:
        admission-attempt rate times the per-query cost estimate.
        Attempt-based on purpose — measured device-ms collapses the
        moment a tenant is deprioritized or shed, which would exonerate
        the aggressor mid-episode; a flooding client keeps attempting
        and so keeps owning the pressure."""
        return self.admit_ewma * max(self.cost_est, 1e-3)

    def effective_weight(self, down_factor: float) -> float:
        if self.stage <= 0:
            return self.weight
        return self.weight / (down_factor ** min(self.stage, 2))


class QosGovernor:
    """Weighted-fair admission queue + pressure-ladder controller.

    Doubles as the batcher's queue object: :meth:`put`/:meth:`get`/
    :meth:`empty` present the ``queue.Queue`` surface the dispatcher
    loop expects (including re-raising ``queue.Empty`` on timeout and
    replaying the batcher's stop sentinel once the queues drain, which
    preserves close()'s drain-then-exit contract).
    """

    def __init__(
        self,
        stats=None,
        weights: dict | None = None,
        enabled: bool = True,
        down_factor: float = 8.0,
        stage_hold: float = 2.0,
        relax_hold: float = 5.0,
        tick_interval: float = 0.25,
        retry_after: float = 1.0,
        aggressor_share: float = 0.5,
        active_window: float = 10.0,
        slo_fn=None,
        ledger_fn=None,
        journal_fn=None,
        incident_fn=None,
    ):
        self.stats = stats if hasattr(stats, "count_with_tags") else None
        self.enabled = bool(enabled)
        self.down_factor = max(float(down_factor), 1.0)
        self.stage_hold = float(stage_hold)
        self.relax_hold = float(relax_hold)
        self.tick_interval = float(tick_interval)
        self.retry_after = max(float(retry_after), 0.0)
        self.aggressor_share = float(aggressor_share)
        self.active_window = float(active_window)
        # Control-loop taps, injected late (NodeServer installs the
        # flight recorder after API construction): callables so the
        # governor never holds a stale reference.
        self._slo_fn = slo_fn  # () -> SLOTracker | None
        self._ledger_fn = ledger_fn  # () -> {tenant: {"deviceMs": ...}}
        self._journal_fn = journal_fn  # () -> EventJournal | None
        self._incident_fn = incident_fn  # (trigger: dict) -> None
        self._cond = threading.Condition()
        self._tenants: dict[str, _TenantState] = {}
        self._weights = dict(weights or {})
        self._vtime = 0.0
        self._seq = 0
        self._stop = None  # batcher's stop sentinel, replayed at drain
        self._last_tick = time.monotonic()
        self._ledger_last: dict[str, float] = {}
        self._episode_active = False
        self.episodes = 0
        self._transitions: deque = deque(maxlen=_MAX_TRANSITIONS)

    # -- tenant state ---------------------------------------------------------

    def _state_locked(self, tenant: str, now: float) -> _TenantState:
        ts = self._tenants.get(tenant)
        if ts is None:
            if len(self._tenants) >= _MAX_TENANTS:
                tenant = _OVERFLOW_TENANT
                ts = self._tenants.get(tenant)
                if ts is not None:
                    return ts
            ts = _TenantState(
                tenant, self._weights.get(tenant, 1.0), now
            )
            self._tenants[tenant] = ts
        return ts

    @staticmethod
    def _tenant_of(item) -> str:
        principal = getattr(item, "principal", None)
        if principal:
            return principal[0] or devledger.DEFAULT_TENANT
        return devledger.DEFAULT_TENANT

    # -- admission ------------------------------------------------------------

    def admit(self, tenant: str | None, can_degrade: bool = False) -> str:
        """Admission decision for one query.  Returns :data:`ADMIT` or
        :data:`DEGRADE`; raises :class:`ShedError` at stage 3."""
        tenant = tenant or devledger.DEFAULT_TENANT
        self.maybe_tick()
        now = time.monotonic()
        shed_exc = None
        counter = None
        with self._cond:
            ts = self._state_locked(tenant, now)
            ts.last_active = now
            ts.admits_since_tick += 1
            if self.enabled and ts.stage >= 3:
                ts.shed += 1
                counter = ("qos_shed", ts.name)
                shed_exc = ShedError(ts.name, self.retry_after)
            else:
                ts.admitted += 1
                counter = ("qos_admitted", ts.name)
                decision = (
                    DEGRADE
                    if self.enabled and ts.stage >= 2 and can_degrade
                    else ADMIT
                )
        if self.stats is not None:
            self.stats.count_with_tags(
                counter[0], 1, 1.0, (f"tenant:{counter[1]}",)
            )
        if shed_exc is not None:
            raise shed_exc
        return decision

    def note_degraded_served(self, tenant: str | None) -> None:
        tenant = tenant or devledger.DEFAULT_TENANT
        with self._cond:
            ts = self._state_locked(tenant, time.monotonic())
            ts.degraded += 1
        if self.stats is not None:
            self.stats.count_with_tags(
                "qos_degraded", 1, 1.0, (f"tenant:{tenant}",)
            )

    # -- queue surface (the batcher's dispatcher loop) ------------------------

    def put(self, item) -> None:
        """Enqueue a flight under its tenant's virtual-time queue.  An
        object without a ``principal`` is the batcher's stop sentinel:
        it is replayed by :meth:`get` only once every queue drains."""
        now = time.monotonic()
        if getattr(item, "principal", None) is None:
            with self._cond:
                self._stop = item
                self._cond.notify_all()
            return
        tenant = self._tenant_of(item)
        with self._cond:
            ts = self._state_locked(tenant, now)
            ts.last_active = now
            if not ts.queue:
                # idle catch-up: a sleeping tenant never banks credit
                ts.vstart = max(ts.vstart, self._vtime)
            self._seq += 1
            ts.queue.append((self._seq, item))
            self._cond.notify()

    def get(self, timeout: float | None = None):
        """Pop the flight with the least virtual start time; block like
        ``queue.Queue.get`` (raising ``queue.Empty`` on timeout)."""
        limit = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                best = None
                for ts in self._tenants.values():
                    if not ts.queue:
                        continue
                    key = (ts.vstart, ts.queue[0][0])
                    if best is None or key < best[0]:
                        best = (key, ts)
                if best is not None:
                    ts = best[1]
                    _, item = ts.queue.popleft()
                    # advance virtual time: charge the tenant's current
                    # cost estimate against its effective weight
                    self._vtime = ts.vstart
                    ts.vstart += max(ts.cost_est, 1e-3) / ts.effective_weight(
                        self.down_factor
                    )
                    ts.served += 1
                    ts.served_since_debit += 1
                    return item
                if self._stop is not None:
                    return self._stop
                if timeout is None:
                    self._cond.wait()
                else:
                    rem = limit - time.monotonic()
                    if rem <= 0:
                        raise queue.Empty
                    self._cond.wait(rem)

    def empty(self) -> bool:
        with self._cond:
            return self._stop is None and not any(
                ts.queue for ts in self._tenants.values()
            )

    def depth(self) -> int:
        with self._cond:
            return sum(len(ts.queue) for ts in self._tenants.values())

    # -- debt: measured device-ms from the ledger -----------------------------

    def observe_ledger(self, tenant_ms: dict) -> float:
        """Debit each tenant's debt by its measured device-ms delta and
        reconcile the per-query cost estimate.  Returns the total
        milliseconds debited (conservation: every measured ms lands in
        exactly one tenant's ``debt_ms``)."""
        now = time.monotonic()
        total = 0.0
        with self._cond:
            for tenant, ms in tenant_ms.items():
                ms = float(ms)
                if ms <= 0:
                    continue
                ts = self._state_locked(tenant, now)
                ts.debt_ms += ms
                ts.last_active = now
                total += ms
                if ts.served_since_debit > 0:
                    per = ms / ts.served_since_debit
                    ts.cost_est = 0.7 * ts.cost_est + 0.3 * per
                    ts.served_since_debit = 0
            # decay every rate EWMA each observation so a tenant that
            # went quiet stops looking like the aggressor
            for ts in self._tenants.values():
                ts.rate_ewma = 0.5 * ts.rate_ewma + 0.5 * float(
                    tenant_ms.get(ts.name, 0.0) or 0.0
                )
        return total

    # -- pressure ladder ------------------------------------------------------

    def maybe_tick(self, now: float | None = None) -> None:
        """Run one control-loop tick if the interval elapsed.  Called
        from admission and dispatch paths — the governor has no thread
        of its own."""
        if now is None:
            now = time.monotonic()
        with self._cond:
            if now - self._last_tick < self.tick_interval:
                return
            self._last_tick = now
        self.tick(now)

    def _ledger_deltas(self) -> dict:
        if self._ledger_fn is None:
            return {}
        try:
            totals = self._ledger_fn() or {}
        except Exception:  # a broken ledger tap must not take admission down
            return {}
        deltas = {}
        for tenant, row in totals.items():
            ms = float(row.get("deviceMs", 0.0)) if isinstance(row, dict) else float(row)
            prev = self._ledger_last.get(tenant, 0.0)
            if ms > prev:
                deltas[tenant] = ms - prev
            self._ledger_last[tenant] = ms
        return deltas

    def _under_pressure(self) -> bool:
        if self._slo_fn is None:
            return False
        try:
            tracker = self._slo_fn()
            pressure = tracker.pressure() if tracker is not None else None
        except Exception:  # an SLO tap failure reads as no pressure
            return False
        if not pressure:
            return False
        return bool(pressure.get("alerts") or pressure.get("latency"))

    def tick(self, now: float | None = None) -> list:
        """One ladder evaluation: debit ledger deltas, read SLO
        pressure, escalate the dominant aggressor or relax everyone.
        Returns the transitions it made (for tests)."""
        if now is None:
            now = time.monotonic()
        self.observe_ledger(self._ledger_deltas())
        pressure = self.enabled and self._under_pressure()
        transitions = []  # (tenant, old_stage, new_stage, reason)
        episode_started = False
        episode_ended = False
        incident = None
        with self._cond:
            for ts in self._tenants.values():
                ts.admits_last_tick = ts.admits_since_tick
                ts.admit_ewma = 0.5 * ts.admit_ewma + 0.5 * ts.admits_since_tick
                ts.admits_since_tick = 0
            # CONTENDERS are tenants that actually offered queries in
            # the last tick window (shed attempts count: a flooding
            # tenant stays a contender while its queries bounce).
            # Governance needs a live contest — two or more contenders
            # — not just recent activity: a decayed EWMA or a stale
            # last_active keeps the tenants of a FINISHED burst around
            # as ghosts for several ticks, and the sole live tenant of
            # the next workload phase would be designated aggressor
            # against nobody and shed.
            contenders = [
                ts
                for ts in self._tenants.values()
                if ts.admits_last_tick > 0
            ]
            if pressure and len(contenders) >= 2:
                # STICKY aggressor: a tenant already on the ladder stays
                # the episode's target as long as it keeps offering load.
                # Re-deriving the aggressor every tick would rotate the
                # ladder onto the victim the moment the real aggressor's
                # demand is suppressed — exactly the tenant the governor
                # exists to defend.  A designated tenant that genuinely
                # went quiet (admit_ewma ~ 0) releases the designation.
                elevated = [ts for ts in contenders if ts.stage > 0]
                if elevated:
                    aggressor = max(
                        elevated, key=lambda ts: (ts.stage, ts.offered_load())
                    )
                    share = None
                else:
                    total_load = sum(ts.offered_load() for ts in contenders)
                    aggressor = max(
                        contenders, key=lambda ts: ts.offered_load()
                    )
                    share = (
                        aggressor.offered_load() / total_load
                        if total_load > 0
                        else 0.0
                    )
                if (
                    (share is None or share >= self.aggressor_share)
                    and aggressor.stage < 3
                    and (now - aggressor.stage_since) >= self.stage_hold
                ):
                    old = aggressor.stage
                    aggressor.stage = old + 1
                    aggressor.stage_since = now
                    reason = (
                        "slo pressure persists; escalating designated"
                        " aggressor"
                        if share is None
                        else f"slo pressure; aggressor share {share:.2f}"
                        f" of offered load"
                    )
                    transitions.append(
                        (aggressor.name, old, aggressor.stage, reason)
                    )
                    if not self._episode_active:
                        self._episode_active = True
                        self.episodes += 1
                        episode_started = True
                        incident = {
                            "type": "qos-pressure",
                            "tenant": aggressor.name,
                            "stage": aggressor.stage,
                            "share": round(share, 3)
                            if share is not None
                            else None,
                            "reason": reason,
                        }
            else:
                # Stand down one rung per relax_hold when the contest is
                # over — pressure cleared, OR pressure persists but
                # fewer than two tenants are contending (no victim left
                # to defend; residual pressure is not this ladder's to
                # fix).
                reason = (
                    "pressure cleared"
                    if not pressure
                    else "no contending neighbor; standing down"
                )
                for ts in self._tenants.values():
                    if (
                        ts.stage > 0
                        and (now - ts.stage_since) >= self.relax_hold
                    ):
                        old = ts.stage
                        ts.stage = old - 1
                        ts.stage_since = now
                        transitions.append((ts.name, old, ts.stage, reason))
                if self._episode_active and not any(
                    ts.stage > 0 for ts in self._tenants.values()
                ):
                    self._episode_active = False
                    episode_ended = True
            for t in transitions:
                self._transitions.append(
                    {
                        "tenant": t[0],
                        "from": _STAGE_NAMES[t[1]],
                        "to": _STAGE_NAMES[t[2]],
                        "reason": t[3],
                    }
                )
        # journal / incident / metrics OUTSIDE the condition lock: the
        # sinks take their own locks (events journal, flight recorder)
        self._emit(transitions, episode_started, episode_ended, incident)
        return transitions

    def _emit(self, transitions, episode_started, episode_ended, incident):
        if self.stats is not None:
            for tenant, _old, new, _reason in transitions:
                self.stats.count_with_tags(
                    "qos_transition",
                    1,
                    1.0,
                    (f"tenant:{tenant}", f"stage:{_STAGE_NAMES[new]}"),
                )
        journal = None
        if self._journal_fn is not None:
            try:
                journal = self._journal_fn()
            except Exception:  # an observability tap, never load-bearing
                journal = None
        if journal is not None:
            from pilosa_tpu_torch.obs import events as events_mod

            for tenant, old, new, reason in transitions:
                journal.record(
                    events_mod.EVENT_QOS,
                    tenant=tenant,
                    fromStage=_STAGE_NAMES[old],
                    toStage=_STAGE_NAMES[new],
                    reason=reason,
                )
            if episode_ended:
                journal.record(
                    events_mod.EVENT_QOS,
                    tenant="*",
                    fromStage="episode",
                    toStage="clear",
                    reason="all tenants back to normal",
                )
        if episode_started and incident is not None and self._incident_fn:
            try:
                self._incident_fn(incident)
            except Exception:  # graftlint: disable=exception-hygiene -- incident capture is best-effort; shedding continues without it
                pass

    # -- introspection --------------------------------------------------------

    def snapshot(self) -> dict:
        """/debug/qos payload."""
        with self._cond:
            tenants = {
                ts.name: {
                    "weight": ts.weight,
                    "effectiveWeight": round(
                        ts.effective_weight(self.down_factor), 6
                    ),
                    "stage": ts.stage,
                    "stageName": _STAGE_NAMES[ts.stage],
                    "queued": len(ts.queue),
                    "admitted": ts.admitted,
                    "served": ts.served,
                    "shed": ts.shed,
                    "degraded": ts.degraded,
                    "debtMs": round(ts.debt_ms, 3),
                    "costEstMs": round(ts.cost_est, 4),
                }
                for ts in self._tenants.values()
            }
            return {
                "enabled": self.enabled,
                "vtime": round(self._vtime, 6),
                "episodes": self.episodes,
                "episodeActive": self._episode_active,
                "config": {
                    "downFactor": self.down_factor,
                    "stageHold": self.stage_hold,
                    "relaxHold": self.relax_hold,
                    "tickInterval": self.tick_interval,
                    "retryAfter": self.retry_after,
                    "aggressorShare": self.aggressor_share,
                },
                "tenants": tenants,
                "transitions": list(self._transitions),
            }
