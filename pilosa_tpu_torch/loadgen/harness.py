"""Open-loop load harness (counterpart of ``pilosa_tpu/loadgen/harness.py``):
drive a deterministic workload through the real HTTP path of the port's
nodes and measure it against the server's SLO plane.

Open-loop means arrivals are SCHEDULED, not request-response paced: op
``k`` of a stage targeting ``rate`` ops/s is due at ``t0 + k/rate``
regardless of how the previous op fared, and its latency is measured
from its *scheduled* time — the standard defense against coordinated
omission (a slow server can't slow the clock that judges it).  Workers
pull due ops from a bounded queue; when every worker is wedged the
dispatcher blocks on the queue and the lost schedule time is charged to
the ops' latencies, not silently dropped.

Stages ramp concurrency/rate and can override the op mix — the default
stage plan in ``pilosa_tpu_torch/loadgen/__main__.py`` includes a time-quantum-heavy stage
(streaming timestamped SetBit with concurrent time-Range queries) and a
full-mix ramp.  Faults (testing/faults.py) can be injected for
error-budget exercises.  :func:`run_harness` boots its nodes on ``cuda``
unless the caller asks for ``device="cpu"``; where CUDA is missing it
raises, as the nodes do.
"""

from __future__ import annotations

import http.client
import json
import logging
import math
import queue
import threading
import time
import urllib.parse

from pilosa_tpu_torch.loadgen import report as report_mod
from pilosa_tpu_torch.loadgen.workload import (
    WorkloadConfig,
    WorkloadGenerator,
    fingerprint,
    schema_ops,
)

logger = logging.getLogger(__name__)

_HTTP_TIMEOUT = 30.0


class StageSpec:
    """One load stage: ``rate`` ops/s for ``duration`` seconds across
    ``workers`` concurrent connections, drawing kinds from ``mix``
    (None = the workload config's mix).

    ``device_budget`` (bytes) caps the process-wide HBM budget for the
    stage's duration and restores the previous cap after — the
    oversubscription knob: a stage whose working set exceeds the cap
    runs under live eviction pressure, and its report entry carries the
    residency hit/miss/prefetch rates observed while it ran
    (docs/residency.md).

    ``repeat_pool`` (template count) switches the stage's reads to the
    repeat-heavy generator (``WorkloadGenerator.sequence_repeat``):
    reads recur zipfian over that many fixed query templates while
    writes keep randomizing — the dashboard-refresh shape that
    exercises the semantic result cache, whose per-stage hit/
    invalidation deltas land in the report entry (docs/caching.md).

    ``shared_pool`` (template count) switches the stage's reads to the
    shared-subtree flight generator (``WorkloadGenerator.
    sequence_shared``): each read is one multi-call query whose calls
    embed a common canonical subtree, the shape the flight planner's
    cross-query CSE exists for — the stage's report entry carries the
    planner's per-stage cseHits/reorders deltas (docs/serving.md
    "Flight planning").

    ``tenant`` stamps every request of the stage with an
    ``X-Pilosa-Tenant`` header, so the stage's device work lands under
    that principal in the device cost ledger (docs/observability.md);
    the per-stage ``devcosts`` delta and the report's top-level
    ``devcosts`` block show the attribution.

    ``tenants`` (``{name: share}``) splits ONE stage's offered load
    across several tenants by weighted interleave — the QoS overload
    shape (docs/robustness.md "Governed admission"): a victim at share
    1 and an aggressor at share 10 ride the same open-loop schedule,
    and the report's per-tenant breakdown shows who got shed/degraded
    and who kept their latency.  Mutually exclusive with ``tenant``."""

    def __init__(
        self,
        name: str,
        duration: float,
        rate: float,
        workers: int,
        mix: dict[str, float] | None = None,
        device_budget: int | None = None,
        repeat_pool: int | None = None,
        tenant: str | None = None,
        shared_pool: int | None = None,
        tenants: dict[str, float] | None = None,
    ):
        self.name = name
        self.duration = float(duration)
        self.rate = float(rate)
        self.workers = int(workers)
        self.mix = mix
        self.device_budget = (
            int(device_budget) if device_budget is not None else None
        )
        self.repeat_pool = int(repeat_pool) if repeat_pool else None
        self.tenant = str(tenant) if tenant else None
        self.shared_pool = int(shared_pool) if shared_pool else None
        self.tenants = (
            {str(t): float(s) for t, s in tenants.items()} if tenants else None
        )
        if self.tenant and self.tenants:
            raise ValueError("tenant and tenants are mutually exclusive")

    @property
    def op_count(self) -> int:
        return max(1, int(math.ceil(self.duration * self.rate)))

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "duration": self.duration,
            "rate": self.rate,
            "workers": self.workers,
            "mix": self.mix,
            "deviceBudget": self.device_budget,
            "repeatPool": self.repeat_pool,
            "tenant": self.tenant,
            "sharedPool": self.shared_pool,
            "tenants": self.tenants,
        }


def prepare_schema(cluster, config: WorkloadConfig) -> None:
    """Create the workload's indexes/fields through the API (idempotent
    across harness reruns on one cluster)."""
    from pilosa_tpu_torch.server.api import ConflictError

    for kind, name, options in schema_ops(config):
        try:
            if kind == "index":
                cluster.create_index(name, options)
            else:
                index, _, field = name.partition("/")
                cluster.create_field(index, field, options)
        except ConflictError:
            pass


def preload(cluster, config: WorkloadConfig, bits: int = 4096) -> None:
    """Deterministic seed data so reads have something to find: zipfian
    (row, col) pairs into the segmentation field, plus int values into
    the BSI field so range_bsi predicates select non-empty rows from the
    first request (not only after set_val writes accumulate)."""
    import numpy as np

    from pilosa_tpu_torch.loadgen.workload import (
        BSI_FIELD,
        BSI_VAL_MAX,
        BSI_VAL_MIN,
        Zipf,
    )

    rng = np.random.default_rng(config.seed ^ 0x5EED)
    rz = Zipf(config.n_rows, config.zipf_theta)
    cz = Zipf(config.n_cols, config.zipf_theta)
    pairs = [(rz.sample(rng), cz.sample(rng)) for _ in range(bits)]
    cluster.import_bits(config.index, "seg", pairs)
    vcols = sorted({cz.sample(rng) for _ in range(bits // 2)})
    vvals = [
        int(v)
        for v in rng.integers(BSI_VAL_MIN, BSI_VAL_MAX, size=len(vcols))
    ]
    cluster.import_values(config.index, BSI_FIELD, vcols, vvals)


class _WorkerResult:
    __slots__ = ("records", "client_errors")

    def __init__(self):
        # (op_class, latency_s, service_s, ok, status, tenant)
        self.records: list[tuple[str, float, float, bool, int, str | None]] = []
        self.client_errors = 0


def _tenant_schedule(tenants: dict[str, float], n: int) -> list[str]:
    """Deterministic weighted interleave of ``n`` slots across tenants.

    Credit-based (smooth weighted round-robin): every slot each tenant
    earns its share, the richest tenant is picked and pays the total.
    A {victim: 1, aggressor: 10} split therefore ISSUES interleaved —
    the victim's requests are spread through the aggressor's flood, not
    batched before/after it, so the governor sees concurrent pressure."""
    names = sorted(tenants)
    total = sum(tenants[t] for t in names) or 1.0
    credit = dict.fromkeys(names, 0.0)
    out: list[str] = []
    for _ in range(n):
        for t in names:
            credit[t] += tenants[t]
        pick = max(names, key=lambda t: (credit[t], t))
        credit[pick] -= total
        out.append(pick)
    return out


def _worker(
    base: str,
    q: "queue.Queue",
    out: _WorkerResult,
    stop: threading.Event,
    tenant: str | None = None,
) -> None:
    netloc = urllib.parse.urlsplit(base).netloc
    conn = http.client.HTTPConnection(netloc, timeout=_HTTP_TIMEOUT)
    headers = {"Content-Type": ""}
    try:
        while not stop.is_set():
            item = q.get()
            if item is None:
                return
            op, sched, op_tenant = item
            eff_tenant = op_tenant or tenant
            now = time.monotonic()
            if sched > now:
                time.sleep(sched - now)
            t_start = time.monotonic()
            status = 0
            try:
                headers["Content-Type"] = op.ctype
                if eff_tenant:
                    headers["X-Pilosa-Tenant"] = eff_tenant
                else:
                    headers.pop("X-Pilosa-Tenant", None)
                conn.request(
                    op.method,
                    op.path,
                    body=op.body,
                    headers=headers,
                )
                resp = conn.getresponse()
                resp.read()
                status = resp.status
            except (OSError, http.client.HTTPException):
                # connection-level failure: count it, reconnect, move on
                out.client_errors += 1
                conn.close()
                conn = http.client.HTTPConnection(netloc, timeout=_HTTP_TIMEOUT)
            done = time.monotonic()
            ok = 200 <= status < 400
            out.records.append(
                (op.op_class, done - sched, done - t_start, ok, status,
                 eff_tenant)
            )
    finally:
        conn.close()


def _fetch_json(base: str, path: str) -> dict | None:
    netloc = urllib.parse.urlsplit(base).netloc
    conn = http.client.HTTPConnection(netloc, timeout=_HTTP_TIMEOUT)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        body = resp.read()
        if resp.status != 200:
            return None
        return json.loads(body)
    except (OSError, ValueError, http.client.HTTPException):
        return None
    finally:
        conn.close()


def _residency_counters(base: str) -> dict | None:
    """Monotonic residency counters from /debug/vars, flattened for
    delta arithmetic (None when the node predates the residency plane)."""
    dbg = _fetch_json(base, "/debug/vars")
    if not dbg or "residency" not in dbg:
        return None
    res = dbg.get("residency") or {}
    dev = dbg.get("device") or {}
    return {
        "deviceHits": res.get("deviceHits", 0),
        "deviceMisses": res.get("deviceMisses", 0),
        "prefetchIssued": res.get("prefetchIssued", 0),
        "prefetchUseful": res.get("prefetchUseful", 0),
        "evictions": dev.get("evictions", 0),
    }


def _residency_delta(
    before: dict | None, after: dict | None
) -> dict | None:
    if before is None or after is None:
        return None
    delta = {k: after[k] - before[k] for k in before}
    lookups = delta["deviceHits"] + delta["deviceMisses"]
    delta["hitRate"] = (
        delta["deviceHits"] / lookups if lookups else None
    )
    issued = delta["prefetchIssued"]
    delta["prefetchUsefulFrac"] = (
        delta["prefetchUseful"] / issued if issued else None
    )
    return delta


def _rescache_counters(base: str) -> dict | None:
    """Monotonic semantic-cache counters from /debug/vars, for per-stage
    delta arithmetic (None when the node predates the cache plane)."""
    dbg = _fetch_json(base, "/debug/vars")
    if not dbg or "rescache" not in dbg:
        return None
    rc = dbg.get("rescache") or {}
    batcher = dbg.get("batcher") or {}
    return {
        "hits": rc.get("hits", 0),
        "misses": rc.get("misses", 0),
        "invalidations": rc.get("invalidations", 0),
        "promotions": rc.get("promotions", 0),
        "maintainedHits": rc.get("maintainedHits", 0),
        "rescacheDemux": batcher.get("rescacheDemux", 0),
    }


def _rescache_delta(before: dict | None, after: dict | None) -> dict | None:
    if before is None or after is None:
        return None
    delta = {k: after[k] - before[k] for k in before}
    lookups = delta["hits"] + delta["misses"]
    delta["hitRate"] = delta["hits"] / lookups if lookups else None
    return delta


def _planner_counters(base: str) -> dict | None:
    """Monotonic flight-planner counters from /debug/vars, for per-stage
    delta arithmetic (None when the node predates the planner)."""
    dbg = _fetch_json(base, "/debug/vars")
    if not dbg or "planner" not in dbg:
        return None
    pl = dbg.get("planner") or {}
    return {
        "cseHits": pl.get("cseHits", 0),
        "cseShared": pl.get("cseShared", 0),
        "reorders": pl.get("reorders", 0),
        "laneOverrides": pl.get("laneOverrides", 0),
        "errors": pl.get("errors", 0),
    }


def _planner_delta(before: dict | None, after: dict | None) -> dict | None:
    if before is None or after is None:
        return None
    return {k: after[k] - before[k] for k in before}


def _devcost_counters(base: str) -> dict | None:
    """Monotonic device-cost-ledger totals from /debug/devcosts,
    flattened for per-stage delta arithmetic (None when the node
    predates the device cost ledger)."""
    dc = _fetch_json(base, "/debug/devcosts")
    if not dc or "totals" not in dc:
        return None
    tot = dc.get("totals") or {}
    return {
        "compiles": tot.get("compiles", 0),
        "compileMs": tot.get("compileMs", 0.0),
        "launches": tot.get("launches", 0),
        "deviceMs": tot.get("deviceMs", 0.0),
        "transferBytes": tot.get("h2dBytes", 0) + tot.get("d2hBytes", 0),
        "storms": len((dc.get("storm") or {}).get("recent", [])),
    }


def _devcost_delta(before: dict | None, after: dict | None) -> dict | None:
    if before is None or after is None:
        return None
    return {k: round(after[k] - before[k], 3) for k in before}


def _qos_counters(base: str) -> dict | None:
    """Monotonic per-tenant QoS governor counters from /debug/qos, for
    per-stage delta arithmetic (None when the node predates the
    governor or it is disabled)."""
    snap = _fetch_json(base, "/debug/qos")
    if not snap or not snap.get("enabled"):
        return None
    return {
        t: {
            "admitted": st.get("admitted", 0),
            "served": st.get("served", 0),
            "shed": st.get("shed", 0),
            "degraded": st.get("degraded", 0),
            "debtMs": st.get("debtMs", 0.0),
        }
        for t, st in (snap.get("tenants") or {}).items()
    }


def _qos_delta(before: dict | None, after: dict | None) -> dict | None:
    if before is None or after is None:
        return None
    out = {}
    for t, av in after.items():
        bv = before.get(t) or {}
        out[t] = {k: round(av[k] - bv.get(k, 0), 3) for k in av}
    return out


# per-stage history embedding: the headline series whose windowed stats
# land in each stage's report entry (full point lists stay on the node)
_HISTORY_STAGE_SERIES = (
    "slo.*.p99_ms,slo.*.rps,slo.*.availability,batcher.depth,"
    "dev.device_ms_ps"
)


def _history_cursor(base: str) -> int | None:
    """The metrics-history base-seq cursor NOW (None when the node
    predates /debug/history or runs with the plane disabled)."""
    snap = _fetch_json(base, "/debug/history?limit=0")
    if not snap or "nextSeq" not in snap:
        return None
    return snap["nextSeq"]


def _history_stage_delta(base: str, since: int | None) -> dict | None:
    """Summary stats (mean/max/last) over the series samples the
    history plane recorded DURING one stage — the ?since= cursor makes
    the window exactly the stage's own samples, and the gap-honest
    ``truncated`` flag rides along so a stage that outran the base
    ring says so instead of silently shrinking."""
    if since is None:
        return None
    snap = _fetch_json(
        base,
        f"/debug/history?since={int(since)}"
        f"&series={urllib.parse.quote(_HISTORY_STAGE_SERIES, safe='')}",
    )
    if not snap:
        return None
    out = {
        "samples": snap.get("returned", 0),
        "truncated": bool(snap.get("truncated")),
        "series": {},
    }
    for name, pts in (snap.get("series") or {}).items():
        vals = [v for _, v in pts if v is not None]
        if not vals:
            continue
        out["series"][name] = {
            "mean": round(sum(vals) / len(vals), 4),
            "max": round(max(vals), 4),
            "last": round(vals[-1], 4),
        }
    return out


def _fetch_text(base: str, path: str) -> str:
    netloc = urllib.parse.urlsplit(base).netloc
    conn = http.client.HTTPConnection(netloc, timeout=_HTTP_TIMEOUT)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.read().decode("utf-8", "replace")
    except (OSError, http.client.HTTPException):
        return ""
    finally:
        conn.close()


class LoadHarness:
    """Runs staged open-loop load against cluster node URIs and builds
    the SLO report dict (see loadgen/report.py for the schema)."""

    # A stage dips below this ok-ratio -> its availability verdict fails
    # (the resize stage's contract: no cluster-wide error window).
    AVAILABILITY_FLOOR = 0.99

    def __init__(
        self,
        uris: list[str],
        config: WorkloadConfig,
        stages: list[StageSpec],
        stage_hooks: dict | None = None,
        availability_floor: float | None = None,
    ):
        if not uris:
            raise ValueError("at least one node URI required")
        self.uris = list(uris)
        self.config = config
        self.stages = list(stages)
        # name -> zero-arg callable run CONCURRENTLY with that stage's
        # traffic (the resize stage's add/remove-node driver); the stage
        # doesn't end until the hook returns, and a hook exception lands
        # in the stage's report entry instead of killing the run.
        self.stage_hooks = dict(stage_hooks or {})
        self.availability_floor = (
            self.AVAILABILITY_FLOOR
            if availability_floor is None
            else float(availability_floor)
        )

    def generate(self) -> list[list]:
        """Pre-generate every stage's op sequence (the full request
        sequence is fixed before the first byte hits the wire); one
        generator stream spans the stages so the whole run replays from
        the seed."""
        gen = WorkloadGenerator(self.config)

        def _stage_ops(st: StageSpec) -> list:
            if st.shared_pool:
                return gen.sequence_shared(
                    st.op_count, st.mix, pool_size=st.shared_pool
                )
            if st.repeat_pool:
                return gen.sequence_repeat(
                    st.op_count, st.mix, pool_size=st.repeat_pool
                )
            return gen.sequence(st.op_count, st.mix)

        return [_stage_ops(st) for st in self.stages]

    def run(self) -> dict:
        per_stage_ops = self.generate()
        all_ops = [op for ops in per_stage_ops for op in ops]
        seq_fp = fingerprint(all_ops)
        live_snapshot = None
        results: list[_WorkerResult] = []
        stage_meta = []
        t_run0 = time.monotonic()
        for si, (stage, ops) in enumerate(zip(self.stages, per_stage_ops)):
            # Oversubscription knob: cap the process-wide HBM budget for
            # this stage only (the harness shares the servers' process —
            # InProcessCluster — so the budget singleton is reachable
            # directly), and restore the previous cap after the join so
            # later stages run at their configured residency.  set_cap
            # (not configure) so entries admitted by earlier stages stay
            # accounted and the shrink evicts the live working set.
            res_before = _residency_counters(self.uris[0])
            rc_before = _rescache_counters(self.uris[0])
            pl_before = _planner_counters(self.uris[0])
            dc_before = _devcost_counters(self.uris[0])
            qo_before = _qos_counters(self.uris[0])
            hi_before = _history_cursor(self.uris[0])
            prev_cap: tuple | None = None
            if stage.device_budget is not None:
                from pilosa_tpu_torch.core import membudget

                prev_cap = (membudget.default_budget().cap,)
                # after the counter snapshot: the shrink's trim evictions
                # belong to this stage's delta
                membudget.set_cap(stage.device_budget)
            stop = threading.Event()
            q: "queue.Queue" = queue.Queue(maxsize=max(64, stage.workers * 8))
            outs = [_WorkerResult() for _ in range(stage.workers)]
            threads = [
                threading.Thread(
                    target=_worker,
                    args=(
                        self.uris[w % len(self.uris)], q, outs[w], stop,
                        stage.tenant,
                    ),
                    name=f"loadgen-{stage.name}-{w}",
                    daemon=True,
                )
                for w in range(stage.workers)
            ]
            for t in threads:
                t.start()
            hook_thread = None
            hook_errors: list[str] = []
            hook = self.stage_hooks.get(stage.name)
            if hook is not None:
                def _run_hook(fn=hook, errs=hook_errors):
                    try:
                        fn()
                    except Exception as e:  # graftlint: disable=exception-hygiene -- surfaced in the stage's report entry; the load run must finish either way
                        logger.exception("stage hook failed")
                        errs.append(f"{type(e).__name__}: {e}")

                hook_thread = threading.Thread(
                    target=_run_hook, name=f"loadgen-hook-{stage.name}",
                    daemon=True,
                )
                hook_thread.start()
            tenant_seq = (
                _tenant_schedule(stage.tenants, len(ops))
                if stage.tenants
                else None
            )
            t0 = time.monotonic()
            interval = 1.0 / stage.rate if stage.rate > 0 else 0.0
            for k, op in enumerate(ops):
                q.put((
                    op,
                    t0 + k * interval,
                    tenant_seq[k] if tenant_seq else None,
                ))
            for _ in threads:
                q.put(None)
            # mid-run liveness probe: /debug/slo must serve DURING load
            if si == 0:
                live_snapshot = _fetch_json(self.uris[0], "/debug/slo")
            for t in threads:
                t.join()
            if hook_thread is not None:
                hook_thread.join()
            stop.set()
            if prev_cap is not None:
                from pilosa_tpu_torch.core import membudget

                membudget.set_cap(prev_cap[0])
            results.extend(outs)
            # Per-stage availability verdict: the share of this stage's
            # ops answered 2xx/3xx.  The resize stage's acceptance rides
            # on this — membership changes must not open an error window.
            ok_ops = sum(
                1 for o in outs for r in o.records if r[3]
            )
            stage_client_errors = sum(o.client_errors for o in outs)
            availability = ok_ops / len(ops) if ops else 1.0
            stage_meta.append(
                {
                    **stage.to_dict(),
                    "ops": len(ops),
                    "okOps": ok_ops,
                    "clientErrors": stage_client_errors,
                    "availability": availability,
                    "availabilityOk": availability >= self.availability_floor,
                    "hookRan": hook is not None,
                    "hookError": hook_errors[0] if hook_errors else None,
                    "residency": _residency_delta(
                        res_before, _residency_counters(self.uris[0])
                    ),
                    "rescache": _rescache_delta(
                        rc_before, _rescache_counters(self.uris[0])
                    ),
                    "planner": _planner_delta(
                        pl_before, _planner_counters(self.uris[0])
                    ),
                    "devcosts": _devcost_delta(
                        dc_before, _devcost_counters(self.uris[0])
                    ),
                    "qos": _qos_delta(
                        qo_before, _qos_counters(self.uris[0])
                    ),
                    "history": _history_stage_delta(
                        self.uris[0], hi_before
                    ),
                }
            )
        wall = time.monotonic() - t_run0
        records = [r for out in results for r in out.records]
        client_errors = sum(out.client_errors for out in results)
        server_slo = _fetch_json(self.uris[0], "/debug/slo")
        metrics_text = _fetch_text(self.uris[0], "/metrics")
        incidents = _fetch_json(self.uris[0], "/debug/incidents")
        events = _fetch_json(self.uris[0], "/debug/events")
        final_vars = _fetch_json(self.uris[0], "/debug/vars")
        residency = None
        if final_vars and "residency" in final_vars:
            residency = {
                "residency": final_vars.get("residency"),
                "device": final_vars.get("device"),
            }
        rescache = None
        if final_vars and "rescache" in final_vars:
            rescache = final_vars.get("rescache")
        planner = None
        if final_vars and "planner" in final_vars:
            planner = final_vars.get("planner")
        # end-of-run ledger state: per-site and per-principal accounting
        # (the tenant-labeled stages show up as principals here)
        devcosts = _fetch_json(self.uris[0], "/debug/devcosts")
        # end-of-run governor state: per-tenant stages, debt, transitions
        qos = _fetch_json(self.uris[0], "/debug/qos")
        # end-of-run history plane: sampler/tier state, detector
        # baselines, and the run's trend incidents (each bundle carries
        # its own pre-incident series windows at /debug/incidents?id=)
        history = None
        hist_snap = _fetch_json(self.uris[0], "/debug/history?limit=0")
        if hist_snap and "nextSeq" in hist_snap:
            trend = []
            for inc in (incidents or {}).get("incidents", []):
                if (inc.get("trigger") or {}).get("type") != "trend":
                    continue
                # the bundle detail carries the attached series windows;
                # embed their span (not the points — the full evidence
                # stays at /debug/incidents?id=)
                entry = dict(inc)
                detail = _fetch_json(
                    self.uris[0], f"/debug/incidents?id={inc['id']}"
                )
                series = (detail or {}).get("series") or {}
                entry["preSeconds"] = series.get("preSeconds")
                entry["seriesCount"] = len(series.get("series") or {})
                trend.append(entry)
            history = {
                "samples": hist_snap.get("seq"),
                "cadence": hist_snap.get("cadence"),
                "tiers": hist_snap.get("tiers"),
                "detectors": hist_snap.get("detectors"),
                "trendIncidents": trend,
            }
        return report_mod.build_report(
            config=self.config.to_dict(),
            stages=stage_meta,
            records=records,
            client_errors=client_errors,
            wall_seconds=wall,
            sequence_fingerprint=seq_fp,
            server_slo=server_slo,
            live_slo_ok=bool(live_snapshot and live_snapshot.get("classes") is not None),
            slo_metrics_present="pilosa_slo_requests_total" in metrics_text,
            incidents=incidents,
            events=events,
            residency=residency,
            rescache=rescache,
            planner=planner,
            devcosts=devcosts,
            qos=qos,
            history=history,
        )


def run_harness(
    config: WorkloadConfig,
    stages: list[StageSpec],
    nodes: int = 1,
    cluster_kwargs: dict | None = None,
    faults: list[dict] | None = None,
    preload_bits: int = 4096,
    stage_hooks: dict | None = None,
    device: str = "cuda",
    cluster_setup=None,
) -> dict:
    """Boot an InProcessCluster on ``device``, prepare schema + seed data,
    drive the staged workload, and return the report dict.
    ``cluster_kwargs`` passes through to InProcessCluster (SLO window
    knobs etc.); ``faults`` is a list of ``inject_fault`` kwargs dicts.
    ``stage_hooks`` maps stage name -> callable(cluster) run concurrently
    with that stage's traffic (e.g. add/remove a node mid-zipfian).
    ``cluster_setup(cluster)`` runs once the data is in, before the first
    stage: the command line sets the QoS governors' time scale there, as
    the port's nodes take no governor knobs."""
    from pilosa_tpu_torch.testing.cluster import InProcessCluster

    kwargs = dict(cluster_kwargs or {})
    with InProcessCluster(nodes, device=device, **kwargs) as cluster:
        prepare_schema(cluster, config)
        if preload_bits:
            preload(cluster, config, preload_bits)
        for f in faults or []:
            cluster.inject_fault(**f)
        if cluster_setup is not None:
            cluster_setup(cluster)
        bound_hooks = {
            name: (lambda fn=fn: fn(cluster))
            for name, fn in (stage_hooks or {}).items()
        }
        harness = LoadHarness(
            [n.uri for n in cluster.nodes], config, stages,
            stage_hooks=bound_hooks,
        )
        return harness.run()
