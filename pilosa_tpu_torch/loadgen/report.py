"""SLO report: the machine-readable artifact one harness run emits
(counterpart of ``pilosa_tpu/loadgen/report.py``, with the same
``SCHEMA``, so one validator reads both packages' reports).

``SLO_r*.json`` sits next to ``BENCH_*.json`` and makes the north-star
("serve heavy mixed traffic inside objectives") a regressable number:
per-op-class client-side p50/p99/p999, error-budget burn from the
server's own tracker, and a pass/fail verdict per objective-bearing
class.  ``validate_report`` is the schema contract the smoke test and
CI assert against.
"""

from __future__ import annotations

import math
import os

SCHEMA = "pilosa-slo-report/v1"


def _percentile(sorted_vals: list[float], q: float) -> float | None:
    if not sorted_vals:
        return None
    idx = max(0, min(len(sorted_vals) - 1, math.ceil(q * len(sorted_vals)) - 1))
    return sorted_vals[idx]


def build_report(
    config: dict,
    stages: list[dict],
    records: list[tuple[str, float, float, bool, int, str | None]],
    client_errors: int,
    wall_seconds: float,
    sequence_fingerprint: str,
    server_slo: dict | None,
    live_slo_ok: bool,
    slo_metrics_present: bool,
    incidents: dict | None = None,
    events: dict | None = None,
    residency: dict | None = None,
    rescache: dict | None = None,
    planner: dict | None = None,
    devcosts: dict | None = None,
    qos: dict | None = None,
    history: dict | None = None,
) -> dict:
    """Aggregate worker records + the server's SLO snapshot into the
    report dict.  ``records`` rows are (op_class, open_loop_latency_s,
    service_latency_s, ok, http_status, tenant)."""
    by_class: dict[str, dict] = {}
    by_tenant: dict[str, dict] = {}
    for op_class, lat, svc, ok, status, tenant in records:
        c = by_class.setdefault(
            op_class,
            {"count": 0, "errors": 0, "lat": [], "svc": []},
        )
        c["count"] += 1
        if not ok:
            c["errors"] += 1
        c["lat"].append(lat)
        c["svc"].append(svc)
        if tenant:
            t = by_tenant.setdefault(
                tenant,
                {"count": 0, "errors": 0, "shed": 0, "lat": []},
            )
            t["count"] += 1
            if not ok:
                t["errors"] += 1
            if status == 429:
                t["shed"] += 1
            # Shed requests answer in microseconds; folding them into the
            # tenant's latency would make a heavily-shed aggressor look
            # FAST.  Percentiles are over answered-with-data ops only.
            if status != 429:
                t["lat"].append(lat)
    ops_out: dict[str, dict] = {}
    for name, c in sorted(by_class.items()):
        lat = sorted(c["lat"])
        svc = sorted(c["svc"])
        ops_out[name] = {
            "count": c["count"],
            "errors": c["errors"],
            "errorRatio": c["errors"] / c["count"] if c["count"] else 0.0,
            "p50Ms": _ms(_percentile(lat, 0.50)),
            "p99Ms": _ms(_percentile(lat, 0.99)),
            "p999Ms": _ms(_percentile(lat, 0.999)),
            "serviceP50Ms": _ms(_percentile(svc, 0.50)),
            "serviceP99Ms": _ms(_percentile(svc, 0.99)),
        }
    tenants_out: dict[str, dict] = {}
    for name, t in sorted(by_tenant.items()):
        lat = sorted(t["lat"])
        tenants_out[name] = {
            "count": t["count"],
            "errors": t["errors"],
            "shed": t["shed"],
            "shedRatio": t["shed"] / t["count"] if t["count"] else 0.0,
            "p50Ms": _ms(_percentile(lat, 0.50)),
            "p99Ms": _ms(_percentile(lat, 0.99)),
        }
    total_ops = sum(c["count"] for c in ops_out.values())
    verdicts: dict[str, dict] = {}
    server_classes = (server_slo or {}).get("classes", {})
    for name, cls in server_classes.items():
        if cls.get("objective") is None:
            continue
        verdicts[name] = {
            "pass": bool(cls.get("ok")),
            "alerts": cls.get("alerts", {}),
            "latencyOk": cls.get("latencyOk"),
            "serverP99Ms": (cls.get("latency") or {}).get("p99Ms"),
        }
    overall = all(v["pass"] for v in verdicts.values()) if verdicts else None
    return {
        "schema": SCHEMA,
        "config": config,
        "stages": stages,
        "sequenceFingerprint": sequence_fingerprint,
        "wallSeconds": wall_seconds,
        "totalOps": total_ops,
        "throughputOpsPerSec": total_ops / wall_seconds if wall_seconds else 0.0,
        "clientErrors": client_errors,
        "ops": ops_out,
        "serverSLO": server_slo,
        "liveSLOServedDuringRun": live_slo_ok,
        "sloMetricsPresent": slo_metrics_present,
        # flight-recorder view after the run: incident bundles captured
        # by burning alerts / 504 spikes during the fault stages
        "incidents": (incidents or {}).get("incidents", []),
        # coordinator event journal after the run: the resize stage's
        # timeline (resize-start .. epoch-flip .. resize-commit) rides
        # here so SLO_r*.json is self-contained evidence of an online
        # membership change under load
        "events": (events or {}).get("events", []),
        # end-of-run residency + HBM-budget snapshots (docs/residency.md):
        # with an `oversubscribed` stage in the plan, the report carries
        # the device hit/miss and prefetch useful/issued rates the
        # working-set manager sustained under eviction pressure
        "residency": residency,
        # end-of-run semantic-cache snapshot (docs/caching.md); with a
        # repeat-heavy stage in the plan, the per-stage entries carry
        # the hit/invalidation deltas observed while it ran
        "rescache": rescache,
        # end-of-run flight-planner snapshot (docs/serving.md "Flight
        # planning"); with a shared-subtree stage in the plan, the
        # per-stage entries carry the cseHits/reorders deltas observed
        # while it ran
        "planner": planner,
        # end-of-run device cost ledger (docs/observability.md): per-site
        # compile/launch/transfer accounting plus per-principal rows —
        # tenant-labeled stages (StageSpec.tenant) land here under their
        # (tenant, index, opClass) principals; per-stage entries carry
        # the compile/launch/transfer deltas observed while each ran
        "devcosts": devcosts,
        # client-side per-tenant view of multi-tenant stages
        # (StageSpec.tenants): shed counts ride separately and are kept
        # OUT of the latency percentiles, so the aggressor's 429s don't
        # masquerade as fast service
        "opsByTenant": tenants_out,
        # end-of-run QoS governor snapshot (docs/robustness.md "Governed
        # admission"): per-tenant stage/debt/shed counters plus the
        # pressure-ladder transition journal observed during the run
        "qos": qos,
        # end-of-run metrics-history plane (docs/observability.md
        # "Metrics history & trend incidents"): sampler/tier state,
        # trend-detector baselines, and the run's `trend` incidents;
        # per-stage entries carry windowed series stats (mean/max/last
        # over exactly the samples recorded while each stage ran)
        "history": history,
        "verdicts": verdicts,
        "pass": overall,
    }


def _ms(v: float | None) -> float | None:
    return v * 1e3 if v is not None else None


def validate_report(report: dict) -> None:
    """Raise ValueError when the report breaks the schema contract."""
    if not isinstance(report, dict):
        raise ValueError("report must be a dict")
    if report.get("schema") != SCHEMA:
        raise ValueError(f"bad schema tag: {report.get('schema')!r}")
    for key in (
        "config", "stages", "sequenceFingerprint", "wallSeconds",
        "totalOps", "ops", "serverSLO", "verdicts",
        "liveSLOServedDuringRun", "sloMetricsPresent",
    ):
        if key not in report:
            raise ValueError(f"report missing key: {key}")
    if not isinstance(report["ops"], dict) or not report["ops"]:
        raise ValueError("report.ops must be a non-empty dict")
    for name, c in report["ops"].items():
        for key in ("count", "errors", "p50Ms", "p99Ms", "p999Ms"):
            if key not in c:
                raise ValueError(f"ops[{name!r}] missing {key}")
    slo = report["serverSLO"]
    if not isinstance(slo, dict) or "classes" not in slo:
        raise ValueError("serverSLO must carry a classes map")
    for name, v in report["verdicts"].items():
        if "pass" not in v:
            raise ValueError(f"verdicts[{name!r}] missing pass")


def next_report_path(directory: str = ".") -> str:
    """Next free SLO_rNN.json in ``directory`` (numbering mirrors the
    BENCH_r*.json convention)."""
    n = 1
    for entry in os.listdir(directory):
        if entry.startswith("SLO_r") and entry.endswith(".json"):
            digits = entry[len("SLO_r"):-len(".json")]
            if digits.isdigit():
                n = max(n, int(digits) + 1)
    return os.path.join(directory, f"SLO_r{n:02d}.json")
