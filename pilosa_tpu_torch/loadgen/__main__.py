"""SLO load harness command line of the port (counterpart of
``tools/loadharness.py``): drive a seeded, deterministic mixed workload
(zipfian key popularity, time-quantum ingest + concurrent time-range
reads, string-key translation, bulk imports) through the real HTTP path
of an in-process cluster of the port's nodes (on ``cuda`` unless
``--device cpu``) and emit a machine-readable ``SLO_rNN.json`` report, by
default under ``build/``.

Default stage plan (scaled by --duration/--rate/--workers):

    warm           read-heavy mix at half rate/concurrency
    timequantum    streaming timestamped SetBit + concurrent Range reads
    rangescan      int-field range predicates (the query-batched BSI lane)
                   with interleaved value writes
    oversubscribed zipfian stack-heavy reads under a deliberately tiny
                   HBM budget (stage-scoped ``device_budget``), so the
                   report carries residency hit/miss and prefetch
                   useful/issued rates under live eviction pressure
    repeatread     repeat-heavy reads drawn zipfian over a small query
                   template pool with interleaved writes — the semantic
                   result cache lane; the report entry carries the
                   stage's cache hit/invalidation deltas
    overload       two tenants on one open-loop schedule, the aggressor
                   at 10x the victim's share — the QoS governor's
                   pressure-ladder lane (docs/robustness.md "Governed
                   admission"); the report's ``opsByTenant`` and ``qos``
                   blocks show who was deprioritized/degraded/shed
    ramp           full mix at full rate and concurrency (budget restored)

Examples::

    python -m pilosa_tpu_torch.loadgen --seed 7 --duration 9 --rate 150
    python -m pilosa_tpu_torch.loadgen --device cpu --duration 4 --rate 40
    python -m pilosa_tpu_torch.loadgen --nodes 2 --fault slow,node=1,delay=0.05
    python -m pilosa_tpu_torch.loadgen --print-sequence | head

Two runs with the same seed generate identical request sequences; the
report's ``sequenceFingerprint`` is the proof (and the regression
anchor).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

from pilosa_tpu_torch.loadgen import (
    StageSpec,
    WorkloadConfig,
    WorkloadGenerator,
    next_report_path,
    run_harness,
    validate_report,
)

# Burn windows shrunk to the harness's time scale: a seconds-long run
# must land inside the fast windows or the error budget reads as empty.
SHORT_BURN_RULES = [
    {"name": "fast", "long": 60.0, "short": 10.0, "factor": 14.4},
    {"name": "slow", "long": 300.0, "short": 60.0, "factor": 1.0},
]

READ_HEAVY_MIX = {
    "count": 34.0, "row": 14.0, "topn": 10.0, "range_time": 8.0,
    "groupby": 6.0, "set": 10.0, "key_count": 10.0, "translate": 8.0,
}
TIMEQUANTUM_MIX = {
    "set_tq": 45.0, "range_time": 30.0, "count": 10.0, "set": 5.0,
    "key_set": 5.0, "translate": 5.0,
}
# Range-heavy: concurrent int-field predicates coalesce into
# query-batched BSI flights server-side, so the per-round SLO verdict
# regresses read.range at batched-lane throughput; interleaved set_val
# writes keep the field's device stack churning under the reads.
RANGE_HEAVY_MIX = {
    "range_bsi": 42.0, "set_val": 18.0, "count": 12.0, "row": 8.0,
    "groupby": 6.0, "set": 8.0, "translate": 6.0,
}
# Oversubscribed: stack-consuming reads dominate (count's Intersect arm,
# groupby, topn, range_bsi all stage field stacks / BSI planes), with
# enough write traffic to keep invalidating what the budget admitted.
# Run under a stage-scoped device_budget smaller than the working set,
# this is the eviction-pressure lane of the stage plan.
OVERSUB_MIX = {
    "count": 40.0, "range_bsi": 20.0, "row": 12.0, "groupby": 8.0,
    "topn": 6.0, "set": 8.0, "translate": 6.0,
}
# Repeat-heavy: the dashboard-refresh shape — reads recur zipfian over a
# small fixed template pool (StageSpec.repeat_pool) so the semantic
# result cache sees real repeat traffic, while ~12% writes keep
# version-precise invalidation live (docs/caching.md).
REPEAT_READ_MIX = {
    "count": 38.0, "topn": 16.0, "groupby": 12.0, "row": 12.0,
    "range_bsi": 10.0, "set": 8.0, "set_val": 4.0,
}
REPEAT_POOL = 12
# Shared-subtree flights: each read is one multi-call dashboard query
# whose calls embed a common canonical subtree (StageSpec.shared_pool),
# the flight planner's cross-query CSE shape — the stage's report entry
# carries the per-stage cseHits/reorders deltas (docs/serving.md
# "Flight planning").  Writes keep the shared operands' fragment
# versions moving underneath.
SHARED_FLIGHT_MIX = {
    "count": 64.0, "row": 12.0, "range_bsi": 8.0, "set": 10.0,
    "set_val": 6.0,
}
SHARED_POOL = 8
# Overload: the noisy-neighbor shape — one stage, two tenants on the
# same open-loop arrival schedule, the aggressor at 10x the victim's
# share (StageSpec.tenants weighted interleave).  TopN/GroupBy carry
# real weight so stage-2 of the pressure ladder has degradable traffic
# to serve from maintained views / last-known cache entries.
OVERLOAD_MIX = {
    "count": 30.0, "topn": 22.0, "groupby": 18.0, "row": 10.0,
    "range_bsi": 8.0, "set": 8.0, "translate": 4.0,
}
OVERLOAD_TENANTS = {"victim": 1.0, "aggressor": 10.0}
# Per-tenant SLO objective for the victim (slo.objectives_from_dict
# "tenants" sub-spec): lenient latency — the point is the RELATIVE
# contract (victim inside objective while the aggressor floods), not an
# absolute in-process latency bar.
OVERLOAD_OBJECTIVES = {
    "tenants": {
        "victim": {
            "read.count": {"availability": 0.99, "latencyP99Ms": 1000.0},
        },
    },
}
# Governor knobs shrunk to the harness's time scale (as SHORT_BURN_RULES
# shrinks the burn windows): fast ticks, sub-second escalation holds. JAX's
# nodes take them as ``qos_*`` constructor knobs; the port's nodes keep
# them at the governor's defaults, so :func:`tune_qos` sets them on each
# node's governor once the cluster is up.
QOS_KNOBS = {
    "tick_interval": 0.1,
    "stage_hold": 0.4,
    "relax_hold": 2.0,
    "retry_after": 1.0,
}


def tune_qos(cluster) -> None:
    """Put every node's QoS governor (where it has one: a node without the
    batcher has none) on the harness's time scale."""
    for node in cluster.nodes:
        if node.api.qos is not None:
            for name, value in QOS_KNOBS.items():
                setattr(node.api.qos, name, value)


def oversub_budget(n_cols: int = WorkloadConfig().n_cols,
                   n_rows: int = WorkloadConfig().n_rows) -> int:
    """Device-memory cap for the oversubscribed stage: ~1.1x one seg-field
    stack, ``ceil(9 n_rows / 8)`` rows (36 at the default 32) x the shards
    the workload's columns cover x ``SHARD_WORDS`` x 4 bytes. The stage's
    hot set is the seg stack PLUS the BSI slice planes (plus time views and
    row caches from earlier stages), so the cap admits any one of them but
    not the set — the count and range_bsi arms of the mix then churn the
    clock hand against each other for the stage's whole duration.

    JAX's cap is ``jax.local_device_count() * 36 * SHARD_WORDS * 4``: its
    stack's shard axis pads up to the mesh, one shard a device. The port's
    stack is ``[S, R, W]`` on one card, unpadded, so its cap follows the
    shards and rows the workload covers; at the default 50,000 columns and
    32 rows on one device the two agree. At the serving size (2^27.3
    columns, 64 rows) JAX's formula gives about 4.7 MB against a 1.34 GB
    seg stack: every stack build would be declined and the stage would
    show no churn at all."""
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, SHARD_WORDS

    rows = math.ceil(9 * n_rows / 8)
    return rows * math.ceil(n_cols / SHARD_WIDTH) * SHARD_WORDS * 4


def default_stages(duration: float, rate: float, workers: int,
                   n_cols: int = WorkloadConfig().n_cols,
                   n_rows: int = WorkloadConfig().n_rows) -> list[StageSpec]:
    """The stage plan, eighths of ``duration``; ``n_cols`` and ``n_rows``
    (the workload's) size the oversubscribed stage's cap."""
    eighth = max(1.0, duration / 8.0)
    return [
        StageSpec("warm", eighth, rate / 2.0, max(1, workers // 2), READ_HEAVY_MIX),
        StageSpec("timequantum", eighth, rate, workers, TIMEQUANTUM_MIX),
        StageSpec("rangescan", eighth, rate, workers, RANGE_HEAVY_MIX),
        StageSpec(
            "oversubscribed", eighth, rate, workers, OVERSUB_MIX,
            device_budget=oversub_budget(n_cols, n_rows),
        ),
        StageSpec(
            "repeatread", eighth, rate, workers, REPEAT_READ_MIX,
            repeat_pool=REPEAT_POOL,
            # tenant-labeled stage: its device work lands under the
            # "dashboards" principal in the report's devcosts block
            tenant="dashboards",
        ),
        StageSpec(
            "sharedflight", eighth, rate, workers, SHARED_FLIGHT_MIX,
            shared_pool=SHARED_POOL,
        ),
        StageSpec(
            # 2x the base rate so the governor actually sees pressure;
            # the aggressor's sheds drag this stage's availability below
            # the floor BY DESIGN — the victim's per-tenant verdict and
            # the report's opsByTenant split are the acceptance signal
            "overload", eighth, rate * 2.0, workers, OVERLOAD_MIX,
            tenants=OVERLOAD_TENANTS,
        ),
        StageSpec("ramp", eighth, rate * 1.5, workers, None),
    ]


def resize_stage(duration: float, rate: float, workers: int) -> StageSpec:
    """The membership-churn stage: zipfian read-heavy traffic during
    which ``resize_hook`` adds a node and then removes one."""
    return StageSpec("resize", duration, rate, workers, READ_HEAVY_MIX)


def resize_hook(cluster, settle: float = 0.4) -> None:
    """Run concurrently with the resize stage's traffic: let the zipfian
    load establish, grow the cluster by one node (per-fragment migration
    under live writes), let the new topology serve, then shrink it back
    out.  Both resizes ride the online protocol — the stage's
    availability verdict is the proof no cluster-wide gate dropped
    requests."""
    time.sleep(settle)
    node = cluster.add_node()
    time.sleep(settle)
    cluster.remove_node(cluster.nodes.index(node))


def trend_stages(
    pre_seconds: float, rate: float, workers: int
) -> list[StageSpec]:
    """A DEDICATED steady-state sequence for the trend-incident
    scenario.  The default stages are deliberately bursty — overload
    doublings, stage-to-stage mix shifts — which trip the trend
    detectors organically (a read-heavy stage collapses write rps; the
    overload stage regresses p99) and drown the injected fault.  Here
    every stage runs the SAME default mix at the SAME rate, so the
    ``slow`` fault ``trend_hook`` injects mid-run is the only anomaly
    in the whole timeline: steady traffic during which the hook first
    lets the metrics history accumulate >= ``pre_seconds`` of
    pre-incident window, then slows every coordinator fan-out leg so
    per-class p99 genuinely regresses.  The EWMA detectors
    (obs/history.py) must fire EXACTLY ONE ``trend`` incident for the
    episode, whose bundle carries the pre-incident series."""
    return [
        StageSpec("settle", 6.0, rate, workers, None),
        StageSpec("trend", pre_seconds + 25.0, rate, workers, None),
    ]


def trend_hook(
    cluster, pre_seconds: float = 60.0, delay: float = 0.2,
    poll: float = 0.5,
) -> None:
    """Run concurrently with the trend stage's traffic: wait until the
    coordinator's history spans >= ``pre_seconds`` of wall clock (the
    acceptance bar for the incident bundle's pre-incident evidence),
    then slow every coordinator->peer fan-out leg.  Requires >= 2 nodes
    and the HTTP fan-out plane (mesh dispatch off) so the fault
    registry sits on the slowed path."""
    hist = getattr(cluster.nodes[0], "history", None)
    give_up = time.monotonic() + pre_seconds + 30.0
    while hist is not None and time.monotonic() < give_up:
        q = hist.query(series="slo.*.p99_ms")
        span = max(
            (pts[-1][0] - pts[0][0]
             for pts in q["series"].values() if len(pts) >= 2),
            default=0.0,
        )
        if span >= pre_seconds:
            break
        time.sleep(poll)
    cluster.inject_fault("slow", node=1, delay=delay)


def parse_fault(spec: str) -> dict:
    """``kind[,k=v...]`` -> inject_fault kwargs, e.g.
    ``slow,node=1,delay=0.05,p=0.5``."""
    parts = spec.split(",")
    out: dict = {"kind": parts[0]}
    for p in parts[1:]:
        k, _, v = p.partition("=")
        if k in ("node", "times", "code"):
            out[k] = int(v)
        elif k in ("delay", "p"):
            out[k] = float(v)
        else:
            out[k] = v
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--nodes", type=int, default=1)
    ap.add_argument("--duration", type=float, default=9.0,
                    help="total seconds across the stage plan")
    ap.add_argument("--rate", type=float, default=150.0,
                    help="open-loop arrival rate (ops/s) of the full-load stages")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--preload-bits", type=int, default=4096)
    ap.add_argument("--report", default=None,
                    help="report path (default: next free SLO_rNN.json in"
                         " --report-dir)")
    ap.add_argument("--report-dir", default="build",
                    help="directory for auto-numbered reports (made if missing)")
    ap.add_argument("--device", default="cuda",
                    help="device of the nodes: cuda (default; raises where"
                         " CUDA is missing) or cpu")
    ap.add_argument("--fault", action="append", default=[],
                    metavar="KIND[,k=v...]",
                    help="inject a fault rule, e.g. slow,node=1,delay=0.05")
    ap.add_argument("--default-deadline", type=float, default=0.0,
                    help="server-side default request deadline (seconds)")
    ap.add_argument("--resize", action="store_true",
                    help="append a resize stage: add a node mid-zipfian"
                         " traffic, then remove one (online per-fragment"
                         " migration under load)")
    ap.add_argument("--trend", action="store_true",
                    help="run the DEDICATED trend scenario (replaces the"
                         " default stages): steady traffic accumulates the"
                         " required pre-incident history, then the"
                         " coordinator's fan-out legs are slowed so the"
                         " EWMA detectors fire exactly one `trend`"
                         " incident (forces >= 2 nodes and the HTTP"
                         " fan-out plane)")
    ap.add_argument("--trend-pre-seconds", type=float, default=60.0,
                    help="pre-incident series window the trend incident"
                         " bundle must carry (wall seconds)")
    ap.add_argument("--print-sequence", action="store_true",
                    help="print the deterministic op sequence as JSON lines"
                         " and exit (no cluster, no load)")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 when any SLO verdict fails (default: the"
                         " verdict lives in the report; short cold-start runs"
                         " legitimately blow latency objectives)")
    args = ap.parse_args(argv)

    config = WorkloadConfig(seed=args.seed)
    stages = default_stages(args.duration, args.rate, args.workers)
    stage_hooks = {}
    if args.resize:
        quarter = max(1.5, args.duration / 4.0)
        stages.append(resize_stage(quarter, args.rate, args.workers))
        stage_hooks["resize"] = resize_hook
    if args.trend:
        if args.resize:
            ap.error("--trend runs a dedicated steady-state sequence; "
                     "combine it with --resize in separate runs")
        # replace, don't append: the injected fault must be the only
        # anomaly in the timeline (see trend_stages)
        stages = trend_stages(
            args.trend_pre_seconds, args.rate / 2.0, args.workers
        )
        stage_hooks["trend"] = (
            lambda cluster: trend_hook(
                cluster, pre_seconds=args.trend_pre_seconds
            )
        )

    if args.print_sequence:
        gen = WorkloadGenerator(config)
        for st in stages:
            if st.shared_pool:
                ops = gen.sequence_shared(
                    st.op_count, st.mix, pool_size=st.shared_pool
                )
            elif st.repeat_pool:
                ops = gen.sequence_repeat(
                    st.op_count, st.mix, pool_size=st.repeat_pool
                )
            else:
                ops = gen.sequence(st.op_count, st.mix)
            for op in ops:
                print(json.dumps({"stage": st.name, **op.to_wire()}))
        return 0

    cluster_kwargs = {
        "slo_burn_rules": SHORT_BURN_RULES,
        "slo_slot_seconds": 1.0,
        "slo_latency_window": 60.0,
        "default_deadline": args.default_deadline,
        "slo_objectives": OVERLOAD_OBJECTIVES,
        "qos_enabled": True,
    }
    nodes = args.nodes
    if args.trend:
        # the slow fault hooks the internal HTTP client, so the trend
        # run needs a peer to slow and the HTTP fan-out plane active
        nodes = max(nodes, 2)
        cluster_kwargs["mesh_dispatch"] = False

    report = run_harness(
        config,
        stages,
        nodes=nodes,
        cluster_kwargs=cluster_kwargs,
        faults=[parse_fault(f) for f in args.fault],
        preload_bits=args.preload_bits,
        stage_hooks=stage_hooks,
        device=args.device,
        cluster_setup=tune_qos,
    )
    validate_report(report)
    if args.report:
        path = args.report
    else:
        os.makedirs(args.report_dir, exist_ok=True)
        path = next_report_path(args.report_dir)
    with open(path, "w") as f:
        json.dump(report, f, indent=1, sort_keys=True)
        f.write("\n")

    print(f"wrote {path}")
    print(
        f"ops={report['totalOps']} wall={report['wallSeconds']:.1f}s "
        f"throughput={report['throughputOpsPerSec']:.0f} ops/s "
        f"clientErrors={report['clientErrors']}"
    )
    for name, c in report["ops"].items():
        print(
            f"  {name:<14} n={c['count']:<6} err={c['errors']:<4} "
            f"p50={c['p50Ms']:.2f}ms p99={c['p99Ms']:.2f}ms "
            f"p999={c['p999Ms']:.2f}ms"
        )
    for st in report["stages"]:
        res = st.get("residency")
        res_note = ""
        if res and st.get("deviceBudget") is not None:
            hr = res.get("hitRate")
            uf = res.get("prefetchUsefulFrac")
            res_note = (
                f" hitRate={hr:.3f}" if hr is not None else " hitRate=n/a"
            ) + (
                f" prefetchUseful={uf:.3f}" if uf is not None else ""
            ) + f" evictions={res.get('evictions', 0)}"
        rc = st.get("rescache")
        if rc and st.get("repeatPool"):
            chr_ = rc.get("hitRate")
            res_note += (
                f" cacheHitRate={chr_:.3f}" if chr_ is not None
                else " cacheHitRate=n/a"
            ) + f" cacheInval={rc.get('invalidations', 0)}"
        print(
            f"  stage {st['name']:<14} avail={st['availability']:.4f} "
            f"{'OK' if st['availabilityOk'] else 'LOW'}"
            + (f" hookError={st['hookError']}" if st.get("hookError") else "")
            + res_note
        )
    for name, t in (report.get("opsByTenant") or {}).items():
        p99 = t["p99Ms"]
        print(
            f"  tenant {name:<14} n={t['count']:<6} shed={t['shed']:<5} "
            + (f"p99={p99:.2f}ms" if p99 is not None else "p99=n/a")
        )
    for inc in ((report.get("history") or {}).get("trendIncidents") or []):
        trig = inc.get("trigger") or {}
        pre = inc.get("preSeconds")
        print(
            f"  trend incident {inc.get('id', '?')} "
            f"{trig.get('detector', '?')} on {trig.get('series', '?')} "
            f"baseline={trig.get('baseline')} observed={trig.get('observed')}"
            + (f" pre={pre:.0f}s" if pre is not None else "")
        )
    for name, v in report["verdicts"].items():
        print(f"  verdict {name:<14} {'PASS' if v['pass'] else 'FAIL'}")
    if report["pass"] is False:
        print("SLO verdict: FAIL")
        return 1 if args.strict else 0
    print("SLO verdict: PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
