"""The port's load harness (``pilosa_tpu_torch/loadgen``) against the JAX
package's (``pilosa_tpu/loadgen``, ``tools/loadharness.py``), on the CPU.

The workload generator is pure numpy: for seeds 7, 42 and 1234, under the
default mix and every mix of the stage plan, both packages' ``sequence``,
``sequence_repeat`` and ``sequence_shared`` must give the same requests
byte for byte, and so the same fingerprint; the zipfian sampler, the
schema steps and the tenant interleave too. The report is built alike
from the same records and server snapshots, and both validators reject
the same broken reports. The stage plans agree but for the oversubscribed
stage's cap, which follows the shards the workload covers in the port
(``oversub_budget``). End to end, one worker drives the same short plan
through a one-node cluster of each package, so the writes land in the
sequence's order: the reports agree in fingerprint and counts, and the
same reads give the same answers afterwards. Last, the port's budgeted
stage caps and restores the process budget, and its command line writes
a valid report."""

# the port's lock witness, installed before the port is imported so that its
# module-level locks are wrapped too (pilosa_tpu_torch/testing/lockwitness.py)
from pilosa_tpu_torch.testing import lockwitness as port_lockwitness

port_lockwitness.install()
# the module fixture that asserts no new inversion among the port's locks
from pilosa_tpu_torch.testing.lockwitness import no_new_inversion  # noqa: F401

import json
import math
import os
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from pilosa_tpu.loadgen import harness as jharness
from pilosa_tpu.loadgen import report as jreport
from pilosa_tpu.loadgen import workload as jwork
from pilosa_tpu.testing.cluster import InProcessCluster as JaxCluster
from pilosa_tpu_torch.core import membudget as tmb
from pilosa_tpu_torch.loadgen import __main__ as tmain
from pilosa_tpu_torch.loadgen import harness as tharness
from pilosa_tpu_torch.loadgen import report as treport
from pilosa_tpu_torch.loadgen import workload as twork
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, SHARD_WORDS
from pilosa_tpu_torch.testing.cluster import InProcessCluster as PortCluster
from tools import loadharness as jmain

REPO = Path(__file__).resolve().parents[1]
SEEDS = [7, 42, 1234]
MIXES = {
    "default": None,
    "read_heavy": jmain.READ_HEAVY_MIX,
    "timequantum": jmain.TIMEQUANTUM_MIX,
    "range_heavy": jmain.RANGE_HEAVY_MIX,
    "oversub": jmain.OVERSUB_MIX,
    "repeat_read": jmain.REPEAT_READ_MIX,
    "shared_flight": jmain.SHARED_FLIGHT_MIX,
    "overload": jmain.OVERLOAD_MIX,
}
N_OPS = 240


def _wire(ops):
    return [(op.kind, op.op_class, op.method, op.path, op.body, op.ctype) for op in ops]


# -- the workload -------------------------------------------------------------


def test_the_port_keeps_the_workload_constants():
    assert twork.DEFAULT_MIX == jwork.DEFAULT_MIX
    assert twork.OP_CLASS == jwork.OP_CLASS
    for name in ("TIME_BASE_YEAR", "TIME_BASE_MONTH", "N_TQ_DAYS", "N_TQ_HOURS",
                 "BSI_FIELD", "BSI_VAL_MIN", "BSI_VAL_MAX"):
        assert getattr(twork, name) == getattr(jwork, name), name
    for name in ("READ_HEAVY_MIX", "TIMEQUANTUM_MIX", "RANGE_HEAVY_MIX", "OVERSUB_MIX",
                 "REPEAT_READ_MIX", "REPEAT_POOL", "SHARED_FLIGHT_MIX", "SHARED_POOL",
                 "OVERLOAD_MIX", "OVERLOAD_TENANTS", "OVERLOAD_OBJECTIVES",
                 "SHORT_BURN_RULES"):
        assert getattr(tmain, name) == getattr(jmain, name), name
    # JAX's node takes the governor's knobs as qos_* keywords
    assert {f"qos_{k}": v for k, v in tmain.QOS_KNOBS.items()} == {
        k: v for k, v in jmain.QOS_KNOBS.items() if k != "qos_enabled"}


@pytest.mark.parametrize("method", ["sequence", "sequence_repeat", "sequence_shared"])
@pytest.mark.parametrize("mix", list(MIXES))
@pytest.mark.parametrize("seed", SEEDS)
def test_sequences_equal_jax(seed, mix, method):
    cfg = dict(seed=seed, n_rows=24, n_cols=70_000, n_user_keys=500, import_batch_size=16)
    jg = jwork.WorkloadGenerator(jwork.WorkloadConfig(**cfg))
    tg = twork.WorkloadGenerator(twork.WorkloadConfig(**cfg))
    # two calls: the stream continues across a generator's stages
    for n in (N_OPS, N_OPS // 3):
        jops = getattr(jg, method)(n, MIXES[mix])
        tops = getattr(tg, method)(n, MIXES[mix])
        assert _wire(tops) == _wire(jops)
        assert twork.fingerprint(tops) == jwork.fingerprint(jops)
        assert [op.to_wire() for op in tops] == [op.to_wire() for op in jops]


@pytest.mark.parametrize("theta", [0.5, 0.99, 1.3])
@pytest.mark.parametrize("n", [1, 3, 1000, 1 << 20])
def test_zipf_equals_jax(n, theta):
    jz, tz = jwork.Zipf(n, theta), twork.Zipf(n, theta)
    assert np.array_equal(tz._cdf, jz._cdf)
    jr, tr = np.random.default_rng(n), np.random.default_rng(n)
    assert [tz.sample(tr) for _ in range(2000)] == [jz.sample(jr) for _ in range(2000)]


@pytest.mark.parametrize("seed", SEEDS)
def test_schema_ops_and_config_equal_jax(seed):
    kw = dict(seed=seed, index="ix", keys_index="kx", n_rows=9, mix={"count": 1.0})
    assert twork.schema_ops(twork.WorkloadConfig(**kw)) == jwork.schema_ops(
        jwork.WorkloadConfig(**kw))
    assert twork.WorkloadConfig(**kw).to_dict() == jwork.WorkloadConfig(**kw).to_dict()
    with pytest.raises(ValueError):
        twork.WorkloadConfig(mix={"frobnicate": 1.0})


@pytest.mark.parametrize("tenants", [
    {"victim": 1.0, "aggressor": 10.0}, {"a": 1.0}, {"a": 2.0, "b": 3.0, "c": 0.5},
    {"x": 0.0, "y": 0.0},
])
def test_tenant_schedule_equals_jax(tenants):
    for n in (0, 1, 11, 137):
        assert tharness._tenant_schedule(tenants, n) == jharness._tenant_schedule(tenants, n)


def test_harness_generate_equals_jax():
    """LoadHarness.generate over the whole default plan (a generator stream
    spanning the stages) and the plan's --print-sequence lines."""
    cfg = dict(seed=5, n_cols=30_000)
    jst = jmain.default_stages(16.0, 30.0, 4)
    tst = tmain.default_stages(16.0, 30.0, 4)
    jops = jharness.LoadHarness(["http://x"], jwork.WorkloadConfig(**cfg), jst).generate()
    tops = tharness.LoadHarness(["http://x"], twork.WorkloadConfig(**cfg), tst).generate()
    assert [_wire(s) for s in tops] == [_wire(s) for s in jops]


# -- the report ---------------------------------------------------------------


def _records(rng, n):
    classes = sorted(set(jwork.OP_CLASS.values()))
    out = []
    for _ in range(n):
        ok = bool(rng.random() < 0.9)
        status = 200 if ok else int(rng.choice([429, 500, 504]))
        tenant = [None, "victim", "aggressor"][int(rng.integers(0, 3))]
        lat = float(rng.exponential(0.01))
        out.append((classes[int(rng.integers(0, len(classes)))], lat, lat * 0.8, ok, status,
                    tenant))
    return out


def _server_slo():
    return {"classes": {
        "write": {"objective": {"availability": 0.999, "latencyP99Ms": 50.0}, "ok": True,
                  "alerts": {"fast": False}, "latencyOk": True, "latency": {"p99Ms": 2.0}},
        "read.count": {"objective": {"availability": 0.99}, "ok": False, "alerts": {},
                       "latencyOk": False, "latency": {"p99Ms": 80.0}},
        "import": {"objective": None},
    }}


@pytest.mark.parametrize("seed", SEEDS)
def test_build_report_equals_jax(seed):
    rng = np.random.default_rng(seed)
    kw = dict(
        config={"seed": seed}, stages=[{"name": "s", "ops": 3}],
        records=_records(rng, 500), client_errors=3, wall_seconds=2.5,
        sequence_fingerprint="ab" * 32, server_slo=_server_slo(), live_slo_ok=True,
        slo_metrics_present=True, incidents={"incidents": [{"id": "x"}]},
        events={"events": [{"type": "node-start"}]}, residency={"a": 1}, rescache={"b": 2},
        planner={"c": 3}, devcosts={"d": 4}, qos={"e": 5}, history={"f": 6},
    )
    got, want = treport.build_report(**kw), jreport.build_report(**kw)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert treport.SCHEMA == jreport.SCHEMA == got["schema"]
    treport.validate_report(want)
    jreport.validate_report(got)


def _broken_reports():
    good = jreport.build_report(
        config={"seed": 1}, stages=[{"name": "s", "ops": 1}],
        records=[("write", 0.001, 0.001, True, 200, None)], client_errors=0,
        wall_seconds=1.0, sequence_fingerprint="abc", server_slo=_server_slo(),
        live_slo_ok=True, slo_metrics_present=True)
    return {
        "schema": {**good, "schema": "bogus/v0"},
        "no_server_slo": {k: v for k, v in good.items() if k != "serverSLO"},
        "no_ops": {**good, "ops": {}},
    }


@pytest.mark.parametrize("broken", list(_broken_reports()))
def test_validate_report_rejects_what_jax_rejects(broken):
    report = _broken_reports()[broken]
    with pytest.raises(ValueError):
        jreport.validate_report(report)
    with pytest.raises(ValueError):
        treport.validate_report(report)


def test_next_report_path_equals_jax(tmp_path):
    assert Path(treport.next_report_path(str(tmp_path))).name == "SLO_r01.json"
    for name in ("SLO_r01.json", "SLO_r07.json", "SLO_rx.json", "other.json"):
        (tmp_path / name).write_text("{}")
    assert treport.next_report_path(str(tmp_path)) == jreport.next_report_path(str(tmp_path))


# -- the stage plan -----------------------------------------------------------


@pytest.mark.parametrize("plan", [(10.0, 100.0, 4), (40.0, 100.0, 16), (3.0, 7.0, 1)])
def test_default_stages_equal_jax_but_the_cap(plan):
    jst, tst = jmain.default_stages(*plan), tmain.default_stages(*plan)
    assert [s.name for s in tst] == ["warm", "timequantum", "rangescan", "oversubscribed",
                                     "repeatread", "sharedflight", "overload", "ramp"]
    for j, t in zip(jst, tst):
        jd, td = j.to_dict(), t.to_dict()
        jcap, tcap = jd.pop("deviceBudget"), td.pop("deviceBudget")
        assert td == jd
        assert (tcap is None) == (jcap is None)
        assert t.op_count == j.op_count
    cfg = twork.WorkloadConfig()
    [ov] = [s for s in tst if s.name == "oversubscribed"]
    shards = math.ceil(cfg.n_cols / SHARD_WIDTH)
    assert ov.device_budget == 36 * shards * SHARD_WORDS * 4 == tmain.oversub_budget()


@pytest.mark.parametrize("n_cols,n_rows", [(1, 32), (SHARD_WIDTH, 32), (SHARD_WIDTH + 1, 32),
                                           (160 * SHARD_WIDTH, 64), (50_000, 7)])
def test_oversub_budget_follows_the_workload(n_cols, n_rows, monkeypatch):
    rows = math.ceil(9 * n_rows / 8)
    want = rows * math.ceil(n_cols / SHARD_WIDTH) * SHARD_WORDS * 4
    assert tmain.oversub_budget(n_cols, n_rows) == want
    stages = tmain.default_stages(8.0, 10.0, 2, n_cols=n_cols, n_rows=n_rows)
    assert [s.device_budget for s in stages if s.device_budget] == [want]
    if n_cols <= SHARD_WIDTH and n_rows == 32:
        # JAX's stack pads one shard a device: on one device the caps agree
        import jax

        monkeypatch.setattr(jax, "local_device_count", lambda *a, **k: 1)
        assert jmain.oversub_budget() == want


def test_parse_fault_equals_jax():
    for spec in ("slow,node=1,delay=0.05", "error,node=2,code=503,p=0.5,times=3",
                 "crash,stage=coordinator:migrate"):
        assert tmain.parse_fault(spec) == jmain.parse_fault(spec)


# -- the harness end to end ---------------------------------------------------

KNOBS = {
    "slo_burn_rules": jmain.SHORT_BURN_RULES,
    "slo_slot_seconds": 1.0,
    "slo_latency_window": 60.0,
}
E2E_CFG = dict(seed=31, n_rows=12, n_cols=3 * (1 << 14) - 500, n_user_keys=60,
               import_batch_size=24)


def _e2e_stages(pkg):
    return [
        pkg.StageSpec("a", 1.0, 40.0, 1, None),
        pkg.StageSpec("b", 0.5, 40.0, 1, jmain.TIMEQUANTUM_MIX),
        pkg.StageSpec("c", 0.5, 40.0, 1, jmain.REPEAT_READ_MIX, repeat_pool=4),
        pkg.StageSpec("d", 0.5, 40.0, 1, jmain.SHARED_FLIGHT_MIX, shared_pool=3),
    ]


def _post(uri, index, pql):
    req = urllib.request.Request(f"{uri}/index/{index}/query", data=pql.encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())["results"]


def _final_reads(cfg):
    reads = [(cfg.index, f"Count(Row(seg={r}))") for r in range(cfg.n_rows)]
    reads += [(cfg.index, "TopN(seg, n=5)"), (cfg.index, "GroupBy(Rows(seg), limit=8)")]
    reads += [(cfg.index, f"Count(Range(ev={r}, 2026-01-01T00:00, 2026-01-{d:02d}T00:00))")
              for r in range(0, cfg.n_rows, 3) for d in (2, 9, 28)]
    reads += [(cfg.index, f"Count(Row({twork.BSI_FIELD} {op} {b}))")
              for op in ("<", ">") for b in (-3000, 0, 2500)]
    reads += [(cfg.index, f"Sum(field={twork.BSI_FIELD})")]
    reads += [(cfg.keys_index, f'Count(Row(tag="t{r}"))') for r in range(cfg.n_rows)]
    return reads


def _run(pkg_harness, cluster, cfg, stages):
    pkg_harness.prepare_schema(cluster, cfg)
    pkg_harness.preload(cluster, cfg, 256)
    return pkg_harness.LoadHarness([n.uri for n in cluster.nodes], cfg, stages).run()


def test_one_worker_harness_run_equals_jax():
    tcfg, jcfg = twork.WorkloadConfig(**E2E_CFG), jwork.WorkloadConfig(**E2E_CFG)
    with PortCluster(1, device="cpu", **KNOBS) as tc, JaxCluster(1, **KNOBS) as jc:
        got = _run(tharness, tc, tcfg, _e2e_stages(tharness))
        want = _run(jharness, jc, jcfg, _e2e_stages(jharness))
        treport.validate_report(got)
        jreport.validate_report(want)
        assert got["clientErrors"] == want["clientErrors"] == 0
        assert got["sequenceFingerprint"] == want["sequenceFingerprint"]
        assert got["totalOps"] == want["totalOps"]
        assert {c: v["count"] for c, v in got["ops"].items()} == {
            c: v["count"] for c, v in want["ops"].items()}
        assert [s["okOps"] for s in got["stages"]] == [s["okOps"] for s in want["stages"]]
        assert [s["okOps"] for s in got["stages"]] == [s["ops"] for s in got["stages"]]
        assert got["liveSLOServedDuringRun"] and got["sloMetricsPresent"]
        for index, pql in _final_reads(tcfg):
            assert _post(tc.nodes[0].uri, index, pql) == _post(jc.nodes[0].uri, index, pql), pql
        keys = [_post(n.uri, tcfg.keys_index, 'Row(tag="t0")')[0]["keys"]
                for n in (tc.nodes[0], jc.nodes[0])]
        assert sorted(keys[0]) == sorted(keys[1])


def test_budgeted_stage_caps_then_restores_and_reports_residency():
    # the port's counterpart of tests/test_loadgen.py's: a device_budget
    # stage caps the process budget for exactly its own duration, attaches
    # a residency delta to its entry and lands the end-of-run block
    prev = tmb.default_budget().cap
    cfg = twork.WorkloadConfig(seed=23, n_cols=5_000)
    budget = 48 * math.ceil(cfg.n_cols / SHARD_WIDTH) * SHARD_WORDS * 4
    try:
        report = tharness.run_harness(
            cfg,
            [tharness.StageSpec("oversubscribed", 1.0, 40.0, 3, {"count": 3.0, "row": 1.0},
                                device_budget=budget),
             tharness.StageSpec("after", 0.5, 20.0, 2, {"count": 1.0})],
            nodes=1, preload_bits=256, device="cpu",
        )
        cap_after_run = tmb.default_budget().cap
    finally:
        tmb.configure(prev)
    treport.validate_report(report)
    ov, after = report["stages"]
    assert ov["deviceBudget"] == budget
    assert after["deviceBudget"] is None
    for st in (ov, after):
        delta = st["residency"]
        assert delta is not None
        for key in ("deviceHits", "deviceMisses", "prefetchIssued", "prefetchUseful",
                    "evictions", "hitRate"):
            assert key in delta, (st["name"], key)
        assert delta["deviceHits"] >= 0 and delta["deviceMisses"] >= 0
    assert report["residency"] is not None
    assert "capBytes" in report["residency"]["device"]
    assert "deviceHits" in report["residency"]["residency"]
    assert cap_after_run == prev
    assert json.dumps(report)


def test_run_harness_on_cuda_raises_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: tests/test_torch_cuda.py runs the harness there")
    with pytest.raises(RuntimeError, match="CUDA"):
        tharness.run_harness(twork.WorkloadConfig(n_cols=1000),
                             [tharness.StageSpec("s", 0.1, 10.0, 1)], preload_bits=0)


def test_command_line_writes_a_valid_report(tmp_path):
    report_path = tmp_path / "slo.json"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run(
        [sys.executable, "-m", "pilosa_tpu_torch.loadgen", "--device", "cpu",
         "--duration", "4", "--rate", "12", "--workers", "2", "--preload-bits", "128",
         "--seed", "3", "--report", str(report_path)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert f"wrote {report_path}" in r.stdout
    report = json.loads(report_path.read_text())
    treport.validate_report(report)
    jreport.validate_report(report)
    assert [s["name"] for s in report["stages"]] == [
        s.name for s in tmain.default_stages(4.0, 12.0, 2)]
    assert report["clientErrors"] == 0
    # the governors ran on the harness's time scale
    assert report["qos"]["config"]["tickInterval"] == tmain.QOS_KNOBS["tick_interval"]
    cfg = twork.WorkloadConfig(seed=3)
    gen_ops = tharness.LoadHarness(["http://x"], cfg,
                                   tmain.default_stages(4.0, 12.0, 2)).generate()
    assert report["sequenceFingerprint"] == twork.fingerprint(
        [op for ops in gen_ops for op in ops])
    # nothing else was written where it ran
    assert sorted(p.name for p in tmp_path.iterdir()) == ["slo.json"]


def test_print_sequence_equals_jax(capsys):
    args = ["--seed", "9", "--duration", "8", "--rate", "6", "--print-sequence"]
    assert tmain.main(args) == 0
    got = capsys.readouterr().out
    assert jmain.main(args) == 0
    assert got == capsys.readouterr().out
