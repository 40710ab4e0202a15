"""The port's observability planes against ``pilosa_tpu``'s, on the CPU:
the metrics history, the flight recorder, the black box, diagnostics,
the runtime gauges, span export and the device ledger's reads.

Each parity case builds the JAX plane and the port's side by side and
feeds both the same seeded input: the history's samples with explicit
``wall`` times (``parse_tiers``, ring wrap, ``since`` cursors and
truncation, decimation, ``downsample`` and the three trend detectors'
episodes), the flight recorder's segments by explicit calls (the
504-spike edge, SLO alert edges, ``capture_incident`` bundles), and the
black box's checkpoints (spool caps, the dirty and clean marker,
crash-loop counting, torn-write recovery, postmortem assembly). Their
answers must be equal once times, pids and node ids are dropped.

Then what only the port has: the flight recorder counts the launch
funnel's launches, the ledger's reads never wait behind a thread that
waits for a launch, a sticky device error leaves a checkpoint whole, and
``NodeServer()`` runs every plane with JAX's defaults. No sampler thread
is waited for: the tests call ``sample_once``, ``_segment`` and
``checkpoint`` themselves, stop every thread in a ``finally``, and leave
``faulthandler`` and the SIGTERM handler as they found them.
"""

# the port's lock witness, installed before the port is imported so that its
# module-level locks are wrapped too (pilosa_tpu_torch/testing/lockwitness.py)
from pilosa_tpu_torch.testing import lockwitness as port_lockwitness

port_lockwitness.install()
# the module fixture that asserts no new inversion among the port's locks
from pilosa_tpu_torch.testing.lockwitness import no_new_inversion  # noqa: F401

import faulthandler
import gc
import importlib
import inspect
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, HTTPServer
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
PKGS = ("pilosa_tpu", "pilosa_tpu_torch")
# values that differ between two runs by nature, dropped before comparing
VOLATILE = {"at", "pid", "node", "startedAt", "assembledAt", "lastCheckpointAt",
            "lastCrashAt", "stoppedAt", "id", "checkpointSeconds", "sampleSeconds",
            "seconds", "ts", "uptime"}


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _stable(obj):
    if isinstance(obj, dict):
        return {k: _stable(v) for k, v in obj.items() if k not in VOLATILE}
    if isinstance(obj, list):
        return [_stable(v) for v in obj]
    return obj


@pytest.fixture(autouse=True)
def _restore_process_hooks():
    """The black box arms ``faulthandler`` and nodes install a SIGTERM
    handler: each test leaves both as it found them."""
    was = faulthandler.is_enabled()
    prev = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, prev)
    faulthandler.disable()
    if was:
        faulthandler.enable(file=sys.__stderr__, all_threads=True)
    gc.collect()


class _Holder:
    slo = None
    stats = None


# -- metrics history ----------------------------------------------------------

TIER_SPECS = ["300@1,240@15", "240@15,300@1", "10@1", " 8@1 , 4@4 ", "240@15", "4@1,10@15",
              "", "0@1", "8@0", [(8, 1), (4, 4)], [(4, 4)]]


@pytest.mark.parametrize("spec", TIER_SPECS, ids=lambda s: repr(s))
def test_parse_tiers_alike(spec):
    out = []
    for pkg in PKGS:
        try:
            out.append(_mod(pkg, "obs.history").parse_tiers(spec))
        except ValueError as e:
            out.append(("ValueError", str(e)))
    assert out[0] == out[1]


def _stream(seed, n, names, gap=0.2):
    """A seeded sample stream: each sample a dict of some of ``names``."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        s = {}
        for k, name in enumerate(names):
            if rng.random() >= gap:
                s[name] = float(np.round(rng.normal(10.0 * (k + 1), 3.0), 3))
        out.append((s, 1000.0 + i + float(np.round(rng.uniform(0, 0.4), 3))))
    return out


HISTORY_SCENARIOS = {
    "wrap": ("8@1", 20, ["a"], 0.0),
    "decimation": ("8@1,4@4", 41, ["a", "b"], 0.3),
    "planes": ("16@1,4@4,2@8", 70, ["slo.read.p99_ms", "slo.read.rps", "batcher.depth",
                                     "dev.device_ms_ps", "qos.t1.debt_ms"], 0.1),
}
HISTORY_QUERIES = [
    {}, {"since": 0}, {"since": 12}, {"since": 13}, {"since": 40}, {"since": 10**6},
    {"limit": 2}, {"limit": 0}, {"series": "slo.*"}, {"series": ["slo.*", "batcher.*"]},
    {"series": "a,b"}, {"step": 1.0}, {"step": 4.0}, {"step": 7.0}, {"step": 8.0},
    {"step": 4.0, "since": 25}, {"step": 4.0, "since": 0}, {"step": 0.5, "limit": 3},
]


@pytest.mark.parametrize("query", HISTORY_QUERIES, ids=lambda q: json.dumps(q, sort_keys=True))
@pytest.mark.parametrize("scenario", sorted(HISTORY_SCENARIOS))
def test_history_queries_alike(scenario, query):
    tiers, n, names, gap = HISTORY_SCENARIOS[scenario]
    stream = _stream(len(scenario), n, names, gap)
    out = []
    for pkg in PKGS:
        h = _mod(pkg, "obs.history").MetricsHistory(_Holder(), tiers=tiers, detectors="")
        for sample, wall in stream:
            h.record(dict(sample), wall=wall)
        out.append(_stable(h.query(**query)))
    assert out[0] == out[1]
    assert out[1]["nextSeq"] >= out[1]["firstSeq"]


@pytest.mark.parametrize("step", [0.5, 2.0, 7.0, 0.0, -1.0])
def test_downsample_alike_and_against_numpy(step):
    rng = np.random.default_rng(42)
    times = np.sort(1_000_000.0 + rng.uniform(0, 100, size=200))
    vals = rng.normal(50.0, 10.0, size=200)
    pts = [[float(t), None if k % 7 == 0 else float(v)]
           for k, (t, v) in enumerate(zip(times, vals))]
    got = [_mod(pkg, "obs.history").downsample(pts, step) for pkg in PKGS]
    assert got[0] == got[1]
    if step > 0:
        buckets = np.floor(times / step) * step
        keep = np.array([p[1] is not None for p in pts])
        for bt, bv in got[1]:
            mask = (buckets == bt) & keep
            if bv is None:
                assert not mask.any()
            else:
                assert bv == pytest.approx(float(vals[mask].mean()), abs=1e-9)


class _FakeRecorder:
    def __init__(self):
        self.triggers = []

    def capture_incident(self, trigger):
        self.triggers.append(trigger)


def _episode_stream(kind, seed):
    """Per-class samples for one detector: a baseline, a regression, a
    recovery, a second regression (its own episode) and, for throughput,
    idle stretches that must not read as a collapse."""
    rng = np.random.default_rng(seed)
    if kind == "latency":
        name, base, bad = "slo.read.p99_ms", 10.0, 90.0
    elif kind == "throughput":
        name, base, bad = "slo.read.rps", 60.0, 4.0
    else:
        name, base, bad = "slo.read.eps", 0.5, 12.0
    plan = ([base] * 15 + [bad] * 6 + [base] * 8 + [bad] * 5 + [base] * 6)
    if kind == "throughput":
        plan = plan[:10] + [0.0] * 6 + plan[10:]
    out = []
    for i, level in enumerate(plan):
        v = level if level == 0.0 else float(np.round(level * rng.uniform(0.9, 1.1), 4))
        sample = {name: v, "slo.write.p99_ms": 5.0, "slo.write.rps": 10.0}
        out.append((sample, 2000.0 + i))
    return out


@pytest.mark.parametrize("kind", ["latency", "throughput", "errors"])
def test_trend_detector_episodes_alike(kind):
    stream = _episode_stream(kind, {"latency": 1, "throughput": 2, "errors": 3}[kind])
    out = []
    for pkg in PKGS:
        h = _mod(pkg, "obs.history").MetricsHistory(_Holder(), tiers="64@1", warmup=5, trips=3)
        rec = _FakeRecorder()
        h.flightrec = rec
        for sample, wall in stream:
            h.record(dict(sample), wall=wall)
        out.append({
            "triggers": rec.triggers,
            "state": h.trend_state(),
            "stats": _stable(h.stats()),
            "series": h.incident_series({"type": "trend", "class": "read"}),
            "blackbox": _stable(h.blackbox_snapshot(8.0)),
        })
    assert out[0] == out[1]
    # two regressions, two episodes: one incident each
    assert len(out[1]["triggers"]) == 2, out[1]["triggers"]
    assert {t["class"] for t in out[1]["triggers"]} == {"read"}


def _planes_node(pkg, tmp_path, **kw):
    """A node of ``pkg`` on a data dir with every sampler's period long, so
    only the test's explicit calls take samples."""
    node_mod = _mod(pkg, "server.node")
    kw.setdefault("history_cadence", 3600.0)
    kw.setdefault("flightrec_segment_seconds", 3600.0)
    kw.setdefault("blackbox_interval", 3600.0)
    kw.setdefault("metric_poll_interval", 3600.0)
    if pkg == "pilosa_tpu":
        kw.setdefault("resize_watchdog_deadline", 0)
    else:
        kw.setdefault("device", "cpu")
    return node_mod.NodeServer(data_dir=str(tmp_path / pkg), port=0, **kw)


def _post(uri, path, body):
    req = urllib.request.Request(uri + path, data=body.encode(), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _get(uri, path):
    try:
        with urllib.request.urlopen(uri + path, timeout=10) as r:
            return r.status, json.loads(r.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _wait_recorded(node, n):
    """Until the SLO tracker has recorded ``n`` requests: a handler records
    its request just after the answer leaves, so a client can see the
    answer first."""
    t_end = time.monotonic() + 10
    while sum(c["total"] for c in node.holder.slo.series_sample().values()) < n:
        assert time.monotonic() < t_end, node.holder.slo.series_sample()
        time.sleep(0.005)


def test_sample_once_reads_the_planes_jax_reads(tmp_path):
    """A sample of a node at its defaults holds the series JAX's holds: the
    SLO classes, the batcher, QoS tenants, the device ledger, residency and
    the ingest plane."""
    names = {}
    for pkg in PKGS:
        node = _planes_node(pkg, tmp_path, flight_recorder=False)
        node.start()
        try:
            _post(node.uri, "/index/i", "{}")
            _post(node.uri, "/index/i/field/f", "{}")
            _post(node.uri, "/index/i/field/f/import", '{"rowIDs": [1, 2], "columnIDs": [3, 4]}')
            node.history.sample_once()
            for q in ("Count(Row(f=1))", "TopN(f)", "Row(f=2)"):
                assert _post(node.uri, "/index/i/query", q)[0] == 200
            _wait_recorded(node, 6)
            node.history.sample_once()
            names[pkg] = set(node.history.query()["series"])
            assert node.history.stats()["samples"] == 2
        finally:
            node.stop()
    assert names["pilosa_tpu"] == names["pilosa_tpu_torch"]
    assert {"dev.device_ms_ps", "batcher.depth", "ingest.decoded_ps"} <= names["pilosa_tpu_torch"]


# -- flight recorder ----------------------------------------------------------

def _parked_in_marker(depth, stop, ready):
    if depth:
        return _parked_in_marker(depth - 1, stop, ready)
    ready.release()
    stop.wait(30)


def test_stack_sampler_collapses_as_jaxs():
    """The port's sampler keys stacks by their code objects and collapses
    them at the drain; its stacks and thread counts equal JAX's over the
    same parked threads (the ones the test parked: other threads of the
    process may move between the two ticks)."""
    stop, ready = threading.Event(), threading.Semaphore(0)
    threads = [threading.Thread(target=_parked_in_marker, args=(d, stop, ready),
                                name=f"parked-{d}") for d in (0, 3, 3, 9)]
    for t in threads:
        t.start()
    try:
        for _ in threads:
            assert ready.acquire(timeout=30)
        out = []
        for pkg in PKGS:
            sampler = _mod(pkg, "obs.profile").Sampler()
            for _ in range(3):
                sampler.tick()
            got = sampler.drain(top=None)
            out.append(({k: v for k, v in got["stacks"].items() if "_parked_in_marker" in k},
                        {k: v for k, v in got["threads"].items() if k.startswith("parked-")},
                        got["samples"]))
    finally:
        stop.set()
        for t in threads:
            t.join(30)
    assert out[0] == out[1]
    stacks, names, samples = out[1]
    assert samples == 3 and sorted(stacks.values()) == [3, 3, 6]
    assert names == {"parked-0": 3, "parked-3": 6, "parked-9": 3}

def _holder(pkg):
    core = _mod(pkg, "core.holder")
    h = core.Holder(device="cpu") if pkg == "pilosa_tpu_torch" else core.Holder()
    h.set_stats(_mod(pkg, "obs.stats").MemStatsClient())
    return h


def _segment(fr, pkg):
    sampler = _mod(pkg, "obs.profile").Sampler()
    sampler.tick()
    seg = fr._segment(sampler, 0.5)
    fr._record_segment(seg)
    fr._check_incidents(seg)
    return seg


@pytest.mark.parametrize("deltas", [
    [0, 6, 7, 0, 5, 2, 0, 9],
    [5, 5, 5, 0, 0, 5],
    [4, 4, 4, 4],
    [0, 0, 12, 1, 1, 0, 6],
], ids=lambda d: ",".join(map(str, d)))
def test_deadline_504_spike_edge_alike(deltas):
    out = []
    for pkg in PKGS:
        holder = _holder(pkg)
        fr = _mod(pkg, "obs.flightrec").FlightRecorder(holder, spike_504=5)
        fr._last_504 = holder.stats.get_counter("http_deadline_exceeded")
        seen = []
        for d in deltas:
            if d:
                holder.stats.count("http_deadline_exceeded", d)
            seg = _segment(fr, pkg)
            seen.append(seg["deadline504Delta"])
        snap = fr.incidents_snapshot()
        out.append((seen, [b["trigger"] for b in snap["incidents"]], snap["segments"]))
    assert out[0] == out[1]
    assert out[1][0] == deltas


class _FakeSLO:
    """SLO snapshots whose alerts fire on a script."""

    def __init__(self, script):
        self.script = list(script)

    def snapshot(self):
        firing = self.script.pop(0) if self.script else set()
        classes = {}
        for cname in ("read.count", "write"):
            classes[cname] = {
                "alerts": {rule: (cname, rule) in firing for rule in ("page", "ticket")},
                "total": 10, "errors": 1, "latency": {"p99Ms": 12.5},
            }
        return {"classes": classes}


def test_slo_alert_edges_alike():
    script = [set(), {("read.count", "page")}, {("read.count", "page"), ("write", "ticket")},
              set(), set(), {("write", "ticket")}, {("write", "ticket")}, set()]
    out = []
    for pkg in PKGS:
        holder = _holder(pkg)
        holder.slo = _FakeSLO(script)
        fr = _mod(pkg, "obs.flightrec").FlightRecorder(holder)
        for _ in script:
            _segment(fr, pkg)
        bundles = [fr.incident_detail(b["id"]) for b in fr.incidents_snapshot()["incidents"]]
        out.append([(b["trigger"], b["slo"], len(b["segments"])) for b in bundles])
        journal = [e for e in holder.events.since(0)["events"] if e["type"] == "incident"]
        assert len(journal) == 2
    assert out[0] == out[1]
    assert [t["type"] for t, _, _ in out[1]] == ["slo-alert", "slo-alert"]


def test_capture_incident_bundle_alike():
    out = []
    for pkg in PKGS:
        holder = _holder(pkg)
        fr = _mod(pkg, "obs.flightrec").FlightRecorder(holder, incident_segments=3)
        hist = _mod(pkg, "obs.history").MetricsHistory(holder, tiers="8@1,2@4", detectors="")
        for i in range(9):
            hist.record({"slo.read.p99_ms": float(i), "batcher.depth": 1.0}, wall=500.0 + i)
        fr.series_provider = hist.incident_series
        flushed = []
        fr.on_incident = flushed.append
        fr.capture_incident({"type": "ignored-while-stopped"})
        assert fr.incidents_snapshot()["incidents"] == []
        for _ in range(5):
            seg = _segment(fr, pkg)
        fr._capture({"type": "qos-ladder", "tenant": "t1", "stage": 2})
        bundle = fr.incident_detail(fr.incidents_snapshot()["incidents"][0]["id"])
        assert flushed and flushed[0]["id"] == bundle["id"]
        assert fr.incident_detail("nope") is None
        out.append({
            "keys": sorted(bundle),
            "trigger": bundle["trigger"],
            "segments": len(bundle["segments"]),
            "segmentKeys": sorted(seg),
            "series": bundle["series"],
            "list": _stable(fr.incidents_snapshot()),
            "full": len(fr.incidents_full()),
        })
    assert out[0] == out[1]


def _stub_cuda_events(monkeypatch, ms=1.5):
    from pilosa_tpu_torch.ops import kernels as tk

    class _Event:
        def __init__(self, **kw):
            pass

        def record(self, stream=None):
            pass

        def query(self):
            return True

        def synchronize(self):
            pass

        def elapsed_time(self, other):
            return ms

    monkeypatch.setattr(tk.torch.cuda, "Event", _Event)
    monkeypatch.setattr(tk.torch.cuda, "current_stream", lambda device=None: None)
    return tk


def test_kernel_dispatch_delta_counts_the_ports_launches(monkeypatch):
    """``kernelDispatchDelta`` is the launch funnel's count between two
    segments (JAX's dispatch lanes have no counterpart), and
    ``devledgerDelta.launches`` the ledger's; a reset of the counts starts
    the next delta from zero, never below it."""
    from pilosa_tpu_torch.obs.flightrec import FlightRecorder

    tk = _stub_cuda_events(monkeypatch)
    saved = dict(tk.LAUNCHES)
    try:
        fr = FlightRecorder(_holder("pilosa_tpu_torch"))
        assert _segment(fr, "pilosa_tpu_torch")["kernelDispatchDelta"] == 0
        for name in ("gram", "tree_count", "bsi_sum"):
            with tk._launching(name, None):
                pass
        seg = _segment(fr, "pilosa_tpu_torch")
        assert seg["kernelDispatchDelta"] == 3
        assert seg["devledgerDelta"]["launches"] == 3
        assert _segment(fr, "pilosa_tpu_torch")["kernelDispatchDelta"] == 0
        tk.reset_launches()
        with tk._launching("gram", None):
            pass
        assert _segment(fr, "pilosa_tpu_torch")["kernelDispatchDelta"] == 1
    finally:
        tk.LAUNCHES.update(saved)


# -- black box ---------------------------------------------------------------

def _box(pkg, path, holder=None, **kw):
    kw.setdefault("node_id", "t")
    return _mod(pkg, "obs.blackbox").BlackBox(holder or _holder(pkg), str(path), **kw)


def _die(box):
    """End a box's life as a crash would: no clean marker, no atexit close,
    its faulthandler file let go."""
    box._closed = True
    box._disarm_faulthandler()
    import atexit

    atexit.unregister(box._atexit)


def _seg_seqs(box):
    return sorted(int(os.path.basename(p)[4:12]) for p in box._seg_files())


def bb_count_cap(pkg, path):
    box = _box(pkg, path, max_segments=3)
    try:
        first = box.open()
        for _ in range(6):
            box.checkpoint("test")
        # the spool's bytes differ: each ledger names its own sites
        stats = {k: v for k, v in box.stats().items() if k != "bytes"}
        return [first, _seg_seqs(box), _stable(stats)]
    finally:
        box.close(clean=True)


def bb_byte_cap(pkg, path):
    box = _box(pkg, path, max_segments=100)
    try:
        box.open()
        box.checkpoint("seed")
        box.max_bytes = int(os.path.getsize(box._seg_files()[0]) * 1.5)
        for _ in range(4):
            box.checkpoint("test")
        return _seg_seqs(box)
    finally:
        box.close(clean=True)


def bb_markers(pkg, path):
    out = []
    b1 = _box(pkg, path)
    out.append(b1.open())
    b1.checkpoint("work")
    b1.close(clean=True)
    b2 = _box(pkg, path)
    out.append(b2.open())
    out.append(b2.postmortems()["postmortems"])
    b2.checkpoint("work")  # life 2 dies dirty: never closed
    _die(b2)
    b3 = _box(pkg, path)
    try:
        pm = b3.open()
        out.append((pm["crashLoop"], pm["segments"], pm["torn"], sorted(pm)))
        out.append(b3._seg_files())
        got = b3.postmortems()
        out.append((got["latest"] == pm["id"], got["postmortem"]["id"] == pm["id"],
                    sorted(got["postmortems"][0])))
        out.append(b3.postmortem_detail(pm["id"])["id"] == pm["id"])
        out.append(b3.postmortem_detail("nope"))
    finally:
        b3.close(clean=True)
    with open(os.path.join(path, "_blackbox", "STATUS")) as f:
        out.append(json.load(f)["state"])
    return out


def bb_crash_loop(pkg, path):
    out = []
    for _ in range(3):
        box = _box(pkg, path)
        pm = box.open()
        out.append(None if pm is None else pm["crashLoop"])
        box.checkpoint("work")
        _die(box)  # never closed: every life dies dirty
    clean = _box(pkg, path)
    out.append(clean.open()["crashLoop"])
    clean.close(clean=True)
    after = _box(pkg, path)
    out.append(after.open())
    after.checkpoint("work")
    _die(after)
    final = _box(pkg, path)
    try:
        out.append(final.open()["crashLoop"])
        out.append(len(final.postmortems()["postmortems"]))
    finally:
        final.close(clean=True)
    return out


def bb_torn(pkg, path):
    box = _box(pkg, path)
    box.open()
    box.holder.events.record("test-event", n=1)
    box.checkpoint("one")
    box.holder.events.record("test-event", n=2)
    box.checkpoint("two")
    files = box._seg_files()
    with open(files[-1], "r+b") as f:
        f.truncate(os.path.getsize(files[-1]) // 2)
    _die(box)
    box2 = _box(pkg, path)
    try:
        pm = box2.open()
        events = [(e["type"], e["data"]) for e in pm["events"]]
        return [pm["torn"], pm["segments"], events, box2.stats()["torn"]]
    finally:
        box2.close(clean=True)


def bb_postmortem_blocks(pkg, path):
    holder = _holder(pkg)
    fr = _mod(pkg, "obs.flightrec").FlightRecorder(holder)
    hist = _mod(pkg, "obs.history").MetricsHistory(holder, tiers="8@1", detectors="")
    box = _box(pkg, path, holder=holder, flightrec=fr, history=hist)
    box.open()
    fr.on_incident = box.flush_incident
    for i in range(3):
        hist.record({"slo.read.rps": float(i)}, wall=700.0 + i)
        _segment(fr, pkg)
    fr._capture({"type": "test", "note": "bb"})
    box.checkpoint("work")
    _die(box)
    box2 = _box(pkg, path)
    try:
        pm = box2.open()
        crash = [e for e in box2.holder.events.since(0)["events"]
                 if e["type"] == "node-crash-detected"]
        return [
            sorted(pm), [b["trigger"] for b in pm["incidents"]], len(pm["flightrecSegments"]),
            pm["history"]["series"], sorted(pm["traces"]), sorted(pm["slo"]),
            box.stats()["syncFlushes"], [e["data"]["crashLoop"] for e in crash],
            "launches" in pm["devledger"],
        ]
    finally:
        box2.close(clean=True)


BB_CASES = {f.__name__: f for f in (bb_count_cap, bb_byte_cap, bb_markers, bb_crash_loop,
                                     bb_torn, bb_postmortem_blocks)}


@pytest.mark.parametrize("case", sorted(BB_CASES))
def test_black_box_alike(case, tmp_path):
    out = [_stable(BB_CASES[case](pkg, tmp_path / pkg)) for pkg in PKGS]
    assert out[0] == out[1]


def test_black_box_spool_layout_is_jaxs(tmp_path):
    names = []
    for pkg in PKGS:
        box = _box(pkg, tmp_path / pkg)
        box.open()
        box.checkpoint("one")
        _die(box)
        names.append(sorted(os.listdir(tmp_path / pkg / "_blackbox")))
        box2 = _box(pkg, tmp_path / pkg)
        box2.open()
        names.append(sorted(n.split("-")[0] for n in os.listdir(tmp_path / pkg / "_blackbox")))
        box2.close(clean=True)
    assert names[0] == names[2] and names[1] == names[3]
    assert names[2] == ["STATUS", "last-words.txt", "seg-00000001.json"]


def test_a_checkpoint_carries_on_after_a_sticky_device_error(tmp_path):
    """After a sticky CUDA error every event read raises: the ledger's
    non-waiting read counts it and still returns the host's counts, and a
    checkpoint writes its segment with every plane it could read."""
    from pilosa_tpu_torch.obs import devledger

    class _Broken:
        def query(self):
            raise RuntimeError("CUDA error: an illegal memory access was encountered")

        def synchronize(self):
            raise AssertionError("a checkpoint must never wait for the card")

        def elapsed_time(self, other):
            raise RuntimeError("sticky")

    led = devledger.ledger()
    site = led.site("test.sticky")
    box = _box("pilosa_tpu_torch", tmp_path)
    box.open()
    try:
        before = led.counters()
        site.record_cuda_launch(_Broken(), _Broken(), wall_s=0.001)
        c = led.counters()
        assert c["launches"] == before["launches"] + 1
        assert c["settleErrors"] == before["settleErrors"] + 1
        box.checkpoint("after-error")
        with open(box._seg_files()[-1]) as f:
            seg = json.load(f)
        assert seg["devledger"]["launches"] == c["launches"]
        assert {"slo", "events", "traces"} <= set(seg)
    finally:
        box.close(clean=True)
        led.reset_sites(["test.sticky"])


def test_signal_handlers_install_once_and_restore_the_previous(tmp_path):
    from pilosa_tpu_torch.obs import blackbox as bb

    prev = signal.getsignal(signal.SIGTERM)
    drained = []

    class _Node:
        def shutdown_graceful(self):
            drained.append(self)

    a, b = _Node(), _Node()
    assert bb.install_signal_handlers(a) and bb.install_signal_handlers(b)
    assert signal.getsignal(signal.SIGTERM) is bb._handle_sigterm
    bb._drain_nodes()
    assert drained == [a, b]
    bb.uninstall_signal_handlers(a)
    assert signal.getsignal(signal.SIGTERM) is bb._handle_sigterm
    bb.uninstall_signal_handlers(b)
    assert signal.getsignal(signal.SIGTERM) is prev
    result = []
    t = threading.Thread(target=lambda: result.append(bb.install_signal_handlers(a)))
    t.start()
    t.join(10)
    assert result == [False] and signal.getsignal(signal.SIGTERM) is prev


# -- diagnostics, runtime gauges ---------------------------------------------

def test_diagnostics_report_alike(tmp_path):
    reports = []
    for pkg in PKGS:
        holder = _holder(pkg)
        idx = holder.create_index("i")
        fo = _mod(pkg, "core.field").FieldOptions
        idx.create_field("f")
        idx.create_field("v", fo(field_type="int", min_=0, max_=100))
        for col in (3, 70000):
            idx.field("f").set_bit(1, col)
        diag = _mod(pkg, "obs.diagnostics").Diagnostics(holder, version="x")
        diag.set("extra", 7)
        sink = tmp_path / f"{pkg}.jsonl"
        diag.sink_path = str(sink)
        diag.flush()
        with open(sink) as f:
            line = json.loads(f.readline())
        rep = diag.snapshot()
        assert set(line) == set(rep)
        reports.append(rep)
    j, t = reports
    assert set(j) == set(t) and set(j["system"]) == set(t["system"])
    for key in ("numNodes", "numIndexes", "numFields", "numViews", "numFragments",
                "numShards", "extra", "version"):
        assert j[key] == t[key], key
    # no fallback in the port: the key stays, always 0
    assert t["pallasFallbacks"] == 0


def test_runtime_monitor_gauges_and_gc_notifier_alike():
    gauges = []
    for pkg in PKGS:
        si = _mod(pkg, "obs.sysinfo")
        mem = _mod(pkg, "obs.stats").MemStatsClient()
        n = si.GCNotifier()
        try:
            gc.collect()
            gc.collect()
            assert n.collections >= 2
            si.RuntimeMonitor(mem, gc_notifier=n).poll_once()
        finally:
            n.close()
        before = n.collections
        gc.collect()
        assert n.collections == before  # detached after close
        g = mem.snapshot()["gauges"]
        assert g["memory_rss_bytes"] > 0 and g["garbage_collections"] >= 2
        gauges.append(set(g))
    assert gauges[0] == gauges[1]


def test_runtime_monitor_thread_stops():
    from pilosa_tpu_torch.obs.sysinfo import RuntimeMonitor
    from pilosa_tpu_torch.obs.stats import MemStatsClient

    mon = RuntimeMonitor(MemStatsClient(), interval=3600.0)
    mon.start()
    try:
        assert mon._thread.is_alive()
    finally:
        mon.stop()
    assert mon._thread is None


# -- span export ---------------------------------------------------------------

def _finished_span(pkg, name="q", error=False):
    tracing = _mod(pkg, "obs.tracing")
    rec = tracing.RecordingTracer()
    span = rec.start_span(name)
    span.set_tag("index", "i")
    if error:
        span.set_tag("error", True)
    span.finish()
    return rec, span


@pytest.mark.parametrize("error", [False, True])
def test_otlp_span_encoding_alike(error):
    _, span = _finished_span("pilosa_tpu_torch", error=error)
    enc = [_mod(pkg, "obs.export")._otlp_span(span) for pkg in PKGS]
    assert enc[0] == enc[1]
    assert enc[1]["status"] == {"code": 2 if error else 0}


def test_exporting_tracer_samples_alike():
    ids = [int(x) for x in np.random.default_rng(5).integers(1, 2**62, 400)]
    for rate in (0.0, 0.1, 0.5, 1.0):
        got = []
        for pkg in PKGS:
            tr = _mod(pkg, "obs.tracing").ExportingTracer(None, sample_rate=rate)
            got.append([tr._sampled(i) for i in ids])
        assert got[0] == got[1], rate


class _Collector(BaseHTTPRequestHandler):
    bodies: list = []
    got = threading.Event()  # set at each body received

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        type(self).bodies.append((self.path, json.loads(self.rfile.read(n))))
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()
        type(self).got.set()

    def log_message(self, *a):
        pass


def test_exporter_posts_jaxs_payload_and_a_down_collector_drops():
    srv = HTTPServer(("127.0.0.1", 0), _Collector)
    srv_thread = threading.Thread(target=srv.serve_forever, daemon=True)
    srv_thread.start()
    _Collector.bodies = []
    exporters = []
    try:
        for pkg in PKGS:
            # three spans, posted in one batch or more
            exp = _mod(pkg, "obs.export").OTLPSpanExporter(
                f"http://127.0.0.1:{srv.server_address[1]}", batch_size=3,
                flush_interval=0.2)
            exporters.append(exp)
            tracer = _mod(pkg, "obs.tracing").ExportingTracer(exp, sample_rate=1.0)
            for name in ("a", "b", "c"):
                tracer.start_span(name).finish()
            want = 3 * len(exporters)
            while sum(len(b["resourceSpans"][0]["scopeSpans"][0]["spans"])
                      for _, b in list(_Collector.bodies)) < want:
                assert _Collector.got.wait(10)
                _Collector.got.clear()
            tracer.close()  # joins the loop, its last post done
            assert exp.exported == 3 and exp.dropped == 0
        (p0, b0), (p1, b1) = _Collector.bodies[0], _Collector.bodies[-1]
        assert p0 == p1 == "/v1/traces"
        strip = lambda b: [sorted(s) for s in b["resourceSpans"][0]["scopeSpans"][0]["spans"]]
        assert strip(b0) == strip(b1)
        assert b0["resourceSpans"][0]["resource"] == b1["resourceSpans"][0]["resource"]
    finally:
        for exp in exporters:
            exp.close()
        srv.shutdown()
        srv.server_close()
    # nothing listens on that port now: export never blocks, the batch drops
    from pilosa_tpu_torch.obs.export import OTLPSpanExporter

    down = OTLPSpanExporter(f"http://127.0.0.1:{srv.server_address[1]}", batch_size=5,
                            flush_interval=0.2, timeout=1.0)
    try:
        _, span = _finished_span("pilosa_tpu_torch")
        t0 = time.perf_counter()
        for _ in range(5):
            down.export(span)
        assert time.perf_counter() - t0 < 0.05
    finally:
        down.close()  # the loop ends once its batch of five was posted or dropped
    assert down.exported == 0 and down.dropped + down._q.qsize() == 5


# -- the device ledger's reads -----------------------------------------------

def test_ledger_counters_have_jaxs_keys(monkeypatch):
    from pilosa_tpu.obs import devledger as jdl
    from pilosa_tpu_torch.obs import devledger as tdl

    jkeys = {k for k in jdl.Ledger().counters() if not k.startswith("site.")}
    led = tdl.Ledger()
    site = led.site("kernels.gram")
    tk = _stub_cuda_events(monkeypatch, ms=2.0)
    site.record_cuda_launch(tk.torch.cuda.Event(), tk.torch.cuda.Event(), wall_s=0.001)
    site.record_transfer(100)
    c = led.counters()
    assert jkeys <= set(c)
    assert (c["launches"], c["deviceMs"], c["h2dBytes"], c["compiles"], c["storms"]) == (
        1, 2.0, 100, 0, 0)
    assert (c["site.kernels.gram.launches"], c["site.kernels.gram.transferBytes"]) == (1, 100)
    for fn in ("reset", "mark_warm", "configure_storm", "on_storm", "counters"):
        assert callable(getattr(tdl, fn)) and callable(getattr(jdl, fn)), fn
    led.configure_storm(threshold=3, window_s=5.0, warmup_s=1.0)
    assert (led.storm_threshold, led.storm_window_s, led.warmup_s) == (3, 5.0, 1.0)
    led.mark_warm()
    assert led.warm
    led.reset()
    c = led.counters()
    assert (c["launches"], c["deviceMs"], c["h2dBytes"]) == (0, 0.0, 0) and not led.warm


class _SlowEvent:
    """An end event of a launch still running: it finishes when the test
    sets ``done``; synchronize blocks until then."""

    entered = threading.Event()

    def __init__(self, ms, done):
        self.ms, self.done = ms, done

    def query(self):
        return self.done.is_set()

    def synchronize(self):
        type(self).entered.set()
        assert self.done.wait(30)

    def elapsed_time(self, end):
        return end.ms - self.ms


def test_no_read_of_the_ledger_waits_behind_a_waiting_snapshot():
    """A snapshot (an exposition route) waits for a long launch with no lock
    held: meanwhile the samplers' and the query path's reads, and new
    launches, return at once, and the snapshot still reads every pair."""
    from pilosa_tpu_torch.obs import devledger

    led = devledger.Ledger()
    site = led.site("kernels.gram")
    done = threading.Event()
    site.record_cuda_launch(_SlowEvent(0.0, done), _SlowEvent(5.0, done), wall_s=0.001,
                            sig="gram")
    snaps = []
    _SlowEvent.entered.clear()
    waiter = threading.Thread(target=lambda: snaps.append(led.snapshot()))
    waiter.start()
    try:
        assert _SlowEvent.entered.wait(10)  # the snapshot waits for the launch
        t0 = time.perf_counter()
        c = led.counters()
        led.measured_ms("kernels.gram", "gram")
        led.tenant_totals()
        for _ in range(300):  # past the queue length at which a launch folds
            site.record_cuda_launch(_SlowEvent(0.0, done), _SlowEvent(1.0, done),
                                    wall_s=0.001)
        took = time.perf_counter() - t0
        assert waiter.is_alive()  # still waiting for the first launch
        assert took < 1.0, took
        assert c["launches"] == 1 and c["deviceMs"] == 0.0 and c["pendingTimings"] == 1
    finally:
        done.set()
        waiter.join(30)
    assert snaps and snaps[0]["sites"]["kernels.gram"]["deviceMs"] >= 5.0
    led.snapshot()
    assert led.counters()["deviceMs"] == 5.0 + 300.0


def test_non_waiting_settle_skips_while_another_thread_folds():
    from pilosa_tpu_torch.obs import devledger

    led = devledger.Ledger()
    done = threading.Event()
    done.set()
    led.site("kernels.gram").record_cuda_launch(_SlowEvent(0.0, done), _SlowEvent(2.0, done),
                                                wall_s=0.001)
    with led._settle_lock:
        t = threading.Thread(target=lambda: led.settle(wait=False))
        t.start()
        t.join(10)
        assert not t.is_alive()
        assert led.totals.device_ms == 0.0  # skipped: another thread folds
    led.settle(wait=False)
    assert led.totals.device_ms == 2.0


# -- the node ------------------------------------------------------------------

PLANE_KNOBS = [
    "metric_poll_interval", "default_deadline", "slow_query_time", "slo_objectives",
    "slo_burn_rules", "slo_slot_seconds", "slo_latency_window", "trace_store_capacity",
    "trace_baseline_n", "flight_recorder", "flightrec_segment_seconds",
    "flightrec_sample_interval", "flightrec_segments", "flightrec_spike_504",
    "history_enabled", "history_cadence", "history_tiers", "history_detectors",
    "history_warmup", "history_trips", "history_latency_factor", "history_latency_min_ms",
    "devledger_storm_threshold", "devledger_storm_window", "devledger_warmup",
    "blackbox_enabled", "blackbox_interval", "blackbox_max_segments", "blackbox_max_bytes",
    "blackbox_keep_postmortems", "blackbox_history_window",
]


@pytest.mark.parametrize("knob", PLANE_KNOBS)
def test_node_knob_default_is_jaxs(knob):
    defaults = [inspect.signature(_mod(pkg, "server.node").NodeServer).parameters[knob].default
                for pkg in PKGS]
    assert defaults[0] == defaults[1]


def test_node_runs_every_plane_by_default_and_stops_them(tmp_path):
    from pilosa_tpu_torch.server.node import NodeServer

    node = NodeServer(data_dir=str(tmp_path / "d"), device="cpu", port=0)
    try:
        assert node.flightrec.sample_interval == 0.025
        assert (node.flightrec.segment_seconds, node.flightrec.max_segments) == (1.0, 60)
        assert node.flightrec.spike_504 == 5
        assert node.history.cadence == 1.0 and len(node.history.tiers) == 2
        assert node.blackbox.interval == 5.0 and node.postmortem is None
        assert node.runtime_monitor.interval == 10.0
        assert node.history.flightrec is node.flightrec
        assert node.flightrec.series_provider == node.history.incident_series
        assert node.flightrec.on_incident == node.blackbox.flush_incident
        node.start()
        names = {t.name for t in threading.enumerate()}
        assert {"flight-recorder", "metrics-history", "blackbox-writer",
                "runtime-monitor"} <= names
        # the QoS ladder's incident reaches the flight recorder
        node.api.qos._incident_fn({"type": "qos-ladder", "tenant": "t1"})
        incidents = node.api.incidents_snapshot()["incidents"]
        assert [b["trigger"]["type"] for b in incidents] == ["qos-ladder"]
        assert node.blackbox.stats()["syncFlushes"] == 1
    finally:
        node.shutdown_graceful()
    assert node.wait(10)
    names = {t.name for t in threading.enumerate()}
    assert not names & {"flight-recorder", "metrics-history", "blackbox-writer",
                        "runtime-monitor"}
    with open(tmp_path / "d" / "_blackbox" / "STATUS") as f:
        assert json.load(f)["state"] == "clean"


def test_slo_knobs_replace_the_tracker(tmp_path):
    from pilosa_tpu_torch.server.node import NodeServer

    node = NodeServer(device="cpu", port=0,
                      slo_objectives={"read.count": {"availability": 0.9, "latencyP99Ms": 1}},
                      slo_burn_rules=[{"name": "fast", "long": 4.0, "short": 1.0, "factor": 2.0}],
                      slo_slot_seconds=0.5, slo_latency_window=4.0,
                      trace_store_capacity=7, trace_baseline_n=1)
    try:
        slo = node.holder.slo
        assert node.holder.traces.slo is slo and node.holder.traces.capacity == 7
        assert slo.objectives["read.count"].latency_p99 == pytest.approx(0.001)
        assert [r.name for r in slo.burn_rules] == ["fast"]
        assert node.blackbox is None  # no data dir: nowhere to survive a crash
    finally:
        node.stop()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cli(data_dir, port, home):
    env = dict(os.environ, PYTHONPATH=str(REPO), HOME=str(home))
    out = open(home / f"out-{time.monotonic_ns()}.txt", "w+")
    cfg = home / "config.json"
    # the black box checkpoints every 0.2 s, so a life killed early has one
    cfg.write_text(json.dumps({"blackbox": {"interval": 0.2}}))
    proc = subprocess.Popen(
        [sys.executable, "-m", "pilosa_tpu_torch.cli", "server", "--device", "cpu",
         "-d", str(data_dir), "--bind", f"127.0.0.1:{port}", "-c", str(cfg)],
        cwd=REPO, env=env, stdout=out, stderr=subprocess.STDOUT, text=True,
    )
    uri = f"http://127.0.0.1:{port}"
    deadline = time.monotonic() + 90
    while True:
        try:
            _get(uri, "/status")
            break
        except (urllib.error.URLError, ConnectionError):
            if proc.poll() is not None:
                out.seek(0)
                raise AssertionError(out.read())
            assert time.monotonic() < deadline, "the server did not come up"
            time.sleep(0.1)
    return proc, out, uri


def _output(out):
    out.flush()
    out.seek(0)
    return out.read()


def test_cli_server_sigkilled_restarts_to_a_postmortem(tmp_path):
    """``cli server`` killed with SIGKILL: the next boot prints the
    postmortem line and serves one bundle with ``crashLoop`` 1 holding the
    first life's events; SIGTERM then stops it cleanly, and the boot after
    that makes no new bundle; a SIGSEGV leaves every thread's stack in
    ``last-words.txt``."""
    data, port = tmp_path / "d", _free_port()
    procs = []
    try:
        proc, out, uri = _cli(data, port, tmp_path)
        procs.append(proc)
        _post(uri, "/index/i", "{}")
        _post(uri, "/index/i/field/f", "{}")
        assert _post(uri, "/index/i/query", "Set(3, f=1)")[0] == 200
        assert _post(uri, "/index/i/query", "Count(Row(f=1))") == (200, {"results": [1]})
        # a checkpoint after the queries, then the plug is pulled
        seen = _get(uri, "/debug/vars")[1]["blackbox"]["checkpoints"]
        deadline = time.monotonic() + 30
        while _get(uri, "/debug/vars")[1]["blackbox"]["checkpoints"] < seen + 2:
            assert time.monotonic() < deadline, "no checkpoint"
            time.sleep(0.05)
        proc.kill()
        proc.wait(30)
        assert "previous life died dirty" not in _output(out)

        proc, out, uri = _cli(data, port, tmp_path)
        procs.append(proc)
        assert "previous life died dirty: postmortem" in _output(out)
        code, got = _get(uri, "/debug/postmortem")
        assert code == 200 and len(got["postmortems"]) == 1
        pm = got["postmortem"]
        assert pm["crashLoop"] == 1 and pm["segments"] >= 1
        assert any(e["type"] == "node-start" for e in pm["events"])
        assert "launches" in pm["devledger"]
        assert pm["slo"]["snapshot"]["classes"]  # the first life's queries
        assert _get(uri, f"/debug/postmortem?id={pm['id']}")[1]["id"] == pm["id"]
        assert _post(uri, "/index/i/query", "Count(Row(f=1))") == (200, {"results": [1]})
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(30) == 0

        proc, out, uri = _cli(data, port, tmp_path)
        procs.append(proc)
        assert "previous life died dirty" not in _output(out)
        assert len(_get(uri, "/debug/postmortem")[1]["postmortems"]) == 1
        proc.send_signal(signal.SIGSEGV)
        assert proc.wait(30) != 0
        with open(data / "_blackbox" / "last-words.txt") as f:
            words = f.read()
        assert "Fatal Python error" in words and "Thread" in words
        assert words.count("File ") >= 2
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
