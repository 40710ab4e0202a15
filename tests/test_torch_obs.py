"""The port's observability modules against ``pilosa_tpu``'s: each case
feeds both packages the same seeded input and their outputs must be
equal (times aside): the deadline budget, ``slo.classify_query`` over
each package's own PQL parse, ``stats.prometheus_text``, the
``traceparent`` header both ways, the trace store's tail-sampling keep
decision, ``qprofile``'s call tree, the event journal and the job
tracker. Then the port's device ledger: a launch's device time is read
from its event pair at snapshot time, never on the query path."""

import importlib

import numpy as np
import pytest

PKGS = ("pilosa_tpu", "pilosa_tpu_torch")
# fields that hold a time, removed before comparing
TIMES = {"ts", "at", "started", "updated", "finished", "elapsed", "startedAt",
         "duration_ms", "durationMs", "startUnixMs", "rates", "eta_seconds"}


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _untimed(obj):
    if isinstance(obj, dict):
        return {k: _untimed(v) for k, v in obj.items() if k not in TIMES}
    if isinstance(obj, list):
        return [_untimed(v) for v in obj]
    return obj


def case_deadline(pkg, rng):
    dl = _mod(pkg, "deadline")
    out = []
    for raw in ["", "abc", "-1", "0", "nan", "inf", "2.5", "1e-3", None, "  7 "]:
        out.append(dl.from_header(raw))
    with dl.scope(None):
        out.append((dl.remaining(), dl.expired()))
    with dl.scope(1e-9):
        try:
            dl.check("x")
            out.append("no raise")
        except dl.DeadlineExceeded as e:
            out.append(("raised", str(e)))
    with dl.scope(100.0):
        out.append((dl.expired(), 99 < dl.remaining() <= 100, dl.would_expire_within(200)))
        out.append(float(dl.header_value()) > 99)
    return out


def case_classify_query(pkg, rng):
    pql = _mod(pkg, "pql")
    slo = _mod(pkg, "obs.slo")
    texts = [
        "Count(Row(f=1))", "TopN(f)", "Row(f=1)", "Range(f=1)", "GroupBy(Rows(f))",
        "Sum(field=v)", "Set(1, f=1)", "Count(Row(f=1)) Set(2, f=2)", "Rows(f)",
        "Intersect(Row(f=1), Row(g=2))", "Clear(1, f=1)", "Store(Row(f=1), g=2)",
        "ClearRow(f=1)", "SetRowAttrs(f, 1, x=2)", "Options(Row(f=1), shards=[1])",
    ]
    picks = [texts[k] for k in rng.integers(0, len(texts), 40)]
    return [slo.classify_query(pql.parse(t)) for t in texts + picks]


def case_prometheus_text(pkg, rng):
    stats = _mod(pkg, "obs.stats")
    c = stats.MemStatsClient()
    for k in range(30):
        name = ["queries", "imports", "http_request"][k % 3]
        tagged = c.with_tags(f"index:i{k % 2}")
        tagged.count(name, int(rng.integers(1, 5)))
        c.gauge("device_used_bytes", int(rng.integers(0, 1 << 30)))
        c.timing("http_request", float(rng.random() / 10))
        c.histogram("sizes", float(rng.integers(1, 1 << 20)))
        c.set_value("tenants", f"t{rng.integers(0, 4)}")
    return stats.prometheus_text(c)


def case_traceparent(pkg, rng):
    tracing = _mod(pkg, "obs.tracing")
    out = []
    for _ in range(20):
        tid = int(rng.integers(1, 2**62)) << int(rng.integers(0, 60))
        sid = int(rng.integers(1, 2**62))
        header = tracing.format_traceparent(tracing.SpanContext(tid, sid))
        back = tracing.parse_traceparent(header)
        out.append((header, back.trace_id, back.span_id, back.remote))
    for bad in ["", "00-xyz", "01-" + "a" * 32 + "-" + "b" * 16 + "-01",
                "00-" + "0" * 32 + "-" + "b" * 16 + "-01", None]:
        ctx = tracing.parse_traceparent(bad)
        out.append(None if ctx is None else (ctx.trace_id, ctx.span_id))
    return out


def case_tracestore_keep(pkg, rng):
    ts = _mod(pkg, "obs.tracestore")
    slo = _mod(pkg, "obs.slo")
    store = ts.TraceStore(slo=slo.SLOTracker(), baseline_n=4)

    class _Span:
        def __init__(self, tid, op_class, duration, error):
            self.context = type("C", (), {"trace_id": tid, "span_id": tid + 1})()
            self.tags = {"op_class": op_class}
            if error:
                self.tags["error"] = True
            self.duration = duration
            self.local_root = True
            self.name = "http.query"
            self.start_unix_ns = 0
            self.parent_id = None

    verdicts = []
    for k in range(60):
        tid = int(rng.integers(1, 2**63))
        op = ["read.count", "read.topn", "write", None][k % 4]
        dur = float(rng.choice([0.001, 0.2, 5.0]))
        err = bool(rng.random() < 0.2)
        verdicts.append((ts.baseline_kept(tid, 4), store._tail_reason(tid, op, dur, err)))
        store._complete(tid, _Span(tid, op, dur, err), [])
    return verdicts, store.snapshot()


def case_qprofile_tree(pkg, rng):
    qp = _mod(pkg, "obs.qprofile")
    tracing = _mod(pkg, "obs.tracing")
    prof = qp.QueryProfile("i", "Count(Row(f=1))", node_id="n")
    names = ["executor.Execute", "executor.executeCount", "executor.batchPairCount"]
    with qp.activate(prof):
        with tracing.start_span(names[0]).set_tag("index", "i"):
            for k in range(int(rng.integers(2, 5))):
                with tracing.start_span(names[1 + k % 2]):
                    qp.incr("gram_cache_hits", int(rng.integers(1, 3)))
                    qp.record_kernel(kernel="gram", lane="x", jit_cache="hit")
                    with qp.span("probe", call="Count"):
                        qp.incr("stack_rebuilds")
            qp.annotate("queue", 1.5, depth=3)
    prof.finish(0.01)
    d = prof.to_dict()
    d.pop("traceId", None)
    return _untimed(d)


def case_event_journal(pkg, rng):
    ev = _mod(pkg, "obs.events")
    j = ev.EventJournal(capacity=16, node_id="n1")
    for k in range(40):
        j.record([ev.EVENT_NODE_START, ev.EVENT_SNAPSHOT, ev.EVENT_NODE_STOP][k % 3],
                 k=k, v=int(rng.integers(0, 9)))
    out = [_untimed(j.since(s, lim)) for s, lim in [(0, None), (10, None), (30, 3), (39, None), (40, None)]]
    return out, j.snapshot_summary()


def case_job_tracker(pkg, rng):
    jobs = _mod(pkg, "obs.jobs")
    t = jobs.JobTracker(capacity=4)
    js = []
    for k in range(7):
        job = t.start(["import-drain", "resize"][k % 2], who=f"w{k}")
        job.set_phase("draining")
        job.advance(imports_done=int(rng.integers(1, 5)))
        job.set_progress(bits_done=int(rng.integers(0, 10)), bits_total=10)
        js.append(job)
    for k, job in enumerate(js[:5]):
        job.finish("done" if k % 2 else "error", error=None if k % 2 else "boom")
    return _untimed(t.snapshot()), _untimed(t.snapshot("resize"))


CASES = [case_deadline, case_classify_query, case_prometheus_text, case_traceparent,
         case_tracestore_keep, case_qprofile_tree, case_event_journal, case_job_tracker]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[5:] for c in CASES])
def test_module_gives_jax_output(case):
    jax_out, torch_out = (case(pkg, np.random.default_rng(5)) for pkg in PKGS)
    assert torch_out == jax_out


def test_ledger_reads_event_pairs_at_snapshot_time():
    """Device time waits for the snapshot: a launch books its count and
    wall time at once and its event pair's device ms when read."""
    from pilosa_tpu_torch.obs import devledger

    class _Event:
        def __init__(self, ms, done=True):
            self.ms, self.done, self.synced = ms, done, False

        def query(self):
            return self.done

        def synchronize(self):
            self.synced = True

        def elapsed_time(self, end):
            return end.ms - self.ms

    led = devledger.Ledger()
    site = led.site("kernels.gram")
    with devledger.tenant_scope("acme"), devledger.principal_scope("i", "read.count"):
        site.record_cuda_launch(_Event(0.0), _Event(2.5), wall_s=0.001)
        late = _Event(10.0, done=False)
        site.record_cuda_launch(_Event(9.0), late, wall_s=0.001)
    assert site.acc.launches == 2 and site.acc.device_ms == 0.0
    led.settle(wait=False)  # the query path's form: the unfinished pair waits
    assert site.acc.device_ms == 2.5 and not late.synced
    snap = led.snapshot()  # the snapshot reads every pair
    assert late.synced and snap["sites"]["kernels.gram"]["deviceMs"] == 3.5
    [row] = snap["principals"]
    assert (row["tenant"], row["index"], row["opClass"], row["launches"]) == (
        "acme", "i", "read.count", 2)
    assert row["deviceMs"] == 3.5 and row["compiles"] == 0


def test_reset_launches_zeroes_the_kernels_ledger_sites(monkeypatch):
    """``reset_launches`` zeroes ``LAUNCHES`` and the kernels' ledger sites
    together: the ``kernels`` block's launches and device ms then count the
    same launches (an unread pair from before the reset is dropped)."""
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
            return 1.5

    monkeypatch.setattr(tk.torch.cuda, "Event", _Event)
    monkeypatch.setattr(tk.torch.cuda, "current_stream", lambda device=None: None)
    saved = dict(tk.LAUNCHES)
    try:
        with tk._launching("gram", None):
            pass
        tk.reset_launches()
        assert tk.telemetry_snapshot()["gram"] == {"launches": 0, "deviceMs": 0.0}
        for _ in range(2):
            with tk._launching("gram", None):
                pass
        assert tk.telemetry_snapshot()["gram"] == {"launches": 2, "deviceMs": 3.0}
    finally:
        tk.LAUNCHES.update(saved)
