"""The traced run's arithmetic on made-up readings: segments of the
trace clipped to the window, each kernel's roofline the median over the
segments, the idle gaps labelled by the dispatcher's open span."""

import types

import pytest

from portbench import observe


def span(name, start, dur, thread=1, sid=0, parent=0):
    s = types.SimpleNamespace(name=name, start=start, duration=dur, thread=thread,
                              parent_id=parent, context=types.SimpleNamespace(span_id=sid))
    return s


def observer(spans):
    o = object.__new__(observe.Observer)
    o.flights = [(2, [0.01, 0.03])]
    o.tracer = types.SimpleNamespace(finished=lambda: spans)
    o.dispatcher = 1
    return o


def test_window_segments_and_breakdown():
    gram = "void pilosa_gram_tiles<128, 64, false>(PilosaGramOperand, int)"
    segs = [
        # least 1 ms in two launches, traced at 2 ms: 50 %
        {"t0": 0.0, "t1": 1.0, "least": {"cross_gram": 1e-3}, "launches": {"cross_gram": 2},
         "device": [(gram, 0.2, 1e-3), (gram, 0.5, 1e-3)]},
        # the same work traced at half its time: 100 %
        {"t0": 1.1, "t1": 2.1, "least": {"cross_gram": 1e-3}, "launches": {"cross_gram": 2},
         "device": [(gram, 1.2, 0.5e-3), (gram, 1.5, 0.5e-3)]},
        {"t0": 2.2, "t1": 3.5, "least": {"cross_gram": 1e-3}, "launches": {"cross_gram": 2},
         "device": [(gram, 2.3, 1e-3), (gram, 2.6, 1e-3), ("Memcpy DtoH", 3.4, 0.2)]},
    ]
    spans = [span("executor.ExecuteBatch", 0.0, 3.0, sid=1),
             span("executor.groupByKLevel", 0.1, 0.8, sid=2, parent=1),
             span("http.query", 0.0, 3.0, thread=2, sid=3)]
    raw = {"counters": {"stack_rebuilds": 0}, "launches": {"cross_gram": 6}, "segments": segs}
    w, bd = observer(spans).window(raw, 0.0, 3.0)
    assert w.roofline("cross_gram") == pytest.approx(50.0)
    assert w.traced_s == pytest.approx(1.0 + 1.0 + 0.8)
    assert w.busy_s == pytest.approx(2e-3 + 1e-3 + 2e-3)
    assert bd["device_ops"][0][0] == "pilosa_gram_tiles<128, 64, false>"
    labels = dict(bd["idle_gaps"])
    assert set(labels) == {"executor.groupByKLevel", "executor.ExecuteBatch"}
    assert w.outermost_seconds("executor.ExecuteBatch", "executor.groupByKLevel") == 3.0


def test_thread_tracer_notes_threads():
    import threading

    from pilosa_tpu_torch.obs import tracing

    t = observe.thread_tracer(tracing, 16)
    with t.start_span("outer"):
        with t.start_span("inner"):
            pass
    other = threading.Thread(target=lambda: t.start_span("there").finish())
    other.start()
    other.join(timeout=10)
    spans = {s.name: s for s in t.finished()}
    assert spans["inner"].parent_id == spans["outer"].context.span_id
    assert spans["outer"].thread == threading.get_ident() != spans["there"].thread


def test_idle_share_counts_kernels_only():
    from portbench.spec import Benchmark
    from portbench.run import ROOT

    tree = "void pilosa_tree_rows<4>(int)"
    segs = [{"t0": 0.0, "t1": 1.0, "least": {}, "launches": {},
             "device": [(tree, 0.1, 0.1), ("Memcpy DtoH (Device -> Pageable)", 0.3, 0.4),
                        ("Memset (Device)", 0.8, 0.1)]}]
    raw = {"counters": {}, "launches": {}, "segments": segs}
    w, bd = observer([]).window(raw, 0.0, 1.0)
    assert w.busy_s == pytest.approx(0.6)
    assert w.kernel_busy_s == pytest.approx(0.1)
    idle = Benchmark(ROOT).reader("device.idle_share")(w)
    assert idle == pytest.approx(90.0)
    assert dict(bd["device_ops"])["Memcpy DtoH (Device -> Pageable)"] == pytest.approx(0.4)


def test_align_uses_either_marker_or_the_nearest_segment():
    spin, k = "spin_kernel", "void pilosa_tree_rows<4>(int)"
    segs = [
        # the opening marker kept: trace clock + 100 s is the host's
        {"mark": 110.0, "end_mark": 120.0, "raw": [(spin, 10.0, 1e-6), (k, 12.0, 1e-3)]},
        # only the closing marker kept: + 200 s
        {"mark": 0.0, "end_mark": 230.0, "raw": [(k, 25.0, 1e-3), (spin, 30.0, 50e-6)]},
        # none kept: the nearest segment's offset
        {"mark": 0.0, "end_mark": 0.0, "raw": [(k, 40.0, 1e-3), ("Memset (Device)", 41.0, 0.0)]},
    ]
    observe.align(segs)
    assert segs[0]["device"][1] == (k, 112.0, 1e-3)
    assert segs[1]["device"][0] == (k, 225.0, 1e-3)
    assert segs[2]["device"] == [(k, 240.0, 1e-3)]
    with pytest.raises(RuntimeError):
        observe.align([{"mark": 0.0, "end_mark": 0.0, "raw": [(k, 1.0, 1e-3)]}])
