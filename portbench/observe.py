"""What the traced run (``--trace 1``) reads over the window, and the
:class:`Window` the per-layer readers (``metrics/<name>.py``) take.

Observed from the benchmark's side, around the calls into each layer:

* spans: the program's own (``http.<route>``, ``executor.*``), kept by a
  ``RecordingTracer`` that also notes each span's thread;
* the batcher's flights: each dispatch's size and its members' queue
  waits, read from the flight slots after the dispatch;
* counters: ``ops/kernels.LAUNCHES``, ``batcher.snapshot()`` and the
  executor's ``stack_rebuilds``, ``gram_cache_hits`` and
  ``crossgram_cache_hits``, as deltas over the window;
* each measured kernel's launches, with the least bytes of their
  operands (``roofline.py``), from the wrappers' arguments;
* the device: ``torch.profiler``'s device events over the window, in
  SEGMENTS traces one after another (the gaps between them, while one
  trace stops and the next starts, are not traced).
"""

from __future__ import annotations

import bisect
import re
import statistics
import threading
import time
from dataclasses import dataclass, field

from portbench import roofline

# device event names of each measured kernel (the program's CUDA sources)
KERNEL_EVENTS = {
    "cross_gram": re.compile(r"pilosa_gram_tiles<[^>]*false>"),
    "tree_count": re.compile(r"pilosa_tree_count_staged|pilosa_tree_rows|pilosa_tree_l2\w*<[^>]*false>"),
    "bsi_sum_batch": re.compile(r"pilosa_bsi_sum_batch_kernel"),
    "bsi_range": re.compile(r"pilosa_bsi_range_kernel"),
}
# device events that move or fill memory rather than run a kernel
COPY_EVENT = re.compile(r"^Mem(cpy|set)\b")
COUNTERS = ("stack_rebuilds", "gram_cache_hits", "crossgram_cache_hits")
# profiler traces a window is cut into, one after another
SEGMENTS = 5
# the markers opening and closing each trace: spins of about 0.5 and 50 us
MARK_START_CYCLES, MARK_END_CYCLES, MARK_SPLIT_S = 1_000, 100_000, 10e-6


@dataclass
class Window:
    """One window's readings; times in seconds on the host's monotonic
    clock."""

    t0: float
    t1: float
    requests: list = field(default_factory=list)
    spans: list = field(default_factory=list)
    flights: list = field(default_factory=list)
    counters: dict = field(default_factory=dict)
    launches: dict = field(default_factory=dict)
    kernels: dict = field(default_factory=dict)
    busy_s: float | None = None
    kernel_busy_s: float | None = None
    traced_s: float | None = None

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    @property
    def answered(self) -> int:
        """Requests answered within the window."""
        return sum(1 for r in self.requests if r[5] == 200 and r[4] <= self.t1)

    def requests_holding(self, text: str) -> int:
        return sum(1 for r in self.requests if r[4] is not None and r[4] <= self.t1
                   and text in r[2])

    def durations(self, *names: str) -> list[float]:
        return [s.duration for s in self.spans if s.name in names]

    def outermost_seconds(self, *names: str) -> float:
        """Seconds of the spans named, leaving out one inside another of
        them."""
        by_id = {s.context.span_id: s for s in self.spans}
        total = 0.0
        for s in self.spans:
            if s.name not in names:
                continue
            p = by_id.get(s.parent_id)
            while p is not None and p.name not in names:
                p = by_id.get(p.parent_id)
            if p is None:
                total += s.duration
        return total

    def roofline(self, kernel: str) -> float | None:
        """Percent: the least time of the kernel's launches over its device
        time, in each trace segment that launched it; the median over
        those segments (now and then one trace of the card reads every
        kernel at half its time). Where a segment's trace kept fewer
        events than there were launches, its device time is the events'
        mean times the launches. None where nothing was launched or
        traced."""
        shares = []
        for least, n, events in self.kernels.get(kernel, []):
            if least and n and events:
                device = sum(events) if len(events) >= n else statistics.fmean(events) * n
                shares.append(100.0 * least / device)
        return statistics.median(shares) if shares else None


def device_events(prof, cpu) -> list[tuple[str, float, float]]:
    """``(name, start s, duration s)`` of the trace's device events, read
    from the profiler's raw results (building its event tree takes
    seconds a second of window); its ``events()`` where the raw results
    have no such fields."""
    try:
        return [(e.name(), e.start_ns() / 1e9, e.duration_ns() / 1e9)
                for e in prof.profiler.kineto_results.events() if e.device_type() != cpu]
    except AttributeError:
        return [(e.name, e.time_range.start / 1e6, e.time_range.elapsed_us() / 1e6)
                for e in prof.events() if e.device_type != cpu]


def marker(cycles: int) -> float:
    """A spin kernel of ``cycles`` on the device, launched at the host
    time returned, with the device idle before and after it: the trace's
    copy of it aligns the trace's clock to the host's."""
    import torch

    torch.cuda.synchronize()
    mark = time.monotonic()
    torch.cuda._sleep(cycles)
    torch.cuda.synchronize()
    return mark


def align(segments: list[dict]) -> None:
    """Each segment's ``device`` events on the host's monotonic clock,
    from its ``raw`` trace. A segment is aligned by its opening marker, or
    where its trace lost that one by its closing marker (the two told
    apart by their lengths); a segment whose trace kept neither takes the
    offset of the nearest segment that kept one, as every trace of one
    process reads one clock. Raises where no segment kept a marker."""
    offsets = []
    for seg in segments:
        offset = None
        for name, t, d in seg["raw"]:
            if "spin" in name or "sleep" in name.lower():
                if d < MARK_SPLIT_S:
                    offset = seg["mark"] - t
                    break
                offset = seg["end_mark"] - t
        offsets.append(offset)
    known = [i for i, o in enumerate(offsets) if o is not None]
    if not known:
        raise RuntimeError("no marker kernel in any trace: cannot align them")
    for i, seg in enumerate(segments):
        offset = offsets[min(known, key=lambda k: abs(k - i))]
        seg["device"] = [(name, t + offset, d) for name, t, d in seg.pop("raw") if d > 0]


def thread_tracer(tracing, capacity: int):
    """A ``RecordingTracer`` of ``capacity`` spans whose spans note the
    thread that opened them."""

    class ThreadTracer(tracing.RecordingTracer):
        def start_span(self, name, child_of=None):
            span = super().start_span(name, child_of)
            span.thread = threading.get_ident()
            return span

    return ThreadTracer(capacity)


class Observer:
    """Hooks on a started node for one window: :meth:`open` before the
    window, :meth:`stop` at its end, :meth:`window` for the readings,
    :meth:`restore` to take the hooks off."""

    def __init__(self, node):
        from pilosa_tpu_torch.obs import tracing
        from pilosa_tpu_torch.ops import bsi, kernels

        self.node = node
        self.tracing, self.kernels, self.bsi = tracing, kernels, bsi
        self.active = False
        self.segment: dict | None = None
        self.segments: list[dict] = []
        self.flights: list = []
        self._lock = threading.Lock()
        self.tracer = thread_tracer(tracing, 4_000_000)
        self._patch()

    # -- kernel operands ------------------------------------------------

    def _record(self, kernel: str, before: int, nbytes) -> None:
        n = self.kernels.LAUNCHES[kernel] - before
        seg = self.segment
        if seg is not None and n > 0:
            least = roofline.least_seconds(nbytes())
            with self._lock:
                seg["least"][kernel] = seg["least"].get(kernel, 0.0) + least
                seg["launches"][kernel] = seg["launches"].get(kernel, 0) + n

    def _patch(self) -> None:
        import numpy as np

        k, b, L = self.kernels, self.bsi, self.kernels.LAUNCHES
        orig = {"cross_gram_gather": k.cross_gram_gather, "tree_count": k.tree_count,
                "bsi_sum_batch": b.bsi_sum_batch, "bsi_range": b.bsi_range}
        self._orig = orig

        def cross_gram_gather(bits_a, bits_b, ia, ib):
            before = L["cross_gram"]
            out = orig["cross_gram_gather"](bits_a, bits_b, ia, ib)

            def nbytes():
                S, _, W = bits_a.shape
                a, c = set(np.asarray(ia).ravel().tolist()), set(np.asarray(ib).ravel().tolist())
                shared = (bits_a.data_ptr() == bits_b.data_ptr()
                          and bits_a.stride() == bits_b.stride())
                rows = len(a | c) if shared else len(a) + len(c)
                ua, ub = len(a), len(c)
                return roofline.cross_gram_bytes(S, W, ua, ub) - (ua + ub - rows) * S * W * 4
            self._record("cross_gram", before, nbytes)
            return out

        def tree_count(stacks, code, leaf_stack, slots):
            before = L["tree_count"]
            out = orig["tree_count"](stacks, code, leaf_stack, slots)

            def nbytes():
                st = tuple(stacks)
                S, _, W = st[0].shape
                sl = np.asarray(slots)
                rows = roofline.tree_distinct_rows([t.data_ptr() for t in st],
                                                   np.asarray(leaf_stack).reshape(-1), sl)
                return roofline.tree_count_bytes(S, W, rows, sl.shape[0])
            self._record("tree_count", before, nbytes)
            return out

        def bsi_sum_batch(planes, exists, sign, filt_bits, filt_idx):
            before = L["bsi_sum_batch"]
            out = orig["bsi_sum_batch"](planes, exists, sign, filt_bits, filt_idx)

            def nbytes():
                S, depth, W = planes.shape
                idx = np.asarray(filt_idx).ravel()
                return roofline.bsi_sum_batch_bytes(S, depth, W, len(set(idx[idx >= 0].tolist())),
                                                    idx.size)
            self._record("bsi_sum_batch", before, nbytes)
            return out

        def bsi_range(planes, exists, sign, table, *, count):
            before = L["bsi_range"]
            out = orig["bsi_range"](planes, exists, sign, table, count=count)

            def nbytes():
                S, depth, W = planes.shape if planes.dim() == 3 else (1,) + tuple(planes.shape)
                t = np.asarray(table)
                return roofline.bsi_range_bytes(S, depth, W, t.nbytes, t.shape[0], count)
            self._record("bsi_range", before, nbytes)
            return out

        k.cross_gram_gather, k.tree_count = cross_gram_gather, tree_count
        b.bsi_sum_batch, b.bsi_range = bsi_sum_batch, bsi_range

    # -- the window -----------------------------------------------------

    def _counters(self) -> dict:
        ex = self.node.api.executor
        out = {c: getattr(ex, c) for c in COUNTERS}
        out.update({f"batcher.{k}": v for k, v in self.node.api.batcher.snapshot().items()
                    if isinstance(v, (int, float))})
        return out

    def _start_segment(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
        self.segment = {"prof": prof, "mark": marker(MARK_START_CYCLES), "t0": time.monotonic(),
                        "least": {}, "launches": {}}

    def _end_segment(self) -> None:
        import torch
        from torch.autograd import DeviceType

        torch.cuda.synchronize()
        seg, self.segment = self.segment, None
        seg["t1"] = time.monotonic()
        seg["end_mark"] = marker(MARK_END_CYCLES)
        prof = seg.pop("prof")
        prof.stop()
        seg["raw"] = device_events(prof, DeviceType.CPU)
        self.segments.append(seg)

    def open(self) -> None:
        batcher = self.node.api.batcher
        dispatch = batcher._dispatch

        def observed(batch, reason):
            dispatch(batch, reason)
            if self.active:
                with self._lock:
                    self.flights.append((len(batch), [f.queue_wait for f in batch]))

        batcher._dispatch = observed
        self.dispatcher = batcher._thread.ident
        self.tracing.set_tracer(self.tracer)
        self.launches0 = dict(self.kernels.LAUNCHES)
        self.counters0 = self._counters()
        self.active = True
        self._start_segment()

    def stop(self, t_go: float, seconds: float) -> dict:
        """Trace the window from ``t_go`` in SEGMENTS traces of the
        profiler, one after another, then stop observing: the readings,
        device events on the host's monotonic clock."""
        for i in range(1, SEGMENTS + 1):
            delay = t_go + seconds * i / SEGMENTS + (0.1 if i == SEGMENTS else 0) - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            self._end_segment()
            if i < SEGMENTS:
                self._start_segment()
        self.active = False
        self.tracing.set_tracer(self.tracing.NopTracer())
        align(self.segments)
        counters1 = self._counters()
        return {
            "counters": {k: counters1[k] - self.counters0[k] for k in counters1},
            "launches": {k: v - self.launches0[k] for k, v in self.kernels.LAUNCHES.items()},
            "segments": self.segments,
        }

    def window(self, raw: dict, t0: float, t1: float) -> tuple[Window, dict]:
        """The :class:`Window` of ``[t0, t1]`` (its requests added by the
        caller) and the ``breakdown``."""
        w = Window(t0=t0, t1=t1, counters=raw["counters"], launches=raw["launches"])
        w.flights = list(self.flights)
        w.spans = [s for s in self.tracer.finished() if t0 <= s.start < t1]
        w.busy_s = w.kernel_busy_s = w.traced_s = 0.0
        covered, by_name = [], {}
        for seg in raw["segments"]:
            a, b = max(seg["t0"], t0), min(seg["t1"], t1)
            if b <= a:
                continue
            ivals, kernel_ivals, events = [], [], {}
            for name, s, d in seg["device"]:
                if a <= s < b:
                    ivals.append((s, s + d))
                    if not COPY_EVENT.match(name):
                        kernel_ivals.append((s, s + d))
                    by_name[name] = by_name.get(name, 0.0) + d
                    for k, rx in KERNEL_EVENTS.items():
                        if rx.search(name):
                            events.setdefault(k, []).append(d)
            for k in set(seg["launches"]) | set(events):
                w.kernels.setdefault(k, []).append(
                    (seg["least"].get(k, 0.0), seg["launches"].get(k, 0), events.get(k, [])))
            w.busy_s += roofline.busy_union(ivals, a, b)
            w.kernel_busy_s += roofline.busy_union(kernel_ivals, a, b)
            w.traced_s += b - a
            covered.append((a, b, ivals))
        return w, self._breakdown(w, covered, by_name)

    def _breakdown(self, w: Window, covered, by_name) -> dict:
        def short(name):
            if COPY_EVENT.match(name):
                return name[:160]
            name = re.sub(r"^void\s+|\(anonymous namespace\)::", "", name)
            return name.split("(")[0].strip()[:160]

        ops = sorted(((short(n), s) for n, s in by_name.items()), key=lambda x: -x[1])[:10]
        mine = sorted((s for s in w.spans if getattr(s, "thread", None) == self.dispatcher),
                      key=lambda s: s.start)
        starts = [s.start for s in mine]
        idle: dict = {}
        gaps = [g for a, b, ivals in covered for g in roofline.idle_gaps(ivals, a, b)]
        for a, b in gaps:
            mid, label = (a + b) / 2, "dispatcher between flights"
            i = bisect.bisect_right(starts, mid) - 1
            for s in mine[max(0, i - 200): i + 1][::-1]:
                if s.start + s.duration >= mid:
                    label = s.name
                    break
            idle[label] = idle.get(label, 0.0) + (b - a)
        gaps = sorted(idle.items(), key=lambda x: -x[1])[:10]
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}

    def restore(self) -> None:
        k, b = self.kernels, self.bsi
        k.cross_gram_gather, k.tree_count = self._orig["cross_gram_gather"], self._orig["tree_count"]
        b.bsi_sum_batch, b.bsi_range = self._orig["bsi_sum_batch"], self._orig["bsi_range"]
