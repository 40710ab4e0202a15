"""Always-on flight recorder + incident engine (the third observability
plane's capture side). Counterpart of ``pilosa_tpu/obs/flightrec.py``.

Google-Wide-Profiling shape: a background thread continuously samples
every thread's stack at a low rate and rolls the collapse into ~1 s
*segments*, each also carrying the serving plane's congestion signals
(batcher depth peak, kernel launch deltas, device-ledger deltas, ingest
occupancy, deadline-504 delta, and the internal client's per-peer
circuit-breaker states, so a breaker's flap lines up with the latency
of its segment). The segment ring is small and bounded — the point is
not history, it is that when something goes wrong the *preceding*
seconds are already captured. No read of a segment waits for the card: the launch count is
the funnel's counter and the ledger's delta its non-waiting
:func:`devledger.counters`.

The incident engine watches two signals at segment cadence:

* SLO burn-rate alert edges — a (class, rule) alert transitioning
  false→true (SRE-Workbook multiwindow alerts from obs/slo.py).  While
  any alert stays firing, further edges join the same episode: one burn
  = one incident, however many rules it trips on the way down.
* deadline-504 spikes — ``http_deadline_exceeded`` jumping by more than
  a threshold within one segment (re-armed by a clean segment).

On trigger it freezes a bounded *bundle*: the last N segments, the
trace store's kept traces (the slow/erroring evidence), the slow-query
log, and the SLO verdicts — served at ``GET /debug/incidents`` and
journaled as an ``incident`` control-plane event.
"""

from __future__ import annotations

import threading
import time
import uuid

from pilosa_tpu_torch.obs import devledger, profile
from pilosa_tpu_torch.obs import events as ev
from pilosa_tpu_torch.ops import kernels

# stacks kept per segment: enough for attribution, bounded for the ring
_SEGMENT_TOP_STACKS = 20


class FlightRecorder:
    def __init__(
        self,
        holder,
        api=None,
        client=None,
        segment_seconds: float = 1.0,
        sample_interval: float = 0.025,
        segments: int = 60,
        incident_capacity: int = 8,
        incident_segments: int = 10,
        incident_traces: int = 16,
        spike_504: int = 5,
    ):
        self.holder = holder
        self.api = api
        # the internal client (cluster/client.py), whose breaker states
        # each segment carries
        self.client = client
        self.segment_seconds = max(0.05, float(segment_seconds))
        self.sample_interval = max(0.001, float(sample_interval))
        self.max_segments = max(1, int(segments))
        self.incident_capacity = max(1, int(incident_capacity))
        self.incident_segments = max(1, int(incident_segments))
        self.incident_traces = max(1, int(incident_traces))
        self.spike_504 = max(1, int(spike_504))
        # optional hook (obs/history.py): callable(trigger) -> dict of
        # series windows frozen into the bundle, so an incident carries
        # its own recent history instead of just the moment of the edge
        self.series_provider = None
        # optional hook (obs/blackbox.py): callable(bundle) invoked
        # after a bundle freezes, so the black box can flush it to disk
        # synchronously — an incident is when the process is likeliest
        # to die next
        self.on_incident = None
        self._lock = threading.Lock()
        self._segments: list[dict] = []
        self._incidents: list[dict] = []
        self._seq = 0
        # incident-engine state (loop thread only)
        self._firing: set[tuple[str, str]] = set()
        self._last_504 = None  # counter baseline; None until first segment
        self._spike_armed = True
        self._last_dispatch = None
        self._last_devcosts = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # the recorder's own cost: stack samples taken, and the seconds
        # its thread spent in them and in closing segments
        self.ticks = 0
        self.busy_seconds = 0.0

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        # Baseline the 504 counter NOW: a spike inside the first segment
        # window must not be swallowed as the baseline.
        stats = self.holder.stats
        if self._last_504 is None and hasattr(stats, "get_counter"):
            self._last_504 = stats.get_counter("http_deadline_exceeded")
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="flight-recorder", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        t = self._thread
        if t is None:
            return
        self._stop.set()
        t.join(timeout=5.0)
        self._thread = None

    # -- recorder loop -------------------------------------------------------

    def _loop(self) -> None:
        sampler = profile.Sampler(exclude_ident=threading.get_ident())
        while not self._stop.is_set():
            seg_start = time.monotonic()
            seg_end = seg_start + self.segment_seconds
            while not self._stop.is_set():
                t = time.perf_counter()
                sampler.tick()
                self.ticks += 1
                self.busy_seconds += time.perf_counter() - t
                rem = seg_end - time.monotonic()
                if rem <= 0:
                    break
                self._stop.wait(min(self.sample_interval, rem))
            t = time.perf_counter()
            try:
                seg = self._segment(sampler, time.monotonic() - seg_start)
                self._record_segment(seg)
                self._check_incidents(seg)
            except Exception:  # the recorder must outlive any one bad snapshot source
                sampler.drain()  # never let a failed segment accumulate
            self.busy_seconds += time.perf_counter() - t

    def _segment(self, sampler, elapsed: float) -> dict:
        self._seq += 1
        seg = {
            "seq": self._seq,
            "at": time.time(),
            "seconds": round(elapsed, 3),
            "profile": sampler.drain(top=_SEGMENT_TOP_STACKS),
        }
        api = self.api
        batcher = getattr(api, "batcher", None) if api is not None else None
        if batcher is not None:
            snap = batcher.snapshot()
            snap["depthPeak"] = batcher.take_depth_peak()
            seg["batcher"] = snap
        ingest = getattr(api, "ingest", None) if api is not None else None
        if ingest is not None:
            seg["ingest"] = ingest.snapshot()
        # every launch the funnel counted (ops/kernels.py LAUNCHES, read
        # under its lock); a reset of the counts restarts the baseline
        total = kernels.launch_total()
        last = self._last_dispatch
        if last is None:
            last = total
        elif total < last:
            last = 0
        seg["kernelDispatchDelta"] = total - last
        self._last_dispatch = total
        try:
            # the ledger's non-waiting read: finished event pairs only
            dev = devledger.counters()
            cur = {
                "compiles": dev["compiles"],
                "launches": dev["launches"],
                "transferBytes": dev["h2dBytes"] + dev["d2hBytes"],
            }
            last = self._last_devcosts or cur
            seg["devledgerDelta"] = {
                k: cur[k] - last[k] for k in cur
            }
            self._last_devcosts = cur
        except Exception:  # graftlint: disable=exception-hygiene -- ledger deltas are advisory segment context
            pass
        client = self.client
        if client is not None and hasattr(client, "breaker_states"):
            breakers = client.breaker_states()
            if breakers:
                seg["breakers"] = breakers
        stats = self.holder.stats
        if hasattr(stats, "get_counter"):
            total_504 = stats.get_counter("http_deadline_exceeded")
            if self._last_504 is None:
                self._last_504 = total_504
            seg["deadline504Delta"] = total_504 - self._last_504
            self._last_504 = total_504
        return seg

    def _record_segment(self, seg: dict) -> None:
        with self._lock:
            self._segments.append(seg)
            if len(self._segments) > self.max_segments:
                del self._segments[: len(self._segments) - self.max_segments]

    # -- incident engine -----------------------------------------------------

    def _check_incidents(self, seg: dict) -> None:
        firing_now: set[tuple[str, str]] = set()
        try:
            snap = self.holder.slo.snapshot()
            for cname, c in snap["classes"].items():
                for rule, firing in c.get("alerts", {}).items():
                    if firing:
                        firing_now.add((cname, rule))
        except Exception:  # a broken snapshot must not kill the recorder
            snap = None
        new_edges = firing_now - self._firing
        was_quiet = not self._firing
        self._firing = firing_now
        if new_edges and was_quiet:
            # one burn episode = one incident: further rules tripping
            # while any alert is still firing join this episode
            cname, rule = sorted(new_edges)[0]
            self._capture(
                {"type": "slo-alert", "class": cname, "rule": rule,
                 "edges": sorted(f"{c}/{r}" for c, r in new_edges)},
                slo_snap=snap,
            )
            return
        delta = seg.get("deadline504Delta", 0)
        if delta >= self.spike_504 and self._spike_armed and was_quiet:
            self._spike_armed = False
            self._capture(
                {"type": "deadline-504-spike", "count": delta}, slo_snap=snap
            )
        elif delta == 0:
            self._spike_armed = True

    def _capture(self, trigger: dict, slo_snap=None) -> None:
        incident_id = uuid.uuid4().hex[:12]
        traces = getattr(self.holder, "traces", None)
        kept = []
        if traces is not None:
            kept = traces.summaries(self.incident_traces)
        slow = None
        if self.api is not None:
            slow = self.api.slow_queries.snapshot()
        with self._lock:
            segments = list(self._segments[-self.incident_segments:])
        bundle = {
            "id": incident_id,
            "at": time.time(),
            "node": getattr(traces, "node_id", ""),
            "trigger": trigger,
            "segments": segments,
            "traces": kept,
            "slowQueries": slow,
        }
        prov = self.series_provider
        if prov is not None:
            try:
                series = prov(trigger)
                if series:
                    bundle["series"] = series
            except Exception:  # graftlint: disable=exception-hygiene -- history attachment is best-effort
                pass
        if slo_snap is not None:
            bundle["slo"] = {
                name: {
                    "alerts": c["alerts"],
                    "total": c["total"],
                    "errors": c["errors"],
                    "p99Ms": c["latency"]["p99Ms"],
                }
                for name, c in slo_snap["classes"].items()
            }
        with self._lock:
            self._incidents.append(bundle)
            if len(self._incidents) > self.incident_capacity:
                del self._incidents[: len(self._incidents)
                                    - self.incident_capacity]
        try:
            # the trigger's "type" key would collide with record()'s
            # event-type parameter; journal it as "trigger"
            self.holder.events.record(
                ev.EVENT_INCIDENT,
                id=incident_id,
                trigger=trigger["type"],
                **{k: v for k, v in trigger.items() if k != "type"},
            )
        except Exception:  # graftlint: disable=exception-hygiene -- journaling is best-effort
            pass
        hook = self.on_incident
        if hook is not None:
            try:
                hook(bundle)
            except Exception:  # graftlint: disable=exception-hygiene -- durable-flush wiring must not fail the capture
                pass

    def capture_incident(self, trigger: dict) -> None:
        """External incident trigger (the device ledger's recompile-storm
        callback): freeze a bundle around the current segments.  Safe to
        call from any thread; failures must not reach the caller.  A
        stopped recorder ignores triggers — the process-global ledger
        outlives individual nodes in multi-node test processes."""
        t = self._thread
        if t is None or not t.is_alive():
            return
        try:
            self._capture(dict(trigger))
        except Exception:  # graftlint: disable=exception-hygiene -- external triggers are best-effort
            pass

    # -- exposition ----------------------------------------------------------

    def incidents_snapshot(self) -> dict:
        with self._lock:
            incidents = [
                {k: v for k, v in b.items()
                 if k not in ("segments", "traces", "slowQueries", "series")}
                for b in reversed(self._incidents)
            ]
            return {
                "enabled": True,
                "segmentSeconds": self.segment_seconds,
                "segments": len(self._segments),
                "incidents": incidents,
            }

    def incident_detail(self, incident_id: str) -> dict | None:
        with self._lock:
            for b in self._incidents:
                if b["id"] == incident_id:
                    return dict(b)
        return None

    def segments_snapshot(self, limit: int = 10) -> list[dict]:
        with self._lock:
            return list(self._segments[-limit:])

    def incidents_full(self) -> list[dict]:
        """Every retained bundle WITH bodies, oldest first — the black
        box checkpoints these verbatim so a postmortem carries the same
        evidence ``/debug/incidents?id=`` would have served live."""
        with self._lock:
            return [dict(b) for b in self._incidents]
