"""In-process retrospective metrics plane: a bounded ring-buffer TSDB
per holder plus EWMA trend detectors that promote sustained anomalies
into flight-recorder incidents. Counterpart of
``pilosa_tpu/obs/history.py``; every plane it samples is read without
waiting for the card (the device ledger through its non-waiting
:func:`devledger.counters`).

Every other observability surface (/metrics, /debug/slo, /debug/qos,
/debug/devcosts, /debug/vars) is a point-in-time snapshot; without an
external Prometheus nothing can answer "what did p99 / batcher depth /
device-ms look like over the last ten minutes".  Monarch's answer —
in-memory time-series storage colocated with the serving process — is
the right shape at this scale: a background sampler (flight-recorder
style thread, ~1 s cadence) snapshots a curated set of series from the
existing planes into fixed-size numpy rings, with coarser retention
tiers produced by decimation (e.g. 5 m @ 1 s plus 1 h @ 15 s), so the
recent past is always queryable at ``GET /debug/history`` for the cost
of a few hundred KB per node.

Sample sequence numbers are monotonic and expressed in BASE-tier units
across every tier (a decimated tier's sample ``k`` covers base seqs
``[k*d, (k+1)*d)``), which gives ``?since=`` cursors the same
gap-honest contract as the event journal: a cursor that predates the
oldest retained sample comes back ``truncated`` instead of silently
skipping.

On top of the rings sits a trend-detector engine — EWMA-baseline
latency-regression, throughput-collapse, and error-acceleration — that
fires through the flight recorder's external-trigger path as ``trend``
incidents.  One trend episode = one incident (further series tripping
while any detector is latched join the episode), and the incident
bundle attaches the relevant series windows so the incident carries
its own history instead of just the moment of the edge.  Throughput
collapse deliberately treats rps == 0 as *no data*, not a collapse:
idle is indistinguishable from no offered load, and stage boundaries
in the load harness must not fire incidents.
"""

from __future__ import annotations

import fnmatch
import threading
import time

import numpy as np

from pilosa_tpu_torch.core import residency
from pilosa_tpu_torch.obs import devledger

# bounded exposition: recent trend triggers kept for /debug/history
_MAX_FIRED = 32

DETECTOR_LATENCY = "latency"
DETECTOR_THROUGHPUT = "throughput"
DETECTOR_ERRORS = "errors"
ALL_DETECTORS = (DETECTOR_LATENCY, DETECTOR_THROUGHPUT, DETECTOR_ERRORS)

# detector -> (series suffix it watches, human trigger name)
_DETECTOR_SUFFIX = {
    DETECTOR_LATENCY: (".p99_ms", "latency-regression"),
    DETECTOR_THROUGHPUT: (".rps", "throughput-collapse"),
    DETECTOR_ERRORS: (".eps", "error-acceleration"),
}


def parse_tiers(spec) -> list[tuple[int, int]]:
    """``"300@1,240@15"`` -> ``[(capacity, decimate), ...]`` sorted by
    decimation factor.  The finest tier must be undecimated (d == 1)
    and must retain at least one full decimation window for every
    coarser tier (coarse samples are folded from the base ring)."""
    if isinstance(spec, str):
        tiers = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            cap, _, dec = part.partition("@")
            tiers.append((int(cap), int(dec or 1)))
    else:
        tiers = [(int(c), int(d)) for c, d in spec]
    if not tiers:
        raise ValueError("history tiers: at least one tier required")
    tiers.sort(key=lambda t: t[1])
    if tiers[0][1] != 1:
        raise ValueError("history tiers: finest tier must have decimate=1")
    if any(c < 1 or d < 1 for c, d in tiers):
        raise ValueError(f"history tiers: bad spec {tiers!r}")
    if tiers[-1][1] > tiers[0][0]:
        raise ValueError(
            "history tiers: base capacity smaller than coarsest decimation"
        )
    return tiers


class _Tier:
    """One retention tier: a shared wall-clock ring plus one fixed-size
    value ring per series (NaN marks slots where a series had no
    sample).  ``count`` is the number of samples ever written."""

    def __init__(self, capacity: int, decimate: int):
        self.capacity = int(capacity)
        self.decimate = int(decimate)
        self.count = 0
        self.times = np.zeros(self.capacity, dtype=np.float64)
        self.values: dict[str, np.ndarray] = {}

    def append(self, wall: float, sample: dict) -> None:
        slot = self.count % self.capacity
        self.times[slot] = wall
        for name, arr in self.values.items():
            arr[slot] = sample.get(name, np.nan)
        for name, v in sample.items():
            if name not in self.values:
                arr = np.full(self.capacity, np.nan)
                arr[slot] = v
                self.values[name] = arr
        self.count += 1

    def window(self, start_idx: int):
        """(times, {name: values}) for tier samples [start_idx, count)."""
        idxs = np.arange(start_idx, self.count)
        slots = idxs % self.capacity
        return self.times[slots], {
            name: arr[slots] for name, arr in self.values.items()
        }


class _DetState:
    __slots__ = ("mean", "n", "bad", "good", "latched")

    def __init__(self):
        self.mean = None
        self.n = 0
        self.bad = 0
        self.good = 0
        self.latched = False


def _nanmean(win: np.ndarray) -> float:
    mask = ~np.isnan(win)
    if not mask.any():
        return float("nan")
    return float(win[mask].mean())


def downsample(points: list, step: float) -> list:
    """Mean-downsample ``[[t, v], ...]`` onto the wall-clock grid
    ``floor(t/step)*step`` (None values are gaps and are skipped; an
    all-gap bucket yields None).  The shared grid is what makes a
    cluster merge wall-clock ALIGNED: every node's points land in the
    same buckets regardless of sampler phase."""
    step = float(step)
    if step <= 0 or not points:
        return list(points)
    buckets: dict[float, list] = {}
    order: list[float] = []
    for t, v in points:
        b = float(np.floor(t / step) * step)
        if b not in buckets:
            buckets[b] = []
            order.append(b)
        if v is not None:
            buckets[b].append(v)
    out = []
    for b in sorted(order):
        vals = buckets[b]
        out.append([round(b, 3),
                    float(np.mean(vals)) if vals else None])
    return out


class MetricsHistory:
    """Bounded per-node metrics history + trend incident engine.

    The sampler thread calls :meth:`sample_once` (collect -> record);
    tests drive :meth:`record` directly with synthetic samples and
    explicit wall clocks, so ring/decimation/detector behaviour is
    deterministic without threads."""

    def __init__(
        self,
        holder,
        api=None,
        node_id: str = "",
        cadence: float = 1.0,
        tiers="300@1,240@15",
        detectors: str = "latency,throughput,errors",
        ewma_alpha: float = 0.1,
        warmup: int = 10,
        trips: int = 3,
        latency_factor: float = 2.0,
        latency_min_ms: float = 20.0,
        collapse_frac: float = 0.3,
        collapse_min_rps: float = 5.0,
        error_factor: float = 3.0,
        error_min_eps: float = 1.0,
    ):
        self.holder = holder
        self.api = api
        self.node_id = node_id or getattr(
            getattr(holder, "slo", None), "node_id", ""
        )
        self.cadence = max(0.01, float(cadence))
        specs = parse_tiers(tiers)
        self.tiers = [_Tier(c, d) for c, d in specs]
        if isinstance(detectors, str):
            detectors = [d.strip() for d in detectors.split(",") if d.strip()]
        self.detectors = frozenset(detectors) & set(ALL_DETECTORS)
        self.ewma_alpha = float(ewma_alpha)
        self.warmup = max(1, int(warmup))
        self.trips = max(1, int(trips))
        self.latency_factor = float(latency_factor)
        self.latency_min_ms = float(latency_min_ms)
        self.collapse_frac = float(collapse_frac)
        self.collapse_min_rps = float(collapse_min_rps)
        self.error_factor = float(error_factor)
        self.error_min_eps = float(error_min_eps)
        self.flightrec = None  # wired by NodeServer after both exist
        self._lock = threading.Lock()
        self._prev: dict[str, tuple[float, float]] = {}  # rate bookkeeping
        self._det: dict[tuple[str, str], _DetState] = {}
        self._episode_active = False
        self._fired: list[dict] = []
        self._samples_taken = 0
        self._sample_seconds = 0.0  # sampler self-cost, for the A/B lane
        self._stop_evt = threading.Event()
        self._thread: threading.Thread | None = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop_evt.clear()
        self._thread = threading.Thread(
            target=self._run, name="metrics-history", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop_evt.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)
        self._thread = None

    def _run(self) -> None:
        while not self._stop_evt.wait(self.cadence):
            try:
                self.sample_once()
            except Exception:  # graftlint: disable=exception-hygiene -- the sampler must survive any plane's failure
                pass

    # -- collection ----------------------------------------------------------

    def _rate(self, key: str, cum: float, now: float) -> float:
        """Per-second delta of a cumulative counter; 0.0 on the first
        observation or a counter reset (restart)."""
        prev = self._prev.get(key)
        self._prev[key] = (float(cum), now)
        if prev is None:
            return 0.0
        pv, pt = prev
        if now <= pt or cum < pv:
            return 0.0
        return (float(cum) - pv) / (now - pt)

    def _collect(self) -> dict:
        """One curated gauge sample across the planes.  Cumulative
        counters become per-second rates so decimation-by-mean is
        meaningful for every series."""
        now = time.monotonic()
        s: dict[str, float] = {}
        slo = getattr(self.holder, "slo", None)
        if slo is not None:
            try:
                # series_sample, not snapshot(): the full objective
                # walk is exposition-grade work, too heavy per tick
                for cname, c in slo.series_sample().items():
                    base = f"slo.{cname}"
                    if c["p50Ms"] is not None:
                        s[f"{base}.p50_ms"] = c["p50Ms"]
                    if c["p99Ms"] is not None:
                        s[f"{base}.p99_ms"] = c["p99Ms"]
                    s[f"{base}.availability"] = c["availability"]
                    if "burnRate" in c:
                        s[f"{base}.burn"] = c["burnRate"]
                    s[f"{base}.rps"] = self._rate(
                        f"{base}.total", c["total"], now
                    )
                    s[f"{base}.eps"] = self._rate(
                        f"{base}.errors", c["errors"], now
                    )
            except Exception:  # graftlint: disable=exception-hygiene -- one plane failing must not starve the others
                pass
        api = self.api
        batcher = getattr(api, "batcher", None) if api is not None else None
        if batcher is not None:
            try:
                b = batcher.snapshot()
                s["batcher.depth"] = b["depth"]
                s["batcher.batches_ps"] = self._rate(
                    "batcher.batches", b["batches"], now
                )
                s["batcher.coalesced_ps"] = self._rate(
                    "batcher.coalesced", b["coalesced"], now
                )
            except Exception:  # graftlint: disable=exception-hygiene -- one plane failing must not starve the others
                pass
        qos = getattr(api, "qos", None) if api is not None else None
        if qos is not None:
            try:
                q = qos.snapshot()
                for tname, t in q["tenants"].items():
                    tb = f"qos.{tname}"
                    s[f"{tb}.admitted_ps"] = self._rate(
                        f"{tb}.admitted", t["admitted"], now
                    )
                    s[f"{tb}.shed_ps"] = self._rate(
                        f"{tb}.shed", t["shed"], now
                    )
                    s[f"{tb}.debt_ms"] = t["debtMs"]
            except Exception:  # graftlint: disable=exception-hygiene -- one plane failing must not starve the others
                pass
        try:
            c = devledger.counters()
            s["dev.device_ms_ps"] = self._rate(
                "dev.deviceMs", c["deviceMs"], now
            )
            s["dev.compiles_ps"] = self._rate(
                "dev.compiles", c["compiles"], now
            )
            s["dev.transfer_bytes_ps"] = self._rate(
                "dev.transferBytes", c["h2dBytes"] + c["d2hBytes"], now
            )
        except Exception:  # graftlint: disable=exception-hygiene -- one plane failing must not starve the others
            pass
        try:
            r = residency.default_tracker().snapshot()
            s["res.hits_ps"] = self._rate(
                "res.hits", r["deviceHits"], now
            )
            s["res.evictions_ps"] = self._rate(
                "res.evictions",
                r.get("autoUnpins", 0) + r.get("prefetchWasted", 0),
                now,
            )
            s["res.prefetch_ps"] = self._rate(
                "res.prefetch", r["prefetchIssued"], now
            )
        except Exception:  # graftlint: disable=exception-hygiene -- one plane failing must not starve the others
            pass
        ingest = getattr(api, "ingest", None) if api is not None else None
        if ingest is not None:
            try:
                snap = ingest.snapshot()
                s["ingest.decoded_ps"] = self._rate(
                    "ingest.decoded", snap["decoded"], now
                )
                pool = snap.get("pool") or {}
                for k in ("occupancy", "inUse", "used"):
                    if k in pool:
                        s["ingest.occupancy"] = pool[k]
                        break
                up = snap.get("uploader")
                if up is not None:
                    s["ingest.h2d_bytes_ps"] = self._rate(
                        "ingest.h2dBytes", up["h2dBytes"], now
                    )
            except Exception:  # graftlint: disable=exception-hygiene -- one plane failing must not starve the others
                pass
        return s

    def sample_once(self) -> None:
        t0 = time.monotonic()
        # stamped when taken, as its rates' monotonic clock is: a sample
        # stamped after a collection that waited on busy planes would skew
        # every rate's integral over the series
        wall = time.time()
        sample = self._collect()
        self.record(sample, wall)
        stats = getattr(self.holder, "stats", None)
        if stats is not None:
            stats.count("history_samples")
        self._sample_seconds += time.monotonic() - t0

    # -- storage -------------------------------------------------------------

    def record(self, sample: dict, wall: float | None = None) -> None:
        """Append one sample to the base ring, fold completed decimation
        windows into coarser tiers, then run the trend detectors."""
        if wall is None:
            wall = time.time()
        with self._lock:
            base = self.tiers[0]
            base.append(wall, sample)
            self._samples_taken += 1
            for tier in self.tiers[1:]:
                d = tier.decimate
                if base.count % d != 0:
                    continue
                times, values = base.window(base.count - d)
                folded = {
                    name: _nanmean(win) for name, win in values.items()
                }
                folded = {
                    k: v for k, v in folded.items() if not np.isnan(v)
                }
                tier.append(float(times[-1]), folded)
        self._detect(sample, wall)

    # -- query ---------------------------------------------------------------

    def _pick_tier(self, step: float | None) -> _Tier:
        if step is None:
            return self.tiers[0]
        pick = self.tiers[0]
        for tier in self.tiers:
            if self.cadence * tier.decimate <= float(step) * (1 + 1e-9):
                pick = tier
        return pick

    @staticmethod
    def _match(name: str, patterns) -> bool:
        if not patterns:
            return True
        return any(fnmatch.fnmatchcase(name, p) for p in patterns)

    def query(
        self,
        series=None,
        since: int | None = None,
        step: float | None = None,
        limit: int | None = None,
    ) -> dict:
        """Windowed, optionally-downsampled read of the rings.

        ``series`` is a glob (or comma list / list of globs) over series
        names; ``since`` is a base-unit seq cursor (resume with the
        returned ``nextSeq``); ``step`` selects the coarsest tier not
        coarser than the requested resolution, then mean-downsamples the
        rest of the way; ``limit`` keeps only the newest N samples.
        Gap-honest: ``truncated`` is True when ``since`` predates the
        oldest retained sample in the serving tier."""
        if isinstance(series, str):
            series = [p.strip() for p in series.split(",") if p.strip()]
        with self._lock:
            tier = self._pick_tier(step)
            d = tier.decimate
            eff_step = self.cadence * d
            valid = min(tier.count, tier.capacity)
            start = tier.count - valid
            truncated = False
            if since is not None:
                want = -(-max(0, int(since)) // d)  # ceil division
                if want < start:
                    truncated = True
                start = max(start, min(want, tier.count))
            if limit is not None and limit >= 0:
                start = max(start, tier.count - int(limit))
            times, values = tier.window(start)
            names = sorted(
                n for n in values.keys() if self._match(n, series)
            )
            out_series = {}
            for name in names:
                vals = values[name]
                pts = [
                    [round(float(t), 3),
                     None if np.isnan(v) else float(v)]
                    for t, v in zip(times, vals)
                ]
                if step is not None and float(step) > 0:
                    # always downsample on an explicit step — even at
                    # step == tierStep it snaps raw sampler-phase times
                    # onto the floor(t/step)*step grid, which is what
                    # keeps a cluster merge wall-clock ALIGNED
                    pts = downsample(pts, float(step))
                out_series[name] = pts
            payload = {
                "node": self.node_id,
                "cadence": self.cadence,
                "step": float(step) if step is not None else eff_step,
                "tierStep": eff_step,
                "tiers": [
                    {
                        "step": self.cadence * t.decimate,
                        "capacity": t.capacity,
                        "retained": min(t.count, t.capacity),
                    }
                    for t in self.tiers
                ],
                "series": out_series,
                "seq": self.tiers[0].count,
                "nextSeq": tier.count * d,
                "firstSeq": (tier.count - valid) * d,
                "returned": int(tier.count - start),
                "truncated": truncated,
            }
        payload["detectors"] = self.trend_state()
        return payload

    # -- trend detection -----------------------------------------------------

    def _class_of(self, name: str, suffix: str) -> str:
        return name[len("slo."):len(name) - len(suffix)]

    def _detect(self, sample: dict, wall: float) -> None:
        fired_now: list[dict] = []
        with self._lock:
            for kind in ALL_DETECTORS:
                if kind not in self.detectors:
                    continue
                suffix, trig_name = _DETECTOR_SUFFIX[kind]
                for name, v in sample.items():
                    if not name.startswith("slo.") or not name.endswith(
                        suffix
                    ):
                        continue
                    t = self._step_detector(kind, name, float(v))
                    if t is not None:
                        t["at"] = round(wall, 3)
                        t["class"] = self._class_of(name, suffix)
                        t["detector"] = trig_name
                        fired_now.append(t)
            was_active = self._episode_active
            self._episode_active = any(
                st.latched for st in self._det.values()
            )
            # one trend episode = one incident: series tripping while
            # any detector is already latched join the episode silently
            if was_active:
                fired_now = []
            elif fired_now:
                fired_now = fired_now[:1]
                self._fired.extend(fired_now)
                del self._fired[:-_MAX_FIRED]
        for trigger in fired_now:
            self._fire(trigger)

    def _step_detector(
        self, kind: str, name: str, v: float
    ) -> dict | None:
        """Advance one (detector, series) state machine; returns a
        trigger skeleton on a fresh latch.  The baseline is FROZEN from
        the first breaching sample until the episode unlatches — an
        EWMA that chases the regression would declare it the new
        normal — and unlatching takes ``trips`` consecutive samples
        past the recovery midpoint, not merely under the latch line."""
        if np.isnan(v):
            return None
        st = self._det.get((kind, name))
        if st is None:
            st = self._det[(kind, name)] = _DetState()
        if kind == DETECTOR_THROUGHPUT and v <= 0.0:
            # idle != collapse: no offered load is indistinguishable
            # from zero goodput, so idle neither breaches nor feeds the
            # baseline; it does count toward re-arm so a latched
            # detector recovers when the burst ends.
            if st.latched:
                st.good += 1
                st.bad = 0
                if st.good >= self.trips:
                    st.latched = False
            return None
        if st.latched:
            # hysteresis: recovery must clear the MIDPOINT between the
            # baseline and the latch threshold, not merely dip under
            # the latch line — and the baseline stays frozen for the
            # whole episode.  Without both, a regression hovering near
            # the threshold drags the EWMA up on each "good" sample
            # until the episode unlatches and immediately re-fires.
            if kind == DETECTOR_LATENCY:
                recovered = v <= max(
                    st.mean * (1.0 + (self.latency_factor - 1.0) / 2.0),
                    st.mean + self.latency_min_ms / 2.0,
                )
            elif kind == DETECTOR_THROUGHPUT:
                recovered = v >= st.mean * min(
                    1.0, (1.0 + self.collapse_frac) / 2.0
                )
            else:
                recovered = v <= max(
                    st.mean * (1.0 + (self.error_factor - 1.0) / 2.0),
                    self.error_min_eps / 2.0,
                )
            if recovered:
                st.good += 1
                st.bad = 0
                if st.good >= self.trips:
                    st.latched = False
            else:
                st.good = 0
            return None
        breach = False
        if st.n >= self.warmup and st.mean is not None:
            if kind == DETECTOR_LATENCY:
                breach = v > max(
                    st.mean * self.latency_factor,
                    st.mean + self.latency_min_ms,
                )
            elif kind == DETECTOR_THROUGHPUT:
                breach = (
                    st.mean >= self.collapse_min_rps
                    and v < st.mean * self.collapse_frac
                )
            elif kind == DETECTOR_ERRORS:
                breach = v > max(
                    st.mean * self.error_factor, self.error_min_eps
                )
        if breach:
            st.bad += 1
            st.good = 0
        else:
            st.good += 1
            st.bad = 0
            if st.mean is None:
                st.mean = v
            else:
                st.mean += self.ewma_alpha * (v - st.mean)
            st.n += 1
        if st.bad >= self.trips:
            st.latched = True
            return {
                "type": "trend",
                "series": name,
                "baseline": round(st.mean, 4),
                "observed": round(v, 4),
                "samples": st.bad,
            }
        return None

    def _fire(self, trigger: dict) -> None:
        stats = getattr(self.holder, "stats", None)
        if stats is not None:
            stats.count("history_trend_incidents")
        fr = self.flightrec
        if fr is not None:
            fr.capture_incident(dict(trigger))

    # -- incident attachment / exposition ------------------------------------

    def incident_series(self, trigger: dict) -> dict | None:
        """Flight-recorder ``series_provider`` hook: the series windows
        to freeze into an incident bundle — the full retained base-tier
        window for the regressed class (or everything for non-trend
        triggers the caller scoped), plus the coarse tier so the bundle
        reaches back past the base ring (>= 60 s of pre-incident
        history at production cadence)."""
        cls = trigger.get("class")
        pats = [f"slo.{cls}.*"] if cls else None
        q = self.query(series=pats)
        out = {
            "cadence": self.cadence,
            "series": q["series"],
            "nextSeq": q["nextSeq"],
        }
        span = 0.0
        for pts in q["series"].values():
            if len(pts) >= 2:
                span = max(span, pts[-1][0] - pts[0][0])
        out["preSeconds"] = round(span, 3)
        if len(self.tiers) > 1:
            coarse_step = self.cadence * self.tiers[-1].decimate
            out["coarse"] = self.query(series=pats, step=coarse_step)[
                "series"
            ]
        return out

    def blackbox_snapshot(self, window_s: float = 60.0) -> dict:
        """Black-box checkpoint block: the trailing ``window_s`` of
        every base-tier series plus detector state — enough that a
        postmortem can answer "what did the last minute look like"
        without the rings that died with the process."""
        import math

        limit = max(1, int(math.ceil(float(window_s) / self.cadence)))
        q = self.query(limit=limit)
        return {
            "cadence": self.cadence,
            "windowSeconds": float(window_s),
            "series": q["series"],
            "nextSeq": q["nextSeq"],
            "detectors": q["detectors"],
            "stats": self.stats(),
        }

    def trend_state(self) -> dict:
        with self._lock:
            return {
                "enabled": sorted(self.detectors),
                "episodeActive": self._episode_active,
                "fired": list(self._fired),
                "series": {
                    f"{kind}:{name}": {
                        "baseline": (
                            round(st.mean, 4) if st.mean is not None
                            else None
                        ),
                        "n": st.n,
                        "latched": st.latched,
                    }
                    for (kind, name), st in sorted(self._det.items())
                },
            }

    def stats(self) -> dict:
        """Sampler self-accounting for /debug/vars and the bench lane."""
        with self._lock:
            return {
                "cadence": self.cadence,
                "samples": self._samples_taken,
                "series": len(self.tiers[0].values),
                "sampleSeconds": round(self._sample_seconds, 6),
                "trendFired": len(self._fired),
            }
