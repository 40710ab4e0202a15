"""Background-job progress tracking for long-running control-plane work.

Anti-entropy rounds, resize migrations, and import-pool drains can run
for minutes; the reference reports them only as log lines after the
fact.  The JobTracker gives each one a live record — phase, progress
counters (``fragments_done``/``fragments_total``, ``bytes_moved``),
derived rates and ETA, and a terminal status (``done``/``aborted``/
``error``) — served at ``/debug/jobs`` and mirrored into ``/metrics``
as ``pilosa_job_*`` series.

Progress counters come in ``<name>_done`` / ``<name>_total`` pairs;
when both exist the snapshot derives percentage, rate (done per
second over the job's lifetime), and ETA.  Bare counters (``bytes``)
just report a rate.

Counterpart of ``pilosa_tpu/obs/jobs.py``, the same code.
"""

from __future__ import annotations

import threading
import time
from collections import deque

STATUS_RUNNING = "running"
STATUS_DONE = "done"
STATUS_ABORTED = "aborted"
STATUS_ERROR = "error"

_TERMINAL = (STATUS_DONE, STATUS_ABORTED, STATUS_ERROR)


class Job:
    """One unit of tracked background work.  All mutators are
    thread-safe and monotonic: counters only advance, and a terminal
    status is final (later ``finish`` calls are ignored)."""

    def __init__(self, tracker: "JobTracker", job_id: int, kind: str,
                 node: str = "", **meta):
        self._tracker = tracker
        self._lock = threading.Lock()
        self.id = job_id
        self.kind = kind
        self.node = node
        self.meta = dict(meta)
        self.phase = ""
        self.status = STATUS_RUNNING
        self.error: str | None = None
        self.started = time.time()
        self.updated = self.started
        self.finished: float | None = None
        self._progress: dict[str, float] = {}

    # -- mutators ------------------------------------------------------------

    def set_phase(self, phase: str) -> None:
        with self._lock:
            if self.status == STATUS_RUNNING:
                self.phase = phase
                self.updated = time.time()

    def annotate(self, **meta) -> None:
        """Merge keys into the job's meta mid-flight (e.g. op-log
        catch-up lag per migration round) — meta is for labels that
        aren't monotonic counters, which is what progress is for."""
        with self._lock:
            if self.status == STATUS_RUNNING:
                self.meta.update(meta)
                self.updated = time.time()

    def advance(self, **counters: float) -> None:
        """Increment progress counters, e.g. ``advance(fragments_done=1,
        bytes=4096)``.  Counters never go backwards."""
        with self._lock:
            if self.status != STATUS_RUNNING:
                return
            for name, delta in counters.items():
                if delta > 0:
                    self._progress[name] = self._progress.get(name, 0) + delta
            self.updated = time.time()

    def set_progress(self, **counters: float) -> None:
        """Set absolute counter values (used for ``*_total`` targets).
        Values are clamped monotonic — a late, smaller total cannot make
        an observer's progress run backwards."""
        with self._lock:
            if self.status != STATUS_RUNNING:
                return
            for name, value in counters.items():
                if value >= self._progress.get(name, 0):
                    self._progress[name] = value
            self.updated = time.time()

    def finish(self, status: str = STATUS_DONE, error: str | None = None) -> None:
        with self._lock:
            if self.status != STATUS_RUNNING:
                return  # terminal is final
            self.status = status if status in _TERMINAL else STATUS_ERROR
            self.error = error
            self.finished = self.updated = time.time()
        self._tracker._on_finish(self)

    # -- views ---------------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            now = self.finished if self.finished is not None else time.time()
            elapsed = max(now - self.started, 1e-9)
            progress = dict(self._progress)
            out = {
                "id": self.id,
                "kind": self.kind,
                "node": self.node,
                "phase": self.phase,
                "status": self.status,
                "error": self.error,
                "started": self.started,
                "updated": self.updated,
                "finished": self.finished,
                "elapsed": now - self.started,
                "progress": progress,
                "meta": dict(self.meta),
            }
        rates: dict[str, float] = {}
        for name, value in progress.items():
            if name.endswith("_total"):
                continue
            rates[name + "_per_sec"] = value / elapsed
        out["rates"] = rates
        # Derive percent/ETA from the first *_done/*_total pair.
        for name, done in progress.items():
            if not name.endswith("_done"):
                continue
            total = progress.get(name[: -len("_done")] + "_total")
            if not total:
                continue
            out["percent"] = min(100.0, 100.0 * done / total)
            rate = done / elapsed
            if out["status"] == STATUS_RUNNING and rate > 0 and done < total:
                out["eta_seconds"] = (total - done) / rate
            break
        return out


class JobTracker:
    """Registry of active jobs plus a bounded history of finished ones.

    Mirrors lifecycle counts into the node's StatsClient when one is
    attached (``set_stats``): ``job_started{kind}``,
    ``job_finished{kind,status}`` counters and a ``job_active`` gauge —
    rendered by prometheus_text as ``pilosa_job_*`` series.
    """

    def __init__(self, capacity: int = 256):
        self._lock = threading.Lock()
        self._next_id = 0
        self._active: dict[int, Job] = {}
        self._history: deque[Job] = deque(maxlen=max(1, int(capacity)))
        self.stats = None  # StatsClient, attached by Holder.set_stats
        self.node_id = ""

    def start(self, kind: str, **meta) -> Job:
        with self._lock:
            self._next_id += 1
            job = Job(self, self._next_id, kind, node=self.node_id, **meta)
            self._active[job.id] = job
            active = len(self._active)
        stats = self.stats
        if stats is not None:
            stats.count_with_tags("job_started", 1, 1.0, [f"kind:{kind}"])
            stats.gauge("job_active", active)
        return job

    def _on_finish(self, job: Job) -> None:
        with self._lock:
            self._active.pop(job.id, None)
            self._history.append(job)
            active = len(self._active)
        stats = self.stats
        if stats is not None:
            stats.count_with_tags(
                "job_finished", 1, 1.0,
                [f"kind:{job.kind}", f"status:{job.status}"],
            )
            stats.gauge("job_active", active)

    def snapshot(self, kind: str | None = None) -> dict:
        """Active jobs plus finished history, newest first."""
        with self._lock:
            active = list(self._active.values())
            history = list(self._history)
        jobs = [j.snapshot() for j in active] + [
            j.snapshot() for j in reversed(history)
        ]
        if kind is not None:
            jobs = [j for j in jobs if j["kind"] == kind]
        jobs.sort(key=lambda j: j["id"], reverse=True)
        return {
            "active": sum(1 for j in jobs if j["status"] == STATUS_RUNNING),
            "jobs": jobs,
        }
