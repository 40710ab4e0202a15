"""Bounded import worker pool (reference api.go:66-96, importWorker
:313-348).

The reference queues every import job onto a channel drained by
``importWorkerPoolSize`` goroutines and the HTTP handler blocks on the
job's error channel — a concurrency limiter with backpressure, not
fire-and-forget.  Same shape here, grown two capabilities for the
staged ingest pipeline:

* **Async handles.** ``submit`` blocks only for queue space (the
  backpressure edge) and returns a handle; ``run`` is submit + wait.
  The pipeline submits every shard's drain before waiting on any, so
  independent fragments merge on different workers concurrently.

* **Same-fragment coalescing.** ``submit_merged`` group-commits: while
  a keyed group is queued but not yet started, later submissions for
  the same key piggyback their payload onto it instead of queueing
  another job — N queued imports into one fragment become ONE merged
  apply (one lock acquisition, one op-log batch, one device sync)
  rather than N serialized merges.  Every member gets the group's
  result.

A job submitted FROM a worker thread runs inline instead, so nested
imports (the coordinator's local slice re-entering the API) can never
deadlock the pool.  One "import-drain" job record spans each busy
period (first submission after idle -> last completion) at
``/debug/jobs``; a failing worker terminates it as ``error`` with the
exception text instead of stranding it active.

Counterpart of ``pilosa_tpu/server/importpool.py``, the same code.
"""

from __future__ import annotations

import queue
import threading
import time


class Handle:
    """Completion future of one submitted job."""

    __slots__ = ("_event", "_result", "_error")

    def __init__(self):
        self._event = threading.Event()
        self._result = None
        self._error = None

    def _finish(self, result=None, error=None) -> None:
        self._result = result
        self._error = error
        self._event.set()

    def wait(self):
        self._event.wait()
        if self._error is not None:
            raise self._error
        return self._result


class _Group:
    """One coalesced same-key batch: payloads accumulate until a worker
    starts the group, then everyone shares the result."""

    __slots__ = ("payloads", "handle", "started")

    def __init__(self, payload):
        self.payloads = [payload]
        self.handle = Handle()
        self.started = False


class ImportPool:
    def __init__(self, workers: int = 2, depth: int = 16, jobs=None, stats=None):
        # depth <= 0 would make the queue unbounded, silently removing
        # the backpressure this pool exists to provide
        self.depth = max(1, depth)
        self.workers = max(1, workers)
        self._q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        self._local = threading.local()
        self._closed = False
        self.stats = stats
        # submit-side counters (read by /debug/vars and the bench)
        self.blocked_submits = 0
        self.blocked_seconds = 0.0
        self.jobs_run = 0
        self.jobs_coalesced = 0
        self.errors = 0
        # Coalescing state: key -> open (not yet started) group.
        self._groups_lock = threading.Lock()
        self._groups: dict = {}
        # Drain tracking: one "import-drain" job spans each busy period
        # (first submission after idle -> last completion), so a bulk
        # ingest shows up as a single progressing job at /debug/jobs.
        self._jobs = jobs  # JobTracker, optional
        self._drain_lock = threading.Lock()
        self._inflight = 0
        self._drain_job = None
        self._drain_errors = 0
        self._drain_last_error: str | None = None
        if self.stats is not None:
            self.stats.gauge("ingest_pool_depth", self.depth)
            self.stats.gauge("ingest_pool_workers", self.workers)
        self._threads = [
            threading.Thread(target=self._worker, daemon=True, name=f"import-{i}")
            for i in range(self.workers)
        ]
        for t in self._threads:
            t.start()

    # -- drain-job bookkeeping ----------------------------------------------

    def _drain_begin(self) -> None:
        with self._drain_lock:
            self._inflight += 1
            if self._jobs is not None and self._drain_job is None:
                self._drain_job = self._jobs.start("import-drain")
                self._drain_job.set_phase("draining")
                self._drain_errors = 0
                self._drain_last_error = None
        if self.stats is not None:
            self.stats.gauge("ingest_inflight", self._inflight)

    def _drain_end(self, failed: bool, error: str | None = None,
                   advance: bool = True) -> None:
        if failed:
            self.errors += 1
            if self.stats is not None:
                self.stats.count("ingest_errors", 1)
        with self._drain_lock:
            self._inflight -= 1
            inflight = self._inflight
            job = self._drain_job
            if job is not None:
                if failed:
                    self._drain_errors += 1
                    if error:
                        self._drain_last_error = error
                if advance:
                    job.advance(
                        imports_done=1, errors=1 if failed else 0
                    )
                if inflight == 0:
                    # A busy period with failures terminates the record
                    # as error (with the last exception text) instead of
                    # reporting a clean drain.
                    if self._drain_errors:
                        job.finish("error", error=self._drain_last_error)
                    else:
                        job.finish("done")
                    self._drain_job = None
        if self.stats is not None:
            self.stats.gauge("ingest_inflight", inflight)

    def drain_scope(self):
        """Context manager holding the drain record open across a whole
        multi-stage import, so decode/upload stages between pool jobs
        don't close the busy period early."""
        pool = self

        class _Scope:
            def __enter__(self):
                pool._drain_begin()
                return self

            def __exit__(self, et, ev, tb):
                pool._drain_end(
                    failed=ev is not None,
                    error=f"{type(ev).__name__}: {ev}" if ev is not None else None,
                    advance=False,
                )
                return False

        return _Scope()

    def note_phase(self, phase: str) -> None:
        """Per-stage progress on the open drain record (pipeline stages
        report decode/apply/upload through here)."""
        with self._drain_lock:
            if self._drain_job is not None:
                self._drain_job.set_phase(phase)

    def advance(self, **counters) -> None:
        with self._drain_lock:
            if self._drain_job is not None:
                self._drain_job.advance(**counters)

    # -- execution ------------------------------------------------------------

    def _worker(self) -> None:
        self._local.is_worker = True
        while True:
            item = self._q.get()
            if item is None:
                return
            fn, handle = item
            self._run_job(fn, handle)
            self._q.task_done()

    def _run_job(self, fn, handle: Handle) -> None:
        """Execute one job and settle its handle; drain accounting ends
        here — in the executing thread — so a raising worker still
        decrements ``_inflight`` and records the error text."""
        failed, err = False, None
        try:
            handle._finish(result=fn())
        except BaseException as e:  # propagate to the submitter
            failed, err = True, f"{type(e).__name__}: {e}"
            handle._finish(error=e)
        finally:
            self.jobs_run += 1
            self._drain_end(failed, err)

    def _put(self, item) -> None:
        """Bounded enqueue, timing the blocked-submit edge."""
        try:
            self._q.put_nowait(item)
            return
        except queue.Full:
            pass
        self.blocked_submits += 1
        t0 = time.perf_counter()
        self._q.put(item)
        dt = time.perf_counter() - t0
        self.blocked_seconds += dt
        if self.stats is not None:
            self.stats.count("ingest_submit_blocked", 1)
            self.stats.timing("ingest_blocked_submit", dt)

    def submit(self, fn, handle: Handle | None = None) -> Handle:
        """Queue ``fn`` for a pool worker; blocks only while the queue
        is full (backpressure to the ingest client).  Jobs submitted
        from a worker thread (nested imports) run inline — completed by
        return — so the pool can never deadlock on itself."""
        self._drain_begin()
        if handle is None:
            handle = Handle()
        if self._closed or getattr(self._local, "is_worker", False):
            self._run_job(fn, handle)
            return handle
        try:
            self._put((fn, handle))
        except BaseException:
            self._drain_end(failed=True, error="submit failed")
            raise
        return handle

    def run(self, fn):
        """Execute ``fn`` on a pool worker and return its result; blocks
        for queue space (backpressure) and for completion, like the
        reference handler blocking on the job's error channel
        (api.go:330-346)."""
        return self.submit(fn).wait()

    def submit_merged(self, key, payload, fn_many) -> Handle:
        """Coalescing submit: group-commit ``payload`` with any other
        queued-but-unstarted submissions of the same ``key``.  The group
        runs as ONE pool job calling ``fn_many(payloads)`` (in arrival
        order); every member's handle settles with that one result.

        Joining an open group costs no queue slot — that's the point:
        under backlog, N queued same-fragment jobs collapse into one
        merged apply instead of N serialized merges."""
        with self._groups_lock:
            group = self._groups.get(key)
            if group is not None and not group.started:
                group.payloads.append(payload)
                self.jobs_coalesced += 1
                if self.stats is not None:
                    self.stats.count("ingest_jobs_coalesced", 1)
                return group.handle
            group = _Group(payload)
            self._groups[key] = group

        def run_group():
            with self._groups_lock:
                group.started = True
                if self._groups.get(key) is group:
                    del self._groups[key]
                payloads = list(group.payloads)
            return fn_many(payloads)

        # The group's shared handle rides the pool job directly: when the
        # worker settles it, every member — first submitter and joiners
        # alike — wakes with the same result.
        return self.submit(run_group, handle=group.handle)

    def wait_all(self, handles) -> None:
        """Wait every handle; raises the first error AFTER all have
        settled (a failing shard must not leave later drains un-awaited)."""
        first: BaseException | None = None
        for h in handles:
            try:
                h.wait()
            except BaseException as e:
                if first is None:
                    first = e
        if first is not None:
            raise first

    # -- introspection --------------------------------------------------------

    def snapshot(self) -> dict:
        with self._drain_lock:
            inflight = self._inflight
        return {
            "workers": self.workers,
            "depth": self.depth,
            "queueLen": self._q.qsize(),
            "inflight": inflight,
            "jobsRun": self.jobs_run,
            "jobsCoalesced": self.jobs_coalesced,
            "errors": self.errors,
            "blockedSubmits": self.blocked_submits,
            "blockedSeconds": round(self.blocked_seconds, 6),
        }

    def close(self) -> None:
        self._closed = True
        for _ in self._threads:
            self._q.put(None)
        for t in self._threads:
            t.join(timeout=5)
