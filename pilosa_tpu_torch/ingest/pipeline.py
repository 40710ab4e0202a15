"""Staged ingest pipeline: decode -> coalesced apply -> H2D upload
(counterpart of ``pilosa_tpu/ingest/pipeline.py``, without the migration
code's ``ChunkPrefetcher``).

The lock-step import path serialized everything: decode a batch, merge
it into the fragment's host mirror, (eventually) re-upload the fragment
to HBM, repeat.  The pipeline runs the three stages concurrently over a
stream of per-shard segments, tf.data-style (overlap the transfer with
the compute):

* **decode** — Roaring blob -> positions, natively and zero-copy into a
  pinned staging buffer (staging.py).  Runs on the submitting handler
  thread; bounded by the staging pool.
* **apply** — the fragment merge, on the bounded ImportPool.  Every
  segment is submitted before any is awaited, so distinct fragments
  drain on different workers, and same-fragment segments group-commit
  into one merged apply (importpool.submit_merged).
* **upload** — the host->device sync of an applied fragment, on a
  dedicated double-buffered uploader thread: while batch N+1 is being
  merged on a worker, batch N's upload is in flight here.  Two
  slots (classic double buffering) bound the device-sync backlog; a
  full slot queue blocks the apply stage, which blocks the pool queue,
  which blocks the HTTP client — backpressure end to end.  On the card
  the thread copies on a CUDA stream of its own through as many pinned
  bounce buffers as it has slots (``ops/streams.PinnedStager``): a slot is
  refilled only after its copy's event, and what it uploads (a fragment's
  device copy, a prefetched stack) carries the event after its copy,
  which every reader's stream waits for before reading.

``overlap_frac`` reports the fraction of uploaded bytes whose transfer
ran while an apply was in flight — the overlap the pipeline exists to
create.

A failed upload is counted (``upload_errors``) and the thread carries on:
the host mirror is authoritative, and the next query's sync uploads again
(and raises, if the card is at fault).
"""

from __future__ import annotations

import queue
import threading
import time

import torch

from pilosa_tpu_torch.ingest.staging import DEFAULT_CAPACITY, StagingPool
from pilosa_tpu_torch.obs import devledger
from pilosa_tpu_torch.ops import streams

# Device cost ledger sites: upload windows adopt the sync's H2D bytes
# (bitops.to_device books to the active window's site), splitting ingest
# uploads from predictive prefetches.
_DL_UPLOAD = devledger.site("ingest.upload")
_DL_PREFETCH = devledger.site("server.prefetch")

_STOP = object()


class DeviceUploader:
    """Double-buffered background host->device sync stage, shared
    between ingest and the residency prefetcher.

    ``submit(frag)`` enqueues a fragment whose mirror was just mutated;
    the uploader thread calls ``frag.device_bits()`` (the incremental
    row sync) off the apply path, on its own stream on the card.  The slot queue is the
    double buffer: with the default two slots, one upload can be in
    flight while one more is staged, and a third submission blocks its
    apply worker (bounded backlog, propagated backpressure).

    ``submit_prefetch(frag)`` rides the same thread on a SECOND,
    lower-priority queue: the run loop only takes a prefetch item when
    the ingest queue is empty, so predictive uploads for the next query
    flight (server/batcher.py) can never delay an apply worker's sync.
    Prefetch submission never blocks — a full prefetch queue drops the
    item (the query path just pays its own upload, as before)."""

    def __init__(
        self, slots: int = 2, stats=None, applies_active=None,
        slot_bytes: int = streams.SLOT_BYTES,
    ):
        self.stats = stats
        self.slot_bytes = int(slot_bytes)
        # card -> PinnedStager, made on the uploader thread at its first
        # job there (the thread owns the side stream and pinned slots)
        self._stagers: dict = {}
        self._applies_active = applies_active or (lambda: 0)
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, slots))
        self.slots = max(1, slots)
        # prefetch backlog is wider than the ingest double buffer (a
        # flight can stage many fragments at once) but still bounded:
        # drop-on-full, never block
        self._prefetch_q: "queue.Queue" = queue.Queue(
            maxsize=max(8, slots * 8)
        )
        self.uploads = 0
        self.uploads_coalesced = 0
        self.upload_errors = 0
        self.h2d_bytes = 0
        self.h2d_bytes_overlapped = 0
        self.blocked_submits = 0
        self.blocked_seconds = 0.0
        self.upload_seconds = 0.0
        self.prefetch_uploads = 0
        self.prefetch_dropped = 0
        self.prefetch_seconds = 0.0
        self._pending = 0
        self._queued: set[int] = set()  # id(frag) staged, not yet syncing
        self._prefetch_queued: set[int] = set()
        self._pending_lock = threading.Lock()
        self._idle = threading.Condition(self._pending_lock)
        self._wake = threading.Condition(self._pending_lock)
        self._closed = False
        self._thread = threading.Thread(
            target=self._run, name="ingest-upload", daemon=True
        )
        self._thread.start()

    def submit(self, frag) -> None:
        """Queue a fragment for device sync; blocks while both slots are
        busy.  No-op after close (host mirror stays source of truth —
        the next query's device_bits() syncs lazily).

        Pending syncs coalesce: a fragment already staged (queued, sync
        not yet started) absorbs this submission — device_bits() reads
        the latest host state when it runs, so one sync covers every
        apply that landed before it started.  Back-to-back merges into
        one fragment cost ONE upload, not one per batch."""
        if self._closed:
            return
        with self._pending_lock:
            if id(frag) in self._queued:
                self.uploads_coalesced += 1
                if self.stats is not None:
                    self.stats.count("ingest_uploads_coalesced", 1)
                return
            self._queued.add(id(frag))
            self._pending += 1
        try:
            self._q.put_nowait(frag)
        except queue.Full:
            self.blocked_submits += 1
            t0 = time.perf_counter()
            self._q.put(frag)
            self.blocked_seconds += time.perf_counter() - t0
        self._notify()

    def _notify(self) -> None:
        """Wake the uploader, after the job is in its queue: woken before
        the put, it could find both queues empty and sleep out its 50 ms
        poll with the job waiting."""
        with self._wake:
            self._wake.notify()

    def submit_prefetch(self, frag, done=None) -> bool:
        """Stage a predictive upload on the low-priority queue; returns
        True when actually queued.  Never blocks: a full queue or an
        uploader busy with the same fragment's ingest sync drops the
        request (False), and the query path pays its own upload exactly
        as it would have without prefetch.  ``done(frag, err)`` runs on
        the uploader thread after the sync attempt."""
        if self._closed:
            return False
        # stack targets carry a stable identity across flights; raw
        # fragments dedup on object id exactly like the ingest queue
        key = getattr(frag, "prefetch_key", None)
        if key is None:
            key = id(frag)
        with self._pending_lock:
            if id(frag) in self._queued or key in self._prefetch_queued:
                # already riding an ingest sync / earlier prefetch: that
                # upload covers this request (device_bits reads latest)
                return False
            self._prefetch_queued.add(key)
            self._pending += 1
        try:
            self._prefetch_q.put_nowait((frag, key, done))
        except queue.Full:
            self.prefetch_dropped += 1
            with self._pending_lock:
                self._prefetch_queued.discard(key)
                self._pending -= 1
                if self._pending == 0:
                    self._idle.notify_all()
            return False
        self._notify()
        return True

    def flush(self, timeout: float = 30.0) -> bool:
        """Block until every submitted upload has completed."""
        deadline = time.monotonic() + timeout
        with self._idle:
            while self._pending > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._idle.wait(remaining)
        return True

    def _drain_prefetch(self) -> None:
        """Discard staged prefetches at shutdown (predictive uploads are
        advisory; flush() was the owner's chance to wait them out)."""
        while True:
            try:
                frag, _key, done = self._prefetch_q.get_nowait()
            except queue.Empty:
                break
            if done is not None:
                try:
                    done(frag, None)  # the owner's note of it ends here
                except Exception:  # its accounting hook: shutdown goes on
                    pass
            with self._idle:
                self._pending -= 1
                if self._pending == 0:
                    self._idle.notify_all()
        with self._pending_lock:
            self._prefetch_queued.clear()

    def _stager(self, frag):
        """The pinned stager of the card ``frag`` lives on (None off the
        card)."""
        dev = getattr(frag, "device", None)
        if dev is None or torch.device(dev).type != "cuda":
            return None
        dev = streams.card(dev)
        st = self._stagers.get(dev)
        if st is None:
            st = self._stagers[dev] = streams.PinnedStager(
                dev, slots=self.slots, slot_bytes=self.slot_bytes
            )
        return st

    def _run_prefetch(self, frag, done) -> None:
        """One predictive upload: marked as prefetch traffic so the
        residency tracker books it apart from query hits/misses."""
        from pilosa_tpu_torch.core import residency

        t0 = time.perf_counter()
        err = None
        tracker = residency.default_tracker()
        tracker.enter_prefetch()
        try:
            with _DL_PREFETCH.launch(sig="prefetch_sync"), streams.staging(
                self._stager(frag)
            ):
                frag.device_bits()
        except Exception as e:  # advisory: the query path syncs lazily
            err = e
        finally:
            tracker.exit_prefetch()
        self.prefetch_uploads += 1
        self.prefetch_seconds += time.perf_counter() - t0
        if self.stats is not None:
            self.stats.count("residency_prefetch_uploads", 1)
        if done is not None:
            try:
                done(frag, err)
            except Exception:
                # the done callback is the prefetcher's own accounting
                # hook; a bug there must not kill the uploader thread
                tracker.note_prefetch_error()
        with self._idle:
            self._pending -= 1
            if self._pending == 0:
                self._idle.notify_all()

    def _run(self) -> None:
        while True:
            done = None
            pkey = None
            is_prefetch = False
            try:
                frag = self._q.get_nowait()
            except queue.Empty:
                # ingest queue empty: a prefetch may ride the idle slot
                # (strict priority — ingest is always drained first)
                try:
                    frag, pkey, done = self._prefetch_q.get_nowait()
                    is_prefetch = True
                except queue.Empty:
                    with self._wake:
                        if self._q.empty() and self._prefetch_q.empty():
                            self._wake.wait(0.05)
                    continue
            if frag is None:
                self._drain_prefetch()
                return
            # un-stage BEFORE syncing: an apply landing mid-sync must
            # queue a fresh sync (device_bits only covers state that
            # existed when it took the fragment lock)
            with self._pending_lock:
                if is_prefetch:
                    self._prefetch_queued.discard(pkey)
                else:
                    self._queued.discard(id(frag))
            if is_prefetch:
                self._run_prefetch(frag, done)
                continue
            overlapped = self._applies_active() > 0
            t0 = time.perf_counter()
            nbytes = 0
            try:
                with _DL_UPLOAD.launch(sig="ingest_sync"), streams.staging(
                    self._stager(frag)
                ):
                    frag.device_bits()
                nbytes = int(getattr(frag, "last_sync_h2d_bytes", 0))
            except Exception:
                # Upload is an accelerator warm-path optimization; the
                # host mirror stays authoritative and the next query
                # syncs lazily, so a failed upload must not fail ingest.
                self.upload_errors += 1
                if self.stats is not None:
                    self.stats.count("ingest_upload_errors", 1)
            dt = time.perf_counter() - t0
            # overlapped if an apply was running when the upload started
            # or by the time it finished (the stages genuinely shared
            # wall-clock either way)
            overlapped = overlapped or self._applies_active() > 0
            self.uploads += 1
            self.upload_seconds += dt
            self.h2d_bytes += nbytes
            if overlapped:
                self.h2d_bytes_overlapped += nbytes
            if self.stats is not None:
                self.stats.count("ingest_uploads", 1)
                self.stats.count("ingest_h2d_bytes", nbytes)
                if overlapped:
                    self.stats.count("ingest_h2d_bytes_overlapped", nbytes)
                self.stats.timing("ingest_upload", dt)
            with self._idle:
                self._pending -= 1
                if self._pending == 0:
                    self._idle.notify_all()

    @property
    def overlap_frac(self) -> float:
        return (
            self.h2d_bytes_overlapped / self.h2d_bytes if self.h2d_bytes else 0.0
        )

    def snapshot(self) -> dict:
        pinned = [st.snapshot() for st in list(self._stagers.values())]
        return {
            "pinnedSlots": pinned,
            "slots": self.slots,
            "uploads": self.uploads,
            "uploadsCoalesced": self.uploads_coalesced,
            "uploadErrors": self.upload_errors,
            "h2dBytes": self.h2d_bytes,
            "h2dBytesOverlapped": self.h2d_bytes_overlapped,
            "overlapFrac": round(self.overlap_frac, 4),
            "blockedSubmits": self.blocked_submits,
            "blockedSeconds": round(self.blocked_seconds, 6),
            "uploadSeconds": round(self.upload_seconds, 6),
            "prefetchUploads": self.prefetch_uploads,
            "prefetchDropped": self.prefetch_dropped,
            "prefetchSeconds": round(self.prefetch_seconds, 6),
        }

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._q.put(None)
        self._notify()
        self._thread.join(timeout=5)


class IngestPipeline:
    """Orchestrates the staged import over an ImportPool.

    The pipeline owns the staging pool (decode stage) and the device
    uploader (transfer stage); the apply stage rides the shared
    ImportPool.  API import paths feed it per-shard segments; each
    segment's ``apply`` callback returns ``(result, fragment)`` and the
    fragment (when not None) is handed to the uploader."""

    def __init__(
        self,
        pool,
        stats=None,
        staging_buffers: int = 4,
        staging_capacity: int = DEFAULT_CAPACITY,
        upload_slots: int = 2,
        upload: bool = True,
    ):
        self.pool = pool
        self.stats = stats
        self.staging = StagingPool(
            buffers=staging_buffers, capacity=staging_capacity, stats=stats
        )
        self._applies = 0
        self._applies_lock = threading.Lock()
        self.uploader = (
            DeviceUploader(
                slots=upload_slots, stats=stats,
                applies_active=self.applies_active,
            )
            if upload
            else None
        )
        self.decoded = 0
        self.decode_seconds = 0.0
        self.segments = 0
        # post-apply observer: called with the mutated fragment inside
        # the same group-commit, before the upload stage sees it.  The
        # API wires this to the semantic result cache so a write
        # invalidates (or delta-maintains) entries the moment the merge
        # lands, not when the next query's version probe notices.
        self.on_apply = None

    def applies_active(self) -> int:
        with self._applies_lock:
            return self._applies

    # -- stage 1: decode ------------------------------------------------------

    def decode_roaring(self, data: bytes, n_words: int | None = None):
        """Decode a Roaring blob into a staging buffer (zero-copy native
        path): its positions, or with ``n_words`` its row words
        (``StagingBuffer.decode_rows``); returns the held StagingBuffer.
        The apply stage must release it."""
        self.pool.note_phase("decode")
        buf = self.staging.acquire()
        t0 = time.perf_counter()
        try:
            if n_words is None:
                buf.decode_grow(data)
            else:
                buf.decode_rows(data, n_words)
        except BaseException:
            buf.release()
            raise
        self.decode_seconds += time.perf_counter() - t0
        self.decoded += 1
        self.pool.advance(decoded=1)
        return buf

    # -- stage 2+3: coalesced apply, then upload ------------------------------

    def submit_segment(self, key, payload, apply_group, release=None):
        """Queue one per-shard segment for a (possibly coalesced) merged
        apply.  ``apply_group(payloads)`` runs on a pool worker with the
        arrival-ordered payload list of its group and returns
        ``(result, fragment)``; the fragment is then submitted to the
        upload stage.  ``release(payload)`` runs after the apply (even
        on error) — staging buffers are returned here, so a failed drain
        can't strand them."""
        self.segments += 1

        def fn_many(payloads):
            self.pool.note_phase("apply")
            with self._applies_lock:
                self._applies += 1
            try:
                result, frag = apply_group(payloads)
            finally:
                with self._applies_lock:
                    self._applies -= 1
                if release is not None:
                    for p in payloads:
                        release(p)
            self.pool.advance(applied=1)
            if frag is not None and self.on_apply is not None:
                try:
                    self.on_apply(frag)
                except Exception:
                    # observers must never fail an ingest apply
                    if self.stats is not None:
                        self.stats.count("ingest_on_apply_errors", 1)
            if frag is not None and self.uploader is not None:
                self.pool.note_phase("upload")
                self.uploader.submit(frag)
            return result

        return self.pool.submit_merged(key, payload, fn_many)

    def drain(self, handles):
        """Await every submitted segment; first error raised after all
        settle."""
        self.pool.wait_all(handles)

    @property
    def overlap_frac(self) -> float:
        return self.uploader.overlap_frac if self.uploader is not None else 0.0

    def snapshot(self) -> dict:
        out = {
            "pool": self.pool.snapshot(),
            "staging": self.staging.snapshot(),
            "decoded": self.decoded,
            "decodeSeconds": round(self.decode_seconds, 6),
            "segments": self.segments,
        }
        if self.uploader is not None:
            out["uploader"] = self.uploader.snapshot()
            out["overlapFrac"] = round(self.overlap_frac, 4)
        return out

    def close(self) -> None:
        if self.uploader is not None:
            self.uploader.flush(timeout=5.0)
            self.uploader.close()
