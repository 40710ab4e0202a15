"""Reusable staging buffers for the ingest decode stage (counterpart of
``pilosa_tpu/ingest/staging.py``).

A StagingPool owns a small, fixed set of reusable host buffers. The
decode stage parks each Roaring blob in one of them, decoded by the
native codec straight into the buffer with no intermediate malloc/copy
pair per batch, in one of two forms:

* positions (``decode``, ``uint64``, JAX's form), through
  ``rt_deserialize_into`` (``storage/_native.deserialize_into``);
* row words (``decode_rows``, ``uint32 [rows, n_words]`` and the row
  ids), through ``rt_decode_rows`` + ``rt_decode_words``
  (``storage/_native.decode_words_into``): the form import-roaring
  merges, since a 64-row payload of a 2^20-column shard merges from words
  in about 15 ms and from its 16.8 M positions in about 0.86 s (one CPU
  core), the positions made in another 0.13 s.

There is no plain-Python decode here: the codec builds at first use or
raises.

The pool is deliberately bounded: ``acquire`` blocks when every buffer
is out, which is the decode stage's backpressure (an import can decode
at most ``buffers`` batches ahead of the apply stage). The positions are
host data the apply stage merges into the fragments' host mirrors; the
copies to the card go through the uploader's pinned slots
(``ingest/pipeline.py``, ``ops/streams.py``).
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np

from pilosa_tpu_torch.storage import _native, roaring

# Default buffer capacity in positions (8 bytes each).  Sized for one
# bulk-import batch of a few hundred thousand bits; acquire() grows a
# buffer in place when a bigger blob arrives, and the growth sticks for
# the buffer's lifetime (steady state: no further allocation).
DEFAULT_CAPACITY = 1 << 20


class StagingBuffer:
    """One reusable decode target.  ``positions`` is a view of the
    filled prefix after ``decode``; ``release`` returns the buffer to
    its pool (idempotent)."""

    def __init__(self, pool: "StagingPool", capacity: int):
        self._pool = pool
        self.data = np.empty(capacity, dtype=np.uint64)
        self.n = 0
        # the row-words form (decode_rows): words grown on demand, and the
        # decoded rows' ids
        self.words = np.empty(0, dtype=np.uint32)
        self.row_ids = np.empty(0, dtype=np.uint64)
        self.rows = np.empty((0, 0), dtype=np.uint32)
        self._held = False

    @property
    def capacity(self) -> int:
        return int(self.data.size)

    @property
    def positions(self) -> np.ndarray:
        return self.data[: self.n]

    def ensure(self, capacity: int) -> None:
        if self.data.size < capacity:
            self.data = np.empty(int(capacity), dtype=np.uint64)

    def decode(self, data: bytes) -> int:
        """Decode a Roaring blob into this buffer; returns the position
        count.  Raises roaring.RoaringError on a malformed payload and
        ValueError (the capacity needed last in its message) when the
        buffer is too small."""
        if len(data) < 8:
            raise roaring.RoaringError("file too short")
        out = _native.deserialize_into(data, self.data)
        if out is None:
            raise roaring._parse_error(data)
        self.n = out[0]
        return self.n

    def decode_grow(self, data: bytes) -> int:
        """``decode`` with the grow-and-retry loop for blobs bigger than
        the buffer (native reports the required capacity)."""
        try:
            return self.decode(data)
        except ValueError as e:
            need = int(str(e).rsplit(" ", 1)[-1])
            self.ensure(max(need, self.capacity * 2))
            return self.decode(data)

    def decode_rows(self, data: bytes, n_words: int) -> int:
        """Decode a Roaring blob into row words in this buffer: ``row_ids``
        (ascending, uint64) and ``rows`` (a ``uint32 [n, n_words]`` view of
        the reusable ``words``), rows left without a bit dropped; returns the
        row count. The buffer grows to the largest payload and keeps that
        size. Raises roaring.RoaringError on a malformed payload."""
        if len(data) < 8:
            raise roaring.RoaringError("file too short")
        while True:
            try:
                out = _native.decode_words_into(data, n_words, self.words)
                break
            except ValueError as e:
                need = int(str(e).rsplit(" ", 1)[-1])
                self.words = np.empty(max(need, 2 * self.words.size), dtype=np.uint32)
        if out is None:
            raise roaring._parse_error(data)
        row_ids, rows, _ = out
        keep = rows.any(axis=1)
        if not keep.all():
            row_ids, rows = row_ids[keep], rows[keep]
        self.row_ids, self.rows = row_ids, rows
        return int(row_ids.size)

    def release(self) -> None:
        self._pool._release(self)


class StagingPool:
    """Bounded pool of StagingBuffers; ``acquire`` blocks when empty."""

    def __init__(
        self,
        buffers: int = 4,
        capacity: int = DEFAULT_CAPACITY,
        stats=None,
    ):
        self.size = max(1, int(buffers))
        self.stats = stats
        self._free: queue.Queue = queue.Queue(maxsize=self.size)
        self._lock = threading.Lock()
        self._outstanding = 0
        self.acquires = 0
        self.blocked_acquires = 0
        self.blocked_seconds = 0.0
        for _ in range(self.size):
            self._free.put(StagingBuffer(self, int(capacity)))

    def acquire(self, timeout: float | None = None) -> StagingBuffer:
        """Take a buffer, blocking while all are out (decode-stage
        backpressure).  Raises queue.Empty on timeout."""
        try:
            buf = self._free.get_nowait()
        except queue.Empty:
            self.blocked_acquires += 1
            t0 = time.perf_counter()
            buf = self._free.get(timeout=timeout)
            dt = time.perf_counter() - t0
            self.blocked_seconds += dt
            if self.stats is not None:
                self.stats.timing("ingest_staging_blocked", dt)
        buf.n = 0
        buf._held = True
        with self._lock:
            self._outstanding += 1
        self.acquires += 1
        if self.stats is not None:
            self.stats.gauge("ingest_staging_outstanding", self.outstanding)
        return buf

    def _release(self, buf: StagingBuffer) -> None:
        with self._lock:
            if not buf._held:
                return  # idempotent: error paths release defensively
            buf._held = False
            self._outstanding -= 1
        self._free.put(buf)
        if self.stats is not None:
            self.stats.gauge("ingest_staging_outstanding", self.outstanding)

    @property
    def outstanding(self) -> int:
        with self._lock:
            return self._outstanding

    def snapshot(self) -> dict:
        return {
            "buffers": self.size,
            "outstanding": self.outstanding,
            "acquires": self.acquires,
            "blockedAcquires": self.blocked_acquires,
            "blockedSeconds": round(self.blocked_seconds, 6),
        }
