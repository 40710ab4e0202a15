"""Per-fragment persistence: roaring snapshot + append-only op log
(counterpart of ``pilosa_tpu/storage/fragmentfile.py``).

The reference persists each fragment as one roaring file whose container
section is a snapshot and whose tail is an op log; mutations append ops and
the whole file is atomically rewritten once ``opN > MaxOpN`` (reference
fragment.go:84 MaxOpN=10000, :311-456 openStorage, :2325-2381 snapshot via
temp file + rename, docs/architecture.md). Same model here, writing from
the fragment's host mirror. The files are the JAX package's, byte for
byte; opening one decodes it straight into the mirror's row words with the
native codec (``roaring.decode_rows``), with no positions array.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time

import numpy as np

from pilosa_tpu_torch.core.fragment import Fragment
from pilosa_tpu_torch.ops import _hostops
from pilosa_tpu_torch.storage import roaring
# the fault registry's hook point (testing/faults.py): with a registry
# installed, a matching rule raises OSError before an op-log or snapshot
# write, as a full disk would
from pilosa_tpu_torch.testing.faults import disk_write_fault

logger = logging.getLogger(__name__)

# reference fragment.go:84.
MAX_OP_N = 10000

# WAL fsync policy — see _append_many.  "snapshot" (default, reference
# durability parity) | "batch" (fsync every WAL batch).
WAL_FSYNC = os.environ.get("PILOSA_TPU_WAL_FSYNC", "snapshot")

# Batch ops chunk size (records of at most this many positions, as JAX).
_BATCH_CHUNK = 65536

# The journal record of a snapshot (the JAX package's obs/events.py type).
EVENT_SNAPSHOT = "snapshot"



class FragmentFile:
    """Owns the on-disk file of one fragment."""

    def __init__(
        self,
        fragment: Fragment,
        path: str,
        snapshot_queue: "SnapshotQueue | None" = None,
        journal=None,
    ):
        self.fragment = fragment
        self.path = path
        self.snapshot_queue = snapshot_queue
        self.journal = journal  # .record(type, **data) per snapshot, or None
        self.last_snapshot_at: float | None = None
        self._lock = threading.Lock()
        self._fh = None
        self._closed = False
        self.op_n = 0
        # monotonic append counter — unlike op_n it NEVER resets, so the
        # optimistic snapshot's "no op landed since my copy" check can't
        # be fooled by op_n cycling back to the same value (ABA) after a
        # concurrent snapshot reset it
        self.mut_seq = 0
        # per-mutation op batching (begin_batch/end_batch): buffered
        # positions flushed as single batch records. Caller guarantees the
        # add and remove sets of one batch are disjoint (true for all
        # Fragment mutators).
        self._batch_depth = 0
        self._batch_add: list[np.ndarray] = []
        self._batch_remove: list[np.ndarray] = []
        # Migration delta taps (cluster/migration.py): while a shard
        # streams to a new owner, a tap
        # pinned here mirrors every appended record so the target can
        # replay writes that landed after its snapshot cut.  Fed under the
        # store lock — tap order matches file order exactly.
        self._taps: list = []
        fragment.store = self

    # -- load ---------------------------------------------------------------

    def open(self) -> None:
        """Load snapshot + replay op log into the fragment's host mirror,
        decoded straight into its row words."""
        if not os.path.exists(self.path) or os.path.getsize(self.path) == 0:
            # seed with an empty-bitmap header so the file always starts
            # with a valid snapshot section (the reference writes the
            # bitmap before appending ops, fragment.go:311-456)
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            with open(self.path, "wb") as f:
                f.write(roaring.serialize(np.empty(0, dtype=np.uint64)))
        if os.path.exists(self.path):
            with open(self.path, "rb") as f:
                data = f.read()
            if data:
                row_ids, words, self.op_n = roaring.decode_rows(
                    data, self.fragment.n_words
                )
                self.fragment.load_rows_matrix(row_ids.tolist(), words)
        self._fh = open(self.path, "ab")

    # -- op append ----------------------------------------------------------

    def _positions(self, row: int, mask: np.ndarray) -> np.ndarray:
        self.check_row(row)
        return _hostops.extract_positions(mask, row * self.fragment.shard_width)

    def _append(self, record: bytes, count: int) -> None:
        self._append_many([record], count)

    def _append_many(self, records: list[bytes], count: int) -> None:
        """Append several records with ONE flush (each record carries
        its own checksum, so a torn tail replays cleanly).

        fsync policy (``PILOSA_TPU_WAL_FSYNC``): the default
        ``snapshot`` syncs only snapshot files — exactly the
        reference's durability (its op-log writes land in the OS page
        cache with no Sync, roaring.go:1655 writeOp; only snapshot
        rewrites fsync, fragment.go:2750), so a process crash loses
        nothing and an OS/power crash can lose ops since the last
        snapshot.  ``batch`` additionally fsyncs every WAL batch —
        stronger than the reference, at the cost of one sync per batch."""
        if not records:
            return
        # fault hook: an OSError here surfaces through the write path the
        # way a real ENOSPC would
        disk_write_fault(self.path)
        with self._lock:
            if self._fh is None:
                self._fh = open(self.path, "ab")
            for record in records:
                self._fh.write(record)
            self._fh.flush()
            if WAL_FSYNC == "batch":
                os.fsync(self._fh.fileno())
            self.op_n += count
            self.mut_seq += 1
            for tap in self._taps:
                tap.feed(records, count)
        if self.op_n > MAX_OP_N:
            self.request_snapshot()

    # -- migration taps -----------------------------------------------------

    def add_tap(self, tap) -> None:
        with self._lock:
            self._taps.append(tap)

    def remove_tap(self, tap) -> None:
        with self._lock:
            try:
                self._taps.remove(tap)
            except ValueError:
                pass

    def tapped(self) -> bool:
        """Whether a migration tap is pinned here."""
        with self._lock:
            return bool(self._taps)

    def check_row(self, row: int) -> None:
        """Raise BEFORE any mutation if a row id cannot be persisted
        (positions are row*width+col in uint64, so rows are bounded at
        ~2^44 for the default width once a store is attached)."""
        width = self.fragment.shard_width
        if row > (2**64 - 1) // width:
            raise ValueError(
                f"row id {row} too large to persist at shard width {width}"
            )

    def _pos(self, row: int, col: int) -> int:
        self.check_row(row)
        return row * self.fragment.shard_width + col

    # -- batching ----------------------------------------------------------

    def begin_batch(self) -> None:
        self._batch_depth += 1

    def end_batch(self) -> None:
        self._batch_depth -= 1
        if self._batch_depth > 0:
            return
        adds, self._batch_add = self._batch_add, []
        removes, self._batch_remove = self._batch_remove, []
        # Group-commit: the whole batch — add AND remove records — lands
        # in ONE locked append/flush (and one fsync under the "batch"
        # WAL policy), so a pipeline-merged apply costs a single op-log
        # write no matter how many imports coalesced into it.
        records: list[bytes] = []
        count = 0
        if adds:
            positions = np.concatenate(adds)
            records += self._batch_records(roaring.OP_ADD_BATCH, positions)
            count += len(positions)
        if removes:
            positions = np.concatenate(removes)
            records += self._batch_records(roaring.OP_REMOVE_BATCH, positions)
            count += len(positions)
        if records:
            self._append_many(records, count)

    def _batch_records(self, op_type: int, positions: np.ndarray) -> list[bytes]:
        # the chunks' records in one buffer (each keeps its own checksum)
        blob = roaring.encode_batch_ops(op_type, positions, _BATCH_CHUNK)
        return [blob] if blob.size else []

    def _emit_batch(self, op_type: int, positions: np.ndarray) -> None:
        self._append_many(
            self._batch_records(op_type, positions), len(positions)
        )

    def log_add(self, row: int, col: int) -> None:
        pos = self._pos(row, col)
        if self._batch_depth:
            self._batch_add.append(np.array([pos], dtype=np.uint64))
            return
        self._append(roaring.encode_op(roaring.OP_ADD, pos), 1)

    def log_remove(self, row: int, col: int) -> None:
        pos = self._pos(row, col)
        if self._batch_depth:
            self._batch_remove.append(np.array([pos], dtype=np.uint64))
            return
        self._append(roaring.encode_op(roaring.OP_REMOVE, pos), 1)

    def log_add_mask(self, row: int, mask: np.ndarray) -> None:
        positions = self._positions(row, mask)
        if self._batch_depth:
            self._batch_add.append(positions)
            return
        self._emit_batch(roaring.OP_ADD_BATCH, positions)

    def log_remove_mask(self, row: int, mask: np.ndarray) -> None:
        positions = self._positions(row, mask)
        if self._batch_depth:
            self._batch_remove.append(positions)
            return
        self._emit_batch(roaring.OP_REMOVE_BATCH, positions)

    def log_add_positions(self, positions: np.ndarray) -> None:
        """Bulk-add op records from PRE-COMPUTED absolute positions —
        the sustained-ingest hot path (Fragment.import_bits derives the
        changed positions as a by-product of its merge, so no mask
        unpack happens here; reference roaring.go:1463's rowSet change
        tracking plays the same role).  Caller has check_row'd the rows."""
        positions = np.ascontiguousarray(positions, dtype=np.uint64)
        if self._batch_depth:
            self._batch_add.append(positions)
            return
        self._emit_batch(roaring.OP_ADD_BATCH, positions)

    def log_remove_positions(self, positions: np.ndarray) -> None:
        positions = np.ascontiguousarray(positions, dtype=np.uint64)
        if self._batch_depth:
            self._batch_remove.append(positions)
            return
        self._emit_batch(roaring.OP_REMOVE_BATCH, positions)

    # -- snapshot -----------------------------------------------------------

    def request_snapshot(self) -> None:
        if self.snapshot_queue is not None:
            self.snapshot_queue.enqueue(self)
        else:
            self.snapshot()

    # optimistic snapshot attempts before falling back to holding the
    # fragment lock for the whole rewrite (continuous writers would
    # otherwise livelock the retry loop)
    _SNAPSHOT_RETRIES = 3

    def snapshot(self) -> None:
        """Atomic rewrite: temp file + rename (reference
        fragment.go:2335-2381).

        The expensive work (position extraction + roaring encode + fsync)
        runs WITHOUT the fragment lock, from a copied state — a snapshot
        worker must not stall concurrent queries/ingest for the whole
        rewrite. The swap then happens under the lock only if no op was
        appended since the copy (an op landing in between would be in the
        fragment's mirror but lost from the replaced file's op log);
        otherwise retry with a fresh copy, degrading to the fully locked
        path after _SNAPSHOT_RETRIES so a continuous writer can't
        livelock us. Lock order fragment->store matches the writer path."""
        for attempt in range(self._SNAPSHOT_RETRIES + 1):
            locked_rewrite = attempt == self._SNAPSHOT_RETRIES
            with self.fragment._lock:
                if locked_rewrite:
                    # final attempt: hold the lock across extract + swap
                    with self._lock:
                        if self._closed:
                            return
                        self._write_snapshot_file(
                            self._encode_rows(*self.fragment.snapshot_rows())
                        )
                        return
                with self._lock:
                    if self._closed:
                        # A snapshot queued before the store was detached
                        # (e.g. the fragment was dropped by resize
                        # cleanup) must not resurrect the deleted file.
                        return
                    seq_at = self.mut_seq
                rids, rwords = self.fragment.snapshot_rows()
            data = self._encode_rows(rids, rwords)
            with self.fragment._lock, self._lock:
                if self._closed:
                    return
                if self.mut_seq != seq_at:
                    continue  # an op landed mid-encode; redo from fresh state
                self._write_snapshot_file(data)
                return

    def _write_snapshot_file(self, data: bytes) -> None:
        """Swap in an encoded snapshot (both locks held)."""
        disk_write_fault(self.path)
        tmp = self.path + ".snapshotting"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        if self._fh is not None:
            self._fh.close()
        os.replace(tmp, self.path)
        self._fh = open(self.path, "ab")
        ops_compacted = self.op_n
        self.op_n = 0
        self.last_snapshot_at = time.time()
        if self.journal is not None:
            frag = self.fragment
            self.journal.record(
                EVENT_SNAPSHOT,
                path=self.path,
                bytes=len(data),
                ops_compacted=ops_compacted,
                shard=getattr(frag, "shard", None),
            )

    def _encode_rows(self, rids: np.ndarray, rwords: np.ndarray) -> bytes:
        """Snapshot bytes for ascending row ids + stacked words: the native
        words->roaring streaming encoder."""
        return roaring.serialize_rows(rids, rwords)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            if self._fh is not None:
                # Under WAL_FSYNC='snapshot' appended ops are only
                # flushed to the page cache; a crash right after a clean
                # close would lose the op-log tail.  Sync on the way out.
                try:
                    self._fh.flush()
                    os.fsync(self._fh.fileno())
                except (OSError, ValueError):
                    pass  # best-effort: close() must not raise on shutdown
                self._fh.close()
                self._fh = None


class SnapshotQueue:
    """Background snapshot pool (reference fragment.go:185-239: depth 100,
    2 workers, await support)."""

    def __init__(self, workers: int = 2, depth: int = 100):
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._pending: set[int] = set()
        self._lock = threading.Lock()
        self._workers = [
            threading.Thread(target=self._run, daemon=True) for _ in range(workers)
        ]
        for w in self._workers:
            w.start()

    def enqueue(self, store: FragmentFile) -> None:
        with self._lock:
            if id(store) in self._pending:
                return
            self._pending.add(id(store))
        try:
            self._queue.put_nowait(store)
        except queue.Full:
            # queue full: snapshot synchronously (reference enqueues
            # blockingly; sync fallback keeps the writer moving)
            with self._lock:
                self._pending.discard(id(store))
            store.snapshot()

    def _run(self) -> None:
        while True:
            store = self._queue.get()
            if store is None:
                return
            try:
                store.snapshot()
            except Exception:
                # e.g. the fragment's directory was deleted mid-flight;
                # never let a failed snapshot kill the worker
                logger.exception("snapshot failed for %s", store.path)
            finally:
                with self._lock:
                    self._pending.discard(id(store))
                self._queue.task_done()

    def await_all(self) -> None:
        self._queue.join()

    def stop(self) -> None:
        for _ in self._workers:
            self._queue.put(None)
