"""Source-side state for online fragment migration (counterpart of
``pilosa_tpu/cluster/migration.py``, the port's own copy).

The resize protocol (cluster/resize.py) moves a fragment to its new
owner without gating writes: the target streams a snapshot cut in
resumable chunks while writes keep landing on the source, then replays
the op-log delta accrued since the cut in bounded catch-up rounds.
This module is the source half of that protocol:

* ``DeltaTap`` — pinned on the fragment's op-log append point
  (``storage/fragmentfile.py:_append_many``); mirrors every appended
  record in order, so the delta stream replays in exactly file order.
* ``MemoryTapLog`` — a store shim for memory-only fragments (most test
  clusters run storeless: ``fragment.store is None``).  It reuses the
  real ``FragmentFile`` batching machinery but appends to taps only —
  attached for the duration of a migration, detached at end.
* ``MigrationSession`` / ``MigrationRegistry`` — one session per
  in-flight fragment transfer, keyed by an opaque token.  The session
  pins the serialized snapshot (chunk reads are idempotent, so a
  crashed target resumes at its last offset) and the tap.  Sessions
  expire after a TTL so a target that died mid-transfer cannot leak
  taps forever.

Correctness of the cut: the tap is installed *before* the snapshot is
serialized (both under the fragment lock order), so every op is either
in the snapshot, in the tap, or both.  Replaying the tap in order on
top of the snapshot therefore converges to the source state — ops
present in both are harmless because replay applies them in the same
order the source did.
"""

from __future__ import annotations

import itertools
import threading
import time

from pilosa_tpu_torch.storage import roaring
from pilosa_tpu_torch.storage.fragmentfile import FragmentFile

# Default transfer chunk; targets may request smaller (tests exercise
# multi-chunk resume with tiny chunks). JAX's is 1 MiB; a 64-row fragment
# at 2^20 columns and the serving density is about 8.4 MB, so the port's
# target asks for 8 MiB and such a fragment moves in one or two requests.
CHUNK_BYTES = 8 << 20

# A session untouched this long is presumed owned by a dead target.
SESSION_TTL = 120.0


class DeltaTap:
    """Ordered accumulator of raw op-log records (bytes)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._records: list[bytes] = []
        self._count = 0

    def feed(self, records: list[bytes], count: int) -> None:
        # called under the store lock; must be cheap and never raise
        with self._lock:
            self._records.extend(records)
            self._count += count

    def drain(self) -> tuple[bytes, int]:
        """Take everything accumulated so far -> (blob, op_count)."""
        with self._lock:
            records, self._records = self._records, []
            count, self._count = self._count, 0
        return b"".join(records), count

    @property
    def pending(self) -> int:
        with self._lock:
            return self._count


class MemoryTapLog(FragmentFile):
    """Store shim for storeless fragments: the full FragmentFile
    batching/encoding pipeline with the disk append replaced by
    tap-only delivery.  Never touches the filesystem."""

    def __init__(self, fragment):
        # deliberately NOT FragmentFile.__init__: no path, no file
        # handle, and crucially no ``fragment.store = self`` — attach()
        # installs us under the fragment lock.
        self.fragment = fragment
        self.path = "<memory-tap>"
        self.snapshot_queue = None
        self.journal = None
        self.last_snapshot_at = None
        self._lock = threading.Lock()
        self._fh = None
        self._closed = False
        self.op_n = 0
        self.mut_seq = 0
        self._batch_depth = 0
        self._batch_add = []
        self._batch_remove = []
        self._taps = []

    def _append_many(self, records: list[bytes], count: int) -> None:
        if not records:
            return
        with self._lock:
            self.op_n += count
            self.mut_seq += 1
            for tap in self._taps:
                tap.feed(records, count)

    def request_snapshot(self) -> None:
        pass

    def snapshot(self) -> None:
        pass

    def close(self) -> None:
        pass


class MigrationSession:
    """One in-flight fragment transfer, source side."""

    def __init__(self, token: str, fragment, frag_key: tuple):
        self.token = token
        self.fragment = fragment
        self.frag_key = frag_key  # (index, field, view, shard)
        self.tap = DeltaTap()
        self._memlog: MemoryTapLog | None = None
        self._store = None
        self.last_access = time.monotonic()
        self._closed = False
        self.chunk_bytes: int | None = None  # target-requested override
        # Install the tap BEFORE cutting the snapshot: under the
        # fragment lock no op can land between tap install and the cut,
        # so the tap + snapshot together cover every op.
        with fragment._lock:
            store = fragment.store
            if store is None:
                self._memlog = MemoryTapLog(fragment)
                fragment.store = self._memlog
                store = self._memlog
            self._store = store
            store.add_tap(self.tap)
            # the native codec streams the cut straight off the mirror's
            # row words (byte-identical to serializing its positions)
            self.snapshot = roaring.serialize_rows(*fragment.snapshot_rows())
        self.size = len(self.snapshot)

    def touch(self) -> None:
        self.last_access = time.monotonic()

    def chunk(self, offset: int, length: int) -> bytes:
        self.touch()
        offset = max(0, int(offset))
        return self.snapshot[offset : offset + max(1, int(length))]

    def delta(self) -> tuple[bytes, int, int]:
        """One catch-up round: (blob, ops_in_blob, ops_still_pending)."""
        self.touch()
        blob, count = self.tap.drain()
        return blob, count, self.tap.pending

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        with self.fragment._lock:
            if self._store is not None:
                self._store.remove_tap(self.tap)
            if self._memlog is not None and self.fragment.store is self._memlog:
                # detach the shim only if no real store replaced it and
                # no other session still needs it
                if not self._memlog._taps:
                    self.fragment.store = None
        self.snapshot = b""


class MigrationRegistry:
    """Per-node table of live migration sessions (source side)."""

    _ids = itertools.count(1)

    def __init__(self, node_id: str = "", ttl: float = SESSION_TTL):
        self.node_id = node_id
        self.ttl = ttl
        self._lock = threading.Lock()
        self._sessions: dict[str, MigrationSession] = {}

    def begin(self, fragment, frag_key: tuple) -> MigrationSession:
        self._sweep()
        token = f"mig-{self.node_id}-{next(self._ids)}"
        session = MigrationSession(token, fragment, frag_key)
        with self._lock:
            self._sessions[token] = session
        return session

    def get(self, token: str) -> MigrationSession:
        with self._lock:
            session = self._sessions.get(token)
        if session is None:
            raise KeyError(f"unknown migration session: {token}")
        session.touch()
        return session

    def end(self, token: str) -> None:
        with self._lock:
            session = self._sessions.pop(token, None)
        if session is not None:
            session.close()

    def _sweep(self) -> None:
        """Expire sessions whose target stopped pulling (died mid-copy):
        a leaked tap would buffer deltas forever."""
        now = time.monotonic()
        with self._lock:
            dead = [
                t for t, s in self._sessions.items()
                if now - s.last_access > self.ttl
            ]
            expired = [self._sessions.pop(t) for t in dead]
        for s in expired:
            s.close()

    def snapshot_summary(self) -> dict:
        with self._lock:
            return {
                "active": len(self._sessions),
                "sessions": [
                    {
                        "token": s.token,
                        "fragment": list(s.frag_key),
                        "bytes": s.size,
                        "pendingOps": s.tap.pending,
                    }
                    for s in self._sessions.values()
                ],
            }

    def close(self) -> None:
        with self._lock:
            sessions = list(self._sessions.values())
            self._sessions.clear()
        for s in sessions:
            s.close()
