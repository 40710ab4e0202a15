"""Fragment: the (index, field, view, shard) storage unit (counterpart of
``pilosa_tpu/core/fragment.py``).

A fragment is a dense bitmap of ``capacity`` rows by ``n_words`` words:

* **host mirror** ``uint32[capacity, W]`` (numpy) — the authoritative copy.
  Mutations apply here first, with exact changed-bit accounting and no
  device round trip.
* **device copy** ``int32[capacity+1, W]`` (torch, on the fragment's
  device) — the compute copy, a bit-identical view of the mirror, synced
  lazily by :meth:`Fragment.device_bits`. Dirty rows go up with one
  in-place ``index_copy_``; a capacity change uploads the whole mirror.
  The final row is permanently zero, so a missing row id gathers it.
  The copy is admitted to the process device-memory budget
  (``core/membudget.py``), which may evict it (the tensor is dropped and
  the next sync uploads it again); a fragment whose copy alone would
  exceed the cap is *declined* and pages the rows a caller asks for from
  the mirror instead (:meth:`row_device`, :meth:`rows_device`).
  A sync may run on the ingest uploader's side stream
  (``ingest/pipeline.py``): the copy then goes through pinned slots, a
  resident copy's dirty rows are patched out of place, and the copy keeps
  the event after it, which every later reader's stream waits for
  (``ops/streams.py``).

Row ids are arbitrary uint64, so the row axis is sparse (row id -> slot
through a dict, capacity grown in powers of two) and the column axis
dense. Per-row counts are maintained across writes, so an unfiltered
TopN needs no device work (reference cache.go, fragment.go:698-712).

A fragment of an int field's ``bsig_<field>`` view holds its values
bit-sliced (reference fragment.go:90-96): row 0 the exists bit, row 1 the
sign bit, rows 2.. the magnitude planes, LSB first. The stored value is
``value - base``; the sign row marks stored < 0 and the planes hold
``abs(stored)``.

With a ``store`` attached (``storage.fragmentfile.FragmentFile``) every
mutation appends op records to the fragment's file as the JAX fragment's
does, record for record (reference fragment.go:453 storage.OpWriter): row
ids are checked before anything changes, and one logical mutation's bits
go out as batch records.
"""

from __future__ import annotations

import itertools
import threading
import weakref
from contextlib import contextmanager
from typing import Iterable

import numpy as np
import torch

from pilosa_tpu_torch import device as device_mod
from pilosa_tpu_torch.core import membudget, residency
from pilosa_tpu_torch.ops import _hostops, bitops, streams
from pilosa_tpu_torch.shardwidth import SHARD_WORDS

# BSI row layout within a bsig_* view (reference fragment.go:90-96).
BSI_EXISTS_BIT = 0
BSI_SIGN_BIT = 1
BSI_OFFSET_BIT = 2

# Rows per anti-entropy checksum block (reference fragment.go:81).
HASH_BLOCK_SIZE = 100

_MIN_CAPACITY = 8


class FragmentInvariantError(AssertionError):
    """Internal coherence violation between slot map, host mirror and
    device copy (reference Container.check, roaring.go:2967-3028)."""


def _retry_evict(ref) -> None:
    """Complete a deferred budget eviction from a thread that holds no
    fragment lock, so a blocking acquire is safe here."""
    f = ref()
    if f is None:
        return
    with f._lock:
        if f._evict_pending:
            f._evict_pending = False
            # the flag may be stale (a sync re-admitted the copy since);
            # the accounting follows the copy dropped here either way
            f._drop_device()


class Fragment:
    """Dense bitmap tensor for one (index, field, view, shard)."""

    _epoch_counter = itertools.count()

    def __init__(
        self,
        index: str = "",
        field: str = "",
        view: str = "",
        shard: int = 0,
        n_words: int = SHARD_WORDS,
        device: str | torch.device | None = None,
    ):
        self.index = index
        self.field = field
        self.view = view
        self.shard = shard
        self.n_words = n_words
        self.shard_width = n_words * 32
        self.device = device_mod.resolve(device)

        self._lock = threading.RLock()
        self._slot_of: dict[int, int] = {}  # row id -> slot
        self._rowids: list[int] = []  # slot -> row id
        self._set_host(np.zeros((0, n_words), dtype=np.uint32))
        self._device: torch.Tensor | None = None  # graftlint: disable=residency-discipline -- the residency manager's own field: a new fragment starts with no device tier
        # the event after the device copy's side-stream upload (None when
        # it was made on the default stream): readers wait for it
        self._device_ready = None
        # bytes shipped host -> device by the latest device_bits() sync (0
        # when the copy was current); the ingest uploader counts them
        self.last_sync_h2d_bytes = 0
        # ((epoch, version), stats) of container_profile, and of blocks()
        self._container_profile = None
        self._blocks_cache = None
        self._dirty: set[int] = set()
        self._counts: np.ndarray | None = None  # per-slot cached popcounts
        # Monotonic mutation counter; with the process-unique epoch it
        # keys the executor's stack cache (a re-created fragment restarts
        # at version 0, so the number alone could alias).
        self.version = 0
        self.epoch = next(self._epoch_counter)
        # the device copy's key in the process budget (membudget), made at
        # the first sync; released when the copy is dropped or the
        # fragment is collected
        self._budget_key = None
        # set by the budget's evict callback when it could not take the
        # lock; honoured at the next sync or by a retry thread
        self._evict_pending = False
        # residency state owned by core/residency.py: decayed hit heat,
        # prefetch flags and a mirror of the budget's pin bit
        self._heat = 0.0
        self._heat_t = 0.0
        self._res_staging = False
        self._res_prefetched = False
        self._res_pinned = False
        # optional storage.FragmentFile: mutations append to its op log
        # (reference fragment.go:453 storage.OpWriter). Lock order is
        # always fragment._lock (outer) -> store lock (inner).
        self.store = None

    def _set_host(self, arr: np.ndarray) -> None:
        """The only way to (re)assign the host mirror: keeps the cached
        base address in step (the host tier builds a row address per
        shard from ``_host_addr``; a reassignment that forgot it would hand
        the native kernel a pointer into the freed old buffer)."""
        self._host = arr
        self._host_addr = arr.__array_interface__["data"][0]

    # -- row bookkeeping ----------------------------------------------------

    @property
    def capacity(self) -> int:
        return self._host.shape[0]

    def row_ids(self) -> list[int]:
        """Sorted ids of rows that physically exist (may include all-zero
        rows that were written then cleared)."""
        with self._lock:
            return sorted(self._slot_of)

    def _grow(self, need: int) -> None:
        cap = max(_MIN_CAPACITY, self.capacity)
        while cap < need:
            cap *= 2
        if cap != self.capacity:
            grown = np.zeros((cap, self.n_words), dtype=np.uint32)
            grown[: self.capacity] = self._host
            self._set_host(grown)
            self._drop_device()  # full re-upload on next sync

    def _slots_batch(self, row_ids: np.ndarray) -> np.ndarray:
        """Slots for every row id (ascending unique array), creating
        missing ones with one capacity grow (caller holds the lock)."""
        out = np.empty(row_ids.size, dtype=np.int64)
        missing = []
        for i, r in enumerate(row_ids):
            s = self._slot_of.get(int(r))
            if s is None:
                missing.append(i)
            else:
                out[i] = s
        if missing:
            self._grow(len(self._rowids) + len(missing))
            for i in missing:
                r = int(row_ids[i])
                s = len(self._rowids)
                self._slot_of[r] = s
                self._rowids.append(r)
                out[i] = s
            self._counts = None
        return out

    def _slot(self, row: int, create: bool = False) -> int | None:
        s = self._slot_of.get(row)
        if s is None and create:
            s = len(self._rowids)
            self._grow(s + 1)
            self._slot_of[row] = s
            self._rowids.append(row)
            self._counts = None
        return s

    def _drop_device(self) -> None:
        """Drop the device copy and its budget accounting (caller holds the
        lock); the host mirror stays authoritative."""
        self._device = None  # graftlint: disable=residency-discipline -- _drop_device is the manager's demote transition: the budget entry is released and the tracker told just below
        self._device_ready = None
        self._dirty.clear()
        if self._budget_key is not None:
            membudget.default_budget(self.device).release(self._budget_key)
        residency.default_tracker().note_dropped(self)

    def release_device(self) -> None:
        """Drop the device copy and release its budget bytes (the fragment
        is leaving this node); the host mirror stays."""
        with self._lock:
            self._drop_device()

    # -- mutation -----------------------------------------------------------

    def _touch(self, slot: int) -> None:
        self._dirty.add(slot)
        self._counts = None
        self.version += 1

    def _counts_delta(self, counts0, slots, deltas) -> None:
        """Carry the cached per-slot popcounts across a write (caller
        holds the lock and captured ``counts0 = self._counts`` BEFORE
        mutating — _touch/_slot null it), zero-padding for rows created
        by the write."""
        if counts0 is None:
            return
        n = len(self._rowids)
        if len(counts0) < n:
            counts0 = np.concatenate(
                [counts0, np.zeros(n - len(counts0), dtype=np.int64)]
            )
        counts0[slots] += deltas
        self._counts = counts0

    def _check_persistable(self, row: int) -> None:
        """With a store attached, reject a row id it cannot persist BEFORE
        mutating, so the mirror and the op log cannot diverge."""
        if self.store is not None:
            self.store.check_row(row)

    @contextmanager
    def _batched_store(self):
        """Coalesce one logical mutation's ops into batch records (one
        locked append instead of one write and flush per bit)."""
        if self.store is None:
            yield
            return
        self.store.begin_batch()
        try:
            yield
        finally:
            self.store.end_batch()

    def set_bit(self, row: int, col: int) -> bool:
        """Set bit (row, col-offset); True if it changed (reference
        fragment.go:645-713)."""
        with self._lock:
            self._check_persistable(row)
            counts0 = self._counts
            s = self._slot(row, create=True)
            w, b = col >> 5, np.uint32(1 << (col & 31))
            if self._host[s, w] & b:
                return False
            self._host[s, w] |= b
            self._touch(s)
            self._counts_delta(counts0, s, 1)
            if self.store is not None:
                self.store.log_add(row, col)
            return True

    def clear_bit(self, row: int, col: int) -> bool:
        with self._lock:
            s = self._slot(row)
            if s is None:
                return False
            w, b = col >> 5, np.uint32(1 << (col & 31))
            if not self._host[s, w] & b:
                return False
            counts0 = self._counts
            self._host[s, w] &= ~b
            self._touch(s)
            self._counts_delta(counts0, s, -1)
            if self.store is not None:
                self.store.log_remove(row, col)
            return True

    def get_bit(self, row: int, col: int) -> bool:
        with self._lock:
            s = self._slot_of.get(row)
            if s is None:
                return False
            return bool((int(self._host[s, col >> 5]) >> (col & 31)) & 1)

    def rows_with_column(self, col: int) -> list[int]:
        """Row ids containing this column — one vectorized pass over the
        host mirror's column word (the Rows(column=...) filter; reference
        fragment.go:2612-2657 filterColumn, without per-row get_bit)."""
        with self._lock:
            n = len(self._rowids)
            if n == 0:
                return []
            w, b = col >> 5, np.uint32(col & 31)
            mask = (self._host[:n, w] >> b) & np.uint32(1)
            return [self._rowids[s] for s in np.flatnonzero(mask)]

    def set_row_words(self, row: int, words: np.ndarray) -> bool:
        """Replace a whole row (reference fragment.go:781-834 setRow);
        True if the row changed."""
        with self._lock:
            self._check_persistable(row)
            s = self._slot(row, create=True)
            words = np.asarray(words, dtype=np.uint32)
            if np.array_equal(self._host[s], words):
                return False
            old = self._host[s].copy()
            self._host[s] = words
            self._touch(s)
            # logged after the change: a snapshot that the logging triggers
            # then writes the new state, on which these ops replay alike
            if self.store is not None:
                added = words & ~old
                removed = old & ~words
                with self._batched_store():
                    if added.any():
                        self.store.log_add_mask(row, added)
                    if removed.any():
                        self.store.log_remove_mask(row, removed)
            return True

    def clear_row(self, row: int) -> bool:
        return self.set_row_words(row, np.zeros(self.n_words, dtype=np.uint32))

    def import_bits(self, rows: np.ndarray, cols: np.ndarray, clear: bool = False) -> int:
        """Bulk import of (row, col-offset) pairs (reference
        fragment.go:1995-2106 bulkImport), merged into the host mirror in
        one native pass (``hostops.cpp ph_import_merge``, the roaring
        AddN/RemoveN role, reference fragment.go:2052). Returns the
        changed-bit count; :meth:`import_bits_plain` is its numpy plain
        version."""
        return self._import_bits(rows, cols, clear, self._merge_native)

    def import_bits_plain(self, rows: np.ndarray, cols: np.ndarray, clear: bool = False) -> int:
        """Plain version of :meth:`import_bits`: the same bookkeeping with
        the merge done in numpy."""
        return self._import_bits(rows, cols, clear, self._merge_plain)

    def _import_bits(self, rows, cols, clear: bool, merge) -> int:
        rows = np.asarray(rows, dtype=np.uint64)
        cols = np.asarray(cols, dtype=np.int64)
        if rows.size == 0:
            return 0
        with self._lock, self._batched_store():
            counts0 = self._counts  # before slot creation nulls it
            # group by row directly (row*width+col would wrap uint64 for
            # hashed row ids)
            row_ids = np.unique(rows)
            if clear:
                keep = np.array(
                    [int(r) in self._slot_of for r in row_ids], dtype=bool
                )
                if not keep.any():
                    return 0
                if not keep.all():
                    sel = keep[np.searchsorted(row_ids, rows)]
                    rows = rows[sel]
                    cols = cols[sel]
                    row_ids = row_ids[keep]
                for r in row_ids:  # before the change: mirror/log atomicity
                    self._check_persistable(int(r))
                slots = np.array(
                    [self._slot_of[int(r)] for r in row_ids], dtype=np.int64
                )
            else:
                for r in row_ids:
                    self._check_persistable(int(r))
                slots = self._slots_batch(row_ids)
            n_changed, per_row, positions = merge(rows, cols, row_ids, slots, clear)
            if n_changed:
                for i in np.nonzero(per_row)[0]:
                    self._dirty.add(int(slots[i]))
                if self.store is not None:
                    if clear:
                        self.store.log_remove_positions(positions)
                    else:
                        self.store.log_add_positions(positions)
                self._counts_delta(
                    counts0, slots, -per_row if clear else per_row
                )
                self.version += 1
            return int(n_changed)

    def _merge_native(self, rows, cols, row_ids, slots, clear: bool):
        """``(n_changed, per-row changed counts, changed positions)`` of one
        native merge pass over sorted keys (caller holds the lock); the
        positions (``row_id*width + col``, ascending: the op log's records)
        only with a store attached, else None. The keys are
        ``row_id*width + col`` while the largest row id allows it, so no
        inverse pass is needed; else ``row_index*width + col``."""
        width = self.n_words * 32
        if int(row_ids[-1]) <= (2**62) // width:
            key = rows.astype(np.int64) * width + cols
            id_keys = True
        else:
            key = np.searchsorted(row_ids, rows).astype(np.int64) * width + cols
            id_keys = False
        key.sort()
        n_changed, positions, per_row, _ = _hostops.import_merge(
            key, width, self.n_words, slots, row_ids, self._host, clear,
            id_keys=id_keys, want_wal=self.store is not None,
        )
        return n_changed, per_row, positions

    def _merge_plain(self, rows, cols, row_ids, slots, clear: bool):
        """The numpy merge of :meth:`_merge_native`: one sort of compact
        keys gives the dedup, the per-word grouping and the changed bits."""
        width = self.n_words * 32
        inverse = np.searchsorted(row_ids, rows)
        key = inverse.astype(np.int64) * width + cols
        ukey = np.unique(key)
        urow = ukey // width  # index into row_ids/slots
        ucol = ukey % width
        bitvals = np.uint32(1) << (ucol & 31).astype(np.uint32)
        # group bits into their words: wkey = urow*n_words + word
        wkey = ukey >> 5
        starts = np.flatnonzero(np.r_[True, wkey[1:] != wkey[:-1]])
        wordvals = np.bitwise_or.reduceat(bitvals, starts)
        uw = wkey[starts]
        flat = self._host.reshape(-1)
        flat_idx = slots[uw // self.n_words] * self.n_words + uw % self.n_words
        pre_words = flat[flat_idx]
        if clear:
            flat[flat_idx] = pre_words & ~wordvals
        else:
            flat[flat_idx] = pre_words | wordvals
        # per-bit changed flags via the pre-update word of each key
        pre_of_key = pre_words[np.searchsorted(uw, wkey)]
        if clear:
            newly = (pre_of_key & bitvals) != 0
        else:
            newly = (pre_of_key & bitvals) == 0
        n_changed = int(np.count_nonzero(newly))
        per_row = np.bincount(urow[newly], minlength=len(row_ids))
        positions = None
        if self.store is not None:
            positions = (
                row_ids[urow[newly]].astype(np.uint64) * np.uint64(width)
                + ucol[newly].astype(np.uint64)
            )
        return n_changed, per_row, positions

    def _merge_row_words(self, row: int, words: np.ndarray, clear: bool) -> int:
        """OR ``words`` into a row, or clear them from it when ``clear``
        (a missing row is created only to set bits); the changed bits go to
        the op log as one mask record. Returns the changed-bit count."""
        if not clear:
            self._check_persistable(row)
        s = self._slot(row, create=not clear)
        if s is None:
            return 0
        old = self._host[s]
        changed = old & words if clear else words & ~old
        if not changed.any():
            return 0
        self._host[s] = old & ~words if clear else old | words
        self._touch(s)
        if self.store is not None:
            if clear:
                self.store.log_remove_mask(row, changed)
            else:
                self.store.log_add_mask(row, changed)
        return int(np.bitwise_count(changed).sum(dtype=np.int64))

    def import_row_words(self, row_ids: np.ndarray, words: np.ndarray, clear: bool = False) -> int:
        """Merge whole rows: ``words[i]`` (uint32, ``n_words``) OR-ed into row
        ``row_ids[i]``, or cleared from it when ``clear``. Returns the
        changed-bit count, which :meth:`import_bits` of the same bits
        returns: the bulk form of a roaring import, made of words and no
        positions."""
        words = np.asarray(words, dtype=np.uint32)
        changed = 0
        with self._lock, self._batched_store():
            for row, w in zip(np.asarray(row_ids, dtype=np.uint64).tolist(), words):
                changed += self._merge_row_words(int(row), w, clear)
        return changed

    def set_mutex(self, row: int, col: int) -> bool:
        """Mutex-field write: clear col in every other row, set (row, col)
        (reference fragment.go:715-759)."""
        with self._lock, self._batched_store():
            self._check_persistable(row)
            w, b = col >> 5, np.uint32(1 << (col & 31))
            target = self._slot(row, create=True)
            holders = np.flatnonzero(self._host[:, w] & b)
            changed = False
            for s in holders:
                if s != target:
                    changed |= self.clear_bit(self._rowids[int(s)], col)
            changed |= self.set_bit(row, col)
            return changed

    # -- device sync & query views -----------------------------------------

    def _device_nbytes(self) -> int:
        return (self.capacity + 1) * self.n_words * 4

    def device_declined(self) -> bool:
        """True when this fragment's whole device copy alone would exceed
        the budget's cap: callers page rows from the host mirror instead of
        making the copy (the reference's mmap -> file fallback,
        syswrap/mmap.go)."""
        return membudget.default_budget(self.device).would_decline(self._device_nbytes())

    def _budget_evict_cb(self):
        ref = weakref.ref(self)

        def cb():
            f = ref()
            if f is None:
                return
            # NON-BLOCKING acquire: the evicting thread may hold another
            # fragment's lock (its own admit), whose callback may want
            # ours: blocking here could deadlock two fragments. When
            # contended, defer and retry from a fresh thread that holds no
            # lock, so a fragment never queried again still frees the
            # card's memory the budget counted as reclaimed.
            if f._lock.acquire(blocking=False):
                try:
                    # a concurrent sync may have re-admitted the entry
                    # between the budget's pop and this call: drop that
                    # accounting with the copy
                    f._drop_device()
                finally:
                    f._lock.release()
            else:
                f._evict_pending = True
                t = threading.Timer(0.05, _retry_evict, args=(ref,))
                t.daemon = True
                t.start()

        return cb

    def _account_device(self, rebuilt: bool) -> None:
        """Admit (after an upload) or touch (on a hit) the device copy in
        the process budget (caller holds the lock; the budget's lock nests
        inside)."""
        budget = membudget.default_budget(self.device)
        if self._budget_key is None:
            self._budget_key = membudget.register_owner(self, budget)
        if rebuilt:
            budget.admit(self._budget_key, self._device_nbytes(), self._budget_evict_cb())
        else:
            budget.touch(self._budget_key)

    def device_bits(self) -> torch.Tensor:
        """The compute copy ``int32[capacity+1, W]``; the final row is
        zeros. Syncs pending host mutations first: dirty rows are copied
        into the existing tensor IN PLACE, so a caller holding the tensor
        from an earlier call sees them too. The copy is admitted to the
        budget when uploaded and touched on a hit."""
        with self._lock:
            if self._evict_pending:
                self._evict_pending = False
                self._drop_device()
            was_resident = (
                self._device is not None
                and self._device.shape[0] == self.capacity + 1
            )
            rebuilt = False
            h2d = 0
            if not was_resident:
                padded = np.zeros((self.capacity + 1, self.n_words), dtype=np.uint32)
                padded[: self.capacity] = self._host
                self._device = bitops.to_device(padded, self.device)  # graftlint: disable=residency-discipline -- device_bits is the manager's promote transition: the upload is admitted to the budget by _account_device below
                self._device_ready = streams.ready_event(self.device)
                rebuilt = True
                h2d = padded.nbytes
            elif self._dirty:
                slots = np.fromiter(sorted(self._dirty), dtype=np.int64)
                rows = bitops.to_device(self._host[slots], self.device)
                where = torch.from_numpy(slots).to(self.device)
                streams.use_here(self._device, self._device_ready)
                if not streams.on_side_stream(self.device):
                    self._device.index_copy_(0, where, rows)
                else:
                    # a reader on another stream may hold the old tensor:
                    # a side stream never writes into it
                    self._device = self._device.index_copy(0, where, rows)  # graftlint: disable=residency-discipline -- device_bits' side-stream patch: the copy's size is unchanged and _account_device touches its budget entry below
                    self._device_ready = streams.ready_event(self.device)
                h2d = slots.nbytes + rows.numel() * 4
            self._dirty.clear()
            self.last_sync_h2d_bytes = h2d
            self._account_device(rebuilt)
            residency.default_tracker().note_sync(self, was_resident, h2d)
            streams.use_here(self._device, self._device_ready)
            return self._device

    def row_device(self, row: int) -> torch.Tensor:
        """One row's words on the device (a copy); zeros when the row does
        not exist (reference fragment.go:599 ``row``). When the fragment
        is declined by the budget only this row is shipped (row paging)."""
        with self._lock:
            if self.device_declined():
                return bitops.to_device(self.row_words_host(row), self.device)
            bits = self.device_bits()
            s = self._slot_of.get(row, self.capacity)
            return bits[s].clone()

    def rows_device(self, rows: Iterable[int]) -> torch.Tensor:
        """Gather many rows -> ``int32[n, W]``; missing rows gather the
        zero row. Pages just these rows from the host mirror when the
        fragment is declined by the budget."""
        rows = list(rows)
        with self._lock:
            if self.device_declined():
                out = np.zeros((len(rows), self.n_words), dtype=np.uint32)
                for i, r in enumerate(rows):
                    s = self._slot_of.get(r)
                    if s is not None:
                        out[i] = self._host[s]
                return bitops.to_device(out, self.device)
            bits = self.device_bits()
            slots = torch.tensor(
                [self._slot_of.get(r, self.capacity) for r in rows],
                dtype=torch.int64,
            )
            return bits.index_select(0, slots.to(self.device))

    def row_words_host(self, row: int) -> np.ndarray:
        with self._lock:
            s = self._slot_of.get(row)
            if s is None:
                return np.zeros(self.n_words, dtype=np.uint32)
            return self._host[s].copy()

    def rows_matrix_host(self) -> tuple[list[int], np.ndarray]:
        """(row_ids, words[len(row_ids), W]) — one copy of every present
        row in slot order."""
        with self._lock:
            n = len(self._rowids)
            return list(self._rowids), self._host[:n].copy()

    def row_pair_count(self, ra: int, rb: int, op: str) -> int:
        """``popcount(op(row_a, row_b))`` from the host mirror, the latency
        tier for a lone ``Count(op(Row, Row))``; absent rows count as zero
        rows."""
        with self._lock:
            sa = self._slot_of.get(ra)
            sb = self._slot_of.get(rb)
            if sa is None and sb is None:
                return 0
            if sa is None:
                if op in ("difference", "intersect"):
                    return 0
                return bitops.popcount_host(self._host[sb])
            if sb is None:
                if op == "intersect":
                    return 0
                return bitops.popcount_host(self._host[sa])
            return bitops.pair_count_host(self._host[sa], self._host[sb], op)

    def container_profile(self, containers: bool = True) -> dict:
        """Storage-shape stats (JAX ``Fragment.container_profile``): set
        bits, rows, bit density and, with ``containers``, the roaring
        container census (``storage/roaring.container_stats_words``, equal
        to ``container_stats`` on the positions), cached under the
        fragment's ``(epoch, version)``, so repeat readers (the flight
        planner's selectivity model once a flight, ``/debug/fragments``)
        pay a lookup while the fragment is unchanged. The bits come from
        the maintained row counts; the census is made at the first full
        request and folded into the same cached dict."""
        from pilosa_tpu_torch.storage import roaring

        with self._lock:
            key = (self.epoch, self.version)
            cached = self._container_profile
            if cached is not None and cached[0] == key:
                prof = cached[1]
            else:
                _, counts = self.row_counts()
                bits = int(counts.sum())
                rows = len(self._slot_of)
                prof = {
                    "bits": bits,
                    "rows": rows,
                    "density": bits / (rows * self.shard_width) if rows else 0.0,
                }
                self._container_profile = (key, prof)
            if containers and "containers" not in prof:
                prof["containers"] = roaring.container_stats_words(*self.snapshot_rows())
            return prof

    def row_counts(self) -> tuple[list[int], np.ndarray]:
        """(row_ids, per-row popcounts) over existing rows, in slot order.
        Counts are maintained across writes and recomputed from the host
        mirror only when absent."""
        with self._lock:
            if self._counts is None or len(self._counts) != len(self._rowids):
                n = len(self._rowids)
                self._counts = np.bitwise_count(self._host[:n]).sum(
                    axis=1, dtype=np.int64
                )
            return list(self._rowids), self._counts.copy()

    # -- BSI (bit-sliced integer) operations -------------------------------

    def bsi_tensors(self, bit_depth: int):
        """``(planes[bit_depth, W], exists[W], sign[W])`` device tensors;
        missing planes gather zeros."""
        planes = self.rows_device(range(BSI_OFFSET_BIT, BSI_OFFSET_BIT + bit_depth))
        return planes, self.row_device(BSI_EXISTS_BIT), self.row_device(BSI_SIGN_BIT)

    def fill_bsi_tensors_host(self, bit_depth: int, planes_out, exists_out, sign_out) -> None:
        """Host-mirror twin of :meth:`bsi_tensors`: fill caller-owned,
        zero-initialised arrays (``planes_out[bit_depth, W]``,
        ``exists_out[W]``, ``sign_out[W]``), so one buffer can hold every
        fragment of a field."""
        with self._lock:
            for k in range(bit_depth):
                s = self._slot_of.get(BSI_OFFSET_BIT + k)
                if s is not None:
                    planes_out[k] = self._host[s]
            se = self._slot_of.get(BSI_EXISTS_BIT)
            if se is not None:
                exists_out[:] = self._host[se]
            ss = self._slot_of.get(BSI_SIGN_BIT)
            if ss is not None:
                sign_out[:] = self._host[ss]

    def bsi_tensors_host(self, bit_depth: int):
        """``(planes, exists, sign)`` numpy copies from the host mirror."""
        planes = np.zeros((bit_depth, self.n_words), dtype=np.uint32)
        exists = np.zeros(self.n_words, dtype=np.uint32)
        sign = np.zeros(self.n_words, dtype=np.uint32)
        self.fill_bsi_tensors_host(bit_depth, planes, exists, sign)
        return planes, exists, sign

    def set_value(self, col: int, bit_depth: int, value: int) -> bool:
        """Write a stored (already base-offset) value for a column
        (reference fragment.go:929-1003 setValueBase); its bits go to the op
        log as one batch record of adds and one of removes."""
        with self._lock, self._batched_store():
            changed = self.set_bit(BSI_EXISTS_BIT, col)
            mag = abs(value)
            if value < 0:
                changed |= self.set_bit(BSI_SIGN_BIT, col)
            else:
                changed |= self.clear_bit(BSI_SIGN_BIT, col)
            for k in range(bit_depth):
                if (mag >> k) & 1:
                    changed |= self.set_bit(BSI_OFFSET_BIT + k, col)
                else:
                    changed |= self.clear_bit(BSI_OFFSET_BIT + k, col)
            return changed

    def value(self, col: int, bit_depth: int) -> tuple[int, bool]:
        """(stored value, exists) for a column (reference
        fragment.go:894-927)."""
        with self._lock:
            if not self.get_bit(BSI_EXISTS_BIT, col):
                return 0, False
            mag = 0
            for k in range(bit_depth):
                if self.get_bit(BSI_OFFSET_BIT + k, col):
                    mag |= 1 << k
            if self.get_bit(BSI_SIGN_BIT, col):
                mag = -mag
            return mag, True

    def clear_value(self, col: int) -> bool:
        """Remove a column's value: one masked pass over the column's word
        of every row."""
        with self._lock, self._batched_store():
            s_exists = self._slot_of.get(BSI_EXISTS_BIT)
            w, bmask = col >> 5, np.uint32(1 << (col & 31))
            if s_exists is None or not self._host[s_exists, w] & bmask:
                return False
            n = len(self._rowids)
            set_slots = np.flatnonzero(self._host[:n, w] & bmask)
            self._host[set_slots, w] &= ~bmask
            for s in set_slots.tolist():
                self._touch(int(s))
                if self.store is not None:
                    self.store.log_remove(self._rowids[s], col)
            return True

    def import_values(
        self, cols: np.ndarray, values: np.ndarray, bit_depth: int, clear: bool = False
    ) -> None:
        """Bulk BSI import of stored values (reference fragment.go:2107-2200
        importValue) as one masked update per plane; the last write of a
        column wins. ``clear`` removes the columns' values instead."""
        cols = np.asarray(cols, dtype=np.int64)
        values = np.asarray(values, dtype=np.int64)
        if cols.size == 0:
            return
        last = len(cols) - 1 - np.unique(cols[::-1], return_index=True)[1]
        cols, values = cols[last], values[last]
        with self._lock, self._batched_store():
            col_words = bitops.pack_columns(cols, self.n_words)
            if clear:
                for row in list(self._slot_of):
                    self._merge_row_words(row, col_words, clear=True)
                return
            mags = np.abs(values)
            self._merge_row_words(BSI_EXISTS_BIT, col_words, clear=False)
            neg_words = bitops.pack_columns(cols[values < 0], self.n_words)
            self._merge_row_words(BSI_SIGN_BIT, neg_words, clear=False)
            self._merge_row_words(BSI_SIGN_BIT, col_words & ~neg_words, clear=True)
            for k in range(bit_depth):
                on = bitops.pack_columns(cols[(mags >> k) & 1 == 1], self.n_words)
                self._merge_row_words(BSI_OFFSET_BIT + k, on, clear=False)
                self._merge_row_words(BSI_OFFSET_BIT + k, col_words & ~on, clear=True)

    # -- whole-fragment helpers --------------------------------------------

    def to_host_rows(self) -> dict[int, np.ndarray]:
        """row id -> packed words (dropping all-zero rows)."""
        with self._lock:
            return {
                row: self._host[s].copy()
                for row, s in self._slot_of.items()
                if self._host[s].any()
            }

    def snapshot_rows(self) -> tuple[np.ndarray, np.ndarray]:
        """(ascending row ids uint64, stacked words [n, n_words]); all-zero
        rows are kept."""
        with self._lock:
            if not self._slot_of:
                return (
                    np.empty(0, dtype=np.uint64),
                    np.empty((0, self.n_words), dtype=np.uint32),
                )
            rids = np.array(sorted(self._slot_of), dtype=np.uint64)
            slots = np.array(
                [self._slot_of[int(r)] for r in rids], dtype=np.int64
            )
            return rids, self._host[slots]

    def load_host_rows(self, rows: dict[int, np.ndarray]) -> None:
        """Replace the fragment's contents with ``rows`` (row id -> words),
        slots in ascending row-id order."""
        ids = sorted(rows)
        words = np.zeros((len(ids), self.n_words), dtype=np.uint32)
        for k, r in enumerate(ids):
            words[k] = rows[r]
        self.load_rows_matrix(ids, words)

    def load_rows_matrix(self, row_ids: list[int], words: np.ndarray) -> None:
        """Replace the fragment's contents with ``words[i]`` as row
        ``row_ids[i]``, slots in the given order: the inverse of
        :meth:`rows_matrix_host`."""
        words = np.asarray(words, dtype=np.uint32)
        if words.shape != (len(row_ids), self.n_words):
            raise ValueError(
                f"words shape {words.shape} != ({len(row_ids)}, {self.n_words})"
            )
        with self._lock:
            self._slot_of = {int(r): s for s, r in enumerate(row_ids)}
            if len(self._slot_of) != len(row_ids):
                raise ValueError("duplicate row ids")
            self._rowids = [int(r) for r in row_ids]
            self._set_host(np.zeros((0, self.n_words), dtype=np.uint32))
            if row_ids:
                self._grow(len(row_ids))
                self._host[: len(row_ids)] = words
            self._drop_device()
            self._counts = None
            self.version += 1

    # -- anti-entropy blocks (reference fragment.go:1760-1991) --------------

    def blocks(self) -> list[dict]:
        """Checksums of HASH_BLOCK_SIZE-row blocks; blocks with no bits are
        omitted (reference fragment.go Blocks/blockChecksum). The bytes
        hashed are the JAX package's, so the two packages' checksums of
        the same rows are equal."""
        from pilosa_tpu_torch.core import blockhash

        with self._lock:
            # a round asks each replica's blocks once for itself and once
            # for each peer: the checksums of one version are kept
            cached = self._blocks_cache
            if cached is not None and cached[0] == (self.epoch, self.version):
                return [dict(b) for b in cached[1]]
            by_block: dict[int, list[int]] = {}
            for row in sorted(self._slot_of):
                if self._host[self._slot_of[row]].any():
                    by_block.setdefault(row // HASH_BLOCK_SIZE, []).append(row)
            out = []
            for block in sorted(by_block):
                h = blockhash.new_hash()
                for row in by_block[block]:
                    blockhash.add_row(h, row, self._host[self._slot_of[row]])
                out.append({"id": block, "checksum": h.hexdigest()})
            self._blocks_cache = ((self.epoch, self.version), [dict(b) for b in out])
            return out

    def block_data(self, block: int) -> tuple[np.ndarray, np.ndarray]:
        """(rows uint64, cols int64) of every set bit in a block, local
        coordinates, row-major (reference fragment.go blockData; the JAX
        package returns the same pairs as lists)."""
        with self._lock:
            rows_out: list[np.ndarray] = []
            cols_out: list[np.ndarray] = []
            lo = block * HASH_BLOCK_SIZE
            for row in range(lo, lo + HASH_BLOCK_SIZE):
                slot = self._slot_of.get(row)
                if slot is None:
                    continue
                cols = bitops.unpack_columns(self._host[slot])
                if len(cols):
                    rows_out.append(np.full(len(cols), row, dtype=np.uint64))
                    cols_out.append(cols.astype(np.int64))
            if not rows_out:
                return np.empty(0, np.uint64), np.empty(0, np.int64)
            return np.concatenate(rows_out), np.concatenate(cols_out)

    def load_if_empty(self, row_ids: np.ndarray, words: np.ndarray) -> bool:
        """:meth:`load_rows_matrix` when the fragment holds no bit and no
        migration streams it, under one hold of the lock, so that no write
        can land between the test and the load; False, and nothing
        changed, otherwise. The load writes no op-log record, so a
        migration's delta tap (``cluster/migration.py``) would never see
        it: a tapped fragment takes its rows through the mutators. A
        session pins its tap and cuts its snapshot under this lock, so a
        load that found no tap lies inside the cut."""
        with self._lock:
            if self.store is not None and self.store.tapped():
                return False
            if self._host[: len(self._rowids)].any():
                return False
            self.load_rows_matrix([int(r) for r in row_ids], words)
            return True

    def check_invariants(self, device: bool = False) -> None:
        """Verify slot-map <-> host-mirror <-> device-copy coherence;
        ``device=True`` also compares every clean row of the device copy
        with the mirror (a device-to-host copy: test use)."""
        with self._lock:
            if len(self._rowids) != len(self._slot_of):
                raise FragmentInvariantError("rowids/slot_of size mismatch")
            for r, s in self._slot_of.items():
                if not (0 <= s < len(self._rowids)) or self._rowids[s] != r:
                    raise FragmentInvariantError(
                        f"slot map incoherent at row {r} -> slot {s}"
                    )
            if self._host.shape != (self.capacity, self.n_words):
                raise FragmentInvariantError("host mirror shape")
            if self._counts is not None:
                want = np.bitwise_count(self._host[: len(self._rowids)]).sum(
                    axis=1, dtype=np.int64
                )
                if not np.array_equal(self._counts, want):
                    raise FragmentInvariantError("stale row-count cache")
            if device and self._device is not None:
                streams.use_here(self._device, self._device_ready)
                dev = bitops.to_host(self._device)
                if dev.shape != (self.capacity + 1, self.n_words):
                    raise FragmentInvariantError(f"device copy shape {dev.shape}")
                if dev[self.capacity].any():
                    raise FragmentInvariantError("zero row is not zero")
                clean = [
                    s for s in range(len(self._rowids)) if s not in self._dirty
                ]
                if clean and not np.array_equal(dev[clean], self._host[clean]):
                    raise FragmentInvariantError(
                        "device copy diverged from host mirror on clean rows"
                    )
