"""Device-memory budget: tiered working-set accounting for device copies
(a copy of ``pilosa_tpu/core/membudget.py``; the cap's probe reads the
holder's card through torch instead of jax and raises where it fails, an
owner's finalizer releases its entry without blocking on the budget's
lock, ``release_from_finalizer``, and owners' keys are fresh objects).

The reference caps mmap count / open files and raises rlimits so a holder
with more fragments than the OS allows still serves (reference
syswrap/mmap.go — 60k map cap with file fallback; holder.go:43,551-597).
The card's analogue is its device memory: every fragment device copy and
every executor field stack is registered here, and when the budget cap is
exceeded cold entries are evicted back to their host mirrors (the "file
fallback"); the owner drops its tensor, which frees the card's memory.
Device memory is per-process, not per-Holder, so the default budget is a
process-wide singleton; tests or embedders can configure a small cap to
exercise eviction.

Eviction policy — clock over LRU, with pinning:

* entries keep LRU order (``touch`` moves to the tail), and every touch
  also sets a *reference bit*;
* the eviction scan walks from the LRU head; a referenced entry gets a
  second chance (bit cleared, moved to the tail) instead of being
  evicted — an entry that was hit since the last scan is never the one
  that pays for a one-off large admit;
* **pinned** entries are skipped entirely: the residency tracker
  (core/residency.py) pins hot fragments and the executor pins hot field
  stacks, so the zipfian head of a working set survives eviction storms
  from its own tail.  Pinned bytes are capped at ``PIN_MAX_FRACTION`` of
  the budget so the scan always has victims to find.

Deadlock discipline: evict callbacks are invoked AFTER the budget lock is
released (victims are collected under the lock, called outside it), so a
callback may take its owner's lock while the admit path holds
owner-lock -> budget-lock — the two orders never nest.
"""

from __future__ import annotations

import os
import threading
import weakref
from collections import OrderedDict
from typing import Callable

# A pinned working set may not squat on the whole budget: the eviction
# scan must always be able to find victims, so pin() declines once
# pinned bytes would exceed this fraction of the cap.
PIN_MAX_FRACTION = 0.5


class _Entry:
    """One admitted allocation: bytes, evict callback, clock state."""

    __slots__ = ("nbytes", "evict", "pinned", "ref")

    def __init__(self, nbytes: int, evict: Callable[[], None]):
        self.nbytes = nbytes
        self.evict = evict
        self.pinned = False
        self.ref = False


class DeviceBudget:
    """Tracks device-resident bytes per owner key with clock/LRU
    eviction and pinning."""

    def __init__(self, cap_bytes: int | None = None):
        self.cap = cap_bytes  # None = unlimited (accounting only)
        self._lock = threading.Lock()
        # key -> _Entry; insertion order = LRU order (head = coldest)
        self._entries: "OrderedDict[object, _Entry]" = OrderedDict()
        self._used = 0
        self._pinned_bytes = 0
        # counters for stats/diagnostics
        self.evictions = 0
        self.admissions = 0
        self.evict_errors = 0
        # residency counters: an admit of an absent key paid an upload
        # (miss); a touch found the bytes already resident (hit)
        self.hits = 0
        self.misses = 0
        self.pins = 0
        self.unpins = 0
        self.pin_declined = 0

    def used(self) -> int:
        with self._lock:
            return self._used

    def entry_count(self) -> int:
        with self._lock:
            return len(self._entries)

    def pinned_bytes(self) -> int:
        with self._lock:
            return self._pinned_bytes

    def snapshot(self) -> dict:
        """One consistent view for /metrics and /debug/vars."""
        with self._lock:
            return {
                "usedBytes": self._used,
                "capBytes": self.cap,
                "entries": len(self._entries),
                "evictions": self.evictions,
                "admissions": self.admissions,
                "evictErrors": self.evict_errors,
                "hits": self.hits,
                "misses": self.misses,
                "pins": self.pins,
                "unpins": self.unpins,
                "pinDeclined": self.pin_declined,
                "pinnedEntries": sum(
                    1 for e in self._entries.values() if e.pinned
                ),
                "pinnedBytes": self._pinned_bytes,
            }

    def would_decline(self, nbytes: int) -> bool:
        """True when a single allocation of ``nbytes`` exceeds the whole
        cap — callers should prefer a paged strategy over admitting it."""
        return self.cap is not None and nbytes > self.cap

    def _collect_victims(self, needed: int) -> list[Callable[[], None]]:
        """Clock scan from the LRU head (caller holds the lock): pinned
        entries are skipped, referenced entries get a second chance, the
        rest are evicted until ``needed`` more bytes fit under the cap.
        Bounded at two full cycles: the first clears every reference
        bit, so the second finds a victim or proves everything left is
        pinned."""
        victims: list[Callable[[], None]] = []
        scans = 2 * len(self._entries)
        while self._used + needed > self.cap and self._entries and scans > 0:
            scans -= 1
            key, entry = next(iter(self._entries.items()))
            if entry.pinned:
                self._entries.move_to_end(key)
                if all(e.pinned for e in self._entries.values()):
                    break  # nothing evictable; admit over cap
                continue
            if entry.ref:
                entry.ref = False  # second chance
                self._entries.move_to_end(key)
                continue
            self._entries.popitem(last=False)
            self._used -= entry.nbytes
            self.evictions += 1
            victims.append(entry.evict)
        return victims

    def admit(self, key, nbytes: int, evict: Callable[[], None]) -> None:
        """Account ``nbytes`` of device memory for ``key`` (replacing any
        previous entry), evicting cold OTHER entries until the cap is
        met.  An entry larger than the entire cap is still admitted
        after evicting everything evictable — the caller already holds
        the array; callers that can page should check ``would_decline``
        first."""
        victims: list[Callable[[], None]] = []
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._used -= old.nbytes
                if old.pinned:
                    self._pinned_bytes -= old.nbytes
            else:
                self.misses += 1
            if self.cap is not None:
                victims = self._collect_victims(nbytes)
            entry = _Entry(nbytes, evict)
            # arrive with the reference bit set: a freshly staged entry
            # (often a predictive prefetch whose consumer hasn't run yet)
            # survives one scan cycle instead of being the next admit's
            # victim — classic CLOCK "insert behind the hand"
            entry.ref = True
            if old is not None and old.pinned:
                # a pinned owner re-admitting (e.g. capacity grow) stays
                # pinned — the heat that earned the pin didn't reset
                entry.pinned = True
                self._pinned_bytes += nbytes
            self._entries[key] = entry
            self._used += nbytes
            self.admissions += 1
        for cb in victims:
            try:
                cb()
            except Exception:
                # eviction is advisory; owner may already be gone —
                # counted so a flaky callback is visible in diagnostics
                self.evict_errors += 1

    def set_cap(self, cap_bytes: int | None) -> None:
        """Change the cap IN PLACE, keeping every entry's accounting.
        Shrinking below current use evicts cold unpinned entries (their
        callbacks run, so owners drop device copies and re-admit on next
        sync) — the online oversubscription knob: unlike ``configure``,
        resident state is trimmed, not forgotten.  Pins granted under a
        larger (or absent) cap are re-validated first: coldest pinned
        entries are shed until pinned bytes fit ``PIN_MAX_FRACTION`` of
        the new cap, restoring the invariant that the clock scan always
        has victims (heat re-pins what still deserves it)."""
        victims: list[Callable[[], None]] = []
        with self._lock:
            self.cap = cap_bytes
            if self.cap is not None:
                limit = self.cap * PIN_MAX_FRACTION
                for key, entry in list(self._entries.items()):
                    if self._pinned_bytes <= limit:
                        break
                    if entry.pinned:  # LRU head first: coldest pin goes
                        entry.pinned = False
                        self._pinned_bytes -= entry.nbytes
                        self.unpins += 1
                victims = self._collect_victims(0)
        for cb in victims:
            try:
                cb()
            except Exception:
                self.evict_errors += 1

    def touch(self, key) -> None:
        """Use stamp: LRU move-to-tail plus the clock reference bit."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                entry.ref = True
                self.hits += 1

    def pin(self, key) -> bool:
        """Exempt ``key`` from eviction.  Declines (False) when the key
        is absent or when pinning it would push pinned bytes past
        ``PIN_MAX_FRACTION`` of the cap — the scan must keep victims."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return False
            if entry.pinned:
                return True
            if (
                self.cap is not None
                and self._pinned_bytes + entry.nbytes > self.cap * PIN_MAX_FRACTION
            ):
                self.pin_declined += 1
                return False
            entry.pinned = True
            self._pinned_bytes += entry.nbytes
            self.pins += 1
            return True

    def unpin(self, key) -> bool:
        with self._lock:
            entry = self._entries.get(key)
            if entry is None or not entry.pinned:
                return False
            entry.pinned = False
            self._pinned_bytes -= entry.nbytes
            self.unpins += 1
            return True

    def is_pinned(self, key) -> bool:
        with self._lock:
            entry = self._entries.get(key)
            return entry is not None and entry.pinned

    def release(self, key) -> None:
        """Remove an entry WITHOUT invoking its evict callback (the owner
        dropped its device copy itself, or died)."""
        with self._lock:
            self._release_locked(key)

    def _release_locked(self, key) -> None:
        old = self._entries.pop(key, None)
        if old is not None:
            self._used -= old.nbytes
            if old.pinned:
                self._pinned_bytes -= old.nbytes

    def release_from_finalizer(self, key) -> None:
        """``release`` for a ``weakref.finalize`` callback. The collector
        can run a finalizer on a thread that holds this budget's lock (an
        allocation inside ``admit``), where a blocking acquire would
        deadlock; so it never blocks, and a short-lived thread releases
        the entry when the lock is taken."""
        if self._lock.acquire(blocking=False):
            try:
                self._release_locked(key)
            finally:
                self._lock.release()
        else:
            threading.Thread(target=self.release, args=(key,), daemon=True).start()


_default: DeviceBudget | None = None
_default_lock = threading.Lock()

# Fraction of the card's total memory used when no explicit cap is
# configured: stacks and fragments may not squat on all of it — the
# kernels need room for their outputs and temporaries (prefix masks,
# result words, patched stack copies).
DEFAULT_HBM_FRACTION = 0.8


def _probe_device_cap(device=None) -> int | None:
    """Derive a default cap from the total memory of the card ``device``
    names (``torch.cuda.mem_get_info``; the current card when ``device``
    is None or not a CUDA device), as the reference ships working syswrap
    defaults rather than unlimited (syswrap/mmap.go). None only where
    there is no CUDA device (accounting only); a failing probe raises, so
    a card is never served without a cap. torch is imported here, not at
    module load."""
    import torch

    if not torch.cuda.is_available():
        return None
    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type != "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    return int(torch.cuda.mem_get_info(dev)[1] * DEFAULT_HBM_FRACTION)


def default_budget(device=None) -> DeviceBudget:
    """The process-wide budget.  Cap precedence: explicit
    PILOSA_TPU_HBM_BUDGET_BYTES (0 = force unlimited accounting), else
    80% of the total memory of ``device``'s card (the caller's holder
    device; read once, when the budget is made: a card would fail its
    allocations long before an unlimited LRU ever engaged), else
    unlimited without CUDA."""
    global _default
    with _default_lock:
        if _default is None:
            env = os.environ.get("PILOSA_TPU_HBM_BUDGET_BYTES")
            if env is not None:
                cap = int(env) or None
            else:
                cap = _probe_device_cap(device)
            _default = DeviceBudget(cap)
        return _default


def configure(cap_bytes: int | None) -> DeviceBudget:
    """Install a fresh process-wide budget with the given cap (existing
    entries are forgotten, not evicted — their owners re-admit on next
    device sync)."""
    global _default
    with _default_lock:
        _default = DeviceBudget(cap_bytes)
        return _default


def set_cap(cap_bytes: int | None) -> DeviceBudget:
    """Change the process-wide budget's cap in place (entries kept,
    excess evicted) — see ``DeviceBudget.set_cap``.  The load harness's
    stage-scoped ``device_budget`` rides this so an oversubscribed stage
    squeezes the live working set instead of starting a blank ledger."""
    budget = default_budget()
    budget.set_cap(cap_bytes)
    return budget


def register_owner(key_obj, budget: DeviceBudget) -> object:
    """A stable budget key for ``key_obj`` that auto-releases its entry
    when the owner is garbage collected. The key is a fresh object, never
    ``id(key_obj)``: a finalizer's release may be deferred
    (``release_from_finalizer``) past the moment a new owner takes the
    dead one's address, and must not release the new owner's entry."""
    key = object()
    weakref.finalize(key_obj, budget.release_from_finalizer, key)
    return key
