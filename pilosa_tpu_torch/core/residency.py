"""Fragment residency tracker: the working-set manager over DeviceBudget
(a copy of ``pilosa_tpu/core/residency.py``).

The budget (membudget.py) decides *which bytes stay*; this module decides
*which bytes should be hot* and *which should already be on their way*.
Together they turn the flat device/not-device split into explicit tiers:

    host-only --> staging --> device --> pinned
       ^             |           |          |
       +---- evict --+-----------+-- cool --+

* **host-only** — only the authoritative numpy mirror exists; the next
  query pays a cold H2D upload.
* **staging** — a predictive prefetch has been queued on the ingest
  ``DeviceUploader`` (the flight's shard set is known at window close,
  server/batcher.py) so the upload overlaps the previous flight's
  compute instead of stalling the dispatch.  The port has no prefetcher
  yet (it comes with the HTTP and serving-plane slices); the hooks
  below (``enter_prefetch``, ``note_prefetch_*``) are kept for it.
* **device** — resident in device memory under clock/LRU eviction.
* **pinned** — hot enough (decayed hit rate over ``heat_half_life``)
  that the budget exempts it from eviction; cooling below the unpin
  threshold demotes it back to plain device residency.

The tracker itself is a thin process-global counter/policy object:
per-fragment state (heat, staging/prefetched flags, pin mirror) lives on
the fragment, updated under the fragment's own lock from
``Fragment.device_bits`` — the tracker never takes a fragment lock, so
the lock order stays fragment -> tracker/budget and never inverts.

Prefetch accounting: ``prefetch_issued`` counts fragments actually
queued on the uploader; an upload that still found work to ship marks
the fragment, and the first *query* hit on that copy counts
``prefetch_useful`` — the ratio is the lane-level proof that predictive
staging pays (BENCH residency lane bar: useful/issued >= 0.5).
"""

from __future__ import annotations

import threading
import time

from pilosa_tpu_torch.core import membudget

STATE_HOST = "host"
STATE_STAGING = "staging"
STATE_DEVICE = "device"
STATE_PINNED = "pinned"

# Decayed-hits threshold above which a fragment's device copy is pinned,
# and the cooler threshold below which a pinned one is released.
DEFAULT_PIN_HEAT = 8.0
DEFAULT_UNPIN_HEAT = 2.0
DEFAULT_HEAT_HALF_LIFE = 10.0  # seconds


class ResidencyTracker:
    """Process-global residency policy + counters (obs: /metrics
    ``pilosa_device_*``, /debug/vars ``residency`` block)."""

    def __init__(
        self,
        pin_heat: float = DEFAULT_PIN_HEAT,
        unpin_heat: float = DEFAULT_UNPIN_HEAT,
        heat_half_life: float = DEFAULT_HEAT_HALF_LIFE,
    ):
        self.pin_heat = float(pin_heat)
        self.unpin_heat = float(unpin_heat)
        self.heat_half_life = max(0.001, float(heat_half_life))
        self._lock = threading.Lock()
        # query-path residency outcomes (prefetch traffic excluded)
        self.device_hits = 0
        self.device_misses = 0
        # predictive prefetch lifecycle
        self.prefetch_issued = 0
        self.prefetch_useful = 0
        self.prefetch_uploads = 0
        self.prefetch_wasted = 0  # upload found the copy already resident
        self.prefetch_dropped = 0  # uploader busy with ingest; not queued
        self.prefetch_errors = 0
        self.prefetch_h2d_bytes = 0
        # pin policy outcomes
        self.auto_pins = 0
        self.auto_unpins = 0
        self.stack_hits = 0
        self.stack_pins = 0
        # threads syncing on behalf of the prefetcher mark themselves so
        # their device_bits calls don't pollute query hit/miss rates
        self._tls = threading.local()

    # -- prefetch-thread marker ---------------------------------------------

    def in_prefetch(self) -> bool:
        return getattr(self._tls, "prefetching", False)

    def enter_prefetch(self) -> None:
        self._tls.prefetching = True

    def exit_prefetch(self) -> None:
        self._tls.prefetching = False

    # -- heat ----------------------------------------------------------------

    def _decayed_heat(self, frag, now: float) -> float:
        dt = now - frag._heat_t
        if dt <= 0:
            return frag._heat
        return frag._heat * (0.5 ** (dt / self.heat_half_life))

    def heat_of(self, frag) -> float:
        """Current decayed heat (read-only; safe without the fragment
        lock — a torn read only skews a diagnostic)."""
        return self._decayed_heat(frag, time.monotonic())

    def state_of(self, frag) -> str:
        """Residency tier for /debug/fragments (racy read by design —
        introspection must not take query-path locks)."""
        if frag._device is not None:
            return STATE_PINNED if frag._res_pinned else STATE_DEVICE
        if frag._res_staging:
            return STATE_STAGING
        return STATE_HOST

    # -- unified residency outcomes (fragments AND field stacks: both
    #    are budget-accounted device assets) ---------------------------------

    def note_hit(self, prefetched: bool = False) -> None:
        """A query found its device asset already resident; when a
        prefetch paid that asset's upload, it proved useful."""
        with self._lock:
            self.device_hits += 1
            if prefetched:
                self.prefetch_useful += 1

    def note_miss(self) -> None:
        """A query paid a cold upload/build on its own path."""
        with self._lock:
            self.device_misses += 1

    def note_prefetch_upload(self, h2d_bytes: int) -> None:
        """The prefetch thread actually shipped bytes for an asset."""
        with self._lock:
            self.prefetch_uploads += 1
            self.prefetch_h2d_bytes += int(h2d_bytes)

    def note_prefetch_claimed(self) -> None:
        """A query needed a stack whose prefetch was still queued and built
        it on its own path (booked there as its miss): the prefetch named
        the right stack, so it counts useful."""
        with self._lock:
            self.prefetch_useful += 1

    def note_prefetch_wasted(self) -> None:
        """The prefetch thread found the asset already resident (the
        query beat it there, or the submit was stale)."""
        with self._lock:
            self.prefetch_wasted += 1

    # -- fragment-path hook (called from Fragment.device_bits, under the
    #    fragment's lock; tracker/budget locks nest inside) ------------------

    def note_sync(self, frag, was_resident: bool, h2d_bytes: int) -> None:
        if self.in_prefetch():
            # the uploader's own sync: prefetch bookkeeping, not a query
            frag._res_staging = False
            if was_resident and not h2d_bytes:
                self.note_prefetch_wasted()
            else:
                frag._res_prefetched = True
                self.note_prefetch_upload(h2d_bytes)
            return
        frag._res_staging = False
        prefetched = frag._res_prefetched
        frag._res_prefetched = False
        if was_resident:
            self.note_hit(prefetched)
        else:
            self.note_miss()
        now = time.monotonic()
        heat = self._decayed_heat(frag, now) + 1.0
        frag._heat = heat
        frag._heat_t = now
        self._repin(frag, heat)

    def _repin(self, frag, heat: float) -> None:
        """Promote/demote the fragment's pin to match its heat."""
        budget = membudget.default_budget(frag.device)
        key = frag._budget_key
        if key is None:
            return
        if not frag._res_pinned and heat >= self.pin_heat:
            if budget.pin(key):
                frag._res_pinned = True
                with self._lock:
                    self.auto_pins += 1
        elif frag._res_pinned and heat < self.unpin_heat:
            budget.unpin(key)
            frag._res_pinned = False
            with self._lock:
                self.auto_unpins += 1

    def note_dropped(self, frag) -> None:
        """The device copy is gone (explicit drop or budget eviction):
        clear the tier flags so state_of can't report a phantom pin."""
        frag._res_pinned = False
        frag._res_prefetched = False
        frag._res_staging = False

    # -- stack-cache policy hooks (exec/executor.py) -------------------------

    def note_stack_hit(self) -> None:
        with self._lock:
            self.stack_hits += 1

    def maybe_pin_stack(self, budget, bkey, hits: int) -> bool:
        """Pin a field stack once its hit count clears the heat bar —
        the executor's cache entries feed the same pin policy as
        fragments (use stamps, not insertion order)."""
        if hits < self.pin_heat:
            return False
        if budget.pin(bkey):
            with self._lock:
                self.stack_pins += 1
            return True
        return False

    # -- prefetch issue-side accounting --------------------------------------

    def note_prefetch_issued(self, n: int = 1) -> None:
        with self._lock:
            self.prefetch_issued += n

    def note_prefetch_dropped(self, n: int = 1) -> None:
        with self._lock:
            self.prefetch_dropped += n

    def note_prefetch_error(self) -> None:
        with self._lock:
            self.prefetch_errors += 1

    # -- introspection -------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            issued = self.prefetch_issued
            useful = self.prefetch_useful
            return {
                "deviceHits": self.device_hits,
                "deviceMisses": self.device_misses,
                "hitRate": round(
                    self.device_hits
                    / max(1, self.device_hits + self.device_misses),
                    4,
                ),
                "prefetchIssued": issued,
                "prefetchUseful": useful,
                "prefetchUsefulFrac": round(useful / max(1, issued), 4),
                "prefetchUploads": self.prefetch_uploads,
                "prefetchWasted": self.prefetch_wasted,
                "prefetchDropped": self.prefetch_dropped,
                "prefetchErrors": self.prefetch_errors,
                "prefetchH2dBytes": self.prefetch_h2d_bytes,
                "autoPins": self.auto_pins,
                "autoUnpins": self.auto_unpins,
                "stackHits": self.stack_hits,
                "stackPins": self.stack_pins,
                "pinHeat": self.pin_heat,
                "unpinHeat": self.unpin_heat,
                "heatHalfLife": self.heat_half_life,
            }


_default: ResidencyTracker | None = None
_default_lock = threading.Lock()


def default_tracker() -> ResidencyTracker:
    global _default
    with _default_lock:
        if _default is None:
            _default = ResidencyTracker()
        return _default


def configure(**kwargs) -> ResidencyTracker:
    """Install a fresh process-wide tracker (tests / embedders)."""
    global _default
    with _default_lock:
        _default = ResidencyTracker(**kwargs)
        return _default
