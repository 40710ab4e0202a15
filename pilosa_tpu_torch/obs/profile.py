"""In-process CPU sampling profiler and memory snapshot.

The reference mounts net/http/pprof on its router (reference
http/handler.go:280) and enables block/mutex profile rates
(server.go:184-185); the analogues here are:

* ``sample(seconds)`` — a statistical wall-clock sampler over
  ``sys._current_frames()``: every tick it records the collapsed stack
  of EVERY live thread (cProfile would only see the calling thread,
  which is never the one serving queries).  Output is
  flamegraph-collapsed format ("a;b;c count" lines), the same shape
  ``go tool pprof``'s raw dumps collapse to.
* ``memory_snapshot(holder)`` — RSS + per-component accounting: host
  mirror bytes by index, device (HBM) budget state, GC and thread
  counts — the heap-profile role, shaped to this runtime's actual
  memory owners (numpy mirrors and HBM stacks, which a Python heap
  profiler cannot see).

Counterpart of ``pilosa_tpu/obs/profile.py``, the same code.
"""

from __future__ import annotations

import gc
import os
import sys
import threading
import time
from collections import Counter


def _collapse(frame) -> str:
    parts: list[str] = []
    while frame is not None:
        code = frame.f_code
        parts.append(f"{os.path.basename(code.co_filename)}:{code.co_name}")
        frame = frame.f_back
    return ";".join(reversed(parts))


class Sampler:
    """Incremental all-thread stack sampler: call :meth:`tick` at any
    cadence (the blocking :func:`sample` loop, or the flight recorder's
    segment thread), :meth:`drain` to take the accumulated collapse and
    reset.  One tick walks ``sys._current_frames()`` once — the
    Google-Wide-Profiling shape: always-on because each observation is
    O(live threads), not O(wall time)."""

    def __init__(self, exclude_ident: int | None = None):
        self._exclude = exclude_ident
        self._names: dict[int | None, str] = {}
        self._stacks: Counter[str] = Counter()
        self._per_thread: Counter[str] = Counter()
        self.samples = 0

    def tick(self) -> None:
        for t in threading.enumerate():
            self._names[t.ident] = t.name
        me = threading.get_ident()
        for ident, frame in sys._current_frames().items():
            if ident == me or ident == self._exclude:
                continue  # the sampler itself is noise
            self._stacks[_collapse(frame)] += 1
            self._per_thread[self._names.get(ident, str(ident))] += 1
        self.samples += 1

    def drain(self, top: int | None = None) -> dict:
        """Take {"samples", "stacks", "threads"} and reset the counters;
        ``top`` bounds the stack list (segment records keep only the
        hottest stacks)."""
        out = {
            "samples": self.samples,
            "stacks": dict(self._stacks.most_common(top)),
            "threads": dict(self._per_thread.most_common()),
        }
        self._stacks.clear()
        self._per_thread.clear()
        self.samples = 0
        return out


def sample(
    seconds: float, interval: float = 0.005, max_seconds: float = 30.0
) -> dict:
    """Sample all threads' stacks for ``seconds`` (capped); returns
    {"samples": N, "seconds": s, "interval_s": i,
     "stacks": {collapsed_stack: count}, "threads": {name: count}}."""
    seconds = max(0.05, min(float(seconds), max_seconds))
    s = Sampler()
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        s.tick()
        time.sleep(interval)
    out = s.drain()
    out.update(seconds=seconds, interval_s=interval)
    return out


def memory_snapshot(holder=None) -> dict:
    """Process + framework memory accounting (the heap-profile role)."""
    from pilosa_tpu_torch.core import membudget
    from pilosa_tpu_torch.obs.sysinfo import SystemInfo

    out: dict = {
        "rss_bytes": SystemInfo().process_rss(),
        "gc_counts": gc.get_count(),
        "gc_collections": [s.get("collections") for s in gc.get_stats()],
        "threads": threading.active_count(),
    }
    b = membudget.default_budget()
    out["hbm_budget"] = {
        "cap_bytes": b.cap,
        "used_bytes": b.used(),
        "entries": b.entry_count(),
        "evictions": b.evictions,
        "admissions": b.admissions,
    }
    if holder is not None:
        per_index = {}
        total = 0
        frags = 0
        for idx in list(holder.indexes.values()):
            ibytes = 0
            for field in list(idx.fields.values()):
                for view in list(field.views.values()):
                    for frag in list(view.fragments.values()):
                        host = getattr(frag, "_host", None)
                        if host is not None:
                            ibytes += host.nbytes
                        frags += 1
            per_index[idx.name] = ibytes
            total += ibytes
        out["host_mirrors"] = {
            "total_bytes": total,
            "fragments": frags,
            "by_index": per_index,
        }
    return out
