"""Crash-durable black box: a bounded on-disk spool of the perishable
observability planes, plus startup postmortem assembly. Counterpart of
``pilosa_tpu/obs/blackbox.py``, with JAX's spool layout.

Every other observability surface (flight-recorder segments, incident
bundles, trend episodes, history rings, kept traces, event journal,
SLO/QoS/devledger snapshots) is in-memory: a SIGKILL, OOM, or segfault
takes the evidence with it — which is exactly the evidence an operator
needs most.  GWP/Dapper practice treats durable, restart-readable
diagnostics as table stakes; Go Pilosa persists its diagnostics
payloads for the same reason.

Shape:

* A low-rate writer thread checkpoints the *tails* of the live planes
  into atomic segment files under ``<data_dir>/_blackbox/`` — written
  as ``.tmp`` + fsync + ``os.replace`` so a crash mid-write leaves the
  previous segment intact, never a torn one (torn files from a crash
  mid-``write`` of the tmp are skipped at assembly, counted, and
  reported — not fatal).
* Incident fire triggers a synchronous flush (the flight recorder's
  ``on_incident`` hook), so the frozen bundle reaches disk the moment
  it exists rather than up to one interval later.
* ``faulthandler`` is pointed at a ``last-words.txt`` in the spool so
  fatal signals (SEGV/ABRT/BUS/FPE/ILL) dump all-thread stacks into
  the black box on the way down.
* A ``STATUS`` marker records ``running`` while alive and ``clean`` on
  orderly shutdown (``close()``/SIGTERM/atexit).  On the next open, a
  ``running`` marker means the previous life died dirty: the spool is
  sealed into a read-only postmortem bundle (served at ``GET
  /debug/postmortem``), a crash-loop counter is incremented, and a
  ``node-crash-detected`` event is journaled.  A ``clean`` marker
  resets the crash-loop counter and discards the stale spool.

The spool is size- and count-capped (oldest segments deleted first) so
the black box can never eat the data dir, and everything here is
best-effort: a failing checkpoint must never take down the serving
process it is trying to explain. A checkpoint never waits for the card
and never synchronizes it: the device ledger's block is its non-waiting
:func:`devledger.counters`, which after a sticky CUDA error still
returns the host's counts (the failed read counted in
``settleErrors``).
"""

from __future__ import annotations

import atexit
import faulthandler
import json
import math
import os
import signal
import sys
import threading
import time

from pilosa_tpu_torch.obs import devledger
from pilosa_tpu_torch.obs import events as ev

_STATUS_FILE = "STATUS"
_CRASHLOOP_FILE = "CRASHLOOP"
_LASTWORDS_FILE = "last-words.txt"
_SEG_PREFIX = "seg-"
_PM_PREFIX = "postmortem-"

# events carried per checkpoint segment (deduped by seq at assembly)
_EVENT_TAIL = 256


def _atomic_write(path: str, data: bytes) -> None:
    """Write-temp + fsync + rename: the file at ``path`` is always a
    complete previous or complete new version, never a torn mix."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _atomic_write_json(path: str, obj) -> int:
    data = json.dumps(obj, default=str).encode()
    _atomic_write(path, data)
    return len(data)


def _read_json(path: str):
    """None on missing, torn, or unreadable — the caller counts torn
    files; a half-written segment must never abort assembly."""
    try:
        with open(path, "rb") as f:
            return json.loads(f.read())
    except (OSError, ValueError):
        return None


class BlackBox:
    """Bounded crash-durable spool + postmortem assembler for one node."""

    def __init__(
        self,
        holder,
        data_dir: str,
        api=None,
        flightrec=None,
        history=None,
        node_id: str = "",
        interval: float = 5.0,
        max_segments: int = 64,
        max_bytes: int = 16 << 20,
        keep_postmortems: int = 4,
        history_window: float = 60.0,
    ):
        self.holder = holder
        self.api = api
        self.flightrec = flightrec
        self.history = history
        self.node_id = node_id
        self.dir = os.path.join(data_dir, "_blackbox")
        self.interval = max(0.05, float(interval))
        self.max_segments = max(1, int(max_segments))
        self.max_bytes = max(1 << 16, int(max_bytes))
        self.keep_postmortems = max(1, int(keep_postmortems))
        self.history_window = max(1.0, float(history_window))
        self.started_at = time.time()
        self._lock = threading.Lock()
        self._seq = 0
        self._closed = False
        self._owns_faulthandler = False
        self._fh_was_enabled = False
        self._lw_file = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._stats = {
            "checkpoints": 0,
            "checkpointSeconds": 0.0,
            "syncFlushes": 0,
            "torn": 0,
            "crashLoop": 0,
        }

    # -- lifecycle -----------------------------------------------------------

    def open(self) -> dict | None:
        """Inspect the previous life's spool, seal a postmortem if it
        died dirty, then arm this life's marker + faulthandler + atexit.
        Returns the assembled postmortem (already persisted) or None."""
        os.makedirs(self.dir, exist_ok=True)
        status = _read_json(os.path.join(self.dir, _STATUS_FILE))
        dirty = bool(status) and status.get("state") == "running"
        postmortem = None
        if dirty:
            postmortem = self._assemble_postmortem(status)
        else:
            self._reset_crashloop()
            self._discard_segments()
        _atomic_write_json(
            os.path.join(self.dir, _STATUS_FILE),
            {
                "state": "running",
                "pid": os.getpid(),
                "node": self.node_id,
                "startedAt": self.started_at,
            },
        )
        self._arm_faulthandler()
        atexit.register(self._atexit)
        if postmortem is not None:
            self._journal_crash(postmortem)
        return postmortem

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="blackbox-writer", daemon=True
        )
        self._thread.start()

    def close(self, clean: bool = True) -> None:
        """Stop the writer, take one final checkpoint, and (when
        ``clean``) replace the dirty marker with a clean one so the next
        life knows this was an orderly shutdown, not a crash."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        self._thread = None
        try:
            self.checkpoint("shutdown")
        except Exception:  # a failing final checkpoint must not block shutdown
            pass
        if clean:
            try:
                _atomic_write_json(
                    os.path.join(self.dir, _STATUS_FILE),
                    {
                        "state": "clean",
                        "pid": os.getpid(),
                        "node": self.node_id,
                        "startedAt": self.started_at,
                        "stoppedAt": time.time(),
                    },
                )
            except OSError:
                pass
        try:
            atexit.unregister(self._atexit)
        except Exception:  # interpreter teardown may have dropped the registry
            pass
        self._disarm_faulthandler()

    def _atexit(self) -> None:
        # Interpreter exit without close() (e.g. sys.exit from a signal
        # handler that raced the graceful path): still an orderly death.
        if not self._closed:
            self.close(clean=True)

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.checkpoint("interval")
            except Exception:  # the black box must outlive any one bad checkpoint
                pass

    # -- faulthandler (last words) -------------------------------------------

    def _arm_faulthandler(self) -> None:
        global _FAULTHANDLER_OWNER
        with _FH_LOCK:
            if _FAULTHANDLER_OWNER is not None:
                return  # another node in this process already owns it
            was_enabled = faulthandler.is_enabled()
            try:
                f = open(  # noqa: SIM115 -- must outlive this frame for faulthandler
                    os.path.join(self.dir, _LASTWORDS_FILE), "w"
                )
                faulthandler.enable(file=f, all_threads=True)
            except (OSError, ValueError):
                return
            self._fh_was_enabled = was_enabled
            self._lw_file = f
            self._owns_faulthandler = True
            _FAULTHANDLER_OWNER = id(self)

    def _disarm_faulthandler(self) -> None:
        global _FAULTHANDLER_OWNER
        with _FH_LOCK:
            if not self._owns_faulthandler:
                return
            try:
                faulthandler.disable()
                if self._fh_was_enabled and sys.__stderr__ is not None:
                    # hand fatal-signal dumps back to stderr, where they
                    # went before this box took them
                    faulthandler.enable(file=sys.__stderr__, all_threads=True)
            except Exception:  # already disabled, or stderr is gone
                pass
            if self._lw_file is not None:
                try:
                    self._lw_file.close()
                except OSError:
                    pass
                self._lw_file = None
            self._owns_faulthandler = False
            _FAULTHANDLER_OWNER = None

    # -- checkpointing -------------------------------------------------------

    def flush_incident(self, bundle=None) -> None:
        """Flight-recorder ``on_incident`` hook: the frozen bundle must
        reach disk NOW, not up to one interval later — an incident is
        precisely the moment the process is likeliest to die next."""
        try:
            with self._lock:
                self._stats["syncFlushes"] += 1
            self.checkpoint("incident")
        except Exception:  # a failed flush must not reach the incident engine
            pass

    def checkpoint(self, reason: str = "interval") -> None:
        """Collect the perishable tails of every plane (no blackbox lock
        held — plane locks are taken by the planes themselves) and write
        one atomic segment file, then enforce the spool caps."""
        t0 = time.monotonic()
        seg = self._collect(reason)
        with self._lock:
            if self._closed and reason != "shutdown":
                return
            self._seq += 1
            seg["seq"] = self._seq
            path = os.path.join(
                self.dir, f"{_SEG_PREFIX}{self._seq:08d}.json"
            )
            _atomic_write_json(path, seg)
            self._enforce_caps()
            self._stats["checkpoints"] += 1
            self._stats["checkpointSeconds"] += time.monotonic() - t0

    def _collect(self, reason: str) -> dict:
        seg: dict = {
            "at": time.time(),
            "reason": reason,
            "node": self.node_id,
            "pid": os.getpid(),
        }
        fr = self.flightrec
        if fr is not None:
            try:
                seg["flightrec"] = {
                    "segments": fr.segments_snapshot(limit=10),
                    "incidents": fr.incidents_full(),
                }
            except Exception:  # one plane failing must not starve the others
                pass
        hist = self.history
        if hist is not None:
            try:
                seg["history"] = hist.blackbox_snapshot(self.history_window)
            except Exception:  # one plane failing must not starve the others
                pass
        traces = getattr(self.holder, "traces", None)
        if traces is not None:
            try:
                seg["traces"] = traces.blackbox_snapshot()
            except Exception:  # one plane failing must not starve the others
                pass
        journal = getattr(self.holder, "events", None)
        if journal is not None:
            try:
                tail = journal.since(
                    max(0, journal.last_seq - _EVENT_TAIL)
                )
                seg["events"] = tail["events"]
            except Exception:  # one plane failing must not starve the others
                pass
        slo = getattr(self.holder, "slo", None)
        if slo is not None:
            try:
                seg["slo"] = {
                    "snapshot": slo.snapshot(),
                    "pressure": slo.pressure(),
                }
            except Exception:  # one plane failing must not starve the others
                pass
        api = self.api
        qos = getattr(api, "qos", None) if api is not None else None
        if qos is not None:
            try:
                seg["qos"] = qos.snapshot()
            except Exception:  # one plane failing must not starve the others
                pass
        try:
            seg["devledger"] = devledger.counters()
        except Exception:  # ledger snapshots are advisory
            pass
        return seg

    def _seg_files(self) -> list[str]:
        try:
            names = sorted(
                n for n in os.listdir(self.dir)
                if n.startswith(_SEG_PREFIX) and n.endswith(".json")
            )
        except OSError:
            return []
        return [os.path.join(self.dir, n) for n in names]

    def _enforce_caps(self) -> None:
        """Delete oldest segments past the count/byte caps (the newest
        segment always survives — a cap must bound the spool, not blind
        it)."""
        files = self._seg_files()
        sizes = []
        for p in files:
            try:
                sizes.append(os.path.getsize(p))
            except OSError:
                sizes.append(0)
        total = sum(sizes)
        i = 0
        while len(files) - i > 1 and (
            len(files) - i > self.max_segments or total > self.max_bytes
        ):
            try:
                os.remove(files[i])
            except OSError:
                pass
            total -= sizes[i]
            i += 1

    # -- postmortem assembly -------------------------------------------------

    def _assemble_postmortem(self, status: dict) -> dict:
        """Seal the dead life's spool into one read-only bundle: dedupe
        flight-recorder segments by seq, incidents by id, events by
        seq; keep the LAST history/traces/SLO/QoS/devledger blocks
        (they are cumulative snapshots, not deltas); attach the
        last-words stack dump and the crash-loop counter."""
        torn = 0
        segs: list[dict] = []
        for path in self._seg_files():
            obj = _read_json(path)
            if obj is None:
                torn += 1
                continue
            segs.append(obj)
        fr_segs: dict = {}
        incidents: dict = {}
        events: dict = {}
        last: dict = {}
        for seg in segs:
            for s in (seg.get("flightrec") or {}).get("segments", []):
                fr_segs[s.get("seq")] = s
            for b in (seg.get("flightrec") or {}).get("incidents", []):
                incidents[b.get("id")] = b
            for e in seg.get("events", []):
                events[e.get("seq")] = e
            for key in ("history", "traces", "slo", "qos", "devledger"):
                if seg.get(key) is not None:
                    last[key] = seg[key]
        last_words = None
        try:
            with open(os.path.join(self.dir, _LASTWORDS_FILE)) as f:
                text = f.read().strip()
            last_words = text or None
        except OSError:
            pass
        crash_loop = self._bump_crashloop()
        pid = status.get("pid")
        started = status.get("startedAt")
        pm_id = (
            f"{int(started)}-{pid}"
            if isinstance(started, (int, float)) and pid is not None
            else f"{int(time.time())}-unknown"
        )
        bundle = {
            "id": pm_id,
            "assembledAt": time.time(),
            "node": status.get("node", ""),
            "pid": pid,
            "startedAt": started,
            "lastCheckpointAt": segs[-1]["at"] if segs else None,
            "crashLoop": crash_loop,
            "lastWords": last_words,
            "segments": len(segs),
            "torn": torn,
            "incidents": sorted(
                incidents.values(), key=lambda b: b.get("at", 0.0)
            ),
            "flightrecSegments": [
                fr_segs[k] for k in sorted(fr_segs, key=lambda s: s or 0)
            ],
            "events": [
                events[k] for k in sorted(events, key=lambda s: s or 0)
            ],
            "history": last.get("history"),
            "traces": last.get("traces"),
            "slo": last.get("slo"),
            "qos": last.get("qos"),
            "devledger": last.get("devledger"),
        }
        with self._lock:
            self._stats["torn"] += torn
            self._stats["crashLoop"] = crash_loop
        try:
            _atomic_write_json(
                os.path.join(self.dir, f"{_PM_PREFIX}{pm_id}.json"), bundle
            )
        except OSError:
            pass
        self._discard_segments()
        self._prune_postmortems()
        return bundle

    def _journal_crash(self, postmortem: dict) -> None:
        journal = getattr(self.holder, "events", None)
        if journal is None:
            return
        try:
            journal.record(
                ev.EVENT_NODE_CRASH,
                postmortem=postmortem["id"],
                crashLoop=postmortem["crashLoop"],
                pid=postmortem.get("pid"),
                lastWords=bool(postmortem.get("lastWords")),
                incidents=len(postmortem.get("incidents") or ()),
            )
        except Exception:  # journaling is best-effort
            pass

    def _discard_segments(self) -> None:
        for path in self._seg_files():
            try:
                os.remove(path)
            except OSError:
                pass

    def _bump_crashloop(self) -> int:
        path = os.path.join(self.dir, _CRASHLOOP_FILE)
        prev = _read_json(path) or {}
        count = int(prev.get("count", 0)) + 1
        try:
            _atomic_write_json(
                path, {"count": count, "lastCrashAt": time.time()}
            )
        except OSError:
            pass
        return count

    def _reset_crashloop(self) -> None:
        path = os.path.join(self.dir, _CRASHLOOP_FILE)
        if _read_json(path) is not None:
            try:
                _atomic_write_json(path, {"count": 0, "lastCrashAt": None})
            except OSError:
                pass

    def _pm_files(self) -> list[tuple[str, str]]:
        """[(id, path)] for sealed bundles, oldest assembly first."""
        try:
            names = [
                n for n in os.listdir(self.dir)
                if n.startswith(_PM_PREFIX) and n.endswith(".json")
            ]
        except OSError:
            return []
        out = []
        for n in names:
            pm_id = n[len(_PM_PREFIX):-len(".json")]
            path = os.path.join(self.dir, n)
            obj = _read_json(path)
            at = (obj or {}).get("assembledAt", 0.0)
            out.append((at, pm_id, path))
        out.sort()
        return [(pm_id, path) for _, pm_id, path in out]

    def _prune_postmortems(self) -> None:
        files = self._pm_files()
        for _, path in files[: max(0, len(files) - self.keep_postmortems)]:
            try:
                os.remove(path)
            except OSError:
                pass

    # -- exposition ----------------------------------------------------------

    def postmortems(self) -> dict:
        """``GET /debug/postmortem``: summaries of every retained bundle
        (newest first) plus the newest bundle in full — the acceptance
        surface after a crash is one GET, no id juggling."""
        files = self._pm_files()
        summaries = []
        latest = None
        for pm_id, path in files:
            obj = _read_json(path)
            if obj is None:
                continue
            latest = obj
            summaries.append({
                k: obj.get(k)
                for k in (
                    "id", "assembledAt", "node", "pid", "startedAt",
                    "lastCheckpointAt", "crashLoop", "segments", "torn",
                )
            } | {
                "incidents": len(obj.get("incidents") or ()),
                "lastWords": bool(obj.get("lastWords")),
            })
        summaries.reverse()
        return {
            "node": self.node_id,
            "postmortems": summaries,
            "latest": summaries[0]["id"] if summaries else None,
            "postmortem": latest,
        }

    def postmortem_detail(self, pm_id: str) -> dict | None:
        for got, path in self._pm_files():
            if got == pm_id:
                return _read_json(path)
        return None

    def stats(self) -> dict:
        """Writer self-accounting for /debug/vars and the bench lane."""
        with self._lock:
            out = dict(self._stats)
        out["interval"] = self.interval
        out["maxSegments"] = self.max_segments
        out["maxBytes"] = self.max_bytes
        files = self._seg_files()
        out["segments"] = len(files)
        total = 0
        for p in files:
            try:
                total += os.path.getsize(p)
            except OSError:
                pass
        out["bytes"] = total
        out["postmortems"] = len(self._pm_files())
        out["checkpointSeconds"] = round(out["checkpointSeconds"], 6)
        return out


# -- process-wide fatal-signal / shutdown plumbing ---------------------------

_FH_LOCK = threading.Lock()
_FAULTHANDLER_OWNER: int | None = None

_SIG_LOCK = threading.Lock()
_SIG_NODES: list = []
_SIG_INSTALLED = False
# the SIGTERM handler before ours, restored when the last node leaves
_SIG_PREV = None


def _drain_nodes() -> None:
    for node in list(_SIG_NODES):
        try:
            node.shutdown_graceful()
        except Exception:  # one node's failed drain must not stop the others'
            pass


def _handle_sigterm(signum, frame) -> None:
    """Drain every registered node: SIGTERM is an orderly stop, and must
    not read as a crash on the next boot. The drain runs on a helper
    thread, so a main thread parked in the server's own loop is not the
    one waiting for that loop to end; a caller parked in
    ``NodeServer.wait()`` (the CLI) returns once it is done and exits 0.
    With no node registered the previous handler takes the signal."""
    if _SIG_NODES:
        threading.Thread(target=_drain_nodes, name="node-stop").start()
        return
    prev = _SIG_PREV
    if callable(prev):
        prev(signum, frame)
        return
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    os.kill(os.getpid(), signal.SIGTERM)


def install_signal_handlers(node) -> bool:
    """Register ``node`` for graceful SIGTERM shutdown.  Installs the
    process-wide handler on first call; returns False when handlers
    cannot be installed (off the main thread)."""
    global _SIG_INSTALLED, _SIG_PREV
    with _SIG_LOCK:
        if node not in _SIG_NODES:
            _SIG_NODES.append(node)
        if _SIG_INSTALLED:
            return True
        try:
            _SIG_PREV = signal.signal(signal.SIGTERM, _handle_sigterm)
        except ValueError:
            _SIG_NODES.remove(node)
            return False
        _SIG_INSTALLED = True
        return True


def uninstall_signal_handlers(node) -> None:
    """Unregister ``node``; the last one out restores the previous
    handler when it can (on the main thread)."""
    global _SIG_INSTALLED, _SIG_PREV
    with _SIG_LOCK:
        if node in _SIG_NODES:
            _SIG_NODES.remove(node)
        if _SIG_NODES or not _SIG_INSTALLED:
            return
        prev = _SIG_PREV if _SIG_PREV is not None else signal.SIG_DFL
        try:
            signal.signal(signal.SIGTERM, prev)
        except ValueError:
            return  # off the main thread: ours stays and defers to prev
        _SIG_INSTALLED = False
        _SIG_PREV = None


def history_window_samples(window_s: float, cadence: float) -> int:
    """Samples needed to cover ``window_s`` at ``cadence`` (ceil)."""
    return max(1, int(math.ceil(float(window_s) / max(1e-6, cadence))))
