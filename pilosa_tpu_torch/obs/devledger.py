"""Process-wide device cost ledger: launch and transfer accounting
(counterpart of ``pilosa_tpu/obs/devledger.py``).

Every kernel launch site registers a :class:`Site`
(``ledger.site("kernels.row_scan")``) and reports through it, so the
server can answer what the device work cost (launch counts, their wall
and device time, H2D/D2H bytes) and who caused it: the *site* (which
launch path) and the *principal* ``(tenant, index, op_class)``, with the
tenant read from the ``X-Pilosa-Tenant`` request header and threaded
http -> api -> executor -> kernel wrappers through contextvars.

Device time comes from a CUDA event pair around each launch
(:meth:`Site.record_cuda_launch`). Reading an event pair waits for the
launch to finish, so the query path never reads one: pairs queue up and
:meth:`Ledger.settle` folds them in when a snapshot is taken (and, without
waiting, the pairs already finished whenever the queue grows long, and
whenever the flight planner, the QoS governor or a sampler reads the
ledger). No lock is held while a pair is waited for, and the non-waiting
form skips when another thread is folding: a launching thread or a
sampler never waits behind an exposition route that waits for a long
kernel.

Each launch carries a signature; its class (the first token) keeps a
per-site EWMA of device ms a launch, read by the flight planner's lane
choice through :func:`measured_ms` (``exec/planner.py``). The batcher
splits a flight's launches across the principals that rode it
(:func:`weighted_scope`), and the QoS governor debits each tenant by its
measured device ms (:func:`tenant_totals`, ``server/qos.py``). A
*launch window* (:meth:`Site.launch`) books host-side device work that is
no kernel, such as an ingest upload or a prefetch, as launches with their
wall time; transfers made inside one book under its site
(:func:`active_window_site`).

The compile columns stay at 0: the port builds its kernels with nvcc
before the first launch (``ops/cuda_build.py``), so no launch compiles
anything, and JAX's ``jax.monitoring`` compile listener has nothing to
observe here. The recompile-storm detector keeps its knobs and callbacks
(:func:`configure_storm`, :func:`on_storm`, :func:`mark_warm`) so a node
wires it as JAX's does, but with no compile event it never fires. The keys
stay so the snapshot and :func:`counters` read as JAX's do.

The ledger is process-global by design, as devices are.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from contextvars import ContextVar

TENANT_HEADER = "X-Pilosa-Tenant"
# THE canonical tenantless principal: every spelling of "no tenant"
# (missing header, empty string, whitespace, the legacy "-") lands
# here, so batcher admission, ledger rows and SLO accounting agree on
# one identity for untagged traffic.
DEFAULT_TENANT = "(default)"
_LEGACY_TENANTLESS = ("-",)

# Principal tables are label sets headed for /metrics: bound cardinality.
_MAX_PRINCIPALS = 512
_OVERFLOW_PRINCIPAL = ("~overflow", "-", "-")
_MAX_TENANT_LEN = 64
# event pairs queued before a launch folds in the finished ones, and the
# most kept unread (past it the oldest pair's device time is dropped and
# counted, so the query path never waits on the card)
_SETTLE_AT = 256
_MAX_PENDING = 1 << 16

_tenant: ContextVar[str] = ContextVar("devledger_tenant", default=DEFAULT_TENANT)
# (index, op_class) bound by the api layer once both are known.
_binding: ContextVar[tuple] = ContextVar("devledger_binding", default=("-", "-"))
# Weighted principal list, set by the batcher around a shared flight so one
# launch is split across every principal that rode it.
_weights: ContextVar[tuple] = ContextVar("devledger_weights", default=())


class _TLS(threading.local):
    def __init__(self):
        self.windows = []


_tls = _TLS()


def active_window_site():
    """The site of this thread's innermost launch window, or None: a
    transfer made inside an ingest-upload window books under that site."""
    w = _tls.windows
    return w[-1] if w else None


def clean_tenant(raw) -> str:
    """Sanitize a tenant label from the wire: printable, bounded,
    non-empty — and NORMALIZED: every tenantless spelling (None, "",
    whitespace, legacy "-") maps to the one canonical
    :data:`DEFAULT_TENANT` so per-tenant accounting never splits
    untagged traffic across aliases."""
    if not raw:
        return DEFAULT_TENANT
    t = "".join(c for c in str(raw).strip() if c.isprintable() and c not in '{}",\\')
    t = t[:_MAX_TENANT_LEN]
    if not t or t in _LEGACY_TENANTLESS:
        return DEFAULT_TENANT
    return t


def current_tenant() -> str:
    return _tenant.get()


def current_principal() -> tuple:
    idx, cls = _binding.get()
    return (_tenant.get(), idx, cls)


def ambient_weights() -> tuple:
    """The weighted principal list launches book against: the batcher's
    flight-level split when set, else the ambient principal at weight 1."""
    w = _weights.get()
    if w:
        return w
    return ((current_principal(), 1.0),)


@contextlib.contextmanager
def tenant_scope(tenant):
    tok = _tenant.set(clean_tenant(tenant))
    try:
        yield
    finally:
        _tenant.reset(tok)


@contextlib.contextmanager
def principal_scope(index="-", op_class="-"):
    tok = _binding.set((str(index or "-"), str(op_class or "-")))
    try:
        yield
    finally:
        _binding.reset(tok)


@contextlib.contextmanager
def weighted_scope(pairs):
    """``pairs`` is an iterable of ((tenant, index, op_class), weight): the
    batcher's split of one shared flight's launches across every principal
    whose queries rode it."""
    tok = _weights.set(tuple(pairs))
    try:
        yield
    finally:
        _weights.reset(tok)


class _Accum:
    """One row of the cost table (a site, a principal, or the totals)."""

    __slots__ = (
        "launches",
        "launch_ms",
        "device_ms",
        "h2d_bytes",
        "d2h_bytes",
    )

    def __init__(self):
        self.launches = 0
        self.launch_ms = 0.0
        self.device_ms = 0.0
        self.h2d_bytes = 0
        self.d2h_bytes = 0

    def to_dict(self, uptime=None):
        d = {
            # no launch compiles (module docstring): the keys stay at 0
            "compiles": 0,
            "compileMs": 0.0,
            "launches": self.launches,
            "launchMs": round(self.launch_ms, 3),
            "deviceMs": round(self.device_ms, 3),
            "h2dBytes": self.h2d_bytes,
            "d2hBytes": self.d2h_bytes,
        }
        if uptime and uptime > 0:
            d["launchesPerSec"] = round(self.launches / uptime, 3)
            d["transferBytesPerSec"] = round(
                (self.h2d_bytes + self.d2h_bytes) / uptime, 1
            )
        return d


class Site:
    """One registered launch site. Cheap to hold; all mutation funnels
    through the owning ledger's lock."""

    __slots__ = ("name", "ledger", "acc", "sig_ms")

    def __init__(self, name, ledger):
        self.name = name
        self.ledger = ledger
        self.acc = _Accum()
        # sig class (the first token of a launch's sig) -> [launches, EWMA
        # device ms a launch]: the price list the flight planner's lane
        # choice reads (exec/planner.py)
        self.sig_ms: dict[str, list] = {}

    def record_cuda_launch(self, start, end, wall_s=0.0, n=1, sig=None):
        """Book ``n`` launches bracketed by the recorded CUDA events
        ``start`` and ``end``: the count and wall time now, the device time
        (and the price of ``sig``'s class) when :meth:`Ledger.settle` reads
        the pair."""
        self.ledger._book_launch(self, n, wall_s * 1e3)
        self.ledger._pend(self, start, end, n, sig)

    @contextlib.contextmanager
    def launch(self, sig=None, n=1):
        """A launch window: ``n`` launches of host-driven device work that
        is no kernel (an ingest upload, a prefetch), booked with their wall
        time; transfers made inside book under this site. Its device time
        is that of the kernels it launches, which book on their own sites."""
        _tls.windows.append(self)
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            _tls.windows.pop()
            self.ledger._book_launch(self, n, (time.perf_counter() - t0) * 1e3)

    def record_transfer(self, nbytes, direction="h2d"):
        self.ledger._book_transfer(self, int(nbytes), direction)


class Ledger:
    def __init__(self):
        self._lock = threading.Lock()
        # one settler at a time, so pairs fold in launch order
        self._settle_lock = threading.Lock()
        self._sites = {}
        self._principals = {}
        self.totals = _Accum()
        self.started = time.monotonic()
        # (seq, site, principal weights, start event, end event, n, sig)
        # not yet read, in launch order; _folded is the seq of the newest
        # pair read or dropped
        self._pending: deque = deque()
        self._pend_seq = 0
        self._folded = 0
        self.timings_dropped = 0
        # pairs whose read raised (a sticky CUDA error): the non-waiting
        # reads of the samplers count it and carry on
        self.settle_errors = 0
        # the recompile-storm detector's knobs and callbacks, as JAX's;
        # with no compile event (module docstring) it never trips
        self.storm_threshold = 8
        self.storm_window_s = 60.0
        self.warmup_s = 0.0
        self._warm_mark = False
        self.storms: deque = deque(maxlen=8)
        self._storm_callbacks = []

    # -- registration -----------------------------------------------------
    def site(self, name) -> Site:
        with self._lock:
            s = self._sites.get(name)
            if s is None:
                s = self._sites[name] = Site(name, self)
        return s

    def reset_sites(self, names) -> None:
        """Zero the named sites' tables and prices; their unread event
        pairs are dropped. The totals and the principal rows keep
        counting."""
        names = set(names)
        with self._settle_lock, self._lock:
            for name in names:
                site = self._sites.get(name)
                if site is not None:
                    site.acc = _Accum()
                    site.sig_ms = {}
            self._pending = deque(p for p in self._pending if p[1].name not in names)

    def reset(self) -> None:
        """Zero every table and re-arm the storm detector (tests, benches).
        Registered sites and storm callbacks survive; unread pairs are
        dropped."""
        with self._settle_lock, self._lock:
            for s in self._sites.values():
                s.acc = _Accum()
                s.sig_ms = {}
            self._principals.clear()
            self.totals = _Accum()
            self.started = time.monotonic()
            self._pending.clear()
            self._folded = self._pend_seq
            self.timings_dropped = 0
            self.settle_errors = 0
            self._warm_mark = False
            self.storms.clear()

    # -- recompile-storm detector (module docstring: never trips) ---------
    def on_storm(self, cb) -> None:
        """Register ``cb(bundle)`` to run when a recompile storm trips."""
        with self._lock:
            if cb not in self._storm_callbacks:
                self._storm_callbacks.append(cb)

    def configure_storm(self, threshold=None, window_s=None, warmup_s=None) -> None:
        with self._lock:
            if threshold is not None:
                self.storm_threshold = max(1, int(threshold))
            if window_s is not None:
                self.storm_window_s = float(window_s)
            if warmup_s is not None:
                self.warmup_s = float(warmup_s)

    def mark_warm(self) -> None:
        self._warm_mark = True

    @property
    def warm(self) -> bool:
        if self._warm_mark:
            return True
        return (time.monotonic() - self.started) >= self.warmup_s > 0

    # per-site sig-class price rows kept (first come; a site's sigs are a
    # handful of classes) and the EWMA smoothing factor, as in JAX
    _MAX_SIG_CLASSES = 32
    _SIG_EWMA_ALPHA = 0.25

    def measured_ms(self, site_name, sig_class):
        """(launches, EWMA device ms a launch) of one site's sig class, or
        None before any pair of that class was read. The finished pairs are
        read first, without waiting on the card: the planner reads this once
        a flight."""
        self.settle(wait=False)
        with self._lock:
            s = self._sites.get(site_name)
            row = None if s is None else s.sig_ms.get(str(sig_class))
            return None if row is None else (row[0], row[1])

    def tenant_totals(self) -> dict:
        """Per-tenant sums over the principal table (device ms, launches,
        transfer bytes): the QoS governor's debt source. The finished pairs
        are read first, without waiting on the card."""
        self.settle(wait=False)
        with self._lock:
            out: dict = {}
            for (tenant, _idx, _cls), row in self._principals.items():
                t = out.get(tenant)
                if t is None:
                    t = out[tenant] = {
                        "deviceMs": 0.0, "compileMs": 0.0, "launches": 0,
                        "transferBytes": 0,
                    }
                t["deviceMs"] += row.device_ms
                t["launches"] += row.launches
                t["transferBytes"] += row.h2d_bytes + row.d2h_bytes
        for t in out.values():
            t["deviceMs"] = round(t["deviceMs"], 3)
        return out

    # -- principal table --------------------------------------------------
    def _principal_row(self, principal) -> _Accum:
        # caller holds self._lock
        row = self._principals.get(principal)
        if row is None:
            if len(self._principals) >= _MAX_PRINCIPALS:
                principal = _OVERFLOW_PRINCIPAL
                row = self._principals.get(principal)
                if row is None:
                    row = self._principals[principal] = _Accum()
            else:
                row = self._principals[principal] = _Accum()
        return row

    # -- booking ----------------------------------------------------------
    def _book_launch(self, site, n, wall_ms):
        weights = ambient_weights()
        with self._lock:
            site.acc.launches += n
            site.acc.launch_ms += wall_ms
            self.totals.launches += n
            self.totals.launch_ms += wall_ms
            for principal, w in weights:
                row = self._principal_row(principal)
                row.launches += max(1, round(n * w)) if n else 0
                row.launch_ms += wall_ms * w

    def _book_device_ms(self, site, weights, ms, n=1, sig=None):
        # caller holds self._lock
        site.acc.device_ms += ms
        self.totals.device_ms += ms
        for principal, w in weights:
            self._principal_row(principal).device_ms += ms * w
        if sig is not None:
            cls = str(sig).split(None, 1)[0]
            per = ms / max(n, 1)
            row = site.sig_ms.get(cls)
            if row is not None:
                row[0] += n
                row[1] += self._SIG_EWMA_ALPHA * (per - row[1])
            elif len(site.sig_ms) < self._MAX_SIG_CLASSES:
                site.sig_ms[cls] = [n, per]

    def _book_transfer(self, site, nbytes, direction):
        weights = ambient_weights()
        with self._lock:
            if direction == "d2h":
                site.acc.d2h_bytes += nbytes
                self.totals.d2h_bytes += nbytes
            else:
                site.acc.h2d_bytes += nbytes
                self.totals.h2d_bytes += nbytes
            for principal, w in weights:
                row = self._principal_row(principal)
                if direction == "d2h":
                    row.d2h_bytes += int(nbytes * w)
                else:
                    row.h2d_bytes += int(nbytes * w)

    # -- CUDA event pairs -------------------------------------------------
    def _pend(self, site, start, end, n=1, sig=None) -> None:
        weights = ambient_weights()
        with self._lock:
            self._pend_seq += 1
            self._pending.append((self._pend_seq, site, weights, start, end, n, sig))
            n = len(self._pending)
        if n >= _SETTLE_AT:
            self.settle(wait=False)
            with self._lock:
                while len(self._pending) > _MAX_PENDING:
                    self._folded = self._pending.popleft()[0]
                    self.timings_dropped += 1

    def _fold_finished(self, synced=None):
        """Fold the finished pairs at the head of the queue, in launch
        order; the caller holds ``_settle_lock``. Returns the end event of
        the first pair still running, or None when none is queued. Reads
        only ``Event.query()`` (``synced``, an end event already waited
        for, counts as finished): it never waits for the card."""
        while True:
            with self._lock:
                if not self._pending:
                    return None
                seq, site, weights, start, end, n, sig = self._pending[0]
            if end is not synced and not end.query():
                return end
            ms = float(start.elapsed_time(end))
            with self._lock:
                if self._pending and self._pending[0][0] == seq:
                    self._pending.popleft()
                    self._folded = seq
                    self._book_device_ms(site, weights, ms, n, sig)

    def settle(self, wait: bool = True) -> None:
        """Fold the device time of queued event pairs into the tables, in
        launch order.

        ``wait=False`` (the query path's and the samplers' form) folds the
        pairs already finished and returns at the first one still running;
        when another thread is folding it returns at once. ``wait=True``
        (the exposition routes') reads every pair queued when it was
        called, waiting for the launches still running with no lock held,
        so a launching thread never waits behind it."""
        if not wait:
            if not self._settle_lock.acquire(blocking=False):
                return
            try:
                self._fold_finished()
            finally:
                self._settle_lock.release()
            return
        with self._lock:
            target = self._pend_seq
        synced = None
        while True:
            with self._settle_lock:
                running = self._fold_finished(synced)
                with self._lock:
                    done = self._folded >= target
            if done or running is None:
                return
            running.synchronize()  # no lock held: launches go on
            synced = running

    # -- exposition -------------------------------------------------------
    def counters(self) -> dict:
        """Flat counter map for cheap before/after deltas (the flight
        recorder's segments, the metrics history, the black box), with
        JAX's keys. It reads only the pairs already finished and never
        waits for the card; a pair whose read raises (a sticky CUDA error)
        is counted in ``settleErrors`` and the host counts still come
        back."""
        try:
            self.settle(wait=False)
        except RuntimeError:
            with self._lock:
                self.settle_errors += 1
        with self._lock:
            out = {
                "compiles": 0,
                "compileMs": 0.0,
                "launches": self.totals.launches,
                "deviceMs": round(self.totals.device_ms, 3),
                "h2dBytes": self.totals.h2d_bytes,
                "d2hBytes": self.totals.d2h_bytes,
                "storms": len(self.storms),
                "pendingTimings": len(self._pending),
                "settleErrors": self.settle_errors,
            }
            for name, s in self._sites.items():
                out[f"site.{name}.compiles"] = 0
                out[f"site.{name}.launches"] = s.acc.launches
                out[f"site.{name}.transferBytes"] = (
                    s.acc.h2d_bytes + s.acc.d2h_bytes
                )
        return out

    def site_device_ms(self) -> dict:
        """site name -> (launches, device ms), every pair read first."""
        self.settle()
        with self._lock:
            return {
                name: (s.acc.launches, s.acc.device_ms)
                for name, s in self._sites.items()
            }

    def snapshot(self) -> dict:
        self.settle()
        uptime = max(time.monotonic() - self.started, 1e-9)
        with self._lock:
            sites = {}
            for name, s in sorted(self._sites.items()):
                d = s.acc.to_dict(uptime)
                if s.sig_ms:
                    d["measuredMs"] = {
                        cls: {"launches": row[0], "ewmaMs": round(row[1], 4)}
                        for cls, row in sorted(s.sig_ms.items())
                    }
                sites[name] = d
            principals = []
            for (tenant, idx, cls), row in sorted(self._principals.items()):
                p = row.to_dict(uptime)
                p["tenant"] = tenant
                p["index"] = idx
                p["opClass"] = cls
                principals.append(p)
            return {
                "uptimeSec": round(uptime, 3),
                "totals": self.totals.to_dict(uptime),
                "sites": sites,
                "principals": principals,
                "timingsDropped": self.timings_dropped,
            }

    def prometheus_text(self) -> str:
        self.settle()
        out = []

        def emit(metric, help_text, rows):
            out.append(f"# HELP pilosa_{metric} {help_text}")
            out.append(f"# TYPE pilosa_{metric} counter")
            for labels, value in rows:
                lbl = ",".join(f'{k}="{v}"' for k, v in labels)
                out.append(f"pilosa_{metric}{{{lbl}}} {value}")

        with self._lock:
            site_rows = [(n, s.acc) for n, s in sorted(self._sites.items())]
            prin_rows = sorted(self._principals.items())
        emit(
            "dev_launches",
            "device launches per ledger site",
            [((("site", n),), a.launches) for n, a in site_rows],
        )
        emit(
            "dev_device_ms",
            "device launch milliseconds per ledger site",
            [((("site", n),), round(a.device_ms, 3)) for n, a in site_rows],
        )
        emit(
            "dev_transfer_bytes",
            "host<->device bytes per ledger site",
            [
                ((("site", n), ("direction", "h2d")), a.h2d_bytes)
                for n, a in site_rows
            ]
            + [
                ((("site", n), ("direction", "d2h")), a.d2h_bytes)
                for n, a in site_rows
            ],
        )
        emit(
            "dev_tenant_launches",
            "device launches per principal",
            [
                (
                    (("tenant", t), ("index", i), ("op_class", c)),
                    a.launches,
                )
                for (t, i, c), a in prin_rows
            ],
        )
        emit(
            "dev_tenant_device_ms",
            "device milliseconds per principal",
            [
                (
                    (("tenant", t), ("index", i), ("op_class", c)),
                    round(a.device_ms, 3),
                )
                for (t, i, c), a in prin_rows
            ],
        )
        emit(
            "dev_tenant_transfer_bytes",
            "host<->device bytes per principal",
            [
                (
                    (("tenant", t), ("index", i), ("op_class", c)),
                    a.h2d_bytes + a.d2h_bytes,
                )
                for (t, i, c), a in prin_rows
            ],
        )
        return "\n".join(out) + "\n"


_LEDGER = Ledger()


def ledger() -> Ledger:
    return _LEDGER


def site(name) -> Site:
    return _LEDGER.site(name)


def snapshot() -> dict:
    return _LEDGER.snapshot()


def measured_ms(site_name, sig_class):
    return _LEDGER.measured_ms(site_name, sig_class)


def tenant_totals() -> dict:
    return _LEDGER.tenant_totals()


def counters() -> dict:
    return _LEDGER.counters()


def reset() -> None:
    _LEDGER.reset()


def mark_warm() -> None:
    _LEDGER.mark_warm()


def configure_storm(threshold=None, window_s=None, warmup_s=None) -> None:
    _LEDGER.configure_storm(threshold, window_s, warmup_s)


def on_storm(cb) -> None:
    _LEDGER.on_storm(cb)


def prometheus_text() -> str:
    return _LEDGER.prometheus_text()

