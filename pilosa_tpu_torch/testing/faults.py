"""Deterministic fault injection for chaos tests.

Counterpart of ``pilosa_tpu/testing/faults.py``, the port's own copy.

The reference exercises failure handling with container-level tooling
(pumba pause in internal/clustertests) — coarse, slow, and
whole-process.  This registry injects faults at the two I/O boundaries
where partial failure actually manifests, so chaos scenarios become
ordinary reproducible pytest cases:

* the internal client's connection pool (``cluster/client.py``):
  ``reset`` (connection reset before the request is sent), ``slow``
  (a peer that stalls until the caller's socket timeout fires), and
  ``error`` (a synthetic HTTP error response);
* the fragment store's write path (``storage/fragmentfile.py``):
  ``disk_write_fail`` (an OSError from the op-log append or snapshot
  rewrite).

Rules match by fnmatch pattern — peer netloc (``127.0.0.1:9101``) and
request route for network faults, file path for disk faults — and fire
``times`` times (None = unlimited) with probability ``p`` drawn from
the registry's SEEDED RNG, so a probabilistic chaos run replays
identically under the same seed.

Hook points are module-level functions (``network_fault``,
``disk_write_fault``) that cost one global read when no registry is
installed — the production hot path pays nothing.
"""

from __future__ import annotations

import fnmatch
import random
import threading
import time

KINDS_NETWORK = ("reset", "slow", "error")
KINDS_DISK = ("disk_write_fail",)
# "crash" fires at named protocol stages (resize/migration phase
# boundaries call ``stage_fault("coordinator:flip")`` etc.) and raises
# CrashError there — a surgical stand-in for killing that participant
# at exactly that point in the protocol.
KINDS_STAGE = ("crash",)
KINDS = KINDS_NETWORK + KINDS_DISK + KINDS_STAGE


class CrashError(RuntimeError):
    """Raised by a fired ``crash`` rule: the participant 'dies' at this
    protocol stage (the surrounding code must treat it like any other
    unexpected failure)."""


class Fault:
    """One injection rule; mutate ``times``/inspect ``hits`` freely."""

    def __init__(
        self,
        kind: str,
        peer: str | None = None,
        route: str | None = None,
        path: str | None = None,
        stage: str | None = None,
        delay: float = 0.0,
        code: int = 503,
        times: int | None = None,
        p: float = 1.0,
    ):
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r} (one of {KINDS})")
        self.kind = kind
        self.peer = peer      # fnmatch on netloc, e.g. "127.0.0.1:91*"
        self.route = route    # fnmatch on request path, e.g. "/index/*"
        self.path = path      # fnmatch on file path (disk faults)
        self.stage = stage    # fnmatch on stage name (crash faults)
        self.delay = float(delay)
        self.code = int(code)
        self.times = times    # remaining firings; None = unlimited
        self.p = float(p)
        self.hits = 0         # observability: how often this rule fired

    def matches_network(self, netloc: str, route: str) -> bool:
        if self.kind not in KINDS_NETWORK:
            return False
        if self.peer is not None and not fnmatch.fnmatch(netloc, self.peer):
            return False
        if self.route is not None and not fnmatch.fnmatch(route, self.route):
            return False
        return True

    def matches_disk(self, path: str) -> bool:
        if self.kind not in KINDS_DISK:
            return False
        return self.path is None or fnmatch.fnmatch(path, self.path)

    def matches_stage(self, stage: str) -> bool:
        if self.kind not in KINDS_STAGE:
            return False
        return self.stage is None or fnmatch.fnmatch(stage, self.stage)


class FaultRegistry:
    """Thread-safe rule set with a seeded RNG for probabilistic rules."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._faults: list[Fault] = []
        # Observer called OUTSIDE the registry lock after a rule fires:
        # fn(kind, target) — the test cluster wires this into the event
        # journal so injected faults appear on the cluster timeline.
        self.on_fire = None

    def add(self, kind: str, **kw) -> Fault:
        fault = Fault(kind, **kw)
        with self._lock:
            self._faults.append(fault)
        return fault

    def remove(self, fault: Fault) -> None:
        with self._lock:
            if fault in self._faults:
                self._faults.remove(fault)

    def clear(self) -> None:
        with self._lock:
            self._faults.clear()

    def _fire(self, fault: Fault) -> bool:
        """Consume one firing of a matched rule (lock held by caller)."""
        if fault.times is not None and fault.times <= 0:
            return False
        if fault.p < 1.0 and self._rng.random() >= fault.p:
            return False
        if fault.times is not None:
            fault.times -= 1
        fault.hits += 1
        return True

    # -- hook implementations ----------------------------------------------

    def network_fault(
        self, netloc: str, route: str, timeout: float | None
    ) -> tuple[int, bytes, str] | None:
        """Apply the first matching network rule.

        ``reset`` raises ConnectionResetError; ``slow`` emulates a
        stalled peer faithfully — the caller blocks for
        ``min(delay, socket timeout)`` and gets TimeoutError if the
        stall outlives its timeout; ``error`` short-circuits with a
        synthetic ``(status, body, content-type)`` response."""
        with self._lock:
            fired = None
            for fault in self._faults:
                if fault.matches_network(netloc, route) and self._fire(fault):
                    fired = fault
                    break
        if fired is None:
            return None
        self._notify(fired, f"{netloc}{route}")
        if fired.kind == "reset":
            raise ConnectionResetError(
                f"fault-injected connection reset ({netloc}{route})"
            )
        if fired.kind == "slow":
            stall = fired.delay
            if timeout is not None and timeout >= 0:
                stall = min(stall, timeout)
            time.sleep(stall)
            if timeout is not None and fired.delay > timeout:
                raise TimeoutError(
                    f"fault-injected slow peer ({netloc}{route}): "
                    f"stalled past the {timeout:.3f}s socket timeout"
                )
            return None  # delay fit in the timeout; request proceeds
        # error
        body = (
            '{"error": "fault-injected error %d"}' % fired.code
        ).encode()
        return fired.code, body, "application/json"

    def disk_write_fault(self, path: str) -> None:
        with self._lock:
            fired = None
            for fault in self._faults:
                if fault.matches_disk(path) and self._fire(fault):
                    fired = fault
                    break
        if fired is not None:
            self._notify(fired, path)
            raise OSError(f"fault-injected disk write failure: {path}")

    def stage_fault(self, stage: str) -> None:
        """Crash the caller at a named protocol stage.  Stage names are
        ``<role>:<phase>`` (e.g. ``coordinator:flip``, ``source:chunk``,
        ``target:apply``); rules fnmatch against them."""
        with self._lock:
            fired = None
            for fault in self._faults:
                if fault.matches_stage(stage) and self._fire(fault):
                    fired = fault
                    break
        if fired is not None:
            self._notify(fired, stage)
            raise CrashError(f"fault-injected crash at stage: {stage}")

    def _notify(self, fault: Fault, target: str) -> None:
        """Invoke the observer (no lock held); observer bugs never mask
        the fault being injected."""
        cb = self.on_fire
        if cb is None:
            return
        try:
            cb(fault.kind, target)
        except Exception:  # graftlint: disable=exception-hygiene -- observer is best-effort; a journal bug must not mask the injected fault
            pass


# -- global hook points ------------------------------------------------------

_active: FaultRegistry | None = None


def install(registry: FaultRegistry) -> FaultRegistry:
    global _active
    _active = registry
    return registry


def uninstall(registry: FaultRegistry | None = None) -> None:
    """Remove the active registry (or only ``registry`` if given and
    active — lets overlapping harnesses not clobber each other)."""
    global _active
    if registry is None or _active is registry:
        _active = None


def active() -> FaultRegistry | None:
    return _active


def network_fault(
    netloc: str, route: str, timeout: float | None
) -> tuple[int, bytes, str] | None:
    """Hook point: called by the internal client's pool per request."""
    registry = _active
    if registry is None:
        return None
    return registry.network_fault(netloc, route, timeout)


def disk_write_fault(path: str) -> None:
    """Hook point: called by FragmentFile before op-log/snapshot writes."""
    registry = _active
    if registry is not None:
        registry.disk_write_fault(path)


def stage_fault(stage: str) -> None:
    """Hook point: called at resize/migration protocol stage boundaries."""
    registry = _active
    if registry is not None:
        registry.stage_fault(stage)
