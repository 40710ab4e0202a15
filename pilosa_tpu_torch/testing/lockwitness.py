"""Runtime lockdep witness for the port's locks (counterpart of
``pilosa_tpu/testing/lockwitness.py``, the port's own copy).

The JAX package's witness wraps the locks allocated under ``pilosa_tpu/``,
``tools/`` and ``tests/``; this one wraps those allocated under
``pilosa_tpu_torch/``, with the same semantics: every such
``threading.Lock``/``RLock`` records an edge ``held -> acquired`` into a
process-global order graph on each acquisition, and the first acquisition
that would create the REVERSE of an already-seen edge (a two-lock
inversion, a deadlock waiting for the right interleaving) raises, or
logs, at the acquisition site, with both witness sites. The two orders
never have to deadlock to be caught: they only have to both happen.

Identity: locks are keyed by **allocation site** (file:line of the
``threading.Lock()`` call), so every instance of a class maps to one key.

* re-acquiring a key already held by this thread records nothing (RLock
  re-entrancy, and two instances of one class);
* non-blocking try-acquires record no edge, but a successful one enters
  the held set;
* ``Condition.wait`` releases and re-acquires through the wrapper's
  ``_release_save``/``_acquire_restore``, so the held set stays honest.

**Chaining.** Another witness may already own ``threading.Lock`` and
``threading.RLock`` (the JAX package's, which the test session installs
first). :func:`install` keeps whatever factories it finds and puts its own
in front of them: an allocation whose site is in the port gets a witness
over the true primitives (``_thread.allocate_lock`` and the C
``_thread.RLock``); every other allocation goes on to the factory that was
there before, which then sees the caller's frame as its own allocation
site (the two dispatch functions carry ``threading``'s file name, which
every witness skips). :func:`uninstall` puts the earlier factories back.
Installing again over factories that someone else replaced chains anew.

Enable it process-wide with :func:`install` (idempotent), or scoped with
``with lockwitness.active():`` in tests. The port's test modules install it
before they import the port, and import :func:`no_new_inversion`, the
module fixture that asserts at their end that it recorded no new
inversion. The mode comes from ``PILOSA_LOCKWITNESS`` (``raise`` | ``log``
| ``off``), as the JAX package's does.
"""

from __future__ import annotations

import _thread
import logging
import os
import sys
import threading
import traceback

import pytest

logger = logging.getLogger(__name__)

# The port's scope: only locks allocated from files under these path
# fragments are witnessed here.
SCOPE = (f"{os.sep}pilosa_tpu_torch{os.sep}",)

# This module's own file plus the stdlib threading module (whose name the
# dispatch functions carry): frames to skip when walking for the
# allocation or acquisition site. Exact-path match.
_SKIP_FILES = (os.path.abspath(__file__), threading.__file__)


class LockOrderInversion(Exception):
    """Two locks were acquired in both orders (potential deadlock)."""


class _State:
    """Process-global witness state (reset by tests)."""

    def __init__(self):
        self.guard = _thread.allocate_lock()
        # (a, b) -> short witness string for the first observed a-then-b
        self.edges: dict[tuple[str, str], str] = {}
        self.inversions: list[dict] = []
        self.inverted_pairs: set[frozenset] = set()
        self.mode = "off"
        self.installed = False
        self.acquires = 0  # observability: witnessed acquisitions
        self.tls = threading.local()

    def held(self) -> list:
        h = getattr(self.tls, "held", None)
        if h is None:
            h = self.tls.held = []
        return h


_state = _State()


def _alloc_site() -> str | None:
    """file:line of the port's frame allocating the lock; None when the
    allocation is out of the port's scope."""
    f = sys._getframe(1)
    while f is not None and f.f_code.co_filename in _SKIP_FILES:
        f = f.f_back
    if f is None:
        return None
    fn = f.f_code.co_filename
    if not any(s in fn for s in SCOPE):
        return None
    return f"{_relative(fn)}:{f.f_lineno}"


def _relative(fn: str) -> str:
    """Repo-relative, stable across checkouts."""
    for marker in ("pilosa_tpu_torch", "tests", "tools"):
        idx = fn.find(f"{os.sep}{marker}{os.sep}")
        if idx >= 0:
            return fn[idx + 1:].replace(os.sep, "/")
    return fn


def _acquire_site() -> str:
    f = sys._getframe(2)
    while f is not None and f.f_code.co_filename in _SKIP_FILES:
        f = f.f_back
    if f is None:  # pragma: no cover - only if called from module top
        return "?"
    return f"{_relative(f.f_code.co_filename)}:{f.f_lineno}"


def _note_acquired(key: str, blocking: bool) -> None:
    st = _state
    held = st.held()
    if any(k == key for k, _site in held):
        held.append((key, None))  # re-entrant depth marker; no edges
        return
    site = _acquire_site()
    st.acquires += 1
    if blocking and held:
        new_edges = []
        inversion = None
        with st.guard:
            for hkey, hsite in held:
                if hsite is None or hkey == key:
                    continue
                edge = (hkey, key)
                if edge not in st.edges:
                    new_edges.append((edge, f"{hsite} then {site}"))
                rev = (key, hkey)
                if rev in st.edges and frozenset(edge) not in st.inverted_pairs:
                    inversion = {
                        "locks": (hkey, key),
                        "thread": threading.current_thread().name,
                        "this_order": f"{hsite} then {site}",
                        "prior_order": st.edges[rev],
                        "stack": "".join(traceback.format_stack(limit=12)),
                    }
                    st.inverted_pairs.add(frozenset(edge))
                    st.inversions.append(inversion)
            for edge, witness in new_edges:
                st.edges[edge] = witness
        if inversion is not None:
            msg = (
                "lock order inversion: "
                f"{inversion['locks'][0]} <-> {inversion['locks'][1]} — "
                f"this thread ({inversion['thread']}): "
                f"{inversion['this_order']}; prior order: "
                f"{inversion['prior_order']}"
            )
            if st.mode == "raise":
                raise LockOrderInversion(msg)
            logger.error("%s\n%s", msg, inversion["stack"])
    held.append((key, site))


def _note_released(key: str) -> None:
    held = _state.held()
    for i in range(len(held) - 1, -1, -1):
        if held[i][0] == key:
            del held[i]
            return


class _WitnessBase:
    """Wrapper delegating to a real lock, recording order."""

    __slots__ = ("_inner", "_key")

    def __init__(self, inner, key):
        self._inner = inner
        self._key = key

    def acquire(self, blocking=True, timeout=-1):
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            try:
                # timeout-bounded acquisitions still count as blocking
                # intent: a thread CAN wait on them, which is what an
                # order edge models
                _note_acquired(self._key, blocking)
            except LockOrderInversion:
                # raise-mode trap: hand the lock back so the caller's
                # with-body never runs half-locked and peers can't hang
                self._inner.release()
                raise
        return ok

    def release(self):
        self._inner.release()
        _note_released(self._key)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._inner.locked()

    def __repr__(self):  # pragma: no cover - debug aid
        return f"<witness {self._key} of {self._inner!r}>"


class _WitnessLock(_WitnessBase):
    pass


class _WitnessRLock(_WitnessBase):
    """RLock wrapper: Condition integration needs the _release_save /
    _acquire_restore / _is_owned trio to route through the witness so
    the held set stays honest across ``wait()``."""

    __slots__ = ()

    def _is_owned(self):
        return self._inner._is_owned()

    def _release_save(self):
        state = self._inner._release_save()
        _note_released(self._key)
        return state

    def _acquire_restore(self, state):
        self._inner._acquire_restore(state)
        _note_acquired(self._key, blocking=True)

    def _at_fork_reinit(self):  # pragma: no cover - fork safety passthrough
        self._inner._at_fork_reinit()


# -- public API --------------------------------------------------------------


# The two dispatch functions are compiled under threading's file name, so
# that a witness chained behind this one, walking the stack for the
# allocation site, skips their frames as it skips threading's own.
_DISPATCH = """
def make_lock():
    if state.mode != "off":
        key = site()
        if key is not None:
            return WitnessLock(allocate_lock(), key)
    return prev[0]()


def make_rlock():
    if state.mode != "off":
        key = site()
        if key is not None:
            return WitnessRLock(c_rlock(), key)
    return prev[1]()
"""
_prev = [threading.Lock, threading.RLock]
_ns = {
    "state": _state, "site": _alloc_site, "prev": _prev,
    "WitnessLock": _WitnessLock, "WitnessRLock": _WitnessRLock,
    "allocate_lock": _thread.allocate_lock, "c_rlock": _thread.RLock,
}
exec(compile(_DISPATCH, threading.__file__, "exec"), _ns)
_make_lock = _ns["make_lock"]
_make_rlock = _ns["make_rlock"]


def _chained() -> bool:
    return threading.Lock is _make_lock and threading.RLock is _make_rlock


def install(mode: str | None = None) -> None:
    """Put the port's factories in front of ``threading.Lock``/``RLock``,
    so port-allocated locks are witnessed. ``mode``: ``raise`` (the first
    inversion raises at the acquisition site), ``log`` (recorded and
    logged) or ``off``; default from ``PILOSA_LOCKWITNESS`` (falling back
    to ``raise``). Idempotent; wraps only locks allocated after it."""
    if mode is None:
        mode = os.environ.get("PILOSA_LOCKWITNESS", "raise")
    if mode not in ("raise", "log", "off"):
        raise ValueError(f"unknown lockwitness mode {mode!r}")
    _state.mode = mode
    if mode == "off":
        return
    if not _chained():
        # whatever is there now (another witness, or the true factories)
        # takes every allocation outside the port
        _prev[:] = [threading.Lock, threading.RLock]
        threading.Lock = _make_lock
        threading.RLock = _make_rlock
    _state.installed = True


def uninstall() -> None:
    """Put back the factories that were there before :func:`install`.
    Locks already wrapped keep working (their inner lock is real)."""
    if _chained():
        threading.Lock, threading.RLock = _prev
    _state.installed = False
    _state.mode = "off"


class active:
    """``with lockwitness.active(mode="raise"):`` scoped install for
    tests; resets recorded state on entry, restores the previous
    install state (and clears the scope's recordings) on exit — safe
    inside a session conftest already runs under the witness."""

    def __init__(self, mode: str = "raise"):
        self.mode = mode
        self._prev: tuple[bool, str] | None = None

    def __enter__(self):
        self._prev = (_state.installed, _state.mode)
        reset()
        install(self.mode)
        return self

    def __exit__(self, *exc):
        installed, mode = self._prev
        if installed:
            _state.mode = mode
        else:
            uninstall()
        reset()
        return False


def findings() -> list[dict]:
    """Inversions recorded so far (log mode records without raising;
    raise mode records before raising, so a swallowed exception in a
    worker thread still shows up here)."""
    with _state.guard:
        return list(_state.inversions)


def order_graph() -> dict:
    """{(a, b): witness} — the live acquisition-order edges, for
    cross-checking against the static lock-graph pass."""
    with _state.guard:
        return dict(_state.edges)


def stats() -> dict:
    with _state.guard:
        return {
            "mode": _state.mode,
            "installed": _state.installed,
            "witnessedAcquires": _state.acquires,
            "edges": len(_state.edges),
            "inversions": len(_state.inversions),
        }


@pytest.fixture(scope="module", autouse=True)
def no_new_inversion():
    """A test module's fixture, imported by name into the module: no
    lock-order inversion among the port's locks while its tests ran."""
    install()
    seen = len(findings())
    yield
    assert findings()[seen:] == []


def reset() -> None:
    """Clear recorded edges/inversions (NOT the install state)."""
    with _state.guard:
        _state.edges.clear()
        _state.inversions.clear()
        _state.inverted_pairs.clear()
        _state.acquires = 0
