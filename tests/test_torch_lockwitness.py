"""The port's lock witness (``pilosa_tpu_torch/testing/lockwitness.py``)
held to the JAX package's witness tests (``tests/test_lockwitness.py``):
a seeded inversion trips it deterministically, its correct-order twin does
not, and the edge semantics (try-acquire, re-entrancy, ``Condition.wait``)
are the same. The seeded locks are allocated in this file, which the cases
add to the port's scope for their duration.

It also shows the chaining: with the JAX package's witness installed first
(as the test session does), a lock allocated in
``pilosa_tpu_torch/server/batcher.py`` is the port's witness, a lock
allocated in ``pilosa_tpu/server/batcher.py`` stays the JAX witness's, and
uninstalling the port's puts JAX's factories back.
"""

# the port's lock witness, installed before the port is imported so that its
# module-level locks are wrapped too (pilosa_tpu_torch/testing/lockwitness.py)
from pilosa_tpu_torch.testing import lockwitness as port_lockwitness

port_lockwitness.install()
# the module fixture that asserts no new inversion among the port's locks
from pilosa_tpu_torch.testing.lockwitness import no_new_inversion  # noqa: F401

import os
import queue
import threading

import pytest

from pilosa_tpu.testing import lockwitness as jax_lockwitness
from pilosa_tpu_torch.testing.lockwitness import LockOrderInversion

lockwitness = port_lockwitness


@pytest.fixture(autouse=True)
def _this_file_in_scope(monkeypatch):
    monkeypatch.setattr(
        lockwitness, "SCOPE", lockwitness.SCOPE + (f"{os.sep}test_torch_lockwitness.py",)
    )


def _two_locks():
    # distinct source lines => distinct allocation-site keys
    a = threading.Lock()
    b = threading.Lock()
    return a, b


def _join(t):
    t.join(timeout=10.0)
    assert not t.is_alive(), "worker thread hung"


def test_locks_of_this_file_are_the_ports_witness():
    with lockwitness.active(mode="raise"):
        a, _ = _two_locks()
        assert isinstance(a, lockwitness._WitnessLock)
        assert isinstance(threading.RLock(), lockwitness._WitnessRLock)


def test_single_thread_inversion_raises():
    with lockwitness.active(mode="raise"):
        a, b = _two_locks()
        with a:
            with b:
                pass
        with b:
            with pytest.raises(LockOrderInversion) as exc:
                with a:
                    pass
        msg = str(exc.value)
        assert "lock order inversion" in msg
        assert "test_torch_lockwitness.py" in msg


def test_two_thread_inversion_raises():
    with lockwitness.active(mode="raise"):
        a, b = _two_locks()

        def worker():
            with a:
                with b:
                    pass

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        _join(t)
        with b:
            with pytest.raises(LockOrderInversion):
                with a:
                    pass
        assert len(lockwitness.findings()) == 1


def test_correct_order_twin_is_clean():
    with lockwitness.active(mode="raise"):
        a, b = _two_locks()

        def worker():
            with a:
                with b:
                    pass

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        _join(t)
        with a:
            with b:
                pass
        assert lockwitness.findings() == []
        assert lockwitness.order_graph()


def test_trap_releases_the_lock():
    with lockwitness.active(mode="raise"):
        a, b = _two_locks()
        with a:
            with b:
                pass
        with b:
            with pytest.raises(LockOrderInversion):
                a.acquire()
        assert not a.locked()
        assert not b.locked()


def test_log_mode_records_without_raising():
    with lockwitness.active(mode="log"):
        a, b = _two_locks()
        with a:
            with b:
                pass
        with b:
            with a:
                pass
        [inv] = lockwitness.findings()
        assert "then" in inv["this_order"] and "then" in inv["prior_order"]


def test_pair_reported_once():
    with lockwitness.active(mode="log"):
        a, b = _two_locks()
        for _ in range(3):
            with a:
                with b:
                    pass
            with b:
                with a:
                    pass
        assert len(lockwitness.findings()) == 1


def test_try_acquire_records_no_edge():
    with lockwitness.active(mode="raise"):
        a, b = _two_locks()
        with a:
            assert b.acquire(blocking=False)
            b.release()
        with b:
            with a:
                pass
        assert lockwitness.findings() == []


def test_successful_try_acquire_still_enters_held_set():
    with lockwitness.active(mode="raise"):
        a, b = _two_locks()
        assert b.acquire(blocking=False)
        with a:  # records B -> A
            pass
        b.release()
        with a:
            with pytest.raises(LockOrderInversion):
                with b:
                    pass


def test_rlock_reentrancy_is_silent():
    with lockwitness.active(mode="raise"):
        r = threading.RLock()
        with r:
            with r:
                pass
        assert lockwitness.findings() == []
        assert lockwitness.order_graph() == {}


def test_same_allocation_site_nesting_is_reentrant():
    with lockwitness.active(mode="raise"):
        def make():
            return threading.Lock()

        x, y = make(), make()
        with x:
            with y:
                pass
        assert lockwitness.order_graph() == {}


def test_condition_wait_keeps_held_set_honest():
    with lockwitness.active(mode="raise"):
        lk = threading.RLock()
        cond = threading.Condition(lk)
        other = threading.Lock()
        started = threading.Event()

        def waiter():
            with cond:
                started.set()
                cond.wait(timeout=10.0)

        t = threading.Thread(target=waiter, daemon=True)
        t.start()
        assert started.wait(timeout=10.0)
        with other:
            with cond:
                cond.notify_all()
        _join(t)
        assert lockwitness.findings() == []


def test_out_of_scope_allocations_pass_through():
    with lockwitness.active(mode="raise"):
        q = queue.Queue()  # the standard library allocates its own locks
        q.put(1)
        assert q.get() == 1
        assert not isinstance(q.mutex, lockwitness._WitnessBase)


def test_active_restores_prior_state():
    before = lockwitness.stats()["installed"]
    with lockwitness.active(mode="log"):
        assert lockwitness.stats()["mode"] == "log"
    assert lockwitness.stats()["installed"] == before


def test_stats_shape():
    with lockwitness.active(mode="raise"):
        a, b = _two_locks()
        with a:
            with b:
                pass
        s = lockwitness.stats()
        assert s["mode"] == "raise"
        assert s["witnessedAcquires"] >= 2
        assert s["edges"] == 1
        assert s["inversions"] == 0


def test_the_ports_batcher_locks_are_witnessed_and_jaxs_stay_jaxs():
    from pilosa_tpu.server import batcher as jax_batcher
    from pilosa_tpu_torch.server import batcher as port_batcher

    if not jax_lockwitness.stats()["installed"]:
        jax_lockwitness.install("raise")
    lockwitness.install()
    port_lock = port_batcher._Flight("i", None, None).event._cond._lock
    assert isinstance(port_lock, lockwitness._WitnessLock)
    assert port_lock._key.startswith("pilosa_tpu_torch/server/batcher.py:")
    jax_lock = jax_batcher._Flight("i", None, None).event._cond._lock
    assert isinstance(jax_lock, jax_lockwitness._WitnessLock)
    assert jax_lock._key.startswith("pilosa_tpu/server/batcher.py:")
    # a lock of this file (outside the port's scope once the fixture's
    # patch is undone) goes on to the JAX witness, keyed on this file
    lockwitness.SCOPE = lockwitness.SCOPE[:1]
    mine = threading.Lock()
    assert isinstance(mine, jax_lockwitness._WitnessLock)
    assert mine._key.startswith("tests/test_torch_lockwitness.py:")


def test_uninstall_puts_the_earlier_factories_back():
    lockwitness.install()
    assert threading.Lock is lockwitness._make_lock
    before = lockwitness._prev[:]
    lockwitness.uninstall()
    try:
        assert [threading.Lock, threading.RLock] == before
    finally:
        lockwitness.install()
    assert threading.Lock is lockwitness._make_lock
    lockwitness.install()  # idempotent: no second link in the chain
    assert lockwitness._prev == before
