"""The port's continuous-batching plane (``pilosa_tpu_torch/server/batcher.py``)
against ``pilosa_tpu/server/batcher.py``, on the CPU.

Each scenario runs on a JAX ``QueryBatcher`` and on the port's, each in
front of the same stub executor (its gate parks the dispatcher mid-flight
while the queue fills; a query named ``q-err`` fails alone), and returns a
trace: the flights dispatched, each request's answer or error, and the
window-close reason and flight size its profile carries. The traces must
be equal: every close reason (size, age, empty, deadline, drain), a
faulted member isolated from its flight, a request expiring in the queue
without paying device work, the deadline bypass, and the drain on close.
Then the port's API at its defaults (batcher, result cache, planner, QoS)
answers a concurrent read mix as the direct path does, in flights of
more than one query.
"""

# the port's lock witness, installed before the port is imported so that its
# module-level locks are wrapped too (pilosa_tpu_torch/testing/lockwitness.py)
from pilosa_tpu_torch.testing import lockwitness as port_lockwitness

port_lockwitness.install()
# the module fixture that asserts no new inversion among the port's locks
from pilosa_tpu_torch.testing.lockwitness import no_new_inversion  # noqa: F401

import gc
import threading
import time

import numpy as np
import pytest

from pilosa_tpu import deadline as jax_deadline
from pilosa_tpu.obs import qprofile as jax_qprofile
from pilosa_tpu.server.batcher import QueryBatcher as JaxBatcher
from pilosa_tpu_torch import deadline as torch_deadline
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.obs import qprofile as torch_qprofile
from pilosa_tpu_torch.server.api import API
from pilosa_tpu_torch.server.batcher import QueryBatcher as TorchBatcher
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

PKGS = {
    "jax": (JaxBatcher, jax_deadline, jax_qprofile),
    "torch": (TorchBatcher, torch_deadline, torch_qprofile),
}


@pytest.fixture(autouse=True)
def _collect_after_each_test():
    yield
    gc.collect()


class StubExecutor:
    """Records every dispatch; ``gate`` (when cleared) parks execute_batch
    (``entered`` tells the dispatcher reached it)."""

    def __init__(self):
        self.gate = threading.Event()
        self.gate.set()
        self.entered = threading.Event()
        self.batches: list[list] = []
        self.direct: list = []

    def execute(self, index, query, shards=None):
        self.direct.append(query)
        return [f"direct:{query}"]

    def execute_batch(self, index, queries):
        self.entered.set()
        self.gate.wait(10)
        self.batches.append([q for q, _ in queries])
        return [
            RuntimeError(f"failed {q}") if q == "q-err" else [f"r:{q}"]
            for q, _ in queries
        ]


def _bg(fn, *args):
    t = threading.Thread(target=fn, args=args, daemon=True)
    t.start()
    return t


def _park(b, stub):
    stub.gate.clear()
    stub.entered.clear()
    t = _bg(b.submit, "i", "sacrificial")
    assert stub.entered.wait(5)
    return t


def _wait_depth(b, n):
    for _ in range(400):
        with b._lock:
            if b._depth == n:
                return
        time.sleep(0.005)
    raise AssertionError(f"queue never reached depth {n}")


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # the trace records the error's type
        return ("error", type(e).__name__)


def _profiled(pkg, b, q, budget=None):
    _, dl, qp = PKGS[pkg]
    prof = qp.QueryProfile("i", q)
    with qp.activate(prof), dl.scope(budget):
        res = _outcome(lambda: b.submit("i", q))
    spans = {c.name: c.tags for c in prof.root.children}
    tags = spans.get("batcher.queueWait", {})
    return res, tags.get("closeReason"), tags.get("batchSize")


def scenario_empty(pkg):
    stub = StubExecutor()
    b = PKGS[pkg][0](stub, window=0.25, max_batch=4)
    try:
        t0 = time.perf_counter()
        out = _profiled(pkg, b, "q0")
        assert time.perf_counter() - t0 < 0.2  # no window dead time
        return [out, stub.batches]
    finally:
        b.close()


def scenario_size(pkg):
    stub = StubExecutor()
    b = PKGS[pkg][0](stub, window=0.25, max_batch=4)
    try:
        sac = _park(b, stub)
        res = {}
        ts = [_bg(lambda q=f"q{i}": res.__setitem__(q, _profiled(pkg, b, q))) for i in range(4)]
        _wait_depth(b, 5)
        stub.gate.set()
        for t in [sac, *ts]:
            t.join(10)
        return [sorted(res.items()), [sorted(x) for x in stub.batches], b.coalesced]
    finally:
        stub.gate.set()
        b.close()


def scenario_age(pkg):
    stub = StubExecutor()
    b = PKGS[pkg][0](stub, window=0.05, max_batch=100)
    try:
        b._q.empty = lambda: False  # the sustained-arrival regime
        t0 = time.perf_counter()
        out = _profiled(pkg, b, "q0")
        assert time.perf_counter() - t0 >= 0.04
        return [out]
    finally:
        del b._q.empty
        b.close()


def scenario_deadline_admission_and_bypass(pkg):
    stub = StubExecutor()
    b = PKGS[pkg][0](stub, window=0.25, max_batch=4)
    _, dl, _ = PKGS[pkg]
    try:
        with dl.scope(1e-9):
            expired = _outcome(lambda: b.submit("i", "q-expired"))
        with dl.scope(0.05):  # budget < window: dispatched at once, alone
            bypass = _outcome(lambda: b.submit("i", "q-urgent"))
        return [expired, bypass, stub.direct, stub.batches]
    finally:
        b.close()


def scenario_expiry_in_queue(pkg):
    stub = StubExecutor()
    b = PKGS[pkg][0](stub, window=0.001, max_batch=4)
    _, dl, _ = PKGS[pkg]
    try:
        sac = _park(b, stub)
        err = []

        def victim():
            with dl.scope(0.05):
                err.append(_outcome(lambda: b.submit("i", "q-doomed")))

        _bg(victim).join(5)
        stub.gate.set()
        sac.join(10)
        b.close()
        return [err, [x for x in stub.batches if "q-doomed" in x]]
    finally:
        stub.gate.set()
        b.close()


def scenario_turns_urgent(pkg):
    stub = StubExecutor()
    b = PKGS[pkg][0](stub, window=0.2, max_batch=100)
    try:
        sac = _park(b, stub)
        out = []
        t = _bg(lambda: out.append(_profiled(pkg, b, "q-tight", budget=0.6)))
        _wait_depth(b, 2)
        time.sleep(0.45)
        stub.gate.set()
        for th in (sac, t):
            th.join(10)
        return out
    finally:
        stub.gate.set()
        b.close()


def scenario_isolation(pkg):
    stub = StubExecutor()
    b = PKGS[pkg][0](stub, window=0.25, max_batch=4)
    try:
        sac = _park(b, stub)
        res = {}
        ts = [_bg(lambda q=q: res.__setitem__(q, _outcome(lambda: b.submit("i", q))))
              for q in ("q-ok1", "q-err", "q-ok2", "q-ok3")]
        _wait_depth(b, 5)
        stub.gate.set()
        for t in [sac, *ts]:
            t.join(10)
        return [sorted(res.items()), [sorted(x) for x in stub.batches]]
    finally:
        stub.gate.set()
        b.close()


def scenario_drain(pkg):
    stub = StubExecutor()
    b = PKGS[pkg][0](stub, window=0.25, max_batch=16)
    sac = _park(b, stub)
    res = {}
    ts = [_bg(lambda q=f"q{i}": res.__setitem__(q, _profiled(pkg, b, q))) for i in range(3)]
    _wait_depth(b, 4)
    closer = _bg(b.close)
    time.sleep(0.05)
    stub.gate.set()
    closer.join(10)
    for t in [sac, *ts]:
        t.join(10)
    late = _outcome(lambda: b.submit("i", "late"))
    b.close()  # idempotent
    return [sorted(res.items()), late, stub.direct, not closer.is_alive()]


SCENARIOS = [scenario_empty, scenario_size, scenario_age,
             scenario_deadline_admission_and_bypass, scenario_expiry_in_queue,
             scenario_turns_urgent, scenario_isolation, scenario_drain]
EXPECT = {
    "scenario_empty": lambda tr: tr[0][1:] == ("empty", 1),
    "scenario_size": lambda tr: {x[1][1] for x in tr[0]} == {"size"} and tr[2] == 4,
    "scenario_age": lambda tr: tr[0][1] == "age",
    "scenario_deadline_admission_and_bypass": lambda tr: (
        tr[0] == ("error", "DeadlineExceeded") and tr[2] == ["q-urgent"] and tr[3] == []),
    "scenario_expiry_in_queue": lambda tr: tr[0] == [("error", "DeadlineExceeded")] and not tr[1],
    "scenario_turns_urgent": lambda tr: tr[0][1] == "deadline",
    "scenario_isolation": lambda tr: dict(tr[0])["q-err"] == ("error", "RuntimeError"),
    "scenario_drain": lambda tr: {x[1][1] for x in tr[0]} == {"drain"} and tr[1] == (
        "ok", ["direct:late"]) and tr[3],
}


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_window_and_deadline_scenarios_trace_as_jax(scenario):
    want = scenario("jax")
    got = scenario("torch")
    assert got == want
    assert EXPECT[scenario.__name__](got), got


def _api_with_data(**kw):
    api = API(Holder(device="cpu"), **kw)
    api.create_index("i")
    api.create_field("i", "f")
    api.create_field("i", "g")
    rng = np.random.default_rng(3)
    cols = rng.integers(0, 3 * SHARD_WIDTH, 3000).tolist()
    api.import_bits("i", "f", {"rowIDs": rng.integers(0, 6, 3000).tolist(), "columnIDs": cols})
    api.import_bits("i", "g", {"rowIDs": rng.integers(0, 4, 3000).tolist(), "columnIDs": cols})
    return api


MIX = (
    [f"Count(Intersect(Row(f={a}), Row(g={b})))" for a in range(6) for b in range(4)]
    + ["TopN(f)", "TopN(f, Row(g=1))", "GroupBy(Rows(f), Rows(g))", "Row(f=2)",
       "Count(Union(Row(f=1), Row(f=2), Row(g=3)))", "Count(Not(Row(f=0)))", "Rows(g)"]
)


def test_defaults_answer_a_concurrent_mix_as_the_direct_path_in_flights():
    direct = _api_with_data(batch_window=0, rescache_entries=0, planner_enabled=False)
    assert direct.batcher is None and direct.qos is None
    # a window long enough that concurrent clients share flights
    api = _api_with_data(batch_window=0.05)
    assert api.batcher is not None and api.qos is not None and api.prefetcher is not None
    try:
        want = {q: direct.query("i", q) for q in MIX}
        got: dict = {}
        barrier = threading.Barrier(8)

        def client(c):
            barrier.wait(10)
            for k in range(len(MIX)):
                q = MIX[(c * 5 + k) % len(MIX)]
                got.setdefault(q, []).append(api.query("i", q))

        ts = [_bg(client, c) for c in range(8)]
        for t in ts:
            t.join(60)
        for q in MIX:
            assert all(a == want[q] for a in got[q]), q
        snap = api.batcher.snapshot()
        assert snap["batches"] >= 1 and snap["coalesced"] >= 2
        assert api.executor.rescache.snapshot()["hits"] >= 1
        # a write through the direct path invalidates, the next answers move
        api.query("i", "Set(5, f=0)")
        direct.query("i", "Set(5, f=0)")
        for q in MIX:
            assert api.query("i", q) == direct.query("i", q), q
    finally:
        api.close()
        direct.close()


def test_api_defaults_are_jax_defaults():
    import inspect

    from pilosa_tpu.server.api import API as JaxAPI
    from pilosa_tpu.server.node import NodeServer as JaxNode
    from pilosa_tpu_torch.server.node import NodeServer

    from pilosa_tpu.exec.rescache import ResultCache as JaxCache
    from pilosa_tpu.server.qos import QosGovernor as JaxQos
    from pilosa_tpu_torch.exec.rescache import ResultCache
    from pilosa_tpu_torch.ingest import IngestPipeline
    from pilosa_tpu_torch.server.qos import QosGovernor

    def defaults(fn, names):
        params = inspect.signature(fn).parameters
        return {k: params[k].default for k in names}

    # the serving knobs on the node and the API
    knobs = ("batch_window", "batch_max_size", "rescache_entries", "planner_enabled",
             "qos_enabled")
    for ours, theirs in ((API, JaxAPI), (NodeServer, JaxNode)):
        assert defaults(ours, knobs) == defaults(theirs, knobs)
    # the rest keep JAX's defaults where they live: the governor, the
    # cache, and the pipeline (JAX passes the API's through)
    qos = ("enabled", "down_factor", "stage_hold", "relax_hold", "tick_interval",
           "retry_after", "aggressor_share")
    assert defaults(QosGovernor, qos) == defaults(JaxQos, qos)
    cache = ("entries", "promote_hits", "demote_deltas")
    assert defaults(ResultCache, cache) == defaults(JaxCache, cache)
    assert defaults(IngestPipeline, ("staging_buffers", "upload_slots")) == {
        k: v for k, v in zip(("staging_buffers", "upload_slots"), defaults(
            JaxAPI, ("ingest_staging_buffers", "ingest_upload_slots")).values())}
