"""The port's QoS governor (``pilosa_tpu_torch/server/qos.py``) against
``pilosa_tpu/server/qos.py``, on the CPU.

Each scenario is a script of admissions, queue operations, ledger totals
and SLO pressure with explicit tick times (the taps of
``tests/test_qos.py``: a fake SLO tracker, a fake journal, an incident
list). It runs on a JAX governor and on the port's, and the traces must be
equal: every admission decision and shed, the pop order of the weighted
fair queues, the stages, the ladder's transitions and journal records, the
incidents and the snapshots (tenant rows, debt, cost estimates). Debt
conservation holds in both: the debt is the measured device ms fed in.
Last, the port's governor is fed by the port's own device ledger
(``devledger.tenant_totals``, event pairs stubbed for the CPU): each
tenant's debt equals its device ms in the ledger, a weighted flight
split included.
"""

# the port's lock witness, installed before the port is imported so that its
# module-level locks are wrapped too (pilosa_tpu_torch/testing/lockwitness.py)
from pilosa_tpu_torch.testing import lockwitness as port_lockwitness

port_lockwitness.install()
# the module fixture that asserts no new inversion among the port's locks
from pilosa_tpu_torch.testing.lockwitness import no_new_inversion  # noqa: F401

import queue
import time

import pytest

from pilosa_tpu.server import qos as jq
from pilosa_tpu_torch.obs import devledger
from pilosa_tpu_torch.server import qos as tq


class _Flight:
    def __init__(self, tenant: str, tag=None):
        self.principal = (tenant, "i", "read.count")
        self.tag = tag


class _Stop:
    """No ``principal``: the batcher's stop sentinel."""


class _Tracker:
    def __init__(self):
        self.on = False

    def pressure(self):
        if self.on:
            return {"alerts": [("read.count", "fast")], "latency": ["read.count"]}
        return {"alerts": [], "latency": []}


class _Journal:
    def __init__(self):
        self.events = []

    def record(self, type, **data):
        self.events.append({"type": type, **data})


def _rig(mod, **over):
    tracker, journal, incidents = _Tracker(), _Journal(), []
    totals = {}
    kw = dict(enabled=True, stage_hold=0.3, relax_hold=0.5, tick_interval=1e9,
              retry_after=2.0, slo_fn=lambda: tracker, journal_fn=lambda: journal,
              incident_fn=incidents.append, ledger_fn=lambda: totals,
              weights={"a": 3.0, "b": 1.0})
    kw.update(over)
    return mod.QosGovernor(**kw), tracker, journal, incidents, totals


def _drain(gov):
    out = []
    while True:
        try:
            item = gov.get(timeout=0.05)
        except queue.Empty:
            return out
        out.append(getattr(item, "tag", "stop"))
        if isinstance(item, _Stop):
            return out


def _admit(mod, gov, tenant, degradable=False):
    try:
        return gov.admit(tenant, can_degrade=degradable)
    except mod.ShedError as e:
        return ("shed", e.tenant, e.retry_after)


def _snap(gov):
    s = gov.snapshot()
    s.pop("vtime", None)
    return s


def scenario_wfq(mod):
    gov, *_ = _rig(mod)
    with gov._cond:
        gov._state_locked("c", time.monotonic()).stage = 2
    for k in range(30):
        for t in ("a", "b", "c"):
            gov.put(_Flight(t, f"{t}{k}"))
    gov.put(_Stop())
    order = _drain(gov)
    return [order, _snap(gov)]


def scenario_debt_and_costs(mod):
    gov, _tr, _j, _inc, totals = _rig(mod)
    trace = []
    steps = [({"a": 5.0, "b": 2.0}, 3, 1), ({"a": 12.5, "b": 2.0}, 2, 0),
             ({"a": 12.5, "b": 8.25, "c": 1.0}, 0, 4), ({"a": 40.0, "b": 8.25, "c": 1.0}, 5, 5)]
    base = time.monotonic()
    for i, (tot, na, nb) in enumerate(steps):
        for _ in range(na):
            gov.put(_Flight("a", "a"))
        for _ in range(nb):
            gov.put(_Flight("b", "b"))
        trace.append(_drain(gov))
        totals.clear()
        totals.update({t: {"deviceMs": ms} for t, ms in tot.items()})
        trace.append(gov.tick(base + i))
    snap = _snap(gov)
    fed = sum(v["deviceMs"] for v in totals.values())
    assert sum(t["debtMs"] for t in snap["tenants"].values()) == pytest.approx(fed, abs=1e-9)
    trace.append(gov.observe_ledger({"a": 3.0, "quiet": 0.0}))
    return trace + [snap, _snap(gov)]


def scenario_ladder(mod):
    gov, tracker, journal, incidents, _ = _rig(mod)
    base = time.monotonic()
    trace = []

    def offer():
        trace.append([_admit(mod, gov, "aggressor", degradable=True) for _ in range(10)])
        trace.append(_admit(mod, gov, "victim"))

    offer()
    tracker.on = True
    for t in (0.5, 0.9, 1.3, 1.7):
        trace.append(gov.tick(base + t))
        offer()
    tracker.on = False
    for i in range(4):
        trace.append(gov.tick(base + 2.1 + 0.6 * i))
        offer()
    return [trace, journal.events, incidents, _snap(gov)]


def scenario_ghost_and_stand_down(mod):
    gov, tracker, journal, incidents, _ = _rig(mod)
    base = time.monotonic()
    trace = [_admit(mod, gov, "ghost")]
    trace.append(gov.tick(base + 0.5))
    tracker.on = True
    for i in range(4):
        for _ in range(10):
            trace.append(_admit(mod, gov, "live"))
        trace.append(gov.tick(base + 1.0 + 0.5 * i))
    # a contest, then every neighbour goes quiet under pressure
    for i in range(3):
        for _ in range(10):
            trace.append(_admit(mod, gov, "noisy"))
        trace.append(_admit(mod, gov, "live"))
        trace.append(gov.tick(base + 3.5 + 0.4 * i))
    for i in range(4):
        trace.append(gov.tick(base + 5.0 + 0.6 * i))
    return [trace, journal.events, incidents, _snap(gov)]


def scenario_disabled_and_default_tenant(mod):
    gov, tracker, *_ = _rig(mod, enabled=False)
    tracker.on = True
    base = time.monotonic()
    trace = []
    for i in range(4):
        trace += [_admit(mod, gov, "x", True) for _ in range(10)] + [_admit(mod, gov, None)]
        trace.append(gov.tick(base + 0.5 * (i + 1)))
    trace.append(_admit(mod, gov, ""))
    gov.note_degraded_served(None)
    return [trace, _snap(gov)]


SCENARIOS = [scenario_wfq, scenario_debt_and_costs, scenario_ladder,
             scenario_ghost_and_stand_down, scenario_disabled_and_default_tenant]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scripted_governor_traces_as_jax(scenario):
    want = scenario(jq)
    got = scenario(tq)
    assert got == want


def test_ladder_reaches_every_stage_and_one_incident():
    trace, events, incidents, snap = scenario_ladder(tq)
    stages = {(e["fromStage"], e["toStage"]) for e in events}
    assert ("normal", "deprioritized") in stages and ("degraded", "shedding") in stages
    assert ("episode", "clear") in stages
    assert len(incidents) == 1 and incidents[0]["tenant"] == "aggressor"
    assert snap["tenants"]["victim"]["stage"] == 0
    assert any(x == "degrade" for row in trace if isinstance(row, list) for x in row)
    assert any(isinstance(x, tuple) and x[0] == "shed"
               for row in trace if isinstance(row, list) for x in row)


class _Event:
    """A CUDA event stand-in whose pair reads a fixed elapsed time."""

    def __init__(self, ms=0.0):
        self.ms = ms

    def query(self):
        return True

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.ms


def test_debt_equals_the_port_ledgers_device_ms():
    led = devledger.Ledger()
    site = led.site("kernels.gram")
    gov = tq.QosGovernor(enabled=True, ledger_fn=led.tenant_totals, tick_interval=1e9)
    base = time.monotonic()
    booked = {}
    for i, (tenant, ms) in enumerate([("t1", 1.5), ("t2", 0.25), ("t1", 2.0), ("t3", 0.125)]):
        with devledger.tenant_scope(tenant):
            site.record_cuda_launch(_Event(), _Event(ms), 0.001, sig="gram")
        booked[tenant] = booked.get(tenant, 0.0) + ms
        gov.tick(base + i)
    # one flight of t1 and t2 queries, split 3:1 across their principals
    with devledger.weighted_scope([(("t1", "i", "q"), 0.75), (("t2", "i", "q"), 0.25)]):
        site.record_cuda_launch(_Event(), _Event(4.0), 0.001, sig="gram")
    booked["t1"] += 3.0
    booked["t2"] += 1.0
    gov.tick(base + 10)
    tenants = gov.snapshot()["tenants"]
    totals = led.tenant_totals()
    for t, ms in booked.items():
        assert totals[t]["deviceMs"] == pytest.approx(ms, abs=1e-9)
        assert tenants[t]["debtMs"] == pytest.approx(totals[t]["deviceMs"], abs=1e-9)
    # the launch price the planner reads: the gram's EWMA device ms
    n, ms = led.measured_ms("kernels.gram", "gram")
    assert n == 5 and ms > 0
    assert led.measured_ms("kernels.gram", "other") is None
