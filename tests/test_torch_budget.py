"""The device-memory budget, the residency tracker and the executor's
over-budget paths of the port against ``pilosa_tpu``'s.

The budget and tracker cases are those of ``tests/test_membudget.py`` and
``tests/test_residency.py``, each run against both packages' modules as
one parametrised test (the tracker's clock patched in both to one fake
clock). Then both executors serve the same seeded index under the same
caps, with the same reads and writes: a cap that holds every stack, one
that makes stacks evict one another, one below every stack (each declined;
fragment copies cycle through the budget, an int field's fragments are
declined too and page their rows), and one below every fragment. After
every query the answers, the bytes the budget holds, its evictions and
the stacks each cache holds must be equal: the same eviction order.
"""

import gc
import subprocess
import sys
import threading
import types
import weakref

import numpy as np
import pytest
import torch

from pilosa_tpu.core import membudget as jmb
from pilosa_tpu.core import residency as jres
from pilosa_tpu.core.field import FieldOptions as JaxFieldOptions
from pilosa_tpu.core.fragment import Fragment as JaxFragment
from pilosa_tpu.core.holder import Holder as JaxHolder
from pilosa_tpu.exec.executor import Executor as JaxExecutor
from pilosa_tpu.parallel import mesh as jmesh
from pilosa_tpu_torch import convert
from pilosa_tpu_torch.core import membudget as tmb
from pilosa_tpu_torch.core import residency as tres
from pilosa_tpu_torch.core.fragment import Fragment as TorchFragment
from pilosa_tpu_torch.exec import executor as tex
from pilosa_tpu_torch.ops import kernels as tk
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, SHARD_WORDS

BUDGETS = pytest.mark.parametrize("mb", [jmb, tmb], ids=["jax", "torch"])
PACKAGES = [
    pytest.param((jmb, jres, lambda: JaxFragment(n_words=64)), id="jax"),
    pytest.param((tmb, tres, lambda: TorchFragment(n_words=64, device="cpu")), id="torch"),
]


@pytest.fixture()
def fresh_budgets():
    """Both packages' process budgets and trackers fresh, restored after."""
    saved = (jmb._default, tmb._default, jres._default, tres._default)
    for m in (jmb, tmb):
        m.configure(None)
    for r in (jres, tres):
        r.configure()
    yield
    jmb._default, tmb._default, jres._default, tres._default = saved


# ---------------------------------------------------------------------------
# DeviceBudget (tests/test_membudget.py), both modules
# ---------------------------------------------------------------------------


@BUDGETS
def test_lru_eviction_order(mb):
    b = mb.DeviceBudget(100)
    evicted = []
    b.admit("a", 40, lambda: evicted.append("a"))
    b.admit("b", 40, lambda: evicted.append("b"))
    b.touch("a")
    b.admit("c", 40, lambda: evicted.append("c"))
    assert evicted == ["b"] and b.used() == 80
    b.admit("d", 90, lambda: evicted.append("d"))
    assert evicted == ["b", "a", "c"] and b.used() == 90


@BUDGETS
def test_release_admit_replace_and_oversize(mb):
    b = mb.DeviceBudget(100)
    evicted = []
    b.admit("a", 60, lambda: evicted.append("a"))
    b.release("a")
    assert b.used() == 0 and evicted == []
    b.admit("a", 60, lambda: None)
    b.admit("a", 30, lambda: evicted.append("a"))
    assert b.used() == 30 and b.entry_count() == 1
    assert b.would_decline(150) and not b.would_decline(100)
    b.admit("big", 150, lambda: evicted.append("big"))
    assert evicted == ["a"] and b.used() == 150


@BUDGETS
def test_set_cap_shrink_trims_and_sheds_pins(mb):
    b = mb.DeviceBudget(None)
    evicted = []
    for name in ("a", "b", "c"):
        b.admit(name, 40, lambda n=name: evicted.append(n))
    b.pin("c")
    b.touch("b")
    b.set_cap(90)
    assert b.cap == 90 and b.used() <= 90
    assert "c" not in evicted and evicted and b.evictions == len(evicted)
    before = list(evicted)
    b.set_cap(None)
    assert evicted == before and b.cap is None
    b = mb.DeviceBudget(None)
    evicted = []
    b.admit("hot", 40, lambda: evicted.append("hot"))
    assert b.pin("hot")
    b.admit("warm", 40, lambda: evicted.append("warm"))
    b.set_cap(60)
    assert not b.is_pinned("hot") and b.unpins == 1
    assert b.used() <= 60 and evicted


@BUDGETS
def test_module_set_cap_mutates_default_budget_in_place(mb, fresh_budgets):
    b = mb.configure(None)
    b.admit("x", 64, lambda: None)
    assert mb.set_cap(32) is b
    assert b.cap == 32 and b.used() <= 32
    mb.set_cap(None)
    assert b.cap is None


@BUDGETS
def test_owner_gc_releases_entry(mb):
    b = mb.DeviceBudget(None)

    class Owner:
        pass

    o = Owner()
    b.admit(mb.register_owner(o, b), 10, lambda: None)
    assert b.used() == 10
    del o
    gc.collect()
    assert b.used() == 0


@BUDGETS
def test_clock_pins_and_counters(mb):
    b = mb.DeviceBudget(100)
    evicted = []
    b.admit("a", 40, lambda: evicted.append("a"))
    b.admit("b", 40, lambda: evicted.append("b"))
    b.touch("a")
    b.admit("c", 40, lambda: evicted.append("c"))
    assert "a" not in evicted and b.used() <= 100
    # a pinned entry survives a storm; pinning stops at the fraction
    b = mb.DeviceBudget(100)
    evicted = []
    b.admit("hot", 40, lambda: evicted.append("hot"))
    assert b.pin("hot")
    for i in range(20):
        b.admit(f"cold{i}", 50, lambda i=i: evicted.append(f"cold{i}"))
    assert "hot" not in evicted and b.pinned_bytes() == 40
    b = mb.DeviceBudget(100)
    b.admit("a", 40, lambda: None)
    b.admit("b", 40, lambda: None)
    assert b.pin("a") and not b.pin("b")
    assert b.snapshot()["pinDeclined"] == 1
    assert b.unpin("a") and b.pin("b")
    assert not b.pin("ghost") and not b.unpin("ghost")
    # everything pinned: an admit goes over the cap
    b = mb.DeviceBudget(100)
    b.admit("a", 30, lambda: None)
    assert b.pin("a")
    b.admit("big", 90, lambda: evicted.append("big"))
    assert b.used() == 120 and b.is_pinned("a")
    b.release("a")
    assert b.pinned_bytes() == 0 and b.used() == 90
    b.admit("r", 20, lambda: None)
    b.pin("r")
    b.admit("r", 30, lambda: None)
    assert b.is_pinned("r") and b.pinned_bytes() == 30
    b.touch("r")
    b.touch("ghost")
    snap = b.snapshot()
    assert snap["hits"] == 1 and snap["misses"] == 3


@BUDGETS
def test_concurrent_admit_touch_evict_storm_accounting_exact(mb):
    import random

    b = mb.DeviceBudget(2000)
    state_lock = threading.Lock()
    state = {}

    def evict_cb(key):
        with state_lock:
            state[key][1] += 1

    def worker(ti):
        r = random.Random(ti)
        for j in range(40):
            key = (ti, j)
            nbytes = r.randint(50, 300)
            with state_lock:
                state[key] = [nbytes, 0, False]
            b.admit(key, nbytes, lambda k=key: evict_cb(k))
            if j:
                b.touch((ti, r.randrange(j)))
            if r.random() < 0.2:
                b.pin(key)
            if r.random() < 0.3:
                k2 = (ti, r.randrange(j + 1))
                b.unpin(k2)
                b.release(k2)
                with state_lock:
                    state[k2][2] = True

    threads = [threading.Thread(target=worker, args=(ti,)) for ti in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert b.snapshot()["evictErrors"] == 0
    assert all(ev <= 1 for _, ev, _ in state.values())
    assert b.used() == sum(nb for nb, ev, rel in state.values() if not ev and not rel)
    assert b.pinned_bytes() <= b.used()


@BUDGETS
@pytest.mark.parametrize("env, want", [("0", None), ("12345678", 12345678)])
def test_env_cap_wins(mb, monkeypatch, env, want):
    monkeypatch.setenv("PILOSA_TPU_HBM_BUDGET_BYTES", env)
    monkeypatch.setattr(mb, "_default", None)
    monkeypatch.setattr(mb, "_probe_device_cap", lambda *device: 10**10)
    assert mb.default_budget().cap == want


@pytest.mark.parametrize("available", [True, False])
def test_port_probe_reads_the_card(monkeypatch, available):
    """The port's default cap is 80 % of the card's total memory as
    ``torch.cuda.mem_get_info`` reports it; None without CUDA."""
    monkeypatch.delenv("PILOSA_TPU_HBM_BUDGET_BYTES", raising=False)
    monkeypatch.setattr(tmb, "_default", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: available)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev=None: (5 * 10**9, 8 * 10**10))
    want = int(8 * 10**10 * tmb.DEFAULT_HBM_FRACTION) if available else None
    assert tmb.default_budget().cap == want


def test_port_probe_reads_the_holders_card_and_raises_when_it_fails(monkeypatch):
    """The cap is read from the card the holder runs on (the current card
    for a CPU holder), and a failing probe raises instead of leaving the
    process without a cap."""
    monkeypatch.delenv("PILOSA_TPU_HBM_BUDGET_BYTES", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    totals = {0: 8 * 10**10, 1: 4 * 10**10}
    asked = []

    def mem_get_info(dev):
        asked.append(torch.device(dev))
        return 10**9, totals[torch.device(dev).index]

    monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
    for device, index in [("cuda:1", 1), (torch.device("cuda", 0), 0), ("cpu", 0), (None, 0)]:
        monkeypatch.setattr(tmb, "_default", None)
        want = int(totals[index] * tmb.DEFAULT_HBM_FRACTION)
        assert tmb.default_budget(device).cap == want, device
        assert asked.pop() == torch.device("cuda", index)

    def broken(dev):
        raise RuntimeError("CUDA error: out of memory")

    monkeypatch.setattr(torch.cuda, "mem_get_info", broken)
    monkeypatch.setattr(tmb, "_default", None)
    with pytest.raises(RuntimeError, match="CUDA error"):
        tmb.default_budget("cuda:0")
    assert tmb._default is None


def test_port_membudget_imports_no_torch():
    """The budget module loads without torch (its probe imports it)."""
    code = (
        "import sys, importlib.util\n"
        f"spec = importlib.util.spec_from_file_location('mb', {tmb.__file__!r})\n"
        "m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m)\n"
        "print('torch' in sys.modules)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert out.stdout.strip() == "False", out.stderr


# ---------------------------------------------------------------------------
# ResidencyTracker (tests/test_residency.py), both packages
# ---------------------------------------------------------------------------


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t


@pytest.fixture()
def clock(monkeypatch):
    c = FakeClock()
    fake_time = types.SimpleNamespace(monotonic=c.monotonic)
    for r in (jres, tres):
        monkeypatch.setattr(r, "time", fake_time)
    return c


@pytest.mark.parametrize("pkg", PACKAGES)
def test_tracker_tiers_hits_and_drop(pkg, fresh_budgets):
    mb, res, make = pkg
    tracker = res.default_tracker()
    frag = make()
    frag.set_bit(0, 1)
    assert tracker.state_of(frag) == res.STATE_HOST
    frag._res_staging = True
    assert tracker.state_of(frag) == res.STATE_STAGING
    frag.device_bits()  # cold: a miss
    assert tracker.state_of(frag) == res.STATE_DEVICE
    frag.device_bits()  # warm: a hit
    snap = tracker.snapshot()
    assert (snap["deviceMisses"], snap["deviceHits"]) == (1, 1)
    frag._res_pinned = True
    assert tracker.state_of(frag) == res.STATE_PINNED
    frag._drop_device()
    assert not frag._res_pinned and tracker.state_of(frag) == res.STATE_HOST
    assert mb.default_budget().used() == 0


@pytest.mark.parametrize("pkg", PACKAGES)
def test_heat_auto_pins_and_decays(pkg, fresh_budgets, clock):
    mb, res, make = pkg
    mb.configure(1 << 20)
    tracker = res.configure(heat_half_life=10.0)
    frag = make()
    frag.set_bit(0, 1)
    for _ in range(12):
        frag.device_bits()
    assert tracker.heat_of(frag) == 12.0  # no time passed
    assert frag._res_pinned and tracker.snapshot()["autoPins"] == 1
    assert mb.default_budget().is_pinned(frag._budget_key)
    clock.t += 40.0  # four half-lives
    assert tracker.heat_of(frag) == 12.0 / 16
    frag.device_bits()  # cooled below the unpin bar
    assert not frag._res_pinned and tracker.snapshot()["autoUnpins"] == 1


@pytest.mark.parametrize("pkg", PACKAGES)
def test_prefetch_accounting(pkg, fresh_budgets):
    mb, res, make = pkg
    tracker = res.default_tracker()
    frag = make()
    frag.set_bit(0, 1)
    tracker.enter_prefetch()
    try:
        frag.device_bits()
    finally:
        tracker.exit_prefetch()
    snap = tracker.snapshot()
    assert snap["prefetchUploads"] == 1 and snap["deviceMisses"] == 0
    frag.device_bits()
    snap = tracker.snapshot()
    assert snap["deviceHits"] == 1 and snap["prefetchUseful"] == 1
    tracker.enter_prefetch()
    try:
        frag.device_bits()
    finally:
        tracker.exit_prefetch()
    assert tracker.snapshot()["prefetchWasted"] == 1
    budget = mb.configure(1000)
    budget.admit("stack", 100, lambda: None)
    assert not tracker.maybe_pin_stack(budget, "stack", hits=3)
    assert tracker.maybe_pin_stack(budget, "stack", hits=int(tracker.pin_heat))
    assert budget.is_pinned("stack") and tracker.snapshot()["stackPins"] == 1


@pytest.mark.parametrize("pkg", PACKAGES)
def test_fragment_budget_eviction_and_paging(pkg, fresh_budgets):
    """A fragment's copy is admitted at its bytes, evicted by the budget
    (dropped, so the next sync uploads it again), and a fragment larger
    than the cap is declined: its rows are paged from the mirror."""
    mb, res, make = pkg
    frags = [make() for _ in range(3)]
    for i, f in enumerate(frags):
        for r in range(5):
            f.set_bit(r, 7 * i + r)
    nbytes = (frags[0].capacity + 1) * 64 * 4
    budget = mb.configure(2 * nbytes + 10)
    for f in frags:
        f.device_bits()
    assert budget.used() == 2 * nbytes and budget.evictions == 1
    assert frags[0]._device is None  # the first, coldest, was dropped
    rows = frags[0].rows_device([0, 1, 9])
    assert np.asarray(rows).shape == (3, 64)
    mb.configure(nbytes - 1)
    assert all(f.device_declined() for f in frags)
    got = np.asarray(frags[1].rows_device([1, 3, 9])).view(np.uint32)
    want = np.stack([frags[1].row_words_host(r) for r in (1, 3, 9)])
    assert np.array_equal(got, want)
    assert np.array_equal(np.asarray(frags[2].row_device(2)).view(np.uint32),
                          frags[2].row_words_host(2))
    assert mb.default_budget().used() == 0


# ---------------------------------------------------------------------------
# Both executors under the same caps
# ---------------------------------------------------------------------------

N_SHARDS = 4
N_COLS = N_SHARDS * SHARD_WIDTH
SET_ROWS = {"f": 8, "g": 6, "h": 3}
INT_FIELDS = {"v": (0, 1000), "w": (-1000, 1000)}
W4 = SHARD_WORDS * 4
# bytes of a fragment of 8 rows and of an int fragment (16-slot capacity)
FRAG8, FRAG16 = 9 * W4, 17 * W4
STACK = {n: N_SHARDS * r * W4 for n, r in SET_ROWS.items()}
STACK_BSI = N_SHARDS * 12 * W4  # depth 10: exists, sign, 10 planes
CAPS = {
    # every stack of the workload fits
    "roomy": 8 * STACK_BSI,
    # f and g fit together; v's stack evicts one of them
    "evicting": STACK["f"] + STACK["g"] + STACK_BSI // 2,
    # below every stack but _exists' (each declined); a set field's
    # fragment fits, an int field's is declined and pages its rows
    "declined": FRAG8 + W4,
    # below every fragment
    "tiny": W4 // 2,
}


def _norm(r):
    if isinstance(r, Exception):
        return ("error", type(r).__name__)
    if isinstance(r, list):
        return [_norm(x) for x in r]
    if hasattr(r, "columns") and hasattr(r, "segments"):
        return ("row", [int(c) for c in r.columns()])
    if hasattr(r, "group"):
        return ("group", [(g.field, int(g.row_id)) for g in r.group], int(r.count))
    if hasattr(r, "value") and hasattr(r, "count"):
        return ("valcount", int(r.value), int(r.count))
    if hasattr(r, "id") and hasattr(r, "count"):
        return ("pair", int(r.id), int(r.count))
    if isinstance(r, (bool, int, np.integer)):
        return r if isinstance(r, bool) else int(r)
    raise TypeError(type(r))


def _build(seed: int):
    rng = np.random.default_rng(seed)
    jh = JaxHolder()
    idx = jh.create_index("i")
    for name in SET_ROWS:
        idx.create_field(name)
    for name, (lo, hi) in INT_FIELDS.items():
        idx.create_field(name, JaxFieldOptions(field_type="int", min_=lo, max_=hi))
    for name, n_rows in SET_ROWS.items():
        rows = rng.integers(0, n_rows, size=2500).astype(np.uint64)
        cols = rng.integers(0, N_COLS, size=2500).astype(np.uint64)
        idx.field(name).import_bits(rows, cols)
    je = JaxExecutor(jh)
    writes = []
    for name, (lo, hi) in INT_FIELDS.items():
        for c, x in zip(rng.integers(0, N_COLS, 300), rng.integers(lo, hi + 1, 300)):
            writes.append(f"Set({int(c)}, {name}={int(x)})")
    je.execute("i", " ".join(writes))
    fragments = {}
    for fname, field in idx.fields.items():
        for vname, view in field.views.items():
            for shard, frag in view.fragments.items():
                fragments[("i", fname, vname, shard)] = frag.rows_matrix_host()
    th = convert.holder_from_arrays(jh.schema(), fragments, device="cpu")
    return je, tex.Executor(th), rng


# reads both executors serve through the same stack calls
READS = [
    "Count(Intersect(Row(f=1), Row(f=2))) Count(Union(Row(f=3), Row(f=1))) "
    "Count(Xor(Row(f=4), Row(f=5)))",
    "Count(Difference(Row(g=1), Row(g=2)))",
    "Count(Row(h=1))",
    "TopN(f, Row(g=1), n=5)",
    "TopN(f, Row(g=2), tanimotoThreshold=10)",
    "TopN(g, n=3)",
    "GroupBy(Rows(f), Rows(g))",
    "GroupBy(Rows(f), Rows(g), limit=7)",
    "GroupBy(Rows(g), Rows(f), Rows(h), filter=Row(v > 300))",
    "Count(Row(v > 500))",
    "Row(v < 200)",
    "Row(w >< [-300, 400])",
    "Count(Row(w == 17)) Count(Row(w != null))",
    "Count(Row(v >= 100)) Count(Row(v < 900)) Row(w > -50)",
    "Sum(field=v)",
    "Sum(Row(f=1), field=w)",
    "Min(field=w) Max(Row(g=2), field=v)",
    "Count(Intersect(Row(f=1), Union(Row(g=1), Row(h=2)))) "
    "Count(Intersect(Row(f=2), Union(Row(g=3), Row(h=0))))",
    "Difference(Row(f=1), Row(g=1)) Not(Row(f=2))",
    "Count(Row(v > 250)) Count(Row(v > 250))",
]
# reads the port serves on its stacks where JAX takes the recursive path
# (one level, a `previous` page): the answers are compared
READS_OWN_PATHS = [
    "GroupBy(Rows(f), Rows(g), previous=[3, 2])",
    "GroupBy(Rows(f), Rows(g), previous=[3, 2], limit=4)",
    "GroupBy(Rows(f), Rows(g), Rows(h), previous=[1, 1, 1], limit=5)",
    "GroupBy(Rows(f), filter=Row(g=1))",
    "GroupBy(Rows(h))",
]
WRITES = "Set(5, f=1) Clear(5, g=1) Set(70000, f=7) Set(9, v=333) Set(12, w=-999)"


def _cached(ex):
    """(field, view) of every stack an executor's cache holds."""
    out = set()
    if isinstance(ex, tex.Executor):
        for field, caches in ex._stacks.items():
            out.update((field.name, k[1]) for k in caches)
    else:
        for field in ex.holder.index("i").fields.values():
            out.update((field.name, k[2]) for k in vars(field).get("_stack_caches", {}))
    return sorted(out)


def _state(budget):
    return budget.used(), budget.evictions, budget.pinned_bytes()


@pytest.fixture()
def one_device_mesh(fresh_budgets):
    """JAX stacks unpadded (the tests' 8 virtual devices would pad the
    shard axis to a multiple of 8)."""
    jmesh.configure_serving(1)
    yield
    jmesh.configure_serving(None)


@pytest.mark.parametrize("cap", list(CAPS))
def test_executors_agree_under_cap(one_device_mesh, cap):
    je, te, _ = _build(23)
    jb, tb = jmb.configure(CAPS[cap]), tmb.configure(CAPS[cap])
    for i, q in enumerate(READS + [WRITES] + READS):
        want, got = _norm(je.execute("i", q)), _norm(te.execute("i", q))
        assert got == want, (cap, i, q)
        assert _cached(te) == _cached(je), (cap, i, q)
        if cap in ("roomy", "evicting"):
            # no stack declined: the budgets hold the same stacks alone. A
            # declined filtered TopN pages fragment rows to the device in
            # the port (the masked row scan per fragment) where JAX counts
            # host filters on the host, so there the fragment copies differ
            assert _state(tb) == _state(jb), (cap, i, q)
        if cap != "roomy" and tb.cap is not None:
            assert tb.used() <= tb.cap or tb.pinned_bytes() > 0, (cap, i, q)
    for q in READS_OWN_PATHS:
        assert _norm(te.execute("i", q)) == _norm(je.execute("i", q)), (cap, q)
    if cap == "roomy":
        assert tb.evictions == 0 and te.stacks_declined == 0
    if cap == "evicting":
        assert tb.evictions > 0 and te.stack_evictions > 0 and te.stacks_declined == 0
    if cap in ("declined", "tiny"):
        assert te.stacks_declined > 0 and te.bsi_fragment_launches > 0


@pytest.mark.parametrize("cap", ["roomy", "declined"])
def test_declined_stacks_match_jax(one_device_mesh, cap):
    """The same stacks are declined by both executors: the port's
    STACK_DECLINED where JAX's _field_stack gives None, and None (no rows)
    where both agree there is nothing to stack."""
    je, te, _ = _build(29)
    jmb.configure(CAPS[cap])
    tmb.configure(CAPS[cap])
    jidx, tidx = je.holder.index("i"), te.holder.index("i")
    shards = list(range(N_SHARDS))
    for name in list(SET_ROWS) + list(INT_FIELDS) + ["_exists"]:
        jf, tf = jidx.field(name), tidx.field(name)
        if name in INT_FIELDS:
            jst, tst = je._bsi_stack(jf, shards), te._bsi_stack(tf, shards)
        else:
            jst, tst = je._field_stack(jf, shards), te._field_stack(tf, shards)
        assert (jst is None) == (tst is tex.STACK_DECLINED), name
    # a view with no rows over the shards is None in both, not declined
    assert te._field_stack(tidx.field("f"), [N_SHARDS + 5]) is None
    assert je._field_stack(jidx.field("f"), [N_SHARDS + 5]) is None


def test_eviction_drops_every_reference_to_the_stack(fresh_budgets):
    """An evicted stack's tensor is freed: no cache entry, gram slot,
    aggregate slot or cross-gram slot keeps it alive."""
    _, te, _ = _build(31)
    tmb.configure(None)
    shards = list(range(N_SHARDS))
    idx = te.holder.index("i")
    te.execute("i", "GroupBy(Rows(f), Rows(g)) GroupBy(Rows(f), Rows(g)) "
               "GroupBy(Rows(f), Rows(g)) Sum(field=v)")
    _, f_bits = te._field_stack(idx.field("f"), shards)
    ref = weakref.ref(f_bits)
    entry = te._stack_entry_for(idx.field("f"), f_bits)
    assert entry.get("crossgram")  # the f x g cross gram, on f's entry
    del f_bits, entry
    tmb.set_cap(1)  # evicts every unpinned stack
    gc.collect()
    assert ref() is None
    assert te.stack_evictions == 3 and tmb.default_budget().used() == 0  # f, g, v


def test_patch_copy_is_accounted(fresh_budgets, monkeypatch):
    """The incremental update's second copy is admitted while it lives."""
    _, te, _ = _build(37)
    budget = tmb.configure(None)
    te.execute("i", "TopN(f, Row(g=1), n=3)")
    seen = []
    admit = budget.admit
    monkeypatch.setattr(budget, "admit", lambda k, n, cb: (seen.append((n, budget.used())),
                                                          admit(k, n, cb)))
    te.execute("i", "Set(3, f=2)")
    te.execute("i", "TopN(f, Row(g=1), n=3)")
    assert te.stack_incremental == 1
    assert seen == [(STACK["f"], STACK["f"])]
    assert budget.used() == STACK["f"]


def test_declined_filtered_topn_scans_each_fragment(one_device_mesh, monkeypatch):
    """A filtered TopN over a declined stack runs the masked row scan once
    per fragment at S = 1."""
    je, te, _ = _build(41)
    jmb.configure(CAPS["declined"])
    tmb.configure(CAPS["declined"])
    shapes = []
    real = tk.masked_row_counts
    monkeypatch.setattr(tk, "masked_row_counts",
                        lambda b, f: shapes.append(tuple(b.shape)) or real(b, f))
    q = "TopN(f, Row(g=1), n=4, tanimotoThreshold=5)"
    assert _norm(te.execute("i", q)) == _norm(je.execute("i", q))
    assert len(shapes) == N_SHARDS and all(s[0] == 1 for s in shapes)


def test_finalizer_release_never_blocks_on_the_budget_lock():
    """An owner collected while its thread holds the budget's lock (the
    collector runs finalizers at any allocation) still releases its entry,
    once the lock is free, instead of deadlocking."""
    b = tmb.DeviceBudget(100)

    class Owner:
        pass

    o = Owner()
    b.admit(tmb.register_owner(o, b), 10, lambda: None)
    with b._lock:
        del o
        gc.collect()  # the finalizer runs here, under the lock
    for _ in range(200):
        if b.used() == 0:
            break
        threading.Event().wait(0.01)
    assert b.used() == 0 and b.entry_count() == 0


def test_deferred_finalizer_release_spares_a_new_owner():
    """A finalizer's release deferred past the budget's lock never lands on
    a new owner's entry, even one that took the dead owner's address: each
    owner's key is an object of its own."""
    b = tmb.DeviceBudget(100)
    gate, started = threading.Event(), []
    release = b.release

    def gated_release(key):
        started.append(threading.current_thread())
        gate.wait(5)
        release(key)

    b.release = gated_release  # the deferred thread's target

    class Owner:
        pass

    o = Owner()
    addr = id(o)
    k1 = tmb.register_owner(o, b)
    b.admit(k1, 10, lambda: None)
    with b._lock:
        del o
        gc.collect()  # the finalizer runs here, under the lock: deferred
    assert len(started) == 1
    # a new owner at the dead one's address (the allocator reuses it soon)
    spare = []
    o2 = Owner()
    while id(o2) != addr and len(spare) < 10000:
        spare.append(o2)
        o2 = Owner()
    del spare
    k2 = tmb.register_owner(o2, b)
    assert k2 is not k1
    b.admit(k2, 20, lambda: None)
    gate.set()
    started[0].join(5)
    assert b.used() == 20 and b.entry_count() == 1
    del o2
    gc.collect()
    assert b.used() == 0


class _EvictOnCompare(int):
    """A stack entry's LRU stamp whose first comparison runs ``fn`` on
    another thread and waits for it: an eviction landing in the middle of
    the cache's LRU scan."""

    def __new__(cls, value, fn):
        obj = super().__new__(cls, value)
        obj.fn = fn
        return obj

    def _fire(self):
        fn, self.fn = self.fn, None
        if fn is not None:
            t = threading.Thread(target=fn)
            t.start()
            t.join()

    def __lt__(self, other):
        self._fire()
        return int(self) < int(other)

    def __gt__(self, other):
        self._fire()
        return int(self) > int(other)


def test_eviction_landing_mid_rebuild_leaves_the_cache_whole(fresh_budgets):
    """The budget's evict callback pops a stack entry without the cache's
    lock; an eviction that lands while ``_field_stack`` picks its LRU entry
    to drop neither breaks the scan nor leaves a byte unaccounted."""
    _, te, _ = _build(43)
    budget = tmb.configure(None)
    field = te.holder.index("i").field("f")
    sets = [[0, 1], [2, 3], [1, 2]]
    for shards in sets[:2]:
        te._field_stack(field, shards)
    caches = te._stacks[field]
    (_, ea), (kb, eb) = caches.items()

    def evict_b():  # the budget's eviction of b: pop its key, then call back
        budget.release(eb["bkey"])
        te._stack_evict_cb(field, kb, eb)()

    ea["lru"] = _EvictOnCompare(ea["lru"], evict_b)
    _, bits = te._field_stack(field, sets[2])
    assert ea["lru"].fn is None  # the eviction ran mid-scan
    assert te.stack_evictions == 1
    # a, the LRU entry of the scan's snapshot, is dropped and released too
    assert list(te._stacks[field]) == [te._stack_key(sets[2], "standard", None)]
    assert budget.used() == 2 * SET_ROWS["f"] * W4 == bits.numel() * 4
    assert budget.entry_count() == 1
    assert te._stack_entry_for(field, bits) is not None


def test_concurrent_evictions_and_rebuilds_keep_the_accounting(fresh_budgets):
    """Readers rebuilding stacks on three shard sets while another thread
    shrinks and grows the cap: no query fails, and the budget holds the
    bytes of exactly the stacks the cache holds."""
    _, te, _ = _build(47)
    budget = tmb.configure(None)
    field = te.holder.index("i").field("f")
    sets = [[0, 1], [2, 3], [1, 2], [0, 3]]
    one = 2 * SET_ROWS["f"] * W4
    errors, stop = [], threading.Event()

    def reader(k):
        try:
            for i in range(60):
                slot_of, bits = te._field_stack(field, sets[(i + k) % len(sets)])
                assert tuple(bits.shape) == (2, SET_ROWS["f"], SHARD_WORDS)
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    def squeezer():
        while not stop.is_set():
            budget.set_cap(one)
            budget.set_cap(None)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=reader, args=(k,)) for k in range(2)]
        sq = threading.Thread(target=squeezer)
        for t in threads + [sq]:
            t.start()
        for t in threads:
            t.join()
        stop.set()
        sq.join()
    finally:
        sys.setswitchinterval(switch)
    assert not errors, errors
    assert te.stack_evictions > 0
    gc.collect()
    cached = [e["bkey"] for e in te._stacks[field].values()]
    assert budget.used() == one * len(cached)
    assert budget.entry_count() == len(cached)
