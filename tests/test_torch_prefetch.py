"""The port's flight prefetcher (``pilosa_tpu_torch/server/prefetch.py``)
against ``pilosa_tpu/server/prefetch.py``, on the CPU.

The stacks a query would demand (``stack_pairs_of_query``: pair and tree
Counts, bitmap trees, time windows, Not through the existence field, and
what stages nothing) must be JAX's for every query of a list, and so must
the fields a query names. Then, under a device-memory cap that holds one
of two competing stacks, flights that alternate between them find their
stack evicted: the prefetcher stages it on the uploader before the
flight's dispatch, and the flight's first hit counts the prefetch useful.
The issued and useful counts must meet JAX's bar (useful/issued >= 0.5),
an uncapped budget must issue nothing, and every answer must equal the
answer without prefetch.
"""

import gc

import numpy as np
import pytest

from pilosa_tpu.core import membudget as jmb
from pilosa_tpu.core import residency as jres
from pilosa_tpu.core.field import FieldOptions as JaxFieldOptions
from pilosa_tpu.core.holder import Holder as JaxHolder
from pilosa_tpu.pql import parse as jax_parse
from pilosa_tpu.server import prefetch as jp
from pilosa_tpu_torch.core import membudget as tmb
from pilosa_tpu_torch.core import residency as tres
from pilosa_tpu_torch.core.field import FieldOptions as TorchFieldOptions
from pilosa_tpu_torch.core.holder import Holder as TorchHolder
from pilosa_tpu_torch.exec.executor import Executor
from pilosa_tpu_torch.ingest import DeviceUploader
from pilosa_tpu_torch.pql import parse as torch_parse
from pilosa_tpu_torch.server import prefetch as tp
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH


@pytest.fixture()
def fresh_budgets():
    saved = (jmb._default, tmb._default, jres._default, tres._default)
    try:
        for m, r in ((jmb, jres), (tmb, tres)):
            m.configure(None)
            r.configure()
        yield
    finally:
        jmb._default, tmb._default, jres._default, tres._default = saved
        gc.collect()


def _holders():
    out = []
    for H, FO in ((JaxHolder, JaxFieldOptions), (lambda: TorchHolder(device="cpu"),
                                                  TorchFieldOptions)):
        h = H()
        idx = h.create_index("i")
        idx.create_field("f")
        idx.create_field("g")
        idx.create_field("t", FO(field_type="time", time_quantum="YMD"))
        idx.create_field("v", FO(field_type="int", min_=0, max_=100))
        idx.field("f").import_bits([1, 2, 3], [5, SHARD_WIDTH + 1, 9])
        idx.field("g").import_bits([1], [7])
        from datetime import datetime

        idx.field("t").import_bits([1, 1], [3, 4], timestamps=[datetime(2024, 1, 1),
                                                             datetime(2024, 2, 3)])
        out.append(h)
    return out


QUERIES = [
    "Count(Row(f=1))",
    "Count(Intersect(Row(f=1), Row(f=2)))",
    "Count(Intersect(Row(f=1), Row(g=2))) Count(Union(Row(g=1), Row(f=3)))",
    "Union(Row(f=1), Row(g=1))",
    "Not(Row(f=1))",
    "Count(Not(Union(Row(f=1), Row(g=2))))",
    "Row(f=1)",
    "TopN(f, Row(g=1))",
    "GroupBy(Rows(f), Rows(g))",
    "Count(Row(t=1, from=2024-01-01T00:00, to=2024-03-01T00:00))",
    "Count(Intersect(Row(t=1, from=2024-01-01T00:00, to=2024-01-05T00:00), Row(f=1)))",
    "Count(Row(v > 5))",
    "Sum(Row(f=1), field=v)",
    "Count(Intersect(Row(nope=1), Row(f=1)))",
    "Xor(Row(f=1), Row(g=1), Row(f=9))",
]


# A lone windowed Count is one tree-kernel launch over its cover's views in
# the port (its batch path counts it; JAX's counts it on the host), so the
# port's prediction, made with the port's own matcher, stages those views.
PORT_ONLY = {
    "Count(Row(t=1, from=2024-01-01T00:00, to=2024-03-01T00:00))":
        [("t", "standard_202401"), ("t", "standard_202402")],
}


@pytest.mark.parametrize("text", QUERIES)
def test_prefetch_candidates_equal_jax(text):
    jh, th = _holders()
    jq, tq = jax_parse(text), torch_parse(text)
    want = PORT_ONLY.get(text) or jp.stack_pairs_of_query(jh.index("i"), jq)
    assert tp.stack_pairs_of_query(th.index("i"), tq) == want
    assert tp.fields_of_query(tq) == jp.fields_of_query(jq)


def _serving(seed=3):
    rng = np.random.default_rng(seed)
    h = TorchHolder(device="cpu")
    idx = h.create_index("i")
    for name in ("f", "g"):
        idx.create_field(name)
        idx.field(name).import_bits(
            rng.integers(0, 16, 4000).astype(np.uint64),
            rng.integers(0, 4 * SHARD_WIDTH, 4000).astype(np.uint64),
        )
    ex = Executor(h, rescache_entries=0)
    up = DeviceUploader(slots=2)
    return h, ex, up, tp.FlightPrefetcher(h, up, ex)


FLIGHT_F = [(f"Count(Intersect(Row(f={a}), Row(f={a + 1})))", None) for a in range(6)]
FLIGHT_G = [(f"Count(Union(Row(g={a}), Row(g={a + 2})))", None) for a in range(6)]


def test_issued_and_useful_under_an_evicting_cap(fresh_budgets, monkeypatch):
    monkeypatch.setattr(tp, "REISSUE_TTL", 0.0)
    h, ex, up, pf = _serving()
    want = {tuple(q for q, _ in fl): [ex.execute("i", q) for q, _ in fl]
            for fl in (FLIGHT_F, FLIGHT_G)}
    stack = 4 * 16 * h.index("i").field("f").n_words * 4
    # room for one of the two fields' stacks (and the fragments' copies)
    tmb.default_budget().set_cap(int(stack * 1.5))
    tracker = tres.default_tracker()
    try:
        for k in range(6):
            fl = FLIGHT_F if k % 2 == 0 else FLIGHT_G
            parsed = [(torch_parse(q), s) for q, s in fl]
            pf.prefetch_flight([("i", q, s) for q, s in parsed])
            assert up.flush(10)
            got = ex.execute_batch("i", parsed)
            assert got == want[tuple(q for q, _ in fl)], k
        snap = tracker.snapshot()
        assert ex.stack_evictions >= 4
        assert snap["prefetchIssued"] >= 4
        assert snap["prefetchUseful"] / snap["prefetchIssued"] >= 0.5, snap
        assert up.snapshot()["uploadErrors"] == 0
    finally:
        up.close()


def test_a_dispatch_claims_the_queued_prefetch_of_its_stack(fresh_budgets, monkeypatch):
    """A flight's dispatch that needs a stack whose prefetch the uploader
    has not started builds the stack itself, without waiting for the
    uploader: it claims the prefetch, which counts useful and not wasted,
    and the uploader skips the job, so the stack is built once."""
    import threading

    h, ex, up, pf = _serving()
    tmb.default_budget().set_cap(1 << 40)
    tracker = tres.default_tracker()
    parsed = [(torch_parse(q), s) for q, s in FLIGHT_F]
    want = [ex.execute("i", q) for q, _ in FLIGHT_F]
    ex._stacks.clear()
    release = threading.Event()
    prefetch_stack = ex.prefetch_stack

    def held(*a, **kw):
        # the uploader holds the job until the dispatch is done
        assert release.wait(30)
        return prefetch_stack(*a, **kw)

    monkeypatch.setattr(ex, "prefetch_stack", held)
    rebuilds0, claims0, snap0 = ex.stack_rebuilds, ex.prefetch_claims, tracker.snapshot()
    try:
        assert pf.prefetch_flight([("i", q, s) for q, s in parsed]) == 1
        [note] = ex._prefetching.values()
        assert ex.execute_batch("i", parsed) == want  # returns with the job held
        assert note.state == "claimed" and ex.prefetch_claims - claims0 == 1
        release.set()
        assert up.flush(10)
        snap = tracker.snapshot()
        assert ex.stack_rebuilds - rebuilds0 == 1 and not ex._prefetching
        assert snap["prefetchUseful"] - snap0["prefetchUseful"] == 1
        assert snap["prefetchWasted"] == snap0["prefetchWasted"]
    finally:
        release.set()
        up.close()


def test_an_uncapped_budget_issues_nothing(fresh_budgets):
    h, ex, up, pf = _serving(4)
    try:
        assert tmb.default_budget().cap is None
        assert pf.prefetch_query("i", torch_parse(FLIGHT_F[0][0]), None) == 0
        assert tres.default_tracker().snapshot()["prefetchIssued"] == 0
    finally:
        up.close()
