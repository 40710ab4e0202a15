"""The configurations' generators, the packing into row words and the
plain reference, on the CPU at a small size.

    python -m pytest portbench -q
"""

import numpy as np
import pytest
import torch

from portbench import pack, run
from portbench.reference import Reference, canonical
from portbench.spec import Benchmark

WIDTH = 12
CELLS = ["taxi.q1-q4", "ssb.q1"]


def small(cell, shards=3):
    return dict(cell.config, shard_width_exp=WIDTH, shards=shards,
                records=(2 * shards - 1) << (WIDTH - 1))


@pytest.fixture(scope="module")
def bench():
    return Benchmark(run.ROOT)


def raws(cell, cfg, seed):
    return [r for _, r in run.raw_shards(cell, cfg, seed, torch.device("cpu"))]


@pytest.mark.parametrize("workload", CELLS)
def test_generator_deterministic(bench, workload):
    cell = bench.cell(workload)
    cfg = small(cell)
    a, b, c = raws(cell, cfg, 2**33 + 5), raws(cell, cfg, 2**33 + 5), raws(cell, cfg, 7)
    for x, y, z in zip(a, b, c):
        assert x.keys() == y.keys()
        for k in x:
            assert torch.equal(x[k], y[k])
        assert any(not torch.equal(x[k], z[k]) for k in x)
    # the last shard is half full
    assert len(next(iter(a[-1].values()))) == 1 << (WIDTH - 1)


def unpack(words: np.ndarray) -> np.ndarray:
    """bool [R, W * 32] of uint32 [R, W]."""
    return ((words[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1).reshape(len(words), -1) == 1


@pytest.mark.parametrize("workload", CELLS)
def test_words_agree_with_values(bench, workload):
    cell = bench.cell(workload)
    cfg = small(cell, shards=2)
    data = cell.data_module()
    for s, raw in run.raw_shards(cell, cfg, 11, torch.device("cpu")):
        n = run.shard_records(cfg, s)
        cols = {k: v.numpy() for k, v in data.columns(cfg, raw).items()}
        words = pack.shard_words(cfg, data.columns(cfg, raw), n, 1 << WIDTH).numpy().view(np.uint32)
        bits = unpack(words)
        assert not bits[:, n:].any()
        r0 = 0
        for field, view, rows in pack.layout(cfg):
            got = bits[r0:r0 + len(rows), :n]
            r0 += len(rows)
            if field == pack.EXISTENCE:
                assert got.all()
                continue
            f = next(f for f in cfg["fields"] if f["name"] == field)
            v = cols[field]
            if f["type"] == "int":
                base, depth = pack.int_layout(f)
                assert got[0].all() and not got[1].any()
                mag = (got[2:].astype(np.int64) << np.arange(depth)[:, None]).sum(0)
                assert np.array_equal(mag + base, v)
            else:
                assert (got.sum(0) == 1).all()
                assert np.array_equal(np.asarray(rows)[got.argmax(0)], v)


BODIES = {
    "taxi.q1-q4": [
        "GroupBy(Rows(cab_type))",
        "GroupBy(Rows(passenger_count), Rows(pickup_year), Rows(dist_miles))",
        "Sum(Row(passenger_count=1), field=total_amount) Sum(Row(passenger_count=5), field=total_amount)",
        "Count(Difference(Intersect(Row(pickup_year=2012), Row(dist_miles=2)), Row(cab_type=1)))",
        "Count(Intersect(Row(pickup_year=2010), Union(Row(passenger_count=1), Row(passenger_count=2)), Row(dist_miles=1)))",
    ],
    "ssb.q1": [
        "Sum(Intersect(Row(d_year=1993), Row(lo_discount >< [1, 3]), Row(lo_quantity < 25)), field=lo_ext_disc)",
        "Sum(Intersect(Row(d_yearmonthnum=199401), Row(lo_discount >< [4, 6]), Row(lo_quantity >< [26, 35])), field=lo_ext_disc)",
        "Sum(Intersect(Row(d_weeknuminyear=6), Row(d_year=1994), Row(lo_discount >< [5, 7]), Row(lo_quantity >< [26, 35])), field=lo_ext_disc)",
    ],
}


def brute(cols: dict, body: str):
    """Each call of ``body`` by a loop over the records' own values."""
    from portbench.pql import Cond, parse

    def mask(c):
        if c.name == "Row":
            (f, v), = c.args.items()
            x = cols[f]
            if not isinstance(v, Cond):
                return x == v
            if v.op == "><":
                return (x >= v.value[0]) & (x <= v.value[1])
            return {"<": x < v.value, "<=": x <= v.value, ">": x > v.value,
                    ">=": x >= v.value}[v.op]
        ms = [mask(k) for k in c.children]
        if c.name == "Intersect":
            return np.logical_and.reduce(ms)
        if c.name == "Union":
            return np.logical_or.reduce(ms)
        return ms[0] & ~np.logical_or.reduce(ms[1:])

    out = []
    for c in parse(body):
        if c.name == "Count":
            out.append(int(mask(c.children[0]).sum()))
        elif c.name == "Sum":
            m = mask(c.children[0])
            out.append([int(cols[c.args["field"]][m].sum()), int(m.sum())])
        else:
            fields = [k.args["_field"] for k in c.children]
            groups = {}
            for key in zip(*(cols[f].tolist() for f in fields)):
                groups[key] = groups.get(key, 0) + 1
            out.append([fields, [list(k) + [n] for k, n in sorted(groups.items())]])
    return out


@pytest.mark.parametrize("workload", CELLS)
def test_reference_agrees_with_brute_force(bench, workload):
    cell = bench.cell(workload)
    cfg = small(cell)
    data = cell.data_module()
    rs = raws(cell, cfg, 3)
    cols = {}
    for raw in rs:
        for k, v in data.columns(cfg, raw).items():
            cols.setdefault(k, []).append(v.numpy())
    cols = {k: np.concatenate(v) for k, v in cols.items()}
    ref = Reference(cell.ref_module().cell_table(cfg, iter(rs), torch.device("cpu")))
    for body in BODIES[workload]:
        assert ref.answer(body) == brute(cols, body), body


def test_canonical_forms():
    assert canonical(7) == 7
    assert canonical({"value": 5, "count": 2}) == [5, 2]
    gb = [{"group": [{"field": "a", "rowID": 1}, {"field": "b", "rowID": 0}], "count": 4}]
    assert canonical(gb) == [["a", "b"], [[1, 0, 4]]]
