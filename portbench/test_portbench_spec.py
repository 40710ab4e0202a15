"""A configuration, a traffic mix and a per-layer metric added as files
in a directory of their own are found by name and run: nothing of the
harness is edited."""

import json
import subprocess
import sys
import textwrap

import pytest

from portbench import run
from portbench.observe import Window
from portbench.spec import Benchmark

DATA = '''
import torch

def raw_shard(cfg, gen, n, dev):
    return {"colour": torch.randint(0, 3, (n,), generator=gen, device=dev),
            "size": torch.randint(0, 4, (n,), generator=gen, device=dev),
            "price": torch.randint(0, 1000, (n,), generator=gen, device=dev)}

def columns(cfg, raw):
    return raw
'''

REF = '''
import numpy as np
import torch
from portbench.reference import CellTable

def cell_table(cfg, raws, dev):
    count = torch.zeros(12, dtype=torch.int64, device=dev)
    price = torch.zeros(12, dtype=torch.int64, device=dev)
    for raw in raws:
        key = raw["colour"] * 4 + raw["size"]
        count += torch.bincount(key, minlength=12)
        price.index_add_(0, key, raw["price"])
    cell = np.arange(12)
    return CellTable(count=count.numpy(), values={"colour": cell // 4, "size": cell % 4},
                     sums={"price": price.numpy()})
'''


@pytest.fixture
def root(tmp_path):
    pb = tmp_path / "pb"
    for d in ("configs", "traffic", "metrics"):
        (pb / d).mkdir(parents=True)
    (pb / "configs" / "toy-shop.json").write_text(json.dumps({
        "name": "toy-shop", "index": "shop", "shard_width_exp": 14, "records": 3 << 13,
        "shards": 2, "existence": True, "node": {"rescache_entries": 0},
        "fields": [{"name": "colour", "type": "set", "rows": 3},
                   {"name": "size", "type": "set", "rows": 4},
                   {"name": "price", "type": "int", "min": 0, "max": 999}]}))
    (pb / "configs" / "toy-shop.data.py").write_text(DATA)
    (pb / "configs" / "toy-shop.ref.py").write_text(REF)
    (pb / "traffic" / "toy-mix.json").write_text(json.dumps({
        "clients": 3, "order": "random", "warm_requests": 2,
        "templates": [{"name": "sum", "pql": "Sum(Row(colour={c}), field=price)"},
                      {"name": "by", "pql": "GroupBy(Rows(colour), Rows(size))"},
                      {"name": "tree", "pql": "Count(Intersect(Row(colour={c}), Row(size={s})))"}],
        "draws": {"c": {"law": "uniform_int", "lo": 0, "hi": 2},
                  "s": {"law": "zipf", "theta": 0.99, "values": [3, 1, 0, 2]}}}))
    (pb / "metrics" / "toy.requests_per_s.py").write_text(textwrap.dedent('''
        def read(w):
            return len(w.requests) / w.window_s
    '''))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        "paths": ["pb"],
        "configs": [{"name": "toy-shop", "file": "pb/configs/toy-shop.json"}],
        "workloads": [{"name": "toy.cell", "config": "toy-shop", "traffic": "toy-mix",
                       "chips": 1}],
        "end_to_end": [{"name": "queries_per_s", "unit": "queries/s"},
                       {"name": "setup_s", "unit": "s"}],
        "per_layer": [{"name": "toy.requests_per_s", "unit": "requests/s",
                       "workloads": ["toy.cell"]}]}))
    return tmp_path


def test_files_found_by_name(root):
    b = Benchmark(root)
    cell = b.cell("toy.cell")
    assert cell.config["index"] == "shop" and cell.traffic["clients"] == 3
    assert hasattr(cell.data_module(), "raw_shard")
    assert hasattr(cell.ref_module(), "cell_table")
    assert [m["name"] for m in cell.per_layer] == ["toy.requests_per_s"]
    w = Window(t0=0.0, t1=2.0, requests=[[0]] * 5)
    assert b.reader("toy.requests_per_s")(w) == 2.5


def test_added_cell_runs_end_to_end(root):
    out = subprocess.run(
        [sys.executable, "-m", "portbench.rehearse", "--root", str(root), "--workload",
         "toy.cell", "--seed", "9", "--seconds", "1.5", "--shards", "2", "--width", "14"],
        cwd=run.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.splitlines()[-1])
    assert result["correct"] and result["attempted"] > 0, result
    assert set(result["metrics"]) == {"queries_per_s", "setup_s"}
