"""The port stands alone: ``pilosa_tpu_torch`` and ``chip_smoke.py`` load
neither JAX nor any module of the JAX package (the device-memory budget,
the residency tracker, the native host tier, storage, the translate store,
time views, Store, the attrs calls and Options included, and one HTTP
node booted on the CPU answering a query, with its API, routes,
observability planes and CLI loaded, and its serving plane at the
defaults: the batcher, the result cache, the flight planner, the QoS
governor, the prefetcher and the ingest pipeline with its side-stream
uploads, and its observability planes at the defaults: the flight
recorder, the metrics history, the black box, diagnostics, the runtime
monitor and span export, and the cluster: placement, the wire, the
internal client, broadcasts, key translation through the primary, the
distributed executor with its mesh route and a two-node in-process
cluster on the CPU, and the elastic planes: migration, resize with its
watchdog, anti-entropy, membership, block checksums, the chunk prefetcher
and the lock witness, with a node added and one removed), the command
line's client subcommands (import, export, backup, restore, check,
inspect, generate-config and config) and the load harness with its
command line's stage plan and a short run; nor any module of ``tools/``;
and the port's default device is ``cuda`` with no fallback to the CPU."""

# the port's lock witness, installed before the port is imported so that its
# module-level locks are wrapped too (pilosa_tpu_torch/testing/lockwitness.py)
from pilosa_tpu_torch.testing import lockwitness as port_lockwitness

port_lockwitness.install()
# the module fixture that asserts no new inversion among the port's locks
from pilosa_tpu_torch.testing.lockwitness import no_new_inversion  # noqa: F401

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "pilosa_tpu_torch"

_PROBE = r"""
import sys
import pilosa_tpu_torch
from pilosa_tpu_torch import convert, device, pql
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.exec import astbatch
from pilosa_tpu_torch.exec.executor import Executor
from pilosa_tpu_torch.core.field import FieldOptions
from pilosa_tpu_torch.ops import bitops, bsi, cuda_build, kernels

h = Holder(device="cpu")
idx = h.create_index("i")
idx.create_field("f")
e = Executor(h)
e.execute("i", "Set(1, f=1) Set(2, f=1) Set(2, f=2) Set(70000, f=2)")
res = e.execute(
    "i",
    "Count(Intersect(Row(f=1), Row(f=2))) Count(Union(Row(f=1), Row(f=2))) "
    "TopN(f, Row(f=2), tanimotoThreshold=1)",
)
assert res[0] == 1 and res[1] == 3, res
assert [(p.id, p.count) for p in res[2]] == [(2, 2), (1, 1)], res[2]
calls = []
tree_count = kernels.tree_count
kernels.tree_count = lambda *a: calls.append(a) or tree_count(*a)
res = e.execute("i", "Count(Xor(Row(f=1), Row(f=2), Row(f=3))) Count(Not(Row(f=2)))" * 2)
assert res == [2, 1, 2, 1] and len(calls) == 2, (res, len(calls))
idx.create_field("v", FieldOptions(field_type="int", min_=-10, max_=100))
e.execute("i", "Set(1, v=7) Set(2, v=-3) Set(70000, v=90)")
res = e.execute("i", "Sum(field=v) Row(v > 5)")
assert (res[0].value, res[0].count) == (94, 3), res[0]
assert res[1].columns().tolist() == [1, 70000], res[1]
# the budget, the tracker and the native host tier: every stack declined,
# the same answers per fragment and on the host tier
from pilosa_tpu_torch import nativelib
from pilosa_tpu_torch.core import membudget, residency
from pilosa_tpu_torch.ops import _hostops
budget = membudget.configure(1)
e = Executor(h)  # no stack cached yet
res = e.execute(
    "i",
    "Count(Intersect(Row(f=1), Row(f=2))) Count(Union(Row(f=1), Row(f=2))) "
    "Sum(field=v) Count(Row(v > 5))",
)
assert res[:2] == [1, 3] and (res[2].value, res[2].count) == (94, 3), res
assert res[3] == 2 and e.stacks_declined > 0, (res, e.stacks_declined)
assert residency.default_tracker().snapshot()["deviceMisses"] > 0
import numpy as np
assert _hostops.popcount(np.array([3, 1], dtype=np.uint32)) == 3
assert nativelib.lib_path(nativelib.NATIVE_SRC / "hostops.cpp").is_file()
membudget.configure(None)
# storage and keys: a data dir written, closed and opened again, keyed
import tempfile
from pilosa_tpu_torch.core import translate
from pilosa_tpu_torch.storage import _native, disk, fragmentfile, roaring, translatelog
d = tempfile.mkdtemp()
st = disk.HolderStore(Holder(device="cpu"), d)
st.open()
st.holder.create_index("k", keys=True).create_field("kf", FieldOptions(keys=True))
ek = Executor(st.holder, translator=st.translator)
ek.execute("k", 'Set("a", kf="x") Set("b", kf="x") Set("b", kf="y")')
st.holder.field("k", "kf").view("standard").fragment(0).store.snapshot()
ek.execute("k", 'Clear("a", kf="x")')
st.close()
st = disk.HolderStore(Holder(device="cpu"), d)
st.open()
res = Executor(st.holder, translator=st.translator).execute("k", 'Row(kf="x") TopN(kf)')
assert res[0].keys == ["b"], res[0].keys
assert [(p.key, p.count) for p in res[1]] == [("x", 1), ("y", 1)], res[1]
assert nativelib.lib_path(nativelib.NATIVE_SRC / "roaring_codec.cpp").is_file()
st.close()
# time views, Store, attrs, Options and the deletes, in JSON form
import datetime
from pilosa_tpu_torch.exec.result import result_to_json
t = idx.create_field("t", FieldOptions(field_type="time", time_quantum="YMDH"))
t.import_bits([1, 2], [3, 70000], timestamps=[datetime.datetime(2024, 1, 1, 5), None])
e = Executor(h)
e.execute("i", "Set(4, t=1, 2024-01-01T06:00)")
w = "from=2024-01-01T00:00, to=2024-01-01T06:00"
res = e.execute_batch("i", [(f"Count(Row(t=1, {w}))", None)] * 2)
assert res == [[1], [1]], res
res = result_to_json(e.execute(
    "i", f"Store(Row(t=1, {w}), s=0) SetRowAttrs(s, 0, x=1) Options(Row(s=0), columnAttrs=true)"))
assert res == [True, None, {"attrs": {"x": 1, "columnattrs": []}, "columns": [3]}], res
assert idx.delete_field("t") and h.fragment("i", "s", "standard", 0) is not None
# one HTTP node on the CPU: the API, the routes, the observability planes
# and the CLI's module load, and a query answered over HTTP
import json
import urllib.request
from pilosa_tpu_torch import cli, deadline
from pilosa_tpu_torch.obs import (devledger, events, jobs, profile, qprofile, slo, stats,
                                  sysinfo, tracestore, tracing)
from pilosa_tpu_torch.server import api, http, importpool, node, qos
n = node.NodeServer(data_dir=tempfile.mkdtemp(), device="cpu", port=0)
n.start()
def post(path, body):
    req = urllib.request.Request(n.uri + path, data=body.encode(), method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read())
post("/index/h", "{}")
post("/index/h/field/f", "{}")
post("/index/h/field/f/import", '{"rowIDs": [1, 1], "columnIDs": [2, 70000]}')
assert post("/index/h/query", "Count(Row(f=1))") == {"results": [2]}
with urllib.request.urlopen(n.uri + "/debug/vars", timeout=10) as r:
    dv = json.loads(r.read())
    assert "kernels" in dv and {"rescache", "planner", "batcher", "qos", "ingest"} <= set(dv)
# the serving plane's modules, loaded and on at the defaults
from pilosa_tpu_torch.exec import planner, rescache
from pilosa_tpu_torch.ingest import pipeline, staging
from pilosa_tpu_torch.ops import streams
from pilosa_tpu_torch.server import batcher, prefetch
assert n.api.batcher is not None and n.api.qos is not None and n.api.prefetcher is not None
assert post("/index/h/query", "Count(Row(f=1))") == {"results": [2]}
assert n.api.executor.rescache.snapshot()["hits"] >= 1
with urllib.request.urlopen(n.uri + "/debug/qos", timeout=10) as r:
    assert "tenants" in json.loads(r.read())
# the observability planes, loaded and on at the defaults
from pilosa_tpu_torch.obs import blackbox, diagnostics, export, flightrec, history
from pilosa_tpu_torch.obs.sysinfo import GCNotifier, RuntimeMonitor
from pilosa_tpu_torch.obs.tracing import ExportingTracer, RecordingTracer
assert n.flightrec is not None and n.history is not None and n.blackbox is not None
n.history.sample_once()
n.blackbox.checkpoint("probe")
for path in ("/debug/history", "/debug/incidents", "/debug/postmortem", "/internal/diagnostics"):
    with urllib.request.urlopen(n.uri + path, timeout=10) as r:
        assert r.status == 200, path
# every client subcommand of the CLI against the node and its files
import contextlib, glob, io, os
csv = os.path.join(tempfile.mkdtemp(), "bits.csv")
with open(csv, "w") as fh:
    fh.write("3,9\n3,70001\n")
host = n.uri.removeprefix("http://")
tar = csv + ".tar"
with contextlib.redirect_stdout(io.StringIO()) as out, contextlib.redirect_stderr(io.StringIO()):
    assert cli.main(["import", "--host", host, "-i", "h", "-f", "f", csv]) == 0
    assert cli.main(["export", "--host", host, "-i", "h", "-f", "f"]) == 0
    assert cli.main(["backup", "--host", host, "-o", tar]) == 0
    files = glob.glob(os.path.join(n.store.path, "h", "f", "views", "standard", "fragments", "*"))
    assert files and cli.main(["check"] + files) == 0 and cli.main(["inspect"] + files) == 0
    assert cli.main(["generate-config"]) == 0 and cli.main(["config"]) == 0
assert "3,70001" in out.getvalue() and "OK (" in out.getvalue(), out.getvalue()
n.shutdown_graceful()
assert n.wait(10)
# the cluster: every module of the slice loaded, and a two-node cluster of
# the port booted on the CPU, answering over both routes
from pilosa_tpu_torch.cluster import (broadcast, client, cluster, dist, hash, meshexec,
                                      topology, translate_proxy, wire)
from pilosa_tpu_torch.parallel import meshplace
from pilosa_tpu_torch.testing import faults
from pilosa_tpu_torch.testing.cluster import InProcessCluster
with InProcessCluster(2, replica_n=2, device="cpu") as cl:
    cl.create_index("c")
    cl.create_field("c", "f")
    cl.import_bits("c", "f", [(1, 5), (1, 70000), (2, 5)])
    for i in range(2):
        assert cl.query(i, "c", "Count(Row(f=1)) TopN(f)")["results"] == [
            2, [{"id": 1, "count": 2}, {"id": 2, "count": 1}]]
    assert cl[0].api.dist.snapshot()["meshDispatches"] > 0
    for nd in cl.nodes:
        nd.api.dist.mesh_enabled = False
    assert cl.query(1, "c", "Count(Row(f=1))")["results"] == [2]
    # the elastic planes: a node joins and one leaves through the resize
    # protocol, and anti-entropy finds nothing to repair
    from pilosa_tpu_torch.cluster import antientropy, membership, migration, resize
    from pilosa_tpu_torch.core import blockhash
    from pilosa_tpu_torch.ingest.pipeline import ChunkPrefetcher
    from pilosa_tpu_torch.testing import lockwitness
    assert cl[0].resize_watchdog is not None
    cl.add_node()
    assert cl.query(2, "c", "Count(Row(f=1))")["results"] == [2]
    assert cl.sync_all()["bits_set"] == 0
    cl.remove_node(1)
    assert cl.query(1, "c", "Count(Row(f=1))")["results"] == [2]
    # the backup restored into the cluster through the CLI
    with contextlib.redirect_stderr(io.StringIO()):
        assert cli.main(["restore", "--host", cl[1].uri.removeprefix("http://"), tar]) == 0
    assert cl.query(0, "h", "Count(Row(f=3))")["results"] == [2]
# the load harness: its modules, its command line's plan and a short run
from pilosa_tpu_torch import loadgen
from pilosa_tpu_torch.loadgen import __main__ as loadgen_main, harness, report, workload
rep = loadgen.run_harness(
    loadgen.WorkloadConfig(seed=3, n_cols=5000),
    [loadgen.StageSpec("s", 0.5, 20.0, 2), loadgen_main.default_stages(8.0, 4.0, 1)[3]],
    preload_bits=64, device="cpu", cluster_setup=loadgen_main.tune_qos)
loadgen.validate_report(rep)
assert rep["clientErrors"] == 0 and rep["stages"][1]["deviceBudget"], rep["stages"]
bad = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
    or m == "pilosa_tpu" or m.startswith("pilosa_tpu.")
    or m == "tools" or m.startswith("tools.")
)
print("BAD", bad)
"""


def test_port_runs_without_jax_or_the_jax_package():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert "BAD []" in r.stdout, r.stdout


def _imported_modules(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            out.append(node.module)
    return out


def _is_forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "pilosa_tpu", "tools")


@pytest.mark.parametrize(
    "path",
    sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_no_jax_imports_in_source(path):
    bad = [m for m in _imported_modules(path) if _is_forbidden(m)]
    assert bad == [], f"{path}: {bad}"


def test_default_device_is_cuda_without_fallback():
    import torch

    from pilosa_tpu_torch import device
    from pilosa_tpu_torch.core.holder import Holder

    assert device.DEFAULT_DEVICE == "cuda"
    assert device.resolve("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert Holder().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Holder()
        with pytest.raises(RuntimeError):
            device.resolve("cuda")
