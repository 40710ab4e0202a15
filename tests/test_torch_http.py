"""One HTTP node of the port against a JAX node, on the CPU.

A JAX node (``pilosa_tpu.server.api.API`` + ``http.Server`` over a
``HolderStore``) and a port node (the same over ``device="cpu"``) each get
the same request script, once with the serving plane cut down on both
(``batch_window=0, rescache_entries=0, planner_enabled=False``) and once at
both APIs' defaults (batcher, result cache, planner, QoS and the ingest
pipeline on):
schema CRUD with its 404 and 409 answers, JSON imports by id, by key, with
timestamps, with values and with ``clear``, ``import-roaring`` (a bad
payload too), every call kind the executor serves, parse errors, an
unknown index, a ``?timeout=`` too small to meet, ``/export``,
``/internal/shards/max``, key translation, ``/status`` and ``/schema``.
Status codes must be equal, and JSON bodies equal once the volatile keys
(versions, node ids, uptimes and times) are dropped. For ``?profile=true``
the span names and the executor counters of the call tree must be equal.
The debug planes must have JAX's top-level keys wherever both have the
plane (``/debug/qos`` too, at the defaults), and values that agree with
the requests sent. A JAX ``NodeServer`` and a port ``NodeServer``, their
observability planes on and then off, answer ``/debug/history`` (with
``series``, ``since``, ``step`` and ``limit``, and a bad cursor),
``/debug/incidents`` (the list and one bundle), ``/debug/postmortem``,
``/internal/diagnostics`` and the ``blackbox`` block of ``/debug/vars``
with the same codes and JSON keys. A port node's data directory answers the same after a restart, and
so does a directory the JAX node wrote. Threads of clients get the serial
answers, and ``python -m pilosa_tpu_torch.cli server`` runs on the CPU
when asked and refuses to start without CUDA otherwise.
"""

import gc
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from pilosa_tpu.core.holder import Holder as JaxHolder
from pilosa_tpu.obs.stats import MemStatsClient as JaxMemStats
from pilosa_tpu.server.api import API as JaxAPI
from pilosa_tpu.server.http import Server as JaxServer
from pilosa_tpu.storage import roaring as jax_roaring
from pilosa_tpu.storage.disk import HolderStore as JaxStore
from pilosa_tpu_torch.core.holder import Holder as TorchHolder
from pilosa_tpu_torch.obs.stats import MemStatsClient as TorchMemStats
from pilosa_tpu_torch.ops import kernels as tk
from pilosa_tpu_torch.server.api import API as TorchAPI
from pilosa_tpu_torch.server.http import Server as TorchServer
from pilosa_tpu_torch.server.node import NodeServer
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
from pilosa_tpu_torch.storage.disk import HolderStore as TorchStore

REPO = Path(__file__).resolve().parents[1]
N_SHARDS = 3
TIMEOUT = 10  # seconds for every request

# keys whose values differ between two nodes by nature
VOLATILE = {"version", "localID", "startedAt", "duration_ms", "traceId", "node"}
# /debug/vars blocks of JAX planes the port does not have (the cluster's)
ABSENT_VARS = {"migrations", "dist"}
# the serving plane cut down, as the JAX node can be
CUT = {"batch_window": 0, "rescache_entries": 0, "planner_enabled": False}


@pytest.fixture(scope="module", autouse=True)
def _freeze_what_came_before():
    """Freeze what is alive when the module's tests begin, so that the
    collection after each test scans only what the tests made."""
    gc.collect()
    gc.freeze()
    yield
    gc.unfreeze()
    gc.collect()


@pytest.fixture(autouse=True)
def _collect_after_each_test():
    """Collect each test's garbage at its end, where no lock is held (the
    JAX holders' budget entries release their bytes in finalizers)."""
    yield
    gc.collect()


def _jax_node(path, defaults=False):
    holder = JaxHolder()
    holder.set_stats(JaxMemStats())
    store = JaxStore(holder, str(path))
    store.open()
    srv = JaxServer(JaxAPI(holder, store, **({} if defaults else CUT)), port=0)
    srv.serve_background()
    return srv


def _torch_node(path, defaults=False):
    holder = TorchHolder(device="cpu")
    holder.set_stats(TorchMemStats())
    store = TorchStore(holder, str(path))
    store.open()
    srv = TorchServer(TorchAPI(holder, store, **({} if defaults else CUT)), port=0)
    srv.serve_background()
    return srv


def _pair(tmp_path, defaults):
    servers = []
    try:
        servers.append(_jax_node(tmp_path / "jax", defaults))
        servers.append(_torch_node(tmp_path / "torch", defaults))
        yield servers[0], servers[1]
    finally:
        for srv in servers:
            srv.close()


@pytest.fixture()
def pair(tmp_path):
    """(JAX server, port server) on fresh data directories, the serving
    plane cut down on both; both closed at the end, whatever happened."""
    yield from _pair(tmp_path, defaults=False)


@pytest.fixture()
def pair_defaults(tmp_path):
    """The same at both APIs' defaults: batcher, result cache, planner, QoS
    and the ingest pipeline on."""
    yield from _pair(tmp_path, defaults=True)


def call(port, method, path, body=None, content_type="application/json", raw=False):
    """(status, JSON body or raw bytes) of one request."""
    data = body if isinstance(body, (bytes, type(None))) else json.dumps(body).encode()
    if isinstance(body, str):
        data = body.encode()
    req = urllib.request.Request(f"http://localhost:{port}{path}", data=data, method=method)
    req.add_header("Content-Type", content_type)
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
            status, payload = resp.status, resp.read()
    except urllib.error.HTTPError as e:
        status, payload = e.code, e.read()
    if raw:
        return status, payload
    return status, (json.loads(payload) if payload.strip() else {})


def _strip(obj):
    """``obj`` without the volatile keys, at any depth."""
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in VOLATILE}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def _status_view(body):
    """/status without the node id in each node entry."""
    body = _strip(body)
    for n in body.get("nodes", []):
        n.pop("id", None)
    return body


def _tree(node):
    """(span name, executor counters, children) of a profile tree, the
    transfer byte counts aside."""
    stats = {k: v for k, v in node.get("stats", {}).items() if not k.startswith("transfer_")}
    kids = [_tree(c) for c in node.get("children", [])]
    return (node["name"], stats, kids)


def _roaring_payload(rng, width, rows, density):
    """Sorted positions row * width + column of random bits, and their
    roaring bytes."""
    parts = []
    for r in rows:
        cols = np.flatnonzero(rng.random(width) < density).astype(np.uint64)
        parts.append(cols + np.uint64(r * width))
    positions = np.concatenate(parts)
    return positions, jax_roaring.serialize(positions)


def _script(rng):
    """The request script: (method, path, body, content type, kind) with
    kind "json" (compare JSON), "raw" (compare bytes), "status" (compare
    /status) or "profile" (compare the call tree)."""
    W = SHARD_WIDTH
    n_bits = 600
    cols = rng.integers(0, N_SHARDS * W, n_bits)
    rows = rng.integers(0, 6, n_bits)
    g_rows = rng.integers(0, 4, n_bits)
    v_cols = rng.choice(N_SHARDS * W, 300, replace=False)
    v_vals = rng.integers(-50, 1000, 300)
    keys = [f"k{i}" for i in range(40)]
    key_cols = rng.choice(keys, 120)
    key_rows = rng.choice(["red", "green", "blue"], 120)
    stamps = [
        f"2024-01-{1 + d:02d}T{h:02d}:00"
        for d, h in zip(rng.integers(0, 3, 200), rng.integers(0, 24, 200))
    ]
    t_cols = rng.integers(0, N_SHARDS * W, 200)
    t_rows = rng.integers(0, 3, 200)
    _, good_roaring = _roaring_payload(rng, W, [7, 8], 0.05)
    # exists row 0, value planes at rows 2-4 (values 0-7) of 50 columns
    w_cols = np.sort(rng.choice(W, 50, replace=False)).astype(np.uint64)
    w_vals = rng.integers(0, 8, 50)
    bsi_pos = [w_cols] + [
        w_cols[(w_vals >> k) & 1 == 1] + np.uint64((2 + k) * W) for k in range(3)
    ]
    bsi_roaring = jax_roaring.serialize(np.sort(np.concatenate(bsi_pos)))
    J = "json"
    s = [
        ("POST", "/index/i", {}, None, J),
        ("POST", "/index/i", {}, None, J),  # 409
        ("POST", "/index/Bad_Name", {}, None, J),  # 400
        ("GET", "/index/i", None, None, J),
        ("GET", "/index/nope", None, None, J),  # 404
        ("POST", "/index/i/field/f", {}, None, J),
        ("POST", "/index/i/field/f", {}, None, J),  # 409
        ("POST", "/index/nope/field/f", {}, None, J),  # 404
        ("POST", "/index/i/field/g", {"options": {"cacheType": "ranked"}}, None, J),
        ("POST", "/index/i/field/v", {"options": {"type": "int", "min": -100, "max": 2000}}, None, J),
        ("POST", "/index/i/field/t", {"options": {"type": "time", "timeQuantum": "YMDH"}}, None, J),
        ("POST", "/index/i/field/m", {"options": {"type": "mutex"}}, None, J),
        ("POST", "/index/i/field/b", {"options": {"type": "bool"}}, None, J),
        ("POST", "/index/i/field/r", {}, None, J),
        ("POST", "/index/i/field/tmp", {}, None, J),
        ("GET", "/index/i/field/v", None, None, J),
        ("GET", "/index/i/field/nope", None, None, J),  # 404
        ("DELETE", "/index/i/field/tmp", None, None, J),
        ("DELETE", "/index/i/field/tmp", None, None, J),  # 404
        ("POST", "/index/k", {"options": {"keys": True}}, None, J),
        ("POST", "/index/k/field/kf", {"options": {"keys": True}}, None, J),
        ("POST", "/index/gone", {}, None, J),
        ("DELETE", "/index/gone", None, None, J),
        ("DELETE", "/index/gone", None, None, J),  # 404
        # imports
        ("POST", "/index/i/field/f/import",
         {"rowIDs": rows.tolist(), "columnIDs": cols.tolist()}, None, J),
        ("POST", "/index/i/field/g/import",
         {"rowIDs": g_rows.tolist(), "columnIDs": cols.tolist()}, None, J),
        ("POST", "/index/i/field/f/import",
         {"rowIDs": rows[:50].tolist(), "columnIDs": cols[:50].tolist(), "clear": True}, None, J),
        ("POST", "/index/i/field/v/import",
         {"columnIDs": v_cols.tolist(), "values": v_vals.tolist()}, None, J),
        ("POST", "/index/i/field/v/import",
         {"columnIDs": [1], "values": [5000]}, None, J),  # out of range
        ("POST", "/index/i/field/f/import",
         {"columnIDs": [1], "values": [5]}, None, J),  # not an int field
        ("POST", "/index/i/field/t/import",
         {"rowIDs": t_rows.tolist(), "columnIDs": t_cols.tolist(), "timestamps": stamps}, None, J),
        ("POST", "/index/i/field/m/import",
         {"rowIDs": [1, 2, 3], "columnIDs": [10, 10, 11]}, None, J),
        ("POST", "/index/i/field/f/import", {"rowIDs": [1]}, None, J),  # 400
        ("POST", "/index/i/field/f/import", {"rowIDs": [1, 2], "columnIDs": [3]}, None, J),
        ("POST", "/index/nope/field/f/import", {"rowIDs": [1], "columnIDs": [3]}, None, J),
        ("POST", "/index/i/field/nope/import", {"rowIDs": [1], "columnIDs": [3]}, None, J),
        ("POST", "/index/i/field/f/import", b"{not json", None, J),
        ("POST", "/index/k/field/kf/import",
         {"rowKeys": key_rows.tolist(), "columnKeys": key_cols.tolist()}, None, J),
        ("POST", "/index/i/field/f/import", {"rowIDs": [1], "columnKeys": ["x"]}, None, J),
        ("POST", "/index/i/field/r/import-roaring/1", good_roaring,
         "application/octet-stream", J),
        ("POST", "/index/i/field/r/import-roaring/1", good_roaring,
         "application/octet-stream", J),  # nothing changes
        ("POST", "/index/i/field/r/import-roaring/2?clear=true", good_roaring,
         "application/octet-stream", J),
        ("POST", "/index/i/field/r/import-roaring/0", b"\x00\x01garbage!!",
         "application/octet-stream", J),  # 400
        ("POST", "/index/i/field/nope/import-roaring/0", good_roaring,
         "application/octet-stream", J),  # 404
        # an int field's planes by import-roaring: exists, then planes 0-2
        ("POST", "/index/i/field/w", {"options": {"type": "int", "min": 0, "max": 1000}}, None, J),
        ("POST", "/index/i/field/w/import-roaring/1?view=bsig_w", bsi_roaring,
         "application/octet-stream", J),
    ]
    q = [
        "Row(f=1)", "Count(Row(f=1))", "Count(Intersect(Row(f=1), Row(f=2)))",
        "Count(Union(Row(f=0), Row(f=3))) Count(Difference(Row(f=1), Row(g=2)))",
        "Count(Xor(Row(f=4), Row(g=1)))", "Intersect(Row(f=1), Row(g=0))",
        "Union(Row(f=2), Row(f=5), Row(g=3))", "Count(Not(Row(f=1)))",
        "Difference(Row(f=1), Row(g=1))", "Xor(Row(f=0), Row(g=0))",
        "TopN(f)", "TopN(f, n=3)", "TopN(f, Row(g=1))", "TopN(g, Row(f=2), n=2)",
        "Rows(f)", "Rows(f, limit=2)", "GroupBy(Rows(f), Rows(g))",
        "GroupBy(Rows(f), limit=3)", "GroupBy(Rows(g), Rows(f), filter=Row(f=1))",
        "Row(v > 500)", "Count(Row(v < 0))", "Row(-10 < v < 100)", "Count(Row(v == 12))",
        "Sum(field=v)", "Sum(Row(f=1), field=v)", "Min(field=v)", "Max(field=v)",
        "Sum(field=w) Count(Row(w > 3)) Max(field=w)",
        "Min(Row(g=2), field=v)", "MinRow(field=f)", "MaxRow(field=f)",
        "Row(t=1, from=2024-01-01T00:00, to=2024-01-02T00:00)",
        "Count(Row(t=0, from=2024-01-02T05:00, to=2024-01-03T12:00))",
        "Row(m=1)", "Row(m=2)", "Count(Row(r=7))", "Count(Row(r=8))",
        "Set(9, f=1) Count(Row(f=1))", "Clear(9, f=1) Count(Row(f=1))",
        "Set(12, b=true) Row(b=true)", "ClearRow(f=5) Count(Row(f=5))",
        "Store(Row(f=2), f=6) Count(Row(f=6))",
        "SetRowAttrs(f, 1, color=\"blue\") Row(f=1)",
        "SetColumnAttrs(7, name=\"x\") Options(Row(f=1), columnAttrs=true)",
        "Set(100, v=42) Row(v == 42)",
        "Shift(Row(f=1), n=2)",
        "Count(Row(f=1)) Count(Row(f=1)) Count(Row(f=2))",
        "Row(f=",  # parse error
        "Unknown(f=1)",
        "Row(nope=1)",
    ]
    s += [("POST", "/index/i/query", x, "text/plain", J) for x in q]
    s += [
        ("POST", "/index/k/query", 'Row(kf="red") Count(Row(kf="blue")) TopN(kf)', "text/plain", J),
        ("POST", "/index/k/query", 'Set("new", kf="red") Row(kf="red")', "text/plain", J),
        ("POST", "/index/nope/query", "Count(Row(f=1))", "text/plain", J),
        ("POST", "/index/i/query?timeout=0.000001", "Count(Row(f=1))", "text/plain", J),
        ("POST", "/index/i/query", {"query": "Count(Row(f=1))", "shards": [1]}, None, J),
        ("POST", "/index/i/query?shards=0,2", "Count(Row(f=2))", "text/plain", J),
        ("POST", "/index/i/query?profile=true", "Count(Row(f=1))", "text/plain", "profile"),
        ("POST", "/index/i/query?profile=true",
         "Count(Intersect(Row(f=1), Row(f=2))) Count(Union(Row(f=1), Row(f=3)))",
         "text/plain", "profile"),
        ("POST", "/index/i/query?profile=true", "TopN(f) GroupBy(Rows(f), Rows(g))",
         "text/plain", "profile"),
        ("POST", "/index/i/query?profile=true", "Sum(field=v) Count(Row(v > 3))",
         "text/plain", "profile"),
        ("GET", "/export?index=i&field=f", None, None, "raw"),
        ("GET", "/export?index=i&field=f&shard=1", None, None, "raw"),
        ("GET", "/export?index=k&field=kf", None, None, "raw"),
        ("GET", "/export?index=i", None, None, J),  # 400
        ("GET", "/export?index=i&field=nope", None, None, J),  # 404
        ("GET", "/internal/shards/max", None, None, J),
        ("POST", "/internal/translate/keys", {"index": "k", "keys": ["k1", "k2", "zz"]}, None, J),
        ("POST", "/internal/translate/keys", {"index": "k", "field": "kf", "keys": ["red"]}, None, J),
        ("POST", "/internal/translate/ids", {"index": "k", "ids": [1, 2, 3]}, None, J),
        ("GET", "/internal/fragment/data?index=i&field=f&shard=1", None, None, "raw"),
        ("GET", "/internal/fragment/data?index=i&field=f&shard=9", None, None, J),
        ("POST", "/recalculate-caches", None, None, J),
        ("GET", "/info", None, None, J),
        ("GET", "/schema", None, None, J),
        ("GET", "/status", None, None, "status"),
        ("GET", "/no/such/route", None, None, J),
        ("POST", "/schema", {"indexes": [{"name": "s", "fields": [{"name": "x"}]}]}, None, J),
        ("GET", "/schema", None, None, J),
    ]
    return s


def _send(port, method, path, body, ctype):
    return call(port, method, path, body, ctype or "application/json", raw=True)


def test_request_script_answers_as_jax(pair):
    _run_script(*pair)


def test_request_script_answers_as_jax_at_defaults(pair_defaults):
    jax_srv, torch_srv = pair_defaults
    _run_script(jax_srv, torch_srv)
    # the serving plane counted alike on both nodes
    j = call(jax_srv.port, "GET", "/debug/vars")[1]
    t = call(torch_srv.port, "GET", "/debug/vars")[1]
    for block, keys in (("rescache", ("hits", "misses", "invalidations", "stores")),
                        ("planner", ("cseHits", "cseShared", "reorders"))):
        assert {k: t[block][k] for k in keys} == {k: j[block][k] for k in keys}, block
    assert t["rescache"]["hits"] > 0 and t["batcher"]["batches"] > 0


def _run_script(jax_srv, torch_srv):
    script = _script(np.random.default_rng(7))
    for method, path, body, ctype, kind in script:
        jc, jb = _send(jax_srv.port, method, path, body, ctype)
        tc, tb = _send(torch_srv.port, method, path, body, ctype)
        what = f"{method} {path} {body if isinstance(body, str) else ''}"
        assert jc == tc, (what, jc, tc, jb[:300], tb[:300])
        if kind == "raw" and jc == 200:
            assert jb == tb, what
            continue
        j, t = json.loads(jb), json.loads(tb)
        if kind == "status":
            assert _status_view(j) == _status_view(t), what
        elif kind == "profile":
            assert j["results"] == t["results"], what
            assert _tree(j["profile"]["tree"]) == _tree(t["profile"]["tree"]), what
        else:
            assert _strip(j) == _strip(t), (what, j, t)


def test_debug_planes_have_jax_keys_and_count_the_requests(pair):
    _debug_planes(*pair)


def test_debug_planes_at_defaults_have_the_serving_blocks(pair_defaults):
    j, t = _debug_planes(*pair_defaults)
    for block in ("rescache", "planner", "batcher", "qos", "ingest"):
        assert block in t["/debug/vars"] and block in j["/debug/vars"], block
        assert set(t["/debug/vars"][block]) >= set(j["/debug/vars"][block]), block
    assert set(t["/debug/qos"]) == set(j["/debug/qos"])
    assert set(t["/debug/qos"]["tenants"]) == set(j["/debug/qos"]["tenants"])
    for k in ("admitted", "shed", "degraded"):
        assert [v[k] for v in t["/debug/qos"]["tenants"].values()] == [
            v[k] for v in j["/debug/qos"]["tenants"].values()
        ]
    assert t["/debug/vars"]["ingest"]["uploader"]["uploadErrors"] == 0


def _debug_planes(jax_srv, torch_srv):
    for port in (jax_srv.port, torch_srv.port):
        call(port, "POST", "/index/i", {})
        call(port, "POST", "/index/i/field/f", {})
        call(port, "POST", "/index/i/field/f/import",
             {"rowIDs": [1, 1, 2], "columnIDs": [3, SHARD_WIDTH + 4, 5]})
        for q in ("Count(Row(f=1))", "Row(f=2)", "Row(f=", "TopN(f)"):
            call(port, "POST", "/index/i/query", q, "text/plain")
    views = {}
    for name, port in (("jax", jax_srv.port), ("torch", torch_srv.port)):
        got = {}
        for path in ("/debug/vars", "/debug/slo", "/debug/traces", "/debug/events",
                     "/debug/jobs", "/debug/fragments?index=i&field=f",
                     "/debug/devcosts", "/debug/slow-queries", "/debug/memory",
                     "/debug/threads", "/debug", "/debug/profile?seconds=0.05",
                     "/debug/qos"):
            code, body = call(port, "GET", path)
            assert code == 200, (name, path, code)
            got[path] = body
        code, text = call(port, "GET", "/metrics", raw=True)
        assert code == 200
        got["/metrics"] = text.decode()
        views[name] = got
    j, t = views["jax"], views["torch"]
    assert set(j["/debug/vars"]) - ABSENT_VARS == set(t["/debug/vars"])
    for path in ("/debug/slo", "/debug/traces", "/debug/events", "/debug/jobs",
                 "/debug/fragments?index=i&field=f", "/debug/slow-queries"):
        assert set(j[path]) == set(t[path]), path
    # the request counts each node kept agree with the requests sent
    for v in (j, t):
        counters = v["/debug/vars"]["counters"]
        assert counters["http_requests{route:query}"] == 4
        assert counters["http_requests{route:import_}"] == 1
        assert counters["http_requests{route:create_index}"] == 1
    jslo, tslo = j["/debug/slo"], t["/debug/slo"]
    assert set(jslo["classes"]) == set(tslo["classes"])
    for cls in jslo["classes"]:
        for key in ("total", "errors"):
            assert jslo["classes"][cls].get(key) == tslo["classes"][cls].get(key), (cls, key)
    # shards 0 and 1 of f, and their rows and bits
    jf, tf = j["/debug/fragments?index=i&field=f"], t["/debug/fragments?index=i&field=f"]
    pick = ("index", "field", "view", "shard", "rows", "bits", "containers")
    assert [{k: f[k] for k in pick} for f in jf["fragments"]] == [
        {k: f[k] for k in pick} for f in tf["fragments"]
    ]
    assert tf["totals"]["fragments"] == 2 and tf["totals"]["bits"] == 3
    assert set(jf["fragments"][0]) == set(tf["fragments"][0])
    # one import-drain job ran to its end on each node
    for v in (j, t):
        drains = [x for x in v["/debug/jobs"]["jobs"] if x["kind"] == "import-drain"]
        assert [x["status"] for x in drains] == ["done"], v["/debug/jobs"]
    # the port's kernels block: every kernel, no launch on the CPU
    assert set(t["/debug/vars"]["kernels"]) == set(tk.LAUNCHES)
    # /metrics parses, and the request counter reads the same on both
    for text in (j["/metrics"], t["/metrics"]):
        for line in text.splitlines():
            if line and not line.startswith("#"):
                assert re.match(r"^[a-zA-Z_:][\w:]*(\{.*\})? \S+( # .*)?$", line), line
        assert re.search(r'pilosa_http_requests(_total)?\{route="query"\} 4', text), text[:2000]
    assert "pilosa_kernel_launches" in t["/metrics"]
    assert t["/debug/events"]["events"] == [] or set(t["/debug/events"]["events"][0]) == set(
        j["/debug/events"]["events"][0]
    )
    return j, t


def _answers(port, queries):
    return [call(port, "POST", "/index/i/query", q, "text/plain") for q in queries]


def test_restart_and_a_jax_directory_answer_the_same(tmp_path):
    rng = np.random.default_rng(3)
    cols = rng.integers(0, N_SHARDS * SHARD_WIDTH, 400).tolist()
    rows = rng.integers(0, 4, 400).tolist()
    writes = [
        ("/index/i", {}), ("/index/i/field/f", {}),
        ("/index/i/field/v", {"options": {"type": "int", "min": 0, "max": 100}}),
    ]
    queries = ["Count(Row(f=1))", "TopN(f)", "Row(f=2)", "Sum(field=v)",
               "GroupBy(Rows(f))", "Count(Row(v > 40))"]
    answers = {}
    for name, make in (("jax", _jax_node), ("torch", _torch_node)):
        srv = make(tmp_path / name)
        try:
            for path, body in writes:
                assert call(srv.port, "POST", path, body)[0] == 200
            call(srv.port, "POST", "/index/i/field/f/import", {"rowIDs": rows, "columnIDs": cols})
            call(srv.port, "POST", "/index/i/field/v/import",
                 {"columnIDs": cols[:100], "values": [c % 101 for c in cols[:100]]})
            call(srv.port, "POST", "/index/i/query", "Set(5, f=3) Clear(%d, f=1)" % cols[0],
                 "text/plain")
            answers[name] = _answers(srv.port, queries)
        finally:
            srv.close()
    assert answers["jax"] == answers["torch"]
    # each directory opened again by the port: the same answers
    for name in ("torch", "jax"):
        srv = _torch_node(tmp_path / name)
        try:
            assert _answers(srv.port, queries) == answers["jax"], name
        finally:
            srv.close()


def test_client_threads_get_the_serial_answers(tmp_path):
    srv = _torch_node(tmp_path / "torch")
    try:
        rng = np.random.default_rng(11)
        call(srv.port, "POST", "/index/i", {})
        call(srv.port, "POST", "/index/i/field/f", {})
        call(srv.port, "POST", "/index/i/field/v", {"options": {"type": "int", "min": 0, "max": 999}})
        cols = rng.integers(0, N_SHARDS * SHARD_WIDTH, 2000).tolist()
        call(srv.port, "POST", "/index/i/field/f/import",
             {"rowIDs": rng.integers(0, 8, 2000).tolist(), "columnIDs": cols})
        call(srv.port, "POST", "/index/i/field/v/import",
             {"columnIDs": cols[:500], "values": rng.integers(0, 999, 500).tolist()})
        mix = (
            [f"Count(Intersect(Row(f={a}), Row(f={b})))" for a in range(4) for b in range(4, 8)]
            + ["TopN(f)", "TopN(f, Row(f=1))", "GroupBy(Rows(f))", "Sum(field=v)",
               "Count(Row(v > 300))", "Min(field=v)", "Count(Union(Row(f=1), Row(f=2), Row(f=3)))",
               "Count(Not(Row(f=0)))"]
        )
        serial = {q: _answers(srv.port, [q])[0] for q in mix}
        plans = [[mix[k] for k in rng.integers(0, len(mix), 50)] for _ in range(8)]
        got: list = [None] * 8

        def client(t):
            got[t] = _answers(srv.port, plans[t])

        threads = [threading.Thread(target=client, args=(t,)) for t in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
        for t in range(8):
            assert got[t] == [serial[q] for q in plans[t]], t
    finally:
        srv.close()


def test_launch_counts_survive_threads(monkeypatch):
    """``LAUNCHES`` counts under a lock: many threads through the launch
    funnel lose no count (the funnel's events stubbed for the CPU)."""

    class _Event:
        def __init__(self, **kw):
            pass

        def record(self, stream=None):
            pass

        def query(self):
            return True

        def synchronize(self):
            pass

        def elapsed_time(self, other):
            return 0.0

    monkeypatch.setattr(tk.torch.cuda, "Event", _Event)
    monkeypatch.setattr(tk.torch.cuda, "current_stream", lambda device=None: None)
    before = tk.LAUNCHES["row_scan"]
    n_threads, per = 8, 2000
    barrier = threading.Barrier(n_threads)

    def launch():
        barrier.wait(timeout=30)
        for _ in range(per):
            with tk._launching("row_scan", None):
                pass

    threads = [threading.Thread(target=launch) for _ in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert tk.LAUNCHES["row_scan"] - before == n_threads * per
    tk.LAUNCHES["row_scan"] = before


def test_node_server_serves_from_a_data_dir(tmp_path):
    node = NodeServer(data_dir=str(tmp_path / "d"), device="cpu", port=0)
    node.start()
    try:
        port = node.server.port
        assert call(port, "POST", "/index/i", {})[0] == 200
        call(port, "POST", "/index/i/field/f", {})
        call(port, "POST", "/index/i/field/f/import", {"rowIDs": [1, 1], "columnIDs": [2, 3]})
        assert call(port, "POST", "/index/i/query", "Count(Row(f=1))", "text/plain") == (
            200, {"results": [2]})
        events = call(port, "GET", "/debug/events")[1]["events"]
        assert [e["type"] for e in events][:1] == ["node-start"]
    finally:
        node.shutdown_graceful()
    assert node.wait(timeout=10)


def _planes_node(pkg, path, planes):
    """A ``NodeServer`` of ``pkg`` on ``path``, its observability planes on
    (their samplers' periods long: the test takes the samples) or off."""
    if pkg == "jax":
        from pilosa_tpu.server.node import NodeServer as Node

        kw = {"resize_watchdog_deadline": 0}
    else:
        Node, kw = NodeServer, {"device": "cpu"}
    if planes:
        kw.update(history_cadence=3600.0, flightrec_segment_seconds=3600.0,
                  blackbox_interval=3600.0)
    else:
        kw.update(flight_recorder=False, history_enabled=False, blackbox_enabled=False)
    node = Node(data_dir=str(path), port=0, metric_poll_interval=3600.0, **kw)
    node.start()
    return node


def _keys(obj, depth=2):
    """The key structure of a JSON body, ``depth`` levels down."""
    if isinstance(obj, dict) and depth:
        return {k: _keys(v, depth - 1) for k, v in obj.items()}
    return type(obj).__name__


OBS_ROUTES = ["/debug/history", "/debug/history?series=slo.*&limit=2",
              "/debug/history?series=dev.*,batcher.*&since=1", "/debug/history?step=2",
              "/debug/history?since=abc", "/debug/incidents", "/debug/incidents?id=nope",
              "/debug/postmortem", "/debug/postmortem?id=nope", "/internal/diagnostics"]


@pytest.mark.parametrize("planes", [True, False], ids=["planes-on", "planes-off"])
def test_observability_routes_answer_as_a_jax_node(tmp_path, planes):
    views = {}
    for pkg in ("jax", "torch"):
        node = _planes_node(pkg, tmp_path / pkg, planes)
        try:
            port = node.server.port
            call(port, "POST", "/index/i", {})
            call(port, "POST", "/index/i/field/f", {})
            call(port, "POST", "/index/i/field/f/import", {"rowIDs": [1, 1], "columnIDs": [2, 3]})
            got = {}
            if planes:
                node.history.sample_once()
            for q in ("Count(Row(f=1))", "TopN(f)", "Row(f="):
                call(port, "POST", "/index/i/query", q, "text/plain")
            if planes:
                # a handler records its request just after the answer
                # leaves: the sample waits for all six
                t_end = time.monotonic() + 10
                while sum(c["total"] for c in node.holder.slo.series_sample().values()) < 6:
                    assert time.monotonic() < t_end
                    time.sleep(0.005)
                node.history.sample_once()
                node.flightrec._record_segment({"seq": 1, "at": 0.0, "seconds": 1.0})
                node.flightrec.capture_incident({"type": "test", "note": "x"})
                [inc] = call(port, "GET", "/debug/incidents")[1]["incidents"]
                got["incident"] = call(port, "GET", f"/debug/incidents?id={inc['id']}")
            for path in OBS_ROUTES:
                got[path] = call(port, "GET", path)
            vars_ = call(port, "GET", "/debug/vars")[1]
            got["blackbox"] = vars_.get("blackbox")
            got["index"] = {e["path"] for e in call(port, "GET", "/debug")[1]["endpoints"]}
            views[pkg] = got
        finally:
            node.stop()
    j, t = views["jax"], views["torch"]
    for path in OBS_ROUTES:
        assert j[path][0] == t[path][0], path
        assert _keys(j[path][1]) == _keys(t[path][1]), path
    assert _keys(j["blackbox"]) == _keys(t["blackbox"])
    assert {"/debug/history", "/debug/incidents", "/debug/postmortem"} <= t["index"] <= j["index"]
    diag = t["/internal/diagnostics"]
    assert diag[0] == 200 and diag[1]["pallasFallbacks"] == 0 and diag[1]["numIndexes"] == 1
    if planes:
        assert _keys(j["incident"]) == _keys(t["incident"])
        for path in ("/debug/history", "/debug/history?series=slo.*&limit=2"):
            assert set(j[path][1]["series"]) == set(t[path][1]["series"]), path
        hist = t["/debug/history"][1]
        assert hist["seq"] == 2 and hist["returned"] == 2 and hist["truncated"] is False
        assert {s.split(".")[0] for s in hist["series"]} >= {"slo", "dev", "batcher", "ingest"}
        assert t["/debug/history?since=abc"][0] == 400
        assert t["/debug/postmortem"][1]["postmortems"] == []
    else:
        assert t["/debug/history"][0] == 404 and t["/debug/postmortem"][0] == 404
        assert t["/debug/incidents"][1] == {"enabled": False, "incidents": []}
        assert t["blackbox"] is None


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cli(args, env_extra=None):
    env = dict(os.environ, PYTHONPATH=str(REPO), **(env_extra or {}))
    return subprocess.Popen(
        [sys.executable, "-m", "pilosa_tpu_torch.cli", "server", *args],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )


def test_cli_server_runs_on_the_cpu_when_asked_and_stops_on_sigterm(tmp_path):
    port = _free_port()
    proc = _cli(["--device", "cpu", "-d", str(tmp_path / "d"), "--bind", f"127.0.0.1:{port}"],
                {"HOME": str(tmp_path)})
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                code, body = call(port, "GET", "/status")
                break
            except (urllib.error.URLError, ConnectionError):
                assert proc.poll() is None, proc.communicate(timeout=10)
                assert time.monotonic() < deadline, "the server did not come up"
                time.sleep(0.2)
        assert code == 200 and body["state"] == "NORMAL"
        call(port, "POST", "/index/i", {})
        call(port, "POST", "/index/i/field/f", {})
        call(port, "POST", "/index/i/query", "Set(3, f=1)", "text/plain")
        assert call(port, "POST", "/index/i/query", "Count(Row(f=1))", "text/plain") == (
            200, {"results": [1]})
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=30)
        assert proc.returncode == 0, err
        assert "listening on http://127.0.0.1:" in out and "device cpu" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=10)


def test_cli_server_refuses_to_start_without_cuda(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    proc = _cli(["-d", str(tmp_path / "d"), "--bind", f"127.0.0.1:{_free_port()}"])
    try:
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=10)
    assert proc.returncode != 0
    assert "CUDA" in err
