"""The port's command line (``pilosa_tpu_torch/cli.py``) against the JAX
package's (``pilosa_tpu/cli.py``), on the CPU.

``check`` and ``inspect`` print the same lines over fragment files written
by either package, with the same exit code (1 for a corrupt file);
``generate-config`` and ``config`` print JAX's configuration plus
``"device": "cuda"``; ``import`` of every CSV form into a port node and a
JAX node leaves the same ``export`` and the same answers; ``backup`` of a
three-node ``replica_n=2`` cluster of each package holding the same data
gives the same tar (member names, schema, key translations, each
fragment's positions), and each tar restores into a cluster of the other
package with the source's answers. ``cli server`` passes the cluster's
replicas and the TLS settings to the node, and exits 2 where CUDA is
missing unless it is asked for the CPU."""

# the port's lock witness, installed before the port is imported so that its
# module-level locks are wrapped too (pilosa_tpu_torch/testing/lockwitness.py)
from pilosa_tpu_torch.testing import lockwitness as port_lockwitness

port_lockwitness.install()
# the module fixture that asserts no new inversion among the port's locks
from pilosa_tpu_torch.testing.lockwitness import no_new_inversion  # noqa: F401

import io
import json
import tarfile
import urllib.request

import numpy as np
import pytest

from pilosa_tpu import cli as jcli
from pilosa_tpu.core.fragment import Fragment as JaxFragment
from pilosa_tpu.server.node import NodeServer as JaxNode
from pilosa_tpu.storage import fragmentfile as jff
from pilosa_tpu.storage import roaring as jroaring
from pilosa_tpu.testing.cluster import InProcessCluster as JaxCluster
from pilosa_tpu_torch import cli as tcli
from pilosa_tpu_torch.core.fragment import Fragment as TorchFragment
from pilosa_tpu_torch.server.node import NodeServer as TorchNode
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, SHARD_WORDS
from pilosa_tpu_torch.storage import fragmentfile as tff
from pilosa_tpu_torch.storage import roaring as troaring
from pilosa_tpu_torch.testing.cluster import InProcessCluster as PortCluster

SEED = 17
W = SHARD_WORDS


def _run(main, argv, capsys):
    rc = main(argv)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


# -- check and inspect --------------------------------------------------------


def _fragment_files(root):
    """Fragment files of four kinds written by each package: a snapshot of
    dense rows, a sparse snapshot with an op log, BSI values with a logged
    value, and an empty file."""
    paths = []
    for pkg, Frag, FF in (("jax", JaxFragment, jff.FragmentFile),
                          ("torch", TorchFragment, tff.FragmentFile)):
        for kind in ("dense", "sparse", "bsi", "empty"):
            rng = np.random.default_rng(SEED + len(kind))
            kw = {} if pkg == "jax" else {"device": "cpu"}
            frag = Frag("i", "f", "standard", 2, W, **kw)
            path = root / f"{pkg}-{kind}"
            store = FF(frag, str(path))
            store.open()
            if kind == "dense":
                for r in (0, 3, 9):
                    frag.set_row_words(
                        r, rng.integers(0, 2**32, W, dtype=np.uint64).astype(np.uint32))
                store.snapshot()
            elif kind == "sparse":
                frag.import_bits(rng.integers(0, 40, 300).astype(np.uint64),
                                 rng.integers(0, SHARD_WIDTH, 300))
                store.snapshot()
                frag.set_bit(70, 3)
                frag.clear_bit(int(frag.row_ids()[0]), 0)
            elif kind == "bsi":
                frag.import_values(rng.integers(0, SHARD_WIDTH, 200),
                                   rng.integers(-1000, 1000, 200), 11)
                store.snapshot()
                frag.set_value(9, 11, -5)
            store.close()
            paths.append(str(path))
    return paths


@pytest.mark.parametrize("cmd", ["check", "inspect"])
def test_check_and_inspect_print_jax_lines(tmp_path, capsys, cmd):
    paths = _fragment_files(tmp_path)
    got = _run(tcli.main, [cmd] + paths, capsys)
    want = _run(jcli.main, [cmd] + paths, capsys)
    assert got == want
    assert got[0] == 0
    # the files written by each package read alike, apart from the path
    lines = got[1].replace(str(tmp_path / "jax-"), "<f>").replace(str(tmp_path / "torch-"),
                                                                 "<f>").splitlines()
    half = len(lines) // 2
    assert lines[:half] == lines[half:]
    if cmd == "check":
        assert sum("OK (" in ln for ln in lines) == 8


@pytest.mark.parametrize("damage", ["truncated", "bad_magic", "short", "missing"])
def test_check_fails_a_damaged_file_as_jax_does(tmp_path, capsys, damage):
    good = _fragment_files(tmp_path)[1]  # JAX's dense snapshot
    data = open(good, "rb").read()
    bad = tmp_path / "bad"
    if damage == "truncated":
        bad.write_bytes(data[: len(data) // 2])
    elif damage == "bad_magic":
        bad.write_bytes(b"\x07\x07" + data[2:])
    elif damage == "short":
        bad.write_bytes(data[:5])
    paths = [good, str(bad)]
    rc_t, out_t, _ = _run(tcli.main, ["check"] + paths, capsys)
    rc_j, out_j, _ = _run(jcli.main, ["check"] + paths, capsys)
    assert rc_t == rc_j == 1
    assert out_t.splitlines()[0] == out_j.splitlines()[0]  # the good file's line
    assert out_t.splitlines()[1].startswith(f"{bad}: FAILED: ")


def test_deserialize_equals_jax_on_the_files(tmp_path):
    for path in _fragment_files(tmp_path):
        data = open(path, "rb").read()
        assert np.array_equal(troaring.deserialize(data), jroaring.deserialize(data))


# -- configuration ------------------------------------------------------------


def test_generate_config_is_jax_plus_the_device(capsys):
    _, got, _ = _run(tcli.main, ["generate-config"], capsys)
    _, want, _ = _run(jcli.main, ["generate-config"], capsys)
    got, want = json.loads(got), json.loads(want)
    assert got.pop("device") == "cuda"
    assert got == want
    assert got["cluster"] == {"replicas": 1, "coordinator": True, "hosts": []}


@pytest.mark.parametrize("fmt", ["json", "toml", "none"])
def test_config_merges_file_and_environment_as_jax(tmp_path, capsys, monkeypatch, fmt):
    path = None
    if fmt == "json":
        path = tmp_path / "c.json"
        path.write_text(json.dumps({"bind": "0.0.0.0:1", "cluster": {"replicas": 3},
                                    "tls": {"skip-verify": True}, "import": {"workers": 5}}))
    elif fmt == "toml":
        path = tmp_path / "c.toml"
        path.write_text('bind = "h:2"\n[cluster]\nreplicas = 2\n[blackbox]\ninterval = 1.5\n')
    monkeypatch.setenv("PILOSA_TPU_DATA_DIR", "/d/x")
    monkeypatch.setenv("PILOSA_TPU_LONG_QUERY_TIME", "2.5")
    monkeypatch.setenv("PILOSA_TPU_HBM_BUDGET_BYTES", "1024")
    argv = ["config"] + (["-c", str(path)] if path else [])
    _, got, _ = _run(tcli.main, argv, capsys)
    _, want, _ = _run(jcli.main, argv, capsys)
    got, want = json.loads(got), json.loads(want)
    assert got.pop("device") == "cuda"
    assert got == want


# -- the server's settings ----------------------------------------------------


class _Built(Exception):
    pass


def test_server_passes_the_cluster_and_tls_settings(tmp_path, monkeypatch):
    from pilosa_tpu_torch.server import node

    seen = {}

    def fake(**kw):
        seen.update(kw)
        raise _Built

    monkeypatch.setattr(node, "NodeServer", fake)
    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps({"cluster": {"replicas": 2},
                               "tls": {"skip-verify": True, "ca-certificate": "/from/file"}}))
    with pytest.raises(_Built):
        tcli.main(["server", "--device", "cpu", "-c", str(cfg), "-d", str(tmp_path / "d"),
                   "--tls-ca-cert", "/from/flag.pem", "--bind", "127.0.0.1:0"])
    assert seen["replica_n"] == 2
    assert seen["tls_skip_verify"] is True
    assert seen["tls_ca_cert"] == "/from/flag.pem"
    assert seen["device"] == "cpu"
    # without the flag, the file's CA bundle; the defaults otherwise
    seen.clear()
    with pytest.raises(_Built):
        tcli.main(["server", "--device", "cpu", "-c", str(cfg), "-d", str(tmp_path / "d")])
    assert seen["tls_ca_cert"] == "/from/file"
    seen.clear()
    with pytest.raises(_Built):
        tcli.main(["server", "--device", "cpu", "-d", str(tmp_path / "d")])
    assert (seen["replica_n"], seen["tls_skip_verify"], seen["tls_ca_cert"]) == (1, False, None)


def test_server_exits_2_without_cuda_unless_asked_for_the_cpu(tmp_path, monkeypatch, capsys):
    import torch

    from pilosa_tpu_torch.server import node

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def fake(**kw):
        raise _Built

    monkeypatch.setattr(node, "NodeServer", fake)
    assert tcli.main(["server", "-d", str(tmp_path / "d")]) == 2
    assert "CUDA" in capsys.readouterr().err
    monkeypatch.setenv("PILOSA_TPU_DEVICE", "cuda:0")
    assert tcli.main(["server", "-d", str(tmp_path / "d")]) == 2
    with pytest.raises(_Built):
        tcli.main(["server", "--device", "cpu", "-d", str(tmp_path / "d")])


# -- import and export --------------------------------------------------------


def _host(node):
    return node.uri.removeprefix("http://")


def _post(uri, index, pql):
    req = urllib.request.Request(f"{uri}/index/{index}/query", data=pql.encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())["results"]


@pytest.fixture(scope="module")
def two_nodes(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_nodes")
    jn = JaxNode(data_dir=str(root / "jax"))
    tn = TorchNode(data_dir=str(root / "torch"), device="cpu")
    jn.start()
    tn.start()
    try:
        for n in (jn, tn):
            n.api.create_index("ci", {})
            n.api.create_field("ci", "f", {})
            n.api.create_field("ci", "t", {"type": "time", "timeQuantum": "YMD"})
            n.api.create_field("ci", "v", {"type": "int", "min": -1000, "max": 1000})
            n.api.create_index("ck", {"keys": True})
            n.api.create_field("ck", "kf", {"keys": True})
        yield jn, tn
    finally:
        jn.stop()
        tn.stop()


def test_import_and_export_equal_jax(two_nodes, tmp_path, capsys):
    jn, tn = two_nodes
    rng = np.random.default_rng(SEED)
    n = 400
    rows = rng.integers(0, 9, n)
    cols = rng.integers(0, 4 * SHARD_WIDTH, n)
    plain = tmp_path / "plain.csv"
    plain.write_text("".join(f"{r},{c}\n" for r, c in zip(rows, cols)) + "\n")
    days = rng.integers(1, 28, n)
    timed = tmp_path / "timed.csv"
    timed.write_text("".join(f"{r},{c},2026-01-{d:02d}T03:00\n"
                             for r, c, d in zip(rows, cols, days)))
    keyed = tmp_path / "keyed.csv"
    keyed.write_text("".join(f"r{r},c{c % 97}\n" for r, c in zip(rows, cols)))
    vals = tmp_path / "vals.csv"
    vcols = rng.choice(4 * SHARD_WIDTH, 150, replace=False)
    vals.write_text("".join(f"{c},{v}\n" for c, v in
                            zip(vcols, rng.integers(-1000, 1001, len(vcols)))))
    runs = [
        ["-i", "ci", "-f", "f", str(plain)],
        ["-i", "ci", "-f", "t", str(timed)],
        ["-i", "ck", "-f", "kf", "--row-keys", "--col-keys", str(keyed)],
        ["-i", "ci", "-f", "v", "--int-values", str(vals)],
    ]
    for argv in runs:
        outs = [_run(main, ["import", "--host", _host(node)] + argv, capsys)
                for main, node in ((tcli.main, tn), (jcli.main, jn))]
        assert outs[0] == outs[1] and outs[0][0] == 0, argv
    # a clear through the CLI too
    clear = tmp_path / "clear.csv"
    clear.write_text("".join(f"{r},{c}\n" for r, c in zip(rows[:50], cols[:50])))
    for main, node in ((tcli.main, tn), (jcli.main, jn)):
        assert _run(main, ["import", "--host", _host(node), "-i", "ci", "-f", "f", "--clear",
                           str(clear)], capsys)[0] == 0
    for index, field in (("ci", "f"), ("ci", "t"), ("ck", "kf")):
        got = [_run(main, ["export", "--host", _host(node), "-i", index, "-f", field,
                           "-o", str(tmp_path / f"{index}{field}{k}.csv")], capsys)
               for k, (main, node) in enumerate(((tcli.main, tn), (jcli.main, jn)))]
        assert got[0][0] == got[1][0] == 0
        a = (tmp_path / f"{index}{field}0.csv").read_text()
        b = (tmp_path / f"{index}{field}1.csv").read_text()
        assert a == b and a, (index, field)
    # export to stdout
    got = _run(tcli.main, ["export", "--host", _host(tn), "-i", "ci", "-f", "f"], capsys)[1]
    assert got == _run(jcli.main, ["export", "--host", _host(jn), "-i", "ci", "-f", "f"],
                       capsys)[1]
    reads = [("ci", f"Count(Row(f={r}))") for r in range(9)]
    reads += [("ci", f"Count(Row(t={r}, from=2026-01-03T00:00, to=2026-01-15T00:00))")
              for r in range(9)]
    reads += [("ci", "Sum(field=v)"), ("ci", "Count(Row(v > 100))"), ("ci", "TopN(f, n=4)")]
    reads += [("ck", f'Row(kf="r{r}")') for r in range(9)]
    for index, pql in reads:
        got, want = _post(tn.uri, index, pql), _post(jn.uri, index, pql)
        if "keys" in str(want):
            got, want = [sorted(got[0]["keys"])], [sorted(want[0]["keys"])]
        assert got == want, pql


# -- backup and restore -------------------------------------------------------

BACKUP_READS = [("b", f"Count(Row(f={r}))") for r in range(6)] + [
    ("b", "Row(f=1)"),
    ("b", "Count(Row(t=2, from=2026-01-02T00:00, to=2026-01-20T00:00))"),
    ("b", "Sum(field=v)"),
    ("b", "Count(Row(v < 0))"),
    ("b", "TopN(f, n=3)"),
    ("kb", 'Count(Row(kf="r1"))'),
    ("kb", 'Count(Row(kf="r2"))'),
]


def _load_backup_data(cluster):
    rng = np.random.default_rng(SEED + 5)
    cluster.create_index("b")
    cluster.create_field("b", "f")
    cluster.create_field("b", "t", {"type": "time", "timeQuantum": "YMD"})
    cluster.create_field("b", "v", {"type": "int", "min": -500, "max": 500})
    cluster.create_index("kb", {"keys": True})
    cluster.create_field("kb", "kf", {"keys": True})
    cols = rng.integers(0, 6 * SHARD_WIDTH, 600)
    cluster.import_bits("b", "f", list(zip(rng.integers(0, 6, 600).tolist(), cols.tolist())))
    vcols = rng.choice(6 * SHARD_WIDTH, 120, replace=False)
    cluster.import_values("b", "v", vcols.tolist(), rng.integers(-500, 501, 120).tolist())
    cluster.query(0, "b", " ".join(f"Set({c}, t={k % 4}, 2026-01-{1 + k % 20:02d}T05:00)"
                                  for k, c in enumerate(cols[:60].tolist())))
    cluster.query(0, "kb", " ".join(f'Set("user{k}", kf="r{k % 3}")' for k in range(40)))


def _answers(node, reads):
    out = []
    for index, pql in reads:
        got = _post(node.uri, index, pql)
        if isinstance(got[0], dict) and "columns" in got[0]:
            got = [sorted(got[0]["columns"])]
        out.append(got)
    return out


def _tar_members(path):
    out = {}
    with tarfile.open(path) as tar:
        for m in tar.getmembers():
            out[m.name] = tar.extractfile(m).read()
    return out


@pytest.fixture(scope="module")
def backups(tmp_path_factory):
    root = tmp_path_factory.mktemp("backups")
    tars, answers = {}, {}
    for pkg, make, main in (("torch", lambda: PortCluster(3, replica_n=2, device="cpu"),
                             tcli.main),
                            ("jax", lambda: JaxCluster(3, replica_n=2), jcli.main)):
        with make() as c:
            _load_backup_data(c)
            answers[pkg] = _answers(c.nodes[0], BACKUP_READS)
            # through a node that is not the coordinator
            host = _host(c.nodes[1])
            tars[pkg] = str(root / f"{pkg}.tar")
            assert main(["backup", "--host", host, "-o", tars[pkg]]) == 0
    return tars, answers


def test_backup_equals_jax(backups):
    tars, answers = backups
    assert answers["torch"] == answers["jax"]
    got, want = _tar_members(tars["torch"]), _tar_members(tars["jax"])
    assert sorted(got) == sorted(want)
    assert any(n.startswith("fragments/b/t/standard_2026") for n in got)
    assert any(n.startswith("fragments/b/v/bsig_v/") for n in got)
    assert json.loads(got["schema.json"]) == json.loads(want["schema.json"])
    assert json.loads(got["translate.json"]) == json.loads(want["translate.json"])
    assert len(json.loads(got["translate.json"])["entries"]) >= 43
    for name in got:
        if name.startswith("fragments/"):
            assert np.array_equal(troaring.deserialize(got[name]),
                                  jroaring.deserialize(want[name])), name


def test_backup_of_one_index(tmp_path, capsys):
    with PortCluster(1, device="cpu") as c:
        _load_backup_data(c)
        out = tmp_path / "kb.tar"
        assert tcli.main(["backup", "--host", _host(c.nodes[0]), "-i", "kb", "-o",
                          str(out)]) == 0
        assert "fragments" in capsys.readouterr().err
    members = _tar_members(str(out))
    assert all(n.startswith("fragments/kb/") for n in members if n.startswith("fragments/"))
    entries = json.loads(members["translate.json"])["entries"]
    assert entries and all(e[0] == "kb" for e in entries)


@pytest.mark.parametrize("direction", ["jax_into_torch", "torch_into_jax"])
def test_restore_into_the_other_package(backups, direction, capsys):
    tars, answers = backups
    src, (make, main) = (
        ("jax", (lambda: PortCluster(2, device="cpu"), tcli.main))
        if direction == "jax_into_torch"
        else ("torch", (lambda: JaxCluster(2), jcli.main))
    )
    with make() as d:
        # through the node that is not the coordinator
        assert main(["restore", "--host", _host(d.nodes[1]), tars[src]]) == 0
        assert "restored" in capsys.readouterr().err
        assert _answers(d.nodes[0], BACKUP_READS) == answers[src]
        assert _answers(d.nodes[1], BACKUP_READS) == answers[src]
        # new keys do not collide with the restored ones
        d.query(1, "kb", 'Set("newkey", kf="r1")')
        got = _post(d.nodes[0].uri, "kb", 'Row(kf="r1")')[0]["keys"]
        assert "newkey" in got and len(got) == len(set(got))


def test_restore_reads_a_tar_from_stdin(backups, monkeypatch, capsys):
    tars, answers = backups
    with PortCluster(1, device="cpu") as d:
        data = open(tars["torch"], "rb").read()
        monkeypatch.setattr("sys.stdin", io.TextIOWrapper(io.BytesIO(data)))
        assert tcli.main(["restore", "--host", _host(d.nodes[0]), "-"]) == 0
        assert _answers(d.nodes[0], BACKUP_READS) == answers["torch"]
