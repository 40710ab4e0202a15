"""Command-line interface of the port (counterpart of ``pilosa_tpu/cli.py``;
reference: cmd/ cobra tree + ctl/ subcommands).

    server            run a node (reference ctl/server)
    import            CSV or value import into a running node
    export            CSV export from a running node
    backup            one tar of a running cluster's schema, keys and
                      fragments
    restore           a backup tar into a running cluster
    check             offline integrity check of fragment files
                      (reference ctl/check.go:47-133)
    inspect           container stats of fragment files (reference
                      ctl/inspect.go)
    generate-config   the default config (reference ctl/generate_config.go)
    config            the effective config, file and environment merged

    python -m pilosa_tpu_torch.cli server -d <data dir> --bind host:port

runs one node on the card (``--device cuda``, the default) or, when asked,
on the CPU (``--device cpu``). There is no fallback: where CUDA is missing
the server exits non-zero and says so. The other subcommands are clients
of a running node or read files; none of them initialises CUDA, so they
run on a host with no card. Config precedence follows the reference
(cmd/root.go): flags > environment (``PILOSA_TPU_*``) > config file (JSON
or TOML) > defaults. The config keys are JAX's, plus ``device``:
``cluster.replicas`` (the copies of each shard), ``tls.*`` (``certificate``,
``key``, ``skip-verify``, ``ca-certificate``), ``blackbox.*`` (the crash
spool under ``<data-dir>/_blackbox/``), ``tracing.endpoint`` and
``tracing.sampler-param`` (OTLP span export), ``metric.poll-interval``
and ``metric.diagnostics-sink`` (a JSONL file of diagnostics reports).
``anti-entropy.interval`` (600 s, 0 turns it off) paces the replica
repair loop the server starts, as JAX's does. A boot after a life that
died dirty prints the postmortem's id. SIGTERM drains the node and exits
0.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import tarfile
import urllib.request

DEFAULT_CONFIG = {
    "data-dir": "~/.pilosa-tpu",
    "bind": "localhost:10101",
    "device": "cuda",
    "long-query-time": 0.0,
    # null = auto (80% of the card's memory, core/membudget.py); 0 = force
    # unlimited accounting; >0 = explicit cap in bytes
    "hbm-budget-bytes": None,
    "cluster": {"replicas": 1, "coordinator": True, "hosts": []},
    # reference api.go:66-96 importWorkerPoolSize (default 2)
    "import": {"workers": 2, "queue-depth": 16},
    "anti-entropy": {"interval": 600},
    # reference server/config.go:160 MaxWritesPerRequest (0 disables)
    "max-writes-per-request": 5000,
    "metric": {"service": "none", "poll-interval": 60, "diagnostics-sink": ""},
    "tracing": {"enabled": False},
    # crash-durable diagnostics spool under <data-dir>/_blackbox/
    # (obs/blackbox.py); postmortems served at GET /debug/postmortem
    "blackbox": {
        "enabled": True,
        "interval": 5.0,
        "max-segments": 64,
        "max-bytes": 16 << 20,
        "keep-postmortems": 4,
        "history-window": 60.0,
    },
}


def _load_config(path: str | None) -> dict:
    cfg = json.loads(json.dumps(DEFAULT_CONFIG))  # deep copy
    if path:
        with open(path, "rb") as f:
            if path.endswith(".toml"):
                import tomllib

                file_cfg = tomllib.load(f)
            else:
                file_cfg = json.load(f)
        _deep_update(cfg, file_cfg)
    env_map = {
        "PILOSA_TPU_DATA_DIR": "data-dir",
        "PILOSA_TPU_BIND": "bind",
        "PILOSA_TPU_DEVICE": "device",
        "PILOSA_TPU_LONG_QUERY_TIME": "long-query-time",
        "PILOSA_TPU_HBM_BUDGET_BYTES": "hbm-budget-bytes",
    }
    for env, key in env_map.items():
        if env in os.environ:
            cfg[key] = os.environ[env]
    return cfg


def _deep_update(dst: dict, src: dict) -> None:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_update(dst[k], v)
        else:
            dst[k] = v


def _parse_statsd_host(raw: str) -> tuple[str, int]:
    """(host, port) from a statsd ``host`` config value: "host:8125",
    "host", "[::1]:8125", "[::1]" or a bare IPv6 literal "::1"."""
    if raw.startswith("["):
        host, _, rest = raw[1:].partition("]")
        port = rest[1:] if rest.startswith(":") else "8125"
    elif raw.count(":") == 1:
        host, _, port = raw.partition(":")
    else:
        host, port = raw, "8125"
    if not port.isdigit():
        port = "8125"
    return host or "127.0.0.1", int(port)


def _stats_client(metric_cfg: dict):
    """metric.service selects the backend (reference server.go:397-411):
    none | expvar/prometheus (in memory, served at /metrics and
    /debug/vars) | statsd/datadog (UDP push)."""
    from pilosa_tpu_torch.obs.stats import NOP, MemStatsClient, StatsDClient

    service = metric_cfg.get("service", "none")
    if service == "none":
        return NOP
    if service in ("statsd", "datadog"):
        return StatsDClient(*_parse_statsd_host(metric_cfg.get("host", "127.0.0.1:8125")))
    return MemStatsClient()


def cmd_server(args) -> int:
    import torch

    from pilosa_tpu_torch.core import membudget
    from pilosa_tpu_torch.server.node import NodeServer

    cfg = _load_config(args.config)
    device = args.device or cfg["device"]
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        print(
            f"error: device {device!r} needs CUDA, and CUDA is not available "
            "here; pass --device cpu to serve from the CPU",
            file=sys.stderr,
        )
        return 2
    data_dir = os.path.expanduser(args.data_dir or cfg["data-dir"])
    bind = args.bind or cfg["bind"]
    host, _, port = bind.rpartition(":")
    host = host or "localhost"
    # device budget precedence: flag > env/config > auto-probe at first
    # use; an explicit 0 on any channel forces unlimited accounting
    hbm = args.hbm_budget
    if hbm is None:
        raw = cfg.get("hbm-budget-bytes")
        hbm = int(raw) if raw is not None else None
    if hbm is not None:
        membudget.configure(hbm or None)
    tls_cfg = cfg.get("tls", {})
    metric_cfg = cfg.get("metric", {})
    bb_cfg = cfg.get("blackbox", {})
    node = NodeServer(
        data_dir=data_dir,
        host=host,
        port=int(port),
        device=device,
        replica_n=int(cfg.get("cluster", {}).get("replicas", 1)),
        long_query_time=float(cfg["long-query-time"]),
        stats_client=_stats_client(metric_cfg),
        metric_poll_interval=float(metric_cfg.get("poll-interval", 10) or 10),
        tls_cert=args.tls_cert or tls_cfg.get("certificate") or None,
        tls_key=args.tls_key or tls_cfg.get("key") or None,
        tls_skip_verify=bool(tls_cfg.get("skip-verify", False)),
        tls_ca_cert=args.tls_ca_cert or tls_cfg.get("ca-certificate") or None,
        import_workers=int(cfg.get("import", {}).get("workers", 2)),
        import_queue_depth=int(cfg.get("import", {}).get("queue-depth", 16)),
        max_writes_per_request=int(cfg.get("max-writes-per-request", 5000)),
        blackbox_enabled=bool(bb_cfg.get("enabled", True)),
        blackbox_interval=float(bb_cfg.get("interval", 5.0)),
        blackbox_max_segments=int(bb_cfg.get("max-segments", 64)),
        blackbox_max_bytes=int(bb_cfg.get("max-bytes", 16 << 20)),
        blackbox_keep_postmortems=int(bb_cfg.get("keep-postmortems", 4)),
        blackbox_history_window=float(bb_cfg.get("history-window", 60.0)),
    )
    if node.postmortem is not None:
        pm = node.postmortem
        print(
            f"previous life died dirty: postmortem {pm['id']} "
            f"(crash loop {pm['crashLoop']}) at /debug/postmortem",
            flush=True,
        )
    # SIGTERM drains the node and exits 0: an orderly stop must never read
    # as a crash on the next boot
    node.install_signal_handlers()
    # span export and its head sampler (reference tracing config,
    # server/config.go:139-145)
    trace_cfg = cfg.get("tracing", {})
    if trace_cfg.get("endpoint"):
        from pilosa_tpu_torch.obs.export import OTLPSpanExporter
        from pilosa_tpu_torch.obs.tracing import ExportingTracer, set_tracer

        set_tracer(
            ExportingTracer(
                OTLPSpanExporter(trace_cfg["endpoint"]),
                sample_rate=float(trace_cfg.get("sampler-param", 1.0)),
            )
        )
    # periodic diagnostics reports go to a local JSONL sink (the reference
    # phones home); without one /internal/diagnostics serves them on demand
    diag_sink = metric_cfg.get("diagnostics-sink")
    if diag_sink:
        node.diagnostics.sink_path = os.path.expanduser(diag_sink)
        node.diagnostics.start(float(metric_cfg.get("poll-interval", 60) or 60))
    node.start()
    # periodic replica repair and translate-log replication (reference
    # server.go:494-546 monitorAntiEntropy; 0 turns it off)
    node.start_anti_entropy(
        float(cfg.get("anti-entropy", {}).get("interval", 600) or 0)
    )
    print(
        f"pilosa-tpu-torch server listening on {node.uri}, data dir {data_dir}, "
        f"device {node.holder.device}",
        flush=True,
    )
    try:
        node.wait()
    except KeyboardInterrupt:
        pass
    finally:
        node.stop()
        from pilosa_tpu_torch.obs.tracing import get_tracer

        close = getattr(get_tracer(), "close", None)
        if close is not None:
            close()  # the exporter posts its last batch
    return 0


def _http(host: str, method: str, path: str, body: bytes | None = None,
          content_type: str = "application/json") -> bytes:
    req = urllib.request.Request(f"http://{host}{path}", data=body, method=method)
    req.add_header("Content-Type", content_type)
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.read()


def cmd_import(args) -> int:
    """CSV import (reference ctl/import.go:82-378): lines of row,col (with
    an optional timestamp) or, with ``--int-values``, col,value."""
    rows, cols, values, timestamps = [], [], [], []
    has_ts = False
    for path in args.files:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                parts = line.split(",")
                if args.int_values:
                    cols.append(int(parts[0]))
                    values.append(int(parts[1]))
                else:
                    rows.append(parts[0] if args.row_keys else int(parts[0]))
                    cols.append(parts[1] if args.col_keys else int(parts[1]))
                    if len(parts) > 2:
                        has_ts = True
                        timestamps.append(parts[2])
                    else:
                        timestamps.append(None)
    if args.int_values:
        payload = {"columnIDs": cols, "values": values}
    else:
        payload = {
            ("rowKeys" if args.row_keys else "rowIDs"): rows,
            ("columnKeys" if args.col_keys else "columnIDs"): cols,
        }
        if has_ts:
            payload["timestamps"] = timestamps
    if args.clear:
        payload["clear"] = True
    _http(args.host, "POST", f"/index/{args.index}/field/{args.field}/import",
          json.dumps(payload).encode())
    print(f"imported {len(cols)} records into {args.index}/{args.field}")
    return 0


def cmd_export(args) -> int:
    data = _http(args.host, "GET", f"/export?index={args.index}&field={args.field}")
    if args.output == "-":
        sys.stdout.write(data.decode())
    else:
        with open(args.output, "w") as out:
            out.write(data.decode())
    return 0


def _cluster_hosts(host: str) -> tuple[list[str], str]:
    """([host:port of every node], the coordinator's host:port): a backup
    must see every node's fragments and the translation primary's log (a
    replica's copy can lag by one anti-entropy interval). A node that
    cannot list its peers stands alone."""
    try:
        nodes = json.loads(_http(host, "GET", "/internal/nodes"))
    except (OSError, ValueError):
        return [host], host
    hosts, primary = [], host
    for n in nodes:
        uri = n.get("uri", "")
        h = uri.split("://", 1)[-1] if uri else ""
        if not h:
            continue
        hosts.append(h)
        if n.get("isCoordinator"):
            primary = h
    return hosts or [host], primary


def _tar_add(tar: tarfile.TarFile, name: str, data: bytes) -> None:
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tar.addfile(info, io.BytesIO(data))


def cmd_backup(args) -> int:
    """Online backup of a running node or cluster into one tar (reference
    fragment.go:2424-2594's tar format, operator-facing like ctl backup):
    schema.json, translate.json and every fragment as a roaring blob at
    fragments/<index>/<field>/<view>/<shard>.roaring. The fragments are the
    union over every node (each lists only its own), each fetched from one
    node that holds it; the key translations come from the primary. Row
    and column attributes are not included."""
    hosts, primary = _cluster_hosts(args.host)
    schema = _http(args.host, "GET", "/schema")
    holder_of: dict[tuple, str] = {}
    for host in hosts:
        inv = json.loads(_http(host, "GET", "/internal/fragments"))["fragments"]
        for f in inv:
            if args.index and f["index"] != args.index:
                continue
            holder_of.setdefault((f["index"], f["field"], f["view"], f["shard"]), host)
    # the whole translation feed of the primary, in pages
    entries, offset = [], 0
    while True:
        page = json.loads(_http(primary, "GET", f"/internal/translate/log?offset={offset}"))
        entries.extend(page["entries"])
        if page["offset"] == offset:
            break
        offset = page["offset"]
    if args.index:
        # column keys live under the index's name, row keys under the index
        # with a field's name: both carry entry[0] == index
        entries = [e for e in entries if e[0] == args.index]
    to_stdout = args.output == "-"
    out = sys.stdout.buffer if to_stdout else open(args.output, "wb")
    try:
        with tarfile.open(fileobj=out, mode="w|") as tar:
            _tar_add(tar, "schema.json", schema)
            _tar_add(tar, "translate.json", json.dumps({"entries": entries}).encode())
            for (index, field, view, shard), host in sorted(holder_of.items()):
                blob = _http(host, "GET", f"/internal/fragment/data?index={index}"
                             f"&field={field}&view={view}&shard={shard}")
                _tar_add(tar, f"fragments/{index}/{field}/{view}/{shard}.roaring", blob)
    finally:
        if not to_stdout:
            out.close()
    print(f"backed up {len(holder_of)} fragments, {len(entries)} key mappings",
          file=sys.stderr)
    return 0


def cmd_restore(args) -> int:
    """A backup tar into a running node or cluster: the schema on every
    node, the key translations through the primary, then every fragment
    through import-roaring (the import routes each shard to its owners, so
    a cluster of another shape places the data anew)."""
    from_stdin = args.file == "-"
    src = sys.stdin.buffer if from_stdin else open(args.file, "rb")
    n_frags = 0
    try:
        with tarfile.open(fileobj=src, mode="r|*") as tar:
            for member in tar:
                f = tar.extractfile(member)
                if f is None:
                    continue
                data = f.read()
                if member.name == "schema.json":
                    # /schema applies on the node it is posted to, so every
                    # node gets it before a fragment's import reaches a replica
                    for host in _cluster_hosts(args.host)[0]:
                        _http(host, "POST", "/schema", data)
                elif member.name == "translate.json":
                    _http(args.host, "POST", "/internal/translate/restore", data)
                elif member.name.startswith("fragments/"):
                    _, index, field, view, fname = member.name.split("/")
                    shard = int(fname.removesuffix(".roaring"))
                    _http(args.host, "POST",
                          f"/index/{index}/field/{field}/import-roaring/{shard}?view={view}",
                          data, content_type="application/octet-stream")
                    n_frags += 1
    finally:
        if not from_stdin:
            src.close()
    print(f"restored {n_frags} fragments", file=sys.stderr)
    return 0


def cmd_check(args) -> int:
    """Offline integrity check of roaring fragment files (reference
    ctl/check.go:47-133): 1 if any file fails to decode."""
    from pilosa_tpu_torch.storage import roaring

    failed = 0
    for path in args.files:
        try:
            with open(path, "rb") as f:
                positions = roaring.deserialize(f.read())
        except (OSError, roaring.RoaringError) as e:
            print(f"{path}: FAILED: {e}")
            failed += 1
            continue
        print(f"{path}: OK ({len(positions)} bits)")
    return 1 if failed else 0


def cmd_inspect(args) -> int:
    """Container statistics of fragment files (reference ctl/inspect.go)."""
    import numpy as np

    from pilosa_tpu_torch.storage import roaring

    for path in args.files:
        with open(path, "rb") as f:
            positions = roaring.deserialize(f.read())
        n_containers = len(np.unique(positions >> np.uint64(16))) if len(positions) else 0
        print(f"{path}:")
        print(f"  bits: {len(positions)}")
        print(f"  containers: {n_containers}")
        if len(positions):
            print(f"  min position: {positions.min()}")
            print(f"  max position: {positions.max()}")
    return 0


def cmd_generate_config(args) -> int:
    print(json.dumps(DEFAULT_CONFIG, indent=2))
    return 0


def cmd_config(args) -> int:
    """The effective configuration after file and environment merging
    (reference `pilosa config`, ctl/config.go)."""
    print(json.dumps(_load_config(args.config), indent=2))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="pilosa-tpu-torch", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    ps = sub.add_parser("server", help="run a node")
    ps.add_argument("-d", "--data-dir", default=None)
    ps.add_argument("-b", "--bind", default=None)
    ps.add_argument("-c", "--config", default=None)
    ps.add_argument(
        "--device", default=None,
        help="device to serve from: cuda (default; exits where CUDA is "
        "missing) or cpu",
    )
    ps.add_argument(
        "--hbm-budget", type=int, default=None,
        help="device-memory budget in bytes for fragment and stack copies "
        "(default: 80%% of the card's memory)",
    )
    ps.add_argument("--tls-cert", default=None, help="TLS certificate path (enables HTTPS)")
    ps.add_argument("--tls-key", default=None, help="TLS private key path")
    ps.add_argument(
        "--tls-ca-cert", default=None,
        help="CA bundle for verifying intra-cluster certs (private CA)",
    )
    ps.set_defaults(fn=cmd_server)

    pi = sub.add_parser("import", help="bulk import CSV")
    pi.add_argument("--host", default="localhost:10101")
    pi.add_argument("-i", "--index", required=True)
    pi.add_argument("-f", "--field", required=True)
    pi.add_argument("--int-values", action="store_true", help="col,value CSV for int fields")
    pi.add_argument("--row-keys", action="store_true")
    pi.add_argument("--col-keys", action="store_true")
    pi.add_argument("--clear", action="store_true")
    pi.add_argument("files", nargs="+")
    pi.set_defaults(fn=cmd_import)

    pe = sub.add_parser("export", help="export a field as CSV")
    pe.add_argument("--host", default="localhost:10101")
    pe.add_argument("-i", "--index", required=True)
    pe.add_argument("-f", "--field", required=True)
    pe.add_argument("-o", "--output", default="-")
    pe.set_defaults(fn=cmd_export)

    pb = sub.add_parser("backup", help="backup a running cluster to a tar")
    pb.add_argument("--host", default="localhost:10101")
    pb.add_argument("-o", "--output", default="-")
    pb.add_argument("-i", "--index", default=None, help="only this index")
    pb.set_defaults(fn=cmd_backup)

    pr = sub.add_parser("restore", help="restore a backup tar into a cluster")
    pr.add_argument("--host", default="localhost:10101")
    pr.add_argument("file", help="backup tar path, or - for stdin")
    pr.set_defaults(fn=cmd_restore)

    pc = sub.add_parser("check", help="verify fragment files")
    pc.add_argument("files", nargs="+")
    pc.set_defaults(fn=cmd_check)

    pn = sub.add_parser("inspect", help="inspect fragment files")
    pn.add_argument("files", nargs="+")
    pn.set_defaults(fn=cmd_inspect)

    pg = sub.add_parser("generate-config", help="print the default config")
    pg.set_defaults(fn=cmd_generate_config)

    pcfg = sub.add_parser("config", help="print the effective config (file + env merged)")
    pcfg.add_argument("-c", "--config", default=None)
    pcfg.set_defaults(fn=cmd_config)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
