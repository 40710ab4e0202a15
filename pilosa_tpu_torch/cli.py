"""Command-line interface of the port (counterpart of ``pilosa_tpu/cli.py``;
reference: cmd/ + ctl/server).

    python -m pilosa_tpu_torch.cli server -d <data dir> --bind host:port

runs one node on the card (``--device cuda``, the default) or, when asked,
on the CPU (``--device cpu``). There is no fallback: where CUDA is missing
the server exits non-zero and says so. Config precedence follows the
reference (cmd/root.go): flags > environment (``PILOSA_TPU_*``) > config
file (JSON or TOML) > defaults. The config keys of the observability
planes are JAX's: ``blackbox.*`` (the crash spool under
``<data-dir>/_blackbox/``), ``tracing.endpoint`` and
``tracing.sampler-param`` (OTLP span export), ``metric.poll-interval``
and ``metric.diagnostics-sink`` (a JSONL file of diagnostics reports).
``anti-entropy.interval`` (600 s, 0 turns it off) paces the replica
repair loop the server starts, as JAX's does. A boot after a life that died dirty prints the postmortem's id. SIGTERM
drains the node and exits 0.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

DEFAULT_CONFIG = {
    "data-dir": "~/.pilosa-tpu",
    "bind": "localhost:10101",
    "device": "cuda",
    "long-query-time": 0.0,
    # null = auto (80% of the card's memory, core/membudget.py); 0 = force
    # unlimited accounting; >0 = explicit cap in bytes
    "hbm-budget-bytes": None,
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
        long_query_time=float(cfg["long-query-time"]),
        stats_client=_stats_client(metric_cfg),
        metric_poll_interval=float(metric_cfg.get("poll-interval", 10) or 10),
        tls_cert=args.tls_cert or tls_cfg.get("certificate") or None,
        tls_key=args.tls_key or tls_cfg.get("key") or None,
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
    ps.set_defaults(fn=cmd_server)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
