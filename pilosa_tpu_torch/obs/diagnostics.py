"""Diagnostics collector (reference: diagnostics.go:41-120 + server.go
:740-790 monitorDiagnostics). Counterpart of
``pilosa_tpu/obs/diagnostics.py``.

The reference phones home a JSON snapshot (version, cluster shape,
schema scale, host info) on an interval. This build has no egress, so
the collector exposes the same snapshot locally — served at
``/internal/diagnostics`` and optionally appended to a JSONL file sink
for offline collection — with the same field vocabulary so downstream
tooling ports over.
"""

from __future__ import annotations

import json
import threading
import time

from pilosa_tpu_torch.obs.sysinfo import SystemInfo


class Diagnostics:
    def __init__(self, holder, cluster=None, version: str = "", sink_path: str | None = None):
        self.holder = holder
        self.cluster = cluster
        self.version = version
        self.sink_path = sink_path
        self.start_time = time.time()
        self.info = SystemInfo()
        self._lock = threading.Lock()
        self._extra: dict = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.flush_errors = 0

    def set(self, key: str, value) -> None:
        """reference diagnostics.Set — arbitrary reported fields."""
        with self._lock:
            self._extra[key] = value

    def snapshot(self) -> dict:
        """One report (reference CheckVersion/logErr payload fields:
        Version, NumNodes, NumIndexes/Fields/Views, OS info...)."""
        num_fields = num_views = num_fragments = 0
        shards: set[int] = set()
        for name in self.holder.index_names():
            idx = self.holder.index(name)
            if idx is None:
                continue
            for fname in idx.field_names(include_internal=True):
                field = idx.field(fname)
                if field is None:
                    continue
                num_fields += 1
                for vname in field.view_names():
                    view = field.view(vname)
                    num_views += 1
                    num_fragments += len(view.fragments)
                    shards |= set(view.fragments)
        report = {
            "version": self.version,
            "uptime": int(time.time() - self.start_time),
            "numNodes": len(self.cluster.nodes) if self.cluster is not None else 1,
            "numIndexes": len(self.holder.index_names()),
            "numFields": num_fields,
            "numViews": num_views,
            "numFragments": num_fragments,
            "numShards": len(shards),
            "system": self.info.to_dict(),
            # JAX counts its silent Pallas-to-XLA kernel demotions here. The
            # port has no fallback: a hand kernel that fails raises. The key
            # stays, always 0, so tooling that reads the vocabulary works.
            "pallasFallbacks": 0,
        }
        with self._lock:
            report.update(self._extra)
        return report

    def flush(self) -> dict:
        """Emit one report to the sink (reference diagnostics.Flush)."""
        report = self.snapshot()
        if self.sink_path:
            try:
                with open(self.sink_path, "a") as f:
                    f.write(json.dumps(report) + "\n")
            except OSError:
                pass
        return report

    # -- interval loop (reference server.go:740-790) ------------------------

    def start(self, interval: float) -> None:
        def run():
            while not self._stop.wait(interval):
                try:
                    self.flush()
                except Exception:
                    # the reporter loop must survive a bad flush; the
                    # counter keeps the failure visible in the report
                    self.flush_errors += 1

        self._thread = threading.Thread(target=run, name="diagnostics", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        self._thread = None
