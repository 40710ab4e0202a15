"""Holder: the root container of indexes (counterpart of
``pilosa_tpu/core/holder.py``; reference holder.go:50).

Memory-resident; the storage layer (``pilosa_tpu_torch.storage.disk``)
binds a holder to a data directory through ``on_create_index`` (reference
holder.go:134-198 Open). The holder fixes the device of everything below
it: ``cuda`` by default, the CPU only when the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import threading

import torch

from pilosa_tpu_torch import device as device_mod
from pilosa_tpu_torch.core.field import FieldOptions
from pilosa_tpu_torch.core.fragment import Fragment
from pilosa_tpu_torch.core.index import Index
from pilosa_tpu_torch.obs import stats as stats_mod
from pilosa_tpu_torch.obs.events import EventJournal
from pilosa_tpu_torch.obs.jobs import JobTracker
from pilosa_tpu_torch.obs.slo import SLOTracker
from pilosa_tpu_torch.obs.tracestore import TraceStore
from pilosa_tpu_torch.shardwidth import SHARD_WORDS


class Holder:
    def __init__(
        self,
        n_words: int = SHARD_WORDS,
        device: str | torch.device | None = None,
    ):
        self.n_words = n_words
        self.device = device_mod.resolve(device)
        self._lock = threading.RLock()
        self.indexes: dict[str, Index] = {}
        # called with each new index (the storage layer wires its files)
        self.on_create_index = None
        # metrics sink (reference holder.go Stats, default nop)
        self.stats = stats_mod.NOP
        # control-plane observability shared by the layers below, as the
        # stats client is: the event journal, the background-job tracker,
        # the SLO plane (per-op-class latency and error budgets, recorded
        # at the HTTP boundary, /debug/slo) and the tail-sampled trace
        # store (/debug/traces), whose slow-keep thresholds come from the
        # SLO objectives and whose kept traces feed the SLO exemplars
        self.events = EventJournal()
        self.jobs = JobTracker()
        self.slo = SLOTracker()
        self.traces = TraceStore(slo=self.slo)
        self.traces.on_keep = self.slo.attach_exemplar

    def set_stats(self, client: stats_mod.StatsClient) -> None:
        """Install a stats client, tagging each index's (reference
        holder.go:112)."""
        with self._lock:
            self.stats = client
            self.jobs.stats = client
            for name, idx in self.indexes.items():
                idx.set_stats(client.with_tags(f"index:{name}"))

    def index(self, name: str) -> Index | None:
        return self.indexes.get(name)

    def create_index(
        self, name: str, keys: bool = False, track_existence: bool = True
    ) -> Index:
        with self._lock:
            if name in self.indexes:
                raise ValueError(f"index already exists: {name}")
            idx = Index(
                name, keys=keys, track_existence=track_existence,
                n_words=self.n_words, device=self.device,
            )
            idx.set_stats(self.stats.with_tags(f"index:{name}"))
            self.indexes[name] = idx
            if self.on_create_index is not None:
                self.on_create_index(idx)
            return idx

    def create_index_if_not_exists(
        self, name: str, keys: bool = False, track_existence: bool = True
    ) -> Index:
        with self._lock:
            idx = self.indexes.get(name)
            if idx is None:
                return self.create_index(name, keys, track_existence)
            return idx

    def delete_index(self, name: str) -> bool:
        with self._lock:
            return self.indexes.pop(name, None) is not None

    def index_names(self) -> list[str]:
        return sorted(self.indexes)

    def field(self, index: str, field: str):
        idx = self.index(index)
        return idx.field(field) if idx is not None else None

    def fragment(self, index: str, field: str, view: str, shard: int) -> Fragment | None:
        """Direct fragment accessor (reference holder.go:496-502)."""
        f = self.field(index, field)
        if f is None:
            return None
        v = f.view(view)
        return v.fragment(shard) if v is not None else None

    def schema(self) -> list[dict]:
        """reference holder.go:279-299 Schema."""
        return [self.indexes[n].to_dict() for n in self.index_names()]

    def apply_schema(self, schema: list[dict]) -> None:
        """Create all indexes/fields described (reference holder.go:318-345
        applySchema)."""
        for idx_d in schema:
            opts = idx_d.get("options", {})
            idx = self.create_index_if_not_exists(
                idx_d["name"],
                keys=opts.get("keys", False),
                track_existence=opts.get("trackExistence", True),
            )
            for f_d in idx_d.get("fields", []):
                if f_d["name"].startswith("_"):
                    continue
                idx.create_field_if_not_exists(
                    f_d["name"], FieldOptions.from_dict(f_d.get("options", {}))
                )
