"""Index: a container of fields (counterpart of ``pilosa_tpu/core/index.py``;
reference index.go).

With ``trackExistence`` an internal ``_exists`` field records every column
ever set, which ``Not()`` reads (reference index.go:173-180, holder.go:46).
``generation`` counts the index's schema changes (a field created or
deleted), as in the JAX package. A deleted field leaves the index only:
its stacks and device copies go when nothing else holds it (the executor
keys its caches weakly on the field object, never on its name).
"""

from __future__ import annotations

import itertools
import threading

import torch

from pilosa_tpu_torch import device as device_mod
from pilosa_tpu_torch.core.attrs import AttrStore
from pilosa_tpu_torch.core.field import Field, FieldOptions, validate_name
from pilosa_tpu_torch.obs import stats as stats_mod
from pilosa_tpu_torch.shardwidth import SHARD_WORDS

EXISTENCE_FIELD_NAME = "_exists"


class Index:
    # process-unique sequence per index object: a deleted and re-created
    # index of the same name never shares result-cache keys with the old
    # one (exec/rescache.py keys on it)
    _SEQ = itertools.count()

    def __init__(
        self,
        name: str,
        keys: bool = False,
        track_existence: bool = True,
        n_words: int = SHARD_WORDS,
        device: str | torch.device | None = None,
    ):
        validate_name(name)
        self.name = name
        self.keys = keys
        self.track_existence = track_existence
        self.n_words = n_words
        self.device = device_mod.resolve(device)
        self._lock = threading.RLock()
        self.seq = next(Index._SEQ)
        # schema generation: bumped on field create and delete, so result
        # cache keys built against the old field set cannot survive it
        self.generation = 0
        self.fields: dict[str, Field] = {}
        # column attributes (reference index.go columnAttrs boltdb store)
        self.column_attrs = AttrStore()
        # called with (index, field) for each new field (storage wiring)
        self.on_create_field = None
        # metrics sink, tagged by the holder (reference index.go Stats)
        self.stats = stats_mod.NOP
        if track_existence:
            self.fields[EXISTENCE_FIELD_NAME] = Field(
                self.name, EXISTENCE_FIELD_NAME, n_words=self.n_words,
                device=self.device,
            )

    def set_stats(self, client) -> None:
        """Install a stats client, tagging each field's (reference
        holder.go:112 wiring)."""
        with self._lock:
            self.stats = client
            for name, f in self.fields.items():
                f.stats = client.with_tags(f"field:{name}")

    def existence_field(self) -> Field | None:
        return self.fields.get(EXISTENCE_FIELD_NAME)

    def field(self, name: str) -> Field | None:
        return self.fields.get(name)

    def create_field(self, name: str, options: FieldOptions | None = None) -> Field:
        """reference index.go:303-367 CreateField."""
        with self._lock:
            if name in self.fields:
                raise ValueError(f"field already exists: {name}")
            f = Field(self.name, name, options, self.n_words, device=self.device)
            f.stats = self.stats.with_tags(f"field:{name}")
            self.fields[name] = f
            self.generation += 1
            if self.on_create_field is not None:
                self.on_create_field(self, f)
            return f

    def create_field_if_not_exists(self, name: str, options: FieldOptions | None = None) -> Field:
        with self._lock:
            f = self.fields.get(name)
            if f is None:
                return self.create_field(name, options)
            return f

    def delete_field(self, name: str) -> bool:
        """reference index.go:430-453."""
        with self._lock:
            gone = self.fields.pop(name, None) is not None
            if gone:
                self.generation += 1
            return gone

    def field_names(self, include_internal: bool = False) -> list[str]:
        return sorted(
            n for n in self.fields if include_internal or not n.startswith("_")
        )

    def available_shards(self) -> set[int]:
        """Union over fields (reference index.go:244-259)."""
        shards: set[int] = set()
        for f in self.fields.values():
            shards |= f.available_shards()
        return shards

    def add_column_existence(self, col: int) -> None:
        """Mark a column as existing (reference executor.go:2098-2103)."""
        ef = self.existence_field()
        if ef is not None:
            ef.set_bit(0, col)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "options": {"keys": self.keys, "trackExistence": self.track_existence},
            "fields": [self.fields[n].to_dict() for n in self.field_names()],
        }
