"""Field: a typed container of views (counterpart of
``pilosa_tpu/core/field.py``; reference field.go).

``set``, ``mutex`` and ``bool`` fields write through their standard view
(a bool field is a two-row mutex); ``int`` fields store their values
bit-sliced in the ``bsig_<field>`` view, offset by the field's ``base``
and auto-growing ``bit_depth`` (reference field.go:1012-1160). ``time``
fields can be declared, so schemas carry over whole, but their writes are
not yet ported and raise.
"""

from __future__ import annotations

import re
import threading
from typing import Iterable

import numpy as np
import torch

from pilosa_tpu_torch import device as device_mod
from pilosa_tpu_torch.core import timequantum
from pilosa_tpu_torch.core.attrs import AttrStore
from pilosa_tpu_torch.core.view import VIEW_STANDARD, View, view_name_bsi
from pilosa_tpu_torch.shardwidth import SHARD_WORDS

FIELD_TYPE_SET = "set"
FIELD_TYPE_INT = "int"
FIELD_TYPE_TIME = "time"
FIELD_TYPE_MUTEX = "mutex"
FIELD_TYPE_BOOL = "bool"

# reference field.go:44-47 defaults.
DEFAULT_CACHE_TYPE = "ranked"
DEFAULT_CACHE_SIZE = 50000

# bool fields store false/true in rows 0/1 (reference field.go:49-53).
FALSE_ROW_ID = 0
TRUE_ROW_ID = 1

_NAME_RE = re.compile(r"^[a-z][a-z0-9_-]{0,63}$")


def validate_name(name: str) -> None:
    """reference field.go validateName / index.go (lowercase, 64 chars)."""
    if not _NAME_RE.match(name):
        raise ValueError(f"invalid name: {name!r}")


def bit_depth_of(v: int) -> int:
    """Bits required to store abs(v) (reference field.go:1606-1621)."""
    v = abs(v)
    for i in range(64):
        if v < (1 << i):
            return i
    return 63


class FieldOptions:
    """reference field.go:1374-1385 FieldOptions."""

    def __init__(
        self,
        field_type: str = FIELD_TYPE_SET,
        keys: bool = False,
        cache_type: str = DEFAULT_CACHE_TYPE,
        cache_size: int = DEFAULT_CACHE_SIZE,
        min_: int = 0,
        max_: int = 0,
        time_quantum: str = "",
        no_standard_view: bool = False,
    ):
        self.field_type = field_type
        self.keys = keys
        self.cache_type = cache_type
        self.cache_size = cache_size
        self.min = min_
        self.max = max_
        self.time_quantum = time_quantum
        self.no_standard_view = no_standard_view

    def to_dict(self) -> dict:
        return {
            "type": self.field_type,
            "keys": self.keys,
            "cacheType": self.cache_type,
            "cacheSize": self.cache_size,
            "min": self.min,
            "max": self.max,
            "timeQuantum": self.time_quantum,
            "noStandardView": self.no_standard_view,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "FieldOptions":
        return cls(
            field_type=d.get("type", FIELD_TYPE_SET),
            keys=d.get("keys", False),
            cache_type=d.get("cacheType", DEFAULT_CACHE_TYPE),
            cache_size=d.get("cacheSize", DEFAULT_CACHE_SIZE),
            min_=d.get("min", 0),
            max_=d.get("max", 0),
            time_quantum=d.get("timeQuantum", ""),
            no_standard_view=d.get("noStandardView", False),
        )


class Field:
    """reference field.go:64 Field."""

    def __init__(
        self,
        index: str,
        name: str,
        options: FieldOptions | None = None,
        n_words: int = SHARD_WORDS,
        device: str | torch.device | None = None,
    ):
        # internal fields (e.g. "_exists") bypass user-name validation
        if not name.startswith("_"):
            validate_name(name)
        self.index = index
        self.name = name
        self.options = options or FieldOptions()
        self.n_words = n_words
        self.device = device_mod.resolve(device)
        self._lock = threading.RLock()
        self.views: dict[str, View] = {}
        # row attributes (reference field.go rowAttrStore)
        self.row_attrs = AttrStore()
        # creation hooks (reference field.go:795-815): called with (field,
        # view name) for each new view; each new view takes
        # on_create_fragment (storage wiring)
        self.on_create_view = None
        self.on_create_fragment = None
        o = self.options
        if o.field_type == FIELD_TYPE_INT:
            if o.min > o.max:
                raise ValueError("invalid int field range")
            # stored = value - base, so an all-positive (or all-negative)
            # range takes the least bit depth (reference field.go bsiGroup)
            self.base = o.min if o.min > 0 else (o.max if o.max < 0 else 0)
            self.bit_depth = max(
                bit_depth_of(o.min - self.base), bit_depth_of(o.max - self.base)
            )
        else:
            self.base = 0
            self.bit_depth = 0
        if o.field_type == FIELD_TYPE_TIME and not timequantum.valid_quantum(
            o.time_quantum
        ):
            raise ValueError("invalid time quantum")

    # -- type predicates ----------------------------------------------------

    @property
    def field_type(self) -> str:
        return self.options.field_type

    @property
    def keys(self) -> bool:
        return self.options.keys

    def is_bsi(self) -> bool:
        return self.field_type == FIELD_TYPE_INT

    # -- views --------------------------------------------------------------

    def view(self, name: str) -> View | None:
        return self.views.get(name)

    def create_view_if_not_exists(self, name: str) -> View:
        with self._lock:
            v = self.views.get(name)
            if v is None:
                v = View(self.index, self.name, name, self.n_words, device=self.device)
                v.on_create_fragment = self.on_create_fragment
                self.views[name] = v
                if self.on_create_view is not None:
                    self.on_create_view(self, name)
            return v

    def bsi_view_name(self) -> str:
        return view_name_bsi(self.name)

    def available_shards(self) -> set[int]:
        shards: set[int] = set()
        for v in self.views.values():
            shards |= v.available_shards()
        return shards

    # -- set/mutex/bool writes (reference field.go:886-968) ----------------

    def set_bit(self, row: int, col: int) -> bool:
        if self.is_bsi():
            raise ValueError(f"field {self.name} is an int field; use set_value")
        if self.options.no_standard_view:
            return False
        std = self.create_view_if_not_exists(VIEW_STANDARD)
        if self.field_type in (FIELD_TYPE_MUTEX, FIELD_TYPE_BOOL):
            return std.set_mutex(row, col)
        return std.set_bit(row, col)

    def clear_bit(self, row: int, col: int) -> bool:
        v = self.view(VIEW_STANDARD)
        return v.clear_bit(row, col) if v is not None else False

    def get_bit(self, row: int, col: int) -> bool:
        v = self.view(VIEW_STANDARD)
        return v.get_bit(row, col) if v is not None else False

    # -- BSI reads/writes (reference field.go:1012-1160) --------------------

    def _check_bsi(self) -> None:
        if not self.is_bsi():
            raise ValueError(f"field {self.name} is not an int field")

    def grow_bit_depth(self, required: int) -> None:
        """Bit depth grows to fit new values (reference field.go:1050-1067)."""
        if required > self.bit_depth:
            self.bit_depth = required

    def value_range(self) -> tuple[int, int]:
        """Min/max representable at the current depth (reference
        field.go:1578-1586 bitDepthMin/Max)."""
        span = (1 << self.bit_depth) - 1
        return self.base - span, self.base + span

    def set_value(self, col: int, value: int) -> bool:
        self._check_bsi()
        o = self.options
        if value < o.min or value > o.max:
            raise ValueError(f"value {value} out of field range [{o.min}, {o.max}]")
        stored = value - self.base
        self.grow_bit_depth(bit_depth_of(stored))
        view = self.create_view_if_not_exists(self.bsi_view_name())
        return view.set_value(col, self.bit_depth, stored)

    def value(self, col: int) -> tuple[int, bool]:
        self._check_bsi()
        view = self.view(self.bsi_view_name())
        if view is None:
            return 0, False
        stored, ok = view.value(col, self.bit_depth)
        return (stored + self.base, ok) if ok else (0, False)

    def clear_value(self, col: int) -> bool:
        self._check_bsi()
        view = self.view(self.bsi_view_name())
        return view.clear_value(col) if view is not None else False

    def import_values(
        self, cols: Iterable[int], values: Iterable[int], clear: bool = False
    ) -> None:
        """Bulk import of values (reference field.go:1163-1352), one
        fragment at a time; the depth grows to fit them first."""
        self._check_bsi()
        cols = np.asarray(
            cols if isinstance(cols, np.ndarray) else list(cols), dtype=np.uint64
        )
        values = np.asarray(
            values if isinstance(values, np.ndarray) else list(values), dtype=np.int64
        )
        if len(values):
            stored = values - self.base
            self.grow_bit_depth(
                max(bit_depth_of(int(stored.min())), bit_depth_of(int(stored.max())))
            )
        view = self.create_view_if_not_exists(self.bsi_view_name())
        width = self.n_words * 32
        shards = cols // width
        offs = cols % width
        for shard in np.unique(shards):
            m = shards == shard
            view.create_fragment_if_not_exists(int(shard)).import_values(
                offs[m].astype(np.int64), values[m] - self.base, self.bit_depth,
                clear=clear,
            )

    # -- schema -------------------------------------------------------------

    def to_dict(self) -> dict:
        return {"name": self.name, "options": self.options.to_dict()}
