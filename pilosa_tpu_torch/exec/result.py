"""Query result types (counterpart of ``pilosa_tpu/exec/result.py``;
reference row.go Row, pilosa.go Pair/ValCount/RowIdentifiers/GroupCount),
and :func:`result_to_json`, their JSON form.

``Row`` is the cross-shard bitmap result: one host ``uint32[W]`` numpy
word vector per shard (the reference's rowSegments, row.go:332-344). The
per-call path reads rows from the fragments' host mirrors, so Row algebra
and counts stay on the host; the device serves the batched paths.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Any

import numpy as np

from pilosa_tpu_torch.ops import bitops


class Row:
    """Cross-shard bitmap result."""

    def __init__(self, segments: dict[int, np.ndarray] | None = None, n_words: int | None = None):
        # shard -> uint32[W] host words
        self.segments: dict[int, np.ndarray] = segments or {}
        self.n_words = n_words
        self.attrs: dict[str, Any] = {}
        # column keys of a keyed index's result, set by the executor
        self.keys: list[str] | None = None

    def shards(self) -> list[int]:
        return sorted(self.segments)

    # -- set algebra (reference row.go:107-239) -----------------------------

    def intersect(self, other: "Row") -> "Row":
        out = {}
        for shard in set(self.segments) & set(other.segments):
            out[shard] = self.segments[shard] & other.segments[shard]
        return Row(out, self.n_words or other.n_words)

    def union(self, other: "Row") -> "Row":
        out = dict(self.segments)
        for shard, seg in other.segments.items():
            out[shard] = (out[shard] | seg) if shard in out else seg
        return Row(out, self.n_words or other.n_words)

    def difference(self, other: "Row") -> "Row":
        out = {}
        for shard, seg in self.segments.items():
            o = other.segments.get(shard)
            out[shard] = seg if o is None else seg & ~o
        return Row(out, self.n_words or other.n_words)

    def xor(self, other: "Row") -> "Row":
        out = dict(self.segments)
        for shard, seg in other.segments.items():
            out[shard] = (out[shard] ^ seg) if shard in out else seg
        return Row(out, self.n_words or other.n_words)

    def shift(self, n: int = 1) -> "Row":
        """Per-shard shift (no cross-shard carry, the reference's per-shard
        Shift semantics, roaring.go:944)."""
        out = {
            shard: bitops.shift_row_host(seg, n)
            for shard, seg in self.segments.items()
        }
        return Row(out, self.n_words)

    # -- materialization ----------------------------------------------------

    def count(self) -> int:
        """Exact total as a Python int."""
        return sum(bitops.popcount_host(seg) for seg in self.segments.values())

    def columns(self) -> np.ndarray:
        """Absolute sorted column ids."""
        parts = []
        for shard in self.shards():
            words = np.asarray(self.segments[shard])
            width = len(words) * 32
            offs = bitops.unpack_columns(words)
            parts.append(offs + np.uint64(shard) * np.uint64(width))
        if not parts:
            return np.array([], dtype=np.uint64)
        return np.concatenate(parts)

    def to_dict(self) -> dict:
        d: dict[str, Any] = {"attrs": self.attrs}
        if self.keys is not None:
            d["keys"] = self.keys
        else:
            d["columns"] = [int(c) for c in self.columns()]
        return d


@dataclass
class ValCount:
    """Sum/Min/Max result (reference pilosa.go ValCount)."""

    value: int = 0
    count: int = 0

    def to_dict(self) -> dict:
        return {"value": self.value, "count": self.count}


@dataclass
class Pair:
    """TopN entry (reference pilosa.go Pair)."""

    id: int = 0
    key: str | None = None
    count: int = 0

    def to_dict(self) -> dict:
        d: dict[str, Any] = {"count": self.count}
        if self.key is not None:
            d["key"] = self.key
        else:
            d["id"] = self.id
        return d


@dataclass
class RowIdentifiers:
    """Rows() result (reference pilosa.go RowIdentifiers)."""

    rows: list[int] = dc_field(default_factory=list)
    keys: list[str] | None = None

    def to_dict(self) -> dict:
        if self.keys is not None:
            return {"keys": self.keys}
        return {"rows": self.rows}


@dataclass
class FieldRow:
    field: str
    row_id: int = 0
    row_key: str | None = None

    def to_dict(self) -> dict:
        d: dict[str, Any] = {"field": self.field}
        if self.row_key is not None:
            d["rowKey"] = self.row_key
        else:
            d["rowID"] = self.row_id
        return d


@dataclass
class GroupCount:
    """GroupBy entry (reference pilosa.go GroupCount)."""

    group: list[FieldRow]
    count: int

    def to_dict(self) -> dict:
        return {"group": [g.to_dict() for g in self.group], "count": self.count}


def result_to_json(result: Any) -> Any:
    """Any executor result as JSON-encodable data (the HTTP layer's
    QueryResult union, reference internal/public.proto:72-82)."""
    if isinstance(result, (Row, ValCount, RowIdentifiers, GroupCount, Pair)):
        return result.to_dict()
    if isinstance(result, list):
        return [result_to_json(r) for r in result]
    if isinstance(result, (bool, int, str)) or result is None:
        return result
    if isinstance(result, np.integer):
        return int(result)
    raise TypeError(f"unencodable result type: {type(result)!r}")
