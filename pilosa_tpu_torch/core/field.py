"""Field: a typed container of views (counterpart of
``pilosa_tpu/core/field.py``; reference field.go).

``set``, ``mutex`` and ``bool`` fields write through their standard view
(a bool field is a two-row mutex); ``int`` fields store their values
bit-sliced in the ``bsig_<field>`` view, offset by the field's ``base``
and auto-growing ``bit_depth`` (reference field.go:1012-1160). A field
with a time quantum also writes a timestamped bit into one view per unit
of its quantum (``standard_2024``, ``standard_202401``, ...; reference
time.go:75-101), which time-range reads cover.

Bulk imports (:meth:`Field.import_bits`) merge each fragment once through
the native host merge, fragments in parallel. Timestamped bits are grouped by the views
their timestamp lands in: each distinct timestamp, truncated to the
quantum's finest unit, is mapped to its views once, and each (view,
shard) then takes one merge. A time view's op log therefore holds one
batch record per fragment and call where the JAX package writes one
record per bit (its per-bit loop is kept as
:meth:`Field.import_bits_plain`): the files replay to the same bits, and
after a snapshot they are byte-equal. The standard view's records are
JAX's, record for record.
"""

from __future__ import annotations

import concurrent.futures
import os
import re
import threading
import warnings
from datetime import datetime
from typing import Iterable

import numpy as np
import torch

from pilosa_tpu_torch import device as device_mod
from pilosa_tpu_torch.core import timequantum
from pilosa_tpu_torch.core.attrs import AttrStore
from pilosa_tpu_torch.core.view import VIEW_STANDARD, View, view_name_bsi
from pilosa_tpu_torch.obs import stats as stats_mod
from pilosa_tpu_torch.obs import tracing
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
        # shards other nodes hold, learned from create-shard broadcasts and
        # status exchanges (reference field.go remoteAvailableShards)
        self.remote_available_shards: set[int] = set()
        # row attributes (reference field.go rowAttrStore)
        self.row_attrs = AttrStore()
        # creation hooks (reference field.go:795-815): called with (field,
        # view name) for each new view; each new view takes
        # on_create_fragment (storage wiring)
        self.on_create_view = None
        self.on_create_fragment = None
        # metrics sink, tagged by the index (reference field.go Stats)
        self.stats = stats_mod.NOP
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

    def view_names(self) -> list[str]:
        return sorted(self.views)

    def delete_view(self, name: str) -> bool:
        with self._lock:
            return self.views.pop(name, None) is not None

    def bsi_view_name(self) -> str:
        return view_name_bsi(self.name)

    def available_shards(self) -> set[int]:
        """Union of the local views' shards and the shards known to exist
        on other nodes (reference field.go remoteAvailableShards + local)."""
        shards: set[int] = set(self.remote_available_shards)
        for v in self.views.values():
            shards |= v.available_shards()
        return shards

    def add_remote_available_shards(self, shards) -> None:
        """Merge shards learned from a create-shard broadcast or a node
        status exchange (reference field.go:331-345
        AddRemoteAvailableShards)."""
        with self._lock:
            self.remote_available_shards |= {int(s) for s in shards}

    # -- set/time/mutex/bool writes (reference field.go:886-968) -----------

    def set_bit(self, row: int, col: int, timestamp: datetime | None = None) -> bool:
        """Set (row, col) in the standard view (unless the field has none)
        and, with a timestamp, in each view of the field's time quantum."""
        o = self.options
        if self.is_bsi():
            raise ValueError(f"field {self.name} is an int field; use set_value")
        changed = False
        if not o.no_standard_view:
            std = self.create_view_if_not_exists(VIEW_STANDARD)
            if self.field_type in (FIELD_TYPE_MUTEX, FIELD_TYPE_BOOL):
                changed |= std.set_mutex(row, col)
            else:
                changed |= std.set_bit(row, col)
        if timestamp is not None:
            if not o.time_quantum:
                raise ValueError(f"cannot set timestamp on non-time field {self.name}")
            for vname in timequantum.views_by_time(VIEW_STANDARD, timestamp, o.time_quantum):
                changed |= self.create_view_if_not_exists(vname).set_bit(row, col)
        if changed:
            self.stats.count("set_bit")
        return changed

    def clear_bit(self, row: int, col: int) -> bool:
        """Clear (row, col) from the standard view and every time view
        (reference field.go:926-968)."""
        changed = False
        for v in list(self.views.values()):
            if v.name == VIEW_STANDARD or v.name.startswith(VIEW_STANDARD + "_"):
                changed |= v.clear_bit(row, col)
        if changed:
            self.stats.count("clear_bit")
        return changed

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
        changed = view.set_value(col, self.bit_depth, stored)
        if changed:
            self.stats.count("set_value")
        return changed

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
        self, cols: Iterable[int], values: Iterable[int], clear: bool = False,
        pipeline=None,
    ) -> None:
        """Bulk import of values (reference field.go:1163-1352), one
        fragment at a time; the depth grows to fit them first. With an
        ingest ``pipeline`` each shard's merge is a pipeline segment of its
        own key (no coalescing: duplicate columns across batches carry
        last-write-wins semantics that a concatenated group would reorder),
        drained shard-parallel with the device uploads overlapped."""
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
        handles = []
        for shard in np.unique(shards):
            m = shards == shard
            frag = view.create_fragment_if_not_exists(int(shard))
            if pipeline is None:
                frag.import_values(
                    offs[m].astype(np.int64), values[m] - self.base, self.bit_depth,
                    clear=clear,
                )
                continue

            def apply_group(payloads, _frag=frag):
                [(c, v)] = payloads
                return _frag.import_values(c, v, self.bit_depth, clear=clear), _frag

            handles.append(pipeline.submit_segment(
                object(), (offs[m].astype(np.int64), values[m] - self.base), apply_group,
            ))
        if handles:
            pipeline.drain(handles)

    # -- bulk imports of bits (reference field.go:1163-1352) ---------------

    def _import_args(self, rows, cols, timestamps, clear: bool, pipeline):
        if clear and timestamps is not None:
            # reference field.go:1180
            raise ValueError("import clear is not supported with timestamps")
        rows = np.asarray(rows if isinstance(rows, np.ndarray) else list(rows), dtype=np.uint64)
        cols = np.asarray(cols if isinstance(cols, np.ndarray) else list(cols), dtype=np.uint64)
        std = (
            None if self.options.no_standard_view
            else self.create_view_if_not_exists(VIEW_STANDARD)
        )
        mutexlike = self.field_type in (FIELD_TYPE_MUTEX, FIELD_TYPE_BOOL) and not clear
        return rows, cols, std, mutexlike

    def import_bits(
        self,
        rows: Iterable[int],
        cols: Iterable[int],
        timestamps: Iterable[datetime | None] | None = None,
        clear: bool = False,
        pipeline=None,
        segments=None,
    ) -> None:
        """Import (row, col[, timestamp]) triples (JAX ``Field.import_bits``,
        its arguments, errors and result): the standard view one native
        merge per shard (a mutex or bool field bit by bit), ``segments``
        (``[(shard, rows, offsets), ...]``, the batch already split by
        shard) taken as given; then each timestamped pair into the views of
        its timestamp, grouped (module docstring). ``timestamps`` holds a
        ``datetime`` or None per pair, or is a ``datetime64`` array (NaT for
        none), the fast form. With an ingest ``pipeline``
        (``ingest/pipeline.py``) each shard's merge of the standard view is a
        pipeline segment (:meth:`_submit_segment`): every segment is
        submitted before any is awaited, queued segments of one fragment
        coalesce into one merged apply, and each applied fragment goes to
        the uploader; the time views merge as without one."""
        rows, cols, std, mutexlike = self._import_args(rows, cols, timestamps, clear, pipeline)
        self.stats.count("import_bits", len(cols))
        # import span (reference fragment.go:2245-2277)
        span = tracing.start_span("field.Import")
        span.set_tag("index", self.index).set_tag("field", self.name)
        span.set_tag("bits", int(len(cols)))
        with span:
            width = self.n_words * 32
            if std is not None:
                if segments is None or mutexlike:
                    segments = _split_by_shard(rows, cols, width)
                merges = []
                handles = []
                for shard, seg_rows, seg_offs in segments:
                    frag = std.create_fragment_if_not_exists(int(shard))
                    if mutexlike:
                        for r, c in zip(seg_rows.tolist(), seg_offs.tolist()):
                            frag.set_mutex(int(r), int(c))
                    elif pipeline is not None:
                        handles.append(self._submit_segment(
                            pipeline, frag, seg_rows, np.asarray(seg_offs, dtype=np.int64),
                            clear,
                        ))
                    else:
                        merges.append((frag, seg_rows, np.asarray(seg_offs, dtype=np.int64)))
                _run_merges(merges, clear)
                if handles:
                    pipeline.drain(handles)
            if timestamps is not None:
                self._import_time_views(rows, cols, timestamps)

    def _submit_segment(self, pipeline, frag, seg_rows, seg_cols, clear):
        """One shard's merge as a pipeline segment: queued segments of one
        fragment coalesce by key into one pool job (a merge per payload
        inside it, so the summed changes equal a concatenate-then-merge),
        and the applied fragment goes to the upload stage once a group."""

        def apply_group(payloads, _frag=frag):
            changed = 0
            for r, c in payloads:
                changed += _frag.import_bits(r, c, clear=clear)
            return changed, _frag

        return pipeline.submit_segment(
            (id(frag), bool(clear)), (seg_rows, seg_cols), apply_group
        )

    def _import_time_views(self, rows: np.ndarray, cols: np.ndarray, timestamps) -> None:
        """The time views of an import: pairs sorted by (shard, truncated
        timestamp), each view's pairs at a shard one slice of that order,
        one native merge per (view, shard)."""
        q = self.options.time_quantum
        ts = _timestamp_array(timestamps)
        if len(ts) > len(rows):
            raise ValueError(f"{len(ts)} timestamps for {len(rows)} bits")
        if not q or not len(ts):
            return
        unit = next(u for u in ("H", "D", "M", "Y") if u in q)
        rows, cols = rows[: len(ts)], cols[: len(ts)]
        nat = np.isnat(ts)
        if nat.any():
            sel = np.flatnonzero(~nat)
            ts, rows, cols = ts[sel], rows[sel], cols[sel]
        if not len(ts):
            return
        tkeys, tinv = _dense_codes(ts.astype(f"datetime64[{_NP_UNIT[unit]}]").view(np.int64))
        width = self.n_words * 32
        shards, sinv = _dense_codes(cols // np.uint64(width))
        n_keys = len(tkeys)
        order, starts = _group_order(sinv * n_keys + tinv, len(shards) * n_keys)
        s_rows = rows[order]
        s_offs = (cols[order] % np.uint64(width)).astype(np.int64)
        # view -> the (ascending) indices of the truncated timestamps in it
        keys_of: dict[str, list[int]] = {}
        for k, key in enumerate(tkeys.tolist()):
            t = np.datetime64(key, _NP_UNIT[unit]).astype("datetime64[us]").item()
            for vname in timequantum.views_by_time(VIEW_STANDARD, t, q):
                keys_of.setdefault(vname, []).append(k)
        merges = []
        for vname, ks in keys_of.items():
            # a view covers a span of time, so its keys are consecutive
            a, b = ks[0], ks[-1]
            view = self.create_view_if_not_exists(vname)
            for j, shard in enumerate(shards.tolist()):
                lo, hi = starts[j * n_keys + a], starts[j * n_keys + b + 1]
                if hi > lo:
                    merges.append((view.create_fragment_if_not_exists(shard),
                                   s_rows[lo:hi], s_offs[lo:hi]))
        _run_merges(merges, False)

    def import_bits_plain(
        self,
        rows: Iterable[int],
        cols: Iterable[int],
        timestamps: Iterable[datetime | None] | None = None,
        clear: bool = False,
        pipeline=None,
        segments=None,
    ) -> None:
        """Plain version of :meth:`import_bits`: the JAX package's loop, each
        shard's pairs selected by a mask and each timestamped bit written
        through ``View.set_bit`` (one op-log record a bit). Tests hold the
        grouped import to it; no serving path calls it."""
        rows, cols, std, mutexlike = self._import_args(rows, cols, timestamps, clear, pipeline)
        width = self.n_words * 32
        if segments is None or std is None or mutexlike:
            shards = cols // width
            offs = cols % width
            segments = [(int(s), rows[shards == s], offs[shards == s]) for s in np.unique(shards)]
        if std is not None:
            for shard, seg_rows, seg_offs in segments:
                frag = std.create_fragment_if_not_exists(int(shard))
                if mutexlike:
                    for r, c in zip(seg_rows, seg_offs):
                        frag.set_mutex(int(r), int(c))
                else:
                    frag.import_bits(seg_rows, np.asarray(seg_offs, dtype=np.int64), clear=clear)
        if timestamps is not None:
            for i, ts in enumerate(list(timestamps)):
                if ts is None:
                    continue
                for vname in timequantum.views_by_time(
                    VIEW_STANDARD, ts, self.options.time_quantum
                ):
                    self.create_view_if_not_exists(vname).set_bit(int(rows[i]), int(cols[i]))

    # -- schema -------------------------------------------------------------

    def to_dict(self) -> dict:
        return {"name": self.name, "options": self.options.to_dict()}


# numpy's datetime64 unit of each time-quantum unit
_NP_UNIT = {"Y": "Y", "M": "M", "D": "D", "H": "h"}


def _timestamp_array(timestamps) -> np.ndarray:
    """``datetime64`` of an import's timestamps, NaT where none: a
    ``datetime64`` array as it is, else ``datetime`` objects (or None)
    converted by numpy in one pass (to microseconds). A timezone-aware
    ``datetime`` keeps its wall-clock fields, as ``strftime`` reads them in
    the JAX package (numpy alone would move it to UTC)."""
    if isinstance(timestamps, np.ndarray) and timestamps.dtype.kind == "M":
        return timestamps.reshape(-1)
    objs = np.asarray(
        timestamps if isinstance(timestamps, np.ndarray) else list(timestamps), dtype=object
    ).reshape(-1)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = objs.astype("datetime64[us]")
    if caught:  # timezone-aware datetimes among them
        out = np.array(
            [None if t is None else t.replace(tzinfo=None) for t in objs.tolist()],
            dtype=object,
        ).astype("datetime64[us]")
    return out


def _dense_codes(keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``(uniq, inverse)``: the distinct keys ascending and each key's index
    among them (int64), in linear passes when the keys span a small range
    (a few hours or shards), else by ``np.unique``."""
    if not keys.size:
        return keys[:0], np.zeros(0, dtype=np.int64)
    lo, hi = int(keys.min()), int(keys.max())
    if hi - lo >= 1 << 22:
        uniq, inv = np.unique(keys, return_inverse=True)
        return uniq, inv.astype(np.int64).reshape(-1)
    off = (keys - keys.dtype.type(lo)).astype(np.int64)
    present = np.bincount(off, minlength=hi - lo + 1) > 0
    code = np.cumsum(present) - 1
    return (np.flatnonzero(present) + lo).astype(keys.dtype), code[off]


def _group_order(groups: np.ndarray, n_groups: int) -> tuple[np.ndarray, np.ndarray]:
    """``(order, starts)``: a stable order of ``groups`` (codes below
    ``n_groups``; a radix sort when they fit 16 bits) and where each group
    starts in it (``starts[n_groups]`` is the total)."""
    codes = groups.astype(np.uint16 if n_groups <= 1 << 16 else np.int64)
    order = np.argsort(codes, kind="stable")
    starts = np.zeros(n_groups + 1, dtype=np.int64)
    np.cumsum(np.bincount(groups, minlength=n_groups), out=starts[1:])
    return order, starts


# pairs an import must carry before its fragments merge on a thread pool
_PARALLEL_MERGE_PAIRS = 1 << 16


def _run_merges(merges: list, clear: bool) -> None:
    """``Fragment.import_bits`` of each ``(fragment, rows, offsets)``, the
    fragments (all distinct, created beforehand) merged on a small thread
    pool when there are enough pairs: the native merge and numpy's sorts
    release the interpreter, so fragments merge in parallel."""
    workers = min(8, os.cpu_count() or 1, len(merges))
    if workers < 2 or sum(len(r) for _, r, _ in merges) < _PARALLEL_MERGE_PAIRS:
        for frag, r, c in merges:
            frag.import_bits(r, c, clear=clear)
        return
    with concurrent.futures.ThreadPoolExecutor(
        max_workers=workers, thread_name_prefix="pilosa-import"
    ) as pool:
        # list(): a merge's error raises here
        list(pool.map(lambda m: m[0].import_bits(m[1], m[2], clear=clear), merges))


def _split_by_shard(rows: np.ndarray, cols: np.ndarray, width: int):
    """``(shard, rows, offsets)`` of each shard the columns reach, in shard
    order, the pairs of a shard in their input order."""
    shards, inv = _dense_codes(cols // np.uint64(width))
    order, starts = _group_order(inv, len(shards))
    rows, cols = rows[order], cols[order]
    for j, shard in enumerate(shards.tolist()):
        lo, hi = starts[j], starts[j + 1]
        yield int(shard), rows[lo:hi], (cols[lo:hi] % np.uint64(width)).astype(np.int64)
