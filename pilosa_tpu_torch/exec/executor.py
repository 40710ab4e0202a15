"""PQL executor (counterpart of ``pilosa_tpu/exec/executor.py``; reference
executor.go).

Single-node PQL read serving over dense field stacks. A field's standard
view is gathered from the fragments' host mirrors into one
``int32[S, R, W]`` stack on the holder's device (:meth:`_field_stack`),
cached until a fragment's (epoch, version) moves. The stack serves three
kinds of query, each through one kernel of ``ops/kernels.py``:

* a batch of ``Count(op(Row, Row))`` calls — one gram launch per field
  (:meth:`_batch_pair_counts`, :meth:`_field_gram`);
* filtered TopN — the masked row scan;
* tanimoto TopN — the row scan for row totals (:meth:`_stack_row_counts`).

Everything else is the latency tier on the host mirrors: lone counts,
Row/Intersect/Union/Difference/Xor/Not/Shift trees, unfiltered TopN from
the maintained per-fragment counts, and Set/Clear/ClearRow writes. Other
calls (BSI, GroupBy, Rows, Store, attrs, keys, time views) raise
``ExecuteError("... not yet ported")``.
"""

from __future__ import annotations

import itertools
import threading
import weakref
from typing import Any

import numpy as np
import torch

from pilosa_tpu_torch import pql
from pilosa_tpu_torch.core.field import (
    FIELD_TYPE_BOOL,
    FIELD_TYPE_INT,
    FALSE_ROW_ID,
    TRUE_ROW_ID,
    Field,
)
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.core.index import Index
from pilosa_tpu_torch.core.view import VIEW_STANDARD
from pilosa_tpu_torch.exec.result import Pair, Row
from pilosa_tpu_torch.ops import bitops, kernels
from pilosa_tpu_torch.pql.ast import Call, Condition

# reference executor.go:66 defaultMinThreshold.
DEFAULT_MIN_THRESHOLD = 1

# Sentinel for "not yet computed" result slots in the batch fast path.
_UNSET = object()

_PAIR_OPS = {
    "Intersect": "intersect",
    "Union": "union",
    "Difference": "difference",
    "Xor": "xor",
}

# Calls that mutate state; the batch fast path must not answer reads that
# appear after one of these in the same query (in-order semantics).
_WRITE_CALLS = {
    "Set",
    "Clear",
    "ClearRow",
    "Store",
    "SetRowAttrs",
    "SetColumnAttrs",
}

# Calls of the JAX executor that this slice does not serve yet.
_NOT_PORTED_CALLS = {
    "Sum",
    "Min",
    "Max",
    "MinRow",
    "MaxRow",
    "Store",
    "SetRowAttrs",
    "SetColumnAttrs",
    "Rows",
    "GroupBy",
    "Options",
}


def _is_write(call: Call) -> bool:
    """A call writes if it or any descendant writes."""
    if call.name in _WRITE_CALLS:
        return True
    return any(_is_write(c) for c in call.children)


class ExecuteError(Exception):
    pass


class TooManyWritesError(ExecuteError):
    """reference pilosa.go:59 ErrTooManyWrites."""


class IndexNotFoundError(ExecuteError):
    pass


class FieldNotFoundError(ExecuteError):
    pass


def _not_ported(what: str) -> ExecuteError:
    return ExecuteError(f"{what} is not yet ported")


class Executor:
    # reference server/config.go:160 MaxWritesPerRequest default
    DEFAULT_MAX_WRITES_PER_REQUEST = 5000

    # stacks kept per field (one per shard set); two entries so
    # alternating shard arguments don't evict each other every call
    _STACK_CACHE_ENTRIES = 2
    # fields up to this many rows may get their FULL gram computed and
    # cached on the stack entry (the reference's ranked cache analogue)
    _GRAM_CACHE_MAX_ROWS = 1024
    # subset-gram computations against one stack snapshot before the full
    # gram pays for itself
    _GRAM_CACHE_MIN_REUSE = 2
    # lone Count(op(Row,Row)) queries against one field before a single
    # query takes the stack + gram path
    _PAIR_SINGLE_WARM = 4

    def __init__(self, holder: Holder, max_writes_per_request: int | None = None):
        self.holder = holder
        self.max_writes_per_request = (
            self.DEFAULT_MAX_WRITES_PER_REQUEST
            if max_writes_per_request is None
            else max_writes_per_request
        )
        # field -> {shard tuple -> stack entry}; guarded by _stack_lock
        self._stacks: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()
        # field -> lone pair-count demand (warm-up for the gram path)
        self._pair_single_demand: weakref.WeakKeyDictionary = (
            weakref.WeakKeyDictionary()
        )
        self._stack_lock = threading.RLock()
        self._lru_clock = itertools.count()
        # observable counters (tests and chip_smoke.py read them)
        self.stack_rebuilds = 0
        self.gram_cache_hits = 0

    # ------------------------------------------------------------------ API

    def execute(
        self,
        index_name: str,
        query: str | pql.Query,
        shards: list[int] | None = None,
    ) -> list[Any]:
        """reference executor.go:116 Execute: translate, then execute."""
        idx = self.holder.index(index_name)
        if idx is None:
            raise IndexNotFoundError(f"index not found: {index_name}")
        q = pql.parse(query) if isinstance(query, str) else query
        if (
            self.max_writes_per_request > 0
            and len(q.write_calls()) > self.max_writes_per_request
        ):
            raise TooManyWritesError("too many write commands")
        calls = [c.clone() for c in q.calls]
        for call in calls:
            self._translate_call(idx, call)
        results: list[Any] = [_UNSET] * len(calls)
        # Many Count(op(Row,Row)) calls collapse into one gram launch. Only
        # calls BEFORE the first write are eligible: they observe exactly
        # the state they would see executing in order.
        first_write = next(
            (i for i, c in enumerate(calls) if _is_write(c)), len(calls)
        )
        self._batch_pair_counts(idx, calls[:first_write], shards, results)
        for i, call in enumerate(calls):
            if results[i] is _UNSET:
                results[i] = self._execute_call(idx, call, shards)
        return results

    def execute_batch(
        self,
        index_name: str,
        queries: list[tuple[str | pql.Query, list[int] | None]],
    ) -> list[Any]:
        """Execute several independent read-only queries as one pass
        through the batched fast paths, so they share the gram launch.

        ``queries`` is ``[(query, shards), ...]``. Returns one slot per
        query: its result list, or the exception it raised (one malformed
        query does not fail the others). A query that carries writes runs
        through the in-order :meth:`execute`. Queries batch within groups
        of equal shard restriction."""
        idx = self.holder.index(index_name)
        if idx is None:
            err = IndexNotFoundError(f"index not found: {index_name}")
            return [err for _ in queries]
        out: list[Any] = [None] * len(queries)
        cloned: list[list[Call] | None] = [None] * len(queries)
        groups: dict[tuple[int, ...] | None, list[int]] = {}
        for qi, (query, shards) in enumerate(queries):
            try:
                q = pql.parse(query) if isinstance(query, str) else query
                if q.write_calls():
                    out[qi] = self.execute(index_name, q, shards=shards)
                    continue
                calls = [c.clone() for c in q.calls]
                for call in calls:
                    self._translate_call(idx, call)
                cloned[qi] = calls
                key = tuple(sorted(shards)) if shards else None
                groups.setdefault(key, []).append(qi)
            except Exception as e:  # per-query isolation: the slot carries it
                out[qi] = e
        for key, qis in groups.items():
            shards = list(key) if key is not None else None
            flat_calls = [c for qi in qis for c in cloned[qi]]
            flat_results: list[Any] = [_UNSET] * len(flat_calls)
            self._batch_pair_counts(idx, flat_calls, shards, flat_results)
            pos = 0
            for qi in qis:
                calls = cloned[qi]
                res = flat_results[pos : pos + len(calls)]
                pos += len(calls)
                try:
                    for ci, call in enumerate(calls):
                        if res[ci] is _UNSET:
                            res[ci] = self._execute_call(idx, call, shards)
                    out[qi] = res
                except Exception as e:  # per-query isolation
                    out[qi] = e
        return out

    # ----------------------------------------------------------- translate

    def _translate_call(self, idx: Index, call: Call) -> None:
        """Bool row values -> row ids in place, and the reference's
        argument checks (executor.go:2625-2712 translateCall). String keys
        are not yet ported."""
        if idx.keys:
            raise _not_ported("an index with string keys")
        name = call.name
        if name in ("Set", "Clear", "Row", "Range", "ClearRow"):
            col_key = "_col"
            field_name = call.field_arg()
            row_key = field_name
        else:
            col_key = "col"
            field_name = call.args.get("field")
            row_key = "row"
        if isinstance(call.args.get(col_key), str):
            raise ExecuteError(
                "string 'col' value not allowed unless index 'keys' option enabled"
            )
        for fname in (field_name, call.args.get("_field")):
            field = idx.field(fname) if isinstance(fname, str) else None
            if field is not None and field.keys:
                raise _not_ported("a field with string keys")
        field = idx.field(field_name) if field_name else None
        if field is not None:
            v = call.args.get(row_key)
            if field.field_type == FIELD_TYPE_BOOL and isinstance(v, bool):
                call.args[row_key] = TRUE_ROW_ID if v else FALSE_ROW_ID
            elif isinstance(v, str):
                raise ExecuteError(
                    "string 'row' value not allowed unless field 'keys' option enabled"
                )
        for child in call.children:
            self._translate_call(idx, child)
        filt = call.args.get("filter")
        if isinstance(filt, Call):
            self._translate_call(idx, filt)

    # ------------------------------------------------------------- dispatch

    def _shards_for(self, idx: Index, shards: list[int] | None) -> list[int]:
        if shards is not None:
            return sorted(shards)
        return sorted(idx.available_shards())

    def _execute_call(self, idx: Index, call: Call, shards: list[int] | None) -> Any:
        name = call.name
        if name in _NOT_PORTED_CALLS:
            raise _not_ported(f"{name}()")
        if name == "Count":
            return self._execute_count(idx, call, shards)
        if name == "TopN":
            return self._execute_topn(idx, call, shards)
        if name == "Set":
            return self._execute_set(idx, call)
        if name == "Clear":
            return self._execute_clear(idx, call)
        if name == "ClearRow":
            return self._execute_clear_row(idx, call, shards)
        return self._execute_bitmap_call(idx, call, shards)

    # ----------------------------------------------- batched Count fast path

    def _match_pair_count(self, idx: Index, call: Call):
        """(field_name, op, row_a, row_b) when ``call`` is a batchable
        ``Count(op(Row(f=a), Row(f=b)))`` over one set-like field; None
        otherwise."""
        if call.name != "Count" or len(call.children) != 1 or call.args:
            return None
        child = call.children[0]
        op = _PAIR_OPS.get(child.name)
        if op is None or len(child.children) != 2 or child.args:
            return None
        fname = None
        rows: list[int] = []
        for rc in child.children:
            if rc.name != "Row" or rc.children:
                return None
            f = rc.field_arg()
            if f is None or set(rc.args) != {f}:
                return None
            v = rc.args.get(f)
            if not isinstance(v, int) or isinstance(v, bool):
                return None
            if fname is None:
                fname = f
            elif fname != f:
                return None
            rows.append(v)
        field = idx.field(fname)
        if field is None or field.field_type == FIELD_TYPE_INT:
            return None
        if field.view(VIEW_STANDARD) is None:
            return None
        return fname, op, rows[0], rows[1]

    def _field_stack(self, field: Field, shards: list[int]):
        """(slot_of, bits) for the field's standard view: ``bits`` is an
        ``int32[S, R, W]`` tensor on the holder's device, DENSE over
        ``shards`` (all-zero slices where a shard has no fragment), rows in
        ascending row-id order. Cached per shard set until a fragment's
        (epoch, version) changes, then rebuilt from the host mirrors. None
        when the view has no rows over ``shards``. A stack larger than the
        device's free memory raises on allocation; it is never served from
        the host instead."""
        v = field.view(VIEW_STANDARD)
        if v is None:
            return None
        frags = {s: v.fragments[s] for s in shards if s in v.fragments}
        if not frags:
            return None
        key = tuple(shards)
        versions = tuple(
            (frags[s].epoch, frags[s].version) if s in frags else (-1, -1)
            for s in shards
        )
        with self._stack_lock:
            caches = self._stacks.setdefault(field, {})
            entry = caches.get(key)
            if entry is not None:
                entry["lru"] = next(self._lru_clock)
                if entry["versions"] == versions:
                    return entry["slot_of"], entry["dev"]
                del caches[key]
            row_ids = sorted({r for f in frags.values() for r in f.row_ids()})
            if not row_ids:
                return None
            S, R, W = len(shards), len(row_ids), field.n_words
            slot_of = {r: i for i, r in enumerate(row_ids)}
            bits = np.zeros((S, R, W), dtype=np.uint32)
            for si, s in enumerate(shards):
                f = frags.get(s)
                if f is None:
                    continue
                ids, matrix = f.rows_matrix_host()
                if ids:
                    bits[si, [slot_of[r] for r in ids]] = matrix
            dev = bitops.to_device(bits, self.holder.device)
            del bits
            self.stack_rebuilds += 1
            while len(caches) >= self._STACK_CACHE_ENTRIES:
                del caches[min(caches, key=lambda k: caches[k]["lru"])]
            caches[key] = {
                "versions": versions,
                "slot_of": slot_of,
                "dev": dev,
                "lru": next(self._lru_clock),
            }
            return slot_of, dev

    def _stack_entry_for(self, field: Field, bits: torch.Tensor):
        """The cache entry whose device snapshot IS ``bits``, or None."""
        with self._stack_lock:
            for e in self._stacks.get(field, {}).values():
                if e["dev"] is bits:
                    return e
        return None

    def _stack_cached(self, field: Field, shard_list: list[int]) -> bool:
        with self._stack_lock:
            return tuple(shard_list) in self._stacks.get(field, {})

    def _field_gram(self, field: Field, bits: torch.Tensor, uniq: list[int]):
        """(gram, pos) answering pair counts for the slot subset ``uniq``:
        a full-row gram cached on the stack entry (identity positions) or
        a fresh subset gram (enumerated positions); (None, None) when the
        gram path declines. The full gram is computed only when the subset
        nearly covers the rows anyway or the snapshot has already served
        _GRAM_CACHE_MIN_REUSE subset batches."""
        R = bits.shape[1]
        entry = self._stack_entry_for(field, bits)
        if entry is not None and R <= self._GRAM_CACHE_MAX_ROWS:
            cached = entry.get("gram")
            if cached is not None:
                self.gram_cache_hits += 1
                return cached, {s: s for s in uniq}
            if (
                2 * len(uniq) >= R
                or entry.get("gram_misses", 0) >= self._GRAM_CACHE_MIN_REUSE
            ):
                g = kernels.pair_gram(bits, list(range(R)))
                if g is not None:
                    with self._stack_lock:
                        entry["gram"] = g
                    return g, {s: s for s in uniq}
            else:
                with self._stack_lock:
                    entry["gram_misses"] = entry.get("gram_misses", 0) + 1
        g = kernels.pair_gram(bits, uniq)
        if g is None:
            return None, None
        return g, {s: k for k, s in enumerate(uniq)}

    def _pair_single_ready(self, field: Field, shard_list: list[int]) -> bool:
        """Whether a LONE pair count takes the gram path: when a serving
        stack is already live, or after _PAIR_SINGLE_WARM lone counts
        against the field."""
        if self._stack_cached(field, shard_list):
            return True
        with self._stack_lock:
            n = self._pair_single_demand.get(field, 0) + 1
            self._pair_single_demand[field] = n
        return n >= self._PAIR_SINGLE_WARM

    def _stack_row_counts(self, field: Field, bits: torch.Tensor) -> np.ndarray:
        """Per-slot row counts ``int64 [R]`` for a stack snapshot, cached on
        its entry. A cached full gram's diagonal is reused instead of
        launching the row scan."""
        entry = self._stack_entry_for(field, bits)
        if entry is not None:
            cached = entry.get("rowcounts")
            if cached is not None:
                return cached
            gram = entry.get("gram")
            if gram is not None:
                rc = np.diag(gram).astype(np.int64)
            else:
                rc = kernels.row_counts(bits).cpu().numpy().astype(np.int64)
            with self._stack_lock:
                entry["rowcounts"] = rc
            return rc
        return kernels.row_counts(bits).cpu().numpy().astype(np.int64)

    def _batch_pair_counts(
        self, idx: Index, calls: list[Call], shards: list[int] | None,
        results: list[Any],
    ) -> None:
        """Answer every batchable Count(op(Row,Row)) call in ``calls``
        (already cut at the first write) with one gram launch per field.
        A field engages when >= 2 of its Counts batch, or a lone count
        once _pair_single_ready says so."""
        by_field: dict[str, list[tuple[int, str, int, int]]] = {}
        for i, call in enumerate(calls):
            m = self._match_pair_count(idx, call)
            if m is not None:
                fname, op, ra, rb = m
                by_field.setdefault(fname, []).append((i, op, ra, rb))
        shard_list = None
        for fname, items in by_field.items():
            field = idx.field(fname)
            if shard_list is None:
                shard_list = self._shards_for(idx, shards)
            if len(items) < 2 and not self._pair_single_ready(field, shard_list):
                continue
            stack = self._field_stack(field, shard_list)
            if stack is None:
                if len(items) < 2:
                    with self._stack_lock:
                        self._pair_single_demand[field] = 0
                continue
            slot_of, bits = stack
            launch: list[tuple[int, str, int, int]] = []
            for i, op, ra, rb in items:
                sa, sb = slot_of.get(ra), slot_of.get(rb)
                if sa is None or sb is None:
                    # Intersect with an absent row is provably 0; the other
                    # ops need the present side's count: normal path.
                    if op == "intersect":
                        results[i] = 0
                    continue
                launch.append((i, op, sa, sb))
            if not launch:
                continue
            # one gram answers every op: each pair op is a formula over
            # gram entries (|a|b| = Gaa+Gbb-Gab, ...)
            uniq = sorted({s for _, _, sa, sb in launch for s in (sa, sb)})
            gram, pos = self._field_gram(field, bits, uniq)
            if gram is not None:
                pa = np.array([pos[sa] for _, _, sa, _ in launch])
                pb = np.array([pos[sb] for _, _, _, sb in launch])
                for op in {op for _, op, _, _ in launch}:
                    sel = [j for j, it in enumerate(launch) if it[1] == op]
                    counts = kernels.pair_counts_from_gram(gram, pa[sel], pb[sel], op)
                    for c, j in zip(counts, sel):
                        results[launch[j][0]] = int(c)
                continue
            # gram declined (too many distinct rows): batched scans, one
            # per op, per-shard partials summed in int64
            by_op: dict[str, list[tuple[int, int, int]]] = {}
            for i, op, sa, sb in launch:
                by_op.setdefault(op, []).append((i, sa, sb))
            for op, olaunch in by_op.items():
                partials = kernels.pair_count_batched(
                    bits,
                    [sa for _, sa, _ in olaunch],
                    [sb for _, _, sb in olaunch],
                    op=op,
                )
                counts = partials.to(torch.int64).sum(dim=1).cpu().numpy()
                for j, (i, _, _) in enumerate(olaunch):
                    results[i] = int(counts[j])

    # --------------------------------------------------------- bitmap calls

    def _execute_bitmap_call(self, idx: Index, call: Call, shards: list[int] | None) -> Row:
        """reference executor.go:653-680 + attr attach (executor.go:235-275)."""
        row = self._bitmap_call(idx, call, self._shards_for(idx, shards))
        if call.name in ("Row", "Range"):
            fname = call.field_arg()
            if fname is not None:
                v = call.args.get(fname)
                field = idx.field(fname)
                if field is not None and isinstance(v, int) and not isinstance(v, bool):
                    row.attrs = field.row_attrs.attrs(v)
        return row

    def _bitmap_call(self, idx: Index, call: Call, shards: list[int]) -> Row:
        name = call.name
        if name in ("Row", "Range"):
            return self._execute_row(idx, call, shards)
        if name == "Difference":
            return self._combine(idx, call, shards, "difference")
        if name == "Intersect":
            return self._combine(idx, call, shards, "intersect")
        if name == "Union":
            return self._combine(idx, call, shards, "union")
        if name == "Xor":
            return self._combine(idx, call, shards, "xor")
        if name == "Not":
            return self._execute_not(idx, call, shards)
        if name == "Shift":
            return self._execute_shift(idx, call, shards)
        raise ExecuteError(f"unknown call: {name}")

    def _combine(self, idx: Index, call: Call, shards: list[int], op: str) -> Row:
        if op == "intersect" and not call.children:
            raise ExecuteError("empty Intersect query is currently not supported")
        if not call.children:
            return Row(n_words=idx.n_words)
        out = self._bitmap_call(idx, call.children[0], shards)
        for c in call.children[1:]:
            if op == "intersect" and not out.segments:
                break
            out = getattr(out, op)(self._bitmap_call(idx, c, shards))
        return out

    def _execute_not(self, idx: Index, call: Call, shards: list[int]) -> Row:
        """Not() via the _exists field (reference executor.go executeNot)."""
        if not idx.track_existence:
            raise ExecuteError("Not() query requires existence tracking to be enabled")
        if len(call.children) != 1:
            raise ExecuteError("Not() takes one argument")
        exists = self._field_row(idx.existence_field(), 0, shards)
        child = self._bitmap_call(idx, call.children[0], shards)
        return exists.difference(child)

    def _execute_shift(self, idx: Index, call: Call, shards: list[int]) -> Row:
        if len(call.children) != 1:
            raise ExecuteError("Shift() takes one argument")
        n, ok = call.int_arg("n")
        child = self._bitmap_call(idx, call.children[0], shards)
        # default n=0: unchanged row (reference executor.go:1773)
        return child.shift(n if ok else 0)

    def _field_row(self, field: Field | None, row_id: int, shards: list[int]) -> Row:
        """Row segments from the host mirrors (the latency tier)."""
        out = Row(n_words=self.holder.n_words)
        if field is None:
            return out
        v = field.view(VIEW_STANDARD)
        if v is None:
            return out
        for shard in shards:
            frag = v.fragment(shard)
            if frag is not None:
                out.segments[shard] = frag.row_words_host(row_id)
        return out

    def _execute_row(self, idx: Index, call: Call, shards: list[int]) -> Row:
        """reference executor.go:1444 executeRowShard (plain rows only)."""
        fname = call.field_arg()
        if fname is None:
            raise ExecuteError(f"{call.name}() requires a field argument")
        field = idx.field(fname)
        if field is None:
            raise FieldNotFoundError(f"field not found: {fname}")
        v = call.args.get(fname)
        if isinstance(v, Condition):
            raise _not_ported("a BSI range condition")
        if "from" in call.args or "to" in call.args:
            raise _not_ported("a time-range row")
        if not isinstance(v, int) or isinstance(v, bool):
            raise ExecuteError(f"{call.name}() row argument must be an integer")
        if field.is_bsi():
            raise ExecuteError(
                f"{call.name}() cannot read a plain row from int field {fname!r}"
            )
        return self._field_row(field, v, shards)

    # ----------------------------------------------------------------- Count

    def _execute_count(self, idx: Index, call: Call, shards: list[int] | None) -> int:
        if len(call.children) != 1:
            raise ExecuteError("Count() takes one argument")
        child = call.children[0]
        shard_list = self._shards_for(idx, shards)
        # Latency tier: a lone Count over a pair or a single row, answered
        # from the host mirrors (the gram path declined it).
        m = self._match_pair_count(idx, call)
        if m is not None:
            fname, op, ra, rb = m
            view = idx.field(fname).view(VIEW_STANDARD)
            return self._host_pair_count(view, ra, rb, op, shard_list)
        n = self._match_single_row_count(idx, child)
        if n is not None:
            field, row_id = n
            view = field.view(VIEW_STANDARD)
            # popcount(a) == popcount(a & a)
            return self._host_pair_count(view, row_id, row_id, "intersect", shard_list)
        return self._bitmap_call(idx, child, shard_list).count()

    @staticmethod
    def _match_single_row_count(idx: Index, child: Call):
        """(field, row_id) when ``child`` is a plain ``Row(f=<id>)`` over
        a set-like field; None otherwise."""
        if child.name != "Row" or child.children:
            return None
        fname = child.field_arg()
        if fname is None or set(child.args) != {fname}:
            return None
        v = child.args.get(fname)
        if not isinstance(v, int) or isinstance(v, bool):
            return None
        field = idx.field(fname)
        if field is None or field.field_type == FIELD_TYPE_INT:
            return None
        return field, v

    @staticmethod
    def _host_pair_count(view, ra: int, rb: int, op: str, shard_list: list[int]) -> int:
        """Sum over shards of the fused host pair count."""
        if view is None:
            return 0
        total = 0
        for s in shard_list:
            frag = view.fragment(s)
            if frag is not None:
                total += frag.row_pair_count(ra, rb, op)
        return total

    # ---------------------------------------------------------------- writes

    def _execute_set(self, idx: Index, call: Call) -> bool:
        """reference executor.go:2069 executeSet."""
        col, ok = call.uint_arg("_col")
        if not ok:
            raise ExecuteError("Set() column argument 'col' required")
        fname = call.field_arg()
        if fname is None:
            raise ExecuteError("Set() argument required: field")
        field = idx.field(fname)
        if field is None:
            raise FieldNotFoundError(f"field not found: {fname}")
        if field.is_bsi():
            raise _not_ported("Set() on an int field")
        if call.args.get("_timestamp") is not None:
            raise _not_ported("Set() with a timestamp")
        idx.add_column_existence(col)
        row, ok = call.uint_arg(fname)
        if not ok:
            raise ExecuteError("Set() row argument 'row' required")
        return field.set_bit(row, col)

    def _execute_clear(self, idx: Index, call: Call) -> bool:
        col, ok = call.uint_arg("_col")
        if not ok:
            raise ExecuteError("Clear() column argument required")
        fname = call.field_arg()
        if fname is None:
            raise ExecuteError("Clear() argument required: field")
        field = idx.field(fname)
        if field is None:
            raise FieldNotFoundError(f"field not found: {fname}")
        if field.is_bsi():
            raise _not_ported("Clear() on an int field")
        row, ok = call.uint_arg(fname)
        if not ok:
            raise ExecuteError("row=<row> argument required to Clear() call")
        return field.clear_bit(row, col)

    def _execute_clear_row(self, idx: Index, call: Call, shards: list[int] | None) -> bool:
        """reference executor.go:1899-1997."""
        fname = call.field_arg()
        if fname is None:
            raise ExecuteError("ClearRow() argument required: field")
        field = idx.field(fname)
        if field is None:
            raise FieldNotFoundError(f"field not found: {fname}")
        if field.field_type not in ("set", "time", "mutex", "bool"):
            raise ExecuteError(
                f"ClearRow() is not supported on {field.field_type} fields"
            )
        row = call.args.get(fname)
        if not isinstance(row, int) or isinstance(row, bool):
            raise ExecuteError("ClearRow() requires a row argument")
        changed = False
        v = field.view(VIEW_STANDARD)
        if v is not None:
            for shard in self._shards_for(idx, shards):
                frag = v.fragment(shard)
                if frag is not None:
                    changed |= frag.clear_row(row)
        return changed

    # ------------------------------------------------------------------ TopN

    def _execute_topn(self, idx: Index, call: Call, shards: list[int] | None) -> list[Pair]:
        """Exact TopN (reference executor.go:860-999). A filtered TopN runs
        the masked row scan over the field's stack (plus the row scan for
        tanimoto row totals); an unfiltered one merges the maintained
        per-fragment counts on the host."""
        shards = self._shards_for(idx, shards)
        fname, ok = call.string_arg("_field")
        if not ok:
            raise ExecuteError("TopN() field required")
        field = idx.field(fname)
        if field is None:
            raise FieldNotFoundError(f"field not found: {fname}")
        if field.is_bsi():
            raise ExecuteError(f"cannot compute TopN() on integer field: {fname!r}")
        if field.options.cache_type == "none":
            raise ExecuteError(f"cannot compute TopN(), field has no cache: {fname!r}")
        if call.args.get("attrName") is not None:
            raise _not_ported("TopN() with attrName")
        n, _ = call.uint_arg("n")
        ids_arg, has_ids = call.uint_slice_arg("ids")
        threshold, has_threshold = call.uint_arg("threshold")
        if not has_threshold or threshold == 0:
            threshold = DEFAULT_MIN_THRESHOLD
        tanimoto, has_tanimoto = call.uint_arg("tanimotoThreshold")
        if has_tanimoto and tanimoto > 100:
            raise ExecuteError("Tanimoto Threshold is from 1 to 100 only")

        src: Row | None = None
        if len(call.children) == 1:
            src = self._bitmap_call(idx, call.children[0], shards)
        elif len(call.children) > 1:
            raise ExecuteError("TopN() can only have one input bitmap")

        view = field.view(VIEW_STANDARD)
        counts: dict[int, int] = {}
        src_count = src.count() if src is not None else 0
        row_totals: dict[int, int] = {}
        if view is not None and src is not None:
            # a stack of None means the view holds no rows over ``shards``
            stack = self._field_stack(field, shards)
            if stack is not None:
                slot_of, bits = stack
                S, _, W = bits.shape
                filt = self._row_to_shard_matrix(src, shards, S, W)
                mc = kernels.masked_row_counts(
                    bits, bitops.to_device(filt, bits.device)
                )
                for rid, slot in slot_of.items():
                    if mc[slot]:
                        counts[rid] = int(mc[slot])
                if has_tanimoto:
                    rc = self._stack_row_counts(field, bits)
                    for rid, slot in slot_of.items():
                        if rc[slot]:
                            row_totals[rid] = int(rc[slot])
        elif view is not None:
            # unfiltered: merge of the maintained per-fragment counts,
            # reduced by row id
            id_parts: list[np.ndarray] = []
            count_parts: list[np.ndarray] = []
            for shard in shards:
                frag = view.fragment(shard)
                if frag is None:
                    continue
                ids, row_counts = frag.row_counts()
                if ids:
                    id_parts.append(np.asarray(ids, dtype=np.int64))
                    count_parts.append(row_counts)
            if id_parts:
                uids, inv = np.unique(np.concatenate(id_parts), return_inverse=True)
                sums = np.bincount(
                    inv, weights=np.concatenate(count_parts), minlength=len(uids)
                ).astype(np.int64)
                nz = sums > 0
                counts = {int(r): int(c) for r, c in zip(uids[nz], sums[nz])}

        if has_ids and ids_arg is not None:
            counts = {r: counts.get(r, 0) for r in ids_arg}
        if has_tanimoto and src is not None:
            keep = {}
            for rid, c in counts.items():
                denom = row_totals.get(rid, 0) + src_count - c
                if denom > 0 and c * 100 >= tanimoto * denom:
                    keep[rid] = c
            counts = keep
        pairs = [
            Pair(id=rid, count=c)
            for rid, c in counts.items()
            if c >= threshold or has_ids
        ]
        pairs.sort(key=lambda p: (-p.count, p.id))
        if n and not has_ids:
            pairs = pairs[:n]
        return pairs

    @staticmethod
    def _row_to_shard_matrix(row: Row, shards: list[int], S: int, W: int) -> np.ndarray:
        """A Row's per-shard segments as a dense ``uint32[S, W]`` matrix
        aligned to a stack's shard axis; absent shards are zero."""
        filt = np.zeros((S, W), dtype=np.uint32)
        for si, s in enumerate(shards):
            seg = row.segments.get(s)
            if seg is not None:
                filt[si] = np.asarray(seg)
        return filt
