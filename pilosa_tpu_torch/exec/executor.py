"""PQL executor (counterpart of ``pilosa_tpu/exec/executor.py``; reference
executor.go).

Single-node PQL serving over dense field stacks. A field's view (the
standard view, a time view, an int field's BSI view) is gathered from the
fragments' host mirrors into one ``int32[S, R, W]`` stack on the holder's
device (:meth:`_field_stack`), cached per view; when a few fragments'
(epoch, version) move, only their shards are patched into a new tensor
(:meth:`_stack_incremental_update`), else the stack is rebuilt. The stacks
serve these queries, each through the kernels of ``ops/kernels.py``:

* a batch of ``Count(op(Row, Row))`` calls — one gram launch per field
  (:meth:`_batch_pair_counts`, :meth:`_field_gram`);
* trees of Row/Intersect/Union/Difference/Xor/Not, under Count or as a
  bitmap — one tree-kernel launch per AST shape and stack set
  (:meth:`_batch_general`, ``exec/astbatch.py``) once their stacks are
  live or demanded by two calls. A time-range ``Row(f=r, from=, to=)``
  is a Union over its time-view cover, one stack per view (a view the
  cover names but the field lacks is a zero leaf), alone or in a tree;
* filtered TopN — the masked row scan;
* tanimoto TopN — the row scan for row totals (:meth:`_stack_row_counts`);
* GroupBy — one level through the row scans, two levels from one gram
  (one field) or one cross gram (two fields, :meth:`_cross_gram`), and k
  levels or a filter through one cross gram per level over running
  prefix masks (:meth:`_groupby_k_level_batch`); a `previous` page is
  cut from the answer;
* int fields (BSI) — an int field's ``bsig_<field>`` view is stacked with
  its rows fixed (exists, sign, then the planes: ``int32[S, 2+depth,
  W]``, :meth:`_bsi_stack`) and read by the kernels of ``ops/bsi.py``:
  range conditions (``Row``/``Range``) by the range scan, ``Sum`` by the
  sum popcounts, ``Min``/``Max`` by the extreme narrowing. Unfiltered
  aggregates and repeat range counts are cached per stack snapshot
  (:meth:`_bsi_agg_cache`). A batch shares one launch per field and op
  class (:meth:`_batch_bsi`): Q conditions or range counts one range scan,
  Q filtered Sums one ``bsi_sum_batch`` launch on the tensor cores, each
  ``Row(f=r)`` filter read in place from f's resident stack, every other
  filter made on the host (in chunks of a filter budget).

With a serving mesh (``parallel/mesh.py``: a host's CUDA devices, or the
devices ``configure_serving(devices=...)`` names) every stack is laid over
it as a ``ShardedStack`` (``parallel/sharded.py``): its shard axis padded
to a multiple of the mesh's size and cut into one contiguous slice per
device, as JAX lays its stacks with ``NamedSharding(mesh, P("shards"))``.
The kernel wrappers take such a stack as they take a tensor, launching
once a slice; a patch copies only the slices whose shards changed.

Every stack is admitted to the process device-memory budget
(``core/membudget.py``), which evicts cold stacks (the next read rebuilds
them) and declines a stack larger than its whole cap. A declined stack
(``STACK_DECLINED``) sends its reads per fragment, each as its JAX
counterpart does: pair Counts to the native host tier, a filtered TopN to
the masked row scan per fragment, a GroupBy to the recursive cross
product on the host mirrors, BSI conditions and aggregates to one launch
per fragment, trees to the host tier.

Everything else is the latency tier on the host mirrors: lone counts,
trees the batch paths decline (a cold lone tree, Shift, a time range whose
cover is empty or longer than ``astbatch.MAX_TIME_COVER`` views: the union
of its views' rows), unfiltered TopN from the maintained per-fragment
counts, Rows (with ``from``/``to``, over the cover's views), MinRow/MaxRow,
a lone cold BSI condition (the ``ops/bsi.py`` functions on CPU tensors
built from the mirrors, until _BSI_SINGLE_WARM lone conditions have
asked), and the writes: Set (with a timestamp, into the time views too),
Clear (every view), ClearRow, Store (a row written shard by shard),
SetRowAttrs and SetColumnAttrs. TopN filters by a row attribute
(``attrName``/``attrValues``) on every tier; Options excludes columns or
row attributes, attaches column attributes or restricts shards.
String keys are translated as in JAX: an index with ``keys`` takes column
keys, a field with ``keys`` row keys, each through the executor's
``translator`` (``core/translate.py``; a data directory's store passes its
own, ``storage/disk.py``) before the call runs, and results carry the keys
back (``Row.keys``, ``Pair.key``, ``RowIdentifiers.keys``,
``FieldRow.row_key``). Every call of the JAX executor on one node is
served; ``exec/result.py`` ``result_to_json`` gives each answer's JSON form.

Ahead of the batch passes every read call probes the semantic result cache
(``exec/rescache.py``): an answer whose fragments' (epoch, version) vector
is unchanged launches nothing; writes invalidate the entries reading the
written field. A flight of :meth:`execute_batch` is planned between the
probe and the passes (``exec/planner.py``): commutative children are
reordered cheapest first, subtrees repeated across the flight are
evaluated once and grafted in (a grafted tree falls to the host algebra),
and the warm-up gates of the gram and tree paths give way to measured
prices once the device ledger has them.
"""

from __future__ import annotations

import bisect
import concurrent.futures
import contextlib
import itertools
import os
import threading
import time
import weakref
from typing import Any

import numpy as np
import torch

from pilosa_tpu_torch import deadline, pql
from pilosa_tpu_torch.core import membudget, residency, timequantum
from pilosa_tpu_torch.core.field import (
    FIELD_TYPE_BOOL,
    FIELD_TYPE_INT,
    FALSE_ROW_ID,
    TRUE_ROW_ID,
    Field,
)
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.core.index import Index
from pilosa_tpu_torch.core.translate import TranslateStore
from pilosa_tpu_torch.core.view import VIEW_STANDARD
from pilosa_tpu_torch.exec import astbatch
from pilosa_tpu_torch.exec import planner as planner_mod
from pilosa_tpu_torch.exec import rescache
from pilosa_tpu_torch.obs import qprofile, tracing
from pilosa_tpu_torch.exec.result import (
    FieldRow,
    GroupCount,
    Pair,
    Row,
    RowIdentifiers,
    ValCount,
)
from pilosa_tpu_torch.ops import _hostops, bitops, bsi, kernels, streams
from pilosa_tpu_torch.parallel import mesh as mesh_mod
from pilosa_tpu_torch.parallel import sharded
from pilosa_tpu_torch.pql.ast import Call, Condition

# reference executor.go:66 defaultMinThreshold.
DEFAULT_MIN_THRESHOLD = 1

# Sentinel for "not yet computed" result slots in the batch fast path.
_UNSET = object()


class _Declined:
    """The type of :data:`STACK_DECLINED`."""

    __slots__ = ()

    def __repr__(self) -> str:
        return "STACK_DECLINED"


def _is_stack(x) -> bool:
    """A device stack: a tensor, or one laid over a serving mesh."""
    return isinstance(x, (torch.Tensor, sharded.ShardedStack))


# What Executor._field_stack returns when the device-memory budget declines
# the stack (it is larger than the budget's whole cap); None means the view
# holds no rows over the shards. A caller unpacking it by mistake fails
# loudly instead of answering as if the field were empty.
STACK_DECLINED = _Declined()


class _PrefetchNote:
    """A stack prefetch on the uploader's queue (``Executor.prefetch_issued``):
    ``queued`` until the uploader starts it, then ``started``; ``claimed``
    once a dispatch that needed the stack first built it itself."""

    __slots__ = ("state",)

    def __init__(self):
        self.state = "queued"


class _StackEntry(dict):
    """A stack cache entry: a dict that a weakref (the budget's evict
    callback, the entry's finalizer) can name."""

    __slots__ = ("__weakref__",)


def _dict_items(d: dict) -> list:
    """A snapshot of ``d``'s items that a concurrent lock-free pop cannot
    break: the copy runs in C without releasing the GIL, and a pop landing
    mid-copy (a build without the GIL) retries."""
    while True:
        try:
            return list(d.items())
        except RuntimeError:  # the dict changed size during the copy
            continue


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


class Executor:
    # reference server/config.go:160 MaxWritesPerRequest default
    DEFAULT_MAX_WRITES_PER_REQUEST = 5000

    # stacks kept per field view (one per shard set); two entries so
    # alternating shard arguments don't evict each other every call. The
    # cap is per view, not per field as in JAX: a time window's cover reads
    # up to astbatch.MAX_TIME_COVER views of one field at once (the budget
    # bounds their bytes)
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
    # live cross-gram slots kept per stack entry (one per partner field);
    # each full gram is <= 8 MiB host memory at _GRAM_CACHE_MAX_ROWS
    _CROSS_GRAM_SLOTS = 4
    # an incremental stack update pays only while few shards changed; past
    # this fraction one full rebuild wins
    _STACK_INCR_MAX_FRACTION = 0.5
    # lone BSI conditions against one field before a lone one builds the
    # field's BSI stack (the BSI twin of _PAIR_SINGLE_WARM; 0 = at once)
    _BSI_SINGLE_WARM = 4
    # scalar aggregates kept per BSI stack snapshot (Sum, Min/Max and
    # repeat range counts, a few ints each)
    _BSI_AGG_SLOTS = 128
    # host-made filter words ([S, Q, W]) one fused Sum launch takes (JAX's
    # _BSI_SUM_FILTER_BUDGET_BYTES, executor.py:1640); a longer flight's
    # go in chunks of this size
    _BSI_SUM_FILTER_BUDGET_BYTES = 256 << 20

    def __init__(
        self,
        holder: Holder,
        translator: TranslateStore | None = None,
        max_writes_per_request: int | None = None,
        rescache_entries: int = 512,
        rescache_promote_hits: int = 3,
        rescache_demote_deltas: int = 64,
        planner_enabled: bool = True,
    ):
        self.holder = holder
        self.translator = translator or TranslateStore()
        # flight-level planner (exec/planner.py): CSE across a flight,
        # cost-based reordering and measured lane choice
        self.planner = planner_mod.FlightPlanner(self, enabled=planner_enabled)
        # semantic result cache (exec/rescache.py): repeat reads with an
        # unchanged fragment version vector skip every launch; entries <= 0
        # keeps nothing
        self.rescache = rescache.ResultCache(
            entries=rescache_entries,
            promote_hits=rescache_promote_hits,
            demote_deltas=rescache_demote_deltas,
            stats_fn=lambda: holder.stats,
        )
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
        # (field id, stack key) -> the note of that stack's prefetch until
        # it ends: a dispatch that needs the stack before the uploader has
        # started the prefetch claims it and builds the stack itself
        # (server/prefetch.py)
        self._prefetching: dict[tuple, _PrefetchNote] = {}
        self._prefetching_lock = threading.Lock()
        # prefetches a dispatch claimed (each also counts useful)
        self.prefetch_claims = 0
        # observable counters (tests and chip_smoke.py read them)
        self.stack_rebuilds = 0
        # stacks patched shard by shard after writes instead of rebuilt
        self.stack_incremental = 0
        self.gram_cache_hits = 0
        # unfiltered TopN row counts served from a stack entry's cache
        self.rowcount_cache_hits = 0
        # GroupBy combination matrices served from a cached cross gram
        self.crossgram_cache_hits = 0
        # field -> lone BSI-condition demand (warm-up for the BSI stack)
        self._bsi_single_demand: weakref.WeakKeyDictionary = (
            weakref.WeakKeyDictionary()
        )
        # BSI computations on a stack (each one or more kernel launches),
        # aggregates served from the per-snapshot cache, and batched items
        # left to the per-call path by an error of their own
        self.bsi_stack_launches = 0
        self.bsi_agg_cache_hits = 0
        self.bsi_batch_item_errors = 0
        # the device-memory budget: stacks it evicted, and stack builds
        # it declined (each sent its reads per fragment)
        self.stack_evictions = 0
        self.stacks_declined = 0
        # flights whose planner-grafted operands went up as one stack
        self.shared_stack_uploads = 0
        # BSI computations on one fragment's rows, the stack declined
        self.bsi_fragment_launches = 0
        # the host tier's thread pool, built at first need on a host of
        # more than one core (_host_tier_pool)
        self._host_pool: concurrent.futures.ThreadPoolExecutor | None = None
        self._host_pool_lock = threading.Lock()

    # ------------------------------------------------------------------ API

    def execute(
        self,
        index_name: str,
        query: str | pql.Query,
        shards: list[int] | None = None,
    ) -> list[Any]:
        """reference executor.go:116 Execute: translate, execute, translate
        the results back."""
        idx = self.holder.index(index_name)
        if idx is None:
            raise IndexNotFoundError(f"index not found: {index_name}")
        q = pql.parse(query) if isinstance(query, str) else query
        if (
            self.max_writes_per_request > 0
            and len(q.write_calls()) > self.max_writes_per_request
        ):
            raise TooManyWritesError("too many write commands")
        # span per query (reference executor.go:117 "Executor.Execute")
        with tracing.start_span("executor.Execute").set_tag("index", index_name):
            calls = [c.clone() for c in q.calls]
            for call in calls:
                self._translate_call(idx, call)
            results: list[Any] = [_UNSET] * len(calls)
            # Many Count(op(Row,Row)) calls collapse into one gram launch.
            # Only calls BEFORE the first write are eligible: they observe
            # exactly the state they would see executing in order.
            first_write = next(
                (i for i, c in enumerate(calls) if _is_write(c)), len(calls)
            )
            # the result cache ahead of the launches: a repeat read whose
            # fragment version vector is unchanged skips the batch passes
            tokens: list[Any] = [None] * len(calls)
            for i, call in enumerate(calls[:first_write]):
                res, tokens[i] = self.rescache.lookup(idx, call, shards)
                if res is not rescache.MISS:
                    results[i] = res
            self._batch_pair_counts(idx, calls[:first_write], shards, results)
            self._batch_general(idx, calls[:first_write], shards, results)
            self._batch_bsi(idx, calls[:first_write], shards, results)
            for i, call in enumerate(calls):
                if results[i] is _UNSET:
                    with tracing.start_span(f"executor.execute{call.name}"):
                        results[i] = self._execute_call(idx, call, shards)
            for i, call in enumerate(calls[:first_write]):
                if tokens[i] is not None:
                    self.rescache.store(
                        tokens[i], results[i],
                        recompute=self._maintained_recompute(idx, call, shards),
                    )
            self._count_stats(idx, calls)
            return [self._translate_result(idx, c, r) for c, r in zip(q.calls, results)]

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
        with tracing.start_span("executor.ExecuteBatch").set_tag(
            "index", index_name
        ).set_tag("queries", len(queries)):
            return self._execute_batch(idx, index_name, queries)

    def _execute_batch(self, idx: Index, index_name: str, queries) -> list[Any]:
        out: list[Any] = [None] * len(queries)
        parsed: list[pql.Query | None] = [None] * len(queries)
        cloned: list[list[Call] | None] = [None] * len(queries)
        groups: dict[tuple[int, ...] | None, list[int]] = {}
        for qi, (query, shards) in enumerate(queries):
            try:
                q = pql.parse(query) if isinstance(query, str) else query
                if q.write_calls():
                    out[qi] = self.execute(index_name, q, shards=shards)
                    continue
                parsed[qi] = q
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
            # the cache probe before the batch passes: members served here
            # never ride a launch
            flat_tokens: list[Any] = [None] * len(flat_calls)
            for fi, call in enumerate(flat_calls):
                res, flat_tokens[fi] = self.rescache.lookup(idx, call, shards)
                if res is not rescache.MISS:
                    flat_results[fi] = res
            # planning after the probe (the tokens and keys are taken, so
            # grafts and reorders cannot shift an entry's identity) and
            # before the batch passes (a grafted tree must decline them)
            self.planner.plan_group(idx, flat_calls, shards, flat_results, _UNSET)
            self._batch_pair_counts(idx, flat_calls, shards, flat_results)
            self._batch_general(idx, flat_calls, shards, flat_results)
            self._batch_bsi(idx, flat_calls, shards, flat_results)
            pos = 0
            for qi in qis:
                calls = cloned[qi]
                res = flat_results[pos : pos + len(calls)]
                toks = flat_tokens[pos : pos + len(calls)]
                pos += len(calls)
                try:
                    for ci, call in enumerate(calls):
                        if res[ci] is _UNSET:
                            with tracing.start_span(f"executor.execute{call.name}"):
                                res[ci] = self._execute_call(idx, call, shards)
                    for ci, call in enumerate(calls):
                        if toks[ci] is not None:
                            self.rescache.store(
                                toks[ci], res[ci],
                                recompute=self._maintained_recompute(idx, call, shards),
                            )
                    self._count_stats(idx, calls)
                    out[qi] = [
                        self._translate_result(idx, c, r)
                        for c, r in zip(parsed[qi].calls, res)
                    ]
                except Exception as e:  # per-query isolation
                    out[qi] = e
        return out

    def rescache_probe(
        self, index_name: str, q: pql.Query, shards: list[int] | None = None,
    ) -> list[Any] | None:
        """All-or-nothing result-cache probe of a whole parsed query (the
        batcher's, at submit): the translated results when every call hits,
        else None (the query then takes the normal path)."""
        return self._rescache_all(
            index_name, q, shards, lambda idx, c, s: self.rescache.lookup(idx, c, s)[0]
        )

    def rescache_degraded(
        self, index_name: str, q: pql.Query, shards: list[int] | None = None,
    ) -> list[Any] | None:
        """:meth:`rescache_probe` over the LAST-KNOWN entries, the version
        check waived (``rescache.lookup_stale``): the QoS governor's
        degraded tier for a pressure-staged tenant's TopN/GroupBy. None when
        a call has no entry (the query then runs for real)."""
        return self._rescache_all(index_name, q, shards, self.rescache.lookup_stale)

    def _rescache_all(self, index_name: str, q: pql.Query, shards, lookup):
        idx = self.holder.index(index_name)
        if idx is None or not q.calls or q.write_calls():
            return None
        try:
            results = []
            for orig in q.calls:
                call = orig.clone()
                self._translate_call(idx, call)
                res = lookup(idx, call, shards)
                if res is rescache.MISS:
                    return None
                results.append(res)
            self._count_stats(idx, q.calls)
            return [self._translate_result(idx, c, r) for c, r in zip(q.calls, results)]
        except Exception:  # the query takes the normal path, which raises it
            return None

    def cached_execute_call(
        self, idx: Index, call: Call, shards: list[int] | None, consumers: int = 1
    ) -> Any:
        """One translated call through the result cache (the planner's
        shared subtree evaluation). A tree on a miss goes to the tree
        kernel first, weighed as ``consumers`` calls at its stacks' demand
        gate (the calls it is shared by would have built them)."""
        res, token = self.rescache.lookup(idx, call, shards)
        if res is not rescache.MISS:
            return res
        slot = [_UNSET]
        self._batch_general(idx, [call], shards, slot, weight=consumers)
        out = slot[0] if slot[0] is not _UNSET else self._execute_call(idx, call, shards)
        if token is not None:
            self.rescache.store(
                token, out, recompute=self._maintained_recompute(idx, call, shards)
            )
        return out

    def _maintained_recompute(
        self, idx: Index, call: Call, shards: list[int] | None
    ):
        """The promotion closure of a hot unfiltered TopN or GroupBy entry:
        re-derive the answer instead of invalidating it. An unfiltered TopN
        re-merges the maintained per-fragment row counts
        (``Fragment._counts``, carried through point writes and imports), a
        host reduce with no launch; a GroupBy reruns over the same state.
        Other shapes do not promote (None)."""
        if not (
            (call.name == "TopN" and not call.children)
            or (call.name == "GroupBy" and "filter" not in call.args)
        ):
            return None
        frozen = call.clone()

        def recompute():
            return self._execute_call(idx, frozen.clone(), shards)

        return recompute

    def _after_write(self, idx: Index, call: Call, result: Any) -> Any:
        self._note_write_call(idx, call)
        return result

    def _note_write_call(self, idx: Index, call: Call) -> None:
        """Eager, precise invalidation after a write call: drop the cache
        entries reading the written field. A column-attribute write has no
        field and drops the index's entries (attributes live outside the
        fragment version space)."""
        name = call.name
        if name == "SetColumnAttrs":
            self.rescache.note_write(idx.name, None)
            return
        if name == "SetRowAttrs":
            fname = call.args.get("_field")
        else:
            fname = call.field_arg()
        if isinstance(fname, str):
            self.rescache.note_write(idx.name, fname)
            if idx.track_existence and name in ("Set", "Store"):
                self.rescache.note_write(idx.name, "_exists")
        else:
            self.rescache.note_write(idx.name, None)

    def _count_stats(self, idx: Index, calls: list[Call]) -> None:
        """Per-call-type query counts of answered calls, however answered
        (reference executor.go:298-339)."""
        for call in calls:
            self.holder.stats.count_with_tags(
                "query_total", 1, 1.0, (f"index:{idx.name}", f"call:{call.name}")
            )

    # ----------------------------------------------------------- translate

    def _field_of_call(self, idx: Index, call: Call) -> Field | None:
        fname = call.args.get("_field") or call.field_arg()
        if fname is None:
            return None
        return idx.field(fname)

    def _translate_call(self, idx: Index, call: Call) -> None:
        """keys -> ids in place. Mirrors the reference's per-call-name arg
        dispatch (executor.go:2625-2712 translateCall): each call shape
        names which args hold column keys vs row keys."""
        name = call.name
        if name == "GroupBy":
            self._translate_groupby(idx, call)
            return
        if name in ("Set", "Clear", "Row", "Range", "SetColumnAttrs", "ClearRow"):
            col_key = "_col"
            field_name = call.field_arg()
            row_key = field_name
        elif name == "SetRowAttrs":
            col_key = None
            row_key = "_row"
            field_name = call.args.get("_field")
        elif name == "Rows":
            field_name = call.args.get("_field")
            row_key = "previous"
            col_key = "column"
        else:
            col_key = "col"
            field_name = call.args.get("field")
            row_key = "row"

        # Translate column key (reference executor.go:2648-2664).
        if col_key is not None:
            col = call.args.get(col_key)
            if idx.keys:
                if col is not None and not isinstance(col, str):
                    raise ExecuteError(
                        "column value must be a string when index 'keys' option enabled"
                    )
                if isinstance(col, str):
                    call.args[col_key] = self.translator.translate_key(
                        idx.name, "", col
                    )
            elif isinstance(col, str):
                raise ExecuteError(
                    "string 'col' value not allowed unless index 'keys' option enabled"
                )

        # Translate row key (reference executor.go:2666-2712).
        if field_name:
            field = idx.field(field_name)
            if field is not None and row_key is not None:
                v = call.args.get(row_key)
                if field.field_type == FIELD_TYPE_BOOL and isinstance(v, bool):
                    call.args[row_key] = TRUE_ROW_ID if v else FALSE_ROW_ID
                elif field.keys:
                    if v is not None and not isinstance(v, str):
                        raise ExecuteError(
                            "row value must be a string when field 'keys' option enabled"
                        )
                    if isinstance(v, str):
                        call.args[row_key] = self.translator.translate_key(
                            idx.name, field_name, v
                        )
                elif isinstance(v, str):
                    raise ExecuteError(
                        "string 'row' value not allowed unless field 'keys' option enabled"
                    )

        for child in call.children:
            self._translate_call(idx, child)
        filt = call.args.get("filter")
        if isinstance(filt, Call):
            self._translate_call(idx, filt)

    def _translate_groupby(self, idx: Index, call: Call) -> None:
        """The `previous` paging list holds one row key/id per child field
        (reference executor.go:2718-2748 translateGroupByCall)."""
        for child in call.children:
            self._translate_call(idx, child)
        filt = call.args.get("filter")
        if isinstance(filt, Call):
            self._translate_call(idx, filt)
        previous = call.args.get("previous")
        if previous is None:
            return
        if not isinstance(previous, list):
            raise ExecuteError("'previous' argument must be a list")
        if len(previous) != len(call.children):
            raise ExecuteError(
                "'previous' argument must have a value for each GroupBy field"
            )
        for i, (child, prev) in enumerate(zip(call.children, previous)):
            fname = child.args.get("_field")
            field = idx.field(fname) if fname else None
            if field is None:
                continue
            if field.field_type == FIELD_TYPE_BOOL and isinstance(prev, bool):
                previous[i] = TRUE_ROW_ID if prev else FALSE_ROW_ID
            elif isinstance(prev, str):
                if not field.keys:
                    raise ExecuteError(
                        f"prev value must be a uint64 for field {fname!r}"
                    )
                previous[i] = self.translator.translate_key(idx.name, fname, prev)

    def _translate_result(self, idx: Index, call: Call, result: Any) -> Any:
        """ids -> keys on results (reference executor.go:2783-2907)."""
        if isinstance(result, Row) and idx.keys:
            result.keys = self.translator.translate_ids(
                idx.name, "", [int(c) for c in result.columns()]
            )
        elif isinstance(result, list) and result and isinstance(result[0], Pair):
            field = self._field_of_call(idx, call)
            if field is not None and field.keys:
                keys = self.translator.translate_ids(
                    idx.name, field.name, [p.id for p in result]
                )
                for p, k in zip(result, keys):
                    p.key = k
        elif isinstance(result, Pair):
            field = self._field_of_call(idx, call)
            if field is not None and field.keys:
                result.key = self.translator.translate_id(
                    idx.name, field.name, result.id
                )
        elif isinstance(result, RowIdentifiers):
            field = self._field_of_call(idx, call)
            if field is not None and field.keys:
                result.keys = self.translator.translate_ids(
                    idx.name, field.name, result.rows
                )
        elif isinstance(result, list) and result and isinstance(result[0], GroupCount):
            for gc in result:
                for fr in gc.group:
                    field = idx.field(fr.field)
                    if field is not None and field.keys:
                        fr.row_key = self.translator.translate_id(
                            idx.name, fr.field, fr.row_id
                        )
        return result

    # ------------------------------------------------------------- dispatch

    def _shards_for(self, idx: Index, shards: list[int] | None) -> list[int]:
        if shards is not None:
            return sorted(shards)
        return sorted(idx.available_shards())

    def _execute_call(self, idx: Index, call: Call, shards: list[int] | None) -> Any:
        name = call.name
        # stop before a scan the caller will no longer wait for
        deadline.check(f"executing {name} on {idx.name!r}")
        if name == "Count":
            return self._execute_count(idx, call, shards)
        if name == "Sum":
            return self._execute_sum(idx, call, shards)
        if name in ("Min", "Max"):
            return self._execute_min_max(idx, call, shards, maximal=name == "Max")
        if name in ("MinRow", "MaxRow"):
            return self._execute_min_max_row(idx, call, shards, maximal=name == "MaxRow")
        if name == "TopN":
            return self._execute_topn(idx, call, shards)
        if name == "Set":
            return self._after_write(idx, call, self._execute_set(idx, call))
        if name == "Clear":
            return self._after_write(idx, call, self._execute_clear(idx, call))
        if name == "ClearRow":
            return self._after_write(idx, call, self._execute_clear_row(idx, call, shards))
        if name == "Rows":
            return self._execute_rows(idx, call, shards)
        if name == "GroupBy":
            return self._execute_groupby(idx, call, shards)
        if name == "Store":
            return self._after_write(idx, call, self._execute_store(idx, call, shards))
        if name == "SetRowAttrs":
            return self._after_write(idx, call, self._execute_set_row_attrs(idx, call))
        if name == "SetColumnAttrs":
            return self._after_write(idx, call, self._execute_set_column_attrs(idx, call))
        if name == "Options":
            return self._execute_options(idx, call, shards)
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

    _UNRESOLVED = object()  # serving_mesh() may itself be None

    def _stack_key(self, shards: list[int], view_name: str, n_fixed_rows: int | None,
                   mesh=_UNRESOLVED):
        """Stack-cache key ``(shards, view, fixed rows, mesh)``. The mesh is
        part of it, as in JAX (executor.py:1172-1190): a stack laid over
        one mesh never answers for another. A caller that lays a stack out
        passes the mesh it resolved once, so key and layout agree."""
        if mesh is Executor._UNRESOLVED:
            mesh = self._serving_mesh()
        return tuple(shards), view_name, n_fixed_rows, mesh

    def _serving_mesh(self):
        """The mesh this executor lays its stacks over
        (``parallel/mesh.serving_mesh``), when its devices are of the
        holder's device type; None for the plain single-device stacks. The
        implicit mesh of a host's CUDA devices does not apply to a CPU
        holder; a mesh set outright (``configure_serving(devices=...)``)
        of another device type raises, so no work moves to another device
        type unasked."""
        mesh = mesh_mod.serving_mesh()
        if mesh is None:
            return None
        want = streams.card(self.holder.device).type
        if mesh.device_type == want:
            return mesh
        if mesh_mod.serving_configured():
            raise ValueError(
                f"serving mesh on {mesh.device_type} devices, holder on {want}"
            )
        return None

    @staticmethod
    def _stack_on(bits: np.ndarray, mesh, device):
        """Host words as a device stack: cut over ``mesh`` (its shard axis
        padded to the mesh's size), or whole on ``device``."""
        if mesh is None:
            return bitops.to_device(bits, device)
        return sharded.shard(bits, mesh)

    def _field_stack(
        self, field: Field, shards: list[int], view_name: str = VIEW_STANDARD,
        fixed_rows: range | None = None,
    ):
        """(slot_of, bits) for one of the field's views: ``bits`` is an
        ``int32[S, R, W]`` tensor on the holder's device, DENSE over
        ``shards`` (all-zero slices where a shard has no fragment), rows in
        ascending row-id order, or pinned to ``fixed_rows`` (the BSI layout:
        exists, sign and the planes at rows 0..depth+1, reference
        fragment.go:90-96; rows outside it are not stacked). Cached per
        (shard set, view, fixed row count) until a fragment's (epoch,
        version) changes; then the changed shards are patched in
        (:meth:`_stack_incremental_update`) or, failing that, the stack is
        rebuilt from the host mirrors.

        Two answers are not a stack: None when the view has no rows over
        ``shards``, and :data:`STACK_DECLINED` when the process
        device-memory budget (``core/membudget.py``) declines it, because
        its bytes alone exceed the budget's cap; the caller then answers
        per fragment. Every cached stack is admitted to the budget under a
        key of its own, touched on a hit or a patch and released when the
        cache drops it; the budget's eviction drops the cache entry, and
        with it the only reference the executor keeps to the tensor (the
        gram, row-count and aggregate caches on the entry go with it; the
        cross-gram slots hold their partner's tensor weakly). A hot entry
        is pinned (``residency.maybe_pin_stack``). The JAX executor also
        declines any stack over a fixed 4 GiB (``_STACK_BUDGET_BYTES``,
        tuned for a TPU's memory); the port does not carry that figure:
        on the card the budget's cap (80 % of the card's memory unless set,
        ``membudget.default_budget``) is the only limit."""
        v = field.view(view_name)
        if v is None:
            return None
        frags = {s: v.fragments[s] for s in shards if s in v.fragments}
        if not frags:
            return None
        # key and layout use the one resolved mesh (a concurrent
        # configure_serving must not file an old-mesh stack under a new key)
        mesh = self._serving_mesh()
        key = self._stack_key(
            shards, view_name, None if fixed_rows is None else len(fixed_rows), mesh
        )
        versions = tuple(
            (frags[s].epoch, frags[s].version) if s in frags else (-1, -1)
            for s in shards
        )
        budget = membudget.default_budget(self.holder.device)
        tracker = residency.default_tracker()
        with self._stack_lock:
            caches = self._stacks.setdefault(field, {})
            entry = caches.get(key)
            if entry is not None:
                # a stack the uploader made on its side stream: this
                # stream waits for its copy before any read (ops/streams.py)
                streams.use_here(entry["dev"], entry.get("ready"))
                entry["lru"] = next(self._lru_clock)
                entry["hits"] += 1
                # the prefetcher's own builds (server/prefetch.py) book as
                # prefetch traffic; a query's first hit on a stack a
                # prefetch built counts that prefetch useful
                prefetching = tracker.in_prefetch()
                if entry["versions"] == versions:
                    budget.touch(entry["bkey"])
                    if prefetching:
                        tracker.note_prefetch_wasted()
                    else:
                        tracker.note_stack_hit()
                        tracker.note_hit(entry["prefetched"])
                        entry["prefetched"] = False
                        if not entry["pinned"] and tracker.maybe_pin_stack(
                            budget, entry["bkey"], entry["hits"]
                        ):
                            entry["pinned"] = True
                    return entry["slot_of"], entry["dev"]
                if not prefetching:
                    self._claim_prefetch(field, key)
                updated = self._stack_incremental_update(
                    field, entry, frags, shards, versions
                )
                if updated is not None:
                    budget.touch(entry["bkey"])
                    if prefetching:
                        entry["prefetched"] = True
                        tracker.note_prefetch_upload(0)
                    else:
                        tracker.note_stack_hit()
                        tracker.note_hit(entry["prefetched"])
                        entry["prefetched"] = False
                    return updated
                caches.pop(key, None)
                budget.release(entry["bkey"])
            if not tracker.in_prefetch():
                self._claim_prefetch(field, key)
            if fixed_rows is not None:
                row_ids = list(fixed_rows)
            else:
                row_ids = sorted({r for f in frags.values() for r in f.row_ids()})
            if not row_ids:
                return None
            S, R, W = len(shards), len(row_ids), field.n_words
            # a mesh pads the shard axis to a multiple of its size
            S_dev = S if mesh is None else -(-S // mesh.size) * mesh.size
            nbytes = S_dev * R * W * 4
            if budget.would_decline(nbytes):
                self.stacks_declined += 1
                return STACK_DECLINED
            slot_of = {r: i for i, r in enumerate(row_ids)}
            bits = np.zeros((S, R, W), dtype=np.uint32)
            for si, s in enumerate(shards):
                f = frags.get(s)
                if f is None:
                    continue
                ids, matrix = f.rows_matrix_host()
                src = [k for k, r in enumerate(ids) if r in slot_of]
                if src:
                    bits[si, [slot_of[ids[k]] for k in src]] = matrix[src]
            dev = self._stack_on(bits, mesh, self.holder.device)
            del bits
            self.stack_rebuilds += 1
            qprofile.incr("stack_rebuilds")
            prefetched = tracker.in_prefetch()
            if prefetched:
                tracker.note_prefetch_upload(nbytes)
            else:
                tracker.note_miss()
            # a BSI depth change (a new row-axis length) retires the entries
            # of the same shards and view: they can never be hit again
            # the budget's evict callback pops entries without the lock
            # (_stack_evict_cb), so these scans read a snapshot and pop
            # with a default: an entry may vanish under them
            for stale in [k for k, _ in _dict_items(caches)
                          if k[:2] == key[:2] and k[3] == key[3] and k[2] != key[2]]:
                old = caches.pop(stale, None)
                if old is not None:
                    budget.release(old["bkey"])
            while True:
                items = [kv for kv in _dict_items(caches) if kv[0][1] == view_name]
                if len(items) < self._STACK_CACHE_ENTRIES:
                    break
                old = caches.pop(min(items, key=lambda kv: kv[1]["lru"])[0], None)
                if old is not None:
                    budget.release(old["bkey"])
            entry = _StackEntry(
                versions=versions, slot_of=slot_of, dev=dev,
                lru=next(self._lru_clock), bkey=object(), hits=0, pinned=False,
                prefetched=prefetched,
                # the event after its copy when built on a side stream
                ready=streams.ready_event(dev.device),
            )
            caches[key] = entry
            # an entry dropped without a release (the field or the executor
            # collected) still leaves the budget
            weakref.finalize(entry, budget.release_from_finalizer, entry["bkey"])
            budget.admit(entry["bkey"], nbytes, self._stack_evict_cb(field, key, entry))
            return slot_of, dev

    def release_stacks(self) -> int:
        """Drop every cached stack and release its bytes from the budget;
        the number dropped. After a topology change the stacks were built
        over shard sets this executor no longer answers, and would hold
        their bytes on the card until the cache's LRU reached them."""
        budget = membudget.default_budget(self.holder.device)
        dropped = 0
        with self._stack_lock:
            for field in list(self._stacks.keys()):
                caches = self._stacks.get(field)
                if not caches:
                    continue
                for key, entry in _dict_items(caches):
                    if caches.pop(key, None) is not None:
                        budget.release(entry["bkey"])
                        dropped += 1
        return dropped

    def _stack_evict_cb(self, field: Field, key, entry: dict):
        """The budget's evict callback for one stack entry: drop the entry
        from the cache (a lock-free pop, as the evicting thread may hold
        another lock), if it is still the entry cached under ``key``. A
        query already holding the tensor keeps using it."""
        exref, fref, eref = weakref.ref(self), weakref.ref(field), weakref.ref(entry)

        def evict():
            ex, f, e = exref(), fref(), eref()
            if ex is None or f is None or e is None:
                return
            caches = ex._stacks.get(f)
            if caches is not None and caches.get(key) is e:
                caches.pop(key, None)
                ex.stack_evictions += 1

        return evict

    def _stack_incremental_update(
        self, field: Field, entry: dict, frags, shards: list[int], versions
    ):
        """(slot_of, bits) with the changed shards of a cached stack patched
        in, or None when the caller must rebuild: a shard gained a row id
        the stack has no slot for, a fragment is gone, or more than
        _STACK_INCR_MAX_FRACTION of the shards changed.

        The patch makes a NEW tensor (out-of-place ``index_copy``, the
        counterpart of JAX's ``.at[changed].set``): the full gram, the row
        totals and the cross-gram slots cached on the entry, and
        :meth:`_stack_entry_for`, key on the tensor's identity, so patching
        in place would let them serve a stale snapshot. The cost is a
        transient second copy of the stack on the device (1.34 GB at 160
        shards x 64 rows x 2^20 columns, so 2.7 GB at the peak) and one
        device-to-device copy of it, besides uploading the changed shards'
        blocks once. The second copy is admitted to the device-memory
        budget under a key of its own while both live (it may evict other
        cold entries to fit) and released once the old one is dropped."""
        slot_of = entry["slot_of"]
        changed = [
            si for si, (a, b) in enumerate(zip(entry["versions"], versions))
            if a != b
        ]
        if not changed or len(changed) > max(
            1, int(len(shards) * self._STACK_INCR_MAX_FRACTION)
        ):
            return None
        blocks = np.zeros((len(changed), len(slot_of), field.n_words), dtype=np.uint32)
        for k, si in enumerate(changed):
            f = frags.get(shards[si])
            if f is None:
                return None
            # one locked snapshot of the fragment: a separate membership
            # check would race a write adding a row between it and the copy
            ids, matrix = f.rows_matrix_host()
            dst = [slot_of.get(r) for r in ids]
            if any(d is None for d in dst):
                return None  # a new row changes the stack's shape
            if ids:
                blocks[k, dst] = matrix
        old = entry["dev"]
        budget = membudget.default_budget(self.holder.device)
        # the entry being patched takes its second chance before the copy's
        # admission looks for victims
        budget.touch(entry["bkey"])
        copy_key = object()
        if sharded.is_sharded(old):  # only the slices holding a changed shard
            touched = [k for k, (a, b) in enumerate(old.bounds)
                       if any(a <= si < b for si in changed)]
            copy_bytes = sum(old.slices[k].numel() * old.element_size() for k in touched)
        else:
            copy_bytes = old.numel() * old.element_size()
        budget.admit(copy_key, copy_bytes, lambda: None)
        try:
            if sharded.is_sharded(old):
                dev = self._patch_slices(old, changed, blocks, touched)
            else:
                where = torch.tensor(changed, dtype=torch.int64, device=old.device)
                dev = old.index_copy(0, where, bitops.to_device(blocks, old.device))
        finally:
            budget.release(copy_key)
        for k in ("gram", "gram_misses", "rowcounts", "crossgram", "crossgram_misses",
                  "bsi_agg"):
            entry.pop(k, None)  # they described the old snapshot
        # the new tensor's copy event before the tensor, and dev before
        # versions: a reader keyed on versions must never see the old dev
        entry["ready"] = streams.ready_event(dev.device)
        entry["dev"] = dev
        entry["versions"] = versions
        self.stack_incremental += 1
        qprofile.incr("stack_incremental")
        return slot_of, dev

    @staticmethod
    def _patch_slices(old, changed: list[int], blocks: np.ndarray, touched: list[int]):
        """A sharded stack with the changed shards' ``blocks`` copied into
        new tensors of the slices that hold them (``touched``); the other
        slices are shared with ``old``."""
        parts = list(old.slices)
        for k in touched:
            a, b = old.bounds[k]
            sel = [j for j, si in enumerate(changed) if a <= si < b]
            t = parts[k]
            where = torch.tensor([changed[j] - a for j in sel], dtype=torch.int64, device=t.device)
            parts[k] = t.index_copy(0, where, bitops.to_device(blocks[sel], t.device))
        return sharded.ShardedStack(parts, old.bounds, old.shape, old.mesh)

    def _stack_entry_for(self, field: Field, bits: torch.Tensor):
        """The cache entry whose device snapshot IS ``bits``, or None."""
        with self._stack_lock:
            for _, e in _dict_items(self._stacks.get(field, {})):
                if e["dev"] is bits:
                    return e
        return None

    def _stack_cached(
        self, field: Field, shard_list: list[int], view_name: str = VIEW_STANDARD,
        n_fixed_rows: int | None = None,
    ) -> bool:
        """Whether a stack of the field's view over these shards is cached
        (a peek that never builds)."""
        key = self._stack_key(shard_list, view_name, n_fixed_rows)
        with self._stack_lock:
            return key in self._stacks.get(field, {})

    def prefetch_issued(self, field: Field, shard_list: list[int], view_name: str):
        """Note a prefetch of a view's stack about to be queued, until
        :meth:`prefetch_ended`: a dispatch that needs the stack before the
        uploader starts the prefetch claims it (:meth:`_claim_prefetch`).
        Returns the note, or None when one is already pending (that
        prefetch covers this one)."""
        k = (id(field), self._stack_key(shard_list, view_name, None))
        with self._prefetching_lock:
            if k in self._prefetching:
                return None
            note = self._prefetching[k] = _PrefetchNote()
            return note

    def prefetch_ended(self, field: Field, shard_list: list[int], view_name: str, note) -> None:
        """The prefetch noted by :meth:`prefetch_issued` ended (built,
        skipped, failed or never queued)."""
        k = (id(field), self._stack_key(shard_list, view_name, None))
        with self._prefetching_lock:
            if self._prefetching.get(k) is note:
                del self._prefetching[k]

    def _claim_prefetch(self, field: Field, key: tuple) -> None:
        """A dispatch is about to build (or patch) a stack: take over that
        stack's prefetch if the uploader has not started it. The dispatch
        never waits for the uploader, which may be busy with ingest; the
        uploader skips the job, and the prefetch counts useful, since it
        named a stack a query needed (``prefetch_claims`` counts these). A
        prefetch already started races the dispatch for the stack lock, as
        in JAX."""
        if not self._prefetching:
            return
        with self._prefetching_lock:
            note = self._prefetching.get((id(field), key))
            if note is None or note.state != "queued":
                return
            note.state = "claimed"
            self.prefetch_claims += 1
        residency.default_tracker().note_prefetch_claimed()

    def prefetch_stack(
        self, field: Field, shard_list: list[int], view_name: str = VIEW_STANDARD,
        note: _PrefetchNote | None = None,
    ) -> None:
        """Build (or refresh) a view's serving stack off the dispatch path:
        the residency prefetcher's target (``server/prefetch.py``). It runs
        on the ingest uploader's thread, inside the tracker's prefetch
        context and on the uploader's side stream, so the stack's copy goes
        through pinned slots and its entry carries the event readers wait
        for; a stack the budget declines is not built. A standard view's
        full pair-count gram is computed here too (one gram launch), so the
        next flight's pair Counts on the field launch nothing. A prefetch
        whose ``note`` a dispatch claimed is skipped: that dispatch built the
        stack."""
        if note is not None:
            with self._prefetching_lock:
                if note.state == "claimed":
                    return
                note.state = "started"
        got = self._field_stack(field, shard_list, view_name)
        if got is None or got is STACK_DECLINED or view_name != VIEW_STANDARD:
            return
        _, bits = got
        R = bits.shape[1]
        if R > self._GRAM_CACHE_MAX_ROWS:
            return
        entry = self._stack_entry_for(field, bits)
        if entry is None or entry.get("gram") is not None:
            return
        g = kernels.pair_gram(bits, list(range(R)))
        if g is not None:
            with self._stack_lock:
                if entry["dev"] is bits:
                    entry["gram"] = g

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
                qprofile.incr("gram_cache_hits")
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
        # once the ledger prices both lanes, the measured comparison
        # replaces the warm-up count (exec/planner.py)
        return self.planner.choose_lane("pair_count", n >= self._PAIR_SINGLE_WARM)

    def _stack_row_counts(self, field: Field, bits: torch.Tensor) -> np.ndarray:
        """Per-slot row counts ``int64 [R]`` for a stack snapshot, cached on
        its entry. A cached full gram's diagonal is reused instead of
        launching the row scan."""
        entry = self._stack_entry_for(field, bits)
        if entry is not None:
            cached = entry.get("rowcounts")
            if cached is not None:
                self.rowcount_cache_hits += 1
                qprofile.incr("rowcount_cache_hits")
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

    def _cross_slot(self, field: Field, bits: torch.Tensor, partner: str):
        """(entry, slot): the stack entry whose snapshot is ``bits`` and
        its cached ``(partner_snapshot_weakref, gram)`` for ``partner``,
        or None for the slot. A slot whose partner snapshot is gone is
        dropped; a hit moves to the end of the LRU order."""
        entry = self._stack_entry_for(field, bits)
        if entry is None:
            return None, None
        with self._stack_lock:
            slots = entry.get("crossgram")
            t = slots.get(partner) if slots else None
            if t is None:
                return entry, None
            slots.pop(partner)
            if t[0]() is None:
                return entry, None
            slots[partner] = t
        return entry, t

    def _cross_gram(
        self, f1: Field, bits1: torch.Tensor, f2: Field, bits2: torch.Tensor,
        sub1: list[int], sub2: list[int],
    ) -> np.ndarray | None:
        """Cross-field intersection counts ``int64 [len(sub1), len(sub2)]``
        between slot subsets of two stack snapshots, with _field_gram's
        invest-on-reuse rule: the FULL cross gram is computed when the
        subsets nearly cover both fields, or once _GRAM_CACHE_MIN_REUSE
        subset grams have been computed against the first snapshot; every
        later combination matrix is then sliced from host memory. Slots
        live on the first field's stack entry, one per partner field, and
        hold the partner's snapshot only weakly; a write to either field
        gives it a new snapshot, which no slot matches. The reversed field
        order is served from the same slot, transposed. None when the
        gram path declines."""
        R1, R2 = bits1.shape[1], bits2.shape[1]
        if R1 <= self._GRAM_CACHE_MAX_ROWS and R2 <= self._GRAM_CACHE_MAX_ROWS:
            entry, t = self._cross_slot(f1, bits1, f2.name)
            if t is not None and t[0]() is bits2:
                self.crossgram_cache_hits += 1
                qprofile.incr("crossgram_cache_hits")
                return t[1][np.ix_(sub1, sub2)]
            _, t2 = self._cross_slot(f2, bits2, f1.name)
            if t2 is not None and t2[0]() is bits1:
                self.crossgram_cache_hits += 1
                qprofile.incr("crossgram_cache_hits")
                return t2[1].T[np.ix_(sub1, sub2)]
            if entry is not None:
                with self._stack_lock:
                    misses = entry.setdefault("crossgram_misses", {})
                    n_miss = misses.get(f2.name, 0)
                nearly_full = 2 * len(sub1) >= R1 and 2 * len(sub2) >= R2
                if nearly_full or n_miss >= self._GRAM_CACHE_MIN_REUSE:
                    g = kernels.cross_pair_gram(
                        bits1, bits2, list(range(R1)), list(range(R2))
                    )
                    if g is not None:
                        with self._stack_lock:
                            slots = entry.setdefault("crossgram", {})
                            slots.pop(f2.name, None)
                            slots[f2.name] = (weakref.ref(bits2), g)
                            while len(slots) > self._CROSS_GRAM_SLOTS:
                                del slots[next(iter(slots))]
                        return g[np.ix_(sub1, sub2)]
                else:
                    with self._stack_lock:
                        misses[f2.name] = n_miss + 1
        return kernels.cross_pair_gram(bits1, bits2, sub1, sub2)

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
            if stack is None or stack is STACK_DECLINED:
                # no rows, or over the budget: the items fall to the
                # per-call path and the host tier; a lone count restarts
                # its warm-up, so singles don't ask for a declined stack on
                # every query
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
            with tracing.start_span("executor.batchPairCount").set_tag(
                "field", fname
            ).set_tag("n", len(launch)):
                self._pair_counts_launch(field, bits, uniq, launch, results)

    def _pair_counts_launch(self, field: Field, bits: torch.Tensor, uniq, launch, results) -> None:
        """One field's batched pair counts: from its gram, or batched scans
        where the gram declines."""
        gram, pos = self._field_gram(field, bits, uniq)
        if gram is not None:
            pa = np.array([pos[sa] for _, _, sa, _ in launch])
            pb = np.array([pos[sb] for _, _, _, sb in launch])
            for op in {op for _, op, _, _ in launch}:
                sel = [j for j, it in enumerate(launch) if it[1] == op]
                counts = kernels.pair_counts_from_gram(gram, pa[sel], pb[sel], op)
                for c, j in zip(counts, sel):
                    results[launch[j][0]] = int(c)
            return
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

    # ------------------------------------------------ compiled tree batches

    def _batch_general(
        self, idx: Index, calls: list[Call], shards: list[int] | None,
        results: list[Any], weight: int = 1,
    ) -> None:
        """Answer the remaining batchable reads — trees of
        Row/Intersect/Union/Difference/Xor/Not, under Count or as a bitmap
        result — with one tree-kernel launch per AST shape and stack set
        (``exec/astbatch.py``; reference semantics executor.go:653-680).

        The caller cuts ``calls`` at the first write. A call engages only
        when every leaf's stack is live already or demanded by at least
        two batchable calls here (a stack build uploads a whole field, so
        it must amortize; each call here stands for ``weight`` of them);
        the others stay on the host tier. The flight planner's grafted
        operands (exec/planner.py) are leaves of one stack made here."""
        # launch groups key on (sig, stack pairs): calls of one shape over
        # the same stacks share one launch
        count_groups: dict[tuple, list[tuple[int, list]]] = {}
        bitmap_items: list[tuple[int, tuple, tuple, list]] = []
        demand: dict[tuple[str, str], int] = {}
        # the planner's grafted operands by identity: one stack for them all
        shared: dict[int, Row] = {}
        for i, call in enumerate(calls):
            if results[i] is not _UNSET:
                continue
            leaves: list[tuple[str, str, int]] = []
            pairs: list[tuple[str, str]] = []
            sig = astbatch.match_count(idx, call, leaves, pairs)
            if sig is not None:
                count_groups.setdefault((sig, tuple(pairs)), []).append((i, leaves))
            elif call.name in (
                "Intersect", "Union", "Difference", "Xor", "Not"
            ) or astbatch.is_time_range(call):
                leaves, pairs = [], []
                sig = astbatch.match_tree(idx, call, leaves, pairs)
                if sig is None:
                    continue
                bitmap_items.append((i, sig, tuple(pairs), leaves))
            else:
                continue
            if (astbatch.SHARED, "") in pairs:
                planner_mod.shared_rows(call, shared)
            for pair in pairs:
                demand[pair] = demand.get(pair, 0) + weight
        if not count_groups and not bitmap_items:
            return
        shard_list = self._shards_for(idx, shards)

        # (field, view) -> (slot_of, stack); None when not taken (cold and
        # under-demanded, or the field is gone) or STACK_DECLINED by the
        # budget; _ABSENT when the view holds no rows over the shards (a
        # view of a time cover that was never written): a zero leaf
        _ABSENT = object()
        stacks_by_view: dict[tuple[str, str], Any] = {}

        def _stacks_for(pairs, allow_spanning=False):
            """(stacks tuple, slot_of per pair), or None when a leaf's stack
            is not taken or declined, or every leaf's view is absent: the
            call then stays on the host tier. Each (field, view) pair reads
            its own view's stack. A bitmap tree declines a stack over a
            mesh that spans processes (``allow_spanning`` False), whose
            per-shard words are not all here, as in JAX."""
            out: list[torch.Tensor | None] = []
            slot_maps = {}
            for pair in pairs:
                fname, vname = pair
                if pair not in stacks_by_view:
                    field = idx.field(fname)  # the existence field too
                    if fname == astbatch.SHARED:  # made for this flight
                        got = self._shared_stack(shared, shard_list, idx.n_words)
                    elif field is None:
                        got = None
                    elif field.view(vname) is None:
                        got = _ABSENT
                    elif self._stack_cached(
                        field, shard_list, vname
                    ) or self.planner.choose_lane(
                        # a live stack serves for free; a cold one waits for
                        # two demands until the ledger prices both lanes
                        "tree_count", demand.get(pair, 0) >= 2
                    ):
                        got = self._field_stack(field, shard_list, vname)
                        if got is None:
                            got = _ABSENT
                    else:
                        got = None
                    stacks_by_view[pair] = got
                entry = stacks_by_view[pair]
                if entry is None or entry is STACK_DECLINED:
                    return None
                if entry is _ABSENT:
                    slot_maps[pair] = {}
                    out.append(None)
                else:
                    slot_maps[pair], stack = entry
                    out.append(stack)
            # an absent view's leaves are all slot -1: any real stack stands
            # in for it
            real = next((t for t in out if t is not None), None)
            if real is None:
                return None
            if not allow_spanning and kernels.stack_spans_processes(real):
                return None
            return tuple(real if t is None else t for t in out), slot_maps

        def _slots_of(leaves, slot_maps) -> np.ndarray:
            # absent rows -> slot -1 (a zero leaf)
            return np.array(
                [slot_maps[(f, vn)].get(r, -1) for f, vn, r in leaves], np.int32
            )

        for (sig, pairs), items in count_groups.items():
            st = _stacks_for(pairs, allow_spanning=True)
            if st is None:
                continue
            stacks, slot_maps = st
            slots = np.stack([_slots_of(leaves, slot_maps) for _, leaves in items])
            with tracing.start_span("executor.batchCountTree").set_tag("n", len(items)):
                totals = astbatch.run_count_batch(sig, stacks, slots)
            for j, (i, _) in enumerate(items):
                results[i] = int(totals[j])

        for i, sig, pairs, leaves in bitmap_items:
            st = _stacks_for(pairs)
            if st is None:
                continue
            stacks, slot_maps = st
            with tracing.start_span("executor.batchBitmapTree"):
                words = bitops.to_host(
                    astbatch.run_bitmap(sig, stacks, _slots_of(leaves, slot_maps))
                )
            row = Row(
                {s: words[si] for si, s in enumerate(shard_list)}, n_words=idx.n_words
            )
            if calls[i].name == "Row":  # a windowed Row carries its attrs
                fname = calls[i].field_arg()
                row.attrs = idx.field(fname).row_attrs.attrs(calls[i].args[fname])
            results[i] = row

    def _shared_stack(self, shared: dict, shard_list: list[int], n_words: int):
        """``(slot_of, int32[S, K, W])``: the flight's K grafted operands
        (``shared``, row identity -> Row) as one stack on the holder's
        device, uploaded once for the flight, so the trees that consume
        them still run in the tree kernel. Shards a row lacks are zeros."""
        bits = np.zeros((len(shard_list), len(shared), n_words), dtype=np.uint32)
        for k, row in enumerate(shared.values()):
            for si, s in enumerate(shard_list):
                seg = row.segments.get(s)
                if seg is not None:
                    bits[si, k] = seg
        self.shared_stack_uploads += 1
        # laid out as the field stacks it is read beside
        return {key: k for k, key in enumerate(shared)}, self._stack_on(
            bits, self._serving_mesh(), self.holder.device
        )

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
        if name == planner_mod.SHARED:
            # a flight-shared operand (exec/planner.py), evaluated once for
            # the flight: copied like a cache hit, so consumers attach keys
            # and attributes apart
            return rescache.copy_result(planner_mod.shared_row(call))
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

    def _field_row(
        self, field: Field | None, row_id: int, shards: list[int], view: str = VIEW_STANDARD
    ) -> Row:
        """Row segments of one of the field's views from the host mirrors
        (the latency tier)."""
        out = Row(n_words=self.holder.n_words)
        if field is None:
            return out
        v = field.view(view)
        if v is None:
            return out
        for shard in shards:
            frag = v.fragment(shard)
            if frag is not None:
                out.segments[shard] = frag.row_words_host(row_id)
        return out

    def _execute_row(self, idx: Index, call: Call, shards: list[int]) -> Row:
        """reference executor.go:1444 executeRowShard: a plain row, a BSI
        condition or a time range."""
        fname = call.field_arg()
        if fname is None:
            raise ExecuteError(f"{call.name}() requires a field argument")
        field = idx.field(fname)
        if field is None:
            raise FieldNotFoundError(f"field not found: {fname}")
        v = call.args.get(fname)
        if isinstance(v, Condition):
            return self._execute_bsi_condition(idx, field, v, shards)
        if "from" in call.args or "to" in call.args:
            return self._execute_time_range(idx, field, call, shards)
        if not isinstance(v, int) or isinstance(v, bool):
            raise ExecuteError(f"{call.name}() row argument must be an integer")
        if field.is_bsi():
            raise ExecuteError(
                f"{call.name}() cannot read a plain row from int field {fname!r}"
            )
        return self._field_row(field, v, shards)

    @staticmethod
    def _view_cover(field: Field, from_arg, to_arg) -> list[str] | None:
        """The minimal time-view cover of [from, to) (``core/timequantum.py``
        ``view_cover``); None when an open bound meets a field with no time
        view."""
        try:
            return timequantum.view_cover(field, from_arg, to_arg, VIEW_STANDARD)
        except ValueError as e:
            raise ExecuteError(str(e))

    def _execute_time_range(self, idx: Index, field: Field, call: Call, shards: list[int]) -> Row:
        """The union of the row over the views of the minimal time-view cover
        (reference executor.go:1515-1531, time.go viewsByTimeRange), on the
        host mirrors."""
        row_id = call.args.get(field.name)
        views = self._view_cover(field, call.args.get("from"), call.args.get("to"))
        out = Row(n_words=idx.n_words)
        if views is None:
            return out
        for vname in views:
            out = out.union(self._field_row(field, row_id, shards, view=vname))
        return out

    # ------------------------------------------------------ BSI conditions

    def _execute_bsi_condition(
        self, idx: Index, field: Field, cond: Condition, shards: list[int]
    ) -> Row:
        """A BSI range predicate (reference executor.go:1536-1566
        executeBSIGroupRangeShard + fragment.go:1271-1534)."""
        if not field.is_bsi():
            raise ExecuteError(f"range condition on non-int field {field.name!r}")
        # one warm-up decision per condition (a != evaluates two predicates)
        ready = self._bsi_single_ready(field, shards)
        op = cond.op
        if op == "!=" and cond.value is None:
            # f != null: every column with a value (reference frag.notNull)
            return self._bsi_rows(field, shards, lambda pl, ex, sg: ex.clone(), ready)
        if op == "==" and cond.value is None:
            raise ExecuteError("Range(): <field> == null is not supported")
        depth = field.bit_depth
        base = field.base
        if op in ("<", "<=", ">", ">="):
            bound = int(cond.value) - base
            fn = bsi.range_lt if op in ("<", "<=") else bsi.range_gt
            allow_eq = op in ("<=", ">=")
            return self._bsi_rows(
                field, shards,
                lambda pl, ex, sg: fn(pl, ex, sg, value=bound, depth=depth, allow_eq=allow_eq),
                ready,
            )
        if op in ("==", "!="):
            stored = int(cond.value) - base
            eq = self._bsi_rows(
                field, shards,
                lambda pl, ex, sg: bsi.range_eq(
                    pl, ex, sg, value_abs=abs(stored), negative=stored < 0, depth=depth
                ),
                ready,
            )
            if op == "==":
                return eq
            notnull = self._bsi_rows(field, shards, lambda pl, ex, sg: ex.clone(), ready)
            return notnull.difference(eq)
        if op == "><" or op in ("<x<", "<=x<", "<x<=", "<=x<="):
            lo, hi = cond.int_pair()
            if op != "><":
                lo_op, hi_op = op.split("x")
                lo = lo if lo_op == "<=" else lo + 1
                hi = hi if hi_op == "<=" else hi - 1
            return self._bsi_rows(
                field, shards,
                lambda pl, ex, sg: bsi.range_between(
                    pl, ex, sg, lo=lo - base, hi=hi - base, depth=depth
                ),
                ready,
            )
        raise ExecuteError(f"unsupported condition op: {op}")

    def _bsi_stack(self, field: Field, shards: list[int]):
        """The field's BSI stack ``int32[S, 2+depth, W]`` (rows: exists,
        sign, then the planes); None when the BSI view holds no fragment
        over ``shards``, :data:`STACK_DECLINED` when the device-memory
        budget declines it. It is a stack of the view like any other,
        cached and patched after writes; a write that grows the depth
        changes its key."""
        stack = self._field_stack(
            field, shards, view_name=field.bsi_view_name(),
            fixed_rows=range(2 + field.bit_depth),
        )
        return stack if stack is None or stack is STACK_DECLINED else stack[1]

    @staticmethod
    def _bsi_split(bits: torch.Tensor):
        """(exists, sign, planes) views of a BSI stack, read in place."""
        return bits[:, 0], bits[:, 1], bits[:, 2:]

    def _bsi_stack_live(self, field: Field, shards: list[int]) -> bool:
        """Whether the field's BSI stack is cached for these shards (a
        peek that never builds)."""
        return self._stack_cached(
            field, shards, field.bsi_view_name(), 2 + field.bit_depth
        )

    def _bsi_single_ready(self, field: Field, shards: list[int]) -> bool:
        """Whether a LONE BSI condition takes the stack: at once when the
        stack is live, else once _BSI_SINGLE_WARM of them have asked (a
        stack build uploads the whole field, so demand must pay for it)."""
        if self._BSI_SINGLE_WARM <= 0 or self._bsi_stack_live(field, shards):
            return True
        with self._stack_lock:
            n = self._bsi_single_demand.get(field, 0) + 1
            self._bsi_single_demand[field] = n
        return n >= self._BSI_SINGLE_WARM

    def _bsi_rows(self, field: Field, shards: list[int], kernel, ready: bool) -> Row:
        """``kernel(planes, exists, sign)`` (an ``ops/bsi.py`` predicate,
        ``[S, W]`` words) over every shard, as a Row: on the stack in one
        launch, or, for a lone cold condition (not ``ready``), on CPU
        tensors filled from the host mirrors, with no device upload (the
        BSI twin of the host pair-count tier). When the budget declines
        the stack, one launch per fragment on its device copy (rows paged
        from the mirror when the fragment itself is declined)."""
        out = Row(n_words=self.holder.n_words)
        if not ready:
            view = field.view(field.bsi_view_name())
            if view is None:
                return out
            frags = [(s, view.fragment(s)) for s in shards if view.fragment(s) is not None]
            if not frags:
                return out
            depth, W = field.bit_depth, field.n_words
            # one buffer for the field: the cold query costs one host copy
            planes = np.zeros((len(frags), depth, W), dtype=np.uint32)
            exists = np.zeros((len(frags), W), dtype=np.uint32)
            sign = np.zeros((len(frags), W), dtype=np.uint32)
            for si, (_, f) in enumerate(frags):
                f.fill_bsi_tensors_host(depth, planes[si], exists[si], sign[si])
            mask = bitops.to_host(kernel(
                *(torch.from_numpy(a.view(np.int32)) for a in (planes, exists, sign))
            ))
            for si, (s, _) in enumerate(frags):
                out.segments[s] = mask[si]
            return out
        st = self._bsi_stack(field, shards)
        if st is None:
            return out
        if st is STACK_DECLINED:
            view = field.view(field.bsi_view_name())
            for s in shards:
                frag = view.fragment(s)
                if frag is not None:
                    planes, exists, sign = frag.bsi_tensors(field.bit_depth)
                    self.bsi_fragment_launches += 1
                    out.segments[s] = bitops.to_host(kernel(planes, exists, sign))
            return out
        exists, sign, planes = self._bsi_split(st)
        self.bsi_stack_launches += 1
        mask = bitops.to_host(kernel(planes, exists, sign))
        for si, s in enumerate(shards):
            out.segments[s] = mask[si]
        return out

    # ----------------------------------------------------------------- Count

    def _range_count_key(self, idx: Index, child: Call):
        """(field, cache key) when ``child`` is a pure BSI range predicate,
        the repeat-dashboard ``Count(Row(v < N))`` whose answer is a scalar
        per stack snapshot; None otherwise."""
        m = astbatch._bsi_condition(idx, child)
        if m is None:
            return None
        field, cond = m
        v = tuple(cond.value) if isinstance(cond.value, list) else cond.value
        return field, f"rangecount:{cond.op}:{v!r}"

    def _execute_count(self, idx: Index, call: Call, shards: list[int] | None) -> int:
        if len(call.children) != 1:
            raise ExecuteError("Count() takes one argument")
        child = call.children[0]
        shard_list = self._shards_for(idx, shards)
        keyed = self._range_count_key(idx, child)
        if keyed is not None:
            field, key = keyed
            # a peek, never a build: a lone cold range count is answered on
            # the host below; repeat demand builds the stack
            ready = self._BSI_SINGLE_WARM <= 0 or self._bsi_stack_live(field, shard_list)
            bits = self._bsi_stack(field, shard_list) if ready else None
            if _is_stack(bits):
                cached, put = self._bsi_agg_cache(field, bits, key)
                if cached is not None:
                    return cached
                n = self._bitmap_call(idx, child, shard_list).count()
                put(n)
                return n
        # Latency tier: a lone Count over a pair or a single row, answered
        # from the host mirrors (the gram path declined it).
        m = self._match_pair_count(idx, call)
        if m is not None:
            fname, op, ra, rb = m
            view = idx.field(fname).view(VIEW_STANDARD)
            t0 = time.perf_counter()
            total = self._host_pair_count(view, ra, rb, op, shard_list)
            # the host lane's price, which the lane choice weighs against
            # the gram's measured device ms (exec/planner.py)
            self.planner.note_host_lane("pair_count", (time.perf_counter() - t0) * 1e3)
            return total
        n = self._match_single_row_count(idx, child)
        if n is not None:
            field, row_id = n
            view = field.view(VIEW_STANDARD)
            # popcount(a) == popcount(a & a)
            return self._host_pair_count(view, row_id, row_id, "intersect", shard_list)
        if child.name in (
            "Intersect", "Union", "Difference", "Xor", "Not"
        ) and not planner_mod.contains_shared(child):
            # a whole tree on the host: the batch-vs-solo lane's host price
            # (a grafted tree's combine is no solo evaluation)
            t0 = time.perf_counter()
            total = self._bitmap_call(idx, child, shard_list).count()
            self.planner.note_host_lane("tree_count", (time.perf_counter() - t0) * 1e3)
            return total
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

    # shards per host-tier fan-out chunk; also the engage threshold: below
    # it the hand-off to a thread costs more than it saves
    _HOST_FANOUT_CHUNK = 24

    def _host_pair_count(self, view, ra: int, rb: int, op: str, shard_list: list[int]) -> int:
        """Sum over shards of the fused host pair count, one native call
        per chunk of fragments (a ctypes crossing per shard would cost more
        than the count at 100+ shards), the chunks fanned over a small
        thread pool when the host has cores to use (the native kernel
        releases the GIL; the worker-pool role of reference
        executor.go:2557-2611)."""
        if view is None:
            return 0
        frags = [f for f in (view.fragment(s) for s in shard_list) if f is not None]
        if not frags:
            return 0
        cores = os.cpu_count() or 1
        if cores > 1 and len(frags) >= 2 * self._HOST_FANOUT_CHUNK:
            chunks = [
                frags[i : i + self._HOST_FANOUT_CHUNK]
                for i in range(0, len(frags), self._HOST_FANOUT_CHUNK)
            ]
            return sum(self._host_tier_pool().map(
                lambda ch: self._host_pair_count_chunk(ch, ra, rb, op), chunks
            ))
        return self._host_pair_count_chunk(frags, ra, rb, op)

    @staticmethod
    def _host_pair_count_chunk(frags, ra: int, rb: int, op: str) -> int:
        """One native call for a chunk of fragments, every fragment's lock
        held through it so the counts read one snapshot. Absent rows read a
        shared zero row, which gives every op its zero-row answer. Row
        addresses are computed in numpy (base + slot * stride) from each
        fragment's ``_host_addr``."""
        n_words = frags[0].n_words
        zeros = np.zeros(n_words, dtype=np.uint32)
        zaddr = np.uint64(zeros.__array_interface__["data"][0])
        n = len(frags)
        bases = np.empty(n, dtype=np.uint64)
        slots_a = np.empty(n, dtype=np.int64)
        slots_b = np.empty(n, dtype=np.int64)
        hosts = []  # every backing array stays alive through the call
        with contextlib.ExitStack() as st:
            for i, f in enumerate(frags):
                st.enter_context(f._lock)
                hosts.append(f._host)
                bases[i] = f._host_addr
                sa = f._slot_of.get(ra)
                sb = f._slot_of.get(rb)
                slots_a[i] = -1 if sa is None else sa
                slots_b[i] = -1 if sb is None else sb
            stride = np.uint64(n_words * 4)
            addr_a = np.where(
                slots_a < 0, zaddr, bases + slots_a.astype(np.uint64) * stride
            )
            addr_b = np.where(
                slots_b < 0, zaddr, bases + slots_b.astype(np.uint64) * stride
            )
            return _hostops.pair_count_addrs(addr_a, addr_b, n_words, op)

    def _host_tier_pool(self) -> concurrent.futures.ThreadPoolExecutor:
        """The executor's thread pool for the host tier's fan-out, built at
        first need (never on a single-core host: the caller does not fan
        out there)."""
        pool = self._host_pool
        if pool is None:
            with self._host_pool_lock:
                pool = self._host_pool
                if pool is None:
                    pool = concurrent.futures.ThreadPoolExecutor(
                        max_workers=min(8, os.cpu_count() or 1),
                        thread_name_prefix="pilosa-hosttier",
                    )
                    self._host_pool = pool
        return pool

    # ------------------------------------------------------- BSI aggregates

    def _sum_filter(self, idx: Index, call: Call, shards: list[int]) -> Row | None:
        if len(call.children) > 1:
            raise ExecuteError(f"{call.name}() only accepts a single bitmap input")
        if call.children:
            return self._bitmap_call(idx, call.children[0], shards)
        return None

    @staticmethod
    def _bsi_field(idx: Index, call: Call) -> Field:
        fname, ok = call.string_arg("field")
        if not ok:
            fname = call.args.get("_field")
        if not fname:
            raise ExecuteError(f"{call.name}(): field required")
        field = idx.field(fname)
        if field is None:
            raise FieldNotFoundError(f"field not found: {fname}")
        return field

    def _bsi_agg_shards(self, idx: Index, call: Call, shards: list[int] | None):
        """Sum/Min/Max scaffold: ``(field, stacked, per_fragment)``.
        ``stacked`` is the deferred ``(bits, filter_row, shards)`` of the
        field's BSI stack (views and filter words are made only on a cache
        miss, by :meth:`_bsi_tensors`), or None when there is no stack (no
        fragment holds values, or the budget declined it). Then
        ``per_fragment`` yields ``(planes, exists, sign, filter)`` of each
        fragment on its device copy, one launch each (JAX's per-shard
        generator); the exists row is the filter of an unfiltered query,
        and a shard the filter does not reach is skipped."""
        shards = self._shards_for(idx, shards)
        field = self._bsi_field(idx, call)
        filt = self._sum_filter(idx, call, shards)
        bits = self._bsi_stack(field, shards)
        stacked = (bits, filt, shards) if _is_stack(bits) else None

        def per_fragment():
            view = field.view(field.bsi_view_name())
            if stacked is not None or view is None:
                return
            for shard in shards:
                frag = view.fragment(shard)
                if frag is None:
                    continue
                seg = None
                if filt is not None:
                    seg = filt.segments.get(shard)
                    if seg is None:
                        continue
                planes, exists, sign = frag.bsi_tensors(field.bit_depth)
                fw = exists if seg is None else bitops.to_device(seg, exists.device)
                self.bsi_fragment_launches += 1
                yield planes, exists, sign, fw

        return field, stacked, per_fragment()

    def _bsi_agg_cache(self, field: Field, dev: torch.Tensor, key: str):
        """``(cached value | None, put)``: scalar aggregates per BSI stack
        snapshot, on its cache entry (keyed on the tensor's identity, so a
        write, which makes a new snapshot, misses), at most _BSI_AGG_SLOTS
        of them, least recently used first out."""
        entry = self._stack_entry_for(field, dev)
        if entry is None:
            return None, lambda v: None
        with self._stack_lock:
            slots = entry.get("bsi_agg")
            t = slots.get(key) if slots else None
            if t is not None and t[0] is dev:
                self.bsi_agg_cache_hits += 1
                qprofile.incr("bsi_agg_cache_hits")
                slots[key] = slots.pop(key)
                return t[1], lambda v: None

        def put(v):
            with self._stack_lock:
                if entry.get("dev") is dev:  # the snapshot is still current
                    slots2 = entry.setdefault("bsi_agg", {})
                    slots2.pop(key, None)
                    slots2[key] = (dev, v)
                    while len(slots2) > self._BSI_AGG_SLOTS:
                        del slots2[next(iter(slots2))]

        return None, put

    def _bsi_tensors(self, field: Field, stacked):
        """``(planes, exists, sign, filter words)`` of a deferred stacked
        aggregate; the exists row is its own filter when unfiltered."""
        bits, filt, shards = stacked
        exists, sign, planes = self._bsi_split(bits)
        if filt is None:
            return planes, exists, sign, exists
        S, W = exists.shape
        fw = bitops.to_device(self._row_to_shard_matrix(filt, shards, S, W), bits.device)
        return planes, exists, sign, fw

    def _bsi_agg_serve(self, field: Field, stacked, key: str, compute):
        """One stacked aggregate: a cache hit for an unfiltered one, else
        ``compute(planes, exists, sign, filter_words)`` (installed when
        unfiltered)."""
        bits, filt, _ = stacked
        cached, put = (
            self._bsi_agg_cache(field, bits, key) if filt is None else (None, lambda v: None)
        )
        if cached is None:
            self.bsi_stack_launches += 1
            cached = compute(*self._bsi_tensors(field, stacked))
            put(cached)
        return cached

    @staticmethod
    def _sum_valcount(field: Field, tc) -> ValCount:
        total, count = tc
        if count == 0:
            return ValCount()
        return ValCount(value=total + count * field.base, count=count)

    def _execute_sum(self, idx: Index, call: Call, shards: list[int] | None) -> ValCount:
        """reference executor.go:409-442 + executeSumCountShard."""
        field, stacked, per_fragment = self._bsi_agg_shards(idx, call, shards)
        depth = field.bit_depth
        if stacked is not None:
            tc = self._bsi_agg_serve(
                field, stacked, "sum",
                lambda p, e, s, fw: bsi.sum_host(p, e, s, fw, depth=depth),
            )
            return self._sum_valcount(field, tc)
        total, count = 0, 0
        for planes, exists, sign, fw in per_fragment:
            t, c = bsi.sum_host(planes, exists, sign, fw, depth=depth)
            total += t
            count += c
        return self._sum_valcount(field, (total, count))

    def _execute_min_max(
        self, idx: Index, call: Call, shards: list[int] | None, maximal: bool
    ) -> ValCount:
        """Min/Max over the whole stack: per-shard (and slice) extremes,
        combined on the host, which is the reference's per-shard merge
        (equal extremes add their counts)."""
        field, stacked, per_fragment = self._bsi_agg_shards(idx, call, shards)
        depth = field.bit_depth
        if stacked is not None:
            value, count = self._bsi_agg_serve(
                field, stacked, f"minmax:{maximal}",
                lambda p, e, s, fw: bsi.min_max_host(p, e, s, fw, depth=depth, maximal=maximal),
            )
            if count == 0:
                return ValCount()
            return ValCount(value=value + field.base, count=count)
        # the per-fragment merge: equal extremes add their counts
        best: ValCount | None = None
        for planes, exists, sign, fw in per_fragment:
            value, count = bsi.min_max_host(
                planes, exists, sign, fw, depth=depth, maximal=maximal
            )
            if count == 0:
                continue
            value += field.base
            if best is None or (value > best.value if maximal else value < best.value):
                best = ValCount(value=value, count=count)
            elif value == best.value:
                best.count += count
        return best or ValCount()

    def _execute_min_max_row(
        self, idx: Index, call: Call, shards: list[int] | None, maximal: bool
    ) -> Pair:
        """MinRow/MaxRow: the extreme row id holding a bit, with its count
        (reference executor.go:560-651), from the maintained per-fragment
        counts."""
        shards = self._shards_for(idx, shards)
        fname, ok = call.string_arg("field")
        if not ok:
            raise ExecuteError(f"{call.name}(): field required")
        field = idx.field(fname)
        if field is None:
            raise FieldNotFoundError(f"field not found: {fname}")
        view = field.view(VIEW_STANDARD)
        best: Pair | None = None
        if view is not None:
            for shard in shards:
                frag = view.fragment(shard)
                if frag is None:
                    continue
                ids, counts = frag.row_counts()
                ids = np.asarray(ids, np.uint64)  # row ids span 64 bits
                counts = np.asarray(counts, np.int64)
                nz = counts > 0
                if not nz.any():
                    continue
                rid = int(ids[nz].max() if maximal else ids[nz].min())
                cnt = int(counts[ids == rid][0])
                if best is None or (rid > best.id if maximal else rid < best.id):
                    best = Pair(id=rid, count=cnt)
                elif rid == best.id:
                    best.count += cnt
        return best or Pair()

    # ---------------------------------------------------- batched BSI lane

    @staticmethod
    def _bsi_stored_bounds(field: Field, cond: Condition):
        """A condition's bounds in stored space (value - base), for the
        batched range scan (ops/bsi.py condition_bounds)."""
        op = cond.op
        if op == "!=" and cond.value is None:
            return bsi.condition_bounds(op, None)
        if op == "><" or "x" in op:
            lo, hi = cond.int_pair()
            return bsi.condition_bounds(op, (lo - field.base, hi - field.base))
        return bsi.condition_bounds(op, int(cond.value) - field.base)

    def _batch_bsi(
        self, idx: Index, calls: list[Call], shards: list[int] | None,
        results: list[Any],
    ) -> None:
        """Answer every call ``astbatch.match_bsi`` signs with shared
        launches: calls group by (field, op class), so Q conditions cost one
        range scan and Q filtered Sums one sum launch (within a budget).
        An item's own trouble leaves its slot _UNSET for the per-call path,
        which raises it within its own query; one bad query never fails the
        others. A field engages when two or more of its calls batch or its
        BSI stack is live; a lone cold call keeps the per-call path."""
        by_field: dict[str, list[tuple[int, str, Any]]] = {}
        fields: dict[str, Field] = {}
        for i, call in enumerate(calls):
            if results[i] is not _UNSET:
                continue
            m = astbatch.match_bsi(idx, call)
            if m is None:
                continue
            op_class, field, cond = m
            by_field.setdefault(field.name, []).append((i, op_class, cond))
            fields[field.name] = field
        if not by_field:
            return
        shard_list = self._shards_for(idx, shards)
        for fname, items in by_field.items():
            field = fields[fname]
            if len(items) < 2 and not self._bsi_stack_live(field, shard_list):
                continue
            bits = self._bsi_stack(field, shard_list)
            if bits is None or bits is STACK_DECLINED:
                continue  # the per-call path answers, per fragment
            if kernels.stack_spans_processes(bits):
                # per-shard words and partials are not all here across
                # processes (JAX declines alike); the per-call paths answer
                continue
            groups: dict[str, list[tuple[int, Any]]] = {}
            for i, op_class, cond in items:
                groups.setdefault(op_class, []).append((i, cond))
            with tracing.start_span("executor.batchBSI").set_tag(
                "field", fname
            ).set_tag("n", len(items)):
                self._batch_bsi_field(idx, field, bits, groups, shard_list, calls, results)

    def _batch_bsi_field(
        self, idx: Index, field: Field, bits: torch.Tensor, groups, shard_list,
        calls: list[Call], results: list[Any],
    ) -> None:
        """One field's grouped launches against its BSI stack."""
        depth = field.bit_depth
        exists, sign, planes = self._bsi_split(bits)

        def queries_of(items):
            try:
                return [self._bsi_stored_bounds(field, cond) for _, cond in items]
            except (ValueError, TypeError):
                return None  # the per-call path raises per query

        # -- result words: Row/Range conditions and GroupBy filters, in
        # launches of at most RANGE_WORDS_BYTES of [Q, S, W] words
        mask_items = groups.get(astbatch.BSI_RANGE, []) + groups.get(astbatch.BSI_GROUPBY, [])
        queries = queries_of(mask_items) if mask_items else None
        if queries is not None:
            cap = bsi.range_words_cap(*exists.shape)
            for q0 in range(0, len(queries), cap):
                self.bsi_stack_launches += 1
                with tracing.start_span("executor.bsiRangeBatch").set_tag(
                    "n", len(queries[q0 : q0 + cap])
                ):
                    masks = bitops.to_host(bsi.range_batch(
                        planes, exists, sign, queries[q0 : q0 + cap], depth=depth
                    ))
                for qi, (i, _) in enumerate(mask_items[q0 : q0 + cap]):
                    row = Row(n_words=self.holder.n_words)
                    for si, s in enumerate(shard_list):
                        row.segments[s] = masks[qi, si]
                    if calls[i].name != "GroupBy":
                        results[i] = row
                        continue
                    try:
                        results[i] = self._execute_groupby(
                            idx, calls[i], shard_list, filt_row=row
                        )
                    except Exception:  # the per-call path raises per query
                        self.bsi_batch_item_errors += 1

        # -- range counts: cache hits first, the rest in one count launch
        count_items = groups.get(astbatch.BSI_RANGE_COUNT, [])
        pending: list[tuple[int, Any]] = []
        puts: list = []
        for i, cond in count_items:
            keyed = self._range_count_key(idx, calls[i].children[0])
            cached, put = (
                self._bsi_agg_cache(field, bits, keyed[1]) if keyed is not None
                else (None, lambda v: None)
            )
            if cached is not None:
                results[i] = cached
            else:
                pending.append((i, cond))
                puts.append(put)
        queries = queries_of(pending) if pending else None
        if queries is not None:
            self.bsi_stack_launches += 1
            with tracing.start_span("executor.bsiRangeCountBatch").set_tag("n", len(pending)):
                counts = bsi.range_count_batch(planes, exists, sign, queries, depth=depth)
            for (i, _), put, n in zip(pending, puts, counts):
                put(n)
                results[i] = n

        sum_items = groups.get(astbatch.BSI_SUM, [])
        if sum_items:
            self._batch_bsi_sums(idx, field, bits, sum_items, shard_list, calls, results)

        # -- Min/Max: one cached scalar per (field, kind); each item fails
        # alone
        for op_class, maximal in ((astbatch.BSI_MIN, False), (astbatch.BSI_MAX, True)):
            for i, _ in groups.get(op_class, []):
                try:
                    results[i] = self._execute_min_max(idx, calls[i], shard_list, maximal)
                except Exception:  # the per-call path raises per query
                    self.bsi_batch_item_errors += 1

    def _batch_bsi_sums(
        self, idx: Index, field: Field, bits: torch.Tensor, sum_items, shard_list,
        calls: list[Call], results: list[Any],
    ) -> None:
        """Unfiltered Sums share the cached stacked aggregate; a lone
        filtered Sum takes one bsi_sum launch over its filter. Two or more
        filtered Sums are one flight (JAX's fused flight,
        executor.py:1844-1912): one bsi_sum_batch launch per filter source
        and chunk (:meth:`_sum_flight`)."""
        depth = field.bit_depth

        def compute(p, e, s, fw):
            return bsi.sum_host(p, e, s, fw, depth=depth)

        in_place: list[tuple[int, tuple[Field, int]]] = []
        made: list[tuple[int, Row]] = []
        for i, _ in sum_items:
            if not calls[i].children:
                tc = self._bsi_agg_serve(field, (bits, None, shard_list), "sum", compute)
                results[i] = self._sum_valcount(field, tc)
                continue
            row = self._sum_row_in_place(idx, calls[i])
            if row is not None:
                in_place.append((i, row))
            else:
                self._made_filter(idx, calls[i], shard_list, i, made)
        if len(in_place) + len(made) < 2:
            for i, _ in in_place:
                self._made_filter(idx, calls[i], shard_list, i, made)
            for i, filt in made:
                tc = self._bsi_agg_serve(field, (bits, filt, shard_list), "sum", compute)
                results[i] = self._sum_valcount(field, tc)
            return
        with tracing.start_span("executor.bsiSumBatch").set_tag(
            "n", len(in_place) + len(made)
        ):
            self._sum_flight(idx, field, bits, in_place, made, shard_list, calls, results)

    def _made_filter(self, idx: Index, call: Call, shard_list, i: int, made: list) -> None:
        """Evaluate a Sum's filter on the host into ``made``; a filter that
        fails leaves its item to the per-call path, which raises it."""
        try:
            made.append((i, self._sum_filter(idx, call, shard_list)))
        except Exception:
            self.bsi_batch_item_errors += 1

    @staticmethod
    def _sum_row_in_place(idx: Index, call: Call) -> tuple[Field, int] | None:
        """``(field, row id)`` when a Sum's one filter is a plain ``Row(f=r)``
        of a set-like field's standard view, which a resident stack of the
        field holds; None otherwise."""
        if len(call.children) != 1:
            return None
        rc = call.children[0]
        if rc.name != "Row" or rc.children:
            return None
        fname = rc.field_arg()
        if fname is None or set(rc.args) != {fname}:
            return None
        v = rc.args.get(fname)
        if not isinstance(v, int) or isinstance(v, bool) or v < 0:
            return None
        f = idx.field(fname)
        if f is None or f.is_bsi() or f.view(VIEW_STANDARD) is None:
            return None
        return f, v

    def _resident_stack(self, field: Field, shard_list: list[int], bits):
        """``(slot_of, stack)`` of the field's standard view over
        ``shard_list`` when it is cached already (patched first after
        writes), not declined and laid out as ``bits``; None otherwise. It
        never builds a stack that is not there."""
        if not self._stack_cached(field, shard_list):
            return None
        stack = self._field_stack(field, shard_list)
        if stack is None or stack is STACK_DECLINED:
            return None
        fbits = stack[1]
        if sharded.is_sharded(fbits) != sharded.is_sharded(bits):
            return None
        if sharded.is_sharded(bits) and (fbits.bounds, fbits.mesh) != (bits.bounds, bits.mesh):
            return None
        return stack

    def _sum_flight(
        self, idx: Index, field: Field, bits, in_place, made, shard_list,
        calls: list[Call], results: list[Any],
    ) -> None:
        """A flight of filtered Sums on one field. A ``Row(f=r)`` filter
        whose field has a resident stack is read there in place (its slot;
        -1 for an absent row), one launch per such field; every other
        filter is made on the host into ``[S, Q, W]`` words, uploaded from
        pinned memory in chunks of _BSI_SUM_FILTER_BUDGET_BYTES, one launch
        a chunk. A fault in a launch raises within the flight."""
        depth = field.bit_depth
        exists, sign, planes = self._bsi_split(bits)

        def launch(operand, slots, items):
            self.bsi_stack_launches += 1
            pairs = bsi.sum_batch_host(planes, exists, sign, operand, depth=depth, idx=slots)
            for i, tc in zip(items, pairs):
                results[i] = self._sum_valcount(field, tc)

        by_field: dict[Field, list[tuple[int, int]]] = {}
        for i, (f, row) in in_place:
            by_field.setdefault(f, []).append((i, row))
        for f, items in by_field.items():
            stack = self._resident_stack(f, shard_list, bits)
            if stack is None:
                for i, _ in items:
                    self._made_filter(idx, calls[i], shard_list, i, made)
                continue
            slot_of, fbits = stack
            launch(fbits, [slot_of.get(r, -1) for _, r in items], [i for i, _ in items])
        S, W = len(shard_list), self.holder.n_words
        per = max(1, self._BSI_SUM_FILTER_BUDGET_BYTES // (bits.shape[0] * W * 4))
        for q0 in range(0, len(made), per):
            chunk = made[q0 : q0 + per]
            host_t, host = bitops.pinned_words((S, len(chunk), W), bits.device)
            for q, (_, row) in enumerate(chunk):
                for si, s in enumerate(shard_list):
                    seg = row.segments.get(s)
                    if seg is not None:
                        host[si, q] = seg
            # a mesh's wrapper cuts the host words at the stack's bounds
            words = host_t if sharded.is_sharded(bits) else bitops.upload(host_t, bits.device)
            launch(words, list(range(len(chunk))), [i for i, _ in chunk])

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
        idx.add_column_existence(col)
        if field.is_bsi():
            value, ok = call.int_arg(fname)
            if not ok:
                raise ExecuteError("Set() row argument 'row' required")
            return field.set_value(col, value)
        row, ok = call.uint_arg(fname)
        if not ok:
            raise ExecuteError("Set() row argument 'row' required")
        ts = call.args.get("_timestamp")
        timestamp = timequantum.parse_time(ts) if ts is not None else None
        return field.set_bit(row, col, timestamp)

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
            # the column's value goes, whatever value the call names (the
            # JAX package's v1.3 behaviour)
            return field.clear_value(col)
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

    def _execute_store(self, idx: Index, call: Call, shards: list[int] | None) -> bool:
        """Store(child, f=row): the child's bitmap written as the row, shard by
        shard (reference executor.go:1999-2067 executeSetRow); a missing
        field is created as a set field (executor.go:2016-2023)."""
        if len(call.children) != 1:
            raise ExecuteError("Store() requires a source query")
        fname = call.field_arg()
        if fname is None:
            raise ExecuteError("Store() argument required: field")
        field = idx.field(fname)
        if field is None:
            field = idx.create_field(fname)
        row = call.args.get(fname)
        if not isinstance(row, int) or isinstance(row, bool):
            raise ExecuteError("Store() requires a row argument")
        shards = self._shards_for(idx, shards)
        child = self._bitmap_call(idx, call.children[0], shards)
        view = field.create_view_if_not_exists(VIEW_STANDARD)
        changed = False
        for shard in shards:
            seg = child.segments.get(shard)
            words = (
                np.zeros(field.n_words, dtype=np.uint32) if seg is None else np.asarray(seg)
            )
            changed |= view.create_fragment_if_not_exists(shard).set_row_words(row, words)
        return changed

    @staticmethod
    def _execute_set_row_attrs(idx: Index, call: Call) -> None:
        fname, ok = call.string_arg("_field")
        field = idx.field(fname) if ok else None
        if field is None:
            raise FieldNotFoundError("SetRowAttrs() field not found")
        row, ok = call.uint_arg("_row")
        if not ok:
            raise ExecuteError("SetRowAttrs() row required")
        field.row_attrs.set_attrs(
            row, {k: v for k, v in call.args.items() if k not in ("_field", "_row")}
        )
        return None

    @staticmethod
    def _execute_set_column_attrs(idx: Index, call: Call) -> None:
        col, ok = call.uint_arg("_col")
        if not ok:
            raise ExecuteError("SetColumnAttrs() column required")
        idx.column_attrs.set_attrs(col, {k: v for k, v in call.args.items() if k != "_col"})
        return None

    # --------------------------------------------------------------- Options

    def _execute_options(self, idx: Index, call: Call, shards: list[int] | None) -> Any:
        """reference executor.go:344-406 executeOptionsCall."""
        if len(call.children) != 1:
            raise ExecuteError("Options() requires exactly one child")
        exclude_columns, _ = call.bool_arg("excludeColumns")
        exclude_row_attrs, _ = call.bool_arg("excludeRowAttrs")
        column_attrs, _ = call.bool_arg("columnAttrs")
        shards_arg, has_shards = call.uint_slice_arg("shards")
        if has_shards:
            shards = shards_arg
        result = self._execute_call(idx, call.children[0], shards)
        if isinstance(result, Row):
            if exclude_columns:
                result.segments = {}
            if exclude_row_attrs:
                result.attrs = {}
            if column_attrs:
                result.attrs["columnattrs"] = [
                    {"id": int(c), "attrs": idx.column_attrs.attrs(int(c))}
                    for c in result.columns()
                    if idx.column_attrs.attrs(int(c))
                ]
        return result

    # ------------------------------------------------------------------ TopN

    def _execute_topn(self, idx: Index, call: Call, shards: list[int] | None) -> list[Pair]:
        """Exact TopN (reference executor.go:860-999). A filtered TopN runs
        the masked row scan over the field's stack (plus the row scan for
        tanimoto row totals), or, when the budget declines the stack, once
        per fragment over its rows (:meth:`_topn_per_fragment`); an
        unfiltered one merges the maintained per-fragment counts on the
        host."""
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
        n, _ = call.uint_arg("n")
        ids_arg, has_ids = call.uint_slice_arg("ids")
        threshold, has_threshold = call.uint_arg("threshold")
        if not has_threshold or threshold == 0:
            threshold = DEFAULT_MIN_THRESHOLD
        tanimoto, has_tanimoto = call.uint_arg("tanimotoThreshold")
        if has_tanimoto and tanimoto > 100:
            raise ExecuteError("Tanimoto Threshold is from 1 to 100 only")
        attr_name, _ = call.string_arg("attrName")
        attr_values = call.args.get("attrValues")

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
            if stack is STACK_DECLINED:
                self._topn_per_fragment(view, src, shards, has_tanimoto, counts, row_totals)
            elif stack is not None:
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
        if attr_name:
            # rows whose attribute is set (to one of attrValues, when given)
            wanted = set(attr_values) if isinstance(attr_values, list) else set()
            keep = {}
            for rid, c in counts.items():
                av = field.row_attrs.attrs(rid).get(attr_name)
                if av is not None and (not wanted or av in wanted):
                    keep[rid] = c
            counts = keep
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
    def _topn_per_fragment(view, src: Row, shards, has_tanimoto: bool, counts, row_totals):
        """A filtered TopN without a stack (JAX executor.py:2926-2960): per
        fragment, the masked row scan at S = 1 over the fragment's rows
        (its device copy, or rows paged from the mirror when the fragment
        is declined) and the filter's segment. Tanimoto row totals sum the
        maintained counts of every shard a row is in, filtered or not."""
        for shard in shards:
            frag = view.fragment(shard)
            if frag is None:
                continue
            ids, row_counts = frag.row_counts()
            if has_tanimoto:
                for rid, t in zip(ids, row_counts.tolist()):
                    row_totals[rid] = row_totals.get(rid, 0) + t
            seg = src.segments.get(shard)
            if seg is None or not ids:
                continue
            rows = frag.rows_device(ids)
            mc = kernels.masked_row_counts(
                rows[None], bitops.to_device(seg, rows.device)[None]
            )
            for rid, c in zip(ids, mc.tolist()):
                if c:
                    counts[rid] = counts.get(rid, 0) + c

    # ------------------------------------------------------------------ Rows

    @staticmethod
    def _rows_of_field(
        field: Field, shards: list[int], views: list[str] | None = None
    ) -> list[int]:
        """Sorted distinct row ids with at least one bit in the standard
        view, or in any of ``views`` (reference fragment.go:2601-2712
        rows())."""
        ids: set[int] = set()
        for vname in [VIEW_STANDARD] if views is None else views:
            v = field.view(vname)
            if v is None:
                continue
            for shard in shards:
                frag = v.fragment(shard)
                if frag is None:
                    continue
                rids, counts = frag.row_counts()
                ids.update(r for r, c in zip(rids, counts.tolist()) if c > 0)
        return sorted(ids)

    def _execute_rows(
        self, idx: Index, call: Call, shards: list[int] | None
    ) -> RowIdentifiers:
        """reference executor.go:1277-1442 executeRows, over the standard
        view or, with ``from``/``to``, the views of the time cover."""
        shards = self._shards_for(idx, shards)
        fname, ok = call.string_arg("_field")
        if not ok:
            raise ExecuteError("Rows() field required")
        field = idx.field(fname)
        if field is None:
            raise FieldNotFoundError(f"field not found: {fname}")
        views = self._rows_views(field, call)
        ids = self._rows_of_field(field, shards, views)

        col = call.args.get("column")
        if col is not None:
            col = self._maybe_translate_col(idx, col)
            shard, off = divmod(col, field.n_words * 32)
            present: set[int] = set()
            for vname in [VIEW_STANDARD] if views is None else views:
                v = field.view(vname)
                frag = v.fragment(shard) if v is not None else None
                if frag is not None:
                    present.update(frag.rows_with_column(off))
            ids = [r for r in ids if r in present]

        prev, has_prev = call.uint_arg("previous")
        if has_prev:
            ids = [r for r in ids if r > prev]
        limit, has_limit = call.uint_arg("limit")
        if has_limit:
            ids = ids[:limit]
        return RowIdentifiers(rows=ids)

    def _rows_views(self, field: Field, call: Call) -> list[str] | None:
        """The time cover of a Rows() with ``from``/``to`` (reference
        executor.go:1342-1402); None without them."""
        from_arg = call.args.get("from")
        to_arg = call.args.get("to")
        if from_arg is None and to_arg is None:
            return None
        cover = self._view_cover(field, from_arg, to_arg)
        return [] if cover is None else cover

    def _maybe_translate_col(self, idx: Index, col) -> int:
        if isinstance(col, str):
            if not idx.keys:
                raise ExecuteError("string column on unkeyed index")
            return self.translator.translate_key(idx.name, "", col)
        return int(col)

    # --------------------------------------------------------------- GroupBy

    def _execute_groupby(
        self, idx: Index, call: Call, shards: list[int] | None,
        filt_row: Row | None = None,
    ) -> list[GroupCount]:
        """reference executor.go:1071-1275: the cross product of the Rows()
        children in row order, each combination counted over the
        intersection of its rows (and the filter), zero counts dropped.
        Every combination is counted on the stacks; a `previous` page is
        the answer's combinations after the bound (row order is the
        answer's order), and `limit` cuts what is left. When the budget
        declines a level's stack, the recursive cross product on the host
        mirrors answers instead (:meth:`_groupby_recursive`). ``filt_row``,
        when given, is the filter's row already evaluated (by the batched
        BSI lane)."""
        shards = self._shards_for(idx, shards)
        if not call.children:
            raise ExecuteError("GroupBy requires at least one Rows() child")
        for c in call.children:
            if c.name != "Rows":
                raise ExecuteError("GroupBy children must be Rows queries")
        limit, has_limit = call.uint_arg("limit")
        filt_call, has_filt = call.call_arg("filter")
        previous, has_prev = call.uint_slice_arg("previous")
        if has_prev and len(previous) != len(call.children):
            raise ExecuteError(
                "'previous' argument must have a value for each GroupBy field"
            )
        if has_filt and filt_row is None:
            filt_row = self._bitmap_call(idx, filt_call, shards)

        levels = []
        for c in call.children:
            fname = c.args.get("_field")
            field = idx.field(fname)
            if field is None:
                raise FieldNotFoundError(f"field not found: {fname}")
            levels.append((fname, field, self._execute_rows(idx, c, shards).rows))

        if any(not rows for _, _, rows in levels):
            return []
        if len(levels) == 1:
            out = self._groupby_one_level(levels[0], shards, filt_row)
        elif len(levels) == 2 and filt_row is None:
            out = self._groupby_two_level_batch(levels, shards)
        else:
            out = self._groupby_k_level_batch(levels, shards, filt_row)
        if out is None:  # a level's stack was declined
            return self._groupby_recursive(
                levels, shards, filt_row, previous if has_prev else None,
                limit if has_limit and limit > 0 else 0,
            )
        if has_prev:
            bound = tuple(previous)
            out = out[bisect.bisect_right(
                out, bound, key=lambda gc: tuple(fr.row_id for fr in gc.group)
            ):]
        return out[:limit] if has_limit and limit > 0 else out

    def _groupby_one_level(
        self, level, shards: list[int], filt_row: Row | None
    ) -> list[GroupCount]:
        """Each row's count over ``shards``: the row scan (or a cached
        gram's diagonal), the masked row scan under a filter; None when
        the stack is declined. A row the standard view lacks (named by a
        time window's views) counts 0, as in every GroupBy engine here."""
        fname, field, rows = level
        stack = self._field_stack(field, shards)
        if stack is STACK_DECLINED:
            return None
        if stack is None:
            return []
        slot_of, bits = stack
        rows = [r for r in rows if r in slot_of]
        if filt_row is None:
            counts = self._stack_row_counts(field, bits)
        else:
            S, _, W = bits.shape
            filt = self._row_to_shard_matrix(filt_row, shards, S, W)
            counts = kernels.masked_row_counts(bits, bitops.to_device(filt, bits.device))
        return [
            GroupCount(group=[FieldRow(field=fname, row_id=r)], count=int(counts[slot_of[r]]))
            for r in rows
            if counts[slot_of[r]] > 0
        ]

    def _groupby_two_level_batch(self, levels, shards: list[int]) -> list[GroupCount]:
        """Every (row1, row2) combination count of an unfiltered two-level
        GroupBy from one gram (one field) or one cross gram (two fields),
        or the batched pair scans when the gram declines; None when a
        stack is declined."""
        (f1name, f1, rows1), (f2name, f2, rows2) = levels
        s1 = self._field_stack(f1, shards)
        s2 = self._field_stack(f2, shards) if f2 is not f1 else s1
        if s1 is STACK_DECLINED or s2 is STACK_DECLINED:
            return None
        if s1 is None or s2 is None:
            return []
        (slot1, bits1), (slot2, bits2) = s1, s2
        rows1 = [r for r in rows1 if r in slot1]
        rows2 = [r for r in rows2 if r in slot2]
        if not rows1 or not rows2:
            return []
        sub1 = [slot1[r] for r in rows1]
        sub2 = [slot2[r] for r in rows2]
        with tracing.start_span("executor.groupByBatch").set_tag("n", len(sub1) * len(sub2)):
            counts2d = None
            if f2 is f1:
                g, pos = self._field_gram(f1, bits1, sorted(set(sub1) | set(sub2)))
                if g is not None:
                    counts2d = g[np.ix_([pos[s] for s in sub1], [pos[s] for s in sub2])]
            else:
                counts2d = self._cross_gram(f1, bits1, f2, bits2, sub1, sub2)
            if counts2d is not None:
                counts = counts2d.reshape(-1)
            else:
                # more distinct rows than the gram takes: per-shard
                # partials of every combination, summed in int64
                ras = np.repeat(sub1, len(sub2))
                rbs = np.tile(sub2, len(sub1))
                if f2 is f1:
                    partials = kernels.pair_count_batched(bits1, ras, rbs)
                else:
                    partials = kernels.pair_count_two_batched(bits1, bits2, ras, rbs)
                counts = partials.to(torch.int64).sum(dim=1).cpu().numpy()
        out = []
        combos = ((r1, r2) for r1 in rows1 for r2 in rows2)
        for (r1, r2), c in zip(combos, counts.tolist()):
            if c > 0:
                out.append(GroupCount(
                    group=[FieldRow(field=f1name, row_id=r1),
                           FieldRow(field=f2name, row_id=r2)],
                    count=int(c),
                ))
        return out

    def _groupby_prefix_budget(self, device: torch.device) -> int:
        """Bytes of ``[C, S, W]`` prefix masks the k-level GroupBy may hold
        at once: half of what the device can still hand out, read at call
        time (on a card the free memory it reports plus PyTorch's cached,
        unused blocks; on the host its available pages). A fixed figure
        would either cut a filtered or 3-level GroupBy at the serving size
        (21 MB per mask) into many small launches or overrun a smaller
        device."""
        if device.type != "cuda":
            return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE") // 2
        free, _ = torch.cuda.mem_get_info(device)
        cached = torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
        return (free + cached) // 2

    def _groupby_k_level_batch(
        self, levels, shards: list[int], filt_row: Row | None
    ) -> list[GroupCount]:
        """All k-level combination counts, one cross-gram launch per level
        and piece: keep ``[C, S, W]`` intersection masks of the surviving
        combinations, count every (combination, next row) pair at once,
        drop the empty ones, refine. The survivors of a level are taken
        in pieces of at most ``cmax`` (and GRAM_MAX_ROWS) masks, depth
        first, so the masks held at once (one piece per level plus one
        temporary) stay within the prefix budget. Matches the reference's
        semantics (executor.go:3057-3230): DFS row order, each count over
        all levels and the filter. None when a level's stack is declined."""
        stacks = []
        for _, f, _ in levels:
            st = self._field_stack(f, shards)
            if st is STACK_DECLINED:
                return None
            stacks.append(st)
        if any(st is None for st in stacks):
            return []
        levels = [(n, f, [r for r in rows if r in st[0]])
                  for (n, f, rows), st in zip(levels, stacks)]
        if any(not rows for _, _, rows in levels):
            return []
        slot0, bits0 = stacks[0]
        if kernels.stack_spans_processes(bits0):
            # the combo counts are per-shard partials, not all here across
            # processes: the recursive path serves, as in JAX
            return None
        S, _, W = bits0.shape
        budget = self._groupby_prefix_budget(bits0.device)
        cmax = max(1, min(kernels.GRAM_MAX_ROWS, budget // (S * W * 4 * len(levels))))
        filt = None
        if filt_row is not None:
            filt = bitops.to_device(
                self._row_to_shard_matrix(filt_row, shards, S, W), bits0.device
            )
        out: list[GroupCount] = []

        def expand(li: int, prefix: torch.Tensor, combos: list[tuple[int, ...]]):
            slotL, bitsL = stacks[li]
            rows = levels[li][2]
            idxL = [slotL[r] for r in rows]
            counts = kernels.combo_counts_gram(prefix, bitsL, idxL)
            if counts is None:
                counts = (
                    kernels.combo_counts(prefix, bitsL, idxL)
                    .to(torch.int64).sum(dim=2).cpu().numpy()
                )
            live = np.argwhere(counts > 0)  # row-major: DFS order
            if li == len(levels) - 1:
                out.extend(
                    GroupCount(
                        group=[
                            FieldRow(field=levels[k][0], row_id=rid)
                            for k, rid in enumerate(combos[ci] + (rows[ri],))
                        ],
                        count=int(counts[ci, ri]),
                    )
                    for ci, ri in live
                )
                return
            for p0 in range(0, len(live), cmax):
                part = live[p0 : p0 + cmax]
                child = kernels.refine_prefix(
                    prefix, bitsL, part[:, 0], [idxL[ri] for ri in part[:, 1]]
                )
                expand(li + 1, child, [combos[ci] + (rows[ri],) for ci, ri in part])
                del child

        rows0 = levels[0][2]
        with tracing.start_span("executor.groupByKLevel").set_tag("levels", len(levels)):
            for p0 in range(0, len(rows0), cmax):
                part = rows0[p0 : p0 + cmax]
                prefix = kernels.gather_prefix(bits0, [slot0[r] for r in part])
                if filt is not None:
                    # in place: the prefix is this call's own copy
                    kernels.mask_prefix(prefix, filt)
                expand(1, prefix, [(r,) for r in part])
                del prefix
        return out

    def _groupby_recursive(
        self, levels, shards: list[int], filt_row: Row | None,
        previous: list[int] | None, limit: int,
    ) -> list[GroupCount]:
        """The depth-first cross product in row order on the host mirrors
        (JAX executor.py:3128-3175), for a GroupBy whose stacks the budget
        declined: each level's row read once, each combination intersected
        with its prefix (and the filter) and counted; combinations up to
        the `previous` bound skipped, at most ``limit`` kept (0: all)."""
        results: list[GroupCount] = []
        row_cache: dict[tuple[int, int], Row] = {}

        def level_row(level: int, rid: int) -> Row:
            key = (level, rid)
            if key not in row_cache:
                row_cache[key] = self._field_row(levels[level][1], rid, shards)
            return row_cache[key]

        def done() -> bool:
            return limit > 0 and len(results) >= limit

        def recurse(level: int, acc: Row | None, group: list[FieldRow], on_bound: bool):
            """``on_bound``: the prefix equals the bound's, so rows before
            the bound are skipped and the bound combination itself too
            (reference executor.go:3127-3156 paging)."""
            fname, _, row_ids = levels[level]
            is_last = level + 1 == len(levels)
            for rid in row_ids:
                if done():
                    return
                bound_here = False
                if on_bound:
                    b = previous[level]
                    if rid < b or (rid == b and is_last):
                        continue
                    bound_here = rid == b
                row = level_row(level, rid)
                cur = row if acc is None else acc.intersect(row)
                g = group + [FieldRow(field=fname, row_id=rid)]
                if not is_last:
                    recurse(level + 1, cur, g, bound_here)
                    continue
                final = cur if filt_row is None else cur.intersect(filt_row)
                cnt = final.count()
                if cnt > 0:
                    results.append(GroupCount(group=g, count=cnt))

        recurse(0, None, [], previous is not None)
        return results

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
