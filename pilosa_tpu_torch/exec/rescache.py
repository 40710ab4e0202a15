"""Semantic result cache with version-precise invalidation (counterpart
of ``pilosa_tpu/exec/rescache.py``).

The cache answers a repeated read query without re-dispatching kernels
when — and only when — none of the fragments the query reads have
changed.  An entry is keyed by the *semantics* of the call (canonical
serialization of the translated AST, commutative children sorted), the
shard restriction, and the index's schema generation; its validity is
carried by a **version vector**: the sorted tuple of
``(field, view, shard, epoch, version)`` over every fragment the call
can read.  ``Fragment.version`` is bumped on every point write, bulk
import, and host-row load and never resets (snapshot compaction resets
the op log, not the version), and ``Fragment.epoch`` is process-unique
per fragment object, so a shard that migrates away and back during a
resize can never alias an old vector.

Invalidation is therefore *precise and lazy*: a lookup recomputes the
current vector and a mismatch is a miss (counted as an invalidation —
the stale entry is dropped).  Writes additionally invalidate *eagerly*
through :meth:`ResultCache.note_write`, which drops only the entries
whose field set intersects the written field — this is what keeps
attribute writes (``SetRowAttrs``), which do not bump fragment
versions, from serving stale attrs, and what makes the
``rescache_invalidations`` metric mean "entries a write actually
killed", never "cache cleared".

Hot TopN/GroupBy entries **promote** to maintained views: instead of
dropping on a version mismatch, a promoted entry refreshes itself
through its ``recompute`` closure — for unfiltered TopN that closure
re-merges the per-fragment maintained row counts (``Fragment._counts``,
updated by ingest in the same group-commit as the bits), which costs a
host reduce, not a device launch.  When the accumulated write delta
(the version-sum drift since promotion) exceeds ``demote_deltas`` the
entry demotes back to ordinary cache-on-miss and the next miss rebuilds
it from scratch.

Thread safety: one lock around the table; results are copied on hit
(:func:`copy_result`) so callers can attach keys/attrs without
mutating the cached object. Cached results are host objects; the copy
takes every numpy array (and tensor) a ``Row`` holds too, so a caller that
writes into its copy's words changes nothing in the cache.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable

import torch

from pilosa_tpu_torch.core.index import Index
from pilosa_tpu_torch.exec.result import (
    FieldRow,
    GroupCount,
    Pair,
    Row,
    RowIdentifiers,
    ValCount,
)
from pilosa_tpu_torch.obs import qprofile
from pilosa_tpu_torch.obs import stats as stats_mod
from pilosa_tpu_torch.pql.ast import Call

# Sentinel distinct from every result value (None and False are results).
MISS = object()

# Read-only call shapes whose results are a pure function of fragment
# contents + the translated AST.  Anything else (writes, Options,
# attr-driven shapes) bypasses the cache.
_CACHEABLE = {
    "All",
    "Count",
    "Difference",
    "GroupBy",
    "Intersect",
    "Max",
    "MaxRow",
    "Min",
    "MinRow",
    "Not",
    "Range",
    "Row",
    "Rows",
    "Sum",
    "TopN",
    "Union",
    "Xor",
}

# Children of these ops are order-independent: canonical form sorts them
# so Intersect(A, B) and Intersect(B, A) share one entry.
_COMMUTATIVE = {"Intersect", "Union", "Xor"}

# Calls whose result depends on row/column attributes, which live
# outside the fragment version space.  TopN(attrName=...) filters by
# attrs; never cache it.
_ATTR_ARGS = ("attrName", "attrValues")

_EXISTENCE = "_exists"


def canonical_str(call: Call) -> str:
    """Deterministic serialization of a call: args render sorted-key
    (``Call.__str__`` already guarantees that) and commutative children
    render in sorted canonical order."""
    kids = [canonical_str(c) for c in call.children]
    if call.name in _COMMUTATIVE:
        kids.sort()
    parts = list(kids)
    rendered = str(Call(call.name, call.args, []))
    inner = rendered[len(call.name) + 1 : -1]
    if inner:
        parts.append(inner)
    return f"{call.name}({', '.join(parts)})"


def subtree_key(idx: Index, call: Call) -> str | None:
    """Canonical CSE key for one subtree, or None when the subtree is
    not safely shareable — the exact cacheability rules whole-call
    entries use (recognized read-only shapes, no attr args), so a
    flight-shared operand (exec/planner.py) is valid under precisely
    the per-fragment version vector a cache entry would carry."""
    if collect_fields(idx, call) is None:
        return None
    return canonical_str(call)


def collect_fields(idx: Index, call: Call) -> set[str] | None:
    """The field names a call can read, or None when the call shape is
    not cacheable.  Conservative: an unrecognized name anywhere in the
    tree poisons the whole call."""
    if call.name not in _CACHEABLE:
        return None
    for a in _ATTR_ARGS:
        if a in call.args:
            return None
    fields: set[str] = set()
    if call.name in ("Not", "All"):
        # existence-backed shapes read the internal _exists field
        fields.add(_EXISTENCE)
    fv = call.args.get("_field")
    if isinstance(fv, str):
        fields.add(fv)
    f = call.args.get("field")
    if isinstance(f, str):
        fields.add(f)
    fa = call.field_arg()
    if fa is not None and idx.field(fa) is not None:
        fields.add(fa)
    for child in call.children:
        sub = collect_fields(idx, child)
        if sub is None:
            return None
        fields |= sub
    filt = call.args.get("filter")
    if isinstance(filt, Call):
        sub = collect_fields(idx, filt)
        if sub is None:
            return None
        fields |= sub
    return fields


def version_vector(
    idx: Index, fields: set[str], shards: list[int] | None
) -> tuple:
    """Sorted ``(field, view, shard, epoch, version)`` over every
    fragment the fields expose in the shard scope.  Covers ALL views of
    each field (time-quantum Range reads quantum views) — coarser than
    the minimal read set but always a superset, so staleness can only
    cause a spurious miss, never a stale hit."""
    scope = set(shards) if shards is not None else None
    vec = []
    for fname in fields:
        field = idx.field(fname)
        if field is None:
            continue
        for vname in sorted(field.views):
            view = field.views[vname]
            for shard, frag in sorted(view.fragments.items()):
                if scope is not None and shard not in scope:
                    continue
                vec.append((fname, vname, shard, frag.epoch, frag.version))
    return tuple(sorted(vec))


def _version_sum(vec: tuple) -> int:
    return sum(item[-1] for item in vec)


def _copy_words(seg):
    if isinstance(seg, torch.Tensor):
        return seg.clone()
    return seg.copy()


def copy_result(result: Any) -> Any:
    """A hit-side copy deep enough that neither the caller's result
    translation (keys/attrs attachment) nor a write into its words ever
    mutates the cached object: every segment array is copied."""
    if isinstance(result, Row):
        out = Row(
            {s: _copy_words(seg) for s, seg in result.segments.items()},
            result.n_words,
        )
        out.attrs = dict(result.attrs)
        return out
    if isinstance(result, Pair):
        return Pair(result.id, result.key, result.count)
    if isinstance(result, ValCount):
        return ValCount(result.value, result.count)
    if isinstance(result, RowIdentifiers):
        return RowIdentifiers(list(result.rows), None)
    if isinstance(result, GroupCount):
        return GroupCount(
            [FieldRow(g.field, g.row_id, None) for g in result.group],
            result.count,
        )
    if isinstance(result, list):
        return [copy_result(r) for r in result]
    # int / bool / None / str scalars
    return result


class _Token:
    """A cacheable miss: carries the key and the vector captured BEFORE
    execution, so a write landing mid-compute can never be masked (the
    stored vector predates it and the next lookup misses)."""

    __slots__ = ("key", "vector", "fields", "index_name")

    def __init__(self, key, vector, fields, index_name):
        self.key = key
        self.vector = vector
        self.fields = fields
        self.index_name = index_name


class _Entry:
    __slots__ = (
        "vector",
        "result",
        "hits",
        "fields",
        "index_name",
        "recompute",
        "maintained",
        "delta_accum",
    )

    def __init__(self, vector, result, fields, index_name, recompute):
        self.vector = vector
        self.result = result
        self.hits = 0
        self.fields = fields
        self.index_name = index_name
        self.recompute = recompute
        self.maintained = False
        self.delta_accum = 0


class ResultCache:
    """Bounded (LRU) semantic result cache.  One instance per Executor;
    the distributed layer reuses it for per-owner partials through the
    ``*_raw`` entry points."""

    def __init__(
        self,
        entries: int = 512,
        promote_hits: int = 3,
        demote_deltas: int = 64,
        stats=None,
        stats_fn: Callable[[], Any] | None = None,
    ):
        self.max_entries = int(entries)
        self.promote_hits = int(promote_hits)
        self.demote_deltas = int(demote_deltas)
        # stats_fn defers the client read: the holder installs its real
        # client after the executor (and this cache) are constructed
        self._stats = stats if stats is not None else stats_mod.NOP
        self._stats_fn = stats_fn
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, _Entry]" = OrderedDict()
        # (index, field) -> set of entry keys reading that field, for
        # eager write invalidation
        self._by_field: dict[tuple[str, str], set] = {}
        self.hits = 0
        self.misses = 0
        self.invalidations = 0
        self.promotions = 0
        self.demotions = 0
        self.maintained_hits = 0
        self.degraded_hits = 0
        self.stores = 0
        self.evictions = 0

    @property
    def stats(self):
        return self._stats_fn() if self._stats_fn is not None else self._stats

    def set_stats(self, client) -> None:
        self._stats = client
        self._stats_fn = None

    # ------------------------------------------------------ key plumbing

    @staticmethod
    def _key(idx: Index, call: Call, shards: list[int] | None) -> tuple:
        return (
            idx.name,
            idx.seq,
            idx.generation,
            canonical_str(call),
            tuple(sorted(shards)) if shards is not None else None,
        )

    # ----------------------------------------------------------- lookups

    def lookup(
        self, idx: Index, call: Call, shards: list[int] | None
    ) -> tuple[Any, _Token | None]:
        """Returns ``(result, None)`` on a hit, ``(MISS, token)`` on a
        cacheable miss (pass the token to :meth:`store` after
        computing), and ``(MISS, None)`` when the call is uncacheable."""
        fields = collect_fields(idx, call)
        if not fields:
            return MISS, None
        vec = version_vector(idx, fields, shards)
        if not vec:
            return MISS, None
        key = self._key(idx, call, shards)
        with qprofile.span("rescache.lookup", call=call.name):
            return self._probe_locked(key, vec, fields, idx.name)

    def lookup_stale(
        self, idx: Index, call: Call, shards: list[int] | None
    ) -> Any:
        """Degraded-tier lookup (server/qos.py pressure stage 2): the
        LAST-KNOWN result for this exact canonical call, version check
        waived.  Maintained entries refresh through writes, so the
        served answer is usually current anyway; a plain entry may be
        stale — that is the explicit contract of the degraded tier and
        the response is marked.  Never mutates promotion/invalidation
        bookkeeping: the degraded path must not distort the cache's
        steady-state policy.  Returns :data:`MISS` when no entry
        exists."""
        key = self._key(idx, call, shards)
        with qprofile.span("rescache.lookupStale", call=call.name):
            with self._lock:
                entry = self._entries.get(key)
                if entry is None:
                    return MISS
                self.degraded_hits += 1
                self.stats.count("rescache_degraded_hits", 1)
                return copy_result(entry.result)

    def probe_raw(self, key: tuple, vector: tuple) -> Any:
        """Distributed partial probe: explicit key + precomputed vector
        (which the caller captured before dispatch).  Returns the
        result or :data:`MISS`."""
        with qprofile.span("rescache.lookup", raw=True):
            res, _tok = self._probe_locked(key, vector, None, None)
        return res

    def _probe_locked(self, key, vec, fields, index_name):
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and entry.vector == vec:
                self._entries.move_to_end(key)
                entry.hits += 1
                self.hits += 1
                self.stats.count("rescache_hits", 1)
                if (
                    entry.recompute is not None
                    and not entry.maintained
                    and entry.hits >= self.promote_hits
                ):
                    entry.maintained = True
                    self.promotions += 1
                    self.stats.count("rescache_promotions", 1)
                return copy_result(entry.result), None
            if entry is not None:
                # stale — refresh maintained entries in place, drop the
                # rest (that drop IS the precise invalidation)
                refreshed = self._refresh_locked(key, entry, vec)
                if refreshed is not MISS:
                    return refreshed, None
            self.misses += 1
            self.stats.count("rescache_misses", 1)
            return MISS, _Token(key, vec, fields, index_name)

    def _refresh_locked(self, key, entry: _Entry, vec) -> Any:
        """Serve a promoted entry through a version change by
        recomputing from the maintained counts; demote when the write
        drift exceeds the rebuild threshold.  Returns MISS when the
        entry was dropped instead."""
        if entry.maintained and entry.recompute is not None:
            drift = _version_sum(vec) - _version_sum(entry.vector)
            entry.delta_accum += max(drift, 1)
            if entry.delta_accum <= self.demote_deltas:
                recompute = entry.recompute
                # recompute outside the lock: it reads fragments, which
                # may contend with writers holding fragment locks
                self._lock.release()
                try:
                    fresh = recompute()
                except Exception:
                    fresh = None
                finally:
                    self._lock.acquire()
                if fresh is not None and self._entries.get(key) is entry:
                    entry.result = fresh
                    entry.vector = vec
                    entry.hits += 1
                    self.maintained_hits += 1
                    self.hits += 1
                    self.stats.count("rescache_hits", 1)
                    self.stats.count("rescache_maintained_hits", 1)
                    return copy_result(fresh)
                return MISS
            self.demotions += 1
            self.stats.count("rescache_demotions", 1)
        self._drop_locked(key, entry)
        self.invalidations += 1
        self.stats.count("rescache_invalidations", 1)
        return MISS

    # ------------------------------------------------------------ stores

    def store(
        self,
        token: _Token,
        result: Any,
        recompute: Callable[[], Any] | None = None,
    ) -> None:
        """Install a computed result under the pre-execution vector the
        token captured."""
        if token is None or isinstance(result, BaseException):
            return
        entry = _Entry(
            token.vector, result, token.fields, token.index_name, recompute
        )
        self._install(token.key, entry)

    def store_raw(
        self,
        key: tuple,
        vector: tuple,
        result: Any,
        index_name: str | None = None,
        fields: set[str] | None = None,
    ) -> None:
        if isinstance(result, BaseException):
            return
        self._install(key, _Entry(vector, result, fields, index_name, None))

    def _install(self, key, entry: _Entry) -> None:
        with self._lock:
            old = self._entries.get(key)
            if old is not None:
                # keep promotion heat across rebuilds of the same key
                entry.hits = old.hits
                entry.maintained = old.maintained
                entry.recompute = entry.recompute or old.recompute
                self._drop_locked(key, old)
            self._entries[key] = entry
            if entry.fields and entry.index_name is not None:
                for fname in entry.fields:
                    self._by_field.setdefault(
                        (entry.index_name, fname), set()
                    ).add(key)
            self.stores += 1
            while len(self._entries) > self.max_entries:
                ev_key, ev_entry = self._entries.popitem(last=False)
                self._unindex_locked(ev_key, ev_entry)
                self.evictions += 1
                self.stats.count("rescache_evictions", 1)

    def _drop_locked(self, key, entry: _Entry) -> None:
        self._entries.pop(key, None)
        self._unindex_locked(key, entry)

    def _unindex_locked(self, key, entry: _Entry) -> None:
        if not entry.fields or entry.index_name is None:
            return
        for fname in entry.fields:
            keys = self._by_field.get((entry.index_name, fname))
            if keys is not None:
                keys.discard(key)
                if not keys:
                    del self._by_field[(entry.index_name, fname)]

    # ------------------------------------------------------ invalidation

    def note_write(self, index_name: str, field_name: str | None) -> None:
        """Eager, precise invalidation: drop exactly the entries whose
        field set intersects the written field (all of the index's
        entries when ``field_name`` is None — column-attr writes).
        Maintained entries survive — their next lookup refreshes from
        the maintained counts instead."""
        with self._lock:
            if field_name is None:
                keys = [
                    k
                    for (iname, _f), ks in self._by_field.items()
                    if iname == index_name
                    for k in ks
                ]
            else:
                keys = list(
                    self._by_field.get((index_name, field_name), ())
                )
            for key in keys:
                entry = self._entries.get(key)
                if entry is None or entry.maintained:
                    continue
                self._drop_locked(key, entry)
                self.invalidations += 1
                self.stats.count("rescache_invalidations", 1)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._by_field.clear()

    # ------------------------------------------------------ introspection

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def snapshot(self) -> dict:
        """The /debug/vars block (server/http.py r_debug_vars)."""
        with self._lock:
            maintained = sum(
                1 for e in self._entries.values() if e.maintained
            )
            return {
                "entries": len(self._entries),
                "maxEntries": self.max_entries,
                "hits": self.hits,
                "misses": self.misses,
                "invalidations": self.invalidations,
                "promotions": self.promotions,
                "demotions": self.demotions,
                "maintainedHits": self.maintained_hits,
                "maintainedEntries": maintained,
                "degradedHits": self.degraded_hits,
                "stores": self.stores,
                "evictions": self.evictions,
                "promoteHits": self.promote_hits,
                "demoteDeltas": self.demote_deltas,
            }
