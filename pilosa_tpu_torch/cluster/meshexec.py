"""Serve peer nodes' shards straight from this process, on the card
(counterpart of ``pilosa_tpu/cluster/meshexec.py``).

``DistributedExecutor`` relays a non-local shard group over HTTP unless
the owner node's holder lives in this process (``parallel/meshplace.py``).
For those owners this module provides the read-only holder facade that
makes their shards executable here: a ``MeshHolderView`` presents the
union of the coordinator's holder and each in-process owner's holder,
restricted to the shard assignment the placement plan computed, so a
plain ``exec.Executor`` built over the facade answers the whole partition
with the ported kernels: one ``uint32[S, R, W]`` stack per field over
every assigned shard, one launch per batch, no sockets.

The facade is read-only: writes never reach it (``cluster/dist.py``
routes every write through its replica-aware paths before mesh planning),
so none of the mutating holder, index or field methods are proxied. A
write goes through the owner's own executor and the facade executor never
sees the call: its stacks and result-cache entries are fenced by the
owners' fragment versions (``Fragment.epoch``, ``Fragment.version``),
which every read compares, never by write notes. A fragment's device
copy that the owner's uploader made on its side stream is read through
the fragment, which makes the reading stream wait for the copy's event
(``ops/streams.py``). The facade executor's stacks are admitted to the
process's device-memory budget (``core/membudget.default_budget``) under
budget keys of its own, beside the owners' stacks.

Identity matters for performance: the executor's stack caches are keyed
by field object (a ``WeakKeyDictionary``), so ``MeshIndex`` memoizes its
``MeshField`` facades (weak-referenceable and hashed by identity), and
``dist`` memoizes whole facade executors per shard assignment, which keeps
warm stacks across queries. Public attributes fall through to the
coordinator's own objects (``holder.device``, ``field.n_words``,
``field.bit_depth``, ``index.seq`` and the rest); underscore-prefixed
attributes are deliberately not delegated, so nothing private to one
object (a lock, a cache slot) can alias the base object's.
"""

from __future__ import annotations

import threading

from pilosa_tpu_torch.core.index import EXISTENCE_FIELD_NAME


class MeshView:
    """A view whose fragments resolve, per shard, to the ASSIGNED owner
    node's live fragment objects."""

    def __init__(self, name: str, owners: list[tuple]):
        # owners: [(real View, shards assigned to that owner), ...]
        self.name = name
        self._owners = owners
        self._view_by_shard = {s: v for v, sh in owners for s in sh}
        self._fragments: dict | None = None

    @property
    def fragments(self) -> dict:
        """The assigned shards' live fragments, gathered once per facade
        view: ``MeshField.view`` makes a fresh view for each lookup, and
        the executor reads ``fragments`` once per shard of a stack."""
        out = self._fragments
        if out is None:
            out = {}
            for s, v in self._view_by_shard.items():
                frag = v.fragments.get(s)
                if frag is not None:
                    out[s] = frag
            self._fragments = out
        return out

    def fragment(self, shard: int):
        return self.fragments.get(shard)

    def available_shards(self) -> set[int]:
        return set(self.fragments)

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._owners[0][0], name)


class MeshField:
    def __init__(self, base, owners: list[tuple]):
        # owners: [(real Field, shards assigned to that owner), ...] —
        # includes the coordinator's own field when it owns shards.
        self._base = base
        self._owners = owners

    def view(self, name: str) -> MeshView | None:
        got = [
            (v, sh)
            for v, sh in ((f.view(name), sh) for f, sh in self._owners)
            if v is not None
        ]
        if not got:
            return None
        return MeshView(name, got)

    @property
    def views(self) -> dict:
        names = {n for f, _ in self._owners for n in f.views}
        return {n: self.view(n) for n in sorted(names)}

    def view_names(self) -> list[str]:
        return sorted({n for f, _ in self._owners for n in f.views})

    def available_shards(self) -> set[int]:
        out: set[int] = set()
        for f, sh in self._owners:
            for v in f.views.values():
                out |= v.available_shards() & set(sh)
        return out

    def __getattr__(self, name: str):
        # Never delegate private attributes: the executor parks its
        # stack caches/locks in vars(field), and falling through to the
        # base field here would silently share (and corrupt) them.
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._base, name)


class MeshIndex:
    def __init__(self, base, owners: list[tuple]):
        # owners: [(real Index, shards assigned to that owner), ...]
        self._base = base
        self._owners = owners
        self._field_cache: dict[str, MeshField] = {}
        self._lock = threading.Lock()

    def field(self, name: str) -> MeshField | None:
        base_f = self._base.field(name)
        if base_f is None:
            return None
        with self._lock:
            mf = self._field_cache.get(name)
            if mf is not None and mf._base is base_f:
                return mf
        fowners = []
        complete = True
        for ix, sh in self._owners:
            f = ix.field(name)
            if f is None:
                # schema broadcast still in flight on that owner — serve
                # an uncached facade so the next call re-checks
                complete = False
            else:
                fowners.append((f, sh))
        mf = MeshField(base_f, fowners)
        if complete:
            with self._lock:
                self._field_cache[name] = mf
        return mf

    def existence_field(self) -> MeshField | None:
        return self.field(EXISTENCE_FIELD_NAME)

    @property
    def fields(self) -> dict:
        return {n: self.field(n) for n in list(self._base.fields)}

    def available_shards(self) -> set[int]:
        out: set[int] = set()
        for ix, sh in self._owners:
            out |= ix.available_shards() & set(sh)
        return out

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._base, name)


class MeshHolderView:
    """Read-only holder facade over a mesh partition.

    ``owners`` maps node id -> (holder, shards) for every node in the
    partition, INCLUDING the coordinator itself when it owns shards —
    folding the local group into the facade is what turns local + peer
    work into a single launch.
    """

    def __init__(self, base, owners: dict):
        self._base = base
        self._owners = owners
        self._index_cache: dict[str, MeshIndex] = {}
        self._lock = threading.Lock()

    def index(self, name: str) -> MeshIndex | None:
        base_idx = self._base.index(name)
        if base_idx is None:
            return None
        with self._lock:
            mi = self._index_cache.get(name)
            if mi is not None and mi._base is base_idx:
                return mi
        iowners = []
        complete = True
        for nid in sorted(self._owners):
            holder, shards = self._owners[nid]
            ix = holder.index(name)
            if ix is None:
                complete = False
            else:
                iowners.append((ix, frozenset(shards)))
        mi = MeshIndex(base_idx, iowners)
        if complete:
            with self._lock:
                self._index_cache[name] = mi
        return mi

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._base, name)
