"""String-key translation: key <-> uint64 id (counterpart of
``pilosa_tpu/core/translate.py``; reference: translate.go).

The reference's ``TranslateStore`` is an mmap'd append-only log with
in-memory hash indexes and primary/replica streaming (translate.go:55-66,
91-97). Here the same interface with an in-memory implementation; the
storage layer adds the append-only-log-backed store, and the cluster layer
adds primary/replica semantics (non-primary stores are read-only and raise
on new-key writes, reference translate.go:52 ErrTranslateStoreReadOnly).

Ids are allocated sequentially from 1 (0 is never a valid translated id).
Columns translate per index; rows per (index, field).
"""

from __future__ import annotations

import threading
import time

from pilosa_tpu_torch.obs import stats as stats_mod


# Process-global key-translation telemetry (a MemStatsClient, as in the
# JAX package): visible in /metrics and /debug/vars whatever stats client
# the holder runs. Counters: translate_keys_created / translate_keys_found /
# translate_ids_looked_up / translate_log_appends (the last fed by
# storage/translatelog.py); histogram: translate_lookup_seconds per
# translate_keys batch.
translate_stats = stats_mod.MemStatsClient()


def telemetry_snapshot() -> dict:
    """The key-translation block of ``/debug/vars``."""
    snap = translate_stats.snapshot()
    counters = snap["counters"]
    hist = snap["histograms"].get("translate_lookup_seconds")
    return {
        "keysCreated": counters.get("translate_keys_created", 0),
        "keysFound": counters.get("translate_keys_found", 0),
        "idsLookedUp": counters.get("translate_ids_looked_up", 0),
        "logAppends": counters.get("translate_log_appends", 0),
        "lookup": hist,
    }


class TranslateStoreReadOnlyError(Exception):
    pass


class TranslateStore:
    """In-memory bidirectional key map (reference inmem/translator.go:37)."""

    def __init__(self, read_only: bool = False):
        self._lock = threading.RLock()
        self.read_only = read_only
        # (index, field) -> key -> id; field "" means column keys.
        self._ids: dict[tuple[str, str], dict[str, int]] = {}
        self._keys: dict[tuple[str, str], list[str]] = {}
        # Called under the lock with the new (index, field, key, id)
        # mappings of one call, in order, before the call returns them:
        # the storage layer appends them to the on-disk log in one write
        # (reference translate.go:37-40 InsertColumn/InsertRow entries).
        self.on_insert = None  # fn([(index, field, key, id), ...])
        # Ordered in-memory entry log: every new mapping, in apply
        # order.  Replicas stream it by offset (the role of the
        # reference's log-position replication, translate.go:91-97);
        # disk replay rebuilds it in original append order.
        self.log: list[tuple[str, str, str, int]] = []

    def _space(self, index: str, field: str):
        ids = self._ids.setdefault((index, field), {})
        keys = self._keys.setdefault((index, field), [])
        return ids, keys

    def translate_keys(self, index: str, field: str, keys: list[str], create: bool = True) -> list[int]:
        """keys -> ids, allocating new ids as needed (reference
        translate.go TranslateColumnsToUint64 / TranslateRowsToUint64)."""
        t0 = time.perf_counter()
        created = 0
        with self._lock:
            ids, key_list = self._space(index, field)
            out = []
            log0 = len(self.log)
            try:
                for k in keys:
                    id_ = ids.get(k)
                    if id_ is None:
                        if not create:
                            out.append(0)
                            continue
                        if self.read_only:
                            raise TranslateStoreReadOnlyError(
                                "translate store is read-only (replica)"
                            )
                        id_ = len(key_list) + 1
                        ids[k] = id_
                        key_list.append(k)
                        created += 1
                        self.log.append((index, field, k, id_))
                    out.append(id_)
            finally:  # what was allocated is logged, even when a key raised
                self._inserted(log0)
        # telemetry outside the store lock: a scrape mid-batch must not
        # serialize against key allocation
        if created:
            translate_stats.count("translate_keys_created", created)
        found = len(keys) - created
        if found:
            translate_stats.count("translate_keys_found", found)
        translate_stats.timing("translate_lookup", time.perf_counter() - t0)
        return out

    def translate_ids(self, index: str, field: str, id_list: list[int]) -> list[str]:
        """ids -> keys; unknown ids map to "" (reference
        TranslateColumnToString)."""
        with self._lock:
            _, key_list = self._space(index, field)
            out = [
                key_list[i - 1] if 1 <= i <= len(key_list) else "" for i in id_list
            ]
        if id_list:
            translate_stats.count("translate_ids_looked_up", len(id_list))
        return out

    def translate_key(self, index: str, field: str, key: str, create: bool = True) -> int:
        return self.translate_keys(index, field, [key], create=create)[0]

    def translate_id(self, index: str, field: str, id_: int) -> str:
        return self.translate_ids(index, field, [id_])[0]

    def set_mapping(self, index: str, field: str, keys: list[str], id_list: list[int]) -> None:
        """Install key->id pairs allocated elsewhere (replica-side cache of
        the primary's log, reference translate.go replication :91-97).
        Bypasses read_only — this IS the replication write path."""
        with self._lock:
            ids, key_list = self._space(index, field)
            log0 = len(self.log)
            for k, i in zip(keys, id_list):
                if i <= 0 or k == "":
                    continue
                while len(key_list) < i:
                    key_list.append("")
                changed = key_list[i - 1] != k
                key_list[i - 1] = k
                ids[k] = i
                if changed:
                    self.log.append((index, field, k, i))
            self._inserted(log0)

    def _inserted(self, log0: int) -> None:
        """Hand the mappings logged since ``log0`` to ``on_insert`` (caller
        holds the lock)."""
        if self.on_insert is not None and len(self.log) > log0:
            self.on_insert(self.log[log0:])

    def log_entries(
        self, offset: int, limit: int = 50_000
    ) -> tuple[list[tuple[str, str, str, int]], int]:
        """(entries since ``offset``, new offset) — the replication feed
        a replica pulls to mirror this store (reference translate.go
        :91-97 log streaming).  Bounded by ``limit`` per pull so one
        request never ships an unbounded log."""
        with self._lock:
            chunk = self.log[offset : offset + limit]
            return chunk, offset + len(chunk)

    def log_len(self) -> int:
        with self._lock:
            return len(self.log)

    # -- persistence --------------------------------------------------------

    def to_dict(self) -> dict:
        with self._lock:
            return {
                "|".join(k): list(v) for k, v in self._keys.items()
            }

    def load_dict(self, d: dict) -> None:
        with self._lock:
            self._ids.clear()
            self._keys.clear()
            self.log = []
            for joined, key_list in d.items():
                index, _, field = joined.partition("|")
                self._keys[(index, field)] = list(key_list)
                self._ids[(index, field)] = {
                    k: i + 1 for i, k in enumerate(key_list)
                }
                # synthetic (id-ordered per space) log: a snapshot has no
                # append order, but the feed must still be complete
                self.log.extend(
                    (index, field, k, i + 1)
                    for i, k in enumerate(key_list)
                    if k
                )
