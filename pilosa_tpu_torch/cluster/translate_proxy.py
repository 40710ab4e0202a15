"""Primary/replica key translation (reference: translate.go:91-97,

Counterpart of ``pilosa_tpu/cluster/translate_proxy.py``, the port's own copy.
cluster.go:1971-1996, holder.go:643-650).

The reference designates one node as translation primary; replicas
stream its append-only log and refuse new-key writes
(ErrTranslateStoreReadOnly, translate.go:52). Here non-primary nodes
forward new-key allocation to the primary over HTTP and cache the
returned mappings in their local store, so id→key result translation is
local after first use and replicas never allocate conflicting ids.
"""

from __future__ import annotations

from pilosa_tpu_torch.core.translate import TranslateStore


class PrimaryTranslateStore:
    """TranslateStore facade routing allocation to the cluster's
    translation primary."""

    def __init__(self, local: TranslateStore, cluster, client):
        self.local = local
        self.cluster = cluster
        self.client = client
        # replication cursor into the primary's entry log (reference
        # translate.go:91-97 log-position streaming)
        self._log_offset = 0

    def _is_primary(self) -> bool:
        primary = self.cluster.translate_primary()
        return (
            primary is None
            or primary.id == self.cluster.node_id
            or len(self.cluster.nodes) <= 1
        )

    def translate_keys(self, index: str, field: str, keys: list[str], create: bool = True) -> list[int]:
        if self._is_primary():
            return self.local.translate_keys(index, field, keys, create=create)
        # Serve fully-cached batches locally; otherwise ask the primary.
        cached = self.local.translate_keys(index, field, keys, create=False)
        if all(i != 0 for i in cached):
            return cached
        primary = self.cluster.translate_primary()
        ids = self.client.translate_keys(primary.uri, index, field or "", keys)
        self.local.set_mapping(index, field, keys, ids)
        return ids

    def translate_ids(self, index: str, field: str, id_list: list[int]) -> list[str]:
        out = self.local.translate_ids(index, field, id_list)
        if all(k != "" for k in out) or self._is_primary():
            return out
        primary = self.cluster.translate_primary()
        keys = self.client.translate_ids(primary.uri, index, field or "", id_list)
        # set_mapping drops ""-keyed entries, so unknown ids are re-asked
        # rather than cached as poison.
        self.local.set_mapping(index, field, keys, id_list)
        return keys

    def sync_from_primary(self) -> int:
        """Pull the primary's entry log since our cursor and apply it
        locally; returns the number of entries applied (the reference's
        replica log streaming, translate.go:91-97; carried here by the
        anti-entropy loop).  After a full sync every ids->keys read is
        local, the local ``.keys`` log holds a complete copy (set_mapping
        fires on_insert for each new entry), and this node can take over
        as primary with full state.  A restarted primary re-feeds its
        log from a possibly different offset base, so the cursor resets
        whenever it runs past the primary's log length."""
        if self._is_primary():
            return 0
        primary = self.cluster.translate_primary()
        applied = 0
        while True:
            entries, new_offset, log_len = self.client.translate_log(
                primary.uri, self._log_offset
            )
            if self._log_offset > log_len:
                # primary restarted with a shorter log: restart the feed
                # (applies are idempotent)
                self._log_offset = 0
                continue
            if not entries:
                return applied
            # batch contiguous (index, field) runs — one set_mapping
            # (and one on_insert disk append) per run, not per key,
            # matching the replay path's batching (translatelog.py)
            run: tuple[str, str] | None = None
            keys: list[str] = []
            ids: list[int] = []
            for index, field, key, id_ in entries:
                if (index, field) != run:
                    if run is not None:
                        self.local.set_mapping(run[0], run[1], keys, ids)
                    run = (index, field)
                    keys, ids = [], []
                keys.append(key)
                ids.append(id_)
            if run is not None:
                self.local.set_mapping(run[0], run[1], keys, ids)
            applied += len(entries)
            self._log_offset = new_offset

    def translate_key(self, index: str, field: str, key: str, create: bool = True) -> int:
        return self.translate_keys(index, field, [key], create=create)[0]

    def translate_id(self, index: str, field: str, id_: int) -> str:
        return self.translate_ids(index, field, [id_])[0]

    def to_dict(self) -> dict:
        return self.local.to_dict()

    def load_dict(self, d: dict) -> None:
        self.local.load_dict(d)
