"""On-disk holder directory tree (counterpart of ``pilosa_tpu/storage/disk.py``;
reference: holder.go:134-198 Open walks
index -> field -> view -> fragment dirs; index.go:183-222 / field.go:525-548
persist .meta; attr stores in boltdb files; translate .keys log).

Layout under a data directory:

    <data>/.id                          node id (reference holder.go:599-619)
    <data>/.keys                        key translation log (a legacy
                                        .keys.json migrates on first open)
    <data>/<index>/.meta.json           index options
    <data>/<index>/.attrs/b<block>.json column attrs, one file per 100-id
                                        block (reference boltdb buckets,
                                        boltdb/attrstore.go:37-90; a
                                        legacy whole-store .attrs.json
                                        migrates on first open)
    <data>/<index>/<field>/.meta.json   field options (+ bit depth/base)
    <data>/<index>/<field>/.attrs/      row attrs, same block layout
    <data>/<index>/<field>/views/<view>/fragments/<shard>   roaring file

Fragments attach ``FragmentFile`` stores as they are created, so every
mutation lands in an op log immediately; ``sync()`` flushes metadata, and
snapshots compact op logs in the background (SnapshotQueue).
"""

from __future__ import annotations

import json
import os
import uuid

from pilosa_tpu_torch.core.field import Field, FieldOptions
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.core.index import Index
from pilosa_tpu_torch.core.translate import TranslateStore
from pilosa_tpu_torch.storage.fragmentfile import FragmentFile, SnapshotQueue
from pilosa_tpu_torch.storage.translatelog import TranslateLog


class AttrBlocksDir:
    """Per-block attr persistence backend: one ``b<block>.json`` per
    100-id block under a directory, so a flush touches only the blocks
    that changed and reads load lazily (the BoltDB+LRU role,
    reference boltdb/attrstore.go:37-90)."""

    def __init__(self, path: str):
        self.path = path

    def _file(self, bid: int) -> str:
        return os.path.join(self.path, f"b{bid}.json")

    def load_block(self, bid: int) -> dict | None:
        try:
            with open(self._file(bid)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def block_ids(self) -> list[int]:
        try:
            names = os.listdir(self.path)
        except OSError:
            return []
        out = []
        for n in names:
            if n.startswith("b") and n.endswith(".json"):
                try:
                    out.append(int(n[1:-5]))
                except ValueError:
                    continue
        return out

    def write_blocks(self, blocks: dict[int, dict]) -> None:
        """Write (or remove, when empty) exactly the given blocks;
        tmp+rename per file so a crash never leaves a torn block."""
        if not blocks:
            return
        os.makedirs(self.path, exist_ok=True)
        for bid, data in blocks.items():
            path = self._file(bid)
            if not data:
                try:
                    os.unlink(path)
                except OSError:
                    pass
                continue
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({str(k): v for k, v in data.items()}, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)


def _attach_attr_backend(store, dir_path: str, legacy_json: str) -> None:
    """Wire an AttrStore to its block dir, migrating a legacy
    whole-store .attrs.json once."""
    store.backend = AttrBlocksDir(dir_path)
    if os.path.exists(legacy_json):
        try:
            with open(legacy_json) as f:
                legacy = json.load(f)
            # MERGE into backend-loaded blocks (set_attrs loads each
            # block through the backend first): a legacy id landing in
            # a block that already has a b<N>.json must not clobber the
            # block's other ids
            store.set_bulk_attrs(
                {int(k): dict(v) for k, v in legacy.items()}
            )
            store.flush_dirty()
            os.unlink(legacy_json)
        except (OSError, ValueError):
            pass


class HolderStore:
    """Binds a Holder to a data directory. ``journal`` (an object with
    ``record(type, **data)``, or None) receives each snapshot's record."""

    def __init__(
        self, holder: Holder, path: str, snapshot_workers: int = 2, journal=None
    ):
        self.holder = holder
        self.path = path
        self.journal = journal
        self.translator = TranslateStore()
        self.translate_log: TranslateLog | None = None
        self.snapshot_queue = SnapshotQueue(workers=snapshot_workers)
        self._stores: list[FragmentFile] = []
        os.makedirs(path, exist_ok=True)
        holder.on_create_index = self._wire_index

    # -- paths --------------------------------------------------------------

    def _index_dir(self, index: str) -> str:
        return os.path.join(self.path, index)

    def _field_dir(self, index: str, field: str) -> str:
        return os.path.join(self.path, index, field)

    def _fragment_path(self, index: str, field: str, view: str, shard: int) -> str:
        return os.path.join(
            self._field_dir(index, field), "views", view, "fragments", str(shard)
        )

    # -- node id ------------------------------------------------------------

    def node_id(self) -> str:
        """Stable node id persisted to .id (reference holder.go:599-619)."""
        p = os.path.join(self.path, ".id")
        if os.path.exists(p):
            with open(p) as f:
                return f.read().strip()
        nid = uuid.uuid4().hex
        with open(p, "w") as f:
            f.write(nid)
        return nid

    # -- hook wiring --------------------------------------------------------

    def _wire_index(self, idx: Index) -> None:
        idx.on_create_field = self._wire_field
        for f in idx.fields.values():
            self._wire_field(idx, f)

    def _wire_field(self, idx: Index, field: Field) -> None:
        def on_fragment(view, shard):
            frag = view.fragments[shard]
            if frag.store is not None:
                return
            path = self._fragment_path(idx.name, field.name, view.name, shard)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            store = FragmentFile(
                frag, path, self.snapshot_queue, journal=self.journal
            )
            store.open()
            self._stores.append(store)

        field.on_create_fragment = on_fragment
        for view in field.views.values():
            view.on_create_fragment = on_fragment
            for shard, frag in view.fragments.items():
                if frag.store is None:
                    on_fragment(view, shard)

    # -- open/sync/close ----------------------------------------------------

    def open(self) -> None:
        """Walk the directory tree, rebuild schema + load every fragment
        (reference holder.go:134-198)."""
        # Key translation: append-only log (reference translate.go
        # TranslateFile .keys). A legacy .keys.json snapshot migrates into
        # the log on first open.
        legacy_path = os.path.join(self.path, ".keys.json")
        legacy = None
        if os.path.exists(legacy_path):
            with open(legacy_path) as f:
                legacy = json.load(f)
        self.translate_log = TranslateLog(
            self.translator, os.path.join(self.path, ".keys")
        )
        self.translate_log.open()
        if legacy is not None:
            # Migrate the legacy snapshot into the log, skipping mappings
            # the log replay already installed — a crash between append and
            # os.remove must not duplicate the whole snapshot on the next
            # open (replay is idempotent, but the log would grow unboundedly
            # across crash loops).
            replayed = self.translator.to_dict()
            for joined, key_list in legacy.items():
                index, _, field = joined.partition("|")
                have = replayed.get(joined, [])
                keys = [k for k in key_list if k != ""]
                ids = [i + 1 for i, k in enumerate(key_list) if k != ""]
                missing_k = []
                missing_i = []
                for k, i in zip(keys, ids):
                    if i > len(have) or have[i - 1] != k:
                        missing_k.append(k)
                        missing_i.append(i)
                # set_mapping installs in memory and (via on_insert, hooked
                # by translate_log.open) appends only the missing records.
                if missing_k:
                    self.translator.set_mapping(
                        index, field, missing_k, missing_i
                    )
            os.remove(legacy_path)
        for index_name in sorted(os.listdir(self.path)):
            index_dir = self._index_dir(index_name)
            meta_path = os.path.join(index_dir, ".meta.json")
            if not os.path.isdir(index_dir) or not os.path.exists(meta_path):
                continue
            with open(meta_path) as f:
                meta = json.load(f)
            idx = self.holder.create_index_if_not_exists(
                index_name,
                keys=meta.get("keys", False),
                track_existence=meta.get("trackExistence", True),
            )
            _attach_attr_backend(
                idx.column_attrs,
                os.path.join(index_dir, ".attrs"),
                os.path.join(index_dir, ".attrs.json"),
            )
            for field_name in sorted(os.listdir(index_dir)):
                field_dir = self._field_dir(index_name, field_name)
                fmeta_path = os.path.join(field_dir, ".meta.json")
                if not os.path.isdir(field_dir) or not os.path.exists(fmeta_path):
                    continue
                with open(fmeta_path) as f:
                    fmeta = json.load(f)
                if field_name in idx.fields:
                    field = idx.fields[field_name]
                else:
                    field = idx.create_field(
                        field_name, FieldOptions.from_dict(fmeta.get("options", {}))
                    )
                field.base = fmeta.get("base", field.base)
                field.bit_depth = fmeta.get("bitDepth", field.bit_depth)
                _attach_attr_backend(
                    field.row_attrs,
                    os.path.join(field_dir, ".attrs"),
                    os.path.join(field_dir, ".attrs.json"),
                )
                views_dir = os.path.join(field_dir, "views")
                if os.path.isdir(views_dir):
                    for view_name in sorted(os.listdir(views_dir)):
                        frags_dir = os.path.join(views_dir, view_name, "fragments")
                        if not os.path.isdir(frags_dir):
                            continue
                        view = field.create_view_if_not_exists(view_name)
                        for shard_name in sorted(os.listdir(frags_dir)):
                            if not shard_name.isdigit():
                                continue
                            view.create_fragment_if_not_exists(int(shard_name))
        # wire hooks for everything that exists (loads fragments) and
        # everything created later
        for idx in self.holder.indexes.values():
            self._wire_index(idx)
        self.holder.on_create_index = self._wire_index

    def sync(self) -> None:
        """Flush schema, attrs, and translation to disk (fragment data is
        already durable via op logs; key translation via its own log)."""
        if self.translate_log is not None:
            self.translate_log.sync()
        for idx in self.holder.indexes.values():
            index_dir = self._index_dir(idx.name)
            os.makedirs(index_dir, exist_ok=True)
            with open(os.path.join(index_dir, ".meta.json"), "w") as f:
                json.dump(
                    {"keys": idx.keys, "trackExistence": idx.track_existence}, f
                )
            self._flush_attrs(
                idx.column_attrs, os.path.join(index_dir, ".attrs")
            )
            for field in idx.fields.values():
                field_dir = self._field_dir(idx.name, field.name)
                os.makedirs(field_dir, exist_ok=True)
                with open(os.path.join(field_dir, ".meta.json"), "w") as f:
                    json.dump(
                        {
                            "options": field.options.to_dict(),
                            "base": field.base,
                            "bitDepth": field.bit_depth,
                        },
                        f,
                    )
                self._flush_attrs(
                    field.row_attrs, os.path.join(field_dir, ".attrs")
                )

    @staticmethod
    def _flush_attrs(store, dir_path: str) -> None:
        """Write only the blocks dirtied since the last flush (no
        whole-store rewrite — reference boltdb writes per bucket)."""
        if store.backend is None:
            store.backend = AttrBlocksDir(dir_path)
        store.flush_dirty()

    def _detach_stores(self, match) -> None:
        """Close + drop FragmentFile stores whose fragment matches, so
        deleted indexes/fields leak neither fds nor _stores entries."""
        kept = []
        for store in self._stores:
            if match(store.fragment):
                store.close()
                store.fragment.store = None
            else:
                kept.append(store)
        self._stores = kept

    def delete_index_dir(self, name: str) -> None:
        import shutil

        self._detach_stores(lambda frag: frag.index == name)
        d = self._index_dir(name)
        if os.path.isdir(d):
            shutil.rmtree(d)

    def delete_fragment(self, index: str, field: str, view: str, shard: int) -> None:
        """Detach + delete one fragment's backing file (resize cleanup,
        reference holderCleaner holder.go:898-926)."""
        self._detach_stores(
            lambda frag: frag.index == index
            and frag.field == field
            and frag.view == view
            and frag.shard == shard
        )
        p = self._fragment_path(index, field, view, shard)
        if os.path.exists(p):
            os.remove(p)

    def delete_field_dir(self, index: str, name: str) -> None:
        import shutil

        self._detach_stores(
            lambda frag: frag.index == index and frag.field == name
        )
        d = self._field_dir(index, name)
        if os.path.isdir(d):
            shutil.rmtree(d)

    def close(self) -> None:
        self.sync()
        if self.translate_log is not None:
            self.translate_log.close()
        self.snapshot_queue.await_all()
        self.snapshot_queue.stop()
        for store in self._stores:
            store.close()
