"""Append-only key-translation log (counterpart of
``pilosa_tpu/storage/translatelog.py``; reference: translate.go TranslateFile
— an mmap'd append-only log of InsertColumn/InsertRow entries
(translate.go:37-40) with in-memory hash indexes rebuilt on load).

Binary format, little-endian:

    header: magic u32 = 0x504b4c31 ("PKL1")
    record: u8 type (1 = insert)
            u16 index_len, u16 field_len, u32 key_len
            u64 id
            index utf-8, field utf-8, key utf-8

A torn tail record (crash mid-append) truncates the replay at the last
complete record, like the roaring op log.
"""

from __future__ import annotations

import os
import struct
import threading

from pilosa_tpu_torch.core import translate
from pilosa_tpu_torch.core.translate import TranslateStore

MAGIC = 0x504B4C31
_HDR = struct.Struct("<I")
_REC = struct.Struct("<BHHIQ")
REC_INSERT = 1


class TranslateLog:
    """Wires a TranslateStore to an on-disk append-only log."""

    def __init__(self, store: TranslateStore, path: str):
        self.store = store
        self.path = path
        self._lock = threading.Lock()
        self._f = None

    def open(self) -> None:
        exists = os.path.exists(self.path)
        if exists:
            self._replay()
        self._f = open(self.path, "ab")
        if not exists or self._f.tell() == 0:
            self._f.write(_HDR.pack(MAGIC))
            self._f.flush()
        # hook AFTER replay so replayed inserts don't re-append
        self.store.on_insert = self._append

    def _replay(self) -> None:
        with open(self.path, "rb") as f:
            data = f.read()
        if len(data) < _HDR.size or _HDR.unpack_from(data, 0)[0] != MAGIC:
            return
        pos = _HDR.size
        good = pos
        # Batch CONTIGUOUS same-(index, field) runs for set_mapping
        # efficiency while preserving the global record order — the
        # rebuilt in-memory entry log must match the original append
        # order so replica stream offsets stay meaningful across a
        # primary restart.
        run_space: tuple[str, str] | None = None
        run_keys: list[str] = []
        run_ids: list[int] = []

        def flush_run():
            if run_space is not None and run_keys:
                self.store.set_mapping(
                    run_space[0], run_space[1], run_keys, run_ids
                )

        while pos + _REC.size <= len(data):
            typ, ilen, flen, klen, id_ = _REC.unpack_from(data, pos)
            end = pos + _REC.size + ilen + flen + klen
            if typ != REC_INSERT or end > len(data):
                break
            p = pos + _REC.size
            index = data[p : p + ilen].decode()
            field = data[p + ilen : p + ilen + flen].decode()
            key = data[p + ilen + flen : end].decode()
            if (index, field) != run_space:
                flush_run()
                run_space = (index, field)
                run_keys, run_ids = [], []
            run_keys.append(key)
            run_ids.append(id_)
            pos = good = end
        flush_run()
        if good < len(data):
            # torn tail: truncate so future appends start at a record edge
            with open(self.path, "r+b") as f:
                f.truncate(good)

    def _append(self, entries: list[tuple[str, str, str, int]]) -> None:
        """Append one call's new mappings in one write and flush: the
        records of JAX's per-key appends, in its order."""
        recs = []
        for index, field, key, id_ in entries:
            ib, fb, kb = index.encode(), field.encode(), key.encode()
            recs.append(_REC.pack(REC_INSERT, len(ib), len(fb), len(kb), id_) + ib + fb + kb)
        # counted before the file lock: telemetry never queues behind I/O
        translate.translate_stats.count("translate_log_appends", len(recs))
        with self._lock:
            if self._f is None:
                return
            self._f.write(b"".join(recs))
            self._f.flush()

    def sync(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.flush()
                os.fsync(self._f.fileno())

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.flush()
                self._f.close()
                self._f = None
        if self.store.on_insert == self._append:
            self.store.on_insert = None
