"""Row/column attribute stores (reference: attr.go, boltdb/attrstore.go).

Arbitrary key/value metadata attached to row ids (per field) and column
ids (per index).  The reference backs this with BoltDB plus an LRU read
cache (boltdb/attrstore.go:37-90); here the store is organized as 100-id
BLOCKS end to end:

* blocks are the persistence unit — the storage layer writes only the
  blocks dirtied since the last flush (no whole-store JSON rewrite),
* blocks are the caching unit — with a ``backend`` attached, blocks load
  lazily on first touch and CLEAN blocks are evicted LRU past
  ``cache_blocks``, so a huge store doesn't live in memory,
* blocks are the anti-entropy unit — 100-id checksums diff against
  replicas (reference attr.go:81-120 AttrBlock/attrBlocks.Diff).

Attrs are never on the device data path.
"""

from __future__ import annotations

import hashlib
import json
import threading
from collections import OrderedDict
from typing import Any

# reference attr.go:29 attrBlockSize.
ATTR_BLOCK_SIZE = 100


class AttrStore:
    # loaded-block LRU cap when a backend is attached (clean blocks
    # only; dirty blocks are pinned until drained).  4096 blocks x 100
    # ids bounds resident attrs at ~400k ids.
    DEFAULT_CACHE_BLOCKS = 4096

    def __init__(self, backend=None, cache_blocks: int = DEFAULT_CACHE_BLOCKS):
        self._lock = threading.RLock()
        # block id -> {id -> attrs}; OrderedDict in LRU order
        self._blocks: OrderedDict[int, dict[int, dict[str, Any]]] = (
            OrderedDict()
        )
        self._dirty: set[int] = set()
        self.backend = backend  # .load_block(bid) -> dict|None, .block_ids()
        self.cache_blocks = cache_blocks

    # -- block plumbing -----------------------------------------------------

    def _block(self, bid: int) -> dict[int, dict[str, Any]]:
        """The block's id->attrs dict, loading through the backend on
        first touch (caller holds the lock)."""
        blk = self._blocks.get(bid)
        if blk is not None:
            self._blocks.move_to_end(bid)
            return blk
        blk = {}
        if self.backend is not None:
            loaded = self.backend.load_block(bid)
            if loaded:
                blk = {int(k): dict(v) for k, v in loaded.items()}
        self._blocks[bid] = blk
        self._evict(protect=bid)
        return blk

    def _evict(self, protect: int | None = None) -> None:
        """Drop least-recently-used CLEAN blocks past the cap (only
        meaningful with a backend — without one every block is its sole
        copy and is never evicted).  ``protect`` pins the block being
        handed to the CURRENT caller: it may be about to dirty it
        (set_attrs marks dirty only after _block returns), and evicting
        it here would orphan that mutation."""
        if self.backend is None:
            return
        while len(self._blocks) > self.cache_blocks:
            victim = next(
                (
                    b
                    for b in self._blocks
                    if b not in self._dirty and b != protect
                ),
                None,
            )
            if victim is None:
                return  # everything dirty/pinned: over-cap until drain
            del self._blocks[victim]

    def _all_block_ids(self) -> list[int]:
        ids = set(self._blocks)
        if self.backend is not None:
            ids.update(self.backend.block_ids())
        return sorted(ids)

    # -- reads / writes -----------------------------------------------------

    def attrs(self, id_: int) -> dict[str, Any]:
        with self._lock:
            return dict(self._block(id_ // ATTR_BLOCK_SIZE).get(id_, {}))

    def set_attrs(self, id_: int, attrs: dict[str, Any]) -> None:
        """Merge semantics: None deletes a key (reference attr.go
        SetAttrs)."""
        with self._lock:
            bid = id_ // ATTR_BLOCK_SIZE
            blk = self._block(bid)
            cur = blk.setdefault(id_, {})
            for k, v in attrs.items():
                if v is None:
                    cur.pop(k, None)
                else:
                    cur[k] = v
            if not cur:
                del blk[id_]
            self._dirty.add(bid)

    def set_bulk_attrs(self, attrs_by_id: dict[int, dict[str, Any]]) -> None:
        with self._lock:
            for id_, attrs in attrs_by_id.items():
                self.set_attrs(id_, attrs)

    def ids(self) -> list[int]:
        with self._lock:
            out: list[int] = []
            for bid in self._all_block_ids():
                out.extend(self._block(bid))
            return sorted(out)

    # -- anti-entropy blocks (reference attr.go:81-120) ---------------------

    def blocks(self) -> list[tuple[int, bytes]]:
        """(block_id, checksum) pairs over 100-id blocks."""
        with self._lock:
            out = []
            for bid in self._all_block_ids():
                blk = self._block(bid)
                if not blk:
                    continue
                h = hashlib.blake2b(digest_size=16)
                for id_ in sorted(blk):
                    h.update(
                        json.dumps([id_, blk[id_]], sort_keys=True).encode()
                    )
                out.append((bid, h.digest()))
            return out

    def block_data(self, block_id: int) -> dict[int, dict[str, Any]]:
        with self._lock:
            return {
                id_: dict(a) for id_, a in self._block(block_id).items()
            }

    # -- persistence --------------------------------------------------------

    def flush_dirty(self) -> None:
        """Persist every block dirtied since the last flush through
        ``self.backend.write_blocks({block_id: block_data})`` — the
        storage layer writes exactly these files (the reference's
        per-bucket BoltDB writes play the same role,
        boltdb/attrstore.go:37-90).

        The dirty set is cleared (and drained blocks become evictable)
        only AFTER the writer returns: a failed write (disk full) leaves
        every block dirty for the next flush instead of silently
        dropping it.  The lock is held across the write so a concurrent
        ``attrs()`` read cannot load-and-cache the stale on-disk block
        mid-flush and keep serving it after the flush lands — attr
        flushes are small (dirty blocks only) and attrs are never on
        the query hot path, so blocking reads for the write is the
        right trade."""
        with self._lock:
            if self.backend is None or not self._dirty:
                return
            self.backend.write_blocks(
                {bid: self.block_data(bid) for bid in self._dirty}
            )
            self._dirty.clear()
            self._evict()

    def to_dict(self) -> dict[str, dict[str, Any]]:
        with self._lock:
            out: dict[str, dict[str, Any]] = {}
            for bid in self._all_block_ids():
                for id_, a in self._block(bid).items():
                    out[str(id_)] = dict(a)
            return out

    def load_dict(self, d: dict[str, dict[str, Any]]) -> None:
        """Install a whole-store snapshot (legacy persistence format and
        the wire path); marks everything dirty so the next flush lands
        it block-wise."""
        with self._lock:
            self._blocks.clear()
            self._dirty.clear()
            for k, v in d.items():
                id_ = int(k)
                bid = id_ // ATTR_BLOCK_SIZE
                self._blocks.setdefault(bid, {})[id_] = dict(v)
                self._dirty.add(bid)
