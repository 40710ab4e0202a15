"""Placement hashing (reference: cluster.go:847-934).

Counterpart of ``pilosa_tpu/cluster/hash.py``, the port's own copy.

Two layers, exactly as in the reference:

1. (index, shard) -> partition: FNV-1a over the index name plus the
   big-endian shard id, mod partitionN (reference cluster.go:847-856).
2. partition -> node ordinal: Lamping-Veach jump consistent hash
   (reference cluster.go:922-934 ``jmphasher``), which moves a minimal
   set of partitions when the node count changes.

Both are deterministic pure functions so every node computes identical
placement with no coordination.
"""

from __future__ import annotations

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = 0xFFFFFFFFFFFFFFFF


def fnv1a64(data: bytes) -> int:
    h = _FNV_OFFSET
    for b in data:
        h ^= b
        h = (h * _FNV_PRIME) & _MASK64
    return h


def partition_hash(index: str, shard: int, partition_n: int) -> int:
    """Hash (index, shard) onto a partition id (reference
    cluster.go:847-856)."""
    data = index.encode() + shard.to_bytes(8, "big")
    return fnv1a64(data) % partition_n


def jump_hash(key: int, n_buckets: int) -> int:
    """Jump consistent hash (Lamping & Veach 2014; reference
    cluster.go:922-934). Maps a 64-bit key onto [0, n_buckets) such that
    growing n_buckets relocates only ~1/n of keys."""
    if n_buckets <= 0:
        raise ValueError("n_buckets must be positive")
    b, j = -1, 0
    key &= _MASK64
    while j < n_buckets:
        b = j
        key = (key * 2862933555777941757 + 1) & _MASK64
        j = int((b + 1) * (1 << 31) / ((key >> 33) + 1))
    return b
