"""Block checksum hashing for anti-entropy (counterpart of
``pilosa_tpu/core/blockhash.py``; reference fragment.go:81, 1760-1839:
100-row blocks, xxhash64 over row/col pairs).

blake2b (8-byte digest, stdlib) stands in for xxhash64, as in the JAX
package: the checksum only has to be deterministic across nodes and
cheap, and a cluster of JAX and port nodes compares the two packages'
checksums, so the bytes hashed are the same: each non-empty row's id as 8
little-endian bytes, then its uint32 words.
"""

from __future__ import annotations

import hashlib

import numpy as np


def new_hash():
    return hashlib.blake2b(digest_size=8)


def add_row(h, row: int, words: np.ndarray) -> None:
    h.update(row.to_bytes(8, "little"))
    h.update(np.ascontiguousarray(words, dtype=np.uint32).tobytes())
