"""Shard-width configuration.

The unit of horizontal distribution is the *shard*: a contiguous block of
``SHARD_WIDTH`` columns. Mirrors the reference's build-time shard width
(reference: fragment.go:50-53, shardwidth/16.go..32.go, Makefile:9
``SHARD_WIDTH=20``) but selected at process start via the environment
variable ``PILOSA_TPU_SHARD_WIDTH`` (exponent, default 20).

A shard's column axis is the word axis of the dense bitmap tensors:
``SHARD_WIDTH // 32`` words per row. The same environment variable as the
JAX package is read, so both packages agree on the width in one process.
Widths are restricted to >= 2^12, which keeps the word count a multiple of
4 (the CUDA scans read 16-byte word groups).
"""

from __future__ import annotations

import os

WORD_BITS = 32

_DEFAULT_EXP = 20

SHARD_WIDTH_EXP: int = int(os.environ.get("PILOSA_TPU_SHARD_WIDTH", str(_DEFAULT_EXP)))
if not 12 <= SHARD_WIDTH_EXP <= 32:
    raise ValueError(
        f"PILOSA_TPU_SHARD_WIDTH must be in [12, 32], got {SHARD_WIDTH_EXP}"
    )

#: Number of columns per shard.
SHARD_WIDTH: int = 1 << SHARD_WIDTH_EXP

#: Number of uint32 words in one row of one shard's bitmap tensor.
SHARD_WORDS: int = SHARD_WIDTH // WORD_BITS


def shard_of(col: int) -> int:
    """Shard that owns an absolute column id (reference: fragment.go:3077)."""
    return col >> SHARD_WIDTH_EXP


def col_in_shard(col: int) -> int:
    """Column offset within its shard."""
    return col & (SHARD_WIDTH - 1)


def word_of(col_offset: int) -> int:
    """Word index of a column offset within a row's word array."""
    return col_offset >> 5


def bit_of(col_offset: int) -> int:
    """Bit index of a column offset within its word (little-endian)."""
    return col_offset & 31
