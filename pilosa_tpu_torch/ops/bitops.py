"""Core bitmap word operations (counterpart of ``pilosa_tpu/ops/bitops.py``).

Every fragment row is a dense little-endian word vector of ``SHARD_WORDS``
words: column offset ``c`` lives at word ``c >> 5``, bit ``c & 31``. The
host side keeps words as numpy ``uint32``; the device side holds the same
bits as ``torch.int32`` (a ``.view`` of the host array), because torch has
no ``~``, ``>>`` or ``<<`` for ``uint32`` on the CPU. Shifts on int32 are
arithmetic, so every shift below is followed by a mask.
"""

from __future__ import annotations

import numpy as np
import torch

from pilosa_tpu_torch.obs import devledger, qprofile
from pilosa_tpu_torch.ops import streams
from pilosa_tpu_torch.shardwidth import SHARD_WORDS, WORD_BITS

_DL_H2D = devledger.site("bitops.to_device")

# ---------------------------------------------------------------------------
# Host-side (numpy) helpers — the ingest/serialization boundary.
# ---------------------------------------------------------------------------


def pow2_pad_len(n: int) -> int:
    """Power-of-two bucket for ``n``; 1 for n <= 1."""
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def pack_columns(cols: np.ndarray, n_words: int = SHARD_WORDS) -> np.ndarray:
    """Pack a sorted-or-not array of column offsets into uint32 words."""
    words = np.zeros(n_words, dtype=np.uint32)
    if len(cols) == 0:
        return words
    cols = np.asarray(cols, dtype=np.int64)
    w = cols >> 5
    b = (cols & 31).astype(np.uint32)
    np.bitwise_or.at(words, w, np.uint32(1) << b)
    return words


def unpack_columns(words: np.ndarray) -> np.ndarray:
    """Inverse of :func:`pack_columns`: packed words -> sorted column offsets.
    A sparse row (a selective tree's result) unpacks only its nonzero
    words."""
    words = np.ascontiguousarray(words, dtype=np.uint32)
    nz = np.flatnonzero(words)
    if nz.size * 8 < words.size:
        bits = np.unpackbits(words[nz].view(np.uint8), bitorder="little").reshape(-1, 32)
        at, bit = np.nonzero(bits)
        return nz[at].astype(np.uint64) * np.uint64(32) + bit.astype(np.uint64)
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    return np.flatnonzero(bits).astype(np.uint64)


def pack_positions(positions: np.ndarray, n_words: int) -> tuple[np.ndarray, np.ndarray]:
    """Group absolute bit positions (row*SHARD_WIDTH + col) into
    ``(row_ids, words[len(row_ids), n_words])``."""
    positions = np.asarray(positions, dtype=np.uint64)
    shard_width = np.uint64(n_words * WORD_BITS)
    rows = positions // shard_width
    offs = positions % shard_width
    row_ids, inverse = np.unique(rows, return_inverse=True)
    words = np.zeros((len(row_ids), n_words), dtype=np.uint32)
    w = (offs >> np.uint64(5)).astype(np.int64)
    b = (offs & np.uint64(31)).astype(np.uint32)
    np.bitwise_or.at(words, (inverse, w), np.uint32(1) << b)
    return row_ids, words


def popcount_host(words: np.ndarray) -> int:
    """Host popcount over a word array of any shape, in one native pass
    (``native/hostops.cpp``); raises where the library cannot be built."""
    from pilosa_tpu_torch.ops import _hostops

    return _hostops.popcount(words)


def popcount_host_plain(words: np.ndarray) -> int:
    """Plain version of :func:`popcount_host` in numpy."""
    return int(np.bitwise_count(np.asarray(words, dtype=np.uint32)).sum(dtype=np.int64))


_HOST_OPS = {
    "intersect": lambda a, b: a & b,
    "union": lambda a, b: a | b,
    "difference": lambda a, b: a & ~b,
    "xor": lambda a, b: a ^ b,
}


def pair_count_host(a: np.ndarray, b: np.ndarray, op: str) -> int:
    """Fused host ``popcount(op(a, b))`` with no temporary, in one native
    pass; ``op`` is one of intersect/union/difference/xor."""
    from pilosa_tpu_torch.ops import _hostops

    return _hostops.pair_count(a, b, op)


def pair_count_host_plain(a: np.ndarray, b: np.ndarray, op: str) -> int:
    """Plain version of :func:`pair_count_host` in numpy."""
    fn = _HOST_OPS.get(op)
    if fn is None:
        raise ValueError(f"unknown pair op: {op}")
    return popcount_host_plain(fn(np.asarray(a, np.uint32), np.asarray(b, np.uint32)))


def shift_row_host(words: np.ndarray, n: int = 1) -> np.ndarray:
    """Shift bits toward higher column ids, dropping bits past the shard
    edge (reference roaring.go:944 ``Shift``)."""
    words = np.asarray(words, dtype=np.uint32)
    nw = words.shape[-1]
    n = int(n)
    if n <= 0:
        return words.copy()
    word_shift, bit_shift = divmod(n, WORD_BITS)
    out = np.zeros_like(words)
    if word_shift < nw:
        out[..., word_shift:] = words[..., : nw - word_shift]
    if bit_shift:
        carry = np.zeros_like(out)
        carry[..., 1:] = out[..., :-1] >> np.uint32(WORD_BITS - bit_shift)
        out = ((out << np.uint32(bit_shift)) | carry).astype(np.uint32)
    return out


def range_mask(start: int, stop: int, n_words: int = SHARD_WORDS) -> np.ndarray:
    """Host-built mask with bits [start, stop) set (reference roaring.go:1727
    ``Flip``)."""
    words = np.zeros(n_words, dtype=np.uint32)
    if stop <= start:
        return words
    first_w, last_w = start >> 5, (stop - 1) >> 5
    words[first_w : last_w + 1] = np.uint32(0xFFFFFFFF)
    words[first_w] &= np.uint32(0xFFFFFFFF) << np.uint32(start & 31)
    if stop & 31:
        words[last_w] &= np.uint32((1 << (stop & 31)) - 1)
    return words


# ---------------------------------------------------------------------------
# Host <-> device word views.
# ---------------------------------------------------------------------------


def to_device(words: np.ndarray, device: torch.device) -> torch.Tensor:
    """``uint32`` host words -> ``int32`` tensor on ``device`` with the same
    bits. The result never aliases ``words``. On a thread with a pinned
    stager installed (the ingest uploader, ``ops/streams.py``) the copy
    goes through its pinned slots on its side stream."""
    arr = np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)
    t = torch.from_numpy(arr)
    if torch.device(device).type == "cpu":
        return t.clone()
    _book_h2d(arr.nbytes)
    stager = streams.current_stager()
    if stager is not None and stager.device == streams.card(device):
        return stager.upload(arr)
    return t.to(device)


def _book_h2d(nbytes: int) -> None:
    """The port's host-to-card funnel: the bytes go on the device ledger
    (under the enclosing launch window's site, an upload or a prefetch,
    where there is one) and the active query profile."""
    (devledger.active_window_site() or _DL_H2D).record_transfer(nbytes, "h2d")
    qprofile.incr("transfer_h2d_bytes", nbytes)


def pinned_words(shape, device) -> tuple[torch.Tensor, np.ndarray]:
    """A zeroed ``int32`` host tensor of ``shape`` and its ``uint32`` numpy
    view, in pinned memory when ``device`` is a card: words filled there
    reach the card in one copy (:func:`upload`) with no staging."""
    t = torch.zeros(shape, dtype=torch.int32, pin_memory=torch.device(device).type == "cuda")
    return t, t.numpy().view(np.uint32)


def upload(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host ``int32`` tensor (:func:`pinned_words`) on ``device``, booked
    as :func:`to_device` books its bytes; from pinned memory the copy is
    queued on the current stream without waiting for it."""
    if torch.device(device).type == "cpu":
        return t
    _book_h2d(t.numel() * t.element_size())
    return t.to(device, non_blocking=t.is_pinned())


def to_host(t: torch.Tensor) -> np.ndarray:
    """``int32`` device words -> ``uint32`` numpy words with the same bits."""
    return t.detach().to("cpu").contiguous().numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# Device-side (torch) word operations on int32.
# ---------------------------------------------------------------------------


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Per-word population count of int32 words -> int32.

    SWAR on the low 31 bits, where every intermediate is non-negative and
    below 2^31 (no signed overflow, and the arithmetic shifts bring in only
    zeros), plus one for the sign bit."""
    if words.dtype != torch.int32:
        raise TypeError(f"popcount wants int32 words, got {words.dtype}")
    x = words & 0x7FFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = (x + (x >> 16)) & 0x3F
    return x + (words < 0).to(torch.int32)


def count_rows(bits: torch.Tensor) -> torch.Tensor:
    """Row-wise popcount: ``int32[..., rows, W] -> int32[..., rows]``
    (exact while one row holds fewer than 2^31 bits)."""
    return popcount(bits).sum(dim=-1, dtype=torch.int32)
