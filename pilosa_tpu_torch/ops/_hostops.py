"""ctypes bindings for the host latency-tier kernels
(``pilosa_tpu_torch/native/hostops.cpp``; counterpart of
``pilosa_tpu/ops/_hostops.py``).

Built on first use by :mod:`pilosa_tpu_torch.nativelib`. There is no numpy
fallback here: every entry point raises ``NativeBuildError`` when the
library cannot be built. The numpy plain versions the tests hold these to
live in ``ops/bitops.py`` (``*_host_plain``) and ``core/fragment.py``
(``Fragment._import_merge_plain``).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from pilosa_tpu_torch import nativelib

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_U8P = ctypes.POINTER(ctypes.c_uint8)
_U64P = ctypes.POINTER(ctypes.c_uint64)
_I64P = ctypes.POINTER(ctypes.c_int64)

# PQL set-op name -> native op code (hostops.cpp enum Op)
OP_CODES = {"intersect": 0, "union": 1, "difference": 2, "xor": 3}


def _bind(lib: ctypes.CDLL) -> None:
    lib.ph_popcount.restype = ctypes.c_uint64
    lib.ph_popcount.argtypes = [_U8P, ctypes.c_size_t]
    lib.ph_extract.restype = ctypes.c_size_t
    lib.ph_extract.argtypes = [_U8P, ctypes.c_size_t, ctypes.c_uint64, _U64P]
    lib.ph_import_merge.restype = ctypes.c_int64
    lib.ph_import_merge.argtypes = [
        _I64P, ctypes.c_size_t, ctypes.c_int64, ctypes.c_int64,
        _I64P, _U64P, ctypes.c_size_t, ctypes.c_int, _U8P, ctypes.c_int,
        _U64P, _I64P, _I64P, _I64P,
    ]
    lib.ph_pair_count.restype = ctypes.c_uint64
    lib.ph_pair_count.argtypes = [_U8P, _U8P, ctypes.c_size_t, ctypes.c_int]
    lib.ph_pair_op.restype = None
    lib.ph_pair_op.argtypes = [_U8P, _U8P, _U8P, ctypes.c_size_t, ctypes.c_int]
    lib.ph_pair_count_addr.restype = ctypes.c_uint64
    lib.ph_pair_count_addr.argtypes = [
        _U64P, _U64P, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_int,
    ]


def load() -> ctypes.CDLL:
    """The native library, built on first use; raises
    ``nativelib.NativeBuildError`` when it cannot be built."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            _lib = nativelib.load("hostops.cpp", _bind)
        return _lib


def _u8(a: np.ndarray):
    return a.ctypes.data_as(_U8P)


def _op_code(op: str) -> int:
    code = OP_CODES.get(op)
    if code is None:
        raise ValueError(f"unknown pair op: {op}")
    return code


def popcount(words: np.ndarray) -> int:
    """Total set bits of a uint32 array (any shape)."""
    lib = load()
    words = np.ascontiguousarray(words, dtype=np.uint32)
    return int(lib.ph_popcount(_u8(words), words.size))


def pair_count(a: np.ndarray, b: np.ndarray, op: str) -> int:
    """Fused ``popcount(op(a, b))`` without materialising the op
    (reference roaring.go:568)."""
    lib = load()
    a = np.ascontiguousarray(a, dtype=np.uint32)
    b = np.ascontiguousarray(b, dtype=np.uint32)
    if a.size != b.size:
        raise ValueError("pair_count operands differ in size")
    return int(lib.ph_pair_count(_u8(a), _u8(b), a.size, _op_code(op)))


def pair_count_addrs(addr_a: np.ndarray, addr_b: np.ndarray, n_words: int, op: str) -> int:
    """Sum of fused pair counts over rows given by ABSOLUTE addresses
    (uint64 arrays): one ctypes crossing for a whole fan of shards. The
    caller keeps the backing arrays alive and locked for the call."""
    lib = load()
    addr_a = np.ascontiguousarray(addr_a, dtype=np.uint64)
    addr_b = np.ascontiguousarray(addr_b, dtype=np.uint64)
    if addr_a.size != addr_b.size:
        raise ValueError("pair_count_addrs: address arrays differ in size")
    return int(lib.ph_pair_count_addr(
        addr_a.ctypes.data_as(_U64P), addr_b.ctypes.data_as(_U64P),
        addr_a.size, n_words, _op_code(op),
    ))


def extract_positions(words: np.ndarray, base: int = 0) -> np.ndarray:
    """Set-bit offsets (+ ``base``) of a contiguous uint32 word vector,
    ascending: the ctz walk behind the op log's mask records."""
    lib = load()
    words = np.ascontiguousarray(words, dtype=np.uint32)
    n = int(lib.ph_popcount(_u8(words), words.size))
    out = np.empty(n, dtype=np.uint64)
    k = lib.ph_extract(
        _u8(words), words.size, ctypes.c_uint64(base), out.ctypes.data_as(_U64P)
    )
    return out[:k]


def import_merge(
    keys: np.ndarray,
    width: int,
    n_words: int,
    slots: np.ndarray,
    row_ids: np.ndarray,
    mirror: np.ndarray,
    clear: bool,
    id_keys: bool = False,
    want_wal: bool = False,
) -> tuple[int, np.ndarray | None, np.ndarray, np.ndarray]:
    """One native pass over SORTED keys (``row_index*width + col``, or
    ``row_id*width + col`` with ``id_keys=True``; duplicates allowed):
    apply the bulk set/clear to ``mirror`` (uint32 ``[capacity, n_words]``,
    C-contiguous, mutated in place) and return ``(n_changed,
    wal_positions, perrow_changed, changed_word_indices)``.
    ``wal_positions`` (changed ``row_id*width + col``, ascending: the op
    log's records of a fragment with a store) is None unless ``want_wal``.
    The caller owns key bounds and holds the fragment lock."""
    lib = load()
    if not (mirror.dtype == np.uint32 and mirror.flags.c_contiguous):
        raise ValueError("import_merge: mirror must be C-contiguous uint32")
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    slots = np.ascontiguousarray(slots, dtype=np.int64)
    row_ids = np.ascontiguousarray(row_ids, dtype=np.uint64)
    wal = np.empty(keys.size, dtype=np.uint64) if want_wal else None
    perrow = np.zeros(slots.size, dtype=np.int64)
    cw = np.empty(keys.size, dtype=np.int64)
    ncw = np.zeros(1, dtype=np.int64)
    nc = int(lib.ph_import_merge(
        keys.ctypes.data_as(_I64P), keys.size, width, n_words,
        slots.ctypes.data_as(_I64P),
        row_ids.ctypes.data_as(_U64P), row_ids.size, int(id_keys),
        _u8(mirror), int(clear),
        wal.ctypes.data_as(_U64P) if wal is not None else None,
        perrow.ctypes.data_as(_I64P),
        cw.ctypes.data_as(_I64P),
        ncw.ctypes.data_as(_I64P),
    ))
    return nc, wal[:nc] if wal is not None else None, perrow, cw[: int(ncw[0])]


def pair_op(a: np.ndarray, b: np.ndarray, op: str) -> np.ndarray:
    """Materialised ``op(a, b)`` into a fresh array, in one native pass."""
    lib = load()
    a = np.ascontiguousarray(a, dtype=np.uint32)
    b = np.ascontiguousarray(b, dtype=np.uint32)
    if a.size != b.size:
        raise ValueError("pair_op operands differ in size")
    out = np.empty_like(a)
    lib.ph_pair_op(_u8(a), _u8(b), _u8(out), a.size, _op_code(op))
    return out
