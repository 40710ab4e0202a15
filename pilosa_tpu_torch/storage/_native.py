"""ctypes bindings for the port's native roaring codec
(``pilosa_tpu_torch/native/roaring_codec.cpp``; counterpart of
``pilosa_tpu/storage/_native.py``).

Built on first use by :mod:`pilosa_tpu_torch.nativelib`. Unlike the JAX
package's binding nothing here returns None for a caller to fall back
from: where the library cannot be built every entry point raises
``NativeBuildError``. A parse failure returns None, and
``storage/roaring.py`` raises ``RoaringError`` for it. The plain Python
codec the tests hold this one to is ``roaring._serialize_py`` /
``roaring._deserialize_py``.
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
_SIZE = ctypes.c_size_t


def _bind(lib: ctypes.CDLL) -> None:
    lib.rt_serialize.restype = ctypes.c_int
    lib.rt_serialize.argtypes = [
        _U64P, _SIZE, ctypes.c_uint8, ctypes.POINTER(_U8P), ctypes.POINTER(_SIZE),
    ]
    lib.rt_serialize_words.restype = ctypes.c_int
    lib.rt_serialize_words.argtypes = [
        _U64P, _I64P, _SIZE, _U8P, ctypes.c_int64, ctypes.c_uint8,
        ctypes.POINTER(_U8P), ctypes.POINTER(_SIZE),
    ]
    lib.rt_deserialize.restype = ctypes.c_int
    lib.rt_deserialize.argtypes = [
        _U8P, _SIZE, ctypes.POINTER(_U64P), ctypes.POINTER(_SIZE), _U64P,
    ]
    lib.rt_deserialize_into.restype = ctypes.c_int
    lib.rt_deserialize_into.argtypes = [
        _U8P, _SIZE, _U64P, _SIZE, ctypes.POINTER(_SIZE), _U64P,
    ]
    lib.rt_decode_rows.restype = ctypes.c_int
    lib.rt_decode_rows.argtypes = [
        _U8P, _SIZE, ctypes.c_uint64, ctypes.POINTER(_U64P), ctypes.POINTER(_SIZE),
        _U64P,
    ]
    lib.rt_decode_words.restype = ctypes.c_int
    lib.rt_decode_words.argtypes = [
        _U8P, _SIZE, _U64P, _SIZE, ctypes.c_int64, _U8P, _U64P,
    ]
    lib.rt_fnv32a.restype = ctypes.c_uint32
    lib.rt_fnv32a.argtypes = [ctypes.c_char_p, _SIZE, ctypes.c_uint32]
    lib.rt_encode_batch_ops.restype = _SIZE
    lib.rt_encode_batch_ops.argtypes = [ctypes.c_uint8, _U64P, _SIZE, _SIZE, _U8P]
    lib.rt_popcount.restype = ctypes.c_uint64
    lib.rt_popcount.argtypes = [_U8P, _SIZE]
    lib.rt_free.restype = None
    lib.rt_free.argtypes = [ctypes.c_void_p]


def load() -> ctypes.CDLL:
    """The native library, built on first use; raises
    ``nativelib.NativeBuildError`` when it cannot be built."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            _lib = nativelib.load("roaring_codec.cpp", _bind)
        return _lib


def _src(data: bytes) -> np.ndarray:
    """A zero-copy uint8 view of ``data``."""
    return np.frombuffer(data, dtype=np.uint8)


def _take_bytes(lib: ctypes.CDLL, out, out_len) -> bytes:
    try:
        return ctypes.string_at(out, out_len.value)
    finally:
        lib.rt_free(out)


def serialize(positions: np.ndarray, flags: int = 0) -> bytes:
    """Sorted uint64 bit positions -> Pilosa roaring file bytes."""
    lib = load()
    positions = np.ascontiguousarray(positions, dtype=np.uint64)
    out = _U8P()
    out_len = _SIZE()
    rc = lib.rt_serialize(
        positions.ctypes.data_as(_U64P), positions.size, flags,
        ctypes.byref(out), ctypes.byref(out_len),
    )
    if rc != 0:
        raise MemoryError("rt_serialize: out of memory")
    return _take_bytes(lib, out, out_len)


def serialize_words(
    row_ids: np.ndarray, slots: np.ndarray, words: np.ndarray, flags: int = 0
) -> bytes:
    """Roaring bytes straight from dense row words (uint32 ``[capacity,
    n_words]``; ``slots[r]`` is the word row of ascending ``row_ids[r]``),
    byte-identical to ``serialize`` on the extracted positions."""
    lib = load()
    row_ids = np.ascontiguousarray(row_ids, dtype=np.uint64)
    slots = np.ascontiguousarray(slots, dtype=np.int64)
    words = np.ascontiguousarray(words, dtype=np.uint32)
    out = _U8P()
    out_len = _SIZE()
    rc = lib.rt_serialize_words(
        row_ids.ctypes.data_as(_U64P), slots.ctypes.data_as(_I64P), row_ids.size,
        words.ctypes.data_as(_U8P), words.shape[-1], flags,
        ctypes.byref(out), ctypes.byref(out_len),
    )
    if rc != 0:
        raise MemoryError("rt_serialize_words: out of memory")
    return _take_bytes(lib, out, out_len)


def deserialize(data: bytes) -> tuple[np.ndarray, int] | None:
    """(sorted positions, op count), or None on a parse failure."""
    lib = load()
    src = _src(data)
    out = _U64P()
    out_n = _SIZE()
    ops = ctypes.c_uint64()
    rc = lib.rt_deserialize(
        src.ctypes.data_as(_U8P), src.size, ctypes.byref(out), ctypes.byref(out_n),
        ctypes.byref(ops),
    )
    if rc != 0:
        return None
    try:
        positions = np.ctypeslib.as_array(out, shape=(out_n.value,)).copy()
    finally:
        lib.rt_free(out)
    return positions, int(ops.value)


def deserialize_into(data: bytes, out: np.ndarray) -> tuple[int, int] | None:
    """Decode ``data`` into the caller's C-contiguous uint64 buffer
    ``out``: ``(count, op_count)``, None on a parse failure; ValueError
    when ``out`` is too small, the capacity needed in the message."""
    lib = load()
    if not (out.dtype == np.uint64 and out.flags["C_CONTIGUOUS"]):
        raise ValueError("staging buffer must be C-contiguous uint64")
    src = _src(data)
    out_n = _SIZE()
    ops = ctypes.c_uint64()
    rc = lib.rt_deserialize_into(
        src.ctypes.data_as(_U8P), src.size, out.ctypes.data_as(_U64P), out.size,
        ctypes.byref(out_n), ctypes.byref(ops),
    )
    if rc == 3:
        raise ValueError(f"staging buffer too small: need {out_n.value}")
    if rc != 0:
        return None
    return int(out_n.value), int(ops.value)


def _decode_row_ids(lib, ptr, size: int, n_words: int):
    """(ascending candidate row ids, op count) of a file, or None."""
    rows = _U64P()
    n_rows = _SIZE()
    ops = ctypes.c_uint64()
    rc = lib.rt_decode_rows(
        ptr, size, n_words * 32, ctypes.byref(rows), ctypes.byref(n_rows),
        ctypes.byref(ops),
    )
    if rc != 0:
        return None
    try:
        row_ids = np.ctypeslib.as_array(rows, shape=(n_rows.value,)).copy()
    finally:
        lib.rt_free(rows)
    return row_ids, int(ops.value)


def decode_words(data: bytes, n_words: int) -> tuple[np.ndarray, np.ndarray, int] | None:
    """``(row_ids, words, op_count)`` of a file at ``n_words`` words a row:
    ascending candidate row ids (uint64), their uint32 ``[n, n_words]``
    words with the op log replayed (a row may be left empty), and the op
    count; None on a parse failure. Two native passes, no positions."""
    got = decode_words_into(data, n_words, None)
    if got is None:
        return None
    row_ids, words, ops = got
    return row_ids, words, ops


def decode_words_into(
    data: bytes, n_words: int, buf: np.ndarray | None
) -> tuple[np.ndarray, np.ndarray, int] | None:
    """:func:`decode_words` into the caller's C-contiguous uint32 buffer
    ``buf`` (a fresh array when None): ``(row_ids, words, op_count)`` with
    ``words`` a ``[n, n_words]`` view of ``buf``; None on a parse failure;
    ValueError when ``buf`` is too small, the size needed last in the
    message."""
    lib = load()
    src = _src(data)
    ptr = src.ctypes.data_as(_U8P)
    got = _decode_row_ids(lib, ptr, src.size, n_words)
    if got is None:
        return None
    row_ids, _ = got
    need = row_ids.size * n_words
    if buf is None:
        buf = np.zeros(need, dtype=np.uint32)
    elif not (buf.dtype == np.uint32 and buf.flags["C_CONTIGUOUS"]):
        raise ValueError("staging buffer must be C-contiguous uint32")
    elif buf.size < need:
        raise ValueError(f"staging buffer too small: need {need}")
    else:
        buf[:need] = 0  # the decode ORs containers in
    words = buf[:need].reshape(row_ids.size, n_words)
    ops = ctypes.c_uint64()
    rc = lib.rt_decode_words(
        ptr, src.size, row_ids.ctypes.data_as(_U64P), row_ids.size, n_words,
        words.ctypes.data_as(_U8P), ctypes.byref(ops),
    )
    if rc != 0:
        return None
    return row_ids, words, int(ops.value)


def popcount(data: bytes | np.ndarray) -> int:
    lib = load()
    arr = np.ascontiguousarray(
        _src(data) if isinstance(data, bytes) else data.view(np.uint8)
    )
    return int(lib.rt_popcount(arr.ctypes.data_as(_U8P), arr.size))


def encode_batch_ops(op_type: int, positions: np.ndarray, chunk: int) -> np.ndarray:
    """The batch op records of ``positions`` in chunks of ``chunk``, back to
    back, as uint8: the bytes of ``roaring.encode_op`` on each chunk,
    joined."""
    lib = load()
    positions = np.ascontiguousarray(positions, dtype=np.uint64)
    n = positions.size
    out = np.empty(-(-n // chunk) * 13 + 8 * n, dtype=np.uint8)
    if out.size:
        lib.rt_encode_batch_ops(
            op_type, positions.ctypes.data_as(_U64P), n, chunk, out.ctypes.data_as(_U8P)
        )
    return out


def fnv32a(h: int, chunk: bytes) -> int:
    """One FNV-1a round over ``chunk``, continuing from ``h``."""
    return int(load().rt_fnv32a(chunk, len(chunk), h))
