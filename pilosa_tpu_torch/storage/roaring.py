"""Roaring bitmap file codec (counterpart of ``pilosa_tpu/storage/roaring.py``):
Pilosa's 64-bit variant, the official 32-bit spec, and the op log.

Format (reference docs/architecture.md; roaring/roaring.go:1044-1126
writer, :1562-1654 pilosa reader, :5076+ official reader, ops :4415-4610):

Pilosa variant, all little-endian:
  bytes 0-1   magic 12348; byte 2 storage version (0); byte 3 user flags
  bytes 4-7   container count N
  descriptive header, 12 bytes/container: u64 key, u16 type, u16 (card-1)
  offset header, 4 bytes/container: u32 absolute file offset of data
  container data:
      array:  u16 values, sorted
      bitmap: 1024 x u64 words
      run:    u16 run count, then [u16 start, u16 last] inclusive pairs
  op log (optional, to EOF): records
      u8 type; u64 value/len; u32 fnv1a checksum; payload
      types: 0 add, 1 remove, 2 addBatch, 3 removeBatch,
             4 addRoaring, 5 removeRoaring (payload: u32 opN + bytes)

Official spec (read-only interchange): cookie 12346 (+u32 container count)
or 12347 (count in cookie high bits, run bitset present), u16 keys.

Every serving path runs the native codec (``native/roaring_codec.cpp``
through ``storage/_native.py``), and raises where it cannot be built. The
numpy codec beside it (``_serialize_py``, ``_deserialize_py``,
``_apply_ops``, ``_fnv32a_plain``) is its plain version: the tests and
``chip_smoke.py`` hold the native one to it, and no serving path calls it.
"""

from __future__ import annotations

import struct

import numpy as np

from pilosa_tpu_torch.storage import _native

MAGIC = 12348
COOKIE_NO_RUN = 12346  # official spec
COOKIE_RUN = 12347  # official spec w/ run containers

CONTAINER_ARRAY = 1
CONTAINER_BITMAP = 2
CONTAINER_RUN = 3

ARRAY_MAX_SIZE = 4096  # reference roaring.go:1984
RUN_MAX_SIZE = 2048  # reference roaring.go:1987

OP_ADD = 0
OP_REMOVE = 1
OP_ADD_BATCH = 2
OP_REMOVE_BATCH = 3
OP_ADD_ROARING = 4
OP_REMOVE_ROARING = 5

_FNV_OFFSET = 0x811C9DC5
_FNV_PRIME = 0x01000193


def _fnv32a(*chunks: bytes) -> int:
    h = _FNV_OFFSET
    for chunk in chunks:
        h = _native.fnv32a(h, bytes(chunk))
    return h


def _fnv32a_plain(*chunks: bytes) -> int:
    """Plain version of :func:`_fnv32a`."""
    h = _FNV_OFFSET
    for chunk in chunks:
        for b in chunk:
            h ^= b
            h = (h * _FNV_PRIME) & 0xFFFFFFFF
    return h


class RoaringError(Exception):
    pass


# ---------------------------------------------------------------------------
# Serialization
# ---------------------------------------------------------------------------


def serialize_rows(row_ids: np.ndarray, words: np.ndarray, flags: int = 0) -> bytes:
    """Ascending row ids + stacked words [n, n_words] -> roaring file
    bytes, streamed straight off the dense words by the native codec
    (byte-identical to ``serialize`` on the extracted positions)."""
    if not len(row_ids):
        return _native.serialize(np.empty(0, dtype=np.uint64), flags)
    slots = np.arange(len(row_ids), dtype=np.int64)
    return _native.serialize_words(
        np.asarray(row_ids, dtype=np.uint64), slots, words, flags
    )


def serialize(positions: np.ndarray, flags: int = 0) -> bytes:
    """Sorted uint64 bit positions -> Pilosa roaring file bytes (the
    native codec; ``_serialize_py`` is its plain version)."""
    return _native.serialize(positions, flags)


def _serialize_py(positions: np.ndarray, flags: int = 0) -> bytes:
    positions = np.asarray(positions, dtype=np.uint64)
    if positions.size and np.any(positions[1:] <= positions[:-1]):
        positions = np.unique(positions)
    keys = positions >> np.uint64(16)
    lows = (positions & np.uint64(0xFFFF)).astype(np.uint16)
    ukeys, starts = np.unique(keys, return_index=True)
    bounds = np.append(starts, len(positions))

    headers = []
    datas = []
    for i, key in enumerate(ukeys):
        vals = lows[bounds[i] : bounds[i + 1]]
        n = len(vals)
        # runs: count of consecutive-value breaks
        if n:
            breaks = np.flatnonzero(np.diff(vals.astype(np.int64)) != 1)
            run_count = len(breaks) + 1
        else:
            run_count = 0
        array_size = 2 * n
        run_size = 2 + 4 * run_count
        bitmap_size = 8192
        best = min(
            (array_size if n <= ARRAY_MAX_SIZE else 1 << 30, CONTAINER_ARRAY),
            (run_size if run_count <= RUN_MAX_SIZE else 1 << 30, CONTAINER_RUN),
            (bitmap_size, CONTAINER_BITMAP),
            key=lambda t: t[0],
        )
        ctype = best[1]
        if ctype == CONTAINER_ARRAY:
            data = vals.astype("<u2").tobytes()
        elif ctype == CONTAINER_RUN:
            edges = np.concatenate(([0], breaks + 1, [n]))
            runs = np.empty((run_count, 2), dtype="<u2")
            runs[:, 0] = vals[edges[:-1]]
            runs[:, 1] = vals[edges[1:] - 1]
            data = struct.pack("<H", run_count) + runs.tobytes()
        else:
            words = np.zeros(8192, dtype=np.uint8)
            np.bitwise_or.at(
                words, (vals >> np.uint16(3)).astype(np.int64), np.uint8(1) << (vals & np.uint16(7)).astype(np.uint8)
            )
            data = words.tobytes()
        headers.append((int(key), ctype, n))
        datas.append(data)

    count = len(ukeys)
    out = bytearray()
    cookie = MAGIC | (flags << 24)
    out += struct.pack("<II", cookie, count)
    for key, ctype, n in headers:
        out += struct.pack("<QHH", key, ctype, n - 1)
    offset = 8 + count * 12 + count * 4
    for data in datas:
        out += struct.pack("<I", offset)
        offset += len(data)
    for data in datas:
        out += data
    return bytes(out)


# ---------------------------------------------------------------------------
# Deserialization
# ---------------------------------------------------------------------------


def container_stats(positions: np.ndarray) -> dict:
    """Per-container-type counts for sorted uint64 positions, using the
    same array/run/bitmap selection rules as :func:`serialize` — the
    introspection view (/debug/fragments) reports what the codec would
    actually write, without encoding anything."""
    positions = np.asarray(positions, dtype=np.uint64)
    if positions.size and np.any(positions[1:] <= positions[:-1]):
        positions = np.unique(positions)
    counts = {"array": 0, "run": 0, "bitmap": 0}
    keys = positions >> np.uint64(16)
    lows = (positions & np.uint64(0xFFFF)).astype(np.uint16)
    ukeys, starts = np.unique(keys, return_index=True)
    bounds = np.append(starts, len(positions))
    for i in range(len(ukeys)):
        vals = lows[bounds[i] : bounds[i + 1]]
        n = len(vals)
        if n:
            breaks = np.flatnonzero(np.diff(vals.astype(np.int64)) != 1)
            run_count = len(breaks) + 1
        else:
            run_count = 0
        best = min(
            (2 * n if n <= ARRAY_MAX_SIZE else 1 << 30, CONTAINER_ARRAY),
            (2 + 4 * run_count if run_count <= RUN_MAX_SIZE else 1 << 30,
             CONTAINER_RUN),
            (8192, CONTAINER_BITMAP),
            key=lambda t: t[0],
        )
        if best[1] == CONTAINER_ARRAY:
            counts["array"] += 1
        elif best[1] == CONTAINER_RUN:
            counts["run"] += 1
        else:
            counts["bitmap"] += 1
    counts["containers"] = len(ukeys)
    return counts


_CONTAINER_WORDS = 1 << 11  # 2^16 positions of 32-bit words


def container_stats_words(row_ids: np.ndarray, words: np.ndarray) -> dict:
    """:func:`container_stats` of a fragment's rows, read off the dense
    words without making positions: ascending ``row_ids`` with their
    ``uint32 [n, n_words]`` words. Each container is a 2^16-position block
    of the fragment's position space (``row * width + column``); its bits
    and runs are word popcounts summed per block, a run carried across a
    word or row edge only inside one block, as :func:`container_stats`
    sees them. Equal to ``container_stats`` on the positions."""
    counts = {"array": 0, "run": 0, "bitmap": 0, "containers": 0}
    row_ids = np.asarray(row_ids, dtype=np.uint64)
    words = np.asarray(words, dtype=np.uint32)
    if not len(row_ids):
        return counts
    n, W = words.shape
    # the word before each word (its top bit continues a run), zeroed at a
    # block's first word and, where rows share a block, after a row that
    # is not adjacent
    prev = np.zeros_like(words)
    prev[:, 1:] = words[:, :-1]
    if W % _CONTAINER_WORDS == 0:  # each row whole blocks: no carry across rows
        prev[:, ::_CONTAINER_WORDS] = 0
        starts = words & ~((words << np.uint32(1)) | (prev >> np.uint32(31)))
        shape = (n * (W // _CONTAINER_WORDS), _CONTAINER_WORDS)
        n_bits = np.bitwise_count(words).reshape(shape).sum(axis=1, dtype=np.int64)
        n_runs = np.bitwise_count(starts).reshape(shape).sum(axis=1, dtype=np.int64)
    else:
        # word index of every word in the fragment's position space
        widx = row_ids[:, None] * np.uint64(W) + np.arange(W, dtype=np.uint64)[None, :]
        adjacent = np.zeros(n, dtype=bool)
        adjacent[1:] = row_ids[1:] == row_ids[:-1] + np.uint64(1)
        prev[1:, 0] = np.where(adjacent[1:], words[:-1, -1], 0)
        prev[widx % np.uint64(_CONTAINER_WORDS) == 0] = 0
        starts = words & ~((words << np.uint32(1)) | (prev >> np.uint32(31)))
        _, inv = np.unique((widx // np.uint64(_CONTAINER_WORDS)).ravel(), return_inverse=True)
        bits = np.bitwise_count(words).astype(np.int64).ravel()
        runs = np.bitwise_count(starts).astype(np.int64).ravel()
        n_bits = np.bincount(inv, weights=bits).astype(np.int64)
        n_runs = np.bincount(inv, weights=runs).astype(np.int64)
    live = n_bits > 0
    n_bits, n_runs = n_bits[live], n_runs[live]
    big = 1 << 30
    array_cost = np.where(n_bits <= ARRAY_MAX_SIZE, 2 * n_bits, big)
    run_cost = np.where(n_runs <= RUN_MAX_SIZE, 2 + 4 * n_runs, big)
    # the first cheapest in (array, run, bitmap) order, as serialize picks
    is_array = (array_cost <= run_cost) & (array_cost <= 8192)
    is_run = ~is_array & (run_cost <= 8192)
    counts["array"] = int(is_array.sum())
    counts["run"] = int(is_run.sum())
    counts["bitmap"] = int(live.sum() - is_array.sum() - is_run.sum())
    counts["containers"] = int(live.sum())
    return counts


def _container_positions(key: int, ctype: int, card: int, data: bytes, off: int):
    base = np.uint64(key) << np.uint64(16)
    if ctype == CONTAINER_ARRAY:
        vals = np.frombuffer(data, dtype="<u2", count=card, offset=off)
        return base + vals.astype(np.uint64), off + 2 * card
    if ctype == CONTAINER_BITMAP:
        raw = np.frombuffer(data, dtype=np.uint8, count=8192, offset=off)
        bits = np.unpackbits(raw, bitorder="little")
        return base + np.flatnonzero(bits).astype(np.uint64), off + 8192
    if ctype == CONTAINER_RUN:
        (run_count,) = struct.unpack_from("<H", data, off)
        runs = np.frombuffer(
            data, dtype="<u2", count=run_count * 2, offset=off + 2
        ).reshape(-1, 2)
        parts = [
            np.arange(int(s), int(l) + 1, dtype=np.uint64) for s, l in runs
        ]
        vals = np.concatenate(parts) if parts else np.empty(0, dtype=np.uint64)
        return base + vals, off + 2 + 4 * run_count
    raise RoaringError(f"unknown container type {ctype}")


def deserialize(data: bytes) -> np.ndarray:
    """Roaring file bytes (either format) -> sorted uint64 positions,
    with any trailing Pilosa op log applied (reference
    roaring.go:1562-1654 unmarshalPilosaRoaring)."""
    return deserialize_with_opcount(data)[0]


def deserialize_with_opcount(data: bytes) -> tuple[np.ndarray, int]:
    """(positions, op-log record bit count) — the count restores a
    reopened fragment's MaxOpN snapshot trigger (the reference counts ops
    while replaying on open)."""
    if len(data) < 8:
        raise RoaringError("file too short")
    native = _native.deserialize(data)
    if native is None:
        raise _parse_error(data)
    return native


def decode_rows(data: bytes, n_words: int) -> tuple[np.ndarray, np.ndarray, int]:
    """``(row_ids, words, op_count)`` of a fragment file at ``n_words``
    words a row: the ascending ids of the rows holding a bit (uint64),
    their uint32 ``[n, n_words]`` words with the op log replayed, and the
    op count. The open path: decoded by the native codec straight into
    words, no positions made; it equals grouping :func:`deserialize`'s
    positions by row."""
    if len(data) < 8:
        raise RoaringError("file too short")
    native = _native.decode_words(data, n_words)
    if native is None:
        raise _parse_error(data)
    row_ids, words, op_count = native
    keep = words.any(axis=1)
    if not keep.all():
        row_ids, words = row_ids[keep], words[keep]
    return row_ids, words, op_count


def _parse_error(data: bytes) -> RoaringError:
    """The error for a file the native codec could not parse, named as
    the plain reader names it where the header tells."""
    (cookie,) = struct.unpack_from("<I", data, 0)
    magic = cookie & 0xFFFF
    if magic not in (MAGIC, COOKIE_NO_RUN, COOKIE_RUN):
        return RoaringError(f"bad magic {magic}")
    if magic == MAGIC and (cookie >> 16) & 0xFF:
        return RoaringError(f"unsupported storage version {(cookie >> 16) & 0xFF}")
    return RoaringError("corrupt roaring data")


def _deserialize_py(data: bytes) -> tuple[np.ndarray, int]:
    """Plain version of :func:`deserialize_with_opcount`."""
    if len(data) < 8:
        raise RoaringError("file too short")
    (cookie,) = struct.unpack_from("<I", data, 0)
    magic = cookie & 0xFFFF
    if magic == MAGIC:
        return _deserialize_pilosa(data)
    if magic in (COOKIE_NO_RUN, COOKIE_RUN):
        return _deserialize_official(data), 0
    raise RoaringError(f"bad magic {magic}")


def _deserialize_pilosa(data: bytes) -> tuple[np.ndarray, int]:
    (cookie, count) = struct.unpack_from("<II", data, 0)
    version = (cookie >> 16) & 0xFF
    if version != 0:
        raise RoaringError(f"unsupported storage version {version}")
    pos = 8
    keys = []
    types = []
    cards = []
    for _ in range(count):
        key, ctype, card = struct.unpack_from("<QHH", data, pos)
        keys.append(key)
        types.append(ctype)
        cards.append(card + 1)
        pos += 12
    offsets = list(struct.unpack_from(f"<{count}I", data, pos)) if count else []
    pos += 4 * count

    parts = []
    data_end = pos
    for key, ctype, card, off in zip(keys, types, cards, offsets):
        vals, end = _container_positions(key, ctype, card, data, off)
        parts.append(vals)
        data_end = max(data_end, end)
    positions = (
        np.concatenate(parts) if parts else np.empty(0, dtype=np.uint64)
    )
    # op log section
    return _apply_ops(positions, data, data_end)


def _deserialize_official(data: bytes) -> np.ndarray:
    (cookie,) = struct.unpack_from("<I", data, 0)
    magic = cookie & 0xFFFF
    pos = 4
    if magic == COOKIE_RUN:
        count = (cookie >> 16) + 1
        bitset_len = (count + 7) // 8
        run_bitset = np.unpackbits(
            np.frombuffer(data, np.uint8, bitset_len, pos), bitorder="little"
        )[:count]
        pos += bitset_len
    else:
        (count,) = struct.unpack_from("<I", data, pos)
        pos += 4
        run_bitset = np.zeros(count, dtype=np.uint8)

    keys = []
    cards = []
    for _ in range(count):
        key, card = struct.unpack_from("<HH", data, pos)
        keys.append(key)
        cards.append(card + 1)
        pos += 4
    # offset header present when no-run format or >= 4 containers
    has_offsets = magic == COOKIE_NO_RUN or count >= 4
    if has_offsets:
        offsets = list(struct.unpack_from(f"<{count}I", data, pos))
        pos += 4 * count
    else:
        offsets = None

    parts = []
    cur = pos
    for i, (key, card) in enumerate(zip(keys, cards)):
        off = offsets[i] if offsets is not None else cur
        if run_bitset[i]:
            # official run containers: [start, len] pairs (the pilosa
            # variant uses [start, last]), decoded directly here
            (run_count,) = struct.unpack_from("<H", data, off)
            runs = np.frombuffer(
                data, dtype="<u2", count=run_count * 2, offset=off + 2
            ).reshape(-1, 2)
            parts2 = [
                np.arange(int(s), int(s) + int(l) + 1, dtype=np.uint64)
                for s, l in runs
            ]
            vals = (np.uint64(key) << np.uint64(16)) + (
                np.concatenate(parts2) if parts2 else np.empty(0, np.uint64)
            )
            end = off + 2 + 4 * run_count
        else:
            ctype = CONTAINER_ARRAY if card <= ARRAY_MAX_SIZE else CONTAINER_BITMAP
            vals, end = _container_positions(key, ctype, card, data, off)
        parts.append(vals)
        cur = end
    return (
        np.concatenate(parts) if parts else np.empty(0, dtype=np.uint64)
    )


# ---------------------------------------------------------------------------
# Op log
# ---------------------------------------------------------------------------


def encode_op(op_type: int, values=None, roaring: bytes | None = None, op_n: int = 0) -> bytes:
    """One op record (reference roaring.go:4455-4503 op.WriteTo)."""
    if op_type in (OP_ADD, OP_REMOVE):
        head = struct.pack("<BQ", op_type, int(values))
        chk = _fnv32a(head)
        return head + struct.pack("<I", chk)
    if op_type in (OP_ADD_BATCH, OP_REMOVE_BATCH):
        vals = np.asarray(values, dtype="<u8")
        head = struct.pack("<BQ", op_type, len(vals))
        payload = vals.tobytes()
        chk = _fnv32a(head, payload)
        return head + struct.pack("<I", chk) + payload
    if op_type in (OP_ADD_ROARING, OP_REMOVE_ROARING):
        head = struct.pack("<BQ", op_type, len(roaring))
        tail = struct.pack("<I", op_n)
        chk = _fnv32a(head, tail, roaring)
        return head + struct.pack("<I", chk) + tail + roaring
    raise RoaringError(f"unknown op type {op_type}")


def encode_batch_ops(op_type: int, positions: np.ndarray, chunk: int) -> np.ndarray:
    """The ``OP_ADD_BATCH``/``OP_REMOVE_BATCH`` records of ``positions`` in
    chunks of at most ``chunk``, back to back, as a uint8 array: the bytes
    of :func:`encode_op` on each chunk, joined (the plain version is
    :func:`_encode_batch_ops_plain`), in one native pass whose checksums
    run interleaved."""
    if op_type not in (OP_ADD_BATCH, OP_REMOVE_BATCH):
        raise RoaringError(f"not a batch op type: {op_type}")
    return _native.encode_batch_ops(op_type, positions, chunk)


def _encode_batch_ops_plain(op_type: int, positions: np.ndarray, chunk: int) -> bytes:
    """Plain version of :func:`encode_batch_ops`."""
    return b"".join(
        encode_op(op_type, positions[i : i + chunk]) for i in range(0, len(positions), chunk)
    )


def decode_ops(data: bytes, start: int, fnv=_fnv32a):
    """Yield (op_type, values_or_bytes, op_n) from the op-log section;
    stops at EOF or a corrupt record (reference truncates the same way).
    ``fnv`` checks the records (the plain reader passes the plain one)."""
    pos = start
    n = len(data)
    while pos + 13 <= n:
        op_type, value = struct.unpack_from("<BQ", data, pos)
        (chk,) = struct.unpack_from("<I", data, pos + 9)
        head = data[pos : pos + 9]
        if op_type in (OP_ADD, OP_REMOVE):
            if fnv(head) != chk:
                return
            yield op_type, value, 0
            pos += 13
        elif op_type in (OP_ADD_BATCH, OP_REMOVE_BATCH):
            end = pos + 13 + value * 8
            if end > n:
                return
            payload = data[pos + 13 : end]
            if fnv(head, payload) != chk:
                return
            yield op_type, np.frombuffer(payload, dtype="<u8"), 0
            pos = end
        elif op_type in (OP_ADD_ROARING, OP_REMOVE_ROARING):
            end = pos + 17 + value
            if end > n:
                return
            tail = data[pos + 13 : pos + 17]
            roaring_data = data[pos + 17 : end]
            if fnv(head, tail, roaring_data) != chk:
                return
            (op_n,) = struct.unpack("<I", tail)
            yield op_type, bytes(roaring_data), op_n
            pos = end
        else:
            return


def _apply_ops(positions: np.ndarray, data: bytes, start: int) -> tuple[np.ndarray, int]:
    """Plain replay of the op log at ``start`` onto ``positions``."""
    current: set | None = None
    op_count = 0
    for op_type, payload, op_n in decode_ops(data, start, fnv=_fnv32a_plain):
        if current is None:
            current = set(positions.tolist())
        if op_type == OP_ADD:
            current.add(payload)
            op_count += 1
        elif op_type == OP_REMOVE:
            current.discard(payload)
            op_count += 1
        elif op_type == OP_ADD_BATCH:
            current.update(payload.tolist())
            op_count += len(payload)
        elif op_type == OP_REMOVE_BATCH:
            current.difference_update(payload.tolist())
            op_count += len(payload)
        elif op_type == OP_ADD_ROARING:
            current.update(_deserialize_py(payload)[0].tolist())
            op_count += op_n
        elif op_type == OP_REMOVE_ROARING:
            current.difference_update(_deserialize_py(payload)[0].tolist())
            op_count += op_n
    if current is None:
        return positions, 0
    return np.array(sorted(current), dtype=np.uint64), op_count
