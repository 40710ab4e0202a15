"""The port's roaring codec against ``pilosa_tpu.storage.roaring``.

Every container kind, 64-bit keys, the official format, the op log (each
record kind, a torn tail, a bad checksum) and malformed headers go through
the JAX codec, the port's native codec and the port's plain Python codec:
the bytes written are equal, and so are the positions and op counts read.
The word decode of the open path (``roaring.decode_rows``) equals the
positions grouped by row at several shard widths. Then the codec's loader:
a build into ``build/native/``, two processes building at once, and a
missing compiler raising ``NativeBuildError``.
"""

# the port's lock witness, installed before the port is imported so that its
# module-level locks are wrapped too (pilosa_tpu_torch/testing/lockwitness.py)
from pilosa_tpu_torch.testing import lockwitness as port_lockwitness

port_lockwitness.install()
# the module fixture that asserts no new inversion among the port's locks
from pilosa_tpu_torch.testing.lockwitness import no_new_inversion  # noqa: F401

import struct
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from pilosa_tpu.storage import roaring as jr
from pilosa_tpu_torch import nativelib
from pilosa_tpu_torch.storage import _native as tn
from pilosa_tpu_torch.storage import roaring as tr

REPO = Path(__file__).resolve().parents[1]
# words per row of the word-decode checks: narrower than one container,
# one container, and several
WIDTHS = [512, 2048, 4096]


def _positions(case: str) -> np.ndarray:
    rng = np.random.default_rng(len(case))
    if case == "empty":
        return np.empty(0, dtype=np.uint64)
    if case == "array":
        return np.array([1, 5, 100, 65535], dtype=np.uint64)
    if case == "bitmap":
        return np.unique(rng.integers(0, 65536, size=9000)).astype(np.uint64)
    if case == "run":
        return np.arange(10_000, dtype=np.uint64)
    if case == "keys64":
        return np.array([0, 65535, 65536, 1 << 20, (1 << 40) + 7, (1 << 50) + 123456],
                        dtype=np.uint64)
    parts = [  # mixed: every kind, across rows of every width checked
        rng.integers(0, 65536, size=100).astype(np.uint64),
        (1 << 16) + np.unique(rng.integers(0, 65536, size=8000)).astype(np.uint64),
        (2 << 16) + np.arange(30000, dtype=np.uint64),
        (9 << 16) + np.arange(0, 65536, 2, dtype=np.uint64),
        (1 << 33) + rng.integers(0, 1 << 18, size=5000).astype(np.uint64),
    ]
    return np.unique(np.concatenate(parts))


def _grouped(positions: np.ndarray, n_words: int):
    """numpy: ``(row ids, words)`` of positions at ``n_words`` words a row."""
    width = n_words * 32
    rows = positions // np.uint64(width)
    ids = np.unique(rows)
    words = np.zeros((ids.size, n_words), dtype=np.uint32)
    cols = (positions % np.uint64(width)).astype(np.int64)
    np.bitwise_or.at(words, (np.searchsorted(ids, rows), cols >> 5),
                     np.uint32(1) << (cols & 31).astype(np.uint32))
    return ids, words


def _same_decode(data: bytes):
    """Port native, port plain and JAX decode ``data`` alike; the word
    decode equals the positions grouped by row. Returns the positions."""
    want, ops = jr.deserialize_with_opcount(data)
    got, got_ops = tr.deserialize_with_opcount(data)
    plain, plain_ops = tr._deserialize_py(data)
    assert np.array_equal(got, want) and np.array_equal(plain, want)
    assert got_ops == plain_ops == ops
    for n_words in WIDTHS:
        ids, words, w_ops = tr.decode_rows(data, n_words)
        want_ids, want_words = _grouped(want, n_words)
        assert np.array_equal(ids, want_ids) and np.array_equal(words, want_words)
        assert w_ops == ops
    return want


CASES = ["empty", "array", "bitmap", "run", "keys64", "mixed"]


@pytest.mark.parametrize("case", CASES)
def test_serialize_and_deserialize_match_jax(case):
    positions = _positions(case)
    data = tr.serialize(positions)
    assert data == jr.serialize(positions) == tr._serialize_py(positions)
    assert np.array_equal(_same_decode(data), positions)


@pytest.mark.parametrize("case", ["bitmap", "run", "mixed"])
def test_container_kinds_in_header(case):
    """The header names the kind each encoder picked, the same in all
    three (array < run < bitmap on a tie)."""
    data = tr.serialize(_positions(case))
    count = struct.unpack_from("<I", data, 4)[0]
    kinds = [struct.unpack_from("<H", data, 8 + 12 * i + 8)[0] for i in range(count)]
    # mixed: an array, a bitmap, a run, every other bit (32768 runs: a
    # bitmap), and four containers of scattered values (arrays)
    want = {"bitmap": [2], "run": [3], "mixed": [1, 2, 3, 2, 1, 1, 1, 1]}[case]
    assert kinds == want


@pytest.mark.parametrize("n_words", [512, 2048, 4096, 130])
@pytest.mark.parametrize("density", [0.25, 0.001, 0.0])
def test_serialize_rows_matches_jax(n_words, density):
    """The words encoder (the snapshot path) writes JAX's bytes, those of
    the positions encoder, at widths of whole containers and not."""
    rng = np.random.default_rng(int(density * 1000) + n_words)
    ids = np.array([0, 1, 3, 7, 70, 1 << 30], dtype=np.uint64)
    bits = rng.random((ids.size, n_words * 32)) < density
    words = np.packbits(bits, axis=1, bitorder="little").view(np.uint32)
    words[2, : n_words // 4] = 0xFFFFFFFF  # a long run
    data = tr.serialize_rows(ids, words)
    assert data == jr.serialize_rows(ids, words)
    width = np.uint64(n_words * 32)
    r, c = np.nonzero(bits | np.unpackbits(words.view(np.uint8), axis=1,
                                           bitorder="little").astype(bool))
    positions = ids[r] * width + c.astype(np.uint64)
    assert data == tr._serialize_py(positions)
    got_ids, got_words, _ = tr.decode_rows(data, n_words)
    keep = words.any(axis=1)
    assert np.array_equal(got_ids, ids[keep]) and np.array_equal(got_words, words[keep])


def _official(containers, runs: bool) -> bytes:
    """An official-format file (cookie 12346, or 12347 with a run bitset)
    of ``containers``: ``(key, kind, values)`` with kind array, bitmap or
    run ([start, length] pairs)."""
    count = len(containers)
    if runs:
        bitset = np.zeros((count + 7) // 8, dtype=np.uint8)
        for i, (_, kind, _) in enumerate(containers):
            if kind == "run":
                bitset[i // 8] |= 1 << (i % 8)
        head = struct.pack("<I", 12347 | ((count - 1) << 16)) + bitset.tobytes()
    else:
        head = struct.pack("<II", 12346, count)
    datas, keys = [], b""
    for key, kind, vals in containers:
        vals = np.asarray(vals, dtype=np.uint16)
        if kind == "run":
            breaks = np.flatnonzero(np.diff(vals.astype(np.int64)) != 1)
            edges = np.concatenate(([0], breaks + 1, [len(vals)]))
            pairs = [(int(vals[a]), int(vals[b - 1]) - int(vals[a]))
                     for a, b in zip(edges[:-1], edges[1:])]
            datas.append(struct.pack("<H", len(pairs))
                         + b"".join(struct.pack("<HH", *p) for p in pairs))
        elif kind == "bitmap":
            words = np.zeros(8192, dtype=np.uint8)
            np.bitwise_or.at(words, vals >> 3, (1 << (vals & 7)).astype(np.uint8))
            datas.append(words.tobytes())
        else:
            datas.append(vals.astype("<u2").tobytes())
        keys += struct.pack("<HH", key, len(vals) - 1)
    out = head + keys
    if not runs or count >= 4:  # the offset header
        off = len(out) + 4 * count
        for d in datas:
            out += struct.pack("<I", off)
            off += len(d)
    return out + b"".join(datas)


@pytest.mark.parametrize("runs", [False, True])
@pytest.mark.parametrize("n", [1, 3, 5])
def test_official_format_matches_jax(runs, n):
    rng = np.random.default_rng(n + 10 * runs)
    kinds = ["array", "bitmap", "run", "array", "bitmap"]
    containers = []
    for i in range(n):
        kind = kinds[i] if runs or kinds[i] != "run" else "array"
        if kind == "array":
            vals = np.unique(rng.integers(0, 65536, size=50))
        elif kind == "bitmap":
            vals = np.unique(rng.integers(0, 65536, size=6000))
        else:
            vals = np.concatenate([np.arange(10, 400), np.arange(1000, 1003)])
        containers.append((3 * i, kind, vals))
    data = _official(containers, runs)
    want = np.concatenate([(k << 16) + np.asarray(v, dtype=np.uint64)
                           for k, _, v in containers])
    assert np.array_equal(_same_decode(data), want)


def _op_log(base: np.ndarray):
    add = tr.serialize(np.array([7, 9, 1 << 40], dtype=np.uint64))
    rem = tr.serialize(np.array([5, 9], dtype=np.uint64))
    return [
        (tr.OP_ADD, {"values": 10}),
        (tr.OP_REMOVE, {"values": 2}),
        (tr.OP_ADD_BATCH, {"values": [100, 200, 1 << 33]}),
        (tr.OP_REMOVE_BATCH, {"values": list(base[:3]) + [100]}),
        (tr.OP_ADD_ROARING, {"roaring": add, "op_n": 3}),
        (tr.OP_REMOVE_ROARING, {"roaring": rem, "op_n": 2}),
        (tr.OP_ADD_BATCH, {"values": np.arange(70000, 70000 + 5000, dtype=np.uint64)}),
    ]


def test_op_records_and_replay_match_jax():
    base = _positions("mixed")
    data = tr.serialize(base)
    for op, kw in _op_log(base):
        rec = tr.encode_op(op, **kw)
        assert rec == jr.encode_op(op, **kw)
        data += rec
    got = _same_decode(data)
    want = set(base.tolist()) | {10, 100, 200, 1 << 33, 7, 1 << 40}
    want = (want - {2, 100, 5, 9} - set(base[:3].tolist())) | set(range(70000, 75000))
    assert got.tolist() == sorted(want)
    assert tr.deserialize_with_opcount(data)[1] == 1 + 1 + 3 + 4 + 3 + 2 + 5000


def test_op_log_torn_tail_and_bad_checksum_stop_the_replay():
    base = tr.serialize(np.array([1], dtype=np.uint64))
    good = tr.encode_op(tr.OP_ADD, 2)
    torn = tr.encode_op(tr.OP_ADD_BATCH, [3, 4])[:-3]
    assert _same_decode(base + good + torn).tolist() == [1, 2]
    bad = bytearray(tr.encode_op(tr.OP_ADD, 3))
    bad[9] ^= 0xFF
    after = tr.encode_op(tr.OP_ADD, 4)
    assert _same_decode(base + good + bytes(bad) + after).tolist() == [1, 2]
    unknown = struct.pack("<BQ", 9, 0) + struct.pack("<I", 0)
    assert _same_decode(base + unknown + after).tolist() == [1]


@pytest.mark.parametrize(
    "data,message",
    [
        (b"\x00" * 8, "bad magic 0"),
        (struct.pack("<II", 4242, 0), "bad magic 4242"),
        (b"\x3c\x30\x00", "file too short"),
        (struct.pack("<II", 12348 | (1 << 16), 0), "unsupported storage version 1"),
    ],
    ids=["zeros", "magic", "short", "version"],
)
def test_malformed_files_raise_as_jax(data, message):
    with pytest.raises(jr.RoaringError, match=message):
        jr.deserialize_with_opcount(data)
    for decode in (tr.deserialize_with_opcount, tr._deserialize_py,
                   lambda d: tr.decode_rows(d, 512)):
        with pytest.raises(tr.RoaringError, match=message):
            decode(data)


def test_truncated_container_raises():
    data = tr.serialize(_positions("bitmap"))[:-100]
    for decode in (tr.deserialize_with_opcount, lambda d: tr.decode_rows(d, 512)):
        with pytest.raises(tr.RoaringError, match="corrupt roaring data"):
            decode(data)


@pytest.mark.parametrize("n", [0, 1, 9, 1000])
def test_fnv32a_native_and_plain(n):
    chunk = np.random.default_rng(n).integers(0, 256, size=n, dtype=np.uint8).tobytes()
    want = jr._fnv32a(chunk, b"tail")
    assert tr._fnv32a(chunk, b"tail") == tr._fnv32a_plain(chunk, b"tail") == want
    assert tn.popcount(chunk) == int(np.unpackbits(np.frombuffer(chunk, np.uint8)).sum())


@pytest.mark.parametrize("n, chunk", [
    (0, 4), (1, 4), (4, 4), (5, 4), (31, 4), (32, 4), (33, 4), (36, 4), (100, 7),
    (70000, 65536), (9 * 65536 + 5, 65536),
])
@pytest.mark.parametrize("op", [tr.OP_ADD_BATCH, tr.OP_REMOVE_BATCH])
def test_batch_op_records_match_jax(n, chunk, op):
    """One pass over every chunk's record (checksums 8 at a time, then the
    rest one by one) writes the bytes JAX's encode_op writes chunk by chunk,
    and so does the plain version; the records replay to the positions."""
    rng = np.random.default_rng(n)
    pos = np.sort(rng.choice(1 << 22, n, replace=False)).astype(np.uint64)
    pos[-1:] += np.uint64(1 << 40)  # a position past 32 bits
    want = b"".join(jr.encode_op(op, pos[i : i + chunk]) for i in range(0, n, chunk))
    got = tr.encode_batch_ops(op, pos, chunk)
    assert got.dtype == np.uint8 and got.tobytes() == want
    assert tr._encode_batch_ops_plain(op, pos, chunk) == want
    if op == tr.OP_ADD_BATCH:
        assert _same_decode(tr.serialize(np.empty(0, dtype=np.uint64)) + want).tolist() == (
            pos.tolist())


def test_batch_op_records_refuse_other_op_types():
    with pytest.raises(tr.RoaringError, match="not a batch op type"):
        tr.encode_batch_ops(tr.OP_ADD, np.arange(3, dtype=np.uint64), 4)


def test_deserialize_into_a_staging_buffer():
    positions = _positions("mixed")
    data = tr.serialize(positions)
    small = np.empty(10, dtype=np.uint64)
    with pytest.raises(ValueError, match=f"need {positions.size}"):
        tn.deserialize_into(data, small)
    out = np.empty(positions.size + 5, dtype=np.uint64)
    assert tn.deserialize_into(data, out) == (positions.size, 0)
    assert np.array_equal(out[: positions.size], positions)


# -- the loader


def test_codec_builds_into_build_native():
    tn.load()
    lib = nativelib.lib_path(nativelib.NATIVE_SRC / "roaring_codec.cpp")
    assert lib.is_file() and lib.parent.parent == REPO / "build" / "native"


_BUILD_RACE = r"""
import sys, time
from pathlib import Path
sys.path.insert(0, sys.argv[1])
from pilosa_tpu_torch import nativelib
nativelib.BUILD_ROOT = Path(sys.argv[2])
while time.time() < float(sys.argv[3]):
    time.sleep(0.001)
import numpy as np
from pilosa_tpu_torch.storage import roaring
data = roaring.serialize(np.arange(5, dtype=np.uint64))
print("OK", roaring.deserialize(data).tolist())
"""


def test_two_processes_build_the_codec_at_once(tmp_path):
    start = time.time() + 2.0
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _BUILD_RACE, str(REPO), str(tmp_path), str(start)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for _ in range(2)
    ]
    for p in procs:
        out, err = p.communicate(timeout=180)
        assert p.returncode == 0 and out.strip() == "OK [0, 1, 2, 3, 4]", err
    built = [p.name for p in tmp_path.rglob("*") if p.is_file()]
    assert built == ["libroaring_codec.so"]


def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(nativelib, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(nativelib.shutil, "which", lambda name: None)
    monkeypatch.setattr(tn, "_lib", None)
    with pytest.raises(nativelib.NativeBuildError, match="g\\+\\+ not found"):
        tr.serialize(np.arange(3, dtype=np.uint64))
    with pytest.raises(nativelib.NativeBuildError):
        tr.decode_rows(jr.serialize(np.arange(3, dtype=np.uint64)), 512)
    with pytest.raises(nativelib.NativeBuildError):
        tr.encode_op(tr.OP_ADD, 1)


@pytest.mark.parametrize("n_words", [512, 2048, 4096])
@pytest.mark.parametrize("seed", range(4))
def test_container_census_of_words_equals_jax(n_words, seed):
    """/debug/fragments' container census, read off a fragment's words,
    equals JAX's ``container_stats`` of the same bits as positions: arrays,
    runs (across word and adjacent-row edges inside a container) and
    bitmaps, at widths under, at and over one container per row."""
    rng = np.random.default_rng(seed)
    row_ids = np.unique(rng.integers(0, 24, 10)).astype(np.uint64)
    words = np.zeros((len(row_ids), n_words), np.uint32)
    for k in range(len(row_ids)):
        kind = k % 4
        if kind == 0:
            words[k] = rng.integers(0, 2**32, n_words, dtype=np.uint64).astype(np.uint32)
        elif kind == 1:
            words[k, rng.integers(0, n_words, 40)] = 1 << rng.integers(0, 32, 40)
        elif kind == 2:
            a, b = sorted(rng.integers(0, n_words, 2))
            words[k, a:b] = 0xFFFFFFFF
        else:
            words[k] = 0xFFFFFFFF
    width = np.uint64(n_words * 32)
    positions = np.concatenate([
        np.flatnonzero(np.unpackbits(w.view(np.uint8), bitorder="little")).astype(np.uint64)
        + np.uint64(r) * width
        for r, w in zip(row_ids, words)
    ])
    assert tr.container_stats_words(row_ids, words) == jr.container_stats(positions)
    assert tr.container_stats(positions) == jr.container_stats(positions)
