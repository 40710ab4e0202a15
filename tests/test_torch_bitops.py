"""The port's word operations against ``pilosa_tpu.ops.bitops``.

Seeded numpy words go through both packages; the torch popcount runs on
int32 views of the same words, including words with the high bit set.
Every comparison is exact.
"""

import numpy as np
import pytest
import torch

from pilosa_tpu.ops import bitops as jb
from pilosa_tpu_torch.ops import bitops as tb

EDGE_WORDS = np.array(
    [0, 1, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xFFFFFFFF, 0xAAAAAAAA,
     0x55555555, 0xF0F0F0F0, 0x0F0F0F0F, 0xFFFF0000, 0x0000FFFF],
    dtype=np.uint32,
)


def _rand_words(rng, *shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_popcount_matches_numpy(seed):
    rng = np.random.default_rng(seed)
    words = np.concatenate([EDGE_WORDS, _rand_words(rng, 4096)])
    got = tb.popcount(torch.from_numpy(words.view(np.int32)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.bitwise_count(words))
    assert int(got.sum()) == jb.popcount_host(words)


def test_popcount_rejects_other_dtypes():
    with pytest.raises(TypeError):
        tb.popcount(torch.zeros(4, dtype=torch.int64))


def test_count_rows_matches_numpy():
    rng = np.random.default_rng(3)
    words = _rand_words(rng, 3, 5, 64)
    words[0, 0] = 0xFFFFFFFF
    got = tb.count_rows(torch.from_numpy(words.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), np.bitwise_count(words).sum(axis=-1))


@pytest.mark.parametrize("n_words", [4, 128, 512])
def test_pack_unpack_columns_match(n_words):
    rng = np.random.default_rng(n_words)
    cols = rng.integers(0, n_words * 32, size=200)
    cols = np.concatenate([cols, [0, n_words * 32 - 1, 31, 32]])
    packed = tb.pack_columns(cols, n_words)
    np.testing.assert_array_equal(packed, jb.pack_columns(cols, n_words))
    np.testing.assert_array_equal(tb.unpack_columns(packed), jb.unpack_columns(packed))
    np.testing.assert_array_equal(tb.pack_columns([], n_words), jb.pack_columns([], n_words))


def test_pack_positions_matches():
    rng = np.random.default_rng(5)
    n_words = 128
    pos = rng.integers(0, 40 * n_words * 32, size=500).astype(np.uint64)
    got_rows, got_words = tb.pack_positions(pos, n_words)
    want_rows, want_words = jb.pack_positions(pos, n_words)
    np.testing.assert_array_equal(got_rows, want_rows)
    np.testing.assert_array_equal(got_words, want_words)


@pytest.mark.parametrize("op", ["intersect", "union", "difference", "xor"])
def test_pair_count_host_matches(op):
    rng = np.random.default_rng(8)
    a = np.concatenate([EDGE_WORDS, _rand_words(rng, 500)])
    b = np.concatenate([EDGE_WORDS[::-1], _rand_words(rng, 500)])
    assert tb.pair_count_host(a, b, op) == jb.pair_count_host(a, b, op)


def test_popcount_host_matches():
    rng = np.random.default_rng(9)
    words = np.concatenate([EDGE_WORDS, _rand_words(rng, 1000)])
    assert tb.popcount_host(words) == jb.popcount_host(words)
    assert tb.popcount_host(words.reshape(-1, 4)) == jb.popcount_host(words.reshape(-1, 4))


@pytest.mark.parametrize("n", [0, 1, 5, 31, 32, 33, 100, 4000])
def test_shift_row_host_matches(n):
    rng = np.random.default_rng(n)
    words = _rand_words(rng, 128)
    np.testing.assert_array_equal(tb.shift_row_host(words, n), jb.shift_row_host(words, n))


@pytest.mark.parametrize("start,stop", [(0, 0), (0, 1), (3, 70), (31, 33), (64, 4096), (5, 4)])
def test_range_mask_matches(start, stop):
    np.testing.assert_array_equal(
        tb.range_mask(start, stop, 128), jb.range_mask(start, stop, 128)
    )


@pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 5, 1000, 1024, 1025])
def test_pow2_pad_len_matches(n):
    assert tb.pow2_pad_len(n) == jb.pow2_pad_len(n)


def test_device_views_round_trip_without_aliasing():
    words = np.concatenate([EDGE_WORDS, EDGE_WORDS]).reshape(2, -1)
    t = tb.to_device(words, torch.device("cpu"))
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(tb.to_host(t), words)
    t[0, 0] = 12345
    assert words[0, 0] == EDGE_WORDS[0]
