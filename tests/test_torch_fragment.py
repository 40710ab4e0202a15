"""The port's Fragment against ``pilosa_tpu.core.fragment.Fragment``.

The same seeded writes (set, clear, import, mutex, row clears) go to
both fragments, with device syncs in between so dirty rows travel to the
device copy by the port's in-place row copy. Host rows, maintained row
counts and device copies must be equal.
"""

# the port's lock witness, installed before the port is imported so that its
# module-level locks are wrapped too (pilosa_tpu_torch/testing/lockwitness.py)
from pilosa_tpu_torch.testing import lockwitness as port_lockwitness

port_lockwitness.install()
# the module fixture that asserts no new inversion among the port's locks
from pilosa_tpu_torch.testing.lockwitness import no_new_inversion  # noqa: F401

import numpy as np
import pytest
import torch

from pilosa_tpu.core.fragment import Fragment as JaxFragment
from pilosa_tpu_torch.core.fragment import Fragment as TorchFragment
from pilosa_tpu_torch.ops import bitops as tb
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, SHARD_WORDS

N_ROWS = 12


def _pair():
    return JaxFragment("i", "f", "standard", 0), TorchFragment(
        "i", "f", "standard", 0, device="cpu"
    )


def _assert_same(jf, tf):
    j_ids, j_mat = jf.rows_matrix_host()
    t_ids, t_mat = tf.rows_matrix_host()
    assert j_ids == t_ids
    np.testing.assert_array_equal(j_mat, t_mat)
    j_rc = jf.row_counts()
    t_rc = tf.row_counts()
    assert j_rc[0] == t_rc[0]
    np.testing.assert_array_equal(j_rc[1], t_rc[1])
    assert jf.row_ids() == tf.row_ids()
    j_snap, t_snap = jf.snapshot_rows(), tf.snapshot_rows()
    np.testing.assert_array_equal(j_snap[0], t_snap[0])
    np.testing.assert_array_equal(j_snap[1], t_snap[1])
    j_rows, t_rows = jf.to_host_rows(), tf.to_host_rows()
    assert sorted(j_rows) == sorted(t_rows)
    for r in j_rows:
        np.testing.assert_array_equal(j_rows[r], t_rows[r])


def _assert_same_device(jf, tf):
    want = np.asarray(jf.device_bits())
    got = tf.device_bits()
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(tb.to_host(got), want)
    tf.check_invariants(device=True)


def _random_writes(rng, jf, tf, n, kinds):
    for _ in range(n):
        kind = kinds[int(rng.integers(0, len(kinds)))]
        row = int(rng.integers(0, N_ROWS))
        col = int(rng.integers(0, SHARD_WIDTH))
        if kind == "set":
            assert jf.set_bit(row, col) == tf.set_bit(row, col)
        elif kind == "clear":
            assert jf.clear_bit(row, col) == tf.clear_bit(row, col)
        elif kind == "mutex":
            assert jf.set_mutex(row, col) == tf.set_mutex(row, col)
        elif kind == "clear_row":
            assert jf.clear_row(row) == tf.clear_row(row)
        elif kind in ("import", "import_clear"):
            m = int(rng.integers(1, 300))
            rows = rng.integers(0, N_ROWS, size=m).astype(np.uint64)
            cols = rng.integers(0, SHARD_WIDTH, size=m).astype(np.int64)
            clear = kind == "import_clear"
            assert jf.import_bits(rows, cols, clear=clear) == tf.import_bits(
                rows, cols, clear=clear
            )
        else:
            raise AssertionError(kind)


@pytest.mark.parametrize("seed", range(4))
def test_point_writes_match(seed):
    rng = np.random.default_rng(seed)
    jf, tf = _pair()
    _random_writes(rng, jf, tf, 400, ["set", "set", "clear"])
    _assert_same(jf, tf)
    _assert_same_device(jf, tf)


@pytest.mark.parametrize("seed", range(4))
def test_mixed_writes_with_device_syncs_match(seed):
    rng = np.random.default_rng(100 + seed)
    jf, tf = _pair()
    kinds = ["set", "clear", "mutex", "clear_row", "import", "import_clear"]
    for _ in range(6):
        _random_writes(rng, jf, tf, 40, kinds)
        _assert_same(jf, tf)
        # a few dirty rows after the first sync go up as an in-place copy
        _assert_same_device(jf, tf)


def test_dirty_rows_sync_in_place():
    _, tf = _pair()
    for r in range(4):
        tf.set_bit(r, r)
    dev = tf.device_bits()
    assert tuple(dev.shape) == (tf.capacity + 1, SHARD_WORDS)
    tf.set_bit(2, 100)
    tf.clear_bit(0, 0)
    again = tf.device_bits()
    assert again is dev  # same capacity: rows copied into the tensor
    np.testing.assert_array_equal(tb.to_host(again)[: tf.capacity], tf._host)
    assert not tb.to_host(again)[tf.capacity].any()


def test_row_reads_match():
    rng = np.random.default_rng(7)
    jf, tf = _pair()
    _random_writes(rng, jf, tf, 300, ["set", "import"])
    for r in range(N_ROWS + 2):  # two absent rows read as zeros
        np.testing.assert_array_equal(jf.row_words_host(r), tf.row_words_host(r))
        np.testing.assert_array_equal(
            np.asarray(jf.row_device(r)), tb.to_host(tf.row_device(r))
        )
    rows = [3, N_ROWS + 5, 0, 3]
    np.testing.assert_array_equal(
        np.asarray(jf.rows_device(rows)), tb.to_host(tf.rows_device(rows))
    )


@pytest.mark.parametrize("op", ["intersect", "union", "difference", "xor"])
def test_row_pair_count_matches(op):
    rng = np.random.default_rng(11)
    jf, tf = _pair()
    _random_writes(rng, jf, tf, 300, ["set", "import"])
    for ra, rb in [(0, 1), (2, 2), (3, N_ROWS + 1), (N_ROWS + 1, 4), (N_ROWS, N_ROWS + 1)]:
        assert jf.row_pair_count(ra, rb, op) == tf.row_pair_count(ra, rb, op)


def test_load_host_rows_matches():
    rng = np.random.default_rng(12)
    rows = {
        int(r): rng.integers(0, 2**32, size=SHARD_WORDS, dtype=np.uint64).astype(np.uint32)
        for r in rng.choice(1000, size=9, replace=False)
    }
    jf, tf = _pair()
    jf.load_host_rows(rows)
    tf.load_host_rows(rows)
    _assert_same(jf, tf)
    _assert_same_device(jf, tf)


def test_hashed_row_ids():
    jf, tf = _pair()
    big = [2**63 + 5, 2**40, 7]
    for r in big:
        assert jf.set_bit(r, 9) == tf.set_bit(r, 9)
    rows = np.array(big * 3, dtype=np.uint64)
    cols = np.arange(9, dtype=np.int64)
    assert jf.import_bits(rows, cols) == tf.import_bits(rows, cols)
    _assert_same(jf, tf)


@pytest.mark.parametrize("seed", range(4))
def test_import_row_words_counts_and_merges_as_jax_import_bits(seed):
    """A roaring import's rows merged as words change what JAX's
    ``import_bits`` of the same positions changes, and count the same
    changed bits, setting and clearing, over rows old and new."""
    rng = np.random.default_rng(seed)
    jf, tf = _pair()
    base_rows = rng.integers(0, N_ROWS, 3000).astype(np.uint64)
    base_cols = rng.integers(0, SHARD_WIDTH, 3000)
    jf.import_bits(base_rows, base_cols)
    tf.import_bits(base_rows, base_cols)
    for clear in (False, True, False):
        rows = np.unique(rng.integers(0, N_ROWS + 3, 5)).astype(np.uint64)
        words = np.zeros((len(rows), SHARD_WORDS), np.uint32)
        r_of, c_of = [], []
        for k, r in enumerate(rows):
            cols = np.unique(rng.integers(0, SHARD_WIDTH, 400))
            words[k] = tb.pack_columns(cols, SHARD_WORDS)
            r_of.append(np.full(len(cols), r, np.uint64))
            c_of.append(cols)
        want = jf.import_bits(np.concatenate(r_of), np.concatenate(c_of), clear=clear)
        assert tf.import_row_words(rows, words, clear=clear) == want
        _assert_same(jf, tf)
