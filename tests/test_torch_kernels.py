"""The port's kernels against the JAX package's Pallas kernels.

On the CPU each wrapper of ``pilosa_tpu_torch.ops.kernels`` computes its
plain PyTorch version; the Pallas kernels run as ``tests/test_kernels.py``
runs them, in interpret mode. Inputs are seeded numpy words handed to
both packages. Counts are integers: every comparison is exact.

The CUDA kernels themselves are held to these plain versions on the card
by ``tests/test_torch_cuda.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pilosa_tpu.ops import kernels as jk
from pilosa_tpu_torch.ops import kernels as tk

W = 512  # words per row at the tests' 2^14 shard width

SHAPES = [(s, r) for s in (1, 5, 12) for r in (3, 8, 13, 40)]
OPS = ["intersect", "union", "difference", "xor"]


def _rand_words(rng, *shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)


def _t(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32))


@pytest.mark.parametrize("S,R", SHAPES)
def test_row_scan_matches_pallas(S, R):
    rng = np.random.default_rng(100 * S + R)
    bits = _rand_words(rng, S, R, W)
    want = np.asarray(jk.row_counts_per_shard_pallas(jnp.asarray(bits)))
    got = tk.row_counts_per_shard(_t(bits))
    assert got.dtype == torch.int32 and tuple(got.shape) == (S, R)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tk.row_counts(_t(bits)).numpy(), want.sum(axis=0)
    )


@pytest.mark.parametrize("S,R", SHAPES)
def test_masked_row_scan_matches_pallas(S, R):
    rng = np.random.default_rng(200 * S + R)
    bits = _rand_words(rng, S, R, W)
    filt = _rand_words(rng, S, W)
    want = np.asarray(
        jk.masked_row_counts_pallas(jnp.asarray(bits), jnp.asarray(filt))
    )
    got = tk.masked_row_counts_per_shard(_t(bits), _t(filt))
    assert got.dtype == torch.int32 and tuple(got.shape) == (S, R)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tk.masked_row_counts(_t(bits), _t(filt)), want.astype(np.int64).sum(axis=0)
    )


@pytest.mark.parametrize("S,R", SHAPES)
def test_gram_matches_pallas(S, R):
    rng = np.random.default_rng(300 * S + R)
    bits = _rand_words(rng, S, R, W)
    # the TPU word block declines below 8 rows; interpret mode takes any
    wb = jk._gram_pallas_wb(R, W) or W
    want = np.asarray(
        jk._gram_matrix_pallas(jnp.asarray(bits), sb=jk._gram_pallas_sb(S), wb=wb)
    )
    got = tk.gram_gather(_t(bits), np.arange(R))
    assert got.dtype == torch.int32 and tuple(got.shape) == (R, R)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("S,R", [(5, 13), (12, 40)])
def test_gram_gather_subset_matches_pallas(S, R):
    rng = np.random.default_rng(400 * S + R)
    bits = _rand_words(rng, S, R, W)
    idx = np.array(sorted(rng.choice(R, size=R // 2 + 1, replace=False)), np.int32)
    want = np.asarray(
        jk._gram_matrix_pallas(
            jnp.asarray(bits[:, idx]), sb=jk._gram_pallas_sb(S), wb=W
        )
    )
    np.testing.assert_array_equal(tk.gram_gather(_t(bits), idx).numpy(), want)


@pytest.mark.parametrize("mode", ["full", "subset"])
@pytest.mark.parametrize("chunked", [False, True])
def test_pair_gram_matches_jax(monkeypatch, mode, chunked):
    rng = np.random.default_rng(7)
    S, R = 12, 13
    bits = _rand_words(rng, S, R, W)
    if chunked:
        # a limit of 5 shards' worth forces shard chunks summed in int64
        limit = 5 * W * 32
        monkeypatch.setattr(jk, "_GRAM_ACC_LIMIT", limit)
        monkeypatch.setattr(tk, "_GRAM_ACC_LIMIT", limit)
        assert not tk._gram_int32_safe(S, W)
    idx = list(range(R)) if mode == "full" else [0, 3, 4, 9, 12]
    want = jk.pair_gram(jnp.asarray(bits), idx)
    got = tk.pair_gram(_t(bits), idx)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def test_pair_gram_declines_above_max_rows():
    bits = _t(np.zeros((1, 2, W), np.uint32))
    idx = [0] * (tk.GRAM_MAX_ROWS + 1)
    assert tk.GRAM_MAX_ROWS == jk.GRAM_MAX_ROWS
    assert tk.pair_gram(bits, idx) is None
    assert jk.pair_gram(jnp.zeros((1, 2, W), jnp.uint32), idx) is None
    assert tk.pair_gram(bits, []) is None


@pytest.mark.parametrize("op", OPS)
def test_pair_counts_from_gram_matches_jax(op):
    rng = np.random.default_rng(11)
    S, R = 5, 13
    bits = _rand_words(rng, S, R, W)
    gram = tk.pair_gram(_t(bits), list(range(R)))
    pa = rng.integers(0, R, size=20)
    pb = rng.integers(0, R, size=20)
    got = tk.pair_counts_from_gram(gram, pa, pb, op)
    np.testing.assert_array_equal(got, jk.pair_counts_from_gram(gram, pa, pb, op))
    truth = [
        int(np.bitwise_count(jk._OPS[op](bits[:, a], bits[:, b])).sum())
        for a, b in zip(pa, pb)
    ]
    assert got.tolist() == truth


@pytest.mark.parametrize("op", OPS)
def test_pair_count_batched_matches_jax(op):
    rng = np.random.default_rng(13)
    S, R, B = 5, 13, 17
    bits = _rand_words(rng, S, R, W)
    ras = rng.integers(0, R, size=B).astype(np.int32)
    rbs = rng.integers(0, R, size=B).astype(np.int32)
    want = np.asarray(
        jk.pair_count_batched_xla(
            jnp.asarray(bits), jnp.asarray(ras), jnp.asarray(rbs), op=op
        )
    )
    got = tk.pair_count_batched(_t(bits), ras, rbs, op=op)
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, S)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_wrappers_do_not_count_launches():
    tk.reset_launches()
    bits = _t(np.ones((2, 3, W), np.uint32))
    tk.row_counts_per_shard(bits)
    tk.masked_row_counts_per_shard(bits, bits[:, 0].contiguous())
    tk.gram_gather(bits, [0, 1, 2])
    assert tk.LAUNCHES == {"row_scan": 0, "masked_row_scan": 0, "gram": 0}


@pytest.mark.parametrize(
    "call",
    [
        lambda: tk.row_counts_per_shard(torch.zeros((2, 3, W), dtype=torch.int64)),
        lambda: tk.row_counts_per_shard(torch.zeros((3, W), dtype=torch.int32)),
        lambda: tk.row_counts_per_shard(
            torch.zeros((2, W, 3), dtype=torch.int32).transpose(1, 2)
        ),
        lambda: tk.masked_row_counts_per_shard(
            torch.zeros((2, 3, W), dtype=torch.int32),
            torch.zeros((3, W), dtype=torch.int32),
        ),
        lambda: tk.gram_gather(torch.zeros((2, 3, W), dtype=torch.int32), [0, 3]),
        lambda: tk.row_counts_per_shard(
            torch.zeros((2, 3, W), dtype=torch.int32, device="meta")
        ),
    ],
    ids=["dtype", "ndim", "contiguity", "filter-shape", "index-range", "device"],
)
def test_wrappers_reject_bad_input(call):
    with pytest.raises((TypeError, ValueError)):
        call()


def test_gram_refuses_int32_unsafe_stack(monkeypatch):
    monkeypatch.setattr(tk, "_GRAM_ACC_LIMIT", W * 32)
    with pytest.raises(ValueError):
        tk.gram_gather(_t(np.zeros((2, 3, W), np.uint32)), [0, 1])
