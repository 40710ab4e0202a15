"""The port's kernels against the JAX package's Pallas kernels.

On the CPU each wrapper of ``pilosa_tpu_torch.ops.kernels`` computes its
plain PyTorch version; the Pallas kernels run as ``tests/test_kernels.py``
runs them, in interpret mode. Inputs are seeded numpy words handed to
both packages. Counts are integers: every comparison is exact.

The CUDA kernels themselves are held to these plain versions on the card
by ``tests/test_torch_cuda.py``.
"""

# the port's lock witness, installed before the port is imported so that its
# module-level locks are wrapped too (pilosa_tpu_torch/testing/lockwitness.py)
from pilosa_tpu_torch.testing import lockwitness as port_lockwitness

port_lockwitness.install()
# the module fixture that asserts no new inversion among the port's locks
from pilosa_tpu_torch.testing.lockwitness import no_new_inversion  # noqa: F401

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
    tk.cross_gram_gather(bits, bits, [0, 1], [2])
    tk.tree_count((bits,), [0, 1, tk.TREE_AND], [0, 0], np.zeros((2, 2), np.int32))
    tk.tree_words((bits,), [0, 1, tk.TREE_AND], [0, 0], np.zeros(2, np.int32))
    from pilosa_tpu_torch.ops import bsi

    planes, exists, sign = bits[:, 2:], bits[:, 0], bits[:, 1]
    bsi.range_count_batch(planes, exists, sign, [[("<", 1)]], depth=1)
    bsi.range_batch(planes, exists, sign, [[(">", 0)]], depth=1)
    bsi.sum_host(planes, exists, sign, exists, depth=1)
    bsi.min_max_host(planes, exists, sign, exists, depth=1, maximal=True)
    bsi.sum_batch_host(planes, exists, sign, bits[:, :2], depth=1)
    assert tk.LAUNCHES == {
        "row_scan": 0, "masked_row_scan": 0, "gram": 0, "cross_gram": 0,
        "tree_count": 0, "tree_words": 0, "bsi_range": 0, "bsi_sum": 0, "bsi_extreme": 0,
        "bsi_sum_batch": 0,
    }


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
        lambda: tk.cross_gram_gather(
            torch.zeros((2, 3, W), dtype=torch.int64),
            torch.zeros((2, 3, W), dtype=torch.int32), [0], [0],
        ),
        lambda: tk.cross_gram_gather(
            torch.zeros((2, 3, W), dtype=torch.int32),
            torch.zeros((2, 3, W), dtype=torch.int32, device="meta"), [0], [0],
        ),
        lambda: tk.cross_gram_gather(
            torch.zeros((2, 3, W), dtype=torch.int32),
            torch.zeros((2, W, 3), dtype=torch.int32).transpose(1, 2), [0], [0],
        ),
        lambda: tk.cross_gram_gather(
            torch.zeros((2, 3, W), dtype=torch.int32),
            torch.zeros((3, 3, W), dtype=torch.int32), [0], [0],
        ),
        lambda: tk.cross_gram_gather(
            torch.zeros((2, 3, W), dtype=torch.int32),
            torch.zeros((2, 4, W), dtype=torch.int32), [0], [4],
        ),
        lambda: tk.pair_count_two_batched(
            torch.zeros((2, 3, W), dtype=torch.int32),
            torch.zeros((2, 3, W), dtype=torch.int32, device="meta"), [0], [0],
        ),
    ],
    ids=[
        "dtype", "ndim", "contiguity", "filter-shape", "index-range", "device",
        "cross-dtype", "cross-mixed-devices", "cross-contiguity",
        "cross-shard-axis", "cross-index-range", "pair-two-mixed-devices",
    ],
)
def test_wrappers_reject_bad_input(call):
    with pytest.raises((TypeError, ValueError)):
        call()


def test_gram_refuses_int32_unsafe_stack(monkeypatch):
    monkeypatch.setattr(tk, "_GRAM_ACC_LIMIT", W * 32)
    with pytest.raises(ValueError):
        tk.gram_gather(_t(np.zeros((2, 3, W), np.uint32)), [0, 1])


# ---------------------------------------------------------------------------
# Launch plans of the two grams (what the wrapper hands the C entry)
# ---------------------------------------------------------------------------

P = tk.GramPlan


@pytest.mark.parametrize(
    "kind,ua,ub,w,vec16,want",
    [
        # the main path at the serving width: a 64-row field's gram, a pair
        # batch's row subset, the two-field cross gram, the 3-level GroupBy's
        # first level (h's 4 rows against g) and second (256 masks against f)
        ("gram", 64, 64, 32768, True, P(False, True, False, 64, 64)),
        ("gram", 36, 36, 32768, True, P(False, True, False, 64, 64)),
        ("cross", 64, 64, 32768, True, P(False, True, False, 64, 64)),
        ("cross", 4, 64, 32768, True, P(True, True, False, 64, 8)),
        ("cross", 256, 64, 32768, True, P(False, True, False, 256, 64)),
        # narrow N tiles, triangular self-grams, the 128-row M tile, both
        # orientations, ragged W (4-byte copies)
        ("gram", 3, 3, 130, False, P(False, False, False, 64, 8)),
        ("gram", 13, 13, 512, True, P(False, True, False, 64, 16)),
        ("gram", 20, 20, 1024, True, P(False, True, False, 64, 32)),
        ("gram", 65, 65, 132, True, P(False, True, True, 64, 64)),
        ("gram", 300, 300, 256, True, P(False, True, True, 64, 64)),
        ("cross", 5, 100, 130, False, P(True, False, False, 64, 8)),
        ("cross", 100, 5, 130, False, P(False, False, False, 64, 8)),
        ("cross", 35, 110, 132, True, P(True, True, False, 128, 64)),
        ("cross", 150, 100, 256, True, P(False, True, False, 256, 64)),
        ("cross", 4096, 4096, 32768, True, P(False, True, False, 256, 64)),
    ],
)
def test_gram_launch_plan(kind, ua, ub, w, vec16, want):
    if kind == "gram":
        plan = tk.gram_plan(ua, w, vec16)
    else:
        plan = tk.cross_gram_plan(ua, ub, vec16)
    assert plan == want
    tk._check_plan(plan, ua, ub, w, self_gram=kind == "gram")


@pytest.mark.parametrize(
    "make,want",
    [
        (lambda: torch.zeros((2, 3, 32768), dtype=torch.int32), True),
        (lambda: torch.zeros((2, 3, 132), dtype=torch.int32), True),
        (lambda: torch.zeros((2, 3, 130), dtype=torch.int32), False),
        # the k-level prefix [C, S, W] read as [S, C, W]; a shard chunk and
        # a row slice of a stack keep whole 16-byte chunks
        (lambda: torch.zeros((5, 2, 256), dtype=torch.int32).transpose(0, 1), True),
        (lambda: torch.zeros((4, 3, 132), dtype=torch.int32)[1:3], True),
        (lambda: torch.zeros((4, 3, 132), dtype=torch.int32)[:, 1:], True),
        # a view that starts one word in
        (lambda: torch.zeros(2 * 3 * 132 + 1, dtype=torch.int32)[1:].view(2, 3, 132), False),
        (lambda: torch.zeros((5, 3, 130), dtype=torch.int32).transpose(0, 1), False),
    ],
    ids=["stack", "w132", "w130", "prefix", "shard-chunk", "row-slice", "offset-word",
         "prefix-w130"],
)
def test_gram_copy_width(make, want):
    t = make()
    assert tk._copies16(t.shape[2], t) is want


@pytest.mark.parametrize(
    "plan,ua,ub,w,self_gram",
    [
        (P(False, True, False, 64, 24), 20, 20, 256, False),
        (P(False, True, False, 128, 32), 100, 20, 256, False),
        (P(False, True, False, 512, 64), 300, 64, 256, False),
        (P(False, True, False, 64, 64), 64, 64, 130, False),
        (P(False, False, True, 64, 64), 64, 64, 256, False),
        (P(False, True, False, 64, 32), 40, 40, 256, True),
        (P(False, True, True, 64, 32), 70, 70, 256, True),
        (P(False, True, False, 128, 64), 100, 100, 256, True),
        (P(True, True, False, 64, 64), 64, 64, 256, True),
        (P(False, True, True, 64, 64), 300, 300, 130, True),
    ],
    ids=["tile-n-24", "tile-128x32", "tile-m-512", "vec16-w130", "cross-tri",
         "gram-u-past-tile", "gram-tri-n32", "gram-tile-m-128", "gram-swap",
         "gram-vec16-w130"],
)
def test_gram_plan_check_refuses_what_the_kernel_cannot_run(plan, ua, ub, w, self_gram):
    with pytest.raises(ValueError):
        tk._check_plan(plan, ua, ub, w, self_gram=self_gram)


# ---------------------------------------------------------------------------
# The cross-gram family (GroupBy)
# ---------------------------------------------------------------------------

# (S, Ra, Rb): asymmetric rows, S not a multiple of the Pallas shard block
CROSS_SHAPES = [(5, 12, 24), (7, 3, 40), (12, 9, 2)]


@pytest.mark.parametrize("S,Ra,Rb", CROSS_SHAPES)
def test_cross_gram_matches_xla_and_pallas(S, Ra, Rb):
    rng = np.random.default_rng(500 + S * Ra + Rb)
    a = _rand_words(rng, S, Ra, W)
    b = _rand_words(rng, S, Rb, W)
    want = np.asarray(jk.cross_gram_xla(jnp.asarray(a), jnp.asarray(b)))
    pallas = np.asarray(
        jk._cross_gram_pallas(
            jnp.asarray(a), jnp.asarray(b), sb=jk._gram_pallas_sb(S), wb=128
        )
    )
    np.testing.assert_array_equal(pallas, want)
    got = tk.cross_gram_gather_plain(_t(a), _t(b), np.arange(Ra), np.arange(Rb))
    assert got.dtype == torch.int32 and tuple(got.shape) == (Ra, Rb)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tk.cross_gram_gather(_t(a), _t(b), np.arange(Ra), np.arange(Rb)).numpy(),
        want,
    )


@pytest.mark.parametrize("S,Ra,Rb", CROSS_SHAPES)
def test_cross_gram_gather_subsets_match_jax(S, Ra, Rb):
    rng = np.random.default_rng(600 + S * Ra + Rb)
    a = _rand_words(rng, S, Ra, W)
    b = _rand_words(rng, S, Rb, W)
    ia = rng.integers(0, Ra, size=max(1, Ra // 2)).astype(np.int32)
    ib = rng.integers(0, Rb, size=Rb + 1).astype(np.int32)
    want = np.asarray(
        jk.cross_gram_gather_xla(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(ia), jnp.asarray(ib)
        )
    )
    got = tk.cross_gram_gather(_t(a), _t(b), ia, ib)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cross_gram_reads_the_prefix_layout_in_place():
    """Operand A as the transpose(0, 1) view of a contiguous [C, S, W]
    prefix equals the gram of its contiguous [S, C, W] copy."""
    rng = np.random.default_rng(17)
    C, S, R = 6, 5, 11
    prefix = _rand_words(rng, C, S, W)
    bits = _rand_words(rng, S, R, W)
    view = _t(prefix).transpose(0, 1)
    assert not view.is_contiguous()
    idx = [10, 0, 4]
    want = np.asarray(
        jk.cross_gram_gather_xla(
            jnp.asarray(np.transpose(prefix, (1, 0, 2))), jnp.asarray(bits),
            jnp.arange(C), jnp.asarray(idx),
        )
    )
    np.testing.assert_array_equal(
        tk.cross_gram_gather(view, _t(bits), np.arange(C), idx).numpy(), want
    )


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("mode", ["full", "subset"])
def test_cross_pair_gram_matches_jax(monkeypatch, mode, chunked):
    rng = np.random.default_rng(19)
    S, Ra, Rb = 12, 7, 10
    a = _rand_words(rng, S, Ra, W)
    b = _rand_words(rng, S, Rb, W)
    if chunked:
        limit = 5 * W * 32
        monkeypatch.setattr(jk, "_GRAM_ACC_LIMIT", limit)
        monkeypatch.setattr(tk, "_GRAM_ACC_LIMIT", limit)
        assert not tk._gram_int32_safe(S, W)
    if mode == "full":
        ia, ib = list(range(Ra)), list(range(Rb))
    else:
        ia, ib = [6, 0, 3], [9, 2]
    want = jk.cross_pair_gram(jnp.asarray(a), jnp.asarray(b), ia, ib)
    got = tk.cross_pair_gram(_t(a), _t(b), ia, ib)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def test_cross_pair_gram_declines_like_jax():
    a = np.zeros((1, 2, W), np.uint32)
    wide = [0] * (tk.GRAM_MAX_ROWS + 1)
    for ia, ib in ([[], [0]], [[0], []], [wide, [0]], [[0], wide]):
        assert tk.cross_pair_gram(_t(a), _t(a), ia, ib) is None
        assert jk.cross_pair_gram(jnp.asarray(a), jnp.asarray(a), ia, ib) is None


def test_cross_gram_refuses_int32_unsafe_stack(monkeypatch):
    monkeypatch.setattr(tk, "_GRAM_ACC_LIMIT", W * 32)
    bits = _t(np.zeros((2, 3, W), np.uint32))
    with pytest.raises(ValueError):
        tk.cross_gram_gather(bits, bits, [0], [1])


@pytest.mark.parametrize("op", OPS)
def test_pair_count_two_batched_matches_jax(op):
    rng = np.random.default_rng(23)
    S, Ra, Rb, B = 5, 6, 9, 21
    a = _rand_words(rng, S, Ra, W)
    b = _rand_words(rng, S, Rb, W)
    ras = rng.integers(0, Ra, size=B).astype(np.int32)
    rbs = rng.integers(0, Rb, size=B).astype(np.int32)
    want = np.asarray(
        jk.pair_count_two_batched_xla(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(ras), jnp.asarray(rbs),
            op=op,
        )
    )
    got = tk.pair_count_two_batched(_t(a), _t(b), ras, rbs, op=op)
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, S)
    np.testing.assert_array_equal(got.numpy(), want)


def _prefix_case(seed, C, S, R):
    rng = np.random.default_rng(seed)
    return _rand_words(rng, C, S, W), _rand_words(rng, S, R, W), rng


@pytest.mark.parametrize("C,S,R", [(4, 5, 9), (1, 3, 6), (13, 2, 20)])
def test_gather_and_refine_prefix_match_jax(C, S, R):
    _, bits, rng = _prefix_case(700 + C, C, S, R)
    idx = rng.choice(R, size=C, replace=False).astype(np.int32)
    want = np.asarray(jk.gather_prefix(jnp.asarray(bits), jnp.asarray(idx)))
    prefix = tk.gather_prefix(_t(bits), idx)
    assert prefix.is_contiguous() and tuple(prefix.shape) == (C, S, W)
    np.testing.assert_array_equal(prefix.numpy().view(np.uint32), want)
    cis = rng.integers(0, C, size=2 * C + 1).astype(np.int32)
    ris = rng.integers(0, R, size=2 * C + 1).astype(np.int32)
    want_r = np.asarray(
        jk.refine_prefix(jnp.asarray(want), jnp.asarray(bits),
                         jnp.asarray(cis), jnp.asarray(ris))
    )
    got_r = tk.refine_prefix(prefix, _t(bits), cis, ris)
    np.testing.assert_array_equal(got_r.numpy().view(np.uint32), want_r)


def test_refine_prefix_steps_match_one_step(monkeypatch):
    prefix, bits, rng = _prefix_case(31, 5, 3, 8)
    cis = rng.integers(0, 5, size=11)
    ris = rng.integers(0, 8, size=11)
    one = tk.refine_prefix(_t(prefix), _t(bits), cis, ris)
    monkeypatch.setattr(tk, "_PAIR_BATCH_BYTES", 2 * 3 * W * 4 * 2)
    np.testing.assert_array_equal(
        tk.refine_prefix(_t(prefix), _t(bits), cis, ris).numpy(), one.numpy()
    )


@pytest.mark.parametrize("C,S,R", [(4, 5, 9), (1, 3, 6), (13, 2, 20)])
def test_combo_counts_match_jax(C, S, R):
    prefix, bits, rng = _prefix_case(800 + C, C, S, R)
    idx = rng.choice(R, size=min(R, 7), replace=False).astype(np.int32)
    want = np.asarray(
        jk.combo_counts(jnp.asarray(prefix), jnp.asarray(bits), jnp.asarray(idx))
    )
    got = tk.combo_counts(_t(prefix), _t(bits), idx)
    assert got.dtype == torch.int32 and tuple(got.shape) == (C, len(idx), S)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize(
    "C,S,R,n,unsafe",
    [
        (4, 5, 9, 8, False),    # C * n = 32: the gram
        (13, 2, 20, 20, False),
        (4, 5, 9, 7, False),    # C * n = 28 < 32: declines
        (4, 5, 9, 8, True),     # S * W * 32 past the limit: declines
    ],
)
def test_combo_counts_gram_matches_jax(monkeypatch, C, S, R, n, unsafe):
    if unsafe:
        monkeypatch.setattr(jk, "_GRAM_ACC_LIMIT", (S - 1) * W * 32)
        monkeypatch.setattr(tk, "_GRAM_ACC_LIMIT", (S - 1) * W * 32)
    prefix, bits, rng = _prefix_case(900 + C + n, C, S, R)
    idx = rng.choice(R, size=n, replace=False).astype(np.int32)
    want = jk.combo_counts_gram(jnp.asarray(prefix), jnp.asarray(bits), idx)
    got = tk.combo_counts_gram(_t(prefix), _t(bits), idx)
    assert (want is None) == (unsafe or C * n < 32)
    if want is None:
        assert got is None
        return
    assert got.dtype == np.int64 and got.shape == (C, n)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, tk.combo_counts(_t(prefix), _t(bits), idx).numpy().sum(axis=2)
    )


def test_combo_counts_gram_declines_above_max_rows(monkeypatch):
    monkeypatch.setattr(jk, "GRAM_MAX_ROWS", 8)
    monkeypatch.setattr(tk, "GRAM_MAX_ROWS", 8)
    prefix, bits, _ = _prefix_case(41, 9, 2, 5)
    idx = np.arange(4, dtype=np.int32)
    assert jk.combo_counts_gram(jnp.asarray(prefix), jnp.asarray(bits), idx) is None
    assert tk.combo_counts_gram(_t(prefix), _t(bits), idx) is None
