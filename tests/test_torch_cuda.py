"""The port on the card: each CUDA kernel against its plain version, and
the executor on ``cuda`` against the same executor on the CPU.

Every test here needs a CUDA device and skips where there is none. The
file imports no JAX, so it runs on a machine with a card and no JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
Counts are integers: every comparison is exact.
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

from pilosa_tpu_torch.ops import bsi as tb
from pilosa_tpu_torch.ops import kernels as tk
from pilosa_tpu_torch.testing import meshcases

pytestmark = pytest.mark.cuda

# (S, R, W): one and many tiles, W not a multiple of 4 (the scans' word
# path), rows below 8 and above one 64-row gram tile
SHAPES = [(1, 3, 128), (5, 13, 512), (12, 40, 1024), (9, 70, 132), (3, 7, 130)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _words(rng, *shape) -> torch.Tensor:
    w = rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(w.view(np.int32))


@pytest.mark.parametrize("S,R,W", SHAPES)
def test_scans_match_plain(cuda_device, S, R, W):
    rng = np.random.default_rng(S * R * W)
    bits = _words(rng, S, R, W).to(cuda_device)
    filt = _words(rng, S, W).to(cuda_device)
    before = dict(tk.LAUNCHES)
    got = tk.row_counts_per_shard(bits)
    got_m = tk.masked_row_counts_per_shard(bits, filt)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["row_scan"] == before["row_scan"] + 1
    assert tk.LAUNCHES["masked_row_scan"] == before["masked_row_scan"] + 1
    assert torch.equal(got, tk.row_counts_per_shard_plain(bits))
    assert torch.equal(got_m, tk.masked_row_counts_per_shard_plain(bits, filt))


@pytest.mark.parametrize("S,R,W", SHAPES)
def test_gram_matches_plain(cuda_device, S, R, W):
    rng = np.random.default_rng(S + R + W)
    bits = _words(rng, S, R, W).to(cuda_device)
    idx = np.array(sorted(rng.choice(R, size=max(1, R // 2), replace=False)))
    before = tk.LAUNCHES["gram"]
    got_full = tk.gram_gather(bits, np.arange(R))
    got_sub = tk.gram_gather(bits, idx)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["gram"] == before + 2
    assert torch.equal(got_full, tk.gram_gather_plain(bits, np.arange(R)))
    assert torch.equal(got_sub, tk.gram_gather_plain(bits, idx))


def test_chunked_pair_gram_matches_plain(cuda_device, monkeypatch):
    rng = np.random.default_rng(5)
    S, R, W = 11, 9, 256
    bits = _words(rng, S, R, W).to(cuda_device)
    want = tk.pair_gram(bits, list(range(R)))
    monkeypatch.setattr(tk, "_GRAM_ACC_LIMIT", 3 * W * 32)
    before = tk.LAUNCHES["gram"]
    got = tk.pair_gram(bits, list(range(R)))
    assert tk.LAUNCHES["gram"] == before + 4  # shard chunks of 3, 3, 3, 2
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, tk.gram_gather_plain(bits, np.arange(R)).cpu().numpy()
    )


@pytest.mark.parametrize("S,R,W", SHAPES)
def test_cross_gram_matches_plain(cuda_device, S, R, W):
    rng = np.random.default_rng(S * 7 + R + W)
    a = _words(rng, S, R, W).to(cuda_device)
    b = _words(rng, S, R + 37, W).to(cuda_device)
    ia = np.array(sorted(rng.choice(R, size=max(1, R // 2), replace=False)))
    ib = rng.integers(0, R + 37, size=R + 40)  # past one 64-row tile
    before = tk.LAUNCHES["cross_gram"]
    got = tk.cross_gram_gather(a, b, ia, ib)
    got_t = tk.cross_gram_gather(b, a, ib, ia)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["cross_gram"] == before + 2
    want = tk.cross_gram_gather_plain(a, b, ia, ib)
    assert torch.equal(got, want)
    assert torch.equal(got_t, want.T)


@pytest.mark.parametrize("C,S,R,W", [(5, 13, 100, 130), (70, 3, 9, 256), (1, 4, 6, 128)])
def test_cross_gram_reads_prefix_layout(cuda_device, C, S, R, W):
    rng = np.random.default_rng(C * S * R)
    prefix = _words(rng, C, S, W).to(cuda_device)
    bits = _words(rng, S, R, W).to(cuda_device)
    idx = rng.integers(0, R, size=R)
    view = prefix.transpose(0, 1)
    got = tk.cross_gram_gather(view, bits, np.arange(C), idx)
    want = tk.cross_gram_gather_plain(
        view.contiguous(), bits, np.arange(C), idx
    )
    assert torch.equal(got, want)
    combo = tk.combo_counts_gram(prefix, bits, idx)
    if combo is not None:
        np.testing.assert_array_equal(
            combo,
            tk.combo_counts(prefix, bits, idx).to(torch.int64).sum(dim=2).cpu().numpy(),
        )


def test_chunked_cross_pair_gram_matches_plain(cuda_device, monkeypatch):
    rng = np.random.default_rng(6)
    S, Ra, Rb, W = 11, 5, 80, 256
    a = _words(rng, S, Ra, W).to(cuda_device)
    b = _words(rng, S, Rb, W).to(cuda_device)
    want = tk.cross_pair_gram(a, b, list(range(Ra)), list(range(Rb)))
    monkeypatch.setattr(tk, "_GRAM_ACC_LIMIT", 3 * W * 32)
    before = tk.LAUNCHES["cross_gram"]
    got = tk.cross_pair_gram(a, b, list(range(Ra)), list(range(Rb)))
    assert tk.LAUNCHES["cross_gram"] == before + 4  # shard chunks of 3, 3, 3, 2
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got,
        tk.cross_gram_gather_plain(a, b, np.arange(Ra), np.arange(Rb)).cpu().numpy(),
    )


def test_executor_on_cuda_matches_cpu(cuda_device):
    from pilosa_tpu_torch.core.field import FieldOptions
    from pilosa_tpu_torch.core.holder import Holder
    from pilosa_tpu_torch.exec.executor import Executor
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    rng = np.random.default_rng(9)
    executors = []
    for dev in ("cpu", cuda_device):
        h = Holder(device=dev)
        idx = h.create_index("i")
        idx.create_field("f")
        idx.create_field("g")
        executors.append(Executor(h))
    n_cols = 3 * SHARD_WIDTH
    sets = [
        " ".join(
            f"Set({int(c)}, {fld}={int(r)})"
            for r, c in zip(rng.integers(0, 9, 3000), rng.integers(0, n_cols, 3000))
        )
        for fld in ("f", "g")
    ]
    # TopN first on each snapshot: once the full gram is cached, its
    # diagonal serves the tanimoto row totals instead of the row scan
    topn = "TopN(f, Row(f=3), n=5, tanimotoThreshold=1) TopN(f, n=4)"
    pairs = " ".join(
        f"Count({op}(Row(f={int(a)}), Row(f={int(b)})))"
        for op, a, b in zip(
            rng.choice(["Intersect", "Union", "Difference", "Xor"], 64),
            rng.integers(0, 9, 64),
            rng.integers(0, 9, 64),
        )
    )
    # two fields (the cross gram), a filter and three levels (the cross
    # gram over prefix masks), one filtered level (the masked row scan)
    # and a page
    groupby = (
        "GroupBy(Rows(f), Rows(g)) GroupBy(Rows(g), Rows(f), filter=Row(f=3)) "
        "GroupBy(Rows(f), Rows(g), Rows(f), limit=50) GroupBy(Rows(g), filter=Row(f=3)) "
        "GroupBy(Rows(f), Rows(g), Rows(f), previous=[4, 2, 6])"
    )
    # compiled trees: two Counts of one shape (the tree count) and a bitmap
    # tree (the tree words)
    trees = (
        "Count(Intersect(Row(f=1), Row(g=2), Row(f=3))) "
        "Count(Intersect(Row(f=4), Row(g=5), Row(f=6))) Union(Row(f=0), Row(g=0), Row(g=7))"
    )

    # an int field: the aggregates build its stack (the sum and the
    # extreme), then a range count and a bitmap condition read it (the
    # range scan), a GroupBy filtered by a condition, and three filtered
    # Sums, one flight (the batched sum)
    values = " ".join(
        f"Set({int(c)}, v={int(x)})"
        for c, x in zip(rng.integers(0, n_cols, 2000), rng.integers(-500, 1000, 2000))
    )
    bsi = (
        "Sum(field=v) Sum(Row(f=3), field=v) Min(field=v) Max(Row(g=1), field=v) "
        "Count(Row(v < 40)) Row(-20 <= v < 300) GroupBy(Rows(f), filter=Row(v > 100)) "
        "Sum(Row(f=1), field=v) Sum(Intersect(Row(f=2), Row(g=1)), field=v)"
    )

    def plain(r):
        if isinstance(r, int):
            return r
        if hasattr(r, "columns"):
            return r.columns().tolist()
        if hasattr(r, "value"):
            return (r.value, r.count)
        return [
            (p.id, p.count) if hasattr(p, "id")
            else ([(g.field, g.row_id) for g in p.group], p.count)
            for p in r
        ]

    before = dict(tk.LAUNCHES)
    out = []
    for e in executors:
        e.holder.index("i").create_field(
            "v", FieldOptions(field_type="int", min_=-500, max_=1000))
        for q in sets + [values]:
            e.execute("i", q)
        res = e.execute("i", topn) + e.execute("i", pairs) + e.execute("i", groupby)
        res += e.execute("i", trees) + e.execute("i", bsi)
        e.execute("i", "Clear(5, f=1) Set(6, f=1) ClearRow(f=2) Set(7, g=4) Set(8, v=999)")
        res += e.execute("i", topn) + e.execute("i", pairs) + e.execute("i", groupby)
        res += e.execute("i", trees) + e.execute("i", bsi)
        out.append([plain(r) for r in res])
    assert out[0] == out[1]
    for k in tk.LAUNCHES:
        assert tk.LAUNCHES[k] > before[k], k


# -- the branches of the tensor-core tile loop (ops/csrc/gram_tile.cuh),
#    each held exactly to the plain version; `plan` is what the wrapper hands
#    the C entry


@pytest.mark.parametrize(
    "S,Ra,Rb,W,ua,ub,plan",
    [
        # orientation: a side below 8 rows against one past 64, both ways
        (4, 6, 120, 256, 5, 100, (True, True, False, 64, 8)),
        (4, 120, 6, 256, 100, 5, (False, True, False, 64, 8)),
        # 4-byte copies with a zero-filled tail, and 16-byte ones at W % 8 != 0
        (3, 7, 90, 130, 70, 90, (True, False, False, 128, 64)),
        (3, 90, 7, 132, 90, 7, (False, True, False, 64, 8)),
        # every N width, and M tiles of 128 and 256 rows beside N = 64
        (2, 20, 40, 264, 12, 20, (True, True, False, 64, 16)),
        (2, 40, 40, 264, 30, 40, (True, True, False, 64, 32)),
        (2, 300, 70, 256, 260, 70, (False, True, False, 256, 64)),
    ],
)
def test_cross_gram_plans_match_plain(cuda_device, S, Ra, Rb, W, ua, ub, plan):
    rng = np.random.default_rng(S * 1000 + ua * 7 + ub)
    a = _words(rng, S, Ra, W).to(cuda_device)
    b = _words(rng, S, Rb, W).to(cuda_device)
    # unsorted rows with repeats on both sides
    ia = rng.integers(0, Ra, size=ua)
    ib = rng.integers(0, Rb, size=ub)
    assert tk.cross_gram_plan(ua, ub, tk._copies16(W, a, b)) == tk.GramPlan(*plan)
    before = tk.LAUNCHES["cross_gram"]
    got = tk.cross_gram_gather(a, b, ia, ib)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["cross_gram"] == before + 1
    assert torch.equal(got, tk.cross_gram_gather_plain(a, b, ia, ib))


@pytest.mark.parametrize(
    "S,R,W,U,tri",
    [
        # one tile, its N rows staged once with its M rows
        (3, 9, 130, 5, False),
        (2, 40, 132, 30, False),
        # triangular 64 x 64 tiles mirrored, diagonal tiles staged once
        (3, 80, 130, 65, True),
        (2, 310, 256, 300, True),
        (4, 100, 264, 150, True),
    ],
)
def test_gram_plans_match_plain(cuda_device, S, R, W, U, tri):
    rng = np.random.default_rng(S * 100 + U)
    bits = _words(rng, S, R, W).to(cuda_device)
    idx = rng.integers(0, R, size=U)  # unsorted, with repeats
    plan = tk.gram_plan(U, W, tk._copies16(W, bits))
    assert plan.tri is tri and plan.vec16 is (W % 4 == 0)
    before = tk.LAUNCHES["gram"]
    got = tk.gram_gather(bits, idx)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["gram"] == before + 1
    assert torch.equal(got, tk.gram_gather_plain(bits, idx))
    assert torch.equal(got, got.T)


@pytest.mark.parametrize("W", [132, 256])
def test_cross_gram_c256_prefix_in_place(cuda_device, W):
    """The 3-level GroupBy's second level at a small S and W: 256 prefix
    masks read in place from [C, S, W] against a 64-row stack, one
    256 x 64 tile."""
    rng = np.random.default_rng(W)
    S, C, R = 3, 256, 64
    prefix = _words(rng, C, S, W).to(cuda_device)
    bits = _words(rng, S, R, W).to(cuda_device)
    view = prefix.transpose(0, 1)
    assert tk.cross_gram_plan(C, R, tk._copies16(W, view, bits)) == tk.GramPlan(
        False, True, False, 256, 64
    )
    got = tk.combo_counts_gram(prefix, bits, np.arange(R))
    want = tk.cross_gram_gather_plain(view.contiguous(), bits, np.arange(C), np.arange(R))
    np.testing.assert_array_equal(got, want.cpu().numpy())


def test_gram_c_entry_refuses_a_bad_plan(cuda_device):
    """The C entry returns cudaErrorInvalidValue, and launches nothing, on
    a plan it cannot run."""
    from pilosa_tpu_torch.ops import cuda_build

    lib = cuda_build.load()
    bits = torch.zeros((2, 3, 130), dtype=torch.int32, device=cuda_device)
    idx = torch.arange(3, dtype=torch.int32, device=cuda_device)
    out = torch.zeros((3, 3), dtype=torch.int32, device=cuda_device)
    stream = torch.cuda.current_stream().cuda_stream
    bad_gram = [(1, 0, 8), (0, 1, 32), (0, 0, 24), (0, 0, 2)]  # vec16 at W = 130, ...
    for vec16, tri, tile_n in bad_gram:
        code = lib.pilosa_gram_gather(
            bits.data_ptr(), idx.data_ptr(), out.data_ptr(), 2, 3, 130, 3, 0,
            stream, vec16, tri, tile_n,
        )
        assert code != 0, (vec16, tri, tile_n)
    for swap, vec16, tm, tn in [(0, 1, 64, 8), (0, 0, 64, 24), (0, 0, 128, 32)]:
        code = lib.pilosa_cross_gram_gather(
            bits.data_ptr(), 3 * 130, 130, idx.data_ptr(), 3,
            bits.data_ptr(), 3 * 130, 130, idx.data_ptr(), 3,
            out.data_ptr(), 2, 130, 0, stream, swap, vec16, tm, tn,
        )
        assert code != 0, (swap, vec16, tm, tn)
    torch.cuda.synchronize()
    assert int(out.abs().sum()) == 0


# -- the tree kernel (ops/csrc/tree_eval.cu): compiled PQL trees


def _chain(n):
    """A right-nested tree of ``n`` leaves, one node per level."""
    sig = ("row", 0)
    for k in range(n - 1):
        op = ("intersect", "union", "xor", "difference")[k % 4]
        sig = (op, ("row", k % 3), sig)
    return sig


def _balanced(levels, k=0):
    """A full binary tree of 2**levels leaves, operators alternating by level."""
    if levels == 0:
        return ("row", k % 3)
    op = ("difference", "union", "xor", "intersect")[levels % 4]
    return (op, _balanced(levels - 1, 2 * k), _balanced(levels - 1, 2 * k + 1))


def _deep_program(depth):
    """A program no tree compiles to: ``depth`` leaves pushed, then folded
    with every fold opcode in turn, so it needs ``depth`` stack entries."""
    from pilosa_tpu_torch.exec import astbatch

    folds = [tk.TREE_AND, tk.TREE_OR, tk.TREE_XOR, tk.TREE_ANDNOT, tk.TREE_NOTAND]
    code = list(range(depth)) + [folds[k % 5] for k in range(depth - 1)]
    return astbatch.Program(np.array(code, np.int32), np.arange(depth, dtype=np.int32) % 3,
                            depth, depth)


_TREE = ("union", ("difference", ("row", 0), ("row", 1)), ("intersect", ("row", 2), ("row", 0)))
_FLAT3 = ("intersect", ("row", 0), ("row", 1), ("row", 2))
# past the opcodes and leaf pointers the kernel stages in shared memory
_WIDE = ("union",) + tuple(("row", k % 3) for k in range(300))
# 600 leaves: past the steps and row pointers the through-L2 instance
# stages in shared memory
_WIDE2 = ("union",) + tuple(("row", k % 3) for k in range(600))
_XOR4 = ("xor", ("row", 0), ("row", 0), ("row", 0), ("row", 0))
_ANDNOT3 = ("difference", ("row", 0), ("row", 0), ("row", 0))


@pytest.mark.parametrize(
    "S,W,rows,sig,B,strided",
    [
        # ragged words, a 0-row stack (every slot -1), absent rows
        (3, 130, (5, 0, 1), _TREE, 9, False),
        # a program at the operand-stack limit (TREE_MAX_DEPTH), one item
        (3, 130, (5, 7, 1), 32, 1, False),
        (2, 132, (9, 4, 3), 32, 5, True),
        # programs longer than the staged head: 300 leaves; 512 leaves at
        # depth 10; and a tree nested 40 levels deep
        (3, 132, (9, 4, 3), _WIDE, 4, False),
        (2, 130, (5, 0, 1), _balanced(9), 3, True),
        (3, 260, (5, 7, 2), _chain(40), 6, False),
        # W below one 16-byte group, and the serving mix of stacks
        (4, 3, (6, 2, 1), _TREE, 17, True),
        (5, 512, (64, 64, 4, 1), _FLAT3, 64, True),
        (7, 1024, (64, 4, 1), ("xor", ("row", 0), ("row", 0), ("row", 0)), 33, False),
    ],
)
def test_tree_kernels_match_plain(cuda_device, S, W, rows, sig, B, strided):
    from pilosa_tpu_torch.exec import astbatch

    rng = np.random.default_rng(S * W + B)
    stacks = tuple(_words(rng, S, r, W).to(cuda_device) for r in rows)
    p = _deep_program(sig) if isinstance(sig, int) else astbatch.program(sig)
    n_rows = np.array([rows[k] for k in p.leaf_stack])
    if strided:  # neighbouring items on rows a fixed stride apart
        slots = (np.arange(B)[:, None] * 5 + 3 * np.arange(p.n_leaves)) % np.maximum(n_rows, 1)
    else:
        slots = (rng.random((B, p.n_leaves)) * n_rows).astype(np.int64)
        slots[rng.random((B, p.n_leaves)) < 0.2] = -1
    slots[:, n_rows == 0] = -1
    slots = slots.astype(np.int32)
    before = dict(tk.LAUNCHES)
    got = tk.tree_count(stacks, p.code, p.leaf_stack, slots)
    words = tk.tree_words(stacks, p.code, p.leaf_stack, slots[-1])
    torch.cuda.synchronize()
    assert tk.LAUNCHES["tree_count"] == before["tree_count"] + 1
    assert tk.LAUNCHES["tree_words"] == before["tree_words"] + 1
    assert torch.equal(got, tk.tree_count_plain(stacks, p.code, p.leaf_stack, slots))
    assert torch.equal(words, tk.tree_words_plain(stacks, p.code, p.leaf_stack, slots[-1]))


def test_tree_kernel_refuses_programs_past_its_limits(cuda_device):
    from pilosa_tpu_torch.exec import astbatch
    from pilosa_tpu_torch.ops import cuda_build

    stacks = (torch.zeros((2, 3, 8), dtype=torch.int32, device=cuda_device),)
    deep = _deep_program(tk.TREE_MAX_DEPTH + 1)
    before = dict(tk.LAUNCHES)
    with pytest.raises(ValueError, match="stack entries"):
        tk.tree_count(stacks, deep.code, deep.leaf_stack,
                      np.zeros((1, deep.n_leaves), np.int32))
    with pytest.raises(ValueError, match="stack entries"):
        tk.tree_words(stacks, deep.code, deep.leaf_stack, np.zeros(deep.n_leaves, np.int32))
    assert tk.LAUNCHES == before
    # the C entries refuse arguments past their limits and launch nothing
    lib = cuda_build.load()
    out = torch.zeros((1, 2), dtype=torch.int32, device=cuda_device)
    flat = astbatch.program(_FLAT3)
    steps, _ = tk.tree_steps(flat.code)
    lay = tk.tree_direct_layout(stacks * 3, flat.leaf_stack, np.zeros((1, 3), np.int32), steps)
    ptr, host_bytes, _owner = tk._tree_table(lay.parts, cuda_device)
    assert 0 < host_bytes <= tk.TREE_PARAM_BYTES  # a parameter, not an upload
    stream = torch.cuda.current_stream().cuda_stream
    # (B, n_rows, n_steps, depth, S, W, vec16, rows_max, stages, lanes, wsplit,
    # flat)
    good = dict(B=1, n_rows=lay.n_rows, n_steps=steps.size, depth=1, S=2, W=8, vec16=1,
                rows_max=lay.rows_max, stages=2, lanes=64, wsplit=1, flat=0)
    for bad in (dict(depth=0), dict(depth=tk.TREE_MAX_DEPTH + 1), dict(W=130),
                dict(wsplit=0), dict(B=-1), dict(stages=5),
                dict(vec16=0, W=9), dict(rows_max=300), dict(flat=4), dict(flat=0, depth=2),
                dict(lanes=16), dict(lanes=0), dict(rows_max=240, lanes=32),
                dict(stages=0, lanes=0), dict(stages=0, flat=-1),
                dict(W=1 << 26, vec16=0, stages=0, lanes=0, flat=-1)):
        args = {**good, **bad}
        assert lib.pilosa_tree_count(ptr, host_bytes, *args.values(), out.data_ptr(), 0,
                                     stream) != 0, bad
    # a host table past the parameter's bytes
    assert lib.pilosa_tree_count(ptr, tk.TREE_PARAM_BYTES + 16, *good.values(),
                                 out.data_ptr(), 0, stream) != 0
    assert lib.pilosa_tree_words(ptr, tk.TREE_PARAM_BYTES + 16, lay.n_rows, steps.size, 1,
                                 2, 8, 1, out.data_ptr(), 0, stream) != 0
    torch.cuda.synchronize()
    assert int(out.abs().sum()) == 0
    # the good arguments run (a count of zero rows)
    assert lib.pilosa_tree_count(ptr, host_bytes, *good.values(), out.data_ptr(), 0,
                                 stream) == 0
    torch.cuda.synchronize()
    assert int(out.abs().sum()) == 0


def _tree_case(cuda_device, S, W, rows, alias, sig, B, absent, seed):
    from pilosa_tpu_torch.exec import astbatch

    rng = np.random.default_rng(seed)
    base = tuple(_words(rng, S, r, W).to(cuda_device) for r in rows)
    stacks = base if alias is None else tuple(base[k] for k in alias)
    p = astbatch.program(sig)
    n_rows = np.array([stacks[k].shape[1] for k in p.leaf_stack])
    slots = (rng.random((B, p.n_leaves)) * n_rows).astype(np.int32)
    slots[rng.random(slots.shape) < absent] = -1
    slots[:, n_rows == 0] = -1
    return stacks, p, slots


def _launched(monkeypatch):
    """The C entries the tree wrappers call, in order, with their
    arguments."""
    calls = []
    real = tk._launch

    def spy(fn, *args):
        calls.append((fn, args))
        return real(fn, *args)

    monkeypatch.setattr(tk, "_launch", spy)
    return calls


_PAIRS = ("union", ("intersect", ("row", 0), ("row", 1)), ("difference", ("row", 0), ("row", 1)))


@pytest.mark.parametrize(
    "S,W,rows,alias,sig,B,absent,force,route",
    [
        # the staged route as planned: W past a whole chunk, one register
        # entry and two, stages 4, a W split, absent rows, a 0-row stack,
        # one tensor as two stacks, B not a whole group
        (3, 132, (5, 7, 1), None, _FLAT3, 40, 0.2, None, "staged"),
        (3, 260, (9, 0, 3), None, _PAIRS, 33, 0.1, None, "staged"),
        (5, 4096, (64, 64, 4), None, _FLAT3, 1001, 0.0, None, "staged"),
        (2, 1028, (6, 4), (0, 0, 1), _FLAT3, 77, 0.1, None, "staged"),
        (7, 512, (64, 4, 1), None, ("xor", ("row", 0), ("row", 0), ("row", 0)), 33, 0.0,
         None, "staged"),
        (3, 260, (5, 7, 2), None, _chain(40), 6, 0.2, None, "staged"),
        # the flat instances: Not (ANDNOT) over a 1-row existence stack, a
        # Union of four leaves (OR), reordered; a flat chain forced onto
        # the general step loop
        (3, 516, (1, 40), None, ("difference", ("row", 0), ("row", 1)), 70, 0.1, None,
         "staged"),
        (2, 132, (3, 9, 5), None, ("union", ("row", 2), ("row", 1), ("row", 0), ("row", 1)), 45,
         0.1, None, "staged"),
        (3, 132, (5, 7, 1), None, _FLAT3, 40, 0.2, "staged", "staged"),
        # forced: one item, and the direct route on a staged shape
        (3, 384, (5, 7, 1), None, _FLAT3, 1, 0.0, "staged", "staged"),
        (4, 1024, (9, 9, 2), None, _PAIRS, 50, 0.1, "staged", "staged"),
        (3, 132, (5, 7, 1), None, _FLAT3, 40, 0.2, "direct", "direct"),
        # items that share no rows (absent -1: item b on rows 3b .. 3b + 2),
        # planned direct, then forced staged
        (2, 132, (24, 24, 24), None, _FLAT3, 8, -1, None, "direct"),
        (2, 132, (24, 24, 24), None, _FLAT3, 8, -1, "staged", "staged"),
        # the word route and a program past the staged route's registers
        (3, 130, (5, 7, 1), None, _FLAT3, 40, 0.2, None, "direct"),
        (2, 132, (5, 0, 1), None, _balanced(3), 30, 0.2, None, "direct"),
        # the direct route's instances ("rows": each item's rows staged by
        # 64 lanes, "rows32" by 32, "l2": through L2). W at and off the slice
        # boundaries (slices of TREE_DIRECT_SLICE_WORDS): one whole slice, a last
        # partial slice of 4 words, two slices and a partial chunk, and the
        # word route; S = 1 and S = 3; B = 1 and items sharing no rows
        (1, 4096, (5, 7, 1), None, _FLAT3, 1, 0.0, None, "rows"),
        (3, 4100, (5, 7, 1), None, _FLAT3, 1, 0.0, None, "rows"),
        (3, 8192 + 516, (5, 7, 1), None, _TREE, 1, 0.0, None, "rows"),
        (1, 132, (5, 7, 1), None, _FLAT3, 1, 0.0, None, "rows"),
        (3, 130, (5, 7, 1), None, _FLAT3, 1, 0.0, None, "l2"),
        (3, 4098, (5, 7, 1), None, _TREE, 1, 0.2, None, "l2"),
        (3, 4100, (24, 24, 24), None, _FLAT3, 8, -1, None, "rows"),
        # an item of more distinct rows than a block stages: through L2, its
        # steps and rows past the ones it stages in shared memory
        (2, 132, (600, 600, 600), None, _WIDE2, 1, 0.0, None, "l2"),
        # XOR and ANDNOT chains that repeat a row (it folds every time),
        # forced onto the rows instance (the rows are shared), on the flat
        # instance and on the general step loop
        (3, 1028, (6,), None, _XOR4, 3, -2, "flat", "rows"),
        (3, 1028, (6,), None, _XOR4, 3, -2, "rows", "rows"),
        (3, 1028, (6,), None, _ANDNOT3, 3, -2, "flat", "rows"),
        (3, 1028, (6,), None, _ANDNOT3, 3, -2, "rows", "rows"),
        # a ring of one stage, 32 lanes
        (3, 1028, (6,), None, _XOR4, 3, -2, "ring1", "rows32"),
        (3, 1028, (5, 7, 1), None, _balanced(3), 2, 0.1, "ring1", "rows32"),
        # absent and 0-row leaves; a program at TREE_MAX_DEPTH (its stack in
        # shared memory); one past TREE_SMEM_OPS steps; a nested tree of
        # three entries on the rows instance and, forced, through L2
        (3, 516, (5, 0, 1), None, _balanced(3), 1, 0.3, None, "rows"),
        # every leaf absent (a stage of the zero row alone); W below one
        # chunk (lanes past W zero-filled)
        (2, 260, (5, 0, 1), None, _FLAT3, 1, 1.0, None, "rows"),
        (2, 8, (3, 2, 1), None, _balanced(3), 1, 0.0, None, "rows"),
        (2, 260, (5, 7, 1), None, "deep32", 1, 0.0, None, "rows"),
        (2, 132, (9, 4, 3), None, _balanced(10), 1, 0.1, None, "rows"),
        (2, 132, (9, 4, 3), None, _balanced(10), 1, 0.1, "l2", "l2"),
        (4, 1024, (64, 64, 4), None, _balanced(3), 64, 0.0, None, "rows"),
        (4, 1024, (64, 64, 4), None, _balanced(3), 64, 0.0, "l2", "l2"),
        # the 300-leaf Union (a flat OR chain of any length, on its own
        # instance), and forced onto the general step loop; the trees path's
        # one, whose 132 rows fit more warps on an SM in blocks of 32 lanes
        (2, 4096, (64, 64, 4), None, _WIDE, 1, 0.0, None, "rows"),
        (2, 4096, (64, 64, 4), None, _WIDE, 1, 0.0, "general", "rows"),
        (2, 4100, (64, 64, 4), None, _WIDE, 1, -3, None, "rows32"),
        (2, 4100, (64, 64, 4), None, _WIDE, 1, -3, "general", "rows32"),
    ],
)
def test_tree_count_routes_match_plain(cuda_device, monkeypatch, S, W, rows, alias, sig, B,
                                       absent, force, route):
    if sig == "deep32":
        stacks = _tree_case(cuda_device, S, W, rows, alias, _FLAT3, B, 0.0, S * W + B)[0]
        p = _deep_program(tk.TREE_MAX_DEPTH)
        n_rows = np.array([rows[k] for k in p.leaf_stack])
        slots = (np.random.default_rng(7).random((B, p.n_leaves)) * n_rows).astype(np.int32)
    else:
        stacks, p, slots = _tree_case(cuda_device, S, W, rows, alias, sig, B, max(absent, 0),
                                      S * W + B)
    if absent == -1:  # item b on rows 3b .. 3b + 2
        slots = (np.arange(B)[:, None] * 3 + np.arange(3)).astype(np.int32)
    elif absent == -2:  # rows repeated within an item
        slots = np.array([[2, 2, 2, 5], [1, 3, 1, 1], [4, 4, 4, 4]], np.int32)[:, : p.n_leaves]
    elif absent == -3:  # each stack's rows in turn, as the trees path's Union
        n_rows = np.array([stacks[k].shape[1] for k in p.leaf_stack])
        slots = ((np.arange(p.n_leaves) // 3) % n_rows).astype(np.int32)[None]
    if force in ("direct", "staged", "l2"):
        # the staged force runs the general step loop (flat -1)
        forced = (tk.TreePlan("direct", W % 4 == 0) if force in ("direct", "l2") else
                  tk.TreePlan("staged", True, 2, 3 * B, 8 * -(-B // 8), 2))
        monkeypatch.setattr(tk, "tree_plan", lambda *a, **k: forced)
    elif force == "general":
        real = tk.tree_plan
        monkeypatch.setattr(tk, "tree_plan", lambda *a, **k: real(*a, **k)._replace(flat=-1))
    elif force in ("rows", "flat", "ring1"):  # each item's leaves as its rows, two slices
        chain = tk.tree_flat(tk.tree_steps(p.code)[0], None) if force == "flat" else -1
        forced = (tk.TreePlan("direct", True, 2, p.n_leaves, 0, 2, chain, 64) if force != "ring1"
                  else tk.TreePlan("direct", True, 1, p.n_leaves, 0, 2, -1, 32))
        monkeypatch.setattr(tk, "tree_plan", lambda *a, **k: forced)
    calls = _launched(monkeypatch)
    got = tk.tree_count(stacks, p.code, p.leaf_stack, slots)
    torch.cuda.synchronize()
    assert [fn for fn, _ in calls] == [
        "pilosa_tree_count_staged" if route == "staged" else "pilosa_tree_count"]
    if route in ("rows", "rows32", "l2"):
        stages, lanes = calls[0][1][10:12]
        assert (stages > 0) == (route != "l2")
        assert lanes == {"rows": 64, "rows32": 32, "l2": 0}[route]
    assert torch.equal(got, tk.tree_count_plain(stacks, p.code, p.leaf_stack, slots))


@pytest.mark.parametrize("rows_per_tile,items_per_tile", [(20, 1024), (1000, 64), (12, 40)])
def test_tree_count_staged_tiles_match_plain(cuda_device, monkeypatch, rows_per_tile,
                                             items_per_tile):
    """Distinct rows and items past one tile: the wrapper cuts the batch."""
    stacks, p, slots = _tree_case(cuda_device, 3, 260, (40, 40, 4), None, _FLAT3, 300, 0.05, 1)
    items = min(304, items_per_tile)
    monkeypatch.setattr(tk, "_TREE_SMEM_LIMIT", min(
        tk._TREE_SMEM_LIMIT, tk._tree_staged_smem(rows_per_tile, items, 3, 3, 2) + 16))
    monkeypatch.setattr(tk, "_TREE_ITEM_TILE", items_per_tile)
    got = tk.tree_count(stacks, p.code, p.leaf_stack, slots)
    torch.cuda.synchronize()
    assert torch.equal(got, tk.tree_count_plain(stacks, p.code, p.leaf_stack, slots))


def test_tree_staged_c_entry_refuses_a_bad_plan(cuda_device):
    from pilosa_tpu_torch.ops import cuda_build

    lib = cuda_build.load()
    table = torch.zeros(1024, dtype=torch.uint8, device=cuda_device)
    out = torch.zeros((8, 2), dtype=torch.int32, device=cuda_device)
    stream = torch.cuda.current_stream().cuda_stream
    good = dict(tiles=1, n_rows=0, n_items=8, n_steps=3, L=3, depth=1, S=2, W=128,
                stages=2, rows_max=0, items_max=8, wsplit=1, flat=-1)
    for bad in (dict(stages=1), dict(stages=5), dict(depth=3), dict(wsplit=0),
                dict(W=130), dict(items_max=12), dict(L=65), dict(rows_max=300, stages=4),
                dict(flat=4), dict(flat=0, depth=2),
                dict(flat=0, n_steps=5, L=5)):
        args = {**good, **bad}
        code = lib.pilosa_tree_count_staged(table.data_ptr(), *args.values(), out.data_ptr(),
                                            0, stream)
        assert code != 0, bad
    torch.cuda.synchronize()
    assert int(out.abs().sum()) == 0


def test_tree_tables_upload_without_waiting_for_the_stream(cuda_device):
    """The tables go to the card without waiting for the stream: a small
    one as the kernel's parameter, a larger one copied from pinned memory
    on the current stream. Calls queued behind a long launch return before
    it ends, and the kernels read the tables after their copies (right
    words and counts)."""
    import time

    stacks, p, slots = _tree_case(cuda_device, 4, 1024, (9, 9, 2), None, _PAIRS, 64, 0.1, 5)
    _, chain, chain_slots = _tree_case(cuda_device, 4, 1024, (9, 9, 2), None, _chain(40), 8,
                                       0.1, 6)
    lay = tk.tree_direct_layout(stacks, chain.leaf_stack, chain_slots[:1],
                                tk.tree_steps(chain.code)[0])
    assert tk._tree_table(lay.parts, cuda_device)[1] == 0  # uploaded, not a parameter
    tk.tree_words(stacks, p.code, p.leaf_stack, slots[0])
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000_000)  # about a second of queued work
    t0 = time.perf_counter()
    words = [tk.tree_words(stacks, p.code, p.leaf_stack, slots[k]) for k in range(8)]
    long_words = [tk.tree_words(stacks, chain.code, chain.leaf_stack, chain_slots[k])
                  for k in range(8)]
    count = tk.tree_count(stacks, p.code, p.leaf_stack, slots)
    queued = time.perf_counter() - t0
    torch.cuda.synchronize()
    assert queued < 0.25
    for k, got in enumerate(words):
        assert torch.equal(got, tk.tree_words_plain(stacks, p.code, p.leaf_stack, slots[k]))
    for k, got in enumerate(long_words):
        assert torch.equal(got, tk.tree_words_plain(stacks, chain.code, chain.leaf_stack,
                                                    chain_slots[k]))
    assert torch.equal(count, tk.tree_count_plain(stacks, p.code, p.leaf_stack, slots))


def _tree_executors(cuda_device):
    from pilosa_tpu_torch.core.holder import Holder
    from pilosa_tpu_torch.exec.executor import Executor
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    rng = np.random.default_rng(13)
    n_cols = 3 * SHARD_WIDTH
    writes = " ".join(
        f"Set({int(c)}, {fld}={int(r)})"
        for fld in ("f", "g")
        for r, c in zip(rng.integers(0, 6, 2000), rng.integers(0, n_cols, 2000))
    )
    executors = []
    for dev in ("cpu", cuda_device):
        h = Holder(device=dev)
        idx = h.create_index("i")
        idx.create_field("f")
        idx.create_field("g")
        e = Executor(h)
        e.execute("i", writes)
        executors.append(e)
    return executors


def test_executor_tree_path_launches_the_tree_kernel(cuda_device):
    trees = [
        "Intersect(Row(f=0), Row(g=1), Row(f=2))",
        "Union(Intersect(Row(f=1), Row(g=1)), Difference(Row(f=3), Row(g=0)))",
        "Not(Row(f=4))",
        "Xor(Row(f=0), Row(f=9), Row(g=5))",
        "Union(" + ", ".join(f"Row({'fg'[k % 2]}={k % 7})" for k in range(300)) + ")",
    ]
    query = " ".join(f"Count({t}) Count({t}) {t}" for t in trees)
    out = []
    before = dict(tk.LAUNCHES)
    for e in _tree_executors(cuda_device):
        res = e.execute("i", query)
        res += e.execute("i", "Set(3, f=0) Clear(5, g=1)")
        res += e.execute("i", query)
        out.append([r if isinstance(r, (bool, int)) else r.columns().tolist() for r in res])
    assert out[0] == out[1]
    # two rounds of five count groups and five bitmap trees, on the card
    assert tk.LAUNCHES["tree_count"] == before["tree_count"] + 10
    assert tk.LAUNCHES["tree_words"] == before["tree_words"] + 10


def test_incremental_update_on_cuda_makes_a_new_tensor(cuda_device):
    _, e = _tree_executors(cuda_device)
    q = "Count(Intersect(Row(f=0), Row(f=1))) Count(Xor(Row(f=2), Row(f=3)))"
    e.execute("i", q)
    field = e.holder.field("i", "f")
    (entry,) = e._stacks[field].values()
    old = entry["dev"]
    snapshot = old.clone()
    rebuilds = e.stack_rebuilds
    e.execute("i", "Set(11, f=0) Set(12, f=1)")  # shard 0, rows the stack holds
    got = e.execute("i", q)
    assert e.stack_incremental == 1 and e.stack_rebuilds == rebuilds
    new = entry["dev"]
    assert new is not old and new.device == old.device
    assert torch.equal(old, snapshot)  # the old snapshot is untouched
    assert not torch.equal(new[0], old[0]) and torch.equal(new[1:], old[1:])
    cpu, _ = _tree_executors(cuda_device)
    cpu.execute("i", "Set(11, f=0) Set(12, f=1)")
    assert got == cpu.execute("i", q)


# -- the BSI kernels (ops/csrc/bsi.cu) against their plain versions: one
#    shard and several, W off each kernel's chunk (128, 1024 and 2048
#    words), depths 1, 20 and 63, Q across the range scan's query tile of
#    8, negative values, and an empty exists row


def _bsi_operands(rng, S, depth, W, device, empty_exists=False):
    """A BSI stack ``[S, 2+depth, W]`` on ``device`` and its (planes,
    exists, sign) views, read in place by the kernels."""
    stack = _words(rng, S, 2 + depth, W)
    if empty_exists:
        stack[:, 0] = 0
    stack = stack.to(device)
    return stack, stack[:, 2:], stack[:, 0], stack[:, 1]


def _bsi_queries(rng, n, depth, two):
    """``n`` random queries of 1 (or 1-2) bounds, in and out of band."""
    lim = 1 << depth
    ops = ["<", "<=", ">", ">=", "==", "!="]
    out = []
    for _ in range(n):
        k = 1 + int(two and rng.integers(0, 2))
        q = []
        for _ in range(k):
            mag = int(rng.integers(0, 1 << min(depth + 1, 62))) if depth else int(rng.integers(0, 2))
            if rng.random() < 0.1:
                mag = lim
            v = -mag if rng.random() < 0.4 else mag
            op = ops[int(rng.integers(0, len(ops)))]
            q.append((op, v))
        if rng.random() < 0.05:
            q = [("any", 0)]
        out.append(q)
    return out


def _range_launches(table, planes, count):
    """The launches bsi_range's plan makes for ``table`` (in count mode a
    flight of ZERO queries alone launches nothing)."""
    return len(tb.range_plan(table, planes.shape[1], planes.shape[2], count).launches)


@pytest.mark.parametrize(
    "S,W,depth,Q,two",
    [(1, 130, 1, 1, False), (3, 130, 20, 3, True), (2, 300, 63, 9, True),
     (5, 1000, 20, 17, False), (1, 128, 0, 4, True), (4, 257, 20, 128, False),
     (2, 130, 63, 130, True),
     # around a group of 8 queries and around and past BSI_RANGE_MAX_Q;
     # depths 31-33 around the two-words-a-thread instance's limit
     (3, 1024, 20, 7, True), (3, 1024, 20, 8, True), (3, 1024, 20, 9, True),
     (2, 258, 20, 255, True), (2, 258, 31, 256, True), (2, 258, 32, 257, True),
     (2, 259, 33, 600, True), (1, 4097, 63, 300, True)],
)
def test_bsi_range_matches_plain(cuda_device, S, W, depth, Q, two):
    rng = np.random.default_rng(S * 1000 + W + depth + Q)
    _, planes, exists, sign = _bsi_operands(rng, S, depth, W, cuda_device)
    queries = _bsi_queries(rng, Q, depth, two)
    qmask, _, qmeta, _ = tb.encode_query_bounds(queries, depth)
    table = tb.bounds_table(qmask, qmeta)
    before = tk.LAUNCHES["bsi_range"]
    counts = tb.bsi_range(planes, exists, sign, table, count=True)
    words = tb.bsi_range(planes, exists, sign, table, count=False)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["bsi_range"] == before + _range_launches(
        table, planes, True) + _range_launches(table, planes, False)
    want_words = tb.bsi_range_plain(planes, exists, sign, table, False)
    assert torch.equal(words, want_words)
    assert torch.equal(counts, tb.bsi_range_plain(planes, exists, sign, table, True))
    cpu = [t.cpu() for t in (planes, exists, sign)]
    assert torch.equal(words.cpu(), tb.bsi_range(*cpu, table, count=False))


def test_bsi_range_counts_past_one_launch(cuda_device, monkeypatch):
    rng = np.random.default_rng(3)
    _, planes, exists, sign = _bsi_operands(rng, 3, 20, 130, cuda_device)
    queries = _bsi_queries(rng, 21, 20, True)
    monkeypatch.setattr(tb, "BSI_RANGE_MAX_Q", 8)
    launches = _range_launches(tb._queries_table(queries, 20), planes, True)
    assert launches >= 2  # the ZERO queries are not launched
    before = tk.LAUNCHES["bsi_range"]
    got = tb.range_count_batch(planes, exists, sign, queries, depth=20)
    assert tk.LAUNCHES["bsi_range"] == before + launches
    cpu = [t.cpu() for t in (planes, exists, sign)]
    assert got == tb.range_count_batch(*cpu, queries, depth=20)


def _every_class_table(rng, depth):
    """A flight with a query of each composition class and sign selection
    (tests/test_torch_bsi.py checks the classes) in a shuffled order, then
    hand-made flag words for the GEN classes."""
    lim = 1 << depth
    t = max(1, lim // 3)
    queries = [
        [("<", t)], [("<=", t)], [(">", -t)], [(">=", -t)], [(">", t)], [(">=", 0)],
        [("<", -t)], [("<=", -t)], [("==", t)], [("==", -t)], [("!=", t)], [("!=", -t)],
        [(">=", 1), ("<=", t)], [(">", -t), ("<", -1)], [(">=", -t), ("<=", t)],
        [(">=", t), ("<=", -t)], [("any", 0)], [("<", lim)], [(">", lim)], [("<", -lim)],
        [("<", t), ("<", 2 * t)], [("==", 0), ("!=", -t)],
    ]
    qmask, _, qmeta, _ = tb.encode_query_bounds(
        [queries[i] for i in rng.permutation(len(queries))], depth)
    hand = np.zeros((6, 2, 3), dtype=np.int32)
    hand[..., 0] = rng.integers(0, 1 << tb._M_CH, size=(6, 2))
    hand[:3, 1, 0] = (1 << tb._M_FNEG) | (1 << tb._M_FNON)  # one bound: GEN1
    mags = rng.integers(0, lim, size=(6, 2), dtype=np.int64)
    hand[..., 1] = (mags & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    hand[..., 2] = (mags >> 32).astype(np.uint32).view(np.int32)
    return np.concatenate([tb.bounds_table(qmask, qmeta), hand])


def _forced_range_plan(monkeypatch, **change):
    real = tb.range_plan

    def forced(*a, **k):
        return real(*a, **{**k, **change})

    monkeypatch.setattr(tb, "range_plan", forced)


# every kernel instance (RANGE_CONFIGS) at the depths it takes: ragged W,
# depths 0, 1, 20, 32 and 63, an empty exists row
_EVERY_CLASS_CASES = [
    (config, *shape) for config in tb.RANGE_CONFIGS
    for shape in [(2, 1000, 20, False), (3, 132, 1, False), (1, 4100, 0, False),
                  (2, 1028, 20, True), (2, 260, 32, False), (2, 260, 63, False)]
    if shape[2] <= config[0]
]


@pytest.mark.parametrize("config,S,W,depth,empty", _EVERY_CLASS_CASES)
def test_bsi_range_every_class_and_instance_matches_plain(cuda_device, monkeypatch, config, S,
                                                          W, depth, empty):
    rng = np.random.default_rng(S + W + depth + config[0])
    _, planes, exists, sign = _bsi_operands(rng, S, depth, W, cuda_device, empty)
    table = _every_class_table(rng, depth)
    if depth:  # at depth 0 no bound but 0 is in band: fewer classes
        assert set(tb.query_classes(table)[0].tolist()) == set(range(10))
    _forced_range_plan(monkeypatch, config=config, vec=config[1], chunks=2)
    for count in (False, True):
        before = tk.LAUNCHES["bsi_range"]
        got = tb.bsi_range(planes, exists, sign, table, count=count)
        torch.cuda.synchronize()
        assert tk.LAUNCHES["bsi_range"] == before + 1
        assert torch.equal(got, tb.bsi_range_plain(planes, exists, sign, table, count))


def test_bsi_range_c_entry_refuses_a_bad_plan(cuda_device):
    from pilosa_tpu_torch.ops import cuda_build

    lib = cuda_build.load()
    rng = np.random.default_rng(5)
    _, planes, exists, sign = _bsi_operands(rng, 2, 20, 256, cuda_device)
    table = tb._queries_table([[("<", 9)], [(">", 3)]], 20)
    plan = tb.range_plan(table, 20, 256, True)
    (launch,) = plan.launches
    out = torch.zeros((2, 2), dtype=torch.int32, device=cuda_device)
    stream = torch.cuda.current_stream().cuda_stream

    def call(param=launch.param, depth=20, dmax=plan.dmax, vec=plan.vec, count=1, n_out=2,
             W=256, grid_x=plan.grid_x):
        return lib.pilosa_bsi_range(
            param, len(param), planes.data_ptr(), planes.stride(0), exists.data_ptr(),
            exists.stride(0), sign.data_ptr(), sign.stride(0), depth, 2, W, dmax, vec, grid_x,
            count, out.data_ptr(), n_out, cuda_device.index or 0, stream)

    P = np.frombuffer(launch.param, dtype=tb._RANGE_PARAM)[0].copy()
    bad_dest, bad_seg, zero_count = P.copy(), P.copy(), P.copy()
    bad_dest["dest"][1] = 2
    bad_seg["seg_end"][int(P["n_seg"]) - 1] = 1
    zero_count["seg_cls"][0] = tb._C_ZERO
    invalid = 1  # cudaErrorInvalidValue
    assert call(param=launch.param[:-16]) == invalid
    assert call(param=bad_dest.tobytes()) == invalid
    assert call(param=bad_seg.tobytes()) == invalid
    assert call(param=zero_count.tobytes()) == invalid
    assert call(depth=33) == invalid and call(dmax=48) == invalid
    assert call(dmax=32, vec=3) == invalid and call(grid_x=0) == invalid
    assert call(vec=4, W=254) == invalid
    assert call(n_out=1) == invalid
    assert call() == 0
    torch.cuda.synchronize()
    assert out.cpu().tolist() == tb.bsi_range_plain(
        planes.cpu(), exists.cpu(), sign.cpu(), table, True).tolist()


@pytest.mark.parametrize(
    "S,W,depth,Q,empty",
    [(1, 130, 1, 1, False), (3, 1100, 20, 3, False), (2, 2049, 63, 9, False),
     (5, 1024, 20, 2, True), (1, 100, 0, 5, False), (7, 3000, 20, 64, False)],
)
def test_bsi_sum_matches_plain(cuda_device, S, W, depth, Q, empty):
    rng = np.random.default_rng(S + W + depth + Q)
    _, planes, exists, sign = _bsi_operands(rng, S, depth, W, cuda_device, empty)
    filters = _words(rng, S, Q, W).to(cuda_device)
    before = tk.LAUNCHES["bsi_sum"]
    got = tb.bsi_sum(planes, exists, sign, filters)
    got_all = tb.bsi_sum(planes, exists, sign)
    got_one = tb.bsi_sum(planes, exists, sign, filters[:, Q - 1])
    torch.cuda.synchronize()
    assert tk.LAUNCHES["bsi_sum"] == before + 3
    assert torch.equal(got, tb.bsi_sum_plain(planes, exists, sign, filters))
    assert torch.equal(got_all, tb.bsi_sum_plain(planes, exists, sign, None))
    assert torch.equal(got_one, got[:, Q - 1 :])
    cpu = [t.cpu() for t in (planes, exists, sign, filters)]
    assert tb.sum_batch_host(planes, exists, sign, filters, depth=depth) == (
        tb.sum_batch_host(*cpu, depth=depth))


@pytest.mark.parametrize(
    "S,W,depth,Q,empty",
    [(1, 130, 1, 1, False), (3, 1100, 20, 3, False), (2, 2049, 63, 9, False),
     (5, 1024, 20, 2, True), (1, 100, 0, 5, False), (7, 3000, 20, 64, False),
     (2, 96, 64, 128, False), (3, 513, 7, 17, False)],
)
def test_bsi_sum_batch_matches_plain(cuda_device, S, W, depth, Q, empty):
    """The tensor-core batched Sum against its plain version on both
    operand forms (``[S, Q, W]`` filters, and the rows of a 40-row stack
    through an index in random order with repeats and -1), with a sign row
    of all ones at odd depths; one launch each."""
    rng = np.random.default_rng(7 * S + W + depth + Q)
    stack, planes, exists, sign = _bsi_operands(rng, S, depth, W, cuda_device, empty)
    if depth % 2:
        stack[:, 1] = -1
    filters = _words(rng, S, Q, W).to(cuda_device)
    rows = _words(rng, S, 40, W).to(cuda_device)
    idx = rng.integers(-1, 40, Q)
    idx[0] = -1
    before = tk.LAUNCHES["bsi_sum_batch"]
    got = tb.bsi_sum_batch(planes, exists, sign, filters, range(Q))
    got_rows = tb.bsi_sum_batch(planes, exists, sign, rows, idx)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["bsi_sum_batch"] == before + 2
    assert torch.equal(got, tb.bsi_sum_batch_plain(planes, exists, sign, filters, range(Q)))
    assert torch.equal(got_rows, tb.bsi_sum_batch_plain(planes, exists, sign, rows, idx))
    cpu = [t.cpu() for t in (planes, exists, sign, rows)]
    assert tb.sum_batch_host(planes, exists, sign, rows, depth=depth, idx=idx) == (
        tb.sum_batch_host(*cpu, depth=depth, idx=idx))


def test_bsi_sum_batch_refuses_on_the_card(cuda_device):
    """A CUDA operand of another dtype, words not one apart, or on another
    device raises in the wrapper; the C entry refuses a depth over 64 and
    totals past int32."""
    from pilosa_tpu_torch.ops import cuda_build

    rng = np.random.default_rng(3)
    _, planes, exists, sign = _bsi_operands(rng, 2, 4, 64, cuda_device)
    rows = _words(rng, 2, 3, 64).to(cuda_device)
    with pytest.raises(TypeError):
        tb.bsi_sum_batch(planes, exists, sign, rows.to(torch.int64), [0])
    with pytest.raises(ValueError):
        tb.bsi_sum_batch(planes, exists, sign, _words(rng, 2, 3, 128).to(cuda_device)[:, :, ::2],
                         [0])
    with pytest.raises(ValueError):
        tb.bsi_sum_batch(planes, exists, sign, rows.cpu(), [0])
    lib = cuda_build.load()
    out = torch.zeros((5, 2, 1), dtype=torch.int32, device=cuda_device)
    idx = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    stream = torch.cuda.current_stream().cuda_stream

    def call(depth=4, S=2, W=64):
        return lib.pilosa_bsi_sum_batch(
            planes.data_ptr(), planes.stride(0), 64, exists.data_ptr(), exists.stride(0),
            sign.data_ptr(), sign.stride(0), rows.data_ptr(), rows.stride(0), rows.stride(1),
            idx.data_ptr(), 1, depth, S, W, 1, out.data_ptr(), cuda_device.index or 0, stream)

    assert call(depth=65) == 1 and call(S=1 << 16, W=1 << 11) == 1  # cudaErrorInvalidValue
    assert call() == 0
    torch.cuda.synchronize()
    assert torch.equal(out.to(torch.int64), tb.bsi_sum_batch_plain(
        planes, exists, sign, rows, [0]))


@pytest.mark.parametrize(
    "S,W,depth,empty",
    [(1, 130, 1, False), (3, 2100, 20, False), (2, 4096, 63, False), (4, 300, 0, False),
     (2, 2048, 20, True), (6, 5000, 20, False)],
)
def test_bsi_extreme_matches_plain(cuda_device, S, W, depth, empty):
    rng = np.random.default_rng(S * W + depth)
    stack, planes, exists, sign = _bsi_operands(rng, S, depth, W, cuda_device, empty)
    if depth >= 2:  # high planes sparse, so slices reach different extremes
        stack[:, 2 + depth - 2 :] &= _words(rng, S, 2, W).to(cuda_device) & _words(
            rng, S, 2, W).to(cuda_device)
    filt = _words(rng, S, W).to(cuda_device)
    before = tk.LAUNCHES["bsi_extreme"]
    for maximal in (True, False):
        for f in (None, filt):
            got = tb.bsi_extreme(planes, exists, sign, f, maximal=maximal)
            want = tb.bsi_extreme_plain(planes, exists, sign, f, maximal)
            assert torch.equal(got, want), (maximal, f is None)
            cpu = [t.cpu() for t in (planes, exists, sign)]
            fw = exists if f is None else f
            assert tb.min_max_host(planes, exists, sign, fw, depth=depth, maximal=maximal) == (
                tb.min_max_host(*cpu, fw.cpu(), depth=depth, maximal=maximal))
    torch.cuda.synchronize()
    assert tk.LAUNCHES["bsi_extreme"] == before + 8


# -- the device-memory budget on the card: evictions free the card's memory,
#    the default cap reads the card, the per-fragment BSI launches (S = 1)
#    and an executor under a small cap answer as on the CPU


@pytest.fixture
def fresh_budget():
    from pilosa_tpu_torch.core import membudget, residency

    saved = (membudget._default, residency._default)
    membudget.configure(None)
    residency.configure()
    yield membudget
    membudget._default, residency._default = saved


def _budget_index(dev, seed=13, n_shards=4):
    from pilosa_tpu_torch.core.field import FieldOptions
    from pilosa_tpu_torch.core.holder import Holder
    from pilosa_tpu_torch.exec.executor import Executor
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    rng = np.random.default_rng(seed)
    h = Holder(device=dev)
    idx = h.create_index("i")
    for name, rows in (("f", 12), ("g", 6)):
        view = idx.create_field(name).create_view_if_not_exists("standard")
        for s in range(n_shards):
            view.create_fragment_if_not_exists(s).import_bits(
                rng.integers(0, rows, 5000).astype(np.uint64),
                rng.integers(0, SHARD_WIDTH, 5000))
    idx.create_field("v", FieldOptions(field_type="int", min_=-500, max_=1000))
    ex = Executor(h)
    ex.execute("i", " ".join(
        f"Set({int(c)}, v={int(x)})"
        for c, x in zip(rng.integers(0, n_shards * SHARD_WIDTH, 3000),
                        rng.integers(-500, 1001, 3000))))
    return ex


def test_evicted_stack_frees_its_bytes(cuda_device, fresh_budget):
    import gc

    ex = _budget_index(cuda_device)
    budget = fresh_budget.configure(None)
    ex.execute("i", "Count(Intersect(Row(f=1), Row(f=2))) Count(Union(Row(f=3), Row(f=4)))")
    ex.execute("i", "Count(Intersect(Row(g=1), Row(g=2))) Count(Union(Row(g=3), Row(g=4)))")
    used = budget.used()
    f_bytes = 4 * 12 * ex.holder.n_words * 4
    assert used == f_bytes + 4 * 6 * ex.holder.n_words * 4
    torch.cuda.synchronize()
    gc.collect()
    before = torch.cuda.memory_allocated(cuda_device)
    budget.set_cap(used - 1)  # the colder stack, f's, must go
    gc.collect()
    after = torch.cuda.memory_allocated(cuda_device)
    assert ex.stack_evictions == 1 and budget.used() == used - f_bytes
    assert before - after >= f_bytes, (before, after, f_bytes)


def test_probe_device_cap_reads_the_card(cuda_device):
    from pilosa_tpu_torch.core import membudget

    total = torch.cuda.mem_get_info(cuda_device)[1]
    want = int(total * membudget.DEFAULT_HBM_FRACTION)
    assert membudget._probe_device_cap() == want
    assert membudget._probe_device_cap(cuda_device) == want


def test_bsi_launches_per_fragment_match_plain(cuda_device):
    """The over-budget BSI paths launch each kernel on one fragment's rows
    (S = 1: planes ``[depth, W]`` gathered from the fragment's copy, rows
    ``[W]``); each equals its plain version on the CPU."""
    ex = _budget_index(cuda_device)
    field = ex.holder.index("i").field("v")
    depth = field.bit_depth
    frag = field.view(field.bsi_view_name()).fragment(1)
    planes, exists, sign = frag.bsi_tensors(depth)
    assert planes.shape == (depth, ex.holder.n_words) and planes.is_cuda
    cpu = [t.cpu() for t in (planes, exists, sign)]
    rng = np.random.default_rng(3)
    filt = _words(rng, ex.holder.n_words).to(cuda_device)
    before = dict(tk.LAUNCHES)
    conds = [
        lambda p, e, s: tb.range_lt(p, e, s, value=300, depth=depth, allow_eq=True),
        lambda p, e, s: tb.range_gt(p, e, s, value=-200, depth=depth, allow_eq=False),
        lambda p, e, s: tb.range_eq(p, e, s, value_abs=17, negative=True, depth=depth),
        lambda p, e, s: tb.range_between(p, e, s, lo=-100, hi=600, depth=depth),
    ]
    for fn in conds:
        assert torch.equal(fn(planes, exists, sign).cpu(), fn(*cpu))
    for fw in (exists, filt):
        assert tb.sum_host(planes, exists, sign, fw, depth=depth) == tb.sum_host(
            *cpu, fw.cpu(), depth=depth)
        for maximal in (True, False):
            assert tb.min_max_host(planes, exists, sign, fw, depth=depth, maximal=maximal) == (
                tb.min_max_host(*cpu, fw.cpu(), depth=depth, maximal=maximal))
    torch.cuda.synchronize()
    assert tk.LAUNCHES["bsi_range"] == before["bsi_range"] + 4
    assert tk.LAUNCHES["bsi_sum"] == before["bsi_sum"] + 2
    assert tk.LAUNCHES["bsi_extreme"] == before["bsi_extreme"] + 4


@pytest.mark.parametrize("cap_stacks", [1.5, 0.4], ids=["evicting", "declined"])
def test_executor_under_small_cap_on_cuda_matches_cpu(cuda_device, fresh_budget, cap_stacks):
    """The same reads on the CPU and on the card under the same cap (1.5
    times f's stack: stacks evict each other; 0.4 of it: every stack
    but the existence field's is declined) give the same answers; on the
    card the declined BSI reads launch the BSI kernels per fragment."""
    queries = (
        "Count(Intersect(Row(f=1), Row(f=2))) Count(Xor(Row(f=3), Row(f=9))) "
        "Count(Union(Row(g=1), Row(g=5)))",
        "Count(Difference(Row(f=4), Row(f=5)))",
        "TopN(f, Row(g=2), n=6, tanimotoThreshold=3)",
        "GroupBy(Rows(f), Rows(g), limit=20) GroupBy(Rows(f), Rows(g), previous=[3, 2])",
        "GroupBy(Rows(g), Rows(f), Rows(g), filter=Row(v > 100))",
        "Count(Intersect(Row(f=1), Row(g=2), Row(f=3))) "
        "Count(Intersect(Row(f=4), Row(g=5), Row(f=6)))",
        "Count(Row(v < 40)) Row(-20 <= v < 300) Count(Row(v != null))",
        "Sum(field=v) Sum(Row(f=3), field=v) Min(field=v) Max(Row(g=1), field=v)",
    ) * 2

    def plain(r):
        if isinstance(r, int):
            return r
        if hasattr(r, "columns"):
            return r.columns().tolist()
        if hasattr(r, "value"):
            return (r.value, r.count)
        return [
            (p.id, p.count) if hasattr(p, "id")
            else ([(g.field, g.row_id) for g in p.group], p.count)
            for p in r
        ]

    out, execs = [], []
    for dev in ("cpu", cuda_device):
        ex = _budget_index(dev)
        ex._BSI_SINGLE_WARM = 0
        cap = int(cap_stacks * 4 * 12 * ex.holder.n_words * 4)
        budget = fresh_budget.configure(cap)
        before = dict(tk.LAUNCHES)
        out.append([plain(r) for q in queries for r in ex.execute("i", q)])
        assert budget.used() <= cap or budget.pinned_bytes() > 0
        execs.append((ex, {k: tk.LAUNCHES[k] - before[k] for k in tk.LAUNCHES}))
    assert out[0] == out[1]
    ex, launches = execs[1]
    if cap_stacks < 1:
        assert ex.stacks_declined > 0 and ex.bsi_fragment_launches > 0
        for k in ("bsi_range", "bsi_sum", "bsi_extreme", "masked_row_scan"):
            assert launches[k] > 0, (k, launches)
    else:
        assert ex.stack_evictions > 0 and ex.stacks_declined == 0


def test_reopen_on_cuda_matches_cpu(cuda_device, tmp_path):
    """A data dir written on the card opens on the card and on the CPU, and
    both serve the same answers, keys included, through the kernels."""
    from pilosa_tpu_torch.core.field import FieldOptions
    from pilosa_tpu_torch.core.holder import Holder
    from pilosa_tpu_torch.exec.executor import Executor
    from pilosa_tpu_torch.storage.disk import HolderStore

    rng = np.random.default_rng(10)
    st = HolderStore(Holder(n_words=512, device=cuda_device), str(tmp_path))
    st.open()
    idx = st.holder.create_index("i")
    idx.create_field("f")
    idx.create_field("v", FieldOptions(field_type="int", min_=0, max_=1000))
    st.holder.create_index("k", keys=True).create_field("kf", FieldOptions(keys=True))
    ex = Executor(st.holder, translator=st.translator)
    # most columns in a narrow range, so that rows overlap; some in each shard
    cols = np.concatenate([rng.integers(0, 1500, 300), rng.integers(0, 3 * 512 * 32, 100)])
    ex.execute("i", " ".join(f"Set({c}, f={r})" for c, r in zip(cols, rng.integers(0, 6, 400))))
    ex.execute("i", " ".join(f"Set({c}, v={x})" for c, x in zip(cols[:50], rng.integers(0, 1000, 50))))
    ex.execute("k", " ".join(f'Set("c{c}", kf="r{c % 5}")' for c in range(60)))
    for frag in st.holder.field("i", "f").view("standard").fragments.values():
        frag.store.snapshot()
    ex.execute("i", "Clear(%d, f=1) Set(7, f=1)" % cols[0])
    st.close()
    reads = ["Count(Intersect(Row(f=1), Row(f=2))) Count(Union(Row(f=3), Row(f=4)))" * 2,
             "TopN(f, Row(f=2), n=4) GroupBy(Rows(f), Rows(f))",
             "Count(Row(v < 500)) Sum(field=v)"]
    answers = {}
    for dev in (cuda_device, torch.device("cpu")):
        ro = HolderStore(Holder(n_words=512, device=dev), str(tmp_path))
        ro.open()
        ex = Executor(ro.holder, translator=ro.translator)
        ex._BSI_SINGLE_WARM = 0
        before = dict(tk.LAUNCHES)
        got = [[repr(r) if not hasattr(r, "columns") else r.columns().tolist() for r in
                ex.execute("i", q)] for q in reads]
        got.append([(p.id, p.key, p.count) for p in ex.execute("k", 'TopN(kf, n=3)')[0]])
        got.append(ex.execute("k", 'Row(kf="r2")')[0].keys)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            launched = {k for k in tk.LAUNCHES if tk.LAUNCHES[k] > before[k]}
            assert {"gram", "masked_row_scan", "bsi_range", "bsi_sum"} <= launched, launched
        answers[dev.type] = got
        ro.close()
    assert answers["cuda"] == answers["cpu"]


def _time_index(dev, n_shards=3, seed=21):
    """An index on ``dev`` with a time field t (quantum YMDH, 6 rows) loaded
    with timestamps over 30 hours, and a set field f."""
    from datetime import datetime

    from pilosa_tpu_torch.core.field import FieldOptions
    from pilosa_tpu_torch.core.holder import Holder
    from pilosa_tpu_torch.exec.executor import Executor

    rng = np.random.default_rng(seed)
    h = Holder(n_words=512, device=dev)
    width = 512 * 32
    idx = h.create_index("i")
    t = idx.create_field("t", FieldOptions(field_type="time", time_quantum="YMDH"))
    f = idx.create_field("f")
    n = 20000
    cols = rng.integers(0, n_shards * width, n).astype(np.uint64)
    hours = np.datetime64("2024-01-01T00", "h") + rng.integers(0, 30, n)
    t.import_bits(rng.integers(0, 6, n).astype(np.uint64), cols, timestamps=hours)
    f.import_bits(rng.integers(0, 4, 8000).astype(np.uint64),
                  rng.integers(0, n_shards * width, 8000).astype(np.uint64))
    return Executor(h)


_TIME_WINDOWS = ["from=2024-01-01T00:00, to=2024-01-02T00:00",
                 "from=2024-01-01T03:00, to=2024-01-01T19:00",
                 "from=2023-12-31T22:00, to=2024-01-02T04:00"]


def _time_reads():
    out = []
    for w in _TIME_WINDOWS:
        for r in range(6):
            out += [f"Count(Row(t={r}, {w}))", f"Count(Intersect(Row(t={r}, {w}), Row(f=1)))"]
        out.append(f"Row(t=2, {w})")
    return out


def test_windowed_batch_on_cuda_matches_cpu(cuda_device):
    """Windowed Counts, trees and bitmaps in one batch on the card: the
    tree kernels launched, the answers equal to the CPU's."""
    from pilosa_tpu_torch.exec.result import result_to_json

    reads = [(q, None) for q in _time_reads()]
    answers = {}
    for dev in ("cpu", cuda_device):
        ex = _time_index(dev)
        before = dict(tk.LAUNCHES)
        got = ex.execute_batch("i", reads)
        answers[torch.device(dev).type] = [result_to_json(r) for r in got]
        if torch.device(dev).type == "cuda":
            assert tk.LAUNCHES["tree_count"] - before["tree_count"] >= len(_TIME_WINDOWS)
            assert tk.LAUNCHES["tree_words"] - before["tree_words"] == len(_TIME_WINDOWS)
    assert answers["cuda"] == answers["cpu"]
    assert any(a != [0] for a in answers["cpu"])


def test_per_view_stacks_are_admitted_to_the_budget(cuda_device, fresh_budget):
    """Each view of a window's cover is a stack of its own on the card,
    admitted to the budget: the budget counts their bytes and the card
    holds them."""
    import gc

    ex = _time_index(cuda_device)
    budget = fresh_budget.configure(None)
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(cuda_device)
    w = _TIME_WINDOWS[2]  # 2 + 1 + 4 views
    ex.execute_batch("i", [(f"Count(Row(t={r}, {w}))", None) for r in range(6)])
    t = ex.holder.field("i", "t")
    from pilosa_tpu_torch.core import timequantum

    cover = timequantum.view_cover(t, "2023-12-31T22:00", "2024-01-02T04:00", "standard")
    want = 0
    for vname in cover:
        v = t.view(vname)
        if v is not None:
            rows = {r for fr in v.fragments.values() for r in fr.row_ids()}
            want += 3 * len(rows) * 512 * 4
    assert want > 0 and ex.stack_rebuilds >= len([v for v in cover if t.view(v) is not None])
    assert budget.used() == want
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(cuda_device) - before >= want


def test_a_deleted_fields_bytes_leave_the_card(cuda_device, fresh_budget):
    """After Index.delete_field and a collection, the field's stacks leave
    the budget and the card; a new field of the same name answers from its
    own data."""
    import gc
    from datetime import datetime

    from pilosa_tpu_torch.core.field import FieldOptions

    ex = _time_index(cuda_device)
    budget = fresh_budget.configure(None)
    reads = [(f"Count(Row(t={r}, {_TIME_WINDOWS[1]}))", None) for r in range(6)]
    first = ex.execute_batch("i", reads)
    torch.cuda.synchronize()
    used = budget.used()
    allocated = torch.cuda.memory_allocated(cuda_device)
    assert used > 0
    idx = ex.holder.index("i")
    idx.delete_field("t")
    gc.collect()
    torch.cuda.synchronize()
    assert budget.used() == 0
    assert allocated - torch.cuda.memory_allocated(cuda_device) >= used
    t = idx.create_field("t", FieldOptions(field_type="time", time_quantum="YMDH"))
    t.import_bits([2], [5], timestamps=[datetime(2024, 1, 1, 4)])
    again = ex.execute_batch("i", reads)
    assert again == [[0], [0], [1], [0], [0], [0]] and again != first


def _http(node, path, body=None):
    import json
    import urllib.request

    data = body.encode() if isinstance(body, str) else (
        None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(node.uri + path, data=data,
                                 method="GET" if body is None else "POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _http_node(tmp_path, device, rng):
    from pilosa_tpu_torch.server.node import NodeServer

    node = NodeServer(data_dir=str(tmp_path / device), device=device, port=0)
    node.start()
    _http(node, "/index/i", {})
    for f in ("f", "g"):
        _http(node, f"/index/i/field/{f}", {})
        _http(node, f"/index/i/field/{f}/import", {
            "rowIDs": rng.integers(0, 8, 4000).tolist(),
            "columnIDs": rng.integers(0, 3 << 20, 4000).tolist(),
        })
    return node


@pytest.mark.parametrize("query,kernel", [
    ("Count(Union(Row(f=1), Row(g=2))) Count(Xor(Row(f=3), Row(g=4)))", "tree_count"),
    ("GroupBy(Rows(f), Rows(g))", "cross_gram"),
])
def test_a_node_on_the_card_answers_over_http_as_on_the_cpu(cuda_device, tmp_path,
                                                            fresh_budget, query, kernel):
    """A node on ``cuda`` answers a tree Count and a GroupBy over HTTP as a
    node on the CPU does over the same imports, and its /debug/vars counts
    the launches the query made."""
    fresh_budget.configure(None)
    cpu = _http_node(tmp_path, "cpu", np.random.default_rng(4))
    card = _http_node(tmp_path, "cuda", np.random.default_rng(4))
    try:
        before = _http(card, "/debug/vars")["kernels"]
        got = _http(card, "/index/i/query", query)
        after = _http(card, "/debug/vars")["kernels"]
        assert got == _http(cpu, "/index/i/query", query)
        made = {k: after[k]["launches"] - before[k]["launches"] for k in after}
        assert made[kernel] >= 1, made
        assert after[kernel]["deviceMs"] > before[kernel]["deviceMs"]
        assert after[kernel]["launches"] == tk.LAUNCHES[kernel]
    finally:
        card.stop()
        cpu.stop()


# -- the serving plane's side-stream uploads -----------------------------------


def _upload_index(dev, n_shards=6, n_rows=24, seed=21):
    from pilosa_tpu_torch.core.holder import Holder
    from pilosa_tpu_torch.exec.executor import Executor
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    rng = np.random.default_rng(seed)
    h = Holder(device=dev)
    idx = h.create_index("i")
    f = idx.create_field("f")
    n = n_shards * 20000
    f.import_bits(rng.integers(0, n_rows, n).astype(np.uint64),
                  rng.integers(0, n_shards * SHARD_WIDTH, n).astype(np.uint64))
    return h, f, Executor(h, rescache_entries=0)


def _host_counts(frag):
    _, counts = frag.row_counts()
    return counts


def test_side_stream_copies_read_at_once_on_another_stream_equal_the_mirror(
        cuda_device, fresh_budget):
    """A fragment copy and a prefetched stack the uploader made on its side
    stream (through small pinned slots, so each copy is many chunks) are
    read at once by a kernel on another thread's stream: the reader's
    stream waits for the copy's event, and the counts equal the mirror's."""
    import threading

    from pilosa_tpu_torch.ingest import DeviceUploader
    from pilosa_tpu_torch.server.prefetch import _StackTarget

    fresh_budget.configure(None)
    h, f, ex = _upload_index(cuda_device)
    up = DeviceUploader(slots=2, slot_bytes=1 << 16)
    try:
        frags = [f.view("standard").fragment(s) for s in range(6)]
        for frag in frags:
            up.submit(frag)
        got = {}

        def reader(k, frag):
            while frag._device is None:
                pass  # the uploader's sync published it: read at once
            bits = frag.device_bits()
            side = torch.cuda.Stream(cuda_device)
            with torch.cuda.stream(side):
                bits = frag.device_bits()
                counts = tk.row_counts_per_shard(bits[None, :frag.capacity].contiguous())
            got[k] = counts[0].cpu().numpy()

        ts = [threading.Thread(target=reader, args=(k, fr)) for k, fr in enumerate(frags)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        for k, frag in enumerate(frags):
            want = np.bitwise_count(frag._host[: frag.capacity]).sum(axis=1)
            assert np.array_equal(got[k], want), k
        # a stack staged by the prefetch lane, read at once by the dispatcher
        shards = list(range(6))
        assert up.submit_prefetch(_StackTarget(ex, f, shards, "standard"))
        while not ex._stack_cached(f, shards):
            pass
        slot_of, bits = ex._field_stack(f, shards)
        counts = tk.row_counts_per_shard(bits).cpu().numpy().sum(axis=0)
        want = np.zeros(bits.shape[1], dtype=np.int64)
        for fr in frags:
            ids, c = fr.row_counts()
            for r, n in zip(ids, c):
                want[slot_of[r]] += n
        assert np.array_equal(counts, want)
        assert up.flush(30)
        snap = up.snapshot()
        assert snap["uploadErrors"] == 0 and snap["pinnedSlots"][0]["chunks"] > 6
    finally:
        up.close()


def test_pinned_slots_refilled_under_load_never_corrupt_a_copy(cuda_device, fresh_budget):
    """Many fragments through two small pinned slots, refilled chunk after
    chunk while earlier copies are in flight: every device copy equals its
    host mirror, and writes between rounds reach the copies too."""
    from pilosa_tpu_torch.ingest import DeviceUploader
    from pilosa_tpu_torch.ops import bitops

    fresh_budget.configure(None)
    h, f, _ = _upload_index(cuda_device, n_shards=24, n_rows=16, seed=5)
    up = DeviceUploader(slots=2, slot_bytes=12288)
    rng = np.random.default_rng(9)
    try:
        frags = [f.view("standard").fragment(s) for s in range(24)]
        for round_ in range(3):
            for frag in frags:
                up.submit(frag)
            assert up.flush(60)
            for frag in frags:
                assert np.array_equal(
                    bitops.to_host(frag.device_bits())[: frag.capacity],
                    frag._host[: frag.capacity],
                ), (round_, frag.shard)
            for frag in frags:  # dirty rows: patched out of place on the side stream
                frag.import_bits(rng.integers(0, 16, 50).astype(np.uint64),
                                 rng.integers(0, frag.shard_width, 50))
        snap = up.snapshot()
        assert snap["uploadErrors"] == 0
        assert snap["pinnedSlots"][0]["slotWaits"] >= 0 and snap["pinnedSlots"][0]["chunks"] > 48
    finally:
        up.close()


def test_a_default_stream_patch_behind_a_long_kernel_reaches_the_side_streams_copy(
        cuda_device, fresh_budget):
    """The dispatcher patches a fragment's rows in place on the default
    stream behind a long kernel, after the uploader's stream last waited for
    the default stream; the uploader then syncs the same fragment, out of
    place on its side stream. The side stream's read waits for the patch,
    so the new copy holds both writes."""
    import threading

    from pilosa_tpu_torch.ops import bitops, streams

    fresh_budget.configure(None)
    _, f, _ = _upload_index(cuda_device, n_shards=1, n_rows=8, seed=3)
    frag = f.view("standard").fragment(0)
    frag.device_bits()
    torch.cuda.synchronize()
    stager = streams.PinnedStager(cuda_device)

    def clear_col(row):
        bits = np.unpackbits(frag._host[frag._slot_of[row]].view(np.uint8), bitorder="little")
        return int(np.flatnonzero(bits == 0)[0])

    for round_ in range(3):
        entered, patched = threading.Event(), threading.Event()

        def dispatcher():
            entered.wait(30)
            torch.cuda._sleep(600_000_000)  # about 0.3 s on the default stream
            frag.set_bit(1, clear_col(1))
            frag.device_bits()  # in place, queued behind the sleep
            patched.set()

        t = threading.Thread(target=dispatcher)
        t.start()
        with streams.staging(stager):
            entered.set()
            assert patched.wait(30)
            frag.set_bit(2, clear_col(2))
            frag.device_bits()  # out of place on the side stream
        t.join(30)
        torch.cuda.synchronize()
        assert np.array_equal(
            bitops.to_host(frag._device)[: frag.capacity], frag._host[: frag.capacity]
        ), round_


def test_a_flights_launches_book_under_the_weighted_principals(cuda_device, fresh_budget):
    """One flight (execute_batch) under the batcher's weighted scope: every
    launch's device time is split across the principals in proportion, and
    the tenants' sums equal the kernels' device ms."""
    from pilosa_tpu_torch.obs import devledger

    fresh_budget.configure(None)
    h, f, ex = _upload_index(cuda_device, seed=8)
    led = devledger.ledger()
    led.settle()
    before = led.tenant_totals()
    sites0 = {k: v for k, v in led.site_device_ms().items() if k.startswith("kernels.")}
    flight = [(f"Count(Intersect(Row(f={a}), Row(f={a + 1})))", None) for a in range(8)]
    flight += [("TopN(f, Row(f=2), n=3)", None)]
    weights = [(("wa", "i", "read"), 0.75), (("wb", "i", "read"), 0.25)]
    with devledger.weighted_scope(weights):
        out = ex.execute_batch("i", flight)
    assert not any(isinstance(o, Exception) for o in out)
    led.settle()
    after = led.tenant_totals()
    sites = led.site_device_ms()
    spent = sum(sites[k][1] - sites0.get(k, (0, 0.0))[1] for k in sites0)
    da = after["wa"]["deviceMs"] - before.get("wa", {"deviceMs": 0.0})["deviceMs"]
    db = after["wb"]["deviceMs"] - before.get("wb", {"deviceMs": 0.0})["deviceMs"]
    assert spent > 0
    assert da == pytest.approx(0.75 * spent, rel=1e-3, abs=2e-3)
    assert db == pytest.approx(0.25 * spent, rel=1e-3, abs=2e-3)
    n, ms = led.measured_ms("kernels.gram", "gram")
    assert n >= 1 and ms > 0


def test_samplers_and_launches_never_wait_for_a_launch_in_flight(
        cuda_device, fresh_budget, tmp_path, monkeypatch):
    """A row scan queued behind about 0.1 s of work on the default stream
    is in flight while an exposition route's ledger snapshot waits for it.
    Meanwhile the metrics history's sample, a flight-recorder segment, the
    black box's read of every plane and the ledger's counters each return
    in under 10 ms, and a launch from a second thread (folding the finished
    pairs at each launch) returns as fast; the snapshot then reads every
    pair. A whole checkpoint, which also writes its segment file (an fsync
    and a rename take the disk's time, not the card's; PERF.md gives it),
    ends while the launch is still in flight."""
    import threading
    import time

    from pilosa_tpu_torch.obs import devledger, profile
    from pilosa_tpu_torch.server.node import NodeServer

    fresh_budget.configure(None)
    node = NodeServer(data_dir=str(tmp_path / "d"), device="cuda", port=0,
                      history_cadence=3600.0, flightrec_segment_seconds=3600.0,
                      blackbox_interval=3600.0, metric_poll_interval=3600.0)
    led = devledger.ledger()
    rng = np.random.default_rng(5)
    bits = _words(rng, 4, 8, 1024).to(cuda_device)
    plain = tk.row_counts_per_shard_plain(bits)
    tk.row_counts_per_shard(bits)
    torch.cuda.synchronize()
    led.snapshot()
    monkeypatch.setattr(devledger, "_SETTLE_AT", 1)  # every launch folds
    snaps = []
    try:
        node.flightrec._segment(profile.Sampler(), 0.1)  # the launch counts' baseline
        torch.cuda._sleep(600_000_000)  # about 0.3 s on the default stream
        slow = tk.row_counts_per_shard(bits)  # queued behind it
        waiter = threading.Thread(target=lambda: snaps.append(led.snapshot()))
        waiter.start()
        took, segs = {}, []
        for name, fn in (
            ("counters", led.counters),
            ("history.sample_once", node.history.sample_once),
            ("flightrec segment",
             lambda: segs.append(node.flightrec._segment(profile.Sampler(), 0.1))),
            ("blackbox checkpoint's read", lambda: node.blackbox._collect("test")),
            ("measured_ms", lambda: led.measured_ms("kernels.row_scan", "row_scan")),
            ("tenant_totals", led.tenant_totals),
        ):
            t0 = time.perf_counter()
            fn()
            took[name] = time.perf_counter() - t0
        t0 = time.perf_counter()
        node.blackbox.checkpoint("durable")
        checkpoint_s = time.perf_counter() - t0
        n_segments = len(node.blackbox._seg_files())
        launched = []

        def second():
            t0 = time.perf_counter()
            out = tk.row_counts_per_shard(bits)
            launched.append((time.perf_counter() - t0, out))

        th = threading.Thread(target=second)
        th.start()
        th.join(30)
        in_flight = not torch.cuda.current_stream(cuda_device).query()
        waiter.join(30)
        torch.cuda.synchronize()
        assert in_flight, "the long launch ended before the reads: nothing was measured"
        for name, s in took.items():
            assert s < 0.010, (name, took)
        assert n_segments == 1, n_segments  # the whole checkpoint wrote its file
        print(f"reads {took}, whole checkpoint {checkpoint_s:.4f} s")
        assert launched and launched[0][0] < 0.010, launched
        assert torch.equal(slow, plain) and torch.equal(launched[0][1], plain)
        # the snapshot waited for the queued launch and read its pair
        assert snaps and snaps[0]["sites"]["kernels.row_scan"]["launches"] >= 2
        # the segment in flight counted the queued launch, the next one the
        # second thread's
        seg = node.flightrec._segment(profile.Sampler(), 0.1)
        for s_ in (segs[0], seg):
            assert s_["kernelDispatchDelta"] == 1 and s_["devledgerDelta"]["launches"] == 1
    finally:
        torch.cuda.synchronize()
        node.stop()


# -- the cluster on the card: the mesh route and the HTTP fan-out ----------------


def _cluster_on(device, n=3, **kw):
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
    from pilosa_tpu_torch.testing.cluster import InProcessCluster

    cl = InProcessCluster(n, replica_n=2, device=device, **kw)
    for node in cl.nodes:
        node.client.timeout = 60.0
    rng = np.random.default_rng(31)
    cl.create_index("i")
    for f in ("f", "g"):
        cl.create_field("i", f)
        cl.nodes[0].api.import_bits("i", f, {
            "rowIDs": rng.integers(0, 12, 20000).astype(np.uint64),
            "columnIDs": rng.integers(0, 6 * SHARD_WIDTH, 20000).astype(np.uint64)})
    return cl


_CLUSTER_READS = [
    "Count(Union(Intersect(Row(f=1), Row(g=2)), Difference(Row(f=3), Row(g=4))))",
    "TopN(f, Row(g=1), n=3)",
    "GroupBy(Rows(f), Rows(g))",
    "GroupBy(Rows(f, limit=4), Rows(f, limit=4))",
]


@pytest.mark.parametrize("route", ["mesh", "http"])
def test_a_cluster_on_the_card_launches_kernels_on_both_routes(cuda_device, fresh_budget,
                                                                route):
    """Three nodes on ``cuda`` answer as three nodes on the CPU, on the mesh
    route (one facade call) and on the HTTP fan-out (a peer's per-call
    route), and their reads launch the masked scan, the cross gram and the
    gram (a lone cold tree Count takes the host tier on either route); no
    mesh read falls back."""
    fresh_budget.configure(None)
    cpu = _cluster_on("cpu")
    card = _cluster_on("cuda")
    try:
        if route == "http":
            for node in card.nodes:
                node.api.dist.mesh_enabled = False
        before = dict(tk.LAUNCHES)
        for q in _CLUSTER_READS:
            assert card.query(0, "i", q) == cpu.query(0, "i", q), q
        made = {k for k in tk.LAUNCHES if tk.LAUNCHES[k] > before[k]}
        assert {"masked_row_scan", "cross_gram", "gram"} <= made, made
        snap = card.nodes[0].api.dist.snapshot()
        assert snap["meshFallbacks"] == 0
        assert (snap["meshDispatches"] > 0) == (route == "mesh")
    finally:
        card.close()
        cpu.close()


def test_a_peers_side_stream_upload_is_seen_by_the_next_mesh_read(cuda_device,
                                                                    fresh_budget):
    """A cap that admits each fragment copy but declines every stack sends
    the mesh route's filtered TopN through the owners' fragment copies
    (``rows_device``), which each owner's ingest uploader makes on its side
    stream; a read through the other node at once after each import waits
    for the copy's event and counts what the host mirrors hold."""
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    fresh_budget.configure(8 << 20)  # a fragment copy fits; no stack does
    cl = _cluster_on("cuda", n=2)
    rng = np.random.default_rng(8)
    try:
        for round_ in range(4):
            cols = rng.integers(0, 6 * SHARD_WIDTH, 3000).astype(np.uint64)
            cl.nodes[1].api.import_bits("i", "f", {
                "rowIDs": np.full(len(cols), 20 + round_, dtype=np.uint64), "columnIDs": cols})
            got = cl.query(0, "i", "TopN(f, Row(g=3), n=4)")["results"][0]
            counts = {}
            node = cl.nodes[0]  # replica_n=2 on two nodes: it holds every shard
            for s in range(6):
                a = node.holder.fragment("i", "f", "standard", s)
                b = node.holder.fragment("i", "g", "standard", s)
                if a is None or b is None:
                    continue
                g3 = b.row_words_host(3)
                for r in a.row_ids():
                    c = int(np.bitwise_count(a.row_words_host(r) & g3).sum())
                    counts[r] = counts.get(r, 0) + c
            want = sorted(((-c, r) for r, c in counts.items() if c), )[:4]
            assert got == [{"id": r, "count": -c} for c, r in want], round_
        snap = cl.nodes[0].api.dist.snapshot()
        assert snap["meshFallbacks"] == 0 and snap["meshDispatches"] > 0
        ex = next(iter(cl.nodes[0].api.dist._mesh_cache.values()))
        assert ex.stacks_declined > 0
    finally:
        cl.close()


def test_the_facades_stacks_are_admitted_to_the_budget(cuda_device, fresh_budget):
    """The mesh route's facade executor admits its stacks to the process's
    device budget under keys of its own, beside the owners' entries."""
    fresh_budget.configure(None)
    budget = fresh_budget.default_budget(cuda_device)
    cl = _cluster_on("cuda")
    try:
        before = budget.snapshot()
        cl.query(0, "i", "Count(Intersect(Row(f=1), Row(g=2))) TopN(f, Row(g=2), n=2)")
        after = budget.snapshot()
        dist = cl.nodes[0].api.dist
        facades = list(dist._mesh_cache.values())
        assert facades
        keys = [e["bkey"] for ex in facades for caches in list(ex._stacks.values())
                for e in caches.values()]
        assert keys and all(k in budget._entries for k in keys)
        stack_bytes = sum(e["dev"].numel() * 4 for ex in facades
                          for caches in list(ex._stacks.values()) for e in caches.values())
        assert after["usedBytes"] - before["usedBytes"] >= stack_bytes > 0
        assert after["entries"] > before["entries"]
    finally:
        cl.close()


def test_a_kernel_error_on_the_mesh_route_raises(cuda_device, fresh_budget, monkeypatch):
    """A launch the wrapper refuses, and a CUDA error from a launch, raise
    through the mesh route: neither is demoted to the HTTP fan-out."""
    from pilosa_tpu_torch.server.api import ApiError

    fresh_budget.configure(None)
    cl = _cluster_on("cuda")
    real = tk.masked_row_counts
    try:
        def refused(bits, filt):
            return real(bits.to(torch.int64), filt)  # the wrapper refuses int64

        monkeypatch.setattr(tk, "masked_row_counts", refused)
        with pytest.raises(TypeError, match="int32"):
            cl.nodes[0].api.dist.execute("i", "TopN(f, Row(g=1), n=2)")
        # over the API a refusal is the client's 400, as JAX maps it
        with pytest.raises(ApiError, match="int32"):
            cl.query(0, "i", "TopN(f, Row(g=3), n=2)")

        def cuda_error(bits, filt):
            raise RuntimeError("CUDA error: an illegal memory access was encountered")

        monkeypatch.setattr(tk, "masked_row_counts", cuda_error)
        with pytest.raises(RuntimeError, match="CUDA error"):
            cl.query(0, "i", "TopN(f, Row(g=2), n=2)")
        assert cl.nodes[0].api.dist.snapshot()["meshFallbacks"] == 0
    finally:
        monkeypatch.undo()
        cl.close()


# -- the elastic planes on the card ------------------------------------------


def test_a_migrated_fragments_device_copy_equals_its_host_mirror(cuda_device, fresh_budget):
    """A node joins a card cluster online: every fragment it pulled makes a
    device copy equal to its host mirror, and the cluster answers as the
    same steps on the CPU do."""
    from pilosa_tpu_torch.ops import bitops

    fresh_budget.configure(None)
    cpu = _cluster_on("cpu", n=2)
    card = _cluster_on("cuda", n=2)
    try:
        cpu.add_node()
        joiner = card.add_node()
        pulled = 0
        for fname in ("f", "g"):
            view = joiner.holder.field("i", fname).view("standard")
            for frag in view.fragments.values():
                dev = frag.device_bits()
                assert dev.device.type == "cuda"
                frag.check_invariants(device=True)
                ids, words = frag.rows_matrix_host()
                assert np.array_equal(bitops.to_host(dev)[: len(ids)], words)
                pulled += 1
        assert pulled
        for q in _CLUSTER_READS:
            for i in range(3):
                assert card.query(i, "i", q) == cpu.query(0, "i", q), (i, q)
    finally:
        card.close()
        cpu.close()


def test_clean_unowned_fragments_returns_the_cards_bytes(cuda_device, fresh_budget):
    """A fragment that arrived on a node that does not own its shard, once
    on the card, leaves through the residency manager when the node drops
    what it does not own: the budget's bytes and ``memory_allocated`` go
    back to their level before it arrived."""
    fresh_budget.configure(None)
    budget = fresh_budget.default_budget(cuda_device)
    cl = _cluster_on("cuda", n=3)
    try:
        node = cl.nodes[0]
        shard = next(s for s in range(64) if not node.cluster.owns_shard(node.node_id, "i", s))
        # the uploads of the load settle, and what the node already held
        # outside its shards goes first: the level is the node's own
        for n in cl.nodes:
            assert n.api.ingest.uploader.flush(60)
        node.api._clean_unowned_fragments()
        torch.cuda.synchronize()
        b0, m0 = budget.used(), torch.cuda.memory_allocated()
        frag = node.holder.field("i", "f").create_view_if_not_exists(
            "standard").create_fragment_if_not_exists(shard)
        frag.import_bits(np.arange(8, dtype=np.uint64), np.arange(8, dtype=np.int64) * 977)
        assert int(frag.device_bits().sum()) != 0
        nbytes = frag._device_nbytes()
        torch.cuda.synchronize()
        m_peak = torch.cuda.memory_allocated()
        assert budget.used() == b0 + nbytes and m_peak >= m0 + nbytes
        assert node.api._clean_unowned_fragments() >= 1
        assert node.holder.fragment("i", "f", "standard", shard) is None
        assert frag._device is None
        torch.cuda.synchronize()
        assert budget.used() == b0
        assert torch.cuda.memory_allocated() == m0
    finally:
        cl.close()


def test_after_an_epoch_flip_the_facade_answers_from_the_new_owners(cuda_device, fresh_budget,
                                                                    monkeypatch):
    """Mid-resize, right after a shard flips, node 0's mesh route reads it
    from its new owner: a bit set on the new owner's copy alone shows in
    the count, which a facade kept from before the flip would not see."""
    from pilosa_tpu_torch.cluster import resize as rz
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    fresh_budget.configure(None)
    cl = _cluster_on("cuda", n=2)
    for node in cl.nodes:
        node.api.executor.rescache.max_entries = 0
    seen = []
    real_flip = rz.ResizeCoordinator._broadcast_flip

    def flip(self, nodes, index, shard, epoch):
        real_flip(self, nodes, index, shard, epoch)
        if seen:
            return
        # the owner node 0's route reads the shard from: only a shard it
        # now reads from the joiner tells a new owner from an old one
        (picked,) = cl.nodes[0].api.dist._group_by_live_owner(index, [shard], set())
        if picked in old_ids:
            return
        holder = next(n for n in cl.nodes if n.node_id == picked).holder
        frag = holder.fragment(index, "f", "standard", shard)
        col = next(c for c in range(SHARD_WIDTH) if not frag.get_bit(11, c))
        q = f"Count(Row(f=11))"
        before = cl.nodes[0].api.query(index, q)["results"][0]
        frag.set_bit(11, col)  # the new owner's copy only
        after = cl.nodes[0].api.query(index, q)["results"][0]
        frag.clear_bit(11, col)
        seen.append((shard, before, after))

    monkeypatch.setattr(rz.ResizeCoordinator, "_broadcast_flip", flip)
    old_ids = {n.node_id for n in cl.nodes}
    try:
        from pilosa_tpu_torch.server.node import NodeServer

        joiner = NodeServer(device="cuda", port=0, replica_n=2)
        joiner.start()
        cl.nodes.append(joiner)
        cl.coordinator.resize_coordinator().add_node(joiner.node_id, joiner.uri)
        assert seen
        _shard, before, after = seen[0]
        assert after == before + 1
        assert cl.nodes[0].api.dist.snapshot()["meshFallbacks"] == 0
    finally:
        monkeypatch.undo()
        cl.close()


def test_a_short_harness_run_on_the_card_validates_and_launches(cuda_device, fresh_budget):
    """``run_harness`` on ``cuda`` (its default): a one-node cluster on the
    card serves a short open-loop plan with the oversubscribed stage's cap;
    the report validates, no request fails, and the node launched kernels."""
    from pilosa_tpu_torch.loadgen import __main__ as lg_main
    from pilosa_tpu_torch.loadgen import harness, report, workload

    fresh_budget.configure(None)
    cfg = workload.WorkloadConfig(seed=11, n_rows=16, n_cols=40_000)
    stages = [
        harness.StageSpec("reads", 1.0, 40.0, 4, lg_main.OVERSUB_MIX),
        harness.StageSpec("oversubscribed", 1.0, 40.0, 4, lg_main.OVERSUB_MIX,
                          device_budget=lg_main.oversub_budget(cfg.n_cols, cfg.n_rows)),
        harness.StageSpec("mix", 1.0, 40.0, 4, None),
    ]
    before = tk.launch_total()
    rep = harness.run_harness(cfg, stages, preload_bits=512, cluster_setup=lg_main.tune_qos)
    torch.cuda.synchronize()
    report.validate_report(rep)
    assert rep["clientErrors"] == 0
    assert all(st["availability"] == 1.0 for st in rep["stages"]), rep["stages"]
    assert tk.launch_total() > before
    assert rep["devcosts"]["totals"]["launches"] > 0
    assert fresh_budget.default_budget().cap is None  # the stage's cap restored


# ---------------------------------------------------------------------------
# Sharded stacks: a mesh of slices on cuda:0 against the whole stack
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("case", sorted(meshcases.CASES))
def test_wrapper_over_a_mesh_on_the_card_matches_one_device(cuda_device, case, n):
    """Each kernel wrapper over a stack laid over n slices of cuda:0 (one
    launch a slice) answers as over the whole stack (one launch)."""
    ops = meshcases.Operands(torch.device("cuda", 0), S=9, R=70, R2=20, W=132)
    whole, got = meshcases.run_case(case, ops, n)
    assert whole.shape == got.shape and np.array_equal(whole, got), case


def test_an_executor_over_a_two_slice_mesh_launches_twice_and_matches(cuda_device,
                                                                      fresh_budget):
    """The executor over ``configure_serving(devices=[cuda:0] * 2)``: each
    stack two slices, every answer the single-device executor's, each
    kernel launched twice as often."""
    from pilosa_tpu_torch.core.field import FieldOptions
    from pilosa_tpu_torch.core.holder import Holder
    from pilosa_tpu_torch.exec.executor import Executor
    from pilosa_tpu_torch.parallel import mesh as mesh_mod
    from pilosa_tpu_torch.parallel import sharded

    rng = np.random.default_rng(4)
    holder = Holder(device="cuda")
    idx = holder.create_index("i")
    idx.create_field("f")
    idx.create_field("g")
    idx.create_field("v", FieldOptions(field_type="int", min_=-20, max_=5000))
    width = holder.n_words * 32
    n_cols = 6 * width
    idx.field("f").import_bits(rng.integers(0, 8, 6000).astype(np.uint64),
                               rng.integers(0, n_cols, 6000).astype(np.uint64))
    idx.field("g").import_bits(rng.integers(0, 4, 3000).astype(np.uint64),
                               rng.integers(0, n_cols, 3000).astype(np.uint64))
    idx.field("v").import_values(rng.choice(n_cols, 900, replace=False),
                                 rng.integers(-20, 5000, 900))
    queries = [
        " ".join(f"Count(Intersect(Row(f={a}), Row(f={b})))" for a, b in
                 [(0, 1), (2, 3), (4, 5), (6, 7)]),
        "TopN(f, Row(g=1), n=4)", "TopN(f, Row(g=2), tanimotoThreshold=3)",
        "GroupBy(Rows(f), Rows(g))", "GroupBy(Rows(f), Rows(g), Rows(f), filter=Row(g=0))",
        "Count(Intersect(Row(f=0), Row(f=1), Row(g=2))) Count(Union(Row(f=3), Row(g=0), Row(g=1)))",
        "Union(Row(f=0), Row(g=1)) Union(Row(f=2), Row(g=3))",
        "Count(Row(v > 100)) Count(Row(v < 3000)) Sum(field=v) Min(field=v) Max(Row(f=1), field=v)",
    ]

    import json

    from pilosa_tpu_torch.exec.result import result_to_json

    def run(ex):
        out, launches = [], []
        for q in queries:
            tk.reset_launches()
            out.append(json.dumps(result_to_json(ex.execute("i", q)), sort_keys=True))
            launches.append(dict(tk.LAUNCHES))
        return out, launches

    one, l_one = run(Executor(holder, rescache_entries=0, planner_enabled=False))
    mesh_mod.configure_serving(None, devices=[torch.device("cuda", 0)] * 2)
    try:
        ex = Executor(holder, rescache_entries=0, planner_enabled=False)
        two, l_two = run(ex)
        stacks = [e["dev"] for c in ex._stacks.values() for e in c.values()]
    finally:
        mesh_mod.configure_serving(None)
    assert two == one
    assert stacks and all(sharded.is_sharded(s) and len(s.slices) == 2 for s in stacks)
    for q, a, b in zip(queries, l_one, l_two):
        assert {k: 2 * n for k, n in a.items()} == b, (q, a, b)
    assert sum(sum(x.values()) for x in l_one) > 0
