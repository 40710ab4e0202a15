"""The port on the card: each CUDA kernel against its plain version, and
the executor on ``cuda`` against the same executor on the CPU.

Every test here needs a CUDA device and skips where there is none. The
file imports no JAX, so it runs on a machine with a card and no JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
Counts are integers: every comparison is exact.
"""

import numpy as np
import pytest
import torch

from pilosa_tpu_torch.ops import kernels as tk

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

    def plain(r):
        if isinstance(r, int):
            return r
        return [
            (p.id, p.count) if hasattr(p, "id")
            else ([(g.field, g.row_id) for g in p.group], p.count)
            for p in r
        ]

    before = dict(tk.LAUNCHES)
    out = []
    for e in executors:
        for q in sets:
            e.execute("i", q)
        res = e.execute("i", topn) + e.execute("i", pairs) + e.execute("i", groupby)
        e.execute("i", "Clear(5, f=1) Set(6, f=1) ClearRow(f=2) Set(7, g=4)")
        res += e.execute("i", topn) + e.execute("i", pairs) + e.execute("i", groupby)
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
