"""The port's native host tier against ``pilosa_tpu``'s.

``pilosa_tpu_torch/native/hostops.cpp`` (built by the port's own loader,
``pilosa_tpu_torch/nativelib.py``) and its bindings against the JAX
package's bindings of its own copy and against the numpy plain versions:
pair counts of every op (by array and by address, with absent rows on the
shared zero row), popcounts, materialised ops, and the import merge (set
and clear, id-keyed and inverse-keyed) through ``Fragment.import_bits``.
Then the executor's host tier, one native call per chunk of fragments,
against the JAX executor's, and the loader: two processes building the
library at once both load it, and a missing compiler raises.
"""

import gc
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from pilosa_tpu.core.fragment import Fragment as JaxFragment
from pilosa_tpu.core.holder import Holder as JaxHolder
from pilosa_tpu.exec.executor import Executor as JaxExecutor
from pilosa_tpu.ops import _hostops as jh
from pilosa_tpu_torch import convert, nativelib
from pilosa_tpu_torch.core.fragment import Fragment as TorchFragment
from pilosa_tpu_torch.exec.executor import Executor as TorchExecutor
from pilosa_tpu_torch.ops import _hostops as th
from pilosa_tpu_torch.ops import bitops as tb


@pytest.fixture(scope="module", autouse=True)
def _freeze_what_came_before():
    """Freeze what is alive when the module's tests begin (the imports'
    objects, above all JAX's), so that the collection after each test
    scans only what the tests made; unfreeze and collect at the end."""
    gc.collect()
    gc.freeze()
    yield
    gc.unfreeze()
    gc.collect()


@pytest.fixture(autouse=True)
def _collect_after_each_test():
    """Collect each test's garbage at its end, where no lock is held: the
    JAX holders' and executors' device-budget entries release their bytes
    in finalizers that take the budget's lock, and left to a later
    collection they may run while another test's code holds a lock (a
    collection can start at any allocation)."""
    yield
    gc.collect()


REPO = Path(__file__).resolve().parents[1]
OPS = ["intersect", "union", "difference", "xor"]


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    """The JAX package's library is on (the comparison is native against
    native), and so is the port's."""
    assert jh.load() is not None
    th.load()


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("n", [0, 1, 7, 512, 1025])
def test_pair_count_popcount_and_op(op, n):
    rng = np.random.default_rng(n * 7 + OPS.index(op))
    a = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    b = rng.integers(0, 2**32, size=n, dtype=np.uint32) & rng.integers(
        0, 2**32, size=n, dtype=np.uint32)
    want = tb.pair_count_host_plain(a, b, op)
    assert th.pair_count(a, b, op) == want == jh.pair_count(a, b, op)
    assert tb.pair_count_host(a, b, op) == want
    assert tb.popcount_host(a) == tb.popcount_host_plain(a) == jh.popcount(a)
    got = th.pair_op(a, b, op)
    assert np.array_equal(got, jh.pair_op(a, b, op))
    assert tb.popcount_host_plain(got) == want


@pytest.mark.parametrize("op", OPS)
def test_pair_count_addrs_with_zero_rows(op):
    """Rows by absolute address, some of them the shared zero row: the
    port's sum equals JAX's and the per-pair numpy sum."""
    rng = np.random.default_rng(OPS.index(op))
    n_words = 96
    mat = rng.integers(0, 2**32, size=(9, n_words), dtype=np.uint32)
    zeros = np.zeros(n_words, dtype=np.uint32)
    base = mat.__array_interface__["data"][0]
    zaddr = zeros.__array_interface__["data"][0]
    pick_a = rng.integers(-1, 9, size=40)
    pick_b = rng.integers(-1, 9, size=40)
    addr = lambda p: np.array([zaddr if k < 0 else base + k * n_words * 4 for k in p],
                              dtype=np.uint64)
    row = lambda k: zeros if k < 0 else mat[k]
    want = sum(tb.pair_count_host_plain(row(x), row(y), op) for x, y in zip(pick_a, pick_b))
    got = th.pair_count_addrs(addr(pick_a), addr(pick_b), n_words, op)
    assert got == want == jh.pair_count_addrs(addr(pick_a), addr(pick_b), n_words, op)
    with pytest.raises(ValueError):
        th.pair_count(mat[0], mat[1, :5], op)


def _import_case(seed: int, hashed: bool):
    rng = np.random.default_rng(seed)
    n = 3000
    ids = (rng.integers(2**60, 2**64 - 1, size=6, dtype=np.uint64) if hashed
           else rng.integers(0, 40, size=6).astype(np.uint64))
    rows = ids[rng.integers(0, len(ids), size=n)]
    cols = rng.integers(0, 512 * 32, size=n).astype(np.int64)
    return rows, cols


@pytest.mark.parametrize("hashed", [False, True], ids=["id_keyed", "inverse_keyed"])
@pytest.mark.parametrize("seed", [1, 2])
def test_import_bits_native_plain_and_jax(seed, hashed):
    """``Fragment.import_bits`` (native merge; id-keyed keys, or
    inverse-keyed for row ids past 2^62 / width) against its numpy plain
    version and JAX's fragment: the same changed counts, mirrors and
    maintained row counts, through sets and then clears."""
    rows, cols = _import_case(seed, hashed)
    tf = TorchFragment(n_words=512, device="cpu")
    pf = TorchFragment(n_words=512, device="cpu")
    jf = JaxFragment(n_words=512)
    for f in (tf, pf, jf):
        f.row_counts()  # the maintained counts ride the import deltas
    half = len(rows) // 2
    steps = [(rows[:half], cols[:half], False), (rows, cols, False),
             (rows[::3], cols[::3], True), (rows[:10], cols[:10] + 1, False)]
    for r, c, clear in steps:
        n_t = tf.import_bits(r, c, clear=clear)
        n_p = pf.import_bits_plain(r, c, clear=clear)
        n_j = jf.import_bits(r, c, clear=clear)
        assert n_t == n_p == n_j
        jids, jmat = jf.rows_matrix_host()
        for f in (tf, pf):
            ids, mat = f.rows_matrix_host()
            assert ids == jids and np.array_equal(mat, jmat)
            assert np.array_equal(f.row_counts()[1], jf.row_counts()[1])
            f.check_invariants()


def test_import_merge_binding_against_jax():
    """The bindings alone on one mirror: the same changed bits, per-row
    counts, changed words and positions."""
    rng = np.random.default_rng(5)
    width, n_words = 64 * 32, 64
    row_ids = np.array([3, 9, 40], dtype=np.uint64)
    slots = np.array([2, 0, 1], dtype=np.int64)
    ri = rng.integers(0, 3, size=500)
    key = np.sort(ri.astype(np.int64) * width + rng.integers(0, width, size=500))
    for clear in (False, True):
        mt = np.zeros((4, n_words), np.uint32) if not clear else mirror_t
        mj = mt.copy()
        got = th.import_merge(key, width, n_words, slots, row_ids, mt, clear, want_wal=True)
        want = jh.import_merge(key, width, n_words, slots, row_ids, mj, clear)
        assert np.array_equal(mt, mj)
        assert got[0] == want[0]
        for g, w in zip(got[1:], want[1:]):
            assert np.array_equal(g, w)
        mirror_t = mt
    with pytest.raises(ValueError):
        th.import_merge(key, width, n_words, slots, row_ids, mt[:, ::2], False)


def _holders(n_shards: int, seed: int):
    rng = np.random.default_rng(seed)
    jhold = JaxHolder()
    idx = jhold.create_index("i")
    idx.create_field("f")
    width = jhold.n_words * 32
    rows = rng.integers(0, 5, size=4000).astype(np.uint64)
    cols = rng.integers(0, n_shards * width, size=4000).astype(np.uint64)
    idx.field("f").import_bits(rows, cols)
    # row 7 lives in one shard only: most fragments lack it
    idx.field("f").import_bits(np.full(20, 7, np.uint64), rng.integers(0, width, 20))
    frags = {}
    for vname, view in idx.field("f").views.items():
        for shard, frag in view.fragments.items():
            frags[("i", "f", vname, shard)] = frag.rows_matrix_host()
    thold = convert.holder_from_arrays(jhold.schema(), frags, device="cpu")
    return JaxExecutor(jhold), TorchExecutor(thold)


@pytest.mark.parametrize("n_shards", [3, 50])
def test_host_tier_pair_counts_match_jax(n_shards, monkeypatch):
    """Lone cold pair Counts on the host tier (one native call per chunk
    of 24 fragments; 50 shards fan out over the pool) equal JAX's, with
    absent rows on every side."""
    je, te = _holders(n_shards, 11 + n_shards)
    te._PAIR_SINGLE_WARM = je._PAIR_SINGLE_WARM = 10**9  # always cold
    chunks = []
    real = TorchExecutor._host_pair_count_chunk
    monkeypatch.setattr(TorchExecutor, "_host_pair_count_chunk",
                        staticmethod(lambda fr, a, b, op: chunks.append(len(fr))
                                     or real(fr, a, b, op)))
    queries = [f"Count({op}(Row(f={a}), Row(f={b})))"
               for op in ("Intersect", "Union", "Difference", "Xor")
               for a, b in ((0, 1), (2, 7), (7, 3), (9, 8), (4, 4))]
    queries += ["Count(Row(f=7))", "Count(Row(f=2))", "Count(Row(f=99))"]
    for q in queries:
        assert te.execute("i", q) == je.execute("i", q), q
    per_query = -(-n_shards // 24) if n_shards >= 48 else 1
    assert len(chunks) == per_query * len(queries)
    assert (te._host_pool is not None) == (n_shards >= 48 and (os.cpu_count() or 1) > 1)


@pytest.mark.parametrize("n", [0, 1, 7, 512, 1025])
def test_extract_positions_matches_jax(n):
    """``ph_extract`` (the op log's mask records): the set bits' offsets
    plus a base, ascending, as JAX's binding and numpy give them."""
    rng = np.random.default_rng(n + 3)
    words = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    words[::3] = 0
    base = (1 << 40) + n
    want = np.flatnonzero(np.unpackbits(words.view(np.uint8), bitorder="little"))
    got = th.extract_positions(words, base)
    assert got.dtype == np.uint64
    assert np.array_equal(got, want.astype(np.uint64) + np.uint64(base))
    assert np.array_equal(got, jh.extract_positions(words, base))


_BUILD_RACE = r"""
import sys, time
from pathlib import Path
sys.path.insert(0, sys.argv[1])
from pilosa_tpu_torch import nativelib
nativelib.BUILD_ROOT = Path(sys.argv[2])
while time.time() < float(sys.argv[3]):
    time.sleep(0.001)
from pilosa_tpu_torch.ops import _hostops
import numpy as np
a = np.arange(64, dtype=np.uint32)
print("OK", _hostops.pair_count(a, a, "intersect"))
"""


def test_two_processes_build_at_once_and_both_load(tmp_path):
    import time

    start = time.time() + 2.0
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _BUILD_RACE, str(REPO), str(tmp_path), str(start)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for _ in range(2)
    ]
    want = f"OK {int(np.bitwise_count(np.arange(64, dtype=np.uint32)).sum())}"
    for p in procs:
        out, err = p.communicate(timeout=180)
        assert p.returncode == 0 and out.strip() == want, err
    built = list(tmp_path.rglob("*"))
    assert [p.name for p in built if p.is_file()] == ["libhostops.so"]


def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(nativelib, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(nativelib.shutil, "which", lambda name: None)
    with pytest.raises(nativelib.NativeBuildError, match="g\\+\\+ not found"):
        nativelib.load("hostops.cpp", th._bind)
    monkeypatch.setattr(th, "_lib", None)
    with pytest.raises(nativelib.NativeBuildError):
        tb.pair_count_host(np.zeros(4, np.uint32), np.zeros(4, np.uint32), "xor")
    with pytest.raises(nativelib.NativeBuildError):
        TorchFragment(n_words=64, device="cpu").import_bits([1], [2])
