"""One rank of a job of two processes over ``torch.distributed``: the
port's counterpart of the worker of ``tests/test_multihost.py``.

Run one process a rank, with the same arguments but ``--rank``::

    python -m pilosa_tpu_torch.testing.multihost --rank 0 --init file:///tmp/pg \\
        --device cpu [--backend gloo] [--shards 8] [--rows 5] [--words 256]

Each rank joins the process group through ``parallel.mesh.init_multihost``
(``--local-devices`` slices of ``--device`` each, so the global mesh holds
``2 x --local-devices`` slices, the ranks' in rank order) and owns the
shards with ``shard % 2 == rank`` (the placement hash's counterpart). The
data of shard ``s`` is drawn from ``default_rng([seed, s])``: about a
quarter of the bits of ``--rows`` rows of ``--words`` words, and 600
values of an int field over all shards, so every rank knows every
shard's truth. Then:

1. the executor on a local mesh of the rank's slices answers pair Counts,
   a tree Count and a Sum over its own shards; the ranks' partials are
   summed with ``all_reduce`` and held to the truth;
2. one stack laid over the global mesh (``sharded.shard_local``: each
   rank's block, the global shard order process-major) is read by the
   kernel wrappers, whose int64 totals are summed across the ranks:
   ``pair_gram`` (all rows and a subset), ``row_counts``,
   ``cross_pair_gram``, ``pair_count_batched`` (intersect, union, and a
   batch wider than ``GRAM_MAX_ROWS``), ``pair_count_two_batched``,
   ``masked_row_counts`` with the filter in the global order,
   ``astbatch.run_count_batch``, and, with the int32 accumulator limit
   shrunk, the grams' chunked branch; each against the truth;
3. it prints ``proc<rank> OK`` and leaves the group.

A failed check raises, and the process exits non-zero. ``chip_smoke.py``
runs two such ranks on one card over gloo (NCCL refuses two ranks on one
device); ``tests/test_torch_multihost.py`` runs them on the CPU.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

N_VALUES = 600
V_MAX = 500


def _log(rank: int, msg: str, t0: float) -> None:
    print(f"[proc{rank} {time.perf_counter() - t0:.1f} s] {msg}", flush=True)


def shard_block(seed: int, shard: int, rows: int, words: int) -> np.ndarray:
    """``uint32[rows, words]``: shard ``shard``'s bits, about a quarter set."""
    rng = np.random.default_rng([seed, shard])
    a = rng.integers(0, 2**32, size=(rows, words), dtype=np.uint32)
    return a & rng.integers(0, 2**32, size=(rows, words), dtype=np.uint32)


def _popc(x: np.ndarray, axis=None) -> np.ndarray:
    return np.bitwise_count(x).sum(axis=axis, dtype=np.int64)


class Truth:
    """Every check's answer over all shards, from the numpy blocks, one
    shard at a time; the blocks of the shards in ``mine`` and every shard's
    filter row are kept (``blocks``, ``filt``)."""

    def __init__(self, args, mine, filt_row):
        R = args.rows
        k = min(R, 5)  # the rows the grams and pair batches read
        self.gram = np.zeros((k, k), np.int64)
        self.rows = np.zeros(R, np.int64)
        self.masked = np.zeros(R, np.int64)
        self.union3 = 0
        self.inter3 = 0
        self.blocks, self.filt = {}, {}
        for s in range(args.shards):
            b = shard_block(args.seed, s, R, args.words)
            if s in mine:
                self.blocks[s] = b
            self.filt[s] = b[filt_row]
            sub = b[:k]
            self.gram += np.array([[_popc(sub[i] & sub[j]) for j in range(k)] for i in range(k)])
            self.rows += _popc(b, axis=1)
            self.masked += _popc(b & b[filt_row][None], axis=1)
            self.union3 += _popc(b[0] | b[1] | b[2])
            self.inter3 += _popc(b[0] & b[1] & b[k - 1])
        self.union = lambda a, c: self.rows[a] + self.rows[c] - self.gram[a, c]


def _values(args, width: int):
    rng = np.random.default_rng([args.seed, args.shards + 1])
    cols = rng.choice(args.shards * width, size=N_VALUES, replace=False)
    return cols, rng.integers(0, V_MAX, size=N_VALUES)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, default=2)
    p.add_argument("--init", required=True, help="the process group's init method")
    p.add_argument("--device", default="cpu")
    p.add_argument("--backend", default=None)
    p.add_argument("--local-devices", type=int, default=2)
    p.add_argument("--shards", type=int, default=8)
    p.add_argument("--rows", type=int, default=5)
    p.add_argument("--words", type=int, default=256)
    p.add_argument("--seed", type=int, default=42)
    args = p.parse_args(argv)
    if args.world != 2:
        raise SystemExit("the job has two ranks")
    t0 = time.perf_counter()
    rank = args.rank

    from pilosa_tpu_torch.core.field import FieldOptions
    from pilosa_tpu_torch.core.holder import Holder
    from pilosa_tpu_torch.exec import astbatch
    from pilosa_tpu_torch.exec.executor import Executor
    from pilosa_tpu_torch.ops import kernels
    from pilosa_tpu_torch.parallel import mesh as mesh_mod
    from pilosa_tpu_torch.parallel import sharded

    dev = torch.device(args.device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    mesh_mod.configure_serving(None, devices=[dev] * args.local_devices)
    mesh_g = mesh_mod.init_multihost(args.init, args.world, rank, backend=args.backend)
    dist = torch.distributed
    assert dist.get_world_size() == 2 and mesh_mod.mesh_spans_processes(mesh_g), mesh_g
    assert mesh_g.size == 2 * args.local_devices, mesh_g
    assert mesh_g.processes == (0,) * args.local_devices + (1,) * args.local_devices
    _log(rank, f"joined over {dist.get_backend()}: mesh of {mesh_g.size} slices", t0)

    R, W, N = args.rows, args.words, args.shards
    width = W * 32
    mine = [s for s in range(N) if s % 2 == rank]
    filt_row = 1
    k = min(R, 5)
    pairs = [(0, 1), (2, 3), (1, k - 1), (3, 0)]
    # a pair batch wider than the gram takes
    n_wide = np.arange(kernels.GRAM_MAX_ROWS + 24)
    wide = (n_wide % k, (n_wide * 3 + 1) % k)
    truth = Truth(args, set(mine), filt_row)
    blocks = truth.blocks
    vcols, vvals = _values(args, width)
    _log(rank, f"data: {len(mine)} own shards of {R} x {W} words, truths", t0)

    # 1. the executor over this rank's shards, on its local mesh
    holder = Holder(n_words=W, device=dev)
    idx = holder.create_index("i")
    f = idx.create_field("f")
    v = idx.create_field("v", FieldOptions(field_type="int", min_=0, max_=V_MAX))
    for s in mine:
        frag = f.create_view_if_not_exists("standard").create_fragment_if_not_exists(s)
        frag.load_rows_matrix(list(range(R)), blocks[s])
    own = (vcols // width) % 2 == rank
    v.import_values(vcols[own], vvals[own])
    ex = Executor(holder, rescache_entries=0)
    res = ex.execute(
        "i",
        "Count(Intersect(Row(f=0), Row(f=1))) Count(Union(Row(f=2), Row(f=3))) "
        f"Count(Intersect(Row(f=0), Row(f=1), Row(f={k - 1}))) Sum(field=v)",
        shards=mine,
    )
    stacks = [e["dev"] for c in ex._stacks.values() for e in c.values()]
    assert stacks and all(sharded.is_sharded(st) and len(st.slices) == args.local_devices
                          for st in stacks), stacks
    part = torch.tensor([res[0], res[1], res[2], res[3].value, res[3].count], dtype=torch.int64)
    part = sharded.all_reduce(part)
    want = [int(truth.gram[0, 1]), int(truth.union(2, 3)), truth.inter3,
            int(vvals.sum()), N_VALUES]
    assert part.tolist() == want, (part.tolist(), want)
    _log(rank, f"executor partials reduced: {part.tolist()}", t0)

    # 2. one stack over the global mesh: each rank's own block
    gbits = sharded.shard_local(np.stack([blocks[s] for s in mine]), mesh_g)
    assert kernels.stack_spans_processes(gbits)
    g = kernels.pair_gram(gbits, list(range(k)))
    assert np.array_equal(g, truth.gram), (g.tolist(), truth.gram.tolist())
    sub = [0, 2, k - 1]
    assert np.array_equal(kernels.pair_gram(gbits, sub), truth.gram[np.ix_(sub, sub)])
    rc = kernels.row_counts(gbits).cpu().numpy()
    assert rc.tolist() == truth.rows.tolist(), (rc.tolist(), truth.rows.tolist())
    xg = kernels.cross_pair_gram(gbits, gbits, sub, [1, 3])
    assert np.array_equal(xg, truth.gram[np.ix_(sub, [1, 3])])
    ras = np.array([a for a, _ in pairs], np.int32)
    rbs = np.array([b for _, b in pairs], np.int32)
    pc = kernels.pair_count_batched(gbits, ras, rbs)
    assert pc.dim() == 1 and pc.dtype == torch.int64, (pc.shape, pc.dtype)
    assert pc.tolist() == [int(truth.gram[a, b]) for a, b in pairs]
    pu = kernels.pair_count_batched(gbits, ras, rbs, op="union")
    assert pu.tolist() == [int(truth.union(a, b)) for a, b in pairs]
    pw = kernels.pair_count_batched(gbits, *wide)
    assert pw.tolist() == [int(truth.gram[a, b]) for a, b in zip(*wide)]
    p2 = kernels.pair_count_two_batched(gbits, gbits, ras, rbs)
    assert p2.tolist() == [int(truth.gram[a, b]) for a, b in pairs]
    # the filter over the global shard axis, in its process-major order
    order = [s for r in (0, 1) for s in range(N) if s % 2 == r]
    filt = np.stack([truth.filt[s] for s in order])
    mc = kernels.masked_row_counts(gbits, filt)
    assert mc.tolist() == truth.masked.tolist(), (mc.tolist(), truth.masked.tolist())
    tot = astbatch.run_count_batch(
        ("intersect", ("row", 0), ("row", 0)), (gbits,),
        np.array([[0, 1], [2, 3], [1, k - 1], [-1, 2]], np.int32),
    )
    assert tot.tolist() == [int(truth.gram[0, 1]), int(truth.gram[2, 3]),
                            int(truth.gram[1, k - 1]), 0], tot.tolist()
    tot3 = astbatch.run_count_batch(("union", ("row", 0), ("row", 0), ("row", 0)), (gbits,),
                                    np.array([[0, 1, 2]], np.int32))
    assert tot3.tolist() == [truth.union3], (tot3.tolist(), truth.union3)
    for name, fn in (("tree words", lambda: kernels.tree_words(
            (gbits,), [0, 1, kernels.TREE_AND], [0, 0], np.array([0, 1], np.int32))),
            ("combos", lambda: kernels.gather_prefix(gbits, [0]))):
        try:
            fn()
        except ValueError:
            pass
        else:
            raise AssertionError(f"{name} over a spanning stack were not declined")
    _log(rank, "spanning reads exact", t0)

    # the chunked branch: each launch's int32 totals kept exact by shrinking
    # the accumulator limit below the stack's extent
    old = kernels._GRAM_ACC_LIMIT
    per = gbits.slices[0].shape[0]
    kernels._GRAM_ACC_LIMIT = max(1, per // 2) * W * 32
    try:
        assert not kernels._gram_int32_safe(per, W)
        g2 = kernels.pair_gram(gbits, list(range(k)))
        x2 = kernels.cross_pair_gram(gbits, gbits, sub, [1])
    finally:
        kernels._GRAM_ACC_LIMIT = old
    assert np.array_equal(g2, truth.gram)
    assert np.array_equal(x2, truth.gram[np.ix_(sub, [1])])
    _log(rank, "chunked spanning grams exact", t0)
    dist.barrier()
    dist.destroy_process_group()
    print(f"proc{rank} OK {part.tolist()}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
