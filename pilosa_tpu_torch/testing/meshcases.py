"""Every kernel wrapper that reads a stack, held over a ``ShardedStack`` to
the same wrapper over the whole stack.

Each case of :data:`CASES` computes one wrapper's answer from seeded
operands (:class:`Operands`) as a numpy array, given ``lay``: the
identity for the whole stack, or a function laying a tensor over a mesh
of ``n`` slices (``parallel/sharded.shard``). A per-shard answer of a
sharded stack carries the padded shards at its end; :func:`run_case`
checks they are zero and cuts them off, so both layouts must give equal
arrays. The CPU tests run the cases on meshes of CPU slices (each
wrapper's plain version a slice), the card tests on ``cuda:0`` slices
(each wrapper's kernel a slice).
"""

from __future__ import annotations

import numpy as np
import torch

from pilosa_tpu_torch.ops import bsi, kernels
from pilosa_tpu_torch.parallel import mesh as mesh_mod
from pilosa_tpu_torch.parallel import sharded

DEPTH = 6


def _words(rng, shape, dense: bool = True) -> np.ndarray:
    a = rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    return a if dense else a & rng.integers(0, 2**32, size=shape, dtype=np.uint32)


class Operands:
    """Seeded operands of ``S`` shards of ``W`` words on ``device``: stacks
    of ``R`` and ``R2`` rows, a filter row per shard, a BSI stack of depth
    :data:`DEPTH` (exists, sign, planes) and a filter per query."""

    def __init__(self, device, S: int = 7, R: int = 12, R2: int = 9, W: int = 64, seed: int = 5):
        rng = np.random.default_rng(seed)
        dev = torch.device(device)

        def put(a):
            return torch.from_numpy(a.view(np.int32)).to(dev)

        self.S, self.W = S, W
        self.bits = put(_words(rng, (S, R, W)))
        self.bits2 = put(_words(rng, (S, R2, W), dense=False))
        self.filt = put(_words(rng, (S, W), dense=False))
        b = _words(rng, (S, 2 + DEPTH, W))
        b[:, 0] &= _words(rng, (S, W))  # exists: about half the columns
        b[:, 1] &= b[:, 0]
        self.bsi = put(b)
        self.filters = put(_words(rng, (S, 3, W)))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _bsi_ops(o, lay):
    b = lay(o.bsi)
    return b[:, 2:], b[:, 0], b[:, 1]


def _chunked(fn):
    """``fn`` with the grams' int32 accumulator limit shrunk to two shards,
    so every launch goes through the chunked branch."""
    def run(o, lay):
        old = kernels._GRAM_ACC_LIMIT
        kernels._GRAM_ACC_LIMIT = 2 * o.W * 32
        try:
            return fn(o, lay)
        finally:
            kernels._GRAM_ACC_LIMIT = old
    return run


_TREE_CODE = [0, 1, kernels.TREE_AND, 2, kernels.TREE_OR, 3, kernels.TREE_ANDNOT]
_TREE_LEAVES = [0, 1, 0, 1]
_TREE_SLOTS = np.array([[0, 1, 2, 3], [4, -1, 5, 0], [7, 2, -1, 8], [11, 8, 3, 1]], np.int32)


def _prefix(o, lay):
    p = kernels.gather_prefix(lay(o.bits), [0, 3, 5, 7, 9, 11])
    kernels.mask_prefix(p, lay(o.filt))
    return p


# name -> (per_shard axis of the answer or None, fn(operands, lay))
CASES = {
    "row_counts_per_shard": (0, lambda o, lay: kernels.row_counts_per_shard(lay(o.bits))),
    "row_counts": (None, lambda o, lay: kernels.row_counts(lay(o.bits)).to(torch.int64)),
    "masked_row_counts_per_shard": (0, lambda o, lay: kernels.masked_row_counts_per_shard(
        lay(o.bits), lay(o.filt))),
    "masked_row_counts": (None, lambda o, lay: kernels.masked_row_counts(lay(o.bits), o.filt)),
    "gram_gather": (None, lambda o, lay: kernels.gram_gather(lay(o.bits), [1, 4, 4, 9, 0])),
    "pair_gram": (None, lambda o, lay: kernels.pair_gram(lay(o.bits), [2, 5, 7, 11])),
    "pair_gram_chunked": (None, _chunked(
        lambda o, lay: kernels.pair_gram(lay(o.bits), list(range(12))))),
    "pair_count_batched": (1, lambda o, lay: kernels.pair_count_batched(
        lay(o.bits), [0, 3, 11, 5], [1, 3, 2, 10], op="union")),
    "pair_count_two_batched": (1, lambda o, lay: kernels.pair_count_two_batched(
        lay(o.bits), lay(o.bits2), [0, 3, 11], [8, 0, 4], op="xor")),
    "cross_gram_gather": (None, lambda o, lay: kernels.cross_gram_gather(
        lay(o.bits), lay(o.bits2), [0, 2, 11], [1, 8])),
    "cross_pair_gram": (None, lambda o, lay: kernels.cross_pair_gram(
        lay(o.bits), lay(o.bits2), [0, 2, 4, 6], [1, 3, 5])),
    "cross_pair_gram_chunked": (None, _chunked(lambda o, lay: kernels.cross_pair_gram(
        lay(o.bits), lay(o.bits2), list(range(12)), list(range(9))))),
    "gather_prefix": (1, lambda o, lay: _prefix(o, lay).cpu()),
    "refine_prefix": (1, lambda o, lay: kernels.refine_prefix(
        _prefix(o, lay), lay(o.bits2), [0, 0, 5, 2], [1, 8, 3, 3]).cpu()),
    "combo_counts": (2, lambda o, lay: kernels.combo_counts(
        _prefix(o, lay), lay(o.bits2), [0, 4, 8])),
    "combo_counts_gram": (None, lambda o, lay: kernels.combo_counts_gram(
        _prefix(o, lay), lay(o.bits2), list(range(9)))),
    "tree_count": (1, lambda o, lay: kernels.tree_count(
        (lay(o.bits), lay(o.bits2)), _TREE_CODE, _TREE_LEAVES, _TREE_SLOTS)),
    "tree_words": (0, lambda o, lay: kernels.tree_words(
        (lay(o.bits), lay(o.bits2)), _TREE_CODE, _TREE_LEAVES, _TREE_SLOTS[1])),
    "topn_counts": (None, lambda o, lay: np.stack(kernels.topn_counts(lay(o.bits), 5))),
    "bsi_range_count": (1, lambda o, lay: bsi.bsi_range(
        *_bsi_ops(o, lay), bsi._queries_table([[("<", 20)], [(">=", -7)], [("!=", 3)]], DEPTH),
        count=True)),
    "bsi_range_words": (1, lambda o, lay: bsi.bsi_range(
        *_bsi_ops(o, lay), bsi._queries_table([[(">", 5), ("<=", 40)], [("==", -9)]], DEPTH),
        count=False)),
    "bsi_sum": (0, lambda o, lay: bsi.bsi_sum(*_bsi_ops(o, lay), o.filters)),
    "bsi_sum_unfiltered": (0, lambda o, lay: bsi.bsi_sum(*_bsi_ops(o, lay))),
    "bsi_extreme_max": (0, lambda o, lay: bsi.bsi_extreme(
        *_bsi_ops(o, lay), o.filt, maximal=True)),
    "bsi_extreme_min": (0, lambda o, lay: bsi.bsi_extreme(*_bsi_ops(o, lay), maximal=False)),
    "bsi_sum_batch": (None, lambda o, lay: bsi.bsi_sum_batch(
        *_bsi_ops(o, lay), lay(o.bits), [3, -1, 11, 3, 0])),
    "sum_batch_host": (None, lambda o, lay: np.array(bsi.sum_batch_host(
        *_bsi_ops(o, lay), o.filters, depth=DEPTH), dtype=object)),
    "sum_host": (None, lambda o, lay: np.array(bsi.sum_host(
        *_bsi_ops(o, lay), o.filt, depth=DEPTH), dtype=object)),
    "min_max_host": (None, lambda o, lay: np.array(
        [bsi.min_max_host(*_bsi_ops(o, lay), o.filt, depth=DEPTH, maximal=m)
         for m in (True, False)], dtype=object)),
}


def layout(device, n: int):
    """``lay`` for a local mesh of ``n`` slices of ``device``."""
    m = mesh_mod.local_mesh([device] * n)
    return lambda t: sharded.shard(t, m)


def run_case(name: str, ops: Operands, n: int) -> tuple[np.ndarray, np.ndarray]:
    """``(whole, over n slices)`` answers of case ``name``: equal arrays
    once the sharded answer's padded shards (checked zero) are cut."""
    axis, fn = CASES[name]
    whole = _np(fn(ops, lambda t: t))
    got = _np(fn(ops, layout(ops.bits.device, n)))
    if axis is not None:
        pad = -(-ops.S // n) * n
        assert got.shape[axis] == pad, (name, got.shape, pad)
        tail = np.take(got, np.arange(ops.S, pad), axis=axis)
        assert not tail.any(), f"{name}: the padded shards are not zero"
        got = np.take(got, np.arange(ops.S), axis=axis)
    return whole, got
