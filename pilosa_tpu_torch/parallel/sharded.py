"""Stacks cut over a serving mesh, and the sharded-field facade
(counterpart of ``pilosa_tpu/parallel/sharded.py``).

A :class:`ShardedStack` is the port's counterpart of a JAX array laid out
as ``NamedSharding(mesh, P("shards", None, None))``: a ``[S, R, W]`` stack
cut along its shard axis into contiguous slices, one per mesh device, the
axis padded with zero shards to a multiple of the mesh's size. On a mesh
that spans processes (:func:`mesh.init_multihost`) it holds only this
process's slices, and the global shard order is process-major.

JAX's ``shard_map`` bodies call the same Pallas kernels on each device;
here every kernel wrapper of ``ops/kernels.py`` and ``ops/bsi.py`` that
reads a stack takes a ``ShardedStack`` too, and answers it through
:func:`per_slice` (one launch of the same hand kernel per slice, on that
device's current stream, through the wrappers' launch funnel) and one
reduce: :func:`total` sums counts in int64, :func:`cat` joins per-shard
rows or words in the stack's shard order. On a spanning mesh the totals
are then summed across the processes with ``torch.distributed.all_reduce``.
JAX carries uint32 (hi, lo) pairs through its psum because a TPU psum is
int32; torch's collectives take int64, so the port sums int64 and needs
no carry. Per-shard outputs of a spanning stack are not this process's to
read, so :func:`cat` declines them, as JAX declines its bitmap programs
there. No path gathers a sharded stack onto one device to run it there.

A ``ShardedField`` holds one field view's fragments as such a stack, with
JAX's query methods (``count_pair``, ``count_pairs``, ``topn``,
``apply_updates``).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from pilosa_tpu_torch.core.view import VIEW_STANDARD
from pilosa_tpu_torch.ops import bitops, bsi, kernels
from pilosa_tpu_torch.parallel import mesh as mesh_mod


class ShardedStack:
    """A tensor cut along its shard axis (``axis``: 0 for a stack, 1 for
    ``[C, S, W]`` prefix masks) into ``slices``, each on its mesh device;
    ``bounds`` holds each local slice's ``(start, stop)`` on the logical
    (padded, global) shard axis and ``shape`` the logical shape. It reads
    like the tensor it stands for where the executor reads a stack:
    ``shape``, ``dtype``, ``device`` (the first slice's), ``numel()``,
    ``element_size()``, and ``bits[:, ...]`` (the shard axis whole), which
    indexes every slice alike."""

    def __init__(self, slices, bounds, shape, mesh: mesh_mod.ServingMesh, axis: int = 0):
        self.slices = tuple(slices)
        self.bounds = tuple(bounds)
        self.shape = torch.Size(shape)
        self.mesh = mesh
        self.axis = axis
        if not self.slices:
            raise ValueError("a sharded stack of no slices")

    @property
    def spans(self) -> bool:
        return mesh_mod.mesh_spans_processes(self.mesh)

    @property
    def dtype(self) -> torch.dtype:
        return self.slices[0].dtype

    @property
    def device(self) -> torch.device:
        return self.slices[0].device

    def dim(self) -> int:
        return len(self.shape)

    def numel(self) -> int:
        return math.prod(self.shape)

    def element_size(self) -> int:
        return self.slices[0].element_size()

    def __getitem__(self, key):
        if not isinstance(key, tuple):
            key = (key,)
        if self.axis != 0 or not key or key[0] != slice(None):
            raise IndexError(
                "a sharded stack is indexed with its shard axis whole (bits[:, ...])"
            )
        return self.map(lambda t: t[key])

    def map(self, fn) -> "ShardedStack":
        """``fn`` of every slice, as a stack of the same bounds (``fn`` keeps
        the shard axis)."""
        parts = [fn(t) for t in self.slices]
        shape = list(parts[0].shape)
        shape[self.axis] = self.shape[self.axis]
        return ShardedStack(parts, self.bounds, shape, self.mesh, self.axis)

    def cpu(self) -> torch.Tensor:
        """The whole stack on the host (a host pull, as JAX's
        ``np.asarray`` of a sharded array); declined on a spanning mesh."""
        return cat(self, [t.cpu() for t in self.slices], self.axis, to=torch.device("cpu"))

    def __repr__(self) -> str:
        return (f"ShardedStack(shape={tuple(self.shape)}, axis={self.axis}, "
                f"bounds={self.bounds}, devices={[str(t.device) for t in self.slices]})")


def is_sharded(x) -> bool:
    return isinstance(x, ShardedStack)


def _device_ctx(device: torch.device):
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _part(x, start: int, stop: int, axis: int, device: torch.device) -> torch.Tensor:
    """Positions ``[start, stop)`` of ``x`` (a tensor or uint32 numpy words)
    along ``axis`` on ``device``, zero past ``x``'s end (the padded shards)."""
    n = x.shape[axis]
    have = max(0, min(stop, n) - start)
    if isinstance(x, np.ndarray):
        idx = [slice(None)] * x.ndim
        idx[axis] = slice(start, start + have)
        block = x[tuple(idx)]
        if have < stop - start:
            pad = [(0, 0)] * x.ndim
            pad[axis] = (0, stop - start - have)
            block = np.pad(block, pad)
        return bitops.to_device(block, device)
    block = x.narrow(axis, min(start, n), have).to(device)
    if have < stop - start:
        shape = list(block.shape)
        shape[axis] = stop - start - have
        block = torch.cat([block, torch.zeros(shape, dtype=block.dtype, device=device)], axis)
    return block.contiguous()


def _layout(mesh: mesh_mod.ServingMesh, n_local: int):
    """``(positions, chunk, padded local length)`` of a block of
    ``n_local`` shards over this process's mesh devices."""
    pos = mesh.local_positions()
    if not pos:
        raise ValueError(f"no device of mesh {mesh.devices} belongs to this process")
    chunk = -(-max(n_local, 1) // len(pos))
    return pos, chunk, chunk * len(pos)


def shard(x, mesh: mesh_mod.ServingMesh, axis: int = 0) -> ShardedStack:
    """A stack (a tensor, or uint32 numpy words) laid out over a local
    ``mesh``: cut along ``axis`` into contiguous slices, one per device,
    the axis padded with zero shards to a multiple of the mesh's size. A
    slice on the tensor's own device is a view of it where no padding
    falls in it."""
    if mesh.spans:
        raise ValueError("shard: a spanning mesh takes each process's own block (shard_local)")
    pos, chunk, padded = _layout(mesh, x.shape[axis])
    shape = list(x.shape)
    shape[axis] = padded
    bounds = [(k * chunk, (k + 1) * chunk) for k in range(len(pos))]
    slices = [_part(x, a, b, axis, mesh.devices[p]) for (a, b), p in zip(bounds, pos)]
    return ShardedStack(slices, bounds, shape, mesh, axis)


def shard_local(x, mesh: mesh_mod.ServingMesh, axis: int = 0) -> ShardedStack:
    """A global stack over a mesh that spans processes, from this
    process's own block ``x`` (the counterpart of JAX's
    ``host_local_array_to_global_array``): every process gives a block of
    the same length, cut over its own devices; the global shard axis is
    the processes' blocks in rank order (process-major)."""
    pos, chunk, _ = _layout(mesh, x.shape[axis])
    shape = list(x.shape)
    shape[axis] = chunk * mesh.size
    bounds = [(p * chunk, (p + 1) * chunk) for p in pos]
    first = pos[0] * chunk
    slices = [_part(x, a - first, b - first, axis, mesh.devices[p])
              for (a, b), p in zip(bounds, pos)]
    return ShardedStack(slices, bounds, shape, mesh, axis)


def split(stack: ShardedStack, x, axis: int = 0) -> list:
    """``x`` cut at ``stack``'s bounds along ``axis``, each part on its
    slice's device: a stack of the same bounds gives its slices; a tensor
    or numpy array over the logical shard axis (the padded tail may be
    missing) gives copies or views; None gives Nones."""
    if x is None:
        return [None] * len(stack.slices)
    if is_sharded(x):
        if x.bounds != stack.bounds or x.mesh != stack.mesh:
            raise ValueError(f"sharded operands of different layouts: {x!r} and {stack!r}")
        return list(x.slices)
    return [_part(x, a, b, axis, t.device) for (a, b), t in zip(stack.bounds, stack.slices)]


def per_slice(stack: ShardedStack, fn, *aligned, axis: int = 0) -> list:
    """``fn(slice, *parts)`` for every local slice, on the slice's device
    (its current stream is the one the launch goes on), with each of
    ``aligned`` cut at the same bounds (:func:`split`)."""
    parts = [split(stack, a, axis) for a in aligned]
    out = []
    for k, t in enumerate(stack.slices):
        with _device_ctx(t.device):
            out.append(fn(t, *(p[k] for p in parts)))
    return out


def cat(stack: ShardedStack, outs, dim: int, to: torch.device | None = None) -> torch.Tensor:
    """Per-slice per-shard outputs joined along ``dim`` in the stack's
    shard order, on the first slice's device (or ``to``). Declined on a
    spanning mesh, where the other processes' shards are not here."""
    if stack.spans:
        raise ValueError(
            "per-shard outputs of a process-spanning stack are not this process's "
            "to read; use a total"
        )
    dev = stack.device if to is None else to
    return torch.cat([o.to(dev) for o in outs], dim)


def all_reduce(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over every process of the job (in place where the
    backend takes ``t``'s device; NCCL takes only CUDA tensors)."""
    dist = torch.distributed
    work = t
    if dist.get_backend() == "nccl" and t.device.type != "cuda":
        work = t.to(torch.device("cuda", torch.cuda.current_device()))
    dist.all_reduce(work, op=dist.ReduceOp.SUM)
    return work.to(t.device)


def total(stack: ShardedStack, outs) -> torch.Tensor:
    """Per-slice counts summed in int64 on the first slice's device, then
    across the processes when the mesh spans them."""
    dev = stack.device
    acc = None
    for o in outs:
        o = (torch.from_numpy(np.asarray(o)) if not isinstance(o, torch.Tensor) else o)
        o = o.to(dev, torch.int64)
        acc = o if acc is None else acc + o
    return all_reduce(acc) if stack.spans else acc


def total_host(stack: ShardedStack, outs) -> np.ndarray:
    """:func:`total` of host arrays, as ``int64`` numpy."""
    acc = np.zeros_like(np.asarray(outs[0]), dtype=np.int64)
    for o in outs:
        acc += np.asarray(o, dtype=np.int64)
    if stack.spans:
        acc = all_reduce(torch.from_numpy(acc)).numpy()
    return acc


def same_layout(name: str, *xs) -> None:
    """Raise unless ``xs`` are all sharded stacks of one layout or all
    plain tensors (a mix would run a slice against a whole stack)."""
    sh = [x for x in xs if is_sharded(x)]
    if not sh:
        return
    if len(sh) != len(xs):
        raise ValueError(f"{name}: sharded and whole stacks mixed")
    for x in sh[1:]:
        if x.bounds != sh[0].bounds or x.mesh != sh[0].mesh or x.axis != sh[0].axis:
            raise ValueError(f"{name}: sharded stacks of different layouts")


# ---------------------------------------------------------------------------
# The sharded-field facade (JAX's module functions and ShardedField)
# ---------------------------------------------------------------------------


def pair_op_count(bits, ra: int, rb: int, *, op: str) -> torch.Tensor:
    """Per-shard counts of ``op(row ra, row rb)``: ``int32[S]`` (a total
    ``int64[1]`` on a spanning mesh)."""
    out = kernels.pair_count_batched(bits, [ra], [rb], op=op)
    return out[0] if out.dim() == 2 else out


def pair_counts_batched(bits, ras, rbs, *, op: str = "intersect") -> torch.Tensor:
    """A batch of ``Count(op(Row, Row))``: ``int32[B, S]`` per-shard
    partials (callers sum in int64), or ``int64[B]`` totals on a spanning
    mesh (:func:`kernels.pair_count_batched`)."""
    return kernels.pair_count_batched(bits, ras, rbs, op=op)


def apply_updates(bits, set_mask, clear_mask):
    """One write step in place: OR in ``set_mask``, clear ``clear_mask``
    (masks of the stack's shape, whole or sharded alike). Returns
    ``bits``."""
    if is_sharded(bits):
        per_slice(bits, lambda t, s, c: t.bitwise_or_(s).bitwise_and_(~c), set_mask, clear_mask)
        return bits
    bits.bitwise_or_(set_mask.to(bits.device)).bitwise_and_(~clear_mask.to(bits.device))
    return bits


def bsi_sum_planes(planes, exists, sign, filter_words, *, depth: int):
    """``(pos[depth], neg[depth], count)`` int64 plane popcounts of a Sum
    over a (sharded) BSI stack under ``exists & filter_words``, one
    ``bsi_sum`` launch a slice, combined with place values by the caller."""
    def one(p, e, s, f):
        return bsi.bsi_sum(p[:, :depth], e, s, f)[:, 0].to(torch.int64).sum(dim=0)

    if is_sharded(planes):
        acc = total(planes, per_slice(planes, one, exists, sign, filter_words))
    else:
        acc = one(planes, exists, sign, filter_words)
    return acc[:depth, 0], acc[:depth, 1], acc[depth].sum()


class ShardedField:
    """A field view's fragments stacked ``[S, R, W]`` and laid over a mesh
    (on one device when ``mesh`` is None)."""

    def __init__(self, bits, row_ids, shard_ids, mesh: mesh_mod.ServingMesh | None = None,
                 *, device=None):
        self.row_ids = list(row_ids)
        self.shard_ids = list(shard_ids)
        self._slot_of = {r: i for i, r in enumerate(self.row_ids)}
        self.mesh = mesh
        if mesh is not None:
            self.bits = shard(bits, mesh)
        elif isinstance(bits, torch.Tensor):
            self.bits = bits if device is None else bits.to(device)
        else:
            dev = device if device is not None else mesh_mod.local_devices()[0]
            self.bits = bitops.to_device(bits, dev)

    @classmethod
    def from_field(cls, field, mesh: mesh_mod.ServingMesh | None = None,
                   view: str = VIEW_STANDARD, pad_shards_to: int | None = None,
                   pad_rows_to: int | None = None, *, device=None) -> "ShardedField":
        """Stack a field's fragments into ``[S, R, W]``: rows are the union
        of row ids across shards, the shard axis padded to a multiple of
        the mesh's size (and to ``pad_shards_to``), the rows to
        ``pad_rows_to``."""
        v = field.view(view)
        frags = dict(v.fragments) if v is not None else {}
        shard_ids = sorted(frags)
        row_ids = sorted({r for f in frags.values() for r in f.row_ids()})
        S, R = max(len(shard_ids), 1), max(len(row_ids), 1)
        if mesh is not None:
            S = -(-S // mesh.size) * mesh.size
        S = max(S, pad_shards_to or 0)
        R = max(R, pad_rows_to or 0)
        bits = np.zeros((S, R, field.n_words), dtype=np.uint32)
        slot = {r: i for i, r in enumerate(row_ids)}
        for si, s in enumerate(shard_ids):
            ids, matrix = frags[s].rows_matrix_host()
            if ids:
                bits[si, [slot[r] for r in ids]] = matrix
        return cls(bits, row_ids, shard_ids, mesh, device=device)

    def slot(self, row_id: int) -> int:
        s = self._slot_of.get(row_id)
        if s is None:
            raise KeyError(f"row {row_id} not present")
        return s

    def count_pair(self, row_a: int, row_b: int, op: str = "intersect") -> int:
        return self.count_pairs([(row_a, row_b)], op=op)[0]

    def count_pairs(self, pairs, op: str = "intersect") -> list[int]:
        """A batch of ``Count(op(Row(a), Row(b)))`` in one launch a slice."""
        out = pair_counts_batched(
            self.bits, [self.slot(a) for a, _ in pairs], [self.slot(b) for _, b in pairs], op=op,
        ).to(torch.int64)
        if out.dim() > 1:  # local: [B, S] partials
            out = out.sum(dim=1)
        return [int(c) for c in out.tolist()]

    def topn(self, n: int) -> list[tuple[int, int]]:
        n = min(n, len(self.row_ids)) or 1
        counts, slots = kernels.topn_counts(self.bits, n)
        return [
            (self.row_ids[s], c)
            for c, s in zip(counts.tolist(), slots.tolist())
            if c > 0 and s < len(self.row_ids)
        ]

    def apply_updates(self, set_mask, clear_mask) -> None:
        """The write step, in place (masks of the stack's layout)."""
        self.bits = apply_updates(self.bits, set_mask, clear_mask)
