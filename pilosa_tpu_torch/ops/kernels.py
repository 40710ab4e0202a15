"""Batched kernels of the serving path (counterpart of
``pilosa_tpu/ops/kernels.py``).

Three hand-written CUDA kernels (``ops/csrc``) replace the three Pallas
kernels that the JAX package runs on this path:

* the **row scan** ``out[s, r] = Σ_w popc(bits[s, r, w])`` — row totals
  for tanimoto TopN (:func:`row_counts_per_shard`, :func:`row_counts`);
* the **masked row scan** ``out[s, r] = Σ_w popc(bits[s, r, w] & filt[s, w])``
  — filtered TopN (:func:`masked_row_counts_per_shard`,
  :func:`masked_row_counts`);
* the **self-gram with a fused gather**
  ``G[i, j] = Σ_s Σ_w popc(bits[s, idx[i], w] & bits[s, idx[j], w])`` — a
  whole batch of ``Count(op(Row, Row))`` queries in one launch
  (:func:`gram_gather`, :func:`pair_gram`).

Each kernel wrapper checks device, dtype, shape and contiguity. Given a
tensor on the CPU it computes the kernel's plain PyTorch version (the
``*_plain`` function beside it); given a CUDA tensor it launches the
kernel or raises. The plain versions are the contract the kernels are
held to on the card. ``LAUNCHES`` counts kernel launches per wrapper.

Stacks are ``int32[S, R, W]``: bit-identical views of the host's
``uint32`` words.
"""

from __future__ import annotations

import numpy as np
import torch

from pilosa_tpu_torch.ops import bitops, cuda_build

_TORCH_OPS = {
    "intersect": lambda a, b: a & b,
    "union": lambda a, b: a | b,
    "difference": lambda a, b: a & ~b,
    "xor": lambda a, b: a ^ b,
}

# kernel name -> launches so far (one per kernel launch, nowhere else)
LAUNCHES = {"row_scan": 0, "masked_row_scan": 0, "gram": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_words(name: str, t, ndim: int) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t).__name__}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 words, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def _is_cpu(name: str, *ts: torch.Tensor) -> bool:
    """True for CPU tensors, False for CUDA tensors on one device; raises
    for mixed devices or any other device type."""
    dev = ts[0].device
    for t in ts[1:]:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    return False


def _launch(fn: str, *args) -> None:
    lib = cuda_build.load()
    cuda_build.check(lib, fn, getattr(lib, fn)(*args))


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
# Row scan
# ---------------------------------------------------------------------------


def row_counts_per_shard_plain(bits: torch.Tensor) -> torch.Tensor:
    """Plain version of the row scan: ``int32[S, R]``."""
    return bitops.count_rows(bits)


def row_counts_per_shard(bits: torch.Tensor) -> torch.Tensor:
    """``int32[S, R]`` per-shard row popcounts (exact per shard: a row of
    one shard holds at most 2^31 - 1 bits at every supported width)."""
    _check_words("row_counts_per_shard", bits, 3)
    if _is_cpu("row_counts_per_shard", bits):
        return row_counts_per_shard_plain(bits)
    S, R, W = bits.shape
    out = torch.empty((S, R), dtype=torch.int32, device=bits.device)
    if out.numel() == 0:
        return out
    if W == 0:
        return out.zero_()
    _launch(
        "pilosa_row_scan", bits.data_ptr(), out.data_ptr(), S, R, W,
        bits.device.index, _stream(bits.device),
    )
    LAUNCHES["row_scan"] += 1
    return out


def _int32_safe(bits: torch.Tensor) -> bool:
    """Cross-shard per-row totals fit int32 when S * shard_bits < 2^31."""
    S, _, W = bits.shape
    return S * W * 32 < 2**31


def row_counts(bits: torch.Tensor) -> torch.Tensor:
    """Per-row popcounts over all shards, on the stack's device:
    ``int32[R]`` when totals fit int32, else ``int64[R]``."""
    per_shard = row_counts_per_shard(bits)
    dtype = torch.int32 if _int32_safe(bits) else torch.int64
    return per_shard.sum(dim=0, dtype=dtype)


# ---------------------------------------------------------------------------
# Masked row scan
# ---------------------------------------------------------------------------


def masked_row_counts_per_shard_plain(
    bits: torch.Tensor, filt: torch.Tensor
) -> torch.Tensor:
    """Plain version of the masked row scan: ``int32[S, R]``."""
    return bitops.count_rows(bits & filt[:, None, :])


def masked_row_counts_per_shard(
    bits: torch.Tensor, filt: torch.Tensor
) -> torch.Tensor:
    """``int32[S, R]`` per-shard popcounts of every row ANDed with the
    shard's filter row ``filt[s]`` (``int32[S, W]``)."""
    _check_words("masked_row_counts_per_shard", bits, 3)
    _check_words("masked_row_counts_per_shard", filt, 2)
    S, R, W = bits.shape
    if tuple(filt.shape) != (S, W):
        raise ValueError(
            f"masked_row_counts_per_shard: filter shape {tuple(filt.shape)} "
            f"!= {(S, W)}"
        )
    if _is_cpu("masked_row_counts_per_shard", bits, filt):
        return masked_row_counts_per_shard_plain(bits, filt)
    out = torch.empty((S, R), dtype=torch.int32, device=bits.device)
    if out.numel() == 0:
        return out
    if W == 0:
        return out.zero_()
    _launch(
        "pilosa_masked_row_scan", bits.data_ptr(), filt.data_ptr(),
        out.data_ptr(), S, R, W, bits.device.index, _stream(bits.device),
    )
    LAUNCHES["masked_row_scan"] += 1
    return out


def masked_row_counts(bits: torch.Tensor, filt: torch.Tensor) -> np.ndarray:
    """``int64[R]`` numpy: per-row popcount of (row & filter) summed over
    shards in int64."""
    per_shard = masked_row_counts_per_shard(bits, filt)
    return per_shard.sum(dim=0, dtype=torch.int64).cpu().numpy()


# ---------------------------------------------------------------------------
# Self-gram with a fused gather
# ---------------------------------------------------------------------------

# Past this many distinct rows the gram itself gets big (U^2) and its
# O(U^2) work outgrows the O(B) scan — callers use pair_count_batched.
GRAM_MAX_ROWS = 4096

# Largest pair total an int32 gram accumulator may reach (tests shrink it
# to exercise the chunked path on small shapes).
_GRAM_ACC_LIMIT = 2**31 - 1

# bytes of float64 0/1 operands the plain gram unpacks per step
_PLAIN_GRAM_UNPACK_BYTES = 256 << 20

_SHIFTS32 = torch.arange(32, dtype=torch.int32)


def _gram_int32_safe(s: int, w: int) -> bool:
    """A pair's total fits int32 while S * W * 32 <= the limit."""
    return s * w * 32 <= _GRAM_ACC_LIMIT


def unpack_bits(words: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``int32[..., W]`` -> ``dtype[..., W*32]`` 0/1, little-endian bit
    order (bit b of word w is column 32*w + b)."""
    shifts = _SHIFTS32.to(words.device)
    bits = (words.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(*words.shape[:-1], words.shape[-1] * 32).to(dtype)


def _idx_array(idx, R: int) -> np.ndarray:
    arr = np.asarray(idx, dtype=np.int64).reshape(-1)
    if arr.size and (arr.min() < 0 or arr.max() >= R):
        raise ValueError(f"gram_gather: row index out of range [0, {R})")
    return arr.astype(np.int32)


def gram_gather_plain(bits: torch.Tensor, idx) -> torch.Tensor:
    """Plain version of the gram: ``int32[U, U]``. Unpacks word blocks of
    the gathered rows to 0/1 float64 and multiplies; float64 sums are exact
    below 2^53, far above the int32 totals the caller allows."""
    S, R, W = bits.shape
    sel = torch.from_numpy(_idx_array(idx, R).astype(np.int64)).to(bits.device)
    U = sel.numel()
    acc = torch.zeros((U, U), dtype=torch.float64, device=bits.device)
    if U == 0 or S == 0 or W == 0:
        return acc.to(torch.int32)
    wb = max(1, min(W, _PLAIN_GRAM_UNPACK_BYTES // (U * 32 * 8)))
    for s in range(S):
        rows = bits[s].index_select(0, sel)
        for w0 in range(0, W, wb):
            x = unpack_bits(rows[:, w0 : w0 + wb], torch.float64)
            acc += x @ x.T
    return acc.to(torch.int32)


def gram_gather(bits: torch.Tensor, idx) -> torch.Tensor:
    """``int32[U, U]`` gram over the stack rows named by ``idx`` (host
    ints in ``[0, R)``), read in place: no gathered copy is made. The
    caller keeps each pair's total within int32 (:func:`pair_gram`)."""
    _check_words("gram_gather", bits, 3)
    S, R, W = bits.shape
    if not _gram_int32_safe(S, W):
        raise ValueError(
            f"gram_gather: S*W*32 = {S * W * 32} exceeds the int32 "
            "accumulator; chunk the shard axis (pair_gram does)"
        )
    if _is_cpu("gram_gather", bits):
        return gram_gather_plain(bits, idx)
    host_idx = _idx_array(idx, R)
    U = host_idx.size
    out = torch.zeros((U, U), dtype=torch.int32, device=bits.device)
    if U == 0 or S == 0 or W == 0:
        return out
    dev_idx = torch.from_numpy(host_idx).to(bits.device)
    _launch(
        "pilosa_gram_gather", bits.data_ptr(), dev_idx.data_ptr(),
        out.data_ptr(), S, R, W, U, bits.device.index, _stream(bits.device),
    )
    LAUNCHES["gram"] += 1
    return out


def pair_gram(bits: torch.Tensor, row_idx) -> np.ndarray | None:
    """``int64 numpy [U, U]`` intersection counts between every pair of
    the rows named by ``row_idx``, summed over all shards — the one-launch
    answer to a batch of pair-count queries. None when ``row_idx`` is too
    wide for the gram path (> GRAM_MAX_ROWS). Shard chunks keep each
    launch's totals int32-exact; chunks are summed in int64."""
    S, R, W = bits.shape
    U = len(row_idx)
    if U == 0 or U > GRAM_MAX_ROWS:
        return None
    idx = np.asarray(row_idx, dtype=np.int32)
    if _gram_int32_safe(S, W):
        return gram_gather(bits, idx).cpu().numpy().astype(np.int64)
    chunk = max(1, _GRAM_ACC_LIMIT // (W * 32))
    total = np.zeros((U, U), np.int64)
    for c0 in range(0, S, chunk):
        total += gram_gather(bits[c0 : c0 + chunk], idx).cpu().numpy()
    return total


def pair_counts_from_gram(
    gram: np.ndarray, pa: np.ndarray, pb: np.ndarray, op: str
) -> np.ndarray:
    """Evaluate a batch of pair-op counts from gram entries.  ``pa/pb``
    index into the gram's row-subset coordinates."""
    g = gram[pa, pb]
    if op == "intersect":
        return g
    da = gram[pa, pa]
    if op == "difference":
        return da - g
    db = gram[pb, pb]
    if op == "union":
        return da + db - g
    if op == "xor":
        return da + db - 2 * g
    raise ValueError(f"unknown pair op: {op}")


# ---------------------------------------------------------------------------
# Batched pair count (plain torch ops; the JAX package runs it in XLA)
# ---------------------------------------------------------------------------

# bytes of gathered [S, b, W] operands per step
_PAIR_BATCH_BYTES = 256 << 20


def pair_count_batched(
    bits: torch.Tensor, ras, rbs, *, op: str = "intersect"
) -> torch.Tensor:
    """``int32[B, S]`` per-shard partials of ``popc(op(row ras[i], row
    rbs[i]))`` — the answer when a batch names more than GRAM_MAX_ROWS
    distinct rows. Callers sum over shards in int64."""
    _check_words("pair_count_batched", bits, 3)
    fn = _TORCH_OPS.get(op)
    if fn is None:
        raise ValueError(f"unknown pair op: {op}")
    S, R, W = bits.shape
    ra = torch.as_tensor(np.asarray(ras, np.int64)).to(bits.device)
    rb = torch.as_tensor(np.asarray(rbs, np.int64)).to(bits.device)
    B = ra.numel()
    out = torch.empty((B, S), dtype=torch.int32, device=bits.device)
    step = max(1, _PAIR_BATCH_BYTES // max(1, 2 * S * W * 4))
    for b0 in range(0, B, step):
        b1 = min(B, b0 + step)
        words = fn(bits[:, ra[b0:b1]], bits[:, rb[b0:b1]])  # [S, b, W]
        out[b0:b1] = bitops.count_rows(words).T
    return out
