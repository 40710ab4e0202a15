"""Row words from per-record field values, on the device: the benchmark's
own packing of a configuration's records into the fragments the node
loads (``convert.load_arrays``'s ``(row_ids, uint32[R, W])`` pairs).

A set field's row r holds the records whose value is r. An int field is
stored as the node stores it: rows 0 (exists), 1 (sign), then bit k of
``|value - base|`` in row 2 + k, with ``base`` and the depth from the
field's ``min`` and ``max``. The existence field's row 0 holds every
record.
"""

from __future__ import annotations

import torch

EXISTENCE = "_exists"
BSI_PREFIX = "bsig_"
STANDARD = "standard"


def field_rows(field: dict) -> list[int]:
    rows = field["rows"]
    return list(range(rows)) if isinstance(rows, int) else list(rows)


def int_layout(field: dict) -> tuple[int, int]:
    """``(base, depth)`` of an int field, as the node derives them."""
    lo, hi = field["min"], field["max"]
    base = lo if lo > 0 else (hi if hi < 0 else 0)
    span = max(abs(lo - base), abs(hi - base))
    return base, span.bit_length()


def schema(cfg: dict) -> list[dict]:
    fields = []
    for f in cfg["fields"]:
        opts = {"type": f["type"]}
        if f["type"] == "int":
            opts.update(min=f["min"], max=f["max"])
        fields.append({"name": f["name"], "options": opts})
    return [{"name": cfg["index"], "options": {"trackExistence": bool(cfg.get("existence"))},
             "fields": fields}]


def layout(cfg: dict) -> list[tuple[str, str, list[int]]]:
    """``(field, view, row ids)`` of each fragment a shard holds, in the
    order :func:`shard_bits` stacks their rows."""
    out = []
    for f in cfg["fields"]:
        if f["type"] == "int":
            out.append((f["name"], BSI_PREFIX + f["name"], list(range(2 + int_layout(f)[1]))))
        else:
            out.append((f["name"], STANDARD, field_rows(f)))
    if cfg.get("existence"):
        out.append((EXISTENCE, STANDARD, [0]))
    return out


def shard_bits(cfg: dict, cols: dict, n: int, width: int) -> torch.Tensor:
    """bool ``[rows, width]``: every fragment's rows of one shard whose
    first ``n`` columns hold records."""
    dev = next(iter(cols.values())).device
    parts = []
    for f in cfg["fields"]:
        v = cols[f["name"]]
        if f["type"] == "int":
            base, depth = int_layout(f)
            stored = v - base
            mag = stored.abs()
            k = torch.arange(depth, device=dev)
            parts += [torch.ones_like(v, dtype=torch.bool)[None], (stored < 0)[None],
                      ((mag[None] >> k[:, None]) & 1).bool()]
        else:
            rows = torch.tensor(field_rows(f), device=dev)
            parts.append(v[None] == rows[:, None])
    if cfg.get("existence"):
        parts.append(torch.ones((1, n), dtype=torch.bool, device=dev))
    bits = torch.cat(parts)
    if n < width:
        bits = torch.nn.functional.pad(bits, (0, width - n))
    return bits


def pack_words(bits: torch.Tensor) -> torch.Tensor:
    """int32 ``[R, N / 32]`` of bool ``[R, N]``: column 32 w + b is bit b
    of word w."""
    R, N = bits.shape
    x = bits.view(R, N // 32, 32).to(torch.int64) << torch.arange(32, device=bits.device)
    w = x.sum(-1)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def shard_words(cfg: dict, cols: dict, n: int, width: int) -> torch.Tensor:
    """int32 ``[rows, width / 32]``: one shard's words, every fragment's
    rows in :func:`layout`'s order."""
    return pack_words(shard_bits(cfg, cols, n, width))
