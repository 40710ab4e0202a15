"""taxi-1b's plain reference: the rides' joint histogram over cab type,
passenger count, pickup year and rounded distance (2 x 10 x 7 x 64
cells), with the rides and the sum of their amounts in each cell.

It reads only the raw rides (``raw_shard``'s columns) and the
configuration's row lists."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import CellTable

DIMS = ("cab_type", "passenger_count", "pickup_year", "dist_miles")
SUMMED = "total_amount"


def _span(field: dict) -> tuple[int, int]:
    rows = field["rows"]
    rows = list(range(rows)) if isinstance(rows, int) else rows
    return min(rows), max(rows) - min(rows) + 1


def cell_table(cfg: dict, raws, dev) -> CellTable:
    spans = {f["name"]: _span(f) for f in cfg["fields"] if f["name"] in DIMS}
    strides, c = {}, 1
    for d in reversed(DIMS):
        strides[d] = c
        c *= spans[d][1]
    count = torch.zeros(c, dtype=torch.int64, device=dev)
    total = torch.zeros(c, dtype=torch.int64, device=dev)
    for raw in raws:
        key = sum((raw[d] - spans[d][0]) * strides[d] for d in DIMS)
        count += torch.bincount(key, minlength=c)
        total.index_add_(0, key, raw[SUMMED])
    cell = np.arange(c)
    values = {d: (cell // strides[d]) % spans[d][1] + spans[d][0] for d in DIMS}
    return CellTable(count=count.cpu().numpy(), values=values,
                     sums={SUMMED: total.cpu().numpy()})
