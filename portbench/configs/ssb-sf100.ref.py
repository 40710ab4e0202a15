"""ssb-sf100's plain reference: the lineorders' joint histogram over
order date, discount and quantity (2406 x 11 x 50 cells), with the
lineorders and the sum of extended price times discount in each cell;
each cell's year, month and week from NumPy's calendar.

It reads only the raw lineorders (``raw_shard``'s columns) and works out
the date dimension and the price from the specification on its own."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import CellTable

DAYS = int((np.datetime64("1998-08-02") - np.datetime64("1992-01-01")).astype(int)) + 1


def cell_table(cfg: dict, raws, dev) -> CellTable:
    c = DAYS * 11 * 50
    count = torch.zeros(c, dtype=torch.int64, device=dev)
    revenue = torch.zeros(c, dtype=torch.int64, device=dev)
    for raw in raws:
        key = raw["orderdate"] * 550 + raw["discount"] * 50 + (raw["quantity"] - 1)
        pk = raw["partkey"]
        retail = 90000 + (pk // 10) % 20001 + 100 * (pk % 1000)
        count += torch.bincount(key, minlength=c)
        revenue.index_add_(0, key, raw["quantity"] * retail * raw["discount"])
    cell = np.arange(c)
    date = np.datetime64("1992-01-01") + cell // 550
    year = date.astype("datetime64[Y]").astype(int) + 1970
    month = date.astype("datetime64[M]").astype(int) % 12 + 1
    yday = (date - date.astype("datetime64[Y]")).astype(int)
    values = {
        "d_year": year,
        "d_yearmonthnum": year * 100 + month,
        "d_weeknuminyear": yday // 7 + 1,
        "lo_discount": (cell // 50) % 11,
        "lo_quantity": cell % 50 + 1,
    }
    return CellTable(count=count.cpu().numpy(), values=values,
                     sums={"lo_ext_disc": revenue.cpu().numpy()})
