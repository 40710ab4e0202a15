"""ssb-sf100's lineorders, drawn on the device from the seed by dbgen's
rules (the configuration's ``assumed``): the order date, discount,
quantity and part of each, and from them the fields the node holds."""

from __future__ import annotations

import datetime

import torch

FIRST_DAY = datetime.date(1992, 1, 1)
LAST_DAY = datetime.date(1998, 8, 2)
PARTS = 1_400_000


def raw_shard(cfg: dict, gen: torch.Generator, n: int, dev) -> dict:
    """``n`` lineorders: ``{orderdate (days since 1992-01-01), discount,
    quantity, partkey}``, int64 each."""
    days = (LAST_DAY - FIRST_DAY).days + 1

    def uniform(lo, hi):
        return torch.randint(lo, hi + 1, (n,), generator=gen, device=dev, dtype=torch.int64)

    return {"orderdate": uniform(0, days - 1), "discount": uniform(0, 10),
            "quantity": uniform(1, 50), "partkey": uniform(1, PARTS)}


def _calendar(dev) -> dict:
    year, month, week = [], [], []
    d = FIRST_DAY
    while d <= LAST_DAY:
        year.append(d.year)
        month.append(d.year * 100 + d.month)
        week.append((d.timetuple().tm_yday - 1) // 7 + 1)
        d += datetime.timedelta(days=1)
    return {k: torch.tensor(v, dtype=torch.int64, device=dev)
            for k, v in (("d_year", year), ("d_yearmonthnum", month), ("d_weeknuminyear", week))}


_CAL: dict = {}


def columns(cfg: dict, raw: dict) -> dict:
    """Each field's value per lineorder: the order date's year, month and
    week, the discount, the quantity and extended price times discount."""
    dev = raw["orderdate"].device
    cal = _CAL.get(str(dev))
    if cal is None:
        cal = _CAL[str(dev)] = _calendar(dev)
    pk = raw["partkey"]
    price = 90000 + torch.remainder(pk // 10, 20001) + 100 * torch.remainder(pk, 1000)
    out = {k: t[raw["orderdate"]] for k, t in cal.items()}
    out["lo_discount"] = raw["discount"]
    out["lo_quantity"] = raw["quantity"]
    out["lo_ext_disc"] = raw["quantity"] * price * raw["discount"]
    return out
