"""taxi-1b's records, drawn on the device from the seed: each ride's cab
type, passenger count, pickup year, rounded distance and amount in
cents, each column by its law in the configuration's ``assumed``."""

from __future__ import annotations

import math

import torch


def _categorical(p, n, gen, dev) -> torch.Tensor:
    bounds = torch.tensor(p, dtype=torch.float64, device=dev).cumsum(0)[:-1]
    u = torch.rand(n, generator=gen, device=dev, dtype=torch.float64)
    return torch.searchsorted(bounds, u, right=True)


def _lognormal_rounded(law, n, gen, dev) -> torch.Tensor:
    z = torch.randn(n, generator=gen, device=dev, dtype=torch.float64)
    x = torch.exp(math.log(law["median"]) + law["sigma"] * z)
    return torch.clamp(torch.round(x), 0, law["top_row"]).to(torch.int64)


def raw_shard(cfg: dict, gen: torch.Generator, n: int, dev) -> dict:
    """``n`` rides: ``{column: int64[n]}``, the columns named as the
    fields they fill."""
    a = cfg["assumed"]
    out = {}
    for f in cfg["fields"]:
        law = a[f["name"]]
        if law["law"] == "categorical":
            idx = _categorical(law["p"], n, gen, dev)
            out[f["name"]] = torch.tensor(f["rows"], device=dev)[idx]
        else:
            out[f["name"]] = _lognormal_rounded(law, n, gen, dev)
    return out


def columns(cfg: dict, raw: dict) -> dict:
    """Each field's value per record: the raw columns as they are."""
    return raw
