"""The plain reference: PQL answered from a joint histogram of the raw
records, in NumPy. It imports nothing of the program and reads none of
the words the program was given.

A configuration's reference module (``configs/<name>.ref.py``) reduces
the generated raw records to a :class:`CellTable`: one cell per distinct
combination of the columns the traffic can name, with the records it
holds, each field's value there, and the sum of each int field the
traffic sums. Every supported call is then a mask over cells:

* ``Row(f=k)``, ``Row(v < x)``, ``Row(v >< [a, b])``; ``Intersect``,
  ``Union``, ``Difference``, ``Xor`` of them;
* ``Count(tree)``, the records under the mask;
* ``Sum(tree, field=v)``, ``[sum, records]`` under the mask;
* ``GroupBy(Rows(f), ..., filter=tree)``, ``[fields, [[row ids...,
  records], ...]]`` in row order, groups of no record left out.

Answers are the canonical forms :func:`canonical` makes of the node's
JSON, so the two compare with ``==``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from portbench.pql import Call, Cond, parse


@dataclass
class CellTable:
    """``count[c]`` records in cell c; ``values[f][c]`` the value of field
    f there (a set field's row id, an int field's value); ``sums[v][c]``
    the sum of int field v over the cell's records, for a field whose
    value is not one per cell."""

    count: np.ndarray
    values: dict = field(default_factory=dict)
    sums: dict = field(default_factory=dict)


_OPS = {
    "<": np.less, "<=": np.less_equal, ">": np.greater, ">=": np.greater_equal,
    "==": np.equal, "!=": np.not_equal,
}


def canonical(result):
    """The comparable form of one call's JSON result: an int for a Count,
    ``[value, count]`` for a Sum, ``[fields, [[row ids..., count], ...]]``
    for a GroupBy; anything else as it came."""
    if isinstance(result, dict) and set(result) == {"value", "count"}:
        return [result["value"], result["count"]]
    if isinstance(result, list) and result and isinstance(result[0], dict) and "group" in result[0]:
        fields = [g["field"] for g in result[0]["group"]]
        return [fields, [[g["rowID"] for g in gc["group"]] + [gc["count"]] for gc in result]]
    return result


class Reference:
    """Answers of PQL bodies over one :class:`CellTable`, memoised by
    body."""

    def __init__(self, table: CellTable):
        self.t = table
        self._memo: dict[str, list] = {}

    def answer(self, body: str) -> list:
        out = self._memo.get(body)
        if out is None:
            out = self._memo[body] = [self._call(c) for c in parse(body)]
        return out

    def _mask(self, c: Call) -> np.ndarray:
        t = self.t
        if c.name == "Row":
            if len(c.args) != 1 or c.children:
                raise ValueError(f"Row takes one field: {c}")
            (f, v), = c.args.items()
            vals = t.values[f]
            if isinstance(v, Cond):
                if v.op == "><":
                    return (vals >= v.value[0]) & (vals <= v.value[1])
                return _OPS[v.op](vals, v.value)
            return vals == v
        masks = [self._mask(k) for k in c.children]
        if c.name == "Intersect":
            return np.logical_and.reduce(masks)
        if c.name == "Union":
            return np.logical_or.reduce(masks)
        if c.name == "Xor":
            return np.logical_xor.reduce(masks)
        if c.name == "Difference":
            out = masks[0].copy()
            for m in masks[1:]:
                out &= ~m
            return out
        raise ValueError(f"no reference for {c.name}")

    def _filter(self, c: Call) -> np.ndarray:
        if not c.children:
            return np.ones(self.t.count.shape, bool)
        if len(c.children) != 1:
            raise ValueError(f"{c.name} takes one filter")
        return self._mask(c.children[0])

    def _call(self, c: Call):
        t = self.t
        if c.name == "Count":
            return int(t.count[self._filter(c)].sum())
        if c.name == "Sum":
            m = self._filter(c)
            f = c.args["field"]
            total = t.sums[f][m].sum() if f in t.sums else (t.values[f][m] * t.count[m]).sum()
            return [int(total), int(t.count[m].sum())]
        if c.name == "GroupBy":
            m = t.count > 0
            if "filter" in c.args:
                m &= self._mask(c.args["filter"])
            fields = [k.args["_field"] for k in c.children]
            keys = np.stack([t.values[f][m] for f in fields], axis=1)
            uniq, inv = np.unique(keys, axis=0, return_inverse=True)
            counts = np.zeros(len(uniq), np.int64)
            np.add.at(counts, inv.reshape(-1), t.count[m])
            rows = [[int(x) for x in u] + [int(n)] for u, n in zip(uniq, counts) if n > 0]
            return [fields, rows] if rows else []  # an empty answer names no field
        raise ValueError(f"no reference for a bare {c.name}")
