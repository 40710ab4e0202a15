"""A plain parser of the PQL the benchmark's traffic sends, for the
reference only (it imports nothing of the program).

The subset: calls with call children, a bare field name (``Rows(f)``),
and keyword arguments, where a
keyword's value is an integer, a name or a call (``Row(f=3)``,
``Sum(..., field=v)``, ``GroupBy(..., filter=Row(f=1))``), and the
conditions of an int field: ``Row(v < 25)`` with ``<``, ``<=``, ``>``,
``>=``, ``==``, ``!=``, and ``Row(v >< [1, 3])``, both bounds included.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

_TOKEN = re.compile(r"\s*(?:(-?\d+)|([A-Za-z_][A-Za-z0-9_-]*)|(><|<=|>=|==|!=|[()\[\],=<>]))")


@dataclass
class Cond:
    """An int field's condition: ``op`` and its integer bound(s)."""

    op: str
    value: int | tuple[int, int]


@dataclass
class Call:
    name: str
    children: list["Call"] = field(default_factory=list)
    args: dict = field(default_factory=dict)


class PQLError(ValueError):
    pass


def _tokens(text: str) -> list[tuple[str, str]]:
    out, pos = [], 0
    while pos < len(text):
        if text[pos:].strip() == "":
            break
        m = _TOKEN.match(text, pos)
        if m is None:
            raise PQLError(f"unexpected text at {pos}: {text[pos:pos + 20]!r}")
        num, name, punct = m.groups()
        out.append(("int", num) if num is not None else ("name", name) if name is not None
                   else ("op", punct))
        pos = m.end()
    return out


class _Parser:
    def __init__(self, text: str):
        self.toks = _tokens(text)
        self.i = 0

    def peek(self, k: int = 0):
        j = self.i + k
        return self.toks[j] if j < len(self.toks) else (None, None)

    def take(self, kind: str, value: str | None = None) -> str:
        k, v = self.peek()
        if k != kind or (value is not None and v != value):
            raise PQLError(f"expected {value or kind}, got {v!r}")
        self.i += 1
        return v

    def query(self) -> list[Call]:
        calls = []
        while self.peek()[0] is not None:
            calls.append(self.call())
        return calls

    def call(self) -> Call:
        c = Call(self.take("name"))
        self.take("op", "(")
        while self.peek() != ("op", ")"):
            self.arg(c)
            if self.peek() == ("op", ","):
                self.i += 1
        self.take("op", ")")
        return c

    def int_(self) -> int:
        return int(self.take("int"))

    def arg(self, c: Call) -> None:
        if self.peek()[0] == "name" and self.peek(1) == ("op", "("):
            c.children.append(self.call())
            return
        key = self.take("name")
        if self.peek() in (("op", ","), ("op", ")")):
            c.args["_field"] = key  # Rows(f)
            return
        op = self.take("op")
        if op == "=":
            if self.peek()[0] == "int":
                c.args[key] = self.int_()
            elif self.peek(1) == ("op", "("):
                c.args[key] = self.call()
            else:
                c.args[key] = self.take("name")
        elif op == "><":
            self.take("op", "[")
            lo = self.int_()
            self.take("op", ",")
            hi = self.int_()
            self.take("op", "]")
            c.args[key] = Cond("><", (lo, hi))
        elif op in ("<", "<=", ">", ">=", "==", "!="):
            c.args[key] = Cond(op, self.int_())
        else:
            raise PQLError(f"unexpected {op!r} after {key!r}")


def parse(text: str) -> list[Call]:
    """The calls of one PQL body, in order."""
    return _Parser(text).query()
