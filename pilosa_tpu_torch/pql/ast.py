"""PQL abstract syntax tree.

Mirrors the reference AST surface (pql/ast.go): ``Query`` holds top-level
``Call``s; a ``Call`` has a name, keyword args (scalars, lists, strings,
``Condition``s, or nested ``Call``s) and child calls; a ``Condition``
carries a comparison operator and bound(s) for BSI range predicates
(pql/ast.go:482).

Positional tokens use the reference's reserved arg keys (pql/pql.peg:60-61):
``_col``, ``_row``, ``_field``, ``_timestamp``, ``_start``, ``_end``.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Any

# Ternary condition ops combine the two comparators of `a < field < b`
# (reference pql/pql.peg:34-37, token.go BTWN_* tokens).
TERNARY_OPS = {"<x<", "<=x<", "<x<=", "<=x<="}
BINARY_OPS = {"<", ">", "<=", ">=", "==", "!=", "><"}


@dataclass
class Condition:
    """A comparison predicate attached to a field arg
    (reference pql/ast.go:482 ``Condition``)."""

    op: str
    value: Any  # scalar, or [lo, hi] for '><' and ternary ops

    def __str__(self) -> str:
        if self.op in TERNARY_OPS:
            lo_op, hi_op = self.op.split("x")
            return f"{self.value[0]} {lo_op} x {hi_op} {self.value[1]}"
        return f"{self.op} {_format_value(self.value)}"

    def int_pair(self) -> tuple[int, int]:
        if not (isinstance(self.value, (list, tuple)) and len(self.value) == 2):
            raise ValueError(f"condition {self.op} requires a [lo, hi] pair")
        return int(self.value[0]), int(self.value[1])


@dataclass
class Call:
    """One PQL call (reference pql/ast.go:263)."""

    name: str
    args: dict[str, Any] = dc_field(default_factory=dict)
    children: list["Call"] = dc_field(default_factory=list)

    # -- typed arg accessors (reference pql/ast.go:272-392) ----------------

    def arg(self, key: str) -> tuple[Any, bool]:
        if key in self.args:
            return self.args[key], True
        return None, False

    def uint_arg(self, key: str) -> tuple[int | None, bool]:
        v = self.args.get(key)
        if v is None:
            return None, False
        if isinstance(v, bool) or not isinstance(v, int):
            raise TypeError(f"arg {key!r} must be an unsigned integer, got {v!r}")
        if v < 0:
            raise TypeError(f"arg {key!r} must be non-negative, got {v}")
        return v, True

    def int_arg(self, key: str) -> tuple[int | None, bool]:
        v = self.args.get(key)
        if v is None:
            return None, False
        if isinstance(v, bool) or not isinstance(v, int):
            raise TypeError(f"arg {key!r} must be an integer, got {v!r}")
        return v, True

    def string_arg(self, key: str) -> tuple[str | None, bool]:
        v = self.args.get(key)
        if v is None:
            return None, False
        if not isinstance(v, str):
            raise TypeError(f"arg {key!r} must be a string, got {v!r}")
        return v, True

    def bool_arg(self, key: str) -> tuple[bool | None, bool]:
        v = self.args.get(key)
        if v is None:
            return None, False
        if not isinstance(v, bool):
            raise TypeError(f"arg {key!r} must be a bool, got {v!r}")
        return v, True

    def uint_slice_arg(self, key: str) -> tuple[list[int] | None, bool]:
        v = self.args.get(key)
        if v is None:
            return None, False
        if not isinstance(v, list):
            raise TypeError(f"arg {key!r} must be a list, got {v!r}")
        out = []
        for x in v:
            if isinstance(x, bool) or not isinstance(x, int) or x < 0:
                raise TypeError(f"arg {key!r} must hold unsigned ints, got {x!r}")
            out.append(x)
        return out, True

    def call_arg(self, key: str) -> tuple["Call | None", bool]:
        v = self.args.get(key)
        if v is None:
            return None, False
        if not isinstance(v, Call):
            raise TypeError(f"arg {key!r} must be a call, got {v!r}")
        return v, True

    def condition_arg(self, key: str) -> tuple[Condition | None, bool]:
        v = self.args.get(key)
        if v is None:
            return None, False
        if not isinstance(v, Condition):
            return Condition("==", v), True
        return v, True

    def field_arg(self) -> str | None:
        """The single non-reserved arg key, for calls like Row(f=1)
        (reference pql/ast.go:360-392 FieldArg)."""
        for k in self.args:
            if not k.startswith("_") and k not in ("from", "to"):
                return k
        return None

    def has_conditions(self) -> bool:
        return any(isinstance(v, Condition) for v in self.args.values())

    def clone(self) -> "Call":
        def copy_value(v):
            if isinstance(v, Call):
                return v.clone()
            if isinstance(v, Condition):
                return Condition(
                    v.op, list(v.value) if isinstance(v.value, list) else v.value
                )
            if isinstance(v, list):
                return [copy_value(x) for x in v]
            return v

        return Call(
            self.name,
            {k: copy_value(v) for k, v in self.args.items()},
            [c.clone() for c in self.children],
        )

    def __str__(self) -> str:
        parts = [str(c) for c in self.children]
        for k in sorted(self.args):
            v = self.args[k]
            if isinstance(v, Condition):
                if v.op in TERNARY_OPS:
                    lo_op, hi_op = v.op.split("x")
                    parts.append(f"{v.value[0]} {lo_op} {k} {hi_op} {v.value[1]}")
                else:
                    parts.append(f"{k} {v.op} {_format_value(v.value)}")
            else:
                parts.append(f"{k}={_format_value(v)}")
        return f"{self.name}({', '.join(parts)})"

    __repr__ = __str__


@dataclass
class Query:
    """A parsed PQL query: one or more calls (reference pql/ast.go:27)."""

    calls: list[Call] = dc_field(default_factory=list)

    def write_calls(self) -> list[Call]:
        """Calls that mutate data (reference pql/ast.go WriteCallN)."""
        writes = {"Set", "Clear", "ClearRow", "Store", "SetRowAttrs", "SetColumnAttrs"}
        return [c for c in self.calls if c.name in writes]

    def __str__(self) -> str:
        return "".join(str(c) for c in self.calls)


def _format_value(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if v is None:
        return "null"
    if isinstance(v, str):
        return f'"{v}"'
    if isinstance(v, list):
        return "[" + ",".join(_format_value(x) for x in v) + "]"
    if isinstance(v, Call):
        return str(v)
    return str(v)
