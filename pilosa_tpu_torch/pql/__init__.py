"""PQL — the Pilosa Query Language (reference: pql/ directory).

A pure host-side layer: grammar-compatible parser producing the same
Call/Condition AST shape as the reference (pql/ast.go:27,263,482), consumed
by the executor.
"""

from pilosa_tpu_torch.pql.ast import Call, Condition, Query
from pilosa_tpu_torch.pql.parser import ParseError, parse

__all__ = ["Call", "Condition", "Query", "ParseError", "parse"]
