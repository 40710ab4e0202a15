"""PQL trees compiled to one launch over the field stacks (counterpart of
``pilosa_tpu/exec/astbatch.py``).

A tree of Row/Intersect/Union/Difference/Xor/Not, alone or under Count,
is matched into a signature (:func:`match_tree`, :func:`match_count`): the
operator tree plus the stack each leaf reads, never the row ids. Row ids
arrive as an ``int32`` slots input, so every Count of one shape over the
same stacks is answered by one launch of the tree kernel
(``ops/csrc/tree_eval.cu``, through :func:`kernels.tree_count`) over the
whole batch, and a bitmap tree by one launch of :func:`kernels.tree_words`.

* A signature compiles to a postfix program (:func:`program`), cached on
  the signature alone, as the JAX package caches its traced programs.
* An absent row rides through as slot ``-1``: a zero leaf, which is the
  empty-row semantics of every operator (Not and Difference included).
* ``Not`` is rewritten at match time into ``Difference(Row(_exists=0),
  child)``, the reference's executeNot against the existence field.
* A time-range ``Row(f=v, from=..., to=...)`` expands into a Union of
  per-view leaves over the minimal time-view cover (reference
  executor.go:1515-1531), each view its own stack, so windowed reads ride
  the same launches. A cover that is empty or longer than
  ``MAX_TIME_COVER`` views is declined, as in JAX. Unlike JAX, a windowed
  Row is signed alone too, under Count and as a bitmap (JAX reads a bare
  Row on the host): it is a Union like any other.
* A program evaluates the children of each node in the order that needs
  the fewest operand-stack entries (the Sethi-Ullman order), so a tree of
  L leaves needs at most floor(log2(L)) + 1 of them, within the kernel's
  ``TREE_MAX_DEPTH`` for any tree: trees of every width and nesting run on
  the card.

The BSI signing half (:func:`match_bsi`) signs the calls the executor's
batched BSI lane answers: range conditions, their Counts, Sum, Min, Max
and GroupBy filtered by a condition, each with its op class.

Over stacks laid on a serving mesh (``parallel/sharded.py``) both run
once a slice; on a mesh that spans processes a count batch is reduced to
its int64 totals across the processes (JAX's ``_compiled_spanning``), and
a bitmap tree is declined, as in JAX.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from pilosa_tpu_torch.core import timequantum
from pilosa_tpu_torch.core.field import FIELD_TYPE_INT
from pilosa_tpu_torch.core.view import VIEW_STANDARD
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.parallel import sharded
from pilosa_tpu_torch.pql.ast import Call, Condition

_OPS = {
    "Intersect": "intersect",
    "Union": "union",
    "Difference": "difference",
    "Xor": "xor",
}

# Largest time-view cover a range leaf may expand to: past it the per-view
# stack builds cost more than the per-fragment union on the host (a fine
# quantum over a wide window covers thousands of views).
MAX_TIME_COVER = 16

# The flight planner's graft node (exec/planner.py SHARED): a subtree
# already materialized as a row for the whole flight. It is a leaf of the
# flight's shared stack (the pair ``(SHARED, "")``, one slot per distinct
# row, keyed by the row's identity), which the executor uploads once for
# the flight, so consumers still combine it in the tree kernel.
SHARED = "__shared__"

# sig nodes: ("row", stack_ordinal) | (op, *child_sigs). Leaves refer to
# stacks by first-appearance ORDINAL; the actual (field, view) pairs ride
# alongside in ``pairs`` and join the executor's launch-group key.


def _stackable_field(idx, fname: str):
    """The field when it can serve stacked reads at all (an absent row is
    an all-zero leaf)."""
    if fname is None:
        return None
    field = idx.field(fname)
    if field is None or field.field_type == FIELD_TYPE_INT:
        return None
    return field


def _ordinal(pairs: list[tuple[str, str]], fname: str, vname: str) -> int:
    pair = (fname, vname)
    try:
        return pairs.index(pair)
    except ValueError:
        pairs.append(pair)
        return len(pairs) - 1


def _match(idx, call: Call, leaves: list, pairs: list):
    name = call.name
    if name == SHARED:
        leaves.append((SHARED, "", id(call._planner_row)))
        return ("row", _ordinal(pairs, SHARED, ""))
    if name == "Row":
        fname = call.field_arg()
        field = _stackable_field(idx, fname)
        if field is None or call.children:
            return None
        v = call.args.get(fname)
        if not isinstance(v, int) or isinstance(v, bool):
            return None
        if "from" in call.args or "to" in call.args:
            return _match_time_range(field, call, v, leaves, pairs)
        if set(call.args) != {fname}:
            return None
        if field.view(VIEW_STANDARD) is None:
            return None
        leaves.append((fname, VIEW_STANDARD, v))
        return ("row", _ordinal(pairs, fname, VIEW_STANDARD))
    if name == "Not":
        # executeNot: exists-row difference (requires track_existence)
        if len(call.children) != 1 or call.args or not idx.track_existence:
            return None
        ef = idx.existence_field()
        if ef is None or ef.view(VIEW_STANDARD) is None:
            return None
        leaves.append((ef.name, VIEW_STANDARD, 0))
        esig = ("row", _ordinal(pairs, ef.name, VIEW_STANDARD))
        child = _match(idx, call.children[0], leaves, pairs)
        if child is None:
            return None
        return ("difference", esig, child)
    op = _OPS.get(name)
    if op is not None:
        if not call.children or call.args:
            return None
        subs = []
        for c in call.children:
            s = _match(idx, c, leaves, pairs)
            if s is None:
                return None
            subs.append(s)
        return (op, *subs)
    return None


def _match_time_range(field, call: Call, row: int, leaves: list, pairs: list):
    """``("union", leaf per view)`` of a time-range Row over its view cover;
    None for another argument, a field without a quantum, an empty cover
    or one longer than MAX_TIME_COVER (JAX astbatch.py:128-149)."""
    fname = field.name
    if set(call.args) - {fname, "from", "to"}:
        return None
    try:
        cover = timequantum.view_cover(
            field, call.args.get("from"), call.args.get("to"), VIEW_STANDARD
        )
    except ValueError:
        return None
    if not cover or len(cover) > MAX_TIME_COVER:
        return None
    for vname in cover:
        leaves.append((fname, vname, row))
    return ("union", *[("row", _ordinal(pairs, fname, vn)) for vn in cover])


def is_time_range(call: Call) -> bool:
    """Whether ``call`` is a time-range Row."""
    return call.name == "Row" and ("from" in call.args or "to" in call.args)


def match_tree(
    idx,
    call: Call,
    leaves: list[tuple[str, str, int]],
    pairs: list[tuple[str, str]],
):
    """``sig`` for a batchable bitmap tree, appending its (field, view,
    row) leaves in traversal order and the distinct (field, view) stack
    pairs to ``pairs`` (the program's stack order); None when any node
    falls outside the compilable set."""
    return _match(idx, call, leaves, pairs)


def match_count(
    idx,
    call: Call,
    leaves: list[tuple[str, str, int]],
    pairs: list[tuple[str, str]],
):
    """sig for ``Count(tree)`` when the tree is compilable and not a bare
    plain Row (plain row counts are one fused count on the host tier; a
    windowed Row is a Union over its views)."""
    if call.name != "Count" or len(call.children) != 1 or call.args:
        return None
    child = call.children[0]
    if child.name == "Row" and not is_time_range(child):
        return None
    return match_tree(idx, child, leaves, pairs)


class Program(NamedTuple):
    """A signature's postfix program (``kernels.TREE_*`` opcodes; a leaf
    opcode is the leaf's index in traversal order), the stack ordinal of
    each leaf, and the operand-stack depth it needs."""

    code: np.ndarray
    leaf_stack: np.ndarray
    n_leaves: int
    depth: int


_FOLD = {
    "intersect": kernels.TREE_AND,
    "union": kernels.TREE_OR,
    "xor": kernels.TREE_XOR,
}


def _emit(sig, leaf_stack: list[int]) -> tuple[int, list[int]]:
    """``(need, code)`` of a subtree: its postfix code and the operand-stack
    entries that code needs. Leaves are numbered in traversal order as they
    are met; the children of a node are then evaluated in decreasing need
    (ties in their order), so that a node needs max(n1, n2 + 1) entries for
    the two largest needs of its children."""
    if sig[0] == "row":
        leaf_stack.append(sig[1])
        return 1, [len(leaf_stack) - 1]
    kids = [(*_emit(kid, leaf_stack), pos) for pos, kid in enumerate(sig[1:])]
    kids.sort(key=lambda k: -k[0])
    need, code, pos = kids[0]
    # Difference(a, b, c) == a & ~(b | c) (reference row.go Difference):
    # subtrahends met before the minuend are ORed, the minuend then takes
    # ~acc & a, and later subtrahends fold as acc & ~b
    minuend = pos == 0
    for k_need, k_code, pos in kids[1:]:
        need = max(need, k_need + 1)
        code += k_code
        if sig[0] != "difference":
            code.append(_FOLD[sig[0]])
        elif minuend:
            code.append(kernels.TREE_ANDNOT)
        elif pos == 0:
            code.append(kernels.TREE_NOTAND)
            minuend = True
        else:
            code.append(kernels.TREE_OR)
    return need, code


@lru_cache(maxsize=256)
def program(sig) -> Program:
    """The postfix :class:`Program` of a signature (a node of k children is
    k - 1 binary folds), evaluated in the order that needs the fewest
    operand-stack entries: at most floor(log2(leaves)) + 1."""
    leaf_stack: list[int] = []
    _, code = _emit(sig, leaf_stack)
    depth = kernels.tree_depth(code, len(leaf_stack))
    return Program(
        np.array(code, dtype=np.int32), np.array(leaf_stack, dtype=np.int32),
        len(leaf_stack), depth,
    )


def run_count_batch(sig, stacks: tuple, slots_np: np.ndarray) -> np.ndarray:
    """One launch: int64 totals for a batch of same-shape Counts.
    ``slots_np`` is int32 ``[B, L]``; per-shard int32 partials are summed
    in int64 on the host. Over sharded stacks, one launch a slice; on a
    process-spanning mesh each slice's partials are summed in int64 and
    the totals summed across the processes."""
    p = program(sig)
    if kernels.stack_spans_processes(stacks[0]):
        st = tuple(stacks)
        return sharded.total(st[0], sharded.per_slice(
            st[0],
            lambda *parts: kernels.tree_count(parts, p.code, p.leaf_stack, slots_np)
            .sum(dim=1, dtype=torch.int64),
            *st[1:],
        )).cpu().numpy()
    partials = kernels.tree_count(stacks, p.code, p.leaf_stack, slots_np)
    return partials.cpu().numpy().astype(np.int64).sum(axis=1)


def run_bitmap(sig, stacks: tuple, slots_np: np.ndarray):
    """One launch: the ``int32[S, W]`` result words of a bitmap tree, on
    the stacks' device."""
    p = program(sig)
    return kernels.tree_words(stacks, p.code, p.leaf_stack, slots_np)


# ------------------------------------------------------------- BSI signing
#
# BSI op classes of the executor's batched lane (Executor._batch_bsi): a
# signed call joins a (field, op class) group, answered by one shared
# launch per group (ops/bsi.py).

BSI_RANGE = "bsi.range"
BSI_RANGE_COUNT = "bsi.range_count"
BSI_SUM = "bsi.sum"
BSI_MIN = "bsi.min"
BSI_MAX = "bsi.max"
BSI_GROUPBY = "bsi.groupby"

BSI_OP_CLASSES = (
    BSI_RANGE, BSI_RANGE_COUNT, BSI_SUM, BSI_MIN, BSI_MAX, BSI_GROUPBY,
)


def _bsi_condition(idx, call: Call):
    """(field, Condition) when ``call`` is a pure BSI range predicate,
    ``Row(v < 3)`` or ``Range(v < 3)`` over an int field; None otherwise.
    ``== null`` stays unsigned, so the per-call path raises it within its
    own query."""
    if call.name not in ("Row", "Range") or call.children:
        return None
    fname = call.field_arg()
    if fname is None or set(call.args) != {fname}:
        return None
    field = idx.field(fname)
    if field is None or not field.is_bsi():
        return None
    cond = call.args.get(fname)
    if not isinstance(cond, Condition):
        return None
    if cond.op == "==" and cond.value is None:
        return None
    return field, cond


def match_bsi(idx, call: Call):
    """``(op_class, field, condition)`` when the batched BSI lane may
    answer ``call`` (condition None for the aggregates, which carry their
    filter as a child); None otherwise."""
    name = call.name
    m = _bsi_condition(idx, call)
    if m is not None:
        return BSI_RANGE, m[0], m[1]
    if name == "Count" and len(call.children) == 1 and not call.args:
        m = _bsi_condition(idx, call.children[0])
        if m is not None:
            return BSI_RANGE_COUNT, m[0], m[1]
        return None
    if name in ("Sum", "Min", "Max"):
        fname, ok = call.string_arg("field")
        if not ok:
            fname = call.args.get("_field")
        field = idx.field(fname) if fname else None
        if field is None or not field.is_bsi():
            return None
        cls = {"Sum": BSI_SUM, "Min": BSI_MIN, "Max": BSI_MAX}[name]
        return cls, field, None
    if name == "GroupBy":
        filt, has = call.call_arg("filter")
        if has and filt is not None:
            m = _bsi_condition(idx, filt)
            if m is not None:
                return BSI_GROUPBY, m[0], m[1]
    return None
