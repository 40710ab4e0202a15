"""Recursive-descent PQL parser.

Grammar-compatible with the reference PEG (pql/pql.peg, 83 lines; generated
parser pql/pql.peg.go). Implemented as a fresh hand-rolled recursive
descent with explicit backtracking where the PEG uses ordered choice
(notably ``Range(f=5, from, to)`` vs generic ``Range(f > 5)``, and the
special call forms falling back to the generic ``IDENT(allargs)`` rule).
"""

from __future__ import annotations

import re
import threading
from collections import OrderedDict
from typing import Any

from pilosa_tpu_torch.pql.ast import Call, Condition, Query

_TIMESTAMP_RE = re.compile(r"\d{4}-[01]\d-[0-3]\dT\d\d:\d\d$")
_NUMBER_RE = re.compile(r"-?(\d+(\.\d*)?|\.\d+)$")
_IDENT_RE = re.compile(r"[A-Za-z][A-Za-z0-9]*")
_FIELD_RE = re.compile(r"[A-Za-z][A-Za-z0-9_-]*")
_RESERVED_FIELDS = ("_row", "_col", "_start", "_end", "_timestamp", "_field")
# Bare-word value charset (pql.peg:50) extended with '.' so numbers and the
# classifier below can share one scan.
_BARE_RE = re.compile(r"[A-Za-z0-9\-_:.]+")


class ParseError(Exception):
    def __init__(self, msg: str, pos: int = 0):
        super().__init__(f"{msg} at position {pos}")
        self.pos = pos


class _Parser:
    def __init__(self, src: str):
        self.src = src
        self.pos = 0

    # -- low-level helpers --------------------------------------------------

    def error(self, msg: str):
        raise ParseError(msg, self.pos)

    def sp(self) -> None:
        while self.pos < len(self.src) and self.src[self.pos] in " \t\n\r":
            self.pos += 1

    def eof(self) -> bool:
        return self.pos >= len(self.src)

    def peek(self) -> str:
        return self.src[self.pos] if self.pos < len(self.src) else ""

    def lit(self, s: str) -> bool:
        if self.src.startswith(s, self.pos):
            self.pos += len(s)
            return True
        return False

    def expect(self, s: str) -> None:
        if not self.lit(s):
            self.error(f"expected {s!r}")

    def comma(self) -> bool:
        save = self.pos
        self.sp()
        if self.lit(","):
            self.sp()
            return True
        self.pos = save
        return False

    def regex(self, rx: re.Pattern) -> str | None:
        m = rx.match(self.src, self.pos)
        if not m:
            return None
        self.pos = m.end()
        return m.group(0)

    # -- grammar ------------------------------------------------------------

    def parse(self) -> Query:
        q = Query()
        self.sp()
        while not self.eof():
            q.calls.append(self.call())
            self.sp()
        return q

    def call(self) -> Call:
        save = self.pos
        name = self.regex(_IDENT_RE)
        if not name:
            self.error("expected call name")
        # Special forms match the exact literal name (PEG ordered choice,
        # pql.peg:9-17); on failure fall back to the generic IDENT rule.
        specials = {
            "Set": self._call_set,
            "SetRowAttrs": self._call_setrowattrs,
            "SetColumnAttrs": self._call_setcolumnattrs,
            "Clear": self._call_clear,
            "ClearRow": self._call_clearrow,
            "Store": self._call_store,
            "TopN": self._call_topn,
            "Rows": self._call_rows,
            "Range": self._call_range,
        }
        special = specials.get(name)
        if special is not None:
            try:
                return special()
            except ParseError:
                self.pos = save
                name = self.regex(_IDENT_RE)
        return self._generic_call(name)

    def _open(self) -> None:
        self.expect("(")
        self.sp()

    def _close(self) -> None:
        self.sp()
        self.expect(")")

    def _generic_call(self, name: str) -> Call:
        # IDENT open allargs comma? close (pql.peg:18)
        call = Call(name)
        self._open()
        self._allargs(call)
        self.comma()
        self._close()
        return call

    def _allargs(self, call: Call) -> None:
        # allargs <- Call (comma Call)* (comma args)? / args / sp (pql.peg:19)
        save = self.pos
        try:
            call.children.append(self.call())
            while True:
                save2 = self.pos
                if not self.comma():
                    break
                try:
                    call.children.append(self.call())
                except ParseError:
                    self.pos = save2
                    if self.comma():
                        self._args(call)
                    break
            return
        except ParseError:
            self.pos = save
        save = self.pos
        try:
            self._args(call)
            return
        except ParseError:
            self.pos = save
        self.sp()

    def _args(self, call: Call) -> None:
        self._arg(call)
        while True:
            save = self.pos
            if not self.comma():
                break
            # trailing comma before ')' belongs to the caller
            try:
                self._arg(call)
            except ParseError:
                self.pos = save
                break
        self.sp()

    def _arg(self, call: Call) -> None:
        # ternary conditional starts with an integer (pql.peg:34-37)
        c = self.peek()
        if c.isdigit() or c == "-":
            self._ternary(call)
            return
        fname = self._field_name()
        self.sp()
        for op in ("><", "<=", ">=", "==", "!=", "<", ">", "="):
            if self.lit(op):
                self.sp()
                value = self.value()
                if op == "=":
                    call.args[fname] = value
                else:
                    call.args[fname] = Condition(op, value)
                return
        self.error("expected '=' or comparison operator")

    def _ternary(self, call: Call) -> None:
        lo = self._int()
        self.sp()
        lo_op = "<=" if self.lit("<=") else ("<" if self.lit("<") else self.error("expected < or <="))
        self.sp()
        fname = self._field_name()
        self.sp()
        hi_op = "<=" if self.lit("<=") else ("<" if self.lit("<") else self.error("expected < or <="))
        self.sp()
        hi = self._int()
        call.args[fname] = Condition(f"{lo_op}x{hi_op}", [lo, hi])

    def _int(self) -> int:
        m = re.compile(r"-?\d+").match(self.src, self.pos)
        if not m:
            self.error("expected integer")
        self.pos = m.end()
        return int(m.group(0))

    def _field_name(self) -> str:
        for r in _RESERVED_FIELDS:
            if self.src.startswith(r, self.pos):
                self.pos += len(r)
                return r
        name = self.regex(_FIELD_RE)
        if not name:
            self.error("expected field name")
        return name

    # -- values -------------------------------------------------------------

    def value(self) -> Any:
        self.sp()
        c = self.peek()
        if c == "[":
            self.pos += 1
            self.sp()
            items = []
            if self.peek() != "]":
                while True:
                    items.append(self.value())
                    if not self.comma():
                        break
            self.sp()
            self.expect("]")
            self.sp()
            return items
        if c == '"':
            return self._dquoted()
        if c == "'":
            return self._squoted()
        save = self.pos
        tok = self.regex(_BARE_RE)
        if tok is None:
            self.error("expected value")
        follows_call = self.peek() == "("
        # classify the bare token (pql.peg:43-53 item ordering)
        if not follows_call:
            if tok in ("null", "true", "false") and self._at_delim():
                return {"null": None, "true": True, "false": False}[tok]
            if _TIMESTAMP_RE.fullmatch(tok):
                return tok
            if _NUMBER_RE.fullmatch(tok):
                return float(tok) if "." in tok else int(tok)
            return tok
        if _IDENT_RE.fullmatch(tok):
            self.pos = save
            return self.call()
        self.error(f"unexpected token {tok!r}")

    def _at_delim(self) -> bool:
        save = self.pos
        self.sp()
        ok = self.peek() in (",", ")", "]", "")
        self.pos = save
        return ok

    def _dquoted(self) -> str:
        self.expect('"')
        out = []
        while True:
            c = self.peek()
            if c == "":
                self.error("unterminated string")
            if c == '"':
                self.pos += 1
                return "".join(out)
            if c == "\\" and self.pos + 1 < len(self.src) and self.src[self.pos + 1] in '"\\':
                out.append(self.src[self.pos + 1])
                self.pos += 2
            else:
                out.append(c)
                self.pos += 1

    def _squoted(self) -> str:
        self.expect("'")
        out = []
        while True:
            c = self.peek()
            if c == "":
                self.error("unterminated string")
            if c == "'":
                self.pos += 1
                return "".join(out)
            if c == "\\" and self.pos + 1 < len(self.src) and self.src[self.pos + 1] in "'\\":
                out.append(self.src[self.pos + 1])
                self.pos += 2
            else:
                out.append(c)
                self.pos += 1

    # -- positional helpers -------------------------------------------------

    def _pos_num_or_str(self, call: Call, key: str) -> None:
        # col / row rule (pql.peg:63-70): uint or quoted string
        c = self.peek()
        if c == '"':
            call.args[key] = self._dquoted()
        elif c == "'":
            call.args[key] = self._squoted()
        else:
            tok = self.regex(re.compile(r"\d+"))
            if tok is None:
                self.error(f"expected {key} value")
            call.args[key] = int(tok)

    def _posfield(self, call: Call) -> None:
        name = self.regex(_FIELD_RE)
        if not name:
            self.error("expected field name")
        call.args["_field"] = name

    def _timestampfmt(self) -> str:
        c = self.peek()
        if c in "\"'":
            quote = c
            self.pos += 1
            tok = self.regex(re.compile(r"\d{4}-[01]\d-[0-3]\dT\d\d:\d\d"))
            if tok is None:
                self.error("expected timestamp")
            self.expect(quote)
            return tok
        tok = self.regex(re.compile(r"\d{4}-[01]\d-[0-3]\dT\d\d:\d\d"))
        if tok is None:
            self.error("expected timestamp")
        return tok

    # -- special call forms (pql.peg:9-17) ----------------------------------

    def _call_set(self) -> Call:
        call = Call("Set")
        self._open()
        self._pos_num_or_str(call, "_col")
        if not self.comma():
            self.error("expected ','")
        self._args(call)
        save = self.pos
        if self.comma():
            try:
                call.args["_timestamp"] = self._timestampfmt()
            except ParseError:
                self.pos = save
        self._close()
        return call

    def _call_setrowattrs(self) -> Call:
        call = Call("SetRowAttrs")
        self._open()
        self._posfield(call)
        if not self.comma():
            self.error("expected ','")
        self._pos_num_or_str(call, "_row")
        if not self.comma():
            self.error("expected ','")
        self._args(call)
        self._close()
        return call

    def _call_setcolumnattrs(self) -> Call:
        call = Call("SetColumnAttrs")
        self._open()
        self._pos_num_or_str(call, "_col")
        if not self.comma():
            self.error("expected ','")
        self._args(call)
        self._close()
        return call

    def _call_clear(self) -> Call:
        call = Call("Clear")
        self._open()
        self._pos_num_or_str(call, "_col")
        if not self.comma():
            self.error("expected ','")
        self._args(call)
        self._close()
        return call

    def _call_clearrow(self) -> Call:
        call = Call("ClearRow")
        self._open()
        self._arg(call)
        self._close()
        return call

    def _call_store(self) -> Call:
        call = Call("Store")
        self._open()
        call.children.append(self.call())
        if not self.comma():
            self.error("expected ','")
        self._arg(call)
        self._close()
        return call

    def _call_topn(self) -> Call:
        return self._posfield_call("TopN")

    def _call_rows(self) -> Call:
        return self._posfield_call("Rows")

    def _posfield_call(self, name: str) -> Call:
        call = Call(name)
        self._open()
        self._posfield(call)
        if self.comma():
            self._allargs(call)
        self._close()
        return call

    def _call_range(self) -> Call:
        # 'Range' open field '=' value comma 'from='? ts comma 'to='? ts close
        call = Call("Range")
        self._open()
        fname = self._field_name()
        self.sp()
        self.expect("=")
        self.sp()
        call.args[fname] = self.value()
        if not self.comma():
            self.error("expected ','")
        self.lit("from=")
        call.args["from"] = self._timestampfmt()
        if not self.comma():
            self.error("expected ','")
        self.lit("to=")
        self.sp()
        call.args["to"] = self._timestampfmt()
        self._close()
        return call


# Parsed-AST cache for SHORT queries (the serving shapes — lone counts,
# TopN, GroupBy — repeat with varying literals, and parsing costs ~half
# of a warm cache-served round trip).  Long strings (bulk write batches)
# are one-shot and would only bloat the key memory, so they bypass.
# Cached Querys are never handed out directly: callers receive a fresh
# clone per parse, because the executor mutates call args in place
# (key translation).
_PARSE_CACHE_MAX_LEN = 256
_parse_cache: "OrderedDict[str, Query]" = OrderedDict()
_PARSE_CACHE_ENTRIES = 4096
_parse_cache_lock = threading.Lock()


def parse(src: str) -> Query:
    """Parse a PQL string into a Query (reference pql/parser.go Parse)."""
    if len(src) > _PARSE_CACHE_MAX_LEN:
        return _Parser(src).parse()
    with _parse_cache_lock:
        q = _parse_cache.get(src)
        if q is not None:
            _parse_cache.move_to_end(src)
            return Query([c.clone() for c in q.calls])
    q = _Parser(src).parse()
    with _parse_cache_lock:
        _parse_cache[src] = Query([c.clone() for c in q.calls])
        while len(_parse_cache) > _PARSE_CACHE_ENTRIES:
            _parse_cache.popitem(last=False)
    return q
