"""Rapids string parser (a copy of h2o3_tpu/rapids/parser.py; the
reference: water/rapids/Rapids.java).

Grammar:
  expr   := '(' op arg* ')'            application
          | '{' id* '.' expr '}'       lambda (AstFunction)
          | '[' item* ']'              number/string list; a:b = span(lo,cnt)
          | number | 'str' | "str" | id | TRUE | FALSE | NA | NaN
Parses to plain python: lists (application, head first), Lambda, Span,
float, str wrapped in StrLit, Id for identifiers.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, List


@dataclass
class Id:
    name: str


@dataclass
class StrLit:
    s: str


@dataclass
class Span:
    lo: float
    cnt: float


@dataclass
class Lambda:
    args: List[str]
    body: Any


class _Reader:
    def __init__(self, s: str):
        self.s = s
        self.i = 0

    def peek(self):
        # ',' counts as whitespace, matching the reference tokenizer
        # (water/rapids/Rapids.java skipWS) — h2o-py emits %r-style lists
        # like ['a','b'] in Assembly step ASTs
        while self.i < len(self.s) and (self.s[self.i].isspace()
                                        or self.s[self.i] == ","):
            self.i += 1
        return self.s[self.i] if self.i < len(self.s) else ""

    def next(self):
        c = self.peek()
        self.i += 1
        return c

    def token(self) -> str:
        self.peek()
        j = self.i
        while j < len(self.s) and not self.s[j].isspace() and self.s[j] not in "()[]{},'\"":
            j += 1
        tok = self.s[self.i:j]
        self.i = j
        return tok

    def string(self, quote: str) -> str:
        out = []
        while True:
            if self.i >= len(self.s):
                raise ValueError("unterminated string")
            c = self.s[self.i]
            self.i += 1
            if c == "\\":
                out.append(self.s[self.i])
                self.i += 1
            elif c == quote:
                return "".join(out)
            else:
                out.append(c)


def _atom(tok: str):
    if tok in ("TRUE", "True", "true"):
        return 1.0
    if tok in ("FALSE", "False", "false"):
        return 0.0
    if tok in ("NA", "NaN", "nan"):
        return float("nan")
    try:
        return float(tok)
    except ValueError:
        return Id(tok)


def _parse_one(r: _Reader):
    c = r.peek()
    if c == "(":
        r.next()
        items = []
        while r.peek() != ")":
            if r.peek() == "":
                raise ValueError("unbalanced (")
            items.append(_parse_one(r))
        r.next()
        return items
    if c == "[":
        r.next()
        items: List[Any] = []
        while r.peek() != "]":
            if r.peek() == "":
                raise ValueError("unbalanced [")
            e = _parse_one(r)
            # a:b spans arrive as tokens 'lo:cnt' (atom parse fails) — handle
            if isinstance(e, Id) and ":" in e.name:
                lo, cnt = e.name.split(":")
                items.append(Span(float(lo), float(cnt)))
            else:
                items.append(e)
        r.next()
        if any(isinstance(x, (StrLit, Id)) for x in items):
            return StrList([x.s if isinstance(x, StrLit)
                            else x.name if isinstance(x, Id) else x
                            for x in items])
        return NumList(items)
    if c == "{":
        r.next()
        args: List[str] = []
        while True:
            p = r.peek()
            if p == ".":
                r.next()
                break
            if p == "":
                raise ValueError("unbalanced {")
            t = r.token()
            if t == ".":
                break
            args.append(t)
        body = _parse_one(r)
        if r.peek() != "}":
            raise ValueError("unbalanced {")
        r.next()
        return Lambda(args, body)
    if c in ("'", '"'):
        r.next()
        return StrLit(r.string(c))
    tok = r.token()
    if not tok:
        raise ValueError(f"parse error at {r.i}: {r.s[r.i:r.i+20]!r}")
    return _atom(tok)


class NumList(list):
    """Marker: a bracket list of pure numbers/spans (vs an application)."""


class StrList(list):
    """Marker: a bracket list of strings (already unwrapped to str)."""


def parse(s: str):
    r = _Reader(s)
    ast = _parse_one(r)
    if r.peek() != "":
        raise ValueError(f"trailing input: {r.s[r.i:]!r}")
    return ast


@functools.lru_cache(maxsize=1024)
def parse_cached(s: str):
    """Memoized :func:`parse`: clients send the same statement strings
    again and again, and the evaluator treats parsed ASTs as read-only.
    Parse errors are not cached."""
    return parse(s)


def parse_cache_stats() -> dict:
    """Occupancy of the bounded statement-parse memo (the
    ``h2o3_rapids_parse_cache_entries`` gauge)."""
    info = parse_cached.cache_info()
    return {"size": info.currsize, "cap": info.maxsize,
            "hits": info.hits, "misses": info.misses}
