"""Regex subset -> byte-level DFA (full-match semantics).

Pipeline: pattern string -> AST -> Thompson NFA over UTF-8 BYTES -> subset
construction -> dense DFA (`trans [S, 256]` int32 with -1 = dead,
`accept [S]` bool) -> live-state set (states from which an accept state is
reachable). Everything downstream (tables.py) only ever walks live states,
so a token whose bytes stray into a dead path is simply disallowed.

Supported syntax (the subset the JSON-schema compiler and the serving
surface need — unsupported constructs raise RegexError, never silently
mis-match): literals (unicode literals expand to their UTF-8 byte
sequence), `.` (any byte except \\n), escapes (\\d \\D \\w \\W \\s \\S,
\\n \\t \\r \\f \\v, \\xNN, and escaped punctuation), character classes
`[...]` / `[^...]` with ranges, groups `(...)`, alternation `|`, and
quantifiers `*` `+` `?` `{m}` `{m,}` `{m,n}`.

Not supported: anchors (matching is whole-string anyway), backreferences,
lookaround, lazy quantifiers (irrelevant: a DFA has no match order), and
named/capturing group semantics (groups only group).
"""

from __future__ import annotations

import dataclasses

import numpy as np

MAX_DFA_STATES = 4096
MAX_REPEAT = 512

_META = set("\\^$.|?*+()[]{}")


class RegexError(ValueError):
    """Unsupported or malformed pattern."""


def escape_literal(text: str) -> str:
    """Escape `text` so the parser treats it as a literal."""
    return "".join("\\" + c if c in _META else c for c in text)


# -- AST ---------------------------------------------------------------------
# ('set', frozenset[int])       one byte from the set
# ('cat', [nodes])              concatenation
# ('alt', [nodes])              alternation
# ('rep', node, m, n|None)      repeat m..n times (None = unbounded)

_DIGITS = frozenset(range(0x30, 0x3A))
_WORD = frozenset(
    list(range(0x30, 0x3A)) + list(range(0x41, 0x5B))
    + list(range(0x61, 0x7B)) + [0x5F]
)
_SPACE = frozenset(b" \t\n\r\f\v")
_ALL = frozenset(range(256))
_DOT = _ALL - {0x0A}


class _Parser:
    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0

    def error(self, msg: str):
        raise RegexError(f"{msg} at position {self.i} in {self.p!r}")

    def peek(self):
        return self.p[self.i] if self.i < len(self.p) else None

    def next(self):
        c = self.peek()
        if c is None:
            self.error("unexpected end of pattern")
        self.i += 1
        return c

    def parse(self):
        node = self._alt()
        if self.i != len(self.p):
            self.error(f"unexpected {self.p[self.i]!r}")
        return node

    def _alt(self):
        branches = [self._cat()]
        while self.peek() == "|":
            self.next()
            branches.append(self._cat())
        return branches[0] if len(branches) == 1 else ("alt", branches)

    def _cat(self):
        parts = []
        while self.peek() is not None and self.peek() not in "|)":
            parts.append(self._repeat())
        return ("cat", parts)

    def _repeat(self):
        atom = self._atom()
        c = self.peek()
        if c == "*":
            self.next()
            return ("rep", atom, 0, None)
        if c == "+":
            self.next()
            return ("rep", atom, 1, None)
        if c == "?":
            self.next()
            return ("rep", atom, 0, 1)
        if c == "{":
            return self._braces(atom)
        return atom

    def _braces(self, atom):
        self.next()  # '{'
        lo = self._int()
        hi = lo
        if self.peek() == ",":
            self.next()
            hi = self._int() if self.peek() != "}" else None
        if self.next() != "}":
            self.error("expected '}'")
        if hi is not None and hi < lo:
            self.error(f"bad repeat bounds {{{lo},{hi}}}")
        if lo > MAX_REPEAT or (hi or 0) > MAX_REPEAT:
            self.error(f"repeat bound exceeds {MAX_REPEAT}")
        return ("rep", atom, lo, hi)

    def _int(self) -> int:
        start = self.i
        while self.peek() is not None and self.peek().isdigit():
            self.next()
        if start == self.i:
            self.error("expected a number")
        return int(self.p[start: self.i])

    def _atom(self):
        c = self.next()
        if c == "(":
            node = self._alt()
            if self.next() != ")":
                self.error("expected ')'")
            return node
        if c == "[":
            return self._cls()
        if c == ".":
            return ("set", _DOT)
        if c == "\\":
            return self._escape(in_class=False)
        if c in "^$":
            self.error(f"anchors ({c!r}) are not supported; matching is "
                       "whole-string")
        if c in "*+?{":
            self.error(f"quantifier {c!r} with nothing to repeat")
        return _literal_node(c)

    def _escape(self, in_class: bool):
        c = self.next()
        simple = {
            "d": _DIGITS, "D": _ALL - _DIGITS,
            "w": _WORD, "W": _ALL - _WORD,
            "s": _SPACE, "S": _ALL - _SPACE,
        }
        if c in simple:
            return ("set", simple[c])
        ctrl = {"n": 0x0A, "t": 0x09, "r": 0x0D, "f": 0x0C, "v": 0x0B,
                "0": 0x00}
        if c in ctrl:
            return ("set", frozenset({ctrl[c]}))
        if c == "x":
            h = self.next() + self.next()
            try:
                return ("set", frozenset({int(h, 16)}))
            except ValueError:
                self.error(f"bad \\x escape {h!r}")
        if c.isalnum():
            self.error(f"unsupported escape \\{c}")
        return _literal_node(c)

    def _cls(self):
        negate = self.peek() == "^"
        if negate:
            self.next()
        members: set[int] = set()
        first = True
        while True:
            c = self.peek()
            if c is None:
                self.error("unterminated character class")
            if c == "]" and not first:
                self.next()
                break
            first = False
            lo = self._cls_member()
            if self.peek() == "-" and self.i + 1 < len(self.p) and \
                    self.p[self.i + 1] != "]":
                self.next()
                hi = self._cls_member()
                if not (len(lo) == len(hi) == 1):
                    self.error("class range endpoints must be single bytes")
                a, b = min(lo), min(hi)
                if b < a:
                    self.error(f"reversed class range")
                members.update(range(a, b + 1))
            else:
                members.update(lo)
        return ("set", frozenset(_ALL - members if negate else members))

    def _cls_member(self) -> frozenset:
        c = self.next()
        if c == "\\":
            node = self._escape(in_class=True)
            return node[1]
        b = c.encode("utf-8")
        if len(b) != 1:
            self.error(f"non-ASCII char {c!r} in class (use it as a literal "
                       "outside the class instead)")
        return frozenset({b[0]})


def _literal_node(char: str):
    """A literal char: one byte-set, or a cat of byte-sets for multi-byte
    UTF-8 (each byte matched exactly)."""
    b = char.encode("utf-8")
    if len(b) == 1:
        return ("set", frozenset({b[0]}))
    return ("cat", [("set", frozenset({x})) for x in b])


# -- Thompson NFA ------------------------------------------------------------


class _Nfa:
    """eps[s] = list of eps-targets; edge[s] = (byteset, target) or None."""

    def __init__(self):
        self.eps: list[list[int]] = []
        self.edge: list = []

    def state(self) -> int:
        self.eps.append([])
        self.edge.append(None)
        return len(self.eps) - 1

    def build(self, node) -> tuple[int, int]:
        kind = node[0]
        if kind == "set":
            s, e = self.state(), self.state()
            self.edge[s] = (node[1], e)
            return s, e
        if kind == "cat":
            if not node[1]:
                s = self.state()
                return s, s
            s, e = self.build(node[1][0])
            for sub in node[1][1:]:
                s2, e2 = self.build(sub)
                self.eps[e].append(s2)
                e = e2
            return s, e
        if kind == "alt":
            s, e = self.state(), self.state()
            for sub in node[1]:
                bs, be = self.build(sub)
                self.eps[s].append(bs)
                self.eps[be].append(e)
            return s, e
        if kind == "rep":
            _, sub, lo, hi = node
            s = self.state()
            cur = s
            for _ in range(lo):
                bs, be = self.build(sub)
                self.eps[cur].append(bs)
                cur = be
            if hi is None:  # star tail
                bs, be = self.build(sub)
                self.eps[cur].append(bs)
                self.eps[be].append(cur)
                return s, cur
            e = self.state()
            self.eps[cur].append(e)
            for _ in range(hi - lo):
                bs, be = self.build(sub)
                self.eps[cur].append(bs)
                cur = be
                self.eps[cur].append(e)
            return s, e
        raise RegexError(f"unknown AST node {kind!r}")


@dataclasses.dataclass
class Dfa:
    """Dense byte-level DFA. trans[s, b] = next state or -1 (dead);
    live[s] = an accept state is reachable from s (s itself counts)."""

    trans: np.ndarray  # [S, 256] int32
    accept: np.ndarray  # [S] bool
    live: np.ndarray  # [S] bool
    start: int = 0

    @property
    def n_states(self) -> int:
        return self.trans.shape[0]


def compile_regex(pattern: str) -> Dfa:
    """Pattern -> byte-level DFA with full-match semantics."""
    ast = _Parser(pattern).parse()
    nfa = _Nfa()
    start, end = nfa.build(ast)

    def closure(states: frozenset) -> frozenset:
        out = set(states)
        stack = list(states)
        while stack:
            for t in nfa.eps[stack.pop()]:
                if t not in out:
                    out.add(t)
                    stack.append(t)
        return frozenset(out)

    start_set = closure(frozenset({start}))
    index = {start_set: 0}
    order = [start_set]
    rows = []
    i = 0
    while i < len(order):
        cur = order[i]
        i += 1
        # bucket this subset's outgoing byte-sets once, then resolve each
        # byte against the handful of distinct edges (not 256 x edges)
        edges = [nfa.edge[s] for s in cur if nfa.edge[s] is not None]
        row = np.full((256,), -1, np.int32)
        if edges:
            targets: dict[int, set] = {}
            for byteset, tgt in edges:
                for b in byteset:
                    targets.setdefault(b, set()).add(tgt)
            for b, tset in targets.items():
                nxt = closure(frozenset(tset))
                j = index.get(nxt)
                if j is None:
                    if len(order) >= MAX_DFA_STATES:
                        raise RegexError(
                            f"constraint DFA exceeds {MAX_DFA_STATES} "
                            f"states; simplify the pattern"
                        )
                    j = len(order)
                    index[nxt] = j
                    order.append(nxt)
                row[b] = j
        rows.append(row)

    trans = np.stack(rows) if rows else np.full((1, 256), -1, np.int32)
    accept = np.asarray([end in s for s in order], bool)
    # live = backward reachability to an accept state
    live = accept.copy()
    changed = True
    while changed:
        changed = False
        # any state with a transition into a live state becomes live
        hits = np.isin(trans, np.flatnonzero(live)) & (trans >= 0)
        new_live = live | hits.any(axis=1)
        if (new_live != live).any():
            live = new_live
            changed = True
    if not live[0]:
        raise RegexError(f"pattern {pattern!r} matches no string")
    return Dfa(trans=trans, accept=accept, live=live)
