"""Regex acceptor for constrained decoding: prefix-validity + completeness.

Python's ``re`` cannot answer "is this text a PREFIX of some match", which
is the question vocab masking asks, so the pattern compiles to a Thompson
NFA simulated character-by-character: ``accepts`` = live states remain,
``complete`` = an accepting state is active.  Supported syntax (the subset
structured-output patterns use): literals, ``.``, ``[...]`` classes with
ranges and negation, escapes (``\\d \\w \\s \\D \\W \\S`` + literal
escapes), groups, alternation, ``* + ? {m} {m,} {m,n}``, anchors ``^ $``
(implicit — the whole output must match, reference semantics).

Reference capability: the ``regex`` sampling param fed to xgrammar-backed
engines (``sglang_scheduler.proto`` SamplingParams).
"""

from __future__ import annotations

_DIGITS = set("0123456789")
_WORD = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_")
_SPACE = set(" \t\n\r\f\v")


#: bound on {m,n} expansion — the NFA grows by m states per repetition, so
#: an unbounded user-supplied count is a memory/CPU DoS
MAX_BOUNDED_REPEAT = 1024


class _Pred:
    """Character predicate (set or negated set; None = any)."""

    __slots__ = ("chars", "negate")

    def __init__(self, chars=None, negate=False):
        self.chars = chars  # None = match anything
        self.negate = negate

    def __call__(self, c: str) -> bool:
        if self.chars is None:
            return True
        return (c not in self.chars) if self.negate else (c in self.chars)


class _ClassPred:
    """[...] class: any member predicate matches (then class negation).
    Members may themselves be negated escapes like \\S."""

    __slots__ = ("members", "negate")

    def __init__(self, members, negate=False):
        self.members = members
        self.negate = negate

    def __call__(self, c: str) -> bool:
        hit = any(m(c) for m in self.members)
        return (not hit) if self.negate else hit


class _Parser:
    """Pattern -> AST of ('cat'|'alt'|'rep'|'char', ...)."""

    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0

    def peek(self):
        return self.p[self.i] if self.i < len(self.p) else None

    def parse(self):
        node = self._alt()
        if self.i != len(self.p):
            raise ValueError(f"regex parse error at {self.i} in {self.p!r}")
        return node

    def _alt(self):
        branches = [self._cat()]
        while self.peek() == "|":
            self.i += 1
            branches.append(self._cat())
        return ("alt", branches) if len(branches) > 1 else branches[0]

    def _cat(self):
        items = []
        while self.peek() is not None and self.peek() not in "|)":
            items.append(self._rep())
        return ("cat", items)

    def _rep(self):
        atom = self._atom()
        while True:
            c = self.peek()
            if c == "*":
                self.i += 1
                atom = ("rep", atom, 0, None)
            elif c == "+":
                self.i += 1
                atom = ("rep", atom, 1, None)
            elif c == "?":
                self.i += 1
                atom = ("rep", atom, 0, 1)
            elif c == "{":
                j = self.p.index("}", self.i)
                spec = self.p[self.i + 1 : j]
                self.i = j + 1
                if "," in spec:
                    lo, hi = spec.split(",", 1)
                    atom = ("rep", atom, int(lo or 0),
                            int(hi) if hi.strip() else None)
                else:
                    atom = ("rep", atom, int(spec), int(spec))
                if atom[2] > MAX_BOUNDED_REPEAT or (
                    atom[3] is not None and atom[3] > MAX_BOUNDED_REPEAT
                ):
                    raise ValueError(
                        f"repetition bound exceeds {MAX_BOUNDED_REPEAT}"
                    )
            else:
                return atom

    def _atom(self):
        c = self.peek()
        if c == "(":
            self.i += 1
            # non-capturing marker is irrelevant to acceptance
            if self.p[self.i : self.i + 2] == "?:":
                self.i += 2
            node = self._alt()
            if self.peek() != ")":
                raise ValueError("unbalanced group")
            self.i += 1
            return node
        if c == "[":
            return ("char", self._char_class())
        if c == "\\":
            self.i += 1
            if self.i >= len(self.p):
                raise ValueError("dangling escape at end of pattern")
            return ("char", self._escape(self.p[self.i]))
        if c in ("^", "$"):  # anchors are implicit (full match); skip
            self.i += 1
            return ("cat", [])
        if c == ".":
            self.i += 1
            return ("char", _Pred(None))
        self.i += 1
        return ("char", _Pred({c}))

    def _escape(self, c: str) -> _Pred:
        self.i += 1
        table = {"d": _Pred(_DIGITS), "D": _Pred(_DIGITS, negate=True),
                 "w": _Pred(_WORD), "W": _Pred(_WORD, negate=True),
                 "s": _Pred(_SPACE), "S": _Pred(_SPACE, negate=True),
                 "n": _Pred({"\n"}), "t": _Pred({"\t"}), "r": _Pred({"\r"})}
        return table.get(c, _Pred({c}))

    def _class_atom(self) -> "str | _Pred":
        """One [...] member: a literal character (possibly from an escape
        like ``\\t`` or ``\\-``, returned as str so it can serve as a range
        endpoint) or a class-escape predicate (``\\d``/``\\S``/...)."""
        c = self.peek()
        if c != "\\":
            self.i += 1
            return c
        self.i += 1
        if self.i >= len(self.p):
            raise ValueError("dangling escape in char class")
        e = self.p[self.i]
        if e in "dDwWsS":
            return self._escape(e)  # advances past the escape char
        self.i += 1
        return {"n": "\n", "t": "\t", "r": "\r"}.get(e, e)

    def _char_class(self):
        self.i += 1  # [
        negate = False
        if self.peek() == "^":
            negate = True
            self.i += 1
        chars: set = set()
        extra_members: list = []  # negated escapes (\S, \D, \W) keep their
        # own predicate instead of being flattened into the char set
        first = True
        while self.peek() is not None and (self.peek() != "]" or first):
            first = False
            lo = self._class_atom()
            if not isinstance(lo, str):
                # multi-char class escape: a set member, never a range
                # endpoint (matches re semantics for [\d-x]: literal '-')
                if lo.chars is not None and not lo.negate:
                    chars |= lo.chars
                else:
                    extra_members.append(lo)
                continue
            # a '-' not followed by ']' starts a range; the low endpoint may
            # itself come from an escape ([\t-z] is the range \t..z, not the
            # set {'\t','-','z'}), and so may the high one ([!-\\])
            if (
                self.peek() == "-"
                and self.i + 1 < len(self.p)
                and self.p[self.i + 1] != "]"
            ):
                self.i += 1  # consume '-'
                hi = self._class_atom()
                if not isinstance(hi, str):
                    raise ValueError(
                        "char-class range endpoint cannot be a class escape"
                    )
                if ord(hi) < ord(lo):
                    raise ValueError(f"bad character range {lo!r}-{hi!r}")
                chars |= {chr(x) for x in range(ord(lo), ord(hi) + 1)}
            else:
                chars.add(lo)
        if self.peek() != "]":
            raise ValueError("unbalanced char class")
        self.i += 1
        if extra_members:
            return _ClassPred([_Pred(chars)] + extra_members, negate=negate)
        return _Pred(chars, negate=negate)


class RegexMachine:
    """NFA acceptance over character predicates (Thompson construction)."""

    def __init__(self, pattern: str):
        self.pattern = pattern
        # states: list of (pred, targets) transitions; eps: list of sets
        self._trans: list[tuple[_Pred, int]] = []
        self._eps: list[list[int]] = []
        self._start, self._accept = self._build(_Parser(pattern).parse())

    def _new_state(self) -> int:
        self._eps.append([])
        return len(self._eps) - 1

    def _build(self, node) -> tuple[int, int]:
        kind = node[0]
        if kind == "char":
            s, t = self._new_state(), self._new_state()
            self._trans.append((node[1], t))
            self._eps[s].append(-len(self._trans))  # marker: transition idx
            return s, t
        if kind == "cat":
            s = t = self._new_state()
            for item in node[1]:
                a, b = self._build(item)
                self._eps[t].append(a)
                t = b
            return s, t
        if kind == "alt":
            s, t = self._new_state(), self._new_state()
            for br in node[1]:
                a, b = self._build(br)
                self._eps[s].append(a)
                self._eps[b].append(t)
            return s, t
        if kind == "rep":
            _, inner, lo, hi = node
            s = t = self._new_state()
            for _ in range(lo):
                a, b = self._build(inner)
                self._eps[t].append(a)
                t = b
            if hi is None:  # unbounded tail: loop
                a, b = self._build(inner)
                self._eps[t].append(a)
                self._eps[b].append(t)  # loop back (>= lo repetitions)
            else:
                for _ in range(hi - lo):
                    a, b = self._build(inner)
                    end = self._new_state()
                    self._eps[t].append(a)
                    self._eps[b].append(end)
                    self._eps[t].append(end)  # optional: skip
                    t = end
            return s, t
        raise ValueError(f"unknown node {kind}")

    def _closure(self, states: set) -> tuple[set, list]:
        """Epsilon-closure -> (state set, outgoing char transitions)."""
        out: set = set()
        trans: list = []
        stack = list(states)
        while stack:
            s = stack.pop()
            if s in out:
                continue
            out.add(s)
            for e in self._eps[s]:
                if e < 0:  # char transition marker
                    trans.append(self._trans[-e - 1])
                elif e not in out:
                    stack.append(e)
        return out, trans

    def _run(self, text: str) -> set:
        states = {self._start}
        for c in text:
            closed, trans = self._closure(states)
            states = {t for pred, t in trans if pred(c)}
            if not states:
                return set()
        closed, _ = self._closure(states)
        return closed

    def accepts(self, text: str) -> bool:
        """text is a viable PREFIX of some full match."""
        return bool(self._run(text)) if text else True

    def complete(self, text: str) -> bool:
        return self._accept in self._run(text) if text else self._accept in self._closure({self._start})[0]

    # ---- incremental interface (TokenFilter fast path): compute the NFA
    # state ONCE per decode step, extend it per candidate piece — O(V·|piece|)
    # instead of re-simulating the whole prefix V times ----

    def prefix_state(self, text: str):
        """Closed state set after ``text``; None = dead prefix."""
        states = self._run(text) if text else self._closure({self._start})[0]
        return states or None

    def accepts_from(self, states, piece: str) -> bool:
        cur = states
        for c in piece:
            closed, trans = self._closure(cur)
            cur = {t for pred, t in trans if pred(c)}
            if not cur:
                return False
        return True

    def complete_from(self, states) -> bool:
        return self._accept in states
