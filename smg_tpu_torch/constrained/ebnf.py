"""EBNF grammar acceptor for constrained decoding (GBNF-style syntax).

Reference capability: the ``ebnf`` sampling param the reference proto
carries end-to-end to xgrammar-backed engines.  Syntax (the GBNF dialect
xgrammar/llama.cpp grammars use)::

    root  ::= answer ("," ws answer)*
    answer ::= "yes" | "no"
    ws    ::= [ \\t]*

Rules: ``name ::= alternatives``; terminals are quoted literals and
``[...]`` character classes (ranges + negation); operators ``| ( ) * + ?``;
``#`` starts a comment.  The start symbol is ``root``.

Acceptance runs an Earley parser over CHARACTERS — handles the full
context-free language incl. recursion (an NFA cannot).  ``accepts(text)``
is prefix-viability (every scan step kept at least one live item);
``complete(text)`` is a finished ``root`` spanning the whole text.  Masks
are memoized per text by the shared TokenFilter, which keeps the O(V·n²)
worst case off the hot path the same way the JSON machine's O(V·n) is.
"""

from __future__ import annotations

from smg_tpu_torch.constrained.regex_fsm import _Pred


class GrammarError(ValueError):
    pass


def _tokenize(src: str):
    i, n = 0, len(src)
    while i < n:
        c = src[i]
        if c == "#":
            while i < n and src[i] != "\n":
                i += 1
            continue
        if c in " \t\r\n":
            i += 1
            continue
        if src.startswith("::=", i):
            yield ("::=", "::=")
            i += 3
            continue
        if c in "()|*+?":
            yield (c, c)
            i += 1
            continue
        if c == '"':
            j = i + 1
            buf = []
            while j < n and src[j] != '"':
                if src[j] == "\\" and j + 1 < n:
                    esc = src[j + 1]
                    buf.append({"n": "\n", "t": "\t", "r": "\r"}.get(esc, esc))
                    j += 2
                else:
                    buf.append(src[j])
                    j += 1
            if j >= n:
                raise GrammarError("unterminated literal")
            yield ("lit", "".join(buf))
            i = j + 1
            continue
        if c == "[":
            j = i + 1
            depth_esc = False
            while j < n and (src[j] != "]" or depth_esc or j == i + 1):
                depth_esc = src[j] == "\\" and not depth_esc
                j += 1
            if j >= n:
                raise GrammarError("unterminated char class")
            yield ("class", src[i : j + 1])
            i = j + 1
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (src[j].isalnum() or src[j] in "_-"):
                j += 1
            yield ("name", src[i:j])
            i = j
            continue
        raise GrammarError(f"unexpected char {c!r} at {i}")


def _parse_class(spec: str) -> _Pred:
    from smg_tpu_torch.constrained.regex_fsm import _Parser

    p = _Parser(spec)
    return p._char_class()


class _GParser:
    """Grammar text -> {rule: [alternative, ...]}, each alternative a list
    of symbols: ('t', _Pred) | ('r', rule_name)."""

    def __init__(self, src: str):
        self.toks = list(_tokenize(src))
        self.i = 0
        self.rules: dict[str, list[list]] = {}
        self._anon = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else (None, None)

    def parse(self) -> dict:
        while self.peek()[0] is not None:
            kind, name = self.toks[self.i]
            if kind != "name" or self.peek()[0] is None:
                raise GrammarError(f"expected rule name, got {kind}")
            self.i += 1
            if self.peek()[0] != "::=":
                raise GrammarError(f"expected ::= after {name}")
            self.i += 1
            self.rules.setdefault(name, []).extend(self._alts())
        if "root" not in self.rules:
            raise GrammarError("grammar must define a 'root' rule")
        return self.rules

    def _fresh(self, alts: list) -> str:
        self._anon += 1
        name = f"_anon{self._anon}"
        self.rules[name] = alts
        return name

    def _alts(self) -> list:
        out = [self._seq()]
        while self.peek()[0] == "|":
            self.i += 1
            out.append(self._seq())
        return out

    def _seq(self) -> list:
        syms: list = []
        while True:
            kind, val = self.peek()
            if kind in (None, "|", ")"):
                return syms
            if kind == "name" and self.i + 1 < len(self.toks) and \
                    self.toks[self.i + 1][0] == "::=":
                return syms  # next rule definition starts
            syms.extend(self._rep())

    def _rep(self) -> list:
        base = self._atom()
        kind, _ = self.peek()
        if kind == "*":
            self.i += 1
            # R ::= eps | base R
            r = self._fresh([[], []])
            self.rules[r][1] = list(base) + [("r", r)]
            return [("r", r)]
        if kind == "+":
            self.i += 1
            r = self._fresh([[], []])
            self.rules[r][1] = list(base) + [("r", r)]
            return list(base) + [("r", r)]
        if kind == "?":
            self.i += 1
            r = self._fresh([[], list(base)])
            return [("r", r)]
        return list(base)

    def _atom(self) -> list:
        kind, val = self.peek()
        if kind == "(":
            self.i += 1
            alts = self._alts()
            if self.peek()[0] != ")":
                raise GrammarError("unbalanced parens")
            self.i += 1
            return [("r", self._fresh(alts))]
        if kind == "lit":
            self.i += 1
            return [("t", _Pred({c})) for c in val]
        if kind == "class":
            self.i += 1
            return [("t", _parse_class(val))]
        if kind == "name":
            self.i += 1
            return [("r", val)]
        raise GrammarError(f"unexpected token {kind}")


class EbnfMachine:
    """Earley-based acceptor: prefix viability + completeness for the
    TokenFilter contract (same interface as JsonMachine/RegexMachine)."""

    def __init__(self, grammar: str):
        self.grammar = grammar
        self.rules = _GParser(grammar).parse()
        for alts in self.rules.values():
            for alt in alts:
                for kind, val in alt:
                    if kind == "r" and val not in self.rules:
                        raise GrammarError(f"undefined rule {val!r}")

    # Earley item: (rule, alt_index, dot, origin)

    def _process(self, read, items: set, pos: int, char, scanned: set) -> None:
        """Run one chart position to fixpoint: predict/complete within
        ``items``, scan ``char`` (None at end-of-input) into ``scanned``.
        ``read(origin)`` resolves earlier positions' item sets (read-only —
        lets incremental extension share the immutable prefix chart)."""
        rules = self.rules
        queue = list(items)
        while queue:
            rule, ai, dot, origin = queue.pop()
            alt = rules[rule][ai]
            if dot < len(alt):
                kind, val = alt[dot]
                if kind == "r":
                    for bi in range(len(rules[val])):
                        cand = (val, bi, 0, pos)
                        if cand not in items:
                            items.add(cand)
                            queue.append(cand)
                    # magic completion for nullable rules: if val already
                    # completed at pos, advance past it
                    for other in list(items):
                        if (other[0] == val and other[3] == pos
                                and other[2] == len(rules[val][other[1]])):
                            cand = (rule, ai, dot + 1, origin)
                            if cand not in items:
                                items.add(cand)
                                queue.append(cand)
                elif kind == "t" and char is not None and val(char):
                    scanned.add((rule, ai, dot + 1, origin))
            else:
                # complete: advance every item waiting on `rule` at origin
                src = items if origin == pos else read(origin)
                for other in list(src):
                    orule, oai, odot, oorigin = other
                    oalt = rules[orule][oai]
                    if odot < len(oalt) and oalt[odot] == ("r", rule):
                        cand = (orule, oai, odot + 1, oorigin)
                        if cand not in items:
                            items.add(cand)
                            queue.append(cand)

    def _chart(self, text: str):
        n = len(text)
        chart: list[set] = [set() for _ in range(n + 1)]
        for ai in range(len(self.rules["root"])):
            chart[0].add(("root", ai, 0, 0))
        read = lambda origin: chart[origin]  # noqa: E731
        for pos in range(n + 1):
            scanned: set = set()
            self._process(read, chart[pos], pos,
                          text[pos] if pos < n else None, scanned)
            if pos < n:
                chart[pos + 1] |= scanned
                if not chart[pos + 1]:
                    return chart, pos + 1  # scan failed
        return chart, None

    @staticmethod
    def _root_done(items, rules) -> bool:
        return any(
            rule == "root" and origin == 0 and dot == len(rules["root"][ai])
            for rule, ai, dot, origin in items
        )

    def accepts(self, text: str) -> bool:
        _, failed_at = self._chart(text)
        return failed_at is None

    def complete(self, text: str) -> bool:
        chart, failed_at = self._chart(text)
        if failed_at is not None:
            return False
        return self._root_done(chart[len(text)], self.rules)

    # ---- incremental interface (TokenFilter fast path): the prefix chart
    # computes ONCE per decode step; each candidate piece extends a COPY of
    # the frontier set, sharing positions < n read-only ----

    def prefix_state(self, text: str):
        chart, failed_at = self._chart(text)
        return None if failed_at is not None else chart

    def accepts_from(self, chart, piece: str) -> bool:
        return self._extend(chart, piece) is not None

    def complete_from(self, chart) -> bool:
        # the frontier was already processed to fixpoint by _chart
        return self._root_done(chart[len(chart) - 1], self.rules)

    def _extend(self, chart, piece: str):
        """Extend a prefix chart by ``piece`` without mutating it; returns
        the list of NEW position sets (frontier copy first) or None when
        the scan dies."""
        base = len(chart) - 1
        new_sets: list[set] = [set(chart[base])]

        def read(origin):
            return chart[origin] if origin < base else new_sets[origin - base]

        for k in range(len(piece) + 1):
            char = piece[k] if k < len(piece) else None
            pos = base + k
            scanned: set = set()
            self._process(read, new_sets[k], pos, char, scanned)
            if char is not None:
                if not scanned:
                    return None
                new_sets.append(scanned)
        return new_sets
