"""Incremental JSON syntax acceptor (prefix validity + completion).

A character-level pushdown acceptor for JSON documents: ``accepts(text)``
says whether ``text`` can still be extended to valid JSON (prefix-valid),
and ``complete(text)`` whether it already is valid JSON.  This is the
"json_object" response-format machine; schema-shaped constraints compose on
top (round-2: compile json_schema -> field automata).
"""

from __future__ import annotations

import json

_WS = " \t\n\r"
_DIGITS = "0123456789"


class JsonMachine:
    """Stateless prefix-validity checks (the token filter drives it with
    candidate strings; no incremental state is kept here, which keeps the
    implementation obviously-correct at the cost of O(n) rescans — the token
    filter memoizes by accepted-text)."""

    def accepts(self, text: str) -> bool:
        """True if ``text`` is a prefix of at least one valid JSON document."""
        ok, _ = _scan(text)
        return ok

    def complete(self, text: str) -> bool:
        """True if ``text`` is a complete valid JSON document."""
        try:
            json.loads(text)
            return True
        except json.JSONDecodeError:
            return False


def _scan(text: str) -> tuple[bool, bool]:
    """Returns (prefix_valid, complete_at_end)."""
    stack: list[str] = []  # '{' expecting key/value alternation, '[' items
    i = 0
    n = len(text)

    def skip_ws(j):
        while j < n and text[j] in _WS:
            j += 1
        return j

    # expectation machine: what token kind may come next
    # states: 'value', 'key', 'colon', 'comma_or_close', 'key_or_close',
    #         'value_or_close', 'end'
    expect = "value"
    i = skip_ws(i)
    if i == n:
        return True, False  # empty/ws-only: still a prefix

    def scan_string(j):
        """text[j] == '"'; returns (end_index_after_quote | n-if-truncated, ok)."""
        j += 1
        while j < n:
            c = text[j]
            if c == "\\":
                if j + 1 >= n:
                    return n, True  # truncated escape: prefix-valid
                nxt = text[j + 1]
                if nxt in '"\\/bfnrt':
                    j += 2
                elif nxt == "u":
                    hexpart = text[j + 2 : j + 6]
                    if any(ch not in "0123456789abcdefABCDEF" for ch in hexpart):
                        return j, False
                    if len(hexpart) < 4:
                        return n, True  # truncated \uXXXX
                    j += 6
                else:
                    return j, False
            elif c == '"':
                return j + 1, True
            elif ord(c) < 0x20:
                return j, False
            else:
                j += 1
        return n, True  # unterminated: prefix-valid

    def scan_number(j):
        """Returns index after the longest number-prefix starting at j, or -1."""
        start = j
        if j < n and text[j] == "-":
            j += 1
        if j < n and text[j] == "0":
            j += 1
        else:
            while j < n and text[j] in _DIGITS:
                j += 1
        if j == start or (text[start] == "-" and j == start + 1 and j >= n):
            return j if j >= n else -1 if j == start else j
        if j < n and text[j] == ".":
            j += 1
            while j < n and text[j] in _DIGITS:
                j += 1
        if j < n and text[j] in "eE":
            j += 1
            if j < n and text[j] in "+-":
                j += 1
            while j < n and text[j] in _DIGITS:
                j += 1
        return j

    while i < n:
        i = skip_ws(i)
        if i >= n:
            break
        c = text[i]
        if expect == "value" or expect == "value_or_close":
            if expect == "value_or_close" and c == "]":
                stack.pop()
                i += 1
                expect = "comma_or_close" if stack else "end"
                continue
            if c == "{":
                stack.append("{")
                i += 1
                expect = "key_or_close"
            elif c == "[":
                stack.append("[")
                i += 1
                expect = "value_or_close"
            elif c == '"':
                i, ok = scan_string(i)
                if not ok:
                    return False, False
                if i >= n:
                    return True, False
                expect = "comma_or_close" if stack else "end"
            elif c in "-0123456789":
                j = scan_number(i)
                if j == -1:
                    return False, False
                i = j
                if i >= n:
                    return True, False  # number may continue
                expect = "comma_or_close" if stack else "end"
            elif any(lit.startswith(text[i : i + len(lit)]) and
                     text[i : i + len(lit)] == lit[: min(len(lit), n - i)]
                     for lit in ("true", "false", "null")):
                for lit in ("true", "false", "null"):
                    if text[i : i + len(lit)] == lit:
                        i += len(lit)
                        expect = "comma_or_close" if stack else "end"
                        break
                    if text[i:n] == lit[: n - i]:
                        return True, False  # truncated literal
                else:
                    return False, False
            else:
                return False, False
        elif expect == "key_or_close" or expect == "key":
            if expect == "key_or_close" and c == "}":
                stack.pop()
                i += 1
                expect = "comma_or_close" if stack else "end"
                continue
            if c != '"':
                return False, False
            i, ok = scan_string(i)
            if not ok:
                return False, False
            if i >= n:
                return True, False
            expect = "colon"
        elif expect == "colon":
            if c != ":":
                return False, False
            i += 1
            expect = "value"
        elif expect == "comma_or_close":
            top = stack[-1] if stack else None
            if c == "," and top:
                i += 1
                expect = "key" if top == "{" else "value"
            elif c == "}" and top == "{":
                stack.pop()
                i += 1
                expect = "comma_or_close" if stack else "end"
            elif c == "]" and top == "[":
                stack.pop()
                i += 1
                expect = "comma_or_close" if stack else "end"
            else:
                return False, False
        elif expect == "end":
            return False, False  # trailing garbage
    complete = expect == "end" and not stack
    return True, complete
