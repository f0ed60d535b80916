"""Incremental JSON completion: parse a JSON prefix by closing open scopes.

Reference: ``crates/tool_parser/src/partial_json.rs`` — used to surface tool
arguments while they stream.  ``parse_partial`` returns (value, consumed) for
the longest parseable prefix, completing unterminated strings/objects/arrays.

The port's copy of ``smg_tpu/parsers/partial_json.py``, unchanged but for its imports.
"""

from __future__ import annotations

import json


def complete_json(fragment: str) -> str | None:
    """Close any open strings/objects/arrays in a JSON prefix; None if the
    fragment can't be a JSON prefix."""
    stack: list[str] = []
    in_str = False
    escape = False
    for ch in fragment:
        if in_str:
            if escape:
                escape = False
            elif ch == "\\":
                escape = True
            elif ch == '"':
                in_str = False
            continue
        if ch == '"':
            in_str = True
        elif ch in "{[":
            stack.append("}" if ch == "{" else "]")
        elif ch in "}]":
            if not stack or stack[-1] != ch:
                return None
            stack.pop()
    out = fragment
    if escape:
        out = out[:-1]
    if in_str:
        out += '"'
    # trim dangling separators like `{"a": 1,` or `{"a":`
    trimmed = out.rstrip()
    while trimmed and trimmed[-1] in ",:":
        trimmed = trimmed[:-1].rstrip()
        out = trimmed
    return out + "".join(reversed(stack))


def parse_partial(fragment: str):
    """Best-effort parse of a JSON prefix.  Returns the value or None."""
    completed = complete_json(fragment)
    if completed is None:
        return None
    try:
        return json.loads(completed)
    except json.JSONDecodeError:
        # back off to the last brace/bracket boundary
        for cut in range(len(fragment) - 1, 0, -1):
            completed = complete_json(fragment[:cut])
            if completed is None:
                continue
            try:
                return json.loads(completed)
            except json.JSONDecodeError:
                continue
        return None
