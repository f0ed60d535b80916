"""Harmony (gpt-oss) channel-based reasoning + tool-call parsing.

Reference: ``model_gateway/src/routers/grpc/harmony/parser.rs`` — gpt-oss
models emit a typed-channel stream instead of plain text:

    <|channel|>analysis<|message|>…thinking…<|end|>
    <|start|>assistant<|channel|>commentary to=functions.NAME <|constrain|>json
        <|message|>{json args}<|call|>
    <|start|>assistant<|channel|>final<|message|>…answer…<|return|>

Routing rules (mirroring the reference): the ``to=functions.*`` recipient is
checked FIRST — a functions recipient is a tool call regardless of channel
(the model sometimes emits tool calls on the analysis channel); otherwise the
``analysis`` channel is reasoning and ``final`` (or no channel) is user
content.

Two cooperating streaming parsers match the gateway's sequential
reasoning→tool pipeline: ``HarmonyReasoningParser`` splits reasoning from
content, passing tool frames through intact; ``HarmonyToolParser`` then
extracts the calls and strips residual control tokens (it also works
standalone on full Harmony text for the /parse endpoints).

The port's copy of ``smg_tpu/parsers/harmony.py``, unchanged but for its imports.
"""

from __future__ import annotations

import json

from smg_tpu_torch.parsers.partial_json import parse_partial
from smg_tpu_torch.parsers.reasoning import ReasoningDelta
from smg_tpu_torch.parsers.tools import (
    ParsedToolCall,
    ToolCallParser,
    ToolDelta,
    _json_args,
)

_HEADER_STARTS = ("<|channel|>", "<|start|>")
_TERMINATORS = ("<|end|>", "<|return|>", "<|call|>")
_ALL_MARKERS = _HEADER_STARTS + _TERMINATORS + ("<|message|>",)


def _earliest(buf: str, markers) -> tuple[int, str | None]:
    best, which = -1, None
    for m in markers:
        i = buf.find(m)
        if i != -1 and (best == -1 or i < best):
            best, which = i, m
    return best, which


def _partial_marker_holdback(buf: str, markers) -> int:
    """Longest suffix of ``buf`` that is a strict prefix of some marker."""
    maxlen = max(len(m) for m in markers)
    for k in range(min(maxlen - 1, len(buf)), 0, -1):
        tail = buf[-k:]
        if any(m.startswith(tail) for m in markers):
            return k
    return 0


class HarmonyReasoningParser:
    """Streaming channel splitter (ReasoningParser-compatible contract)."""

    name = "harmony"

    def __init__(self):
        self._buf = ""
        self._route = "content"  # content | reasoning | tool
        self._in_header = False
        self._header_prefix = ""

    def _route_for_header(self, header: str) -> str:
        if "to=functions." in header:
            return "tool"
        if "analysis" in header:
            return "reasoning"
        return "content"

    def _emit(self, piece: str, out: ReasoningDelta) -> None:
        if not piece:
            return
        if self._route == "reasoning":
            out.reasoning += piece
        else:  # content and tool frames both flow to content (tool parser next)
            out.content += piece

    def feed(self, text: str) -> ReasoningDelta:
        out = ReasoningDelta()
        self._buf += text
        while self._buf:
            if self._in_header:
                i = self._buf.find("<|message|>")
                if i == -1:
                    if len(self._buf) > 4096:  # runaway header: bail to content
                        self._in_header = False
                        self._route = "content"
                        continue
                    return out
                header = self._buf[:i]
                self._buf = self._buf[i + len("<|message|>"):]
                self._in_header = False
                self._route = self._route_for_header(header)
                if self._route == "tool":
                    # hand the full frame header to the tool parser
                    out.content += self._header_prefix + header + "<|message|>"
                continue
            idx, marker = _earliest(self._buf, _HEADER_STARTS + _TERMINATORS)
            if idx == -1:
                hold = _partial_marker_holdback(self._buf, _ALL_MARKERS)
                emit_len = len(self._buf) - hold
                self._emit(self._buf[:emit_len], out)
                self._buf = self._buf[emit_len:]
                return out
            self._emit(self._buf[:idx], out)
            self._buf = self._buf[idx + len(marker):]
            if marker in _HEADER_STARTS:
                self._in_header = True
                self._header_prefix = marker
            else:  # terminator
                if self._route == "tool":
                    out.content += marker  # tool parser needs the frame close
                self._route = "content"
        return out

    def flush(self) -> ReasoningDelta:
        out = ReasoningDelta()
        if self._in_header:
            out.content += self._header_prefix + self._buf
        else:
            self._emit(self._buf, out)
        self._buf = ""
        self._in_header = False
        return out

    def parse_full(self, text: str) -> tuple[str, str]:
        d1 = self.feed(text)
        d2 = self.flush()
        return d1.content + d2.content, d1.reasoning + d2.reasoning


class HarmonyToolParser(ToolCallParser):
    """Extracts ``to=functions.NAME`` frames as calls; consumes residual
    Harmony control tokens from the text stream."""

    name = "harmony"
    start_markers = _HEADER_STARTS + _TERMINATORS

    def _try_extract(self, buf):
        for tok in _TERMINATORS:
            if buf.startswith(tok):
                return [], buf[len(tok):], True
        # header frame: <|channel|>HEADER<|message|> or <|start|>…<|message|>
        for start in _HEADER_STARTS:
            if buf.startswith(start):
                i = buf.find("<|message|>")
                if i == -1:
                    return [], buf, False
                header = buf[len(start): i]
                body_start = i + len("<|message|>")
                # name ends at whitespace OR the next <|...|> control token
                # (gpt-oss sometimes emits the recipient with no trailing space)
                name = ""
                if "to=functions." in header:
                    raw = header.split("to=functions.", 1)[1].split("<|")[0].strip()
                    name = raw.split()[0] if raw.split() else ""
                if not name:
                    # non-tool (or nameless) header: consume; body flows as text
                    return [], buf[body_start:], True
                # tool body ends at <|call|> (or any next marker as fallback)
                end, marker = _earliest(buf[body_start:], _ALL_MARKERS)
                if end == -1:
                    return [], buf, False
                raw = buf[body_start: body_start + end].strip()
                rest = buf[body_start + end:]
                if marker == "<|call|>":
                    rest = rest[len("<|call|>"):]
                try:
                    args = json.loads(raw)
                except ValueError:
                    args = parse_partial(raw)
                if not isinstance(args, dict):
                    args = {"value": args} if args is not None else {}
                return (
                    [ParsedToolCall(name=name, arguments=_json_args(args))],
                    rest,
                    True,
                )
        return [], buf, True  # unreachable: marker always matched

    def flush(self) -> ToolDelta:
        out = ToolDelta()
        if self._in_call:
            calls, rest, _done = self._try_extract(self._buf + "<|end|>")
            if calls:
                for c in calls:
                    c.index = self._n_emitted
                    self._n_emitted += 1
                out.calls.extend(calls)
            else:
                out.normal_text += self._buf
        else:
            out.normal_text += self._buf
        self._buf = ""
        self._in_call = False
        return out
