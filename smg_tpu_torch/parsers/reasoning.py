"""Streaming reasoning-content extraction.

Reference: ``crates/reasoning_parser/src/parsers/`` — deepseek_r1, qwen3,
glm45, kimi, minimax, step3, nano_v3, cohere_cmd, inkling, passthrough
(SURVEY.md §2.2).  All tag-delimited families reduce to one streaming
machine parameterized by (open_tag, close_tag, initial_in_reasoning);
model-name mapping mirrors the reference's factory.

The port's copy of ``smg_tpu/parsers/reasoning.py``, unchanged but for its imports.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class ReasoningDelta:
    content: str = ""
    reasoning: str = ""


class ReasoningParser:
    """Incremental splitter for <think>-style reasoning blocks.

    ``initial_in_reasoning`` covers models whose template pre-opens the think
    block (DeepSeek-R1, Qwen3-thinking render the opening tag in the prompt),
    so the stream starts inside reasoning.
    """

    name = "base"

    def __init__(
        self,
        open_tag: str = "<think>",
        close_tag: str = "</think>",
        initial_in_reasoning: bool = False,
        strip_leading_ws_after_close: bool = True,
    ):
        self.open_tag = open_tag
        self.close_tag = close_tag
        self.in_reasoning = initial_in_reasoning
        self.strip_after_close = strip_leading_ws_after_close
        self._buf = ""
        self._just_closed = False

    def _holdback(self) -> int:
        tag = self.close_tag if self.in_reasoning else self.open_tag
        return len(tag) - 1

    def feed(self, text: str) -> ReasoningDelta:
        self._buf += text
        out = ReasoningDelta()
        while True:
            tag = self.close_tag if self.in_reasoning else self.open_tag
            idx = self._buf.find(tag)
            if idx == -1:
                break
            piece = self._buf[:idx]
            self._emit(piece, out)
            self._buf = self._buf[idx + len(tag):]
            self.in_reasoning = not self.in_reasoning
            self._just_closed = not self.in_reasoning
        hold = self._holdback()
        # keep a tail that could be a tag prefix
        emit_len = len(self._buf)
        for k in range(min(hold, len(self._buf)), 0, -1):
            tag = self.close_tag if self.in_reasoning else self.open_tag
            if tag.startswith(self._buf[-k:]):
                emit_len = len(self._buf) - k
                break
        self._emit(self._buf[:emit_len], out)
        self._buf = self._buf[emit_len:]
        return out

    def _emit(self, piece: str, out: ReasoningDelta) -> None:
        if not piece:
            return
        if self.in_reasoning:
            out.reasoning += piece
        else:
            if self._just_closed and self.strip_after_close:
                piece = piece.lstrip("\n")
                if not piece:
                    return
                self._just_closed = False
            out.content += piece

    def flush(self) -> ReasoningDelta:
        out = ReasoningDelta()
        self._emit(self._buf, out)
        self._buf = ""
        return out

    def parse_full(self, text: str) -> tuple[str, str]:
        """Non-streaming convenience: returns (content, reasoning)."""
        d1 = self.feed(text)
        d2 = self.flush()
        return d1.content + d2.content, d1.reasoning + d2.reasoning


class PassthroughReasoningParser(ReasoningParser):
    name = "passthrough"

    def __init__(self):
        super().__init__()

    def feed(self, text: str) -> ReasoningDelta:
        return ReasoningDelta(content=text)

    def flush(self) -> ReasoningDelta:
        return ReasoningDelta()


# family -> (open, close, initial_in_reasoning)
_FAMILIES: dict[str, tuple[str, str, bool]] = {
    "deepseek_r1": ("<think>", "</think>", True),
    "deepseek_v3": ("<think>", "</think>", False),
    "qwen3": ("<think>", "</think>", False),
    "qwen3_thinking": ("<think>", "</think>", True),
    "glm45": ("<think>", "</think>", False),
    "kimi": ("◁think▷", "◁/think▷", False),
    "minimax": ("<think>", "</think>", True),
    "step3": ("<think>", "</think>", True),
    "nano_v3": ("<think>", "</think>", False),
    "cohere_cmd": ("<|START_THINKING|>", "<|END_THINKING|>", False),
    "inkling": ("<think>", "</think>", True),
}

# model-name substring -> family (mirrors the reference factory's mapping)
_MODEL_MAP = [
    ("deepseek-r1", "deepseek_r1"),
    ("deepseek-v3", "deepseek_v3"),
    ("qwen3-thinking", "qwen3_thinking"),
    ("qwen3", "qwen3"),
    ("qwq", "qwen3_thinking"),
    ("glm-4.5", "glm45"),
    ("glm4", "glm45"),
    ("kimi", "kimi"),
    ("minimax", "minimax"),
    ("step-3", "step3"),
    ("step3", "step3"),
    ("command-a", "cohere_cmd"),
    ("cohere", "cohere_cmd"),
]


def get_reasoning_parser(name_or_model: str | None) -> ReasoningParser:
    if not name_or_model or name_or_model == "passthrough":
        return PassthroughReasoningParser()
    key = name_or_model.lower()
    if key == "harmony" or "gpt-oss" in key:
        from smg_tpu_torch.parsers.harmony import HarmonyReasoningParser

        return HarmonyReasoningParser()
    if key in _FAMILIES:
        o, c, init = _FAMILIES[key]
        p = ReasoningParser(o, c, init)
        p.name = key
        return p
    for sub, fam in _MODEL_MAP:
        if sub in key:
            o, c, init = _FAMILIES[fam]
            p = ReasoningParser(o, c, init)
            p.name = fam
            return p
    return PassthroughReasoningParser()
