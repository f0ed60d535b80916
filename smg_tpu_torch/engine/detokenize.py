"""Incremental detokenization + stop-sequence handling — the port's own
copy of ``smg_tpu/engine/detokenize.py``.

Reference: the gateway's ``DecodeStream`` + ``StopSequenceDecoder``
(``crates/tokenizer/src/{stream,stop}.rs``, SURVEY.md §2.2) — per-token
incremental decode with holdback so stop strings spanning chunk boundaries are
caught and trimmed from the emitted text.
"""

from __future__ import annotations

REPLACEMENT_CHAR = "�"


class IncrementalDecoder:
    """Streams text from token ids using the offset-pair technique: decode is
    only emitted once it no longer ends in an incomplete UTF-8 sequence."""

    def __init__(self, tokenizer, skip_special_tokens: bool = True):
        self._tok = tokenizer
        self._skip = skip_special_tokens
        self.token_ids: list[int] = []
        self._prefix_offset = 0
        self._read_offset = 0

    def put(self, token_ids: list[int]) -> str:
        """Append token(s); return newly stabilized text (possibly "")."""
        self.token_ids.extend(token_ids)
        prefix = self._tok.decode(
            self.token_ids[self._prefix_offset : self._read_offset],
            skip_special_tokens=self._skip,
        )
        full = self._tok.decode(
            self.token_ids[self._prefix_offset :], skip_special_tokens=self._skip
        )
        if len(full) > len(prefix) and not full.endswith(REPLACEMENT_CHAR):
            delta = full[len(prefix) :]
            self._prefix_offset = self._read_offset
            self._read_offset = len(self.token_ids)
            return delta
        return ""

    def flush(self) -> str:
        """Emit whatever remains (end of stream)."""
        prefix = self._tok.decode(
            self.token_ids[self._prefix_offset : self._read_offset],
            skip_special_tokens=self._skip,
        )
        full = self._tok.decode(
            self.token_ids[self._prefix_offset :], skip_special_tokens=self._skip
        )
        self._prefix_offset = self._read_offset = len(self.token_ids)
        return full[len(prefix) :] if len(full) > len(prefix) else ""


class StopStringChecker:
    """Scans a text stream for stop strings with cross-chunk holdback.

    ``feed`` returns (emittable_text, stopped).  When a stop string is found
    the text before it is emitted and the stop string itself is swallowed
    (OpenAI semantics: stop sequence not included in output).
    """

    def __init__(self, stops: list[str]):
        self.stops = [s for s in stops if s]
        self._holdback = max((len(s) for s in self.stops), default=1) - 1
        self._buf = ""
        self.stopped = False
        self.matched: str | None = None

    def feed(self, text: str) -> tuple[str, bool]:
        if self.stopped:
            return "", True
        if not self.stops:
            return text, False
        self._buf += text
        earliest = -1
        for s in self.stops:
            i = self._buf.find(s)
            if i != -1 and (earliest == -1 or i < earliest):
                earliest = i
                self.matched = s
        if earliest != -1:
            self.stopped = True
            return self._buf[:earliest], True
        if self._holdback:
            emit = self._buf[: -self._holdback] if len(self._buf) > self._holdback else ""
            self._buf = self._buf[len(emit) :]
        else:
            emit, self._buf = self._buf, ""
        return emit, False

    def flush(self) -> str:
        """End of stream: release held-back text (no stop was found)."""
        if self.stopped:
            return ""
        out, self._buf = self._buf, ""
        return out
