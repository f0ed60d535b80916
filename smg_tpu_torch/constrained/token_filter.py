"""Vocab masking for constrained decoding.

Given a tokenizer and an acceptor (``accepts(text)`` / ``complete(text)``),
compute which token ids may extend the current output.  Piece strings are
decoded once and cached; masks are memoized by accepted-text so repeated
states (e.g. inside long strings) are cheap.
"""

from __future__ import annotations

import logging

import numpy as np

logger = logging.getLogger("smg_tpu_torch.constrained")

# piece tables depend only on (tokenizer, vocab_size) — shared across every
# filter (the engine keys filters per grammar PATTERN, and rebuilding a
# vocab-size decode table per pattern would duplicate work and memory).
# Entries hold a STRONG reference to the tokenizer: keying by id() alone
# would let a GC'd tokenizer's reused address serve another model's pieces.
_piece_tables: dict[tuple, tuple] = {}  # (id, vocab) -> (tokenizer, pieces)


class TokenFilter:
    def __init__(self, tokenizer, machine, vocab_size: int, eos_token_ids=()):
        self.tok = tokenizer
        self.machine = machine
        self.vocab_size = vocab_size
        self.eos_ids = set(eos_token_ids)
        self._mask_cache: dict[str, np.ndarray] = {}

    def _piece_table(self) -> list[str]:
        key = (id(self.tok), self.vocab_size)
        entry = _piece_tables.get(key)
        if entry is not None and entry[0] is self.tok:
            return entry[1]
        pieces = [
            self.tok.decode([t], skip_special_tokens=False)
            for t in range(self.vocab_size)
        ]
        if len(_piece_tables) >= 8:  # a handful of live tokenizers
            _piece_tables.pop(next(iter(_piece_tables)))
        _piece_tables[key] = (self.tok, pieces)
        return pieces

    def allowed_mask(self, text_so_far: str) -> np.ndarray:
        """Boolean [vocab] mask of tokens that keep the output prefix-valid.
        EOS allowed iff the document is already complete.

        Fast path: machines exposing the incremental interface
        (``prefix_state``/``accepts_from``) simulate the n-char prefix ONCE
        and extend per candidate piece — O(V·|piece|) instead of O(V·n)
        (regex NFA) / O(V·n²) (EBNF Earley) per step."""
        cached = self._mask_cache.get(text_so_far)
        if cached is not None:
            return cached
        pieces = self._piece_table()
        mask = np.zeros(self.vocab_size, bool)
        state = None
        incremental = hasattr(self.machine, "prefix_state")
        if incremental:
            state = self.machine.prefix_state(text_so_far)
            complete = state is not None and self.machine.complete_from(state)
        else:
            complete = self.machine.complete(text_so_far)
        for tid, piece in enumerate(pieces):
            if tid in self.eos_ids:
                mask[tid] = complete
            elif piece:
                if incremental:
                    mask[tid] = state is not None and self.machine.accepts_from(
                        state, piece
                    )
                else:
                    # once complete, only whitespace extensions remain valid
                    mask[tid] = self.machine.accepts(text_so_far + piece)
        if len(self._mask_cache) < 512:
            self._mask_cache[text_so_far] = mask
        return mask

    def is_finished(self, text_so_far: str) -> bool:
        return self.machine.complete(text_so_far)

    def text_of(self, output_ids) -> str:
        """Canonical generated-text view the acceptor sees (shared helper so
        the scheduler and tests decode identically)."""
        return self.tok.decode(list(output_ids), skip_special_tokens=True)
