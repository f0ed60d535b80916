"""Deterministic mock tokenizer — the port's copy of
``smg_tpu/tokenizer/mock.py``; serves text for preset models, which have no
tokenizer file.

Reference: ``crates/tokenizer/src/mock.rs`` (MockTokenizer used by all
gateway integration tests, SURVEY.md §4 tier 2).

Vocabulary: token id ``i`` <-> word ``w{i}``; unknown words hash stably into
the vocab.  Round-trips exactly for text made of ``w{i}`` words, which is what
the tests use.
"""

from __future__ import annotations

import hashlib


class MockTokenizer:
    def __init__(self, vocab_size: int = 512, eos_token_id: int = 0, bos_token_id: int = 1):
        self.vocab_size = vocab_size
        self.eos_token_id = eos_token_id
        self.bos_token_id = bos_token_id
        self.special_ids = {eos_token_id, bos_token_id}

    def encode(self, text: str, add_special_tokens: bool = False) -> list[int]:
        ids = []
        if add_special_tokens:
            ids.append(self.bos_token_id)
        for word in text.split():
            if word.startswith("w") and word[1:].isdigit():
                tid = int(word[1:]) % self.vocab_size
            else:
                digest = hashlib.blake2b(word.encode(), digest_size=4).digest()
                tid = int.from_bytes(digest, "little") % self.vocab_size
            ids.append(tid)
        return ids

    def decode(self, token_ids: list[int], skip_special_tokens: bool = True) -> str:
        words = []
        for t in token_ids:
            if skip_special_tokens and t in self.special_ids:
                continue
            words.append(f"w{int(t)}")
        return " ".join(words)

    def apply_chat_template(
        self, messages: list[dict], add_generation_prompt: bool = True, **_ignored
    ) -> str:
        parts = [f"[{m['role']}] {m.get('content') or ''}" for m in messages]
        if add_generation_prompt:
            parts.append("[assistant]")
        return " ".join(parts)
