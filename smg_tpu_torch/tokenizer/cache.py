"""L1 prefix cache: special-token-boundary tokenization reuse — the port's
copy of ``smg_tpu/tokenizer/cache.py``.  Special tokens are atomic
in BPE tokenizers (``special: true, normalized: false``), so positions
immediately after a special token are the only split points where
``tokenize(prefix) + tokenize(suffix) == tokenize(prefix + suffix)`` is
guaranteed.  Chat prompts share long special-delimited prefixes (system
prompt + few-shot turns), so caching the prefix tokens turns an O(prompt)
re-tokenization into O(suffix).

The registry's L0 (exact-string LRU) sits in front; L1 catches the misses
where only the user turn changed.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict


def find_boundaries(text: str, special_tokens: list[str]) -> list[int]:
    """Positions immediately after each special-token occurrence, ascending.
    Only special tokens — no whitespace fallback (better to skip caching
    than to corrupt a tokenization; reference l1.rs:60-66)."""
    if not special_tokens:
        return []
    out: set[int] = set()
    for s in special_tokens:
        start = 0
        while True:
            p = text.find(s, start)
            if p == -1:
                break
            out.add(p + len(s))
            start = p + 1
    return sorted(out)


class L1PrefixCache:
    """Longest-prefix lookup over blake2-hashed prefixes at special-token
    boundaries.  Thread-safe; LRU-bounded."""

    def __init__(self, special_tokens: list[str], max_entries: int = 1024,
                 min_prefix_chars: int = 16):
        self.special_tokens = [s for s in special_tokens if s]
        self.max_entries = max_entries
        self.min_prefix_chars = min_prefix_chars
        self._entries: OrderedDict[bytes, tuple[int, list[int]]] = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    @property
    def active(self) -> bool:
        return bool(self.special_tokens)

    @staticmethod
    def _digest(text: str, end: int) -> bytes:
        return hashlib.blake2b(text[:end].encode(), digest_size=16).digest()

    def lookup(self, text: str) -> tuple[list[int], int] | None:
        """Longest cached prefix of ``text`` -> (prefix_tokens, char_len)."""
        boundaries = find_boundaries(text, self.special_tokens)
        with self._lock:
            for end in reversed(boundaries):
                if end < self.min_prefix_chars:
                    break
                key = self._digest(text, end)
                hit = self._entries.get(key)
                if hit is not None and hit[0] == end:
                    self._entries.move_to_end(key)
                    self.hits += 1
                    return list(hit[1]), end
            self.misses += 1
        return None

    def seed(self, text: str, encode, full_ids: "list[int] | None" = None) -> None:
        """On a miss: cache the longest boundary prefix (one extra encode —
        amortized away by subsequent hits on the shared prefix).

        When ``full_ids`` (the whole text's tokenization) is provided, the
        splice guarantee is verified once: if
        ``encode(prefix) + encode(suffix) != full_ids`` this tokenizer's
        normalizer breaks boundary atomicity and the cache disables itself
        rather than ever serving a corrupted tokenization."""
        boundaries = [
            b for b in find_boundaries(text, self.special_tokens)
            if b >= self.min_prefix_chars
        ]
        if not boundaries:
            return
        end = boundaries[-1]
        key = self._digest(text, end)
        with self._lock:
            if key in self._entries:
                return
        tokens = list(encode(text[:end]))
        if full_ids is not None:
            if tokens + list(encode(text[end:])) != list(full_ids):
                self.special_tokens = []  # poison: boundaries aren't safe
                with self._lock:
                    self._entries.clear()
                return
        with self._lock:
            self._entries[key] = (end, tokens)
            self._entries.move_to_end(key)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "hits": self.hits,
                "misses": self.misses,
            }
