"""Tokenizer registry with encode caching — the port's copy of
``smg_tpu/tokenizer/registry.py``.  L0: LRU over exact text (90% of wins).
L1: special-token-boundary prefix reuse — catches the L0 misses where only
the final user turn changed (``cache.py``).  Tokenize is on the gateway hot
path (every chat request).
"""

from __future__ import annotations

import threading
from collections import OrderedDict


class TokenizerRegistry:
    def __init__(self, l0_cache_size: int = 4096, l1_cache_size: int = 1024):
        self._tokenizers: dict[str, object] = {}
        self._default: object | None = None
        self._lock = threading.Lock()
        self._cache: OrderedDict[tuple, list[int]] = OrderedDict()
        self._cache_size = l0_cache_size
        self._l1_size = l1_cache_size
        self._l1: dict[int, object] = {}  # id(tokenizer) -> L1PrefixCache
        self.cache_hits = 0
        self.cache_misses = 0

    def register(self, model_id: str, tokenizer, default: bool = False) -> None:
        with self._lock:
            self._tokenizers[model_id] = tokenizer
            if default or self._default is None:
                self._default = tokenizer

    def _l1_for(self, tok):
        """Per-tokenizer L1 prefix cache, created on first use (None when
        the tokenizer declares no special tokens — no safe boundaries)."""
        from smg_tpu_torch.tokenizer.cache import L1PrefixCache

        key = id(tok)
        with self._lock:
            l1 = self._l1.get(key)
            if l1 is None:
                specials = list(getattr(tok, "all_special_tokens", []) or [])
                l1 = L1PrefixCache(specials, max_entries=self._l1_size)
                self._l1[key] = l1
        return l1 if l1.active else None

    def has(self, model_id: str) -> bool:
        """Exact registration check (``get`` falls back to the default)."""
        with self._lock:
            return model_id in self._tokenizers

    def get(self, model_id: str | None = None):
        with self._lock:
            if model_id and model_id in self._tokenizers:
                return self._tokenizers[model_id]
            return self._default

    def encode_cached(self, model_id: str | None, text: str) -> list[int]:
        tok = self.get(model_id)
        if tok is None:
            raise RuntimeError("no tokenizer registered")
        key = (model_id, text)
        with self._lock:
            ids = self._cache.get(key)
            if ids is not None:
                self._cache.move_to_end(key)
                self.cache_hits += 1
                return list(ids)
            self.cache_misses += 1
        # L0 miss: try the L1 prefix tier — shared chat prefix (system
        # prompt + history) re-tokenizes as O(suffix)
        l1 = self._l1_for(tok)
        if l1 is not None:
            hit = l1.lookup(text)
            if hit is not None:
                prefix_ids, end = hit
                ids = prefix_ids + tok.encode(text[end:])
            else:
                ids = tok.encode(text)
                l1.seed(text, tok.encode, full_ids=ids)
        else:
            ids = tok.encode(text)
        with self._lock:
            self._cache[key] = list(ids)
            self._cache.move_to_end(key)
            while len(self._cache) > self._cache_size:
                self._cache.popitem(last=False)
        return ids
