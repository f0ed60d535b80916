"""Tokenizer registry with encode caching — the port's copy of
``smg_tpu/tokenizer/registry.py`` with its L0 tier: an LRU over exact text.
The L1 prefix tier (``smg_tpu/tokenizer/cache.py``) splits at special-token
boundaries, which only a tokenizer file declares; it waits with the HF
tokenizer.  Tokenize is on the gateway hot path (every chat request).
"""

from __future__ import annotations

import threading
from collections import OrderedDict


class TokenizerRegistry:
    def __init__(self, l0_cache_size: int = 4096):
        self._tokenizers: dict[str, object] = {}
        self._default: object | None = None
        self._lock = threading.Lock()
        self._cache: OrderedDict[tuple, list[int]] = OrderedDict()
        self._cache_size = l0_cache_size
        self.cache_hits = 0
        self.cache_misses = 0

    def register(self, model_id: str, tokenizer, default: bool = False) -> None:
        with self._lock:
            self._tokenizers[model_id] = tokenizer
            if default or self._default is None:
                self._default = tokenizer

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
        ids = tok.encode(text)
        with self._lock:
            self._cache[key] = list(ids)
            self._cache.move_to_end(key)
            while len(self._cache) > self._cache_size:
                self._cache.popitem(last=False)
        return ids
