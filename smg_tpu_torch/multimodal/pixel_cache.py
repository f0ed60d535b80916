"""Host-DRAM LRU cache of preprocessed per-image encoder inputs — the port's
copy of ``smg_tpu/multimodal/pixel_cache.py``.

Reference: ``routers/grpc/multimodal/pixel_cache.rs`` — repeated images
(avatars, document pages re-sent every turn of a conversation) skip
fetch/decode/resize/normalize/patchify.  Keyed by the raw image-source
hash PLUS a processor fingerprint: the same bytes preprocess differently
under another model's geometry.  Disabled by default
(``SMG_MM_PIXEL_CACHE_MB`` unset / 0); bounded by estimated tensor bytes
with LRU eviction.
"""

from __future__ import annotations

import hashlib
import os
import threading
from collections import OrderedDict

import numpy as np

from smg_tpu_torch.utils import get_logger

logger = get_logger("multimodal.pixel_cache")


def image_source_hash(part: dict) -> str:
    """Stable digest of an image content part (url or inline data)."""
    import json

    return hashlib.blake2b(
        json.dumps(part, sort_keys=True, default=str).encode(), digest_size=16
    ).hexdigest()


def processor_fingerprint(proc) -> str:
    """Identity+geometry of a processor instance (same bytes, different
    config => different cache entry).  The device the processor runs on is
    not part of it: the fingerprint is the reference's, whatever the
    device."""
    cfg = {k: v for k, v in sorted(vars(proc).items())
           if k != "device" and isinstance(v, (int, float, str, bool, tuple))}
    return f"{type(proc).__name__}:{cfg}"


class PixelCache:
    def __init__(self, max_bytes: int):
        self.max_bytes = max_bytes
        self._items: OrderedDict[tuple, tuple] = OrderedDict()  # key -> (entry, nbytes)
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _entry_bytes(entry) -> int:
        pixel_values, grid, n_tokens, llm_grid = entry
        return int(np.asarray(pixel_values).nbytes) + 64

    def get(self, key: tuple):
        with self._lock:
            entry = self._items.get(key)
            if entry is None:
                self.misses += 1
                return None
            self._items.move_to_end(key)
            self.hits += 1
            return entry[0]

    def put(self, key: tuple, entry) -> None:
        nbytes = self._entry_bytes(entry)
        if nbytes > self.max_bytes:
            return
        with self._lock:
            old = self._items.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            self._items[key] = (entry, nbytes)
            self._bytes += nbytes
            while self._bytes > self.max_bytes and self._items:
                _, (_, freed) = self._items.popitem(last=False)
                self._bytes -= freed

    @property
    def size_bytes(self) -> int:
        # metric/debug surface, not a hot path: lock so the byte count never
        # reads mid-eviction (put() mutates _bytes several times per call)
        with self._lock:
            return self._bytes

    def stats(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "bytes": self._bytes, "items": len(self._items)}


_global: "PixelCache | None" = None
_global_lock = threading.Lock()


def get_pixel_cache() -> "PixelCache | None":
    """Process-wide cache sized by SMG_MM_PIXEL_CACHE_MB (0/unset = off)."""
    global _global
    with _global_lock:
        if _global is None:
            mb = int(os.environ.get("SMG_MM_PIXEL_CACHE_MB", "0") or 0)
            if mb <= 0:
                return None
            _global = PixelCache(mb * 2**20)
            logger.info("pixel cache enabled: %d MiB", mb)
        return _global
