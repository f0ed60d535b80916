"""Multi-tenant token-bucket rate limiting + concurrency caps.

Reference: ``model_gateway/src/rate_limit/`` — per-tenant token buckets with
capacity ``max_concurrent_requests`` and refill ``rate_limit_tokens_per_second``
(SURVEY.md §2.1).

The port's copy of ``smg_tpu/gateway/rate_limit.py``, unchanged but for its imports.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass


@dataclass
class RateLimitConfig:
    capacity: float = 256.0  # burst size
    refill_per_sec: float = 0.0  # 0 = concurrency-only (no sustained limit)
    max_concurrent: int = 256


class TokenBucket:
    def __init__(self, capacity: float, refill_per_sec: float):
        self.capacity = capacity
        self.refill = refill_per_sec
        self._tokens = capacity
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def try_acquire(self, cost: float = 1.0) -> bool:
        with self._lock:
            now = time.monotonic()
            if self.refill > 0:
                self._tokens = min(self.capacity, self._tokens + (now - self._last) * self.refill)
            self._last = now
            if self._tokens >= cost:
                self._tokens -= cost
                return True
            return False

    def release(self, amount: float = 1.0) -> None:
        """Concurrency-mode return (refill == 0): finishing a request returns
        its slot."""
        if self.refill > 0:
            return
        with self._lock:
            self._tokens = min(self.capacity, self._tokens + amount)


class RateLimiter:
    """Per-tenant buckets with a default config; tenant id comes from auth or
    the X-Tenant-Id header (reference: tenant_resolution middleware).

    Two independent limits per tenant: a token bucket (burst + sustained rate
    when ``refill_per_sec`` > 0) and a hard in-flight cap (``max_concurrent``)
    enforced regardless of refill mode."""

    def __init__(self, default: RateLimitConfig | None = None):
        self.default = default or RateLimitConfig()
        self._buckets: dict[str, TokenBucket] = {}
        self._inflight: dict[str, int] = {}
        self._overrides: dict[str, RateLimitConfig] = {}
        self._lock = threading.Lock()

    def set_tenant_config(self, tenant: str, config: RateLimitConfig) -> None:
        with self._lock:
            self._overrides[tenant] = config
            self._buckets.pop(tenant, None)

    def _cfg(self, tenant: str) -> RateLimitConfig:
        return self._overrides.get(tenant, self.default)

    def _bucket(self, tenant: str) -> TokenBucket:
        with self._lock:
            b = self._buckets.get(tenant)
            if b is None:
                cfg = self._cfg(tenant)
                b = TokenBucket(cfg.capacity, cfg.refill_per_sec)
                self._buckets[tenant] = b
            return b

    def try_acquire(self, tenant: str = "default", cost: float = 1.0) -> bool:
        with self._lock:
            if self._inflight.get(tenant, 0) >= self._cfg(tenant).max_concurrent:
                return False
        if not self._bucket(tenant).try_acquire(cost):
            return False
        with self._lock:
            self._inflight[tenant] = self._inflight.get(tenant, 0) + 1
        return True

    def release(self, tenant: str = "default", amount: float = 1.0) -> None:
        with self._lock:
            self._inflight[tenant] = max(0, self._inflight.get(tenant, 0) - 1)
        self._bucket(tenant).release(amount)
