"""Hash-based policies: consistent_hashing, prefix_hash — the port's copy of
``smg_tpu/policies/hashing.py``.

Reference: ``model_gateway/src/policies/{consistent_hashing,prefix_hash}.rs``.
"""

from __future__ import annotations

import bisect
import hashlib

from smg_tpu_torch.policies.base import Policy, register_policy


def _h(data: bytes) -> int:
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(), "little")


@register_policy
class ConsistentHashingPolicy(Policy):
    """Hash ring with virtual nodes; key = routing_key or request text.
    Stable under worker churn (``consistent_hashing.rs``, 533 LoC)."""

    name = "consistent_hashing"

    def __init__(self, vnodes: int = 160):
        self.vnodes = vnodes
        self._ring: list[tuple[int, str]] = []
        self._ring_workers: frozenset[str] = frozenset()

    def _rebuild(self, worker_ids: frozenset[str]) -> None:
        ring = []
        for wid in worker_ids:
            for v in range(self.vnodes):
                ring.append((_h(f"{wid}#{v}".encode()), wid))
        ring.sort()
        self._ring = ring
        self._ring_workers = worker_ids

    def select_worker(self, workers, ctx, decision=None):
        avail = self.available(workers)
        if not avail:
            return None
        ids = frozenset(w.worker_id for w in avail)
        if ids != self._ring_workers:
            self._rebuild(ids)
        key = ctx.routing_key or ctx.text or ""
        if not key and ctx.token_ids:
            key = ",".join(map(str, ctx.token_ids[:64]))
        point = _h(key.encode())
        idx = bisect.bisect(self._ring, (point, ""))
        if idx == len(self._ring):
            idx = 0
        wid = self._ring[idx][1]
        if decision is not None:
            decision.outcome = "hash_ring"
            decision.tie_break = f"vnode:{idx}"
        return next(w for w in avail if w.worker_id == wid)


@register_policy
class PrefixHashPolicy(Policy):
    """Hash the first ``prefix_len`` tokens/chars so shared-prefix requests
    co-locate (cheap cache affinity without state — ``prefix_hash.rs``)."""

    name = "prefix_hash"

    def __init__(self, prefix_tokens: int = 256):
        self.prefix_tokens = prefix_tokens

    def select_worker(self, workers, ctx, decision=None):
        avail = self.available(workers)
        if not avail:
            return None
        if ctx.token_ids:
            key = b"".join(int(t).to_bytes(4, "little") for t in ctx.token_ids[: self.prefix_tokens])
        else:
            key = (ctx.text or "")[: self.prefix_tokens * 4].encode()
        if decision is not None:
            decision.outcome = "prefix_hash"
        return avail[_h(key) % len(avail)]
