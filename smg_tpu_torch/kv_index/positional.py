"""Event-driven positional KV index — the port's copy of
``smg_tpu/kv_index/positional.py``.

Reference: ``crates/kv_index/src/event_tree.rs:1-21`` — a map keyed by
``(position, content_hash)`` holding per-worker presence, fed by worker
``BlockStored``/``BlockRemoved`` events; queries jump-search the deepest
position at which a worker still holds the request's prefix.

The engine's block hashes form a rolling chain (parent hash + page tokens →
hash, ``smg_tpu_torch/engine/radix_cache.py``), so the gateway recomputes the same
chain over a request's tokens and probes which workers hold each depth.
"""

from __future__ import annotations

import hashlib
from collections import defaultdict

from smg_tpu_torch.protocols.events import AllBlocksCleared, BlockRemoved, BlockStored, KvEventBatch


def chain_hash(parent_hash: int, tokens: tuple[int, ...]) -> int:
    h = hashlib.blake2b(digest_size=8)
    h.update(parent_hash.to_bytes(8, "little", signed=False))
    for t in tokens:
        h.update(int(t).to_bytes(4, "little", signed=False))
    return int.from_bytes(h.digest(), "little")


class PositionalIndexer:
    def __init__(self, page_size: int = 16):
        self.page_size = page_size
        # block_hash -> set of worker ids holding it
        self._blocks: dict[int, set[str]] = defaultdict(set)
        # worker -> set of block hashes (for removal / worker eviction)
        self._worker_blocks: dict[str, set[int]] = defaultdict(set)
        # event accounting for the kv-index drift audit: how much churn the
        # gateway mirror has absorbed (vs what workers report via loads())
        self.num_batches_applied = 0
        self.num_blocks_stored = 0
        self.num_blocks_removed = 0
        self.num_clears = 0

    def apply_batch(self, worker_id: str, batch: KvEventBatch) -> None:
        self.num_batches_applied += 1
        for ev in batch.events:
            if isinstance(ev, BlockStored):
                for h in ev.block_hashes:
                    self._blocks[h].add(worker_id)
                    self._worker_blocks[worker_id].add(h)
                self.num_blocks_stored += len(ev.block_hashes)
            elif isinstance(ev, BlockRemoved):
                for h in ev.block_hashes:
                    s = self._blocks.get(h)
                    if s is not None:
                        s.discard(worker_id)
                        if not s:
                            self._blocks.pop(h, None)
                    self._worker_blocks[worker_id].discard(h)
                self.num_blocks_removed += len(ev.block_hashes)
            elif isinstance(ev, AllBlocksCleared):
                self.num_clears += 1
                self.remove_worker(worker_id)

    def remove_worker(self, worker_id: str) -> None:
        for h in self._worker_blocks.pop(worker_id, set()):
            s = self._blocks.get(h)
            if s is not None:
                s.discard(worker_id)
                if not s:
                    self._blocks.pop(h, None)

    def match(self, token_ids: list[int]) -> dict[str, int]:
        """Per-worker matched prefix length (in tokens) for this request.

        Jump-search (reference: positional jump-search, event_tree.rs):
        block chains are prefix-monotone — a worker holding depth ``d``
        holds every shallower depth — so the deepest any-worker depth D* is
        found by galloping + binary search with hashes computed LAZILY
        (most requests match shallowly or not at all, so the rolling chain
        is hashed to ~2·D* pages, not the whole prompt), and each worker's
        exact depth is then a binary search over set membership.  Cost:
        O(D*) hashing + O(W·log D*) lookups vs the old O(n_pages·W) walk.
        """
        ps = self.page_size
        n_pages = len(token_ids) // ps
        if n_pages == 0 or not self._blocks:
            return {}
        hashes: list[int] = []

        def hash_at(depth: int) -> int:  # 1-based; extends the chain lazily
            while len(hashes) < depth:
                i = len(hashes)
                parent = hashes[-1] if hashes else 0
                hashes.append(
                    chain_hash(parent, tuple(token_ids[i * ps:(i + 1) * ps]))
                )
            return hashes[depth - 1]

        def nonempty(depth: int) -> bool:
            return bool(self._blocks.get(hash_at(depth)))

        if not nonempty(1):
            return {}
        # gallop for an upper bound on the deepest any-worker depth
        lo = 1
        probe = 2
        while probe <= n_pages and nonempty(probe):
            lo = probe
            probe *= 2
        hi = min(probe - 1, n_pages)
        # binary search the deepest nonempty depth in (lo, hi]
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if nonempty(mid):
                lo = mid
            else:
                hi = mid - 1
        deepest = lo
        # exact per-worker depth: binary search membership in the worker's
        # own block set (holders at depth 1 is the candidate superset)
        out: dict[str, int] = {}
        for w in self._blocks.get(hash_at(1), ()):
            blocks = self._worker_blocks.get(w, ())
            wlo, whi = 1, deepest
            while wlo < whi:
                mid = (wlo + whi + 1) // 2
                if hash_at(mid) in blocks:
                    wlo = mid
                else:
                    whi = mid - 1
            out[w] = wlo * ps
        return out

    def stats(self) -> dict:
        return {
            "blocks": len(self._blocks),
            "workers": len(self._worker_blocks),
            "per_worker_blocks": {
                w: len(s) for w, s in self._worker_blocks.items()
            },
            "batches_applied": self.num_batches_applied,
            "blocks_stored": self.num_blocks_stored,
            "blocks_removed": self.num_blocks_removed,
            "clears": self.num_clears,
            "page_size": self.page_size,
        }
