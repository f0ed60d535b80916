"""Radix prefix cache over KV pages, with KV-event emission — the port's copy
of ``smg_tpu/engine/radix_cache.py`` (same chain hashes and event sequence).

The engine-side twin of the gateway's cache index: sequences share KV pages at
page granularity via a token radix tree.  On insert/evict the cache emits
``BlockStored``/``BlockRemoved`` events with a rolling hash chain — exactly
what the gateway's ``PositionalIndexer`` consumes for cache-aware routing
(reference: ``crates/kv_index/src/event_tree.rs:1-21``, events wire shape
``crates/grpc_client/proto/common.proto:19-63``).

Tree keys are full-page token tuples (page_size tokens); partial tail pages
are never cached.  Nodes hold one page each, a refcount (pages pinned by
running requests can't be evicted) and an LRU stamp.
"""

from __future__ import annotations

import hashlib
import itertools
from dataclasses import dataclass, field
from typing import Callable

from smg_tpu_torch.protocols.events import AllBlocksCleared, BlockRemoved, BlockStored, KvEvent


def _chain_hash(parent_hash: int, tokens: tuple[int, ...],
                extra_key: int = 0) -> int:
    h = hashlib.blake2b(digest_size=8)
    h.update(parent_hash.to_bytes(8, "little", signed=False))
    for t in tokens:
        h.update(int(t).to_bytes(4, "little", signed=False))
    if extra_key:
        # multimodal content salt (reference: mm extra keys in block hashes —
        # same token ids, different pixels, different chain)
        h.update(int(extra_key).to_bytes(8, "little", signed=False))
    return int.from_bytes(h.digest(), "little")


@dataclass
class RadixNode:
    key: tuple[int, ...]
    page: int
    parent: "RadixNode | None"
    block_hash: int
    children: dict[tuple[int, ...], "RadixNode"] = field(default_factory=dict)
    refcount: int = 0
    last_access: float = 0.0

    @property
    def is_leaf(self) -> bool:
        return not self.children


class RadixCache:
    def __init__(self, page_size: int, event_sink: Callable[[KvEvent], None] | None = None):
        self.page_size = page_size
        self.root = RadixNode(key=(), page=-1, parent=None, block_hash=0)
        self._size = 0  # pages held by the tree
        # cumulative eviction count (LRU evict + clear) — the cache is the
        # single authority on what left the tree; hit/miss accounting lives
        # in the scheduler (admission-time) because match_prefix re-probes
        # back-pressured requests every step
        self.evicted_pages = 0
        self._event_sink = event_sink
        self._clock = itertools.count()

    @property
    def num_cached_pages(self) -> int:
        return self._size

    def _touch(self, node: RadixNode) -> None:
        node.last_access = next(self._clock)

    def _emit(self, ev: KvEvent) -> None:
        if self._event_sink is not None:
            self._event_sink(ev)

    # ---- lookup ----

    @staticmethod
    def _page_key(tokens: list[int], i: int, ps: int,
                  extra_keys: "list[int] | None") -> tuple:
        """Tree key for the page starting at token ``i``.  Pages overlapped
        by multimodal content append a content-hash salt so identical
        placeholder token runs with different pixels never alias
        (reference: mm extra keys); text-only pages keep the bare tuple so
        existing chains and hashes are unchanged."""
        key = tuple(tokens[i : i + ps])
        extra = extra_keys[i // ps] if extra_keys and i // ps < len(extra_keys) else 0
        if extra:
            return key + (("mm", extra),)
        return key

    def match_prefix(
        self, tokens: list[int], extra_keys: "list[int] | None" = None
    ) -> tuple[list[int], RadixNode]:
        """Longest cached prefix in full pages.  Returns (pages, deepest node).
        Does NOT pin; call ``lock`` on the node to protect from eviction."""
        node = self.root
        pages: list[int] = []
        ps = self.page_size
        for i in range(0, len(tokens) - ps + 1, ps):
            key = self._page_key(tokens, i, ps, extra_keys)
            child = node.children.get(key)
            if child is None:
                break
            node = child
            self._touch(node)
            pages.append(node.page)
        return pages, node

    # ---- pinning ----

    def lock(self, node: RadixNode) -> None:
        while node is not self.root and node is not None:
            node.refcount += 1
            node = node.parent

    def unlock(self, node: RadixNode) -> None:
        while node is not self.root and node is not None:
            node.refcount -= 1
            if node.refcount < 0:
                raise RuntimeError("radix cache refcount underflow")
            node = node.parent

    # ---- insert ----

    def insert(
        self, tokens: list[int], pages: list[int],
        extra_keys: "list[int] | None" = None,
    ) -> list[tuple[int, int]]:
        """Insert the full-page chains of ``tokens`` whose KV lives in ``pages``
        (pages[i] holds tokens[i*ps:(i+1)*ps]).  Ownership of inserted pages
        moves to the tree.  Returns ``(page_index, page)`` duplicates whose
        chain already existed (the caller frees the ones it owns — e.g. two
        requests computed the same prefix concurrently; indices below the
        caller's shared-prefix count are the tree's own pages).
        ``extra_keys`` (per page, 0 = none) carry mm content salts."""
        ps = self.page_size
        node = self.root
        dupes: list[tuple[int, int]] = []
        stored_hashes: list[int] = []
        stored_tokens: list[int] = []
        parent_hash_for_event: int | None = None
        for i in range(0, len(tokens) - ps + 1, ps):
            pg_idx = i // ps
            if pg_idx >= len(pages):
                break
            page_tokens = tuple(tokens[i : i + ps])
            extra = (extra_keys[pg_idx]
                     if extra_keys and pg_idx < len(extra_keys) else 0)
            key = self._page_key(tokens, i, ps, extra_keys)
            child = node.children.get(key)
            if child is not None:
                dupes.append((pg_idx, pages[pg_idx]))
                node = child
                self._touch(node)
                continue
            block_hash = _chain_hash(node.block_hash, page_tokens, extra)
            child = RadixNode(
                key=key, page=pages[pg_idx], parent=node, block_hash=block_hash
            )
            node.children[key] = child
            self._size += 1
            if not stored_hashes:
                parent_hash_for_event = node.block_hash if node is not self.root else None
            stored_hashes.append(block_hash)
            stored_tokens.extend(page_tokens)
            node = child
            self._touch(node)
        if stored_hashes:
            self._emit(
                BlockStored(
                    block_hashes=stored_hashes,
                    token_ids=stored_tokens,
                    parent_block_hash=parent_hash_for_event,
                    block_size=ps,
                )
            )
        return dupes

    # ---- eviction ----

    def evict(self, n_pages: int) -> list[int]:
        """Evict up to ``n_pages`` LRU unpinned leaves.  Returns freed page ids
        (caller returns them to the PagePool)."""
        freed: list[int] = []
        removed_hashes: list[int] = []
        # collect evictable leaves, oldest first
        leaves = [
            n for n in self._iter_nodes() if n.is_leaf and n.refcount == 0
        ]
        leaves.sort(key=lambda n: n.last_access)
        for leaf in leaves:
            if len(freed) >= n_pages:
                break
            node = leaf
            # walk up freeing chains that become evictable leaves
            while (
                node is not self.root
                and node.is_leaf
                and node.refcount == 0
                and len(freed) < n_pages
            ):
                parent = node.parent
                del parent.children[node.key]
                freed.append(node.page)
                removed_hashes.append(node.block_hash)
                self._size -= 1
                node = parent
        if removed_hashes:
            self._emit(BlockRemoved(block_hashes=removed_hashes))
        self.evicted_pages += len(freed)
        return freed

    def clear(self) -> list[int]:
        """Drop all unpinned pages (flush_cache).  Returns freed pages."""
        freed = self.evict(self._size)
        self._emit(AllBlocksCleared())
        return freed

    def _iter_nodes(self):
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            yield n

    # ---- stats ----

    def stats(self) -> dict:
        return {"cached_pages": self._size, "evicted_pages": self.evicted_pages}

    def lock_stats(self) -> dict:
        """Pin accounting for the zero-leak quiescence audit
        (``Scheduler.audit``): how many nodes are refcount-pinned and the
        total refcount across them.  Every pin belongs to a live request's
        ``radix_node`` lock — at quiescence both numbers must be zero, or a
        release path leaked a ``lock`` without its ``unlock``.  O(tree
        nodes): ops-plane (``loads()`` / ``/scheduler``), not the step loop.
        """
        locked_nodes = 0
        lock_refcounts = 0
        for node in self._iter_nodes():
            if node.refcount:
                locked_nodes += 1
                lock_refcounts += node.refcount
        return {"locked_nodes": locked_nodes, "lock_refcounts": lock_refcounts}
