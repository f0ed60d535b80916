"""Radix prefix cache over KV pages — the port's own copy of
``smg_tpu/engine/radix_cache.py``.

Sequences share KV pages at page granularity via a token radix tree.  Keys
are full-page token tuples (partial tail pages are never cached); nodes hold
one page each, a refcount (pages pinned by running requests can't be
evicted) and an LRU stamp.  The JAX package's KV-event emission (consumed by
the gateway's cache-aware routing) is not ported yet: nothing in this slice
subscribes to it.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field


@dataclass
class RadixNode:
    key: tuple[int, ...]
    page: int
    parent: "RadixNode | None"
    children: dict[tuple[int, ...], "RadixNode"] = field(default_factory=dict)
    refcount: int = 0
    last_access: int = 0

    @property
    def is_leaf(self) -> bool:
        return not self.children


class RadixCache:
    def __init__(self, page_size: int):
        self.page_size = page_size
        self.root = RadixNode(key=(), page=-1, parent=None)
        self._size = 0  # pages held by the tree
        self.evicted_pages = 0
        self._clock = itertools.count()

    @property
    def num_cached_pages(self) -> int:
        return self._size

    def _touch(self, node: RadixNode) -> None:
        node.last_access = next(self._clock)

    def match_prefix(self, tokens: list[int]) -> tuple[list[int], RadixNode]:
        """Longest cached prefix in full pages: (pages, deepest node).  Does
        NOT pin; call ``lock`` on the node to protect it from eviction."""
        node = self.root
        pages: list[int] = []
        ps = self.page_size
        for i in range(0, len(tokens) - ps + 1, ps):
            child = node.children.get(tuple(tokens[i : i + ps]))
            if child is None:
                break
            node = child
            self._touch(node)
            pages.append(node.page)
        return pages, node

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

    def insert(self, tokens: list[int], pages: list[int]) -> list[tuple[int, int]]:
        """Insert the full-page chains of ``tokens`` whose KV lives in
        ``pages``; ownership of inserted pages moves to the tree.  Returns
        ``(page_index, page)`` duplicates whose chain already existed (the
        caller frees the ones it owns)."""
        ps = self.page_size
        node = self.root
        dupes: list[tuple[int, int]] = []
        for i in range(0, len(tokens) - ps + 1, ps):
            pg_idx = i // ps
            if pg_idx >= len(pages):
                break
            key = tuple(tokens[i : i + ps])
            child = node.children.get(key)
            if child is not None:
                dupes.append((pg_idx, pages[pg_idx]))
            else:
                child = RadixNode(key=key, page=pages[pg_idx], parent=node)
                node.children[key] = child
                self._size += 1
            node = child
            self._touch(node)
        return dupes

    def evict(self, n_pages: int) -> list[int]:
        """Evict up to ``n_pages`` LRU unpinned leaves; returns freed pages."""
        freed: list[int] = []
        leaves = [n for n in self._iter_nodes() if n.is_leaf and n.refcount == 0]
        leaves.sort(key=lambda n: n.last_access)
        for leaf in leaves:
            if len(freed) >= n_pages:
                break
            node = leaf
            # walk up freeing chains that become evictable leaves
            while (node is not self.root and node.is_leaf and node.refcount == 0
                   and len(freed) < n_pages):
                parent = node.parent
                del parent.children[node.key]
                freed.append(node.page)
                self._size -= 1
                node = parent
        self.evicted_pages += len(freed)
        return freed

    def clear(self) -> list[int]:
        """Drop all unpinned pages (flush_cache).  Returns freed pages."""
        return self.evict(self._size)

    def lock_stats(self) -> dict:
        """Pins for the zero-leak audit: every pin belongs to a live
        request's ``radix_node``, so both numbers are zero at quiescence."""
        locked = [n.refcount for n in self._iter_nodes() if n.refcount]
        return {"locked_nodes": len(locked), "lock_refcounts": sum(locked)}

    def _iter_nodes(self):
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            yield n
