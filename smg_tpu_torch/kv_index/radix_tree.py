"""Approximate multi-tenant radix tree (gateway side) — the port's copy of
``smg_tpu/kv_index/radix_tree.py``.

Reference: ``crates/kv_index/src/{string_tree,token_tree}.rs`` — one tree per
model, nodes tagged with the set of workers that have routed through them,
LRU-evicted beyond ``max_size``.  Generic over element type so it serves as
both StringTree (chars) and TokenTree (token ids).

Used by the ``cache_aware`` policy in approximate mode: on routing, the chosen
worker's id is inserted along the request's prefix; future requests match
their prefix against the tree to find the worker with the longest overlap
(``model_gateway/src/policies/cache_aware.rs:1-41``).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field


@dataclass
class _Node:
    key: tuple = ()
    children: dict = field(default_factory=dict)  # first element -> node
    workers: dict = field(default_factory=dict)  # worker_id -> last_access tick
    parent: "_Node | None" = None


class RadixTree:
    """Compressed radix tree over sequences (str or list[int])."""

    def __init__(self, max_size: int = 2**20):
        self.root = _Node()
        self.max_size = max_size  # total elements stored
        self._size = 0
        self._clock = itertools.count()
        self.num_nodes = 0  # non-root nodes
        self.num_evicted_elements = 0

    def _tick(self) -> int:
        return next(self._clock)

    def stats(self) -> dict:
        """Index accountability snapshot (/debug/kv_index, cache gauges)."""
        return {
            "elements": self._size,
            "nodes": self.num_nodes,
            "evicted_elements": self.num_evicted_elements,
            "max_size": self.max_size,
        }

    def insert(self, seq, worker_id: str) -> None:
        seq = tuple(seq)
        tick = self._tick()
        node = self.root
        node.workers[worker_id] = tick
        i = 0
        while i < len(seq):
            head = seq[i]
            child = node.children.get(head)
            if child is None:
                new = _Node(key=seq[i:], parent=node)
                new.workers[worker_id] = tick
                node.children[head] = new
                self._size += len(new.key)
                self.num_nodes += 1
                break
            # find common prefix length with child.key
            k = child.key
            n = min(len(k), len(seq) - i)
            p = 0
            while p < n and k[p] == seq[i + p]:
                p += 1
            if p < len(k):
                # split child at p
                mid = _Node(key=k[:p], parent=node)
                child.key = k[p:]
                child.parent = mid
                mid.children[child.key[0]] = child
                mid.workers = dict(child.workers)
                node.children[head] = mid
                child = mid
                self.num_nodes += 1
            child.workers[worker_id] = tick
            node = child
            i += p
        if self._size > self.max_size:
            self.evict(self._size - self.max_size)

    def prefix_match(self, seq) -> dict[str, int]:
        """Per-worker longest shared-prefix length with ``seq``."""
        seq = tuple(seq)
        out: dict[str, int] = {}
        node = self.root
        i = 0
        while i < len(seq):
            child = node.children.get(seq[i])
            if child is None:
                break
            k = child.key
            n = min(len(k), len(seq) - i)
            p = 0
            while p < n and k[p] == seq[i + p]:
                p += 1
            matched = i + p
            for w in child.workers:
                out[w] = matched
            if p < len(k):
                break
            node = child
            i = matched
        return out

    def remove_worker(self, worker_id: str) -> None:
        stack = [self.root]
        while stack:
            n = stack.pop()
            n.workers.pop(worker_id, None)
            stack.extend(n.children.values())

    def evict(self, n_elements: int) -> None:
        """LRU-evict leaves until ``n_elements`` freed.  Single tree scan; a
        removed leaf's parent becomes the only new candidate, pushed back into
        the heap (avoids re-scanning the tree per eviction)."""
        import heapq

        heap = [
            (max(n.workers.values(), default=-1), id(n), n)
            for n in self._iter_nodes()
            if not n.children
        ]
        heapq.heapify(heap)
        freed = 0
        while freed < n_elements and heap:
            _, _, victim = heapq.heappop(heap)
            if victim.children:  # became internal since scan (shouldn't happen)
                continue
            parent = victim.parent
            if parent is None:
                continue
            del parent.children[victim.key[0]]
            freed += len(victim.key)
            self._size -= len(victim.key)
            self.num_nodes -= 1
            self.num_evicted_elements += len(victim.key)
            if parent is not self.root and not parent.children:
                heapq.heappush(
                    heap, (max(parent.workers.values(), default=-1), id(parent), parent)
                )

    def _iter_nodes(self):
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            yield n
