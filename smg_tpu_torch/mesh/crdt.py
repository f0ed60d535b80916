"""CRDT state: last-writer-wins map with (epoch, node_id) version vectors —
the port's copy of ``smg_tpu/mesh/crdt.py``.

Reference: ``crates/mesh`` CRDT KV (epoch-count merge, operation log).  Used
to replicate worker-registry state between gateway peers: concurrent updates
converge because merge is commutative/associative/idempotent.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class Version:
    epoch: int
    node_id: str  # tiebreak for concurrent epochs

    def __lt__(self, other: "Version") -> bool:
        return (self.epoch, self.node_id) < (other.epoch, other.node_id)


@dataclass
class Entry:
    value: Any
    version: Version
    tombstone: bool = False


class LwwMap:
    """Last-writer-wins map.  ``delta_since`` + ``merge`` implement gossip
    anti-entropy; deletes are tombstoned so they propagate."""

    def __init__(self, node_id: str):
        self.node_id = node_id
        self._data: dict[str, Entry] = {}
        self._epoch = 0
        self._lock = threading.Lock()
        self._listeners: list = []

    def set(self, key: str, value: Any) -> None:
        with self._lock:
            self._epoch += 1
            self._data[key] = Entry(value, Version(self._epoch, self.node_id))
        self._notify(key, value, False)

    def delete(self, key: str) -> None:
        with self._lock:
            self._epoch += 1
            self._data[key] = Entry(None, Version(self._epoch, self.node_id), tombstone=True)
        self._notify(key, None, True)

    def get(self, key: str) -> Any | None:
        with self._lock:
            e = self._data.get(key)
            return None if e is None or e.tombstone else e.value

    def items(self) -> dict[str, Any]:
        with self._lock:
            return {k: e.value for k, e in self._data.items() if not e.tombstone}

    def snapshot(self) -> list[tuple]:
        """Wire form: [(key, value, epoch, node_id, tombstone), ...]."""
        with self._lock:
            return [
                (k, e.value, e.version.epoch, e.version.node_id, e.tombstone)
                for k, e in self._data.items()
            ]

    def merge(self, snapshot: list[tuple]) -> list[str]:
        """Merge a peer snapshot; returns keys that changed locally."""
        changed = []
        notifications = []
        with self._lock:
            for k, value, epoch, node_id, tombstone in snapshot:
                incoming = Version(epoch, node_id)
                cur = self._data.get(k)
                if cur is None or cur.version < incoming:
                    self._data[k] = Entry(value, incoming, tombstone)
                    self._epoch = max(self._epoch, epoch)
                    changed.append(k)
                    notifications.append((k, value, tombstone))
        for k, value, tombstone in notifications:
            self._notify(k, value, tombstone)
        return changed

    def on_change(self, cb) -> None:
        """cb(key, value, deleted)"""
        self._listeners.append(cb)

    def _notify(self, key, value, deleted) -> None:
        for cb in self._listeners:
            try:
                cb(key, value, deleted)
            except Exception:
                pass
