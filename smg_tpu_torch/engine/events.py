"""KV-event publishing: sequence-numbered batches with replayable history —
the port's copy of ``smg_tpu/engine/events.py``.

Reference: ``SubscribeKvEvents`` streaming RPC with ``start_sequence_number``
resume (``crates/grpc_client/proto/common.proto:19-29``) feeding the gateway's
``KvEventMonitor`` (SURVEY.md §3.5).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable

from smg_tpu_torch.protocols.events import KvEvent, KvEventBatch


class KvEventPublisher:
    def __init__(self, history: int = 4096, dp_rank: int = 0):
        self._seq = 0
        self._dp_rank = dp_rank
        self._history: deque[KvEventBatch] = deque(maxlen=history)
        self._pending: list[KvEvent] = []
        self._subscribers: list[Callable[[KvEventBatch], None]] = []
        self._lock = threading.Lock()

    def publish(self, event: KvEvent) -> None:
        """Buffer an event; batched out on ``flush`` (one batch per engine step)."""
        with self._lock:
            self._pending.append(event)

    def flush(self) -> KvEventBatch | None:
        with self._lock:
            if not self._pending:
                return None
            self._seq += 1
            batch = KvEventBatch(
                sequence_number=self._seq, events=self._pending, dp_rank=self._dp_rank
            )
            self._pending = []
            self._history.append(batch)
            subs = list(self._subscribers)
        for cb in subs:
            cb(batch)
        return batch

    def subscribe(
        self, callback: Callable[[KvEventBatch], None], start_sequence_number: int = 0
    ) -> Callable[[], None]:
        """Register a subscriber; replays history from ``start_sequence_number``
        first.  Returns an unsubscribe function."""
        with self._lock:
            replay = [b for b in self._history if b.sequence_number > start_sequence_number]
            self._subscribers.append(callback)
        for b in replay:
            callback(b)

        def unsubscribe():
            with self._lock:
                if callback in self._subscribers:
                    self._subscribers.remove(callback)

        return unsubscribe
