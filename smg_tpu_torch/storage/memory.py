"""In-memory storage backend (reference: ``data_connector/src/memory.rs``).

The port's copy of ``smg_tpu/storage/memory.py``, unchanged but for its
imports.
"""

from __future__ import annotations

import threading

from smg_tpu_torch.storage.core import (
    Conversation,
    ConversationItem,
    ConversationItemStorage,
    ConversationStorage,
    ResponseStorage,
    StoredResponse,
)


class MemoryStorage(ConversationStorage, ConversationItemStorage, ResponseStorage):
    def __init__(self):
        self._convs: dict[str, Conversation] = {}
        self._items: dict[str, list[ConversationItem]] = {}
        self._responses: dict[str, StoredResponse] = {}
        self._lock = threading.Lock()

    async def create_conversation(self, metadata=None) -> Conversation:
        conv = Conversation(metadata=metadata or {})
        with self._lock:
            self._convs[conv.id] = conv
            self._items[conv.id] = []
        return conv

    async def get_conversation(self, conv_id):
        with self._lock:
            return self._convs.get(conv_id)

    async def update_conversation(self, conv_id, metadata):
        with self._lock:
            conv = self._convs.get(conv_id)
            if conv:
                conv.metadata.update(metadata)
            return conv

    async def delete_conversation(self, conv_id):
        with self._lock:
            self._items.pop(conv_id, None)
            return self._convs.pop(conv_id, None) is not None

    async def list_conversations(self, limit=100):
        with self._lock:
            return sorted(self._convs.values(), key=lambda c: -c.created_at)[:limit]

    async def add_items(self, conv_id, items):
        with self._lock:
            bucket = self._items.setdefault(conv_id, [])
            for it in items:
                it.conversation_id = conv_id
                bucket.append(it)
        return items

    async def list_items(self, conv_id, limit=1000):
        with self._lock:
            return list(self._items.get(conv_id, []))[:limit]

    async def get_item(self, conv_id, item_id):
        with self._lock:
            for it in self._items.get(conv_id, []):
                if it.id == item_id:
                    return it
        return None

    async def delete_item(self, conv_id, item_id):
        with self._lock:
            bucket = self._items.get(conv_id, [])
            for i, it in enumerate(bucket):
                if it.id == item_id:
                    del bucket[i]
                    return True
        return False

    async def store_response(self, response):
        with self._lock:
            self._responses[response.id] = response
        return response

    async def get_response(self, response_id):
        with self._lock:
            return self._responses.get(response_id)

    async def delete_response(self, response_id):
        with self._lock:
            return self._responses.pop(response_id, None) is not None
