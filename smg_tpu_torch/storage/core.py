"""Storage traits + records.

Reference: ``crates/data_connector/src/core.rs`` — async traits over
conversations, conversation items, and stored responses.

The port's copy of ``smg_tpu/storage/core.py``, unchanged but for its
imports.
"""

from __future__ import annotations

import time
import uuid
from dataclasses import dataclass, field
from typing import Any


def _id(prefix: str) -> str:
    return f"{prefix}_{uuid.uuid4().hex[:24]}"


@dataclass
class Conversation:
    id: str = field(default_factory=lambda: _id("conv"))
    created_at: float = field(default_factory=time.time)
    metadata: dict[str, Any] = field(default_factory=dict)


@dataclass
class ConversationItem:
    id: str = field(default_factory=lambda: _id("item"))
    conversation_id: str = ""
    type: str = "message"  # message | function_call | function_call_output | reasoning
    role: str | None = None
    content: Any = None
    created_at: float = field(default_factory=time.time)


@dataclass
class StoredResponse:
    id: str = field(default_factory=lambda: _id("resp"))
    previous_response_id: str | None = None
    conversation_id: str | None = None
    created_at: float = field(default_factory=time.time)
    status: str = "completed"
    model: str = ""
    output: list[dict] = field(default_factory=list)
    input_items: list[dict] = field(default_factory=list)
    usage: dict = field(default_factory=dict)
    metadata: dict = field(default_factory=dict)


class ConversationStorage:
    async def create_conversation(self, metadata: dict | None = None) -> Conversation:
        raise NotImplementedError

    async def get_conversation(self, conv_id: str) -> Conversation | None:
        raise NotImplementedError

    async def update_conversation(self, conv_id: str, metadata: dict) -> Conversation | None:
        raise NotImplementedError

    async def delete_conversation(self, conv_id: str) -> bool:
        raise NotImplementedError

    async def list_conversations(self, limit: int = 100) -> list[Conversation]:
        raise NotImplementedError


class ConversationItemStorage:
    async def add_items(self, conv_id: str, items: list[ConversationItem]) -> list[ConversationItem]:
        raise NotImplementedError

    async def list_items(self, conv_id: str, limit: int = 1000) -> list[ConversationItem]:
        raise NotImplementedError

    async def get_item(self, conv_id: str, item_id: str) -> ConversationItem | None:
        raise NotImplementedError

    async def delete_item(self, conv_id: str, item_id: str) -> bool:
        raise NotImplementedError


class ResponseStorage:
    async def store_response(self, response: StoredResponse) -> StoredResponse:
        raise NotImplementedError

    async def get_response(self, response_id: str) -> StoredResponse | None:
        raise NotImplementedError

    async def delete_response(self, response_id: str) -> bool:
        raise NotImplementedError

    async def response_chain(self, response_id: str, max_depth: int = 64) -> list[StoredResponse]:
        """Walk previous_response_id links, oldest first."""
        chain: list[StoredResponse] = []
        cur = await self.get_response(response_id)
        while cur is not None and len(chain) < max_depth:
            chain.append(cur)
            if not cur.previous_response_id:
                break
            cur = await self.get_response(cur.previous_response_id)
        chain.reverse()
        return chain
