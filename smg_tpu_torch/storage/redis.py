"""Redis storage backend over the in-tree RESP client.

Reference: ``crates/data_connector/src/redis.rs`` — same trait surface as
the SQLite/memory backends (conversations, items, responses).  Data model:

- ``conv:{id}``             JSON blob of the Conversation
- ``convs``                 ZSET of conversation ids scored by created_at
- ``items:{conv_id}``       LIST of item ids in insertion order
- ``item:{conv_id}:{id}``   JSON blob of the ConversationItem
- ``resp:{id}``             JSON blob of the StoredResponse

All mutations ride pipelines so multi-key updates are one round trip (Redis
single-threaded execution makes each pipeline effectively atomic for this
workload's needs; cross-key transactional integrity matches the reference's
connector, which also does not use MULTI for these paths).

The port's copy of ``smg_tpu/storage/redis.py``, unchanged but for its
imports.
"""

from __future__ import annotations

import dataclasses
import json

from smg_tpu_torch.storage.core import (
    Conversation,
    ConversationItem,
    ConversationItemStorage,
    ConversationStorage,
    ResponseStorage,
    StoredResponse,
)
from smg_tpu_torch.storage.resp import RespClient, RespError


def _dump(obj) -> str:
    return json.dumps(dataclasses.asdict(obj))


class RedisStorage(ConversationStorage, ConversationItemStorage, ResponseStorage):
    def __init__(self, client: RespClient | None = None, url: str | None = None,
                 prefix: str = "smg"):
        if client is None:
            client = RespClient.from_url(url or "redis://127.0.0.1:6379/0")
        self.client = client
        self.prefix = prefix

    def _k(self, *parts: str) -> str:
        return ":".join((self.prefix,) + parts)

    @staticmethod
    def _check(reply):
        if isinstance(reply, RespError):
            raise reply
        return reply

    async def close(self) -> None:
        await self.client.close()

    # ---- conversations ----

    async def create_conversation(self, metadata=None) -> Conversation:
        conv = Conversation(metadata=metadata or {})
        self._check((await self.client.pipeline([
            ("SET", self._k("conv", conv.id), _dump(conv)),
            ("ZADD", self._k("convs"), conv.created_at, conv.id),
        ]))[0])
        return conv

    async def get_conversation(self, conv_id: str) -> Conversation | None:
        raw = self._check(await self.client.command("GET", self._k("conv", conv_id)))
        return None if raw is None else Conversation(**json.loads(raw))

    async def update_conversation(self, conv_id: str, metadata: dict) -> Conversation | None:
        conv = await self.get_conversation(conv_id)
        if conv is None:
            return None
        conv.metadata.update(metadata)
        self._check(await self.client.command(
            "SET", self._k("conv", conv_id), _dump(conv)
        ))
        return conv

    async def delete_conversation(self, conv_id: str) -> bool:
        item_ids = self._check(await self.client.command(
            "LRANGE", self._k("items", conv_id), 0, -1
        )) or []
        cmds = [
            ("DEL", self._k("conv", conv_id)),
            ("ZREM", self._k("convs"), conv_id),
            ("DEL", self._k("items", conv_id)),
        ]
        for iid in item_ids:
            iid = iid.decode() if isinstance(iid, bytes) else iid
            cmds.append(("DEL", self._k("item", conv_id, iid)))
        replies = await self.client.pipeline(cmds)
        return bool(self._check(replies[0]))

    async def list_conversations(self, limit: int = 100) -> list[Conversation]:
        # newest first: parity with the memory/sqlite backends
        ids = self._check(await self.client.command(
            "ZREVRANGE", self._k("convs"), 0, limit - 1
        )) or []
        if not ids:
            return []
        raws = await self.client.pipeline([
            ("GET", self._k("conv", i.decode() if isinstance(i, bytes) else i))
            for i in ids
        ])
        return [
            Conversation(**json.loads(r)) for r in raws
            if r is not None and not isinstance(r, RespError)
        ]

    # ---- items ----

    async def add_items(self, conv_id: str, items: list[ConversationItem]) -> list[ConversationItem]:
        cmds = []
        for item in items:
            item.conversation_id = conv_id
            cmds.append(("RPUSH", self._k("items", conv_id), item.id))
            cmds.append(("SET", self._k("item", conv_id, item.id), _dump(item)))
        for r in await self.client.pipeline(cmds):
            self._check(r)
        return items

    async def list_items(self, conv_id: str, limit: int = 1000) -> list[ConversationItem]:
        ids = self._check(await self.client.command(
            "LRANGE", self._k("items", conv_id), 0, limit - 1
        )) or []
        if not ids:
            return []
        raws = await self.client.pipeline([
            ("GET", self._k("item", conv_id, i.decode() if isinstance(i, bytes) else i))
            for i in ids
        ])
        return [
            ConversationItem(**json.loads(r)) for r in raws
            if r is not None and not isinstance(r, RespError)
        ]

    async def get_item(self, conv_id: str, item_id: str) -> ConversationItem | None:
        raw = self._check(await self.client.command(
            "GET", self._k("item", conv_id, item_id)
        ))
        return None if raw is None else ConversationItem(**json.loads(raw))

    async def delete_item(self, conv_id: str, item_id: str) -> bool:
        replies = await self.client.pipeline([
            ("LREM", self._k("items", conv_id), 0, item_id),
            ("DEL", self._k("item", conv_id, item_id)),
        ])
        return bool(self._check(replies[1]))

    # ---- responses ----

    async def store_response(self, response: StoredResponse) -> StoredResponse:
        self._check(await self.client.command(
            "SET", self._k("resp", response.id), _dump(response)
        ))
        return response

    async def get_response(self, response_id: str) -> StoredResponse | None:
        raw = self._check(await self.client.command(
            "GET", self._k("resp", response_id)
        ))
        return None if raw is None else StoredResponse(**json.loads(raw))

    async def delete_response(self, response_id: str) -> bool:
        return bool(self._check(await self.client.command(
            "DEL", self._k("resp", response_id)
        )))
