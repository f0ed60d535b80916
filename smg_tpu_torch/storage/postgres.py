"""Postgres storage backend over the in-tree wire client.

Reference: ``crates/data_connector/src/postgres.rs`` — same trait surface
and a versioned migrations table (``smg_migrations``), mirroring the SQLite
backend's PRAGMA user_version scheme.

The port's copy of ``smg_tpu/storage/postgres.py``, unchanged but for its
imports.
"""

from __future__ import annotations

import json

from smg_tpu_torch.storage.core import (
    Conversation,
    ConversationItem,
    ConversationItemStorage,
    ConversationStorage,
    ResponseStorage,
    StoredResponse,
)
from smg_tpu_torch.storage.pgwire import PgClient, PgError, quote_literal as q

MIGRATIONS = [
    """
    CREATE TABLE IF NOT EXISTS conversations (
        id TEXT PRIMARY KEY,
        created_at DOUBLE PRECISION NOT NULL,
        metadata TEXT NOT NULL
    );
    CREATE TABLE IF NOT EXISTS conversation_items (
        id TEXT PRIMARY KEY,
        conversation_id TEXT NOT NULL,
        type TEXT NOT NULL,
        role TEXT,
        content TEXT,
        created_at DOUBLE PRECISION NOT NULL,
        seq BIGINT NOT NULL
    );
    CREATE INDEX IF NOT EXISTS idx_items_conv
        ON conversation_items (conversation_id, seq);
    CREATE TABLE IF NOT EXISTS responses (
        id TEXT PRIMARY KEY,
        previous_response_id TEXT,
        conversation_id TEXT,
        created_at DOUBLE PRECISION NOT NULL,
        status TEXT NOT NULL,
        model TEXT NOT NULL,
        output TEXT NOT NULL,
        input_items TEXT NOT NULL,
        usage TEXT NOT NULL,
        metadata TEXT NOT NULL
    );
    """,
    # v2: item ordering moves from a process-local counter to a server-side
    # sequence so concurrent gateway instances can never mint colliding seq
    # values.  The setval runs once here (not per startup) — the only race
    # window is an old-version instance still inserting literal seqs during
    # this migration, vs. every restart with the counter scheme.
    """
    CREATE SEQUENCE IF NOT EXISTS conversation_items_seq;
    SELECT setval('conversation_items_seq', GREATEST(
        (SELECT COALESCE(MAX(seq), 0) FROM conversation_items), 1));
    """,
]


class PostgresStorage(ConversationStorage, ConversationItemStorage, ResponseStorage):
    def __init__(self, client: PgClient | None = None, dsn: str | None = None):
        if client is None:
            client = PgClient.from_dsn(dsn or "postgres://postgres@127.0.0.1/postgres")
        self.client = client
        self._migrated = False

    async def _ensure(self) -> None:
        if self._migrated:
            return
        await self.client.query(
            "CREATE TABLE IF NOT EXISTS smg_migrations "
            "(version BIGINT PRIMARY KEY, applied_at DOUBLE PRECISION)"
        )
        rows = await self.client.query(
            "SELECT COALESCE(MAX(version), 0) AS v FROM smg_migrations"
        )
        version = int(rows[0]["v"] or 0)
        import time

        for i, mig in enumerate(MIGRATIONS[version:], start=version + 1):
            await self.client.query(mig)
            await self.client.query(
                f"INSERT INTO smg_migrations VALUES ({i}, {time.time()})"
            )
        self._migrated = True

    async def close(self) -> None:
        await self.client.close()

    # ---- conversations ----

    async def create_conversation(self, metadata=None) -> Conversation:
        await self._ensure()
        conv = Conversation(metadata=metadata or {})
        await self.client.query(
            f"INSERT INTO conversations VALUES ({q(conv.id)}, {conv.created_at}, "
            f"{q(json.dumps(conv.metadata))})"
        )
        return conv

    async def get_conversation(self, conv_id: str) -> Conversation | None:
        await self._ensure()
        rows = await self.client.query(
            f"SELECT * FROM conversations WHERE id = {q(conv_id)}"
        )
        if not rows:
            return None
        r = rows[0]
        return Conversation(
            id=r["id"], created_at=float(r["created_at"]),
            metadata=json.loads(r["metadata"]),
        )

    async def update_conversation(self, conv_id: str, metadata: dict) -> Conversation | None:
        conv = await self.get_conversation(conv_id)
        if conv is None:
            return None
        conv.metadata.update(metadata)
        await self.client.query(
            f"UPDATE conversations SET metadata = {q(json.dumps(conv.metadata))} "
            f"WHERE id = {q(conv_id)}"
        )
        return conv

    async def delete_conversation(self, conv_id: str) -> bool:
        await self._ensure()
        rows = await self.client.query(
            f"DELETE FROM conversations WHERE id = {q(conv_id)} RETURNING id"
        )
        await self.client.query(
            f"DELETE FROM conversation_items WHERE conversation_id = {q(conv_id)}"
        )
        return bool(rows)

    async def list_conversations(self, limit: int = 100) -> list[Conversation]:
        await self._ensure()
        # newest first: parity with the memory/sqlite backends
        rows = await self.client.query(
            f"SELECT * FROM conversations ORDER BY created_at DESC LIMIT {int(limit)}"
        )
        return [
            Conversation(id=r["id"], created_at=float(r["created_at"]),
                         metadata=json.loads(r["metadata"]))
            for r in rows
        ]

    # ---- items ----

    async def add_items(self, conv_id: str, items: list[ConversationItem]) -> list[ConversationItem]:
        await self._ensure()
        for item in items:
            item.conversation_id = conv_id
            await self.client.query(
                "INSERT INTO conversation_items VALUES ("
                f"{q(item.id)}, {q(conv_id)}, {q(item.type)}, {q(item.role)}, "
                f"{q(json.dumps(item.content))}, {item.created_at}, "
                "nextval('conversation_items_seq'))"
            )
        return items

    async def list_items(self, conv_id: str, limit: int = 1000) -> list[ConversationItem]:
        await self._ensure()
        rows = await self.client.query(
            "SELECT * FROM conversation_items WHERE conversation_id = "
            f"{q(conv_id)} ORDER BY seq LIMIT {int(limit)}"
        )
        return [self._item(r) for r in rows]

    @staticmethod
    def _item(r: dict) -> ConversationItem:
        return ConversationItem(
            id=r["id"], conversation_id=r["conversation_id"], type=r["type"],
            role=r["role"], content=json.loads(r["content"]),
            created_at=float(r["created_at"]),
        )

    async def get_item(self, conv_id: str, item_id: str) -> ConversationItem | None:
        await self._ensure()
        rows = await self.client.query(
            "SELECT * FROM conversation_items WHERE conversation_id = "
            f"{q(conv_id)} AND id = {q(item_id)}"
        )
        return self._item(rows[0]) if rows else None

    async def delete_item(self, conv_id: str, item_id: str) -> bool:
        await self._ensure()
        rows = await self.client.query(
            "DELETE FROM conversation_items WHERE conversation_id = "
            f"{q(conv_id)} AND id = {q(item_id)} RETURNING id"
        )
        return bool(rows)

    # ---- responses ----

    async def store_response(self, response: StoredResponse) -> StoredResponse:
        await self._ensure()
        await self.client.query(
            "INSERT INTO responses VALUES ("
            f"{q(response.id)}, {q(response.previous_response_id)}, "
            f"{q(response.conversation_id)}, {response.created_at}, "
            f"{q(response.status)}, {q(response.model)}, "
            f"{q(json.dumps(response.output))}, {q(json.dumps(response.input_items))}, "
            f"{q(json.dumps(response.usage))}, {q(json.dumps(response.metadata))})"
        )
        return response

    async def get_response(self, response_id: str) -> StoredResponse | None:
        await self._ensure()
        rows = await self.client.query(
            f"SELECT * FROM responses WHERE id = {q(response_id)}"
        )
        if not rows:
            return None
        r = rows[0]
        return StoredResponse(
            id=r["id"], previous_response_id=r["previous_response_id"],
            conversation_id=r["conversation_id"], created_at=float(r["created_at"]),
            status=r["status"], model=r["model"], output=json.loads(r["output"]),
            input_items=json.loads(r["input_items"]), usage=json.loads(r["usage"]),
            metadata=json.loads(r["metadata"]),
        )

    async def delete_response(self, response_id: str) -> bool:
        await self._ensure()
        rows = await self.client.query(
            f"DELETE FROM responses WHERE id = {q(response_id)} RETURNING id"
        )
        return bool(rows)
