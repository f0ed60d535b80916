"""SQLite storage backend with schema migrations.

Reference: the durable backends in ``crates/data_connector`` (oracle/postgres
with ``*_migrations.rs``, SURVEY.md §5 checkpoint/resume).  sqlite3 (stdlib)
keeps the same discipline: versioned migrations applied on open, queries
behind the shared traits.  Synchronous sqlite calls are pushed through a
single-thread executor so the event loop never blocks.

The port's copy of ``smg_tpu/storage/sqlite.py``, unchanged but for its
imports.
"""

from __future__ import annotations

import asyncio
import json
import sqlite3
from concurrent.futures import ThreadPoolExecutor

from smg_tpu_torch.storage.core import (
    Conversation,
    ConversationItem,
    ConversationItemStorage,
    ConversationStorage,
    ResponseStorage,
    StoredResponse,
)

MIGRATIONS: list[str] = [
    # v1
    """
    CREATE TABLE conversations (
        id TEXT PRIMARY KEY,
        created_at REAL NOT NULL,
        metadata TEXT NOT NULL DEFAULT '{}'
    );
    CREATE TABLE conversation_items (
        id TEXT PRIMARY KEY,
        conversation_id TEXT NOT NULL,
        type TEXT NOT NULL,
        role TEXT,
        content TEXT,
        created_at REAL NOT NULL
    );
    CREATE INDEX idx_items_conv ON conversation_items(conversation_id, created_at);
    CREATE TABLE responses (
        id TEXT PRIMARY KEY,
        previous_response_id TEXT,
        conversation_id TEXT,
        created_at REAL NOT NULL,
        status TEXT NOT NULL,
        model TEXT NOT NULL DEFAULT '',
        output TEXT NOT NULL DEFAULT '[]',
        input_items TEXT NOT NULL DEFAULT '[]',
        usage TEXT NOT NULL DEFAULT '{}',
        metadata TEXT NOT NULL DEFAULT '{}'
    );
    """,
]


class SqliteStorage(ConversationStorage, ConversationItemStorage, ResponseStorage):
    def __init__(self, path: str = ":memory:"):
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._conn = None
        self.path = path
        # open + migrate synchronously on the db thread
        fut = self._pool.submit(self._open)
        fut.result()

    def _open(self) -> None:
        self._conn = sqlite3.connect(self.path)
        self._conn.execute("PRAGMA journal_mode=WAL")
        cur = self._conn.execute("PRAGMA user_version").fetchone()
        version = cur[0]
        for i, mig in enumerate(MIGRATIONS[version:], start=version + 1):
            self._conn.executescript(mig)
            self._conn.execute(f"PRAGMA user_version = {i}")
            self._conn.commit()

    async def _run(self, fn, *args):
        return await asyncio.get_running_loop().run_in_executor(self._pool, fn, *args)

    # ---- conversations ----

    async def create_conversation(self, metadata=None) -> Conversation:
        conv = Conversation(metadata=metadata or {})

        def op():
            self._conn.execute(
                "INSERT INTO conversations VALUES (?, ?, ?)",
                (conv.id, conv.created_at, json.dumps(conv.metadata)),
            )
            self._conn.commit()

        await self._run(op)
        return conv

    async def get_conversation(self, conv_id):
        def op():
            row = self._conn.execute(
                "SELECT id, created_at, metadata FROM conversations WHERE id=?", (conv_id,)
            ).fetchone()
            return row

        row = await self._run(op)
        if row is None:
            return None
        return Conversation(id=row[0], created_at=row[1], metadata=json.loads(row[2]))

    async def update_conversation(self, conv_id, metadata):
        conv = await self.get_conversation(conv_id)
        if conv is None:
            return None
        conv.metadata.update(metadata)

        def op():
            self._conn.execute(
                "UPDATE conversations SET metadata=? WHERE id=?",
                (json.dumps(conv.metadata), conv_id),
            )
            self._conn.commit()

        await self._run(op)
        return conv

    async def delete_conversation(self, conv_id):
        def op():
            cur = self._conn.execute("DELETE FROM conversations WHERE id=?", (conv_id,))
            self._conn.execute(
                "DELETE FROM conversation_items WHERE conversation_id=?", (conv_id,)
            )
            self._conn.commit()
            return cur.rowcount > 0

        return await self._run(op)

    async def list_conversations(self, limit=100):
        def op():
            return self._conn.execute(
                "SELECT id, created_at, metadata FROM conversations "
                "ORDER BY created_at DESC LIMIT ?", (limit,)
            ).fetchall()

        rows = await self._run(op)
        return [Conversation(id=r[0], created_at=r[1], metadata=json.loads(r[2])) for r in rows]

    # ---- items ----

    async def add_items(self, conv_id, items):
        def op():
            for it in items:
                it.conversation_id = conv_id
                self._conn.execute(
                    "INSERT INTO conversation_items VALUES (?, ?, ?, ?, ?, ?)",
                    (it.id, conv_id, it.type, it.role, json.dumps(it.content), it.created_at),
                )
            self._conn.commit()

        await self._run(op)
        return items

    async def list_items(self, conv_id, limit=1000):
        def op():
            return self._conn.execute(
                "SELECT id, conversation_id, type, role, content, created_at "
                "FROM conversation_items WHERE conversation_id=? "
                "ORDER BY created_at LIMIT ?", (conv_id, limit)
            ).fetchall()

        rows = await self._run(op)
        return [
            ConversationItem(
                id=r[0], conversation_id=r[1], type=r[2], role=r[3],
                content=json.loads(r[4]) if r[4] else None, created_at=r[5],
            )
            for r in rows
        ]

    async def get_item(self, conv_id, item_id):
        items = await self.list_items(conv_id)
        return next((i for i in items if i.id == item_id), None)

    async def delete_item(self, conv_id, item_id):
        def op():
            cur = self._conn.execute(
                "DELETE FROM conversation_items WHERE conversation_id=? AND id=?",
                (conv_id, item_id),
            )
            self._conn.commit()
            return cur.rowcount > 0

        return await self._run(op)

    # ---- responses ----

    async def store_response(self, response):
        def op():
            self._conn.execute(
                "INSERT OR REPLACE INTO responses VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
                (
                    response.id, response.previous_response_id, response.conversation_id,
                    response.created_at, response.status, response.model,
                    json.dumps(response.output), json.dumps(response.input_items),
                    json.dumps(response.usage), json.dumps(response.metadata),
                ),
            )
            self._conn.commit()

        await self._run(op)
        return response

    async def get_response(self, response_id):
        def op():
            return self._conn.execute(
                "SELECT * FROM responses WHERE id=?", (response_id,)
            ).fetchone()

        r = await self._run(op)
        if r is None:
            return None
        return StoredResponse(
            id=r[0], previous_response_id=r[1], conversation_id=r[2], created_at=r[3],
            status=r[4], model=r[5], output=json.loads(r[6]),
            input_items=json.loads(r[7]), usage=json.loads(r[8]), metadata=json.loads(r[9]),
        )

    async def delete_response(self, response_id):
        def op():
            cur = self._conn.execute("DELETE FROM responses WHERE id=?", (response_id,))
            self._conn.commit()
            return cur.rowcount > 0

        return await self._run(op)
