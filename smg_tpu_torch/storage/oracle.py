"""Oracle storage backend (chat history / responses).

Reference: ``crates/data_connector/src/oracle.rs`` +
``oracle_migrations.rs`` — versioned migrations tracked in a
``smg_migrations`` table, Oracle DDL dialect (``VARCHAR2``/``CLOB``/
``BINARY_DOUBLE``, sequences + ``NEXTVAL``, ``FETCH FIRST n ROWS ONLY``,
no ``IF NOT EXISTS`` — existence races are absorbed by the ORA-00955
handler), and full schema REMAPPING (``storage/schema.py``): deployments
point at an existing physical schema by renaming tables/columns, adding
extra columns, or skipping ones the physical schema lacks.

The wire client is INJECTED (``async query(sql) -> list[dict]``): the
``oracledb`` driver isn't bundled, so ``connect_oracle`` gates on its
availability while tests drive the full SQL surface through a
dialect-shimmed fake.  Rows come back with UPPERCASE keys (Oracle's
unquoted-identifier canon); this backend lowercases on read.

The port's copy of ``smg_tpu/storage/oracle.py``, unchanged but for its
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
from smg_tpu_torch.storage.pgwire import quote_literal as q
from smg_tpu_torch.storage.schema import SchemaConfig
from smg_tpu_torch.utils import get_logger

logger = get_logger("storage.oracle")

ORA_NAME_EXISTS = "ORA-00955"
ORA_UNIQUE_VIOLATION = "ORA-00001"


class _RawSql(str):
    """Module-private marker for SQL expressions that must splice verbatim
    (sequence NEXTVAL).  ``_insert`` quotes every value EXCEPT instances of
    this class — a client-controlled string can therefore never reach the
    statement unquoted, no matter what it ends with (the old sentinel,
    "ends with .NEXTVAL", let hostile ids/metadata splice raw SQL)."""

    __slots__ = ()


#: the only raw expression this backend ever inserts
_ITEM_SEQ_NEXTVAL = _RawSql("smg_item_seq.NEXTVAL")

#: logical schema: (logical column, oracle type) per logical table
LOGICAL_TABLES = {
    "conversations": [
        ("id", "VARCHAR2(64) PRIMARY KEY"),
        ("created_at", "BINARY_DOUBLE NOT NULL"),
        ("metadata", "CLOB"),
    ],
    "conversation_items": [
        ("id", "VARCHAR2(64) PRIMARY KEY"),
        ("conversation_id", "VARCHAR2(64) NOT NULL"),
        ("item_type", "VARCHAR2(64) NOT NULL"),
        ("role", "VARCHAR2(32)"),
        ("content", "CLOB"),
        ("created_at", "BINARY_DOUBLE NOT NULL"),
        ("seq", "NUMBER(19) NOT NULL"),
    ],
    "responses": [
        ("id", "VARCHAR2(64) PRIMARY KEY"),
        ("previous_response_id", "VARCHAR2(64)"),
        ("conversation_id", "VARCHAR2(64)"),
        ("created_at", "BINARY_DOUBLE NOT NULL"),
        ("status", "VARCHAR2(32) NOT NULL"),
        ("model", "VARCHAR2(256)"),
        ("output", "CLOB"),
        ("input_items", "CLOB"),
        ("usage_json", "CLOB"),
        ("metadata", "CLOB"),
    ],
}


def connect_oracle(dsn: str, user: str = "", password: str = ""):
    """Async oracledb client wrapper; raises a clear error when the driver
    isn't installed (it isn't bundled — Oracle wire needs the vendor lib)."""
    try:
        import oracledb  # type: ignore
    except ImportError as e:  # pragma: no cover - driver not bundled
        raise RuntimeError(
            "oracle storage needs the 'oracledb' driver (pip install "
            "oracledb) or an injected client"
        ) from e

    class _Client:  # pragma: no cover - exercised only with a live Oracle
        def __init__(self):
            self._pool = oracledb.create_pool_async(
                dsn=dsn, user=user, password=password, min=1, max=4
            )

        async def query(self, sql: str) -> list[dict]:
            async with self._pool.acquire() as conn:
                cur = conn.cursor()
                await cur.execute(sql)
                if cur.description is None:
                    await conn.commit()
                    return []
                cols = [d[0] for d in cur.description]
                return [dict(zip(cols, row)) async for row in cur]

        async def close(self):
            await self._pool.close()

    return _Client()


class OracleStorage(ConversationStorage, ConversationItemStorage, ResponseStorage):
    def __init__(self, client, schema: SchemaConfig | None = None):
        self.client = client
        self.schema = schema or SchemaConfig()
        self._migrated = False

    # ---- DDL / migrations ----

    def _t(self, logical: str) -> str:
        return self.schema.table(logical).name

    def _c(self, logical_table: str, logical_col: str) -> str:
        return self.schema.table(logical_table).col(logical_col)

    def _ddl(self, logical: str) -> str:
        tc = self.schema.table(logical)
        cols = tc.live_columns(LOGICAL_TABLES[logical])
        body = ", ".join(f"{name} {sqltype}" for name, sqltype in cols)
        return f"CREATE TABLE {tc.name} ({body})"

    def migrations(self) -> "list[list[str]]":
        """Versioned statement batches (oracle_migrations.rs analog).
        v1: history tables + item sequence; v2: responses; v3: item index."""
        items = self.schema.table("conversation_items")
        return [
            [
                self._ddl("conversations"),
                self._ddl("conversation_items"),
                "CREATE SEQUENCE smg_item_seq",
            ],
            [self._ddl("responses")],
            [
                f"CREATE INDEX smg_items_conv_idx ON {items.name} "
                f"({items.col('conversation_id')}, {items.col('seq')})",
            ],
        ]

    async def _exec_ignore_exists(self, sql: str) -> None:
        try:
            await self.client.query(sql)
        except Exception as e:
            if ORA_NAME_EXISTS in str(e):
                return  # concurrent migrator won the race: identical DDL
            raise

    async def _ensure(self) -> None:
        if self._migrated:
            return
        await self._exec_ignore_exists(
            "CREATE TABLE smg_migrations "
            "(version NUMBER(10) PRIMARY KEY, applied_at BINARY_DOUBLE)"
        )
        rows = await self.client.query(
            "SELECT COALESCE(MAX(version), 0) AS v FROM smg_migrations"
        )
        version = int(self._row(rows[0])["v"] or 0)
        import time

        migs = self.migrations()
        for i, batch in enumerate(migs[version:], start=version + 1):
            for stmt in batch:
                await self._exec_ignore_exists(stmt)
            try:
                await self.client.query(
                    f"INSERT INTO smg_migrations VALUES ({i}, {time.time()})"
                )
            except Exception as e:
                if ORA_UNIQUE_VIOLATION not in str(e):
                    raise
                # a concurrent migrator recorded this version first (PK race
                # on `version`); the DDL batches are identical and idempotent
                # under the ORA-00955 handler, so the loser continues instead
                # of failing its first request
        self._migrated = True

    @staticmethod
    def _row(r: dict) -> dict:
        """Oracle canonicalizes unquoted identifiers to UPPERCASE."""
        return {k.lower(): v for k, v in r.items()}

    def _logical_row(self, logical_table: str, r: dict) -> dict:
        """Physical row -> logical field names (reverse column remap)."""
        tc = self.schema.table(logical_table)
        reverse = {v.lower(): k for k, v in tc.columns.items()}
        low = self._row(r)
        return {reverse.get(k, k): v for k, v in low.items()}

    def _insert(self, logical: str, values: dict) -> str:
        """INSERT over the LIVE columns (remap applied, skips dropped)."""
        tc = self.schema.table(logical)
        cols, vals = [], []
        for name, _ in LOGICAL_TABLES[logical]:
            if name in tc.skip_columns or name not in values:
                continue
            cols.append(tc.col(name))
            v = values[name]
            vals.append(v if isinstance(v, _RawSql) else q(v))
        return (f"INSERT INTO {tc.name} ({', '.join(cols)}) "
                f"VALUES ({', '.join(vals)})")

    async def close(self) -> None:
        close = getattr(self.client, "close", None)
        if close is not None:
            await close()

    # ---- conversations ----

    async def create_conversation(self, metadata=None) -> Conversation:
        await self._ensure()
        conv = Conversation(metadata=metadata or {})
        await self.client.query(self._insert("conversations", {
            "id": conv.id, "created_at": conv.created_at,
            "metadata": json.dumps(conv.metadata),
        }))
        return conv

    async def get_conversation(self, conv_id: str) -> Conversation | None:
        await self._ensure()
        t = self._t("conversations")
        rows = await self.client.query(
            f"SELECT * FROM {t} WHERE {self._c('conversations', 'id')} = {q(conv_id)}"
        )
        if not rows:
            return None
        r = self._logical_row("conversations", rows[0])
        return Conversation(id=r["id"], created_at=float(r["created_at"]),
                            metadata=json.loads(r.get("metadata") or "{}"))

    async def update_conversation(self, conv_id: str, metadata: dict):
        await self._ensure()
        conv = await self.get_conversation(conv_id)
        if conv is None:
            return None
        conv.metadata.update(metadata)
        if "metadata" not in self.schema.table("conversations").skip_columns:
            await self.client.query(
                f"UPDATE {self._t('conversations')} SET "
                f"{self._c('conversations', 'metadata')} = {q(json.dumps(conv.metadata))} "
                f"WHERE {self._c('conversations', 'id')} = {q(conv_id)}"
            )
        return conv

    async def delete_conversation(self, conv_id: str) -> bool:
        await self._ensure()
        rows = await self.client.query(
            f"SELECT 1 AS x FROM {self._t('conversations')} "
            f"WHERE {self._c('conversations', 'id')} = {q(conv_id)}"
        )
        await self.client.query(
            f"DELETE FROM {self._t('conversations')} "
            f"WHERE {self._c('conversations', 'id')} = {q(conv_id)}"
        )
        await self.client.query(
            f"DELETE FROM {self._t('conversation_items')} "
            f"WHERE {self._c('conversation_items', 'conversation_id')} = {q(conv_id)}"
        )
        return bool(rows)

    async def list_conversations(self, limit: int = 100) -> list[Conversation]:
        await self._ensure()
        rows = await self.client.query(
            f"SELECT * FROM {self._t('conversations')} ORDER BY "
            f"{self._c('conversations', 'created_at')} DESC "
            f"FETCH FIRST {int(limit)} ROWS ONLY"
        )
        out = []
        for raw in rows:
            r = self._logical_row("conversations", raw)
            out.append(Conversation(id=r["id"], created_at=float(r["created_at"]),
                                    metadata=json.loads(r.get("metadata") or "{}")))
        return out

    # ---- items ----

    async def add_items(self, conv_id: str, items: list[ConversationItem]) -> list[ConversationItem]:
        await self._ensure()
        for item in items:
            item.conversation_id = conv_id
            await self.client.query(self._insert("conversation_items", {
                "id": item.id, "conversation_id": conv_id,
                "item_type": item.type, "role": item.role,
                "content": json.dumps(item.content),
                "created_at": item.created_at,
                "seq": _ITEM_SEQ_NEXTVAL,
            }))
        return items

    async def list_items(self, conv_id: str, limit: int = 1000) -> list[ConversationItem]:
        await self._ensure()
        rows = await self.client.query(
            f"SELECT * FROM {self._t('conversation_items')} WHERE "
            f"{self._c('conversation_items', 'conversation_id')} = {q(conv_id)} "
            f"ORDER BY {self._c('conversation_items', 'seq')} "
            f"FETCH FIRST {int(limit)} ROWS ONLY"
        )
        return [self._item(r) for r in rows]

    def _item(self, raw: dict) -> ConversationItem:
        r = self._logical_row("conversation_items", raw)
        return ConversationItem(
            id=r["id"], conversation_id=r["conversation_id"],
            type=r["item_type"], role=r.get("role"),
            content=json.loads(r.get("content") or "null"),
            created_at=float(r["created_at"]),
        )

    async def get_item(self, conv_id: str, item_id: str) -> ConversationItem | None:
        await self._ensure()
        rows = await self.client.query(
            f"SELECT * FROM {self._t('conversation_items')} WHERE "
            f"{self._c('conversation_items', 'conversation_id')} = {q(conv_id)} "
            f"AND {self._c('conversation_items', 'id')} = {q(item_id)}"
        )
        return self._item(rows[0]) if rows else None

    async def delete_item(self, conv_id: str, item_id: str) -> bool:
        await self._ensure()
        rows = await self.client.query(
            f"SELECT 1 AS x FROM {self._t('conversation_items')} WHERE "
            f"{self._c('conversation_items', 'conversation_id')} = {q(conv_id)} "
            f"AND {self._c('conversation_items', 'id')} = {q(item_id)}"
        )
        await self.client.query(
            f"DELETE FROM {self._t('conversation_items')} WHERE "
            f"{self._c('conversation_items', 'conversation_id')} = {q(conv_id)} "
            f"AND {self._c('conversation_items', 'id')} = {q(item_id)}"
        )
        return bool(rows)

    # ---- responses ----

    async def store_response(self, response: StoredResponse) -> StoredResponse:
        await self._ensure()
        await self.client.query(self._insert("responses", {
            "id": response.id,
            "previous_response_id": response.previous_response_id,
            "conversation_id": response.conversation_id,
            "created_at": response.created_at,
            "status": response.status, "model": response.model,
            "output": json.dumps(response.output),
            "input_items": json.dumps(response.input_items),
            "usage_json": json.dumps(response.usage),
            "metadata": json.dumps(response.metadata),
        }))
        return response

    async def get_response(self, response_id: str) -> StoredResponse | None:
        await self._ensure()
        rows = await self.client.query(
            f"SELECT * FROM {self._t('responses')} WHERE "
            f"{self._c('responses', 'id')} = {q(response_id)}"
        )
        if not rows:
            return None
        r = self._logical_row("responses", rows[0])
        return StoredResponse(
            id=r["id"], previous_response_id=r.get("previous_response_id"),
            conversation_id=r.get("conversation_id"),
            created_at=float(r["created_at"]), status=r["status"],
            model=r.get("model") or "",
            output=json.loads(r.get("output") or "[]"),
            input_items=json.loads(r.get("input_items") or "[]"),
            usage=json.loads(r.get("usage_json") or "{}"),
            metadata=json.loads(r.get("metadata") or "{}"),
        )

    async def delete_response(self, response_id: str) -> bool:
        await self._ensure()
        rows = await self.client.query(
            f"SELECT 1 AS x FROM {self._t('responses')} WHERE "
            f"{self._c('responses', 'id')} = {q(response_id)}"
        )
        await self.client.query(
            f"DELETE FROM {self._t('responses')} WHERE "
            f"{self._c('responses', 'id')} = {q(response_id)}"
        )
        return bool(rows)
