"""Chat-history storage (reference: ``crates/data_connector``, SURVEY.md §2.2).

Storage traits (``ConversationStorage``/``ConversationItemStorage``/
``ResponseStorage``, reference ``core.rs:132,225,434``) with in-memory,
SQLite, Redis, and Postgres backends (reference ships
memory/noop/oracle/postgres/redis).  The Redis and Postgres backends speak
their wire protocols directly (``resp.py``, ``pgwire.py``) — no client
library is a dependency, and the protocols are small.

Backend selection: ``make_storage("memory" | "sqlite:<path>" |
"redis://..." | "postgres://...")``.

The port's copy of ``smg_tpu/storage/__init__.py``, unchanged but for its
imports.
"""

from smg_tpu_torch.storage.core import (
    Conversation,
    ConversationItem,
    ConversationItemStorage,
    ConversationStorage,
    ResponseStorage,
    StoredResponse,
)
from smg_tpu_torch.storage.memory import MemoryStorage
from smg_tpu_torch.storage.sqlite import SqliteStorage


def make_storage(spec: str | None):
    """Storage factory keyed by URL scheme (reference: connector factory,
    ``crates/data_connector/src/lib.rs``)."""
    if not spec or spec == "memory":
        return MemoryStorage()
    if spec.startswith("sqlite:"):
        return SqliteStorage(spec.split(":", 1)[1] or ":memory:")
    if spec.startswith(("redis://", "rediss://")):
        from smg_tpu_torch.storage.redis import RedisStorage

        return RedisStorage(url=spec)
    if spec.startswith(("postgres://", "postgresql://")):
        from smg_tpu_torch.storage.postgres import PostgresStorage

        return PostgresStorage(dsn=spec)
    if spec.startswith("oracle://"):
        from urllib.parse import urlparse

        from smg_tpu_torch.storage.oracle import OracleStorage, connect_oracle

        u = urlparse(spec)
        dsn = f"{u.hostname}:{u.port or 1521}/{(u.path or '/').lstrip('/')}"
        return OracleStorage(connect_oracle(
            dsn, user=u.username or "", password=u.password or ""
        ))
    raise ValueError(f"unknown storage spec {spec!r}")


__all__ = [
    "Conversation",
    "ConversationItem",
    "ConversationStorage",
    "ConversationItemStorage",
    "ResponseStorage",
    "StoredResponse",
    "MemoryStorage",
    "SqliteStorage",
    "make_storage",
]
