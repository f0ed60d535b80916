"""Minimal async Redis client (RESP2) — no external dependency.

Reference: ``crates/data_connector/src/redis.rs`` uses the redis crate; this
environment has no redis client library, so the wire protocol is implemented
directly: RESP2 framing (simple strings, errors, integers, bulk strings,
arrays), request pipelining over one connection, AUTH/SELECT on connect.
Covers everything the storage backend needs (strings, hashes, sorted sets,
lists, DEL/EXISTS, SCAN).

The port's copy of ``smg_tpu/storage/resp.py``, unchanged but for its
imports.
"""

from __future__ import annotations

import asyncio

from smg_tpu_torch.utils import get_logger

logger = get_logger("storage.resp")


class RespError(RuntimeError):
    """Server-reported error reply (``-ERR ...``)."""


class RespClient:
    """One connection, FIFO pipelining (commands are answered in order)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6379,
                 password: str | None = None, db: int = 0,
                 connect_timeout: float = 5.0, use_tls: bool = False):
        self.host, self.port = host, port
        self.password, self.db = password, db
        self.connect_timeout = connect_timeout
        self.use_tls = use_tls
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._lock = asyncio.Lock()  # serialize write+read pairs

    @classmethod
    def from_url(cls, url: str) -> "RespClient":
        """redis://[:password@]host[:port][/db]; rediss:// enables TLS."""
        scheme, _, rest = url.partition("://")
        password = None
        if "@" in rest:
            cred, rest = rest.rsplit("@", 1)
            password = cred.split(":", 1)[-1] or None
        db = 0
        if "/" in rest:
            rest, db_s = rest.split("/", 1)
            db = int(db_s or 0)
        host, _, port = rest.partition(":")
        return cls(host or "127.0.0.1", int(port or 6379), password, db,
                   use_tls=(scheme == "rediss"))

    async def _connect_locked(self) -> None:
        """Dial + handshake; caller holds self._lock."""
        import ssl as ssl_mod

        ssl_ctx = ssl_mod.create_default_context() if self.use_tls else None
        self._reader, self._writer = await asyncio.wait_for(
            asyncio.open_connection(self.host, self.port, ssl=ssl_ctx),
            self.connect_timeout,
        )
        handshake = []
        if self.password:
            handshake.append(("AUTH", self.password))
        if self.db:
            handshake.append(("SELECT", str(self.db)))
        if handshake:
            self._writer.write(b"".join(self.encode(c) for c in handshake))
            await self._writer.drain()
            for _ in handshake:
                await self._read_reply()  # RespError propagates

    async def connect(self) -> None:
        async with self._lock:
            if self._writer is None:
                await self._connect_locked()

    async def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except Exception:
                pass
            self._reader = self._writer = None

    # ---- framing ----

    @staticmethod
    def encode(args: tuple) -> bytes:
        """Client request = RESP array of bulk strings."""
        out = [b"*%d\r\n" % len(args)]
        for a in args:
            b = a if isinstance(a, bytes) else str(a).encode()
            out.append(b"$%d\r\n%s\r\n" % (len(b), b))
        return b"".join(out)

    async def _read_reply(self):
        line = await self._reader.readline()
        if not line:
            raise ConnectionError("redis connection closed")
        kind, rest = line[:1], line[1:-2]
        if kind == b"+":
            return rest.decode()
        if kind == b"-":
            raise RespError(rest.decode())
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            if n < 0:
                return None
            data = await self._reader.readexactly(n + 2)
            return data[:-2]
        if kind == b"*":
            n = int(rest)
            if n < 0:
                return None
            return [await self._read_reply() for _ in range(n)]
        raise RespError(f"unknown RESP type prefix {kind!r}")

    # ---- public API ----

    async def command(self, *args):
        """One command, one reply."""
        (reply,) = await self.pipeline([args])
        return reply

    async def pipeline(self, commands: list[tuple]):
        """Send several commands in one write; replies in order.  Errors are
        returned in-slot as RespError instances (callers inspect), matching
        client-library pipeline semantics."""
        async with self._lock:
            if self._writer is None:  # dial inside the lock: no connect race
                await self._connect_locked()
            try:
                self._writer.write(b"".join(self.encode(c) for c in commands))
                await self._writer.drain()
                replies = []
                for _ in commands:
                    try:
                        replies.append(await self._read_reply())
                    except RespError as e:
                        replies.append(e)
                return replies
            except (OSError, asyncio.IncompleteReadError, ConnectionError):
                # dead/desynced socket: drop it so the next call re-dials
                # instead of poisoning every future command
                writer, self._reader, self._writer = self._writer, None, None
                if writer is not None:
                    writer.close()
                raise
