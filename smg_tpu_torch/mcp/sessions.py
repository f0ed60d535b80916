"""MCP session management: per-caller server bindings with TTL eviction.

Reference: ``crates/mcp/src/core/session.rs`` + ``tenant.rs`` — a session
pins the set of MCP servers one request chain talks to (gateway-level
servers filtered by tenant, plus request-level servers), caches the merged
tool inventory for the session's lifetime, and is evicted after idle TTL so
request-scoped HTTP connections don't leak.

The port's copy of ``smg_tpu/mcp/sessions.py``, unchanged but for its
imports.
"""

from __future__ import annotations

import time
import uuid

from smg_tpu_torch.mcp.client import McpRegistry, McpToolServer, ToolInfo
from smg_tpu_torch.utils import get_logger

logger = get_logger("mcp.sessions")


class McpSession:
    """One caller's view of the MCP world for the duration of a request
    chain (a Responses conversation / previous_response_id chain).

    ``owned`` lists the REQUEST-SCOPED servers this session created (e.g.
    Responses-API ``type: mcp`` URL tools) — close() tears down only those;
    gateway-configured servers in the registry are shared across requests
    and must survive session eviction."""

    def __init__(self, session_id: str, registry: McpRegistry,
                 tenant: str | None = None,
                 owned: "list[McpToolServer] | None" = None):
        self.id = session_id
        self.tenant = tenant
        self.registry = registry
        self.owned = list(owned or [])
        self.created_at = time.monotonic()
        self.last_used = self.created_at
        self._tools: list[ToolInfo] | None = None

    def touch(self) -> None:
        self.last_used = time.monotonic()

    async def tools(self, refresh: bool = False) -> list[ToolInfo]:
        self.touch()
        if self._tools is None or refresh:
            self._tools = await self.registry.list_tools()
        return self._tools

    async def call_tool(self, name: str, arguments: dict) -> str:
        self.touch()
        return await self.registry.call_tool(name, arguments)

    def server_for(self, tool_name: str) -> str | None:
        """Server label a tool resolves to (for mcp_call item attribution)."""
        for t in self._tools or []:
            if t.name == tool_name or f"{t.server}.{t.name}" == tool_name:
                return t.server
        return None

    async def close(self) -> None:
        for s in self.owned:
            try:
                await s.close()
            except Exception:
                logger.exception("closing request-scoped MCP server %s failed",
                                 s.name)


def _fingerprint(registry: McpRegistry) -> tuple:
    """Server identity set: name + URL (request-scoped HTTP servers can
    re-point a label at a different URL between turns)."""
    return tuple(sorted(
        (name, getattr(srv, "url", ""))
        for name, srv in registry._servers.items()
    ))


class SessionManager:
    """TTL-evicting session store (core/session.rs SessionPool analog)."""

    def __init__(self, ttl: float = 900.0, max_sessions: int = 1024):
        self.ttl = ttl
        self.max_sessions = max_sessions
        self._sessions: dict[str, McpSession] = {}

    async def _evict(self) -> None:
        now = time.monotonic()
        dead = [sid for sid, s in self._sessions.items()
                if now - s.last_used > self.ttl]
        # LRU overflow: oldest first beyond the cap
        if len(self._sessions) - len(dead) > self.max_sessions:
            alive = sorted(
                (s for sid, s in self._sessions.items() if sid not in dead),
                key=lambda s: s.last_used,
            )
            dead += [s.id for s in alive[: len(self._sessions) - len(dead)
                                         - self.max_sessions]]
        for sid in dead:
            s = self._sessions.pop(sid, None)
            if s is not None:
                try:
                    await s.close()
                except Exception:
                    logger.exception("closing MCP session %s failed", sid)

    async def get_or_create(self, session_id: str | None, registry: McpRegistry,
                            tenant: str | None = None,
                            owned: "list | None" = None) -> McpSession:
        await self._evict()
        if session_id is not None and session_id in self._sessions:
            s = self._sessions[session_id]
            # reuse only when the server set (identity incl. URL, not just
            # names — a re-labelled URL must not ride a stale connection)
            # and tenant still match
            if s.tenant == tenant and _fingerprint(s.registry) == _fingerprint(registry):
                s.touch()
                return s
            stale = self._sessions.pop(session_id, None)
            if stale is not None:
                try:
                    await stale.close()
                except Exception:
                    logger.exception("closing replaced MCP session failed")
        sid = session_id or f"mcps_{uuid.uuid4().hex[:16]}"
        s = McpSession(sid, registry, tenant=tenant, owned=owned)
        self._sessions[sid] = s
        return s

    def get(self, session_id: str) -> McpSession | None:
        return self._sessions.get(session_id)

    @property
    def count(self) -> int:
        return len(self._sessions)

    async def close(self) -> None:
        for s in list(self._sessions.values()):
            try:
                await s.close()
            except Exception:
                pass
        self._sessions.clear()
