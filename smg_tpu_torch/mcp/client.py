"""MCP tool servers + registry.

Reference: ``crates/mcp`` — server inventory, session management, tool
execution, approval flow, tenancy (SURVEY.md §2.2).  Two transports:

- ``LocalToolServer``: in-process Python tools (tests, built-ins);
- ``HttpMcpServer``: MCP streamable-HTTP JSON-RPC (initialize / tools/list /
  tools/call), the wire protocol MCP servers speak.

The port's copy of ``smg_tpu/mcp/client.py``, unchanged but for its imports.
"""

from __future__ import annotations

import asyncio
import itertools
import json
from dataclasses import dataclass, field
from typing import Any, Callable

from smg_tpu_torch.utils import get_logger

logger = get_logger("mcp")


@dataclass
class ToolInfo:
    name: str
    description: str = ""
    input_schema: dict = field(default_factory=dict)
    server: str = ""


class McpToolServer:
    name: str = "server"

    async def list_tools(self) -> list[ToolInfo]:
        raise NotImplementedError

    async def call_tool(self, name: str, arguments: dict) -> str:
        """Returns the tool result as text (JSON-encoded when structured)."""
        raise NotImplementedError

    async def close(self) -> None:
        pass


class LocalToolServer(McpToolServer):
    def __init__(self, name: str = "local"):
        self.name = name
        self._tools: dict[str, tuple[ToolInfo, Callable]] = {}

    def register(self, name: str, fn: Callable, description: str = "",
                 input_schema: dict | None = None) -> None:
        info = ToolInfo(name=name, description=description,
                        input_schema=input_schema or {}, server=self.name)
        self._tools[name] = (info, fn)

    async def list_tools(self) -> list[ToolInfo]:
        return [info for info, _ in self._tools.values()]

    async def call_tool(self, name: str, arguments: dict) -> str:
        if name not in self._tools:
            raise KeyError(f"unknown tool {name!r}")
        _, fn = self._tools[name]
        result = fn(**arguments)
        if asyncio.iscoroutine(result):
            result = await result
        return result if isinstance(result, str) else json.dumps(result)


class HttpMcpServer(McpToolServer):
    """MCP over streamable HTTP (JSON-RPC 2.0)."""

    def __init__(self, name: str, url: str, headers: dict | None = None):
        self.name = name
        self.url = url
        self.headers = {"Content-Type": "application/json", **(headers or {})}
        self._ids = itertools.count(1)
        self._session = None
        self._initialized = False

    async def _http(self):
        if self._session is None:
            import aiohttp

            self._session = aiohttp.ClientSession()
        return self._session

    async def _rpc(self, method: str, params: dict | None = None) -> Any:
        session = await self._http()
        payload = {"jsonrpc": "2.0", "id": next(self._ids), "method": method,
                   "params": params or {}}
        async with session.post(self.url, json=payload, headers=self.headers) as resp:
            ctype = resp.headers.get("Content-Type", "")
            if "text/event-stream" in ctype:
                # streamable-http servers may answer via a one-shot SSE body
                async for line in resp.content:
                    line = line.decode().strip()
                    if line.startswith("data:"):
                        body = json.loads(line[5:].strip())
                        break
                else:
                    raise RuntimeError("empty SSE response from MCP server")
            else:
                body = await resp.json()
        if "error" in body:
            raise RuntimeError(f"MCP error: {body['error']}")
        return body.get("result")

    async def _ensure_init(self) -> None:
        if not self._initialized:
            await self._rpc(
                "initialize",
                {
                    "protocolVersion": "2025-03-26",
                    "capabilities": {},
                    "clientInfo": {"name": "smg-tpu", "version": "0.1.0"},
                },
            )
            self._initialized = True

    async def list_tools(self) -> list[ToolInfo]:
        await self._ensure_init()
        result = await self._rpc("tools/list")
        return [
            ToolInfo(
                name=t["name"],
                description=t.get("description", ""),
                input_schema=t.get("inputSchema", {}),
                server=self.name,
            )
            for t in result.get("tools", [])
        ]

    async def call_tool(self, name: str, arguments: dict) -> str:
        await self._ensure_init()
        result = await self._rpc("tools/call", {"name": name, "arguments": arguments})
        parts = result.get("content", [])
        texts = [p.get("text", "") for p in parts if p.get("type") == "text"]
        return "\n".join(texts) if texts else json.dumps(result)

    async def close(self) -> None:
        if self._session is not None:
            await self._session.close()


class McpRegistry:
    """Named MCP servers; flat tool namespace with a cached name->servers
    map (refreshed on registry change or lookup miss, not per call).

    Multi-server routing (reference: ``crates/mcp`` inventory index): a tool
    name owned by several servers is a COLLISION — unqualified calls raise
    :class:`~smg_tpu_torch.mcp.errors.ToolCollision` and callers disambiguate
    with the qualified ``server.tool`` form, which always works."""

    def __init__(self):
        self._servers: dict[str, McpToolServer] = {}
        self._tool_map: dict[str, list[str]] | None = None  # tool -> servers

    def add(self, server: McpToolServer) -> None:
        self._servers[server.name] = server
        self._tool_map = None

    def remove(self, name: str) -> None:
        self._servers.pop(name, None)
        self._tool_map = None

    @property
    def servers(self) -> list[str]:
        return sorted(self._servers)

    async def list_tools(self) -> list[ToolInfo]:
        out: list[ToolInfo] = []
        tool_map: dict[str, list[str]] = {}
        for s in self._servers.values():
            try:
                tools = await s.list_tools()
            except Exception:
                logger.exception("tools/list failed for MCP server %s", s.name)
                continue
            for t in tools:
                tool_map.setdefault(t.name, []).append(s.name)
            out.extend(tools)
        self._tool_map = tool_map
        return out

    async def collisions(self) -> dict[str, list[str]]:
        """Tool names exported by more than one server."""
        if self._tool_map is None:
            await self.list_tools()
        return {t: s for t, s in (self._tool_map or {}).items() if len(s) > 1}

    def _resolve_qualified(self, name: str) -> "tuple[str, str] | None":
        """``server.tool`` -> (server, tool) when the server exists."""
        if "." in name:
            server, _, tool = name.partition(".")
            if server in self._servers:
                return server, tool
        return None

    async def call_tool(self, name: str, arguments: dict) -> str:
        from smg_tpu_torch.mcp.errors import (
            McpError,
            ToolCollision,
            ToolExecutionError,
            ToolNotFound,
        )

        qualified = self._resolve_qualified(name)
        if qualified is not None:
            server_name, tool = qualified
        else:
            if self._tool_map is None or name not in self._tool_map:
                await self.list_tools()  # refresh once on miss / first use
            owners = (self._tool_map or {}).get(name) or []
            if not owners:
                raise ToolNotFound(f"tool {name!r} not found in any MCP server")
            if len(owners) > 1:
                raise ToolCollision(name, owners)
            server_name, tool = owners[0], name
        if server_name not in self._servers:
            raise ToolNotFound(f"tool {name!r} not found in any MCP server")
        try:
            return await self._servers[server_name].call_tool(tool, arguments)
        except McpError:
            raise
        except Exception as e:
            raise ToolExecutionError(f"{tool!r} on {server_name!r}: {e}") from e

    async def close(self) -> None:
        for s in self._servers.values():
            await s.close()
