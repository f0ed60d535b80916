"""MCP error taxonomy.

Reference: ``crates/mcp/src/error.rs`` — typed variants instead of bare
strings so callers (the Responses tool loop, the gateway error mapper) can
route on failure class: connection problems retry, policy denials surface
to the client, unknown tools 404.

The port's copy of ``smg_tpu/mcp/errors.py``, unchanged but for its imports.
"""

from __future__ import annotations


class McpError(Exception):
    """Base for every MCP failure; ``code`` is the wire-stable slug."""

    code = "mcp_error"

    def __init__(self, message: str = ""):
        super().__init__(message)
        self.message = message


class ServerNotFound(McpError):
    code = "server_not_found"


class ServerDisconnected(McpError):
    code = "server_disconnected"


class ToolNotFound(McpError):
    code = "tool_not_found"


class ToolCollision(McpError):
    """Same tool name exported by several servers and the caller didn't
    qualify which one (``server.tool``)."""

    code = "tool_collision"

    def __init__(self, tool_name: str, servers: list[str]):
        super().__init__(
            f"tool {tool_name!r} exists on servers {sorted(servers)}; "
            f"qualify as 'server.{tool_name}'"
        )
        self.tool_name = tool_name
        self.servers = sorted(servers)


class TransportError(McpError):
    code = "transport"


class ToolExecutionError(McpError):
    code = "tool_execution"


class ConnectionFailed(McpError):
    code = "connection_failed"


class ConfigError(McpError):
    code = "config"


class AuthError(McpError):
    code = "auth"


class InvalidArguments(McpError):
    code = "invalid_arguments"


class ServerAccessDenied(McpError):
    """Tenant policy forbids this server."""

    code = "server_access_denied"


class ToolDenied(McpError):
    """Policy engine denied the call outright (no approval possible)."""

    code = "tool_denied"


# ---- approval errors (error.rs ApprovalError) ----


class ApprovalError(McpError):
    code = "approval"


class ApprovalRequired(ApprovalError):
    """The call needs an interactive approval before it may run."""

    code = "approval_required"

    def __init__(self, key: str, server: str, tool: str, arguments: str):
        super().__init__(f"tool {tool!r} on {server!r} requires approval")
        self.key = key
        self.server = server
        self.tool = tool
        self.arguments = arguments


class ApprovalDeniedError(ApprovalError):
    code = "approval_denied"


class ApprovalTimeout(ApprovalError):
    code = "approval_timeout"


class ApprovalNotFound(ApprovalError):
    code = "approval_not_found"
