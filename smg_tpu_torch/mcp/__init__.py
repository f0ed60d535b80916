"""MCP client orchestration (reference: ``crates/mcp`` smg-mcp, SURVEY.md §2.2):
server inventory, sessions, tool execution with approval flow, tenancy, and
a typed error taxonomy.

The port's copy of ``smg_tpu/mcp/__init__.py``, unchanged but for its
imports.
"""

from smg_tpu_torch.mcp.approval import (
    ApprovalManager,
    ApprovalPolicy,
    AuditLog,
    Decision,
    PolicyRule,
    TrustLevel,
)
from smg_tpu_torch.mcp.client import (
    HttpMcpServer,
    LocalToolServer,
    McpRegistry,
    McpToolServer,
    ToolInfo,
)
from smg_tpu_torch.mcp.errors import (
    ApprovalDeniedError,
    ApprovalNotFound,
    ApprovalRequired,
    McpError,
    ServerAccessDenied,
    ServerNotFound,
    ToolCollision,
    ToolDenied,
    ToolExecutionError,
    ToolNotFound,
)
from smg_tpu_torch.mcp.inventory import McpInventory
from smg_tpu_torch.mcp.sessions import McpSession, SessionManager

__all__ = [
    "McpToolServer",
    "LocalToolServer",
    "HttpMcpServer",
    "McpRegistry",
    "ToolInfo",
    "McpInventory",
    "McpSession",
    "SessionManager",
    "ApprovalManager",
    "ApprovalPolicy",
    "AuditLog",
    "Decision",
    "PolicyRule",
    "TrustLevel",
    "McpError",
    "ServerNotFound",
    "ServerAccessDenied",
    "ToolNotFound",
    "ToolCollision",
    "ToolDenied",
    "ToolExecutionError",
    "ApprovalRequired",
    "ApprovalDeniedError",
    "ApprovalNotFound",
]
