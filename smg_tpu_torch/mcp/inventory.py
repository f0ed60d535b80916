"""Per-tenant MCP server inventory.

Reference: ``crates/mcp/src/inventory/`` + ``tenant.rs`` — the gateway owns
a global server catalog; each tenant sees an allowed subset (or everything
when no tenancy is configured).  ``registry_for`` materializes a tenant's
view as a plain :class:`McpRegistry` so the rest of the stack (sessions,
tool loop) stays tenancy-unaware.

The port's copy of ``smg_tpu/mcp/inventory.py``, unchanged but for its
imports.
"""

from __future__ import annotations

from smg_tpu_torch.mcp.client import McpRegistry, McpToolServer
from smg_tpu_torch.mcp.errors import ServerAccessDenied, ServerNotFound
from smg_tpu_torch.utils import get_logger

logger = get_logger("mcp.inventory")


class McpInventory:
    def __init__(self):
        self._servers: dict[str, McpToolServer] = {}
        # tenant -> allowed server names; absent tenant = all servers
        self._tenant_allow: dict[str, set[str]] = {}
        # servers REGISTERED tenant-restricted; public servers never enter
        # this set, so granting a tenant explicit access to a public server
        # can't silently revoke it from everyone else
        self._restricted: set[str] = set()

    # ---- catalog ----

    def add_server(self, server: McpToolServer,
                   tenants: "list[str] | None" = None) -> None:
        """Register a server globally; ``tenants`` restricts visibility to
        those tenants (and implicitly creates their allowlists)."""
        self._servers[server.name] = server
        if tenants:
            self._restricted.add(server.name)
            for t in tenants:
                self._tenant_allow.setdefault(t, set()).add(server.name)

    def remove_server(self, name: str) -> None:
        self._servers.pop(name, None)
        self._restricted.discard(name)
        for allowed in self._tenant_allow.values():
            allowed.discard(name)

    def allow(self, tenant: str, server_name: str) -> None:
        if server_name not in self._servers:
            raise ServerNotFound(server_name)
        self._tenant_allow.setdefault(tenant, set()).add(server_name)

    @property
    def servers(self) -> list[str]:
        return sorted(self._servers)

    def servers_for(self, tenant: str | None) -> list[str]:
        """Visible servers: everyone sees the public (unrestricted) ones;
        servers registered with an explicit tenant list are visible only to
        those tenants."""
        visible = set(self._servers) - self._restricted
        if tenant is not None and tenant in self._tenant_allow:
            visible |= self._tenant_allow[tenant] & set(self._servers)
        return sorted(visible)

    def check_access(self, tenant: str | None, server_name: str) -> None:
        if server_name not in self._servers:
            raise ServerNotFound(server_name)
        if server_name not in self.servers_for(tenant):
            raise ServerAccessDenied(
                f"tenant {tenant!r} may not use MCP server {server_name!r}"
            )

    def registry_for(self, tenant: str | None,
                     extra: "list[McpToolServer] | None" = None) -> McpRegistry:
        """Tenant view as a registry; ``extra`` appends request-level
        servers (Responses API ``type: mcp`` tools)."""
        reg = McpRegistry()
        for name in self.servers_for(tenant):
            reg.add(self._servers[name])
        for s in extra or []:
            reg.add(s)
        return reg
