"""MCP approval flow: policy engine, pending-approval store, audit log.

Reference: ``crates/mcp/src/approval/{policy,manager,audit}.rs`` — tool
calls are gated by a policy engine (allow / deny / require approval, with
per-server and per-tool rules, trust levels, and read-only-hint conditions);
calls that require approval park in a pending store keyed by
``(request_id, server, tool)`` until a decision arrives or the TTL expires,
and every decision lands in an audit log.

The port's copy of ``smg_tpu/mcp/approval.py``, unchanged but for its
imports.
"""

from __future__ import annotations

import fnmatch
import time
from dataclasses import dataclass, field
from enum import Enum

from smg_tpu_torch.mcp.errors import ApprovalNotFound
from smg_tpu_torch.utils import get_logger

logger = get_logger("mcp.approval")


class Decision(Enum):
    ALLOW = "allow"  # run without asking
    DENY = "deny"  # never run
    REQUIRE_APPROVAL = "require_approval"  # park until a human says yes


class TrustLevel(Enum):
    """Server trust shorthand (policy.rs TrustLevel): trusted servers run
    tools unprompted, untrusted ones require approval for every call."""

    TRUSTED = "trusted"
    UNTRUSTED = "untrusted"


@dataclass
class PolicyRule:
    """Glob rule over ``server`` / ``tool`` with an optional read-only-hint
    condition (annotations.rs ToolAnnotations.readOnlyHint): a rule with
    ``only_if_write=True`` matches only tools that may mutate state."""

    server: str = "*"
    tool: str = "*"
    decision: Decision = Decision.ALLOW
    only_if_write: bool = False
    reason: str = ""

    def matches(self, server: str, tool: str, read_only: bool = False) -> bool:
        if not fnmatch.fnmatch(server, self.server):
            return False
        if not fnmatch.fnmatch(tool, self.tool):
            return False
        if self.only_if_write and read_only:
            return False
        return True


class ApprovalPolicy:
    """First-match rule list + per-server trust defaults + global default."""

    def __init__(self, default: Decision = Decision.ALLOW):
        self.default = default
        self.rules: list[PolicyRule] = []
        self._server_trust: dict[str, TrustLevel] = {}

    def add_rule(self, rule: PolicyRule) -> "ApprovalPolicy":
        self.rules.append(rule)
        return self

    def set_server_trust(self, server: str, trust: TrustLevel) -> "ApprovalPolicy":
        self._server_trust[server] = trust
        return self

    def evaluate(self, server: str, tool: str, read_only: bool = False) -> tuple[Decision, str]:
        for rule in self.rules:
            if rule.matches(server, tool, read_only):
                return rule.decision, rule.reason
        trust = self._server_trust.get(server)
        if trust is TrustLevel.UNTRUSTED:
            return Decision.REQUIRE_APPROVAL, f"server {server!r} is untrusted"
        if trust is TrustLevel.TRUSTED:
            return Decision.ALLOW, ""
        return self.default, ""


@dataclass
class AuditEntry:
    at: float
    server: str
    tool: str
    decision: str
    reason: str = ""
    request_id: str = ""


class AuditLog:
    """Bounded in-memory decision trail (audit.rs); newest last."""

    def __init__(self, cap: int = 1000):
        self.cap = cap
        self.entries: list[AuditEntry] = []

    def record(self, server: str, tool: str, decision: str, reason: str = "",
               request_id: str = "") -> None:
        self.entries.append(AuditEntry(
            at=time.time(), server=server, tool=tool, decision=decision,
            reason=reason, request_id=request_id,
        ))
        if len(self.entries) > self.cap:
            del self.entries[: len(self.entries) - self.cap]

    def tail(self, n: int = 50) -> list[AuditEntry]:
        return self.entries[-n:]


@dataclass
class PendingApproval:
    key: str
    server: str
    tool: str
    arguments: str  # json text
    request_id: str
    created_at: float = field(default_factory=time.monotonic)


class ApprovalManager:
    """Pending store + decision intake (manager.rs).

    ``check`` runs the policy; REQUIRE_APPROVAL parks the call and the
    caller surfaces an ``mcp_approval_request`` item.  ``decide`` consumes
    the pending entry (approve/deny) and audits it.  Expired entries are
    evicted lazily on every access."""

    def __init__(self, policy: ApprovalPolicy | None = None,
                 audit: AuditLog | None = None, timeout: float = 600.0):
        self.policy = policy or ApprovalPolicy()
        self.audit = audit or AuditLog()
        self.timeout = timeout
        self._pending: dict[str, PendingApproval] = {}

    def _evict_expired(self) -> None:
        now = time.monotonic()
        for k in [k for k, p in self._pending.items()
                  if now - p.created_at > self.timeout]:
            p = self._pending.pop(k)
            self.audit.record(p.server, p.tool, "expired", request_id=p.request_id)

    def check(self, server: str, tool: str, arguments: str,
              request_id: str = "", read_only: bool = False,
              force_approval: bool = False) -> "PendingApproval | None":
        """Returns None when the call may run now; a PendingApproval when it
        must wait; raises ToolDenied when policy forbids it outright.
        ``force_approval`` is the request-level ``require_approval: always``
        (Responses API) — policy DENY still wins."""
        from smg_tpu_torch.mcp.errors import ToolDenied

        self._evict_expired()
        decision, reason = self.policy.evaluate(server, tool, read_only)
        if decision is Decision.DENY:
            self.audit.record(server, tool, "denied", reason, request_id)
            raise ToolDenied(reason or f"policy denies {tool!r} on {server!r}")
        if decision is Decision.ALLOW and not force_approval:
            self.audit.record(server, tool, "allowed", reason, request_id)
            return None
        import uuid

        # unguessable: the key doubles as the client-facing item id and a
        # sequential counter would let one caller aim at another's approvals
        key = f"mcpr_{uuid.uuid4().hex[:20]}"
        pending = PendingApproval(key=key, server=server, tool=tool,
                                  arguments=arguments, request_id=request_id)
        self._pending[key] = pending
        self.audit.record(server, tool, "pending", reason, request_id)
        return pending

    def restore(self, key: str, server: str, tool: str, arguments: str,
                request_id: str = "") -> None:
        """Re-park an approval rebuilt from a stored response (stateless
        resume across gateway instances)."""
        self._pending[key] = PendingApproval(
            key=key, server=server, tool=tool, arguments=arguments,
            request_id=request_id,
        )

    def decide(self, key: str, approve: bool, reason: str = "") -> PendingApproval:
        """Consume a pending approval; raises ApprovalNotFound for unknown /
        expired keys."""
        self._evict_expired()
        pending = self._pending.pop(key, None)
        if pending is None:
            raise ApprovalNotFound(f"no pending approval {key!r}")
        self.audit.record(pending.server, pending.tool,
                          "approved" if approve else "denied",
                          reason, pending.request_id)
        return pending

    def pending_count(self) -> int:
        self._evict_expired()
        return len(self._pending)

    def has_pending(self, key: str) -> bool:
        self._evict_expired()
        return key in self._pending
