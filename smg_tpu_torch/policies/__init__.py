"""Load-balancing policies — the port's copy of ``smg_tpu/policies``: the
simple policies and ``cache_aware`` (the default).  The hashing policies and
the DP-rank policies are not ported yet."""

from smg_tpu_torch.policies import cache_aware as _cache_aware  # noqa: F401
from smg_tpu_torch.policies import simple as _simple  # noqa: F401
from smg_tpu_torch.policies.base import (
    DECISION_KEYS,
    DECISION_SCHEMA_VERSION,
    Policy,
    PolicyRegistry,
    RequestContext,
    RouteDecision,
    get_policy,
)

__all__ = [
    "DECISION_KEYS", "DECISION_SCHEMA_VERSION", "Policy", "PolicyRegistry",
    "RequestContext", "RouteDecision", "get_policy",
]
