"""Load-balancing policies — the port's copy of ``smg_tpu/policies``: the
simple policies, ``prefix_hash`` and ``consistent_hashing``, and
``cache_aware`` (the default) over the native radix tree where it builds;
``policies/dp.py`` holds the DP-rank stage the router runs after a worker
is picked."""

from smg_tpu_torch.policies import cache_aware as _cache_aware  # noqa: F401
from smg_tpu_torch.policies import hashing as _hashing  # noqa: F401
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
