"""Multi-model router coordination — "IGW" mode; the port's copy of
``smg_tpu/gateway/router_manager.py``.

Reference: ``model_gateway/src/routers/router_manager.rs:1-5`` — one gateway
fronting several models, each with its own router instance, policy, and
parser configuration, over a shared worker registry.  Single-model
deployments keep using the default router untouched (the reference's
``enable_igw=false`` fast path).

Design notes: the reference keys
routers by (connection mode × routing mode) and weights selection by worker
counts; here every worker speaks the same token-level protocol (gRPC or
in-proc) and PD/EPD roles are resolved inside ``Router._execute``, so the
manager's job reduces to per-model configuration: a dedicated ``Router``
(with its own ``RouterConfig``) when the operator configures one, the shared
default otherwise.  Policies are already per-model via ``PolicyRegistry``.
"""

from __future__ import annotations

import dataclasses

from smg_tpu_torch.gateway.router import Router, RouterConfig
from smg_tpu_torch.policies.base import get_policy
from smg_tpu_torch.utils import get_logger

logger = get_logger("gateway.router_manager")

#: RouterConfig fields operators may set per model over the admin API
_CONFIG_FIELDS = frozenset(
    f.name for f in dataclasses.fields(RouterConfig)
)


class RouterManager:
    """Per-model :class:`Router` instances over shared registries."""

    def __init__(self, registry, policies, tokenizers, default_config=None,
                 metrics=None):
        self.registry = registry
        self.policies = policies
        self.tokenizers = tokenizers
        self.metrics = metrics
        self.default = Router(registry, policies, tokenizers, default_config,
                              metrics=metrics)
        self._per_model: dict[str, Router] = {}

    def router_for(self, model_id: str | None) -> Router:
        """Model-keyed dispatch: a dedicated router when configured, the
        shared default otherwise (reference: select_router_for_request)."""
        if model_id:
            r = self._per_model.get(model_id)
            if r is not None:
                return r
        return self.default

    def configure_model(
        self,
        model_id: str,
        policy: str | None = None,
        policy_args: dict | None = None,
        config: dict | None = None,
    ) -> dict:
        """Set a per-model policy and/or a dedicated router configuration.

        ``config`` keys must be RouterConfig fields; a dedicated Router is
        created (or replaced) only when config overrides are given — a
        policy-only change rides the shared default router, which resolves
        policies per model already.

        Validation is atomic: everything is checked (and the policy/router
        constructed) BEFORE any routing state mutates, so a 400 response
        really means nothing changed."""
        new_router = None
        if config:
            unknown = set(config) - _CONFIG_FIELDS
            if unknown:
                raise ValueError(
                    f"unknown router config fields: {sorted(unknown)}; "
                    f"known: {sorted(_CONFIG_FIELDS)}"
                )
            cfg = dataclasses.replace(self.default.config, **config)
            new_router = Router(
                self.registry, self.policies, self.tokenizers, cfg,
                metrics=self.metrics,
            )
        if policy is not None:
            try:
                get_policy(policy, **(policy_args or {}))  # dry construct
            except TypeError as e:
                raise ValueError(f"invalid policy args for {policy!r}: {e}")
            self.policies.set_policy(model_id, policy, **(policy_args or {}))
        if new_router is not None:
            self._per_model[model_id] = new_router
            logger.info("dedicated router configured for model %r: %s",
                        model_id, config)
        return self.describe_model(model_id)

    def reset_model(self, model_id: str) -> bool:
        """Drop a model's dedicated router (policy mapping is kept — it
        belongs to PolicyRegistry and falls back to the default on its own
        lifecycle).  Returns whether a dedicated router existed."""
        return self._per_model.pop(model_id, None) is not None

    def describe_model(self, model_id: str) -> dict:
        r = self._per_model.get(model_id)
        policy = (
            self.policies.policy_for(model_id).name
            if self.policies.has_policy(model_id)
            else None
        )
        return {
            "model_id": model_id,
            "dedicated_router": r is not None,
            "policy": policy,  # None = default policy resolved lazily
            "config": dataclasses.asdict((r or self.default).config),
            "workers": [
                w.worker_id for w in self.registry.list(model_id=model_id)
            ],
        }

    def describe(self) -> dict:
        models = sorted(
            set(self.registry.model_ids()) | set(self._per_model)
        )
        return {
            "default_config": dataclasses.asdict(self.default.config),
            "models": [self.describe_model(m) for m in models],
        }
