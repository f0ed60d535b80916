"""Provider registry: model name -> backend adapter.
The port's copy of ``smg_tpu/gateway/providers/registry.py``.

Reference: ``routers/openai/provider/registry.rs``.  Resolution order:
1. exact model name listed in a spec's ``models``;
2. ``<provider-name>/<model>`` routing prefix (e.g. ``anthropic/claude-…``).

Specs load from a JSON config (``--provider-config``) whose entries mirror
ProviderSpec; ``api_key_env`` names the environment variable holding the key
so secrets never sit in the config file (reference: env-var passthrough,
``main.rs:625-664``).
"""

from __future__ import annotations

import json
import os

from smg_tpu_torch.gateway.providers.anthropic import AnthropicAdapter
from smg_tpu_torch.gateway.providers.base import ProviderAdapter, ProviderSpec
from smg_tpu_torch.gateway.providers.bedrock import BedrockAdapter
from smg_tpu_torch.gateway.providers.gemini import GeminiAdapter
from smg_tpu_torch.gateway.providers.openai import OpenAIAdapter
from smg_tpu_torch.gateway.providers.xai import XAIAdapter

_ADAPTERS = {
    "openai": OpenAIAdapter,
    "xai": XAIAdapter,  # OpenAI chat wire + Responses input rewrite
    "anthropic": AnthropicAdapter,
    "gemini": GeminiAdapter,
    "bedrock": BedrockAdapter,
}


class ProviderRegistry:
    def __init__(self):
        self._adapters: list[ProviderAdapter] = []

    def register(self, spec: ProviderSpec) -> ProviderAdapter:
        try:
            cls = _ADAPTERS[spec.kind]
        except KeyError:
            raise ValueError(
                f"unknown provider kind {spec.kind!r}; have {sorted(_ADAPTERS)}"
            ) from None
        adapter = cls(spec)
        self._adapters.append(adapter)
        return adapter

    def resolve(self, model: str | None) -> ProviderAdapter | None:
        if not model:
            return None
        for a in self._adapters:
            if model in a.spec.models:
                return a
        for a in self._adapters:
            if model.startswith(a.spec.name + "/"):
                return a
        return None

    def list_models(self) -> list[str]:
        return [m for a in self._adapters for m in a.spec.models]

    async def close(self) -> None:
        for a in self._adapters:
            await a.close()

    def load_config(self, path: str) -> None:
        with open(path) as f:
            entries = json.load(f)
        for e in entries:
            key = e.get("api_key", "")
            env = e.get("api_key_env")
            if env:
                key = os.environ.get(env, key)
            self.register(ProviderSpec(
                name=e.get("name") or e["kind"],
                kind=e["kind"],
                base_url=e["base_url"].rstrip("/"),
                api_key=key,
                models=list(e.get("models") or []),
                model_map=dict(e.get("model_map") or {}),
                timeout_s=float(e.get("timeout_s", 300.0)),
            ))
