"""Third-party provider backends behind the gateway (OpenAI, xAI, Anthropic,
Gemini, Bedrock) — the port's copy of ``smg_tpu/gateway/providers``."""

from smg_tpu_torch.gateway.providers.base import ProviderAdapter, ProviderError, ProviderSpec
from smg_tpu_torch.gateway.providers.registry import ProviderRegistry

__all__ = ["ProviderAdapter", "ProviderError", "ProviderRegistry", "ProviderSpec"]
