"""OpenAI-compatible backend adapter (OpenAI, xAI, any OAI-format server).
The port's copy of ``smg_tpu/gateway/providers/openai.py``.

Reference: ``routers/openai/provider/openai.rs`` — near-passthrough: the
gateway's front API is already OpenAI format, so translation is limited to
model remapping and auth headers.  Streaming forwards upstream SSE chunks
verbatim (parsed, so the gateway can re-frame and meter them).
"""

from __future__ import annotations

import json
from typing import Any, AsyncIterator

from smg_tpu_torch.gateway.providers.base import (
    ProviderAdapter,
    ProviderError,
    iter_sse_data,
)
from smg_tpu_torch.protocols.openai import ChatCompletionRequest


class OpenAIAdapter(ProviderAdapter):
    kind = "openai"

    def _headers(self) -> dict[str, str]:
        h = {"content-type": "application/json"}
        if self.spec.api_key:
            h["authorization"] = f"Bearer {self.spec.api_key}"
        return h

    def _body(self, req: ChatCompletionRequest, stream: bool) -> dict[str, Any]:
        body = req.model_dump(exclude_none=True, exclude_unset=True)
        body["model"] = self.spec.upstream_model(req.model)
        body["stream"] = stream
        # gateway-local extensions that OAI backends reject
        for k in ("ignore_eos", "skip_special_tokens", "separate_reasoning",
                  "min_p", "top_k", "repetition_penalty"):
            body.pop(k, None)
        return body

    async def chat(self, req: ChatCompletionRequest) -> dict[str, Any]:
        s = await self.session()
        async with s.post(
            f"{self.spec.base_url}/chat/completions",
            json=self._body(req, stream=False),
            headers=self._headers(),
        ) as resp:
            if resp.status != 200:
                raise ProviderError(resp.status, await resp.text())
            data = await resp.json()
            # echo the gateway-facing id, not the remapped upstream one
            data["model"] = req.model
            return data

    async def chat_stream(self, req: ChatCompletionRequest) -> AsyncIterator[dict[str, Any]]:
        s = await self.session()
        async with s.post(
            f"{self.spec.base_url}/chat/completions",
            json=self._body(req, stream=True),
            headers=self._headers(),
        ) as resp:
            if resp.status != 200:
                raise ProviderError(resp.status, await resp.text())
            async for data in iter_sse_data(resp):
                if data.strip() == "[DONE]":
                    return
                try:
                    chunk = json.loads(data)
                except ValueError:
                    continue
                if isinstance(chunk, dict):
                    chunk["model"] = req.model
                yield chunk
