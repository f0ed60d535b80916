"""xAI backend adapter.
The port's copy of ``smg_tpu/gateway/providers/xai.py``.

Reference: ``routers/openai/provider/xai.rs`` — xAI speaks the OpenAI wire
format for chat, so the adapter inherits the passthrough; the one xAI
-specific transform is on the RESPONSES surface: historical items replayed
from ``previous_response_id`` chains must drop server-side ``id``/``status``
fields and rewrite ``output_text`` content parts to ``input_text`` (xAI
rejects output-typed parts on input).
"""

from __future__ import annotations

import json
from typing import Any, AsyncIterator

from smg_tpu_torch.gateway.providers.base import ProviderError, iter_sse_data
from smg_tpu_torch.gateway.providers.openai import OpenAIAdapter


def transform_responses_input(body: dict) -> dict:
    """Rewrite Responses API input items to the shape xAI accepts
    (xai.rs ``transform_responses_input``); mutates and returns ``body``."""
    items = body.get("input")
    if not isinstance(items, list):
        return body
    for item in items:
        if not isinstance(item, dict):
            continue
        item.pop("id", None)
        item.pop("status", None)
        content = item.get("content")
        if not isinstance(content, list):
            continue
        for part in content:
            if isinstance(part, dict) and part.get("type") == "output_text":
                part["type"] = "input_text"
    return body


class XAIAdapter(OpenAIAdapter):
    kind = "xai"

    async def responses(self, body: dict) -> dict[str, Any]:
        """Responses API passthrough with the xAI input rewrite."""
        gateway_model = body.get("model", "")
        body = transform_responses_input(dict(body))
        body["model"] = self.spec.upstream_model(gateway_model)
        body["stream"] = False
        s = await self.session()
        async with s.post(
            f"{self.spec.base_url}/responses", json=body, headers=self._headers()
        ) as resp:
            if resp.status != 200:
                raise ProviderError(resp.status, await resp.text())
            data = await resp.json()
            if isinstance(data, dict):
                # echo the gateway-facing id, not the remapped upstream one
                data["model"] = gateway_model
            return data

    async def responses_stream(self, body: dict) -> AsyncIterator[tuple[str, dict]]:
        body = transform_responses_input(dict(body))
        body["model"] = self.spec.upstream_model(body.get("model", ""))
        body["stream"] = True
        s = await self.session()
        async with s.post(
            f"{self.spec.base_url}/responses", json=body, headers=self._headers()
        ) as resp:
            if resp.status != 200:
                raise ProviderError(resp.status, await resp.text())
            async for data in iter_sse_data(resp):
                if data.strip() == "[DONE]":
                    return
                try:
                    payload = json.loads(data)
                except ValueError:
                    continue
                yield payload.get("type", "message"), payload
