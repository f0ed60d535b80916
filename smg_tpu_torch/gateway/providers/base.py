"""Provider adapter interface — 3rd-party backends behind the gateway.
The port's copy of ``smg_tpu/gateway/providers/base.py``.

Reference: ``model_gateway/src/routers/openai/provider/`` — the gateway can
route ``/v1/chat/completions`` traffic to cloud providers (OpenAI, Anthropic,
Gemini, xAI, …) instead of self-hosted workers, translating request/response
wire formats per backend (``provider/registry.rs``).  Adapters speak raw wire
dicts on the way out so OpenAI-compatible backends stay byte-faithful
passthroughs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, AsyncIterator

import aiohttp

from smg_tpu_torch.protocols.openai import ChatCompletionRequest


class ProviderError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


@dataclass
class ProviderSpec:
    """One configured backend provider."""

    name: str  # routing prefix: "openai" serves models "openai/..."
    kind: str  # adapter type: openai | anthropic | gemini
    base_url: str
    api_key: str = ""
    models: list[str] = field(default_factory=list)  # exact model names served
    model_map: dict[str, str] = field(default_factory=dict)  # gateway -> upstream
    timeout_s: float = 300.0

    def upstream_model(self, model: str) -> str:
        """Strip the routing prefix and apply any explicit remap."""
        if model.startswith(self.name + "/"):
            model = model[len(self.name) + 1 :]
        return self.model_map.get(model, model)


class ProviderAdapter:
    """Translates gateway chat requests to one upstream wire format."""

    def __init__(self, spec: ProviderSpec, session: aiohttp.ClientSession | None = None):
        self.spec = spec
        self._session = session

    async def session(self) -> aiohttp.ClientSession:
        if self._session is None or self._session.closed:
            self._session = aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(total=self.spec.timeout_s)
            )
        return self._session

    async def close(self) -> None:
        if self._session is not None and not self._session.closed:
            await self._session.close()

    # -- adapter API: both return OpenAI chat-completion wire dicts --

    async def chat(self, req: ChatCompletionRequest) -> dict[str, Any]:
        raise NotImplementedError

    def chat_stream(self, req: ChatCompletionRequest) -> AsyncIterator[dict[str, Any]]:
        raise NotImplementedError


def stop_list(stop) -> list[str]:
    """Normalize OpenAI's str | list[str] | None stop field."""
    if isinstance(stop, list):
        return stop
    return [stop] if stop else []


def make_chunk_framer(rid: str, created: int, model: str):
    """Shared chat.completion.chunk builder for translating adapters."""

    def frame(delta: dict[str, Any], finish: str | None = None) -> dict[str, Any]:
        return {
            "id": rid,
            "object": "chat.completion.chunk",
            "created": created,
            "model": model,
            "choices": [{"index": 0, "delta": delta, "finish_reason": finish}],
        }

    return frame


async def iter_sse_data(resp: aiohttp.ClientResponse) -> AsyncIterator[str]:
    """Yield the payload of each ``data:`` SSE frame (multi-line aware)."""
    buf: list[str] = []
    async for raw in resp.content:
        line = raw.decode("utf-8", errors="replace").rstrip("\r\n")
        if line.startswith("data:"):
            buf.append(line[5:].lstrip())
        elif line == "" and buf:
            yield "\n".join(buf)
            buf = []
    if buf:
        yield "\n".join(buf)
