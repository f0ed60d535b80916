"""Anthropic Messages backend adapter.
The port's copy of ``smg_tpu/gateway/providers/anthropic.py``.

Reference: ``routers/openai/provider/anthropic.rs`` — translates OpenAI chat
format to the Anthropic Messages API and back, including tool use and
streaming event re-framing:

request:  system messages -> ``system``; assistant ``tool_calls`` ->
          ``tool_use`` content blocks; ``tool`` role -> ``tool_result`` user
          blocks; tools -> ``input_schema`` defs.
response: text/tool_use blocks -> message.content / tool_calls;
          stop_reason end_turn|max_tokens|tool_use|stop_sequence ->
          stop|length|tool_calls|stop.
stream:   message_start / content_block_{start,delta,stop} / message_delta
          events -> OpenAI chat.completion.chunk frames.
"""

from __future__ import annotations

import json
import time
import uuid
from typing import Any, AsyncIterator

from smg_tpu_torch.gateway.providers.base import (
    ProviderAdapter,
    ProviderError,
    iter_sse_data,
    make_chunk_framer,
    stop_list,
)
from smg_tpu_torch.protocols.openai import ChatCompletionRequest

_STOP_REASON = {
    "end_turn": "stop",
    "stop_sequence": "stop",
    "max_tokens": "length",
    "tool_use": "tool_calls",
}


def chat_to_messages(req: ChatCompletionRequest, model: str) -> dict[str, Any]:
    system_parts: list[str] = []
    messages: list[dict[str, Any]] = []
    for m in req.messages:
        if m.role == "system":
            if isinstance(m.content, str):
                system_parts.append(m.content)
            elif isinstance(m.content, list):
                system_parts.extend(
                    p.get("text", "") for p in m.content if p.get("type") == "text"
                )
            continue
        if m.role == "tool":
            block = {
                "type": "tool_result",
                "tool_use_id": m.tool_call_id or "",
                "content": m.content if isinstance(m.content, str) else json.dumps(m.content),
            }
            # Anthropic requires tool results inside a user turn; merge into a
            # preceding user turn made of tool_results when present
            if messages and messages[-1]["role"] == "user" and isinstance(
                messages[-1]["content"], list
            ):
                messages[-1]["content"].append(block)
            else:
                messages.append({"role": "user", "content": [block]})
            continue
        content: list[dict[str, Any]] = []
        if isinstance(m.content, str) and m.content:
            content.append({"type": "text", "text": m.content})
        elif isinstance(m.content, list):
            for p in m.content:
                if p.get("type") == "text":
                    content.append({"type": "text", "text": p.get("text", "")})
        if m.role == "assistant" and m.tool_calls:
            for tc in m.tool_calls:
                try:
                    args = json.loads(tc.function.arguments or "{}")
                except ValueError:
                    args = {}
                content.append({
                    "type": "tool_use",
                    "id": tc.id or f"toolu_{uuid.uuid4().hex[:16]}",
                    "name": tc.function.name or "",
                    "input": args,
                })
        messages.append({"role": m.role, "content": content or m.content or ""})

    body: dict[str, Any] = {
        "model": model,
        "messages": messages,
        "max_tokens": req.max_completion_tokens or req.max_tokens or 1024,
    }
    if system_parts:
        body["system"] = "\n".join(system_parts)
    if req.temperature is not None:
        body["temperature"] = req.temperature
    if req.top_p is not None:
        body["top_p"] = req.top_p
    if req.top_k is not None:
        body["top_k"] = req.top_k
    stops = stop_list(req.stop)
    if stops:
        body["stop_sequences"] = stops
    if req.tools:
        body["tools"] = [
            {
                "name": t.function.name,
                "description": t.function.description or "",
                "input_schema": t.function.parameters or {"type": "object"},
            }
            for t in req.tools
        ]
    if req.tool_choice is not None:
        if req.tool_choice == "none":
            body.pop("tools", None)
        elif req.tool_choice == "required":
            body["tool_choice"] = {"type": "any"}
        elif isinstance(req.tool_choice, dict):
            name = (req.tool_choice.get("function") or {}).get("name")
            if name:
                body["tool_choice"] = {"type": "tool", "name": name}
        else:
            body["tool_choice"] = {"type": "auto"}
    return body


def messages_to_chat(data: dict[str, Any], model: str) -> dict[str, Any]:
    text_parts: list[str] = []
    tool_calls: list[dict[str, Any]] = []
    for block in data.get("content") or []:
        if block.get("type") == "text":
            text_parts.append(block.get("text", ""))
        elif block.get("type") == "tool_use":
            tool_calls.append({
                "id": block.get("id"),
                "type": "function",
                "index": len(tool_calls),
                "function": {
                    "name": block.get("name"),
                    "arguments": json.dumps(block.get("input") or {}),
                },
            })
    message: dict[str, Any] = {"role": "assistant", "content": "".join(text_parts) or None}
    if tool_calls:
        message["tool_calls"] = tool_calls
    usage = data.get("usage") or {}
    return {
        "id": data.get("id") or f"chatcmpl-{uuid.uuid4().hex[:24]}",
        "object": "chat.completion",
        "created": int(time.time()),
        "model": model,
        "choices": [{
            "index": 0,
            "message": message,
            "finish_reason": _STOP_REASON.get(data.get("stop_reason"), "stop"),
        }],
        "usage": {
            "prompt_tokens": usage.get("input_tokens", 0),
            "completion_tokens": usage.get("output_tokens", 0),
            "total_tokens": usage.get("input_tokens", 0) + usage.get("output_tokens", 0),
        },
    }


class AnthropicAdapter(ProviderAdapter):
    kind = "anthropic"

    def _headers(self) -> dict[str, str]:
        h = {"content-type": "application/json", "anthropic-version": "2023-06-01"}
        if self.spec.api_key:
            h["x-api-key"] = self.spec.api_key
        return h

    async def chat(self, req: ChatCompletionRequest) -> dict[str, Any]:
        model = self.spec.upstream_model(req.model)
        s = await self.session()
        async with s.post(
            f"{self.spec.base_url}/messages",
            json=chat_to_messages(req, model),
            headers=self._headers(),
        ) as resp:
            if resp.status != 200:
                raise ProviderError(resp.status, await resp.text())
            return messages_to_chat(await resp.json(), req.model)

    async def chat_stream(self, req: ChatCompletionRequest) -> AsyncIterator[dict[str, Any]]:
        model = self.spec.upstream_model(req.model)
        body = chat_to_messages(req, model)
        body["stream"] = True
        frame = make_chunk_framer(
            f"chatcmpl-{uuid.uuid4().hex[:24]}", int(time.time()), req.model
        )
        s = await self.session()
        async with s.post(
            f"{self.spec.base_url}/messages", json=body, headers=self._headers()
        ) as resp:
            if resp.status != 200:
                raise ProviderError(resp.status, await resp.text())
            yield frame({"role": "assistant"})
            tool_idx = -1
            finish = "stop"
            async for data in iter_sse_data(resp):
                try:
                    ev = json.loads(data)
                except ValueError:
                    continue
                et = ev.get("type")
                if et == "error":
                    # documented mid-stream failure (e.g. overloaded_error):
                    # surface it instead of faking a clean completion
                    err = ev.get("error") or {}
                    raise ProviderError(
                        502, f"{err.get('type', 'error')}: {err.get('message', '')}"
                    )
                if et == "content_block_start":
                    block = ev.get("content_block") or {}
                    if block.get("type") == "tool_use":
                        tool_idx += 1
                        yield frame({
                            "tool_calls": [{
                                "index": tool_idx,
                                "id": block.get("id"),
                                "type": "function",
                                "function": {"name": block.get("name"), "arguments": ""},
                            }]
                        })
                elif et == "content_block_delta":
                    d = ev.get("delta") or {}
                    if d.get("type") == "text_delta":
                        yield frame({"content": d.get("text", "")})
                    elif d.get("type") == "input_json_delta":
                        yield frame({
                            "tool_calls": [{
                                "index": tool_idx,
                                "function": {"arguments": d.get("partial_json", "")},
                            }]
                        })
                elif et == "message_delta":
                    sr = (ev.get("delta") or {}).get("stop_reason")
                    if sr:
                        finish = _STOP_REASON.get(sr, "stop")
                elif et == "message_stop":
                    break
            yield frame({}, finish=finish)
