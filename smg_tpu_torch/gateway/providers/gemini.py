"""Gemini generateContent backend adapter.
The port's copy of ``smg_tpu/gateway/providers/gemini.py``.

Reference: ``routers/openai/provider/gemini.rs`` — translates OpenAI chat
format to Gemini's ``generateContent``/``streamGenerateContent`` and back:

request:  system -> ``systemInstruction``; assistant -> role "model";
          tool_calls -> ``functionCall`` parts; tool results ->
          ``functionResponse`` parts; tools -> ``functionDeclarations``;
          sampling -> ``generationConfig``.
response: candidate parts -> content/tool_calls; finishReason STOP|MAX_TOKENS
          -> stop|length; usageMetadata -> usage.
stream:   ``streamGenerateContent?alt=sse`` frames -> chat.completion.chunk.
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

_FINISH = {"STOP": "stop", "MAX_TOKENS": "length", "SAFETY": "content_filter"}


def chat_to_gemini(req: ChatCompletionRequest, want_tools: bool = True) -> dict[str, Any]:
    system_parts: list[dict[str, str]] = []
    contents: list[dict[str, Any]] = []
    # tool_call_id -> function name (functionResponse is keyed by name)
    call_names: dict[str, str] = {}
    for m in req.messages:
        if m.role == "assistant" and m.tool_calls:
            for tc in m.tool_calls:
                if tc.id and tc.function.name:
                    call_names[tc.id] = tc.function.name
    for m in req.messages:
        if m.role == "system":
            if isinstance(m.content, str):
                system_parts.append({"text": m.content})
            elif isinstance(m.content, list):
                system_parts.extend(
                    {"text": p.get("text", "")}
                    for p in m.content
                    if p.get("type") == "text"
                )
            continue
        if m.role == "tool":
            try:
                payload = json.loads(m.content) if isinstance(m.content, str) else m.content
            except ValueError:
                payload = {"result": m.content}
            if not isinstance(payload, dict):
                payload = {"result": payload}
            contents.append({
                "role": "user",
                "parts": [{
                    "functionResponse": {
                        "name": call_names.get(m.tool_call_id or "", m.name or "tool"),
                        "response": payload,
                    }
                }],
            })
            continue
        parts: list[dict[str, Any]] = []
        if isinstance(m.content, str) and m.content:
            parts.append({"text": m.content})
        elif isinstance(m.content, list):
            for p in m.content:
                if p.get("type") == "text":
                    parts.append({"text": p.get("text", "")})
        if m.role == "assistant" and m.tool_calls:
            for tc in m.tool_calls:
                try:
                    args = json.loads(tc.function.arguments or "{}")
                except ValueError:
                    args = {}
                parts.append({"functionCall": {"name": tc.function.name or "", "args": args}})
        contents.append({
            "role": "model" if m.role == "assistant" else "user",
            "parts": parts or [{"text": ""}],
        })

    body: dict[str, Any] = {"contents": contents}
    if system_parts:
        body["systemInstruction"] = {"parts": system_parts}
    gen: dict[str, Any] = {}
    if req.temperature is not None:
        gen["temperature"] = req.temperature
    if req.top_p is not None:
        gen["topP"] = req.top_p
    if req.top_k is not None:
        gen["topK"] = req.top_k
    max_new = req.max_completion_tokens or req.max_tokens
    if max_new is not None:
        gen["maxOutputTokens"] = max_new
    stops = stop_list(req.stop)
    if stops:
        gen["stopSequences"] = stops
    if gen:
        body["generationConfig"] = gen
    if want_tools and req.tools and req.tool_choice != "none":
        body["tools"] = [{
            "functionDeclarations": [
                {
                    "name": t.function.name,
                    "description": t.function.description or "",
                    "parameters": t.function.parameters or {"type": "object"},
                }
                for t in req.tools
            ]
        }]
    return body


def _parts_to_chat(parts: list[dict[str, Any]], start_tool_idx: int = 0):
    text_parts: list[str] = []
    tool_calls: list[dict[str, Any]] = []
    for p in parts:
        if "text" in p:
            text_parts.append(p["text"])
        elif "functionCall" in p:
            fc = p["functionCall"]
            tool_calls.append({
                "id": f"call_{uuid.uuid4().hex[:16]}",
                "type": "function",
                "index": start_tool_idx + len(tool_calls),
                "function": {
                    "name": fc.get("name"),
                    "arguments": json.dumps(fc.get("args") or {}),
                },
            })
    return "".join(text_parts), tool_calls


def gemini_to_chat(data: dict[str, Any], model: str) -> dict[str, Any]:
    cand = (data.get("candidates") or [{}])[0]
    parts = (cand.get("content") or {}).get("parts") or []
    text, tool_calls = _parts_to_chat(parts)
    message: dict[str, Any] = {"role": "assistant", "content": text or None}
    finish = _FINISH.get(cand.get("finishReason"), "stop")
    if not data.get("candidates") and (data.get("promptFeedback") or {}).get("blockReason"):
        finish = "content_filter"  # safety-blocked prompt, OpenAI semantics
    if tool_calls:
        message["tool_calls"] = tool_calls
        finish = "tool_calls"
    usage = data.get("usageMetadata") or {}
    return {
        "id": f"chatcmpl-{uuid.uuid4().hex[:24]}",
        "object": "chat.completion",
        "created": int(time.time()),
        "model": model,
        "choices": [{"index": 0, "message": message, "finish_reason": finish}],
        "usage": {
            "prompt_tokens": usage.get("promptTokenCount", 0),
            "completion_tokens": usage.get("candidatesTokenCount", 0),
            "total_tokens": usage.get("totalTokenCount", 0),
        },
    }


class GeminiAdapter(ProviderAdapter):
    kind = "gemini"

    def _headers(self) -> dict[str, str]:
        h = {"content-type": "application/json"}
        if self.spec.api_key:
            h["x-goog-api-key"] = self.spec.api_key
        return h

    async def chat(self, req: ChatCompletionRequest) -> dict[str, Any]:
        model = self.spec.upstream_model(req.model)
        s = await self.session()
        async with s.post(
            f"{self.spec.base_url}/models/{model}:generateContent",
            json=chat_to_gemini(req),
            headers=self._headers(),
        ) as resp:
            if resp.status != 200:
                raise ProviderError(resp.status, await resp.text())
            return gemini_to_chat(await resp.json(), req.model)

    async def chat_stream(self, req: ChatCompletionRequest) -> AsyncIterator[dict[str, Any]]:
        model = self.spec.upstream_model(req.model)
        frame = make_chunk_framer(
            f"chatcmpl-{uuid.uuid4().hex[:24]}", int(time.time()), req.model
        )
        s = await self.session()
        async with s.post(
            f"{self.spec.base_url}/models/{model}:streamGenerateContent?alt=sse",
            json=chat_to_gemini(req),
            headers=self._headers(),
        ) as resp:
            if resp.status != 200:
                raise ProviderError(resp.status, await resp.text())
            yield frame({"role": "assistant"})
            finish = "stop"
            tool_idx = 0
            async for data in iter_sse_data(resp):
                try:
                    ev = json.loads(data)
                except ValueError:
                    continue
                if ev.get("error"):
                    err = ev["error"]
                    raise ProviderError(
                        502, f"{err.get('status', 'error')}: {err.get('message', '')}"
                    )
                if not ev.get("candidates") and (
                    (ev.get("promptFeedback") or {}).get("blockReason")
                ):
                    finish = "content_filter"
                    continue
                cand = (ev.get("candidates") or [{}])[0]
                parts = (cand.get("content") or {}).get("parts") or []
                text, tool_calls = _parts_to_chat(parts, start_tool_idx=tool_idx)
                if text:
                    yield frame({"content": text})
                if tool_calls:
                    tool_idx += len(tool_calls)
                    yield frame({"tool_calls": tool_calls})
                    finish = "tool_calls"
                fr = cand.get("finishReason")
                if fr and finish != "tool_calls":
                    finish = _FINISH.get(fr, "stop")
            yield frame({}, finish=finish)
