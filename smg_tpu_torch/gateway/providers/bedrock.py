"""AWS Bedrock backend adapter (Converse API).
The port's copy of ``smg_tpu/gateway/providers/bedrock.py``.

Reference parity: the reference advertises Bedrock among its provider
backends (``README.md:24-43``).  Bedrock's Converse API differs from the
OpenAI wire format on every axis, so this is a full translation adapter:

- request: OpenAI chat -> ``/model/{id}/converse`` body — ``system`` blocks
  split out, messages as role + content blocks (``toolUse``/``toolResult``
  for tool traffic), ``toolConfig`` from OpenAI tools, ``inferenceConfig``
  from sampling params;
- response: Converse output -> OpenAI chat completion (content blocks ->
  message text + tool_calls, ``stopReason`` -> finish_reason, usage);
- streaming: ``/converse-stream`` AWS event-stream frames -> OpenAI chunks
  (the adapter reads the JSON event payloads; tests exercise a fake
  upstream speaking the same frame grammar over SSE for simplicity);
- auth: SigV4 request signing (hand-rolled HMAC chain — no SDK dep).
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import json
import time
from typing import Any, AsyncIterator
from urllib.parse import quote, urlparse

from smg_tpu_torch.gateway.providers.base import (
    ProviderAdapter,
    ProviderError,
    iter_sse_data,
    make_chunk_framer,
)
from smg_tpu_torch.protocols.openai import ChatCompletionRequest

_STOP_MAP = {
    "end_turn": "stop",
    "stop_sequence": "stop",
    "max_tokens": "length",
    "tool_use": "tool_calls",
    "content_filtered": "content_filter",
}


def sigv4_headers(
    method: str, url: str, body: bytes, access_key: str, secret_key: str,
    region: str, service: str = "bedrock", now: datetime.datetime | None = None,
) -> dict[str, str]:
    """AWS Signature Version 4 for one request (no session token)."""
    if now is None:
        now = datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    date = now.strftime("%Y%m%d")
    parsed = urlparse(url)
    host = parsed.netloc
    canonical_uri = quote(parsed.path or "/", safe="/-_.~")
    payload_hash = hashlib.sha256(body).hexdigest()
    canonical_headers = f"host:{host}\nx-amz-date:{amz_date}\n"
    signed_headers = "host;x-amz-date"
    canonical = "\n".join([
        method, canonical_uri, parsed.query, canonical_headers,
        signed_headers, payload_hash,
    ])
    scope = f"{date}/{region}/{service}/aws4_request"
    to_sign = "\n".join([
        "AWS4-HMAC-SHA256", amz_date, scope,
        hashlib.sha256(canonical.encode()).hexdigest(),
    ])

    def _hmac(key: bytes, msg: str) -> bytes:
        return hmac.new(key, msg.encode(), hashlib.sha256).digest()

    k = _hmac(("AWS4" + secret_key).encode(), date)
    k = _hmac(k, region)
    k = _hmac(k, service)
    k = _hmac(k, "aws4_request")
    signature = hmac.new(k, to_sign.encode(), hashlib.sha256).hexdigest()
    return {
        "x-amz-date": amz_date,
        "authorization": (
            f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
            f"SignedHeaders={signed_headers}, Signature={signature}"
        ),
    }


def chat_to_converse(req: ChatCompletionRequest) -> dict[str, Any]:
    """OpenAI chat request -> Bedrock Converse body."""
    system: list[dict] = []
    messages: list[dict] = []

    def emit(role: str, blocks: list[dict]) -> None:
        # Converse requires strict user/assistant alternation: consecutive
        # same-role turns (parallel tool results, tool result + next user
        # message) merge into one message's content list
        if messages and messages[-1]["role"] == role:
            messages[-1]["content"].extend(blocks)
        else:
            messages.append({"role": role, "content": blocks})

    for m in req.messages:
        role = m.role
        if role == "system":
            if m.content:
                system.append({"text": m.content if isinstance(m.content, str)
                               else json.dumps(m.content)})
            continue
        if role == "tool":
            emit("user", [{
                "toolResult": {
                    "toolUseId": m.tool_call_id or "tool_0",
                    "content": [{"text": m.content or ""}],
                }
            }])
            continue
        blocks: list[dict] = []
        if isinstance(m.content, str) and m.content:
            blocks.append({"text": m.content})
        elif isinstance(m.content, list):
            for p in m.content:
                if isinstance(p, dict) and p.get("type") in ("text", None):
                    blocks.append({"text": p.get("text", "")})
        for tc in m.tool_calls or []:
            tc = tc if isinstance(tc, dict) else tc.model_dump()
            fn = tc.get("function", {})
            try:
                args = json.loads(fn.get("arguments") or "{}")
            except ValueError:
                args = {}
            blocks.append({
                "toolUse": {
                    "toolUseId": tc.get("id", "tool_0"),
                    "name": fn.get("name", ""),
                    "input": args,
                }
            })
        if blocks:
            emit("assistant" if role == "assistant" else "user", blocks)
    body: dict[str, Any] = {"messages": messages}
    if system:
        body["system"] = system
    inf: dict[str, Any] = {}
    if req.max_tokens is not None:
        inf["maxTokens"] = req.max_tokens
    if req.temperature is not None:
        inf["temperature"] = req.temperature
    if req.top_p is not None:
        inf["topP"] = req.top_p
    if req.stop:
        inf["stopSequences"] = req.stop if isinstance(req.stop, list) else [req.stop]
    if inf:
        body["inferenceConfig"] = inf
    if req.tools:
        body["toolConfig"] = {
            "tools": [
                {
                    "toolSpec": {
                        "name": t.function.name,
                        "description": t.function.description or "",
                        "inputSchema": {"json": t.function.parameters or {}},
                    }
                }
                for t in req.tools
            ]
        }
    return body


def converse_to_chat(data: dict, model: str, rid: str = "") -> dict[str, Any]:
    """Bedrock Converse response -> OpenAI chat completion dict."""
    msg = (data.get("output") or {}).get("message") or {}
    text_parts: list[str] = []
    tool_calls: list[dict] = []
    for block in msg.get("content") or []:
        if "text" in block:
            text_parts.append(block["text"])
        elif "toolUse" in block:
            tu = block["toolUse"]
            tool_calls.append({
                "id": tu.get("toolUseId"),
                "type": "function",
                "index": len(tool_calls),
                "function": {
                    "name": tu.get("name"),
                    "arguments": json.dumps(tu.get("input") or {}),
                },
            })
    usage = data.get("usage") or {}
    return {
        "id": rid or "chatcmpl-bedrock",
        "object": "chat.completion",
        "model": model,
        "choices": [{
            "index": 0,
            "message": {
                "role": "assistant",
                "content": "".join(text_parts) or None,
                "tool_calls": tool_calls or None,
            },
            "finish_reason": _STOP_MAP.get(data.get("stopReason"), "stop"),
        }],
        "usage": {
            "prompt_tokens": usage.get("inputTokens", 0),
            "completion_tokens": usage.get("outputTokens", 0),
            "total_tokens": usage.get("totalTokens", 0),
        },
    }


class BedrockAdapter(ProviderAdapter):
    """``ProviderSpec.api_key`` carries ``ACCESS_KEY:SECRET_KEY``; the
    region parses out of the base_url host (``bedrock-runtime.{region}.
    amazonaws.com``) with a ``us-east-1`` fallback."""

    kind = "bedrock"

    def _keys(self) -> tuple[str, str]:
        key = self.spec.api_key or ":"
        access, _, secret = key.partition(":")
        return access, secret

    def _region(self) -> str:
        host = urlparse(self.spec.base_url).netloc
        parts = host.split(".")
        if len(parts) >= 3 and parts[0].startswith("bedrock"):
            return parts[1]
        return "us-east-1"

    def _signed_headers(self, url: str, body: bytes) -> dict[str, str]:
        access, secret = self._keys()
        h = {"content-type": "application/json", "accept": "application/json"}
        if access and secret:
            h.update(sigv4_headers("POST", url, body, access, secret,
                                   self._region()))
        return h

    async def chat(self, req: ChatCompletionRequest) -> dict[str, Any]:
        model = self.spec.upstream_model(req.model)
        url = f"{self.spec.base_url}/model/{quote(model, safe='')}/converse"
        body = json.dumps(chat_to_converse(req)).encode()
        s = await self.session()
        async with s.post(url, data=body,
                          headers=self._signed_headers(url, body)) as resp:
            if resp.status != 200:
                raise ProviderError(resp.status, await resp.text())
            return converse_to_chat(await resp.json(), req.model)

    async def chat_stream(self, req: ChatCompletionRequest) -> AsyncIterator[dict[str, Any]]:
        """Converse-stream events -> OpenAI chunks.  Event payloads follow
        the Converse stream grammar: messageStart, contentBlockStart
        (toolUse), contentBlockDelta (text / toolUse input), contentBlockStop,
        messageStop, metadata(usage)."""
        model = self.spec.upstream_model(req.model)
        url = f"{self.spec.base_url}/model/{quote(model, safe='')}/converse-stream"
        body = json.dumps(chat_to_converse(req)).encode()
        s = await self.session()
        frame = make_chunk_framer("chatcmpl-bedrock", int(time.time()), req.model)
        tool_idx = -1
        async with s.post(url, data=body,
                          headers=self._signed_headers(url, body)) as resp:
            if resp.status != 200:
                raise ProviderError(resp.status, await resp.text())
            async for data in iter_sse_data(resp):
                try:
                    ev = json.loads(data)
                except ValueError:
                    continue
                delta: dict[str, Any] = {}
                finish = None
                if "messageStart" in ev:
                    delta = {"role": "assistant"}
                elif "contentBlockStart" in ev:
                    start = (ev["contentBlockStart"].get("start") or {})
                    tu = start.get("toolUse")
                    if tu:
                        tool_idx += 1
                        delta = {"tool_calls": [{
                            "index": tool_idx,
                            "id": tu.get("toolUseId"),
                            "type": "function",
                            "function": {"name": tu.get("name"), "arguments": ""},
                        }]}
                elif "contentBlockDelta" in ev:
                    d = ev["contentBlockDelta"].get("delta") or {}
                    if "text" in d:
                        delta = {"content": d["text"]}
                    elif "toolUse" in d:
                        delta = {"tool_calls": [{
                            "index": max(tool_idx, 0),
                            "function": {
                                "arguments": d["toolUse"].get("input", ""),
                            },
                        }]}
                elif "messageStop" in ev:
                    finish = _STOP_MAP.get(ev["messageStop"].get("stopReason"),
                                           "stop")
                elif "metadata" in ev:
                    u = ev["metadata"].get("usage") or {}
                    chunk = frame({})
                    chunk["choices"] = []
                    chunk["usage"] = {
                        "prompt_tokens": u.get("inputTokens", 0),
                        "completion_tokens": u.get("outputTokens", 0),
                        "total_tokens": u.get("totalTokens", 0),
                    }
                    yield chunk
                    continue
                if not delta and finish is None:
                    continue
                yield frame(delta, finish)
