"""Anthropic Messages API types (reference: ``crates/protocols/src/messages``
+ ``src/routers/anthropic/``, the native Anthropic Messages router).

The port's copy of ``smg_tpu/protocols/anthropic.py``: the request, its
normalisation to chat messages (system blocks, ``tool_use`` to
``tool_calls``, ``tool_result`` to tool messages, image blocks kept as
content parts for the multimodal ingest), the response and usage models and
``map_stop_reason``.
"""

from __future__ import annotations

import json
import uuid
from typing import Any, Literal

from pydantic import BaseModel, ConfigDict, Field


class AnthropicMessage(BaseModel):
    model_config = ConfigDict(extra="allow")
    role: Literal["user", "assistant"]
    content: str | list[dict[str, Any]]


class AnthropicToolDef(BaseModel):
    model_config = ConfigDict(extra="allow")
    name: str
    description: str | None = None
    input_schema: dict[str, Any] | None = None


class AnthropicMessagesRequest(BaseModel):
    model_config = ConfigDict(extra="allow")
    model: str = ""
    messages: list[AnthropicMessage]
    max_tokens: int = 1024
    system: str | list[dict[str, Any]] | None = None
    temperature: float | None = None
    top_p: float | None = None
    top_k: int | None = None
    stop_sequences: list[str] | None = None
    stream: bool = False
    tools: list[AnthropicToolDef] | None = None
    metadata: dict[str, Any] | None = None

    def to_chat_messages(self) -> list[dict]:
        """Normalize to the internal chat shape: system first; text blocks
        flatten; tool_use blocks become assistant tool_calls; tool_result
        blocks become tool-role messages (the standard Anthropic tool loop
        must survive translation)."""
        out: list[dict] = []
        if self.system:
            if isinstance(self.system, str):
                out.append({"role": "system", "content": self.system})
            else:
                text = "".join(
                    b.get("text", "") for b in self.system if b.get("type") == "text"
                )
                out.append({"role": "system", "content": text})
        for m in self.messages:
            if isinstance(m.content, str):
                out.append({"role": m.role, "content": m.content})
                continue
            text_parts: list[str] = []
            parts: list[dict] = []  # ordered text+image parts (mm path)
            has_image = False
            tool_calls: list[dict] = []
            tool_results: list[dict] = []
            for b in m.content:
                if not isinstance(b, dict):
                    continue
                btype = b.get("type")
                if btype == "text":
                    text_parts.append(b.get("text", ""))
                    parts.append(b)
                elif btype == "image":
                    # preserved as a content part: the router's multimodal
                    # ingest consumes Anthropic source blocks directly
                    has_image = True
                    parts.append(b)
                elif btype == "tool_use":
                    tool_calls.append(
                        {
                            "id": b.get("id"),
                            "type": "function",
                            "function": {
                                "name": b.get("name", ""),
                                "arguments": json.dumps(b.get("input") or {}),
                            },
                        }
                    )
                elif btype == "tool_result":
                    rc = b.get("content")
                    if isinstance(rc, list):
                        rc = "".join(
                            p.get("text", "") for p in rc
                            if isinstance(p, dict) and p.get("type") == "text"
                        )
                    tool_results.append(
                        {
                            "role": "tool",
                            "content": rc or "",
                            "tool_call_id": b.get("tool_use_id"),
                        }
                    )
            text = "".join(text_parts)
            if m.role == "assistant" and tool_calls:
                out.append(
                    {"role": "assistant", "content": text or None, "tool_calls": tool_calls}
                )
            elif has_image:
                out.append({"role": m.role, "content": parts})
            elif text or not tool_results:
                out.append({"role": m.role, "content": text})
            out.extend(tool_results)
        return out


class AnthropicUsage(BaseModel):
    input_tokens: int = 0
    output_tokens: int = 0
    cache_read_input_tokens: int = 0


class AnthropicContentBlock(BaseModel):
    type: str = "text"
    text: str | None = None
    # tool_use blocks
    id: str | None = None
    name: str | None = None
    input: dict[str, Any] | None = None


class AnthropicMessagesResponse(BaseModel):
    id: str = Field(default_factory=lambda: f"msg_{uuid.uuid4().hex[:24]}")
    type: str = "message"
    role: str = "assistant"
    model: str = ""
    content: list[AnthropicContentBlock] = Field(default_factory=list)
    stop_reason: str | None = None  # end_turn | max_tokens | stop_sequence | tool_use
    stop_sequence: str | None = None
    usage: AnthropicUsage = Field(default_factory=AnthropicUsage)


def map_stop_reason(finish_reason: str | None, matched_stop=None) -> str:
    if finish_reason == "length":
        return "max_tokens"
    if finish_reason == "tool_calls":
        return "tool_use"
    if finish_reason == "stop" and isinstance(matched_stop, str):
        return "stop_sequence"
    return "end_turn"
