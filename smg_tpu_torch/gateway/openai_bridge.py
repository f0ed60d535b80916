"""Anthropic <-> OpenAI format bridge — the port's copy of
``smg_tpu/gateway/openai_bridge.py``.

Reference: ``model_gateway/src/routers/common/openai_bridge/transformer.rs``
(1,700 LoC) — the gateway serves the Anthropic ``/v1/messages`` surface in
front of OpenAI-format backends by translating the request, the response,
and the streaming event grammar.  These transformers are shared by the
NATIVE path (``Router.anthropic_messages*`` — our own workers speak OpenAI
-chat internally) and the PROVIDER path (``server._messages_via_provider``
— 3rd-party OpenAI-compatible backends like OpenAI/xAI behind the
Anthropic front door), so both stay in lockstep by construction.

Event grammar emitted (Anthropic SSE): ``message_start`` →
``content_block_start`` / ``content_block_delta`` (``text_delta`` |
``input_json_delta``) / ``content_block_stop`` per block → ``message_delta``
(stop_reason + usage) → ``message_stop``.
"""

from __future__ import annotations

import json
import uuid
from typing import AsyncIterator

from smg_tpu_torch.protocols.anthropic import (
    AnthropicContentBlock,
    AnthropicMessagesResponse,
    AnthropicUsage,
    map_stop_reason,
)
from smg_tpu_torch.protocols.openai import (
    ChatCompletionRequest,
    ChatCompletionResponse,
    ChatMessage,
    FunctionDef,
    Tool,
)


def anthropic_to_openai_request(req) -> ChatCompletionRequest:
    """AnthropicMessagesRequest -> OpenAI chat request."""
    tools = None
    if req.tools:
        tools = [
            Tool(function=FunctionDef(
                name=t.name, description=t.description, parameters=t.input_schema
            ))
            for t in req.tools
        ]
    return ChatCompletionRequest(
        model=req.model,
        messages=[ChatMessage.model_validate(m) for m in req.to_chat_messages()],
        max_tokens=req.max_tokens,
        temperature=req.temperature,
        top_p=req.top_p,
        top_k=req.top_k,
        stop=req.stop_sequences,
        tools=tools,
        stream=req.stream,
        stream_options=None,
    )


def openai_to_anthropic_response(
    resp: ChatCompletionResponse, model: str | None
) -> AnthropicMessagesResponse:
    """OpenAI chat response -> Anthropic message (content blocks +
    stop_reason + usage)."""
    choice = resp.choices[0]
    blocks: list[AnthropicContentBlock] = []
    if choice.message.content:
        blocks.append(AnthropicContentBlock(type="text", text=choice.message.content))
    for tc in choice.message.tool_calls or []:
        try:
            args = json.loads(tc.function.arguments or "{}")
        except Exception:
            args = {}
        blocks.append(
            AnthropicContentBlock(
                type="tool_use", id=tc.id, name=tc.function.name, input=args
            )
        )
    usage = AnthropicUsage(
        input_tokens=resp.usage.prompt_tokens,
        output_tokens=resp.usage.completion_tokens,
        cache_read_input_tokens=(resp.usage.prompt_tokens_details or {}).get(
            "cached_tokens", 0
        ),
    )
    return AnthropicMessagesResponse(
        model=model or "default",
        content=blocks,
        stop_reason=map_stop_reason(choice.finish_reason),
        usage=usage,
    )


async def openai_chunks_to_anthropic_events(
    chunks: AsyncIterator, model: str | None
):
    """OpenAI streaming chunks (ChatCompletionStreamChunk) -> Anthropic SSE
    (event_name, payload) pairs."""
    mid = f"msg_{uuid.uuid4().hex[:24]}"
    yield "message_start", {
        "type": "message_start",
        "message": {
            "id": mid, "type": "message", "role": "assistant",
            "model": model or "default", "content": [],
            "usage": {"input_tokens": 0, "output_tokens": 0},
        },
    }
    finish = None
    in_tokens = out_tokens = 0
    block_idx = -1
    text_block_open = False
    tool_block_open = False  # OpenAI streams tool calls as an opening delta
    # (id+name) followed by bare argument fragments — one tool_use block
    # stays open across them and closes when the next block starts
    async for chunk in chunks:
        if chunk.usage is not None:
            in_tokens = chunk.usage.prompt_tokens
            out_tokens = chunk.usage.completion_tokens
            continue
        for ch in chunk.choices:
            if ch.delta.content:
                if tool_block_open:
                    yield "content_block_stop", {
                        "type": "content_block_stop", "index": block_idx,
                    }
                    tool_block_open = False
                if not text_block_open:
                    block_idx += 1
                    text_block_open = True
                    yield "content_block_start", {
                        "type": "content_block_start", "index": block_idx,
                        "content_block": {"type": "text", "text": ""},
                    }
                yield "content_block_delta", {
                    "type": "content_block_delta", "index": block_idx,
                    "delta": {"type": "text_delta", "text": ch.delta.content},
                }
            for tc in ch.delta.tool_calls or []:
                opening = bool(tc.function.name or tc.id)
                if opening or not tool_block_open:
                    if text_block_open:
                        yield "content_block_stop", {
                            "type": "content_block_stop", "index": block_idx,
                        }
                        text_block_open = False
                    if tool_block_open:
                        yield "content_block_stop", {
                            "type": "content_block_stop", "index": block_idx,
                        }
                    block_idx += 1
                    tool_block_open = True
                    yield "content_block_start", {
                        "type": "content_block_start", "index": block_idx,
                        "content_block": {
                            "type": "tool_use", "id": tc.id,
                            "name": tc.function.name or "", "input": {},
                        },
                    }
                if tc.function.arguments:
                    yield "content_block_delta", {
                        "type": "content_block_delta", "index": block_idx,
                        "delta": {
                            "type": "input_json_delta",
                            "partial_json": tc.function.arguments,
                        },
                    }
            if ch.finish_reason:
                finish = ch.finish_reason
    if text_block_open or tool_block_open:
        yield "content_block_stop", {"type": "content_block_stop", "index": block_idx}
    yield "message_delta", {
        "type": "message_delta",
        "delta": {"stop_reason": map_stop_reason(finish), "stop_sequence": None},
        "usage": {"input_tokens": in_tokens, "output_tokens": out_tokens},
    }
    yield "message_stop", {"type": "message_stop"}
