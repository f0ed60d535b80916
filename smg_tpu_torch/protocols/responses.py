"""OpenAI Responses API types (reference: ``crates/protocols`` responses +
``src/routers/openai/responses``, SURVEY.md §2.1).

The port's copy of ``smg_tpu/protocols/responses.py``, unchanged but for its
imports.
"""

from __future__ import annotations

import time
import uuid
from typing import Any

from pydantic import BaseModel, ConfigDict, Field


class ResponsesRequest(BaseModel):
    model_config = ConfigDict(extra="allow")
    model: str = ""
    input: str | list[dict[str, Any]] = ""
    instructions: str | None = None
    previous_response_id: str | None = None
    conversation: str | None = None
    tools: list[dict[str, Any]] | None = None
    tool_choice: str | dict | None = None
    max_output_tokens: int | None = None
    max_tool_calls: int | None = None
    temperature: float | None = None
    top_p: float | None = None
    stream: bool = False
    store: bool = True
    metadata: dict[str, Any] | None = None


class ResponseOutputText(BaseModel):
    type: str = "output_text"
    text: str = ""
    annotations: list = Field(default_factory=list)


class ResponseMessageItem(BaseModel):
    id: str = Field(default_factory=lambda: f"msg_{uuid.uuid4().hex[:24]}")
    type: str = "message"
    role: str = "assistant"
    status: str = "completed"
    content: list[ResponseOutputText] = Field(default_factory=list)


class ResponseFunctionCallItem(BaseModel):
    id: str = Field(default_factory=lambda: f"fc_{uuid.uuid4().hex[:24]}")
    type: str = "function_call"
    call_id: str = ""
    name: str = ""
    arguments: str = "{}"
    status: str = "completed"


class ResponseUsage(BaseModel):
    input_tokens: int = 0
    output_tokens: int = 0
    total_tokens: int = 0


class ResponsesResponse(BaseModel):
    id: str = Field(default_factory=lambda: f"resp_{uuid.uuid4().hex[:24]}")
    object: str = "response"
    created_at: int = Field(default_factory=lambda: int(time.time()))
    status: str = "completed"  # completed | failed | incomplete | in_progress
    model: str = ""
    output: list[dict[str, Any]] = Field(default_factory=list)
    previous_response_id: str | None = None
    conversation: dict | None = None
    usage: ResponseUsage = Field(default_factory=ResponseUsage)
    metadata: dict[str, Any] = Field(default_factory=dict)

    @property
    def output_text(self) -> str:
        parts = []
        for item in self.output:
            if item.get("type") == "message":
                for c in item.get("content", []):
                    if c.get("type") == "output_text":
                        parts.append(c.get("text", ""))
        return "".join(parts)
