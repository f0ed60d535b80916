"""OpenAI-compatible API types — the port's copy of
``smg_tpu/protocols/openai.py``.

Reference: ``crates/protocols/src/`` (chat, completion, embedding, model_card —
SURVEY.md §2.2).  Pydantic v2 models; extra fields are tolerated on requests
(the OpenAI ecosystem sends vendor extensions freely) and dropped on responses.
"""

from __future__ import annotations

import time
import uuid
from typing import Any, Literal

from pydantic import BaseModel, ConfigDict, Field

from smg_tpu_torch.protocols.sampling import SamplingParams


def _gen_id(prefix: str) -> str:
    return f"{prefix}-{uuid.uuid4().hex[:24]}"


class UsageInfo(BaseModel):
    prompt_tokens: int = 0
    completion_tokens: int = 0
    total_tokens: int = 0
    # extension: tokens served from prefix cache (reference reports cached_tokens)
    prompt_tokens_details: dict[str, int] | None = None


class FunctionCall(BaseModel):
    name: str | None = None
    arguments: str | None = None


class ToolCall(BaseModel):
    id: str | None = None
    type: str = "function"
    function: FunctionCall = Field(default_factory=FunctionCall)
    index: int | None = None


class FunctionDef(BaseModel):
    model_config = ConfigDict(extra="allow")
    name: str
    description: str | None = None
    parameters: dict[str, Any] | None = None
    strict: bool | None = None


class Tool(BaseModel):
    model_config = ConfigDict(extra="allow")
    type: str = "function"
    function: FunctionDef


class ChatMessage(BaseModel):
    model_config = ConfigDict(extra="allow")
    role: str
    # str, None, or a list of content parts ({"type": "text"|"image_url"|...})
    content: str | list[dict[str, Any]] | None = None
    name: str | None = None
    tool_calls: list[ToolCall] | None = None
    tool_call_id: str | None = None
    reasoning_content: str | None = None


class ResponseFormat(BaseModel):
    model_config = ConfigDict(extra="allow")
    type: Literal["text", "json_object", "json_schema"] = "text"
    json_schema: dict[str, Any] | None = None


class StreamOptions(BaseModel):
    include_usage: bool = False


class ChatCompletionRequest(BaseModel):
    model_config = ConfigDict(extra="allow")

    model: str = ""
    messages: list[ChatMessage]
    temperature: float | None = None
    top_p: float | None = None
    top_k: int | None = None
    min_p: float | None = None
    n: int = 1
    max_tokens: int | None = None
    max_completion_tokens: int | None = None
    stop: str | list[str] | None = None
    stream: bool = False
    stream_options: StreamOptions | None = None
    presence_penalty: float | None = None
    frequency_penalty: float | None = None
    repetition_penalty: float | None = None
    logprobs: bool = False
    top_logprobs: int | None = None
    seed: int | None = None
    user: str | None = None
    tools: list[Tool] | None = None
    tool_choice: str | dict[str, Any] | None = None
    parallel_tool_calls: bool | None = None
    response_format: ResponseFormat | None = None
    # SGLang-compatible extensions honoured by the reference gateway
    ignore_eos: bool = False
    skip_special_tokens: bool = True
    separate_reasoning: bool = True
    lora_adapter: str | None = None

    def to_sampling_params(self, default_max_tokens: int) -> SamplingParams:
        stop = self.stop if isinstance(self.stop, list) else ([self.stop] if self.stop else [])
        if self.max_completion_tokens is not None:
            max_new = self.max_completion_tokens
        elif self.max_tokens is not None:
            max_new = self.max_tokens
        else:
            max_new = default_max_tokens
        sp = SamplingParams(
            max_new_tokens=max_new,
            temperature=self.temperature if self.temperature is not None else 1.0,
            top_p=self.top_p if self.top_p is not None else 1.0,
            top_k=self.top_k if self.top_k is not None else -1,
            min_p=self.min_p if self.min_p is not None else 0.0,
            frequency_penalty=self.frequency_penalty or 0.0,
            presence_penalty=self.presence_penalty or 0.0,
            repetition_penalty=self.repetition_penalty if self.repetition_penalty is not None else 1.0,
            stop=stop,
            ignore_eos=self.ignore_eos,
            skip_special_tokens=self.skip_special_tokens,
            seed=self.seed,
            n=self.n,
            logprobs=self.logprobs,
            top_logprobs=self.top_logprobs or 0,
            lora_adapter=self.lora_adapter,
        )
        if self.response_format is not None:
            if self.response_format.type == "json_object":
                sp.json_schema = "{}"
            elif self.response_format.type == "json_schema" and self.response_format.json_schema:
                import json as _json

                schema = self.response_format.json_schema.get("schema")
                if schema is not None:
                    sp.json_schema = _json.dumps(schema)
        sp.validate()
        return sp


class ChatCompletionChoice(BaseModel):
    index: int = 0
    message: ChatMessage
    finish_reason: str | None = None
    logprobs: dict[str, Any] | None = None


class ChatCompletionResponse(BaseModel):
    id: str = Field(default_factory=lambda: _gen_id("chatcmpl"))
    object: str = "chat.completion"
    created: int = Field(default_factory=lambda: int(time.time()))
    model: str = ""
    choices: list[ChatCompletionChoice] = Field(default_factory=list)
    usage: UsageInfo = Field(default_factory=UsageInfo)


class ChatStreamDelta(BaseModel):
    role: str | None = None
    content: str | None = None
    reasoning_content: str | None = None
    tool_calls: list[ToolCall] | None = None


class ChatStreamChoice(BaseModel):
    index: int = 0
    delta: ChatStreamDelta = Field(default_factory=ChatStreamDelta)
    finish_reason: str | None = None
    logprobs: dict[str, Any] | None = None


class ChatCompletionStreamChunk(BaseModel):
    id: str = ""
    object: str = "chat.completion.chunk"
    created: int = Field(default_factory=lambda: int(time.time()))
    model: str = ""
    choices: list[ChatStreamChoice] = Field(default_factory=list)
    usage: UsageInfo | None = None


class CompletionRequest(BaseModel):
    model_config = ConfigDict(extra="allow")

    model: str = ""
    prompt: str | list[str] | list[int] | list[list[int]] = ""
    suffix: str | None = None
    max_tokens: int | None = 16
    temperature: float | None = None
    top_p: float | None = None
    top_k: int | None = None
    n: int = 1
    stream: bool = False
    stream_options: StreamOptions | None = None
    logprobs: int | None = None
    echo: bool = False
    stop: str | list[str] | None = None
    presence_penalty: float | None = None
    frequency_penalty: float | None = None
    repetition_penalty: float | None = None
    seed: int | None = None
    user: str | None = None
    ignore_eos: bool = False
    lora_adapter: str | None = None

    def to_sampling_params(self, default_max_tokens: int) -> SamplingParams:
        stop = self.stop if isinstance(self.stop, list) else ([self.stop] if self.stop else [])
        sp = SamplingParams(
            max_new_tokens=self.max_tokens if self.max_tokens is not None else default_max_tokens,
            temperature=self.temperature if self.temperature is not None else 1.0,
            top_p=self.top_p if self.top_p is not None else 1.0,
            top_k=self.top_k if self.top_k is not None else -1,
            frequency_penalty=self.frequency_penalty or 0.0,
            presence_penalty=self.presence_penalty or 0.0,
            repetition_penalty=self.repetition_penalty if self.repetition_penalty is not None else 1.0,
            stop=stop,
            ignore_eos=self.ignore_eos,
            seed=self.seed,
            n=self.n,
            logprobs=self.logprobs is not None,
            top_logprobs=self.logprobs or 0,
            lora_adapter=self.lora_adapter,
        )
        sp.validate()
        return sp


class CompletionChoice(BaseModel):
    index: int = 0
    text: str = ""
    finish_reason: str | None = None
    logprobs: dict[str, Any] | None = None


class CompletionResponse(BaseModel):
    id: str = Field(default_factory=lambda: _gen_id("cmpl"))
    object: str = "text_completion"
    created: int = Field(default_factory=lambda: int(time.time()))
    model: str = ""
    choices: list[CompletionChoice] = Field(default_factory=list)
    usage: UsageInfo | None = None


class EmbeddingRequest(BaseModel):
    model_config = ConfigDict(extra="allow")
    model: str = ""
    input: str | list[str] | list[int] | list[list[int]]
    encoding_format: str = "float"
    dimensions: int | None = None
    user: str | None = None


class EmbeddingData(BaseModel):
    object: str = "embedding"
    index: int = 0
    embedding: list[float] = Field(default_factory=list)


class EmbeddingResponse(BaseModel):
    object: str = "list"
    data: list[EmbeddingData] = Field(default_factory=list)
    model: str = ""
    usage: UsageInfo = Field(default_factory=UsageInfo)


class ModelCard(BaseModel):
    id: str
    object: str = "model"
    created: int = Field(default_factory=lambda: int(time.time()))
    owned_by: str = "smg-tpu"


class ModelList(BaseModel):
    object: str = "list"
    data: list[ModelCard] = Field(default_factory=list)


class ErrorInfo(BaseModel):
    message: str
    type: str = "invalid_request_error"
    param: str | None = None
    code: str | int | None = None


class ErrorResponse(BaseModel):
    error: ErrorInfo
