"""Native /generate API (SGLang-compatible shape) — the port's copy of
``smg_tpu/protocols/generate.py``.

Reference: the gateway's ``/generate`` route (``model_gateway/src/server.rs:778-922``)
and ``crates/protocols`` generate types.  This is the lowest-level text API:
raw prompt or token ids in, tokens out, no chat templating.
"""

from __future__ import annotations

from typing import Any

from pydantic import BaseModel, ConfigDict, Field

from smg_tpu_torch.protocols.sampling import SamplingParams


class GenerateSamplingParams(BaseModel):
    model_config = ConfigDict(extra="allow")
    max_new_tokens: int | None = None
    temperature: float | None = None
    top_p: float | None = None
    top_k: int | None = None
    min_p: float | None = None
    frequency_penalty: float | None = None
    presence_penalty: float | None = None
    repetition_penalty: float | None = None
    stop: str | list[str] | None = None
    stop_token_ids: list[int] | None = None
    ignore_eos: bool | None = None
    skip_special_tokens: bool | None = None
    n: int | None = None
    json_schema: str | None = None
    regex: str | None = None
    ebnf: str | None = None
    lora_adapter: str | None = None
    lora_path: str | None = None  # SGLang-compatible alias


class GenerateRequest(BaseModel):
    model_config = ConfigDict(extra="allow")

    text: str | list[str] | None = None
    input_ids: list[int] | list[list[int]] | None = None
    sampling_params: GenerateSamplingParams | None = None
    stream: bool = False
    return_logprob: bool = False
    rid: str | None = None

    def to_sampling_params(self, default_max_tokens: int) -> SamplingParams:
        g = self.sampling_params or GenerateSamplingParams()
        stop = g.stop if isinstance(g.stop, list) else ([g.stop] if g.stop else [])
        sp = SamplingParams(
            max_new_tokens=g.max_new_tokens if g.max_new_tokens is not None else default_max_tokens,
            temperature=g.temperature if g.temperature is not None else 1.0,
            top_p=g.top_p if g.top_p is not None else 1.0,
            top_k=g.top_k if g.top_k is not None else -1,
            min_p=g.min_p if g.min_p is not None else 0.0,
            frequency_penalty=g.frequency_penalty or 0.0,
            presence_penalty=g.presence_penalty or 0.0,
            repetition_penalty=g.repetition_penalty if g.repetition_penalty is not None else 1.0,
            stop=stop,
            stop_token_ids=list(g.stop_token_ids or []),
            ignore_eos=bool(g.ignore_eos),
            skip_special_tokens=g.skip_special_tokens if g.skip_special_tokens is not None else True,
            n=g.n or 1,
            logprobs=self.return_logprob,
            json_schema=g.json_schema,
            regex=g.regex,
            ebnf=g.ebnf,
            lora_adapter=g.lora_adapter or g.lora_path,
        )
        sp.validate()
        return sp


class GenerateMetaInfo(BaseModel):
    model_config = ConfigDict(extra="allow")
    id: str = ""
    finish_reason: dict[str, Any] | None = None
    prompt_tokens: int = 0
    completion_tokens: int = 0
    cached_tokens: int = 0


class GenerateResponse(BaseModel):
    text: str = ""
    output_ids: list[int] = Field(default_factory=list)
    meta_info: GenerateMetaInfo = Field(default_factory=GenerateMetaInfo)
