"""Canonical sampling parameters — the port's own copy of
``smg_tpu/protocols/sampling.py``, holding the fields this engine honours:
the sampling knobs, OpenAI frequency/presence and HF repetition penalties,
stop token ids and stop strings, detokenisation, and grammar constraints
(``json_schema``, ``regex``, ``ebnf``).  ``seed``, ``n``, ``logprobs``,
``top_logprobs`` and ``lora_adapter`` come with the slices that port
per-request seeds, parallel sampling, top logprobs and LoRA."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class SamplingParams:
    """Engine-facing sampling configuration."""

    max_new_tokens: int = 128
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = -1  # -1 = disabled
    min_p: float = 0.0
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    repetition_penalty: float = 1.0
    stop: list[str] = field(default_factory=list)
    stop_token_ids: list[int] = field(default_factory=list)
    ignore_eos: bool = False
    skip_special_tokens: bool = True
    # structured output (grammar-constrained decoding)
    json_schema: str | None = None
    regex: str | None = None
    ebnf: str | None = None

    def validate(self) -> None:
        if self.max_new_tokens < 0:
            raise ValueError("max_new_tokens must be >= 0")
        if self.temperature < 0:
            raise ValueError("temperature must be >= 0")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")
        if self.top_k < -1 or self.top_k == 0:
            raise ValueError("top_k must be -1 (disabled) or a positive integer")
        if not 0.0 <= self.min_p <= 1.0:
            raise ValueError("min_p must be in [0, 1]")
        if self.repetition_penalty <= 0:
            raise ValueError("repetition_penalty must be > 0")

    @property
    def has_penalties(self) -> bool:
        return (
            self.frequency_penalty != 0.0
            or self.presence_penalty != 0.0
            or self.repetition_penalty != 1.0
        )
