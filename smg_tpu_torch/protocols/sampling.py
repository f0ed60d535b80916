"""Canonical sampling parameters — the port's own copy of
``smg_tpu/protocols/sampling.py``, holding the fields this engine honours.
Penalties, stop strings, grammar constraints, LoRA adapters and n > 1 are
not ported yet, so they are not accepted either."""

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
    stop_token_ids: list[int] = field(default_factory=list)
    ignore_eos: bool = False

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
