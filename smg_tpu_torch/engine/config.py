"""Engine configuration — the port's own copy of the parts of
``smg_tpu/engine/config.py`` this engine reads (cache layout, the
continuous-batching scheduler knobs it implements, engine identity)."""

from __future__ import annotations

from dataclasses import dataclass, field

from smg_tpu_torch.models.config import ModelConfig


@dataclass(frozen=True)
class CacheConfig:
    """Paged KV cache layout; ``page_size`` in tokens."""

    page_size: int = 16
    num_pages: int = 2048  # overridden by device-memory sizing when auto_size
    auto_size: bool = True
    hbm_utilization: float = 0.9  # fraction of free device memory given to KV
    dtype: str = "bfloat16"

    def __post_init__(self) -> None:
        if self.page_size % 8 != 0:
            raise ValueError("page_size must be a multiple of 8")


@dataclass(frozen=True)
class SchedulerConfig:
    """Continuous-batching knobs.  ``max_prefill_tokens`` is the per-step
    prefill budget (stall-free chunked prefill); ``decode_horizon`` is the
    megastep width (decode columns per device round trip).  PyTorch runs
    eagerly, so the JAX package's compile buckets (prefill token and decode
    batch ladders) have no counterpart: calls take their exact shapes."""

    max_batch_size: int = 64
    max_seq_len: int = 8192
    max_prefill_tokens: int = 4096
    watermark_pages: int = 8  # keep this many pages free before admitting prefill
    decode_horizon: int = 1
    max_prefill_group: int = 8

    def __post_init__(self) -> None:
        if self.max_batch_size < 1 or self.max_prefill_tokens < 1:
            raise ValueError("max_batch_size and max_prefill_tokens must be >= 1")
        if self.decode_horizon < 1:
            raise ValueError("decode_horizon must be >= 1")


@dataclass
class EngineConfig:
    model: ModelConfig = field(default_factory=ModelConfig)  # sets the weights' dtype
    cache: CacheConfig = field(default_factory=CacheConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    seed: int = 0  # random weights (when none are given) and the sampler
