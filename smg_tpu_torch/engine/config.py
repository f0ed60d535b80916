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
    megastep width (decode columns per device round trip).  Decode batches
    pad to ``decode_batch_buckets`` (one CUDA graph per bucket, page-table
    width, horizon and stop-id width); prefill runs eagerly at its exact
    shapes."""

    max_batch_size: int = 64
    max_seq_len: int = 8192
    max_prefill_tokens: int = 4096
    decode_batch_buckets: tuple[int, ...] = (8, 16, 32, 64)
    watermark_pages: int = 8  # keep this many pages free before admitting prefill
    decode_horizon: int = 1
    # adaptive horizon controller: K per launch from page headroom, the
    # smallest remaining token budget and the EMA of columns between
    # finishes, capped at horizon_cap.  Pending admission work forces K=1
    # in every mode (an admission can land between any two columns).
    adaptive_horizon: bool = False
    # largest horizon a launch may take (0 = follow decode_horizon)
    decode_horizon_max: int = 0
    max_prefill_group: int = 8
    # admission back-pressure on the waiting queue (0 = unbounded): a
    # submit over either bound raises QueueFullError
    max_queued_requests: int = 0
    max_queued_tokens: int = 0
    # overlapped decode pipeline: the next megastep is launched before the
    # previous one's tokens are fetched; streams stay byte-identical to the
    # synchronous schedule
    overlap_schedule: bool = True

    def __post_init__(self) -> None:
        if self.max_batch_size < 1 or self.max_prefill_tokens < 1:
            raise ValueError("max_batch_size and max_prefill_tokens must be >= 1")
        if self.max_batch_size > max(self.decode_batch_buckets):
            raise ValueError("max_batch_size must be <= largest decode batch bucket")
        if self.decode_horizon < 1:
            raise ValueError("decode_horizon must be >= 1")
        if self.decode_horizon_max and self.decode_horizon_max < self.decode_horizon:
            raise ValueError("decode_horizon_max must be 0 or >= decode_horizon")

    @property
    def horizon_cap(self) -> int:
        """The widest megastep a launch may take."""
        return max(self.decode_horizon_max, self.decode_horizon, 1)

    def decode_bucket(self, batch: int) -> int:
        for b in self.decode_batch_buckets:
            if batch <= b:
                return b
        return max(self.decode_batch_buckets)


@dataclass
class EngineConfig:
    model: ModelConfig = field(default_factory=ModelConfig)  # sets the weights' dtype
    cache: CacheConfig = field(default_factory=CacheConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    seed: int = 0  # random weights (when none are given) and the sampler
    # on the card, replay each decode megastep from a CUDA graph (captured
    # at first use per bucket); False launches every column eagerly.  The
    # CPU always runs eagerly.
    decode_graphs: bool = True
