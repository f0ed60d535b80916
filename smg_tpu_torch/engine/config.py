"""Engine configuration — the port's own copy of the parts of
``smg_tpu/engine/config.py`` this engine reads (the parallel axes, cache
layout, the continuous-batching scheduler knobs it implements, speculative
decoding, engine identity and checkpoint paths, the LoRA bank, failure
isolation and the flight ring)."""

from __future__ import annotations

from dataclasses import dataclass, field

from smg_tpu_torch.models.config import ModelConfig


@dataclass(frozen=True)
class ParallelConfig:
    """Sizes of the named parallel axes (the reference's ``ParallelConfig``).

    ``tp``, ``pp``, ``sp`` and ``ep``: a rank mesh, one rank process per
    rank of the grid (``parallel/``); ``dp`` is parsed and validated as the
    reference does, and an engine refuses it above 1 until its
    ``ROADMAP.md`` item lands."""

    dp: int = 1
    tp: int = 1
    sp: int = 1
    ep: int = 1
    pp: int = 1

    @property
    def world_size(self) -> int:
        return self.dp * self.tp * self.sp * self.ep * self.pp

    def axis_sizes(self) -> dict[str, int]:
        return {"dp": self.dp, "tp": self.tp, "sp": self.sp, "ep": self.ep, "pp": self.pp}

    @classmethod
    def from_spec(cls, spec: str, base: "ParallelConfig | None" = None) -> "ParallelConfig":
        """Parse a ``--mesh-shape`` string ("tp=4", "dp=2,tp=4") over
        ``base`` (axes not named keep the base's value).  Raises ValueError
        on an unknown axis, a malformed entry, an axis named twice or a size
        below 1."""
        sizes = (base or cls()).axis_sizes()
        seen: set[str] = set()
        for part in (p.strip() for p in spec.split(",") if p.strip()):
            axis, sep, val = part.partition("=")
            axis = axis.strip()
            if not sep or axis not in sizes:
                raise ValueError(
                    f"mesh-shape entry {part!r}: expected axis=N with axis "
                    f"in {sorted(sizes)}"
                )
            if axis in seen:
                # a repeated axis is a typo, not an override
                raise ValueError(f"mesh-shape names {axis!r} twice")
            seen.add(axis)
            try:
                n = int(val)
            except ValueError:
                raise ValueError(f"mesh-shape entry {part!r}: size must be an int") from None
            if n < 1:
                raise ValueError(f"mesh-shape entry {part!r}: size must be >= 1")
            sizes[axis] = n
        return cls(**sizes)


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
    shapes.  ``prefill_token_buckets`` pads only the embedding forward's
    sequence length (``runner.embed``) and caps it."""

    max_batch_size: int = 64
    max_seq_len: int = 8192
    max_prefill_tokens: int = 4096
    prefill_token_buckets: tuple[int, ...] = (64, 128, 256, 512, 1024, 2048, 4096)
    decode_batch_buckets: tuple[int, ...] = (8, 16, 32, 64)
    # False builds no radix cache: every prompt is computed whole
    enable_prefix_cache: bool = True
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
    # prefill scheduling: "stall-free" spends at most max_prefill_tokens a
    # step (resumable chunks, decode every step); "throughput" drains the
    # waiting queue every step, a long prompt's chunks back to back
    # (the most prefill a step, decode stalls behind it)
    prefill_mix_policy: str = "stall-free"
    # admission back-pressure on the waiting queue (0 = unbounded): a
    # submit over either bound raises QueueFullError
    max_queued_requests: int = 0
    max_queued_tokens: int = 0
    # overlapped decode pipeline: the next megastep is launched before the
    # previous one's tokens are fetched; streams stay byte-identical to the
    # synchronous schedule
    overlap_schedule: bool = True
    # speculative decoding (engine/speculative.py, engine/draft.py and the
    # runner's verify block): eligible lanes draft up to spec_max_draft
    # tokens on the host and verify them in one batched forward with the
    # acceptance on the device — greedy chains at temperature 0, rejection
    # sampling above it.  Steps where nothing drafts take the megastep.
    speculative: bool = False
    spec_max_draft: int = 8
    spec_ngram_max: int = 3
    spec_ngram_min: int = 1
    # drafting tier: "auto" uses the draft model when one is configured
    # (EngineConfig.draft_model) and n-grams otherwise; "ngram" pins the
    # n-gram tier; "draft" requires a draft model
    speculative_tier: str = "auto"

    def __post_init__(self) -> None:
        if self.max_batch_size < 1 or self.max_prefill_tokens < 1:
            raise ValueError("max_batch_size and max_prefill_tokens must be >= 1")
        if self.max_batch_size > max(self.decode_batch_buckets):
            raise ValueError("max_batch_size must be <= largest decode batch bucket")
        if self.max_prefill_tokens > max(self.prefill_token_buckets):
            raise ValueError("max_prefill_tokens must be <= largest prefill bucket")
        if self.prefill_mix_policy not in ("stall-free", "throughput"):
            raise ValueError("prefill_mix_policy must be 'stall-free' or 'throughput', "
                             f"got {self.prefill_mix_policy!r}")
        if self.decode_horizon < 1:
            raise ValueError("decode_horizon must be >= 1")
        if self.decode_horizon_max and self.decode_horizon_max < self.decode_horizon:
            raise ValueError("decode_horizon_max must be 0 or >= decode_horizon")
        if self.speculative_tier not in ("auto", "ngram", "draft"):
            raise ValueError("speculative_tier must be 'auto', 'ngram', or 'draft', "
                             f"got {self.speculative_tier!r}")
        if self.spec_max_draft < 1:
            raise ValueError("spec_max_draft must be >= 1")

    @property
    def horizon_cap(self) -> int:
        """The widest megastep a launch may take."""
        return max(self.decode_horizon_max, self.decode_horizon, 1)

    def prefill_bucket(self, n_tokens: int) -> int:
        for b in self.prefill_token_buckets:
            if n_tokens <= b:
                return b
        return max(self.prefill_token_buckets)

    def decode_bucket(self, batch: int) -> int:
        for b in self.decode_batch_buckets:
            if batch <= b:
                return b
        return max(self.decode_batch_buckets)


@dataclass
class EngineConfig:
    model: ModelConfig = field(default_factory=ModelConfig)  # sets the weights' dtype
    # tp, pp, sp or ep above 1 shard the model over rank processes
    # (parallel/); dp is refused above 1
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    cache: CacheConfig = field(default_factory=CacheConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    seed: int = 0  # random weights (when none are given) and the sampler
    # on the card, replay each decode megastep from a CUDA graph (captured
    # at first use per bucket); False launches every column eagerly.  The
    # CPU always runs eagerly.  A rank-mesh engine whose collectives go over
    # gloo (parallel/group.py) cannot capture them and refuses True.
    decode_graphs: bool = True
    # speculative draft model (engine/draft.py): a smaller ModelConfig whose
    # greedy proposals replace n-gram lookup, with random weights from
    # draft_seed unless the engine is given draft_params; None = n-grams
    draft_model: ModelConfig | None = None
    draft_seed: int = 1
    # serving identity (the model name the gateway lists)
    model_id: str = "smg-tpu-model"
    # HF-format checkpoint directory (config.json + safetensors) and the
    # tokenizer's directory; None for a preset with random weights
    model_path: str | None = None
    tokenizer_path: str | None = None
    # LoRA adapter bank slots (models/lora.py); slot 0 = no adapter
    max_loras: int = 4
    # ---- failure isolation (the reference's defaults) ----
    # step watchdog: a thread that flags the engine unhealthy when no step
    # completes for this many seconds while work is pending (a wedged
    # device fetch, a runaway capture); 0 disables it
    step_watchdog_secs: float = 0.0
    # this many consecutive failed steps turn ``Engine.healthy`` false, so
    # the gateway's health monitor and breakers route around the worker
    max_consecutive_step_failures: int = 3
    # ---- observability (engine/metrics.py, engine/flight_recorder.py) ----
    # rolling step-stats horizon (loads()["stats"], /scheduler) and the
    # cadence of the device-memory gauges (0 = never sampled)
    metrics_window_secs: float = 30.0
    device_metrics_interval_secs: float = 10.0
    # the flight recorder: a ring of per-step records and request
    # timelines, auto-dumped on quarantine, watchdog stall, health flip and
    # drain; off only to measure what it costs
    flight_recorder: bool = True
    flight_ring_size: int = 256
    # a directory that auto-dumps are also written to (None: memory only)
    # and the per-reason least interval between two auto-dumps
    flight_dump_dir: str | None = None
    flight_dump_min_interval_secs: float = 5.0
