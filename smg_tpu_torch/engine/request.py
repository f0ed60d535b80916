"""Engine-side request state for continuous batching — the port's own copy
of ``smg_tpu/engine/request.py`` (fields this engine uses)."""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import Any

from smg_tpu_torch.protocols.sampling import SamplingParams


class QueueFullError(RuntimeError):
    """Admission back-pressure: the bounded waiting queue (or a draining
    engine) rejected a submit.  Retryable: load, not fault."""


class RequestStatus(enum.Enum):
    WAITING = "waiting"
    # admitted to a slot, prompt KV partially computed (``prefill_pos`` is
    # the cursor); not yet a decode lane
    PREFILLING = "prefilling"
    RUNNING = "running"
    PREEMPTED = "preempted"  # pages taken back; queued again at the front
    FINISHED = "finished"
    ABORTED = "aborted"


@dataclass
class FinishInfo:
    reason: str  # "stop" | "length" | "abort" | "error" | "timeout"
    matched_stop: str | int | None = None
    message: str | None = None


@dataclass
class EngineRequest:
    rid: str
    prompt_ids: list[int]
    sampling: SamplingParams
    arrival_time: float = field(default_factory=time.monotonic)
    # absolute time.monotonic() deadline (None = none): the scheduler
    # finishes the request with reason "timeout" once it passes
    deadline: float | None = None

    status: RequestStatus = RequestStatus.WAITING
    output_ids: list[int] = field(default_factory=list)
    logprobs: list[float] = field(default_factory=list)
    seq_len: int = 0  # tokens whose KV is currently cached
    prefill_pos: int = 0  # prompt tokens whose KV is computed so far
    cached_tokens: int = 0  # tokens served from the radix prefix cache
    owned_pages: list[int] = field(default_factory=list)
    shared_pages: list[int] = field(default_factory=list)  # radix pages (pinned)
    radix_node: Any = None  # locked RadixNode for the shared prefix
    slot: int | None = None
    finish: FinishInfo | None = None
    # filled by the engine layer (detokenisation, stop strings)
    detok: Any = None
    stop_checker: Any = None
    # constrained decoding: the engine-installed TokenFilter (vocab masks)
    token_filter: Any = None
    # the runner's penalty row for this request's slot is current
    penalty_synced: bool = False
    sched_serial: int = -1  # admission order; decode rows follow it

    @property
    def prompt_len(self) -> int:
        return len(self.prompt_ids)

    @property
    def total_len(self) -> int:
        return len(self.prompt_ids) + len(self.output_ids)

    @property
    def all_token_ids(self) -> list[int]:
        return self.prompt_ids + self.output_ids

    @property
    def is_finished(self) -> bool:
        return self.status in (RequestStatus.FINISHED, RequestStatus.ABORTED)


@dataclass
class StepOutput:
    """One request's increment from a scheduler step."""

    request: EngineRequest
    new_token_ids: list[int]
    finished: bool
    finish: FinishInfo | None = None
    logprobs: list[float] = field(default_factory=list)
