"""Engine facade: scheduler + streaming results (port of the synchronous
surface of ``smg_tpu/engine/engine.py``: ``submit``, ``step``,
``generate`` and their result types).

Entry points run on the card: ``device=None`` means CUDA, and a machine
without one raises.  Not ported yet: detokenisation (``text`` fields stay
empty), string stops, the background loop, deadlines and abort.
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass, field

from smg_tpu_torch.engine.config import EngineConfig
from smg_tpu_torch.engine.request import EngineRequest, StepOutput
from smg_tpu_torch.engine.runner import ModelRunner
from smg_tpu_torch.engine.scheduler import Scheduler
from smg_tpu_torch.protocols.sampling import SamplingParams


@dataclass
class RequestOutput:
    """One streamed increment for a request."""

    rid: str
    new_token_ids: list[int] = field(default_factory=list)
    text_delta: str = ""
    finished: bool = False
    finish_reason: str | None = None
    matched_stop: str | int | None = None
    prompt_tokens: int = 0
    output_tokens: int = 0
    cached_tokens: int = 0
    logprobs: list[float] = field(default_factory=list)


@dataclass
class GenerationResult:
    rid: str
    token_ids: list[int]
    text: str
    finish_reason: str
    matched_stop: str | int | None
    prompt_tokens: int
    output_tokens: int
    cached_tokens: int
    logprobs: list[float]


class Engine:
    def __init__(self, config: EngineConfig, params: dict | None = None, device=None,
                 attention: str = "kernel"):
        self.config = config
        self.runner = ModelRunner(config, params=params, device=device, attention=attention)
        self.scheduler = Scheduler(self.runner, config)
        self._callbacks: dict[str, object] = {}

    def submit(self, prompt_ids: list[int], sampling: SamplingParams,
               rid: str | None = None, on_output=None) -> str:
        """Queue a request; ``on_output`` receives its ``RequestOutput``s."""
        rid = rid or f"req-{uuid.uuid4().hex[:16]}"
        req = EngineRequest(rid=rid, prompt_ids=list(prompt_ids), sampling=sampling)
        self.scheduler.add_request(req)
        if on_output is not None:
            self._callbacks[rid] = on_output
        return rid

    def has_work(self) -> bool:
        return self.scheduler.has_work()

    def step(self) -> list[RequestOutput]:
        """One scheduler iteration; returns per-request increments."""
        outputs = [self._postprocess(so) for so in self.scheduler.step()]
        for out in outputs:
            cb = self._callbacks.get(out.rid)
            if cb is not None:
                cb(out)
                if out.finished:
                    self._callbacks.pop(out.rid, None)
        return outputs

    def _postprocess(self, so: StepOutput) -> RequestOutput:
        req = so.request
        return RequestOutput(
            rid=req.rid,
            new_token_ids=list(so.new_token_ids),
            finished=so.finished,
            finish_reason=so.finish.reason if so.finish else None,
            matched_stop=so.finish.matched_stop if so.finish else None,
            prompt_tokens=req.prompt_len,
            output_tokens=len(req.output_ids),
            cached_tokens=req.cached_tokens,
            logprobs=list(so.logprobs),
        )

    def generate(self, prompt_ids: list[int], sampling: SamplingParams | None = None,
                 rid: str | None = None) -> GenerationResult:
        """Blocking generate: steps the engine until the request finishes."""
        sampling = sampling or SamplingParams()
        chunks: list[RequestOutput] = []
        rid = self.submit(prompt_ids, sampling, rid=rid, on_output=chunks.append)
        while not (chunks and chunks[-1].finished):
            self.step()
        return collect_result(rid, chunks)


def collect_result(rid: str, chunks: list[RequestOutput]) -> GenerationResult:
    """Fold a request's streamed increments into its final result."""
    token_ids = [t for c in chunks for t in c.new_token_ids]
    last = chunks[-1]
    return GenerationResult(
        rid=rid,
        token_ids=token_ids,
        text="",
        finish_reason=last.finish_reason or "stop",
        matched_stop=last.matched_stop,
        prompt_tokens=last.prompt_tokens,
        output_tokens=last.output_tokens,
        cached_tokens=chunks[0].cached_tokens,
        logprobs=[x for c in chunks for x in c.logprobs],
    )
