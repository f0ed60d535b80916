"""Engine facade: scheduler + streaming results + the background step loop
(port of ``smg_tpu/engine/engine.py``: ``submit``, ``abort``, ``step``,
``generate``, ``start``/``stop``, ``loads``, ``audit``, ``flush_cache``).

Entry points run on the card: ``device=None`` means CUDA, and a machine
without one raises.  ``start()`` runs ``step()`` on a loop thread while
there is work; output callbacks run on that thread, outside the engine
lock.  Not ported yet: detokenisation (``text`` fields stay empty), string
stops, the step watchdog, the flight recorder and metrics.
"""

from __future__ import annotations

import logging
import threading
import time
import uuid
from dataclasses import dataclass, field

from smg_tpu_torch.engine.config import EngineConfig
from smg_tpu_torch.engine.request import EngineRequest, StepOutput
from smg_tpu_torch.engine.runner import ModelRunner
from smg_tpu_torch.engine.scheduler import Scheduler
from smg_tpu_torch.protocols.sampling import SamplingParams

logger = logging.getLogger("smg_tpu_torch.engine")
# consecutive loop-step failures after which ``healthy`` turns false
MAX_CONSECUTIVE_STEP_FAILURES = 3


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
        self._lock = threading.RLock()
        self._wakeup = threading.Condition(self._lock)
        self._thread: threading.Thread | None = None
        self._stopping = False
        self.consec_step_failures = 0

    # ---- submission ----

    def submit(self, prompt_ids: list[int], sampling: SamplingParams,
               rid: str | None = None, on_output=None,
               timeout_secs: float | None = None) -> str:
        """Queue a request; ``on_output`` receives its ``RequestOutput``s.
        ``timeout_secs`` is the request's budget: past it the scheduler ends
        it with finish ``timeout``, queued or running.  Raises
        ``QueueFullError`` under admission back-pressure or while draining."""
        rid = rid or f"req-{uuid.uuid4().hex[:16]}"
        req = EngineRequest(rid=rid, prompt_ids=list(prompt_ids), sampling=sampling)
        if timeout_secs is not None:
            req.deadline = time.monotonic() + max(timeout_secs, 0.0)
        with self._wakeup:
            self.scheduler.add_request(req)
            if on_output is not None:
                self._callbacks[rid] = on_output
            self._wakeup.notify_all()
        return rid

    def abort(self, rid: str) -> bool:
        with self._lock:
            ok = self.scheduler.abort_request(rid)
            self._callbacks.pop(rid, None)
            return ok

    def has_work(self) -> bool:
        with self._lock:
            return self.scheduler.has_work()

    @property
    def healthy(self) -> bool:
        """False while the loop thread's steps keep failing."""
        return self.consec_step_failures < MAX_CONSECUTIVE_STEP_FAILURES

    def loads(self) -> dict:
        with self._lock:
            out = self.scheduler.loads()
            out["audit"] = self._audit_locked()
        out["healthy"] = self.healthy
        return out

    def _audit_locked(self) -> dict:
        out = self.scheduler.audit()
        out["pending_callbacks"] = len(self._callbacks)
        out["clean"] = out["clean"] and (not out["quiescent"] or not self._callbacks)
        return out

    def audit(self) -> dict:
        """``Scheduler.audit`` plus output callbacks left at quiescence."""
        with self._lock:
            return self._audit_locked()

    def flush_cache(self) -> bool:
        with self._lock:
            return self.scheduler.flush_cache()

    # ---- stepping ----

    def step(self) -> list[RequestOutput]:
        """One scheduler iteration; returns per-request increments.  The
        callbacks run after the engine lock is released."""
        with self._lock:
            outputs = [self._postprocess(so) for so in self.scheduler.step()]
        self._deliver(outputs)
        return outputs

    def _deliver(self, outputs: list[RequestOutput]) -> None:
        for out in outputs:
            cb = self._callbacks.get(out.rid)
            if cb is None:
                continue
            try:
                cb(out)
            except Exception:
                logger.exception("output callback failed for %s", out.rid)
            if out.finished:
                self._callbacks.pop(out.rid, None)

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

    # ---- background loop ----

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stopping = False
        self._thread = threading.Thread(target=self._loop, name="smg-torch-engine",
                                        daemon=True)
        self._thread.start()

    def stop(self, drain: bool = False, timeout: float = 30.0) -> None:
        """Stop the loop.  ``drain=True`` first stops admission, ends every
        queued request with a terminal ``abort``, and waits up to ``timeout``
        seconds for the admitted requests to finish streaming."""
        if drain:
            with self._wakeup:
                self.scheduler.draining = True
                step_outs: list[StepOutput] = []
                self.scheduler.drain_waiting(step_outs)
                outputs = [self._postprocess(so) for so in step_outs]
                self._wakeup.notify_all()
            self._deliver(outputs)
            deadline = time.monotonic() + max(timeout, 0.0)
            while self._thread is not None and time.monotonic() < deadline:
                if not self.has_work():
                    break
                time.sleep(0.01)
            else:
                if self._thread is not None:
                    logger.warning("drain timeout (%.1fs): stopping with work in flight",
                                   timeout)
        with self._wakeup:
            self._stopping = True
            self._wakeup.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

    def _loop(self) -> None:
        """Step while there is work.  With ``overlap_schedule`` each step
        consumes the previous launch and leaves the next in flight, so the
        host's bookkeeping and callbacks here overlap the card's compute;
        ``has_work`` counts the in-flight frame, so the pipeline drains by
        itself, and stop() discards whatever is still in flight."""
        while True:
            with self._wakeup:
                if self._stopping:
                    break
                if not self.scheduler.has_work():
                    self._wakeup.wait(timeout=0.05)
                    continue
            try:
                self.step()
                self.consec_step_failures = 0
                # the lock is not fair: yield so a submit, abort or stop
                # waiting on it gets in between two steps
                time.sleep(0)
            except Exception:
                self.consec_step_failures += 1
                logger.exception("engine step failed (%d consecutive)",
                                 self.consec_step_failures)
                time.sleep(0.1)
        with self._lock:
            self.scheduler.drop_inflight()

    # ---- sync convenience ----

    def generate(self, prompt_ids: list[int], sampling: SamplingParams | None = None,
                 rid: str | None = None, timeout_secs: float = 300.0) -> GenerationResult:
        """Blocking generate: steps the engine inline when no loop thread
        runs, otherwise waits on the stream.  An expired ``timeout_secs``
        comes back as a result with finish ``timeout``; ``TimeoutError``
        is only the backstop for an engine that stops producing outputs."""
        sampling = sampling or SamplingParams()
        done = threading.Event()
        chunks: list[RequestOutput] = []

        def on_output(out: RequestOutput) -> None:
            chunks.append(out)
            if out.finished:
                done.set()

        rid = self.submit(prompt_ids, sampling, rid=rid, on_output=on_output,
                          timeout_secs=timeout_secs)
        backstop = timeout_secs + 30.0
        if self._thread is None:
            deadline = time.monotonic() + backstop
            while not done.is_set():
                self.step()
                if time.monotonic() > deadline:
                    self.abort(rid)
                    raise TimeoutError(f"generation {rid} timed out")
        elif not done.wait(timeout=backstop):
            self.abort(rid)
            raise TimeoutError(f"generation {rid} timed out")
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
        cached_tokens=chunks[0].cached_tokens if chunks else 0,
        logprobs=[x for c in chunks for x in c.logprobs],
    )
