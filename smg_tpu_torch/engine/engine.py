"""Engine facade: scheduler + detokenisation + stop strings + streaming
results + the background step loop (port of ``smg_tpu/engine/engine.py``:
``submit``, ``abort``, ``step``, ``generate``, ``start``/``stop``,
``loads``, ``audit``, ``flush_cache``).

Entry points run on the card: ``device=None`` means CUDA, and a machine
without one raises.  ``start()`` runs ``step()`` on a loop thread while
there is work; output callbacks run on that thread, outside the engine
lock.  With a ``tokenizer``, outputs carry text (``text_delta``, and
``text`` in ``GenerationResult``), ``stop`` strings end a request at this
layer (token stops live in the scheduler), and ``json_schema``/``regex``/
``ebnf`` install a grammar vocab mask.  Not ported yet: the step watchdog,
the flight recorder and metrics.
"""

from __future__ import annotations

import logging
import threading
import time
import uuid
from dataclasses import dataclass, field

from smg_tpu_torch.constrained import JsonMachine, TokenFilter
from smg_tpu_torch.engine.config import EngineConfig
from smg_tpu_torch.engine.detokenize import IncrementalDecoder, StopStringChecker
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
                 attention: str = "kernel", tokenizer=None):
        self.config = config
        self.tokenizer = tokenizer
        self.runner = ModelRunner(config, params=params, device=device, attention=attention)
        self.scheduler = Scheduler(self.runner, config)
        self._callbacks: dict[str, object] = {}
        self._json_filter = None  # shared TokenFilter (piece table + mask cache)
        self._grammar_filters: dict = {}  # (kind, pattern) -> TokenFilter
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
        if self.tokenizer is not None:
            req.detok = IncrementalDecoder(
                self.tokenizer, skip_special_tokens=sampling.skip_special_tokens)
            if sampling.stop:
                req.stop_checker = StopStringChecker(sampling.stop)
        req.token_filter = self._build_token_filter(sampling)
        with self._wakeup:
            self.scheduler.add_request(req)
            if on_output is not None:
                self._callbacks[rid] = on_output
            self._wakeup.notify_all()
        return rid

    def _build_token_filter(self, sampling: SamplingParams):
        """The grammar vocab-mask filter for structured output.
        ``json_schema`` constrains generation to syntactically valid JSON
        (``{}`` = any document; the schema's shape is not enforced).  One
        filter per regex/EBNF pattern (at most 16 kept) and one shared JSON
        filter: the piece table and the text-to-mask cache are per
        tokenizer and pattern."""
        if sampling.json_schema is None and not sampling.regex and not sampling.ebnf:
            return None
        if self.tokenizer is None:
            logger.warning("grammar constraint ignored: engine has no tokenizer")
            return None
        eos = self.config.model.eos_token_ids
        V = self.config.model.vocab_size
        if sampling.regex or sampling.ebnf:
            key = ("ebnf", sampling.ebnf) if sampling.ebnf else ("regex", sampling.regex)
            cached = self._grammar_filters.get(key)
            if cached is not None:
                return cached
            if sampling.ebnf:
                from smg_tpu_torch.constrained.ebnf import EbnfMachine

                machine = EbnfMachine(sampling.ebnf)
            else:
                from smg_tpu_torch.constrained.regex_fsm import RegexMachine

                machine = RegexMachine(sampling.regex)
            filt = TokenFilter(self.tokenizer, machine, V, eos_token_ids=eos)
            if len(self._grammar_filters) >= 16:  # bound the pattern-keyed mask caches
                self._grammar_filters.pop(next(iter(self._grammar_filters)))
            self._grammar_filters[key] = filt
            return filt
        if self._json_filter is None:
            self._json_filter = TokenFilter(self.tokenizer, JsonMachine(), V, eos_token_ids=eos)
        return self._json_filter

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
        """Detokenise a step's increment and scan it for stop strings token
        by token: a match swallows the stop string, rolls back the tokens
        after it and finishes the request here (``finish_request``); a match
        completed only by the final flush still reports ``stop``."""
        req = so.request
        out = RequestOutput(
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
        if req.detok is None:
            return out
        if req.stop_checker is None:
            text = req.detok.put(so.new_token_ids) if so.new_token_ids else ""
            if so.finished:
                text += req.detok.flush()
            out.text_delta = text
            return out
        parts: list[str] = []
        consumed = 0
        stopped = False
        for tok in so.new_token_ids:
            piece, stopped = req.stop_checker.feed(req.detok.put([tok]))
            consumed += 1
            parts.append(piece)
            if stopped:
                break
        if stopped and consumed < len(so.new_token_ids):
            # roll back the tokens after the stop (their KV lies past
            # seq_len, which never enters the radix cache)
            cut = len(so.new_token_ids) - consumed
            out.new_token_ids = out.new_token_ids[:consumed]
            out.logprobs = out.logprobs[:consumed]
            req.output_ids = req.output_ids[: len(req.output_ids) - cut]
            req.logprobs = req.logprobs[: len(req.logprobs) - cut]
            req.seq_len -= cut
            out.output_tokens = len(req.output_ids)
        if stopped:
            matched = req.stop_checker.matched
            if not so.finished:
                self.scheduler.finish_request(req.rid, "stop", matched_stop=matched)
            out.finished = True
            out.finish_reason = "stop"
            out.matched_stop = matched
        elif so.finished:
            piece, stopped_late = req.stop_checker.feed(req.detok.flush())
            parts.append(piece)
            if stopped_late:
                out.finish_reason = "stop"
                out.matched_stop = req.stop_checker.matched
            else:
                parts.append(req.stop_checker.flush())
        out.text_delta = "".join(parts)
        return out

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
        text="".join(c.text_delta for c in chunks),
        finish_reason=last.finish_reason or "stop",
        matched_stop=last.matched_stop,
        prompt_tokens=last.prompt_tokens,
        output_tokens=last.output_tokens,
        cached_tokens=chunks[0].cached_tokens if chunks else 0,
        logprobs=[x for c in chunks for x in c.logprobs],
    )
