"""Continuous-batching scheduler — a port of ``smg_tpu/engine/scheduler.py``
that keeps the reference's host logic for what it ports:

- the waiting queue, decode slots and page accounting, with evict-then-
  preempt back-pressure: a lane that needs a page the pool cannot give
  preempts the youngest request (a mid-prefill victim banks its computed
  pages in the radix cache, so readmission resumes from a prefix hit);
- radix prefix match at admission and insert at finish;
- stall-free chunked prefill under a per-step token budget;
- the decode megastep at bucketed shapes with the host trim at the
  earliest finish column, and ``DecodeState`` inputs refreshed only when
  the batch composition or the page tables change;
- the overlapped pipeline (``overlap_schedule``, on by default): step N's
  decode is launched before step N-1's tokens are fetched.  An
  ``InFlightFrame`` records each launch; a lookahead launch chains the
  frame's last sampled column on the device.  Any divergence from the
  synchronous schedule (a finish inside the frame, an abort, a deadline)
  discards the frame and rewinds the sampling counter, so token streams
  are byte-identical to ``overlap_schedule=False`` at any temperature;
- EOS, stop-id and ``max_new_tokens`` finishes, abort, deadlines (finish
  ``timeout``), drain, bounded queues and ``flush_cache``; ``audit`` checks
  that no page and no radix pin leaks;
- request semantics: penalties (per-slot device counts, re-derived from
  the host after admission, preemption or a discarded launch), grammar
  vocab masks (``TokenFilter``; forced K=1 and no lookahead), stop-string
  lanes at K=1 (the engine finds the match and calls ``finish_request``);
- speculative decoding (``speculative=True`` or a draft model): eligible
  lanes draft on the host (per-request n-gram index, or the draft model of
  ``engine/draft.py``) and verify as one fused device block
  (``runner.decode_spec_async``) after the rest lanes' megastep, with the
  verify frame in flight across steps under the overlap schedule; the
  acceptance-EMA depth, the ``spec_cold`` back-off and the drafted and
  accepted counts are the reference's;
- failure isolation: a prefill that raises quarantines its request (a
  grouped prefill retries its members solo first); a decode step that
  raises blames the newest lane and retries the survivors once, and a
  second failure condemns the batch.  A frame in flight when a step raised
  is discarded with its sampling counters rewound, so survivors' streams
  are byte-identical to a run without the fault.  Consecutive failed steps
  are counted for ``Engine.healthy``;
- the flight recorder's step ring and request timelines, the engine
  metrics, and KV events from the radix cache;
- LoRA lanes (a slot index per row) and multimodal requests: every prefill
  path (budgeted chunks, ``_prefill_solo``, grouped prefill) splices the
  request's image embeddings into its placeholder rows (``_mm_chunk``) and
  rotates by its M-RoPE ids (``_mrope_chunk``); decode lanes, lookahead
  and speculative lanes carry the request's M-RoPE offset; the radix cache
  keys pages by their image content (``_mm_extra_keys``), so two images
  behind the same placeholder ids never share KV, while the same image
  does;
- PD disaggregation: ``prefill_only`` prefills a prompt into pages outside
  any slot for export, ``alloc_import_pages`` and ``adopt_prefilled`` take
  an imported prompt straight into a decode lane.

A request that cannot be
admitted even with nothing else running (its prompt needs more pages than
the pool can free) finishes with reason ``error`` naming
``OutOfPagesError``.
"""

from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable

import numpy as np

from smg_tpu_torch.engine.config import EngineConfig
from smg_tpu_torch.engine.flight_recorder import FlightRecorder
from smg_tpu_torch.engine.kv_cache import OutOfPagesError, PagePool
from smg_tpu_torch.engine.radix_cache import RadixCache
from smg_tpu_torch.engine.request import (
    EngineRequest,
    FinishInfo,
    QueueFullError,
    RequestStatus,
    StepOutput,
)
from smg_tpu_torch.engine.runner import DecodeLaunch, DecodeState, ModelRunner, SpecLaunch
from smg_tpu_torch.engine.speculative import NgramIndex, SpecConfig, propose_ngram
from smg_tpu_torch.faults import FAULTS
from smg_tpu_torch.utils import get_logger

logger = get_logger("engine.scheduler")


@dataclass
class InFlightFrame:
    """One dispatched decode horizon whose results are not yet consumed.

    ``lanes`` pins each batch row to (slot, request, expected_seq_len): a
    lane whose request no longer matches when the frame is consumed went
    stale in flight (abort, deadline), and the frame is dropped — its KV
    landed past each request's final ``seq_len``, which never enters the
    radix cache.  ``rng_mark`` is the sampling counter before the launch,
    which consumed ``folds`` (= horizon) counters.

    A speculative verify frame (``spec``) holds a ``SpecLaunch`` (emitted
    rows [B, W], logprobs and ``n_emit`` per lane), the block width W as
    its horizon and one fold; ``draft_ns`` and ``tiers`` are each lane's
    drafted-token count and drafting tier, read at consume."""

    lanes: list  # [(slot, EngineRequest, expected_seq_len)]
    launch: DecodeLaunch | SpecLaunch
    horizon: int
    B: int  # padded batch bucket
    B_real: int
    mp_b: int
    positions: np.ndarray  # [B] launch positions (lookahead chaining)
    lane_sig: tuple
    rng_mark: int
    lookahead: bool = False
    folds: int = 1
    use_pen: bool = False
    use_lora: bool = False
    use_mrope: bool = False
    spec: bool = False
    draft_ns: list | None = None
    tiers: list | None = None


class Scheduler:
    def __init__(self, runner: ModelRunner, config: EngineConfig,
                 event_sink: Callable | None = None, metrics=None):
        self.runner = runner
        self.config = config
        # EngineMetrics (engine/metrics.py); None leaves a bare scheduler
        # without metrics, and every hook checks
        self.metrics = metrics
        self.sched = config.scheduler
        self.ps = runner.spec.page_size
        self.mp = runner.max_pages_per_seq
        self.pool = PagePool(runner.spec.num_pages)
        # None with enable_prefix_cache off: every prompt is computed whole
        self.radix = (RadixCache(self.ps, event_sink) if self.sched.enable_prefix_cache
                      else None)
        self.waiting: deque[EngineRequest] = deque()
        self.slots: list[EngineRequest | None] = [None] * self.sched.max_batch_size
        self.page_tables = np.zeros((self.sched.max_batch_size, self.mp), np.int32)
        self._pages_version = 0  # bumped on every page-table row change
        self.requests: dict[str, EngineRequest] = {}
        self._serial = 0
        self.inflight: InFlightFrame | None = None
        self._dstate = DecodeState()
        # draft-model proposer (engine/draft.py); the engine installs one
        # when config.draft_model is set
        self.draft = None
        # speculative decoding: drafted and accepted tokens, step-scoped
        # copies for the flight ring, and the acceptance-length EMA the
        # adaptive depth reads (_pick_spec_depth)
        self.num_spec_drafted = 0
        self.num_spec_accepted = 0
        self._step_spec_drafted = 0
        self._step_spec_accepted = 0
        self._spec_accept_ema = 0.0
        self.draining = False  # stop(drain=True): no new admissions
        self.num_prefill_tokens = 0
        self.num_decode_tokens = 0  # accepted decode tokens
        self.num_preemptions = 0
        self.num_lookahead_kept = 0
        self.num_lookahead_discarded = 0
        # decode columns computed but never accepted (trimmed horizons and
        # discarded frames); early exits: a finish inside a horizon
        self.num_wasted_decode_tokens = 0
        self.num_megastep_early_exits = 0
        self.num_queue_rejections = 0
        self.num_deadline_waiting = 0
        self.num_deadline_running = 0
        # radix hit-rate accounting, once per admission (a back-pressured
        # request re-probes every step)
        self.num_cached_prompt_tokens = 0
        self.num_computed_prompt_tokens = 0
        self.num_radix_hit_pages = 0
        self.num_radix_miss_pages = 0
        # adaptive horizon: EMA of decode columns between finishes
        self._finish_gap_ema = 0.0
        self._cols_since_finish = 0
        # failure isolation: quarantines and the step-failure streak
        # (``Engine.healthy`` reads ``consec_step_failures``)
        self.num_quarantined = 0
        self.num_step_failures = 0
        self.consec_step_failures = 0  # reset by a step with no failure
        self._step_had_failure = False
        self.flight = None  # config.flight_recorder off
        if config.flight_recorder:
            self.flight = FlightRecorder(
                ring_size=config.flight_ring_size, dump_dir=config.flight_dump_dir,
                dump_min_interval_secs=config.flight_dump_min_interval_secs)
            self.flight.metrics = metrics
        # step-scoped recorder state (reset at the top of every step)
        self._step_fault_phases: list[str] = []
        self._step_admissions = 0
        self._step_outcome: str | None = None
        self._step_fetch_s = 0.0
        self._step_horizon = 0
        # host seconds enqueueing decode launches vs blocked on their fetch:
        # step-scoped for the metrics, cumulative for loads()
        self._step_dispatch_s = 0.0
        self.dispatch_enqueue_s_total = 0.0
        self.fetch_wait_s_total = 0.0
        # dump reasons raised mid-step (quarantine, health flip), fired
        # after the step's own ring record lands so the dump holds it
        self._pending_dumps: list[str] = []

    # ---- public API ----

    def add_request(self, req: EngineRequest) -> None:
        if req.rid in self.requests:
            raise ValueError(f"duplicate request id {req.rid}")
        if self.draining:
            raise QueueFullError("engine draining; retry on another worker")
        req.sampling.validate()
        self._check_queue_capacity(req)
        self._serial += 1
        req.sched_serial = self._serial
        self.requests[req.rid] = req
        self.waiting.append(req)
        if self.flight is not None:
            self.flight.on_queued(req.rid, prompt_tokens=len(req.prompt_ids),
                                  trace_id=req.trace_id, meta=self._flight_meta(req),
                                  deadline_t=req.deadline)

    def _flight_meta(self, req: EngineRequest) -> dict:
        """Sampling metadata for the request's timeline (the reference's
        keys; priorities are not ported, so ``priority`` is always 0)."""
        sp = req.sampling
        meta = {"temperature": sp.temperature, "top_p": sp.top_p,
                "top_k": sp.top_k, "max_new_tokens": sp.max_new_tokens,
                "priority": 0}
        if sp.lora_adapter:
            meta["lora"] = sp.lora_adapter
        if req.token_filter is not None:
            meta["constrained"] = True
        return meta

    def _check_queue_capacity(self, req: EngineRequest) -> None:
        """Bounded waiting queue: only new submissions are bounded
        (preemption victims re-enter ``waiting`` directly)."""
        sched = self.sched
        full = bool(sched.max_queued_requests
                    and len(self.waiting) >= sched.max_queued_requests)
        if not full and sched.max_queued_tokens:
            queued = sum(len(r.all_token_ids) for r in self.waiting)
            full = queued + len(req.prompt_ids) > sched.max_queued_tokens
        if full:
            self.num_queue_rejections += 1
            if self.metrics is not None:
                self.metrics.queue_rejections.inc()
            raise QueueFullError(f"engine waiting queue full ({len(self.waiting)} "
                                 "queued); retry on another worker or later")

    def abort_request(self, rid: str) -> bool:
        req = self.requests.get(rid)
        if req is None or req.is_finished:
            return False
        if req.status in (RequestStatus.WAITING, RequestStatus.PREEMPTED):
            if req in self.waiting:
                self.waiting.remove(req)
            req.status = RequestStatus.ABORTED
            req.finish = FinishInfo(reason="abort")
            self._count_finish(req, "abort")
            self.requests.pop(rid, None)
            return True
        self._release(req, FinishInfo(reason="abort"), aborted=True)
        return True

    @property
    def spec_mode(self) -> bool:
        """Speculative decoding is on: asked for, or a draft model is
        installed."""
        return self.sched.speculative or self.draft is not None

    def has_work(self) -> bool:
        return (bool(self.waiting) or any(s is not None for s in self.slots)
                or self.inflight is not None)

    def _note_dispatch(self, seconds: float) -> None:
        """Account one decode launch's enqueue time."""
        self._step_dispatch_s += seconds
        self.dispatch_enqueue_s_total += seconds

    def prefill_inflight_tokens(self) -> int:
        """Un-prefilled prompt tokens of admitted, resumable prefills."""
        return sum(len(r.all_token_ids) - r.prefill_pos for r in self.slots
                   if r is not None and r.status is RequestStatus.PREFILLING)

    def loads(self) -> dict:
        live = [s for s in self.slots if s is not None]
        # token-load estimate: queued prompts and every admitted request's
        # remaining generation budget and un-prefilled prompt
        queued = sum(len(r.prompt_ids) + r.sampling.max_new_tokens for r in self.waiting)
        for s in live:
            queued += max(s.sampling.max_new_tokens - len(s.output_ids), 0)
            if s.status is RequestStatus.PREFILLING:
                queued += len(s.all_token_ids) - s.prefill_pos
        prefill_inflight = self.prefill_inflight_tokens()
        total_prompt = self.num_cached_prompt_tokens + self.num_computed_prompt_tokens
        out = {
            "num_waiting": len(self.waiting),
            "num_running": len(live),
            "num_prefilling": sum(s.status is RequestStatus.PREFILLING for s in live),
            "prefill_inflight_tokens": prefill_inflight,
            "prefill_backlog_tokens": prefill_inflight + sum(
                len(r.all_token_ids) for r in self.waiting),
            "free_pages": self.pool.free_count,
            "cached_pages": self.radix.num_cached_pages if self.radix else 0,
            "total_pages": self.runner.spec.num_pages,
            "queued_tokens": queued,
            "prefill_tokens": self.num_prefill_tokens,
            "decode_tokens": self.num_decode_tokens,
            "spec_drafted": self.num_spec_drafted,
            "spec_accepted": self.num_spec_accepted,
            "cached_prompt_tokens": self.num_cached_prompt_tokens,
            "computed_prompt_tokens": self.num_computed_prompt_tokens,
            "cache_hit_rate": (self.num_cached_prompt_tokens / total_prompt
                               if total_prompt else 0.0),
            "preemptions": self.num_preemptions,
            "radix_hit_pages": self.num_radix_hit_pages,
            "radix_miss_pages": self.num_radix_miss_pages,
            "radix_evicted_pages": self.radix.evicted_pages if self.radix else 0,
            "lookahead_kept": self.num_lookahead_kept,
            "lookahead_discarded": self.num_lookahead_discarded,
            "wasted_decode_tokens": self.num_wasted_decode_tokens,
            "megastep_early_exits": self.num_megastep_early_exits,
            "quarantined_requests": self.num_quarantined,
            "step_failures": self.num_step_failures,
            "consecutive_step_failures": self.consec_step_failures,
            "queue_rejections": self.num_queue_rejections,
            "deadline_expirations_waiting": self.num_deadline_waiting,
            "deadline_expirations_running": self.num_deadline_running,
            "draining": self.draining,
            "dispatch_enqueue_seconds": self.dispatch_enqueue_s_total,
            "fetch_wait_seconds": self.fetch_wait_s_total,
            # mesh topology: devices, the axes' sizes, platform, backend
            "mesh": self.runner.mesh_info(),
            **self.runner.graphs.stats(),
        }
        if self.metrics is not None:
            out["stats"] = self.metrics.window.snapshot()
        return out

    def audit(self) -> dict:
        """Zero-leak audit: every allocatable page is free, radix-cached or
        owned by a resident request (``leaked_pages == 0`` always), and at
        quiescence no radix node is pinned."""
        live = [r for r in self.slots if r is not None]
        held = sum(len(r.owned_pages) for r in live)
        cached = self.radix.num_cached_pages if self.radix else 0
        free = self.pool.free_count
        locks = (self.radix.lock_stats() if self.radix is not None
                 else {"locked_nodes": 0, "lock_refcounts": 0})
        quiescent = not live and not self.waiting and self.inflight is None
        leaked = self.pool.num_pages - 1 - free - cached - held  # page 0: garbage
        return {
            "live_slots": len(live),
            "waiting_requests": len(self.waiting),
            "inflight_frames": 0 if self.inflight is None else 1,
            "held_pages": held,
            "free_pages": free,
            "radix_cached_pages": cached,
            "leaked_pages": leaked,
            "radix_locked_nodes": locks["locked_nodes"],
            "radix_lock_refcounts": locks["lock_refcounts"],
            "quiescent": quiescent,
            "clean": leaked == 0 and (not quiescent or locks["locked_nodes"] == 0),
        }

    def flush_cache(self) -> bool:
        """Drop the prefix cache and zero the KV buffers (only when idle)."""
        if any(s is not None for s in self.slots) or self.waiting:
            return False
        # an idle scheduler can still hold a stale frame (its lanes finished)
        self.drop_inflight()
        if self.radix is not None:
            self.pool.free(self.radix.clear())
        self.runner.flush_cache_buffers()
        return True

    def step(self) -> list[StepOutput]:
        """One iteration with failure isolation: prefill failures are
        quarantined per request inside the prefill phase; anything that
        escapes is a decode-phase failure, handled by blame and one retry
        (``_recover_decode_failure``), so one poisoned batch never livelocks
        the engine.  The flight ring's record lands in ``finally``, also for
        a step whose exception escapes to the engine loop."""
        outputs: list[StepOutput] = []
        self._step_had_failure = False
        self._step_fault_phases = []
        self._step_admissions = 0
        self._step_outcome = None
        self._step_fetch_s = 0.0
        self._step_horizon = 0
        self._step_dispatch_s = 0.0
        self._step_spec_drafted = 0
        self._step_spec_accepted = 0
        pf0, dc0 = self.num_prefill_tokens, self.num_decode_tokens
        we0, ee0 = self.num_wasted_decode_tokens, self.num_megastep_early_exits
        t0 = time.perf_counter()
        escaped = True  # past recovery: the engine loop counts it (phase=loop)
        try:
            try:
                self._step_inner(outputs)
            except Exception as e:  # noqa: BLE001 — isolation boundary
                self._recover_decode_failure(outputs, e)
            else:
                if not self._step_had_failure:
                    # only a step with no recorded failure resets the streak:
                    # a worker failing every prefill must reach the threshold
                    self.consec_step_failures = 0
            escaped = False
        finally:
            if self.flight is not None:
                self.flight.record_step(
                    step_s=time.perf_counter() - t0,
                    prefill_tokens=self.num_prefill_tokens - pf0,
                    decode_tokens=self.num_decode_tokens - dc0,
                    running=sum(1 for s in self.slots if s is not None),
                    waiting=len(self.waiting),
                    max_batch=self.sched.max_batch_size,
                    prefill_inflight_tokens=self.prefill_inflight_tokens(),
                    free_pages=self.pool.free_count,
                    admissions=self._step_admissions,
                    finishes=sum(1 for o in outputs if o.finished),
                    overlap=self._step_outcome,
                    fetch_wait_s=self._step_fetch_s,
                    faults=self._step_fault_phases + (["loop"] if escaped else []),
                    horizon=self._step_horizon,
                    mesh=self.runner.mesh_devices,
                    early_exits=self.num_megastep_early_exits - ee0,
                    wasted_decode_tokens=self.num_wasted_decode_tokens - we0,
                    spec_drafted=self._step_spec_drafted,
                    spec_accepted=self._step_spec_accepted,
                )
            self.flush_pending_dumps()
        return outputs

    def flush_pending_dumps(self) -> None:
        """Fire dump reasons raised mid-step (quarantine, health flip) now
        that the step's ring record is in place.  The engine loop calls it
        too, after counting an escaped failure."""
        if not self._pending_dumps:
            return
        pending, self._pending_dumps = self._pending_dumps, []
        if self.flight is not None:
            for reason in pending:
                self.flight.auto_dump(reason)

    def _step_inner(self, outputs: list[StepOutput]) -> None:
        """Deadline sweep, the prefill phase under the token budget, and
        decode — pipelined (the next megastep launched before this one's
        tokens are fetched) or synchronous.  Speculative mode runs its own
        pipelined schedule (``_step_spec``): drafting needs the last step's
        accepted tokens on the host, so there is no chained lookahead, but
        the verify frame stays in flight across steps."""
        m = self.metrics
        self._expire_deadlines(outputs)
        pf0, dc0 = self.num_prefill_tokens, self.num_decode_tokens
        t0 = time.perf_counter()
        if self.sched.overlap_schedule and self.spec_mode:
            admit_s, fetch_s, outcome = self._step_spec(outputs)
            self._step_outcome = outcome
            self._step_fetch_s += fetch_s
        elif self.sched.overlap_schedule:
            admit_s, fetch_s, outcome = self._step_overlap(outputs)
            self._step_outcome = outcome
            self._step_fetch_s += fetch_s
        else:
            self.drop_inflight()  # mode flip mid-run: never strand a frame
            self._admit(outputs)
            admit_s = time.perf_counter() - t0
            self._decode(outputs)
            fetch_s, outcome = 0.0, None
        if m is None:
            return
        step_s = time.perf_counter() - t0
        m.observe_step(
            step_s=step_s, prefill_s=admit_s, decode_s=step_s - admit_s,
            prefill_tokens=self.num_prefill_tokens - pf0,
            decode_tokens=self.num_decode_tokens - dc0,
            running=sum(1 for s in self.slots if s is not None),
            waiting=len(self.waiting),
            prefill_inflight_tokens=self.prefill_inflight_tokens(),
            max_batch=self.sched.max_batch_size,
            free_pages=self.pool.free_count,
            total_pages=self.runner.spec.num_pages,
            cached_pages=self.radix.num_cached_pages if self.radix else 0,
            cumulative={
                "preemptions": self.num_preemptions,
                "radix_hit_pages": self.num_radix_hit_pages,
                "radix_miss_pages": self.num_radix_miss_pages,
                "radix_evicted_pages": self.radix.evicted_pages if self.radix else 0,
                "cached_prompt_tokens": self.num_cached_prompt_tokens,
                "wasted_decode_tokens": self.num_wasted_decode_tokens,
                "megastep_early_exits": self.num_megastep_early_exits,
            },
            decode_horizon=self._step_horizon,
        )
        if outcome is not None:
            m.observe_overlap(outcome=outcome, fetch_wait_s=fetch_s,
                              host_s=max(step_s - fetch_s, 0.0))
        if self._step_dispatch_s or self._step_fetch_s:
            m.observe_dispatch(enqueue_s=self._step_dispatch_s, fetch_s=self._step_fetch_s)

    # ---- failure isolation (poison-step quarantine) ----

    def _fail_request(self, req: EngineRequest, message: str,
                      outputs: list[StepOutput]) -> None:
        """Quarantine one request: a terminal ``error`` output, its slot,
        pages and radix pin released, and (through ``_release``'s error
        path) its possibly poisoned KV kept out of the radix cache.
        Surviving lanes are untouched."""
        if req.is_finished:
            return
        logger.error("quarantining request %s: %s", req.rid, message)
        self.num_quarantined += 1
        if self.metrics is not None:
            self.metrics.quarantined_requests.inc()
        # the event lands before the finish moves the timeline to the
        # finished ring, so the dump names the blamed request
        if self.flight is not None:
            self.flight.event(req.rid, "quarantine", message=message[:200])
        self._pending_dumps.append("quarantine")
        if req in self.waiting:
            self.waiting.remove(req)
        finish = FinishInfo(reason="error", message=message)
        if req.slot is not None:
            self._release(req, finish)
        else:
            req.finish = finish
            req.status = RequestStatus.FINISHED
            self._count_finish(req, "error", message)
            self.requests.pop(req.rid, None)
        outputs.append(StepOutput(req, [], True, finish))

    def _count_step_failure(self, phase: str) -> None:
        self.num_step_failures += 1
        self.consec_step_failures += 1
        self._step_had_failure = True
        if self.metrics is not None:
            self.metrics.step_failures.labels(phase=phase).inc()
        self._step_fault_phases.append(phase)
        if self.consec_step_failures == self.config.max_consecutive_step_failures:
            # the streak just crossed the unhealthy threshold: capture the
            # run-up
            self._pending_dumps.append("health_flip")

    def _recover_decode_failure(self, outputs: list[StepOutput], exc: Exception) -> None:
        """Blame for a decode-phase failure.  A batch gives no per-row error,
        so blame falls on the most recently admitted lane (the newest
        schedule change); it is quarantined and the survivors get one
        synchronous retry this step.  A second failure condemns the whole
        batch.  A raising path leaves its frame on ``self.inflight``, so
        ``drop_inflight`` rewinds its sampling counters before the retry
        samples again."""
        self.drop_inflight()
        active = self._decode_active()
        if not active:
            # nothing to blame: the engine loop counts it once as "loop"
            raise exc
        self._count_step_failure("decode")
        logger.exception("decode step failed; attributing blame")
        newest = max(active, key=lambda t: t[1].sched_serial)[1]
        self._fail_request(newest, f"decode step failed: {exc}", outputs)
        if not self._decode_active():
            return
        try:
            self._decode(outputs)
        except Exception as e2:  # noqa: BLE001 — second strike: condemn the batch
            self._count_step_failure("decode")
            self.drop_inflight()
            logger.exception("decode retry failed; quarantining the batch")
            for _slot, req in self._decode_active():
                self._fail_request(req, f"decode step failed after retry: {e2}", outputs)

    # ---- deadlines and drain ----

    def _expire_deadlines(self, outputs: list[StepOutput]) -> None:
        """Finish requests past their deadline with reason ``timeout``:
        queued ones leave the queue, resident ones are released like an
        abort (an in-flight frame holding them goes stale and is
        discarded)."""
        now = time.monotonic()
        m = self.metrics
        for req in [r for r in self.waiting if r.deadline is not None and now > r.deadline]:
            self.waiting.remove(req)
            req.status = RequestStatus.FINISHED
            req.finish = FinishInfo(reason="timeout")
            if self.flight is not None:
                self.flight.event(req.rid, "deadline", state="waiting")
            self._count_finish(req, "timeout")
            self.requests.pop(req.rid, None)
            self.num_deadline_waiting += 1
            if m is not None:
                m.deadline_expirations.labels(state="waiting").inc()
            outputs.append(StepOutput(req, [], True, req.finish))
        for req in list(self.slots):
            if (req is not None and req.deadline is not None and now > req.deadline
                    and not req.is_finished):
                if self.flight is not None:
                    self.flight.event(req.rid, "deadline", state="running")
                self._release(req, FinishInfo(reason="timeout"))
                self.num_deadline_running += 1
                if m is not None:
                    m.deadline_expirations.labels(state="running").inc()
                outputs.append(StepOutput(req, [], True, req.finish))

    def drain_waiting(self, outputs: list[StepOutput]) -> None:
        """End every queued request with a terminal ``abort`` (drain mode
        finishes admitted work and refuses the rest)."""
        while self.waiting:
            req = self.waiting.popleft()
            req.status = RequestStatus.ABORTED
            req.finish = FinishInfo(reason="abort", message="engine draining")
            self._count_finish(req, "abort", "engine draining")
            self.requests.pop(req.rid, None)
            outputs.append(StepOutput(req, [], True, req.finish))

    # ---- overlapped pipeline ----
    #
    # Invariant: token streams are byte-identical to the synchronous path,
    # so the sequence of device calls (with their sampling counters and
    # batch compositions) must be exactly the one the synchronous scheduler
    # issues; a lookahead launch that turns out not to match it is
    # discarded and the counter rewound before relaunching.

    def _step_overlap(self, outputs: list[StepOutput]) -> tuple[float, float, str]:
        """One pipeline iteration; returns (admit_s, fetch_wait_s, outcome)."""
        frame = self.inflight
        self.inflight = None
        fetch_s = 0.0
        outcome = "sync"
        if frame is not None and self._frame_stale(frame):
            # the schedule changed while the frame was in flight (abort,
            # deadline, quarantine): its tokens never existed in the sync
            # schedule.  Discard before the prefill phase, while its
            # counters are the newest.
            self._discard_frame(frame)
            outcome = "discarded" if frame.lookahead else "sync"
            frame = None
        look = None
        if frame is not None:
            # the lookahead IS this step's decode launch, dispatched before
            # the frame's results are fetched; the sync step samples prefill
            # before decode, so it is only legal when this step's prefill
            # phase provably samples nothing
            try:
                if self._prefill_phase_fold_free():
                    look = self._launch_lookahead(frame)
                fetch_s, used = self._consume_frame(frame, outputs)
            except Exception:
                # quarantine path: rewind the newest counters first (the
                # lookahead chained off this frame), then leave the frame on
                # ``inflight`` so the step's handler discards it too before
                # the blame and retry sample again
                if look is not None:
                    self._discard_frame(look)
                self.inflight = frame
                raise
            if used < frame.horizon:
                # a finish trimmed the frame: the lane set changes there, so
                # the lookahead no longer matches, and the frame's unused
                # counters rewind before the prefill phase can sample
                if look is not None:
                    self._discard_frame(look)
                    look = None
                    outcome = "discarded"
                self._rewind_unused_folds(frame, used)
        # admission after the consume sees every slot and page the frame's
        # finishes freed, as the sync schedule's admission would
        ta = time.perf_counter()
        disturbed = self._admit(outputs)
        admit_s = time.perf_counter() - ta
        if look is not None:
            if disturbed or self._frame_stale(look):
                self._discard_frame(look)
                outcome = "discarded"
            else:
                self.inflight = look
                outcome = "kept"
        if self.inflight is None:
            active = self._decode_active()
            if active:
                self.inflight = self._launch_frame(active)
        return admit_s, fetch_s, outcome

    def _mp_bucket(self, pages_needed: int) -> int:
        """Power-of-two page-table width (>= 8, capped at the full table):
        one graph per width, attention reads only live pages.  Every launch
        path shares it."""
        mp_b = 8
        while mp_b < pages_needed:
            mp_b *= 2
        return min(mp_b, self.mp)

    def _decode_active(self) -> list:
        """Running lanes in admission order (the row order of the batch):
        serial order is the same under the overlap and sync schedules, slot
        order is not."""
        act = [(i, r) for i, r in enumerate(self.slots)
               if r is not None and r.status is RequestStatus.RUNNING]
        act.sort(key=lambda t: t[1].sched_serial)
        return act

    def _prefill_phase_fold_free(self) -> bool:
        """Conservatively predict, before the frame is consumed, that this
        step's prefill phase samples nothing: the oldest resumable prefill
        takes a non-final chunk that eats the whole budget, or nothing waits
        and nothing is mid-prefill.  May say False wrongly (one step runs
        synchronously), never True wrongly.  Under ``throughput`` any
        waiting request may admit and sample."""
        if self.sched.prefill_mix_policy == "throughput":
            return not self.waiting
        budget = self.sched.max_prefill_tokens
        cont = [r for r in self.slots
                if r is not None and r.status is RequestStatus.PREFILLING]
        if cont:
            first = min(cont, key=lambda r: r.sched_serial)
            if len(first.all_token_ids) - first.prefill_pos <= budget:
                return False  # final chunk will sample this step
            budget = 0  # the non-final chunk consumes the whole budget
        return budget == 0 or not self.waiting

    def _frame_stale(self, frame: InFlightFrame) -> bool:
        """True when the frame no longer matches the sync schedule: a lane
        was released or the decode lane set changed.  A verify frame never
        belongs to this pipeline (an overlap-mode switch mid-run)."""
        if frame.spec:
            return True
        active = self._decode_active()
        if len(active) != len(frame.lanes):
            return True
        for (slot, req, expected), (i, r) in zip(frame.lanes, active):
            if slot != i or req is not r or req.is_finished or req.seq_len != expected:
                return True
        return False

    def _discard_frame(self, frame: InFlightFrame) -> None:
        """Drop a frame's results and rewind the sampling counter, unless
        something else sampled since its launch.  The device penalty counts
        the discarded horizon advanced are re-derived from the host before
        the lanes' next launch."""
        if frame.lookahead:
            self.num_lookahead_discarded += 1
        if self.runner.rng_mark() == frame.rng_mark + frame.folds:
            self.runner.rng_restore(frame.rng_mark)
        self.num_wasted_decode_tokens += frame.B_real * frame.horizon
        if frame.use_pen:
            for _slot, req, _expected in frame.lanes:
                if req.sampling.has_penalties and not req.is_finished:
                    req.penalty_synced = False

    def _rewind_unused_folds(self, frame: InFlightFrame, used: int) -> None:
        """A finish trimmed a consumed megastep at column ``used - 1``: the
        sync schedule sampled only ``used`` of its counters before the batch
        changed, so the tail rewinds (while the frame's counters are still
        the newest)."""
        if self.runner.rng_mark() == frame.rng_mark + frame.folds:
            self.runner.rng_restore(frame.rng_mark + used)

    def drop_inflight(self) -> None:
        """Discard any pending frame (stop, flush, an overlap-mode flip)."""
        if self.inflight is not None:
            self._discard_frame(self.inflight)
            self.inflight = None

    def _consume_frame(self, frame: InFlightFrame,
                       outputs: list[StepOutput]) -> tuple[float, int]:
        """The deferred fetch and host-side acceptance; returns (seconds
        blocked on the device, columns accepted).  Acceptance stops at the
        earliest finish column across the batch: later columns belong to a
        batch the single-step schedule would have recomposed."""
        FAULTS.fire("engine.device_fetch",
                    rids=",".join(r.rid for _s, r, _e in frame.lanes))
        t0 = time.perf_counter()
        toks, lps, sr = self.runner.decode_fetch(frame.launch)
        fetch_s = time.perf_counter() - t0
        self.fetch_wait_s_total += fetch_s
        self._step_horizon = frame.horizon
        if frame.lookahead:
            self.num_lookahead_kept += 1
        used = min(frame.horizon, sr) if sr > 0 else frame.horizon
        finished_any = False
        for idx, (_slot, req, _expected) in enumerate(frame.lanes):
            col = self._host_finish_col(req, toks[idx], used)
            if col is not None:
                finished_any = True
                used = min(used, col + 1)
        if sr < frame.horizon:
            self.num_megastep_early_exits += 1
        # every column was computed on the card: the trimmed ones are waste
        self.num_wasted_decode_tokens += (frame.horizon - used) * frame.B_real
        self.num_decode_tokens += frame.B_real * used
        for idx, (_slot, req, _expected) in enumerate(frame.lanes):
            self._accept_tokens(req, [int(t) for t in toks[idx][:used]],
                                [float(x) for x in lps[idx][:used]], outputs,
                                advance_seq=True)
        self._cols_since_finish += used
        if finished_any:
            gap = float(self._cols_since_finish)
            self._finish_gap_ema = (gap if self._finish_gap_ema == 0.0
                                    else 0.7 * self._finish_gap_ema + 0.3 * gap)
            self._cols_since_finish = 0
        return fetch_s, used

    def _launch_lookahead(self, frame: InFlightFrame) -> InFlightFrame | None:
        """The launch for the step after ``frame``, dispatched before
        ``frame`` is consumed: its input tokens are the frame's last sampled
        column on the device, its positions advance by the horizon.  None
        when the next step is not predictable: a lane will finish on length
        inside the frame, or the extended horizon needs pages the free pool
        does not hold (eviction or preemption here would diverge from the
        sync schedule's, which runs after finishes release pages), or a lane
        is grammar-constrained (its vocab mask derives from the token the
        frame has not yet returned)."""
        FAULTS.fire("engine.decode_step",
                    rids=",".join(r.rid for _s, r, _e in frame.lanes))
        H = frame.horizon
        lanes = [(s, r) for s, r, _ in frame.lanes]
        H2, _max_steps = self._pick_horizon(lanes)
        max_seq = self.sched.max_seq_len
        need = 0
        for _slot, req, expected in frame.lanes:
            if req.token_filter is not None:
                return None
            if len(req.output_ids) + H >= req.sampling.max_new_tokens:
                return None
            if req.total_len + H >= max_seq:
                return None
            limit = min(expected + H + H2, max_seq)
            have = len(req.shared_pages) + len(req.owned_pages)
            need += max(0, math.ceil(limit / self.ps) - have)
        if need > self.pool.free_count:
            return None
        for _slot, req, _expected in frame.lanes:
            # the precheck guarantees allocation without eviction or preemption
            if not self._ensure_seq_capacity(req, H + H2):
                return None
        mp_b = self._mp_bucket(max(
            math.ceil(min(expected + H + H2, max_seq) / self.ps)
            for _slot, _req, expected in frame.lanes))
        positions = frame.positions + np.int32(H)
        positions[frame.B_real:] = mp_b * self.ps  # padded rows -> garbage page
        ds = self._refresh_decode_state(lanes, frame.B, mp_b, frame.lane_sig,
                                        use_pen=frame.use_pen, use_lora=frame.use_lora,
                                        use_mrope=frame.use_mrope)
        mark = self.runner.rng_mark()
        t_dispatch = time.perf_counter()
        launch = self.runner.decode_multi_async(frame.launch.last_col, positions, ds, H2)
        self._note_dispatch(time.perf_counter() - t_dispatch)
        return InFlightFrame(
            lanes=[(s, r, e + H) for s, r, e in frame.lanes], launch=launch,
            horizon=H2, B=frame.B, B_real=frame.B_real, mp_b=mp_b,
            positions=positions, lane_sig=frame.lane_sig, rng_mark=mark,
            lookahead=True, folds=H2, use_pen=frame.use_pen, use_lora=frame.use_lora,
            use_mrope=frame.use_mrope)

    # ---- prefill phase ----

    def _admit(self, outputs: list[StepOutput]) -> bool:
        """This step's prefill phase under ``prefill_mix_policy``; True when
        anything sampled."""
        if self.sched.prefill_mix_policy == "throughput":
            return self._admit_legacy(outputs)
        return self._admit_budgeted(outputs)

    def _admit_budgeted(self, outputs: list[StepOutput]) -> bool:
        """Spend at most one ``max_prefill_tokens`` budget: resume
        ``PREFILLING`` slot-holders (oldest first), then admit waiting prompts
        into the leftover.  Non-final chunks write KV only; a final chunk
        samples the first token and promotes the request to a decode lane.
        Returns True when anything sampled (the overlap pipeline keeps a
        lookahead only across a phase that sampled nothing)."""
        sched = self.sched
        budget = sched.max_prefill_tokens
        disturbed = False
        cont = sorted(
            (r for r in self.slots if r is not None and r.status is RequestStatus.PREFILLING),
            key=lambda r: r.sched_serial,
        )
        for req in cont:
            if budget <= 0:
                break
            remaining = len(req.all_token_ids) - req.prefill_pos
            if remaining <= budget:
                budget -= remaining
                try:
                    self._prefill_final(req, outputs)
                except Exception as e:  # noqa: BLE001 — quarantine boundary
                    self._count_step_failure("prefill")
                    self._fail_request(req, f"prefill failed: {e}", outputs)
                # disturbed either way: a failure may have sampled before it
                # raised, and a wrongly kept lookahead would desync streams
                disturbed = True
            else:
                if budget < min(self.ps, sched.max_prefill_tokens):
                    break  # sub-page leftover: not worth a dispatch
                try:
                    self._prefill_chunk(req, budget)
                except Exception as e:  # noqa: BLE001 — quarantine boundary
                    self._count_step_failure("prefill")
                    self._fail_request(req, f"prefill failed: {e}", outputs)
                budget = 0
        group: list[EngineRequest] = []
        while budget > 0 and not self.draining and self.waiting:
            got = self._try_admit_head(outputs, budget_left=budget)
            if got is None:
                break  # no slot, page back-pressure, or sliver-sized leftover
            if got == "consumed":
                continue  # head finished without admission
            req = got
            remaining = len(req.all_token_ids) - req.prefill_pos
            if remaining <= budget:
                budget -= remaining
                group.append(req)
                if len(group) >= sched.max_prefill_group:
                    self._prefill_group_guarded(group, outputs)
                    disturbed = True
                    group = []
            else:
                try:
                    self._prefill_chunk(req, budget)  # first resumable chunk
                except Exception as e:  # noqa: BLE001 — quarantine boundary
                    self._count_step_failure("prefill")
                    self._fail_request(req, f"prefill failed: {e}", outputs)
                budget = 0
        if group:
            self._prefill_group_guarded(group, outputs)
            disturbed = True
        return disturbed

    def _prefill_group_guarded(self, group: list[EngineRequest],
                               outputs: list[StepOutput]) -> None:
        """Grouped prefill with per-request blame: when the batched call
        fails, the members retry solo, so only the culprit is quarantined
        and the others still promote this step."""
        try:
            self._prefill_group(group, outputs)
            return
        except Exception:  # noqa: BLE001 — quarantine boundary
            self._count_step_failure("prefill")
            logger.exception("grouped prefill failed; retrying %d members solo", len(group))
        for req in group:
            if req.is_finished:
                continue
            try:
                self._prefill_final(req, outputs)
            except Exception as e:  # noqa: BLE001 — the culprit
                self._fail_request(req, f"prefill failed: {e}", outputs)

    def _admit_legacy(self, outputs: list[StepOutput]) -> bool:
        """Drain-the-queue admission (``prefill_mix_policy="throughput"``):
        every admissible request prefills this step, a long prompt running
        all its chunks back to back (``_prefill_solo``), the short ones in
        groups; decode waits for the whole drain."""
        disturbed = False
        while not self.draining and self.waiting:
            group: list[EngineRequest] = []
            admitted_any = False
            while self.waiting and len(group) < self.sched.max_prefill_group:
                got = self._try_admit_head(outputs)
                if got is None:
                    break
                if got == "consumed":
                    continue
                req = got
                admitted_any = disturbed = True
                if len(req.all_token_ids) - req.cached_tokens > self.sched.max_prefill_tokens:
                    try:
                        self._prefill_solo(req, outputs)
                    except Exception as e:  # noqa: BLE001 — quarantine boundary
                        self._count_step_failure("prefill")
                        self._fail_request(req, f"prefill failed: {e}", outputs)
                else:
                    group.append(req)
            if group:
                self._prefill_group_guarded(group, outputs)
            if not admitted_any:
                return disturbed
        return disturbed

    def _try_admit_head(self, outputs: list[StepOutput], budget_left: int | None = None):
        """Admit the head of the waiting queue into a free slot: radix-match
        its prefix, allocate pages for the whole prompt, park it
        ``PREFILLING`` at the matched prefix.  Returns the request, None when
        blocked (no slot, no pages, or a leftover ``budget_left`` too small
        for a chunk), or ``"consumed"`` when the head finished without
        admission."""
        free_slots = [i for i, s in enumerate(self.slots) if s is None]
        if not free_slots:
            return None
        req = self.waiting[0]
        prompt = req.all_token_ids  # includes prior output after preemption
        if len(prompt) + 1 > self.sched.max_seq_len:
            self.waiting.popleft()
            self._finish_unadmitted(req, FinishInfo(
                reason="error",
                message=f"prompt length {len(prompt)} exceeds max_seq_len "
                        f"{self.sched.max_seq_len}"), outputs)
            return "consumed"
        if req.sampling.max_new_tokens == 0:
            self.waiting.popleft()
            self._finish_unadmitted(req, FinishInfo(reason="length"), outputs)
            return "consumed"
        # never match the full prompt: one token must run to give logits.
        # Image requests match through per-page content salts: the same
        # placeholder ids with other pixels hash to other chains
        shared_pages, node = [], None
        if self.radix is not None:
            shared_pages, node = self.radix.match_prefix(
                prompt[:-1], extra_keys=self._mm_extra_keys(req, len(prompt)))
        matched = len(shared_pages) * self.ps
        remaining = len(prompt) - matched
        if (budget_left is not None and remaining > budget_left
                and budget_left < min(self.ps, self.sched.max_prefill_tokens)):
            return None  # sliver: wait for next step's full budget
        need = math.ceil(len(prompt) / self.ps) - len(shared_pages)
        # pin the matched chain before the free-page check may evict
        if node is not None:
            self.radix.lock(node)
        if not self._ensure_free_pages(need + self.sched.watermark_pages):
            if node is not None:
                self.radix.unlock(node)
            if not any(s is not None for s in self.slots) and self.inflight is None:
                # nothing running will ever release a page
                self.waiting.popleft()
                self._finish_unadmitted(req, FinishInfo(reason="error", message=(
                    f"{OutOfPagesError.__name__}: request {req.rid} needs {need} pages "
                    f"(+{self.sched.watermark_pages} watermark), {self.pool.free_count} "
                    "free and nothing running will release any")), outputs)
                return "consumed"
            return None  # back-pressure: running requests will release pages
        self.waiting.popleft()
        self.num_cached_prompt_tokens += matched
        self.num_computed_prompt_tokens += remaining
        self.num_radix_hit_pages += len(shared_pages)
        self.num_radix_miss_pages += need
        req.radix_node = node
        req.shared_pages = shared_pages
        req.cached_tokens = matched
        req.owned_pages = self.pool.alloc(need)
        req.status = RequestStatus.PREFILLING
        req.prefill_pos = matched
        req.seq_len = matched
        slot = free_slots[0]
        req.slot = slot
        row = self.page_tables[slot]
        row[:] = 0
        all_pages = shared_pages + req.owned_pages
        row[: len(all_pages)] = all_pages
        self._pages_version += 1
        self.slots[slot] = req
        self._step_admissions += 1
        if self.flight is not None:
            self.flight.event(req.rid, "admitted", slot=slot, cached_tokens=matched)
        return req

    def _prefill_chunk(self, req: EngineRequest, take: int) -> None:
        """Advance a resumable prefill by one NON-final chunk (KV only,
        nothing sampled: a lookahead frame stays in flight across it)."""
        FAULTS.fire("engine.prefill", rid=req.rid)
        start = req.prefill_pos
        chunk = req.all_token_ids[start : start + take]
        self.runner.prefill_extend(chunk, prefix_len=start,
                                   page_table=self.page_tables[req.slot],
                                   lora_idx=req.lora_idx,
                                   mm=self._mm_chunk(req, start, len(chunk)),
                                   rope_pos=self._mrope_chunk(req, start, len(chunk)))
        self.num_prefill_tokens += len(chunk)
        req.prefill_pos += len(chunk)
        req.seq_len = req.prefill_pos
        if self.flight is not None:
            self.flight.event(req.rid, "prefill_chunk", start=start, n=len(chunk), final=False)

    def _prefill_final(self, req: EngineRequest, outputs: list[StepOutput]) -> None:
        """Final chunk of a resumable prefill: sample the first token and
        promote the request to a decode lane."""
        FAULTS.fire("engine.prefill", rid=req.rid)
        prompt = req.all_token_ids
        start = req.prefill_pos
        sp = req.sampling
        pen = None
        if sp.has_penalties:
            counts, pmask = self._req_pen_state(req)
            pen = (counts, pmask, sp.frequency_penalty, sp.presence_penalty,
                   sp.repetition_penalty)
        mask = self._mask_for(req) if req.token_filter is not None else None
        n = len(prompt) - start
        tok, lp = self.runner.prefill(
            prompt[start:], prefix_len=start, page_table=self.page_tables[req.slot],
            temperature=sp.temperature, top_k=sp.top_k, top_p=sp.top_p, min_p=sp.min_p,
            pen=pen, mask=mask, lora_idx=req.lora_idx, mm=self._mm_chunk(req, start, n),
            rope_pos=self._mrope_chunk(req, start, n))
        self.num_prefill_tokens += len(prompt) - start
        req.prefill_pos = req.seq_len = len(prompt)
        req.status = RequestStatus.RUNNING
        if self.flight is not None:
            self.flight.event(req.rid, "prefill_chunk", start=start, n=len(prompt) - start,
                              final=True)
        self._accept_tokens(req, [tok], [lp], outputs, advance_seq=False)

    def _prefill_solo(self, req: EngineRequest, outputs: list[StepOutput]) -> None:
        """A long prompt's chunks back to back, at most ``max_prefill_tokens``
        each: the non-final ones write KV only, the last samples."""
        while len(req.all_token_ids) - req.prefill_pos > self.sched.max_prefill_tokens:
            self._prefill_chunk(req, self.sched.max_prefill_tokens)
        self._prefill_final(req, outputs)

    def _mrope_chunk(self, req: EngineRequest, start: int, n: int):
        """[3, n] M-RoPE ids for one prefill chunk, None for a request
        without them.  Positions past the prompt (a re-prefill after
        preemption re-runs generated tokens) are text: all three axes =
        sequence position + delta."""
        if req.mrope_pos is None:
            return None
        idx = np.arange(start, start + n)
        out = np.broadcast_to((idx + req.mrope_delta)[None, :], (3, n)).astype(np.int32)
        pl = req.mrope_pos.shape[1]
        within = idx < pl
        if within.any():
            out[:, within] = req.mrope_pos[:, idx[within]]
        return out

    def _mm_extra_keys(self, req: EngineRequest, n_tokens: int | None = None
                       ) -> "list[int] | None":
        """Per-page content salts for radix keying (the reference's extra
        keys mixed into the chain hashes): page p's salt digests the
        embedding rows and in-page offsets of every placeholder position it
        covers, and, under M-RoPE, its position ids wherever they leave the
        sequential arange (the image pages and everything after them:
        generated positions carry the delta); 0 = a page with neither.
        ``n_tokens`` extends coverage past the prompt, for the insert at
        finish."""
        if req.mm_embeds is None:
            return None
        if n_tokens is None:
            n_tokens = len(req.prompt_ids)
        cached = req.mm_extra_keys
        if cached is not None and cached[0] == n_tokens:
            return cached[1]
        import hashlib

        embeds, positions = req.mm_embeds
        n_pages = math.ceil(n_tokens / self.ps)
        keys = [0] * n_pages
        order = np.argsort(positions)
        for p in range(n_pages):
            lo, hi = p * self.ps, (p + 1) * self.ps
            sel = order[(positions[order] >= lo) & (positions[order] < hi)]
            mr = None
            if req.mrope_pos is not None:
                mslice = self._mrope_chunk(req, lo, min(hi, n_tokens) - lo)
                seq = np.arange(lo, lo + mslice.shape[1], dtype=mslice.dtype)
                if not (mslice == seq[None, :]).all():
                    mr = mslice
            if sel.size == 0 and mr is None:
                continue
            h = hashlib.blake2b(digest_size=8)
            h.update(np.ascontiguousarray(positions[sel] - lo).tobytes())
            h.update(np.ascontiguousarray(embeds[sel], np.float32).tobytes())
            if mr is not None:
                h.update(b"mrope")
                h.update(np.ascontiguousarray(mr).tobytes())
            keys[p] = int.from_bytes(h.digest(), "little") or 1
        req.mm_extra_keys = (n_tokens, keys)
        return keys

    def _mm_chunk(self, req: EngineRequest, start: int, chunk_len: int):
        """The request's image embeddings for one prefill chunk: a dense
        [chunk_len, E] float32 buffer and the bool mask of its placeholder
        rows; None for a request without images."""
        if req.mm_embeds is None:
            return None
        embeds, positions = req.mm_embeds
        sel = (positions >= start) & (positions < start + chunk_len)
        out = np.zeros((chunk_len, embeds.shape[1]), np.float32)
        m = np.zeros(chunk_len, bool)
        idx = positions[sel] - start
        out[idx] = embeds[sel]
        m[idx] = True
        return out, m

    def _prefill_group(self, group: list[EngineRequest], outputs: list[StepOutput]) -> None:
        """One batched prefill for a group of single-chunk prompts."""
        for req in group:
            # per-member seam before any bookkeeping changes, so the guarded
            # caller's solo retry finds every member untouched
            FAULTS.fire("engine.prefill", rid=req.rid)
        chunks = [(r.all_token_ids[r.cached_tokens:], r.cached_tokens,
                   self.page_tables[r.slot]) for r in group]
        sps = [r.sampling for r in group]
        pen = None
        if any(s.has_penalties for s in sps):
            counts, pmask = (np.stack(x) for x in zip(*map(self._req_pen_state, group)))
            pen = (counts, pmask, *self._pen_scalars(group, len(group)))
        use_lora = any(r.lora_idx for r in group)
        mm = [self._mm_chunk(r, r.cached_tokens, len(c[0])) for r, c in zip(group, chunks)]
        rope = [self._mrope_chunk(r, r.cached_tokens, len(c[0]))
                for r, c in zip(group, chunks)]
        toks, lps = self.runner.prefill_batched(
            chunks, [s.temperature for s in sps], [s.top_k for s in sps],
            [s.top_p for s in sps], [s.min_p for s in sps], pen=pen,
            mask=self._masks(group, len(group)),
            lora_idx=[r.lora_idx for r in group] if use_lora else None,
            mm=mm if any(m is not None for m in mm) else None,
            rope=rope if any(r is not None for r in rope) else None)
        for i, req in enumerate(group):
            self.num_prefill_tokens += len(chunks[i][0])
            req.seq_len = req.prefill_pos = req.total_len
            req.status = RequestStatus.RUNNING
            if self.flight is not None:
                self.flight.event(req.rid, "prefill_chunk", start=chunks[i][1],
                                  n=len(chunks[i][0]), final=True, grouped=True)
            self._accept_tokens(req, [int(toks[i])], [float(lps[i])], outputs,
                                advance_seq=False)

    def _mask_for(self, req: EngineRequest) -> np.ndarray:
        """The grammar vocab mask for the request's next token.  A vocabulary
        with no valid continuation (the tokenizer cannot spell the grammar)
        degrades to EOS only, so generation terminates instead of sampling
        over NEG_INF logits."""
        f = req.token_filter
        m = f.allowed_mask(f.text_of(req.output_ids))
        if not m.any():
            m = m.copy()
            m[list(self.config.model.eos_token_ids)] = True
        return m

    def _masks(self, reqs: list[EngineRequest], n: int) -> np.ndarray | None:
        """[n, V] grammar masks for ``n`` rows, the first ones ``reqs``'s:
        all-true for a request without a grammar and for padded rows; None
        when no request has a grammar."""
        if all(r.token_filter is None for r in reqs):
            return None
        mask = np.ones((n, self.runner.model_cfg.vocab_size), bool)
        for i, req in enumerate(reqs):
            if req.token_filter is not None:
                mask[i] = self._mask_for(req)
        return mask

    @staticmethod
    def _pen_scalars(reqs: list[EngineRequest], n: int) -> tuple:
        """(frequency, presence, repetition) penalties [n] float32 for ``n``
        rows, the first ones ``reqs``'s: neutral (0, 0, 1) for a request
        without penalties and for padded rows, which then change nothing."""
        freqs, pres, reps = np.zeros(n, np.float32), np.zeros(n, np.float32), np.ones(n, np.float32)
        for i, req in enumerate(reqs):
            sp = req.sampling
            if sp.has_penalties:
                freqs[i], pres[i] = sp.frequency_penalty, sp.presence_penalty
                reps[i] = sp.repetition_penalty
        return freqs, pres, reps

    def _req_pen_state(self, req: EngineRequest) -> tuple:
        """Host-side (counts [V], prompt_mask [V]) snapshot for a prefill."""
        return self.runner.penalty_state(req.prompt_ids, req.output_ids)

    def _ensure_free_pages(self, n: int) -> bool:
        if self.pool.free_count >= n or self.radix is None:
            return self.pool.free_count >= n
        freed = self.radix.evict(n - self.pool.free_count)
        if freed:
            self.pool.free(freed)
        return self.pool.free_count >= n

    # ---- decode ----

    def _decode(self, outputs: list[StepOutput]) -> None:
        """Synchronous decode: launch one megastep and consume it in-step
        (the pipeline calls the same halves with a frame between).
        Speculative mode runs the phase order of the pipelined
        ``_step_spec`` (rest megastep, then the verify block) with the frame
        consumed in-step, which keeps overlap on and off byte-identical."""
        active = self._decode_active()
        if not active:
            return
        if self.spec_mode:
            self._spec_phase(outputs, pipelined=False)
            return
        self._decode_batch(active, outputs)

    def _decode_batch(self, active: list, outputs: list[StepOutput]) -> None:
        """Launch one megastep for ``active`` and consume it in-step."""
        frame = self._launch_frame(active)
        if frame is not None:
            try:
                fetch_s, used = self._consume_frame(frame, outputs)
            except Exception:
                # left for the quarantine handler's drop_inflight, which
                # rewinds this frame's counters before any retry samples
                self.inflight = frame
                raise
            self._step_fetch_s += fetch_s
            if used < frame.horizon:
                self._rewind_unused_folds(frame, used)

    def _refresh_decode_state(self, active: list, B: int, mp_b: int, sig: tuple,
                              stop_e: int = 0, use_pen: bool = False,
                              use_lora: bool = False,
                              use_mrope: bool = False) -> DecodeState:
        """Bring the decode inputs up to date: sampling parameters, penalty
        rows, adapter slots (``use_lora``), M-RoPE offsets (``use_mrope``)
        and stop state (``stop_e`` > 0:
        per-lane stop ids, absolute length limits, live-lane mask) only on a
        new composition ``sig``;
        page tables only on a new composition, width or page-table change.
        With ``use_pen``, lanes whose device penalty row is stale (new
        admission, preemption, a discarded launch) re-derive it from the
        host whatever the signature."""
        ds = self._dstate
        if ds.lane_sig != sig:
            ds.temps = np.zeros(B, np.float32)
            ds.topks = np.full(B, -1, np.int64)
            ds.topps = np.ones(B, np.float32)
            ds.minps = np.zeros(B, np.float32)
            for idx, (_slot, req) in enumerate(active):
                sp = req.sampling
                ds.temps[idx], ds.topks[idx] = sp.temperature, sp.top_k
                ds.topps[idx], ds.minps[idx] = sp.top_p, sp.min_p
            ds.stop_ids = ds.limits = ds.live = None
            if stop_e > 0:
                # -1 pads the id sets (tokens are >= 0); padded rows are not
                # live, so they start done and never end a horizon
                eos = tuple(self.config.model.eos_token_ids)
                ds.stop_ids = np.full((B, stop_e), -1, np.int64)
                ds.limits = np.ones(B, np.int64)
                ds.live = np.zeros(B, bool)
                for idx, (_slot, req) in enumerate(active):
                    sp = req.sampling
                    ids = list(sp.stop_token_ids) + ([] if sp.ignore_eos else list(eos))
                    ds.stop_ids[idx, : len(ids)] = ids
                    ds.limits[idx] = min(req.prompt_len + sp.max_new_tokens,
                                         self.sched.max_seq_len)
                    ds.live[idx] = True
            ds.slot_idx = ds.freqs = ds.pres = ds.reps = None
            if use_pen:
                # padded rows read and write the garbage row S
                ds.slot_idx = np.full(B, self.sched.max_batch_size, np.int64)
                ds.slot_idx[: len(active)] = [slot for slot, _ in active]
                ds.freqs, ds.pres, ds.reps = self._pen_scalars([r for _, r in active], B)
            ds.lora_idx = None
            if use_lora:
                ds.lora_idx = np.zeros(B, np.int64)  # padded rows: no adapter
                ds.lora_idx[: len(active)] = [r.lora_idx for _, r in active]
            ds.rope_delta = None
            if use_mrope:
                ds.rope_delta = np.zeros(B, np.int32)  # text and padded rows: 0
                ds.rope_delta[: len(active)] = [r.mrope_delta for _, r in active]
            ds.lane_sig = sig
        if use_pen:
            for slot, req in active:
                if req.sampling.has_penalties and not req.penalty_synced:
                    self.runner.sync_slot_penalty_state(slot, req.prompt_ids, req.output_ids)
                    req.penalty_synced = True
        pt_sig = (sig, mp_b, self._pages_version)
        if ds.pt_sig != pt_sig:
            ds.page_tables = np.zeros((B, mp_b), np.int32)
            for idx, (slot, _req) in enumerate(active):
                ds.page_tables[idx] = self.page_tables[slot][:mp_b]
            ds.pt_sig = pt_sig
        return ds

    def _pick_horizon(self, active: list) -> tuple[int, int]:
        """This launch's horizon K and the widest one this composition may
        take; returns ``(K, max_steps)``.

        Pending admission work (a waiting queue or a resumable prefill)
        forces K=1: the single-step schedule could admit between any two
        columns, and a horizon spanning that point would compute later
        columns with a batch the single-step schedule never runs.  Otherwise
        ``decode_horizon``, or with ``adaptive_horizon`` the cap halved while
        it exceeds the finish-gap EMA and clamped to the smallest remaining
        token budget; either way halved until growing every lane fits the
        free pages (a preemption forced by a wide horizon alone would
        change the schedule).

        Grammar and stop-string lanes force ``(1, 1)``: a vocab mask derives
        from the previous token on the host, and a stop string is found by
        the engine after detokenisation, which the device cannot see."""
        sched = self.sched
        cap = sched.horizon_cap
        forced = any(r.token_filter is not None or r.sampling.stop for _, r in active)
        if forced or cap <= 1:
            return 1, 1
        if self.waiting or any(r is not None and r.status is RequestStatus.PREFILLING
                               for r in self.slots):
            return 1, cap
        if sched.adaptive_horizon:
            k = cap
            ema = self._finish_gap_ema
            while k > 1 and 0.0 < ema < k:
                k //= 2
            rem = min(min(r.sampling.max_new_tokens - len(r.output_ids),
                          sched.max_seq_len - r.total_len) for _, r in active)
            k = max(1, min(k, rem))
        else:
            k = min(sched.decode_horizon, cap)
        while k > 1:
            need = 0
            for _, r in active:
                limit = min(r.seq_len + k, sched.max_seq_len)
                have = len(r.shared_pages) + len(r.owned_pages)
                need += max(0, math.ceil(limit / self.ps) - have)
            if need <= self.pool.free_count:
                break
            k //= 2
        return k, cap

    def _stop_id_width(self, active: list) -> int:
        """Power-of-two width (>= 1) of the device stop-id sets: EOS ids
        (unless ignore_eos) plus each request's stop_token_ids."""
        eos = len(self.config.model.eos_token_ids)
        n = max([1] + [(0 if r.sampling.ignore_eos else eos) + len(r.sampling.stop_token_ids)
                       for _, r in active])
        e = 1
        while e < n:
            e *= 2
        return e

    def _launch_frame(self, active: list) -> InFlightFrame | None:
        """Plan and dispatch one decode megastep for ``active``; returns the
        in-flight frame, or None when page pressure preempted every lane."""
        FAULTS.fire("engine.decode_step", rids=",".join(r.rid for _i, r in active))
        horizon, max_steps = self._pick_horizon(active)
        # pages for the whole horizon; may preempt (a lane already taken
        # as a peer's victim in this pass is refused)
        survivors = [(i, r) for i, r in active if self._ensure_seq_capacity(r, horizon)]
        active = [(i, r) for i, r in survivors if self.slots[i] is r]
        if not active:
            return None
        B_real = len(active)
        B = self.sched.decode_bucket(B_real)
        mp_b = self._mp_bucket(max(
            math.ceil(min(r.seq_len + horizon, self.sched.max_seq_len) / self.ps)
            for _, r in active))
        E = self._stop_id_width(active) if max_steps > 1 else 0
        use_pen = any(r.sampling.has_penalties for _, r in active)
        use_lora = any(r.lora_idx for _, r in active)
        use_mrope = any(r.mrope_delta for _, r in active)
        sig = (B, use_pen, use_lora, use_mrope, max_steps, E,
               tuple((i, r.sched_serial) for i, r in active))
        ds = self._refresh_decode_state(active, B, mp_b, sig, stop_e=E, use_pen=use_pen,
                                        use_lora=use_lora, use_mrope=use_mrope)
        tokens = np.zeros(B, np.int64)
        positions = np.full(B, mp_b * self.ps, np.int32)  # padded rows -> garbage page
        for idx, (_slot, req) in enumerate(active):
            tokens[idx] = req.output_ids[-1]
            positions[idx] = req.seq_len
        mask = self._masks([r for _, r in active], B)
        mark = self.runner.rng_mark()
        t_dispatch = time.perf_counter()
        launch = self.runner.decode_multi_async(tokens, positions, ds, horizon, mask)
        self._note_dispatch(time.perf_counter() - t_dispatch)
        return InFlightFrame(
            lanes=[(i, r, r.seq_len) for i, r in active], launch=launch,
            horizon=horizon, B=B, B_real=B_real, mp_b=mp_b, positions=positions,
            lane_sig=sig, rng_mark=mark, folds=horizon, use_pen=use_pen, use_lora=use_lora,
            use_mrope=use_mrope)

    # ---- speculative decoding (two-tier drafting + fused batched verify) ----
    #
    # Eligible lanes draft on the host — the per-request n-gram index by
    # default, the draft model when one is installed — and every lane that
    # proposed verifies in one fused block (``runner.decode_spec_async``):
    # all drafted positions scored in one forward, acceptance on the
    # device, rejected columns' KV on the garbage page.  Under the overlap
    # schedule the verify frame stays in flight across steps (launched at
    # the end of step N, consumed at the top of step N+1) and rides the
    # frame staleness and rewind machinery, so abort, deadline and
    # quarantine discard it and rewind its sampling counter.  Lanes that
    # propose nothing take the megastep at the controller's full horizon.

    def _partition_spec(self, active: list) -> tuple[list, list]:
        """Split decode lanes into (spec-eligible, rest).  Eligible means
        unconstrained, penalty-free, no logprobs, no LoRA (the verify block
        scores the base model's distributions only), no stop strings (an
        engine-layer match would roll back a block's emissions; such lanes
        stay on the K=1 megastep), with output.  A pipeline-parallel engine
        never speculates, as in the reference: every lane takes the
        megastep.  Membership is static per request."""
        if self.runner.use_pp:
            return [], active
        eligible, rest = [], []
        for slot, req in active:
            sp = req.sampling
            ok = (req.token_filter is None and not sp.has_penalties and not sp.logprobs
                  and not req.lora_idx and not sp.stop and bool(req.output_ids))
            (eligible if ok else rest).append((slot, req))
        return eligible, rest

    def _spec_tier(self) -> str:
        """The drafting tier: the draft model when installed (unless the
        configuration pins "ngram"), prompt-lookup n-grams otherwise."""
        if self.draft is not None and self.sched.speculative_tier in ("auto", "draft"):
            return "draft"
        return "ngram"

    def _pick_spec_depth(self, eligible: list) -> int:
        """This launch's draft depth: capped at ``spec_max_draft``; in
        adaptive mode one past the acceptance-length EMA (deep drafts on a
        cold context waste verify columns); halved until growing every
        eligible lane depth + 1 tokens fits the free pool (speculation never
        forces an eviction cascade)."""
        sched = self.sched
        d = max(1, sched.spec_max_draft)
        if sched.adaptive_horizon and self._spec_accept_ema > 0.0:
            d = min(d, int(self._spec_accept_ema) + 2)
        while d > 1:
            need = 0
            for _, r in eligible:
                limit = min(r.seq_len + d + 1, sched.max_seq_len)
                have = len(r.shared_pages) + len(r.owned_pages)
                need += max(0, math.ceil(limit / self.ps) - have)
            if need <= self.pool.free_count:
                break
            d //= 2
        return d

    def _collect_drafts(self, eligible: list) -> dict:
        """Per-lane proposals: {slot: (proposals, tier)}.  The draft-model
        tier ensures KV capacity before proposing (the draft writes through
        the same page table); the n-gram tier is a host lookup.  Lanes in
        acceptance back-off (``spec_cold``) or out of room propose nothing
        and take the rest megastep."""
        cfg = SpecConfig(enabled=True, max_draft=self.sched.spec_max_draft,
                         ngram_max=self.sched.spec_ngram_max,
                         ngram_min=self.sched.spec_ngram_min)
        depth = self._pick_spec_depth(eligible)
        tier = self._spec_tier()
        room = min(self.sched.max_seq_len, self.mp * self.ps)
        out: dict = {}
        for slot, req in eligible:
            if self.slots[slot] is not req:
                continue  # preempted as a peer's victim
            k = min(depth, max(0, room - req.seq_len - 1))
            if k <= 0 or req.spec_cold >= 3:
                out[slot] = ([], None)
                continue
            if tier == "draft":
                if not self._ensure_seq_capacity(req, k + 1) or self.slots[slot] is not req:
                    continue  # preempted
                pt = self.page_tables[slot]
                self.draft.ensure_context(req, pt)
                proposals = self.draft.propose(req.output_ids[-1], req.seq_len, pt, k)
            else:
                index = req.spec_index if req.spec_index is not None \
                    else self._new_spec_index(req, cfg)
                proposals = propose_ngram(req.all_token_ids, cfg, index=index)[:k]
            out[slot] = (proposals, tier if proposals else None)
        return out

    def _spec_phase(self, outputs: list[StepOutput], pipelined: bool) -> None:
        """The decode phase in speculative mode, in the same order in both
        schedules: draft (a capacity ensure may preempt), the rest lanes'
        megastep, then the verify launch — left in flight when
        ``pipelined``, consumed in-step otherwise."""
        active = self._decode_active()
        if not active:
            return
        eligible, rest = self._partition_spec(active)
        drafts = self._collect_drafts(eligible) if eligible else {}
        drafting = [(i, r) for i, r in eligible if drafts.get(i, ([], None))[0]]
        rest += [(i, r) for i, r in eligible if not drafts.get(i, ([], None))[0]]
        rest.sort(key=lambda t: t[1].sched_serial)  # rows follow admission order
        rest = [(i, r) for i, r in rest
                if self.slots[i] is r and r.status is RequestStatus.RUNNING]
        if rest:
            self._decode_batch(rest, outputs)
        drafting = [(i, r) for i, r in drafting
                    if self.slots[i] is r and r.status is RequestStatus.RUNNING
                    and not r.is_finished]
        if not drafting:
            return
        frame = self._launch_spec_frame(drafting, drafts, pipelined)
        if frame is None:
            return
        if pipelined:
            self.inflight = frame
            return
        try:
            self._step_fetch_s += self._consume_spec_frame(frame, outputs)
        except Exception:
            # left for the quarantine handler's drop_inflight, which rewinds
            # the launch's counter before any retry samples
            self.inflight = frame
            raise

    def _launch_spec_frame(self, drafting: list, drafts: dict,
                           pipelined: bool) -> InFlightFrame | None:
        """Dispatch one verify block for the lanes that proposed: pages for
        every lane's drafts and bonus first, then a re-filter (a later
        lane's ensure may preempt an earlier one)."""
        FAULTS.fire("engine.decode_step", rids=",".join(r.rid for _s, r in drafting))
        survivors = []
        for slot, req in drafting:
            props, tier = drafts.get(slot, ([], None))
            if self._ensure_seq_capacity(req, len(props) + 1):
                survivors.append((slot, req, props, tier))
        lanes = [(slot, req, props, tier) for slot, req, props, tier in survivors
                 if self.slots[slot] is req and req.status is RequestStatus.RUNNING]
        if not lanes:
            return None
        B_real = len(lanes)
        B = self.sched.decode_bucket(B_real)
        W = max(2, self.sched.spec_max_draft + 1)  # the block width
        mp_b = self._mp_bucket(max(
            math.ceil(min(r.seq_len + len(p) + 1, self.sched.max_seq_len) / self.ps)
            for _s, r, p, _t in lanes))
        tokens = np.zeros((B, W), np.int64)
        draft_n = np.zeros(B, np.int64)
        positions = np.full(B, mp_b * self.ps, np.int32)  # padded rows -> garbage page
        temps = np.zeros(B, np.float32)
        topks = np.full(B, -1, np.int64)
        topps = np.ones(B, np.float32)
        minps = np.zeros(B, np.float32)
        page_tables = np.zeros((B, mp_b), np.int32)
        use_mrope = any(r.mrope_delta for _s, r, _p, _t in lanes)
        rope_delta = np.zeros(B, np.int32) if use_mrope else None
        for idx, (slot, req, props, _tier) in enumerate(lanes):
            sp = req.sampling
            tokens[idx, 0] = req.output_ids[-1]
            tokens[idx, 1:1 + len(props)] = props
            draft_n[idx] = len(props)
            positions[idx] = req.seq_len
            temps[idx], topks[idx], topps[idx], minps[idx] = (
                sp.temperature, sp.top_k, sp.top_p, sp.min_p)
            page_tables[idx] = self.page_tables[slot][:mp_b]
            if use_mrope:
                rope_delta[idx] = req.mrope_delta
        mark = self.runner.rng_mark()
        t_dispatch = time.perf_counter()
        launch = self.runner.decode_spec_async(tokens, draft_n, positions, page_tables,
                                               temps, topks, topps, minps,
                                               rope_delta=rope_delta)
        self._note_dispatch(time.perf_counter() - t_dispatch)
        return InFlightFrame(
            lanes=[(s, r, r.seq_len) for s, r, _p, _t in lanes], launch=launch,
            horizon=W, B=B, B_real=B_real, mp_b=mp_b, positions=positions, lane_sig=(),
            rng_mark=mark, lookahead=pipelined, folds=1, spec=True,
            draft_ns=[len(p) for _s, _r, p, _t in lanes], tiers=[t for *_x, t in lanes])

    def _spec_frame_stale(self, frame: InFlightFrame) -> bool:
        """Per-lane staleness of an in-flight verify frame: a lane that
        vanished or moved (deadline, abort, quarantine, preemption)
        discards it.  Membership cannot grow between launch and consume,
        since ``_step_spec`` consumes before the step's admissions."""
        if not frame.spec:
            return True
        return any(self.slots[slot] is not req or req.status is not RequestStatus.RUNNING
                   or req.is_finished or req.seq_len != expected
                   for slot, req, expected in frame.lanes)

    def _consume_spec_frame(self, frame: InFlightFrame, outputs: list[StepOutput]) -> float:
        """The deferred fetch and per-lane acceptance of one verify block;
        returns the seconds blocked on the device.  Each lane's emitted run
        is its accepted drafts and the bonus or correction, and
        ``_accept_tokens`` cuts it at that lane's own finish: a finish in
        one lane never trims another's."""
        FAULTS.fire("engine.device_fetch", rids=",".join(r.rid for _s, r, _e in frame.lanes))
        t0 = time.perf_counter()
        toks, lps, n_emit = self.runner.spec_fetch(frame.launch)
        fetch_s = time.perf_counter() - t0
        self.fetch_wait_s_total += fetch_s
        if frame.lookahead:
            self.num_lookahead_kept += 1
        m = self.metrics
        for idx, (_slot, req, expected) in enumerate(frame.lanes):
            n = int(n_emit[idx])
            drafted = frame.draft_ns[idx]
            accepted = max(0, min(n - 1, drafted))
            if drafted:
                self.num_spec_drafted += drafted
                self.num_spec_accepted += accepted
                self._step_spec_drafted += drafted
                self._step_spec_accepted += accepted
                # rejected verify columns were computed but never emitted
                self.num_wasted_decode_tokens += drafted - accepted
                req.spec_cold = 0 if accepted else req.spec_cold + 1
                self._spec_accept_ema = (float(accepted) if self._spec_accept_ema == 0.0
                                         else 0.8 * self._spec_accept_ema + 0.2 * accepted)
                if m is not None:
                    m.observe_spec(frame.tiers[idx] or "ngram", drafted, accepted)
            before = len(req.output_ids)
            self._accept_tokens(req, [int(t) for t in toks[idx][:n]],
                                [float(x) for x in lps[idx][:n]], outputs, advance_seq=True)
            kept = len(req.output_ids) - before
            self.num_decode_tokens += kept
            # emitted past a finish inside the accepted run: computed, dropped
            self.num_wasted_decode_tokens += n - kept
            if drafted and self.draft is not None and not req.is_finished:
                # the draft was fed [y0, drafts...] from the entry: its KV
                # covers y0 and the accepted drafts, capped at the fed range
                # and the committed length (wrong coverage only costs
                # acceptance, never correctness)
                req.draft_len = min(expected + 1 + accepted, expected + drafted, req.seq_len)
        return fetch_s

    def _step_spec(self, outputs: list[StepOutput]) -> tuple[float, float, str | None]:
        """One pipelined speculative iteration; returns (admit_s, fetch_s,
        outcome).  Consume the in-flight verify frame first (admission must
        see the slots and pages its finishes freed), run the prefill phase,
        then the spec decode phase leaves the next verify block in flight.
        The counter order — prefill, rest megastep, verify launch — is the
        synchronous schedule's, so streams are byte-identical to it."""
        frame = self.inflight
        self.inflight = None
        fetch_s = 0.0
        outcome = None
        if frame is not None:
            if self._spec_frame_stale(frame):
                self._discard_frame(frame)
                outcome = "discarded" if frame.lookahead else None
            else:
                try:
                    fetch_s = self._consume_spec_frame(frame, outputs)
                except Exception:
                    # the step's handler discards it (rewinding its counter)
                    # before the blame and retry sample again
                    self.inflight = frame
                    raise
                outcome = "kept"
        ta = time.perf_counter()
        self._admit(outputs)
        admit_s = time.perf_counter() - ta
        self._spec_phase(outputs, pipelined=True)
        return admit_s, fetch_s, outcome

    def _new_spec_index(self, req: EngineRequest, cfg: SpecConfig) -> NgramIndex:
        req.spec_index = NgramIndex(cfg.ngram_min, cfg.ngram_max)
        return req.spec_index

    # ---- preemption ----

    def _ensure_seq_capacity(self, req: EngineRequest, n_tokens: int) -> bool:
        """Pages for positions seq_len .. seq_len + n_tokens - 1.  Returns
        False when the request itself had to be preempted (or already was,
        as a peer's victim in this pass)."""
        if req.slot is None or req.status is RequestStatus.PREEMPTED:
            return False
        limit = min(req.seq_len + n_tokens, self.sched.max_seq_len)
        needed = math.ceil(limit / self.ps)
        have = len(req.shared_pages) + len(req.owned_pages)
        while needed > have:
            if not self._ensure_free_pages(1):
                victim = self._pick_preemption_victim(req)
                if victim is None:
                    self._preempt(req)  # nothing else to preempt
                    return False
                self._preempt(victim)
                if not self._ensure_free_pages(1):
                    self._preempt(req)
                    return False
            page = self.pool.alloc(1)[0]
            req.owned_pages.append(page)
            self.page_tables[req.slot][have] = page
            self._pages_version += 1
            have += 1
        return True

    def _pick_preemption_victim(self, requester: EngineRequest) -> EngineRequest | None:
        """The youngest resident request other than ``requester`` (the
        latest arrival pays)."""
        candidates = [r for r in self.slots if r is not None and r is not requester]
        if not candidates:
            return None
        return max(candidates, key=lambda r: r.arrival_time)

    def _preempt(self, req: EngineRequest) -> None:
        """Take a resident request's pages back and queue it at the front.
        A mid-prefill victim banks the full pages computed so far in the
        radix cache, so readmission resumes from a prefix hit (best effort:
        the banked pages are evictable like any cached prefix)."""
        logger.warning("preempting request %s (out of KV pages)", req.rid)
        self.num_preemptions += 1
        if self.flight is not None:
            self.flight.event(req.rid, "preempt", at_tokens=req.seq_len, status=req.status.value)
        slot = req.slot
        self.slots[slot] = None
        self.page_tables[slot][:] = 0
        self._pages_version += 1
        req.slot = None
        if (req.status is RequestStatus.PREFILLING and self.radix is not None
                and req.prefill_pos >= self.ps):
            tokens = req.all_token_ids[: req.prefill_pos]
            full_pages = len(tokens) // self.ps
            all_pages = req.shared_pages + req.owned_pages
            n_shared = len(req.shared_pages)
            dupes = self.radix.insert(tokens, all_pages[:full_pages],
                                      extra_keys=self._mm_extra_keys(req, len(tokens)))
            to_free = [page for idx, page in dupes if idx >= n_shared]
            to_free.extend(all_pages[full_pages:])
            if to_free:
                self.pool.free(to_free)
        else:
            self.pool.free(req.owned_pages)
        req.owned_pages = []
        req.shared_pages = []
        if req.radix_node is not None:
            self.radix.unlock(req.radix_node)
            req.radix_node = None
        req.seq_len = req.prefill_pos = req.cached_tokens = 0
        req.penalty_synced = False  # re-derive the counts on readmission
        req.draft_len = 0  # the draft cache's rows went with the pages
        req.status = RequestStatus.PREEMPTED
        self.waiting.appendleft(req)

    # ---- finish bookkeeping ----

    def _token_finish(self, sp, tok: int, out_len: int, total_len: int) -> FinishInfo | None:
        """The token-level finish rule, mirrored on the device by the
        megastep's stop state (``_refresh_decode_state``)."""
        if not sp.ignore_eos and tok in self.config.model.eos_token_ids:
            return FinishInfo(reason="stop", matched_stop=tok)
        if tok in sp.stop_token_ids:
            return FinishInfo(reason="stop", matched_stop=tok)
        if out_len >= sp.max_new_tokens:
            return FinishInfo(reason="length")
        if total_len >= self.sched.max_seq_len:
            return FinishInfo(reason="length")
        return None

    def _host_finish_col(self, req: EngineRequest, row, horizon: int):
        """First column of ``row`` that triggers a finish, or None."""
        out_len = len(req.output_ids)
        total = req.total_len
        for j in range(horizon):
            out_len += 1
            total += 1
            if self._token_finish(req.sampling, int(row[j]), out_len, total) is not None:
                return j
        return None

    def _accept_tokens(self, req: EngineRequest, toks: list[int], lps: list[float],
                       outputs: list[StepOutput], advance_seq: bool) -> None:
        """Accept sampled tokens in order until a stop condition; overshoot
        past the stop is discarded (its KV lies past seq_len, which never
        enters the radix cache)."""
        had_output = bool(req.output_ids)
        accepted: list[int] = []
        accepted_lps: list[float] = []
        finish = None
        for tok, lp in zip(toks, lps):
            if advance_seq:
                req.seq_len += 1
            req.output_ids.append(tok)
            req.logprobs.append(lp)
            accepted.append(tok)
            accepted_lps.append(lp)
            finish = self._token_finish(req.sampling, tok, len(req.output_ids), req.total_len)
            if finish is not None:
                break
        if accepted:
            # before _release, so the tokens precede the finish event
            if self.flight is not None:
                self.flight.on_tokens(req.rid, len(accepted), first=not had_output)
        if finish is not None:
            self._release(req, finish)
        outputs.append(StepOutput(req, accepted, finish is not None, finish,
                                  logprobs=accepted_lps))

    # ---- PD disaggregation ----

    def prefill_only(self, prompt_ids: list[int], sampling,
                     token_filter=None) -> tuple[int, list[int], int]:
        """The prefill leg: prefill a prompt into freshly allocated pages
        outside any decode slot and return (first_token, pages, seq_len);
        the caller exports the pages and must ``release_pages`` them.  The
        radix cache is neither read nor written.  Penalties and the grammar
        mask apply to the first token as in the co-located prefill.  Every
        chunk samples, as the reference's does, so the sampling counter
        advances once a chunk; a frame in flight then keeps its counters
        (``_discard_frame`` rewinds only while they are the newest)."""
        n_pages = math.ceil(len(prompt_ids) / self.ps)
        if not self._ensure_free_pages(n_pages):
            raise RuntimeError("out of KV pages for prefill-only request")
        pages = self.pool.alloc(n_pages)
        row = np.zeros(self.mp, np.int32)
        row[: len(pages)] = pages
        pen = None
        if sampling.has_penalties:
            counts, pmask = self.runner.penalty_state(prompt_ids, [])
            pen = (counts, pmask, sampling.frequency_penalty, sampling.presence_penalty,
                   sampling.repetition_penalty)
        mask = None
        if token_filter is not None:
            mask = token_filter.allowed_mask("")
            if not mask.any():
                mask = mask.copy()
                mask[list(self.config.model.eos_token_ids)] = True
        start, tok = 0, None
        try:
            while start < len(prompt_ids):
                chunk = prompt_ids[start : start + self.sched.max_prefill_tokens]
                tok, _ = self.runner.prefill(
                    chunk, prefix_len=start, page_table=row,
                    temperature=sampling.temperature, top_k=sampling.top_k,
                    top_p=sampling.top_p, min_p=sampling.min_p, pen=pen, mask=mask)
                self.num_prefill_tokens += len(chunk)
                start += len(chunk)
        except BaseException:
            self.pool.free(pages)
            raise
        return tok, pages, len(prompt_ids)

    def release_pages(self, pages: list[int]) -> None:
        self.pool.free(pages)

    def alloc_import_pages(self, n_tokens: int) -> list[int]:
        """Pages for an imported prompt of ``n_tokens``."""
        n_pages = math.ceil(n_tokens / self.ps)
        if not self._ensure_free_pages(n_pages):
            raise RuntimeError("out of KV pages for import")
        return self.pool.alloc(n_pages)

    def adopt_prefilled(self, req: EngineRequest, pages: list[int], first_token: int) -> bool:
        """The decode leg: adopt a request whose prompt KV was imported into
        ``pages``, which it then owns.  False when no slot is free.  The
        page-table upload keys off ``_pages_version``; the lane's penalty
        row is filled by the lazy sync before its first launch
        (``penalty_synced`` stays false).  The caller accepts
        ``first_token``."""
        free_slots = [i for i, s in enumerate(self.slots) if s is None]
        if not free_slots:
            return False
        if req.rid in self.requests:
            raise ValueError(f"duplicate request id {req.rid}")
        self._serial += 1
        req.sched_serial = self._serial  # lane signatures key off it
        self.requests[req.rid] = req
        req.owned_pages = list(pages)
        req.seq_len = req.prefill_pos = req.prompt_len  # prompt KV imported
        req.status = RequestStatus.RUNNING
        slot = free_slots[0]
        req.slot = slot
        row = self.page_tables[slot]
        row[:] = 0
        row[: len(pages)] = pages
        self.slots[slot] = req
        self._pages_version += 1
        if self.flight is not None:
            # queued and admitted collapse into one adoption instant: the
            # prompt ran on the other leg's worker
            self.flight.on_queued(req.rid, prompt_tokens=req.prompt_len,
                                  trace_id=req.trace_id, meta=self._flight_meta(req))
            self.flight.event(req.rid, "adopted", slot=slot)
        del first_token
        return True

    def finish_request(self, rid: str, reason: str, matched_stop=None) -> None:
        """A finish found outside the scheduler (the engine matched a stop
        string).  A frame in flight that holds the lane goes stale and is
        discarded at the next step."""
        req = self.requests.get(rid)
        if req is None or req.is_finished or req.slot is None:
            return
        self._release(req, FinishInfo(reason=reason, matched_stop=matched_stop))

    def _finish_unadmitted(self, req: EngineRequest, finish: FinishInfo,
                           outputs: list[StepOutput]) -> None:
        req.status = RequestStatus.FINISHED
        req.finish = finish
        self._count_finish(req, finish.reason, finish.message)
        self.requests.pop(req.rid, None)
        outputs.append(StepOutput(req, [], True, finish))

    def _count_finish(self, req: EngineRequest, reason: str,
                      message: str | None = None) -> None:
        if self.metrics is not None:
            self.metrics.on_finish(reason)
        # the terminal event moves the timeline to the finished ring
        if self.flight is not None:
            self.flight.on_finish(req.rid, reason, message)

    def _release(self, req: EngineRequest, finish: FinishInfo, aborted: bool = False) -> None:
        req.finish = finish
        req.status = RequestStatus.ABORTED if aborted else RequestStatus.FINISHED
        self._count_finish(req, finish.reason, finish.message)
        if req.slot is not None:
            self.page_tables[req.slot][:] = 0
            self._pages_version += 1
            self.slots[req.slot] = None
            req.slot = None
        # only tokens whose KV is written may enter the radix cache: the last
        # sampled token is never fed back, so its position has no KV
        tokens = req.all_token_ids[: req.seq_len]
        full_pages = len(tokens) // self.ps
        n_shared = len(req.shared_pages)
        all_pages = req.shared_pages + req.owned_pages
        to_free: list[int] = []
        if self.radix is not None and finish.reason != "error":
            # image pages insert with their content salts
            dupes = self.radix.insert(tokens, all_pages[:full_pages],
                                      extra_keys=self._mm_extra_keys(req, len(tokens)))
            to_free.extend(page for idx, page in dupes if idx >= n_shared)
            to_free.extend(all_pages[full_pages:])  # partial tail pages
        else:
            to_free.extend(req.owned_pages)
        if to_free:
            self.pool.free(to_free)
        req.owned_pages = []
        req.shared_pages = []
        if req.radix_node is not None:
            self.radix.unlock(req.radix_node)  # the root when nothing matched
            req.radix_node = None
        self.requests.pop(req.rid, None)
