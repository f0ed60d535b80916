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
  lanes at K=1 (the engine finds the match and calls ``finish_request``).

Not ported yet: speculation, LoRA, multimodal, the flight recorder,
metrics and failure isolation (quarantine of a failing request).  A
request that cannot be admitted even with nothing else running (its prompt
needs more pages than the pool can free) finishes with reason ``error``
naming ``OutOfPagesError``.
"""

from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass

import numpy as np

from smg_tpu_torch.engine.config import EngineConfig
from smg_tpu_torch.engine.kv_cache import OutOfPagesError, PagePool
from smg_tpu_torch.engine.radix_cache import RadixCache
from smg_tpu_torch.engine.request import (
    EngineRequest,
    FinishInfo,
    QueueFullError,
    RequestStatus,
    StepOutput,
)
from smg_tpu_torch.engine.runner import DecodeLaunch, DecodeState, ModelRunner


@dataclass
class InFlightFrame:
    """One dispatched decode horizon whose results are not yet consumed.

    ``lanes`` pins each batch row to (slot, request, expected_seq_len): a
    lane whose request no longer matches when the frame is consumed went
    stale in flight (abort, deadline), and the frame is dropped — its KV
    landed past each request's final ``seq_len``, which never enters the
    radix cache.  ``rng_mark`` is the sampling counter before the launch,
    which consumed ``folds`` (= horizon) counters."""

    lanes: list  # [(slot, EngineRequest, expected_seq_len)]
    launch: DecodeLaunch
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


class Scheduler:
    def __init__(self, runner: ModelRunner, config: EngineConfig):
        self.runner = runner
        self.config = config
        self.sched = config.scheduler
        self.ps = runner.spec.page_size
        self.mp = runner.max_pages_per_seq
        self.pool = PagePool(runner.spec.num_pages)
        self.radix = RadixCache(self.ps)
        self.waiting: deque[EngineRequest] = deque()
        self.slots: list[EngineRequest | None] = [None] * self.sched.max_batch_size
        self.page_tables = np.zeros((self.sched.max_batch_size, self.mp), np.int32)
        self._pages_version = 0  # bumped on every page-table row change
        self.requests: dict[str, EngineRequest] = {}
        self._serial = 0
        self.inflight: InFlightFrame | None = None
        self._dstate = DecodeState()
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
        # adaptive horizon: EMA of decode columns between finishes
        self._finish_gap_ema = 0.0
        self._cols_since_finish = 0

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
            self.requests.pop(rid, None)
            return True
        self._release(req, FinishInfo(reason="abort"), aborted=True)
        return True

    def has_work(self) -> bool:
        return (bool(self.waiting) or any(s is not None for s in self.slots)
                or self.inflight is not None)

    def loads(self) -> dict:
        live = [s for s in self.slots if s is not None]
        return {
            "num_waiting": len(self.waiting),
            "num_running": len(live),
            "num_prefilling": sum(s.status is RequestStatus.PREFILLING for s in live),
            "free_pages": self.pool.free_count,
            "cached_pages": self.radix.num_cached_pages,
            "total_pages": self.runner.spec.num_pages,
            "prefill_tokens": self.num_prefill_tokens,
            "decode_tokens": self.num_decode_tokens,
            "preemptions": self.num_preemptions,
            "radix_evicted_pages": self.radix.evicted_pages,
            "lookahead_kept": self.num_lookahead_kept,
            "lookahead_discarded": self.num_lookahead_discarded,
            "wasted_decode_tokens": self.num_wasted_decode_tokens,
            "megastep_early_exits": self.num_megastep_early_exits,
            "queue_rejections": self.num_queue_rejections,
            "deadline_expirations_waiting": self.num_deadline_waiting,
            "deadline_expirations_running": self.num_deadline_running,
            "draining": self.draining,
            **self.runner.graphs.stats(),
        }

    def audit(self) -> dict:
        """Zero-leak audit: every allocatable page is free, radix-cached or
        owned by a resident request (``leaked_pages == 0`` always), and at
        quiescence no radix node is pinned."""
        live = [r for r in self.slots if r is not None]
        held = sum(len(r.owned_pages) for r in live)
        cached = self.radix.num_cached_pages
        free = self.pool.free_count
        locks = self.radix.lock_stats()
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
        self.pool.free(self.radix.clear())
        self.runner.flush_cache_buffers()
        return True

    def step(self) -> list[StepOutput]:
        """One iteration: deadline sweep, the prefill phase under the token
        budget, and decode — pipelined (the next megastep launched before
        this one's tokens are fetched) or synchronous."""
        outputs: list[StepOutput] = []
        self._expire_deadlines(outputs)
        if self.sched.overlap_schedule:
            self._step_overlap(outputs)
        else:
            self.drop_inflight()  # mode flip mid-run: never strand a frame
            self._admit_budgeted(outputs)
            self._decode(outputs)
        return outputs

    # ---- deadlines and drain ----

    def _expire_deadlines(self, outputs: list[StepOutput]) -> None:
        """Finish requests past their deadline with reason ``timeout``:
        queued ones leave the queue, resident ones are released like an
        abort (an in-flight frame holding them goes stale and is
        discarded)."""
        now = time.monotonic()
        for req in [r for r in self.waiting if r.deadline is not None and now > r.deadline]:
            self.waiting.remove(req)
            req.status = RequestStatus.FINISHED
            req.finish = FinishInfo(reason="timeout")
            self.requests.pop(req.rid, None)
            self.num_deadline_waiting += 1
            outputs.append(StepOutput(req, [], True, req.finish))
        for req in list(self.slots):
            if req is not None and req.deadline is not None and now > req.deadline:
                self._release(req, FinishInfo(reason="timeout"))
                self.num_deadline_running += 1
                outputs.append(StepOutput(req, [], True, req.finish))

    def drain_waiting(self, outputs: list[StepOutput]) -> None:
        """End every queued request with a terminal ``abort`` (drain mode
        finishes admitted work and refuses the rest)."""
        while self.waiting:
            req = self.waiting.popleft()
            req.status = RequestStatus.ABORTED
            req.finish = FinishInfo(reason="abort", message="engine draining")
            self.requests.pop(req.rid, None)
            outputs.append(StepOutput(req, [], True, req.finish))

    # ---- overlapped pipeline ----
    #
    # Invariant: token streams are byte-identical to the synchronous path,
    # so the sequence of device calls (with their sampling counters and
    # batch compositions) must be exactly the one the synchronous scheduler
    # issues; a lookahead launch that turns out not to match it is
    # discarded and the counter rewound before relaunching.

    def _step_overlap(self, outputs: list[StepOutput]) -> None:
        frame = self.inflight
        self.inflight = None
        if frame is not None and self._frame_stale(frame):
            # the schedule changed while the frame was in flight (abort,
            # deadline): its tokens never existed in the sync schedule.
            # Discard before the prefill phase, while its counters are the
            # newest.
            self._discard_frame(frame)
            frame = None
        look = None
        if frame is not None:
            # the lookahead IS this step's decode launch, dispatched before
            # the frame's results are fetched; the sync step samples prefill
            # before decode, so it is only legal when this step's prefill
            # phase provably samples nothing
            if self._prefill_phase_fold_free():
                look = self._launch_lookahead(frame)
            used = self._consume_frame(frame, outputs)
            if used < frame.horizon:
                # a finish trimmed the frame: the lane set changes there, so
                # the lookahead no longer matches, and the frame's unused
                # counters rewind before the prefill phase can sample
                if look is not None:
                    self._discard_frame(look)
                    look = None
                self._rewind_unused_folds(frame, used)
        # admission after the consume sees every slot and page the frame's
        # finishes freed, as the sync schedule's admission would
        disturbed = self._admit_budgeted(outputs)
        if look is not None:
            if disturbed or self._frame_stale(look):
                self._discard_frame(look)
            else:
                self.inflight = look
        if self.inflight is None:
            active = self._decode_active()
            if active:
                self.inflight = self._launch_frame(active)

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
        synchronously), never True wrongly."""
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
        was released or the decode lane set changed."""
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

    def _consume_frame(self, frame: InFlightFrame, outputs: list[StepOutput]) -> int:
        """The deferred fetch and host-side acceptance; returns the columns
        accepted.  Acceptance stops at the earliest finish column across the
        batch: later columns belong to a batch the single-step schedule
        would have recomposed."""
        toks, lps, sr = self.runner.decode_fetch(frame.launch)
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
        return used

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
                                        use_pen=frame.use_pen)
        mark = self.runner.rng_mark()
        launch = self.runner.decode_multi_async(frame.launch.last_col, positions, ds, H2)
        return InFlightFrame(
            lanes=[(s, r, e + H) for s, r, e in frame.lanes], launch=launch,
            horizon=H2, B=frame.B, B_real=frame.B_real, mp_b=mp_b,
            positions=positions, lane_sig=frame.lane_sig, rng_mark=mark,
            lookahead=True, folds=H2, use_pen=frame.use_pen)

    # ---- prefill phase ----

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
                self._prefill_final(req, outputs)
                disturbed = True
            else:
                if budget < min(self.ps, sched.max_prefill_tokens):
                    break  # sub-page leftover: not worth a dispatch
                self._prefill_chunk(req, budget)
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
                    self._prefill_group(group, outputs)
                    disturbed = True
                    group = []
            else:
                self._prefill_chunk(req, budget)  # first resumable chunk
                budget = 0
        if group:
            self._prefill_group(group, outputs)
            disturbed = True
        return disturbed

    def _try_admit_head(self, outputs: list[StepOutput], budget_left: int):
        """Admit the head of the waiting queue into a free slot: radix-match
        its prefix, allocate pages for the whole prompt, park it
        ``PREFILLING`` at the matched prefix.  Returns the request, None when
        blocked, or ``"consumed"`` when the head finished without admission."""
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
        # never match the full prompt: one token must run to give logits
        shared_pages, node = self.radix.match_prefix(prompt[:-1])
        matched = len(shared_pages) * self.ps
        remaining = len(prompt) - matched
        if (remaining > budget_left
                and budget_left < min(self.ps, self.sched.max_prefill_tokens)):
            return None  # sliver: wait for next step's full budget
        need = math.ceil(len(prompt) / self.ps) - len(shared_pages)
        # pin the matched chain before the free-page check may evict
        self.radix.lock(node)
        if not self._ensure_free_pages(need + self.sched.watermark_pages):
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
        return req

    def _prefill_chunk(self, req: EngineRequest, take: int) -> None:
        """Advance a resumable prefill by one NON-final chunk (KV only,
        nothing sampled: a lookahead frame stays in flight across it)."""
        start = req.prefill_pos
        chunk = req.all_token_ids[start : start + take]
        self.runner.prefill_extend(chunk, prefix_len=start,
                                   page_table=self.page_tables[req.slot])
        self.num_prefill_tokens += len(chunk)
        req.prefill_pos += len(chunk)
        req.seq_len = req.prefill_pos

    def _prefill_final(self, req: EngineRequest, outputs: list[StepOutput]) -> None:
        """Final chunk of a resumable prefill: sample the first token and
        promote the request to a decode lane."""
        prompt = req.all_token_ids
        start = req.prefill_pos
        sp = req.sampling
        pen = None
        if sp.has_penalties:
            counts, pmask = self._req_pen_state(req)
            pen = (counts, pmask, sp.frequency_penalty, sp.presence_penalty,
                   sp.repetition_penalty)
        mask = self._mask_for(req) if req.token_filter is not None else None
        tok, lp = self.runner.prefill(
            prompt[start:], prefix_len=start, page_table=self.page_tables[req.slot],
            temperature=sp.temperature, top_k=sp.top_k, top_p=sp.top_p, min_p=sp.min_p,
            pen=pen, mask=mask)
        self.num_prefill_tokens += len(prompt) - start
        req.prefill_pos = req.seq_len = len(prompt)
        req.status = RequestStatus.RUNNING
        self._accept_tokens(req, [tok], [lp], outputs, advance_seq=False)

    def _prefill_group(self, group: list[EngineRequest], outputs: list[StepOutput]) -> None:
        """One batched prefill for a group of single-chunk prompts."""
        chunks = [(r.all_token_ids[r.cached_tokens:], r.cached_tokens,
                   self.page_tables[r.slot]) for r in group]
        sps = [r.sampling for r in group]
        pen = None
        if any(s.has_penalties for s in sps):
            counts, pmask = (np.stack(x) for x in zip(*map(self._req_pen_state, group)))
            pen = (counts, pmask, *self._pen_scalars(group, len(group)))
        toks, lps = self.runner.prefill_batched(
            chunks, [s.temperature for s in sps], [s.top_k for s in sps],
            [s.top_p for s in sps], [s.min_p for s in sps], pen=pen,
            mask=self._masks(group, len(group)))
        for i, req in enumerate(group):
            self.num_prefill_tokens += len(chunks[i][0])
            req.seq_len = req.prefill_pos = req.total_len
            req.status = RequestStatus.RUNNING
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
        if self.pool.free_count >= n:
            return True
        freed = self.radix.evict(n - self.pool.free_count)
        if freed:
            self.pool.free(freed)
        return self.pool.free_count >= n

    # ---- decode ----

    def _decode(self, outputs: list[StepOutput]) -> None:
        """Synchronous decode: launch one megastep and consume it in-step
        (the pipeline calls the same halves with a frame between)."""
        active = self._decode_active()
        if not active:
            return
        frame = self._launch_frame(active)
        if frame is not None:
            used = self._consume_frame(frame, outputs)
            if used < frame.horizon:
                self._rewind_unused_folds(frame, used)

    def _refresh_decode_state(self, active: list, B: int, mp_b: int, sig: tuple,
                              stop_e: int = 0, use_pen: bool = False) -> DecodeState:
        """Bring the decode inputs up to date: sampling parameters, penalty
        rows and stop state (``stop_e`` > 0: per-lane stop ids, absolute
        length limits, live-lane mask) only on a new composition ``sig``;
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
        sig = (B, use_pen, max_steps, E, tuple((i, r.sched_serial) for i, r in active))
        ds = self._refresh_decode_state(active, B, mp_b, sig, stop_e=E, use_pen=use_pen)
        tokens = np.zeros(B, np.int64)
        positions = np.full(B, mp_b * self.ps, np.int32)  # padded rows -> garbage page
        for idx, (_slot, req) in enumerate(active):
            tokens[idx] = req.output_ids[-1]
            positions[idx] = req.seq_len
        mask = self._masks([r for _, r in active], B)
        mark = self.runner.rng_mark()
        launch = self.runner.decode_multi_async(tokens, positions, ds, horizon, mask)
        return InFlightFrame(
            lanes=[(i, r, r.seq_len) for i, r in active], launch=launch,
            horizon=horizon, B=B, B_real=B_real, mp_b=mp_b, positions=positions,
            lane_sig=sig, rng_mark=mark, folds=horizon, use_pen=use_pen)

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
        self.num_preemptions += 1
        slot = req.slot
        self.slots[slot] = None
        self.page_tables[slot][:] = 0
        self._pages_version += 1
        req.slot = None
        if req.status is RequestStatus.PREFILLING and req.prefill_pos >= self.ps:
            tokens = req.all_token_ids[: req.prefill_pos]
            full_pages = len(tokens) // self.ps
            all_pages = req.shared_pages + req.owned_pages
            n_shared = len(req.shared_pages)
            dupes = self.radix.insert(tokens, all_pages[:full_pages])
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
        if finish is not None:
            self._release(req, finish)
        outputs.append(StepOutput(req, accepted, finish is not None, finish,
                                  logprobs=accepted_lps))

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
        self.requests.pop(req.rid, None)
        outputs.append(StepOutput(req, [], True, finish))

    def _release(self, req: EngineRequest, finish: FinishInfo, aborted: bool = False) -> None:
        req.finish = finish
        req.status = RequestStatus.ABORTED if aborted else RequestStatus.FINISHED
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
        if finish.reason != "error":
            dupes = self.radix.insert(tokens, all_pages[:full_pages])
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
