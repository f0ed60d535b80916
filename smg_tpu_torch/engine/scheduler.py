"""Continuous-batching scheduler — a reduced port of
``smg_tpu/engine/scheduler.py`` that keeps the reference's host logic for
what it ports:

- the waiting queue, decode slots and page accounting;
- radix prefix match at admission and insert at finish;
- stall-free chunked prefill under a per-step token budget: resumable
  ``PREFILLING`` requests advance first, then waiting prompts are admitted,
  whole short prompts as one grouped prefill, a prompt over the leftover
  budget as its first resumable chunk (``_admit_budgeted``);
- the decode megastep with the host trim at the earliest finish column;
- EOS, stop-id and ``max_new_tokens`` finishes, and page release.

Not ported yet: the overlap pipeline, speculation, preemption, deadlines,
abort, penalties, grammar masks, LoRA and multimodal.  Where the reference
would preempt or wait on pages that no running request can free, this
scheduler raises ``OutOfPagesError`` instead of stalling.
"""

from __future__ import annotations

import math
from collections import deque

import numpy as np

from smg_tpu_torch.engine.config import EngineConfig
from smg_tpu_torch.engine.kv_cache import OutOfPagesError, PagePool
from smg_tpu_torch.engine.radix_cache import RadixCache
from smg_tpu_torch.engine.request import (
    EngineRequest,
    FinishInfo,
    RequestStatus,
    StepOutput,
)
from smg_tpu_torch.engine.runner import ModelRunner


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
        self.requests: dict[str, EngineRequest] = {}
        self._serial = 0
        self.num_decode_tokens = 0  # accepted decode tokens

    # ---- public API ----

    def add_request(self, req: EngineRequest) -> None:
        if req.rid in self.requests:
            raise ValueError(f"duplicate request id {req.rid}")
        req.sampling.validate()
        self._serial += 1
        req.sched_serial = self._serial
        self.requests[req.rid] = req
        self.waiting.append(req)

    def has_work(self) -> bool:
        return bool(self.waiting) or any(s is not None for s in self.slots)

    def step(self) -> list[StepOutput]:
        """One iteration: the prefill phase under the token budget, then one
        decode megastep for every running lane."""
        outputs: list[StepOutput] = []
        self._admit_budgeted(outputs)
        self._decode(outputs)
        return outputs

    # ---- prefill phase ----

    def _admit_budgeted(self, outputs: list[StepOutput]) -> None:
        """Spend at most one ``max_prefill_tokens`` budget: resume
        ``PREFILLING`` slot-holders (oldest first), then admit waiting prompts
        into the leftover.  Non-final chunks write KV only; a final chunk
        samples the first token and promotes the request to a decode lane."""
        sched = self.sched
        budget = sched.max_prefill_tokens
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
            else:
                if budget < min(self.ps, sched.max_prefill_tokens):
                    break  # sub-page leftover: not worth a dispatch
                self._prefill_chunk(req, budget)
                budget = 0
        group: list[EngineRequest] = []
        while budget > 0 and self.waiting:
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
                    group = []
            else:
                self._prefill_chunk(req, budget)  # first resumable chunk
                budget = 0
        if group:
            self._prefill_group(group, outputs)

    def _try_admit_head(self, outputs: list[StepOutput], budget_left: int):
        """Admit the head of the waiting queue into a free slot: radix-match
        its prefix, allocate pages for the whole prompt, park it
        ``PREFILLING`` at the matched prefix.  Returns the request, None when
        blocked, or ``"consumed"`` when the head finished without admission."""
        free_slots = [i for i, s in enumerate(self.slots) if s is None]
        if not free_slots:
            return None
        req = self.waiting[0]
        prompt = req.all_token_ids
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
            if not any(s is not None for s in self.slots):
                raise OutOfPagesError(
                    f"request {req.rid} needs {need} pages (+{self.sched.watermark_pages} "
                    f"watermark), {self.pool.free_count} free and nothing running "
                    "will release any")
            return None  # running requests will release pages
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
        self.slots[slot] = req
        return req

    def _prefill_chunk(self, req: EngineRequest, take: int) -> None:
        """Advance a resumable prefill by one NON-final chunk (KV only)."""
        start = req.prefill_pos
        chunk = req.all_token_ids[start : start + take]
        self.runner.prefill_extend(chunk, prefix_len=start,
                                   page_table=self.page_tables[req.slot])
        req.prefill_pos += len(chunk)
        req.seq_len = req.prefill_pos

    def _prefill_final(self, req: EngineRequest, outputs: list[StepOutput]) -> None:
        """Final chunk of a resumable prefill: sample the first token and
        promote the request to a decode lane."""
        prompt = req.all_token_ids
        start = req.prefill_pos
        sp = req.sampling
        tok, lp = self.runner.prefill(
            prompt[start:], prefix_len=start, page_table=self.page_tables[req.slot],
            temperature=sp.temperature, top_k=sp.top_k, top_p=sp.top_p, min_p=sp.min_p)
        req.prefill_pos = req.seq_len = len(prompt)
        req.status = RequestStatus.RUNNING
        self._accept_tokens(req, [tok], [lp], outputs, advance_seq=False)

    def _prefill_group(self, group: list[EngineRequest], outputs: list[StepOutput]) -> None:
        """One batched prefill for a group of single-chunk prompts."""
        chunks = [(r.all_token_ids[r.cached_tokens:], r.cached_tokens,
                   self.page_tables[r.slot]) for r in group]
        sps = [r.sampling for r in group]
        toks, lps = self.runner.prefill_batched(
            chunks, [s.temperature for s in sps], [s.top_k for s in sps],
            [s.top_p for s in sps], [s.min_p for s in sps])
        for i, req in enumerate(group):
            req.seq_len = req.prefill_pos = req.total_len
            req.status = RequestStatus.RUNNING
            self._accept_tokens(req, [int(toks[i])], [float(lps[i])], outputs,
                                advance_seq=False)

    def _ensure_free_pages(self, n: int) -> bool:
        if self.pool.free_count >= n:
            return True
        freed = self.radix.evict(n - self.pool.free_count)
        if freed:
            self.pool.free(freed)
        return self.pool.free_count >= n

    # ---- decode phase ----

    def _decode_active(self) -> list:
        """Running lanes in admission order (the row order of the batch)."""
        act = [(i, r) for i, r in enumerate(self.slots)
               if r is not None and r.status is RequestStatus.RUNNING]
        act.sort(key=lambda t: t[1].sched_serial)
        return act

    def _pick_horizon(self, active: list) -> int:
        """Decode columns for this launch.  Pending admission work (waiting
        queue, a resumable prefill) forces 1: the single-step schedule could
        admit between any two columns, and a horizon spanning that point
        would change the batch a column sees.  Otherwise ``decode_horizon``,
        halved until growing every lane fits the free pages."""
        sched = self.sched
        if sched.decode_horizon <= 1 or self.waiting or any(
                r is not None and r.status is RequestStatus.PREFILLING for r in self.slots):
            return 1
        k = sched.decode_horizon
        while k > 1:
            need = 0
            for _, r in active:
                limit = min(r.seq_len + k, sched.max_seq_len)
                have = len(r.shared_pages) + len(r.owned_pages)
                need += max(0, math.ceil(limit / self.ps) - have)
            if need <= self.pool.free_count:
                break
            k //= 2
        return k

    def _ensure_seq_capacity(self, req: EngineRequest, n_tokens: int) -> None:
        """Pages for positions seq_len .. seq_len + n_tokens - 1."""
        limit = min(req.seq_len + n_tokens, self.sched.max_seq_len)
        needed = math.ceil(limit / self.ps)
        have = len(req.shared_pages) + len(req.owned_pages)
        while needed > have:
            if not self._ensure_free_pages(1):
                raise OutOfPagesError(
                    f"no free KV page for request {req.rid} at {req.seq_len} tokens "
                    "(preemption is not ported yet)")
            page = self.pool.alloc(1)[0]
            req.owned_pages.append(page)
            self.page_tables[req.slot][have] = page
            have += 1

    def _stop_state(self, active: list) -> tuple:
        """Device stop state: per-lane stop ids (EOS unless ignore_eos, plus
        stop_token_ids; -1 padded) and absolute total-length limits."""
        eos = tuple(self.config.model.eos_token_ids)
        ids_per = []
        for _, r in active:
            ids = list(r.sampling.stop_token_ids)
            if not r.sampling.ignore_eos:
                ids.extend(eos)
            ids_per.append(ids)
        E = max(1, max(len(ids) for ids in ids_per))
        stop_ids = np.full((len(active), E), -1, np.int32)
        limits = np.zeros(len(active), np.int32)
        for idx, (_, r) in enumerate(active):
            stop_ids[idx, : len(ids_per[idx])] = ids_per[idx]
            limits[idx] = min(r.prompt_len + r.sampling.max_new_tokens,
                              self.sched.max_seq_len)
        return stop_ids, limits, np.ones(len(active), bool)

    def _decode(self, outputs: list[StepOutput]) -> None:
        active = self._decode_active()
        if not active:
            return
        horizon = self._pick_horizon(active)
        for _, req in active:
            self._ensure_seq_capacity(req, horizon)
        B = len(active)
        mp_b = max(math.ceil(min(r.seq_len + horizon, self.sched.max_seq_len) / self.ps)
                   for _, r in active)
        tokens = np.array([r.output_ids[-1] for _, r in active], np.int32)
        positions = np.array([r.seq_len for _, r in active], np.int32)
        page_tables = np.stack([self.page_tables[i][:mp_b] for i, _ in active])
        sps = [r.sampling for _, r in active]
        toks, lps = self.runner.decode_multi(
            tokens, positions, page_tables,
            [s.temperature for s in sps], [s.top_k for s in sps],
            [s.top_p for s in sps], [s.min_p for s in sps],
            num_steps=horizon,
            stop_state=self._stop_state(active) if horizon > 1 else None,
        )
        # host trim: acceptance stops at the earliest finish column across
        # the batch (what the single-step schedule would have accepted)
        used = toks.shape[1]
        for idx, (_, req) in enumerate(active):
            col = self._host_finish_col(req, toks[idx], used)
            if col is not None and col + 1 < used:
                used = col + 1
        self.num_decode_tokens += B * used
        for idx, (_, req) in enumerate(active):
            self._accept_tokens(req, [int(t) for t in toks[idx][:used]],
                                [float(x) for x in lps[idx][:used]], outputs,
                                advance_seq=True)

    # ---- finish bookkeeping ----

    def _token_finish(self, sp, tok: int, out_len: int, total_len: int) -> FinishInfo | None:
        """The token-level finish rule, mirrored on the device by the
        megastep's stop state (``_stop_state``)."""
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
        """Accept sampled tokens in order until a stop condition."""
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

    def _finish_unadmitted(self, req: EngineRequest, finish: FinishInfo,
                           outputs: list[StepOutput]) -> None:
        req.status = RequestStatus.FINISHED
        req.finish = finish
        self.requests.pop(req.rid, None)
        outputs.append(StepOutput(req, [], True, finish))

    def _release(self, req: EngineRequest, finish: FinishInfo) -> None:
        req.finish = finish
        req.status = RequestStatus.FINISHED
        if req.slot is not None:
            self.page_tables[req.slot][:] = 0
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
