"""Priority scheduler: admission control with per-class queues.

Reference: ``model_gateway/src/middleware/scheduler/`` (4,291 LoC) — SlotPool
+ per-class FIFO queues with classes system/interactive/default/bulk and a
preemption budget (SURVEY.md §2.1).  Async variant: a fixed slot pool; a
request waits in its class queue until a slot frees; higher classes always
drain first; per-class max queue wait produces 503s instead of unbounded
queues.

The port's copy of ``smg_tpu/gateway/priority.py``, unchanged but for its imports.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field

CLASS_ORDER = ("system", "interactive", "default", "bulk")


@dataclass
class PriorityConfig:
    slots: int = 256
    classes: tuple[str, ...] = CLASS_ORDER
    max_queue: dict = field(default_factory=lambda: {"bulk": 4096, "default": 2048,
                                                     "interactive": 1024, "system": 256})
    max_wait_secs: dict = field(default_factory=lambda: {"bulk": 120.0, "default": 30.0,
                                                         "interactive": 10.0, "system": 5.0})
    # Preemption (reference: middleware/scheduler/engine.rs 50ms-budget
    # preemption): requests of `preempt_for` classes that stay queued past
    # `preempt_after_secs` cancel+requeue one in-flight `preemptable` request.
    preempt_for: tuple[str, ...] = ("system",)
    preemptable: tuple[str, ...] = ("bulk",)
    preempt_after_secs: float = 0.05


class AdmissionRejected(Exception):
    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


class SlotGuard:
    def __init__(self, scheduler: "PriorityScheduler", priority: str = "default"):
        self._sched = scheduler
        self._released = False
        self.priority = priority
        self.preempted = False
        self._preempt_cb = None

    def set_preempt_callback(self, cb) -> None:
        """Opt this in-flight request into preemption: ``cb()`` must cancel
        the request's work, which in turn releases this guard."""
        self._preempt_cb = cb
        self._sched._register_preemptable(self)

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._sched._unregister_preemptable(self)
            self._sched._release()

    async def __aenter__(self):
        return self

    async def __aexit__(self, *exc):
        self.release()


class PriorityScheduler:
    def __init__(self, config: PriorityConfig | None = None):
        self.config = config or PriorityConfig()
        self._free = self.config.slots
        self._waiters: dict[str, asyncio.Queue] = {}
        self._queues: dict[str, list] = {c: [] for c in self.config.classes}
        self._lock = asyncio.Lock()
        self._preemptable: dict[str, list[SlotGuard]] = {
            c: [] for c in self.config.classes
        }
        self.stats = {
            c: {"admitted": 0, "rejected": 0, "preempted": 0}
            for c in self.config.classes
        }

    def classify(self, headers) -> str:
        c = (headers.get("X-SMG-Priority") or headers.get("Priority") or "default").lower()
        return c if c in self.config.classes else "default"

    async def admit(self, priority: str = "default", count_stats: bool = True) -> SlotGuard:
        """Waits for a slot; raises AdmissionRejected on queue overflow or
        wait timeout.  Waiters of ``preempt_for`` classes that exceed the
        preemption budget cancel one in-flight ``preemptable`` request.
        ``count_stats=False`` (preemption requeues) keeps one logical request
        from inflating the admitted counter."""
        async with self._lock:
            if self._free > 0 and not any(self._queues[c] for c in self.config.classes):
                self._free -= 1
                if count_stats:
                    self.stats[priority]["admitted"] += 1
                return SlotGuard(self, priority)
            if len(self._queues[priority]) >= self.config.max_queue.get(priority, 1024):
                self.stats[priority]["rejected"] += 1
                raise AdmissionRejected(f"{priority} queue full")
            fut: asyncio.Future = asyncio.get_running_loop().create_future()
            self._queues[priority].append(fut)
        timeout = self.config.max_wait_secs.get(priority, 30.0)
        preempt_task = None
        if priority in self.config.preempt_for:
            preempt_task = asyncio.get_running_loop().create_task(
                self._preempt_when_stalled(fut)
            )
        try:
            await asyncio.wait_for(fut, timeout=timeout)
        except asyncio.TimeoutError:
            async with self._lock:
                if fut in self._queues[priority]:
                    self._queues[priority].remove(fut)
            self.stats[priority]["rejected"] += 1
            raise AdmissionRejected(f"{priority} admission timed out after {timeout}s")
        except asyncio.CancelledError:
            # the waiter may have been handed a slot between set_result and
            # this cancellation — return it so the slot isn't leaked
            async with self._lock:
                if fut in self._queues[priority]:
                    self._queues[priority].remove(fut)
            if fut.done() and not fut.cancelled():
                self._release()
            raise
        finally:
            if preempt_task is not None:
                preempt_task.cancel()
        if count_stats:
            self.stats[priority]["admitted"] += 1
        return SlotGuard(self, priority)

    # ---- preemption ----

    def _register_preemptable(self, guard: SlotGuard) -> None:
        if guard.priority in self.config.preemptable:
            self._preemptable[guard.priority].append(guard)

    def _unregister_preemptable(self, guard: SlotGuard) -> None:
        q = self._preemptable.get(guard.priority)
        if q and guard in q:
            q.remove(guard)

    async def _preempt_when_stalled(self, fut: asyncio.Future) -> None:
        await asyncio.sleep(self.config.preempt_after_secs)
        if fut.done():
            return
        # newest bulk work pays first (it has produced the least output)
        for c in reversed(self.config.classes):
            if c not in self.config.preemptable:
                continue
            victims = self._preemptable.get(c) or []
            for guard in reversed(victims):
                if guard.preempted or guard._preempt_cb is None:
                    continue
                # mark BEFORE the callback (task.cancel only schedules the
                # cancellation; the handler must already see preempted=True),
                # but roll back if the callback itself fails so the guard
                # stays eligible and stats stay truthful
                guard.preempted = True
                try:
                    ok = guard._preempt_cb()
                except Exception:
                    guard.preempted = False
                    continue
                if ok is False:  # task.cancel() no-op: victim already done
                    guard.preempted = False
                    continue
                self.stats[c]["preempted"] += 1
                return

    def _release(self) -> None:
        loop = asyncio.get_event_loop()

        async def _do():
            async with self._lock:
                # wake the highest-priority waiter, else free the slot
                for c in self.config.classes:
                    q = self._queues[c]
                    while q:
                        fut = q.pop(0)
                        if not fut.done():
                            fut.set_result(None)
                            return
                self._free += 1

        loop.create_task(_do())

    def describe(self) -> dict:
        return {
            "free_slots": self._free,
            "queued": {c: len(q) for c, q in self._queues.items()},
            "stats": self.stats,
        }
