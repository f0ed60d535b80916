"""Async job queue — the port's copy of ``smg_tpu/workflow/queue.py``
(reference: the gateway's worker JobQueue, ``server.rs:1107-1117``: a
bounded queue and worker tasks with job status introspection; registration
work rides it so slow workers cannot serialize or wedge API handlers)."""

from __future__ import annotations

import asyncio
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable

from smg_tpu_torch.utils import get_logger

logger = get_logger("workflow.queue")


@dataclass
class Job:
    fn: Callable[[], Awaitable[Any]]
    name: str = "job"
    job_id: str = field(default_factory=lambda: f"job_{uuid.uuid4().hex[:24]}")
    status: str = "queued"  # queued | running | succeeded | failed | cancelled
    result: Any = None
    error: str | None = None
    created_at: float = field(default_factory=time.time)
    finished_at: float | None = None

    def describe(self) -> dict:
        return {
            "job_id": self.job_id,
            "name": self.name,
            "status": self.status,
            "error": self.error,
            "result": self.result if _json_safe(self.result) else None,
            "created_at": self.created_at,
            "finished_at": self.finished_at,
        }


def _json_safe(v) -> bool:
    import json

    try:
        json.dumps(v)
        return True
    except (TypeError, ValueError):
        return False


class JobQueue:
    def __init__(self, concurrency: int = 4, max_pending: int = 256,
                 history: int = 512):
        self._queue: asyncio.Queue = asyncio.Queue(maxsize=max_pending)
        self._jobs: dict[str, Job] = {}
        self._order: list[str] = []
        self._history = history
        self._workers = [
            asyncio.ensure_future(self._worker(i)) for i in range(concurrency)
        ]
        self._done_events: dict[str, asyncio.Event] = {}

    def submit(self, fn: Callable[[], Awaitable[Any]], name: str = "job") -> Job:
        job = Job(fn=fn, name=name)
        self._jobs[job.job_id] = job
        self._order.append(job.job_id)
        # trim history: evict only TERMINAL jobs (a live job must stay both
        # listed and tracked); stop at the first live one to keep order
        while len(self._order) > self._history:
            old = self._order[0]
            old_job = self._jobs.get(old)
            if old_job is not None and old_job.status not in (
                "succeeded", "failed", "cancelled"
            ):
                break
            self._order.pop(0)
            self._jobs.pop(old, None)
            self._done_events.pop(old, None)
        self._done_events[job.job_id] = asyncio.Event()
        try:
            self._queue.put_nowait(job)
        except asyncio.QueueFull:
            job.status = "failed"
            job.error = "job queue full"
            self._done_events[job.job_id].set()
        return job

    def get(self, job_id: str) -> Job | None:
        return self._jobs.get(job_id)

    def list(self) -> list[Job]:
        return [self._jobs[i] for i in self._order if i in self._jobs]

    async def wait(self, job_id: str, timeout: float = 60.0) -> Job:
        ev = self._done_events.get(job_id)
        if ev is not None:
            try:
                await asyncio.wait_for(ev.wait(), timeout)
            except asyncio.TimeoutError:
                pass
        return self._jobs[job_id]

    async def _worker(self, idx: int) -> None:
        while True:
            job: Job = await self._queue.get()
            if job.status != "queued":
                continue
            job.status = "running"
            try:
                job.result = await job.fn()
                job.status = "succeeded"
            except asyncio.CancelledError:
                job.status = "cancelled"
                job.finished_at = time.time()
                self._done_events[job.job_id].set()
                raise
            except Exception as e:
                logger.exception("job %s (%s) failed", job.job_id, job.name)
                job.status = "failed"
                job.error = str(e) or type(e).__name__
            job.finished_at = time.time()
            self._done_events[job.job_id].set()

    async def close(self) -> None:
        for w in self._workers:
            w.cancel()
        await asyncio.gather(*self._workers, return_exceptions=True)
