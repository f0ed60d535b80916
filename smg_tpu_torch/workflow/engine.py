"""Workflow engine — the port's copy of ``smg_tpu/workflow/engine.py``:
runs definitions over instances with retries, failure actions, persisted
state, and resume (reference: ``crates/workflow/src/engine.rs``; the
semantics kept are the ones the reference tests pin: per-step retry with
backoff, FailureAction routing, cancel, resume-from-failure, event order).
"""

from __future__ import annotations

import asyncio
import time

from smg_tpu_torch.utils import get_logger
from smg_tpu_torch.workflow.core import (
    FailureAction,
    StepState,
    StepStatus,
    WorkflowDefinition,
    WorkflowInstance,
    WorkflowStatus,
)
from smg_tpu_torch.workflow.events import EventBus, WorkflowEvent
from smg_tpu_torch.workflow.state import InMemoryStore, StateStore

logger = get_logger("workflow.engine")


class WorkflowEngine:
    def __init__(self, store: StateStore | None = None,
                 bus: EventBus | None = None):
        self.store = store or InMemoryStore()
        self.bus = bus or EventBus()
        self._definitions: dict[str, WorkflowDefinition] = {}
        self._tasks: dict[str, asyncio.Task] = {}
        self._cancelled: set[str] = set()

    def register(self, definition: WorkflowDefinition) -> None:
        definition.validate()
        self._definitions[definition.workflow_type] = definition

    async def start(self, workflow_type: str, data: dict | None = None) -> str:
        """Create an instance and run it in the background; returns id."""
        if workflow_type not in self._definitions:
            raise KeyError(f"unknown workflow {workflow_type!r}")
        inst = WorkflowInstance(workflow_type=workflow_type, data=data or {})
        defn = self._definitions[workflow_type]
        for s in defn.steps:
            inst.steps[s.name] = StepState()
        await self.store.save(inst)
        self._tasks[inst.instance_id] = asyncio.ensure_future(
            self._run(inst, defn)
        )
        return inst.instance_id

    async def resume(self, instance_id: str) -> bool:
        """Re-run a failed/paused instance from its first incomplete step
        (succeeded/skipped steps are not repeated).  Returns False when the
        instance is unknown or already terminal-complete/running."""
        inst = await self.store.load(instance_id)
        if inst is None or inst.status in (
            WorkflowStatus.COMPLETED, WorkflowStatus.RUNNING
        ):
            return False
        defn = self._definitions.get(inst.workflow_type)
        if defn is None:
            return False
        self._cancelled.discard(instance_id)
        inst.status = WorkflowStatus.PENDING
        inst.error = None
        for st in inst.steps.values():
            if st.status in (StepStatus.FAILED, StepStatus.RUNNING,
                             StepStatus.RETRYING):
                st.status = StepStatus.PENDING
                st.error = None
        await self.store.save(inst)
        self._tasks[inst.instance_id] = asyncio.ensure_future(
            self._run(inst, defn)
        )
        return True

    async def cancel(self, instance_id: str) -> bool:
        inst = await self.store.load(instance_id)
        if inst is None or inst.status not in (
            WorkflowStatus.PENDING, WorkflowStatus.RUNNING
        ):
            return False
        self._cancelled.add(instance_id)
        task = self._tasks.get(instance_id)
        if task is not None:
            task.cancel()
        return True

    async def wait(self, instance_id: str, timeout: float = 60.0) -> WorkflowInstance:
        task = self._tasks.get(instance_id)
        if task is not None:
            try:
                await asyncio.wait_for(asyncio.shield(task), timeout)
            except asyncio.TimeoutError:
                pass
            except asyncio.CancelledError:
                # the shield makes this distinction possible: if the WORKFLOW
                # task was cancelled (engine.cancel) we fall through and
                # report its terminal state; if the CALLER was cancelled
                # (client disconnect) cancellation must propagate
                if not task.cancelled():
                    raise
            except Exception:
                pass  # workflow errors land in the instance state
        inst = await self.store.load(instance_id)
        assert inst is not None
        return inst

    async def _emit(self, kind: str, inst: WorkflowInstance,
                    step: str | None = None, error: str | None = None,
                    attempt: int = 0) -> None:
        await self.bus.publish(WorkflowEvent(
            kind=kind, instance_id=inst.instance_id,
            workflow_type=inst.workflow_type, step=step, error=error,
            attempt=attempt,
        ))

    async def _run(self, inst: WorkflowInstance, defn: WorkflowDefinition) -> None:
        inst.status = WorkflowStatus.RUNNING
        inst.updated_at = time.time()
        await self.store.save(inst)
        await self._emit("workflow_started", inst)
        try:
            for step in defn.steps:
                st = inst.steps[step.name]
                if st.status in (StepStatus.SUCCEEDED, StepStatus.SKIPPED):
                    continue  # resume path: done steps don't repeat
                inst.current_step = step.name
                ok = await self._run_step(inst, step, st)
                await self.store.save(inst)
                if not ok:
                    if step.on_failure == FailureAction.CONTINUE_NEXT_STEP:
                        st.status = StepStatus.SKIPPED
                        await self._emit("step_skipped", inst, step.name)
                        continue
                    inst.status = WorkflowStatus.FAILED
                    inst.error = st.error
                    inst.updated_at = time.time()
                    await self.store.save(inst)
                    await self._emit("workflow_failed", inst, step.name, st.error)
                    return
            inst.status = WorkflowStatus.COMPLETED
            inst.current_step = None
            inst.updated_at = time.time()
            await self.store.save(inst)
            await self._emit("workflow_completed", inst)
        except asyncio.CancelledError:
            inst.status = WorkflowStatus.CANCELLED
            inst.updated_at = time.time()
            await self.store.save(inst)
            await self._emit("workflow_cancelled", inst, inst.current_step)
        finally:
            self._cancelled.discard(inst.instance_id)
            self._tasks.pop(inst.instance_id, None)

    async def _run_step(self, inst, step, st: StepState) -> bool:
        attempt = 0
        while True:
            attempt += 1
            st.attempts = attempt
            st.status = StepStatus.RUNNING
            st.started_at = st.started_at or time.time()
            await self._emit("step_started", inst, step.name, attempt=attempt)
            try:
                coro = step.fn(inst.data)
                result = await (
                    asyncio.wait_for(coro, step.timeout)
                    if step.timeout else coro
                )
                if result is False:
                    raise RuntimeError(f"step {step.name!r} returned False")
                st.status = StepStatus.SUCCEEDED
                st.finished_at = time.time()
                st.error = None
                await self._emit("step_succeeded", inst, step.name,
                                 attempt=attempt)
                return True
            except asyncio.CancelledError:
                raise
            except Exception as e:
                st.error = str(e) or type(e).__name__
                retry_forever = step.on_failure == FailureAction.RETRY_INDEFINITELY
                if retry_forever or attempt < step.retry.max_attempts:
                    st.status = StepStatus.RETRYING
                    await self._emit("step_retrying", inst, step.name,
                                     st.error, attempt)
                    await asyncio.sleep(step.retry.backoff.delay(attempt))
                    continue
                st.status = StepStatus.FAILED
                st.finished_at = time.time()
                await self._emit("step_failed", inst, step.name, st.error,
                                 attempt)
                return False
