"""Workflow state stores — the port's copy of ``smg_tpu/workflow/state.py``
(reference: ``crates/workflow/src/state.rs``)."""

from __future__ import annotations

import asyncio

from smg_tpu_torch.workflow.core import WorkflowInstance


class StateStore:
    async def save(self, instance: WorkflowInstance) -> None:
        raise NotImplementedError

    async def load(self, instance_id: str) -> WorkflowInstance | None:
        raise NotImplementedError

    async def list(self, workflow_type: str | None = None) -> list[WorkflowInstance]:
        raise NotImplementedError

    async def delete(self, instance_id: str) -> bool:
        raise NotImplementedError


class InMemoryStore(StateStore):
    def __init__(self):
        self._instances: dict[str, WorkflowInstance] = {}
        self._lock = asyncio.Lock()

    async def save(self, instance: WorkflowInstance) -> None:
        async with self._lock:
            self._instances[instance.instance_id] = instance

    async def load(self, instance_id: str) -> WorkflowInstance | None:
        async with self._lock:
            return self._instances.get(instance_id)

    async def list(self, workflow_type: str | None = None) -> list[WorkflowInstance]:
        async with self._lock:
            out = list(self._instances.values())
        if workflow_type is not None:
            out = [i for i in out if i.workflow_type == workflow_type]
        return sorted(out, key=lambda i: i.created_at)

    async def delete(self, instance_id: str) -> bool:
        async with self._lock:
            return self._instances.pop(instance_id, None) is not None
