"""Workflow event bus — the port's copy of ``smg_tpu/workflow/events.py``
(reference: ``crates/workflow/src/event.rs``)."""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from smg_tpu_torch.utils import get_logger

logger = get_logger("workflow.events")


@dataclass
class WorkflowEvent:
    kind: str  # workflow_started | step_started | step_succeeded |
    #            step_retrying | step_failed | step_skipped |
    #            workflow_completed | workflow_failed | workflow_cancelled
    instance_id: str
    workflow_type: str
    step: str | None = None
    error: str | None = None
    attempt: int = 0
    at: float = field(default_factory=time.time)


class EventBus:
    """Fan-out to subscribers; a failing subscriber never blocks the
    workflow (reference: event.rs subscriber isolation)."""

    def __init__(self):
        self._subscribers: list = []

    def subscribe(self, cb) -> "callable":
        self._subscribers.append(cb)

        def unsubscribe():
            try:
                self._subscribers.remove(cb)
            except ValueError:
                pass

        return unsubscribe

    async def publish(self, event: WorkflowEvent) -> None:
        for cb in list(self._subscribers):
            try:
                result = cb(event)
                if hasattr(result, "__await__"):
                    await result
            except Exception:
                logger.exception("workflow event subscriber failed")


def LoggingSubscriber(event: WorkflowEvent) -> None:
    """Reference parity: the stock logging subscriber."""
    if event.kind in ("step_failed", "workflow_failed"):
        logger.warning("[%s/%s] %s step=%s err=%s", event.workflow_type,
                       event.instance_id, event.kind, event.step, event.error)
    else:
        logger.info("[%s/%s] %s step=%s", event.workflow_type,
                    event.instance_id, event.kind, event.step)
