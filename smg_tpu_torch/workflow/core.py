"""Workflow types — the port's copy of ``smg_tpu/workflow/core.py``:
definitions, steps, retry policies, instance state.

Reference: ``crates/workflow/src/{types,definition}.rs`` — StepDefinition
with RetryPolicy + FailureAction, WorkflowDefinition with validation,
WorkflowInstance/StepState for persisted execution state.
"""

from __future__ import annotations

import enum
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable


class ValidationError(ValueError):
    pass


class BackoffStrategy:
    """Delay schedules (reference: types.rs BackoffStrategy)."""

    def __init__(self, kind: str = "exponential", base: float = 1.0,
                 max_delay: float = 30.0, increment: float = 1.0):
        if kind not in ("fixed", "exponential", "linear"):
            raise ValidationError(f"unknown backoff kind {kind!r}")
        self.kind = kind
        self.base = base
        self.max_delay = max_delay
        self.increment = increment

    def delay(self, attempt: int) -> float:
        """Delay before retry ``attempt`` (1-based)."""
        if self.kind == "fixed":
            return min(self.base, self.max_delay)
        if self.kind == "linear":
            return min(self.increment * attempt, self.max_delay)
        return min(self.base * (2 ** (attempt - 1)), self.max_delay)


@dataclass
class RetryPolicy:
    max_attempts: int = 3
    backoff: BackoffStrategy = field(default_factory=BackoffStrategy)


class FailureAction(enum.Enum):
    FAIL_WORKFLOW = "fail_workflow"
    CONTINUE_NEXT_STEP = "continue_next_step"
    RETRY_INDEFINITELY = "retry_indefinitely"


class WorkflowStatus(enum.Enum):
    PENDING = "pending"
    RUNNING = "running"
    PAUSED = "paused"
    COMPLETED = "completed"
    FAILED = "failed"
    CANCELLED = "cancelled"


class StepStatus(enum.Enum):
    PENDING = "pending"
    RUNNING = "running"
    SUCCEEDED = "succeeded"
    FAILED = "failed"
    RETRYING = "retrying"
    SKIPPED = "skipped"


@dataclass
class StepDefinition:
    """One step: an async callable over the workflow's mutable data dict.
    The callable may return None/True (success), False (failure), or raise.
    """

    name: str
    fn: Callable[[dict], Awaitable[Any]]
    retry: RetryPolicy = field(default_factory=RetryPolicy)
    on_failure: FailureAction = FailureAction.FAIL_WORKFLOW
    timeout: float | None = None  # per-attempt seconds


@dataclass
class StepState:
    status: StepStatus = StepStatus.PENDING
    attempts: int = 0
    error: str | None = None
    started_at: float | None = None
    finished_at: float | None = None


@dataclass
class WorkflowInstance:
    """Execution state — everything needed to resume after a crash
    (reference: resumable workflow instances in state.rs)."""

    workflow_type: str
    data: dict = field(default_factory=dict)
    instance_id: str = field(default_factory=lambda: f"wfi_{uuid.uuid4().hex[:24]}")
    status: WorkflowStatus = WorkflowStatus.PENDING
    steps: dict[str, StepState] = field(default_factory=dict)
    current_step: str | None = None
    error: str | None = None
    created_at: float = field(default_factory=time.time)
    updated_at: float = field(default_factory=time.time)

    def describe(self) -> dict:
        return {
            "instance_id": self.instance_id,
            "workflow_type": self.workflow_type,
            "status": self.status.value,
            "current_step": self.current_step,
            "error": self.error,
            "steps": {
                name: {
                    "status": st.status.value,
                    "attempts": st.attempts,
                    "error": st.error,
                }
                for name, st in self.steps.items()
            },
            "created_at": self.created_at,
            "updated_at": self.updated_at,
        }


class WorkflowDefinition:
    """Ordered steps with validation (reference: definition.rs)."""

    def __init__(self, workflow_type: str,
                 steps: "list[StepDefinition] | None" = None):
        self.workflow_type = workflow_type
        self.steps: list[StepDefinition] = list(steps or [])

    def add_step(self, step: StepDefinition) -> "WorkflowDefinition":
        self.steps.append(step)
        return self

    def validate(self) -> None:
        if not self.workflow_type:
            raise ValidationError("workflow_type must be non-empty")
        if not self.steps:
            raise ValidationError(f"workflow {self.workflow_type!r} has no steps")
        names = [s.name for s in self.steps]
        if len(set(names)) != len(names):
            dupes = sorted({n for n in names if names.count(n) > 1})
            raise ValidationError(f"duplicate step names: {dupes}")
        for s in self.steps:
            if s.retry.max_attempts < 1:
                raise ValidationError(
                    f"step {s.name!r}: max_attempts must be >= 1"
                )
