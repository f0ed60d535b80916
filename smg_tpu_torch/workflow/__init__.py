"""Workflow engine and job queue — the port's copy of ``smg_tpu/workflow/``
(reference: ``crates/workflow/src/lib.rs``: typed multi-step operations
with retries, failure actions, persisted state and an event bus;
``server.rs:1107-1135`` routes worker and tokenizer registration through
it)."""

from smg_tpu_torch.workflow.core import (
    BackoffStrategy,
    FailureAction,
    RetryPolicy,
    StepDefinition,
    StepStatus,
    ValidationError,
    WorkflowDefinition,
    WorkflowInstance,
    WorkflowStatus,
)
from smg_tpu_torch.workflow.engine import WorkflowEngine
from smg_tpu_torch.workflow.events import EventBus, LoggingSubscriber, WorkflowEvent
from smg_tpu_torch.workflow.queue import Job, JobQueue
from smg_tpu_torch.workflow.state import InMemoryStore, StateStore

__all__ = [
    "BackoffStrategy",
    "FailureAction",
    "RetryPolicy",
    "StepDefinition",
    "StepStatus",
    "ValidationError",
    "WorkflowDefinition",
    "WorkflowInstance",
    "WorkflowStatus",
    "WorkflowEngine",
    "EventBus",
    "LoggingSubscriber",
    "WorkflowEvent",
    "Job",
    "JobQueue",
    "InMemoryStore",
    "StateStore",
]
