"""Worker registration as a workflow — the port's copy of
``smg_tpu/gateway/registration.py`` (reference: ``server.rs:1107-1135``:
registration rides the job queue and the workflow engine, so slow or flaky
workers retry with backoff instead of serializing API handlers, and a
failed registration can be resumed).

Steps: connect (transport by URL scheme) -> model_info (retried: the
worker may still be starting) -> register (registry add) -> tokenizer
(bundle fetch; optional, skipped on failure).
"""

from __future__ import annotations

from smg_tpu_torch.utils import get_logger
from smg_tpu_torch.workflow import (
    BackoffStrategy,
    FailureAction,
    RetryPolicy,
    StepDefinition,
    WorkflowDefinition,
)

logger = get_logger("gateway.registration")

WORKER_REGISTRATION = "worker_registration"


def build_worker_registration(ctx) -> WorkflowDefinition:
    """Definition bound to an AppContext.  Instance data keys:
    in: url, worker_id?, model_id?, api_key?, worker_type?
    out: worker_id, model_id, registered (bool), tokenizer_fetched (bool)."""

    async def connect(data: dict) -> None:
        url = data["url"]
        if url.startswith(("http://", "https://")):
            from smg_tpu_torch.gateway.http_worker import HttpWorkerClient

            data["client"] = HttpWorkerClient(url, api_key=data.get("api_key", ""))
        else:
            from smg_tpu_torch.rpc.client import GrpcWorkerClient

            data["client"] = GrpcWorkerClient(url)

    async def model_info(data: dict) -> None:
        data["info"] = await data["client"].get_model_info()

    async def register(data: dict) -> None:
        from smg_tpu_torch.gateway.workers import Worker, WorkerType

        info = data["info"]
        url = data["url"]
        wtype = WorkerType(data.get("worker_type") or "regular")
        worker = Worker(
            worker_id=data.get("worker_id") or url,
            client=data["client"],
            model_id=data.get("model_id") or info.get("model_id", "default"),
            url=url,
            worker_type=wtype,
            page_size=info.get("page_size") or None,
            dp_size=info.get("dp_size") or 1,
            bootstrap_host=data.get("bootstrap_host"),
            bootstrap_port=data.get("bootstrap_port"),
        )
        ctx.registry.add(worker)
        data["worker_id"] = worker.worker_id
        data["model_id"] = worker.model_id
        data["registered"] = True

    async def tokenizer(data: dict) -> None:
        """Mirror the worker's tokenizer bundle onto the gateway unless one
        is already registered for the model."""
        model_id = data.get("model_id") or "default"
        if data.get("skip_tokenizer") or ctx.tokenizers.has(model_id):
            data["tokenizer_fetched"] = False
            return
        tok = await data["client"].get_tokenizer()
        if tok is not None:
            # a real worker tokenizer outranks the launch-time mock fallback
            # (a late registration must not leave the mock as default)
            current_default = ctx.tokenizers.get(None)
            make_default = current_default is None or getattr(
                current_default, "_smg_fallback", False
            )
            ctx.tokenizers.register(model_id, tok, default=make_default)
            data["tokenizer_fetched"] = True
            logger.info("tokenizer for %r fetched from %s", model_id, data["url"])
        else:
            data["tokenizer_fetched"] = False

    return WorkflowDefinition(WORKER_REGISTRATION, [
        StepDefinition("connect", connect,
                       retry=RetryPolicy(max_attempts=1)),
        StepDefinition(
            "model_info", model_info, timeout=30.0,
            # the worker may still be starting: it loads its kernels and
            # makes or loads its weights before it answers, so the retry
            # budget covers a cold boot (~36s of backoff; reference:
            # worker_startup_timeout_secs)
            retry=RetryPolicy(
                max_attempts=8,
                backoff=BackoffStrategy("exponential", base=0.5, max_delay=10.0),
            ),
        ),
        StepDefinition("register", register,
                       retry=RetryPolicy(max_attempts=1)),
        StepDefinition(
            "tokenizer", tokenizer, timeout=60.0,
            retry=RetryPolicy(max_attempts=2,
                              backoff=BackoffStrategy("fixed", base=0.2)),
            on_failure=FailureAction.CONTINUE_NEXT_STEP,
        ),
    ])
