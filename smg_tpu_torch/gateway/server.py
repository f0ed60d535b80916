"""HTTP front of the port's gateway — the port's copy of
``smg_tpu/gateway/server.py`` (aiohttp) for the text serving path: probes,
model listing, chat and text completions, ``/generate``, tokenize and
detokenize, and the operational routes (``/metrics``, ``/scheduler``,
``/get_loads``, ``/flush_cache``, ``/debug/flight/{worker_id}``,
``GET /workers``, ``/start_profile``, ``/stop_profile``), embeddings,
rerank and classify (``/v1/embeddings``, ``/v1/rerank`` and its alias
``/rerank``, ``/v1/classify``), the LoRA admin routes
(``/load_lora_adapter``, ``/unload_lora_adapter``,
``/list_lora_adapters``), the parser-only routes (``/parse/function_call``,
``/parse/reasoning``), the SLO surfaces (``/debug/slo``,
``/debug/slo/verdicts``) and the routing plane's (``/debug/router``,
``/debug/kv_index``).  Each handler keeps the reference's status codes,
JSON bodies and SSE framing (``data: …`` frames, ``data: [DONE]`` last).

The request-policy layer is the reference's middleware chain, in its order:
request id, the OTel request span, errors, the request timeout and CORS
(websocket sessions exempt from the timeout), the plugin stage (``--plugins``:
``plugins/``' hooks on every request and response, which may reject or
modify it), auth, then admission (per-tenant rate limit, the priority
scheduler with cancel-and-requeue preemption of ``bulk`` work, request
counters).

Workers register by URL (``POST /workers``, synchronous or as a job;
``DELETE /workers/{worker_id}`` drains first) through the
``worker_registration`` workflow (``gateway/registration.py``), and
``/jobs`` and ``/workflows`` show and resume that work.  Chat, completions
and ``/generate`` go, in the reference's order, to a PREFILL and DECODE
pair of HTTP workers (PD over HTTP: bootstrap metadata injected into both
legs, the decode leg's answer returned), else to an HTTP worker (a
text-level proxy that re-streams its SSE frames as they come), else
through the token-level router.  In a Kubernetes pod the gateway watches
its namespace's worker pods (``gateway/discovery.py``).

The Responses API (``/v1/responses`` create, get and delete, streamed as
``event: <name>`` SSE frames) runs the agentic tool loop of
``gateway/responses.py`` over the router: MCP tools run on the server
between model turns, approvals pause and resume the loop, and history comes
from a conversation or a ``previous_response_id`` chain kept in the
conversation storage (``storage/``: memory, SQLite, Redis, Postgres,
Oracle), which ``/v1/conversations`` and its items expose.

The Anthropic Messages API (``/v1/messages``, streamed as ``event: <name>``
SSE frames) runs over the chat path through the format bridge
(``gateway/openai_bridge.py``).  Third-party providers
(``gateway/providers/``: OpenAI, xAI, Anthropic, Gemini, Bedrock, from
``--provider-config``) take a model before any local worker does: chat,
``/v1/messages`` (the bridge in front of the provider's chat) and
``/v1/responses`` (upstream for xAI, over the provider's chat otherwise)
resolve the model's provider first, and ``/v1/models`` lists its models.
Each model may have a router of its own (``gateway/router_manager.py``;
``/routers`` and ``/models/{model_id}/router`` show, set and reset it);
``ctx.router`` is the default one.

The Realtime API (``gateway/realtime.py``: the ``/v1/realtime`` websocket,
``/v1/realtime/client_secrets``, the ``/v1/realtime/relay/{session_id}``
legs) runs its responses over the default router and its audio through the
transcription leg; ``/v1/audio/transcriptions`` forwards its multipart form
to an HTTP audio worker (501 without one); ``/v1/interactions`` (create,
get, delete) runs chat turns chained by ``previous_interaction_id`` over the
conversation storage, streamed as ``content_delta`` and
``interaction_complete`` frames.
"""

from __future__ import annotations

import asyncio
import json
import os
import tempfile
import time
import uuid

from aiohttp import web

from smg_tpu_torch.gateway.auth import AuthConfig, Authenticator, AuthError
from smg_tpu_torch.gateway.discovery import KubeApi, ServiceDiscovery
from smg_tpu_torch.gateway.health import HealthConfig, HealthMonitor
from smg_tpu_torch.gateway.http_worker import HttpWorkerError
from smg_tpu_torch.gateway.kv_events import KvEventMonitor
from smg_tpu_torch.gateway.observability import Metrics
from smg_tpu_torch.gateway.openai_bridge import (
    anthropic_to_openai_request,
    openai_chunks_to_anthropic_events,
    openai_to_anthropic_response,
)
from smg_tpu_torch.gateway.priority import AdmissionRejected, PriorityConfig, PriorityScheduler
from smg_tpu_torch.gateway.providers import ProviderError, ProviderRegistry
from smg_tpu_torch.gateway.rate_limit import RateLimitConfig, RateLimiter
from smg_tpu_torch.gateway.registration import WORKER_REGISTRATION, build_worker_registration
from smg_tpu_torch.gateway.responses import ResponsesHandler
from smg_tpu_torch.gateway.router import RouteError, Router, RouterConfig
from smg_tpu_torch.gateway.router_manager import RouterManager
from smg_tpu_torch.gateway.tracing import (
    OtelTracer,
    current_span,
    current_tracer,
    end_stage,
    start_stage,
)
from smg_tpu_torch.gateway.workers import WorkerRegistry
from smg_tpu_torch.mcp import McpRegistry
from smg_tpu_torch.plugins import PluginHost, PluginResponse, Reject
from smg_tpu_torch.policies import PolicyRegistry, RequestContext
from smg_tpu_torch.protocols.anthropic import AnthropicMessagesRequest
from smg_tpu_torch.protocols.generate import GenerateMetaInfo, GenerateRequest, GenerateResponse
from smg_tpu_torch.protocols.interactions import (
    Interaction,
    InteractionsRequest,
    InteractionsUsage,
    interaction_metadata,
    text_output,
)
from smg_tpu_torch.protocols.openai import (
    ChatCompletionRequest,
    ChatCompletionResponse,
    ChatCompletionStreamChunk,
    ChatMessage,
    CompletionRequest,
    ErrorInfo,
    ErrorResponse,
    ModelCard,
    ModelList,
    StreamOptions,
)
from smg_tpu_torch.protocols.responses import ResponsesRequest, ResponsesResponse, ResponseUsage
from smg_tpu_torch.protocols.sampling import SamplingParams
from smg_tpu_torch.protocols.transcription import TranscriptionRequest
from smg_tpu_torch.storage import ConversationItem, StoredResponse, make_storage
from smg_tpu_torch.tokenizer.registry import TokenizerRegistry
from smg_tpu_torch.utils import get_logger
from smg_tpu_torch.utils.logging import request_id_var
from smg_tpu_torch.version import __version__
from smg_tpu_torch.workflow import JobQueue, LoggingSubscriber, StepStatus, WorkflowEngine

logger = get_logger("gateway.server")

#: the application key of the ``AppContext``
CTX = web.AppKey("ctx", object)

#: routes whose requests ``track_request`` counts
INFERENCE_ROUTES = frozenset({"/v1/chat/completions", "/v1/completions", "/generate",
                              "/v1/messages", "/v1/embeddings", "/v1/rerank", "/rerank",
                              "/v1/classify"})


class AppContext:
    """The gateway's shared state: workers (with the breakers'
    ``circuit_breaker_config`` = (failures, successes, open seconds)),
    policies, tokenizers, metrics, health checks, the per-model routers
    (``routers``; ``router`` is the default one), the third-party providers
    (``providers``), the request-policy layer (auth, rate limits, the
    priority scheduler, the request timeout, CORS, the tracer, extra
    request-id headers), the Responses API's conversation storage
    (``storage``: a ``make_storage`` spec), gateway-level MCP servers and
    handler, and the plugin host (``plugins``: None until
    ``load_plugins``)."""

    def __init__(
        self,
        policy: str = "cache_aware",
        router_config: RouterConfig | None = None,
        max_concurrent_requests: int = 256,
        policy_kwargs: dict | None = None,
        auth_config: AuthConfig | None = None,
        rate_limit_config: RateLimitConfig | None = None,
        priority_config: PriorityConfig | None = None,
        health_config: HealthConfig | None = None,
        storage: str | None = None,
        otel_endpoint: str | None = None,
        otel_service_name: str = "smg-tpu",
        request_id_headers: list | None = None,
        tenant_header: str = "X-Tenant-Id",
        trust_tenant_header: bool | None = None,
        request_timeout_secs: float | None = None,
        cors_allowed_origins: list | None = None,
        circuit_breaker_config: tuple | None = None,
        slo_specs=None,
    ):
        self.registry = WorkerRegistry()
        self.registry.circuit_breaker_config = circuit_breaker_config
        self.policies = PolicyRegistry(default=policy, **(policy_kwargs or {}))
        self.providers = ProviderRegistry()
        self.tokenizers = TokenizerRegistry()
        self.metrics = Metrics()
        # declarative SLO enforcement (gateway/slo_enforcement.py): specs
        # from --slo-spec evaluate over the SloTracker ring; verdicts at
        # GET /debug/slo/verdicts
        if slo_specs:
            self.metrics.slo_enforcer.install(slo_specs)
        # routing decision ring + reconciliation: every policy instance
        # (existing and lazily created per model) gets the sink
        self.metrics.route.watch(self.policies)
        self.kv_monitor = KvEventMonitor(self.registry, self.policies, metrics=self.metrics)
        # per-model routers over the shared registries; ``self.router`` is
        # the default instance, which single-model deployments use alone
        self.routers = RouterManager(self.registry, self.policies, self.tokenizers,
                                     router_config, metrics=self.metrics)
        self.router = self.routers.default
        self.semaphore = asyncio.Semaphore(max_concurrent_requests)
        # unify engine metrics into the gateway registry as in-proc workers
        # register
        self._adopted_engine_metrics: set[int] = set()
        self.registry.on_change(self._maybe_adopt_worker_metrics)
        self.health_monitor = HealthMonitor(
            self.registry, health_config, self.metrics,
            dp_loads=getattr(self.router.dp_policy, "manager", None),
        )
        self.auth = Authenticator(auth_config or AuthConfig())
        # extra headers accepted as the request id (--request-id-headers)
        self.request_id_headers = list(request_id_headers or [])
        self.tenant_header = tenant_header
        # None = trust exactly when no auth is configured
        self.trust_tenant_header = (
            trust_tenant_header
            if trust_tenant_header is not None
            else not self.auth.config.enabled
        )
        self.request_timeout_secs = request_timeout_secs
        self.cors_allowed_origins = list(cors_allowed_origins or [])
        self.rate_limiter = RateLimiter(
            rate_limit_config
            or RateLimitConfig(
                capacity=float(max_concurrent_requests),
                max_concurrent=max_concurrent_requests,
            )
        )
        self.priority = PriorityScheduler(
            priority_config or PriorityConfig(slots=max_concurrent_requests)
        )
        self.storage = make_storage(storage)
        self.mcp = McpRegistry()
        self.responses = ResponsesHandler(self.router, self.storage, self.mcp)
        # OTel tracing: off unless an OTLP endpoint is configured
        self.tracer = (OtelTracer(otel_endpoint, otel_service_name)
                       if otel_endpoint else None)
        self.discovery = None  # attached by build_app when running in a pod
        # the plugin host: None until --plugins loads modules; the plugin
        # middleware does nothing without it
        self.plugins = None
        # worker registration rides typed workflows; the job queue is made
        # lazily because it starts tasks on the running loop
        self.workflows = WorkflowEngine()
        self.workflows.bus.subscribe(LoggingSubscriber)
        self.workflows.register(build_worker_registration(self))
        self.jobs = None

    def ensure_jobs(self):
        if self.jobs is None:
            self.jobs = JobQueue()
        return self.jobs

    def router_for(self, model_id: str | None) -> Router:
        """Model-keyed router dispatch (IGW mode)."""
        return self.routers.router_for(model_id)

    def load_plugins(self, specs, fail_open: bool | None = None) -> PluginHost:
        """Load middleware plugins (file paths or dotted modules).

        ``fail_open=None`` keeps the existing host's setting: a later call
        that states no preference must not turn a ``--plugin-fail-closed``
        gateway fail-open."""
        if self.plugins is None:
            self.plugins = PluginHost(fail_open=True if fail_open is None else fail_open)
        elif fail_open is not None:
            # fail-closed is a security setting: an explicit choice wins
            self.plugins.fail_open = fail_open
        for spec in specs:
            self.plugins.load(spec)
        return self.plugins

    def adopt_engine_metrics(self, engine_metrics) -> bool:
        """Register an in-proc engine's metric set into the gateway registry
        so /metrics exports gateway and engine series side by side.
        Idempotent; a second engine's identically named collectors are
        skipped with a warning (its series stay on the engine's registry)."""
        if id(engine_metrics) in self._adopted_engine_metrics:
            return True
        try:
            engine_metrics.register_into(self.metrics.registry)
        except ValueError:
            logger.warning(
                "engine metrics collide with series already in the gateway "
                "registry; keeping them on the engine-local registry"
            )
            return False
        self._adopted_engine_metrics.add(id(engine_metrics))
        return True

    def _maybe_adopt_worker_metrics(self, event: str, worker) -> None:
        em = getattr(worker.client, "engine_metrics", None)
        if em is None:
            return
        if event == "added":
            self.adopt_engine_metrics(em)
        elif event == "removed" and id(em) in self._adopted_engine_metrics:
            em.unregister_from(self.metrics.registry)
            self._adopted_engine_metrics.discard(id(em))


def _error(status: int, message: str, err_type: str = "invalid_request_error") -> web.Response:
    body = ErrorResponse(error=ErrorInfo(message=message, type=err_type))
    return web.json_response(body.model_dump(), status=status)


def _sse_response(request: web.Request) -> web.StreamResponse:
    resp = web.StreamResponse(
        status=200,
        headers={
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
            "Connection": "keep-alive",
            "X-Accel-Buffering": "no",
        },
    )
    # trace propagation must be attached before prepare() sends the headers:
    # the otel middleware's post-handler setdefault is a no-op for streams
    span = request.get("otel_span")
    if span is not None:
        resp.headers["traceparent"] = span.traceparent
    # once prepared, bytes go out: a preempted request can no longer requeue
    request["response_started"] = True
    return resp


@web.middleware
async def request_id_middleware(request: web.Request, handler):
    ctx: AppContext = request.app[CTX]
    rid = request.headers.get("X-Request-Id")
    if not rid:
        for h in ctx.request_id_headers:
            rid = request.headers.get(h)
            if rid:
                break
    rid = rid or f"req-{uuid.uuid4().hex[:16]}"
    request["request_id"] = rid
    token = request_id_var.set(rid)
    try:
        resp = await handler(request)
        resp.headers.setdefault("X-Request-Id", rid)
        return resp
    finally:
        request_id_var.reset(token)


@web.middleware
async def otel_middleware(request: web.Request, handler):
    """One SERVER span per request, W3C traceparent in and out, correlated
    with the request id.  No-op without a configured tracer."""
    ctx: AppContext = request.app[CTX]
    tracer = ctx.tracer
    if tracer is None:
        return await handler(request)
    span = tracer.start_span(
        f"{request.method} {request.path}",
        traceparent=request.headers.get("traceparent"),
    )
    span.set("http.request.method", request.method)
    span.set("url.path", request.path)
    span.set("request.id", request.get("request_id", ""))
    request["otel_span"] = span
    # park span and tracer in contextvars so pipeline stages (queue,
    # tokenize, prefill, decode, detokenize) anywhere down-stack open
    # children of this request's span
    span_token = current_span.set(span)
    tracer_token = current_tracer.set(tracer)
    try:
        resp = await handler(request)
        span.set("http.response.status_code", resp.status)
        span.end(error=resp.status >= 500)
        resp.headers.setdefault("traceparent", span.traceparent)
        return resp
    except Exception:
        span.set("http.response.status_code", 500)
        span.end(error=True)
        raise
    finally:
        current_span.reset(span_token)
        current_tracer.reset(tracer_token)
        tracer.record(span)


@web.middleware
async def error_middleware(request: web.Request, handler):
    try:
        return await handler(request)
    except RouteError as e:
        return _error(e.status, e.message, e.err_type)
    except web.HTTPException:
        raise
    except Exception as e:
        logger.exception("unhandled error on %s", request.path)
        return _error(500, f"internal error: {e}", "internal_error")


@web.middleware
async def plugin_middleware(request: web.Request, handler):
    """The plugin hooks (reference: the WASM component host,
    ``crates/wasm/src/interface/spec.wit``): ``on_request`` before the
    handler, ``on_response`` on a whole (not streamed) response; each may
    continue, reject or modify.  No-op unless plugins are loaded."""
    ctx: AppContext = request.app[CTX]
    host = ctx.plugins
    if host is None or not host.plugins:
        return await handler(request)
    preq = host.make_request(request, request.get("request_id", ""))
    action = await host.on_request(preq)
    if isinstance(action, Reject):
        return _error(action.status, action.message or "rejected by plugin", "plugin_rejected")
    # header modifications visible to downstream handlers
    request["plugin_headers"] = preq.headers
    resp = await handler(request)
    if isinstance(resp, web.Response) and resp.body is not None:
        presp = PluginResponse(
            status=resp.status,
            headers={k.lower(): v for k, v in resp.headers.items()},
            body=bytes(resp.body) if resp.body else b"",
        )
        action = await host.on_response(presp)
        if isinstance(action, Reject):
            return _error(action.status, action.message or "rejected by plugin",
                          "plugin_rejected")
        if presp.status != resp.status or presp.body != (resp.body or b""):
            return web.Response(status=presp.status, body=presp.body,
                                content_type=resp.content_type)
        for k, v in presp.headers.items():
            if k not in ("content-type", "content-length"):
                resp.headers[k] = v
    return resp


@web.middleware
async def auth_middleware(request: web.Request, handler):
    ctx: AppContext = request.app[CTX]
    try:
        principal = ctx.auth.authenticate(request.path, request.headers)
    except AuthError as e:
        return _error(e.status, e.message, "authentication_error")
    request["principal"] = principal
    if principal:
        request["tenant"] = principal.tenant
    elif ctx.trust_tenant_header:
        # --trust-tenant-header / --tenant-header-name
        request["tenant"] = request.headers.get(ctx.tenant_header, "default")
    else:
        request["tenant"] = "default"
    return await handler(request)


@web.middleware
async def limits_middleware(request: web.Request, handler):
    """--request-timeout-secs and --cors-allowed-origins."""
    ctx: AppContext = request.app[CTX]
    origin = request.headers.get("Origin")
    cors_ok = origin and (
        origin in ctx.cors_allowed_origins or "*" in ctx.cors_allowed_origins
    )
    if request.method == "OPTIONS" and cors_ok:
        return web.Response(status=204, headers={
            "Access-Control-Allow-Origin": origin,
            "Access-Control-Allow-Methods": "GET, POST, DELETE, OPTIONS",
            "Access-Control-Allow-Headers": "authorization, content-type, x-api-key",
            "Access-Control-Max-Age": "600",
        })
    is_ws = request.headers.get("Upgrade", "").lower() == "websocket"
    if ctx.request_timeout_secs and not is_ws:
        # websocket sessions (realtime and relay) are long-lived by design:
        # the timeout governs HTTP request and response cycles only
        try:
            resp = await asyncio.wait_for(handler(request), ctx.request_timeout_secs)
        except TimeoutError:
            if request.get("response_started"):
                # bytes already out: end the connection, so the client sees
                # a cut stream at once (the reference leaves it open and
                # silent until the client gives up)
                if request.transport is not None:
                    request.transport.close()
                raise
            return _error(408, "request timed out", "timeout_error")
    else:
        resp = await handler(request)
    if cors_ok:
        resp.headers["Access-Control-Allow-Origin"] = origin
    return resp


@web.middleware
async def admission_middleware(request: web.Request, handler):
    """Per-tenant rate limit and priority-scheduler admission on the
    inference routes, and their request counters with the real status."""
    ctx: AppContext = request.app[CTX]
    if request.path not in INFERENCE_ROUTES:
        return await handler(request)
    tenant = request.get("tenant", "default")
    if not ctx.rate_limiter.try_acquire(tenant):
        ctx.metrics.rate_limited_total.inc()
        return _error(429, f"rate limit exceeded for tenant {tenant!r}", "rate_limit_error")
    priority = ctx.priority.classify(request.headers)
    q_start = time.perf_counter()
    q_span = start_stage("engine.queue", priority=priority)
    try:
        guard = await ctx.priority.admit(priority)
    except AdmissionRejected as e:
        end_stage(q_span, error=True)
        ctx.rate_limiter.release(tenant)
        return _error(503, str(e), "overloaded_error")
    end_stage(q_span)
    ctx.metrics.queue_wait.labels(priority=priority).observe(time.perf_counter() - q_start)
    try:
        with ctx.metrics.track_request(request.path) as track:
            if priority not in ctx.priority.config.preemptable:
                resp = await handler(request)
            else:
                resp = await _run_preemptable(ctx, request, handler, guard, priority)
            # count the real status: handlers returning 4xx/5xx responses
            # without raising must not be recorded as status="200"
            track.status = str(getattr(resp, "status", 200))
            return resp
    finally:
        guard.release()
        ctx.rate_limiter.release(tenant)


async def _run_preemptable(ctx: AppContext, request: web.Request, handler, guard,
                           priority: str):
    """Run a preemptable-class request so that a stalled high-priority
    waiter can cancel it.  Cancel and requeue: if no response bytes have
    gone out, the request queues again through admission and runs again;
    a response already streaming cannot be replayed, so its connection
    ends.  The cancel reaches the router, which aborts the request in the
    engine before the rerun submits it again."""
    # cache the whole body before the handler can be cancelled: aiohttp
    # caches only a complete read, so a cancel inside request.json() would
    # leave the rerun reading a half-consumed payload stream
    await request.read()
    requeues = 0
    while True:
        task = asyncio.ensure_future(handler(request))
        if requeues == 0:
            # a request that already paid one preemption runs to completion
            # (no livelock under sustained system-class pressure)
            guard.set_preempt_callback(task.cancel)
        try:
            return await task
        except asyncio.CancelledError:
            if not guard.preempted:
                # client disconnect or shutdown: propagate into the handler
                # so its work does not outlive the slot
                task.cancel()
                try:
                    await task
                except BaseException:
                    pass
                raise
            if request.get("response_started"):
                raise  # mid-stream: nothing to replay
            # requeue: give the slot back, wait in our class queue, run again
            guard.release()
            try:
                new_guard = await ctx.priority.admit(priority, count_stats=False)
            except AdmissionRejected as e:
                return _error(503, f"preempted and requeue failed: {e}", "overloaded_error")
            # adopt the fresh slot into the caller's guard (slots are
            # fungible counters: re-arm the old guard, disarm the new one)
            guard._released = False
            guard.preempted = False
            guard._preempt_cb = None
            new_guard._released = True
            requeues += 1


def build_app(ctx: AppContext, client_max_size: int = 256 * 2**20) -> web.Application:
    """The aiohttp app over ``ctx``; ``client_max_size`` caps a request
    body in bytes (``--max-payload-size``)."""
    app = web.Application(
        middlewares=[
            request_id_middleware, otel_middleware, error_middleware,
            limits_middleware, plugin_middleware, auth_middleware,
            admission_middleware,
        ],
        client_max_size=client_max_size,
    )
    app[CTX] = ctx

    async def _start_background(app):
        ctx.health_monitor.start()
        if ctx.tracer is not None:
            await ctx.tracer.start()
        if ctx.discovery is None:
            api = KubeApi()  # namespace from the service-account mount
            if api.available:
                ctx.discovery = ServiceDiscovery(ctx.registry, api=api)
        if ctx.discovery is not None:
            ctx.discovery.start()

    async def _stop_background(app):
        ctx.health_monitor.stop()
        if ctx.tracer is not None:
            await ctx.tracer.stop()
        if ctx.jobs is not None:
            await ctx.jobs.close()
        if ctx.discovery is not None:
            await ctx.discovery.aclose()
        # MCP sessions keep request-scoped servers until their TTL, and each
        # HTTP server holds an aiohttp session: none outlives the app
        await ctx.responses.sessions.close()
        await ctx.mcp.close()
        await ctx.providers.close()

    app.on_startup.append(_start_background)
    app.on_cleanup.append(_stop_background)

    app.router.add_get("/metrics", h_metrics)
    app.router.add_get("/scheduler", h_scheduler_stats)
    app.router.add_get("/debug/flight/{worker_id}", h_debug_flight)
    app.router.add_get("/debug/slo", h_debug_slo)
    app.router.add_get("/debug/slo/verdicts", h_debug_slo_verdicts)
    app.router.add_get("/debug/router", h_debug_router)
    app.router.add_get("/debug/kv_index", h_debug_kv_index)
    app.router.add_get("/health", h_health)
    app.router.add_get("/liveness", h_health)
    app.router.add_get("/readiness", h_readiness)
    app.router.add_get("/health_generate", h_health_generate)
    app.router.add_get("/v1/models", h_models)
    app.router.add_get("/get_server_info", h_server_info)
    app.router.add_post("/v1/chat/completions", h_chat)
    app.router.add_post("/v1/completions", h_completions)
    app.router.add_post("/generate", h_generate)
    app.router.add_post("/v1/embeddings", h_embeddings)
    app.router.add_post("/v1/rerank", h_rerank)
    app.router.add_post("/rerank", h_rerank)  # the reference's alias
    app.router.add_post("/v1/classify", h_classify)
    app.router.add_post("/v1/messages", h_anthropic_messages)
    app.router.add_post("/v1/audio/transcriptions", h_audio_transcriptions)
    app.router.add_post("/v1/interactions", h_interactions)
    app.router.add_get("/v1/interactions/{interaction_id}", h_interaction_get)
    app.router.add_delete("/v1/interactions/{interaction_id}", h_interaction_delete)
    app.router.add_post("/parse/function_call", h_parse_function_call)
    app.router.add_post("/parse/reasoning", h_parse_reasoning)
    app.router.add_post("/v1/tokenize", h_tokenize)
    app.router.add_post("/v1/detokenize", h_detokenize)
    # realtime.py imports this module for CTX: imported here, once both exist
    from smg_tpu_torch.gateway.realtime import (
        h_realtime_client_secrets,
        handle_realtime,
        handle_realtime_relay,
    )

    app.router.add_get("/v1/realtime", handle_realtime)
    app.router.add_post("/v1/realtime/client_secrets", h_realtime_client_secrets)
    app.router.add_get("/v1/realtime/relay/{session_id}", handle_realtime_relay)
    app.router.add_post("/v1/responses", h_responses_create)
    app.router.add_get("/v1/responses/{response_id}", h_responses_get)
    app.router.add_delete("/v1/responses/{response_id}", h_responses_delete)
    app.router.add_post("/v1/conversations", h_conv_create)
    app.router.add_get("/v1/conversations/{conv_id}", h_conv_get)
    app.router.add_post("/v1/conversations/{conv_id}", h_conv_update)
    app.router.add_delete("/v1/conversations/{conv_id}", h_conv_delete)
    app.router.add_get("/v1/conversations/{conv_id}/items", h_conv_items_list)
    app.router.add_post("/v1/conversations/{conv_id}/items", h_conv_items_add)
    app.router.add_get("/get_loads", h_get_loads)
    app.router.add_post("/flush_cache", h_flush_cache)
    app.router.add_post("/start_profile", h_start_profile)
    app.router.add_post("/stop_profile", h_stop_profile)
    app.router.add_post("/load_lora_adapter", h_load_lora)
    app.router.add_post("/unload_lora_adapter", h_unload_lora)
    app.router.add_get("/list_lora_adapters", h_list_lora)
    app.router.add_get("/workers", h_workers_list)
    app.router.add_post("/workers", h_workers_add)
    app.router.add_delete("/workers/{worker_id}", h_workers_remove)
    app.router.add_get("/jobs", h_jobs_list)
    app.router.add_get("/jobs/{job_id}", h_job_get)
    app.router.add_get("/workflows", h_workflows_list)
    app.router.add_get("/workflows/{instance_id}", h_workflow_get)
    app.router.add_post("/workflows/{instance_id}/resume", h_workflow_resume)
    app.router.add_get("/routers", h_routers_list)
    app.router.add_get("/models/{model_id}/router", h_model_router_get)
    app.router.add_post("/models/{model_id}/router", h_model_router_set)
    app.router.add_delete("/models/{model_id}/router", h_model_router_reset)
    return app


# ---- probes / info ----

async def h_metrics(request: web.Request) -> web.Response:
    ctx: AppContext = request.app[CTX]
    return web.Response(body=ctx.metrics.export(), content_type="text/plain")


async def h_scheduler_stats(request: web.Request) -> web.Response:
    """Priority-scheduler state plus per-worker engine step-loop stats
    (rolling p50/p95 step time, tokens/s, cache hit rate and the zero-leak
    audit from loads())."""
    ctx: AppContext = request.app[CTX]
    body = ctx.priority.describe()

    async def _loads(w):
        # per-worker timeout: one wedged worker must not wedge the endpoint
        try:
            return w.worker_id, await asyncio.wait_for(w.client.get_loads(), 2.0)
        except Exception as e:
            return w.worker_id, {"error": str(e)}

    results = await asyncio.gather(*(_loads(w) for w in ctx.registry.list()))
    body["engine"] = dict(results)
    return web.json_response(body)


async def h_debug_flight(request: web.Request) -> web.Response:
    """Worker flight-recorder dump: the engine's step ring and request
    timelines.  ``?reason=`` tags the dump (default ``manual``)."""
    ctx: AppContext = request.app[CTX]
    wid = request.match_info["worker_id"]
    worker = ctx.registry.get(wid)
    if worker is None:
        return _error(404, f"unknown worker {wid}")
    reason = request.query.get("reason", "manual")
    try:
        # bounded: a dump is a diagnostic fetch, possibly from a wedged worker
        dump = await asyncio.wait_for(worker.client.dump_flight(reason=reason), 30.0)
    except NotImplementedError:
        return _error(501, f"worker {wid} has no flight recorder", "not_implemented")
    except Exception as e:
        return _error(502, f"flight dump from {wid} failed: {e}", "worker_error")
    return web.json_response({"worker_id": wid, "dump": dump})


async def h_debug_slo(request: web.Request) -> web.Response:
    """Rolling gateway-side SLO and goodput summary: TTFT, ITL and e2e
    percentiles, deadline met/missed, goodput, and recent per-request
    records with trace-id exemplars.  ``?recent=`` bounds the records
    returned (default 32, capped at the ring size)."""
    ctx: AppContext = request.app[CTX]
    try:
        recent = int(request.query.get("recent", 32))
    except ValueError:
        return _error(400, "recent must be an integer")
    recent = max(0, min(recent, ctx.metrics.slo.keep))
    return web.json_response(ctx.metrics.slo.summary(recent=recent))


async def h_debug_slo_verdicts(request: web.Request) -> web.Response:
    """Every installed ``SloSpec`` evaluated now over its fast and slow
    windows of the completed-request ring: per-window stats, breaches, burn
    rates and the hysteresis-damped verdict.  No specs answers
    ``all_pass: true`` over zero verdicts."""
    ctx: AppContext = request.app[CTX]
    return web.json_response(ctx.metrics.slo_enforcer.evaluate())


async def h_debug_router(request: web.Request) -> web.Response:
    """Routing decision ring + predicted-vs-actual reconciliation: bounded,
    schema-stable per-model decision records (policy, candidates with
    loads/breaker states, prefix matches, threshold/imbalance outcome,
    tie-break, decision latency) and per-worker prediction-error aggregates
    (``gateway/route_observability.py``).  ``?model=`` filters,
    ``?limit=`` bounds records per model (default 64)."""
    ctx: AppContext = request.app[CTX]
    try:
        limit = int(request.query.get("limit", 64))
    except ValueError:
        return _error(400, "limit must be an integer")
    return web.json_response(
        ctx.metrics.route.debug_router(
            model=request.query.get("model"), limit=limit
        )
    )


# radix-relevant subset of worker loads() used by the kv-index drift audit
_KV_AUDIT_LOAD_KEYS = (
    "cached_pages", "total_pages", "free_pages", "radix_hit_pages",
    "radix_miss_pages", "radix_evicted_pages", "cached_prompt_tokens",
    "computed_prompt_tokens", "cache_hit_rate",
)


async def h_debug_kv_index(request: web.Request) -> web.Response:
    """KV-index drift audit: the gateway's cache-index state (RadixTree /
    PositionalIndexer per model) side by side with each worker's
    ``loads()``-reported radix stats, flagging event-mode divergence (the
    gateway mirror claiming materially more or fewer blocks than the worker
    actually caches).  ``?drift_ratio=`` (default 0.25) and ``?min_abs=``
    (default 4 blocks) tune the flag thresholds."""
    ctx: AppContext = request.app[CTX]
    try:
        drift_ratio = float(request.query.get("drift_ratio", 0.25))
        min_abs = int(request.query.get("min_abs", 4))
    except ValueError:
        return _error(400, "drift_ratio/min_abs must be numeric")
    gateway_view = ctx.metrics.route.kv_index_snapshot()

    async def _loads(w):
        # per-worker timeout (like /scheduler): one black-holed remote
        # worker must not wedge the audit endpoint
        try:
            return w.worker_id, await asyncio.wait_for(w.client.get_loads(), 2.0)
        except Exception as e:
            return w.worker_id, {"error": str(e)}

    all_workers = ctx.registry.list()
    results = dict(await asyncio.gather(*(_loads(w) for w in all_workers)))
    workers = {
        wid: (
            loads if "error" in loads
            else {k: loads[k] for k in _KV_AUDIT_LOAD_KEYS if k in loads}
        )
        for wid, loads in results.items()
    }

    audit = []
    for model_key, stats in gateway_view.items():
        if "error" in stats:
            continue
        # scope each policy's audit to the workers that actually feed its
        # index: KvEventMonitor subscribes a worker to policy_for(model_id),
        # so a worker with its own model key never populates the __default__
        # indexer — pairing them would flag phantom drift in multi-model
        # deployments
        pool = [
            w for w in all_workers
            if (w.model_id or "__default__") == model_key
        ]
        per_worker_blocks = (stats.get("indexer") or {}).get(
            "per_worker_blocks", {}
        )
        for w in pool:
            loads = workers.get(w.worker_id, {})
            cached_pages = loads.get("cached_pages")
            entry = {
                "model": model_key,
                "worker_id": w.worker_id,
                "mode": stats.get("mode"),
                "gateway_blocks": per_worker_blocks.get(w.worker_id, 0),
                "worker_cached_pages": cached_pages,
                "drift_blocks": None,
                "drift_ratio": None,
                "flagged": False,
            }
            if stats.get("mode") == "event" and cached_pages is not None:
                gw_blocks = entry["gateway_blocks"]
                drift = gw_blocks - cached_pages
                ratio = abs(drift) / max(gw_blocks, cached_pages, 1)
                entry["drift_blocks"] = drift
                entry["drift_ratio"] = ratio
                entry["flagged"] = ratio > drift_ratio and abs(drift) >= min_abs
            audit.append(entry)

    return web.json_response({
        "schema_version": 1,
        "gateway": gateway_view,
        "workers": workers,
        "audit": audit,
        "thresholds": {"drift_ratio": drift_ratio, "min_abs": min_abs},
    })


async def h_health(request: web.Request) -> web.Response:
    return web.json_response({"status": "ok", "version": __version__})


async def h_readiness(request: web.Request) -> web.Response:
    ctx: AppContext = request.app[CTX]
    workers = ctx.registry.list()
    healthy = [w for w in workers if w.is_available()]
    status = 200 if healthy else 503
    return web.json_response(
        {"ready": bool(healthy), "workers": len(workers), "healthy": len(healthy)},
        status=status,
    )


async def h_health_generate(request: web.Request) -> web.Response:
    """End-to-end probe: a 1-token generation through the pipeline."""
    ctx: AppContext = request.app[CTX]
    tok = ctx.tokenizers.get(None)
    if tok is None:
        return _error(503, "no tokenizer", "service_unavailable")
    ids = tok.encode("health probe")[:8] or [1]
    sampling = SamplingParams(max_new_tokens=1, ignore_eos=True)
    rid = f"health-{uuid.uuid4().hex[:8]}"
    rctx = RequestContext(token_ids=ids, request_id=rid)
    try:
        async for _ in ctx.router._execute(rctx, ids, sampling, rid, None):
            pass
        return web.json_response({"status": "ok"})
    except RouteError as e:
        return _error(e.status, e.message, e.err_type)


async def h_models(request: web.Request) -> web.Response:
    ctx: AppContext = request.app[CTX]
    ids = list(ctx.registry.model_ids()) + ctx.providers.list_models()
    ids = ids or ["default"]
    return web.json_response(ModelList(data=[ModelCard(id=i) for i in ids]).model_dump())


async def h_server_info(request: web.Request) -> web.Response:
    ctx: AppContext = request.app[CTX]
    return web.json_response(
        {"version": __version__, "workers": [w.describe() for w in ctx.registry.list()]}
    )


# ---- inference APIs ----

async def _write_sse(request: web.Request, chunks) -> web.StreamResponse:
    """Stream pydantic chunks as ``data: {json}`` frames, then ``[DONE]``; a
    route error after the headers went out becomes an error frame."""
    sse = _sse_response(request)
    await sse.prepare(request)
    try:
        async for chunk in chunks:
            data = chunk.model_dump(exclude_none=True)
            await sse.write(f"data: {json.dumps(data)}\n\n".encode())
        await sse.write(b"data: [DONE]\n\n")
    except RouteError as e:
        err = ErrorResponse(error=ErrorInfo(message=e.message, type=e.err_type))
        await sse.write(f"data: {json.dumps(err.model_dump())}\n\n".encode())
    await sse.write_eof()
    return sse


async def h_chat(request: web.Request) -> web.Response | web.StreamResponse:
    ctx: AppContext = request.app[CTX]
    try:
        req = ChatCompletionRequest.model_validate(await request.json())
    except Exception as e:
        return _error(400, f"invalid request: {e}")
    rid = request["request_id"]
    adapter = ctx.providers.resolve(req.model)
    if adapter is not None:
        return await _chat_via_provider(request, ctx, adapter, req)
    router = ctx.router_for(req.model)
    pd_pair = router.select_pd_http_pair(req.model)
    if pd_pair is not None:
        body = req.model_dump(exclude_none=True, exclude_unset=True)
        return await _proxy_pd_via_http(request, ctx, pd_pair, body,
                                        "/v1/chat/completions", req.stream)
    proxy_worker = router.select_proxy_worker(req.model)
    if proxy_worker is not None:
        return await _proxy_via_http_worker(request, ctx, proxy_worker, req,
                                            "/v1/chat/completions")
    async with ctx.semaphore:
        if not req.stream:
            resp = await router.chat(req, request_id=rid)
            return web.json_response(resp.model_dump(exclude_none=True))
        return await _write_sse(request, router.chat_stream(req, request_id=rid))


def _provider_error(e: Exception) -> web.Response:
    """A provider's failure before any bytes went out: its 4xx keeps its
    status, a 5xx is a 502, an unreachable provider a 502."""
    if isinstance(e, ProviderError):
        return _error(502 if e.status >= 500 else e.status, f"provider error: {e.message}",
                      "provider_error")
    return _error(502, f"provider unreachable: {e}", "provider_error")


async def _chat_via_provider(request, ctx, adapter, req) -> web.Response | web.StreamResponse:
    """Third-party provider path (reference: ``routers/openai/`` provider
    routing): no gateway-side tokenization, the upstream owns templating
    and parsing.  Each upstream chunk is written as it comes."""
    async with ctx.semaphore:
        if not req.stream:
            try:
                data = await adapter.chat(req)
            except Exception as e:
                return _provider_error(e)
            return web.json_response(data)
        sse = _sse_response(request)
        await sse.prepare(request)
        try:
            async for chunk in adapter.chat_stream(req):
                await sse.write(f"data: {json.dumps(chunk)}\n\n".encode())
            await sse.write(b"data: [DONE]\n\n")
        except Exception as e:
            msg = e.message if isinstance(e, ProviderError) else str(e)
            err = ErrorResponse(error=ErrorInfo(message=msg, type="provider_error"))
            await sse.write(f"data: {json.dumps(err.model_dump())}\n\n".encode())
        await sse.write_eof()
        return sse


def _client_gone(request: web.Request) -> bool:
    """The client hung up (its connection is closing): what failed then is
    not the worker, and the breakers are not fed."""
    return request.transport is None or request.transport.is_closing()


async def _proxy_via_http_worker(request, ctx, worker, req, path: str
                                 ) -> web.Response | web.StreamResponse:
    """HTTP worker proxy path (reference: ``routers/http/router.rs``):
    text-level passthrough to an OpenAI-compatible worker, with registry
    citizenship: load guard, breaker feedback, worker counters."""
    body = req.model_dump(exclude_none=True, exclude_unset=True)
    return await _proxy_raw_via_http_worker(request, ctx, worker, body, path,
                                            bool(req.stream))


def _inject_bootstrap(body: dict, prefill_worker) -> dict:
    """PD-over-HTTP bootstrap metadata (reference: ``pd_router.rs``
    ``inject_bootstrap_into_value``): both legs get the PREFILL worker's
    rendezvous address and one shared random room id; the engines transfer
    the KV between themselves.  Batch requests (list text or input_ids on
    /generate) get lists, one entry a prompt."""
    import random
    from urllib.parse import urlparse

    parsed = urlparse(prefill_worker.url if "//" in prefill_worker.url
                      else "http://" + prefill_worker.url)
    host = prefill_worker.bootstrap_host or parsed.hostname or prefill_worker.url
    # a PREFILL worker registered without a bootstrap port rendezvouses on
    # its serving port
    port = prefill_worker.bootstrap_port
    if port is None:
        port = parsed.port
    n = 1
    for key in ("text", "input_ids", "prompt"):
        v = body.get(key)
        if isinstance(v, list) and v and isinstance(v[0], (str, list)):
            n = len(v)
            break
    if n > 1:
        body["bootstrap_host"] = [host] * n
        body["bootstrap_port"] = [port] * n
        body["bootstrap_room"] = [random.getrandbits(63) for _ in range(n)]
    else:
        body["bootstrap_host"] = host
        body["bootstrap_port"] = port
        body["bootstrap_room"] = random.getrandbits(63)
    return body


async def _proxy_pd_via_http(request, ctx, pair, body: dict, path: str, stream: bool
                             ) -> web.Response | web.StreamResponse:
    """PD-over-HTTP dual dispatch (reference: ``routers/http/pd_router.rs``
    ``execute_dual_dispatch``): inject the bootstrap metadata, send the
    request to BOTH the prefill and the decode worker, return the decode
    worker's response (the prefill leg's is drained and only checked for
    errors: its job is the KV the decode leg pulls)."""
    prefill_w, decode_w = pair
    body = _inject_bootstrap(dict(body), prefill_w)
    prefill_body = {**body, "stream": False}
    async with ctx.semaphore:
        pguard = prefill_w.acquire()
        dguard = decode_w.acquire()
        p_ok = d_ok = False
        prefill_task = asyncio.create_task(prefill_w.client.post_json(path, prefill_body))
        try:
            if not stream:
                decode_task = asyncio.create_task(decode_w.client.post_json(path, body))
                p_res, d_res = await asyncio.gather(prefill_task, decode_task,
                                                    return_exceptions=True)
                if isinstance(p_res, BaseException):
                    logger.warning("pd-http prefill leg failed: %s", p_res)
                else:
                    p_ok = True
                if isinstance(d_res, BaseException):
                    msg = getattr(d_res, "message", str(d_res))
                    status = getattr(d_res, "status", 502)
                    return _error(502 if status >= 500 else status, f"worker error: {msg}",
                                  "worker_error")
                d_ok = True
                return web.json_response(d_res)
            sse = _sse_response(request)
            await sse.prepare(request)
            try:
                async for chunk in decode_w.client.stream_sse(path, body):
                    await sse.write(f"data: {json.dumps(chunk)}\n\n".encode())
                await sse.write(b"data: [DONE]\n\n")
                d_ok = True
            except (ConnectionResetError, asyncio.CancelledError):
                # the client hung up mid-stream: not a worker failure, so
                # the breakers are not fed (the token-level path's rule)
                p_ok = d_ok = True
                raise
            except Exception as e:
                msg = getattr(e, "message", str(e))
                err = ErrorResponse(error=ErrorInfo(message=msg, type="worker_error"))
                try:
                    await sse.write(f"data: {json.dumps(err.model_dump())}\n\n".encode())
                except ConnectionResetError:
                    p_ok = d_ok = True
            try:
                await prefill_task
                p_ok = True
            except Exception as e:
                logger.warning("pd-http prefill leg failed: %s", e)
            await sse.write_eof()
            return sse
        finally:
            if not prefill_task.done():
                prefill_task.cancel()
            pguard.release(success=p_ok)
            dguard.release(success=d_ok)


async def _proxy_raw_via_http_worker(request, ctx, worker, body: dict, path: str,
                                     stream: bool) -> web.Response | web.StreamResponse:
    """Raw-dict variant of ``_proxy_via_http_worker`` for native engine
    endpoints (``/generate``) whose body is not an OpenAI model object.
    The worker's SSE frames are re-streamed as they come; an upstream 4xx
    keeps its status, a 5xx or an unreachable worker is a 502, both as
    ``worker_error`` bodies."""
    async with ctx.semaphore:
        guard = worker.acquire()
        ok = False
        try:
            if not stream:
                try:
                    data = await worker.client.post_json(path, body)
                except HttpWorkerError as e:
                    return _error(502 if e.status >= 500 else e.status,
                                  f"worker error: {e.message}", "worker_error")
                except Exception as e:
                    return _error(502, f"worker unreachable: {e}", "worker_error")
                ok = True
                return web.json_response(data)
            sse = _sse_response(request)
            await sse.prepare(request)
            try:
                async for chunk in worker.client.stream_sse(path, body):
                    await sse.write(f"data: {json.dumps(chunk)}\n\n".encode())
                await sse.write(b"data: [DONE]\n\n")
                ok = True
            except asyncio.CancelledError:
                ok = True  # cancelled from the client's side
                raise
            except Exception as e:
                if _client_gone(request):
                    ok = True
                    raise
                msg = getattr(e, "message", str(e))
                err = ErrorResponse(error=ErrorInfo(message=msg, type="worker_error"))
                await sse.write(f"data: {json.dumps(err.model_dump())}\n\n".encode())
            await sse.write_eof()
            return sse
        finally:
            guard.release(success=ok)


async def h_completions(request: web.Request) -> web.Response | web.StreamResponse:
    ctx: AppContext = request.app[CTX]
    try:
        req = CompletionRequest.model_validate(await request.json())
    except Exception as e:
        return _error(400, f"invalid request: {e}")
    rid = request["request_id"]
    router = ctx.router_for(req.model)
    pd_pair = router.select_pd_http_pair(req.model)
    if pd_pair is not None:
        body = req.model_dump(exclude_none=True, exclude_unset=True)
        return await _proxy_pd_via_http(request, ctx, pd_pair, body, "/v1/completions",
                                        bool(req.stream))
    proxy_worker = router.select_proxy_worker(req.model)
    if proxy_worker is not None:
        return await _proxy_via_http_worker(request, ctx, proxy_worker, req,
                                            "/v1/completions")
    async with ctx.semaphore:
        if not req.stream:
            resp = await router.completion(req, request_id=rid)
            return web.json_response(resp.model_dump(exclude_none=True))
        return await _write_sse(request, router.completion_stream(req, request_id=rid))


async def h_generate(request: web.Request) -> web.Response | web.StreamResponse:
    """SGLang-compatible native generate endpoint."""
    ctx: AppContext = request.app[CTX]
    try:
        raw_body = await request.json()
        req = GenerateRequest.model_validate(raw_body)
    except Exception as e:
        return _error(400, f"invalid request: {e}")
    rid = req.rid or request["request_id"]
    # HTTP workers own /generate natively: raw passthrough (dual dispatch
    # when prefill and decode pools exist)
    router0 = ctx.router_for(None)
    pd_pair = router0.select_pd_http_pair(None)
    if pd_pair is not None:
        return await _proxy_pd_via_http(request, ctx, pd_pair, dict(raw_body), "/generate",
                                        bool(req.stream))
    proxy_worker = router0.select_proxy_worker(None)
    if proxy_worker is not None:
        return await _proxy_raw_via_http_worker(request, ctx, proxy_worker, dict(raw_body),
                                                "/generate", bool(req.stream))
    sampling = req.to_sampling_params(ctx.router.config.default_max_tokens)

    if isinstance(req.text, list) or (req.input_ids and isinstance(req.input_ids[0], list)):
        return _error(400, "batch generate not yet supported; send one prompt per request")

    tokenizer = ctx.tokenizers.get(None)
    if req.input_ids is not None:
        input_ids = list(req.input_ids)
        text = None
    elif req.text is not None:
        if tokenizer is None:
            return _error(500, "no tokenizer registered")
        text = req.text
        input_ids = ctx.tokenizers.encode_cached(None, text)
    else:
        return _error(400, "need text or input_ids")

    rctx = RequestContext(text=text, token_ids=input_ids, request_id=rid)

    async with ctx.semaphore:
        if not req.stream:
            parts: list[str] = []
            token_ids: list[int] = []
            last = None
            async for ev in ctx.router._execute(rctx, input_ids, sampling, rid, tokenizer):
                parts.append(ev.text_delta)
                token_ids.extend(ev.token_ids)
                last = ev
            resp = GenerateResponse(
                text="".join(parts),
                output_ids=token_ids,
                meta_info=GenerateMetaInfo(
                    id=rid,
                    finish_reason={"type": last.finish_reason, "matched": last.matched_stop}
                    if last and last.finish_reason
                    else None,
                    prompt_tokens=last.prompt_tokens if last else 0,
                    completion_tokens=last.output_tokens if last else 0,
                    cached_tokens=last.cached_tokens if last else 0,
                ),
            )
            return web.json_response(resp.model_dump())
        sse = _sse_response(request)
        await sse.prepare(request)
        acc_text = []
        acc_ids: list[int] = []
        async for ev in ctx.router._execute(rctx, input_ids, sampling, rid, tokenizer):
            acc_text.append(ev.text_delta)
            acc_ids.extend(ev.token_ids)
            payload = GenerateResponse(
                text="".join(acc_text),
                output_ids=acc_ids,
                meta_info=GenerateMetaInfo(
                    id=rid,
                    finish_reason={"type": ev.finish_reason, "matched": ev.matched_stop}
                    if ev.finish_reason
                    else None,
                    prompt_tokens=ev.prompt_tokens,
                    completion_tokens=ev.output_tokens,
                    cached_tokens=ev.cached_tokens,
                ),
            )
            await sse.write(f"data: {json.dumps(payload.model_dump())}\n\n".encode())
        await sse.write(b"data: [DONE]\n\n")
        await sse.write_eof()
        return sse


async def h_embeddings(request: web.Request) -> web.Response:
    ctx: AppContext = request.app[CTX]
    from smg_tpu_torch.protocols.openai import EmbeddingRequest

    try:
        req = EmbeddingRequest.model_validate(await request.json())
    except Exception as e:
        return _error(400, f"invalid request: {e}")
    async with ctx.semaphore:
        resp = await ctx.router_for(req.model).embeddings(req,
                                                          request_id=request["request_id"])
        return web.json_response(resp.model_dump())


async def h_rerank(request: web.Request) -> web.Response:
    ctx: AppContext = request.app[CTX]
    from smg_tpu_torch.protocols.rerank import RerankRequest

    try:
        req = RerankRequest.model_validate(await request.json())
    except Exception as e:
        return _error(400, f"invalid request: {e}")
    async with ctx.semaphore:
        try:
            resp = await ctx.router_for(req.model).rerank(req,
                                                          request_id=request["request_id"])
        except RouteError as e:
            return _error(e.status, e.message, e.err_type)
        return web.json_response(resp.model_dump(exclude_none=True))


async def h_classify(request: web.Request) -> web.Response:
    ctx: AppContext = request.app[CTX]
    from smg_tpu_torch.protocols.rerank import ClassifyRequest

    try:
        req = ClassifyRequest.model_validate(await request.json())
    except Exception as e:
        return _error(400, f"invalid request: {e}")
    async with ctx.semaphore:
        try:
            resp = await ctx.router_for(req.model).classify(req,
                                                            request_id=request["request_id"])
        except RouteError as e:
            return _error(e.status, e.message, e.err_type)
        return web.json_response(resp.model_dump())


async def _write_events(request: web.Request, events, err_type: str | None = None
                        ) -> web.StreamResponse:
    """Stream (name, payload) pairs as ``event: <name>`` SSE frames.  A
    route error after the headers went out becomes an ``error`` event; so
    does any failure when ``err_type`` names the type to report it as (the
    provider paths)."""
    sse = _sse_response(request)
    await sse.prepare(request)
    try:
        async for name, payload in events:
            await sse.write(f"event: {name}\ndata: {json.dumps(payload)}\n\n".encode())
    except Exception as e:
        if err_type is None and not isinstance(e, RouteError):
            raise
        if err_type is None:
            info = {"type": e.err_type, "message": e.message}
        else:
            info = {"type": err_type,
                    "message": e.message if isinstance(e, ProviderError) else str(e)}
        err = {"type": "error", "error": info}
        await sse.write(f"event: error\ndata: {json.dumps(err)}\n\n".encode())
    await sse.write_eof()
    return sse


async def h_anthropic_messages(request: web.Request) -> web.Response | web.StreamResponse:
    """The Anthropic Messages API: a provider's model through the bridge in
    front of its chat, else the model's router."""
    ctx: AppContext = request.app[CTX]
    try:
        req = AnthropicMessagesRequest.model_validate(await request.json())
    except Exception as e:
        return _error(400, f"invalid request: {e}")
    rid = request["request_id"]
    adapter = ctx.providers.resolve(req.model)
    if adapter is not None:
        return await _messages_via_provider(request, ctx, adapter, req)
    router = ctx.router_for(req.model)
    async with ctx.semaphore:
        if not req.stream:
            resp = await router.anthropic_messages(req, request_id=rid)
            return web.json_response(resp.model_dump(exclude_none=True))
        return await _write_events(request, router.anthropic_messages_stream(req,
                                                                             request_id=rid))


async def _messages_via_provider(request, ctx, adapter, req) -> web.Response | web.StreamResponse:
    """Anthropic /v1/messages served by an OpenAI-format provider backend
    through the shared bridge."""
    chat_req = anthropic_to_openai_request(req)
    if req.stream:
        # OpenAI-format upstreams send the usage frame only when asked:
        # without it message_delta would meter zero tokens
        chat_req.stream_options = StreamOptions(include_usage=True)
    async with ctx.semaphore:
        if not req.stream:
            try:
                data = await adapter.chat(chat_req)
            except Exception as e:
                return _provider_error(e)
            resp = openai_to_anthropic_response(ChatCompletionResponse.model_validate(data),
                                                req.model)
            return web.json_response(resp.model_dump(exclude_none=True))

        async def chunks():
            async for raw in adapter.chat_stream(chat_req):
                yield ChatCompletionStreamChunk.model_validate(raw)

        return await _write_events(
            request, openai_chunks_to_anthropic_events(chunks(), req.model), "provider_error")


async def h_parse_function_call(request: web.Request) -> web.Response:
    """Parser-only endpoint: tool calls in ``text`` by the dialect of
    ``tool_call_parser`` (or of ``model``)."""
    body = await request.json()
    from smg_tpu_torch.parsers import get_tool_parser

    parser = get_tool_parser(body.get("tool_call_parser") or body.get("model"))
    normal, calls = parser.parse_full(body.get("text", ""))
    return web.json_response(
        {
            "normal_text": normal,
            "calls": [
                {"name": c.name, "arguments": c.arguments, "id": c.id, "index": c.index}
                for c in calls
            ],
        }
    )


async def h_parse_reasoning(request: web.Request) -> web.Response:
    """Parser-only endpoint: reasoning split out of ``text`` by the family
    of ``reasoning_parser`` (or of ``model``)."""
    body = await request.json()
    from smg_tpu_torch.parsers import get_reasoning_parser

    parser = get_reasoning_parser(body.get("reasoning_parser") or body.get("model"))
    content, reasoning = parser.parse_full(body.get("text", ""))
    return web.json_response({"text": content, "reasoning_text": reasoning})


async def h_tokenize(request: web.Request) -> web.Response:
    ctx: AppContext = request.app[CTX]
    body = await request.json()
    tok = ctx.tokenizers.get(body.get("model"))
    if tok is None:
        return _error(500, "no tokenizer registered")
    text = body.get("text") or body.get("prompt") or ""
    ids = tok.encode(text, add_special_tokens=body.get("add_special_tokens", False))
    return web.json_response({"tokens": ids, "count": len(ids)})


async def h_detokenize(request: web.Request) -> web.Response:
    ctx: AppContext = request.app[CTX]
    body = await request.json()
    tok = ctx.tokenizers.get(body.get("model"))
    if tok is None:
        return _error(500, "no tokenizer registered")
    ids = body.get("tokens") or []
    text = tok.decode(ids, skip_special_tokens=body.get("skip_special_tokens", True))
    return web.json_response({"text": text})


# ---- responses / conversations ----

async def h_responses_create(request: web.Request) -> web.Response | web.StreamResponse:
    ctx: AppContext = request.app[CTX]
    try:
        req = ResponsesRequest.model_validate(await request.json())
    except Exception as e:
        return _error(400, f"invalid request: {e}")
    rid = request["request_id"]
    tenant = request.get("tenant")
    adapter = ctx.providers.resolve(req.model)
    if adapter is not None:
        if hasattr(adapter, "responses"):
            # Responses-capable providers (xAI) take the request upstream
            # with their input rewrite
            return await _responses_via_provider(request, ctx, adapter, req)
        # chat-only providers: the Responses result made over the adapter's
        # chat (the local loop has no worker for them)
        return await _responses_via_chat_adapter(ctx, adapter, req)
    async with ctx.semaphore:
        if not req.stream:
            resp = await ctx.responses.create(req, request_id=rid, tenant=tenant)
            return web.json_response(resp.model_dump(exclude_none=True))
        sse = _sse_response(request)
        await sse.prepare(request)
        try:
            async for name, payload in ctx.responses.create_stream(
                req, request_id=rid, tenant=tenant
            ):
                await sse.write(f"event: {name}\ndata: {json.dumps(payload)}\n\n".encode())
        except RouteError as e:
            err = {"type": "error", "error": {"message": e.message, "type": e.err_type}}
            await sse.write(f"event: error\ndata: {json.dumps(err)}\n\n".encode())
        await sse.write_eof()
        return sse


async def _responses_via_provider(request, ctx, adapter, req
                                  ) -> web.Response | web.StreamResponse:
    body = req.model_dump(exclude_none=True, exclude_unset=True)
    async with ctx.semaphore:
        if not req.stream:
            try:
                data = await adapter.responses(body)
            except Exception as e:
                return _provider_error(e)
            return web.json_response(data)
        sse = _sse_response(request)
        await sse.prepare(request)
        try:
            async for name, payload in adapter.responses_stream(body):
                await sse.write(f"event: {name}\ndata: {json.dumps(payload)}\n\n".encode())
        except Exception as e:
            msg = e.message if isinstance(e, ProviderError) else str(e)
            err = {"type": "error", "error": {"message": msg, "type": "provider_error"}}
            await sse.write(f"event: error\ndata: {json.dumps(err)}\n\n".encode())
        await sse.write_eof()
        return sse


async def _responses_via_chat_adapter(ctx, adapter, req) -> web.Response:
    """A Responses result over a chat-only provider: the input becomes chat
    messages, the chat answer becomes message and function_call output
    items.  Tool execution loops stay on the local handler: provider models
    get the single-shot surface (streamed or not, one JSON body)."""
    messages = []
    if req.instructions:
        messages.append(ChatMessage(role="system", content=req.instructions))
    if isinstance(req.input, str):
        messages.append(ChatMessage(role="user", content=req.input))
    else:
        for item in req.input:
            messages.extend(ctx.responses._item_to_messages(
                item.get("type", "message"), item.get("role"), item))
    chat_req = ChatCompletionRequest(
        model=req.model, messages=messages, temperature=req.temperature, top_p=req.top_p,
        max_tokens=req.max_output_tokens,
        tools=[t for t in (req.tools or []) if t.get("type") == "function"] or None,
    )
    async with ctx.semaphore:
        try:
            data = await adapter.chat(chat_req)
        except Exception as e:
            return _provider_error(e)
    resp = ChatCompletionResponse.model_validate(data)
    choice = resp.choices[0]
    output = []
    if choice.message.content:
        output.append({"type": "message", "role": "assistant",
                       "content": [{"type": "output_text", "text": choice.message.content}]})
    for tc in choice.message.tool_calls or []:
        output.append({"type": "function_call", "call_id": tc.id or "call_0",
                       "name": tc.function.name or "",
                       "arguments": tc.function.arguments or "{}"})
    usage = ResponseUsage(input_tokens=resp.usage.prompt_tokens,
                          output_tokens=resp.usage.completion_tokens,
                          total_tokens=resp.usage.total_tokens)
    out = ResponsesResponse(model=req.model or "default", status="completed", output=output,
                            usage=usage, metadata=req.metadata or {})
    return web.json_response(out.model_dump(exclude_none=True))


async def h_responses_get(request: web.Request) -> web.Response:
    ctx: AppContext = request.app[CTX]
    stored = await ctx.storage.get_response(request.match_info["response_id"])
    if stored is None:
        return _error(404, "response not found")
    return web.json_response(
        {
            "id": stored.id,
            "object": "response",
            "created_at": int(stored.created_at),
            "status": stored.status,
            "model": stored.model,
            "output": stored.output,
            "previous_response_id": stored.previous_response_id,
            "usage": stored.usage,
            "metadata": stored.metadata,
        }
    )


async def h_responses_delete(request: web.Request) -> web.Response:
    ctx: AppContext = request.app[CTX]
    rid = request.match_info["response_id"]
    if not await ctx.storage.delete_response(rid):
        return _error(404, "response not found")
    return web.json_response({"id": rid, "object": "response", "deleted": True})


def _conv_json(conv) -> dict:
    return {
        "id": conv.id, "object": "conversation",
        "created_at": int(conv.created_at), "metadata": conv.metadata,
    }


def _conv_items(raw: list) -> list:
    return [ConversationItem(type=i.get("type", "message"), role=i.get("role"), content=i)
            for i in raw]


async def h_conv_create(request: web.Request) -> web.Response:
    ctx: AppContext = request.app[CTX]
    body = await request.json() if request.can_read_body else {}
    conv = await ctx.storage.create_conversation(body.get("metadata") or {})
    if body.get("items"):
        await ctx.storage.add_items(conv.id, _conv_items(body["items"]))
    return web.json_response(_conv_json(conv))


async def h_conv_get(request: web.Request) -> web.Response:
    ctx: AppContext = request.app[CTX]
    conv = await ctx.storage.get_conversation(request.match_info["conv_id"])
    if conv is None:
        return _error(404, "conversation not found")
    return web.json_response(_conv_json(conv))


async def h_conv_update(request: web.Request) -> web.Response:
    ctx: AppContext = request.app[CTX]
    body = await request.json()
    conv = await ctx.storage.update_conversation(
        request.match_info["conv_id"], body.get("metadata") or {}
    )
    if conv is None:
        return _error(404, "conversation not found")
    return web.json_response(_conv_json(conv))


async def h_conv_delete(request: web.Request) -> web.Response:
    ctx: AppContext = request.app[CTX]
    cid = request.match_info["conv_id"]
    if not await ctx.storage.delete_conversation(cid):
        return _error(404, "conversation not found")
    return web.json_response({"id": cid, "object": "conversation.deleted", "deleted": True})


async def h_conv_items_list(request: web.Request) -> web.Response:
    ctx: AppContext = request.app[CTX]
    cid = request.match_info["conv_id"]
    if await ctx.storage.get_conversation(cid) is None:
        return _error(404, "conversation not found")
    items = await ctx.storage.list_items(cid)
    return web.json_response(
        {
            "object": "list",
            "data": [
                {"id": i.id, "type": i.type, "role": i.role, "content": i.content,
                 "created_at": int(i.created_at)}
                for i in items
            ],
        }
    )


async def h_conv_items_add(request: web.Request) -> web.Response:
    ctx: AppContext = request.app[CTX]
    cid = request.match_info["conv_id"]
    if await ctx.storage.get_conversation(cid) is None:
        return _error(404, "conversation not found")
    body = await request.json()
    items = _conv_items(body.get("items", []))
    await ctx.storage.add_items(cid, items)
    return web.json_response({"object": "list", "data": [{"id": i.id} for i in items]})


# ---- operations ----

async def h_get_loads(request: web.Request) -> web.Response:
    ctx: AppContext = request.app[CTX]
    loads = []
    for w in ctx.registry.list():
        entry = {"worker_id": w.worker_id, "gateway_load": w.load}
        try:
            entry.update(await w.client.get_loads())
        except Exception as e:
            entry["error"] = str(e)
        loads.append(entry)
    return web.json_response({"loads": loads})


async def h_flush_cache(request: web.Request) -> web.Response:
    ctx: AppContext = request.app[CTX]
    results = {}
    for w in ctx.registry.list():
        try:
            results[w.worker_id] = await w.client.flush_cache()
        except Exception as e:
            results[w.worker_id] = f"error: {e}"
    return web.json_response({"flushed": results})


async def h_start_profile(request: web.Request) -> web.Response:
    """Proxy engine profilers (reference: server.rs:897-898 -> engine
    StartProfile; here a torch.profiler trace on each worker, written to
    ``output_dir``, by default ``smg_profile`` under the temporary
    directory)."""
    ctx: AppContext = request.app[CTX]
    try:
        body = await request.json() if request.can_read_body else {}
    except Exception:
        body = {}
    output_dir = body.get("output_dir") or os.path.join(tempfile.gettempdir(), "smg_profile")
    results = {}
    started = []
    for w in ctx.registry.list():
        try:
            r = await w.client.start_profile(
                output_dir,
                host_tracer=bool(body.get("host_tracer", True)),
                python_tracer=bool(body.get("python_tracer", False)),
                num_steps=int(body.get("num_steps", 0) or 0),
            )
        except Exception as e:
            r = {"ok": False, "error": str(e)}
        results[w.worker_id] = r
        if r.get("ok"):
            started.append(w)
    ok = bool(results) and all(r.get("ok") for r in results.values())
    if not ok and started:
        # all-or-nothing: roll back partial starts so no worker is left with
        # an asymmetric trace running
        for w in started:
            try:
                await w.client.stop_profile()
            except Exception:
                pass
    return web.json_response({"ok": ok, "workers": results}, status=200 if ok else 503)


async def h_stop_profile(request: web.Request) -> web.Response:
    ctx: AppContext = request.app[CTX]
    results = {}
    for w in ctx.registry.list():
        try:
            results[w.worker_id] = await w.client.stop_profile()
        except Exception as e:
            results[w.worker_id] = {"ok": False, "error": str(e)}
    ok = bool(results) and all(r.get("ok") for r in results.values())
    return web.json_response({"ok": ok, "workers": results}, status=200 if ok else 503)


async def h_load_lora(request: web.Request) -> web.Response:
    """Broadcast LoadLoRAAdapter to the workers (the reference's LoRA
    admin surface)."""
    ctx: AppContext = request.app[CTX]
    try:
        body = await request.json()
        name = body["lora_name"]
    except Exception as e:
        return _error(400, f"invalid request: {e}")
    path = body.get("lora_path")
    results = {}
    for w in ctx.registry.list():
        try:
            results[w.worker_id] = await w.client.load_lora_adapter(name, path=path)
        except Exception as e:
            results[w.worker_id] = {"ok": False, "error": str(e)}
    ok = bool(results) and all(r.get("ok") for r in results.values())
    return web.json_response({"ok": ok, "workers": results}, status=200 if ok else 503)


async def h_unload_lora(request: web.Request) -> web.Response:
    ctx: AppContext = request.app[CTX]
    try:
        body = await request.json()
        name = body["lora_name"]
    except Exception as e:
        return _error(400, f"invalid request: {e}")
    results = {}
    for w in ctx.registry.list():
        try:
            results[w.worker_id] = await w.client.unload_lora_adapter(name)
        except Exception as e:
            results[w.worker_id] = {"ok": False, "error": str(e)}
    ok = bool(results) and all(r.get("ok") for r in results.values())
    return web.json_response({"ok": ok, "workers": results}, status=200 if ok else 503)


async def h_list_lora(request: web.Request) -> web.Response:
    ctx: AppContext = request.app[CTX]
    results = {}
    for w in ctx.registry.list():
        try:
            results[w.worker_id] = await w.client.list_lora_adapters()
        except Exception as e:
            results[w.worker_id] = f"error: {e}"
    return web.json_response({"workers": results})


async def h_workers_list(request: web.Request) -> web.Response:
    ctx: AppContext = request.app[CTX]
    return web.json_response({"workers": [w.describe() for w in ctx.registry.list()]})


async def h_workers_add(request: web.Request) -> web.Response:
    """Register a remote worker by URL.  Registration runs as a workflow
    (connect -> model_info with retry -> register -> tokenizer; reference:
    registration rides the job queue and the workflow engine,
    server.rs:1107-1135).  ``"async": true`` enqueues it and answers 202
    with a job id to poll at /jobs/{id}; the default waits inline.  The
    transport goes by scheme: http(s):// = OpenAI-wire proxy worker, bare
    host:port = token-level gRPC."""
    ctx: AppContext = request.app[CTX]
    body = await request.json()
    url = body.get("url")
    if not url:
        return _error(400, "missing url")
    data = {
        "url": url,
        "worker_id": body.get("worker_id"),
        "model_id": body.get("model_id"),
        "api_key": body.get("api_key", ""),
        "worker_type": body.get("worker_type"),
        "bootstrap_host": body.get("bootstrap_host"),
        "bootstrap_port": body.get("bootstrap_port"),
        "skip_tokenizer": bool(body.get("skip_tokenizer")),
    }

    async def run_registration(timeout: float = 120.0) -> dict:
        iid = await ctx.workflows.start(WORKER_REGISTRATION, data)
        inst = await ctx.workflows.wait(iid, timeout=timeout)
        if inst.status.value == "running":
            # the caller timed out: leave no registration running behind
            await ctx.workflows.cancel(iid)
            inst = await ctx.workflows.wait(iid, timeout=5.0)
        if inst.status.value != "completed":
            # a failed or cancelled registration leaves nothing routable: a
            # worker the register step added goes, the client closes, and
            # connect and register are reset so a later
            # POST /workflows/{id}/resume dials again
            if data.get("registered") and data.get("worker_id"):
                ctx.registry.remove(data["worker_id"])
                data["registered"] = False
            client = data.pop("client", None)
            if client is not None:
                await client.close()
            for name in ("connect", "register"):
                if inst.steps[name].status == StepStatus.SUCCEEDED:
                    inst.steps[name].status = StepStatus.PENDING
            await ctx.workflows.store.save(inst)
        return inst.describe()

    if body.get("async"):
        job = ctx.ensure_jobs().submit(run_registration, name=f"register {url}")
        return web.json_response({"job_id": job.job_id, "status": job.status}, status=202)
    desc = await run_registration()
    if desc["status"] != "completed":
        return _error(502, f"worker registration failed: {desc.get('error')}", "worker_error")
    worker = ctx.registry.get(data["worker_id"])
    return web.json_response({"added": worker.describe(), "workflow": desc})


async def h_workers_remove(request: web.Request) -> web.Response:
    """Remove a worker, draining in-flight requests first (reference:
    ``--drain-settle-secs``, main.rs:550-556).  ``?drain=SECS`` bounds the
    wait (default 10, 0 = at once); the worker stops being selected the
    moment draining starts."""
    ctx: AppContext = request.app[CTX]
    wid = request.match_info["worker_id"]
    worker = ctx.registry.get(wid)
    if worker is None:
        return _error(404, f"no such worker {wid}")
    try:
        drain_secs = float(request.query.get("drain", "10"))
    except ValueError:
        return _error(400, "invalid drain seconds")
    if not (0.0 <= drain_secs <= 300.0):
        return _error(400, "drain seconds must be in [0, 300]")
    if worker.draining:
        return _error(409, f"worker {wid} is already draining")
    worker.draining = True
    loop = asyncio.get_running_loop()
    deadline = loop.time() + drain_secs
    while worker.load > 0 and loop.time() < deadline:
        await asyncio.sleep(0.05)
    drained = worker.load == 0
    ctx.registry.remove(wid)
    await worker.client.close()
    return web.json_response(
        {"removed": wid, "drained": drained, "in_flight_at_removal": worker.load})


# ---- per-model routers ----

async def h_routers_list(request: web.Request) -> web.Response:
    """Every model's routing state: dedicated routers, policies, workers."""
    ctx: AppContext = request.app[CTX]
    return web.json_response(ctx.routers.describe())


async def h_model_router_get(request: web.Request) -> web.Response:
    ctx: AppContext = request.app[CTX]
    return web.json_response(ctx.routers.describe_model(request.match_info["model_id"]))


async def h_model_router_set(request: web.Request) -> web.Response:
    """Configure a model's routing: ``{"policy": name, "policy_args":
    {...}, "config": {RouterConfig overrides}}``, any subset.  A 400
    changes nothing."""
    ctx: AppContext = request.app[CTX]
    model_id = request.match_info["model_id"]
    try:
        body = await request.json()
    except Exception:
        return _error(400, "invalid JSON body")
    try:
        desc = ctx.routers.configure_model(model_id, policy=body.get("policy"),
                                           policy_args=body.get("policy_args"),
                                           config=body.get("config"))
    except (ValueError, KeyError) as e:
        return _error(400, str(e))
    return web.json_response(desc)


async def h_model_router_reset(request: web.Request) -> web.Response:
    ctx: AppContext = request.app[CTX]
    model_id = request.match_info["model_id"]
    return web.json_response({"model_id": model_id,
                              "reset": ctx.routers.reset_model(model_id)})


# ---- job queue and workflow introspection ----

async def h_jobs_list(request: web.Request) -> web.Response:
    ctx: AppContext = request.app[CTX]
    jobs = ctx.jobs.list() if ctx.jobs is not None else []
    return web.json_response({"jobs": [j.describe() for j in jobs]})


async def h_job_get(request: web.Request) -> web.Response:
    ctx: AppContext = request.app[CTX]
    job = ctx.jobs.get(request.match_info["job_id"]) if ctx.jobs else None
    if job is None:
        return _error(404, f"no such job {request.match_info['job_id']}")
    return web.json_response(job.describe())


async def h_workflows_list(request: web.Request) -> web.Response:
    ctx: AppContext = request.app[CTX]
    instances = await ctx.workflows.store.list(request.query.get("type") or None)
    return web.json_response({"workflows": [i.describe() for i in instances]})


async def h_workflow_get(request: web.Request) -> web.Response:
    ctx: AppContext = request.app[CTX]
    inst = await ctx.workflows.store.load(request.match_info["instance_id"])
    if inst is None:
        return _error(404, f"no such workflow {request.match_info['instance_id']}")
    return web.json_response(inst.describe())


async def h_workflow_resume(request: web.Request) -> web.Response:
    """Resume a failed registration (or any resumable workflow) from its
    first incomplete step (reference: resume-on-failure)."""
    ctx: AppContext = request.app[CTX]
    iid = request.match_info["instance_id"]
    if not await ctx.workflows.resume(iid):
        return _error(409, f"workflow {iid} is not resumable")
    inst = await ctx.workflows.wait(iid, timeout=120.0)
    return web.json_response(inst.describe())


# ---- audio transcriptions and interactions (reference: server.rs:238-311) ----

async def h_audio_transcriptions(request: web.Request) -> web.Response:
    """OpenAI-compatible ``/v1/audio/transcriptions`` (multipart/form-data).

    ASR runs on the worker: the gateway parses the form and forwards it to
    an OpenAI-compatible audio worker (the HTTP proxy path).  Without one,
    the request fails with an explicit 501 rather than a silent wrong
    answer."""
    ctx: AppContext = request.app[CTX]
    if not (request.content_type or "").startswith("multipart/"):
        return _error(400, "expected multipart/form-data with a 'file' part")
    fields: dict = {}
    granularities: list[str] = []
    file_bytes = None
    filename = "audio.wav"
    file_ctype = "application/octet-stream"
    reader = await request.multipart()
    async for part in reader:
        if part.name == "file":
            file_bytes = await part.read(decode=False)
            filename = part.filename or filename
            file_ctype = part.headers.get("Content-Type") or file_ctype
        elif part.name in ("timestamp_granularities[]", "timestamp_granularities"):
            # repeated form parts accumulate (word and segment)
            granularities.append((await part.read(decode=False)).decode())
        elif part.name:
            fields[part.name] = (await part.read(decode=False)).decode()
    if file_bytes is None:
        return _error(400, "missing 'file' part")
    try:
        req = TranscriptionRequest.model_validate(
            {**fields, "timestamp_granularities": granularities or None})
    except Exception as e:
        return _error(400, f"invalid request: {e}")
    router = ctx.router_for(req.model or None)
    worker = router.select_proxy_worker(req.model or None)
    if worker is None:
        return _error(
            501,
            "no transcription-capable worker for this model; register an "
            "OpenAI-compatible audio worker (POST /workers with an http:// url)",
            "not_implemented",
        )
    async with ctx.semaphore:
        guard = worker.acquire()
        ok = False
        try:
            forward = dict(fields)
            if granularities:
                forward["timestamp_granularities[]"] = granularities
            data = await worker.client.post_multipart(
                "/v1/audio/transcriptions", forward, file_bytes, filename=filename,
                content_type=file_ctype)
            ok = True
        except Exception as e:
            status = getattr(e, "status", 502)
            return _error(502 if status >= 500 else status,
                          f"transcription worker error: {e}", "worker_error")
        finally:
            guard.release(success=ok)
    if isinstance(data, str):
        return web.Response(text=data, content_type="text/plain")
    return web.json_response(data)


async def h_interactions(request: web.Request) -> web.Response | web.StreamResponse:
    """The Interactions API: a stateful chat-like surface with
    ``previous_interaction_id`` chaining over the conversation storage
    (reference: interactions.rs and server.rs:238-250), served on the
    token-level path."""
    ctx: AppContext = request.app[CTX]
    try:
        req = InteractionsRequest.model_validate(await request.json())
    except Exception as e:
        return _error(400, f"invalid request: {e}")
    model_id = req.model or req.agent
    prior: list = []
    if req.previous_interaction_id:
        stored = await ctx.storage.get_response(req.previous_interaction_id)
        if stored is None:
            return _error(404, f"no interaction {req.previous_interaction_id}")
        prior = stored.metadata.get("messages", [])
    messages = req.to_messages(prior)
    gen = req.generation_config
    chat_req = ChatCompletionRequest(
        model=model_id,
        messages=messages,
        temperature=gen.temperature if gen else None,
        top_p=gen.top_p if gen else None,
        top_k=gen.top_k if gen else None,
        max_tokens=gen.max_output_tokens if gen else None,
        stop=gen.stop_sequences if gen else None,
        stream=req.stream,
        # the last stream chunk carries usage, so a streamed interaction
        # stores real token counts, as the blocking path does
        stream_options={"include_usage": True} if req.stream else None,
    )
    router = ctx.router_for(model_id)
    rid = Interaction.new_id()

    async def persist(text: str, usage: InteractionsUsage) -> None:
        if not req.store:
            return
        await ctx.storage.store_response(StoredResponse(
            id=rid,
            previous_response_id=req.previous_interaction_id,
            model=model_id or "",
            output=[text_output(text)],
            usage=usage.model_dump(),
            metadata=interaction_metadata(req, messages, text),
        ))

    def interaction(text: str, usage: InteractionsUsage) -> dict:
        return Interaction(
            id=rid, model=req.model, agent=req.agent, created=Interaction.now_iso(),
            outputs=[text_output(text)], usage=usage,
            previous_interaction_id=req.previous_interaction_id,
        ).model_dump(exclude_none=True)

    def usage_of(u) -> InteractionsUsage:
        return InteractionsUsage(total_input_tokens=u.prompt_tokens,
                                 total_output_tokens=u.completion_tokens,
                                 total_tokens=u.total_tokens)

    async with ctx.semaphore:
        if not req.stream:
            resp = await router.chat(chat_req, request_id=rid)
            text = resp.choices[0].message.content or ""
            usage = usage_of(resp.usage)
            await persist(text, usage)
            return web.json_response(interaction(text, usage))
        sse = _sse_response(request)
        await sse.prepare(request)
        parts: list[str] = []
        usage = InteractionsUsage()
        try:
            async for chunk in router.chat_stream(chat_req, request_id=rid):
                if chunk.usage is not None:
                    usage = usage_of(chunk.usage)
                delta = chunk.choices[0].delta.content if chunk.choices else None
                if delta:
                    parts.append(delta)
                    ev = {"type": "content_delta", "interaction_id": rid,
                          "delta": {"type": "text", "text": delta}}
                    await sse.write(f"data: {json.dumps(ev)}\n\n".encode())
            text = "".join(parts)
            await persist(text, usage)
            done = {"type": "interaction_complete", "interaction": interaction(text, usage)}
            await sse.write(f"data: {json.dumps(done)}\n\n".encode())
            await sse.write(b"data: [DONE]\n\n")
        except RouteError as e:
            err = {"type": "error", "error": {"message": e.message}}
            await sse.write(f"data: {json.dumps(err)}\n\n".encode())
        await sse.write_eof()
        return sse


async def _stored_interaction(ctx: AppContext, iid: str):
    """The stored interaction ``iid``, or None: a stored Responses-API object
    is not an interaction (``metadata.kind`` says which)."""
    stored = await ctx.storage.get_response(iid)
    if stored is None or stored.metadata.get("kind") != "interaction":
        return None
    return stored


async def h_interaction_get(request: web.Request) -> web.Response:
    ctx: AppContext = request.app[CTX]
    iid = request.match_info["interaction_id"]
    stored = await _stored_interaction(ctx, iid)
    if stored is None:
        return _error(404, f"no interaction {iid}")
    return web.json_response(Interaction(
        id=stored.id, model=stored.model or None, status=stored.status,
        outputs=stored.output,
        usage=InteractionsUsage(**stored.usage) if stored.usage else None,
        previous_interaction_id=stored.previous_response_id,
    ).model_dump(exclude_none=True))


async def h_interaction_delete(request: web.Request) -> web.Response:
    ctx: AppContext = request.app[CTX]
    iid = request.match_info["interaction_id"]
    if await _stored_interaction(ctx, iid) is None:
        return _error(404, f"no interaction {iid}")
    await ctx.storage.delete_response(iid)
    return web.json_response({"deleted": iid})
