"""HTTP front of the port's gateway — the port's copy of
``smg_tpu/gateway/server.py`` (aiohttp) for the text serving path: probes,
model listing, chat and text completions, ``/generate``, tokenize and
detokenize, and the operational routes (``/metrics``, ``/scheduler``,
``/get_loads``, ``/flush_cache``, ``/debug/flight/{worker_id}``,
``GET /workers``).  Each handler keeps the reference's status codes, JSON
bodies and SSE framing (``data: …`` frames, ``data: [DONE]`` last).

Not ported yet: auth, rate limiting and priority admission, OTel spans,
plugins, providers, the HTTP/PD proxy paths, embeddings, rerank, classify,
the Anthropic, responses, conversations, realtime and transcription APIs,
LoRA and profiling routes, worker registration over HTTP, jobs, workflows,
the SLO and routing debug surfaces.
"""

from __future__ import annotations

import asyncio
import json
import uuid

from aiohttp import web

from smg_tpu_torch.gateway.health import HealthMonitor
from smg_tpu_torch.gateway.kv_events import KvEventMonitor
from smg_tpu_torch.gateway.observability import Metrics
from smg_tpu_torch.gateway.router import RouteError, Router
from smg_tpu_torch.gateway.workers import WorkerRegistry
from smg_tpu_torch.policies import PolicyRegistry, RequestContext
from smg_tpu_torch.protocols.generate import GenerateMetaInfo, GenerateRequest, GenerateResponse
from smg_tpu_torch.protocols.openai import (
    ChatCompletionRequest,
    CompletionRequest,
    ErrorInfo,
    ErrorResponse,
    ModelCard,
    ModelList,
)
from smg_tpu_torch.protocols.sampling import SamplingParams
from smg_tpu_torch.tokenizer.registry import TokenizerRegistry
from smg_tpu_torch.utils import get_logger
from smg_tpu_torch.utils.logging import request_id_var
from smg_tpu_torch.version import __version__

logger = get_logger("gateway.server")

#: the application key of the ``AppContext``
CTX = web.AppKey("ctx", object)

#: routes whose requests ``track_request`` counts
INFERENCE_ROUTES = frozenset({"/v1/chat/completions", "/v1/completions", "/generate"})


class AppContext:
    """The gateway's shared state: workers, policies, tokenizers, metrics
    and the router."""

    def __init__(self, policy: str = "cache_aware", policy_kwargs: dict | None = None):
        self.registry = WorkerRegistry()
        self.policies = PolicyRegistry(default=policy, **(policy_kwargs or {}))
        self.tokenizers = TokenizerRegistry()
        self.metrics = Metrics()
        self.kv_monitor = KvEventMonitor(self.registry, self.policies)
        self.router = Router(self.registry, self.policies, self.tokenizers,
                             metrics=self.metrics)
        # the reference's --max-concurrent-requests default
        self.semaphore = asyncio.Semaphore(256)
        # unify engine metrics into the gateway registry as in-proc workers
        # register
        self._adopted_engine_metrics: set[int] = set()
        self.registry.on_change(self._maybe_adopt_worker_metrics)
        self.health_monitor = HealthMonitor(self.registry, metrics=self.metrics)

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


def _sse_response() -> web.StreamResponse:
    return web.StreamResponse(
        status=200,
        headers={
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
            "Connection": "keep-alive",
            "X-Accel-Buffering": "no",
        },
    )


@web.middleware
async def request_id_middleware(request: web.Request, handler):
    rid = request.headers.get("X-Request-Id") or f"req-{uuid.uuid4().hex[:16]}"
    request["request_id"] = rid
    token = request_id_var.set(rid)
    try:
        resp = await handler(request)
        resp.headers.setdefault("X-Request-Id", rid)
        return resp
    finally:
        request_id_var.reset(token)


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
async def metrics_middleware(request: web.Request, handler):
    """Request counters on the inference routes, with the real status."""
    if request.path not in INFERENCE_ROUTES:
        return await handler(request)
    ctx: AppContext = request.app[CTX]
    with ctx.metrics.track_request(request.path) as track:
        resp = await handler(request)
        track.status = str(getattr(resp, "status", 200))
        return resp


def build_app(ctx: AppContext) -> web.Application:
    app = web.Application(
        middlewares=[request_id_middleware, error_middleware, metrics_middleware],
        client_max_size=256 * 2**20,  # the reference's request body cap
    )
    app[CTX] = ctx

    async def _start_background(app):
        ctx.health_monitor.start()

    async def _stop_background(app):
        ctx.health_monitor.stop()

    app.on_startup.append(_start_background)
    app.on_cleanup.append(_stop_background)

    app.router.add_get("/metrics", h_metrics)
    app.router.add_get("/scheduler", h_scheduler_stats)
    app.router.add_get("/debug/flight/{worker_id}", h_debug_flight)
    app.router.add_get("/health", h_health)
    app.router.add_get("/liveness", h_health)
    app.router.add_get("/readiness", h_readiness)
    app.router.add_get("/health_generate", h_health_generate)
    app.router.add_get("/v1/models", h_models)
    app.router.add_get("/get_server_info", h_server_info)
    app.router.add_post("/v1/chat/completions", h_chat)
    app.router.add_post("/v1/completions", h_completions)
    app.router.add_post("/generate", h_generate)
    app.router.add_post("/v1/tokenize", h_tokenize)
    app.router.add_post("/v1/detokenize", h_detokenize)
    app.router.add_get("/get_loads", h_get_loads)
    app.router.add_post("/flush_cache", h_flush_cache)
    app.router.add_get("/workers", h_workers_list)
    return app


# ---- probes / info ----

async def h_metrics(request: web.Request) -> web.Response:
    ctx: AppContext = request.app[CTX]
    return web.Response(body=ctx.metrics.export(), content_type="text/plain")


async def h_scheduler_stats(request: web.Request) -> web.Response:
    """Per-worker engine step-loop stats (rolling p50/p95 step time,
    tokens/s, cache hit rate and the zero-leak audit from loads()).  The
    reference also reports its priority scheduler here, which is not
    ported."""
    ctx: AppContext = request.app[CTX]

    async def _loads(w):
        # per-worker timeout: one wedged worker must not wedge the endpoint
        try:
            return w.worker_id, await asyncio.wait_for(w.client.get_loads(), 2.0)
        except Exception as e:
            return w.worker_id, {"error": str(e)}

    results = await asyncio.gather(*(_loads(w) for w in ctx.registry.list()))
    return web.json_response({"engine": dict(results)})


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
    ids = list(ctx.registry.model_ids()) or ["default"]
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
    sse = _sse_response()
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
    async with ctx.semaphore:
        if not req.stream:
            resp = await ctx.router.chat(req, request_id=rid)
            return web.json_response(resp.model_dump(exclude_none=True))
        return await _write_sse(request, ctx.router.chat_stream(req, request_id=rid))


async def h_completions(request: web.Request) -> web.Response | web.StreamResponse:
    ctx: AppContext = request.app[CTX]
    try:
        req = CompletionRequest.model_validate(await request.json())
    except Exception as e:
        return _error(400, f"invalid request: {e}")
    rid = request["request_id"]
    async with ctx.semaphore:
        if not req.stream:
            resp = await ctx.router.completion(req, request_id=rid)
            return web.json_response(resp.model_dump(exclude_none=True))
        return await _write_sse(request, ctx.router.completion_stream(req, request_id=rid))


async def h_generate(request: web.Request) -> web.Response | web.StreamResponse:
    """SGLang-compatible native generate endpoint."""
    ctx: AppContext = request.app[CTX]
    try:
        req = GenerateRequest.model_validate(await request.json())
    except Exception as e:
        return _error(400, f"invalid request: {e}")
    rid = req.rid or request["request_id"]
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
        sse = _sse_response()
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


async def h_workers_list(request: web.Request) -> web.Response:
    ctx: AppContext = request.app[CTX]
    return web.json_response({"workers": [w.describe() for w in ctx.registry.list()]})
