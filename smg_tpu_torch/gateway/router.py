"""Token-level request pipeline — the port's copy of
``smg_tpu/gateway/router.py`` for text requests: preparation (chat template
+ tokenize) → worker selection (policy + load guard) → execution (streamed,
with retries, backoff and failover on a full queue or a failed worker) →
response processing (incremental detokenize → stop scan → OpenAI shapes).
Stop *strings* are enforced here — workers only see token ids — by aborting
the worker stream when a stop match lands.  Chat output goes through the
reasoning and tool-call parsers (``smg_tpu_torch/parsers``) or, for harmony
(gpt-oss) models, the harmony channel demux; tools render into the chat
template.  Each dispatch feeds the SLO tracker (TTFT, per-token ITL,
deadline, goodput) and opens the ``engine.*`` stage spans under the
request's span; both read host clocks at chunk arrivals only.  The policy's
routing decision rides the dispatch, and the first chunk's
``cached_tokens`` reconciles its predicted prefix match
(``metrics.route``).  Embeddings, rerank and classify go through one
guarded worker ``embed`` leg.

PD disaggregation: when the model has PREFILL and DECODE workers, a text
request runs its prompt on a prefill worker (``prefill_export``), hands the
KV over through the configured connector (``RouterConfig.kv_connector``:
``auto`` takes ``device`` when every leg keeps KV on the card, else
``transfer`` when every leg's worker pulls KV between processes and every
leg's URL names one host, else ``host``) and streams from a decode worker that imports it
(``generate_prefilled``).  A ``transfer`` offer is released on the prefill
worker once the decode leg streams, and reclaimed on any failure after the
prefill leg.  An image request bypasses PD onto a worker that
is neither DECODE nor ENCODE.

HTTP workers (``gateway/http_worker.py``, ``proxy_mode``) never serve the
token-level path: ``select_proxy_worker`` and ``select_pd_http_pair`` pick
them for the server's text-level proxy, PD over HTTP included.

DP-rank pinning: after the policy picks a worker with data-parallel
replicas (``dp_size`` > 1), ``RouterConfig.dp_rank_policy`` picks the
replica (``policies/dp.py``: ``dp_min_token`` charges the request's prompt
plus generation budget to the least-loaded rank and releases it when the
stream ends; ``dp_passthrough`` lets the worker balance, as the wire's -1
does).

The Anthropic Messages API (``anthropic_messages``,
``anthropic_messages_stream``) runs over ``chat`` and ``chat_stream``
through the shared format bridge (``gateway/openai_bridge.py``).
"""

from __future__ import annotations

import asyncio
import ipaddress
import time
import uuid
from dataclasses import dataclass, field
from urllib.parse import urlsplit

from smg_tpu_torch.engine.detokenize import IncrementalDecoder, StopStringChecker
from smg_tpu_torch.gateway.observability import current_route
from smg_tpu_torch.gateway.openai_bridge import (
    anthropic_to_openai_request,
    openai_chunks_to_anthropic_events,
    openai_to_anthropic_response,
)
from smg_tpu_torch.gateway.tracing import current_span, end_stage, stage, start_stage
from smg_tpu_torch.gateway.worker_client import (
    WorkerGenerateRequest,
    WorkerQueueFullError,
    WorkerStreamChunk,
)
from smg_tpu_torch.gateway.workers import Worker, WorkerRegistry, WorkerType
from smg_tpu_torch.policies import PolicyRegistry, RequestContext
from smg_tpu_torch.protocols.openai import (
    ChatCompletionChoice,
    ChatCompletionRequest,
    ChatCompletionResponse,
    ChatCompletionStreamChunk,
    ChatMessage,
    ChatStreamChoice,
    ChatStreamDelta,
    CompletionChoice,
    CompletionRequest,
    CompletionResponse,
    FunctionCall,
    StreamOptions,
    ToolCall,
    UsageInfo,
)
from smg_tpu_torch.protocols.sampling import SamplingParams
from smg_tpu_torch.tokenizer.registry import TokenizerRegistry
from smg_tpu_torch.utils import get_logger

logger = get_logger("gateway.router")


def _worker_host(worker: Worker) -> str:
    """The host a worker's engine runs on, as the address its client dials
    names it (``loopback`` for this gateway's own host)."""
    if worker.client.supports_device_kv:  # an engine in this process
        return "loopback"
    url = getattr(worker.client, "url", None) or worker.url
    host = urlsplit("//" + url.split("://", 1)[-1]).hostname or url
    try:
        loopback = ipaddress.ip_address(host).is_loopback
    except ValueError:
        loopback = host == "localhost"
    return "loopback" if loopback else host


class RouteError(Exception):
    def __init__(self, status: int, message: str, err_type: str = "invalid_request_error"):
        super().__init__(message)
        self.status = status
        self.message = message
        self.err_type = err_type


@dataclass
class RouterConfig:
    default_max_tokens: int = 512
    # PD KV handoff: "auto" = on the card whenever both legs support it,
    # else a device pull ("transfer") when every leg does and all run on
    # one host, else host bytes ("host" | "device" force a connector)
    kv_connector: str = "auto"
    max_retries: int = 3
    retry_backoff_base: float = 0.1
    retry_backoff_max: float = 2.0
    # parser selection: None = auto by model name; "passthrough" disables
    reasoning_parser: str | None = None
    tool_parser: str | None = None
    # harmony (gpt-oss) pipeline: None = auto-detect by model name; True/False
    # force
    harmony: bool | None = None
    # gateway --request-timeout-secs: the REMAINING budget rides each worker
    # dispatch (WorkerGenerateRequest.timeout_secs -> engine deadline), so a
    # request the HTTP layer would abandon also stops consuming engine slots
    # and pages, and a retry carries only what is left, not a fresh budget
    request_timeout_secs: float | None = None
    # DP-rank stage for dp_size>1 workers: "dp_min_token" pins each request to
    # the replica with the fewest outstanding tokens; "dp_passthrough" lets
    # the worker balance locally (reference: dp_min_token.rs:24-31)
    dp_rank_policy: str = "dp_min_token"


@dataclass
class StreamEvent:
    """One increment of a routed generation, text-level."""

    text_delta: str = ""
    token_ids: list[int] = field(default_factory=list)
    finished: bool = False
    finish_reason: str | None = None
    matched_stop: str | int | None = None
    prompt_tokens: int = 0
    output_tokens: int = 0
    cached_tokens: int = 0


class Router:
    def __init__(
        self,
        registry: WorkerRegistry,
        policies: PolicyRegistry,
        tokenizers: TokenizerRegistry,
        config: RouterConfig | None = None,
        metrics=None,
    ):
        self.registry = registry
        self.policies = policies
        self.tokenizers = tokenizers
        self.config = config or RouterConfig()
        # gateway Metrics (observability.py): token/TTFT/retry counters are
        # recorded here, at dispatch, where chunk usage originates from the
        # scheduler's admission-time accounting
        self.metrics = metrics
        from smg_tpu_torch.policies.dp import MinimumTokensPolicy, PassthroughDpPolicy

        self.dp_policy = (
            PassthroughDpPolicy()
            if self.config.dp_rank_policy == "dp_passthrough"
            else MinimumTokensPolicy()
        )
        manager = getattr(self.dp_policy, "manager", None)
        if manager is not None:
            registry.on_change(
                lambda ev, w: manager.on_worker_removed(w.worker_id)
                if ev == "removed"
                else None
            )

    # ---- worker selection ----

    def _candidate_workers(self, model_id: str | None) -> list[Worker]:
        workers = self.registry.list(model_id=model_id) if model_id else []
        if not workers:
            workers = self.registry.list()  # single-model deployments ignore name
        return workers

    def select_worker(self, ctx: RequestContext, exclude: set[str] = frozenset()) -> Worker:
        return self._select_with_decision(ctx, exclude=exclude)[0]

    def _select_with_decision(self, ctx: RequestContext, exclude: set[str] = frozenset()):
        """(worker, RouteDecision) from the model's policy: the policy's
        sink records the decision in the ring, and the dispatch holds it so
        the first chunk's ``cached_tokens`` can reconcile the predicted
        prefix match."""
        workers = [
            w for w in self._candidate_workers(ctx.model_id)
            if w.worker_id not in exclude
            # text-level proxy workers cannot serve the token-level path
            and not getattr(w.client, "proxy_mode", False)
        ]
        if not workers:
            raise RouteError(503, "no workers available", "service_unavailable")
        policy = self.policies.policy_for(ctx.model_id)
        worker, decision = policy.select(workers, ctx)
        if worker is None:
            raise RouteError(503, "no healthy workers available", "service_unavailable")
        return worker, decision

    def select_proxy_worker(self, model_id: str | None,
                            ctx: RequestContext | None = None) -> Worker | None:
        """Policy-select among HTTP proxy-mode workers for ``model_id``
        (reference: the HTTP router path, ``routers/http/router.rs``).
        None when the model has no proxy workers: the token-level path
        applies."""
        workers = [w for w in self._candidate_workers(model_id)
                   if getattr(w.client, "proxy_mode", False)]
        if not workers:
            return None
        policy = self.policies.policy_for(model_id)
        return policy.select(workers, ctx or RequestContext(model_id=model_id))[0]

    def select_pd_http_pair(self, model_id: str | None, ctx: RequestContext | None = None
                            ) -> "tuple[Worker, Worker] | None":
        """(prefill, decode) pair among HTTP proxy-mode workers: non-None
        means PD-over-HTTP dual dispatch (reference:
        ``routers/http/pd_router.rs``: bootstrap injection and a dual
        send)."""
        http = [w for w in self._candidate_workers(model_id)
                if getattr(w.client, "proxy_mode", False)]
        prefills = [w for w in http if w.worker_type is WorkerType.PREFILL]
        decodes = [w for w in http if w.worker_type is WorkerType.DECODE]
        if not prefills or not decodes:
            return None
        policy = self.policies.policy_for(model_id)
        rc = ctx or RequestContext(model_id=model_id)
        p = policy.select(prefills, rc)[0]
        d = policy.select(decodes, rc)[0]
        if p is None or d is None:
            # a pool exists but nothing in it is selectable right now
            # (circuit open, draining): fall through to the other paths
            return None
        return p, d

    def _pd_pools(self, model_id: str | None) -> tuple[list[Worker], list[Worker]]:
        """(prefill pool, decode pool): both non-empty means PD mode."""
        candidates = self._candidate_workers(model_id)
        prefill = [w for w in candidates if w.worker_type == WorkerType.PREFILL]
        decode = [w for w in candidates if w.worker_type == WorkerType.DECODE]
        return prefill, decode

    # ---- core execution with retry ----

    async def _execute(
        self,
        ctx: RequestContext,
        input_ids: list[int],
        sampling: SamplingParams,
        rid: str,
        tokenizer,
        mm: tuple | None = None,
    ):
        """Async generator of StreamEvent with retry-on-dispatch-failure;
        ``mm`` = (embeds, positions[, grids]), the image splice riding the
        dispatch."""
        if sampling.regex or sampling.ebnf:
            # malformed patterns are a client error at the front door, not
            # a retried 502 when a worker's submit raises
            from smg_tpu_torch.constrained import validate_grammar

            try:
                validate_grammar(sampling.regex, sampling.ebnf)
            except ValueError as e:
                raise RouteError(400, f"invalid grammar: {e}")
        # stop strings are enforced gateway-side; worker gets token-level params
        worker_sampling = SamplingParams(**{**sampling.__dict__, "stop": []})
        stop_checker = StopStringChecker(sampling.stop) if sampling.stop else None
        detok = (
            IncrementalDecoder(tokenizer, skip_special_tokens=sampling.skip_special_tokens)
            if tokenizer is not None
            else None
        )
        prefill_pool, decode_pool = self._pd_pools(ctx.model_id)
        # one first-dispatch clock for TTFT and the SLO record, shared by the
        # regular and the PD path and never reset on failover: a queue-full
        # retry or a backoff sleep shows up in the TTFT
        t_dispatch = time.perf_counter()
        srec = None
        if self.metrics is not None:
            span = current_span.get()
            srec = self.metrics.slo.begin(
                rid, route=current_route.get(),
                deadline_secs=self.config.request_timeout_secs,
                trace_id=span.trace_id if span is not None else None,
                t_start=t_dispatch,
            )
        exclude: set[str] = set()
        if mm is not None and prefill_pool and decode_pool:
            # the prefill export does not carry the image splice: image
            # requests take the regular path, never onto a DECODE or ENCODE
            # worker
            candidates = self._candidate_workers(ctx.model_id)
            typed = [w for w in candidates
                     if w.worker_type in (WorkerType.DECODE, WorkerType.ENCODE)]
            if len(typed) == len(candidates):
                if srec is not None:
                    srec.fail("error")
                raise RouteError(
                    503, "image input needs a prefill-capable worker; this PD "
                    "deployment has only decode/encode workers", "service_unavailable")
            exclude = {w.worker_id for w in typed}
            logger.warning("request %s has image input; bypassing PD disaggregation", rid)
        elif prefill_pool and decode_pool:
            try:
                async for ev in self._execute_pd(ctx, input_ids, worker_sampling, rid, detok,
                                                 stop_checker, prefill_pool, decode_pool,
                                                 t_dispatch=t_dispatch, srec=srec):
                    yield ev
            except (GeneratorExit, asyncio.CancelledError):
                if srec is not None:
                    srec.abandon("abort")
                raise
            except BaseException:
                # failures before the stream (no prefill worker, a failed
                # export, decode selection) land in the SLO record too; the
                # PD path's own terminal calls came first
                if srec is not None:
                    srec.fail("error")
                raise
            return
        attempts = 0
        saw_queue_full = False
        # dp-rank cost estimate: prompt + generation budget (released on exit)
        dp_cost = len(input_ids) + (worker_sampling.max_new_tokens or 0)
        # remaining-budget deadline for --request-timeout-secs: each
        # (re)dispatch hands the engine only what is left
        budget_deadline = (
            time.monotonic() + self.config.request_timeout_secs
            if self.config.request_timeout_secs
            else None
        )
        try:
            while True:
                try:
                    worker, decision = self._select_with_decision(ctx, exclude=exclude)
                except RouteError:
                    if srec is not None:
                        srec.fail("rate_limited" if saw_queue_full else "error")
                    if saw_queue_full:
                        # every candidate rejected with backpressure: the
                        # honest front-door answer is 429 retry-later, not a
                        # 5xx
                        raise RouteError(
                            429, "all workers at capacity; retry later", "rate_limit_error",
                        ) from None
                    raise
                guard = worker.acquire()
                got_first_chunk = False
                finished_cleanly = False
                dp_rank = self.dp_policy.select_dp_rank(worker, dp_cost)
                # engine-stage child spans under the request's span: prefill =
                # dispatch -> first chunk, decode = first chunk -> finish;
                # None (no cost) without a configured tracer
                prefill_span = start_stage(
                    "engine.prefill", worker_id=worker.worker_id, rid=rid,
                    prompt_tokens=len(input_ids),
                )
                decode_span = None
                detok_busy_ns = 0
                last_output_tokens = 0

                def _close_spans(error: bool) -> None:
                    nonlocal prefill_span, decode_span
                    end_stage(prefill_span, error=error)
                    end_stage(decode_span, error=error, output_tokens=last_output_tokens)
                    if not error and decode_span is not None and detok_busy_ns:
                        # detokenize work is smeared across chunks: report its
                        # cumulative cost as one trailing stage span
                        dspan = start_stage("engine.detokenize", rid=rid)
                        if dspan is not None:
                            dspan.start_ns = time.time_ns() - detok_busy_ns
                            end_stage(dspan, busy_ns=detok_busy_ns)
                    prefill_span = decode_span = None

                try:
                    wreq = WorkerGenerateRequest(
                        rid=rid, input_ids=input_ids, sampling=worker_sampling,
                        mm_embeds=mm,
                        data_parallel_rank=-1 if dp_rank is None else dp_rank,
                        timeout_secs=(max(budget_deadline - time.monotonic(), 0.0)
                                      if budget_deadline is not None else None),
                    )
                    async for chunk in worker.client.generate(wreq):
                        if not got_first_chunk and prefill_span is not None:
                            end_stage(prefill_span, cached_tokens=chunk.cached_tokens)
                            prefill_span = None
                            decode_span = start_stage(
                                "engine.decode", worker_id=worker.worker_id, rid=rid,
                            )
                        if not got_first_chunk and self.metrics is not None:
                            self.metrics.ttft.labels(route=current_route.get()).observe(
                                time.perf_counter() - t_dispatch
                            )
                            self.metrics.prompt_tokens.inc(chunk.prompt_tokens)
                            if chunk.cached_tokens:
                                self.metrics.cached_tokens.inc(chunk.cached_tokens)
                            if srec is not None:
                                srec.first_token(chunk.prompt_tokens, chunk.cached_tokens)
                            # predicted-vs-actual prefix-hit reconciliation:
                            # the engine's admission-time cached_tokens rides
                            # the first chunk
                            self.metrics.route.reconcile(
                                decision, worker.worker_id, chunk.cached_tokens)
                        if self.metrics is not None and chunk.output_tokens > last_output_tokens:
                            self.metrics.generated_tokens.inc(
                                chunk.output_tokens - last_output_tokens
                            )
                            if srec is not None:
                                srec.tokens(chunk.output_tokens - last_output_tokens)
                        got_first_chunk = True
                        last_output_tokens = chunk.output_tokens
                        if decode_span is not None:
                            dt0 = time.perf_counter_ns()
                            ev = self._chunk_to_event(chunk, detok, stop_checker)
                            detok_busy_ns += time.perf_counter_ns() - dt0
                        else:
                            ev = self._chunk_to_event(chunk, detok, stop_checker)
                        if ev is not None:
                            if srec is not None and ev.finished:
                                # terminal SLO record BEFORE the yield: a
                                # consumer that stops iterating at the final
                                # event closes this generator at the yield
                                srec.finish(ev.finish_reason)
                            yield ev
                            if ev.finished and not chunk.finished:
                                # gateway-side stop: cancel the worker stream
                                await worker.client.abort(rid)
                                finished_cleanly = True
                                guard.release(success=True)
                                return
                        if chunk.finished:
                            if srec is not None:
                                srec.finish(chunk.finish_reason)  # no-op if done
                            finished_cleanly = True
                            guard.release(success=True)
                            return
                    # stream ended without a finish marker
                    raise RuntimeError("worker stream ended unexpectedly")
                except RouteError:
                    guard.release(success=False)
                    if srec is not None:
                        srec.fail("error")
                    raise
                except (GeneratorExit, asyncio.CancelledError):
                    # client disconnected, request timed out or preempted: not
                    # a worker failure — release the load guard and stop the
                    # generation in the engine
                    guard.release(success=True)
                    if srec is not None:
                        srec.abandon("abort")
                    try:
                        await asyncio.shield(worker.client.abort(rid))
                    except Exception:
                        pass
                    raise
                except WorkerQueueFullError:
                    # admission backpressure: retry another worker WITHOUT
                    # penalizing this one's breaker (a full queue is load, not
                    # fault)
                    guard.release(success=None)
                    saw_queue_full = True
                    attempts += 1
                    exclude.add(worker.worker_id)
                    if attempts > max(self.config.max_retries, 1):
                        if srec is not None:
                            srec.fail("rate_limited")
                        raise RouteError(
                            429, "all workers at capacity; retry later", "rate_limit_error",
                        )
                    if self.metrics is not None:
                        self.metrics.retries_total.inc()
                    logger.warning("worker %s rejected %s with queue-full; trying another",
                                   worker.worker_id, rid)
                    _close_spans(error=True)
                except Exception as e:
                    guard.release(success=False)
                    attempts += 1
                    exclude.add(worker.worker_id)
                    if got_first_chunk or attempts >= self.config.max_retries:
                        logger.exception("request %s failed on %s", rid, worker.worker_id)
                        if srec is not None:
                            srec.fail("error")
                        raise RouteError(502, f"worker error: {e}", "worker_error")
                    if self.metrics is not None:
                        self.metrics.retries_total.inc()
                    backoff = min(
                        self.config.retry_backoff_base * (2 ** (attempts - 1)),
                        self.config.retry_backoff_max,
                    )
                    logger.warning("retrying %s after failure on %s (attempt %d): %s",
                                   rid, worker.worker_id, attempts, e)
                    # close the failed attempt's spans before the backoff sleep
                    # so their duration is the attempt, not attempt + idle
                    _close_spans(error=True)
                    await asyncio.sleep(backoff)
                finally:
                    _close_spans(error=not finished_cleanly)
                    if dp_rank is not None:
                        self.dp_policy.release(worker, dp_rank, dp_cost)
                    if not finished_cleanly:
                        guard.release(success=True)  # no-op if already released
        finally:
            # termination backstop of the SLO record: a cancel can land at
            # seams the loop's handlers never see (between a queue-full
            # failover and the next dispatch, inside the backoff sleep).
            # Every deliberate exit already made its terminal call, so this
            # records only otherwise untracked endings, as voluntary
            if srec is not None:
                srec.abandon("abort")

    async def _execute_pd(self, ctx, input_ids, worker_sampling, rid, detok, stop_checker,
                          prefill_pool, decode_pool, t_dispatch: float, srec=None):
        """PD-disaggregated execution: the prefill leg computes and exports
        the prompt's KV, the decode leg imports it and streams tokens.
        ``t_dispatch`` and ``srec`` are ``_execute``'s first-dispatch clock
        and SLO record.  Either leg's failure answers 502; a stop string or
        a disconnect aborts the decode leg."""
        policy = self.policies.policy_for(ctx.model_id)
        p_worker = policy.select(prefill_pool, ctx)[0]
        if p_worker is None:
            raise RouteError(503, "no healthy prefill workers", "service_unavailable")
        # a capability check only: the decode worker is chosen after the
        # prefill, so load changes during a long prefill get a fresh choice
        connector = self.config.kv_connector
        if connector == "auto":
            if (p_worker.client.supports_device_kv and decode_pool
                    and all(w.client.supports_device_kv for w in decode_pool)):
                connector = "device"  # one process, one card
            else:
                # worker processes: a device pull when every leg runs a pull
                # server on one host (CUDA IPC and shared memory reach no
                # further), else host bytes
                connector = "host"
                if len({_worker_host(w) for w in [p_worker, *decode_pool]}) == 1:
                    try:
                        infos = [await self.worker_info(p_worker)] + [
                            await self.worker_info(w) for w in decode_pool]
                        if all(i.get("supports_kv_transfer") for i in infos):
                            connector = "transfer"
                    except Exception:
                        pass

        p_guard = p_worker.acquire()
        p_span = start_stage("engine.prefill", worker_id=p_worker.worker_id, rid=rid,
                             prompt_tokens=len(input_ids), pd_leg="prefill")
        try:
            export = await p_worker.client.prefill_export(input_ids, worker_sampling,
                                                          connector=connector)
            p_guard.release(success=True)
            end_stage(p_span)
        except Exception as e:
            p_guard.release(success=False)
            end_stage(p_span, error=True)
            raise RouteError(502, f"prefill worker error: {e}", "worker_error")

        # transfer: the prefill worker's offer holds its KV until the decode
        # leg pulls it; signal the outcome, so success stops the tracking and
        # any failure from here on (decode-worker selection included)
        # reclaims the offer (engine/kv_transfer.py)
        offer_uuid = (export["k"].get("transfer_uuid")
                      if export.get("connector") == "transfer" else None)
        signalled = False

        async def _signal(consumed: bool):
            nonlocal signalled
            if offer_uuid is None or signalled:
                return
            signalled = True
            try:
                await asyncio.shield(p_worker.client.release_kv_offer(offer_uuid, consumed))
            except Exception:
                logger.warning("kv offer %s signal failed", offer_uuid)

        try:
            d_worker, d_decision = policy.select(decode_pool, ctx)
            if d_worker is None:
                raise RouteError(503, "no healthy decode workers", "service_unavailable")
            if export.get("connector") == "device" and not d_worker.client.supports_device_kv:
                # a host-only decode worker joined mid-flight: the payload
                # comes to the host, off the event loop (tens of MB)
                from smg_tpu_torch.engine.kv_connector import to_host

                loop = asyncio.get_running_loop()
                export["k"], export["v"] = await loop.run_in_executor(
                    None, lambda: (to_host(export["k"]), to_host(export["v"])))
                export["connector"] = "host"
        except BaseException:
            await _signal(consumed=False)
            raise
        d_guard = d_worker.acquire()
        finished_cleanly = False
        got_first_chunk = False
        last_output_tokens = 0
        d_span = start_stage("engine.decode", worker_id=d_worker.worker_id, rid=rid,
                             pd_leg="decode")
        try:
            wreq = WorkerGenerateRequest(rid=rid, input_ids=input_ids, sampling=worker_sampling)
            async for chunk in d_worker.client.generate_prefilled(
                    wreq, export["first_token"], export["k"], export["v"]):
                await _signal(consumed=True)  # the decode leg is live: KV pulled
                if not got_first_chunk and self.metrics is not None:
                    self.metrics.ttft.labels(route=current_route.get()).observe(
                        time.perf_counter() - t_dispatch)
                    self.metrics.prompt_tokens.inc(chunk.prompt_tokens)
                    if chunk.cached_tokens:
                        self.metrics.cached_tokens.inc(chunk.cached_tokens)
                    if srec is not None:
                        srec.first_token(chunk.prompt_tokens, chunk.cached_tokens)
                    # the decode leg imports the prompt without its prefix
                    # cache, so it reports 0 cached tokens: a cache-aware
                    # prediction lands as "over", as it should for PD
                    self.metrics.route.reconcile(d_decision, d_worker.worker_id,
                                                 chunk.cached_tokens)
                got_first_chunk = True
                if self.metrics is not None and chunk.output_tokens > last_output_tokens:
                    self.metrics.generated_tokens.inc(chunk.output_tokens - last_output_tokens)
                    if srec is not None:
                        srec.tokens(chunk.output_tokens - last_output_tokens)
                last_output_tokens = chunk.output_tokens
                ev = self._chunk_to_event(chunk, detok, stop_checker)
                if ev is not None:
                    if srec is not None and ev.finished:
                        srec.finish(ev.finish_reason)
                    yield ev
                    if ev.finished and not chunk.finished:
                        await d_worker.client.abort(rid)
                        finished_cleanly = True
                        d_guard.release(success=True)
                        return
                if chunk.finished:
                    if srec is not None:
                        srec.finish(chunk.finish_reason)
                    finished_cleanly = True
                    d_guard.release(success=True)
                    return
            raise RuntimeError("decode stream ended unexpectedly")
        except (GeneratorExit, asyncio.CancelledError):
            d_guard.release(success=True)
            if srec is not None:
                srec.abandon("abort")
            try:
                await asyncio.shield(d_worker.client.abort(rid))
            except Exception:
                pass
            raise
        except RouteError:
            d_guard.release(success=False)
            if srec is not None:
                srec.fail("error")
            raise
        except Exception as e:
            d_guard.release(success=False)
            if srec is not None:
                srec.fail("error")
            raise RouteError(502, f"decode worker error: {e}", "worker_error")
        finally:
            end_stage(d_span, error=not finished_cleanly, output_tokens=last_output_tokens)
            # no chunk ever arrived: the offer was never pulled — reclaim
            await _signal(consumed=False)
            if not finished_cleanly:
                d_guard.release(success=True)

    def _chunk_to_event(
        self,
        chunk: WorkerStreamChunk,
        detok: IncrementalDecoder | None,
        stop_checker: StopStringChecker | None,
    ) -> StreamEvent | None:
        ev = StreamEvent(
            token_ids=list(chunk.token_ids),
            finished=chunk.finished,
            finish_reason=chunk.finish_reason,
            matched_stop=chunk.matched_stop,
            prompt_tokens=chunk.prompt_tokens,
            output_tokens=chunk.output_tokens,
            cached_tokens=chunk.cached_tokens,
        )
        if detok is None:
            return ev
        text = detok.put(chunk.token_ids) if chunk.token_ids else ""
        if chunk.finished:
            text += detok.flush()
        if stop_checker is not None:
            emitted, stopped = stop_checker.feed(text)
            if stopped and not chunk.finished:
                ev.finished = True
                ev.finish_reason = "stop"
                ev.matched_stop = stop_checker.matched
            elif chunk.finished:
                emitted += stop_checker.flush()
            ev.text_delta = emitted
        else:
            ev.text_delta = text
        return ev

    # ---- chat completions ----

    def _is_harmony(self, model: str | None) -> bool:
        if self.config.harmony is not None:
            return self.config.harmony
        from smg_tpu_torch.gateway.harmony import is_harmony_model

        return is_harmony_model(model)

    async def worker_info(self, worker: Worker) -> dict:
        """Worker model info, cached after the first fetch (static per
        process: model identity, vision caps, page size)."""
        info = getattr(worker, "_model_info", None)
        if info is None:
            info = await worker.client.get_model_info()
            worker._model_info = info
        return info

    async def _vision_worker(self, model_id: str | None) -> tuple[Worker, dict]:
        """Pick a worker for the encode leg (the reference's EncodeStage):
        dedicated ENCODE workers first, then any vision-capable worker."""
        candidates = [w for w in self._candidate_workers(model_id)
                      if not getattr(w.client, "proxy_mode", False)]
        encode_pool = [w for w in candidates if w.worker_type == WorkerType.ENCODE]
        saw_vision_capable = saw_unknown = False
        # an unavailable encode pool must not mask capable regular workers
        for w in encode_pool + [w for w in candidates if w not in encode_pool]:
            try:
                info = await self.worker_info(w)
            except Exception:  # noqa: BLE001 — unreachable: capability undetermined
                saw_unknown = True
                continue
            if not info.get("supports_vision"):
                continue
            saw_vision_capable = True
            if w.is_available():
                return w, info
        if saw_vision_capable or saw_unknown:
            # the capability exists (or cannot be ruled out): availability is
            # the transient problem, a 503 and not a permanent-looking 400
            raise RouteError(503, "no vision-capable workers available",
                             "service_unavailable")
        raise RouteError(400, f"model {model_id or 'default'} does not support image input")

    async def prepare_chat(self, req: ChatCompletionRequest):
        """Chat preparation, the multimodal encode leg included, inside one
        ``engine.tokenize`` stage span.  Returns (tokenizer, prompt_text,
        input_ids, sampling, mm): ``mm`` is None for a text-only request,
        else (embeds [M, E] f32, positions [M][, grids])."""
        with stage("engine.tokenize"):
            return await self._prepare_chat_any(req)

    async def _prepare_chat_any(self, req: ChatCompletionRequest):
        """The image pipeline (the reference's EncodeStage): image content
        parts -> decode -> the worker's processor (resize, normalize,
        patchify) -> the worker's encode -> the placeholder token expanded
        by each image's token count -> splice positions."""
        import numpy as np

        from smg_tpu_torch.multimodal.ingest import (
            ImageIngestError,
            expand_image_placeholders,
            extract_image_parts,
            fetch_image,
            flatten_content,
        )
        from smg_tpu_torch.multimodal.pixel_cache import (
            get_pixel_cache,
            image_source_hash,
            processor_fingerprint,
        )
        from smg_tpu_torch.multimodal.processor import processor_for_worker

        messages = [m.model_dump(exclude_none=True) for m in req.messages]
        parts = extract_image_parts(messages)
        if not parts:
            return (*self._prepare_chat(req), None)
        if self._is_harmony(req.model):
            # gpt-oss is text-only (the reference's builder rejects media)
            raise RouteError(400, "harmony (gpt-oss) models accept text input only")
        tokenizer = self.tokenizers.get(req.model or None)
        if tokenizer is None:
            raise RouteError(500, "no tokenizer registered for gateway-side processing")
        worker, info = await self._vision_worker(req.model or None)
        image_token_id = int(info.get("image_token_id") or 0)
        placeholder = tokenizer.decode([image_token_id], skip_special_tokens=False)
        proc = processor_for_worker(
            req.model or info.get("model_id") or "",
            patch_size=info.get("vision_patch_size"),
            merge_size=info.get("vision_merge_size"), device=info.get("device"))
        loop = asyncio.get_running_loop()
        pixel_cache = get_pixel_cache()
        proc_fp = processor_fingerprint(proc) if pixel_cache is not None else ""

        async def encode(pv, grid, n_tok):
            e = await worker.client.encode_image(pv, grid)
            if e.shape[0] != n_tok:
                raise RouteError(502, f"encode returned {e.shape[0]} embeddings for "
                                      f"{n_tok} placeholder tokens", "worker_error")
            return np.asarray(e, np.float32)

        async def one_image(part, session):
            cache_key = None
            if pixel_cache is not None:
                cache_key = (image_source_hash(part), proc_fp)
                hit = pixel_cache.get(cache_key)
                if hit is not None:
                    # fetch, decode and preprocessing skipped; the encode
                    # still runs (embeddings are worker-side state)
                    pv, grid, n_tok, llm_grid = hit
                    return await encode(pv, grid, n_tok), n_tok, llm_grid
            img = await fetch_image(part, http_session=session)
            # preprocessing is device work: keep it off the event loop
            pimg = await loop.run_in_executor(None, proc.process, img)
            if cache_key is not None:
                pixel_cache.put(cache_key, (
                    pimg.pixel_values.cpu().numpy(), pimg.grid,
                    pimg.num_placeholder_tokens, pimg.llm_grid))
            e = await encode(pimg.pixel_values, pimg.grid, pimg.num_placeholder_tokens)
            # the processor owns the geometry: llm_grid is set only when the
            # placeholder run is a planar grid (M-RoPE input)
            return e, pimg.num_placeholder_tokens, pimg.llm_grid

        session = None
        try:
            needs_http = any(
                str((p.get("image_url") or {}).get("url", "")
                    if isinstance(p.get("image_url"), dict) else p.get("image_url") or "")
                .startswith(("http://", "https://"))
                or (p.get("source") or {}).get("type") == "url"
                for p in parts)
            if needs_http:
                import aiohttp

                session = aiohttp.ClientSession()  # one pool for all fetches
            # fetch -> preprocess -> encode run concurrently per image, in
            # prompt order; on the first failure the siblings are cancelled
            # and drained, so nothing touches the session after it closes
            tasks = [asyncio.ensure_future(one_image(p, session)) for p in parts]
            try:
                results = await asyncio.gather(*tasks)
            except BaseException:
                for t in tasks:
                    t.cancel()
                await asyncio.gather(*tasks, return_exceptions=True)
                raise
        except ImageIngestError as e:
            raise RouteError(400, str(e))
        except RouteError:
            raise
        except Exception as e:  # noqa: BLE001 — the encode leg's boundary
            logger.exception("image encode failed")
            raise RouteError(502, f"image encode failed: {e}", "worker_error")
        finally:
            if session is not None:
                await session.close()
        embeds = [e for e, _, _ in results]
        counts = [c for _, c, _ in results]
        grids = [g for _, _, g in results]

        flat = flatten_content(messages, placeholder)
        tools = [t.model_dump(exclude_none=True) for t in req.tools] if req.tools else None
        try:
            prompt_text = tokenizer.apply_chat_template(flat, add_generation_prompt=True,
                                                        tools=tools)
        except Exception as e:
            raise RouteError(400, f"chat template failed: {e}")
        # deliberately uncached encode: image prompts are dominated by unique
        # image payloads, not repeated text
        input_ids = tokenizer.encode(prompt_text)
        try:
            input_ids, positions = expand_image_placeholders(input_ids, image_token_id, counts)
        except ImageIngestError as e:
            raise RouteError(400, str(e))
        sampling = req.to_sampling_params(self.config.default_max_tokens)
        mm = (np.concatenate(embeds, axis=0), np.asarray(positions, np.int64))
        if all(g is not None for g in grids):
            # merged grids ride along for M-RoPE-capable workers
            mm = mm + (grids,)
        return tokenizer, prompt_text, input_ids, sampling, mm

    def _prepare_chat(self, req: ChatCompletionRequest):
        tokenizer = self.tokenizers.get(req.model or None)
        if tokenizer is None:
            raise RouteError(500, "no tokenizer registered for gateway-side processing")
        messages = [m.model_dump(exclude_none=True) for m in req.messages]
        tools = [t.model_dump(exclude_none=True) for t in req.tools] if req.tools else None
        if self._is_harmony(req.model):
            # harmony models bypass the chat template: the gateway renders the
            # channel-structured frame format itself and stops generation at
            # end-of-response / end-of-tool-call markers
            from smg_tpu_torch.gateway.harmony import HARMONY_STOPS, render_harmony_prompt

            prompt_text = render_harmony_prompt(
                messages, tools=tools,
                reasoning_effort=getattr(req, "reasoning_effort", None) or "medium",
            )
            input_ids = self.tokenizers.encode_cached(req.model or None, prompt_text)
            sampling = req.to_sampling_params(self.config.default_max_tokens)
            stops = list(sampling.stop or [])
            sampling.stop = stops + [s for s in HARMONY_STOPS if s not in stops]
            # the channel markers are special tokens on real gpt-oss
            # tokenizers: skip_special_tokens would strip them before the
            # demux and the gateway-side stop checker see them
            sampling.skip_special_tokens = False
            return tokenizer, prompt_text, input_ids, sampling
        try:
            prompt_text = tokenizer.apply_chat_template(
                messages, add_generation_prompt=True, tools=tools)
        except Exception as e:
            raise RouteError(400, f"chat template failed: {e}")
        input_ids = self.tokenizers.encode_cached(req.model or None, prompt_text)
        sampling = req.to_sampling_params(self.config.default_max_tokens)
        return tokenizer, prompt_text, input_ids, sampling

    async def chat(self, req: ChatCompletionRequest, request_id: str | None = None):
        tokenizer, prompt_text, input_ids, sampling, mm = await self.prepare_chat(req)
        rid = request_id or f"chatcmpl-{uuid.uuid4().hex[:24]}"
        ctx = RequestContext(
            text=prompt_text, token_ids=input_ids,
            model_id=req.model or None, request_id=rid,
        )

        async def run_one(choice_idx: int) -> tuple[ChatCompletionChoice, StreamEvent]:
            text_parts: list[str] = []
            last: StreamEvent | None = None
            sub_rid = rid if sampling.n == 1 else f"{rid}-{choice_idx}"
            one_sampling = SamplingParams(**{**sampling.__dict__, "n": 1})
            async for ev in self._execute(ctx, input_ids, one_sampling, sub_rid, tokenizer,
                                          mm=mm):
                text_parts.append(ev.text_delta)
                last = ev
            if last is None:
                raise RuntimeError(f"worker stream for {sub_rid} ended without output")
            text = "".join(text_parts)

            reasoning_content = None
            tool_calls = None
            finish = last.finish_reason or "stop"
            if self._is_harmony(req.model):
                # always demux: raw channel markup must never reach a client
                from smg_tpu_torch.gateway.harmony import HarmonyStreamingProcessor

                text, reasoning, calls = HarmonyStreamingProcessor().parse_full(text)
                reasoning_content = (reasoning or None) if req.separate_reasoning else None
                if calls:
                    tool_calls = [
                        ToolCall(id=c["id"], index=i,
                                 function=FunctionCall(name=c["name"],
                                                       arguments=c["arguments"]))
                        for i, c in enumerate(calls)
                    ]
                    finish = "tool_calls"
            else:
                if req.separate_reasoning:
                    from smg_tpu_torch.parsers import get_reasoning_parser

                    rp = get_reasoning_parser(self.config.reasoning_parser or req.model)
                    text, reasoning = rp.parse_full(text)
                    reasoning_content = reasoning or None
                if req.tools:
                    from smg_tpu_torch.parsers import get_tool_parser

                    tp = get_tool_parser(self.config.tool_parser or req.model)
                    text, parsed = tp.parse_full(text)
                    if parsed:
                        tool_calls = [
                            ToolCall(id=c.id, index=c.index,
                                     function=FunctionCall(name=c.name, arguments=c.arguments))
                            for c in parsed
                        ]
                        finish = "tool_calls"
            choice = ChatCompletionChoice(
                index=choice_idx,
                message=ChatMessage(
                    role="assistant",
                    content=text or (None if tool_calls else ""),
                    tool_calls=tool_calls,
                    reasoning_content=reasoning_content,
                ),
                finish_reason=finish,
            )
            return choice, last

        # n > 1 fan-out; the first failure cancels the siblings
        try:
            async with asyncio.TaskGroup() as tg:
                tasks = [tg.create_task(run_one(i)) for i in range(sampling.n)]
        except BaseExceptionGroup as eg:
            route = next((e for e in eg.exceptions if isinstance(e, RouteError)), None)
            raise route if route is not None else eg.exceptions[0]
        # every task is done after the TaskGroup exits: result() does not wait
        # smglint: disable-next=ASYNCBLOCK tasks are done after TaskGroup exit
        results = [t.result() for t in tasks]
        choices = [c for c, _ in results]
        usage = UsageInfo(
            prompt_tokens=sum(last.prompt_tokens for _, last in results),
            completion_tokens=sum(last.output_tokens for _, last in results),
        )
        usage.total_tokens = usage.prompt_tokens + usage.completion_tokens
        cached = sum(last.cached_tokens for _, last in results)
        if cached:
            usage.prompt_tokens_details = {"cached_tokens": cached}
        return ChatCompletionResponse(
            id=rid, model=req.model or "default", choices=choices, usage=usage
        )

    async def chat_stream(self, req: ChatCompletionRequest, request_id: str | None = None):
        """Async generator of ChatCompletionStreamChunk."""
        tokenizer, prompt_text, input_ids, sampling, mm = await self.prepare_chat(req)
        rid = request_id or f"chatcmpl-{uuid.uuid4().hex[:24]}"
        created = int(time.time())
        ctx = RequestContext(
            text=prompt_text, token_ids=input_ids,
            model_id=req.model or None, request_id=rid,
        )
        model = req.model or "default"
        usage_totals = {"prompt": 0, "completion": 0, "cached": 0}

        async def stream_choice(idx: int, out_q: asyncio.Queue):
            sub_rid = rid if sampling.n == 1 else f"{rid}-{idx}"
            one_sampling = SamplingParams(**{**sampling.__dict__, "n": 1})
            first = True
            rp = tp = hp = None
            if self._is_harmony(req.model):
                from smg_tpu_torch.gateway.harmony import HarmonyStreamingProcessor

                hp = HarmonyStreamingProcessor()
            else:
                if req.separate_reasoning:
                    from smg_tpu_torch.parsers import get_reasoning_parser

                    rp = get_reasoning_parser(self.config.reasoning_parser or req.model)
                if req.tools:
                    from smg_tpu_torch.parsers import get_tool_parser

                    tp = get_tool_parser(self.config.tool_parser or req.model)
            saw_tool_calls = False

            def make_delta(text: str, flush: bool = False):
                nonlocal saw_tool_calls
                reasoning = None
                calls = None
                if hp is not None:
                    # harmony channel demux: analysis -> reasoning deltas,
                    # commentary tool frames -> incremental argument deltas
                    d = hp.feed(text)
                    if flush:
                        df = hp.flush()
                        d.analysis += df.analysis
                        d.final += df.final
                        d.tool_deltas.extend(df.tool_deltas)
                    text = d.final
                    reasoning = (d.analysis or None) if req.separate_reasoning else None
                    if d.tool_deltas:
                        saw_tool_calls = True
                        calls = [
                            ToolCall(id=td.id, index=td.index,
                                     function=FunctionCall(name=td.name,
                                                           arguments=td.arguments))
                            for td in d.tool_deltas
                        ]
                    return text, reasoning, calls
                if rp is not None:
                    d = rp.feed(text)
                    if flush:
                        df = rp.flush()
                        d.content += df.content
                        d.reasoning += df.reasoning
                    text = d.content
                    reasoning = d.reasoning or None
                if tp is not None:
                    d2 = tp.feed(text)
                    if flush:
                        df2 = tp.flush()
                        d2.normal_text += df2.normal_text
                        d2.calls.extend(df2.calls)
                    text = d2.normal_text
                    if d2.calls:
                        saw_tool_calls = True
                        calls = [
                            ToolCall(id=c.id, index=c.index,
                                     function=FunctionCall(name=c.name, arguments=c.arguments))
                            for c in d2.calls
                        ]
                return text, reasoning, calls

            try:
                async for ev in self._execute(ctx, input_ids, one_sampling, sub_rid, tokenizer,
                                              mm=mm):
                    text, reasoning, calls = make_delta(ev.text_delta, flush=ev.finished)
                    delta = ChatStreamDelta(
                        role="assistant" if first else None,
                        content=text if text else ("" if first else None),
                        reasoning_content=reasoning,
                        tool_calls=calls,
                    )
                    first = False
                    finish = None
                    if ev.finished:
                        finish = "tool_calls" if saw_tool_calls else (ev.finish_reason or "stop")
                    if text or reasoning or calls or finish or delta.role:
                        await out_q.put(
                            ChatCompletionStreamChunk(
                                id=rid, created=created, model=model,
                                choices=[ChatStreamChoice(index=idx, delta=delta,
                                                          finish_reason=finish)],
                            )
                        )
                    if ev.finished:
                        usage_totals["prompt"] += ev.prompt_tokens
                        usage_totals["completion"] += ev.output_tokens
                        usage_totals["cached"] += ev.cached_tokens
                await out_q.put(None)  # clean end-of-choice sentinel
            except (GeneratorExit, asyncio.CancelledError):
                raise
            except BaseException as e:  # propagate worker errors to the consumer
                await out_q.put(e)

        q: asyncio.Queue = asyncio.Queue()
        tasks = [asyncio.create_task(stream_choice(i, q)) for i in range(sampling.n)]
        done_streams = 0
        try:
            while done_streams < sampling.n:
                item = await q.get()
                if item is None:
                    done_streams += 1
                    continue
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            for t in tasks:
                if not t.done():
                    t.cancel()
            for t in tasks:
                try:
                    await t
                except BaseException:
                    pass
        if req.stream_options and req.stream_options.include_usage:
            usage = UsageInfo(
                prompt_tokens=usage_totals["prompt"],
                completion_tokens=usage_totals["completion"],
                total_tokens=usage_totals["prompt"] + usage_totals["completion"],
            )
            if usage_totals["cached"]:
                usage.prompt_tokens_details = {"cached_tokens": usage_totals["cached"]}
            yield ChatCompletionStreamChunk(
                id=rid, created=created, model=model, choices=[], usage=usage
            )

    # ---- embeddings ----

    async def embeddings(self, req, request_id: str | None = None):
        from smg_tpu_torch.protocols.openai import EmbeddingData, EmbeddingResponse, UsageInfo

        model_id = req.model or None
        inputs = req.input
        batches: list[list[int]] = []
        if isinstance(inputs, str):
            batches.append(self.tokenizers.encode_cached(model_id, inputs))
        elif isinstance(inputs, list) and inputs and isinstance(inputs[0], int):
            batches.append(list(inputs))
        elif isinstance(inputs, list) and inputs and isinstance(inputs[0], str):
            batches = [self.tokenizers.encode_cached(model_id, s) for s in inputs]
        elif isinstance(inputs, list) and inputs and isinstance(inputs[0], list):
            batches = [list(x) for x in inputs]
        else:
            raise RouteError(400, "invalid embeddings input")

        vecs, total_tokens = await self._embed_batches(model_id, batches, request_id)
        data = [EmbeddingData(index=i, embedding=v) for i, v in enumerate(vecs)]
        usage = UsageInfo(prompt_tokens=total_tokens, total_tokens=total_tokens)
        return EmbeddingResponse(data=data, model=req.model or "default", usage=usage)

    async def _embed_batches(self, model_id, batches: list, request_id):
        """Single guarded worker embed leg (shared by embeddings, rerank,
        classify).  Returns (vectors, total_tokens)."""
        ctx = RequestContext(model_id=model_id, request_id=request_id)
        worker = self.select_worker(ctx)
        guard = worker.acquire()
        try:
            vecs = await worker.client.embed(batches)
            guard.release(success=True)
        except Exception as e:
            guard.release(success=False)
            raise RouteError(502, f"worker embed error: {e}", "worker_error")
        return vecs, sum(len(b) for b in batches)

    async def _embed_texts(self, model_id: str | None, texts: list[str], request_id):
        batches = [self.tokenizers.encode_cached(model_id, t) for t in texts]
        return await self._embed_batches(model_id, batches, request_id)

    @staticmethod
    def _unit_rows(vecs) -> "object":
        """Normalize embedding rows once; cosine becomes a plain dot."""
        import numpy as np

        arr = np.asarray(vecs, np.float64)
        norms = np.linalg.norm(arr, axis=-1, keepdims=True)
        return arr / np.where(norms == 0, 1.0, norms)

    async def rerank(self, req, request_id: str | None = None):
        """Query-document relevance scoring via the embedding path
        (reference: /v1/rerank, server.rs:188-221)."""
        from smg_tpu_torch.protocols.rerank import RerankResponse, RerankResult

        if not req.documents:
            raise RouteError(400, "documents must be non-empty")
        vecs, total = await self._embed_texts(
            req.model or None, [req.query] + req.documents, request_id
        )
        unit = self._unit_rows(vecs)
        scores = unit[1:] @ unit[0]
        results = [
            RerankResult(
                index=i,
                relevance_score=float(s),
                document=req.documents[i] if req.return_documents else None,
            )
            for i, s in enumerate(scores)
        ]
        results.sort(key=lambda r: r.relevance_score, reverse=True)
        if req.top_n is not None:
            results = results[: max(req.top_n, 0)]
        return RerankResponse(
            model=req.model or "default",
            results=results,
            usage=UsageInfo(prompt_tokens=total, total_tokens=total),
        )

    async def classify(self, req, request_id: str | None = None):
        """Zero-shot classification over caller labels: softmax of
        input-label embedding similarities (reference: /v1/classify,
        server.rs:287-300)."""
        import numpy as np

        from smg_tpu_torch.protocols.rerank import ClassifyData, ClassifyResponse

        if not req.labels:
            raise RouteError(400, "labels must be non-empty")
        if len(set(req.labels)) != len(req.labels):
            raise RouteError(400, "labels must be unique")
        inputs = [req.input] if isinstance(req.input, str) else list(req.input)
        if not inputs:
            raise RouteError(400, "input must be non-empty")
        vecs, total = await self._embed_texts(
            req.model or None, inputs + req.labels, request_id
        )
        unit = self._unit_rows(vecs)
        in_vecs, label_vecs = unit[: len(inputs)], unit[len(inputs) :]
        sims = in_vecs @ label_vecs.T  # [I, L]
        exps = np.exp(sims - sims.max(axis=-1, keepdims=True))
        probs = exps / exps.sum(axis=-1, keepdims=True)
        data = []
        for i, row in enumerate(probs):
            best = int(np.argmax(row))
            data.append(ClassifyData(
                index=i,
                label=req.labels[best],
                scores={lab: float(p) for lab, p in zip(req.labels, row)},
            ))
        return ClassifyResponse(
            model=req.model or "default",
            data=data,
            usage=UsageInfo(prompt_tokens=total, total_tokens=total),
        )

    # ---- Anthropic Messages ----

    async def anthropic_messages(self, req, request_id: str | None = None):
        """Non-streaming Anthropic /v1/messages (reference: anthropic
        router).  Format translation lives in ``gateway/openai_bridge.py``
        — shared with the 3rd-party provider path."""
        chat_req = anthropic_to_openai_request(req)
        resp = await self.chat(chat_req, request_id=request_id)
        return openai_to_anthropic_response(resp, req.model)

    async def anthropic_messages_stream(self, req, request_id: str | None = None):
        """Anthropic streaming events via the shared bridge grammar:
        message_start, content_block_start, content_block_delta
        (text_delta | input_json_delta), content_block_stop, message_delta,
        message_stop."""
        chat_req = anthropic_to_openai_request(req)
        chat_req.stream = True
        chat_req.stream_options = StreamOptions(include_usage=True)
        chunks = self.chat_stream(chat_req, request_id=request_id)
        async for name, payload in openai_chunks_to_anthropic_events(chunks, req.model):
            yield name, payload

    # ---- completions ----

    def _prepare_completion(self, req: CompletionRequest):
        with stage("engine.tokenize"):
            return self._prepare_completion_inner(req)

    def _prepare_completion_inner(self, req: CompletionRequest):
        tokenizer = self.tokenizers.get(req.model or None)
        sampling = req.to_sampling_params(self.config.default_max_tokens)
        prompts: list[tuple[str | None, list[int]]] = []
        p = req.prompt
        if isinstance(p, str):
            prompts.append((p, self.tokenizers.encode_cached(req.model or None, p)))
        elif isinstance(p, list) and p and isinstance(p[0], int):
            prompts.append((None, list(p)))
        elif isinstance(p, list) and p and isinstance(p[0], str):
            for s in p:
                prompts.append((s, self.tokenizers.encode_cached(req.model or None, s)))
        elif isinstance(p, list) and p and isinstance(p[0], list):
            for ids in p:
                prompts.append((None, list(ids)))
        else:
            raise RouteError(400, "invalid prompt")
        return tokenizer, prompts, sampling

    async def completion(self, req: CompletionRequest, request_id: str | None = None):
        tokenizer, prompts, sampling = self._prepare_completion(req)
        rid = request_id or f"cmpl-{uuid.uuid4().hex[:24]}"
        choices: list[CompletionChoice] = []
        usage = UsageInfo()
        idx = 0
        for text_prompt, input_ids in prompts:
            ctx = RequestContext(
                text=text_prompt, token_ids=input_ids,
                model_id=req.model or None, request_id=rid,
            )
            for _ in range(sampling.n):
                parts: list[str] = []
                last: StreamEvent | None = None
                one = SamplingParams(**{**sampling.__dict__, "n": 1})
                async for ev in self._execute(ctx, input_ids, one, f"{rid}-{idx}", tokenizer):
                    parts.append(ev.text_delta)
                    last = ev
                text = "".join(parts)
                if req.echo and text_prompt is not None:
                    text = text_prompt + text
                choices.append(
                    CompletionChoice(index=idx, text=text,
                                     finish_reason=last.finish_reason or "stop")
                )
                usage.prompt_tokens += last.prompt_tokens
                usage.completion_tokens += last.output_tokens
                idx += 1
        usage.total_tokens = usage.prompt_tokens + usage.completion_tokens
        return CompletionResponse(id=rid, model=req.model or "default", choices=choices,
                                  usage=usage)

    async def completion_stream(self, req: CompletionRequest, request_id: str | None = None):
        tokenizer, prompts, sampling = self._prepare_completion(req)
        rid = request_id or f"cmpl-{uuid.uuid4().hex[:24]}"
        created = int(time.time())
        model = req.model or "default"
        idx = 0
        totals = {"prompt": 0, "completion": 0}
        for text_prompt, input_ids in prompts:
            ctx = RequestContext(
                text=text_prompt, token_ids=input_ids,
                model_id=req.model or None, request_id=rid,
            )
            for _ in range(sampling.n):
                one = SamplingParams(**{**sampling.__dict__, "n": 1})
                if req.echo and text_prompt is not None:
                    yield CompletionResponse(
                        id=rid, created=created, model=model,
                        choices=[CompletionChoice(index=idx, text=text_prompt)],
                        usage=None,
                    )
                async for ev in self._execute(ctx, input_ids, one, f"{rid}-{idx}", tokenizer):
                    finish = ev.finish_reason if ev.finished else None
                    if ev.text_delta or finish:
                        yield CompletionResponse(
                            id=rid, created=created, model=model,
                            choices=[CompletionChoice(index=idx, text=ev.text_delta,
                                                      finish_reason=finish)],
                            usage=None,
                        )
                    if ev.finished:
                        totals["prompt"] += ev.prompt_tokens
                        totals["completion"] += ev.output_tokens
                idx += 1
        if req.stream_options and req.stream_options.include_usage:
            yield CompletionResponse(
                id=rid, created=created, model=model, choices=[],
                usage=UsageInfo(
                    prompt_tokens=totals["prompt"],
                    completion_tokens=totals["completion"],
                    total_tokens=totals["prompt"] + totals["completion"],
                ),
            )
