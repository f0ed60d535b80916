"""Process assembly for ``python -m smg_tpu_torch.cli launch|serve|worker``
— the port's copy of ``smg_tpu/gateway/launch.py``: build a port ``Engine``
from an HF checkpoint directory (``--model-path``: its ``config.json``,
safetensors weights and tokenizer) or a model preset; ``worker`` serves it
over gRPC (``rpc/server.py``); ``serve`` puts it behind the gateway as one
``InProcWorkerClient``; ``launch`` runs the gateway alone.  Both gateway
commands open the conversation storage (``--storage``), the MCP servers
of ``--mcp-config-path``, the third-party providers of
``--provider-config`` and the middleware plugins of ``--plugins`` before an
engine loads, register the
workers named by URL (``--worker``, ``--prefill-worker``,
``--decode-worker``) through the registration workflow before the listener
binds, watch Kubernetes pods with ``--service-discovery``, gossip workers
and cache-aware prefix trees with peer gateways with ``--mesh-port``
(``start_mesh``), take TLS and the
probe-only and metrics-only listeners, and on SIGTERM or SIGINT stop
selecting every worker, close every client (an in-process engine drains)
and shut every listener.

Preset models have no tokenizer file, so the engine and the gateway share a
vocabulary-matched ``MockTokenizer``.  (The JAX ``serve`` gives its gateway
``MockTokenizer()`` at its default 512-word vocabulary; the port's gateway
uses the engine's, so a prompt's words map to the ids the model sees.)  A
``launch`` gateway takes ``--gateway-tokenizer-path``, else the first
worker's tokenizer bundle, else ``MockTokenizer()`` marked
``_smg_fallback``, which a worker's bundle registered later replaces as
the default.
"""

from __future__ import annotations

import asyncio
import dataclasses

from aiohttp import web

from smg_tpu_torch.utils import get_logger

logger = get_logger("gateway.launch")


def build_engine_from_args(args):
    """A port ``Engine`` from the parsed ``serve`` flags, on ``--device``
    (the card by default): the checkpoint of ``--model-path`` (weights in
    ``--dtype``, its tokenizer, ``model_id`` = the path), or a preset with
    random weights from ``seed``; a vision-language checkpoint's tower loads
    from the same directory.  A draft model comes from
    ``--draft-model-path`` (its checkpoint) or ``--draft-model-preset``.

    ``--tp``, ``--pp``, ``--sp``, ``--ep`` and ``--mesh-shape`` build the
    ``ParallelConfig`` as the
    reference does; a mesh larger than the devices present exits with the
    reference's message before anything loads.  Ranks whose collectives go
    over gloo (the CPU, or ranks sharing a card) decode eagerly: the engine
    is built with ``decode_graphs=False`` and the log says so."""
    from smg_tpu_torch.engine.config import (
        CacheConfig,
        EngineConfig,
        ParallelConfig,
        SchedulerConfig,
    )
    from smg_tpu_torch.engine.engine import Engine
    from smg_tpu_torch.models.config import PRESETS, ModelConfig
    from smg_tpu_torch.models.weights import load_params, load_vision_params
    from smg_tpu_torch.tokenizer import MockTokenizer

    if args.model_path:
        model = ModelConfig.from_pretrained(args.model_path, dtype=args.dtype)
    elif args.model_preset:
        if args.model_preset not in PRESETS:
            raise SystemExit(f"unknown --model-preset {args.model_preset!r}; "
                             f"known: {sorted(PRESETS)}")
        model = dataclasses.replace(PRESETS[args.model_preset](), dtype=args.dtype)
        if model.vision is not None:  # the tower computes in the same dtype
            model = dataclasses.replace(
                model, vision=dataclasses.replace(model.vision, dtype=args.dtype))
    else:
        raise SystemExit("need --model-path or --model-preset")
    parallel = ParallelConfig(tp=args.tp, pp=args.pp, sp=args.sp, ep=args.ep)
    if args.mesh_shape:
        # validate_cli_args already refused a conflict with a per-axis flag
        parallel = ParallelConfig.from_spec(args.mesh_shape, base=parallel)
    devices, graphs = None, True
    if parallel.world_size > 1:
        from smg_tpu_torch.parallel.group import device_backend, resolve_devices

        named = [d for d in args.device.split(",") if d]
        if named == ["cpu"]:
            named = ["cpu"] * parallel.world_size
        try:
            devices = resolve_devices(parallel, None if named == ["cuda"] else named)
        except RuntimeError as e:
            raise SystemExit(str(e)) from None
        graphs = device_backend(devices) == "nccl"
        logger.info("parallel mesh: %s over %s (%s collectives%s)", parallel.axis_sizes(),
                    [str(d) for d in devices], "nccl" if graphs else "gloo",
                    "" if graphs else "; decode megasteps run eagerly: gloo cannot be "
                    "captured in a CUDA graph")
    draft_model = draft_params = None
    if args.draft_model_path:
        draft_model = ModelConfig.from_pretrained(args.draft_model_path, dtype=args.dtype)
        draft_params = load_params(EngineConfig(model=draft_model,
                                                model_path=args.draft_model_path),
                                   device=str(devices[0]) if devices else args.device)
    elif args.draft_model_preset:
        if args.draft_model_preset not in PRESETS:
            raise SystemExit(f"unknown --draft-model-preset {args.draft_model_preset!r}; "
                             f"known: {sorted(PRESETS)}")
        draft_model = dataclasses.replace(PRESETS[args.draft_model_preset](),
                                          dtype=args.dtype)
    if args.speculative_tier == "draft" and draft_model is None:
        raise SystemExit("--speculative-tier draft needs --draft-model-path or "
                         "--draft-model-preset")
    cfg = EngineConfig(
        model=model,
        model_path=args.model_path,
        tokenizer_path=args.tokenizer_path or args.model_path,
        cache=CacheConfig(
            page_size=args.page_size,
            # KV follows the compute dtype unless the operator overrides
            dtype=args.kv_dtype or args.dtype,
        ),
        scheduler=SchedulerConfig(
            max_batch_size=args.max_batch_size,
            max_seq_len=args.max_seq_len,
            max_prefill_tokens=args.max_prefill_tokens,
            prefill_mix_policy=args.prefill_mix_policy,
            decode_horizon=args.decode_horizon,
            adaptive_horizon=args.adaptive_horizon == "on",
            decode_horizon_max=args.decode_horizon_max,
            overlap_schedule=args.overlap_schedule != "off",
            max_queued_requests=args.max_queued_requests,
            max_queued_tokens=args.max_queued_tokens,
            speculative=args.speculative,
            spec_max_draft=args.spec_max_draft,
            speculative_tier=args.speculative_tier,
        ),
        draft_model=draft_model,
        parallel=parallel,
        decode_graphs=graphs,
        model_id=args.model_path or args.model_preset,
        step_watchdog_secs=args.step_watchdog_secs,
        metrics_window_secs=args.metrics_window_secs,
        device_metrics_interval_secs=args.device_metrics_interval_secs,
        flight_recorder=args.flight_recorder != "off",
        flight_ring_size=args.flight_ring_size,
        flight_dump_dir=args.flight_dump_dir,
        flight_dump_min_interval_secs=args.flight_dump_min_interval_secs,
    )
    params = vision_params = None
    if args.model_path:
        # a rank-mesh engine's ranks each take their part of the whole host copy
        params = load_params(cfg, device="cpu" if devices is not None else args.device)
        if model.vision is not None:
            vision_params = load_vision_params(cfg, device=args.device)
    if cfg.tokenizer_path:
        tokenizer = load_tokenizer(cfg.tokenizer_path)
    else:
        tokenizer = MockTokenizer(
            vocab_size=model.vocab_size,
            eos_token_id=(model.eos_token_ids or (0,))[0],
            bos_token_id=model.bos_token_id,
        )
    if devices is not None:
        return Engine(cfg, params=params, tokenizer=tokenizer, devices=devices,
                      draft_params=draft_params, vision_params=vision_params)
    return Engine(cfg, params=params, tokenizer=tokenizer, device=args.device,
                  draft_params=draft_params, vision_params=vision_params)


def load_tokenizer(path: str):
    """The HF tokenizer of a directory (``tokenizer.json``, its config and
    chat template)."""
    from smg_tpu_torch.tokenizer.hf import HFTokenizer

    return HFTokenizer(path)


def gateway_options(args) -> dict:
    """``AppContext`` keyword arguments from the parsed ``serve`` flags:
    the router's retries, parser, harmony, timeout and DP-rank settings,
    the cache-aware and prefix-hash knobs, auth, rate limits, priority
    admission, health checks, breakers, CORS, the tenant and request-id headers, SLO specs, the
    conversation storage spec and OTel export (the reference's
    flag-to-config mapping)."""
    from smg_tpu_torch.gateway.health import HealthConfig
    from smg_tpu_torch.gateway.router import RouterConfig

    router_config = RouterConfig(
        max_retries=0 if args.disable_retries else args.retry_max_retries,
        retry_backoff_base=args.retry_initial_backoff_ms / 1e3,
        retry_backoff_max=args.retry_max_backoff_ms / 1e3,
        reasoning_parser=args.reasoning_parser,
        tool_parser=args.tool_call_parser,
        harmony={None: None, "auto": None, "on": True, "off": False}[args.harmony],
        # the remaining request budget rides every worker dispatch, so the
        # engine expires abandoned work instead of decoding into the void
        request_timeout_secs=args.request_timeout_secs,
        kv_connector=args.kv_connector,
        # min-token replica pinning is the default; --no-dp-aware lets the
        # worker balance its replicas
        dp_rank_policy="dp_min_token" if args.dp_aware else "dp_passthrough",
    )
    policy_kwargs = {}
    if args.policy == "cache_aware":
        policy_kwargs = {
            "match_threshold": args.cache_threshold,
            "imbalance_abs": args.balance_abs_threshold,
            "imbalance_rel": args.balance_rel_threshold,
            "max_tree_size": args.max_tree_size,
            "page_size": args.block_size,
        }
    elif args.policy == "prefix_hash":
        policy_kwargs = {"prefix_tokens": args.prefix_token_count}
    auth_config = None
    if args.api_keys or args.jwt_secret or args.jwt_jwks_uri:
        from smg_tpu_torch.gateway.auth import AuthConfig, JwksVerifier, Principal

        keys = {}
        for spec in args.api_keys:
            key, _, rest = spec.partition(":")
            tenant, _, role = rest.partition(":")
            keys[key] = Principal(id=f"key-{key[:6]}", tenant=tenant or "default",
                                  roles=(role,) if role else ("user",))
        jwks = None
        if args.jwt_jwks_uri:
            def _fetch_jwks(uri=args.jwt_jwks_uri):
                import json
                import urllib.request

                with urllib.request.urlopen(uri, timeout=10) as r:
                    return json.loads(r.read())

            jwks = JwksVerifier(_fetch_jwks, issuer=args.jwt_issuer,
                                audience=args.jwt_audience)
        auth_config = AuthConfig(enabled=True, api_keys=keys,
                                 jwt_secret=args.jwt_secret, jwks=jwks)
    rate_limit_config = None
    if args.rate_limit_tokens_per_second:
        from smg_tpu_torch.gateway.rate_limit import RateLimitConfig

        rate_limit_config = RateLimitConfig(
            capacity=args.rate_limit_burst,
            refill_per_sec=args.rate_limit_tokens_per_second,
            max_concurrent=args.max_concurrent_requests,
        )
    priority_config = None
    if args.priority_scheduler_enabled:
        from smg_tpu_torch.gateway.priority import PriorityConfig

        priority_config = PriorityConfig(slots=args.priority_slots)
    # disable = an interval no deployment outlives (the monitor stays, so
    # the health routes keep working)
    health_config = HealthConfig(
        interval_secs=1e9 if args.disable_health_check else args.health_check_interval_secs,
        timeout_secs=args.health_check_timeout_secs,
        failure_threshold=args.health_failure_threshold,
        success_threshold=args.health_success_threshold,
    )
    # breaker knobs are per context: applied to workers as they register
    cb_config = (10**9 if args.disable_circuit_breaker else args.cb_failure_threshold,
                 args.cb_success_threshold, args.cb_timeout_duration_secs)
    slo_specs = None
    if args.slo_spec:
        from smg_tpu_torch.gateway.slo_enforcement import load_slo_specs

        # a malformed spec fails startup loudly, not the first evaluation
        slo_specs = load_slo_specs(args.slo_spec)
        logger.info("SLO enforcement on: %s", [s.name for s in slo_specs])
    return dict(
        policy=args.policy,
        router_config=router_config,
        max_concurrent_requests=args.max_concurrent_requests,
        policy_kwargs=policy_kwargs,
        auth_config=auth_config,
        rate_limit_config=rate_limit_config,
        priority_config=priority_config,
        health_config=health_config,
        storage=args.storage,
        otel_endpoint=args.otel_endpoint,
        otel_service_name=args.otel_service_name,
        request_id_headers=list(args.request_id_headers),
        tenant_header=args.tenant_header_name,
        # without auth the tenant header is all there is; with auth it must
        # be trusted explicitly
        trust_tenant_header=args.trust_tenant_header or auth_config is None,
        request_timeout_secs=args.request_timeout_secs,
        cors_allowed_origins=list(args.cors_allowed_origins),
        circuit_breaker_config=cb_config,
        slo_specs=slo_specs,
    )


def build_context(engine, policy: str = "cache_aware", drain_timeout_secs: float = 10.0,
                  **options):
    """The gateway's ``AppContext`` with ``engine`` registered as one
    in-process worker, its tokenizer as the default; ``options`` are
    further ``AppContext`` arguments (``gateway_options``)."""
    from smg_tpu_torch.gateway.server import AppContext

    ctx = AppContext(policy=policy, **options)
    add_engine_worker(ctx, engine, drain_timeout_secs)
    return ctx


def add_engine_worker(ctx, engine, drain_timeout_secs: float = 10.0) -> None:
    """Register ``engine`` in ``ctx`` as the in-process worker
    ``inproc-0``, its tokenizer as the default."""
    from smg_tpu_torch.gateway.worker_client import InProcWorkerClient
    from smg_tpu_torch.gateway.workers import Worker

    ctx.tokenizers.register(engine.config.model_id, engine.tokenizer, default=True)
    client = InProcWorkerClient(engine)
    client.drain_timeout_secs = drain_timeout_secs
    ctx.registry.add(Worker(worker_id="inproc-0", client=client,
                            model_id=engine.config.model_id,
                            page_size=engine.config.cache.page_size))


async def load_mcp_config(ctx, path: str) -> None:
    """One ``HttpMcpServer`` in ``ctx.mcp`` per entry of the JSON file at
    ``path`` (``[{"name", "url", "headers"}]``; the name defaults to the
    URL).  The file is read on a thread: startup runs on the serving loop."""
    import json
    from pathlib import Path

    from smg_tpu_torch.mcp import HttpMcpServer

    raw = await asyncio.to_thread(Path(path).read_text)
    for spec in json.loads(raw):
        ctx.mcp.add(HttpMcpServer(name=spec.get("name", spec["url"]), url=spec["url"],
                                  headers=spec.get("headers")))


async def serve_context(ctx, host: str, port: int, stop: asyncio.Event,
                        client_max_size: int = 256 * 2**20, ssl_context=None,
                        probe_port: int | None = None,
                        metrics_listener: "tuple[str, int] | None" = None,
                        discoveries=(), mesh_node=None) -> None:
    """Serve ``ctx`` on ``host:port`` (request bodies capped at
    ``client_max_size`` bytes; HTTPS with ``ssl_context``), with a
    probe-only listener on ``probe_port`` and a metrics-only one on
    ``metrics_listener`` = (host, port) when given, until ``stop`` is set;
    then drain: the ``discoveries`` and the ``mesh_node`` stop, workers stop
    being selected, each
    worker client closes (for an in-proc engine that is
    ``stop(drain=True)``: queued requests get terminal aborts and running
    lanes finish within the drain budget), and the listeners shut."""
    from smg_tpu_torch.gateway.server import CTX, build_app, h_health, h_metrics, h_readiness

    runners = [web.AppRunner(build_app(ctx, client_max_size=client_max_size))]
    try:
        await runners[0].setup()
        await web.TCPSite(runners[0], host, port, ssl_context=ssl_context).start()
        logger.info("gateway listening on %s:%d%s", host, port,
                    " (TLS)" if ssl_context else "")
        if probe_port:
            # /health, /liveness and /readiness stay reachable when the main
            # port saturates; only the probes: the API must not leak onto a
            # plaintext, unauthenticated port
            papp = web.Application()
            papp[CTX] = ctx
            papp.router.add_get("/health", h_health)
            papp.router.add_get("/liveness", h_health)
            papp.router.add_get("/readiness", h_readiness)
            runners.append(web.AppRunner(papp))
            await runners[-1].setup()
            await web.TCPSite(runners[-1], host, probe_port).start()
            logger.info("probe listener on %s:%d", host, probe_port)
        if metrics_listener:
            # scrapers reach /metrics and nothing else
            mapp = web.Application()
            mapp[CTX] = ctx
            mapp.router.add_get("/metrics", h_metrics)
            runners.append(web.AppRunner(mapp))
            await runners[-1].setup()
            await web.TCPSite(runners[-1], *metrics_listener).start()
            logger.info("prometheus exporter on %s:%d", *metrics_listener)
        await stop.wait()
        logger.info("shutdown signal received; draining workers")
        for d in discoveries:
            await d.aclose()
        if mesh_node is not None:
            await mesh_node.stop()
        for w in ctx.registry.list():
            w.draining = True  # no new selections while streams settle
        for w in ctx.registry.list():
            try:
                await w.client.close()
            except Exception:
                logger.exception("worker %s close failed during shutdown", w.worker_id)
    finally:
        if mesh_node is not None:
            await mesh_node.stop()  # idempotent: covers a failed startup
        for r in reversed(runners):
            await r.cleanup()


def configure_grpc_clients(args) -> None:
    """``--mm-transport``, ``--mm-shm-min-bytes`` and
    ``--worker-stream-idle-timeout-secs`` as process-wide class attributes
    of every gRPC worker client (0 turns the idle bound off)."""
    from smg_tpu_torch.rpc.client import GrpcWorkerClient

    GrpcWorkerClient.mm_transport = args.mm_transport
    GrpcWorkerClient.mm_shm_min_bytes = args.mm_shm_min_bytes
    if args.worker_stream_idle_timeout_secs is not None:
        GrpcWorkerClient.idle_timeout_secs = args.worker_stream_idle_timeout_secs or None


async def register_worker(ctx, url: str, worker_type, fetch_bundle: bool,
                          timeout: float) -> None:
    """Register one worker through the registration workflow (reference:
    registration rides the job queue and the workflow engine,
    server.rs:1107-1135): model_info retries with backoff, so a worker
    still starting neither kills nor serializes the gateway, and a failed
    registration stays resumable via POST /workflows/{id}/resume."""
    from smg_tpu_torch.gateway.registration import WORKER_REGISTRATION

    iid = await ctx.workflows.start(WORKER_REGISTRATION, {
        "url": url, "worker_type": worker_type.value, "skip_tokenizer": not fetch_bundle,
    })
    inst = await ctx.workflows.wait(iid, timeout=timeout)
    if inst.status.value != "completed":
        logger.error("worker %s registration %s at startup (%s); resumable as %s",
                     url, inst.status.value, inst.error, iid)


def start_discovery(ctx, args) -> list:
    """One Kubernetes pod watcher per role selector group: pods a role's
    selector matches default to that role without a role label."""
    from smg_tpu_torch.gateway.discovery import DiscoveryConfig, ServiceDiscovery

    ns = args.service_discovery_namespace or "default"
    groups = [(",".join(args.selectors) or "app=smg-worker", "regular")]
    if args.prefill_selectors:
        groups.append((",".join(args.prefill_selectors), "prefill"))
    if args.decode_selectors:
        groups.append((",".join(args.decode_selectors), "decode"))
    out = []
    for selector, role in groups:
        d = ServiceDiscovery(ctx.registry, DiscoveryConfig(
            namespace=ns, selector=selector, default_port=args.service_discovery_port,
            default_role=role))
        d.start()
        out.append(d)
        logger.info("k8s service discovery on (selector %s, role %s)", selector, role)
    return out


async def start_mesh(ctx, args):
    """``--mesh-port``: a gossip node on 0.0.0.0 (seeded by ``--mesh-seed``,
    mutual TLS with the three ``--mesh-tls-*`` files) whose CRDT state the
    worker and tree adapters sync with this gateway's registry and
    cache-aware policies."""
    from smg_tpu_torch.mesh import GossipConfig, GossipNode
    from smg_tpu_torch.mesh.adapters import TreeSyncAdapter, WorkerSyncAdapter

    node = GossipNode(GossipConfig(
        host="0.0.0.0", port=args.mesh_port, seeds=list(args.mesh_seeds),
        tls_cert_file=args.mesh_tls_cert, tls_key_file=args.mesh_tls_key,
        tls_ca_file=args.mesh_tls_ca))
    await node.start()
    WorkerSyncAdapter(ctx.registry, node.state)
    TreeSyncAdapter(ctx.policies, node.state)
    logger.info("HA mesh enabled on port %d", args.mesh_port)
    return node


async def _run_gateway(args, stop: asyncio.Event | None = None) -> int:
    """``launch`` (the gateway alone) and ``serve`` (with an in-process
    engine) until SIGTERM or SIGINT, or until ``stop`` is set: the
    reference's ``_run_gateway`` for the flags the port takes."""
    from smg_tpu_torch.gateway.server import AppContext
    from smg_tpu_torch.gateway.workers import WorkerType

    if stop is None:
        stop = asyncio.Event()
        try:
            import signal

            loop = asyncio.get_running_loop()
            for sig in (signal.SIGTERM, signal.SIGINT):
                loop.add_signal_handler(sig, stop.set)
        except (NotImplementedError, RuntimeError, ValueError):
            pass  # non-main thread / platform without signal support
    # the SLO spec file is read off the serving loop; the storage, the MCP
    # servers, the providers and the plugins come before the engine, so a
    # bad --storage, MCP, provider or plugin file fails startup before any
    # weights load
    options = await asyncio.to_thread(gateway_options, args)
    ctx = AppContext(**options)
    if args.mcp_config_path:
        await load_mcp_config(ctx, args.mcp_config_path)
    if args.provider_config:
        await asyncio.to_thread(ctx.providers.load_config, args.provider_config)
    if args.plugins:
        ctx.load_plugins(args.plugins, fail_open=not args.plugin_fail_closed)
    if args.command == "serve":
        add_engine_worker(ctx, build_engine_from_args(args),
                          drain_timeout_secs=args.engine_drain_timeout_secs)
    configure_grpc_clients(args)
    explicit_tok = args.gateway_tokenizer_path or getattr(args, "tokenizer_path", None)
    if args.command == "launch" and explicit_tok:
        tok = await asyncio.to_thread(load_tokenizer, explicit_tok)
        ctx.tokenizers.register("default", tok, default=True)
    role_urls = ([(u, WorkerType.REGULAR) for u in args.workers]
                 + [(u, WorkerType.PREFILL) for u in args.prefill_workers]
                 + [(u, WorkerType.DECODE) for u in args.decode_workers])
    if role_urls:
        # every worker at once; the wait outlasts the workflow's model_info
        # retry budget, or a late success would race the mock fallback
        # below (an operator-configured tokenizer wins over worker bundles)
        await asyncio.gather(*(
            register_worker(ctx, url, wtype, fetch_bundle=not explicit_tok,
                            timeout=args.worker_startup_timeout_secs)
            for url, wtype in role_urls))
    discoveries = start_discovery(ctx, args) if args.service_discovery else []
    if args.command == "launch" and ctx.tokenizers.get(None) is None:
        # nothing explicit and no worker handed one over; marked, so a
        # worker's tokenizer arriving later takes the default over it
        from smg_tpu_torch.tokenizer import MockTokenizer

        logger.warning("no tokenizer from the command line or a worker; using MockTokenizer")
        fallback = MockTokenizer()
        fallback._smg_fallback = True
        ctx.tokenizers.register("default", fallback, default=True)
    mesh_node = await start_mesh(ctx, args) if args.mesh_port is not None else None
    ssl_context = None
    if args.tls_cert_path:
        import ssl

        ssl_context = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        await asyncio.to_thread(ssl_context.load_cert_chain, args.tls_cert_path,
                                args.tls_key_path)
    await serve_context(
        ctx, args.host, args.port, stop, client_max_size=args.max_payload_size,
        ssl_context=ssl_context, probe_port=args.health_check_port,
        metrics_listener=((args.prometheus_host, args.prometheus_port)
                          if args.prometheus_port else None),
        discoveries=discoveries, mesh_node=mesh_node)
    return 0


def run_worker(args) -> int:
    """``worker``: one engine behind the gRPC scheduler protocol until
    SIGTERM or SIGINT."""
    from smg_tpu_torch.rpc.server import serve_worker

    engine = build_engine_from_args(args)
    engine.start()
    return serve_worker(engine, port=args.grpc_port)


def run_command(args) -> int:
    if args.command == "worker":
        return run_worker(args)
    return asyncio.run(_run_gateway(args))
