"""Process assembly for ``python -m smg_tpu_torch.cli serve`` — the port's
copy of the ``serve`` path of ``smg_tpu/gateway/launch.py``: build a port
``Engine`` from a model preset, put it behind one ``InProcWorkerClient``,
and serve the gateway until SIGTERM or SIGINT, which drains the engine.

Preset models have no tokenizer file, so the engine and the gateway share a
vocabulary-matched ``MockTokenizer``.  (The JAX ``serve`` gives its gateway
``MockTokenizer()`` at its default 512-word vocabulary; the port's gateway
uses the engine's, so a prompt's words map to the ids the model sees.)
"""

from __future__ import annotations

import asyncio
import dataclasses

from aiohttp import web

from smg_tpu_torch.utils import get_logger

logger = get_logger("gateway.launch")


def build_engine_from_args(args):
    """A port ``Engine`` from the parsed ``serve`` flags: random weights
    from ``seed`` for the preset, on ``--device`` (the card by default)."""
    from smg_tpu_torch.engine.config import CacheConfig, EngineConfig, SchedulerConfig
    from smg_tpu_torch.engine.engine import Engine
    from smg_tpu_torch.models.config import PRESETS
    from smg_tpu_torch.tokenizer import MockTokenizer

    if args.model_preset not in PRESETS:
        raise SystemExit(f"unknown --model-preset {args.model_preset!r}; "
                         f"known: {sorted(PRESETS)}")
    model = dataclasses.replace(PRESETS[args.model_preset](), dtype=args.dtype)
    cfg = EngineConfig(
        model=model,
        cache=CacheConfig(
            page_size=args.page_size,
            # KV follows the compute dtype unless the operator overrides
            dtype=args.kv_dtype or args.dtype,
        ),
        scheduler=SchedulerConfig(
            max_batch_size=args.max_batch_size,
            max_seq_len=args.max_seq_len,
            max_prefill_tokens=args.max_prefill_tokens,
            decode_horizon=args.decode_horizon,
            adaptive_horizon=args.adaptive_horizon == "on",
            decode_horizon_max=args.decode_horizon_max,
            overlap_schedule=args.overlap_schedule != "off",
            max_queued_requests=args.max_queued_requests,
            max_queued_tokens=args.max_queued_tokens,
        ),
        model_id=args.model_preset,
        step_watchdog_secs=args.step_watchdog_secs,
        flight_ring_size=args.flight_ring_size,
    )
    tokenizer = MockTokenizer(
        vocab_size=model.vocab_size,
        eos_token_id=(model.eos_token_ids or (0,))[0],
        bos_token_id=model.bos_token_id,
    )
    return Engine(cfg, tokenizer=tokenizer, device=args.device)


def build_context(engine, policy: str = "cache_aware", drain_timeout_secs: float = 10.0):
    """The gateway's ``AppContext`` with ``engine`` registered as one
    in-process worker, its tokenizer as the default."""
    from smg_tpu_torch.gateway.server import AppContext
    from smg_tpu_torch.gateway.worker_client import InProcWorkerClient
    from smg_tpu_torch.gateway.workers import Worker

    ctx = AppContext(policy=policy)
    ctx.tokenizers.register(engine.config.model_id, engine.tokenizer, default=True)
    client = InProcWorkerClient(engine)
    client.drain_timeout_secs = drain_timeout_secs
    ctx.registry.add(Worker(worker_id="inproc-0", client=client,
                            model_id=engine.config.model_id,
                            page_size=engine.config.cache.page_size))
    return ctx


async def serve_context(ctx, host: str, port: int, stop: asyncio.Event) -> None:
    """Serve ``ctx`` on ``host:port`` until ``stop`` is set, then drain:
    workers stop being selected, each worker client closes (for an in-proc
    engine that is ``stop(drain=True)``: queued requests get terminal
    aborts and running lanes finish within the drain budget), and the
    listener shuts."""
    from smg_tpu_torch.gateway.server import build_app

    runner = web.AppRunner(build_app(ctx))
    await runner.setup()
    try:
        await web.TCPSite(runner, host, port).start()
        logger.info("gateway listening on %s:%d", host, port)
        await stop.wait()
        logger.info("shutdown signal received; draining workers")
        for w in ctx.registry.list():
            w.draining = True  # no new selections while streams settle
        for w in ctx.registry.list():
            try:
                await w.client.close()
            except Exception:
                logger.exception("worker %s close failed during shutdown", w.worker_id)
    finally:
        await runner.cleanup()


async def _run_serve(args) -> int:
    engine = build_engine_from_args(args)
    ctx = build_context(engine, policy=args.policy,
                        drain_timeout_secs=args.engine_drain_timeout_secs)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    try:
        import signal

        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(sig, stop.set)
    except (NotImplementedError, RuntimeError, ValueError):
        pass  # non-main thread / platform without signal support
    await serve_context(ctx, args.host, args.port, stop)
    return 0


def run_command(args) -> int:
    return asyncio.run(_run_serve(args))
