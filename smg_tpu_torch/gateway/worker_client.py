"""Worker client abstraction: how the gateway talks to engine workers — the
port's copy of ``smg_tpu/gateway/worker_client.py``.  Two transports:

- ``InProcWorkerClient``: a port ``Engine`` in the gateway's process, with
  generation, the PD legs (``prefill_export``, ``generate_prefilled``; the
  KV may stay on the card: ``supports_device_kv``), embeddings, the vision
  encode, profiling and the LoRA calls;
- ``GrpcWorkerClient`` (``smg_tpu_torch/rpc/client.py``): remote workers
  over gRPC, the KV as bytes on the wire or, with the ``transfer``
  connector, a pull descriptor (``release_kv_offer`` signals the offer's
  outcome back to the prefill worker).
"""

from __future__ import annotations

import asyncio
import functools
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import AsyncIterator

from smg_tpu_torch.protocols.sampling import SamplingParams


class WorkerQueueFullError(RuntimeError):
    """The worker rejected the request with admission backpressure (engine
    bounded-queue ``QueueFullError``).  Retryable: the router tries another
    worker without penalizing this one's circuit breaker, and answers 429
    when every candidate is saturated."""


@dataclass
class WorkerGenerateRequest:
    rid: str
    input_ids: list[int]
    sampling: SamplingParams
    stream: bool = True
    # external DP dispatch: pin to one of the worker's engine replicas (-1 =
    # the worker chooses)
    data_parallel_rank: int = -1
    # multimodal splice (embeds, positions[, grids])
    mm_embeds: tuple | None = None
    # remaining client budget in seconds: the engine expires the request in
    # queue or aborts it mid-generation with finish_reason="timeout"
    timeout_secs: float | None = None
    # the caller's trace id, recorded in the engine's flight timeline
    trace_id: str | None = None


@dataclass
class WorkerStreamChunk:
    """Token-level increment from a worker (no text: the gateway detokenizes)."""

    rid: str
    token_ids: list[int] = field(default_factory=list)
    logprobs: list[float] = field(default_factory=list)
    finished: bool = False
    finish_reason: str | None = None
    matched_stop: str | int | None = None
    prompt_tokens: int = 0
    cached_tokens: int = 0
    output_tokens: int = 0


class WorkerClient:
    """Transport-agnostic worker API (async)."""

    #: True when this client can hand KV over as tensors on the card (an
    #: in-process engine: the ``device`` kv connector)
    supports_device_kv = False

    async def generate(self, req: WorkerGenerateRequest) -> AsyncIterator[WorkerStreamChunk]:
        raise NotImplementedError
        yield  # pragma: no cover

    async def abort(self, rid: str) -> bool:
        raise NotImplementedError

    async def prefill_export(self, input_ids: list, sampling, connector: str = "host") -> dict:
        """PD prefill leg: {first_token, k, v, seq_len, connector}."""
        raise NotImplementedError

    async def release_kv_offer(self, uuid: int, consumed: bool) -> bool:
        """PD transfer lifecycle signal (no-op for non-transfer workers)."""
        return False

    def generate_prefilled(self, req, first_token: int, k, v):
        """PD decode leg: async iterator of WorkerStreamChunk."""
        raise NotImplementedError

    async def health(self) -> bool:
        raise NotImplementedError

    async def dump_flight(self, reason: str = "manual") -> dict:
        """Engine flight-recorder dump (the step ring and request timelines
        as a schema-versioned JSON-able dict).  Gateway surface:
        GET /debug/flight/{worker}."""
        raise NotImplementedError("flight recorder unsupported by this worker")

    async def get_loads(self) -> dict:
        raise NotImplementedError

    async def get_model_info(self) -> dict:
        raise NotImplementedError

    async def flush_cache(self) -> bool:
        raise NotImplementedError

    async def embed(self, batches: list) -> list:
        """batches: list[list[int]] -> list[list[float]]."""
        raise NotImplementedError

    async def encode_image(self, pixel_values, grid: tuple) -> "object":
        """Vision-tower encode (the EPD encode leg): pre-patchified pixels
        [N, patch_dim] f32 -> np.float32 [N/merge^2, lm_hidden]."""
        raise NotImplementedError("worker has no vision tower")

    async def start_profile(self, output_dir: str, host_tracer: bool = True,
                            python_tracer: bool = False, num_steps: int = 0) -> dict:
        return {"ok": False, "error": "profiling unsupported by this worker"}

    async def stop_profile(self) -> dict:
        return {"ok": False, "error": "profiling unsupported by this worker"}

    async def load_lora_adapter(self, name: str, path: str | None = None,
                                data: bytes | None = None) -> dict:
        return {"ok": False, "error": "LoRA unsupported by this worker"}

    async def unload_lora_adapter(self, name: str) -> dict:
        return {"ok": False, "error": "LoRA unsupported by this worker"}

    async def list_lora_adapters(self) -> list[str]:
        return []

    async def get_tokenizer(self):
        return None

    def subscribe_kv_events(self, callback) -> callable:
        """Register a KV-event batch callback; returns unsubscribe fn."""
        return lambda: None

    @property
    def engine_metrics(self):
        """EngineMetrics of a colocated engine, or None; the gateway folds
        its series into its /metrics registry."""
        return None

    async def close(self) -> None:
        pass


class InProcWorkerClient(WorkerClient):
    """Engine in the same process.  The engine's background loop runs in its
    own thread; outputs hop onto the event loop via call_soon_threadsafe.

    Submits and aborts run on one worker thread of this client, in the
    order they are called.  The engine holds its lock for a whole step
    (tens of milliseconds of prefill on the card), so a submit made on the
    event loop would stall every other request and stream for that long;
    on the worker thread only the caller waits.  One thread in call order
    keeps the engine's arrival order, and puts an abort after its own
    request's submit even when the caller was cancelled while submitting.
    (The reference submits on the event loop.)  The PD legs run there too:
    an export holds the engine lock for the prompt's prefill."""

    supports_device_kv = True

    #: drain budget handed to ``engine.stop(drain=True)`` on close — long
    #: enough for in-flight lanes to finish, short enough for prompt SIGTERM
    drain_timeout_secs: float = 10.0

    def __init__(self, engine):
        self.engine = engine
        self._calls = ThreadPoolExecutor(max_workers=1, thread_name_prefix="inproc-submit")
        engine.start()

    async def generate(self, req: WorkerGenerateRequest) -> AsyncIterator[WorkerStreamChunk]:
        from smg_tpu_torch.engine.request import QueueFullError
        from smg_tpu_torch.faults import FAULTS

        loop = asyncio.get_running_loop()
        q: asyncio.Queue = asyncio.Queue()
        on_output = _chunk_sink(req.rid, loop, q)

        # in-proc trace link: the ambient request span's trace id threads
        # into the engine request, so the flight-recorder timeline links to
        # the request's OTel trace
        from smg_tpu_torch.gateway.tracing import ambient_trace_id

        submit = functools.partial(
            self.engine.submit, req.input_ids, req.sampling, rid=req.rid,
            on_output=on_output, mm_embeds=req.mm_embeds, timeout_secs=req.timeout_secs,
            trace_id=req.trace_id or ambient_trace_id(),
        )
        try:
            await loop.run_in_executor(self._calls, submit)
        except QueueFullError as e:
            # transport-level shape of engine backpressure: the router
            # retries another worker / answers 429, breaker untouched
            raise WorkerQueueFullError(str(e)) from e
        while True:
            chunk = await q.get()
            # fault point: simulated transport death mid-stream
            FAULTS.fire("worker.stream", rid=req.rid)
            yield chunk
            if chunk.finished:
                return

    async def abort(self, rid: str) -> bool:
        # behind any submit still queued on the same thread
        return await asyncio.get_running_loop().run_in_executor(
            self._calls, self.engine.abort, rid)

    async def prefill_export(self, input_ids: list, sampling, connector: str = "host") -> dict:
        return await asyncio.get_running_loop().run_in_executor(
            self._calls, functools.partial(self.engine.prefill_export, list(input_ids),
                                           sampling, connector=connector))

    async def release_kv_offer(self, uuid: int, consumed: bool) -> bool:
        mgr = self.engine.runner.kv_transfer
        return mgr.mark_consumed(uuid) if consumed else mgr.reclaim(uuid)

    async def generate_prefilled(self, req, first_token: int, k, v):
        from smg_tpu_torch.gateway.tracing import ambient_trace_id

        loop = asyncio.get_running_loop()
        q: asyncio.Queue = asyncio.Queue()
        submit = functools.partial(
            self.engine.submit_prefilled, req.input_ids, first_token, k, v, req.sampling,
            rid=req.rid, on_output=_chunk_sink(req.rid, loop, q),
            trace_id=req.trace_id or ambient_trace_id())
        await loop.run_in_executor(self._calls, submit)
        while True:
            chunk = await q.get()
            yield chunk
            if chunk.finished:
                return

    async def health(self) -> bool:
        # engine-level health, not liveness: a wedged device fetch or a run
        # of consecutive step failures reports false here, so HealthMonitor
        # and breakers route around the worker while it recovers
        return bool(getattr(self.engine, "healthy", True))

    async def dump_flight(self, reason: str = "manual") -> dict:
        # takes only the recorder's own lock, but serialization is real
        # work — off the loop
        return await asyncio.to_thread(self.engine.dump_flight, reason)

    async def get_loads(self) -> dict:
        # loads() takes the engine lock — off the event loop, or a
        # multi-second prefill step would stall every request
        return await asyncio.to_thread(self.engine.loads)

    @property
    def engine_metrics(self):
        return getattr(getattr(self, "engine", None), "metrics", None)

    async def get_model_info(self) -> dict:
        """The reference's fields; ``device`` (the engine's, where the
        gateway's image processor runs for an in-process worker) is the
        port's own."""
        cfg = self.engine.config
        info = {
            "model_id": cfg.model_id,
            "max_seq_len": cfg.scheduler.max_seq_len,
            "vocab_size": cfg.model.vocab_size,
            "eos_token_ids": list(cfg.model.eos_token_ids),
            "page_size": cfg.cache.page_size,
            "supports_vision": self.engine.supports_vision,
            "supports_kv_transfer": self.engine.runner.supports_kv_transfer,
            "device": str(self.engine.runner.device),
        }
        if self.engine.supports_vision:
            info.update(
                image_token_id=cfg.model.image_token_id,
                vision_patch_size=cfg.model.vision.patch_size,
                vision_merge_size=cfg.model.vision.merge_size,
            )
        return info

    async def flush_cache(self) -> bool:
        return self.engine.flush_cache()

    # embed and the profiler calls take the engine lock: on the client's own
    # thread, ordered with submits and aborts, never on the event loop

    async def embed(self, batches: list) -> list:
        vecs = await asyncio.get_running_loop().run_in_executor(
            self._calls, self.engine.embed, [list(b) for b in batches])
        return [v.tolist() for v in vecs]

    async def encode_image(self, pixel_values, grid: tuple) -> "object":
        return await asyncio.get_running_loop().run_in_executor(
            self._calls, self.engine.encode_image, pixel_values, grid)

    async def start_profile(self, output_dir: str, host_tracer: bool = True,
                            python_tracer: bool = False, num_steps: int = 0) -> dict:
        loop = asyncio.get_running_loop()
        try:
            out = await loop.run_in_executor(self._calls, functools.partial(
                self.engine.start_profile, output_dir, host_tracer=host_tracer,
                python_tracer=python_tracer, num_steps=num_steps))
            return {"ok": True, "error": "", "output_dir": out}
        except Exception as e:
            return {"ok": False, "error": str(e)}

    async def stop_profile(self) -> dict:
        loop = asyncio.get_running_loop()
        try:
            await loop.run_in_executor(self._calls, self.engine.stop_profile)
            return {"ok": True, "error": ""}
        except Exception as e:
            return {"ok": False, "error": str(e)}

    async def load_lora_adapter(self, name: str, path: str | None = None,
                                data: bytes | None = None) -> dict:
        # on the client's own thread, ordered with submits and aborts
        loop = asyncio.get_running_loop()
        try:
            slot = await loop.run_in_executor(
                self._calls, lambda: self.engine.load_lora_adapter(name, path=path, data=data))
            return {"ok": True, "error": "", "slot": slot}
        except Exception as e:
            return {"ok": False, "error": str(e)}

    async def unload_lora_adapter(self, name: str) -> dict:
        loop = asyncio.get_running_loop()
        ok = await loop.run_in_executor(self._calls, self.engine.unload_lora_adapter, name)
        return {"ok": ok, "error": "" if ok else f"adapter {name!r} not loaded"}

    async def list_lora_adapters(self) -> list[str]:
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(self._calls, self.engine.list_lora_adapters)

    async def get_tokenizer(self):
        return self.engine.tokenizer

    def subscribe_kv_events(self, callback):
        return self.engine.events.subscribe(callback)

    async def close(self) -> None:
        # graceful: admission stops, queued requests get terminal aborts,
        # running lanes finish (bounded); off the event loop — the drain
        # wait is seconds of blocking
        await asyncio.to_thread(self.engine.stop, True, self.drain_timeout_secs)
        self._calls.shutdown(wait=False)


def _chunk_sink(rid: str, loop, q: asyncio.Queue):
    """An engine ``on_output`` callback (engine thread) that hops each
    output onto ``loop`` as a ``WorkerStreamChunk`` in ``q``."""

    def on_output(out) -> None:
        chunk = WorkerStreamChunk(
            rid=rid,
            token_ids=list(out.new_token_ids),
            logprobs=list(out.logprobs),
            finished=out.finished,
            finish_reason=out.finish_reason,
            matched_stop=out.matched_stop,
            prompt_tokens=out.prompt_tokens,
            cached_tokens=out.cached_tokens,
            output_tokens=out.output_tokens,
        )
        loop.call_soon_threadsafe(q.put_nowait, chunk)

    return on_output
