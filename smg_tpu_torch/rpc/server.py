"""Worker-side gRPC servicer: one or more port ``Engine`` replicas over the
scheduler protocol — the port's copy of ``smg_tpu/rpc/server.py``, on the
same wire format (``rpc/scheduler_pb2.py``), so the reference's client
drives it and the port's client drives the reference's server.

Every RPC of the reference: ``Generate``, ``Embed``, ``EmbedBatch``,
``Encode``, ``PrefillExport``, ``GeneratePrefilled``, ``DumpFlight``,
``Abort``, ``HealthCheck``, ``GetLoads``, ``GetModelInfo``, ``FlushCache``,
the three LoRA RPCs, ``GetTokenizer``, ``StartProfile``/``StopProfile``
(a ``torch.profiler`` trace) and ``SubscribeKvEvents``.

Data-parallel replicas as in the reference: ``engines=[e0, e1, ...]``
serves one replica per ``data_parallel_rank``; -1 takes the replica with
the fewest queued tokens.  ``Abort`` tries every replica, ``HealthCheck``
is the AND of theirs, ``GetLoads`` sums their counters and gives each
rank's queued tokens, ``FlushCache`` and ``DumpFlight`` cover all of them;
every other RPC addresses replica 0 (replicas are homogeneous).  The
replicas share the process, and on the card its one CUDA context.
Divergences:

- the PD legs move the KV as host bytes (``PrefillExport`` sends them,
  ``GeneratePrefilled`` imports them) or, with the ``transfer`` connector,
  as a pull descriptor: the decode worker pulls the bulk bytes from the
  prefill worker's pull server (``engine/kv_transfer.py``: CUDA IPC, so
  both workers run on one host), and ``ReleaseKvOffer`` signals the offer's
  outcome;
- submits and aborts run on one worker thread, in call order, as the
  in-process client's do: the engine lock is held for a whole step, and the
  server's event loop must not wait on it.  The replica pick of a -1 rank
  reads every replica's load under its lock, so it runs there too, just
  before the submit.

Messages are capped at 512 MiB each way, as the reference's are.  A PD
export of more KV than that fails its prefill leg (the router answers 502):
at Llama-3-8B in bf16 a token's K and V take 131,072 bytes, so 4,080 tokens
(255 pages of 16) fit and 4,096 do not.
"""

from __future__ import annotations

import asyncio
import functools
import os
import tempfile
from concurrent.futures import ThreadPoolExecutor

import grpc
import grpc.aio

from smg_tpu_torch.rpc import SERVICE
from smg_tpu_torch.rpc import scheduler_pb2 as pb
from smg_tpu_torch.rpc.convert import (
    kv_batch_to_proto,
    kv_from_wire,
    kv_to_wire,
    mm_embeds_from_proto,
    sampling_from_proto,
)
from smg_tpu_torch.utils import get_logger

logger = get_logger("rpc.server")

MAX_MESSAGE_BYTES = 512 * 1024 * 1024


def _chunk(rid: str, out) -> pb.GenerateChunk:
    return pb.GenerateChunk(
        rid=rid,
        token_ids=out.new_token_ids,
        logprobs=out.logprobs,
        finished=out.finished,
        finish_reason=out.finish_reason or "",
        matched_stop_token=out.matched_stop if isinstance(out.matched_stop, int) else -1,
        prompt_tokens=out.prompt_tokens,
        cached_tokens=out.cached_tokens,
        output_tokens=out.output_tokens,
    )


class SchedulerServicer:
    """One worker = one or more data-parallel port engine replicas
    (``engines``; ``engine`` alone is one replica); ``tracer`` (an
    ``OtelTracer``) opens a ``worker.generate`` span under the gateway's
    propagated traceparent."""

    def __init__(self, engine=None, engines: "list | None" = None, tracer=None):
        if engines is None:
            engines = [engine]
        if not engines or any(e is None for e in engines):
            raise ValueError("need at least one engine")
        self.engines = list(engines)
        self.engine = self.engines[0]
        self.tracer = tracer
        self._calls = ThreadPoolExecutor(max_workers=1, thread_name_prefix="rpc-submit")

    @staticmethod
    def _traceparent(context) -> "str | None":
        """W3C traceparent from the request metadata."""
        try:
            for key, value in context.invocation_metadata() or ():
                if key == "traceparent":
                    return value
        except Exception:
            return None
        return None

    def _trace_id(self, context) -> "str | None":
        from smg_tpu_torch.gateway.tracing import parse_traceparent

        ctx = parse_traceparent(self._traceparent(context))
        return ctx[0] if ctx else None

    def _engine_for(self, rank: int):
        """The replica of ``rank``; -1 picks the one with the fewest queued
        tokens (its counters only: no audit, no radix lock walk).  Raises
        ``ValueError`` for a rank past the last replica."""
        if rank >= len(self.engines):
            raise ValueError(
                f"data_parallel_rank {rank} out of range (dp_size {len(self.engines)})")
        if rank >= 0:
            return self.engines[rank]
        if len(self.engines) == 1:
            return self.engine
        return min(self.engines, key=lambda e: e.loads(include_audit=False)["queued_tokens"])

    def _submit(self, rank: int, *args, **kwargs):
        """Pick the replica and submit to it (on the worker thread)."""
        engine = self._engine_for(rank)
        engine.submit(*args, **kwargs)
        return engine

    def _end_span(self, span, error: bool = False) -> None:
        if span is None or self.tracer is None:
            return
        span.end(error=error)
        self.tracer.record(span)

    async def _stream(self, engine, rid: str, q: asyncio.Queue):
        """Yield the request's outputs as chunks until it finishes; a client
        that goes away mid-stream aborts it in the replica that holds it
        (queued behind the submit on the worker thread)."""
        try:
            while True:
                out = await q.get()
                yield _chunk(rid, out)
                if out.finished:
                    return
        finally:
            self._calls.submit(engine.abort, rid)

    async def Generate(self, request: pb.GenerateRequestProto, context):
        from smg_tpu_torch.engine.request import QueueFullError
        from smg_tpu_torch.faults import FAULTS

        loop = asyncio.get_running_loop()
        q: asyncio.Queue = asyncio.Queue()
        sampling = sampling_from_proto(request.sampling)
        rid = request.rid
        # worker-side failure before any engine state is touched
        FAULTS.fire("rpc.generate", rid=rid)
        traceparent = self._traceparent(context)
        span = None
        if self.tracer is not None:
            span = self.tracer.start_span("worker.generate", traceparent=traceparent)
            span.set("rid", rid)
        try:
            engine = await loop.run_in_executor(self._calls, functools.partial(
                self._submit, request.data_parallel_rank, list(request.input_ids), sampling,
                rid=rid,
                on_output=lambda out: loop.call_soon_threadsafe(q.put_nowait, out),
                mm_embeds=mm_embeds_from_proto(request.mm_embeds),
                timeout_secs=request.timeout_secs or None,
                trace_id=self._trace_id(context)))
        except QueueFullError as e:
            # admission back-pressure is retryable: the client maps it to
            # try-another-worker / HTTP 429
            self._end_span(span, error=True)
            await context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))
        except ValueError as e:
            # an invalid request (an unknown adapter, a bad pattern, a rank):
            # one terminal chunk
            self._end_span(span, error=True)
            yield pb.GenerateChunk(rid=rid, finished=True, finish_reason="error",
                                   error=str(e), matched_stop_token=-1)
            return
        except BaseException:
            self._end_span(span, error=True)
            raise
        finished = False
        try:
            async for chunk in self._stream(engine, rid, q):
                yield chunk
            finished = True
        finally:
            self._end_span(span, error=not finished)

    async def Embed(self, request: pb.EmbedRequestProto, context):
        loop = asyncio.get_running_loop()
        try:
            vec = await loop.run_in_executor(self._calls, self.engine.embed,
                                             [list(request.input_ids)])
            return pb.EmbedResponseProto(embedding=vec[0].tolist(),
                                         prompt_tokens=len(request.input_ids))
        except Exception as e:
            logger.exception("embed failed")
            return pb.EmbedResponseProto(error=str(e))

    async def EmbedBatch(self, request: pb.EmbedBatchRequestProto, context):
        loop = asyncio.get_running_loop()
        try:
            batches = [list(t.ids) for t in request.inputs]
            vecs = await loop.run_in_executor(self._calls, self.engine.embed, batches)
            resp = pb.EmbedBatchResponseProto(prompt_tokens=sum(len(b) for b in batches))
            for v in vecs:
                resp.embeddings.add(values=v.tolist())
            return resp
        except Exception as e:
            logger.exception("embed batch failed")
            return pb.EmbedBatchResponseProto(error=str(e))

    async def Encode(self, request: pb.EncodeRequestProto, context):
        """The EPD encode leg: the vision tower on pre-patchified pixels,
        inline or through a same-host shared-memory segment."""
        import numpy as np

        loop = asyncio.get_running_loop()
        try:
            n = request.n_patches * request.patch_dim
            if request.shm_name:
                from multiprocessing import resource_tracker, shared_memory

                try:
                    shm = shared_memory.SharedMemory(name=request.shm_name)
                except (FileNotFoundError, OSError) as e:
                    # the client retries inline
                    return pb.EncodeResponseProto(error=f"shm_unavailable: {e}")
                try:
                    # attached, not created: the creator unlinks
                    try:
                        resource_tracker.unregister(shm._name, "shared_memory")
                    except Exception:
                        pass
                    pixels = np.frombuffer(shm.buf[: n * 4], dtype=np.float32).reshape(
                        request.n_patches, request.patch_dim).copy()
                finally:
                    shm.close()
            else:
                pixels = np.frombuffer(request.pixel_values, dtype=np.float32).reshape(
                    request.n_patches, request.patch_dim)
            out = await loop.run_in_executor(self._calls, self.engine.encode_image, pixels,
                                             (request.grid_h, request.grid_w))
            return pb.EncodeResponseProto(
                embeds=np.ascontiguousarray(out, np.float32).tobytes(),
                rows=out.shape[0], cols=out.shape[1])
        except Exception as e:
            logger.exception("encode failed")
            return pb.EncodeResponseProto(error=str(e))

    async def PrefillExport(self, request: pb.PrefillExportRequestProto, context):
        """The PD prefill leg: the prompt's KV as host bytes, or offered for
        a pull (``transfer``: only the descriptor goes back).  A gRPC leg
        never exports by ``device``."""
        loop = asyncio.get_running_loop()
        try:
            sampling = sampling_from_proto(request.sampling)
            connector = request.connector or "host"
            if connector not in ("host", "transfer"):
                connector = "host"  # gRPC legs: bytes or pull, never local device
            result = await loop.run_in_executor(self._calls, functools.partial(
                self.engine.prefill_export, list(request.input_ids), sampling,
                connector=connector))
            if result.get("connector") == "transfer":
                desc = result["k"]
                return pb.PrefillExportResponseProto(
                    first_token=result["first_token"], seq_len=result["seq_len"],
                    kv_shape=list(desc["kv_shape"]), kv_dtype=desc["kv_dtype"],
                    transfer_address=desc["transfer_address"],
                    transfer_uuid=desc["transfer_uuid"])
            k, shape, dtype = kv_to_wire(result["k"])
            v, _, _ = kv_to_wire(result["v"])
            return pb.PrefillExportResponseProto(
                first_token=result["first_token"], seq_len=result["seq_len"],
                k=k, v=v, kv_shape=shape, kv_dtype=dtype)
        except Exception as e:
            logger.exception("prefill export failed")
            return pb.PrefillExportResponseProto(error=str(e))

    async def GeneratePrefilled(self, request: pb.GeneratePrefilledRequestProto, context):
        """The PD decode leg: import the KV (its bytes, or a pull descriptor
        the engine's ``transfer`` connector fetches device to device) and
        stream from it."""
        loop = asyncio.get_running_loop()
        q: asyncio.Queue = asyncio.Queue()
        base = request.base
        sampling = sampling_from_proto(base.sampling)
        if request.transfer_address:
            k = v = {
                "transfer_address": request.transfer_address,
                "transfer_uuid": request.transfer_uuid,
                "kv_shape": tuple(request.kv_shape),
                "kv_dtype": request.kv_dtype,
            }
        else:
            k = kv_from_wire(request.k, request.kv_shape, request.kv_dtype)
            v = kv_from_wire(request.v, request.kv_shape, request.kv_dtype)
        rid = base.rid
        await loop.run_in_executor(self._calls, functools.partial(
            self.engine.submit_prefilled, list(base.input_ids), request.first_token, k, v,
            sampling, rid=rid,
            on_output=lambda out: loop.call_soon_threadsafe(q.put_nowait, out),
            trace_id=self._trace_id(context)))
        async for chunk in self._stream(self.engine, rid, q):
            yield chunk

    async def ReleaseKvOffer(self, request: pb.KvOfferProto, context):
        """PD transfer lifecycle: consumed offers stop being tracked;
        abandoned ones are dropped (engine/kv_transfer.py)."""
        mgr = self.engine.runner.kv_transfer
        if request.consumed:
            ok = mgr.mark_consumed(request.uuid)
        else:
            ok = mgr.reclaim(request.uuid)
        return pb.AbortResponseProto(ok=ok)

    async def DumpFlight(self, request: pb.FlightDumpRequestProto, context):
        """The flight recorder's dump as JSON, off the event loop and
        without the engine lock (a wedged worker still answers).  With
        replicas, one dump each under ``engines``, beside ``dp_size`` and
        the top-level ``schema_version``."""
        import json

        from smg_tpu_torch.engine.flight_recorder import SCHEMA_VERSION

        reason = request.reason or "manual"
        try:
            dumps = await asyncio.to_thread(lambda: [e.dump_flight(reason)
                                                     for e in self.engines])
            payload = dumps[0] if len(dumps) == 1 else {
                "schema_version": SCHEMA_VERSION, "dp_size": len(dumps), "engines": dumps}
            return pb.FlightDumpResponseProto(json=json.dumps(payload))
        except Exception as e:
            logger.exception("flight dump failed")
            return pb.FlightDumpResponseProto(error=str(e))

    async def Abort(self, request: pb.AbortRequestProto, context):
        # the rid lives on one replica: try each, as the reference does
        ok = await asyncio.get_running_loop().run_in_executor(
            self._calls, lambda: any(e.abort(request.rid) for e in self.engines))
        return pb.AbortResponseProto(ok=ok)

    async def HealthCheck(self, request: pb.EmptyProto, context):
        # engine health, not process liveness
        return pb.HealthResponseProto(
            ok=all(getattr(e, "healthy", True) for e in self.engines))

    async def GetLoads(self, request: pb.EmptyProto, context):
        # the message carries fixed counters only: no audit
        per_rank = await asyncio.to_thread(
            lambda: [e.loads(include_audit=False) for e in self.engines])
        return pb.LoadsProto(
            **{k: sum(r[k] for r in per_rank) for k in (
                "num_waiting", "num_running", "free_pages", "cached_pages", "total_pages")},
            dp_queued_tokens=[r["queued_tokens"] for r in per_rank])

    async def GetModelInfo(self, request: pb.EmptyProto, context):
        cfg = self.engine.config
        msg = pb.ModelInfoProto(
            model_id=cfg.model_id, max_seq_len=cfg.scheduler.max_seq_len,
            vocab_size=cfg.model.vocab_size, eos_token_ids=list(cfg.model.eos_token_ids),
            page_size=cfg.cache.page_size, dp_size=len(self.engines))
        if self.engine.supports_vision:
            msg.supports_vision = True
            msg.image_token_id = cfg.model.image_token_id or 0
            msg.vision_patch_size = cfg.model.vision.patch_size
            msg.vision_merge_size = cfg.model.vision.merge_size
        msg.supports_kv_transfer = self.engine.runner.supports_kv_transfer
        return msg

    async def FlushCache(self, request: pb.EmptyProto, context):
        ok = await asyncio.to_thread(lambda: all(e.flush_cache() for e in self.engines))
        return pb.FlushResponseProto(ok=ok)

    async def LoadLoRAAdapter(self, request: pb.LoadLoraRequestProto, context):
        loop = asyncio.get_running_loop()
        try:
            slot = await loop.run_in_executor(self._calls, functools.partial(
                self.engine.load_lora_adapter, request.name, path=request.path or None,
                data=request.npz or None))
            return pb.LoraOpResponseProto(ok=True, slot=slot)
        except Exception as e:
            return pb.LoraOpResponseProto(ok=False, error=str(e))

    async def UnloadLoRAAdapter(self, request: pb.LoadLoraRequestProto, context):
        loop = asyncio.get_running_loop()
        try:
            ok = await loop.run_in_executor(self._calls, self.engine.unload_lora_adapter,
                                            request.name)
            err = "" if ok else f"adapter {request.name!r} not loaded"
            return pb.LoraOpResponseProto(ok=ok, error=err)
        except Exception as e:
            return pb.LoraOpResponseProto(ok=False, error=str(e))

    async def ListLoRAAdapters(self, request: pb.EmptyProto, context):
        return pb.LoraListProto(names=self.engine.list_lora_adapters())

    async def GetTokenizer(self, request: pb.EmptyProto, context):
        from smg_tpu_torch.tokenizer.bundle import make_bundle

        if self.engine.tokenizer is None:
            yield pb.TokenizerChunkProto(last=True, format="none")
            return
        data, fmt, sha = await asyncio.to_thread(make_bundle, self.engine.tokenizer)
        chunk_size = 1 << 20
        for off in range(0, max(len(data), 1), chunk_size):
            last = off + chunk_size >= len(data)
            yield pb.TokenizerChunkProto(data=data[off : off + chunk_size], last=last,
                                         sha256=sha if last else "",
                                         format=fmt if last else "")

    async def StartProfile(self, request: pb.StartProfileRequestProto, context):
        loop = asyncio.get_running_loop()
        out_dir = request.output_dir or os.path.join(tempfile.gettempdir(), "smg_profile")
        try:
            out = await loop.run_in_executor(self._calls, functools.partial(
                self.engine.start_profile, out_dir, host_tracer=request.host_tracer,
                python_tracer=request.python_tracer, num_steps=request.num_steps))
            return pb.ProfileResponseProto(ok=True, output_dir=out)
        except Exception as e:
            return pb.ProfileResponseProto(ok=False, error=str(e))

    async def StopProfile(self, request: pb.EmptyProto, context):
        loop = asyncio.get_running_loop()
        try:
            await loop.run_in_executor(self._calls, self.engine.stop_profile)
            return pb.ProfileResponseProto(ok=True)
        except Exception as e:
            return pb.ProfileResponseProto(ok=False, error=str(e))

    async def SubscribeKvEvents(self, request: pb.KvEventsRequestProto, context):
        loop = asyncio.get_running_loop()
        q: asyncio.Queue = asyncio.Queue()
        unsub = self.engine.events.subscribe(
            lambda batch: loop.call_soon_threadsafe(q.put_nowait, batch),
            start_sequence_number=request.start_sequence_number)
        try:
            while True:
                yield kv_batch_to_proto(await q.get())
        finally:
            unsub()


#: RPC name -> (handler kind, request message, response message)
RPCS = {
    "Generate": ("unary_stream", pb.GenerateRequestProto, pb.GenerateChunk),
    "Embed": ("unary_unary", pb.EmbedRequestProto, pb.EmbedResponseProto),
    "Encode": ("unary_unary", pb.EncodeRequestProto, pb.EncodeResponseProto),
    "PrefillExport": ("unary_unary", pb.PrefillExportRequestProto,
                      pb.PrefillExportResponseProto),
    "GeneratePrefilled": ("unary_stream", pb.GeneratePrefilledRequestProto, pb.GenerateChunk),
    "EmbedBatch": ("unary_unary", pb.EmbedBatchRequestProto, pb.EmbedBatchResponseProto),
    "ReleaseKvOffer": ("unary_unary", pb.KvOfferProto, pb.AbortResponseProto),
    "DumpFlight": ("unary_unary", pb.FlightDumpRequestProto, pb.FlightDumpResponseProto),
    "Abort": ("unary_unary", pb.AbortRequestProto, pb.AbortResponseProto),
    "HealthCheck": ("unary_unary", pb.EmptyProto, pb.HealthResponseProto),
    "GetLoads": ("unary_unary", pb.EmptyProto, pb.LoadsProto),
    "GetModelInfo": ("unary_unary", pb.EmptyProto, pb.ModelInfoProto),
    "LoadLoRAAdapter": ("unary_unary", pb.LoadLoraRequestProto, pb.LoraOpResponseProto),
    "UnloadLoRAAdapter": ("unary_unary", pb.LoadLoraRequestProto, pb.LoraOpResponseProto),
    "ListLoRAAdapters": ("unary_unary", pb.EmptyProto, pb.LoraListProto),
    "GetTokenizer": ("unary_stream", pb.EmptyProto, pb.TokenizerChunkProto),
    "StartProfile": ("unary_unary", pb.StartProfileRequestProto, pb.ProfileResponseProto),
    "StopProfile": ("unary_unary", pb.EmptyProto, pb.ProfileResponseProto),
    "FlushCache": ("unary_unary", pb.EmptyProto, pb.FlushResponseProto),
    "SubscribeKvEvents": ("unary_stream", pb.KvEventsRequestProto, pb.KvEventBatchProto),
}


def _handlers(servicer: SchedulerServicer) -> grpc.GenericRpcHandler:
    make = {"unary_unary": grpc.unary_unary_rpc_method_handler,
            "unary_stream": grpc.unary_stream_rpc_method_handler}
    return grpc.method_handlers_generic_handler(SERVICE, {
        name: make[kind](getattr(servicer, name), request_deserializer=req.FromString,
                         response_serializer=resp.SerializeToString)
        for name, (kind, req, resp) in RPCS.items()})


async def serve_worker_async(engine, port: int, host: str = "0.0.0.0",
                             engines: "list | None" = None, tracer=None) -> grpc.aio.Server:
    """Start serving ``engine``, or the replicas ``engines``, on
    ``host:port`` (0 picks a free port, read back as
    ``server._bound_port``)."""
    server = grpc.aio.server(options=[
        ("grpc.max_send_message_length", MAX_MESSAGE_BYTES),
        ("grpc.max_receive_message_length", MAX_MESSAGE_BYTES),
    ])
    server.add_generic_rpc_handlers(
        (_handlers(SchedulerServicer(engine, engines=engines, tracer=tracer)),))
    bound = server.add_insecure_port(f"{host}:{port}")
    await server.start()
    logger.info("worker gRPC listening on %s:%d", host, bound)
    server._bound_port = bound
    return server


def serve_worker(engine, port: int, host: str = "0.0.0.0") -> int:
    """Serve until SIGTERM or SIGINT, then close the engine (a rank-mesh
    engine's rank processes with it: tp, pp, sp or ep)."""
    async def _main():
        server = await serve_worker_async(engine, port, host)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        try:
            import signal

            for sig in (signal.SIGTERM, signal.SIGINT):
                loop.add_signal_handler(sig, stop.set)
        except (NotImplementedError, RuntimeError, ValueError):
            pass  # not the main thread
        await stop.wait()
        await server.stop(grace=1.0)

    try:
        asyncio.run(_main())
    finally:
        engine.close()
    return 0
