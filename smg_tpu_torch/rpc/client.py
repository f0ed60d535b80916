"""Gateway-side gRPC worker client — the port's copy of
``smg_tpu/rpc/client.py``: every call of the in-process client over the
scheduler protocol (channel reuse, abort-on-drop, KV-event subscription,
the remaining deadline on the proto, ``RESOURCE_EXHAUSTED`` as queue-full),
with grpc.aio and hand-wired method stubs.  The PD legs move the KV as host
bytes (``rpc/convert.py``) or, with the ``transfer`` connector, as a pull
descriptor the decode worker fetches device to device; ``release_kv_offer``
signals an offer's outcome to the prefill worker.  A request carries the replica the
router's DP policy pinned (``data_parallel_rank``), -1 when it pinned none.
"""

from __future__ import annotations

import asyncio
from typing import AsyncIterator

import grpc
import grpc.aio

from smg_tpu_torch.gateway.worker_client import (
    WorkerClient,
    WorkerGenerateRequest,
    WorkerQueueFullError,
    WorkerStreamChunk,
)
from smg_tpu_torch.rpc import method
from smg_tpu_torch.rpc import scheduler_pb2 as pb
from smg_tpu_torch.rpc.convert import (
    kv_batch_from_proto,
    kv_from_wire,
    kv_to_wire,
    mm_embeds_to_proto,
    sampling_to_proto,
)
from smg_tpu_torch.utils import get_logger

logger = get_logger("rpc.client")


class StreamIdleTimeout(RuntimeError):
    """No chunk arrived within the idle window: treated as a worker failure
    so the router's retry/breaker path engages (a stream that stops making
    progress is indistinguishable from a dead worker)."""


async def iter_with_idle_timeout(
    call,
    idle_timeout_secs: float | None,
    url: str,
    first_chunk_timeout_secs: float | None = None,
):
    """Yield chunks from a gRPC stream, bounding the INTER-chunk gap.

    Replaces the old whole-stream 600s cap, which both killed legitimate
    long generations and let a silently-wedged worker hold a client for ten
    minutes.  A healthy stream emits a chunk every engine step once decoding
    starts, so mid-stream silence of ``idle_timeout_secs`` is a worker
    fault.  The FIRST chunk legitimately waits behind the worker's queue +
    prefill — bounding it with the idle window would record merely-busy
    workers as breaker failures at peak load — so it gets the separate
    (longer) ``first_chunk_timeout_secs`` wedge backstop.  ``None``/0
    disables either bound."""
    it = call.__aiter__()
    bound = first_chunk_timeout_secs
    while True:
        try:
            if bound and bound > 0:
                chunk = await asyncio.wait_for(it.__anext__(), bound)
            else:
                chunk = await it.__anext__()
        except StopAsyncIteration:
            return
        except asyncio.TimeoutError:
            call.cancel()
            raise StreamIdleTimeout(
                f"worker {url}: no stream chunk for {bound:.0f}s"
            ) from None
        bound = idle_timeout_secs
        yield chunk


class GrpcWorkerClient(WorkerClient):
    #: inter-chunk idle bound on generate streams (seconds; None/0
    #: disables).  Class-level so ``--worker-stream-idle-timeout-secs``
    #: configures every client the gateway dials (same pattern as
    #: ``mm_transport``).
    idle_timeout_secs: "float | None" = 120.0
    #: wedge backstop for the FIRST chunk only (queue wait + prefill are
    #: legitimate latency, not silence — see iter_with_idle_timeout)
    first_chunk_timeout_secs: "float | None" = 600.0
    #: per-call timeouts, threaded from config instead of scattered
    #: literals: ``unary`` covers hot control-plane calls (health / abort /
    #: loads), ``setup`` covers registration-time metadata (model info,
    #: flush, adapter list, profile start), ``bulk`` covers payload-heavy
    #: calls (embed, encode, prefill export, tokenizer/LoRA transfer)
    unary_timeout_secs: float = 5.0
    setup_timeout_secs: float = 30.0
    bulk_timeout_secs: float = 600.0

    @staticmethod
    def _trace_metadata():
        """gRPC metadata carrying the ambient span's traceparent, or None."""
        from smg_tpu_torch.gateway.tracing import ambient_traceparent

        tp = ambient_traceparent()
        return (("traceparent", tp),) if tp else None

    def __init__(self, url: str):
        if "://" in url:
            url = url.split("://", 1)[1]
        self.url = url
        self._channel = grpc.aio.insecure_channel(
            url,
            options=[
                ("grpc.max_send_message_length", 512 * 1024 * 1024),
                ("grpc.max_receive_message_length", 512 * 1024 * 1024),
                ("grpc.keepalive_time_ms", 30000),
            ],
        )
        c = self._channel
        self._generate = c.unary_stream(
            method("Generate"),
            request_serializer=pb.GenerateRequestProto.SerializeToString,
            response_deserializer=pb.GenerateChunk.FromString,
        )
        self._embed = c.unary_unary(
            method("Embed"),
            request_serializer=pb.EmbedRequestProto.SerializeToString,
            response_deserializer=pb.EmbedResponseProto.FromString,
        )
        self._embed_batch = c.unary_unary(
            method("EmbedBatch"),
            request_serializer=pb.EmbedBatchRequestProto.SerializeToString,
            response_deserializer=pb.EmbedBatchResponseProto.FromString,
        )
        self._encode = c.unary_unary(
            method("Encode"),
            request_serializer=pb.EncodeRequestProto.SerializeToString,
            response_deserializer=pb.EncodeResponseProto.FromString,
        )
        self._prefill_export = c.unary_unary(
            method("PrefillExport"),
            request_serializer=pb.PrefillExportRequestProto.SerializeToString,
            response_deserializer=pb.PrefillExportResponseProto.FromString,
        )
        self._generate_prefilled = c.unary_stream(
            method("GeneratePrefilled"),
            request_serializer=pb.GeneratePrefilledRequestProto.SerializeToString,
            response_deserializer=pb.GenerateChunk.FromString,
        )
        self._load_lora = c.unary_unary(
            method("LoadLoRAAdapter"),
            request_serializer=pb.LoadLoraRequestProto.SerializeToString,
            response_deserializer=pb.LoraOpResponseProto.FromString,
        )
        self._unload_lora = c.unary_unary(
            method("UnloadLoRAAdapter"),
            request_serializer=pb.LoadLoraRequestProto.SerializeToString,
            response_deserializer=pb.LoraOpResponseProto.FromString,
        )
        self._list_lora = c.unary_unary(
            method("ListLoRAAdapters"),
            request_serializer=pb.EmptyProto.SerializeToString,
            response_deserializer=pb.LoraListProto.FromString,
        )
        self._get_tokenizer = c.unary_stream(
            method("GetTokenizer"),
            request_serializer=pb.EmptyProto.SerializeToString,
            response_deserializer=pb.TokenizerChunkProto.FromString,
        )
        self._start_profile = c.unary_unary(
            method("StartProfile"),
            request_serializer=pb.StartProfileRequestProto.SerializeToString,
            response_deserializer=pb.ProfileResponseProto.FromString,
        )
        self._stop_profile = c.unary_unary(
            method("StopProfile"),
            request_serializer=pb.EmptyProto.SerializeToString,
            response_deserializer=pb.ProfileResponseProto.FromString,
        )
        self._dump_flight = c.unary_unary(
            method("DumpFlight"),
            request_serializer=pb.FlightDumpRequestProto.SerializeToString,
            response_deserializer=pb.FlightDumpResponseProto.FromString,
        )
        self._release_kv_offer = c.unary_unary(
            method("ReleaseKvOffer"),
            request_serializer=pb.KvOfferProto.SerializeToString,
            response_deserializer=pb.AbortResponseProto.FromString,
        )
        self._abort = c.unary_unary(
            method("Abort"),
            request_serializer=pb.AbortRequestProto.SerializeToString,
            response_deserializer=pb.AbortResponseProto.FromString,
        )
        self._health = c.unary_unary(
            method("HealthCheck"),
            request_serializer=pb.EmptyProto.SerializeToString,
            response_deserializer=pb.HealthResponseProto.FromString,
        )
        self._get_loads = c.unary_unary(
            method("GetLoads"),
            request_serializer=pb.EmptyProto.SerializeToString,
            response_deserializer=pb.LoadsProto.FromString,
        )
        self._model_info = c.unary_unary(
            method("GetModelInfo"),
            request_serializer=pb.EmptyProto.SerializeToString,
            response_deserializer=pb.ModelInfoProto.FromString,
        )
        self._flush = c.unary_unary(
            method("FlushCache"),
            request_serializer=pb.EmptyProto.SerializeToString,
            response_deserializer=pb.FlushResponseProto.FromString,
        )
        self._kv_events = c.unary_stream(
            method("SubscribeKvEvents"),
            request_serializer=pb.KvEventsRequestProto.SerializeToString,
            response_deserializer=pb.KvEventBatchProto.FromString,
        )
        self._kv_tasks: list[asyncio.Task] = []

    async def generate(self, req: WorkerGenerateRequest) -> AsyncIterator[WorkerStreamChunk]:
        # proto sentinel: 0 = "no deadline", so an EXHAUSTED budget (0.0s
        # remaining after retries ate it) must round up to a tiny positive
        # value — sending 0.0 verbatim would invert "expired" into
        # "unlimited" on the worker
        budget = getattr(req, "timeout_secs", None)
        msg = pb.GenerateRequestProto(
            rid=req.rid, input_ids=req.input_ids,
            sampling=sampling_to_proto(req.sampling),
            data_parallel_rank=req.data_parallel_rank,
            timeout_secs=0.0 if budget is None else max(budget, 1e-3),
        )
        mm = mm_embeds_to_proto(getattr(req, "mm_embeds", None))
        if mm is not None:
            msg.mm_embeds.CopyFrom(mm)
        # W3C trace propagation over the worker hop: the gateway's ambient
        # request span rides gRPC metadata, so worker-side spans and the
        # engine's flight-recorder timeline join the SAME trace instead of
        # each worker hop rooting a fresh one
        call = self._generate(msg, metadata=self._trace_metadata())
        try:
            async for chunk in iter_with_idle_timeout(
                call, self.idle_timeout_secs, self.url,
                first_chunk_timeout_secs=self.first_chunk_timeout_secs,
            ):
                if chunk.error:
                    raise RuntimeError(f"worker error: {chunk.error}")
                yield WorkerStreamChunk(
                    rid=chunk.rid,
                    token_ids=list(chunk.token_ids),
                    logprobs=list(chunk.logprobs),
                    finished=chunk.finished,
                    finish_reason=chunk.finish_reason or None,
                    matched_stop=(
                        chunk.matched_stop_token if chunk.matched_stop_token >= 0 else None
                    ),
                    prompt_tokens=chunk.prompt_tokens,
                    cached_tokens=chunk.cached_tokens,
                    output_tokens=chunk.output_tokens,
                )
        except grpc.aio.AioRpcError as e:
            if e.code() == grpc.StatusCode.RESOURCE_EXHAUSTED:
                # engine admission backpressure: retryable-elsewhere, not a
                # worker fault (the router leaves the breaker alone)
                raise WorkerQueueFullError(e.details() or "worker queue full") from e
            raise
        finally:
            call.cancel()

    async def prefill_export(self, input_ids: list, sampling, connector: str = "host") -> dict:
        """The PD prefill leg over gRPC: the KV comes back as host bytes,
        rebuilt as CPU tensors, or with ``transfer`` as a pull descriptor
        the decode worker fetches device to device."""
        if connector == "device":
            logger.warning("kv connector 'device' requested but %s is a gRPC transport; "
                           "staging KV via host bytes", self.url)
            connector = "host"
        resp = await self._prefill_export(
            pb.PrefillExportRequestProto(
                rid="prefill", input_ids=input_ids,
                sampling=sampling_to_proto(sampling), connector=connector,
            ),
            timeout=self.bulk_timeout_secs,
        )
        if resp.error:
            raise RuntimeError(f"prefill export error: {resp.error}")
        if resp.transfer_address:
            desc = {
                "transfer_address": resp.transfer_address,
                "transfer_uuid": resp.transfer_uuid,
                "kv_shape": tuple(resp.kv_shape),
                "kv_dtype": resp.kv_dtype,
            }
            return {"first_token": resp.first_token, "seq_len": resp.seq_len,
                    "k": desc, "v": desc, "connector": "transfer"}
        return {
            "first_token": resp.first_token,
            "seq_len": resp.seq_len,
            "k": kv_from_wire(resp.k, resp.kv_shape, resp.kv_dtype),
            "v": kv_from_wire(resp.v, resp.kv_shape, resp.kv_dtype),
            "connector": "host",
        }

    async def generate_prefilled(self, req, first_token: int, k, v):
        msg = pb.GeneratePrefilledRequestProto(
            base=pb.GenerateRequestProto(
                rid=req.rid, input_ids=req.input_ids,
                sampling=sampling_to_proto(req.sampling),
            ),
            first_token=first_token,
        )
        if isinstance(k, dict) and "transfer_address" in k:
            msg.transfer_address = k["transfer_address"]
            msg.transfer_uuid = int(k["transfer_uuid"])
            msg.kv_shape.extend(list(k["kv_shape"]))
            msg.kv_dtype = k["kv_dtype"]
        else:
            msg.k, shape, msg.kv_dtype = kv_to_wire(k)
            msg.v = kv_to_wire(v)[0]
            msg.kv_shape.extend(shape)
        # same trace propagation as generate(): the PD decode leg's timeline
        # must link to the request's trace too
        call = self._generate_prefilled(msg, metadata=self._trace_metadata())
        try:
            async for chunk in iter_with_idle_timeout(
                call, self.idle_timeout_secs, self.url,
                first_chunk_timeout_secs=self.first_chunk_timeout_secs,
            ):
                if chunk.error:
                    raise RuntimeError(f"worker error: {chunk.error}")
                yield WorkerStreamChunk(
                    rid=chunk.rid,
                    token_ids=list(chunk.token_ids),
                    logprobs=list(chunk.logprobs),
                    finished=chunk.finished,
                    finish_reason=chunk.finish_reason or None,
                    matched_stop=(
                        chunk.matched_stop_token if chunk.matched_stop_token >= 0 else None
                    ),
                    prompt_tokens=chunk.prompt_tokens,
                    cached_tokens=chunk.cached_tokens,
                    output_tokens=chunk.output_tokens,
                )
        finally:
            call.cancel()

    async def embed(self, batches: list) -> list:
        """batches: list[list[int]] -> list[list[float]] (one RPC)."""
        req = pb.EmbedBatchRequestProto(rid="embed")
        for ids in batches:
            req.inputs.add(ids=ids)
        resp = await self._embed_batch(req, timeout=self.bulk_timeout_secs)
        if resp.error:
            raise RuntimeError(f"worker embed error: {resp.error}")
        return [list(v.values) for v in resp.embeddings]

    #: mm pixel transport: "inline" | "shm" | "auto" (reference ladder,
    #: main.rs:319-328).  auto = shm for loopback workers above the
    #: threshold; payloads below ride inline either way.
    mm_transport = "auto"
    mm_shm_min_bytes = 1 << 20

    def _same_host(self) -> bool:
        host = self.url.rsplit(":", 1)[0]
        return host in ("127.0.0.1", "localhost", "::1", "[::1]")

    async def encode_image(self, pixel_values, grid: tuple) -> "object":
        import numpy as np

        pixels = np.ascontiguousarray(np.asarray(pixel_values, np.float32))
        use_shm = (
            self.mm_transport == "shm"
            or (self.mm_transport == "auto"
                and pixels.nbytes >= self.mm_shm_min_bytes
                and self._same_host())
        )
        shm = None
        msg = pb.EncodeRequestProto(
            rid="encode",
            n_patches=pixels.shape[0], patch_dim=pixels.shape[1],
            grid_h=int(grid[0]), grid_w=int(grid[1]),
        )
        if use_shm:
            from multiprocessing import shared_memory

            try:
                shm = shared_memory.SharedMemory(create=True, size=pixels.nbytes)
                # zero-extra-copy write: view the segment as the target
                # array instead of materializing tobytes() first
                np.ndarray(pixels.shape, np.float32, buffer=shm.buf)[:] = pixels
                msg.shm_name = shm.name
            except OSError:
                shm = None  # /dev/shm unavailable: fall back to inline
        if shm is None:
            msg.pixel_values = pixels.tobytes()
        try:
            resp = await self._encode(msg, timeout=self.bulk_timeout_secs)
            if (shm is not None and resp.error
                    and resp.error.startswith("shm_unavailable")):
                # loopback address but no shared /dev/shm (worker in a
                # container): transparent inline retry, once
                logger.warning(
                    "worker %s cannot open shm segments; retrying inline "
                    "(set --mm-transport inline to skip the probe)", self.url,
                )
                msg.shm_name = ""
                msg.pixel_values = pixels.tobytes()
                resp = await self._encode(msg, timeout=self.bulk_timeout_secs)
        finally:
            if shm is not None:
                shm.close()
                try:
                    shm.unlink()
                except FileNotFoundError:
                    pass
        if resp.error:
            raise RuntimeError(f"worker encode error: {resp.error}")
        return np.frombuffer(resp.embeds, dtype=np.float32).reshape(
            resp.rows, resp.cols
        )

    async def release_kv_offer(self, uuid: int, consumed: bool) -> bool:
        try:
            resp = await self._release_kv_offer(
                pb.KvOfferProto(uuid=int(uuid), consumed=consumed),
                timeout=self.setup_timeout_secs,
            )
            return resp.ok
        except grpc.aio.AioRpcError:
            return False

    async def dump_flight(self, reason: str = "manual") -> dict:
        """Fetch the worker's flight-recorder dump (postmortem black box).
        ``setup`` timeout class: a dump is a diagnostic document, not a
        hot-path call, and a wedged worker may be slow to serialize it."""
        import json

        resp = await self._dump_flight(
            pb.FlightDumpRequestProto(reason=reason),
            timeout=self.setup_timeout_secs,
        )
        if resp.error:
            raise RuntimeError(f"worker flight dump error: {resp.error}")
        return json.loads(resp.json)

    async def abort(self, rid: str) -> bool:
        try:
            resp = await self._abort(
                pb.AbortRequestProto(rid=rid), timeout=self.unary_timeout_secs
            )
            return resp.ok
        except grpc.aio.AioRpcError:
            return False

    async def health(self) -> bool:
        try:
            resp = await self._health(pb.EmptyProto(), timeout=self.unary_timeout_secs)
            return resp.ok
        except grpc.aio.AioRpcError:
            return False

    async def get_loads(self) -> dict:
        resp = await self._get_loads(pb.EmptyProto(), timeout=self.unary_timeout_secs)
        return {
            "num_waiting": resp.num_waiting,
            "num_running": resp.num_running,
            "free_pages": resp.free_pages,
            "cached_pages": resp.cached_pages,
            "total_pages": resp.total_pages,
            "dp_queued_tokens": list(resp.dp_queued_tokens),
        }

    async def get_model_info(self) -> dict:
        resp = await self._model_info(pb.EmptyProto(), timeout=self.setup_timeout_secs)
        info = {
            "model_id": resp.model_id,
            "max_seq_len": resp.max_seq_len,
            "vocab_size": resp.vocab_size,
            "eos_token_ids": list(resp.eos_token_ids),
            "page_size": resp.page_size,
            "dp_size": resp.dp_size or 1,
            "supports_vision": resp.supports_vision,
            "supports_kv_transfer": resp.supports_kv_transfer,
        }
        if resp.supports_vision:
            info.update(
                image_token_id=resp.image_token_id,
                vision_patch_size=resp.vision_patch_size,
                vision_merge_size=resp.vision_merge_size,
            )
        return info

    async def flush_cache(self) -> bool:
        resp = await self._flush(pb.EmptyProto(), timeout=self.setup_timeout_secs)
        return resp.ok

    async def load_lora_adapter(
        self, name: str, path: str | None = None, data: bytes | None = None
    ) -> dict:
        resp = await self._load_lora(
            pb.LoadLoraRequestProto(name=name, path=path or "", npz=data or b""),
            timeout=self.bulk_timeout_secs,
        )
        return {"ok": resp.ok, "error": resp.error, "slot": resp.slot}

    async def unload_lora_adapter(self, name: str) -> dict:
        resp = await self._unload_lora(
            pb.LoadLoraRequestProto(name=name), timeout=self.setup_timeout_secs
        )
        return {"ok": resp.ok, "error": resp.error}

    async def list_lora_adapters(self) -> list[str]:
        resp = await self._list_lora(pb.EmptyProto(), timeout=self.setup_timeout_secs)
        return list(resp.names)

    async def get_tokenizer(self):
        """Fetch the worker's tokenizer bundle; returns a tokenizer or None."""
        from smg_tpu_torch.tokenizer.bundle import load_bundle

        parts: list[bytes] = []
        fmt = sha = ""
        async for chunk in self._get_tokenizer(
            pb.EmptyProto(), timeout=self.bulk_timeout_secs
        ):
            if chunk.data:
                parts.append(chunk.data)
            if chunk.last:
                fmt, sha = chunk.format, chunk.sha256
        if fmt in ("", "none"):
            return None
        return load_bundle(b"".join(parts), fmt, sha or None)

    async def start_profile(
        self, output_dir: str, host_tracer: bool = True,
        python_tracer: bool = False, num_steps: int = 0,
    ) -> dict:
        resp = await self._start_profile(
            pb.StartProfileRequestProto(
                output_dir=output_dir,
                host_tracer=host_tracer,
                python_tracer=python_tracer,
                num_steps=num_steps,
            ),
            timeout=self.setup_timeout_secs,
        )
        return {"ok": resp.ok, "error": resp.error, "output_dir": resp.output_dir}

    async def stop_profile(self) -> dict:
        resp = await self._stop_profile(
            pb.EmptyProto(), timeout=self.setup_timeout_secs
        )
        return {"ok": resp.ok, "error": resp.error}

    def subscribe_kv_events(self, callback):
        """Spawn a background task streaming KV events into ``callback``."""
        stop = asyncio.Event()

        async def pump():
            seq = 0
            while not stop.is_set():
                try:
                    call = self._kv_events(pb.KvEventsRequestProto(start_sequence_number=seq))
                    async for batch in call:
                        if stop.is_set():
                            call.cancel()
                            break
                        seq = batch.sequence_number
                        callback(kv_batch_from_proto(batch))
                except grpc.aio.AioRpcError as e:
                    if stop.is_set():
                        break
                    logger.warning("kv-event stream to %s dropped (%s); resuming at %d",
                                   self.url, e.code(), seq)
                if not stop.is_set():
                    # backoff also covers clean stream ends (re-dial loop)
                    await asyncio.sleep(1.0)

        try:
            loop = asyncio.get_running_loop()
            task = loop.create_task(pump())
            self._kv_tasks.append(task)
        except RuntimeError:
            # no running loop (sync context): subscription starts when the
            # gateway loop runs; caller should re-subscribe from async code
            logger.warning("subscribe_kv_events called outside event loop; ignored")
            return lambda: None

        def unsubscribe():
            stop.set()
            task.cancel()

        return unsubscribe

    async def close(self) -> None:
        for t in self._kv_tasks:
            t.cancel()
        await self._channel.close()
