"""HTTP engine-worker transport — the port's copy of
``smg_tpu/gateway/http_worker.py``: proxy OpenAI-format traffic to workers
that speak HTTP instead of the token-level gRPC scheduler protocol.

Reference: the HTTP router path (``model_gateway/src/routers/http/router.rs``):
engines exposing an OpenAI-compatible HTTP server (the port's own ``serve``
among them) are fronted directly: the gateway does NOT tokenize, it selects
a worker by policy and forwards the request, re-streaming the worker's SSE.
Workers keep full registry citizenship (health loop, circuit breaker, load
guard, routing policies); only the wire differs (``proxy_mode`` marks the
client so the token-level router never selects it).
"""

from __future__ import annotations

import json
from typing import Any, AsyncIterator

import aiohttp

from smg_tpu_torch.gateway.worker_client import WorkerClient


async def iter_sse_data(resp: aiohttp.ClientResponse) -> AsyncIterator[str]:
    """Yield the payload of each ``data:`` SSE frame (multi-line aware);
    the reference's, from ``smg_tpu/gateway/providers/base.py``."""
    buf: list[str] = []
    async for raw in resp.content:
        line = raw.decode("utf-8", errors="replace").rstrip("\r\n")
        if line.startswith("data:"):
            buf.append(line[5:].lstrip())
        elif line == "" and buf:
            yield "\n".join(buf)
            buf = []
    if buf:
        yield "\n".join(buf)


class HttpWorkerError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


class HttpWorkerClient(WorkerClient):
    """Text-level passthrough transport for OpenAI-compatible HTTP workers."""

    proxy_mode = True
    supports_device_kv = False

    def __init__(self, url: str, timeout_s: float = 300.0, api_key: str = ""):
        if not url.startswith(("http://", "https://")):
            url = "http://" + url
        self.url = url.rstrip("/")
        self.timeout_s = timeout_s
        self.api_key = api_key
        self._session: aiohttp.ClientSession | None = None

    async def _sess(self) -> aiohttp.ClientSession:
        if self._session is None or self._session.closed:
            self._session = aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(total=self.timeout_s)
            )
        return self._session

    def _headers(self) -> dict[str, str]:
        h = {"content-type": "application/json"}
        if self.api_key:
            h["authorization"] = f"Bearer {self.api_key}"
        return h

    # ---- registry-facing control plane ----

    async def health(self) -> bool:
        s = await self._sess()
        for path in ("/health", "/v1/models"):
            try:
                async with s.get(
                    f"{self.url}{path}",
                    timeout=aiohttp.ClientTimeout(total=5),
                ) as resp:
                    if resp.status == 200:
                        return True
            except Exception:
                continue
        return False

    async def get_model_info(self) -> dict:
        s = await self._sess()
        # engine-style info endpoint first (richer), then OpenAI model list
        try:
            async with s.get(f"{self.url}/get_model_info") as resp:
                if resp.status == 200:
                    data = await resp.json()
                    mid = data.get("model_path") or data.get("model_id") or "default"
                    return {"model_id": mid.rsplit("/", 1)[-1], **data}
        except Exception:
            pass
        async with s.get(f"{self.url}/v1/models") as resp:
            if resp.status != 200:
                raise HttpWorkerError(resp.status, await resp.text())
            data = await resp.json()
            models = data.get("data") or []
            mid = models[0]["id"] if models else "default"
            return {"model_id": mid}

    async def get_loads(self) -> dict:
        s = await self._sess()
        try:
            async with s.get(f"{self.url}/get_load") as resp:
                if resp.status == 200:
                    data = await resp.json()
                    if isinstance(data, list) and data:
                        data = data[0]
                    return {
                        "num_waiting": int(data.get("num_waiting_reqs", 0)),
                        "num_running": int(data.get("num_running_reqs", 0)),
                        "free_pages": 0,
                        "cached_pages": 0,
                        "total_pages": 0,
                    }
        except Exception:
            pass
        return {"num_waiting": 0, "num_running": 0, "free_pages": 0,
                "cached_pages": 0, "total_pages": 0}

    async def flush_cache(self) -> bool:
        s = await self._sess()
        try:
            async with s.post(f"{self.url}/flush_cache") as resp:
                return resp.status == 200
        except Exception:
            return False

    async def abort(self, rid: str) -> bool:
        # HTTP transport has no abort RPC: closing the response stream is the
        # cancellation signal (aiohttp does this when the iterator is dropped)
        return False

    # ---- text-level data plane (OpenAI wire passthrough) ----

    async def post_json(self, path: str, body: dict[str, Any]) -> dict[str, Any]:
        s = await self._sess()
        async with s.post(
            f"{self.url}{path}", json=body, headers=self._headers()
        ) as resp:
            if resp.status != 200:
                raise HttpWorkerError(resp.status, await resp.text())
            return await resp.json()

    async def post_multipart(
        self, path: str, fields: dict[str, str], file_bytes: bytes,
        filename: str = "audio.wav", file_field: str = "file",
        content_type: str = "application/octet-stream",
    ) -> dict[str, Any] | str:
        """multipart/form-data forward (the transcription wire format —
        reference: /v1/audio/transcriptions carries the audio out-of-band).
        Returns parsed JSON, or raw text for text-ish response formats."""
        form = aiohttp.FormData()
        for k, v in fields.items():
            # list values become repeated form parts (e.g. the OpenAI
            # timestamp_granularities[] convention)
            for item in (v if isinstance(v, (list, tuple)) else [v]):
                form.add_field(k, str(item))
        form.add_field(file_field, file_bytes, filename=filename,
                       content_type=content_type)
        # NOT self._headers(): its content-type json would clobber the
        # multipart boundary aiohttp sets from the FormData
        headers = {}
        if self.api_key:
            headers["authorization"] = f"Bearer {self.api_key}"
        s = await self._sess()
        async with s.post(
            f"{self.url}{path}", data=form, headers=headers
        ) as resp:
            if resp.status != 200:
                raise HttpWorkerError(resp.status, await resp.text())
            if "json" in (resp.headers.get("Content-Type") or ""):
                return await resp.json()
            return await resp.text()

    async def stream_sse(
        self, path: str, body: dict[str, Any]
    ) -> AsyncIterator[dict[str, Any]]:
        s = await self._sess()
        async with s.post(
            f"{self.url}{path}", json=body, headers=self._headers()
        ) as resp:
            if resp.status != 200:
                raise HttpWorkerError(resp.status, await resp.text())
            async for data in iter_sse_data(resp):
                if data.strip() == "[DONE]":
                    return
                try:
                    chunk = json.loads(data)
                except ValueError:
                    continue
                if isinstance(chunk, dict):
                    yield chunk

    async def close(self) -> None:
        if self._session is not None and not self._session.closed:
            await self._session.close()
