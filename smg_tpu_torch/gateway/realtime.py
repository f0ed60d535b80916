"""Realtime API: the WS transport, audio input, ephemeral tokens and the
dual-leg relay — the port's copy of ``smg_tpu/gateway/realtime.py``.

Reference: ``src/routers/common/realtime/`` (SURVEY.md §2.1): three
transports, a WS proxy, a WebRTC dual-peer relay and REST token minting.
Here:

- **WS events** bridged onto the chat pipeline: session.update,
  conversation.item.create, response.create/cancel in; session.created,
  conversation.item.created, response.created, response.output_text.delta,
  response.done, error out.  A response streams from the default router
  (``ctx.router``), as the reference's does, whatever the session's model.
- **Audio input**: ``input_audio_buffer.append`` accumulates base64 PCM16
  frames (at most ``MAX_AUDIO_BUFFER_BYTES``); ``commit`` wraps them as WAV
  and runs them through a transcription-capable proxy worker (the leg
  ``/v1/audio/transcriptions`` uses), emitting
  ``conversation.item.input_audio_transcription.completed`` and feeding the
  transcript into the conversation.
- **REST token mint**: ``POST /v1/realtime/client_secrets`` issues a
  TTL-bounded ephemeral secret (``rest.rs`` ``client_secrets``); the WS
  handshake accepts it as ``?client_secret=`` (browsers cannot set WS
  headers) and checks it in the handler whenever gateway auth is on.
- **Dual-leg relay**: ``/v1/realtime/relay/{session}?leg=a|b`` pairs two
  websockets and forwards frames (text and binary audio) between them: the
  transport-agnostic analog of the WebRTC dual peer-connection relay
  (``webrtc.rs``: the gateway terminates both sides).

The request timeout (``--request-timeout-secs``) does not apply to these
websocket sessions: they are long-lived by design (``limits_middleware``).
"""

from __future__ import annotations

import base64
import json
import struct
import time
import uuid

from aiohttp import WSMsgType, web

from smg_tpu_torch.gateway.router import RouteError
from smg_tpu_torch.gateway.server import CTX
from smg_tpu_torch.protocols.openai import ChatCompletionRequest, ChatMessage, StreamOptions
from smg_tpu_torch.utils import get_logger

logger = get_logger("gateway.realtime")

#: ephemeral client secrets: value -> expiry (monotonic), minted over REST
_client_secrets: dict[str, float] = {}
EPHEMERAL_TTL_SECS = 600.0
#: per-connection input-audio cap (client_max_size bounds HTTP bodies only;
#: an uncommitted WS stream would otherwise grow without bound)
MAX_AUDIO_BUFFER_BYTES = 32 * 2**20


def mint_client_secret(ttl: float = EPHEMERAL_TTL_SECS) -> dict:
    """Issue an ephemeral realtime credential (rest.rs client_secrets)."""
    now = time.monotonic()
    for k in [k for k, exp in _client_secrets.items() if exp < now]:
        del _client_secrets[k]
    value = f"eph_{uuid.uuid4().hex}"
    _client_secrets[value] = now + ttl
    return {"value": value, "expires_at": time.time() + ttl}


def _secret_valid(value: str | None) -> bool:
    if not value:
        return False
    exp = _client_secrets.get(value)
    return exp is not None and exp >= time.monotonic()


async def h_realtime_client_secrets(request: web.Request) -> web.Response:
    secret = mint_client_secret()
    return web.json_response({
        "client_secret": secret,
        "session": {"type": "realtime"},
    })


def _authorize_ws(ctx, request: web.Request) -> bool:
    """The WS routes' credential check, in the handler (the auth middleware
    passes their handshakes through): an unexpired ephemeral secret or a
    configured API key, as ``?client_secret=`` or a bearer token, or auth
    off.  JWTs are not taken here, as in the reference."""
    if not ctx.auth.config.enabled:
        return True
    candidate = request.query.get("client_secret")
    authz = request.headers.get("Authorization", "")
    bearer = authz[7:] if authz.startswith("Bearer ") else None
    for tok in (candidate, bearer):
        if _secret_valid(tok):
            return True
        if tok and tok in ctx.auth.config.api_keys:
            return True
    return False


def pcm16_to_wav(pcm: bytes, sample_rate: int = 16000, channels: int = 1) -> bytes:
    """Wrap raw little-endian PCM16 in a WAV container."""
    byte_rate = sample_rate * channels * 2
    return b"".join([
        b"RIFF", struct.pack("<I", 36 + len(pcm)), b"WAVE",
        b"fmt ", struct.pack("<IHHIIHH", 16, 1, channels, sample_rate,
                             byte_rate, channels * 2, 16),
        b"data", struct.pack("<I", len(pcm)), pcm,
    ])


async def handle_realtime(request: web.Request) -> web.WebSocketResponse:
    ctx = request.app[CTX]
    ws = web.WebSocketResponse(heartbeat=30)
    if not _authorize_ws(ctx, request):
        await ws.prepare(request)
        await ws.send_json({"type": "error", "error": {
            "type": "authentication_error",
            "message": "missing/expired client_secret (mint one via POST "
                       "/v1/realtime/client_secrets)",
        }})
        await ws.close()
        return ws
    await ws.prepare(request)

    session_id = f"sess_{uuid.uuid4().hex[:16]}"
    session = {
        "id": session_id,
        "model": request.query.get("model", "default"),
        "instructions": None,
        "temperature": None,
        "max_output_tokens": None,
        "input_audio_sample_rate": 16000,
    }
    history: list[ChatMessage] = []
    audio_buf = bytearray()
    await ws.send_json({"type": "session.created", "session": dict(session)})

    async for msg in ws:
        if msg.type != WSMsgType.TEXT:
            if msg.type in (WSMsgType.CLOSE, WSMsgType.ERROR):
                break
            continue
        try:
            event = json.loads(msg.data)
        except json.JSONDecodeError:
            await ws.send_json({"type": "error", "error": {"message": "invalid JSON"}})
            continue
        etype = event.get("type")

        if etype == "session.update":
            patch = event.get("session", {})
            for k in ("model", "instructions", "temperature", "max_output_tokens"):
                if k in patch:
                    session[k] = patch[k]
            await ws.send_json({"type": "session.updated", "session": dict(session)})

        elif etype == "conversation.item.create":
            item = event.get("item", {})
            role = item.get("role", "user")
            content = item.get("content", [])
            if isinstance(content, list):
                text = "".join(
                    c.get("text", "") for c in content
                    if isinstance(c, dict) and c.get("type") in ("input_text", "text")
                )
            else:
                text = str(content)
            history.append(ChatMessage(role=role, content=text))
            await ws.send_json({
                "type": "conversation.item.created",
                "item": {"id": f"item_{uuid.uuid4().hex[:12]}", "role": role},
            })

        elif etype == "input_audio_buffer.append":
            try:
                frame = base64.b64decode(event.get("audio", ""))
            except Exception:
                await ws.send_json({"type": "error", "error": {
                    "message": "invalid base64 audio"}})
                continue
            if len(audio_buf) + len(frame) > MAX_AUDIO_BUFFER_BYTES:
                audio_buf.clear()
                await ws.send_json({"type": "error", "error": {
                    "message": "audio buffer limit exceeded; buffer cleared"}})
                continue
            audio_buf += frame
            await ws.send_json({"type": "input_audio_buffer.appended",
                                "bytes": len(audio_buf)})

        elif etype == "input_audio_buffer.clear":
            audio_buf.clear()
            await ws.send_json({"type": "input_audio_buffer.cleared"})

        elif etype == "input_audio_buffer.commit":
            if not audio_buf:
                await ws.send_json({"type": "error", "error": {
                    "message": "audio buffer is empty"}})
                continue
            transcript, err = await _transcribe(
                ctx, bytes(audio_buf), session
            )
            audio_buf.clear()
            item_id = f"item_{uuid.uuid4().hex[:12]}"
            await ws.send_json({"type": "input_audio_buffer.committed",
                                "item_id": item_id})
            if err is not None:
                await ws.send_json({"type": "error", "error": {"message": err}})
                continue
            history.append(ChatMessage(role="user", content=transcript))
            await ws.send_json({
                "type": "conversation.item.input_audio_transcription.completed",
                "item_id": item_id,
                "transcript": transcript,
            })

        elif etype == "response.create":
            await _run_response(ctx, ws, session, history)

        elif etype == "response.cancel":
            # responses run to completion within _run_response; nothing pending
            await ws.send_json({"type": "response.cancelled"})

        else:
            await ws.send_json({
                "type": "error",
                "error": {"message": f"unknown event type {etype!r}"},
            })
    return ws


async def _transcribe(ctx, pcm: bytes, session: dict) -> tuple[str | None, str | None]:
    """Audio buffer -> transcript via a transcription-capable proxy worker
    (the /v1/audio/transcriptions leg).  Returns (transcript, error)."""
    model = session.get("model")
    router = ctx.router_for(model if model != "default" else None)
    worker = router.select_proxy_worker(model if model != "default" else None)
    if worker is None:
        return None, ("no transcription-capable worker; register an "
                      "OpenAI-compatible audio worker")
    wav = pcm16_to_wav(pcm, sample_rate=int(session.get(
        "input_audio_sample_rate", 16000)))
    guard = worker.acquire()
    ok = False
    try:
        data = await worker.client.post_multipart(
            "/v1/audio/transcriptions", {"model": model or "default"},
            wav, filename="realtime.wav", content_type="audio/wav",
        )
        ok = True
    except Exception as e:
        return None, f"transcription worker error: {e}"
    finally:
        guard.release(success=ok)
    if isinstance(data, dict):
        return str(data.get("text", "")), None
    return str(data), None


# ---- dual-leg relay (WebRTC-relay analog) ----


class RelaySession:
    def __init__(self, session_id: str):
        self.id = session_id
        self.legs: dict[str, web.WebSocketResponse] = {}
        self.created_at = time.monotonic()


class RealtimeRegistry:
    """Pairs relay legs by session id (reference: registry.rs).  The
    gateway terminates BOTH connections and forwards frames between them —
    text and binary (audio) alike."""

    def __init__(self, ttl: float = 3600.0):
        self.ttl = ttl
        self._sessions: dict[str, RelaySession] = {}

    def _evict(self) -> None:
        now = time.monotonic()
        for sid in [sid for sid, s in self._sessions.items()
                    if now - s.created_at > self.ttl]:
            del self._sessions[sid]

    def join(self, session_id: str, leg: str, ws) -> RelaySession:
        self._evict()
        s = self._sessions.setdefault(session_id, RelaySession(session_id))
        s.legs[leg] = ws
        return s

    def leave(self, session_id: str, leg: str, ws=None) -> None:
        s = self._sessions.get(session_id)
        if s is not None:
            # identity check: a reconnected leg must not be evicted by the
            # OLD connection's late cleanup
            if ws is None or s.legs.get(leg) is ws:
                s.legs.pop(leg, None)
            if not s.legs:
                self._sessions.pop(session_id, None)


_relay_registry = RealtimeRegistry()


async def handle_realtime_relay(request: web.Request) -> web.WebSocketResponse:
    ctx = request.app[CTX]
    ws = web.WebSocketResponse(heartbeat=30)
    if not _authorize_ws(ctx, request):
        await ws.prepare(request)
        await ws.send_json({"type": "error", "error": {
            "type": "authentication_error", "message": "unauthorized"}})
        await ws.close()
        return ws
    await ws.prepare(request)
    session_id = request.match_info["session_id"]
    leg = request.query.get("leg", "a")
    if leg not in ("a", "b"):
        await ws.send_json({"type": "error", "error": {"message": "leg must be a|b"}})
        await ws.close()
        return ws
    sess = _relay_registry.join(session_id, leg, ws)
    other_leg = "b" if leg == "a" else "a"
    await ws.send_json({"type": "relay.joined", "session_id": session_id,
                        "leg": leg, "peer_connected": other_leg in sess.legs})
    peer = sess.legs.get(other_leg)
    if peer is not None and not peer.closed:
        await peer.send_json({"type": "relay.peer_connected", "leg": leg})
    try:
        async for msg in ws:
            peer = sess.legs.get(other_leg)
            if msg.type == WSMsgType.TEXT:
                if peer is not None and not peer.closed:
                    await peer.send_str(msg.data)
            elif msg.type == WSMsgType.BINARY:
                # audio frames relay verbatim — the legs own the codec
                if peer is not None and not peer.closed:
                    await peer.send_bytes(msg.data)
            elif msg.type in (WSMsgType.CLOSE, WSMsgType.ERROR):
                break
    finally:
        _relay_registry.leave(session_id, leg, ws)
        peer = sess.legs.get(other_leg)
        if peer is not None and not peer.closed:
            try:
                await peer.send_json({"type": "relay.peer_disconnected", "leg": leg})
            except Exception:
                pass
    return ws


async def _run_response(ctx, ws, session: dict, history: list[ChatMessage]) -> None:
    rid = f"resp_{uuid.uuid4().hex[:16]}"
    messages = list(history)
    if session.get("instructions"):
        messages.insert(0, ChatMessage(role="system", content=session["instructions"]))
    req = ChatCompletionRequest(
        model=session.get("model") or "default",
        messages=messages,
        temperature=session.get("temperature"),
        max_tokens=session.get("max_output_tokens"),
        stream=True,
        stream_options=StreamOptions(include_usage=True),
    )
    await ws.send_json({"type": "response.created", "response": {"id": rid}})
    parts: list[str] = []
    usage = None
    try:
        async for chunk in ctx.router.chat_stream(req, request_id=rid):
            if chunk.usage is not None:
                usage = {
                    "input_tokens": chunk.usage.prompt_tokens,
                    "output_tokens": chunk.usage.completion_tokens,
                }
                continue
            for ch in chunk.choices:
                if ch.delta.content:
                    parts.append(ch.delta.content)
                    await ws.send_json({
                        "type": "response.output_text.delta",
                        "response_id": rid,
                        "delta": ch.delta.content,
                    })
    except RouteError as e:
        await ws.send_json({"type": "error", "error": {"message": e.message}})
        return
    text = "".join(parts)
    history.append(ChatMessage(role="assistant", content=text))
    await ws.send_json({
        "type": "response.done",
        "response": {"id": rid, "output_text": text, "usage": usage},
    })
