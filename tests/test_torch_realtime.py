"""The Realtime API on the port against the reference, on the CPU.

- Sessions over ``/v1/realtime`` through both apps (``smg_tpu.gateway.
  server.build_app`` over a tiny JAX ``Engine``, the port's over a tiny port
  ``Engine`` with the same weights; ``test_torch_messages.Pair``) at
  temperature 0: every event either app sends, in order, identical once ids
  are canonicalised; text turns whose joined deltas are ``response.done``'s
  text and equal the direct chat on the same history; the error events
  (unknown type, invalid JSON, bad base64, an empty commit, the audio
  buffer's cap) after which the session keeps working.
- Audio: PCM16 frames appended and committed reach an ASR server (a fake
  registered through ``POST /workers``) as ``pcm16_to_wav`` of the frames,
  byte for byte; the transcript event and the response on it equal the
  reference's.  ``pcm16_to_wav`` is byte-equal to the reference on seeded
  PCM and reads back through ``wave``.
- Client secrets (mint, expiry, the handshake with auth on) and the relay
  (text and binary frames byte for byte, the peer notices), as the
  reference's.
- The websocket exemption from ``--request-timeout-secs``: with a timeout
  shorter than the session, a realtime session and a relay pair outlive it
  on both apps while a slow HTTP chat still gets its 408.
- The route table: every route of the reference's app exists on the port's.

The reference's eight cases (``tests/test_realtime.py``) are among these,
each run on both apps.
"""

import asyncio
import base64
import hashlib
import io
import re
import wave

import numpy as np
import pytest
from aiohttp import web
from aiohttp.test_utils import TestServer

from smg_tpu.gateway import auth as jauth
from smg_tpu.gateway import realtime as jrt
from smg_tpu.gateway import server as jserver
from smg_tpu_torch.gateway import auth as tauth
from smg_tpu_torch.gateway import realtime as trt
from smg_tpu_torch.gateway import server as tserver
from test_torch_gateway import MODEL
from test_torch_messages import SIDES, Pair

RT = (jrt, trt)
AUTH = (jauth, tauth)
IDS = re.compile(r"(sess|item|resp|eph|interaction|chatcmpl|req)[_-][0-9a-f]{12,}")
TRANSCRIPT = "w11 w12 w13"


def _canon(obj, seen: dict):
    """Ids replaced by their order of first appearance; times removed."""
    if isinstance(obj, str):
        return IDS.sub(lambda m: seen.setdefault(m.group(0), f"<{m.group(1)}{len(seen)}>"), obj)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_canon(v, seen) for v in obj)
    if isinstance(obj, dict):
        return {k: _canon(v, seen) for k, v in obj.items() if k not in ("expires_at", "created")}
    return obj


@pytest.fixture(scope="module")
def pair():
    p = Pair()
    yield p
    p.close()


class AsrServer:
    """An OpenAI-compatible audio worker: ``/v1/models``, ``/health`` and
    ``/v1/audio/transcriptions``, which records each form and answers
    ``TRANSCRIPT`` with the SHA-256 of the audio it received (plain text for
    ``response_format=text``, a 500 for ``language=fail``)."""

    def __init__(self):
        self.forms: list = []
        app = web.Application()
        app.router.add_get("/v1/models", self.models)
        app.router.add_get("/health", self.models)
        app.router.add_post("/v1/audio/transcriptions", self.transcribe)
        self.server = TestServer(app)

    async def models(self, request):
        return web.json_response({"object": "list", "data": [{"id": "whisper-x"}]})

    async def transcribe(self, request):
        fields, blob = {}, b""
        async for part in await request.multipart():
            if part.name == "file":
                blob = await part.read(decode=False)
                fields["filename"] = part.filename
            elif part.name:
                fields.setdefault(part.name, []).append(
                    (await part.read(decode=False)).decode())
        self.forms.append((fields, blob))
        if fields.get("language") == ["fail"]:
            return web.Response(status=500, text="asr down")
        if fields.get("response_format") == ["text"]:
            return web.Response(text=TRANSCRIPT, content_type="text/plain")
        return web.json_response({"text": TRANSCRIPT, "sha256": hashlib.sha256(blob).hexdigest(),
                                  "language": (fields.get("language") or [None])[0]})

    @property
    def url(self) -> str:
        return str(self.server.make_url("")).rstrip("/")


async def _until(ws, last: tuple) -> list:
    """Events from ``ws`` up to and including one whose type is in ``last``."""
    out = []
    while True:
        ev = await ws.receive_json(timeout=60)
        out.append(ev)
        if ev["type"] in last:
            return out


async def _session(tc, script: list, query: str = f"?model={MODEL}") -> list:
    """Open a realtime session, send ``script``'s events (a str is sent as
    it is) and return every event received: one reply per event, a
    response's up to ``response.done`` or ``error``."""
    ws = await tc.ws_connect(f"/v1/realtime{query}")
    got = [await ws.receive_json(timeout=60)]
    for ev in script:
        if isinstance(ev, str):
            await ws.send_str(ev)
        else:
            await ws.send_json(ev)
        if isinstance(ev, dict) and ev["type"] == "response.create":
            got += await _until(ws, ("response.done", "error"))
        elif isinstance(ev, dict) and ev["type"] == "input_audio_buffer.commit":
            got += await _until(ws, ("conversation.item.input_audio_transcription.completed",
                                     "error"))
        else:
            got.append(await ws.receive_json(timeout=60))
    await ws.close()
    return got


def _both(pair, fn) -> list:
    """``fn(side index, client)`` on each app, in turn; returns both results."""
    return [pair.run(fn(i, tc)) for i, tc in enumerate(pair.clients)]


def _item(role: str, *texts) -> dict:
    return {"type": "conversation.item.create",
            "item": {"role": role, "content": [{"type": "input_text", "text": t}
                                               for t in texts]}}


def _chat_text(pair, i: int, messages: list, max_tokens: int = 6) -> str:
    async def go():
        r = await pair.clients[i].post("/v1/chat/completions", json={
            "model": MODEL, "messages": messages, "temperature": 0, "max_tokens": max_tokens})
        return await r.json()

    return pair.run(go())["choices"][0]["message"]["content"]


UPDATE = {"type": "session.update", "session": {"temperature": 0, "max_output_tokens": 6}}


# ---- sessions ----

def test_text_turns_are_the_reference_and_the_direct_chat(pair):
    script = [{**UPDATE, "session": {**UPDATE["session"], "instructions": "w3 w4"}},
              _item("user", "w5 w6"), {"type": "response.create"},
              _item("user", "w7", " w8"), {"type": "response.create"},
              {"type": "response.cancel"}]
    got = _both(pair, lambda i, tc: _session(tc, script))
    assert _canon(got[1], {}) == _canon(got[0], {})
    events = got[1]
    types = [e["type"] for e in events]
    assert types[:4] == ["session.created", "session.updated", "conversation.item.created",
                         "response.created"]
    assert types[-1] == "response.cancelled"
    dones = [i for i, t in enumerate(types) if t == "response.done"]
    assert len(dones) == 2 and "error" not in types
    history = [{"role": "system", "content": "w3 w4"}, {"role": "user", "content": "w5 w6"}]
    start = 3
    for turn, end in enumerate(dones):
        deltas = [e["delta"] for e in events[start:end] if e["type"] == "response.output_text.delta"]
        text = events[end]["response"]["output_text"]
        assert deltas and "".join(deltas) == text
        for i in range(2):
            assert _chat_text(pair, i, history) == text
        history += [{"role": "assistant", "content": text}, {"role": "user", "content": "w7 w8"}]
        start = end + 1
    # the second turn's prompt holds the first (the reference's history case)
    usage = [events[d]["response"]["usage"] for d in dones]
    assert usage[1]["input_tokens"] > usage[0]["input_tokens"] and usage[0]["output_tokens"] == 6


def test_error_events_leave_the_session_working(pair, monkeypatch):
    for mod in RT:
        monkeypatch.setattr(mod, "MAX_AUDIO_BUFFER_BYTES", 8)
    script = [{"type": "bogus.event"}, "{not json",
              {"type": "input_audio_buffer.commit"},
              {"type": "input_audio_buffer.append", "audio": "abc"},
              {"type": "input_audio_buffer.append", "audio": base64.b64encode(b"123456").decode()},
              {"type": "input_audio_buffer.append", "audio": base64.b64encode(b"789012").decode()},
              {"type": "input_audio_buffer.clear"},
              UPDATE, _item("user", "w9"), {"type": "response.create"}]
    got = _both(pair, lambda i, tc: _session(tc, script))
    assert _canon(got[1], {}) == _canon(got[0], {})
    errors = [e["error"]["message"] for e in got[1] if e["type"] == "error"]
    assert errors == ["unknown event type 'bogus.event'", "invalid JSON", "audio buffer is empty",
                      "invalid base64 audio", "audio buffer limit exceeded; buffer cleared"]
    assert got[1][-1]["type"] == "response.done"


def test_pcm16_to_wav_is_the_reference():
    rng = np.random.default_rng(0)
    for rate, channels, n in ((16000, 1, 1600), (24000, 2, 999), (8000, 1, 0)):
        pcm = rng.integers(-32768, 32768, n * channels).astype("<i2").tobytes()
        wav = trt.pcm16_to_wav(pcm, sample_rate=rate, channels=channels)
        assert wav == jrt.pcm16_to_wav(pcm, sample_rate=rate, channels=channels)
        with wave.open(io.BytesIO(wav)) as w:
            assert (w.getframerate(), w.getnchannels(), w.getsampwidth()) == (rate, channels, 2)
            assert w.readframes(n) == pcm


def test_audio_commit_transcribes_through_the_proxy_leg(pair):
    """Frames appended and committed reach the ASR worker as one WAV; the
    transcript joins the conversation and the response answers it."""
    asr = AsrServer()
    rng = np.random.default_rng(1)
    frames = [rng.integers(-2000, 2000, 400).astype("<i2").tobytes() for _ in range(3)]
    script = [UPDATE, *({"type": "input_audio_buffer.append",
                         "audio": base64.b64encode(f).decode()} for f in frames),
              {"type": "input_audio_buffer.commit"}, {"type": "response.create"}]

    async def go(i, tc):
        r = await tc.post("/workers", json={"url": asr.url, "model_id": MODEL,
                                            "worker_id": "audio-w"})
        assert r.status == 200, await r.text()
        try:
            return await _session(tc, script)
        finally:
            r = await tc.delete("/workers/audio-w?drain=0")
            assert r.status == 200, await r.text()

    pair.run(asr.server.start_server())
    try:
        got = _both(pair, go)
    finally:
        pair.run(asr.server.close())
    assert _canon(got[1], {}) == _canon(got[0], {})
    types = [e["type"] for e in got[1]]
    at = types.index("input_audio_buffer.committed")
    assert types[at:at + 3] == ["input_audio_buffer.committed",
                                "conversation.item.input_audio_transcription.completed",
                                "response.created"] and types[-1] == "response.done"
    assert [e["bytes"] for e in got[1] if e["type"] == "input_audio_buffer.appended"] == \
        [800, 1600, 2400]
    done = got[1][types.index("conversation.item.input_audio_transcription.completed")]
    assert done["transcript"] == TRANSCRIPT
    want = trt.pcm16_to_wav(b"".join(frames))
    assert [blob for _f, blob in asr.forms] == [want, want]
    assert asr.forms[1][0] == {"filename": "realtime.wav", "model": [MODEL]}
    for i in range(2):
        assert _chat_text(pair, i, [{"role": "user", "content": TRANSCRIPT}]) == \
            got[1][-1]["response"]["output_text"]


def test_commit_without_an_audio_worker_is_an_error_event(pair):
    script = [{"type": "input_audio_buffer.append", "audio": base64.b64encode(b"ab").decode()},
              {"type": "input_audio_buffer.commit"}]
    got = _both(pair, lambda i, tc: _session(tc, script))
    assert _canon(got[1], {}) == _canon(got[0], {})
    assert got[1][-1] == {"type": "error", "error": {
        "message": "no transcription-capable worker; register an OpenAI-compatible audio worker"}}


# ---- client secrets ----

def test_client_secret_mint_and_expiry():
    for mod in RT:
        s = mod.mint_client_secret(ttl=60)
        assert s["value"].startswith("eph_") and mod._secret_valid(s["value"])
        assert not mod._secret_valid(mod.mint_client_secret(ttl=-1)["value"])
        assert not mod._secret_valid("eph_bogus") and not mod._secret_valid(None)


def test_handshake_needs_a_credential_when_auth_is_on(pair):
    """With gateway auth on, the WS handshake needs a minted secret or an
    API key; minting itself authenticates normally."""
    olds = [ctx.auth for ctx in pair.ctxs]
    for ctx, mod in zip(pair.ctxs, AUTH):
        ctx.auth = mod.Authenticator(mod.AuthConfig(
            enabled=True, api_keys={"sk-admin": mod.Principal(id="admin")}))

    async def go(i, tc):
        out = []
        for query in ("", "?client_secret=eph_bogus"):
            ws = await tc.ws_connect(f"/v1/realtime{query}")
            out.append(await ws.receive_json(timeout=30))
            out.append((await ws.receive(timeout=30)).type.name)
            await ws.close()
        r = await tc.post("/v1/realtime/client_secrets")
        out.append((r.status, await r.json()))
        r = await tc.post("/v1/realtime/client_secrets",
                          headers={"Authorization": "Bearer sk-admin"})
        minted = await r.json()
        out.append((r.status, minted))
        for query, headers in ((f"?client_secret={minted['client_secret']['value']}", {}),
                               ("", {"Authorization": "Bearer sk-admin"})):
            ws = await tc.ws_connect(f"/v1/realtime{query}", headers=headers)
            out.append((await ws.receive_json(timeout=30))["type"])
            await ws.close()
        ws = await tc.ws_connect("/v1/realtime/relay/s1?leg=a")
        out.append(await ws.receive_json(timeout=30))
        await ws.close()
        return out

    try:
        got = _both(pair, go)
    finally:
        for ctx, old in zip(pair.ctxs, olds):
            ctx.auth = old
    assert _canon(got[1], {}) == _canon(got[0], {})
    out = got[1]
    assert out[0]["error"]["type"] == "authentication_error" and out[1] == "CLOSE"
    assert out[2]["error"]["type"] == "authentication_error"
    assert out[4][0] == 401 and out[5][0] == 200
    assert out[5][1]["session"] == {"type": "realtime"}
    assert out[6:8] == ["session.created", "session.created"]
    assert out[8] == {"type": "error", "error": {"type": "authentication_error",
                                                 "message": "unauthorized"}}


# ---- the relay ----

async def _relay(tc, sid: str, payload: bytes, gap: float = 0.0) -> list:
    a = await tc.ws_connect(f"/v1/realtime/relay/{sid}?leg=a")
    out = [await a.receive_json(timeout=30)]
    b = await tc.ws_connect(f"/v1/realtime/relay/{sid}?leg=b")
    out += [await b.receive_json(timeout=30), await a.receive_json(timeout=30)]
    await asyncio.sleep(gap)
    await a.send_str('{"type": "offer", "sdp": "fake"}')
    out.append(await b.receive_str(timeout=30))
    await b.send_bytes(payload)
    got = await a.receive(timeout=30)
    out.append((got.type.name, got.data == payload, len(got.data)))
    await b.close()
    out.append(await a.receive_json(timeout=30))
    await a.close()
    bad = await tc.ws_connect(f"/v1/realtime/relay/{sid}?leg=c")
    out.append(await bad.receive_json(timeout=30))
    await bad.close()
    return out


def test_relay_pairs_legs(pair):
    payload = np.random.default_rng(2).bytes(64 * 1024)
    got = _both(pair, lambda i, tc: _relay(tc, "sess42", payload))
    assert got[1] == got[0]
    out = got[1]
    assert out[0] == {"type": "relay.joined", "session_id": "sess42", "leg": "a",
                      "peer_connected": False}
    assert out[1]["peer_connected"] is True and out[2] == {"type": "relay.peer_connected",
                                                           "leg": "b"}
    assert out[3] == '{"type": "offer", "sdp": "fake"}'
    assert out[4] == ("BINARY", True, 64 * 1024)
    assert out[5] == {"type": "relay.peer_disconnected", "leg": "b"}
    assert out[6] == {"type": "error", "error": {"message": "leg must be a|b"}}


# ---- the websocket exemption from the request timeout ----

TIMEOUT_S = 0.5


def test_websocket_sessions_outlive_the_request_timeout(pair):
    """A realtime session and a relay pair run past ``request_timeout_secs``
    on both apps; a chat slower than it still gets its 408."""
    from test_torch_messages import scripted_worker

    class Slow:
        """Sleeps past the timeout before a scripted worker's first chunk."""

        def __init__(self, inner):
            self.inner = inner

        def __getattr__(self, name):
            return getattr(self.inner, name)

        async def generate(self, req):
            await asyncio.sleep(3 * TIMEOUT_S)
            async for c in self.inner.generate(req):
                yield c

    starts = []
    for side, ctx in zip(SIDES, pair.ctxs):
        timed = side["server"].AppContext(policy="round_robin", request_timeout_secs=TIMEOUT_S)
        tok = ctx.tokenizers.get(MODEL)
        timed.tokenizers.register(MODEL, tok, default=True)
        timed.registry.add(ctx.registry.get("engine"))
        timed.tokenizers.register("slow", tok)
        timed.registry.add(side["Worker"](
            worker_id="slow", client=Slow(scripted_worker(side["wc"], "w5 w6", tok)),
            model_id="slow"))
        starts.append(Pair._start(side["server"], timed))
    clients = [pair.run(s) for s in starts]

    async def go(i, tc):
        ws = await tc.ws_connect(f"/v1/realtime?model={MODEL}")
        created = await ws.receive_json(timeout=30)
        await asyncio.sleep(2 * TIMEOUT_S)
        await ws.send_json(UPDATE)
        updated = await ws.receive_json(timeout=30)
        await ws.send_json(_item("user", "w5"))
        await ws.receive_json(timeout=30)
        await ws.send_json({"type": "response.create"})
        events = await _until(ws, ("response.done", "error"))
        await ws.close()
        relay = await _relay(tc, f"slow{i}", b"\x00" * 1024, gap=2 * TIMEOUT_S)
        r = await tc.post("/v1/chat/completions", json={
            "model": "slow", "messages": [{"role": "user", "content": "w5"}]})
        return created["type"], updated["type"], events[-1]["type"], relay[4], r.status, \
            (await r.json())["error"]["type"]

    async def both():
        return await asyncio.gather(*(go(i, tc) for i, tc in enumerate(clients)))

    try:
        got = pair.run(both())
    finally:
        for tc in clients:
            pair.run(tc.close())
    assert got[1] == got[0]
    assert got[1] == ("session.created", "session.updated", "response.done", ("BINARY", True, 1024),
                      408, "timeout_error")


# ---- the route table ----

#: routes of the reference's app the port lacks, each with its reason (the
#: modules still in ROADMAP Queue A add none)
ROUTE_EXCEPTIONS: dict = {}


def test_every_reference_route_is_on_the_port():
    def routes(server):
        app = server.build_app(server.AppContext())
        return {(r.method, r.resource.canonical) for r in app.router.routes()}

    ref, port = routes(jserver), routes(tserver)
    assert ref - port == set(ROUTE_EXCEPTIONS)
    assert port - ref == set()
