"""HTTP workers behind the port's gateway, held against the reference's
(``tests/test_http_worker.py`` and the PD-over-HTTP cases of
``tests/test_pd.py``).

- (a) ``HttpWorkerClient``, the port's and the reference's, against one mock
  OpenAI-wire worker: health over ``/health`` then ``/v1/models``, model
  info over ``/get_model_info`` falling back to ``/v1/models``,
  ``/get_load``, ``post_json``, ``post_multipart`` and ``stream_sse``;
- (b) the port's and the reference's gateways in front of the same mock
  worker, registered by ``POST /workers`` with its ``http://`` URL: chat,
  completions and ``/generate``, streamed and not, and an upstream 4xx,
  5xx or dead worker give identical statuses, bodies and SSE frames; the
  proxy path never tokenizes and keeps registry accounting; a client that
  hangs up mid-stream does not feed the worker's breaker;
- (c) PD over HTTP: a PREFILL and a DECODE mock worker behind both
  gateways: both legs get the same bootstrap metadata (the prefill
  worker's address and one random room), the prefill leg never streams,
  the client gets the decode leg's answer; bodies and frames identical with
  the rooms removed."""

import asyncio
import json
import threading

import pytest
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

from smg_tpu.gateway import http_worker as jhw
from smg_tpu.gateway import server as jgw
from smg_tpu.gateway.workers import Worker as JaxWorker
from smg_tpu_torch.gateway import http_worker as thw
from smg_tpu_torch.gateway import server as tgw
from smg_tpu_torch.gateway.workers import Worker

GATEWAYS = {"ref": jgw, "port": tgw}
CLIENTS = {"ref": jhw, "port": thw}
WORKERS = {"ref": JaxWorker, "port": Worker}


def _frame(obj) -> bytes:
    return f"data: {json.dumps(obj)}\n\n".encode()


def make_mock_http_worker(seen: list, model_id: str = "proxy-model", role: str = "",
                          info: bool = False):
    """A protocol-accurate OpenAI-compatible engine worker.  ``role`` tags
    what it records and answers (a PD leg); ``info`` adds
    ``/get_model_info`` and ``/get_load``.  Model ``err400``/``err500``
    answers that status; ``slow`` streams 50 frames, 20 ms apart."""

    async def models(request):
        return web.json_response({"object": "list", "data": [{"id": model_id}]})

    async def health(request):
        return web.Response(text="ok")

    async def model_info(request):
        return web.json_response({"model_path": f"/models/{model_id}", "page_size": 16})

    async def load(request):
        return web.json_response([{"num_waiting_reqs": 2, "num_running_reqs": 3}])

    async def flush(request):
        return web.json_response({})

    def failure(body):
        if body.get("model") in ("err400", "err500"):
            status = int(body["model"][3:])
            return web.json_response({"error": {"message": f"upstream {status}"}},
                                     status=status)
        return None

    async def stream(request, frames, delay=0.0):
        resp = web.StreamResponse(headers={"content-type": "text/event-stream"})
        await resp.prepare(request)
        for f in frames:
            await resp.write(_frame(f))
            if delay:
                await asyncio.sleep(delay)
        await resp.write(b"data: [DONE]\n\n")
        await resp.write_eof()
        return resp

    async def chat(request):
        body = await request.json()
        seen.append({"role": role, "path": "/v1/chat/completions", "body": body})
        bad = failure(body)
        if bad is not None:
            return bad
        if body.get("stream"):
            frags = ["x"] * 50 if body.get("model") == "slow" else [f"{role} ", "hel", "lo"]
            frames = [{"id": "c1", "object": "chat.completion.chunk",
                       "choices": [{"index": 0, "delta": {"content": f}}]} for f in frags]
            frames.append({"id": "c1", "object": "chat.completion.chunk",
                           "choices": [{"index": 0, "delta": {}, "finish_reason": "stop"}]})
            return await stream(request, frames, 0.02 if body.get("model") == "slow" else 0)
        return web.json_response({
            "id": "c1", "object": "chat.completion", "created": 1, "model": body.get("model"),
            "choices": [{"index": 0, "message": {"role": "assistant",
                                                 "content": f"{role} from http worker"},
                         "finish_reason": "stop"}],
            "usage": {"prompt_tokens": 4, "completion_tokens": 3, "total_tokens": 7}})

    async def completions(request):
        body = await request.json()
        seen.append({"role": role, "path": "/v1/completions", "body": body})
        bad = failure(body)
        if bad is not None:
            return bad
        if body.get("stream"):
            return await stream(request, [
                {"id": "c2", "object": "text_completion",
                 "choices": [{"index": 0, "text": t, "finish_reason": None}]}
                for t in (" contin", "ued")])
        return web.json_response({
            "id": "c2", "object": "text_completion", "created": 1, "model": body.get("model"),
            "choices": [{"index": 0, "text": f"{role} continued", "finish_reason": "stop"}]})

    async def generate(request):
        body = await request.json()
        seen.append({"role": role, "path": "/generate", "body": body})
        if body.get("stream"):
            return await stream(request, [{"text": t, "meta_info": {"id": "g1"}}
                                          for t in ("gen", "generated")])
        return web.json_response({"text": f"{role} generated", "output_ids": [1, 2],
                                  "meta_info": {"id": body.get("rid") or "g1",
                                                "finish_reason": {"type": "stop"}}})

    async def transcribe(request):
        form = await request.post()
        return web.json_response({"fields": sorted(k for k in form if k != "file"),
                                  "bytes": len(form["file"].file.read())})

    app = web.Application()
    app.router.add_get("/v1/models", models)
    app.router.add_get("/health", health)
    if info:
        app.router.add_get("/get_model_info", model_info)
        app.router.add_get("/get_load", load)
    app.router.add_post("/flush_cache", flush)
    app.router.add_post("/v1/chat/completions", chat)
    app.router.add_post("/v1/completions", completions)
    app.router.add_post("/generate", generate)
    app.router.add_post("/v1/audio/transcriptions", transcribe)
    return app


class Loop:
    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()

    def run(self, coro, timeout=60):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout=timeout)

    def close(self):
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=10)


async def _upstream(app) -> TestServer:
    s = TestServer(app)
    await s.start_server()
    return s


def _url(server) -> str:
    return str(server.make_url("")).rstrip("/")


# ---- (a) the client ----


@pytest.fixture(scope="module")
def upstreams():
    h = Loop()
    h.seen = []
    h.plain = h.run(_upstream(make_mock_http_worker(h.seen)))
    h.rich = h.run(_upstream(make_mock_http_worker(h.seen, model_id="rich", info=True)))
    yield h
    h.run(h.plain.close())
    h.run(h.rich.close())
    h.close()


def _per_client(h, fn):
    async def go(mod):
        client = mod.HttpWorkerClient(_url(h.plain))
        rich = mod.HttpWorkerClient(_url(h.rich))
        try:
            return await fn(client, rich, mod)
        finally:
            await client.close()
            await rich.close()

    out = {side: h.run(go(mod)) for side, mod in CLIENTS.items()}
    assert out["port"] == out["ref"]
    return out["port"]


def test_client_marks_and_url(upstreams):
    for mod in CLIENTS.values():
        c = mod.HttpWorkerClient("127.0.0.1:1/")
        assert (c.proxy_mode, c.supports_device_kv, c.url) == (True, False, "http://127.0.0.1:1")


def test_client_health_info_and_loads(upstreams):
    async def fn(client, rich, mod):
        dead = mod.HttpWorkerClient("http://127.0.0.1:9")
        try:
            return (await client.health(), await dead.health(), await client.get_model_info(),
                    await rich.get_model_info(), await client.get_loads(),
                    await rich.get_loads(), await client.flush_cache(),
                    await client.abort("r1"), await client.get_tokenizer())
        finally:
            await dead.close()

    out = _per_client(upstreams, fn)
    assert out[:2] == (True, False)
    assert out[2] == {"model_id": "proxy-model"}
    assert out[3]["model_id"] == "rich" and out[3]["page_size"] == 16
    assert out[5]["num_waiting"] == 2 and out[5]["num_running"] == 3
    assert out[6:] == (True, False, None)


def test_client_post_stream_and_multipart(upstreams):
    async def fn(client, rich, mod):
        body = {"model": "proxy-model", "messages": [{"role": "user", "content": "hi"}]}
        one = await client.post_json("/v1/chat/completions", body)
        frames = [c async for c in client.stream_sse("/v1/chat/completions",
                                                     {**body, "stream": True})]
        errs = []
        for model in ("err400", "err500"):
            try:
                await client.post_json("/v1/chat/completions", {**body, "model": model})
            except mod.HttpWorkerError as e:
                errs.append((e.status, json.loads(e.message)))
            try:
                async for _ in client.stream_sse("/v1/chat/completions",
                                                 {**body, "model": model, "stream": True}):
                    pass
            except mod.HttpWorkerError as e:
                errs.append((e.status, json.loads(e.message)))
        form = await client.post_multipart(
            "/v1/audio/transcriptions", {"model": "whisper",
                                         "timestamp_granularities[]": ["word", "segment"]},
            b"\x00" * 100)
        return one, frames, errs, form

    one, frames, errs, form = _per_client(upstreams, fn)
    assert one["choices"][0]["message"]["content"] == " from http worker"
    assert "".join(f["choices"][0]["delta"].get("content", "") for f in frames) == " hello"
    assert [s for s, _ in errs] == [400, 400, 500, 500]
    assert form == {"fields": ["model", "timestamp_granularities[]",
                              "timestamp_granularities[]"], "bytes": 100}


# ---- (b) the proxy path through both gateways ----


class Proxy(Loop):
    """One mock worker behind the reference's and the port's gateways."""

    def __init__(self):
        super().__init__()
        self.seen = []
        self.ctx, self.tc = {}, {}
        self.upstream = self.run(_upstream(make_mock_http_worker(self.seen)))
        self.reg = {side: self.run(self._gateway(side)) for side in GATEWAYS}

    async def _gateway(self, side):
        gw = GATEWAYS[side]
        self.ctx[side] = gw.AppContext(policy="round_robin")
        self.tc[side] = TestClient(TestServer(gw.build_app(self.ctx[side])))
        await self.tc[side].start_server()
        r = await self.tc[side].post("/workers", json={"url": _url(self.upstream)})
        return r.status, await r.json()

    def both(self, method, path, body=None, raw=False):
        """(status, JSON body or SSE frames) from each gateway, with what
        the worker saw."""
        out = {}
        for side in GATEWAYS:
            self.seen.clear()

            async def go():
                r = await self.tc[side].request(method, path, json=body)
                if raw:
                    text = await r.text()
                    return r.status, [ln for ln in text.splitlines() if ln]
                return r.status, await r.json()

            out[side] = (*self.run(go()), list(self.seen))
        assert out["port"] == out["ref"]
        return out["port"]

    def close(self):
        for tc in self.tc.values():
            self.run(tc.close())
        self.run(self.upstream.close())
        super().close()


@pytest.fixture(scope="module")
def proxy():
    h = Proxy()
    yield h
    h.close()


def _chat(**kw):
    return {"model": "proxy-model", "messages": [{"role": "user", "content": "hi"}],
            "max_tokens": 8, **kw}


def test_http_worker_registration_reports_model(proxy):
    assert proxy.reg["port"][0] == 200
    added = {k: v for k, v in proxy.reg["port"][1]["added"].items()}
    ref = proxy.reg["ref"][1]["added"]
    assert added == ref and added["model_id"] == "proxy-model"
    steps = proxy.reg["port"][1]["workflow"]["steps"]
    assert steps["tokenizer"]["status"] == "succeeded"  # nothing to fetch over HTTP
    status, body, _ = proxy.both("GET", "/workers")
    assert status == 200 and [w["model_id"] for w in body["workers"]] == ["proxy-model"]
    assert not proxy.ctx["port"].tokenizers.has("proxy-model")


def test_http_worker_chat_roundtrip(proxy):
    before = proxy.ctx["port"].registry.list()[0].total_requests
    status, body, seen = proxy.both("POST", "/v1/chat/completions", _chat())
    assert status == 200
    assert body["choices"][0]["message"]["content"] == " from http worker"
    # through the proxy transport, untokenized
    assert seen == [{"role": "", "path": "/v1/chat/completions", "body": _chat()}]
    assert proxy.ctx["port"].registry.list()[0].total_requests == before + 1


def test_http_worker_chat_streaming(proxy):
    status, lines, seen = proxy.both("POST", "/v1/chat/completions",
                                     _chat(stream=True, messages=[
                                         {"role": "user", "content": "stream please"}]),
                                     raw=True)
    assert status == 200 and lines[-1] == "data: [DONE]"
    deltas = [json.loads(ln[6:]) for ln in lines[:-1]]
    assert "".join(d["choices"][0]["delta"].get("content", "") for d in deltas) == " hello"
    assert seen[0]["body"]["stream"] is True


@pytest.mark.parametrize("stream", [False, True], ids=["plain", "stream"])
def test_http_worker_completions_proxy(proxy, stream):
    body = {"model": "proxy-model", "prompt": "once upon", "max_tokens": 4}
    if stream:
        body["stream"] = True
    status, out, seen = proxy.both("POST", "/v1/completions", body, raw=stream)
    assert status == 200 and seen[-1]["path"] == "/v1/completions"
    if not stream:
        assert out["choices"][0]["text"] == " continued"
    else:
        assert out[-1] == "data: [DONE]" and len(out) == 3


@pytest.mark.parametrize("stream", [False, True], ids=["plain", "stream"])
def test_http_worker_generate_passthrough(proxy, stream):
    body = {"text": "complete this", "sampling_params": {"max_new_tokens": 4},
            "stream": stream}
    status, out, seen = proxy.both("POST", "/generate", body, raw=stream)
    assert status == 200
    assert seen == [{"role": "", "path": "/generate", "body": body}]  # the raw body
    if not stream:
        assert out["text"] == " generated"
    else:
        assert out[-1] == "data: [DONE]"


@pytest.mark.parametrize("model,stream", [("err400", False), ("err500", False),
                                          ("err400", True), ("err500", True)],
                         ids=["400", "500", "400-stream", "500-stream"])
def test_http_worker_upstream_errors_map_to_worker_error(proxy, model, stream):
    """A 4xx keeps its status, a 5xx is a 502, as ``worker_error`` bodies;
    mid-stream (headers already sent) the error is an SSE frame."""
    status, out, _ = proxy.both("POST", "/v1/chat/completions",
                                _chat(model=model, stream=stream), raw=stream)
    if not stream:
        assert status == (400 if model == "err400" else 502)
        assert out["error"]["type"] == "worker_error"
        assert out["error"]["message"].startswith("worker error: ")
    else:
        assert status == 200
        assert json.loads(out[-1][6:])["error"]["type"] == "worker_error"


def test_http_worker_error_maps_to_worker_error(proxy):
    """A dead HTTP worker surfaces 502 worker_error and feeds the breaker."""
    out = {}
    for side in GATEWAYS:
        dead = WORKERS[side](worker_id="dead", model_id="dead-model",
                             client=CLIENTS[side].HttpWorkerClient("http://127.0.0.1:9"))
        proxy.ctx[side].registry.add(dead)
        try:
            async def go():
                r = await proxy.tc[side].post("/v1/chat/completions", json=_chat(
                    model="dead-model", messages=[{"role": "user", "content": "x"}]))
                return r.status, (await r.json())["error"]["type"], dead.total_failures
            out[side] = proxy.run(go())
        finally:
            proxy.ctx[side].registry.remove("dead")
    assert out["port"] == out["ref"] == (502, "worker_error", 1)


def test_client_hangup_does_not_feed_the_breaker(proxy):
    """A client that drops a proxied stream is not a worker failure: the
    load comes back and the breaker records no failure."""
    worker = proxy.ctx["port"].registry.list()[0]
    failures = worker.total_failures

    async def go():
        r = await proxy.tc["port"].post("/v1/chat/completions",
                                        json=_chat(model="slow", stream=True))
        await r.content.readline()  # the first frame, then hang up
        r.close()
        for _ in range(200):
            if worker.load == 0:
                break
            await asyncio.sleep(0.02)
        return worker.load

    assert proxy.run(go()) == 0
    assert worker.total_failures == failures
    assert worker.circuit.state.value == "closed"


# ---- (c) PD over HTTP ----


class PdProxy(Proxy):
    def __init__(self):
        Loop.__init__(self)
        self.seen = []
        self.ctx, self.tc = {}, {}
        self.legs = {role: self.run(_upstream(make_mock_http_worker(
            self.seen, model_id="pd-http-model", role=role))) for role in ("prefill", "decode")}
        self.upstream = None
        for side in GATEWAYS:
            self.run(self._pd_gateway(side))

    async def _pd_gateway(self, side):
        gw = GATEWAYS[side]
        self.ctx[side] = gw.AppContext(policy="round_robin")
        self.tc[side] = TestClient(TestServer(gw.build_app(self.ctx[side])))
        await self.tc[side].start_server()
        for role, s in self.legs.items():
            r = await self.tc[side].post("/workers", json={
                "url": _url(s), "worker_type": role,
                "bootstrap_host": "10.0.0.7" if role == "prefill" else None,
                "bootstrap_port": 8998 if role == "prefill" else None})
            assert r.status == 200, await r.text()

    def both(self, method, path, body=None, raw=False):
        """As ``Proxy.both``, each leg's body with its room checked (one
        63-bit int, the same on both legs) and removed."""
        out = {}
        for side in GATEWAYS:
            self.seen.clear()

            async def go():
                r = await self.tc[side].request(method, path, json=body)
                if raw:
                    return r.status, [ln for ln in (await r.text()).splitlines() if ln]
                return r.status, await r.json()

            status, resp = self.run(go())
            rooms = {s["body"].pop("bootstrap_room") for s in self.seen}
            assert len(rooms) == 1 and 0 <= next(iter(rooms)) < 2**63
            out[side] = (status, resp, sorted(self.seen, key=lambda s: s["role"]))
        assert out["port"] == out["ref"]
        return out["port"]

    def close(self):
        for tc in self.tc.values():
            self.run(tc.close())
        for s in self.legs.values():
            self.run(s.close())
        Loop.close(self)


@pytest.fixture(scope="module")
def pd_proxy():
    h = PdProxy()
    yield h
    h.close()


def test_pd_http_chat_dual_dispatch(pd_proxy):
    """Both legs get the prefill worker's bootstrap address; the client
    sees the decode leg's answer; the prefill leg is forced non-streaming."""
    status, body, seen = pd_proxy.both("POST", "/v1/chat/completions", {
        "model": "pd-http-model", "messages": [{"role": "user", "content": "hi"}]})
    assert status == 200, body
    assert body["choices"][0]["message"]["content"] == "decode from http worker"
    assert [s["role"] for s in seen] == ["decode", "prefill"]
    p, d = seen[1]["body"], seen[0]["body"]
    assert p["bootstrap_host"] == d["bootstrap_host"] == "10.0.0.7"
    assert p["bootstrap_port"] == d["bootstrap_port"] == 8998
    assert p["stream"] is False


def test_pd_http_chat_streaming_from_decode(pd_proxy):
    status, lines, seen = pd_proxy.both("POST", "/v1/chat/completions", {
        "model": "pd-http-model", "stream": True,
        "messages": [{"role": "user", "content": "hi"}]}, raw=True)
    text = "".join(json.loads(ln[6:])["choices"][0]["delta"].get("content") or ""
                   for ln in lines if ln != "data: [DONE]")
    assert status == 200 and text == "decode hello"
    assert seen[1]["body"]["stream"] is False  # the prefill leg never streams


@pytest.mark.parametrize("path", ["/v1/completions", "/generate"])
def test_pd_http_other_routes(pd_proxy, path):
    """``/v1/completions`` and the raw ``/generate`` passthrough: the decode
    leg's answer, the body as sent plus the bootstrap metadata."""
    body = ({"model": "pd-http-model", "prompt": "once", "max_tokens": 4} if path != "/generate"
            else {"text": "complete this", "sampling_params": {"max_new_tokens": 4}})
    status, out, seen = pd_proxy.both("POST", path, body)
    assert status == 200, out
    assert out.get("text", "") == "decode generated" or \
        out["choices"][0]["text"] == "decode continued"
    for s in seen:
        sent = {k: v for k, v in s["body"].items()
                if not k.startswith("bootstrap_") and k != "stream"}
        assert sent == body


def test_pd_http_batch_generate_gets_a_room_per_prompt(pd_proxy):
    """A batch ``/generate`` (list text) gets per-prompt bootstrap lists."""
    out = {}
    for side in GATEWAYS:
        pd_proxy.seen.clear()

        async def go():
            r = await pd_proxy.tc[side].post("/generate", json={
                "text": ["a", "b", "c"], "sampling_params": {"max_new_tokens": 2}})
            return r.status

        status = pd_proxy.run(go())
        bodies = [s["body"] for s in pd_proxy.seen]
        assert bodies[0]["bootstrap_room"] == bodies[1]["bootstrap_room"]
        out[side] = (status, [{k: v for k, v in b.items() if k != "bootstrap_room"}
                              for b in bodies], len(set(bodies[0]["bootstrap_room"])))
    assert out["port"][0] == 200
    assert sorted(map(json.dumps, out["port"][1])) == sorted(map(json.dumps, out["ref"][1]))
    assert out["port"][1][0]["bootstrap_host"] == ["10.0.0.7"] * 3
    assert out["port"][2] == out["ref"][2] == 3
