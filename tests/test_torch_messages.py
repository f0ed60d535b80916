"""The Anthropic Messages API on the port against the reference, on the CPU.

- ``AnthropicMessagesRequest.to_chat_messages`` (system blocks, ``tool_use``
  and ``tool_result`` blocks, images kept as parts) and the bridge's three
  functions (``gateway/openai_bridge.py``) on seeded inputs: the port's
  outputs equal the reference's.
- ``/v1/messages`` through both apps (``smg_tpu.gateway.server.build_app``
  over a tiny JAX ``Engine``, the port's over a tiny port ``Engine`` with the
  same weights), unstreamed and streamed, at temperature 0: bodies and
  ``event:`` frames identical with ids removed; the reference gateway
  test's two cases (``tests/test_gateway.py``) hold on the port.
- Over one scripted worker of each package (text through a chunk
  tokenizer): a tool call becomes a ``tool_use`` block and
  ``input_json_delta`` frames, a stop sequence ``end_turn``, the token
  budget ``max_tokens``, a route error the ``event: error`` frame; an image
  block on a text-only model gets the reference's answer.
- ``/v1/messages``' span tree and its ``smg_requests_total`` line equal the
  reference's.
"""

import asyncio
import json
import re
import threading

import numpy as np
import pytest
import torch
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

from smg_tpu.gateway import openai_bridge as jbridge
from smg_tpu.gateway import server as jserver
from smg_tpu.gateway import worker_client as jwc
from smg_tpu.gateway.worker_client import InProcWorkerClient as JaxInProc
from smg_tpu.gateway.workers import Worker as JaxWorker
from smg_tpu.protocols import anthropic as janth
from smg_tpu.protocols import openai as joai
from smg_tpu.tokenizer import MockTokenizer as JaxMockTokenizer
from smg_tpu_torch.gateway import openai_bridge as tbridge
from smg_tpu_torch.gateway import server as tserver
from smg_tpu_torch.gateway import worker_client as twc
from smg_tpu_torch.gateway.worker_client import InProcWorkerClient
from smg_tpu_torch.gateway.workers import Worker
from smg_tpu_torch.protocols import anthropic as tanth
from smg_tpu_torch.protocols import openai as toai
from smg_tpu_torch.tokenizer import MockTokenizer
from test_torch_gateway import MODEL, _jax_engine, _port_engine
from test_torch_responses import text_tokenizer
from test_torch_slo_tracing import UPSTREAM, Collector, _tree, _worker

torch.set_num_threads(2)
SIDES = (
    dict(server=jserver, wc=jwc, Worker=JaxWorker, InProc=JaxInProc, Tok=JaxMockTokenizer,
         engine=_jax_engine),
    dict(server=tserver, wc=twc, Worker=Worker, InProc=InProcWorkerClient, Tok=MockTokenizer,
         engine=_port_engine),
)
IDS = re.compile(r"(msg|chatcmpl|call|req)[_-][0-9a-f]{16,}")
SCRIPTED, FAILING = "scripted", "failing"
ADD_CALL = '{"name": "add", "arguments": {"a": 2, "b": 5}}'
ADD_TOOL = {"name": "add", "description": "add two numbers",
            "input_schema": {"type": "object", "properties": {"a": {"type": "integer"},
                                                              "b": {"type": "integer"}}}}
PNG_1PX = ("iVBORw0KGgoAAAANSUhEUgAAAAEAAAABCAIAAACQd1PeAAAADElEQVR4nGP4z8AAAAMBAQDJ/pLvAAAA"
           "AElFTkSuQmCC")


def _canon(obj, seen: dict):
    """Ids replaced by their order of first appearance; timestamps removed."""
    if isinstance(obj, str):
        return IDS.sub(lambda m: seen.setdefault(m.group(0), f"<{m.group(1)}{len(seen)}>"), obj)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_canon(v, seen) for v in obj)
    if isinstance(obj, dict):
        return {k: _canon(v, seen) for k, v in obj.items() if k not in ("created",)}
    return obj


def _events(text: str) -> list:
    out = []
    for block in text.strip().split("\n\n"):
        lines = dict(line.split(": ", 1) for line in block.split("\n"))
        out.append((lines["event"], json.loads(lines["data"])))
    return out


# ---- the request's normalisation ----

TOOL_LOOP = [
    {"role": "user", "content": "what is 2+5?"},
    {"role": "assistant", "content": [
        {"type": "text", "text": "let me compute"},
        {"type": "tool_use", "id": "tu_1", "name": "add", "input": {"a": 2, "b": 5}}]},
    {"role": "user", "content": [{"type": "tool_result", "tool_use_id": "tu_1", "content": "7"}]},
]
IMAGE = {"type": "image", "source": {"type": "base64", "media_type": "image/png",
                                     "data": PNG_1PX}}
NORMALISE = {
    # the reference's tool-loop case (tests/test_agentic.py)
    "tool_loop": dict(messages=TOOL_LOOP),
    "system_str": dict(system="be terse", messages=[{"role": "user", "content": "hi"}]),
    "system_blocks": dict(system=[{"type": "text", "text": "a "}, {"type": "other"},
                                  {"type": "text", "text": "b"}],
                          messages=[{"role": "user", "content": "hi"}]),
    "image_between_text": dict(messages=[{"role": "user", "content": [
        {"type": "text", "text": "look "}, IMAGE, {"type": "text", "text": " here"}]}]),
    "image_url_source": dict(messages=[{"role": "user", "content": [
        {"type": "image", "source": {"type": "url", "url": "http://127.0.0.1:9/x.png"}}]}]),
    "tool_result_blocks": dict(messages=[*TOOL_LOOP[:2], {"role": "user", "content": [
        {"type": "tool_result", "tool_use_id": "tu_1",
         "content": [{"type": "text", "text": "7"}, {"type": "image"}, "x",
                     {"type": "text", "text": "!"}]},
        {"type": "text", "text": "and then?"}]}]),
    "tool_use_without_text": dict(messages=[{"role": "assistant", "content": [
        {"type": "tool_use", "id": "tu_2", "name": "f"},
        {"type": "tool_use", "id": "tu_3", "name": "g", "input": {"x": [1, 2]}}]}]),
    "empty_and_odd_blocks": dict(messages=[
        {"role": "user", "content": []}, {"role": "assistant", "content": [{"type": "thinking"}]},
        {"role": "user", "content": [{"type": "text"}, {"type": "document"}]}]),
}


@pytest.mark.parametrize("case", sorted(NORMALISE))
def test_to_chat_messages_is_the_reference(case):
    body = {"model": "m", "max_tokens": 10, **NORMALISE[case]}
    want = janth.AnthropicMessagesRequest.model_validate(body).to_chat_messages()
    got = tanth.AnthropicMessagesRequest.model_validate(body).to_chat_messages()
    assert got == want
    if case == "tool_loop":
        assert [m["role"] for m in got] == ["user", "assistant", "tool"]
        assert got[1]["tool_calls"][0]["function"]["name"] == "add"
        assert (got[2]["content"], got[2]["tool_call_id"]) == ("7", "tu_1")
    if case == "image_between_text":
        assert got[0]["content"][1] == IMAGE


def test_map_stop_reason_is_the_reference():
    for finish in ("length", "tool_calls", "stop", "abort", "error", None):
        for matched in (None, "STOP", 7):
            assert tanth.map_stop_reason(finish, matched) == janth.map_stop_reason(finish,
                                                                                   matched)


# ---- the bridge on seeded inputs ----

def _random_request(rng) -> dict:
    def block():
        kind = rng.choice(["text", "image", "tool_use", "tool_result"])
        if kind == "text":
            return {"type": "text", "text": f"t{rng.integers(100)}"}
        if kind == "image":
            return IMAGE
        if kind == "tool_use":
            return {"type": "tool_use", "id": f"tu_{rng.integers(100)}", "name": "add",
                    "input": {"a": int(rng.integers(9))}}
        return {"type": "tool_result", "tool_use_id": f"tu_{rng.integers(100)}",
                "content": f"r{rng.integers(100)}"}

    messages = []
    for i in range(int(rng.integers(1, 6))):
        role = ["user", "assistant"][i % 2]
        content = (f"w{rng.integers(500)}" if rng.random() < 0.4
                   else [block() for _ in range(int(rng.integers(0, 4)))])
        messages.append({"role": role, "content": content})
    body = {"model": f"m{rng.integers(3)}", "messages": messages,
            "max_tokens": int(rng.integers(1, 64)), "stream": bool(rng.random() < 0.5)}
    for key, value in (("system", "sys"), ("temperature", float(rng.random())),
                       ("top_p", 0.9), ("top_k", 5), ("stop_sequences", ["S", "T"]),
                       ("tools", [ADD_TOOL, {"name": "f"}])):
        if rng.random() < 0.5:
            body[key] = value
    return body


@pytest.mark.parametrize("seed", range(6))
def test_bridge_request_translation_is_the_reference(seed):
    body = _random_request(np.random.default_rng(seed))
    want = jbridge.anthropic_to_openai_request(
        janth.AnthropicMessagesRequest.model_validate(body))
    got = tbridge.anthropic_to_openai_request(
        tanth.AnthropicMessagesRequest.model_validate(body))
    assert got.model_dump() == want.model_dump()
    assert got.temperature == body.get("temperature")  # None stays None: the engine samples


def _random_response(rng) -> dict:
    message = {"role": "assistant",
               "content": None if rng.random() < 0.3 else f"w{rng.integers(500)}"}
    if rng.random() < 0.6:
        message["tool_calls"] = [
            {"id": f"call_{i}", "type": "function", "function": {
                "name": f"f{i}", "arguments": '{"x": 1}' if rng.random() < 0.7 else "{bad"}}
            for i in range(int(rng.integers(1, 3)))]
    usage = {"prompt_tokens": int(rng.integers(100)), "completion_tokens": int(rng.integers(50)),
             "total_tokens": 0}
    if rng.random() < 0.5:
        usage["prompt_tokens_details"] = {"cached_tokens": int(rng.integers(10))}
    return {"id": "chatcmpl-x", "model": "m", "usage": usage, "choices": [{
        "index": 0, "message": message,
        "finish_reason": rng.choice(["stop", "length", "tool_calls", "abort"])}]}


@pytest.mark.parametrize("seed", range(6))
def test_bridge_response_translation_is_the_reference(seed):
    data = _random_response(np.random.default_rng(seed))
    model = None if seed % 3 == 0 else "claude-x"
    want = jbridge.openai_to_anthropic_response(
        joai.ChatCompletionResponse.model_validate(data), model).model_dump()
    got = tbridge.openai_to_anthropic_response(
        toai.ChatCompletionResponse.model_validate(data), model).model_dump()
    assert got["id"].startswith("msg_") and want["id"].startswith("msg_")
    got.pop("id"), want.pop("id")
    assert got == want


def _random_chunks(rng) -> list:
    chunks = [{"choices": [{"index": 0, "delta": {"role": "assistant"}}]}]
    for _ in range(int(rng.integers(3, 12))):
        r = rng.random()
        if r < 0.4:
            delta = {"content": f"w{rng.integers(500)} "}
        elif r < 0.6:
            delta = {"tool_calls": [{"index": 0, "id": f"call_{rng.integers(9)}",
                                     "type": "function",
                                     "function": {"name": "f", "arguments": ""}}]}
        else:
            delta = {"tool_calls": [{"index": 0, "function": {"arguments": '{"x":'}}]}
        chunks.append({"choices": [{"index": 0, "delta": delta}]})
    chunks.append({"choices": [{"index": 0, "delta": {},
                                "finish_reason": rng.choice(["stop", "length", "tool_calls"])}]})
    if rng.random() < 0.7:
        chunks.append({"choices": [], "usage": {"prompt_tokens": 11, "completion_tokens": 7,
                                                "total_tokens": 18}})
    return [{"id": "c", "object": "chat.completion.chunk", "created": 1, "model": "m", **c}
            for c in chunks]


@pytest.mark.parametrize("seed", range(6))
def test_bridge_event_grammar_is_the_reference(seed):
    raw = _random_chunks(np.random.default_rng(seed))

    async def events(bridge, oai):
        async def chunks():
            for c in raw:
                yield oai.ChatCompletionStreamChunk.model_validate(c)

        return [e async for e in bridge.openai_chunks_to_anthropic_events(chunks(), "m")]

    want = asyncio.run(events(jbridge, joai))
    got = asyncio.run(events(tbridge, toai))
    for evs in (want, got):
        evs[0][1]["message"]["id"] = "<msg>"
    assert got == want
    names = [n for n, _ in got]
    assert names[0] == "message_start" and names[-2:] == ["message_delta", "message_stop"]
    opened = [p["index"] for n, p in got if n == "content_block_start"]
    closed = [p["index"] for n, p in got if n == "content_block_stop"]
    assert opened == closed == list(range(len(opened)))


# ---- both apps over HTTP ----

def scripted_worker(wc, script: str, tok, chunk: int = 1):
    """A worker of ``wc``'s package that answers every request with
    ``script``'s tokens, ``chunk`` a chunk, cut at the request's token budget
    (``length``), else ending with ``stop``."""

    class Scripted(wc.WorkerClient):
        async def generate(self, req):
            ids = tok.encode(script)
            budget = req.sampling.max_new_tokens or len(ids)
            n = min(len(ids), budget)
            for i in range(0, n, chunk):
                last = i + chunk >= n
                yield wc.WorkerStreamChunk(
                    rid=req.rid, token_ids=ids[i:min(i + chunk, n)], finished=last,
                    finish_reason=("length" if budget < len(ids) else "stop") if last else None,
                    prompt_tokens=len(req.input_ids), output_tokens=min(i + chunk, n))

        async def abort(self, rid):
            return True

        async def health(self):
            return True

    return Scripted()


def failing_worker(wc):
    class Failing(wc.WorkerClient):
        async def generate(self, req):
            raise RuntimeError("worker exploded")
            yield  # an async generator

        async def abort(self, rid):
            return True

        async def health(self):
            return True

    return Failing()


class Pair:
    """The two apps on one private loop thread, each over a tiny engine
    (``MODEL``), a failing worker (``FAILING``) and, after ``script``, a
    scripted worker (``SCRIPTED``).  ``call`` sends one request to each and
    asserts (status, content type, canonical body) equal."""

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        self.engines, self.ctxs, self.clients = [], [], []
        for side in SIDES:
            ctx = side["server"].AppContext(policy="round_robin")
            ctx.router.config.max_retries = 0
            ctx.tokenizers.register(MODEL, side["Tok"](), default=True)
            engine = side["engine"]()
            self.engines.append(engine)
            ctx.registry.add(side["Worker"](worker_id="engine", client=side["InProc"](engine),
                                            model_id=MODEL, page_size=16))
            ctx.registry.add(side["Worker"](worker_id=FAILING, client=failing_worker(side["wc"]),
                                            model_id=FAILING))
            self.ctxs.append(ctx)
            self.clients.append(self.run(self._start(side["server"], ctx)))

    def run(self, coro, timeout=120):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout=timeout)

    @staticmethod
    async def _start(server, ctx):
        tc = TestClient(TestServer(server.build_app(ctx)))
        await tc.start_server()
        return tc

    def script(self, text: str, chunk: int = 1):
        for side, ctx in zip(SIDES, self.ctxs):
            tok = text_tokenizer(side["Tok"])
            if ctx.registry.get(SCRIPTED) is not None:
                ctx.registry.remove(SCRIPTED)
            ctx.tokenizers.register(SCRIPTED, tok)
            ctx.registry.add(side["Worker"](worker_id=SCRIPTED,
                                            client=scripted_worker(side["wc"], text, tok, chunk),
                                            model_id=SCRIPTED))

    async def _one(self, tc, method, path, body, headers):
        resp = await tc.request(method, path, json=body, headers=headers or {})
        return resp.status, resp.headers.get("Content-Type", "").split(";")[0], await resp.text()

    def call(self, path: str, body: dict, status: int = 200, method: str = "POST",
             headers=None):
        got, parsed = [], None
        for tc in self.clients:
            st, ctype, text = self.run(self._one(tc, method, path, body, headers))
            parsed = _events(text) if ctype == "text/event-stream" else json.loads(text)
            got.append((st, ctype, _canon(parsed, {})))
        assert got[1] == got[0], (path, body)
        assert got[1][0] == status if status else got[1][0] >= 400, got[1]
        return parsed

    def close(self):
        for tc in self.clients:
            self.run(tc.close())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=10)
        for e in self.engines:
            e.stop()


@pytest.fixture(scope="module")
def pair():
    p = Pair()
    yield p
    p.close()


def _messages(model=MODEL, **kw) -> dict:
    return {"model": model, "max_tokens": 8, "temperature": 0, "system": "w3 w4",
            "messages": [{"role": "user", "content": "w5 w6"},
                         {"role": "assistant", "content": "w7"},
                         {"role": "user", "content": [{"type": "text", "text": "w8 w9"}]}],
            **kw}


@pytest.mark.parametrize("stream", [False, True])
def test_messages_over_the_engine_are_the_reference(pair, stream):
    got = pair.call("/v1/messages", _messages(stream=stream))
    chat = pair.call("/v1/chat/completions", {
        "model": MODEL, "max_tokens": 8, "temperature": 0,
        "messages": [{"role": "system", "content": "w3 w4"}, {"role": "user", "content": "w5 w6"},
                     {"role": "assistant", "content": "w7"},
                     {"role": "user", "content": "w8 w9"}]})
    want_text = chat["choices"][0]["message"]["content"]
    if not stream:
        assert got["content"] == [{"type": "text", "text": want_text}]
        assert got["stop_reason"] == "max_tokens"
        assert got["usage"]["input_tokens"] == chat["usage"]["prompt_tokens"]
        return
    names = [n for n, _ in got]
    assert names == (["message_start", "content_block_start"]
                     + ["content_block_delta"] * (len(names) - 5)
                     + ["content_block_stop", "message_delta", "message_stop"])
    assert "".join(p["delta"]["text"] for n, p in got if n == "content_block_delta") == want_text
    delta = got[-2][1]
    assert delta["delta"]["stop_reason"] == "max_tokens"
    assert delta["usage"] == {"input_tokens": chat["usage"]["prompt_tokens"],
                              "output_tokens": chat["usage"]["completion_tokens"]}


def test_reference_gateway_cases_hold_on_the_port(pair):
    """``tests/test_gateway.py``'s two /v1/messages cases, sent to the port
    as they are (no temperature: the engine samples)."""
    tc = pair.clients[1]

    async def go():
        r1 = await tc.post("/v1/messages", json={
            "model": MODEL, "max_tokens": 6, "system": "be terse",
            "messages": [{"role": "user", "content": "w5 w6"}]})
        r2 = await tc.post("/v1/messages", json={
            "model": MODEL, "max_tokens": 4, "stream": True,
            "messages": [{"role": "user", "content": "w9"}]})
        return r1.status, await r1.json(), await r2.text()

    status, body, raw = pair.run(go())
    assert status == 200, body
    assert (body["type"], body["role"], body["content"][0]["type"]) == ("message", "assistant",
                                                                        "text")
    assert body["content"][0]["text"].startswith("w")
    assert body["stop_reason"] == "max_tokens"
    assert body["usage"]["output_tokens"] == 6
    events = [line[7:] for line in raw.splitlines() if line.startswith("event: ")]
    assert events[0] == "message_start" and events[-1] == "message_stop"
    assert "content_block_delta" in events


@pytest.mark.parametrize("stream", [False, True])
def test_a_tool_call_becomes_tool_use(pair, stream):
    # the streaming JSON parser takes a call that starts the text, once its
    # first chunk shows the "name" key
    pair.script(ADD_CALL, chunk=4) if stream else pair.script("sure. " + ADD_CALL)
    got = pair.call("/v1/messages", _messages(SCRIPTED, max_tokens=64, tools=[ADD_TOOL],
                                              stream=stream))
    if not stream:
        assert [b["type"] for b in got["content"]] == ["text", "tool_use"]
        assert (got["content"][1]["name"], got["content"][1]["input"]) == ("add",
                                                                           {"a": 2, "b": 5})
        assert got["stop_reason"] == "tool_use"
        return
    starts = [p["content_block"] for n, p in got if n == "content_block_start"]
    assert [(b["type"], b["name"]) for b in starts] == [("tool_use", "add")]
    args = "".join(p["delta"]["partial_json"] for n, p in got
                   if n == "content_block_delta" and p["delta"]["type"] == "input_json_delta")
    assert json.loads(args) == {"a": 2, "b": 5}
    assert got[-2][1]["delta"]["stop_reason"] == "tool_use"


@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("stop,max_tokens,reason", [
    (["STOP"], 64, "end_turn"), (None, 64, "end_turn"), (None, 3, "max_tokens")],
    ids=["stop_sequence", "finished", "budget"])
def test_stop_reasons_and_usage(pair, stream, stop, max_tokens, reason):
    pair.script("one two three four STOP five six")
    body = _messages(SCRIPTED, max_tokens=max_tokens, stream=stream)
    if stop:
        body["stop_sequences"] = stop
    got = pair.call("/v1/messages", body)
    delta = got[-2][1] if stream else got
    stop_reason = delta["delta"]["stop_reason"] if stream else got["stop_reason"]
    assert stop_reason == reason
    assert delta["usage"]["output_tokens"] > 0


def test_a_route_error_mid_stream_is_the_error_event(pair):
    got = pair.call("/v1/messages", _messages(FAILING, stream=True))
    assert [n for n, _ in got][-1] == "error"
    assert got[-1][1]["type"] == "error" and got[-1][1]["error"]["message"]
    got = pair.call("/v1/messages", _messages(FAILING), status=None)
    assert got["error"]["message"]


def test_an_image_on_a_text_model_gets_the_reference_answer(pair):
    body = _messages()
    body["messages"][-1]["content"].append(IMAGE)
    got = pair.call("/v1/messages", body, status=None)
    assert got["error"]["message"]


def test_invalid_messages_body_is_400(pair):
    got = pair.call("/v1/messages", {"model": MODEL, "messages": "nope"}, status=400)
    assert got["error"]["type"] == "invalid_request_error"


# ---- spans and counters ----

@pytest.mark.parametrize("stream", [False, True])
def test_span_tree_and_request_counter_are_the_reference(stream):
    col = Collector()

    async def go():
        runner = web.AppRunner(col.app)
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        port = site._server.sockets[0].getsockname()[1]
        clients, counters = [], {}
        for svc, side in zip(("ref", "port"), SIDES):
            server = side["server"]
            ctx = server.AppContext(policy="round_robin", otel_endpoint=f"http://127.0.0.1:{port}",
                                    otel_service_name=svc)
            ctx.tracer.flush_interval = 3600.0  # exports only when flushed below
            ctx.tokenizers.register(MODEL, side["Tok"](), default=True)
            ctx.registry.add(side["Worker"](worker_id="w0", client=_worker(side["wc"]),
                                            model_id=MODEL))
            tc = TestClient(TestServer(server.build_app(ctx)))
            await tc.start_server()
            resp = await tc.post("/v1/messages", json={
                "model": MODEL, "messages": [{"role": "user", "content": "w5 w6"}],
                "max_tokens": 3, "temperature": 0, "stream": stream,
            }, headers={"traceparent": UPSTREAM, "X-Request-Id": "req-span-1"})
            assert resp.status == 200
            await resp.read()
            assert resp.headers.get("traceparent", "").split("-")[1] == "12" * 16
            for _ in range(500):  # the root span is recorded as the handler returns
                if any(s.name.startswith("POST ") for s in ctx.tracer._buffer):
                    break
                await asyncio.sleep(0.01)
            await ctx.tracer.flush()
            metrics = await (await tc.get("/metrics")).text()
            counters[svc] = [line for line in metrics.splitlines()
                             if line.startswith("smg_requests_total{")]
            clients.append(tc)
        for tc in clients:
            await tc.close()
        await runner.cleanup()
        return counters

    counters = asyncio.run(go())
    assert counters["port"] == counters["ref"]
    assert counters["port"] == ['smg_requests_total{route="/v1/messages",status="200"} 1.0']
    # the /metrics read above has a span of its own
    ref, port = ([s for s in col.by_service[svc] if s["name"] != "GET /metrics"]
                 for svc in ("ref", "port"))
    assert _tree(port) == _tree(ref)
    assert sorted(s["name"] for s in port) == sorted([
        "POST /v1/messages", "engine.queue", "engine.tokenize", "engine.prefill",
        "engine.decode", "engine.detokenize"])


# ---- an image through /v1/messages ----

def test_an_image_source_block_answers_as_the_image_chat():
    """An Anthropic base64 ``source`` block on a vision model (``tiny-vlm``
    with M-RoPE, both packages' engines on the same weights): the body of
    ``/v1/messages`` is the reference's, and its text the image chat's."""
    import base64

    from smg_tpu_torch.gateway import launch as tlaunch
    from test_torch_vision import jax_engine, png_bytes, port_engine

    png = png_bytes(np.random.default_rng(7).integers(0, 256, (24, 16, 3), dtype=np.uint8))
    b64 = base64.b64encode(png).decode()
    chat = {"model": "tiny-vlm", "max_tokens": 8, "temperature": 0, "messages": [
        {"role": "user", "content": [
            {"type": "text", "text": "w5"},
            {"type": "image_url", "image_url": {"url": "data:image/png;base64," + b64}},
            {"type": "text", "text": "w6"}]}]}
    msgs = {**chat, "messages": [{"role": "user", "content": [
        {"type": "text", "text": "w5"},
        {"type": "image", "source": {"type": "base64", "media_type": "image/png", "data": b64}},
        {"type": "text", "text": "w6"}]}]}
    jctx = jserver.AppContext(policy="round_robin")
    jctx.tokenizers.register("tiny-vlm", JaxMockTokenizer(), default=True)
    jctx.registry.add(JaxWorker(worker_id="inproc-0", model_id="tiny-vlm",
                                client=JaxInProc(jax_engine("mrope",
                                                            tokenizer=JaxMockTokenizer()))))
    tctx = tlaunch.build_context(port_engine("mrope", tokenizer=MockTokenizer()),
                                 policy="round_robin", drain_timeout_secs=2)

    async def post_both(server, ctx):
        tc = TestClient(TestServer(server.build_app(ctx)))
        await tc.start_server()
        try:
            out = []
            for path, body in (("/v1/chat/completions", chat), ("/v1/messages", msgs)):
                resp = await tc.post(path, json=body)
                out.append((resp.status, await resp.json()))
            return out
        finally:
            await tc.close()
            for w in ctx.registry.list():
                await w.client.close()

    want = asyncio.run(post_both(jserver, jctx))
    got = asyncio.run(post_both(tserver, tctx))
    assert [s for s, _ in got] == [s for s, _ in want] == [200, 200]
    assert _canon(got[1][1], {}) == _canon(want[1][1], {})
    (_, c), (_, m) = got
    assert m["content"] == [{"type": "text", "text": c["choices"][0]["message"]["content"]}]
    assert m["usage"]["input_tokens"] == c["usage"]["prompt_tokens"] > 10  # expanded
