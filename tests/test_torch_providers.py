"""Third-party providers on the port's gateway against the reference's, on
the CPU.

Every case of ``tests/test_providers.py`` and ``tests/test_providers_v2.py``
runs through both gateways (``smg_tpu.gateway.server.build_app`` and the
port's), each with the same six providers registered (OpenAI with a model
map, Anthropic, Gemini, xAI, Bedrock, and an OpenAI-format backend behind
the ``/v1/messages`` bridge), over ONE set of the reference tests' own fake
upstreams on a private loop.  Each fake records every request it receives
(method, path and query, headers, raw body).  For each case the statuses,
bodies and SSE frames of the two gateways are identical once ids and times
are removed, the fakes received byte-identical requests from both (Bedrock's
SigV4 headers under one pinned clock), and the reference test's own
assertions hold on the port's answer.  The reference files' unit cases
(the xAI input rewrite, the Bedrock translations and signature, registry
resolution) run on both packages' functions and compare results."""

import asyncio
import datetime
import functools
import json
import re
import threading

import pytest
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

from smg_tpu.gateway import server as jserver
from smg_tpu.gateway.providers import ProviderRegistry as JaxProviders
from smg_tpu.gateway.providers import ProviderSpec as JaxSpec
from smg_tpu.gateway.providers import bedrock as jbedrock
from smg_tpu.gateway.providers import xai as jxai
from smg_tpu.protocols import openai as joai
from smg_tpu_torch.gateway import server as tserver
from smg_tpu_torch.gateway.providers import ProviderRegistry, ProviderSpec
from smg_tpu_torch.gateway.providers import bedrock as tbedrock
from smg_tpu_torch.gateway.providers import xai as txai
from smg_tpu_torch.protocols import openai as toai
from test_providers import make_mock_anthropic, make_mock_gemini, make_mock_openai
from test_providers_v2 import make_mock_bedrock, make_mock_openai_for_bridge, make_mock_xai

MAKERS = {"openai": make_mock_openai, "anthropic": make_mock_anthropic,
          "gemini": make_mock_gemini, "xai": make_mock_xai, "bedrock": make_mock_bedrock,
          "bridge": make_mock_openai_for_bridge}
NOW = datetime.datetime(2026, 7, 30, 12, 0, 0, tzinfo=datetime.timezone.utc)
IDS = re.compile(r"(msg|chatcmpl|call|toolu|resp|req)[_-][0-9a-f]{16,}")
TIMES = ("created", "created_at")


def _specs(url: dict) -> list:
    """The reference fixtures' provider specs, as keyword arguments."""
    return [
        dict(name="openai", kind="openai", base_url=url["openai"], api_key="sk-test-123",
             models=["gpt-4o-mini"], model_map={"gpt-4o-mini": "gpt-4o-mini-2024"}),
        dict(name="anthropic", kind="anthropic", base_url=url["anthropic"],
             api_key="sk-ant-test"),
        dict(name="gemini", kind="gemini", base_url=url["gemini"], api_key="AIza-test"),
        dict(name="xai", kind="xai", base_url=url["xai"], api_key="xai-test", models=["grok-4"]),
        dict(name="bedrock", kind="bedrock", base_url=url["bedrock"], api_key="AKID:SECRET",
             models=["anthropic.claude-3-sonnet"]),
        dict(name="oai-bridge", kind="openai", base_url=url["bridge"], api_key="sk-b",
             models=["bridge-model"]),
    ]


def _canon(obj, seen: dict):
    """Ids replaced by their order of first appearance; times removed."""
    if isinstance(obj, str):
        return IDS.sub(lambda m: seen.setdefault(m.group(0), f"<{m.group(1)}{len(seen)}>"), obj)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_canon(v, seen) for v in obj)
    if isinstance(obj, dict):
        return {k: _canon(v, seen) for k, v in obj.items() if k not in TIMES}
    return obj


def _parse(ctype: str, text: str):
    """JSON, or the SSE frames as (event name or None, payload) in order."""
    if ctype != "text/event-stream":
        return json.loads(text)
    frames = []
    for block in text.strip().split("\n\n"):
        name, data = None, None
        for line in block.split("\n"):
            if line.startswith("event: "):
                name = line[7:]
            elif line.startswith("data: "):
                data = line[6:]
        frames.append((name, data if data == "[DONE]" else json.loads(data)))
    return frames


class Pair:
    """The fake upstreams and the two gateways on one private loop thread."""

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        self.received: list = []  # every request any fake received, in order
        self.seen = {k: [] for k in MAKERS}
        self.mocks = {k: self.run(self._start_mock(k)) for k in MAKERS}
        url = {k: str(s.make_url("")).rstrip("/") for k, s in self.mocks.items()}
        self.ctxs, self.clients = [], []
        for server, spec_cls in ((jserver, JaxSpec), (tserver, ProviderSpec)):
            ctx = server.AppContext(policy="round_robin")
            for spec in _specs(url):
                ctx.providers.register(spec_cls(**spec))
            self.ctxs.append(ctx)
            self.clients.append(self.run(self._start(server, ctx)))

    def run(self, coro, timeout=60):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout=timeout)

    async def _start_mock(self, kind: str):
        @web.middleware
        async def record(request, handler):
            body = await request.read()
            self.received.append((kind, request.method, request.path_qs,
                                  dict(request.headers), body))
            return await handler(request)

        app = MAKERS[kind](self.seen[kind])
        app.middlewares.append(record)
        server = TestServer(app)
        await server.start_server()
        return server

    @staticmethod
    async def _start(server, ctx):
        tc = TestClient(TestServer(server.build_app(ctx)))
        await tc.start_server()
        return tc

    async def _one(self, tc, method, path, body):
        resp = await tc.request(method, path, json=body)
        return resp.status, resp.headers.get("Content-Type", "").split(";")[0], await resp.text()

    def call(self, method: str, path: str, body=None):
        """Both gateways' (status, content type, canonical body) and the
        requests the fakes received for each, asserted equal; returns the
        port's (status, parsed body, requests received)."""
        got, ups = [], []
        for tc in self.clients:
            n = len(self.received)
            st, ctype, text = self.run(self._one(tc, method, path, body))
            parsed = _parse(ctype, text)
            got.append((st, ctype, _canon(parsed, {})))
            ups.append(self.received[n:])
        assert got[1] == got[0], (method, path, body)
        assert ups[1] == ups[0], (method, path, body)
        return got[1][0], parsed, ups[1]

    def close(self):
        for tc in self.clients:
            self.run(tc.close())
        for s in self.mocks.values():
            self.run(s.close())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=10)


@pytest.fixture(scope="module")
def pair():
    # one clock for both packages' SigV4 signatures
    real = jbedrock.sigv4_headers, tbedrock.sigv4_headers
    jbedrock.sigv4_headers = functools.partial(real[0], now=NOW)
    tbedrock.sigv4_headers = functools.partial(real[1], now=NOW)
    p = Pair()
    yield p
    p.close()
    jbedrock.sigv4_headers, tbedrock.sigv4_headers = real


def _data(frames) -> list:
    return [d for _n, d in frames if d != "[DONE]"]


def _headers(up) -> dict:
    return {k.lower(): v for k, v in up[3].items()}


# ---- tests/test_providers.py ----

def test_openai_provider_roundtrip(pair):
    st, body, ups = pair.call("POST", "/v1/chat/completions", {
        "model": "gpt-4o-mini", "messages": [{"role": "user", "content": "hello"}]})
    assert st == 200, body
    assert body["choices"][0]["message"]["content"] == "upstream says hi"
    assert body["usage"]["total_tokens"] == 10
    (up,) = ups
    assert _headers(up)["authorization"] == "Bearer sk-test-123"
    assert json.loads(up[4])["model"] == "gpt-4o-mini-2024"  # model_map applied
    assert body["model"] == "gpt-4o-mini"  # gateway-facing id echoed back


def test_openai_provider_streaming(pair):
    st, frames, _ = pair.call("POST", "/v1/chat/completions", {
        "model": "gpt-4o-mini", "messages": [{"role": "user", "content": "hello"}],
        "stream": True})
    assert st == 200 and frames[-1] == (None, "[DONE]")
    # one frame out for each upstream frame, in order, the model restamped
    assert [f["choices"][0]["delta"] for f in _data(frames)] == [
        {"role": "assistant"}, {"content": "hi "}, {"content": "there"}, {}]
    assert {f["model"] for f in _data(frames)} == {"gpt-4o-mini"}
    assert "".join(f["choices"][0]["delta"].get("content") or ""
                   for f in _data(frames)) == "hi there"


def test_openai_provider_tool_calls(pair):
    st, body, _ = pair.call("POST", "/v1/chat/completions", {
        "model": "gpt-4o-mini", "messages": [{"role": "user", "content": "weather in paris?"}],
        "tools": [{"type": "function", "function": {
            "name": "get_weather",
            "parameters": {"type": "object", "properties": {"city": {"type": "string"}}}}}]})
    tc = body["choices"][0]["message"]["tool_calls"][0]
    assert tc["function"]["name"] == "get_weather"
    assert json.loads(tc["function"]["arguments"]) == {"city": "Paris"}
    assert body["choices"][0]["finish_reason"] == "tool_calls"


def test_openai_provider_drops_the_gateway_only_sampling_keys(pair):
    st, body, ups = pair.call("POST", "/v1/chat/completions", {
        "model": "openai/gpt-4.1", "messages": [{"role": "user", "content": "hello"}],
        "temperature": 0, "top_k": 5, "min_p": 0.1, "repetition_penalty": 1.1,
        "ignore_eos": True, "skip_special_tokens": False, "separate_reasoning": True})
    assert st == 200, body
    sent = json.loads(ups[0][4])
    assert sent["model"] == "gpt-4.1" and sent["temperature"] == 0  # greedy reaches it
    assert not {"top_k", "min_p", "repetition_penalty", "ignore_eos", "skip_special_tokens",
                "separate_reasoning"} & set(sent)


def test_anthropic_provider_translation(pair):
    st, body, ups = pair.call("POST", "/v1/chat/completions", {
        "model": "anthropic/claude-x",
        "messages": [
            {"role": "system", "content": "be brief"},
            {"role": "user", "content": "bonjour?"},
            {"role": "assistant", "content": None, "tool_calls": [{
                "id": "call_a", "type": "function",
                "function": {"name": "get_weather", "arguments": "{\"city\": \"Paris\"}"}}]},
            {"role": "tool", "tool_call_id": "call_a", "content": "{\"temp\": 21}"},
        ],
        "tools": [{"type": "function", "function": {"name": "get_weather",
                                                    "parameters": {"type": "object"}}}],
        "max_tokens": 64, "temperature": 0})
    assert st == 200, body
    (up,) = ups
    assert _headers(up)["x-api-key"] == "sk-ant-test"
    ub = json.loads(up[4])
    assert (ub["model"], ub["system"], ub["max_tokens"], ub["temperature"]) == (
        "claude-x", "be brief", 64, 0)
    assert ub["tools"][0]["input_schema"] == {"type": "object"}
    assert [m["role"] for m in ub["messages"]] == ["user", "assistant", "user"]
    assert ub["messages"][1]["content"][0]["type"] == "tool_use"
    assert ub["messages"][2]["content"][0]["type"] == "tool_result"
    assert ub["messages"][2]["content"][0]["tool_use_id"] == "call_a"
    msg = body["choices"][0]["message"]
    assert msg["content"] == "bonjour"
    assert msg["tool_calls"][0]["function"]["name"] == "get_weather"
    assert body["choices"][0]["finish_reason"] == "tool_calls"
    assert body["usage"] == {"prompt_tokens": 11, "completion_tokens": 5, "total_tokens": 16}


def test_anthropic_provider_streaming_tool_call(pair):
    st, frames, _ = pair.call("POST", "/v1/chat/completions", {
        "model": "anthropic/claude-x", "messages": [{"role": "user", "content": "weather?"}],
        "stream": True})
    frames = _data(frames)
    assert "".join(f["choices"][0]["delta"].get("content") or "" for f in frames) == "I'll check."
    calls = [t for f in frames for t in f["choices"][0]["delta"].get("tool_calls") or []]
    assert json.loads("".join(t["function"].get("arguments", "") for t in calls)) == {
        "city": "Paris"}
    assert [t["function"]["name"] for t in calls if t["function"].get("name")] == ["get_weather"]
    assert frames[-1]["choices"][0]["finish_reason"] == "tool_calls"


def test_gemini_provider_translation(pair):
    st, body, ups = pair.call("POST", "/v1/chat/completions", {
        "model": "gemini/gemini-pro",
        "messages": [{"role": "system", "content": "be nice"},
                     {"role": "user", "content": "hallo"}],
        "tools": [{"type": "function", "function": {"name": "get_weather",
                                                    "parameters": {"type": "object"}}}],
        "temperature": 0.5, "max_tokens": 32})
    assert st == 200, body
    (up,) = ups
    assert _headers(up)["x-goog-api-key"] == "AIza-test"
    assert up[2].endswith("/models/gemini-pro:generateContent")
    ub = json.loads(up[4])
    assert ub["systemInstruction"]["parts"] == [{"text": "be nice"}]
    assert ub["generationConfig"]["temperature"] == 0.5
    assert ub["generationConfig"]["maxOutputTokens"] == 32
    assert ub["tools"][0]["functionDeclarations"][0]["name"] == "get_weather"
    msg = body["choices"][0]["message"]
    assert msg["content"] == "guten tag"
    assert json.loads(msg["tool_calls"][0]["function"]["arguments"]) == {"city": "Paris"}
    assert body["choices"][0]["finish_reason"] == "tool_calls"


def test_gemini_provider_streaming(pair):
    st, frames, ups = pair.call("POST", "/v1/chat/completions", {
        "model": "gemini/gemini-pro", "messages": [{"role": "user", "content": "hallo"}],
        "stream": True})
    assert ups[0][2].endswith("/models/gemini-pro:streamGenerateContent?alt=sse")
    data = _data(frames)
    assert "".join(f["choices"][0]["delta"].get("content") or "" for f in data) == "guten tag"
    assert data[-1]["choices"][0]["finish_reason"] == "stop"
    assert frames[-1] == (None, "[DONE]")


def test_provider_models_listed(pair):
    st, body, ups = pair.call("GET", "/v1/models")
    assert ups == []
    assert [m["id"] for m in body["data"]] == ["gpt-4o-mini", "grok-4",
                                               "anthropic.claude-3-sonnet", "bridge-model"]


def test_unknown_model_not_provider_routed(pair):
    """A model no provider serves falls through to worker routing (and no
    worker is registered): no fake sees a request."""
    st, body, ups = pair.call("POST", "/v1/chat/completions", {
        "model": "totally-unknown", "messages": [{"role": "user", "content": "x"}]})
    assert st in (500, 503) and ups == []


def test_registry_resolution_unit():
    for reg_cls, spec_cls in ((JaxProviders, JaxSpec), (ProviderRegistry, ProviderSpec)):
        reg = reg_cls()
        reg.register(spec_cls(name="openai", kind="openai", base_url="http://x",
                              models=["gpt-4o"]))
        assert reg.resolve("gpt-4o") is not None
        assert reg.resolve("openai/gpt-4.1") is not None
        assert reg.resolve("claude-x") is None and reg.resolve(None) is None
    errors = []
    for reg_cls, spec_cls in ((JaxProviders, JaxSpec), (ProviderRegistry, ProviderSpec)):
        with pytest.raises(ValueError) as e:
            reg_cls().register(spec_cls(name="z", kind="nope", base_url="http://x"))
        errors.append(str(e.value))
    assert errors[1] == errors[0] and errors[1].startswith("unknown provider kind 'nope'")


def test_upstream_model_strips_the_prefix_then_remaps():
    for spec_cls in (JaxSpec, ProviderSpec):
        spec = spec_cls(name="p", kind="openai", base_url="http://x", model_map={"a": "b"})
        assert [spec.upstream_model(m) for m in ("p/a", "a", "p/c", "q/a")] == [
            "b", "b", "c", "q/a"]


def test_provider_errors_keep_4xx_and_map_5xx_and_unreachable_to_502(pair):
    # a 404 from the fake (no such route on the xAI fake for Gemini's path
    # shape) keeps its status; a provider nothing listens on is a 502
    async def add_dead():
        for ctx, spec_cls in zip(pair.ctxs, (JaxSpec, ProviderSpec)):
            ctx.providers.register(spec_cls(name="dead", kind="openai",
                                            base_url="http://127.0.0.1:9", models=["dead-m"]))
            ctx.providers.register(spec_cls(name="wrong", kind="gemini",
                                            base_url=str(pair.mocks["xai"].make_url(""))
                                            .rstrip("/"), models=["wrong-m"]))

    pair.run(add_dead())
    try:
        for model, status in (("dead-m", 502), ("wrong-m", 404)):
            for stream in (False, True):
                st, body, _ = pair.call("POST", "/v1/chat/completions", {
                    "model": model, "stream": stream,
                    "messages": [{"role": "user", "content": "x"}]})
                if stream:  # the headers went out: an error frame
                    assert st == 200 and _data(body)[-1]["error"]["type"] == "provider_error"
                else:
                    assert (st, body["error"]["type"]) == (status, "provider_error")
    finally:
        for ctx in pair.ctxs:
            del ctx.providers._adapters[-2:]


# ---- tests/test_providers_v2.py ----

def test_xai_responses_input_rewrite():
    body = {"model": "grok-4", "input": [
        {"type": "message", "role": "user", "id": "itm_1", "status": "done",
         "content": [{"type": "input_text", "text": "hi"}]},
        {"type": "message", "role": "assistant",
         "content": [{"type": "output_text", "text": "prior answer"}]}]}
    want = jxai.transform_responses_input(json.loads(json.dumps(body)))
    out = txai.transform_responses_input(json.loads(json.dumps(body)))
    assert out == want
    assert "id" not in out["input"][0] and "status" not in out["input"][0]
    assert out["input"][0]["content"][0]["type"] == "input_text"
    assert out["input"][1]["content"][0] == {"type": "input_text", "text": "prior answer"}


def test_xai_rewrite_ignores_string_input():
    assert txai.transform_responses_input({"input": "plain"}) == \
        jxai.transform_responses_input({"input": "plain"}) == {"input": "plain"}


def _converse_request(oai):
    return oai.ChatCompletionRequest(
        model="bedrock/claude", max_tokens=64, temperature=0.3, top_p=0.9, stop=["END"],
        messages=[
            oai.ChatMessage(role="system", content="be brief"),
            oai.ChatMessage(role="user", content="weather?"),
            oai.ChatMessage(role="assistant", content=None, tool_calls=[{
                "id": "t1", "type": "function",
                "function": {"name": "get_weather", "arguments": '{"c": "P"}'}}]),
            oai.ChatMessage(role="tool", content="18C", tool_call_id="t1"),
        ],
        tools=[oai.Tool(function=oai.FunctionDef(name="get_weather", description="w",
                                                 parameters={"type": "object"}))])


def test_chat_to_converse_shapes():
    body = tbedrock.chat_to_converse(_converse_request(toai))
    assert body == jbedrock.chat_to_converse(_converse_request(joai))
    assert body["system"] == [{"text": "be brief"}]
    assert body["messages"][0] == {"role": "user", "content": [{"text": "weather?"}]}
    tu = body["messages"][1]["content"][0]["toolUse"]
    assert tu["name"] == "get_weather" and tu["input"] == {"c": "P"}
    assert body["messages"][2]["content"][0]["toolResult"]["toolUseId"] == "t1"
    assert body["inferenceConfig"] == {"maxTokens": 64, "temperature": 0.3, "topP": 0.9,
                                       "stopSequences": ["END"]}
    assert body["toolConfig"]["tools"][0]["toolSpec"]["inputSchema"] == {
        "json": {"type": "object"}}


def test_converse_to_chat_tool_use():
    data = {"output": {"message": {"role": "assistant", "content": [
        {"text": "checking"}, {"toolUse": {"toolUseId": "tu1", "name": "f", "input": {"a": 1}}}]}},
        "stopReason": "tool_use", "usage": {"inputTokens": 5, "outputTokens": 9,
                                             "totalTokens": 14}}
    out = tbedrock.converse_to_chat(data, "bedrock/claude")
    assert out == jbedrock.converse_to_chat(data, "bedrock/claude")
    msg = out["choices"][0]["message"]
    assert msg["content"] == "checking"
    assert json.loads(msg["tool_calls"][0]["function"]["arguments"]) == {"a": 1}
    assert out["choices"][0]["finish_reason"] == "tool_calls"
    assert out["usage"]["total_tokens"] == 14


def test_sigv4_deterministic_and_secret_sensitive():
    url = "https://bedrock-runtime.us-west-2.amazonaws.com/model/m/converse"
    for args in ((b"{}", "AKID", "SECRET"), (b"{}", "AKID", "OTHER"),
                 (b'{"a": 1}', "AKID", "SECRET")):
        got = tbedrock.sigv4_headers("POST", url, *args, "us-west-2", now=NOW)
        assert got == jbedrock.sigv4_headers("POST", url, *args, "us-west-2", now=NOW)
    h1 = tbedrock.sigv4_headers("POST", url, b"{}", "AKID", "SECRET", "us-west-2", now=NOW)
    h3 = tbedrock.sigv4_headers("POST", url, b"{}", "AKID", "OTHER", "us-west-2", now=NOW)
    assert h1["authorization"] != h3["authorization"]
    assert h1["x-amz-date"] == "20260730T120000Z"
    assert h1["authorization"].startswith(
        "AWS4-HMAC-SHA256 Credential=AKID/20260730/us-west-2/bedrock/aws4_request, "
        "SignedHeaders=host;x-amz-date, Signature=")


def test_xai_chat_roundtrip(pair):
    st, body, ups = pair.call("POST", "/v1/chat/completions", {
        "model": "grok-4", "messages": [{"role": "user", "content": "hi"}]})
    assert st == 200, body
    assert body["choices"][0]["message"]["content"] == "grok says hi"
    assert _headers(ups[0])["authorization"] == "Bearer xai-test"


def test_xai_responses_upstream_rewrite(pair):
    st, body, ups = pair.call("POST", "/v1/responses", {
        "model": "grok-4",
        "input": [{"type": "message", "role": "user", "id": "a", "status": "done",
                   "content": [{"type": "input_text", "text": "q"}]},
                  {"type": "message", "role": "assistant",
                   "content": [{"type": "output_text", "text": "prev"}]}]})
    assert st == 200 and body["status"] == "completed", body
    assert body["model"] == "grok-4"
    (up,) = ups
    assert up[2] == "/responses"
    items = json.loads(up[4])["input"]
    assert "id" not in items[0]
    assert items[1]["content"][0]["type"] == "input_text"


def test_bedrock_chat_roundtrip_signed(pair):
    st, body, ups = pair.call("POST", "/v1/chat/completions", {
        "model": "anthropic.claude-3-sonnet",
        "messages": [{"role": "system", "content": "brief"},
                     {"role": "user", "content": "hello"}],
        "max_tokens": 32})
    assert st == 200, body
    assert body["choices"][0]["message"]["content"] == "bedrock says hi"
    assert body["usage"]["total_tokens"] == 10
    (up,) = ups
    assert up[2].endswith("/converse")
    sent = json.loads(up[4])
    assert sent["system"] == [{"text": "brief"}]
    assert sent["messages"] == [{"role": "user", "content": [{"text": "hello"}]}]
    auth = _headers(up)["authorization"]
    assert auth.startswith("AWS4-HMAC-SHA256 Credential=AKID/20260730/")
    assert "SignedHeaders=host;x-amz-date" in auth
    assert _headers(up)["x-amz-date"] == "20260730T120000Z"


def test_bedrock_tool_calls(pair):
    st, body, _ = pair.call("POST", "/v1/chat/completions", {
        "model": "anthropic.claude-3-sonnet", "messages": [{"role": "user", "content": "w?"}],
        "tools": [{"type": "function", "function": {"name": "get_weather",
                                                    "parameters": {"type": "object"}}}]})
    assert st == 200, body
    tc = body["choices"][0]["message"]["tool_calls"][0]
    assert tc["function"]["name"] == "get_weather"
    assert json.loads(tc["function"]["arguments"]) == {"city": "Paris"}
    assert body["choices"][0]["finish_reason"] == "tool_calls"


def test_bedrock_streaming(pair):
    st, frames, ups = pair.call("POST", "/v1/chat/completions", {
        "model": "anthropic.claude-3-sonnet", "stream": True,
        "messages": [{"role": "user", "content": "weather?"}]})
    assert ups[0][2].endswith("/converse-stream")
    chunks = _data(frames)
    text = "".join(c["choices"][0]["delta"].get("content") or ""
                   for c in chunks if c.get("choices"))
    assert text == "hi from bedrock"
    calls = [tc for c in chunks if c.get("choices")
             for tc in c["choices"][0]["delta"].get("tool_calls") or []]
    assert [tc["function"]["name"] for tc in calls if tc["function"].get("name")] == [
        "get_weather"]
    assert json.loads("".join(tc["function"].get("arguments") or "" for tc in calls)) == {
        "city": "Paris"}
    assert "tool_calls" in [c["choices"][0].get("finish_reason")
                            for c in chunks if c.get("choices")]
    usage = [c["usage"] for c in chunks if c.get("usage")]
    assert usage and usage[-1]["total_tokens"] == 10


def test_bridge_messages_roundtrip(pair):
    st, body, ups = pair.call("POST", "/v1/messages", {
        "model": "bridge-model", "max_tokens": 64, "temperature": 0,
        "messages": [{"role": "user", "content": "do it"}]})
    assert st == 200, body
    assert [b["type"] for b in body["content"]] == ["text", "tool_use"]
    assert body["content"][0]["text"] == "bridged answer"
    assert (body["content"][1]["name"], body["content"][1]["input"]) == ("f", {"x": 2})
    assert body["stop_reason"] == "tool_use"
    assert body["usage"]["input_tokens"] == 5
    sent = json.loads(ups[0][4])  # the upstream saw an OpenAI-format request
    assert sent["messages"] == [{"role": "user", "content": "do it"}]
    assert sent["temperature"] == 0


def test_bridge_messages_streaming_grammar(pair):
    st, frames, _ = pair.call("POST", "/v1/messages", {
        "model": "bridge-model", "max_tokens": 64, "stream": True,
        "messages": [{"role": "user", "content": "do it"}]})
    names = [n for n, _ in frames]
    assert names[0] == "message_start"
    assert names[-2:] == ["message_delta", "message_stop"]
    text = "".join(d["delta"]["text"] for n, d in frames
                   if n == "content_block_delta" and d["delta"]["type"] == "text_delta")
    assert text == "bridged text"
    tools = [d for n, d in frames
             if n == "content_block_start" and d["content_block"]["type"] == "tool_use"]
    assert len(tools) == 1, "fragmented args must not open extra blocks"
    assert (tools[0]["content_block"]["name"], tools[0]["content_block"]["id"]) == ("f",
                                                                                    "call_7")
    idx = tools[0]["index"]
    frags = [d["delta"]["partial_json"] for n, d in frames if n == "content_block_delta"
             and d["delta"]["type"] == "input_json_delta" and d["index"] == idx]
    assert json.loads("".join(frags)) == {"x": 1}
    assert len([d for n, d in frames if n == "content_block_stop" and d["index"] == idx]) == 1
    md = next(d for n, d in frames if n == "message_delta")
    assert md["delta"]["stop_reason"] == "tool_use"
    assert md["usage"] == {"input_tokens": 11, "output_tokens": 7}


def test_bridge_requests_usage_frame(pair):
    """The provider bridge asks the upstream for the usage frame."""
    _st, _frames, ups = pair.call("POST", "/v1/messages", {
        "model": "bridge-model", "max_tokens": 8, "stream": True,
        "messages": [{"role": "user", "content": "x"}]})
    assert (json.loads(ups[0][4]).get("stream_options") or {}).get("include_usage") is True


def test_responses_via_chat_only_provider(pair):
    """A chat-only provider model still serves /v1/responses (made over
    adapter.chat)."""
    st, body, _ = pair.call("POST", "/v1/responses", {"model": "bridge-model", "input": "do it"})
    assert st == 200, body
    kinds = [o["type"] for o in body["output"]]
    assert "message" in kinds and "function_call" in kinds
    assert next(o for o in body["output"] if o["type"] == "message")["content"][0]["text"] == \
        "bridged answer"
    fc = next(o for o in body["output"] if o["type"] == "function_call")
    assert fc["name"] == "f" and json.loads(fc["arguments"]) == {"x": 2}
    assert body["usage"]["total_tokens"] == 9


def test_bedrock_merges_consecutive_user_turns(pair):
    """Parallel tool results and the next user turn merge into ONE Converse
    user message (Bedrock requires role alternation)."""
    st, _body, ups = pair.call("POST", "/v1/chat/completions", {
        "model": "anthropic.claude-3-sonnet",
        "messages": [
            {"role": "user", "content": "weather in two cities"},
            {"role": "assistant", "content": None, "tool_calls": [
                {"id": "t1", "type": "function", "function": {"name": "w",
                                                               "arguments": '{"c": "P"}'}},
                {"id": "t2", "type": "function", "function": {"name": "w",
                                                               "arguments": '{"c": "L"}'}}]},
            {"role": "tool", "content": "18C", "tool_call_id": "t1"},
            {"role": "tool", "content": "15C", "tool_call_id": "t2"},
            {"role": "user", "content": "so which is warmer?"},
        ]})
    assert st == 200
    sent = json.loads(ups[0][4])
    assert [m["role"] for m in sent["messages"]] == ["user", "assistant", "user"]
    assert [list(b)[0] for b in sent["messages"][2]["content"]] == ["toolResult", "toolResult",
                                                                    "text"]
