"""The port's gateway against the JAX gateway over HTTP.

Both apps run on one private event loop: ``smg_tpu.gateway.server.build_app``
over two JAX ``Engine`` workers, and ``smg_tpu_torch.gateway.server.build_app``
over two port ``Engine`` workers on the CPU, with the same bridged weights,
the same ``MockTokenizer`` vocabulary and ``cache_aware`` routing from the
same seed.  Every request goes to both, in the same order, so routing
decisions and radix-cache state match.

- Generation and tokenizer routes: bodies identical once ids and timestamps
  are removed; SSE frames identical frame by frame.
- Operational routes: identical status codes and the keys the gateway and
  the loadgen read.
- A shared-prefix pair lands on one worker, on both gateways.
- The ``serve`` CLI's argument parsing and app factory, on ``--device cpu``.
"""

import asyncio
import functools
import json
import threading

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

import jax
from smg_tpu.engine import config as jconf
from smg_tpu.engine.engine import Engine as JaxEngine
from smg_tpu.gateway import server as jserver
from smg_tpu.gateway.worker_client import InProcWorkerClient as JaxInProc
from smg_tpu.gateway.workers import Worker as JaxWorker
from smg_tpu.models.config import tiny_test_config
from smg_tpu.models.registry import get_model
from smg_tpu.tokenizer import MockTokenizer as JaxMockTokenizer
from smg_tpu_torch.engine import config as tconf
from smg_tpu_torch.engine.engine import Engine
from smg_tpu_torch.gateway import server as tserver
from smg_tpu_torch.gateway.worker_client import InProcWorkerClient
from smg_tpu_torch.gateway.workers import Worker
from smg_tpu_torch.models.config import tiny_test_config as port_tiny
from smg_tpu_torch.models.convert import params_from_jax
from smg_tpu_torch.tokenizer import MockTokenizer

torch.set_num_threads(2)
MODEL = "tiny-test"
SCHED = dict(max_batch_size=8, max_seq_len=256, max_prefill_tokens=64,
             decode_batch_buckets=(4, 8), decode_horizon=4)


@functools.lru_cache(maxsize=1)
def jax_params():
    cfg = tiny_test_config()
    return get_model(cfg.arch).init_params(cfg, jax.random.PRNGKey(0))


def _jax_engine():
    return JaxEngine(jconf.EngineConfig(
        model=tiny_test_config(),
        cache=jconf.CacheConfig(page_size=16, num_pages=256, auto_size=False, dtype="float32"),
        scheduler=jconf.SchedulerConfig(prefill_token_buckets=(16, 32, 64), **SCHED),
        dtype="float32", model_id=MODEL), params=jax_params())


def _port_engine():
    return Engine(tconf.EngineConfig(
        model=port_tiny(),
        cache=tconf.CacheConfig(page_size=16, num_pages=256, auto_size=False, dtype="float32"),
        scheduler=tconf.SchedulerConfig(**SCHED), model_id=MODEL),
        params=params_from_jax(jax.tree.map(np.asarray, jax_params())), device="cpu")


class Gateways:
    """The two apps on a private loop thread; ``call`` sends one request to
    both and returns ((status, body), (status, body)) for JAX and port."""

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        self.engines = []
        self.clients = [self.run(self._start(jserver, JaxInProc, JaxWorker, _jax_engine,
                                             JaxMockTokenizer())),
                        self.run(self._start(tserver, InProcWorkerClient, Worker,
                                             _port_engine, MockTokenizer()))]

    def run(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout=120)

    async def _start(self, server, client_cls, worker_cls, make_engine, tokenizer):
        ctx = server.AppContext(policy="cache_aware", policy_kwargs={"seed": 0})
        ctx.tokenizers.register(MODEL, tokenizer, default=True)
        for i in range(2):
            engine = make_engine()
            self.engines.append(engine)
            ctx.registry.add(worker_cls(worker_id=f"w{i}", client=client_cls(engine),
                                        model_id=MODEL, page_size=16))
        tc = TestClient(TestServer(server.build_app(ctx)))
        await tc.start_server()
        return tc

    async def _one(self, tc, method, path, body):
        resp = await tc.request(method, path, json=body)
        text = await resp.text()
        return resp.status, text

    def call(self, method: str, path: str, body=None):
        return [self.run(self._one(tc, method, path, body)) for tc in self.clients]

    def close(self):
        for tc in self.clients:
            self.run(tc.close())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=10)
        for e in self.engines:
            e.stop()


@pytest.fixture(scope="module")
def gw():
    g = Gateways()
    yield g
    g.close()


def _strip(obj):
    """Drop request ids and timestamps, which differ by construction."""
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in ("id", "created")}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def _frames(text: str) -> list:
    out = []
    for block in text.split("\n\n"):
        if block.startswith("data: "):
            data = block[len("data: "):]
            out.append(data if data == "[DONE]" else _strip(json.loads(data)))
    return out


def _same_json(gw, method, path, body=None):
    (js, jt), (ps, pt) = gw.call(method, path, body)
    assert ps == js, (path, js, jt, ps, pt)
    jb, pb = json.loads(jt), json.loads(pt)
    assert _strip(pb) == _strip(jb), path
    return ps, pb


def _same_sse(gw, path, body):
    (js, jt), (ps, pt) = gw.call("POST", path, body)
    assert ps == js == 200, (jt, pt)
    jf, pf = _frames(jt), _frames(pt)
    assert pf == jf
    assert pf[-1] == "[DONE]"
    return pf


def _chat(content, **kw):
    return {"model": MODEL, "messages": [{"role": "user", "content": content}],
            "temperature": 0, "ignore_eos": True, **kw}


def test_chat_with_and_without_streaming(gw):
    _, body = _same_json(gw, "POST", "/v1/chat/completions", _chat("w5 w6 w7", max_tokens=9))
    assert body["choices"][0]["finish_reason"] == "length"
    assert body["usage"]["completion_tokens"] == 9
    frames = _same_sse(gw, "/v1/chat/completions", _chat(
        "w5 w6 w7", max_tokens=9, stream=True, stream_options={"include_usage": True}))
    text = "".join(f["choices"][0]["delta"].get("content") or ""
                   for f in frames[:-1] if f["choices"])
    assert text == body["choices"][0]["message"]["content"]
    assert frames[-2]["usage"]["completion_tokens"] == 9


def test_chat_n2(gw):
    _, body = _same_json(gw, "POST", "/v1/chat/completions",
                         _chat("w11 w12 w13 w14", max_tokens=6, n=2))
    assert [c["index"] for c in body["choices"]] == [0, 1]
    # the two choices' frames interleave as the engine loop happens to step
    # them, so the streams are compared choice by choice
    (js, jt), (ps, pt) = gw.call("POST", "/v1/chat/completions",
                                 _chat("w21 w22 w23", max_tokens=5, n=2, stream=True))
    assert ps == js == 200

    def by_choice(frames):
        out = {}
        for f in frames[:-1]:
            c = f["choices"][0]
            text, fin = out.get(c["index"], ("", None))
            out[c["index"]] = (text + (c["delta"].get("content") or ""),
                               c.get("finish_reason") or fin)
        return out

    jf, pf = _frames(jt), _frames(pt)
    assert pf[-1] == jf[-1] == "[DONE]"
    assert by_choice(pf) == by_choice(jf) and set(by_choice(pf)) == {0, 1}


def test_completions_and_generate(gw):
    _, body = _same_json(gw, "POST", "/v1/completions",
                         {"model": MODEL, "prompt": "w40 w41 w42 w43", "max_tokens": 7,
                          "temperature": 0, "ignore_eos": True})
    assert body["choices"][0]["text"].startswith("w")
    _same_sse(gw, "/v1/completions", {"model": MODEL, "prompt": [50, 51, 52],
                                      "max_tokens": 5, "temperature": 0, "stream": True})
    long_ids = [(7 * i) % 500 + 2 for i in range(150)]  # three prefill chunks
    _, gen = _same_json(gw, "POST", "/generate", {
        "input_ids": long_ids, "sampling_params": {"max_new_tokens": 6, "temperature": 0,
                                                   "ignore_eos": True}})
    assert len(gen["output_ids"]) == 6
    frames = _same_sse(gw, "/generate", {
        "text": "w60 w61 w62", "stream": True,
        "sampling_params": {"max_new_tokens": 5, "temperature": 0, "ignore_eos": True}})
    assert frames[-2]["meta_info"]["finish_reason"]["type"] == "length"


def test_stop_string(gw):
    _, body = _same_json(gw, "POST", "/v1/chat/completions", _chat("w70 w71", max_tokens=8))
    words = body["choices"][0]["message"]["content"].split()
    _, cut = _same_json(gw, "POST", "/v1/chat/completions",
                        _chat("w70 w71", max_tokens=8, stop=[words[3]]))
    assert cut["choices"][0]["finish_reason"] == "stop"
    assert words[3] not in cut["choices"][0]["message"]["content"].split()


def test_tokenize_and_detokenize(gw):
    _, tok = _same_json(gw, "POST", "/v1/tokenize", {"model": MODEL, "text": "w1 w2 hello"})
    _same_json(gw, "POST", "/v1/detokenize", {"model": MODEL, "tokens": tok["tokens"]})


def test_invalid_body_is_400(gw):
    for path, body in (("/v1/chat/completions", {"model": MODEL}),
                       ("/v1/completions", {"prompt": 3}),
                       ("/generate", {"sampling_params": "x"})):
        (js, jt), (ps, pt) = gw.call("POST", path, body)
        assert ps == js == 400, (path, jt, pt)
        assert json.loads(pt)["error"]["type"] == json.loads(jt)["error"]["type"]


def test_operational_routes(gw):
    for path in ("/health", "/liveness", "/readiness", "/health_generate", "/v1/models"):
        (js, jt), (ps, pt) = gw.call("GET", path)
        assert ps == js == 200, (path, jt, pt)
        assert set(json.loads(pt)) == set(json.loads(jt)), path
    _same_json(gw, "GET", "/v1/models")
    (js, jt), (ps, pt) = gw.call("GET", "/get_loads")
    assert ps == js == 200
    keys = ("worker_id", "gateway_load", "cached_prompt_tokens", "computed_prompt_tokens",
            "num_running", "num_waiting", "quarantined_requests", "healthy", "audit")
    for want, got in zip(json.loads(jt)["loads"], json.loads(pt)["loads"]):
        assert all(k in got for k in keys) and all(k in want for k in keys)
        assert got["worker_id"] == want["worker_id"]
        assert got["audit"]["clean"] and want["audit"]["clean"]
    (js, jt), (ps, pt) = gw.call("GET", "/scheduler")
    assert ps == js == 200
    assert set(json.loads(pt)["engine"]) == set(json.loads(jt)["engine"]) == {"w0", "w1"}
    for path in ("/get_server_info", "/workers"):
        (js, jt), (ps, pt) = gw.call("GET", path)
        assert ps == js == 200
        assert _strip(json.loads(pt)) == _strip(json.loads(jt)), path
    (js, jt), (ps, pt) = gw.call("GET", "/debug/flight/w0?reason=manual")
    assert ps == js == 200
    jd, pd = json.loads(jt)["dump"], json.loads(pt)["dump"]
    assert pd["schema_version"] == jd["schema_version"]
    assert {"ring", "timelines", "auto_dumps", "engine"} <= set(pd)
    (js, _), (ps, _) = gw.call("GET", "/debug/flight/nope")
    assert ps == js == 404
    (js, jt), (ps, pt) = gw.call("GET", "/metrics")
    assert ps == js == 200

    def families(text):
        return {line.split()[2] for line in text.splitlines() if line.startswith("# TYPE")}

    jf, pf = families(jt), families(pt)
    assert pf <= jf  # the gateway families the port has, by the same names
    assert {f for f in pf if f.startswith("smg_engine_")} == \
        {f for f in jf if f.startswith("smg_engine_")}
    _same_json(gw, "POST", "/flush_cache")


def test_cache_aware_routes_shared_prefix_to_one_worker(gw):
    shared = " ".join(f"w{i}" for i in range(100, 140))
    for tail in ("w300 w301", "w302 w303"):
        _same_json(gw, "POST", "/v1/completions",
                   {"model": MODEL, "prompt": f"{shared} {tail}", "max_tokens": 3,
                    "temperature": 0})
    (_, jt), (_, pt) = gw.call("GET", "/workers")
    before = {w["worker_id"]: w["total_requests"] for w in json.loads(pt)["workers"]}
    assert before == {w["worker_id"]: w["total_requests"] for w in json.loads(jt)["workers"]}
    _, body = _same_json(gw, "POST", "/v1/chat/completions", _chat(shared, max_tokens=2))
    _, again = _same_json(gw, "POST", "/v1/chat/completions",
                          _chat(shared + " w999", max_tokens=2))
    (_, jt), (_, pt) = gw.call("GET", "/workers")
    after = {w["worker_id"]: w["total_requests"] for w in json.loads(pt)["workers"]}
    assert after == {w["worker_id"]: w["total_requests"] for w in json.loads(jt)["workers"]}
    grew = [w for w in after if after[w] > before[w]]
    assert len(grew) == 1 and after[grew[0]] - before[grew[0]] == 2  # same worker
    assert again["usage"]["prompt_tokens_details"]["cached_tokens"] >= 32


def test_serve_cli_builds_the_app_on_cpu():
    from smg_tpu_torch.cli import build_parser
    from smg_tpu_torch.gateway.launch import build_context, build_engine_from_args

    args = build_parser().parse_args([
        "serve", "--model-preset", "tiny", "--device", "cpu", "--dtype", "float32",
        "--port", "0", "--max-batch-size", "4", "--max-seq-len", "128",
        "--decode-horizon", "2", "--engine-drain-timeout-secs", "2"])
    assert args.policy == "cache_aware" and args.device == "cpu"
    engine = build_engine_from_args(args)
    assert engine.runner.device.type == "cpu" and engine.config.model_id == "tiny"
    ctx = build_context(engine, policy=args.policy,
                        drain_timeout_secs=args.engine_drain_timeout_secs)

    async def go():
        tc = TestClient(TestServer(tserver.build_app(ctx)))
        await tc.start_server()
        try:
            health = await tc.get("/health")
            chat = await tc.post("/v1/chat/completions", json=_chat("w5 w6", max_tokens=3))
            return health.status, chat.status, await chat.json()
        finally:
            await tc.close()
            await ctx.registry.list()[0].client.close()

    health, status, body = asyncio.run(go())
    assert health == 200 and status == 200, body
    assert body["usage"]["completion_tokens"] == 3
