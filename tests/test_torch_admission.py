"""The port's request-policy layer against the JAX gateway's: auth, rate
limits, priority admission with preemption, the request timeout, CORS, the
parse routes, ``/scheduler`` and the ``serve`` flags.

Both apps run on one private event loop.  Status codes and bodies of the
policy layer's answers are compared over scripted workers (no engine), with
the reference's cases from ``tests/test_enterprise.py``.  Preemption runs
through each gateway over its own tiny engine (JAX and port, the same
bridged float32 weights): the preempted ``bulk`` chat is aborted in the
engine, requeued, and its final text equals its lone run and the other
package's; each engine's audit is clean and every page comes back.  A
request timeout cuts a decode on the port engine: one abort counted, audit
clean.
"""

import asyncio
import base64
import functools
import hashlib
import hmac
import json
import threading
import time

import aiohttp
import numpy as np
import pytest
import torch
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

import jax
from smg_tpu import cli as jcli
from smg_tpu.engine import config as jconf
from smg_tpu.engine.engine import Engine as JaxEngine
from smg_tpu.gateway import auth as jauth
from smg_tpu.gateway import priority as jprio
from smg_tpu.gateway import rate_limit as jrl
from smg_tpu.gateway import server as jserver
from smg_tpu.gateway import worker_client as jwc
from smg_tpu.gateway.worker_client import InProcWorkerClient as JaxInProc
from smg_tpu.gateway.workers import Worker as JaxWorker
from smg_tpu.models.config import tiny_test_config
from smg_tpu.models.registry import get_model
from smg_tpu.tokenizer import MockTokenizer as JaxMockTokenizer
from smg_tpu_torch import cli as tcli
from smg_tpu_torch.engine import config as tconf
from smg_tpu_torch.engine.engine import Engine
from smg_tpu_torch.gateway import auth as tauth
from smg_tpu_torch.gateway import priority as tprio
from smg_tpu_torch.gateway import rate_limit as trl
from smg_tpu_torch.gateway import server as tserver
from smg_tpu_torch.gateway import worker_client as twc
from smg_tpu_torch.gateway.launch import gateway_options
from smg_tpu_torch.gateway.worker_client import InProcWorkerClient
from smg_tpu_torch.gateway.workers import Worker
from smg_tpu_torch.models.config import tiny_test_config as port_tiny
from smg_tpu_torch.models.convert import params_from_jax
from smg_tpu_torch.tokenizer import MockTokenizer

torch.set_num_threads(2)
MODEL = "tiny-test"
CHAT = {"model": MODEL, "messages": [{"role": "user", "content": "w5 w6 w7"}],
        "max_tokens": 4, "temperature": 0}
# (server module, worker-client module, worker class, auth, rate limit, priority)
PKGS = ((jserver, jwc, JaxWorker, jauth, jrl, jprio),
        (tserver, twc, Worker, tauth, trl, tprio))


def scripted_worker(wc, n_chunks: int = 3, gap: float = 0.0):
    """A worker of ``wc``'s package streaming ``n_chunks`` one-token chunks
    ``gap`` seconds apart; records aborts."""

    class Scripted(wc.WorkerClient):
        def __init__(self):
            self.aborted = []

        async def generate(self, req):
            for i in range(n_chunks):
                if gap:
                    await asyncio.sleep(gap)
                last = i == n_chunks - 1
                yield wc.WorkerStreamChunk(
                    rid=req.rid, token_ids=[10 + i], finished=last,
                    finish_reason="length" if last else None,
                    prompt_tokens=len(req.input_ids), output_tokens=i + 1)

        async def abort(self, rid):
            self.aborted.append(rid)
            return True

        async def health(self):
            return True

    return Scripted()


class Pair:
    """Both gateways on one private loop thread, each over one worker.
    ``make_ctx(pkg)`` builds each side's ``AppContext`` keyword arguments
    from that package's modules; ``make_worker(pkg)`` its worker client."""

    def __init__(self, make_ctx=lambda pkg: {}, make_worker=None, tokenizer=(
            JaxMockTokenizer, MockTokenizer)):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        self.ctxs, self.clients, self.workers = [], [], []
        for pkg, tok in zip(PKGS, tokenizer):
            server, wc, worker_cls = pkg[:3]
            ctx = server.AppContext(policy="round_robin", **make_ctx(pkg))
            ctx.tokenizers.register(MODEL, tok(), default=True)
            w = (make_worker or (lambda p: scripted_worker(p[1])))(pkg)
            ctx.registry.add(worker_cls(worker_id="w0", client=w, model_id=MODEL))
            self.ctxs.append(ctx)
            self.workers.append(w)
            self.clients.append(self.run(self._start(server, ctx)))

    def run(self, coro, timeout=120):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout=timeout)

    @staticmethod
    async def _start(server, ctx):
        tc = TestClient(TestServer(server.build_app(ctx)))
        await tc.start_server()
        return tc

    @staticmethod
    async def _one(tc, method, path, body, headers):
        resp = await tc.request(method, path, json=body, headers=headers or {})
        text = await resp.text()
        hdr = {k: v for k, v in resp.headers.items() if k.startswith("Access-Control")}
        return resp.status, text, hdr

    def call(self, method, path, body=None, headers=None) -> list:
        """One request to each gateway in turn: [(status, text, CORS headers)]."""
        return [self.run(self._one(tc, method, path, body, headers)) for tc in self.clients]

    def together(self, calls) -> list:
        """``calls`` = [(method, path, body, headers)] sent concurrently to
        each gateway in turn; one list of results per gateway."""
        async def go(tc):
            return await asyncio.gather(*(self._one(tc, *c) for c in calls))

        return [self.run(go(tc)) for tc in self.clients]

    def close(self):
        for tc in self.clients:
            self.run(tc.close())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=10)


def _strip(text: str):
    try:
        obj = json.loads(text)
    except ValueError:
        return text

    def go(o):
        if isinstance(o, dict):
            return {k: go(v) for k, v in o.items() if k not in ("id", "created")}
        if isinstance(o, list):
            return [go(v) for v in o]
        return o

    return go(obj)


def same(results) -> tuple:
    """Both gateways' (status, body without ids, CORS headers); asserts they
    are equal and returns the port's."""
    want, got = ((s, _strip(t), h) for s, t, h in results)
    assert got == want
    return got


# ---- auth ----


def _b64(b: bytes) -> str:
    return base64.urlsafe_b64encode(b).rstrip(b"=").decode()


def _hs256(secret: str, payload: dict, alg: str = "HS256") -> str:
    header = _b64(json.dumps({"alg": alg, "typ": "JWT"}).encode())
    body = _b64(json.dumps(payload).encode())
    sig = _b64(hmac.new(secret.encode(), f"{header}.{body}".encode(), hashlib.sha256).digest())
    return f"{header}.{body}.{sig}"


def test_api_key_and_hs256_auth_match_reference():
    secret = "s3cret"

    def ctx(pkg):
        auth = pkg[3]
        return {"auth_config": auth.AuthConfig(
            enabled=True, jwt_secret=secret,
            api_keys={"sk-test": auth.Principal(id="u1", tenant="t1")})}

    pair = Pair(ctx)
    try:
        good = _hs256(secret, {"sub": "alice", "tenant": "acme", "exp": time.time() + 60})
        cases = [
            None,  # missing credentials: 401
            {"Authorization": "Bearer wrong"},  # invalid: 403
            {"Authorization": "Bearer sk-test"},
            {"X-API-Key": "sk-test"},
            {"Authorization": f"Bearer {good}"},
            {"Authorization": "Bearer " + _hs256(secret, {"sub": "a", "exp": time.time() - 5})},
            {"Authorization": "Bearer " + _hs256("other", {"sub": "a"})},
            {"Authorization": "Bearer " + _hs256(secret, {"sub": "a"}, alg="none")},
            {"Authorization": "Bearer a.b.c"},
        ]
        statuses = [same(pair.call("POST", "/v1/chat/completions", CHAT, h))[0] for h in cases]
        # a bad HS256 token is 401, an unknown credential 403, as in the reference
        assert statuses == [401, 403, 200, 200, 200, 401, 401, 403, 403]
        # probes and /metrics are public; other ops routes are not
        assert same(pair.call("GET", "/health"))[0] == 200
        assert [st for st, _t, _h in pair.call("GET", "/metrics")] == [200, 200]
        assert same(pair.call("GET", "/v1/models"))[0] == 401
        assert same(pair.call("GET", "/v1/models", headers={"X-API-Key": "sk-test"}))[0] == 200
        audits = [[(a["outcome"], a["path"], a["principal"]) for a in c.auth.audit]
                  for c in pair.ctxs]
        assert audits[1] == audits[0]
    finally:
        pair.close()


def _rsa_keypair():
    from cryptography.hazmat.primitives.asymmetric import rsa

    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    pub = key.public_key().public_numbers()
    return key, pub.n, pub.e


def _jwk(kid: str, n: int, e: int) -> dict:
    return {"kty": "RSA", "kid": kid, "alg": "RS256", "use": "sig",
            "n": _b64(n.to_bytes((n.bit_length() + 7) // 8, "big")),
            "e": _b64(e.to_bytes((e.bit_length() + 7) // 8, "big"))}


def _rs256(key, kid: str, payload: dict) -> str:
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import padding

    header = _b64(json.dumps({"alg": "RS256", "kid": kid}).encode())
    body = _b64(json.dumps(payload).encode())
    sig = key.sign(f"{header}.{body}".encode(), padding.PKCS1v15(), hashes.SHA256())
    return f"{header}.{body}.{_b64(sig)}"


class JwksServer:
    """A JWKS document served by a local aiohttp app on its own loop thread
    (the verifier's fetcher blocks, so the gateway's loop cannot host it)."""

    def __init__(self):
        self.keys, self.fetches = [], 0
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        app = web.Application()
        app.router.add_get("/.well-known/jwks.json", self.handle)
        self.runner = web.AppRunner(app)
        self.port = asyncio.run_coroutine_threadsafe(self._start(), self.loop).result(30)

    async def _start(self):
        await self.runner.setup()
        site = web.TCPSite(self.runner, "127.0.0.1", 0)
        await site.start()
        return site._server.sockets[0].getsockname()[1]

    async def handle(self, request):
        self.fetches += 1
        return web.json_response({"keys": list(self.keys)})

    def fetcher(self):
        import urllib.request

        url = f"http://127.0.0.1:{self.port}/.well-known/jwks.json"
        with urllib.request.urlopen(url, timeout=10) as r:
            return json.loads(r.read())

    def close(self):
        asyncio.run_coroutine_threadsafe(self.runner.cleanup(), self.loop).result(30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=10)


def test_jwks_rs256_with_rotation_matches_reference():
    idp = JwksServer()
    k1, n1, e1 = _rsa_keypair()
    k2, n2, e2 = _rsa_keypair()
    idp.keys = [_jwk("k1", n1, e1)]
    claims = {"sub": "alice", "iss": "https://idp.example", "aud": "smg",
              "exp": time.time() + 600, "tenant": "acme", "roles": ["admin"]}

    def ctx(pkg):
        auth = pkg[3]
        # no rotation cooldown, so a new kid forces a refresh at once
        jwks = auth.JwksVerifier(idp.fetcher, issuer="https://idp.example",
                                 audience="smg", min_refresh_interval=0.0)
        return {"auth_config": auth.AuthConfig(enabled=True, jwks=jwks)}

    pair = Pair(ctx)
    try:
        def status(token):
            return same(pair.call("POST", "/v1/chat/completions", CHAT,
                                  {"Authorization": f"Bearer {token}"}))[0]

        assert status(_rs256(k1, "k1", claims)) == 200
        assert status(_rs256(k1, "k1", {**claims, "iss": "https://evil"})) == 403
        assert status(_rs256(k1, "k1", {**claims, "aud": "other"})) == 403
        assert status(_rs256(k2, "k1", claims)) == 401  # signed by the wrong key
        assert status(_rs256(k2, "k2", claims)) == 401  # k2 not published yet
        # the IdP rotates: k2 published, k1 retired
        idp.keys = [_jwk("k2", n2, e2)]
        assert status(_rs256(k2, "k2", claims)) == 200
        assert status(_rs256(k1, "k1", claims)) == 401
        assert idp.fetches >= 4
    finally:
        pair.close()
        idp.close()


# ---- rate limits, admission, timeouts, CORS ----


def test_rate_limit_429s_match_reference():
    def ctx(pkg):
        return {"rate_limit_config": pkg[4].RateLimitConfig(capacity=2, refill_per_sec=1e-9),
                "trust_tenant_header": True}

    pair = Pair(ctx)
    try:
        got = [same(pair.call("POST", "/v1/chat/completions", CHAT, {"X-Tenant-Id": "a"}))
               for _ in range(3)]
        assert [g[0] for g in got] == [200, 200, 429]
        assert got[2][1] == {"error": {"message": "rate limit exceeded for tenant 'a'",
                                       "type": "rate_limit_error", "param": None,
                                       "code": None}}
        # another tenant has its own bucket
        assert same(pair.call("POST", "/v1/chat/completions", CHAT,
                              {"X-Tenant-Id": "b"}))[0] == 200
        for c in pair.ctxs:
            assert not any(c.rate_limiter._inflight.values())
    finally:
        pair.close()


def test_concurrency_cap_and_three_concurrent_chats():
    """Burst 2 with a near-zero refill and three concurrent chats: exactly
    one 429, the same on both gateways, and nothing left in flight."""
    def ctx(pkg):
        return {"rate_limit_config": pkg[4].RateLimitConfig(capacity=2, refill_per_sec=1e-9)}

    pair = Pair(ctx, make_worker=lambda p: scripted_worker(p[1], n_chunks=4, gap=0.02))
    try:
        jres, tres = pair.together([("POST", "/v1/chat/completions", CHAT, None)] * 3)
        assert sorted(s for s, _t, _h in tres) == sorted(s for s, _t, _h in jres) == [200, 200, 429]
        for c in pair.ctxs:
            assert not any(c.rate_limiter._inflight.values())
        # the in-flight cap alone (no refill mode): a second concurrent
        # request of one tenant is refused while the first runs
    finally:
        pair.close()
    pair = Pair(lambda pkg: {"rate_limit_config": pkg[4].RateLimitConfig(
        capacity=100, refill_per_sec=0.0, max_concurrent=1)},
        make_worker=lambda p: scripted_worker(p[1], n_chunks=4, gap=0.02))
    try:
        jres, tres = pair.together([("POST", "/v1/chat/completions", CHAT, None)] * 2)
        assert sorted(s for s, _t, _h in tres) == sorted(s for s, _t, _h in jres) == [200, 429]
        for c in pair.ctxs:
            assert not any(c.rate_limiter._inflight.values())
    finally:
        pair.close()


def test_priority_queue_full_and_wait_timeout_match_reference():
    def ctx(pkg):
        return {"priority_config": pkg[5].PriorityConfig(
            slots=1, max_queue={"bulk": 0, "default": 4, "interactive": 4, "system": 4},
            max_wait_secs={"bulk": 1.0, "default": 0.05, "interactive": 5.0, "system": 5.0})}

    pair = Pair(ctx, make_worker=lambda p: scripted_worker(p[1], n_chunks=10, gap=0.03))
    try:
        calls = [("POST", "/v1/chat/completions", CHAT, None),
                 ("POST", "/v1/chat/completions", CHAT, {"X-SMG-Priority": "bulk"}),
                 ("POST", "/v1/chat/completions", CHAT, {"X-SMG-Priority": "default"})]
        jres, tres = pair.together(calls)
        for j, t in zip(jres, tres):
            same([j, t])
        assert [s for s, _t, _h in tres] == [200, 503, 503]
        assert "bulk queue full" in tres[1][1] and "admission timed out" in tres[2][1]
        st, sched, _h = same(pair.call("GET", "/scheduler"))
        assert st == 200 and sched["free_slots"] == 1 and sched["stats"]["bulk"]["rejected"] == 1
        assert sched["stats"]["default"] == {"admitted": 1, "rejected": 1, "preempted": 0}
    finally:
        pair.close()


def test_request_timeout_and_cors_match_reference():
    def ctx(pkg):
        return {"request_timeout_secs": 0.15, "cors_allowed_origins": ["https://app.example"]}

    pair = Pair(ctx, make_worker=lambda p: scripted_worker(p[1], n_chunks=20, gap=0.03))
    try:
        st, body, _h = same(pair.call("POST", "/v1/chat/completions", CHAT))
        assert st == 408 and body["error"]["type"] == "timeout_error"
        for w in pair.workers:
            assert len(w.aborted) == 1  # the cancel reached the worker
        # streamed: the headers went out, so there is no 408.  The port ends
        # the connection at once; the reference leaves it open and silent
        # (a deliberate divergence)
        async def stream(tc, wait: float):
            resp = await tc.post("/v1/chat/completions", json={**CHAT, "stream": True})
            assert resp.status == 200
            await asyncio.wait_for(resp.content.read(), wait)

        with pytest.raises(asyncio.TimeoutError):
            pair.run(stream(pair.clients[0], 1.0))
        t0 = time.monotonic()
        with pytest.raises(aiohttp.ClientPayloadError):
            pair.run(stream(pair.clients[1], 10.0))
        assert time.monotonic() - t0 < 2.0
        for w in pair.workers:
            assert len(w.aborted) == 2
        pre = same(pair.call("OPTIONS", "/v1/chat/completions",
                             headers={"Origin": "https://app.example"}))
        assert pre[0] == 204 and pre[2]["Access-Control-Allow-Origin"] == "https://app.example"
        other = same(pair.call("GET", "/health", headers={"Origin": "https://evil.example"}))
        assert other[0] == 200 and not other[2]
        ok = same(pair.call("GET", "/health", headers={"Origin": "https://app.example"}))
        assert ok[2] == {"Access-Control-Allow-Origin": "https://app.example"}
    finally:
        pair.close()


def test_parse_routes_match_reference():
    pair = Pair()
    try:
        for body in (
            {"text": 'a <tool_call>\n{"name": "f", "arguments": {"x": 1}}\n</tool_call> b',
             "tool_call_parser": "qwen"},
            {"text": '{"name": "g", "arguments": {}}', "model": "llama3-8b"},
            {"text": "plain"},
        ):
            st, got, _h = same(pair.call("POST", "/parse/function_call", body))
            assert st == 200
        assert got == {"normal_text": "plain", "calls": []}
        for body in ({"text": "<think>r</think>c", "reasoning_parser": "qwen3"},
                     {"text": "r</think>c", "model": "deepseek-r1"},
                     {"text": "<think>r</think>c", "model": "unknown"}):
            assert same(pair.call("POST", "/parse/reasoning", body))[0] == 200
    finally:
        pair.close()


# ---- the serve flags ----


SERVE_FLAGS = ["--max-concurrent-requests", "--otel-endpoint", "--otel-service-name",
               "--harmony", "--reasoning-parser", "--tool-call-parser", "--slo-spec",
               "--priority-scheduler-enabled", "--priority-slots",
               "--rate-limit-tokens-per-second", "--rate-limit-burst", "--api-key",
               "--jwt-secret", "--jwt-jwks-uri", "--jwt-issuer", "--jwt-audience",
               "--trust-tenant-header", "--tenant-header-name", "--request-timeout-secs",
               "--cors-allowed-origins"]


def _actions(parser, command: str) -> dict:
    sub = next(a for a in parser._actions if a.dest == "command")
    return {s: a for a in sub.choices[command]._actions for s in a.option_strings}


def test_serve_flags_keep_the_reference_names_and_defaults():
    ref = _actions(jcli.build_parser(), "serve")
    port = _actions(tcli.build_parser(), "serve")
    for flag in SERVE_FLAGS:
        r, p = ref[flag], port[flag]
        assert (p.dest, p.default, p.choices, p.type, p.nargs) == \
            (r.dest, r.default, r.choices, r.type, r.nargs), flag
    assert port["--device"].default == "cuda"


def test_serve_flags_reach_the_context(tmp_path):
    spec = tmp_path / "slo.json"
    spec.write_text(json.dumps([{"name": "chat", "ttft_p95_s": 0.5}]))
    args = tcli.build_parser().parse_args([
        "serve", "--model-preset", "tiny", "--device", "cpu", "--api-key", "k1:acme:admin",
        "--priority-scheduler-enabled", "--priority-slots", "3",
        "--rate-limit-tokens-per-second", "2", "--rate-limit-burst", "5",
        "--request-timeout-secs", "7", "--cors-allowed-origins", "https://a",
        "--harmony", "on", "--reasoning-parser", "qwen3", "--tool-call-parser", "qwen",
        "--slo-spec", str(spec), "--otel-endpoint", "http://127.0.0.1:9"])
    ctx = tserver.AppContext(**gateway_options(args))
    assert ctx.auth.config.enabled and not ctx.trust_tenant_header
    p = ctx.auth.config.api_keys["k1"]
    assert (p.tenant, p.roles) == ("acme", ("admin",))
    assert ctx.priority.config.slots == 3
    assert (ctx.rate_limiter.default.capacity, ctx.rate_limiter.default.refill_per_sec) == (5, 2)
    assert ctx.request_timeout_secs == 7 and ctx.router.config.request_timeout_secs == 7
    assert ctx.cors_allowed_origins == ["https://a"]
    rc = ctx.router.config
    assert (rc.harmony, rc.reasoning_parser, rc.tool_parser) == (True, "qwen3", "qwen")
    assert [s.name for s in ctx.metrics.slo_enforcer.specs] == ["chat"]
    assert ctx.tracer is not None and ctx.tracer.endpoint == "http://127.0.0.1:9"
    # no auth flag: the tenant header is all there is, so it is trusted
    bare = tcli.build_parser().parse_args(["serve", "--model-preset", "tiny"])
    assert tserver.AppContext(**gateway_options(bare)).trust_tenant_header


# ---- preemption and timeouts on real engines ----


SCHED = dict(max_batch_size=4, max_seq_len=512, max_prefill_tokens=64,
             decode_batch_buckets=(4,), decode_horizon=4)


@functools.lru_cache(maxsize=1)
def jax_params():
    cfg = tiny_test_config()
    return get_model(cfg.arch).init_params(cfg, jax.random.PRNGKey(0))


def _jax_engine():
    return JaxEngine(jconf.EngineConfig(
        model=tiny_test_config(),
        cache=jconf.CacheConfig(page_size=16, num_pages=128, auto_size=False, dtype="float32"),
        scheduler=jconf.SchedulerConfig(prefill_token_buckets=(16, 32, 64), **SCHED),
        dtype="float32", model_id=MODEL), params=jax_params())


def _port_engine():
    return Engine(tconf.EngineConfig(
        model=port_tiny(),
        cache=tconf.CacheConfig(page_size=16, num_pages=128, auto_size=False, dtype="float32"),
        scheduler=tconf.SchedulerConfig(**SCHED), model_id=MODEL),
        params=params_from_jax(jax.tree.map(np.asarray, jax_params())), device="cpu")


def _aborts(engine) -> float:
    return engine.metrics.requests_finished.labels(reason="abort")._value.get()


def _quiesce(engine) -> None:
    """Wait (bounded) until the engine's audit is clean: the client can
    hold its whole response before the engine thread has dropped the
    finished request's output callback, or retired an in-flight frame.  A
    real leak stays, and the caller's audit check then fails."""
    deadline = time.monotonic() + 30
    while not engine.audit()["clean"] and time.monotonic() < deadline:
        time.sleep(0.01)


def test_preemption_requeues_bulk_on_both_engines():
    """A bulk chat holding the only slot is preempted by a system chat: the
    bulk run is aborted in the engine, requeued and rerun to the same text
    as its lone run, on the JAX and the port engine alike."""
    engines = [_jax_engine(), _port_engine()]

    def ctx(pkg):
        return {"priority_config": pkg[5].PriorityConfig(slots=1, preempt_after_secs=0.03)}

    clients = iter([JaxInProc(engines[0]), InProcWorkerClient(engines[1])])
    pair = Pair(ctx, make_worker=lambda p: next(clients))
    bulk = {**CHAT, "max_tokens": 160, "ignore_eos": True,
            "messages": [{"role": "user", "content": " ".join(f"w{i}" for i in range(5, 40))}]}
    system = {**CHAT, "max_tokens": 8, "ignore_eos": True}
    try:
        free0 = [e.scheduler.pool.free_count for e in engines]
        lone = same(pair.call("POST", "/v1/chat/completions", bulk))
        for e in engines:
            assert e.flush_cache()

        async def go(tc, engine):
            bulk_task = asyncio.ensure_future(tc.post(
                "/v1/chat/completions", json=bulk, headers={"X-SMG-Priority": "bulk",
                                                            "X-Request-Id": "bulk-1"}))
            # the system chat arrives while the bulk one is decoding
            for _ in range(2000):
                r = engine.scheduler.requests.get("bulk-1")
                if r is not None and len(r.output_ids) >= 4:
                    break
                await asyncio.sleep(0.002)
            else:
                raise AssertionError("the bulk chat never started decoding")
            aborts0 = _aborts(engine)
            r_sys = await tc.post("/v1/chat/completions", json=system,
                                  headers={"X-SMG-Priority": "system"})
            sys_body = await r_sys.text()
            sys_done_while_bulk_pending = not bulk_task.done()
            r_bulk = await bulk_task
            return (r_sys.status, sys_body, r_bulk.status, await r_bulk.text(),
                    sys_done_while_bulk_pending, _aborts(engine) - aborts0)

        out = [pair.run(go(tc, e), timeout=300) for tc, e in zip(pair.clients, engines)]
        for (s_st, _sb, b_st, b_body, first, aborted), ctx_ in zip(out, pair.ctxs):
            assert s_st == 200 and b_st == 200
            assert first, "the system chat must finish before the preempted bulk chat"
            assert aborted == 1, "the preempted run is aborted in the engine"
            assert ctx_.priority.stats["bulk"]["preempted"] == 1
            # the rerun may hit the radix cache the first run filled, so
            # only cached_tokens may differ from the lone run
            got, want = _strip(b_body), lone[1]
            assert got["choices"] == want["choices"]
            assert {k: v for k, v in got["usage"].items() if k != "prompt_tokens_details"} \
                == {k: v for k, v in want["usage"].items() if k != "prompt_tokens_details"}
        assert _strip(out[1][3]) == _strip(out[0][3]) and _strip(out[1][1]) == _strip(out[0][1])
        for e, f0 in zip(engines, free0):
            _quiesce(e)
            assert e.audit()["clean"]
            assert e.flush_cache()
            assert e.scheduler.pool.free_count == f0
    finally:
        pair.close()
        for e in engines:
            e.stop()


def test_request_timeout_aborts_the_decode_on_the_port_engine():
    engine = _port_engine()
    client = InProcWorkerClient(engine)
    ctx = tserver.AppContext(policy="round_robin", request_timeout_secs=0.3)
    ctx.tokenizers.register(MODEL, MockTokenizer(), default=True)
    ctx.registry.add(Worker(worker_id="w0", client=client, model_id=MODEL))
    loop = asyncio.new_event_loop()

    async def start():
        tc = TestClient(TestServer(tserver.build_app(ctx)))
        await tc.start_server()
        return tc

    try:
        tc = loop.run_until_complete(start())
        free0 = engine.scheduler.pool.free_count
        aborts0 = _aborts(engine)
        decoded0 = engine.scheduler.num_decode_tokens
        long = {**CHAT, "max_tokens": 440, "ignore_eos": True}

        async def cut():
            resp = await tc.post("/v1/chat/completions", json=long)
            return resp.status, await resp.json()

        st, body = loop.run_until_complete(cut())
        assert st == 408 and body["error"]["type"] == "timeout_error"
        _quiesce(engine)
        assert _aborts(engine) - aborts0 == 1
        # cut mid-decode: tokens were decoded, fewer than asked for
        assert 0 < engine.scheduler.num_decode_tokens - decoded0 < long["max_tokens"]
        assert engine.audit()["clean"]
        assert engine.flush_cache() and engine.scheduler.pool.free_count == free0
        loop.run_until_complete(tc.close())
    finally:
        loop.close()
        engine.stop()


def test_a_waiting_submit_does_not_stall_the_event_loop():
    """The in-process client submits on its own thread: while an engine step
    holds the engine lock, the gateway still answers other requests at once.
    (The reference submits on the event loop, which waits out the step.)"""
    engine = _port_engine()
    ctx = tserver.AppContext(policy="round_robin")
    ctx.tokenizers.register(MODEL, MockTokenizer(), default=True)
    ctx.registry.add(Worker(worker_id="w0", client=InProcWorkerClient(engine), model_id=MODEL))
    loop = asyncio.new_event_loop()
    held, release = threading.Event(), threading.Event()

    def long_step():  # stands in for a long prefill step
        with engine._lock:
            held.set()
            release.wait(3)

    async def go():
        tc = TestClient(TestServer(tserver.build_app(ctx)))
        await tc.start_server()
        try:
            holder = threading.Thread(target=long_step)
            holder.start()
            held.wait(10)
            # measured from before the chat: a submit made on the event
            # loop would stall the sleep and /health until the lock frees
            t0 = time.monotonic()
            chat = asyncio.ensure_future(tc.post("/v1/chat/completions", json=CHAT))
            await asyncio.sleep(0.05)  # the chat is waiting for the lock
            health = await tc.get("/health")
            waited = time.monotonic() - t0
            assert not chat.done()
            release.set()
            resp = await chat
            holder.join(10)
            return health.status, waited, resp.status
        finally:
            release.set()
            await tc.close()

    try:
        st, waited, chat_status = loop.run_until_complete(go())
        assert st == 200 and waited < 0.5, waited
        assert chat_status == 200
        _quiesce(engine)
        audit = engine.audit()
        assert audit["clean"], json.dumps(audit)
    finally:
        loop.close()
        engine.stop()


