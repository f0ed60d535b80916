"""The port's SLO accounting, SLO enforcement and OTel spans against the JAX
gateway's.

- ``SloTracker`` records, ``/debug/slo`` summaries and ``SloEnforcer``
  verdicts over one scripted set of request timelines, driven through both
  packages with an injected clock: exact.
- TTFT, per-token ITL, goodput and deadline families after the same
  scripted frame timings through both routers (the scripted worker moves
  the clock): identical histogram and counter contents.
- The span tree of one chat sent with a ``traceparent`` through both
  gateways, streamed and not: the same names, parentage, status, attribute
  keys and values, the routing decision's ``route.*`` attributes included
  (ids and times removed; the detokenize busy time and the decision latency
  kept as keys).  The test waits for the root span
  itself, not for the first export.
- The trace id reaches the port engine's flight-recorder timeline.
"""

import asyncio
import json
import time

import pytest
import torch
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

from smg_tpu.gateway import observability as jobs
from smg_tpu.gateway import router as jrouter
from smg_tpu.gateway import server as jserver
from smg_tpu.gateway import slo_enforcement as jslo
from smg_tpu.gateway import worker_client as jwc
from smg_tpu.gateway import workers as jworkers
from smg_tpu.gateway.tracing import parse_traceparent as j_parse
from smg_tpu.policies import PolicyRegistry as JaxPolicies
from smg_tpu.tokenizer import MockTokenizer as JaxMockTokenizer
from smg_tpu.tokenizer.registry import TokenizerRegistry as JaxTokenizers
from smg_tpu_torch.gateway import observability as tobs
from smg_tpu_torch.gateway import router as trouter
from smg_tpu_torch.gateway import server as tserver
from smg_tpu_torch.gateway import slo_enforcement as tslo
from smg_tpu_torch.gateway import worker_client as twc
from smg_tpu_torch.gateway import workers as tworkers
from smg_tpu_torch.gateway.tracing import Span, parse_traceparent
from smg_tpu_torch.policies import PolicyRegistry
from smg_tpu_torch.tokenizer import MockTokenizer
from smg_tpu_torch.tokenizer.registry import TokenizerRegistry

torch.set_num_threads(2)
MODEL = "tiny-test"
UPSTREAM = "00-" + "12" * 16 + "-" + "34" * 8 + "-01"


class Clock:
    """A ``time.perf_counter`` that moves only when told to."""

    def __init__(self):
        self.now = 1000.0

    def __call__(self) -> float:
        return self.now


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    monkeypatch.setattr(time, "perf_counter", c)
    return c


# request timelines: (rid, deadline, [(t, event, arg)]) with events
# first (prompt tokens), tokens (n), finish/fail/abandon (reason)
TIMELINES = [
    ("a", None, [(0.10, "first", 12), (0.13, "tokens", 4), (0.16, "tokens", 4),
                 (0.18, "tokens", 3), (0.18, "finish", "length")]),
    ("b", 0.5, [(0.25, "first", 40), (0.31, "tokens", 4), (0.42, "tokens", 2),
                (0.42, "finish", "stop")]),
    ("c", 0.3, [(0.20, "first", 8), (0.26, "tokens", 4), (0.45, "tokens", 4),
                (0.45, "finish", "length")]),  # past its deadline: missed
    ("d", 1.0, [(0.05, "first", 5), (0.09, "tokens", 1), (0.30, "finish", "timeout")]),
    ("e", 1.0, [(0.40, "fail", "error")]),
    ("f", 1.0, [(0.02, "first", 3), (0.03, "abandon", "abort")]),  # voluntary
    ("g", None, [(0.07, "first", 64), (0.08, "tokens", 1), (0.09, "tokens", 1),
                 (0.30, "tokens", 4), (0.31, "finish", "stop")]),
    ("h", None, [(0.12, "first", 9), (0.12, "finish", "stop")]),
]


def _drive(obs, clock, t0: float) -> object:
    """Run every timeline through ``obs.Metrics()``'s tracker, request by
    request, starting at ``t0`` on the clock."""
    m = obs.Metrics()
    for i, (rid, deadline, events) in enumerate(TIMELINES):
        start = t0 + i * 0.5
        clock.now = start
        rec = m.slo.begin(rid, route="/v1/chat/completions", deadline_secs=deadline,
                          trace_id=f"{i:032x}", t_start=start)
        for t, ev, arg in events:
            clock.now = start + t
            if ev == "first":
                rec.first_token(arg, arg // 4)
            elif ev == "tokens":
                rec.tokens(arg)
            else:
                getattr(rec, ev)(arg)
    return m


def _samples(metrics, name: str) -> list:
    # a counter's family drops the _total its samples carry
    fam = {f.name: f for f in metrics.registry.collect()}[name.removesuffix("_total")]
    return sorted((s.name, tuple(sorted(s.labels.items())), s.value) for s in fam.samples
                  if not s.name.endswith("_created"))


SPECS = [
    {"name": "pass", "ttft_p95_s": 1.0, "itl_p95_s": 1.0, "min_requests": 4,
     "hysteresis": 1},
    {"name": "ttft", "ttft_p95_s": 0.05, "min_requests": 4, "hysteresis": 1},
    {"name": "budget", "deadline_miss_budget": 0.1, "min_requests": 2, "hysteresis": 2,
     "fast_window_s": 2.0, "slow_window_s": 10.0},
    {"name": "goodput", "goodput_ratio_floor": 0.95, "e2e_p95_s": 0.2},
]


def test_slo_tracker_summaries_and_verdicts_are_exact(clock):
    jm = _drive(jobs, clock, 1000.0)
    tm = _drive(tobs, clock, 1000.0)
    assert list(tm.slo._done) == list(jm.slo._done)
    for recent in (0, 3, 32):
        assert tm.slo.summary(recent=recent) == jm.slo.summary(recent=recent)
    records = list(tm.slo._done)
    assert tobs.aggregate_slo_records(records) == jobs.aggregate_slo_records(records)
    assert tobs.aggregate_slo_records([]) == jobs.aggregate_slo_records([])
    for w in (0.3, 1.0, 10.0):
        assert tm.slo.window_records(w) == jm.slo.window_records(w)
    tm.slo_enforcer.install(SPECS)
    jm.slo_enforcer.install(SPECS)
    for step in range(4):  # hysteresis: verdicts flip on the second pass
        clock.now += 0.5
        got, want = tm.slo_enforcer.evaluate(), jm.slo_enforcer.evaluate()
        assert got == want, step
    assert {v["slo"]: v["verdict"] for v in got["verdicts"]} == {
        "pass": "pass", "ttft": "fail", "budget": "pass", "goodput": "fail"}
    for fam in ("smg_inter_token_latency_seconds", "smg_request_deadline_outcomes_total",
                "smg_goodput_tokens_total", "smg_slo_violations_total", "smg_slo_burn_rate"):
        assert _samples(tm, fam) == _samples(jm, fam), fam


def test_slo_spec_loading_matches_reference(tmp_path):
    path = tmp_path / "slo.json"
    path.write_text(json.dumps({"slos": SPECS}))
    assert [vars(s) for s in tslo.load_slo_specs(str(path))] == \
        [vars(s) for s in jslo.load_slo_specs(str(path))]
    for bad in ([{"name": "x"}], [{"name": "x", "ttft_p95": 1}],
                [{"name": "x", "ttft_p95_s": 1, "fast_window_s": 9, "slow_window_s": 1}]):
        with pytest.raises(ValueError) as want:
            jslo.load_slo_specs(bad)
        with pytest.raises(ValueError) as got:
            tslo.load_slo_specs(bad)
        assert str(got.value) == str(want.value)


# ---- the router's hooks over scripted frame timings ----


# (seconds after dispatch, tokens in the frame): horizon-4 frames and a
# short last one
FRAMES = [(0.120, 4), (0.135, 4), (0.151, 4), (0.170, 4), (0.199, 3)]


def scripted(wc, clock):
    class Scripted(wc.WorkerClient):
        async def generate(self, req):
            t0 = clock.now
            total = 0
            for i, (t, n) in enumerate(FRAMES):
                clock.now = t0 + t
                total += n
                last = i == len(FRAMES) - 1
                yield wc.WorkerStreamChunk(
                    rid=req.rid, token_ids=list(range(5, 5 + n)), finished=last,
                    finish_reason="length" if last else None,
                    prompt_tokens=len(req.input_ids), cached_tokens=2, output_tokens=total)

        async def abort(self, rid):
            return True

    return Scripted()


@pytest.mark.parametrize("deadline", [None, 0.15, 5.0])
@pytest.mark.parametrize("stream", [False, True])
def test_router_ttft_and_itl_families_are_exact(clock, stream, deadline):
    from smg_tpu.protocols.openai import ChatCompletionRequest as JaxChat
    from smg_tpu_torch.protocols.openai import ChatCompletionRequest

    out = []
    for obs, router, wc, workers, policies, toks, mock, chat in (
            (jobs, jrouter, jwc, jworkers, JaxPolicies, JaxTokenizers, JaxMockTokenizer,
             JaxChat),
            (tobs, trouter, twc, tworkers, PolicyRegistry, TokenizerRegistry, MockTokenizer,
             ChatCompletionRequest)):
        metrics = obs.Metrics()
        reg = workers.WorkerRegistry()
        reg.add(workers.Worker(worker_id="w0", client=scripted(wc, clock), model_id=MODEL))
        tz = toks()
        tz.register(MODEL, mock(), default=True)
        r = router.Router(reg, policies(default="round_robin"), tz,
                          router.RouterConfig(request_timeout_secs=deadline), metrics=metrics)
        req = chat(model=MODEL, messages=[{"role": "user", "content": "w5 w6"}],
                   max_tokens=19, stream=stream)

        async def go():
            with metrics.track_request("/v1/chat/completions"):
                for i in range(3):
                    clock.now += 1.0
                    if stream:
                        async for _ in r.chat_stream(req, request_id=f"r{i}"):
                            pass
                    else:
                        await r.chat(req, request_id=f"r{i}")

        asyncio.run(go())
        out.append(metrics)
    jm, tm = out
    for fam in ("smg_time_to_first_token_seconds", "smg_inter_token_latency_seconds",
                "smg_generated_tokens_total", "smg_prompt_tokens_total",
                "smg_cached_prompt_tokens_total", "smg_goodput_tokens_total",
                "smg_request_deadline_outcomes_total"):
        assert _samples(tm, fam) == _samples(jm, fam), fam
    recs = [{k: v for k, v in r.items() if k != "t_end"} for r in tm.slo._done]
    assert recs == [{k: v for k, v in r.items() if k != "t_end"} for r in jm.slo._done]
    # per-token ITL: each frame's gap over its tokens
    itl = recs[0]["itl_mean_s"]
    assert itl == pytest.approx((0.199 - 0.120) / 15)


# ---- spans ----


def test_traceparent_parsing_and_span_shape_match_reference():
    from smg_tpu.gateway.tracing import Span as JaxSpan

    for h in (UPSTREAM, UPSTREAM.upper(), None, "", "garbage", "ff" + UPSTREAM[2:],
              "00-" + "0" * 32 + "-" + "cd" * 8 + "-01", "00-" + "zz" * 16 + "-" + "cd" * 8
              + "-01", "00-" + "ab" * 16 + "-" + "cd" * 8 + "-1"):
        assert parse_traceparent(h) == j_parse(h), h
    spans = []
    for cls in (JaxSpan, Span):
        s = cls(name="x", trace_id="ab" * 16, span_id="cd" * 8, parent_span_id="ef" * 8,
                start_ns=5, end_ns=9)
        for k, v in (("a", 1), ("b", True), ("c", 0.5), ("d", "s"), ("e", None)):
            s.set(k, v)
        spans.append(s.to_otlp())
    assert spans[1] == spans[0]


class Collector:
    """OTLP/HTTP collector double: spans by the exporting service's name."""

    def __init__(self):
        self.by_service: dict[str, list] = {}
        self.app = web.Application()
        self.app.router.add_post("/v1/traces", self.handle)

    async def handle(self, request):
        body = await request.json()
        for rs in body["resourceSpans"]:
            svc = rs["resource"]["attributes"][0]["value"]["stringValue"]
            for ss in rs["scopeSpans"]:
                self.by_service.setdefault(svc, []).extend(ss["spans"])
        return web.json_response({})


def _worker(wc):
    class W(wc.WorkerClient):
        async def generate(self, req):
            for i in range(3):
                await asyncio.sleep(0.005)
                yield wc.WorkerStreamChunk(
                    rid=req.rid, token_ids=[5 + i], finished=i == 2,
                    finish_reason="length" if i == 2 else None,
                    prompt_tokens=len(req.input_ids), output_tokens=i + 1)

        async def abort(self, rid):
            return True

        async def health(self):
            return True

    return W()


def _tree(spans: list) -> list:
    """(name, parent's name, status, attributes) per span, sorted; times and
    ids dropped, the detokenize busy time and the routing decision's latency
    kept as keys only."""
    by_id = {s["spanId"]: s["name"] for s in spans}
    out = []
    for s in spans:
        attrs = {a["key"]: a["value"] for a in s["attributes"]}
        for key in ("busy_ns", "route.decision_us"):
            if key in attrs:
                attrs[key] = "<time>"
        out.append((s["name"], by_id.get(s.get("parentSpanId"), s.get("parentSpanId")),
                    s["status"], s["kind"], sorted(attrs.items())))
    return sorted(out)


@pytest.mark.parametrize("stream", [False, True])
def test_span_tree_matches_reference(stream):
    col = Collector()

    async def go():
        runner = web.AppRunner(col.app)
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        port = site._server.sockets[0].getsockname()[1]
        clients = []
        for svc, server, wc, workers, mock in (
                ("ref", jserver, jwc, jworkers, JaxMockTokenizer),
                ("port", tserver, twc, tworkers, MockTokenizer)):
            ctx = server.AppContext(policy="round_robin", otel_endpoint=f"http://127.0.0.1:{port}",
                                    otel_service_name=svc)
            ctx.tracer.flush_interval = 3600.0  # exports only when flushed below
            ctx.tokenizers.register(MODEL, mock(), default=True)
            ctx.registry.add(workers.Worker(worker_id="w0", client=_worker(wc), model_id=MODEL))
            tc = TestClient(TestServer(server.build_app(ctx)))
            await tc.start_server()
            resp = await tc.post("/v1/chat/completions", json={
                "model": MODEL, "messages": [{"role": "user", "content": "w5 w6"}],
                "max_tokens": 3, "stream": stream,
            }, headers={"traceparent": UPSTREAM, "X-Request-Id": "req-span-1"})
            assert resp.status == 200
            await resp.read()
            tp = resp.headers.get("traceparent")
            assert tp is not None and tp.split("-")[1] == "12" * 16
            # the root span is recorded as the handler returns: wait for it
            # itself, then export everything
            for _ in range(500):
                if any(s.name.startswith("POST ") for s in ctx.tracer._buffer):
                    break
                await asyncio.sleep(0.01)
            await ctx.tracer.flush()
            clients.append(tc)
        for tc in clients:
            await tc.close()
        await runner.cleanup()

    asyncio.run(go())
    ref, port = col.by_service["ref"], col.by_service["port"]
    assert _tree(port) == _tree(ref)
    names = sorted(s["name"] for s in port)
    assert names == sorted(["POST /v1/chat/completions", "engine.queue", "engine.tokenize",
                            "engine.prefill", "engine.decode", "engine.detokenize"])
    root = next(s for s in port if s["name"].startswith("POST "))
    assert root["parentSpanId"] == "34" * 8
    assert {a["key"] for a in root["attributes"]} >= {"route.policy", "route.outcome",
                                                      "route.worker", "route.decision_us"}
    for s in port:
        assert s["traceId"] == "12" * 16
        if s is not root:
            assert s["parentSpanId"] == root["spanId"]


def test_trace_id_reaches_the_port_engine():
    import jax
    import numpy as np

    from smg_tpu.models.config import tiny_test_config
    from smg_tpu.models.registry import get_model
    from smg_tpu_torch.engine import config as tconf
    from smg_tpu_torch.engine.engine import Engine
    from smg_tpu_torch.gateway.worker_client import InProcWorkerClient
    from smg_tpu_torch.models.config import tiny_test_config as port_tiny
    from smg_tpu_torch.models.convert import params_from_jax

    cfg = tiny_test_config()
    params = get_model(cfg.arch).init_params(cfg, jax.random.PRNGKey(0))
    engine = Engine(tconf.EngineConfig(
        model=port_tiny(),
        cache=tconf.CacheConfig(page_size=16, num_pages=32, auto_size=False, dtype="float32"),
        scheduler=tconf.SchedulerConfig(max_batch_size=2, max_seq_len=128,
                                        max_prefill_tokens=32), model_id=MODEL),
        params=params_from_jax(jax.tree.map(np.asarray, params)), device="cpu")
    col = Collector()

    async def go():
        runner = web.AppRunner(col.app)
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        port = site._server.sockets[0].getsockname()[1]
        ctx = tserver.AppContext(policy="round_robin", otel_endpoint=f"http://127.0.0.1:{port}")
        ctx.tokenizers.register(MODEL, MockTokenizer(), default=True)
        ctx.registry.add(tworkers.Worker(worker_id="w0", client=InProcWorkerClient(engine),
                                         model_id=MODEL))
        tc = TestClient(TestServer(tserver.build_app(ctx)))
        await tc.start_server()
        resp = await tc.post("/v1/chat/completions", json={
            "model": MODEL, "messages": [{"role": "user", "content": "w5 w6"}],
            "max_tokens": 3, "ignore_eos": True,
        }, headers={"traceparent": UPSTREAM, "X-Request-Id": "req-traced"})
        assert resp.status == 200
        await tc.close()
        await runner.cleanup()

    try:
        asyncio.run(go())
        timelines = engine.dump_flight()["timelines"]["finished"]
        tl = next(t for t in timelines if t["rid"] == "req-traced")
        assert tl["trace_id"] == "12" * 16
    finally:
        engine.stop()


def test_slo_ttft_starts_at_first_dispatch_as_the_reference():
    """The TTFT and SLO clock starts at the first dispatch in both gateways.
    A request that waits for the only priority slot: neither SLO TTFT holds
    the wait, which both report in ``smg_scheduler_queue_wait_seconds``."""
    from smg_tpu.gateway.priority import PriorityConfig as JaxPriority
    from smg_tpu_torch.gateway.priority import PriorityConfig

    def slow(wc):
        class W(wc.WorkerClient):
            async def generate(self, req):
                for i in range(4):
                    await asyncio.sleep(0.1)
                    yield wc.WorkerStreamChunk(
                        rid=req.rid, token_ids=[5 + i], finished=i == 3,
                        finish_reason="length" if i == 3 else None,
                        prompt_tokens=len(req.input_ids), output_tokens=i + 1)

            async def abort(self, rid):
                return True

            async def health(self):
                return True

        return W()

    async def go(server, wc, workers, mock, prio):
        ctx = server.AppContext(policy="round_robin", priority_config=prio(slots=1))
        ctx.tokenizers.register(MODEL, mock(), default=True)
        ctx.registry.add(workers.Worker(worker_id="w0", client=slow(wc), model_id=MODEL))
        tc = TestClient(TestServer(server.build_app(ctx)))
        await tc.start_server()

        async def one(rid):
            t0 = time.perf_counter()
            resp = await tc.post("/v1/chat/completions", json={
                "model": MODEL, "messages": [{"role": "user", "content": "w5"}],
                "max_tokens": 4, "stream": True}, headers={"X-Request-Id": rid})
            await resp.content.readline()  # the first frame
            first = time.perf_counter() - t0
            await resp.read()
            return first

        client = await asyncio.gather(one("first"), one("waits"))
        records = {r["rid"]: r for r in ctx.metrics.slo.summary(recent=8)["recent"]}
        waits = {s.labels["priority"]: s.value
                 for m in ctx.metrics.queue_wait.collect() for s in m.samples
                 if s.name.endswith("_sum")}
        await tc.close()
        return client, records, waits

    ref_client, ref, ref_waits = asyncio.run(
        go(jserver, jwc, jworkers, JaxMockTokenizer, JaxPriority))
    port_client, port, port_waits = asyncio.run(
        go(tserver, twc, tworkers, MockTokenizer, PriorityConfig))
    # "waits" queued behind the 0.4 s of "first"
    assert port_client[1] > 0.45 and ref_client[1] > 0.45
    for rid in ("first", "waits"):
        # from dispatch to the first of the worker's 0.1 s chunks
        assert 0.09 < ref[rid]["ttft_s"] < 0.2 and 0.09 < port[rid]["ttft_s"] < 0.2, rid
        assert abs(port[rid]["ttft_s"] - ref[rid]["ttft_s"]) < 0.05, rid
    assert set(port_waits) == set(ref_waits)
    assert sum(port_waits.values()) > 0.35 and sum(ref_waits.values()) > 0.35
