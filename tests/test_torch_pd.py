"""PD (prefill/decode) disaggregation on the port, held against the JAX
package on the CPU (the reference's ``tests/test_pd.py``).

- The engine legs: the port's ``prefill_export`` K/V equal the JAX engine's
  export (1e-5, shape ``[L, n, ps, KD]``); the decode engine's tokens equal
  a co-located run's and the JAX PD pair's, and it prefills nothing.
- The gateway: the port's ``build_app`` over a PREFILL and a DECODE worker
  against the reference's over two JAX engines, with the ``auto`` and
  ``host`` connectors: bodies and SSE frames identical once ids and times
  are removed, the connector the router hands the prefill leg, the decode
  decision reconciled as ``over`` (its prefix cache is never consulted), a
  failed prefill leg answered 502.
- The device connector between two CPU engines (and, on the card, between
  two engines there, where the payload stays on the card and a graph
  captured before an import replays over the imported pages).
- The degraded path (no slot, no pages: the decode engine prefills itself),
  an adopted lane with penalties, an export beside an overlapped lane in
  flight, the Qwen-MoE family (``tiny-moe``) and the router's image
  bypass.

The ``transfer`` connector's tests are in ``tests/test_torch_kv_transfer.py``.
Float32, the tiny models with weights bridged from
the JAX ``init_params``."""

import asyncio
import dataclasses
import functools
import json
import logging
import threading

import jax
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from smg_tpu.engine import config as jconf
from smg_tpu.engine.engine import Engine as JaxEngine
from smg_tpu.gateway import router as jrouter
from smg_tpu.gateway import server as jserver
from smg_tpu.gateway import worker_client as jwc
from smg_tpu.gateway import workers as jworkers
from smg_tpu.models import llama as jl
from smg_tpu.models.config import tiny_moe_config, tiny_test_config
from smg_tpu.models.registry import get_model
from smg_tpu.protocols.sampling import SamplingParams as JaxSamplingParams
from smg_tpu.tokenizer import MockTokenizer as JaxMockTokenizer
from smg_tpu_torch import policies as tpolicies
from smg_tpu_torch.engine import config as tconf
from smg_tpu_torch.engine.engine import Engine
from smg_tpu_torch.engine.kv_connector import (
    DeviceKvConnector,
    get_connector,
    resolve_for_payload,
)
from smg_tpu_torch.gateway import router as trouter
from smg_tpu_torch.gateway import server as tserver
from smg_tpu_torch.gateway import worker_client as twc
from smg_tpu_torch.gateway import workers as tworkers
from smg_tpu_torch.models import config as tmodels
from smg_tpu_torch.models.convert import params_from_jax
from smg_tpu_torch.protocols.sampling import SamplingParams
from smg_tpu_torch.tokenizer import MockTokenizer

torch.set_num_threads(2)
MODEL = "tiny-test"
CONFIGS = {"tiny": tiny_test_config(), "tiny_moe": tiny_moe_config()}
SCHED = dict(max_batch_size=4, max_seq_len=128, max_prefill_tokens=64,
             prefill_token_buckets=(16, 32, 64), decode_batch_buckets=(4,))
PROMPT = list(range(5, 45))  # 40 tokens: 3 pages of 16
GREEDY = dict(temperature=0.0, max_new_tokens=8, ignore_eos=True)


@functools.lru_cache(maxsize=None)
def jax_params(name: str = "tiny"):
    cfg = CONFIGS[name]
    if name == "tiny":
        return get_model(cfg.arch).init_params(cfg, jax.random.PRNGKey(0))
    return jax.jit(functools.partial(jl.init_params, cfg))(jax.random.PRNGKey(0))


def port_model(name: str):
    jcfg = CONFIGS[name]
    names = {f.name for f in dataclasses.fields(tmodels.ModelConfig)}
    return tmodels.ModelConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items()
                                  if k in names})


def jax_engine(name: str = "tiny", **sched) -> JaxEngine:
    return JaxEngine(jconf.EngineConfig(
        model=CONFIGS[name],
        cache=jconf.CacheConfig(page_size=16, num_pages=128, auto_size=False, dtype="float32"),
        scheduler=jconf.SchedulerConfig(**{**SCHED, **sched}),
        dtype="float32", model_id=MODEL), params=jax_params(name))


def port_engine(name: str = "tiny", num_pages: int = 128, device="cpu", graphs=True,
                **sched) -> Engine:
    return Engine(tconf.EngineConfig(
        model=port_model(name),
        cache=tconf.CacheConfig(page_size=16, num_pages=num_pages, auto_size=False,
                                dtype="float32"),
        scheduler=tconf.SchedulerConfig(**{**SCHED, **sched}), model_id=MODEL,
        decode_graphs=graphs),
        params=params_from_jax(jax.tree.map(np.asarray, jax_params(name))), device=device)


def run_prefilled(engine, prompt, export, sp, rid=None) -> list:
    """``submit_prefilled`` then step inline until the request finishes:
    its outputs."""
    outs, done = [], threading.Event()

    def cb(o):
        outs.append(o)
        if o.finished:
            done.set()

    engine.submit_prefilled(prompt, export["first_token"], export["k"], export["v"], sp,
                            rid=rid, on_output=cb)
    for _ in range(500):
        if done.is_set():
            break
        engine.step()
    assert done.is_set()
    return outs


def tokens_of(outs) -> list:
    return [t for o in outs for t in o.new_token_ids]


def logprobs_of(outs) -> list:
    return [x for o in outs for x in o.logprobs]


# ---- the engine legs ----


def test_connectors_by_name_and_by_payload():
    """The port's connectors are the reference's, by name and by payload."""
    from smg_tpu.engine import kv_connector as jkv

    for name in ("host", "device", "transfer"):
        assert get_connector(name).name == jkv.get_connector(name).name == name
    with pytest.raises(ValueError) as port_err:
        get_connector("nope")
    with pytest.raises(ValueError) as ref_err:
        jkv.get_connector("nope")
    assert str(port_err.value) == str(ref_err.value)
    desc = {"transfer_address": "smgkv://127.0.0.1:1", "transfer_uuid": 1}
    assert resolve_for_payload(desc).name == jkv.resolve_for_payload(desc).name == "transfer"
    assert resolve_for_payload(torch.zeros(2)).name == "host"
    assert resolve_for_payload(np.zeros(2)).name == "host"


def test_engine_level_kv_handoff():
    """The reference's ``test_engine_level_kv_handoff``: the export equals
    the JAX engine's, and the decode engine's stream equals a co-located
    run's without prefilling anything."""
    ja = jax_engine()
    ref = ja.generate(prompt_ids=PROMPT, sampling=JaxSamplingParams(**GREEDY))
    ja.flush_cache()
    jexp = ja.prefill_export(PROMPT, JaxSamplingParams(**GREEDY))
    a, b = port_engine(), port_engine()
    sp = SamplingParams(**GREEDY)
    exp = a.prefill_export(PROMPT, sp)
    assert exp["connector"] == "host" and exp["seq_len"] == 40
    assert exp["first_token"] == jexp["first_token"] == ref.token_ids[0]
    cfg = CONFIGS["tiny"]
    assert tuple(exp["k"].shape) == (cfg.num_layers, 3, 16, cfg.num_kv_heads * cfg.head_dim)
    for name in ("k", "v"):
        assert tuple(exp[name].shape) == np.shape(jexp[name])
        np.testing.assert_allclose(exp[name].numpy(), np.asarray(jexp[name]),
                                   rtol=1e-5, atol=1e-5)
    # the prefill engine has every page back
    assert a.scheduler.pool.free_count == a.runner.spec.num_pages - 1
    outs = run_prefilled(b, PROMPT, exp, sp)
    assert tokens_of(outs) == ref.token_ids
    # the first token rides the handoff with logprob 0.0, as in the reference
    assert logprobs_of(outs)[0] == 0.0
    np.testing.assert_allclose(logprobs_of(outs)[1:], ref.logprobs[1:], atol=1e-4)
    assert b.scheduler.num_prefill_tokens == 0
    assert b.runner.kv_handoffs["import_host"] == 1
    assert b.audit()["clean"] and a.audit()["clean"]
    ja.stop()


def test_engine_level_device_connector():
    """The reference moves the payload between two JAX CPU devices; here the
    device connector runs between two CPU engines: the payload is a tensor
    on the exporting engine's device, and the stream is exact.  On the CPU
    the payload resolves to the host route (the card test covers the
    device route)."""
    a, b = port_engine(), port_engine()
    sp = SamplingParams(**GREEDY)
    ref = a.generate(PROMPT, sp)
    a.flush_cache()
    exp = a.prefill_export(PROMPT, sp, connector="device")
    assert exp["connector"] == "device"
    assert isinstance(exp["k"], torch.Tensor) and exp["k"].device == a.runner.k_cache.device
    assert a.runner.kv_handoffs["export_device"] == 1
    outs = run_prefilled(b, PROMPT, exp, sp)
    assert tokens_of(outs) == ref.token_ids
    assert b.scheduler.num_prefill_tokens == 0
    # the device import itself lands the same bytes as the host import
    pages = b.scheduler.alloc_import_pages(len(PROMPT))
    DeviceKvConnector().import_(b.runner, pages, exp["k"], exp["v"])
    idx = torch.as_tensor(pages)
    assert torch.equal(b.runner.k_cache[:, idx], exp["k"])
    assert torch.equal(b.runner.v_cache[:, idx], exp["v"])
    # a payload on another device is refused, never moved
    with pytest.raises(ValueError, match="not on this engine's"):
        b.runner.import_pages_device(pages, exp["k"].to("meta"), exp["v"].to("meta"))
    b.scheduler.release_pages(pages)
    assert b.audit()["clean"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the device connector's card route and CUDA "
                    "graphs have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_card_device_connector_and_a_graph_captured_before_the_import(card):
    """Two engines on the card: the device payload stays there (no host
    import), and the decode engine replays a megastep graph it captured
    before the import over the imported pages; its stream equals an eager
    engine's on the same payload and a co-located run's."""
    a = port_engine(device=card)
    g = port_engine(device=card, decode_horizon=4)
    e = port_engine(device=card, graphs=False, overlap_schedule=False, decode_horizon=4)
    sp = SamplingParams(**{**GREEDY, "max_new_tokens": 16})
    ref = a.generate(PROMPT, sp)
    a.flush_cache()
    g.generate(list(range(50, 90)), sp)  # same shapes: captures the megastep graph
    graphs = g.runner.graphs.num_graphs
    calls = g.runner.stats["decode_calls"]
    prefilled = {g: g.scheduler.num_prefill_tokens, e: 0}
    assert graphs >= 1
    exp = a.prefill_export(PROMPT, sp, connector="device")
    assert exp["k"].is_cuda and exp["v"].is_cuda
    got = tokens_of(run_prefilled(g, PROMPT, exp, sp))
    want = tokens_of(run_prefilled(e, PROMPT, exp, sp))
    assert got == want == ref.token_ids
    assert g.runner.graphs.num_graphs == graphs  # replays only: no new capture
    assert g.runner.stats["decode_calls"] > calls
    for eng in (g, e):
        assert eng.runner.kv_handoffs["import_device"] == 1
        assert eng.runner.kv_handoffs["import_host"] == 0
        assert eng.scheduler.num_prefill_tokens == prefilled[eng]  # nothing for PD
        assert eng.audit()["clean"]


@pytest.mark.parametrize("pressure", ["slots", "pages"])
def test_degraded_path_prefills_on_the_decode_engine(pressure):
    """No free slot, or no free pages: the decode leg submits the request
    normally and prefills it itself, as the reference does; the stream is
    still exact once the pressure lifts."""
    a = port_engine()
    sp = SamplingParams(**GREEDY)
    ref = a.generate(PROMPT, sp)
    a.flush_cache()
    exp = a.prefill_export(PROMPT, sp)
    b = port_engine(num_pages=7, watermark_pages=0) if pressure == "pages" else port_engine()
    # the fillers take every slot, or 4 of the 6 usable pages
    lens = [60] if pressure == "pages" else [8] * SCHED["max_batch_size"]
    for i, n in enumerate(lens):
        b.submit(list(range(100 + 8 * i, 100 + 8 * i + n)),
                 SamplingParams(temperature=0.0, max_new_tokens=3, ignore_eos=True))
    while b.scheduler.waiting or any(r.prefill_pos < r.prompt_len
                                     for r in b.scheduler.requests.values()):
        b.step()
    assert len(b.scheduler.requests) == len(lens)
    warnings = []
    catch = logging.Handler(logging.WARNING)
    catch.emit = lambda record: warnings.append(record.getMessage())
    engine_logger = logging.getLogger("smg_tpu_torch.engine")
    engine_logger.addHandler(catch)
    try:
        outs = run_prefilled(b, PROMPT, exp, sp, rid="pd-degraded")
    finally:
        engine_logger.removeHandler(catch)
    assert any("falling back to local prefill" in m for m in warnings), warnings
    assert tokens_of(outs) == ref.token_ids
    assert b.scheduler.num_prefill_tokens == len(PROMPT) + sum(lens)
    for _ in range(100):
        if not b.scheduler.has_work():
            break
        b.step()
    assert b.audit()["clean"]


def test_adopted_lane_with_penalties_matches_the_jax_pd_pair():
    """Penalties apply to the first token on the prefill leg and, through
    the lazily synced penalty row, to every token of the adopted lane."""
    kw = dict(temperature=0.0, max_new_tokens=12, ignore_eos=True, frequency_penalty=0.5,
              presence_penalty=0.3, repetition_penalty=1.2)
    ja, jb = jax_engine(decode_horizon=4), jax_engine(decode_horizon=4)
    jexp = ja.prefill_export(PROMPT, JaxSamplingParams(**kw))
    want = run_prefilled(jb, PROMPT, jexp, JaxSamplingParams(**kw))
    a, b = port_engine(decode_horizon=4), port_engine(decode_horizon=4)
    exp = a.prefill_export(PROMPT, SamplingParams(**kw))
    got = run_prefilled(b, PROMPT, exp, SamplingParams(**kw))
    assert tokens_of(got) == tokens_of(want)
    np.testing.assert_allclose(logprobs_of(got), logprobs_of(want), atol=1e-4)
    colocated = port_engine(decode_horizon=4).generate(PROMPT, SamplingParams(**kw))
    assert tokens_of(got) == colocated.token_ids
    assert b.audit()["clean"]
    ja.stop()
    jb.stop()


def test_prefill_export_beside_a_running_overlapped_lane():
    """A PREFILL worker may also run whole generates (an image bypass), so
    an export can land while an overlap frame is in flight.  The export
    equals a quiet engine's; the greedy lane keeps its solo stream; and the
    frame discarded after the export (an abort made it stale) does not
    rewind the sampling counter below what the export consumed: its
    counters are no longer the newest."""
    sp_lane = SamplingParams(temperature=0.0, max_new_tokens=24, ignore_eos=True)
    sp_hot = SamplingParams(temperature=0.8, max_new_tokens=24, ignore_eos=True)
    lane_prompt, hot_prompt = list(range(60, 80)), list(range(90, 110))
    solo = port_engine(decode_horizon=4).generate(lane_prompt, sp_lane).token_ids
    quiet = port_engine().prefill_export(PROMPT, SamplingParams(**GREEDY))
    e = port_engine(decode_horizon=4)
    assert e.config.scheduler.overlap_schedule
    chunks = {"lane": [], "hot": []}
    e.submit(lane_prompt, sp_lane, rid="lane", on_output=chunks["lane"].append)
    e.submit(hot_prompt, sp_hot, rid="hot", on_output=chunks["hot"].append)
    for _ in range(3):
        e.step()
    assert e.scheduler.inflight is not None
    exp = e.prefill_export(PROMPT, SamplingParams(**GREEDY))
    after_export = e.runner.rng_mark()
    frame = e.scheduler.inflight
    discarded = []
    discard = e.scheduler._discard_frame
    e.scheduler._discard_frame = lambda f: (discarded.append(f), discard(f))
    # an abort makes the frame in flight stale: the next step discards it
    e.abort("hot")
    for _ in range(300):
        if not e.scheduler.has_work():
            break
        e.step()
        assert e.runner.rng_mark() >= after_export
    assert frame in discarded
    assert exp["first_token"] == quiet["first_token"]
    assert torch.equal(exp["k"], quiet["k"]) and torch.equal(exp["v"], quiet["v"])
    assert tokens_of(chunks["lane"]) == solo and chunks["lane"][-1].finished
    assert e.audit()["clean"]


def test_moe_family_through_pd():
    """``tiny-moe``: the export equals the JAX engine's and the adopted
    stream equals the JAX PD pair's."""
    ja, jb = jax_engine("tiny_moe"), jax_engine("tiny_moe")
    jexp = ja.prefill_export(PROMPT, JaxSamplingParams(**GREEDY))
    want = run_prefilled(jb, PROMPT, jexp, JaxSamplingParams(**GREEDY))
    a, b = port_engine("tiny_moe"), port_engine("tiny_moe")
    exp = a.prefill_export(PROMPT, SamplingParams(**GREEDY), connector="device")
    np.testing.assert_allclose(exp["k"].numpy(), np.asarray(jexp["k"]), rtol=1e-5, atol=1e-5)
    got = run_prefilled(b, PROMPT, exp, SamplingParams(**GREEDY))
    assert tokens_of(got) == tokens_of(want)
    np.testing.assert_allclose(logprobs_of(got), logprobs_of(want), atol=1e-4)
    assert b.scheduler.num_prefill_tokens == 0
    ja.stop()
    jb.stop()


# ---- the gateway's PD path, against the reference ----


class PdGateways:
    """The reference's ``build_app`` over a JAX PREFILL and DECODE engine
    and the port's over two port engines, on one private loop, with
    ``cache_aware`` routing from one seed and one connector setting."""

    def __init__(self, connector: str):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        self.engines = {"ref": (jax_engine(), jax_engine()),
                        "port": (port_engine(), port_engine())}
        mods = {"ref": (jserver, jrouter, jwc, jworkers, JaxMockTokenizer),
                "port": (tserver, trouter, twc, tworkers, MockTokenizer)}
        self.clients = {side: self.run(self._start(connector, self.engines[side], *mods[side]))
                        for side in ("ref", "port")}

    def run(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout=120)

    async def _start(self, connector, engines, server, router, wc, workers, tok_cls):
        ctx = server.AppContext(policy="cache_aware", policy_kwargs={"seed": 0},
                                router_config=router.RouterConfig(kv_connector=connector))
        ctx.tokenizers.register(MODEL, tok_cls(), default=True)
        for (wid, wtype), engine in zip(
                (("prefill-0", workers.WorkerType.PREFILL),
                 ("decode-0", workers.WorkerType.DECODE)), engines):
            ctx.registry.add(workers.Worker(worker_id=wid, client=wc.InProcWorkerClient(engine),
                                            model_id=MODEL, worker_type=wtype))
        tc = TestClient(TestServer(server.build_app(ctx)))
        await tc.start_server()
        return tc

    def post(self, path: str, body: dict) -> dict:
        """side -> (status, text), the reference first."""
        async def one(tc):
            resp = await tc.post(path, json=body)
            return resp.status, await resp.text()

        return {side: self.run(one(tc)) for side, tc in self.clients.items()}

    def get(self, path: str) -> dict:
        async def one(tc):
            resp = await tc.get(path)
            return resp.status, await resp.json()

        return {side: self.run(one(tc)) for side, tc in self.clients.items()}

    def close(self):
        for tc in self.clients.values():
            self.run(tc.close())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=10)
        for p, d in self.engines.values():
            p.stop()
            d.stop()


@pytest.fixture(scope="module", params=["auto", "host"])
def pd(request):
    g = PdGateways(request.param)
    # what the router must hand the prefill leg: 'auto' resolves to 'device'
    # with both legs in process
    g.kv_connector = "device" if request.param == "auto" else request.param
    yield g
    g.close()


def _strip(obj):
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items()
                if k not in ("id", "created", "ts", "decision_us", "trace_id", "request_id",
                             "nodes", "evicted_elements", "max_size")}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def _frames(text: str) -> list:
    return [_strip(json.loads(b[6:])) if b[6:] != "[DONE]" else b[6:]
            for b in text.split("\n\n") if b.startswith("data: ")]


def _chat(content: str, max_tokens: int, **kw) -> dict:
    return {"model": MODEL, "messages": [{"role": "user", "content": content}],
            "max_tokens": max_tokens, "temperature": 0, "ignore_eos": True, **kw}


def test_pd_chat_through_gateway(pd):
    out = pd.post("/v1/chat/completions", _chat("w5 w6 w7", 6))
    (rs, rt), (ps, pt) = out["ref"], out["port"]
    assert rs == ps == 200, (rt, pt)
    body = json.loads(pt)
    assert _strip(body) == _strip(json.loads(rt))
    assert body["choices"][0]["message"]["content"].startswith("w")
    assert body["usage"]["completion_tokens"] == 6
    p_engine, d_engine = pd.engines["port"]
    assert p_engine.scheduler.num_prefill_tokens > 0
    assert d_engine.scheduler.num_prefill_tokens == 0
    assert d_engine.scheduler.num_decode_tokens > 0
    # the prefill engine has every page back; nothing leaks on either leg
    assert p_engine.scheduler.pool.free_count == p_engine.runner.spec.num_pages - 1
    assert p_engine.audit()["clean"]


def test_pd_streaming(pd):
    out = pd.post("/v1/chat/completions", _chat("w9 w10", 4, stream=True))
    (rs, rt), (ps, pt) = out["ref"], out["port"]
    assert rs == ps == 200
    frames = _frames(pt)
    assert frames == _frames(rt)
    assert frames[-1] == "[DONE]" and len(frames) >= 4


def test_pd_decode_decision_reconciles_as_over(pd):
    """The same prompt twice: cache-aware routing predicts a prefix hit on
    the decode worker, whose import reports 0 cached tokens — ``over``."""
    for _ in range(2):
        out = pd.post("/v1/chat/completions", _chat("w11 w12 w13 w14 w15 w16 w17 w18 w19 "
                                                    "w20 w21 w22 w23 w24 w25 w26 w27 w28", 2))
        assert out["ref"][0] == out["port"][0] == 200
    dbg = pd.get("/debug/router?limit=16")
    assert dbg["port"][0] == dbg["ref"][0] == 200
    assert _strip(dbg["port"][1]) == _strip(dbg["ref"][1])
    body = dbg["port"][1]
    decisions = [d for d in body["models"][MODEL]["decisions"]
                 if d["reconciled"] and d["chosen"] == "decode-0"]
    assert decisions and decisions[-1]["worker_cached_tokens"] == 0
    assert body["reconciliation"]["decode-0"]["over"] >= 1


def test_gateway_routes_configured_connector(pd):
    calls = []
    p_engine = pd.engines["port"][0]
    orig = p_engine.prefill_export

    def spy(prompt_ids, sampling, connector="host"):
        calls.append(connector)
        return orig(prompt_ids, sampling, connector=connector)

    p_engine.prefill_export = spy
    try:
        out = pd.post("/v1/chat/completions", _chat("w21 w22", 3))
    finally:
        p_engine.prefill_export = orig
    assert out["port"][0] == 200
    assert _strip(json.loads(out["port"][1])) == _strip(json.loads(out["ref"][1]))
    assert calls == [pd.kv_connector]


def test_failed_prefill_leg_answers_502(pd):
    originals = []
    for side in ("ref", "port"):
        p_engine = pd.engines[side][0]
        originals.append((p_engine, p_engine.prefill_export))

        def boom(*a, **kw):
            raise RuntimeError("prefill exploded")

        p_engine.prefill_export = boom
    try:
        out = pd.post("/v1/chat/completions", _chat("w30 w31", 3))
    finally:
        for p_engine, orig in originals:
            p_engine.prefill_export = orig
    (rs, rt), (ps, pt) = out["ref"], out["port"]
    assert rs == ps == 502
    assert json.loads(pt) == json.loads(rt)


# ---- the router's image bypass ----


class _FakeClient:
    """A worker client that records generates and answers one finished
    chunk."""

    supports_device_kv = True

    def __init__(self, wc):
        self.wc, self.calls = wc, []

    async def generate(self, req):
        self.calls.append("generate")
        yield self.wc.WorkerStreamChunk(rid=req.rid, token_ids=[7], finished=True,
                                        finish_reason="length", prompt_tokens=3,
                                        output_tokens=1)

    async def prefill_export(self, *a, **kw):
        self.calls.append("prefill_export")
        raise AssertionError("an image request never takes the PD path")


@pytest.mark.parametrize("side", ["ref", "port"])
def test_image_request_bypasses_pd_onto_the_prefill_worker(side):
    router_mod, wc, workers, pol, sp_cls = {
        "ref": (jrouter, jwc, jworkers, __import__("smg_tpu.policies", fromlist=["x"]),
                JaxSamplingParams),
        "port": (trouter, twc, tworkers, tpolicies, SamplingParams)}[side]
    from smg_tpu_torch.tokenizer.registry import TokenizerRegistry

    registry = workers.WorkerRegistry()
    clients = {}
    for wid, wtype in (("prefill-0", workers.WorkerType.PREFILL),
                       ("decode-0", workers.WorkerType.DECODE)):
        clients[wid] = _FakeClient(wc)
        registry.add(workers.Worker(worker_id=wid, client=clients[wid], model_id=MODEL,
                                    worker_type=wtype))
    router = router_mod.Router(registry, pol.PolicyRegistry(default="round_robin"),
                               TokenizerRegistry())

    async def go():
        ctx = pol.RequestContext(model_id=MODEL)
        mm = (np.zeros((1, 4), np.float32), np.array([0]))
        return [ev async for ev in router._execute(ctx, [1, 2, 3], sp_cls(max_new_tokens=1),
                                                   "img-1", None, mm=mm)]

    events = asyncio.run(go())
    assert events[-1].finished and events[-1].token_ids == [7]
    assert clients["prefill-0"].calls == ["generate"] and clients["decode-0"].calls == []
