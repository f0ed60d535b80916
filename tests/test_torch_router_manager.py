"""Per-model routers (``gateway/router_manager.py``, the reference's "IGW"
mode) on the port's gateway against the reference's, on the CPU.

Both apps run on one private loop over the same three workers each:
``model-a`` with one, ``model-b`` with two (``round_robin``, a default
``max_tokens`` of 4).  The workers are scripted, one per package, and answer
every request with ``w5 w6 ...`` cut at its token budget, so a body shows
which budget the serving router applied.  The five cases of
``tests/test_router_manager.py`` run through both apps, and then the admin
routes' edges: every status and body is identical, and the per-worker
request counts are the same on both sides.  Validation is atomic: a 400
leaves ``/routers`` as it was."""

import asyncio
import json
import threading

import pytest
from aiohttp.test_utils import TestClient, TestServer

from smg_tpu.gateway import server as jserver
from smg_tpu.gateway import worker_client as jwc
from smg_tpu.gateway.router import RouterConfig as JaxRouterConfig
from smg_tpu.gateway.workers import Worker as JaxWorker
from smg_tpu.tokenizer import MockTokenizer as JaxMockTokenizer
from smg_tpu_torch.gateway import server as tserver
from smg_tpu_torch.gateway import worker_client as twc
from smg_tpu_torch.gateway.router import RouterConfig
from smg_tpu_torch.gateway.workers import Worker
from smg_tpu_torch.tokenizer import MockTokenizer
from test_torch_messages import scripted_worker

SIDES = (
    dict(server=jserver, wc=jwc, Worker=JaxWorker, Tok=JaxMockTokenizer, Config=JaxRouterConfig),
    dict(server=tserver, wc=twc, Worker=Worker, Tok=MockTokenizer, Config=RouterConfig),
)
SCRIPT = " ".join(f"w{i}" for i in range(5, 25))
WORKERS = (("a0", "model-a"), ("b0", "model-b"), ("b1", "model-b"))


class Igw:
    """The two apps; ``call`` sends one request to each and asserts the
    (status, body) pairs equal, ``id`` and ``created`` removed."""

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        self.ctxs, self.clients, self.workers = [], [], []
        for side in SIDES:
            ctx = side["server"].AppContext(policy="round_robin",
                                            router_config=side["Config"](default_max_tokens=4))
            ctx.tokenizers.register("model-a", side["Tok"](), default=True)
            ctx.tokenizers.register("model-b", side["Tok"]())
            workers = {wid: side["Worker"](worker_id=wid, model_id=model, client=scripted_worker(
                side["wc"], SCRIPT, side["Tok"]())) for wid, model in WORKERS}
            for w in workers.values():
                ctx.registry.add(w)
            self.ctxs.append(ctx)
            self.workers.append(workers)
            self.clients.append(self.run(self._start(side["server"], ctx)))

    def run(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout=60)

    @staticmethod
    async def _start(server, ctx):
        tc = TestClient(TestServer(server.build_app(ctx)))
        await tc.start_server()
        return tc

    async def _one(self, tc, method, path, body):
        resp = await tc.request(method, path, json=body)
        return resp.status, await resp.json()

    def call(self, method: str, path: str, body=None) -> tuple:
        got = [self.run(self._one(tc, method, path, body)) for tc in self.clients]
        strip = [(st, {k: v for k, v in b.items() if k not in ("id", "created")})
                 for st, b in got]
        assert strip[1] == strip[0], (method, path, body)
        return got[1]

    def counts(self) -> list:
        return [{wid: w.total_requests for wid, w in ws.items()} for ws in self.workers]

    def close(self):
        for tc in self.clients:
            self.run(tc.close())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=10)


@pytest.fixture(scope="module")
def igw():
    h = Igw()
    yield h
    h.close()


def _chat(h, model, **kw):
    return h.call("POST", "/v1/chat/completions", {
        "model": model, "messages": [{"role": "user", "content": "w5 w6"}],
        "temperature": 0, "ignore_eos": True, **kw})


def test_model_keyed_dispatch(igw):
    """Requests land only on the named model's workers."""
    for ws in igw.workers:
        for w in ws.values():
            w.total_requests = 0
    for model in ("model-a", "model-b", "model-b"):
        status, _ = _chat(igw, model, max_tokens=3)
        assert status == 200
    counts = igw.counts()
    assert counts[1] == counts[0]
    assert counts[1] == {"a0": 1, "b0": 1, "b1": 1}  # round_robin over model-b's two


def test_models_aggregation(igw):
    _status, body = igw.call("GET", "/v1/models")
    assert {m["id"] for m in body["data"]} >= {"model-a", "model-b"}


def test_per_model_router_config(igw):
    """POST /models/{id}/router gives model-b a dedicated router whose
    default_max_tokens differs from the shared default; model-a unaffected."""
    status, desc = igw.call("POST", "/models/model-b/router", {
        "policy": "random", "config": {"default_max_tokens": 2}})
    assert status == 200
    assert (desc["dedicated_router"], desc["policy"]) == (True, "random")
    assert desc["config"]["default_max_tokens"] == 2
    assert set(desc["workers"]) == {"b0", "b1"}
    # no max_tokens in the request: the per-model default applies
    status, body = _chat(igw, "model-b")
    assert (status, body["usage"]["completion_tokens"]) == (200, 2)
    status, body = _chat(igw, "model-a")
    assert (status, body["usage"]["completion_tokens"]) == (200, 4)  # shared default
    _st, listing = igw.call("GET", "/routers")
    by_model = {m["model_id"]: m for m in listing["models"]}
    assert by_model["model-b"]["dedicated_router"] is True
    assert by_model["model-a"]["dedicated_router"] is False
    assert igw.call("GET", "/models/model-b/router") == (200, by_model["model-b"])
    # reset restores the default router
    assert igw.call("DELETE", "/models/model-b/router") == (200, {"model_id": "model-b",
                                                                  "reset": True})
    status, body = _chat(igw, "model-b")
    assert (status, body["usage"]["completion_tokens"]) == (200, 4)
    assert igw.call("DELETE", "/models/model-b/router")[1]["reset"] is False


def test_unknown_config_field_400(igw):
    before = igw.call("GET", "/routers")
    status, body = igw.call("POST", "/models/model-a/router", {"config": {"no_such_knob": 1}})
    assert status == 400 and "no_such_knob" in str(body)
    assert igw.call("GET", "/routers") == before  # a 400 changed nothing


@pytest.mark.parametrize("body", [
    {"policy": "no_such_policy"}, {"policy": "round_robin", "policy_args": {"bogus": 1}},
    {"policy": "random", "config": {"default_max_tokens": 2, "no_such_knob": 1}}],
    ids=["unknown_policy", "bad_policy_args", "policy_with_a_bad_config"])
def test_a_rejected_configuration_changes_nothing(igw, body):
    before = igw.call("GET", "/routers")
    status, _ = igw.call("POST", "/models/model-a/router", body)
    assert status == 400
    assert igw.call("GET", "/routers") == before


def test_unknown_model_still_routes_default(igw):
    """A model id with no workers falls back to the default router, whose
    candidate filter falls back to every worker: the request serves."""
    status, _ = _chat(igw, "ghost-model", max_tokens=2)
    assert status == 200
    _st, desc = igw.call("GET", "/models/ghost-model/router")
    assert (desc["dedicated_router"], desc["workers"]) == (False, [])


def test_a_streamed_chat_follows_the_dedicated_router(igw):
    status, _ = igw.call("POST", "/models/model-b/router", {"config": {"default_max_tokens": 3}})
    assert status == 200
    try:
        texts = [igw.run(_stream(tc)) for tc in igw.clients]
        assert texts[1] == texts[0] == "w5 w6 w7"
    finally:
        igw.call("DELETE", "/models/model-b/router")


async def _stream(tc) -> str:
    resp = await tc.post("/v1/chat/completions", json={
        "model": "model-b", "stream": True, "ignore_eos": True,
        "messages": [{"role": "user", "content": "w5"}]})
    text = ""
    for line in (await resp.text()).splitlines():
        if line.startswith("data: {"):
            for c in json.loads(line[6:])["choices"]:
                text += c["delta"].get("content") or ""
    return text
