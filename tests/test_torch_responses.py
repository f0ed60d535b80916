"""The Responses API and conversations on the port's gateway against the
reference's, on the CPU.

Both apps run on one private event loop: ``smg_tpu.gateway.server.build_app``
and ``smg_tpu_torch.gateway.server.build_app``, each over SQLite conversation
storage (``storage="sqlite:<file>"``), a tiny engine (the JAX ``Engine``; the
port's ``Engine`` with the same weights through ``params_from_jax``, float32
on the CPU) and, per test, scripted workers of each package that emit tool
calls as text (as the reference's ``test_agentic`` and ``test_mcp_depth``
do).  Every request goes to both in the same order; statuses, bodies and SSE
frames must be identical once ids are replaced by their order of first
appearance and timestamps are removed.  Covered: conversation CRUD and
items; create, get, delete, ``previous_response_id`` chains and
``conversation`` mode over the engine (greedy text identical); the MCP tool
loop; approval pause, resume, deny, an unknown or foreign key, stateless
resume; request-level ``require_approval`` (both forms), ``mcp_list_tools``
once per chain, tenant views; ``max_tool_calls``; the label-collision 400;
streaming, the ``error`` event included.  Then the port alone: request-scoped
MCP servers closed with the app (the reference's stay open), and a slow
storage write that leaves other streams flowing."""

import asyncio
import json
import re
import threading
import time

import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from smg_tpu import mcp as jmcp
from smg_tpu.gateway import server as jserver
from smg_tpu.gateway import worker_client as jwc
from smg_tpu.gateway.worker_client import InProcWorkerClient as JaxInProc
from smg_tpu.gateway.workers import Worker as JaxWorker
from smg_tpu.tokenizer import MockTokenizer as JaxMockTokenizer
from smg_tpu_torch import mcp as tmcp
from smg_tpu_torch.gateway import server as tserver
from smg_tpu_torch.gateway import worker_client as twc
from smg_tpu_torch.gateway.worker_client import InProcWorkerClient
from smg_tpu_torch.gateway.workers import Worker
from smg_tpu_torch.storage import MemoryStorage, SqliteStorage
from smg_tpu_torch.tokenizer import MockTokenizer
from test_torch_gateway import MODEL, _jax_engine, _port_engine
from test_torch_mcp import McpHttp, _serve

torch.set_num_threads(2)
SIDES = (
    dict(name="jax", server=jserver, wc=jwc, Worker=JaxWorker, InProc=JaxInProc, mcp=jmcp,
         Tok=JaxMockTokenizer, engine=_jax_engine),
    dict(name="port", server=tserver, wc=twc, Worker=Worker, InProc=InProcWorkerClient,
         mcp=tmcp, Tok=MockTokenizer, engine=_port_engine),
)
SCRIPTED = "scripted"
IDS = re.compile(r"(resp|conv|item|msg|fc|mcpr|mcps|call|chatcmpl|req)[_-][0-9a-f]{16,}")
TIMES = ("created_at", "created")
ADD_CALL = '{"name": "add", "arguments": {"a": 2, "b": 5}}'


def text_tokenizer(tok_cls):
    """Arbitrary text round-tripping through incremental detokenization:
    each 4-character chunk gets its own id (the reference tests' trick)."""

    class TextTokenizer(tok_cls):
        def __init__(self):
            super().__init__()
            self.pieces, self._next = {}, 10

        def decode(self, ids, skip_special_tokens=True):
            return "".join(self.pieces.get(int(t), "") for t in ids)

        def encode(self, text, add_special_tokens=False):
            ids = []
            for i in range(0, len(text), 4):
                self.pieces[self._next] = text[i:i + 4]
                ids.append(self._next)
                self._next += 1
            return ids

    return TextTokenizer()


def scripted_worker(wc, scripts, tok, gap: float = 0.0):
    """A worker of ``wc``'s package answering turn ``i`` with
    ``scripts[min(i, last)]`` (one chunk, or one chunk a piece ``gap``
    seconds apart); it records each prompt's text."""

    class Scripted(wc.WorkerClient):
        def __init__(self):
            self.turn, self.prompts = 0, []

        async def generate(self, req):
            text = scripts[min(self.turn, len(scripts) - 1)]
            self.turn += 1
            self.prompts.append(tok.decode(req.input_ids))
            ids = tok.encode(text)
            if not gap:
                yield wc.WorkerStreamChunk(rid=req.rid, token_ids=ids, finished=True,
                                           finish_reason="stop",
                                           prompt_tokens=len(req.input_ids),
                                           output_tokens=len(ids))
                return
            for i, t in enumerate(ids):
                await asyncio.sleep(gap)
                yield wc.WorkerStreamChunk(rid=req.rid, token_ids=[t],
                                           finished=i == len(ids) - 1,
                                           finish_reason="stop" if i == len(ids) - 1 else None,
                                           prompt_tokens=len(req.input_ids), output_tokens=i + 1)

        async def abort(self, rid):
            return True

        async def health(self):
            return True

    return Scripted()


def _canon(obj, seen: dict):
    """Ids replaced by their order of first appearance; timestamps removed."""
    if isinstance(obj, str):
        return IDS.sub(lambda m: seen.setdefault(m.group(0), f"<{m.group(1)}{len(seen)}>"), obj)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_canon(v, seen) for v in obj)
    if isinstance(obj, dict):
        return {k: _canon(v, seen) for k, v in obj.items() if k not in TIMES}
    return obj


def _parse(text: str):
    if text.startswith("event: "):
        frames = []
        for block in text.strip().split("\n\n"):
            lines = dict(line.split(": ", 1) for line in block.split("\n"))
            frames.append((lines["event"], json.loads(lines["data"])))
        return frames
    try:
        return json.loads(text)
    except ValueError:
        return text


class Pair:
    """The two apps on one private loop thread.  ``call`` sends a request to
    each in turn: ``{name}`` in its path and bodies stands for the value
    saved under ``name`` on that side (``save`` = {name: getter of the
    parsed body})."""

    def __init__(self, tmp):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        self.engines, self.ctxs, self.clients, self.seen = [], [], [], []
        self.names = [{}, {}]
        self.scripted = [None, None]
        for side in SIDES:
            ctx = side["server"].AppContext(policy="round_robin",
                                            storage=f"sqlite:{tmp / side['name']}.db")
            ctx.tokenizers.register(MODEL, side["Tok"](), default=True)
            engine = side["engine"]()
            self.engines.append(engine)
            ctx.registry.add(side["Worker"](worker_id="engine", client=side["InProc"](engine),
                                            model_id=MODEL, page_size=16))
            self.ctxs.append(ctx)
            self.clients.append(self.run(self._start(side["server"], ctx)))
            self.seen.append({})

    def run(self, coro, timeout=120):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout=timeout)

    @staticmethod
    async def _start(server, ctx):
        tc = TestClient(TestServer(server.build_app(ctx)))
        await tc.start_server()
        return tc

    def reset(self, mcp_servers=None, approvals=None, inventory=None, scripts=None):
        """Fresh MCP state on both sides: ``mcp_servers(mcp)`` and
        ``inventory(mcp)`` build each side's servers from its package,
        ``approvals(mcp)`` its ``ApprovalManager``; ``scripts`` a new
        scripted worker (model ``scripted``)."""
        for i, (side, ctx) in enumerate(zip(SIDES, self.ctxs)):
            mcp = side["mcp"]
            ctx.mcp = ctx.responses.mcp = mcp.McpRegistry()
            for s in (mcp_servers(mcp) if mcp_servers else ()):
                ctx.mcp.add(s)
            ctx.responses.approvals = approvals(mcp) if approvals else mcp.ApprovalManager()
            ctx.responses.inventory = inventory(mcp) if inventory else None
            ctx.responses.sessions = mcp.SessionManager()
            if ctx.registry.get(SCRIPTED) is not None:
                ctx.registry.remove(SCRIPTED)
            if scripts is not None:
                tok = text_tokenizer(side["Tok"])
                self.scripted[i] = scripted_worker(side["wc"], scripts, tok)
                ctx.tokenizers.register(SCRIPTED, tok)
                ctx.registry.add(side["Worker"](worker_id=SCRIPTED, client=self.scripted[i],
                                                model_id=SCRIPTED))

    @staticmethod
    def _fill(obj, names: dict):
        if isinstance(obj, str):
            m = re.fullmatch(r"\{(\w+)\}", obj)
            return names[m.group(1)] if m else obj
        if isinstance(obj, list):
            return [Pair._fill(v, names) for v in obj]
        if isinstance(obj, dict):
            return {k: Pair._fill(v, names) for k, v in obj.items()}
        return obj

    async def _one(self, tc, method, path, body, headers):
        resp = await tc.request(method, path, json=body, headers=headers or {})
        return resp.status, resp.headers.get("Content-Type", "").split(";")[0], await resp.text()

    def call(self, method: str, path: str, body=None, headers=None, save=None, status=200):
        """Both sides' (status, content type, canonical body), asserted equal;
        returns the port's parsed body (ids as the port made them)."""
        got, raw = [], []
        for i, tc in enumerate(self.clients):
            names = self.names[i]
            st, ctype, text = self.run(self._one(
                tc, method, path.format(**names), self._fill(body, names), headers))
            parsed = _parse(text)
            for name, getter in (save or {}).items():
                names[name] = getter(parsed)
            got.append((st, ctype, _canon(parsed, self.seen[i])))
            raw.append(parsed)
        assert got[1] == got[0], (method, path)
        assert got[1][0] == status, got[1]
        return raw[1]

    def close(self):
        for tc in self.clients:
            self.run(tc.close())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=10)
        for e in self.engines:
            e.stop()


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    p = Pair(tmp_path_factory.mktemp("responses"))
    yield p
    p.close()


def _item(kind: str, i: int = 0):
    """Getter of the ``id`` of the ``i``-th output item of type ``kind``."""
    return lambda body: [o for o in body["output"] if o["type"] == kind][i]["id"]


def _types(body) -> list:
    return [o["type"] for o in body["output"]]


def _calc(mcp, calls=None):
    srv = mcp.LocalToolServer("calc")

    def add(a, b):
        if calls is not None:
            calls.append((a, b))
        return {"sum": a + b}

    srv.register("add", add, "adds", {"type": "object"})
    return srv


# ---- conversations ----

def test_conversation_crud(pair):
    pair.reset()
    items = [{"type": "message", "role": "user", "content": "w1 w2"},
             {"type": "message", "role": "assistant",
              "content": [{"type": "output_text", "text": "w3"}]}]
    conv = pair.call("POST", "/v1/conversations", {"metadata": {"t": "demo"}, "items": items},
                     save={"c": lambda b: b["id"]})
    assert conv["object"] == "conversation" and conv["metadata"] == {"t": "demo"}
    pair.call("GET", "/v1/conversations/{c}")
    listed = pair.call("GET", "/v1/conversations/{c}/items")
    assert [i["content"] for i in listed["data"]] == items
    added = pair.call("POST", "/v1/conversations/{c}/items",
                      {"items": [{"type": "function_call_output", "call_id": "x",
                                  "output": "7"}, {"role": "user", "content": "w4"}]})
    assert len(added["data"]) == 2
    assert len(pair.call("GET", "/v1/conversations/{c}/items")["data"]) == 4
    upd = pair.call("POST", "/v1/conversations/{c}", {"metadata": {"u": 1}})
    assert upd["metadata"] == {"t": "demo", "u": 1}
    pair.call("POST", "/v1/conversations")  # no body
    pair.call("DELETE", "/v1/conversations/{c}")
    for method, path, body in (("DELETE", "/v1/conversations/{c}", None),
                               ("GET", "/v1/conversations/{c}", None),
                               ("GET", "/v1/conversations/{c}/items", None),
                               ("POST", "/v1/conversations/{c}/items", {"items": []}),
                               ("POST", "/v1/conversations/{c}", {"metadata": {}})):
        pair.call(method, path, body, status=404)


# ---- responses over the engine ----

def test_responses_create_get_delete_and_chain(pair):
    pair.reset()
    r1 = pair.call("POST", "/v1/responses", {"model": MODEL, "input": "w5 w6 w7",
                                             "max_output_tokens": 6, "temperature": 0},
                   save={"r1": lambda b: b["id"]})
    assert r1["status"] == "completed" and _types(r1) == ["message"]
    assert r1["usage"]["output_tokens"] == 6
    got = pair.call("GET", "/v1/responses/{r1}")
    assert got["output"] == r1["output"] and got["usage"] == r1["usage"]
    r2 = pair.call("POST", "/v1/responses", {
        "model": MODEL, "previous_response_id": "{r1}", "instructions": "w100 w101",
        "input": [{"type": "message", "role": "user",
                   "content": [{"type": "input_text", "text": "w8 w9"}]}],
        "max_output_tokens": 5, "temperature": 0, "metadata": {"k": "v"}},
        save={"r2": lambda b: b["id"]})
    assert r2["previous_response_id"] == r1["id"] and r2["metadata"] == {"k": "v"}
    pair.call("POST", "/v1/responses", {
        "model": MODEL, "previous_response_id": "{r2}", "input": "w10",
        "max_output_tokens": 3, "temperature": 0, "store": False},
        save={"r3": lambda b: b["id"]})
    pair.call("GET", "/v1/responses/{r3}", status=404)
    pair.call("DELETE", "/v1/responses/{r1}")
    pair.call("DELETE", "/v1/responses/{r1}", status=404)
    pair.call("GET", "/v1/responses/{r1}", status=404)
    # r2's chain lost its root: history is r2 alone
    pair.call("POST", "/v1/responses", {"model": MODEL, "previous_response_id": "{r2}",
                                        "input": "w11", "max_output_tokens": 3,
                                        "temperature": 0})
    pair.call("POST", "/v1/responses", {"model": MODEL, "previous_response_id": "{r1}",
                                        "input": "w12"}, status=404)
    pair.call("POST", "/v1/responses", {"model": MODEL, "input": 5}, status=400)


def test_responses_text_equals_the_chat_with_the_same_messages(pair):
    """Turn 2 of a chain is the chat of turn 1's messages, its answer and
    the new input (the radix cache flushed before each call)."""
    pair.reset()
    pair.call("POST", "/flush_cache")
    r1 = pair.call("POST", "/v1/responses", {"model": MODEL, "input": "w20 w21 w22",
                                             "max_output_tokens": 4, "temperature": 0},
                   save={"r1": lambda b: b["id"]})
    pair.call("POST", "/flush_cache")
    r2 = pair.call("POST", "/v1/responses", {"model": MODEL, "input": "w23",
                                             "previous_response_id": "{r1}",
                                             "max_output_tokens": 4, "temperature": 0})
    first = r1["output"][0]["content"][0]["text"]
    pair.call("POST", "/flush_cache")
    chat = pair.call("POST", "/v1/chat/completions", {
        "model": MODEL, "max_tokens": 4, "temperature": 0,
        "messages": [{"role": "user", "content": "w20 w21 w22"},
                     {"role": "assistant", "content": first},
                     {"role": "user", "content": "w23"}]})
    assert r2["output"][0]["content"][0]["text"] == chat["choices"][0]["message"]["content"]
    assert r2["usage"]["input_tokens"] == chat["usage"]["prompt_tokens"]


def test_conversation_mode_stores_inputs_and_outputs_in_order(pair):
    pair.reset()
    pair.call("POST", "/v1/conversations", {"items": [
        {"type": "message", "role": "user", "content": "w30 w31"}]},
        save={"c": lambda b: b["id"]})
    outs = []
    for turn, inp in enumerate(("w32 w33", [{"type": "message", "role": "user",
                                             "content": "w34"}])):
        r = pair.call("POST", "/v1/responses", {"model": MODEL, "conversation": "{c}",
                                                "input": inp, "max_output_tokens": 4,
                                                "temperature": 0})
        assert r["conversation"]["id"] == pair.names[1]["c"]
        outs.append((inp, r["output"]))
    items = pair.call("GET", "/v1/conversations/{c}/items")["data"]
    want = [{"type": "message", "role": "user", "content": "w30 w31"},
            {"role": "user", "content": "w32 w33"}, outs[0][1][0],
            outs[1][0][0], outs[1][1][0]]
    assert [i["content"] for i in items] == want


# ---- the MCP tool loop ----

def test_mcp_tool_loop_runs_the_tool_between_turns(pair):
    calls = [[], []]
    servers = iter(calls)
    pair.reset(mcp_servers=lambda mcp: [_calc(mcp, next(servers))],
               scripts=[ADD_CALL, "the sum is seven"])
    body = pair.call("POST", "/v1/responses", {"model": SCRIPTED, "input": "add two and five",
                                               "temperature": 0, "max_output_tokens": 16})
    assert _types(body) == ["mcp_list_tools", "function_call", "function_call_output",
                            "message"]
    assert '"sum": 7' in body["output"][2]["output"]
    assert calls == [[(2, 5)], [(2, 5)]]
    # the second model turn saw the tool's result in its prompt
    assert '{"sum": 7}' in pair.scripted[1].prompts[1]


def test_client_function_tool_stops_the_loop_and_resumes(pair):
    pair.reset(scripts=['{"name": "get_time", "arguments": {"tz": "utc"}}', "it is noon"])
    tools = [{"type": "function", "name": "get_time", "description": "clock",
              "parameters": {"type": "object"}}]
    r1 = pair.call("POST", "/v1/responses", {"model": SCRIPTED, "input": "time?", "tools": tools,
                                             "temperature": 0},
                   save={"r1": lambda b: b["id"],
                         "call": lambda b: b["output"][0]["call_id"]})
    assert _types(r1) == ["function_call"] and r1["status"] == "completed"
    r2 = pair.call("POST", "/v1/responses", {
        "model": SCRIPTED, "previous_response_id": "{r1}", "tools": tools, "temperature": 0,
        "input": [{"type": "function_call_output", "call_id": "{call}", "output": "12:00"}]})
    assert _types(r2) == ["message"]
    assert "12:00" in pair.scripted[1].prompts[1]


def test_approval_pause_resume_deny_and_stateless_resume(pair):
    calls = [[], []]
    servers = iter(calls)

    def gate(mcp):
        return mcp.ApprovalManager(mcp.ApprovalPolicy().add_rule(
            mcp.PolicyRule(server="calc", decision=mcp.Decision.REQUIRE_APPROVAL)))

    pair.reset(mcp_servers=lambda mcp: [_calc(mcp, next(servers))], approvals=gate,
               scripts=[ADD_CALL, "the sum is seven", ADD_CALL, "understood", ADD_CALL, "done"])
    r1 = pair.call("POST", "/v1/responses", {"model": SCRIPTED, "input": "add", "temperature": 0},
                   save={"r1": lambda b: b["id"], "a1": _item("mcp_approval_request")})
    assert _types(r1) == ["mcp_list_tools", "mcp_approval_request"] and calls == [[], []]
    assert json.loads(r1["output"][1]["arguments"]) == {"a": 2, "b": 5}
    approve = lambda key, yes: [{"type": "mcp_approval_response",  # noqa: E731
                                 "approval_request_id": key, "approve": yes}]
    r2 = pair.call("POST", "/v1/responses", {"model": SCRIPTED, "previous_response_id": "{r1}",
                                             "temperature": 0, "input": approve("{a1}", True)})
    assert _types(r2) == ["mcp_call", "message"]
    assert '"sum": 7' in r2["output"][0]["output"] and r2["output"][0]["error"] is None
    assert calls == [[(2, 5)], [(2, 5)]]
    # a second chain, denied
    pair.call("POST", "/v1/responses", {"model": SCRIPTED, "input": "add", "temperature": 0},
              save={"r3": lambda b: b["id"], "a3": _item("mcp_approval_request")})
    r4 = pair.call("POST", "/v1/responses", {"model": SCRIPTED, "previous_response_id": "{r3}",
                                             "temperature": 0, "input": approve("{a3}", False)})
    assert r4["output"][0]["error"] == "approval denied by user"
    assert calls == [[(2, 5)], [(2, 5)]]
    # unknown keys, and a key from another chain, are not found
    pair.call("POST", "/v1/responses", {"model": SCRIPTED, "previous_response_id": "{r3}",
                                        "input": approve("mcpr_nope", True)}, status=404)
    pair.call("POST", "/v1/responses", {"model": SCRIPTED, "previous_response_id": "{r1}",
                                        "input": approve("{a3}", True)}, status=404)
    # stateless: another manager (as another gateway instance) resumes from storage
    pair.call("POST", "/v1/responses", {"model": SCRIPTED, "input": "add", "temperature": 0},
              save={"r5": lambda b: b["id"], "a5": _item("mcp_approval_request")})
    for ctx, side in zip(pair.ctxs, SIDES):
        ctx.responses.approvals = side["mcp"].ApprovalManager()
    r6 = pair.call("POST", "/v1/responses", {"model": SCRIPTED, "previous_response_id": "{r5}",
                                             "temperature": 0, "input": approve("{a5}", True)})
    assert _types(r6) == ["mcp_call", "message"] and calls == [[(2, 5)] * 2] * 2
    kinds = [e.decision for e in pair.ctxs[1].responses.approvals.audit.tail()]
    assert kinds == ["approved"]


@pytest.mark.parametrize("mode,parks", [
    ("always", True), ("never", False), ({"never": {"tool_names": ["echo"]}}, False),
    ({"always": {"tool_names": ["echo"]}}, True), ({}, True)],
    ids=["always", "never", "dict-never", "dict-always", "dict-empty"])
def test_request_level_require_approval(pair, mode, parks):
    def inventory(mcp):
        inv = mcp.McpInventory()
        srv = mcp.LocalToolServer("req-srv")
        srv.register("echo", lambda v: str(v))
        inv.add_server(srv)
        return inv

    pair.reset(inventory=inventory, scripts=['{"name": "echo", "arguments": {"v": 1}}', "ok"])
    body = pair.call("POST", "/v1/responses", {
        "model": SCRIPTED, "input": "echo", "temperature": 0,
        "tools": [{"type": "mcp", "server_label": "req-srv", "server_url": "local://req-srv",
                   "require_approval": mode}]})
    assert ("mcp_approval_request" in _types(body)) is parks
    assert ("function_call_output" in _types(body)) is not parks


def test_mcp_list_tools_once_per_chain_and_tenant_views(pair):
    def inventory(mcp):
        inv = mcp.McpInventory()
        shared, private = mcp.LocalToolServer("calc"), mcp.LocalToolServer("a-tools")
        shared.register("add", lambda a, b: "2")
        private.register("secret", lambda: "classified")
        inv.add_server(shared)
        inv.add_server(private, tenants=["tenant-a"])
        return inv

    pair.reset(inventory=inventory, scripts=["hello"])
    r1 = pair.call("POST", "/v1/responses", {"model": SCRIPTED, "input": "hi", "temperature": 0},
                   headers={"X-Tenant-Id": "tenant-a"}, save={"r1": lambda b: b["id"]})
    listed = [(o["server_label"], [t["name"] for t in o["tools"]]) for o in r1["output"]
              if o["type"] == "mcp_list_tools"]
    assert listed == [("a-tools", ["secret"]), ("calc", ["add"])]
    r2 = pair.call("POST", "/v1/responses", {"model": SCRIPTED, "input": "more",
                                             "previous_response_id": "{r1}", "temperature": 0},
                   headers={"X-Tenant-Id": "tenant-a"})
    assert "mcp_list_tools" not in _types(r2)
    rb = pair.call("POST", "/v1/responses", {"model": SCRIPTED, "input": "x", "temperature": 0},
                   headers={"X-Tenant-Id": "tenant-b"})
    assert [o["server_label"] for o in rb["output"] if o["type"] == "mcp_list_tools"] == ["calc"]


def test_max_tool_calls_reached_is_incomplete(pair):
    calls = [[], []]
    servers = iter(calls)
    pair.reset(mcp_servers=lambda mcp: [_calc(mcp, next(servers))], scripts=[ADD_CALL])
    body = pair.call("POST", "/v1/responses", {"model": SCRIPTED, "input": "loop",
                                               "temperature": 0, "max_tool_calls": 2})
    assert body["status"] == "incomplete"
    assert _types(body).count("function_call_output") == 2 and calls == [[(2, 5)] * 2] * 2


def test_request_mcp_label_colliding_with_a_configured_server_is_400(pair):
    pair.reset(mcp_servers=lambda mcp: [_calc(mcp)], scripts=["x"])
    body = pair.call("POST", "/v1/responses", {
        "model": SCRIPTED, "input": "x",
        "tools": [{"type": "mcp", "server_label": "calc",
                   "server_url": "http://127.0.0.1:9/mcp"}]}, status=400)
    assert "collides with a gateway-configured server" in body["error"]["message"]
    assert pair.scripted[1].turn == 0


# ---- streaming ----

def test_streaming_events(pair):
    pair.reset(mcp_servers=lambda mcp: [_calc(mcp)], scripts=[ADD_CALL, "the sum is seven"])
    body = {"model": MODEL, "input": "w40 w41", "max_output_tokens": 5, "temperature": 0}
    pair.call("POST", "/flush_cache")
    whole = pair.call("POST", "/v1/responses", body)
    pair.call("POST", "/flush_cache")
    frames = pair.call("POST", "/v1/responses", {**body, "stream": True})
    assert [n for n, _ in frames] == [
        "response.created", "response.output_item.added", "response.output_item.done",
        "response.output_item.added", "response.output_text.delta",
        "response.output_item.done", "response.completed"]
    assert [p["sequence_number"] for _, p in frames] == list(range(1, len(frames) + 1))
    text = "".join(p["delta"] for n, p in frames if n == "response.output_text.delta")
    assert text == whole["output"][-1]["content"][0]["text"]
    done = frames[-1][1]["response"]
    assert [o["type"] for o in done["output"]] == ["mcp_list_tools", "message"]
    # the tool loop, streamed: every item added and done, in order
    loop = pair.call("POST", "/v1/responses", {"model": SCRIPTED, "input": "add",
                                               "temperature": 0, "stream": True})
    assert [n for n, _ in loop] == (
        ["response.created"]
        + ["response.output_item.added", "response.output_item.done"] * 3
        + ["response.output_item.added", "response.output_text.delta",
           "response.output_item.done", "response.completed"])
    # a RouteError becomes the error event
    err = pair.call("POST", "/v1/responses", {"model": MODEL, "input": "x", "stream": True,
                                              "previous_response_id": "resp_" + "0" * 24})
    assert err == [("error", {"type": "error", "error": {
        "message": f"response {'resp_' + '0' * 24} not found",
        "type": "invalid_request_error"}})]


# ---- the port alone ----

@pytest.mark.parametrize("side", SIDES, ids=[s["name"] for s in SIDES])
def test_request_scoped_mcp_servers_close_with_the_app(side):
    """A request-level ``mcp`` tool by URL makes an ``HttpMcpServer`` the
    session owns until its TTL.  The port's app closes sessions (and the
    configured servers) when it shuts down; the reference's leaves the
    aiohttp session open ("Unclosed client session" at exit)."""
    tok = text_tokenizer(side["Tok"])
    ctx = side["server"].AppContext(policy="round_robin")
    ctx.tokenizers.register(SCRIPTED, tok, default=True)
    ctx.registry.add(side["Worker"](worker_id="w", client=scripted_worker(side["wc"], ["ok"], tok),
                                    model_id=SCRIPTED))
    mcp_server = McpHttp(sse=False)

    async def go(tc):
        runner, port = await _serve(mcp_server.handle)
        try:
            resp = await tc.post("/v1/responses", json={
                "model": SCRIPTED, "input": "x",
                "tools": [{"type": "mcp", "server_label": "docs",
                           "server_url": f"http://127.0.0.1:{port}/mcp"}]})
            body = await resp.json()
            [session] = ctx.responses.sessions._sessions.values()
            return body, session.owned
        finally:
            await runner.cleanup()

    async def run():
        tc = TestClient(TestServer(side["server"].build_app(ctx)))
        await tc.start_server()
        try:
            body, owned = await go(tc)
            open_before = [s._session.closed for s in owned]
        finally:
            await tc.close()
        closed_after = [s._session.closed for s in owned]
        for s in owned:  # the reference's: closed here, not by its app
            await s.close()
        return body, open_before, closed_after

    body, before, after = asyncio.run(run())
    assert [o["type"] for o in body["output"]] == ["mcp_list_tools", "message"]
    assert before == [False]
    assert after == ([True] if side["name"] == "port" else [False])


def _gaps_during_a_slow_write(storage) -> tuple[float, float]:
    """A 20-piece chat streams (a piece every 20 ms) while a Responses turn
    stores its result through ``storage``; returns (the largest gap between
    SSE frames, the Responses call's seconds)."""
    tok = text_tokenizer(MockTokenizer)
    ctx = tserver.AppContext(policy="round_robin")
    ctx.storage = ctx.responses.storage = storage
    ctx.tokenizers.register(SCRIPTED, tok, default=True)
    ctx.registry.add(Worker(worker_id="w", client=scripted_worker(twc, ["answer"], tok),
                            model_id=SCRIPTED))
    ctx.tokenizers.register("stream", tok)
    ctx.registry.add(Worker(worker_id="s", client=scripted_worker(
        twc, ["0123" * 20], tok, gap=0.02), model_id="stream"))

    async def go():
        tc = TestClient(TestServer(tserver.build_app(ctx)))
        await tc.start_server()
        try:
            async def stream():
                resp = await tc.post("/v1/chat/completions", json={
                    "model": "stream", "stream": True,
                    "messages": [{"role": "user", "content": "go"}]})
                stamps = []
                async for _line in resp.content:
                    stamps.append(time.monotonic())
                return max(b - a for a, b in zip(stamps, stamps[1:]))

            async def respond():
                await asyncio.sleep(0.1)
                t0 = time.monotonic()
                resp = await tc.post("/v1/responses", json={"model": SCRIPTED, "input": "x"})
                assert resp.status == 200
                return time.monotonic() - t0

            return await asyncio.gather(stream(), respond())
        finally:
            await tc.close()

    return asyncio.run(go())


SLOW_S = 0.4


def test_a_slow_storage_write_does_not_stall_other_streams(tmp_path):
    """``SqliteStorage`` writes on its own thread: a write held for 0.4 s
    leaves another request's SSE frames flowing.  The same hold inside a
    storage that writes on the event loop stalls them (the check can
    fail)."""
    slow = SqliteStorage(str(tmp_path / "slow.db"))
    conn = slow._conn

    class SlowConn:  # every statement of the response write waits on the db thread
        def execute(self, sql, *args):
            if sql.startswith("INSERT OR REPLACE INTO responses"):
                time.sleep(SLOW_S)
            return conn.execute(sql, *args)

        def __getattr__(self, name):
            return getattr(conn, name)

    slow._conn = SlowConn()
    gap, took = _gaps_during_a_slow_write(slow)
    assert took >= SLOW_S and gap < SLOW_S / 2, (gap, took)

    class BlockingMemory(MemoryStorage):
        async def store_response(self, response):
            time.sleep(SLOW_S)  # on the event loop
            return await super().store_response(response)

    gap, took = _gaps_during_a_slow_write(BlockingMemory())
    assert gap >= SLOW_S * 0.9, gap
