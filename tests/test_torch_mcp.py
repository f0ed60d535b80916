"""The port's MCP client orchestration against the JAX package's, on the CPU.

Every case of the reference's ``tests/test_mcp_depth.py`` up to the
Responses loop (policy rules and trust, the read-only condition, park,
decide and audit, deny and force, timeout eviction, session TTL and the
registry fingerprint, tenant views, collisions and qualified names) and
``test_agentic``'s local registry run as scenarios on both packages; each
scenario returns its outcomes (return values, errors with their codes and
texts, audit entries), and the two lists must be equal.  Approval keys and
session ids are random in both: they are replaced by the order of their
first appearance.  Clocks are injected: the approval and session modules
read a clock the test moves.  Then ``HttpMcpServer`` (JSON-RPC 2.0 over
aiohttp) against an in-test MCP server answering in JSON and in one-shot
SSE: the requests it receives, the tools, the results and the errors."""

import asyncio
import dataclasses
import json
import re

import numpy as np
import pytest
from aiohttp import web

from smg_tpu import mcp as jmcp
from smg_tpu.mcp import approval as japproval
from smg_tpu.mcp import errors as jerrors
from smg_tpu.mcp import sessions as jsessions
from smg_tpu_torch import mcp as tmcp
from smg_tpu_torch.mcp import approval as tapproval
from smg_tpu_torch.mcp import errors as terrors
from smg_tpu_torch.mcp import sessions as tsessions

PACKAGES = {"jax": (jmcp, japproval, jsessions, jerrors),
            "port": (tmcp, tapproval, tsessions, terrors)}
RANDOM_IDS = re.compile(r"\b(mcpr|mcps)_[0-9a-f]+")


class Clock:
    """``time`` for the approval and session modules, moved by the test."""

    def __init__(self):
        self.offset = 0.0

    def monotonic(self) -> float:
        return 1_000.0 + self.offset

    def time(self) -> float:
        return 1_000_000.0 + self.offset


@pytest.fixture
def clocks(monkeypatch):
    """One clock a package; ``PendingApproval.created_at`` reads it too
    (its default factory holds the real clock, so the class is replaced by
    a subclass whose factory reads the test's)."""
    out = {}
    for name, (_m, approval, sessions, _e) in PACKAGES.items():
        clock = out[name] = Clock()
        monkeypatch.setattr(approval, "time", clock)
        monkeypatch.setattr(sessions, "time", clock)
        monkeypatch.setattr(approval, "PendingApproval", dataclasses.make_dataclass(
            "PendingApproval", [("created_at", float,
                                 dataclasses.field(default_factory=clock.monotonic))],
            bases=(approval.PendingApproval,)))
    return out


def _canon(obj, seen: dict):
    """Random keys and ids replaced by their order of first appearance."""
    if isinstance(obj, str):
        return RANDOM_IDS.sub(lambda m: seen.setdefault(m.group(0), f"<id{len(seen)}>"), obj)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_canon(v, seen) for v in obj)
    if isinstance(obj, dict):
        return {k: _canon(v, seen) for k, v in obj.items()}
    return obj


def _audit(mgr) -> list:
    return [(e.at, e.server, e.tool, e.decision, e.reason, e.request_id)
            for e in mgr.audit.tail(1000)]


def _run_both(scenario, clocks) -> list:
    """``scenario(mcp, errors, clock, out)`` on each package; the outcome
    lists (canonical ids) must be equal."""
    got = {}
    for name, (mcp, _a, _s, errors) in PACKAGES.items():
        out: list = []

        def record(what, fn, *args, **kw):
            try:
                value = fn(*args, **kw)
                if asyncio.iscoroutine(value):
                    value = asyncio.run(value)
                out.append((what, "ok", value))
                return value
            except errors.McpError as e:
                out.append((what, type(e).__name__, e.code, str(e)))
            except KeyError as e:
                out.append((what, "KeyError", str(e)))
            return None

        scenario(mcp, clocks[name], record, out)
        got[name] = _canon(out, {})
    assert got["port"] == got["jax"]
    return got["port"]


def _pending(p):
    return None if p is None else (p.key, p.server, p.tool, p.arguments, p.request_id)


# ---- policy engine ----

def test_policy_rules_first_match_and_trust(clocks):
    def scenario(mcp, clock, record, out):
        p = (mcp.ApprovalPolicy(default=mcp.Decision.ALLOW)
             .add_rule(mcp.PolicyRule(server="prod*", tool="delete_*",
                                      decision=mcp.Decision.DENY, reason="no deletes"))
             .add_rule(mcp.PolicyRule(server="prod*", decision=mcp.Decision.REQUIRE_APPROVAL))
             .set_server_trust("sandbox", mcp.TrustLevel.TRUSTED)
             .set_server_trust("sketchy", mcp.TrustLevel.UNTRUSTED))
        for server, tool in (("prod-db", "delete_rows"), ("prod-db", "read_rows"),
                             ("sandbox", "anything"), ("sketchy", "anything"),
                             ("other", "anything"), ("prod", "delete_"), ("xprod", "delete_x")):
            d, reason = p.evaluate(server, tool)
            out.append((server, tool, d.value, reason))

    got = _run_both(scenario, clocks)
    assert got[0] == ("prod-db", "delete_rows", "deny", "no deletes")
    assert [g[2] for g in got[1:5]] == ["require_approval", "allow", "require_approval", "allow"]


def test_policy_read_only_condition(clocks):
    def scenario(mcp, clock, record, out):
        p = mcp.ApprovalPolicy().add_rule(mcp.PolicyRule(
            tool="*", decision=mcp.Decision.REQUIRE_APPROVAL, only_if_write=True))
        for ro in (True, False):
            out.append((ro, p.evaluate("s", "t", read_only=ro)[0].value))

    assert _run_both(scenario, clocks) == [(True, "allow"), (False, "require_approval")]


# ---- approval manager ----

def test_approval_manager_park_decide_audit(clocks):
    def scenario(mcp, clock, record, out):
        mgr = mcp.ApprovalManager(mcp.ApprovalPolicy().add_rule(
            mcp.PolicyRule(server="s", decision=mcp.Decision.REQUIRE_APPROVAL)))
        pending = mgr.check("s", "t", '{"a": 1}', request_id="r1")
        out.append(("check", _pending(pending), mgr.has_pending(pending.key),
                    mgr.pending_count()))
        out.append(("allowed", _pending(mgr.check("other", "t", "{}", request_id="r2"))))
        got = mgr.decide(pending.key, approve=True, reason="ok by me")
        out.append(("decide", _pending(got), mgr.has_pending(pending.key)))
        record("decide_unknown", mgr.decide, "mcpr_nope", approve=True)
        record("decide_again", mgr.decide, pending.key, approve=False)
        mgr.restore("mcpr_restored", "s", "t", "{}", request_id="r3")
        out.append(("restored", mgr.has_pending("mcpr_restored")))
        out.append(("denied", _pending(mgr.decide("mcpr_restored", approve=False))))
        out.append(("audit", _audit(mgr)))

    got = _run_both(scenario, clocks)
    kinds = [e[3] for e in got[-1][1]]
    assert kinds == ["pending", "allowed", "approved", "denied"]
    assert got[3][1] == "ApprovalNotFound"


def test_approval_manager_deny_and_force(clocks):
    def scenario(mcp, clock, record, out):
        mgr = mcp.ApprovalManager(mcp.ApprovalPolicy().add_rule(
            mcp.PolicyRule(server="bad", decision=mcp.Decision.DENY)))
        record("deny", mgr.check, "bad", "t", "{}")
        record("deny_forced", mgr.check, "bad", "t", "{}", force_approval=True)
        out.append(("force", _pending(mgr.check("good", "t", "{}", force_approval=True))))
        out.append(("audit", _audit(mgr)))

    got = _run_both(scenario, clocks)
    assert got[0][1] == "ToolDenied" and got[1][1] == "ToolDenied"
    assert got[2][1] is not None


def test_approval_timeout_eviction(clocks):
    def scenario(mcp, clock, record, out):
        mgr = mcp.ApprovalManager(mcp.ApprovalPolicy(default=mcp.Decision.REQUIRE_APPROVAL),
                                  timeout=60.0)
        a = mgr.check("s", "t", "{}", request_id="old")
        clock.offset += 30.0
        b = mgr.check("s", "u", "{}", request_id="new")
        out.append(("both", mgr.pending_count()))
        clock.offset += 31.0  # a is 61 s old, b 31 s
        out.append(("one", mgr.pending_count(), mgr.has_pending(a.key), mgr.has_pending(b.key)))
        record("decide_expired", mgr.decide, a.key, approve=True)
        clock.offset += 30.0
        out.append(("none", mgr.pending_count()))
        out.append(("audit", _audit(mgr)))

    got = _run_both(scenario, clocks)
    assert got[0] == ("both", 2) and got[1][1:] == (1, False, True) and got[3] == ("none", 0)
    assert [e[3] for e in got[4][1]].count("expired") == 2


# ---- sessions ----

def test_session_manager_ttl_and_registry_change(clocks):
    def scenario(mcp, clock, record, out):
        async def go():
            sm = mcp.SessionManager(ttl=100.0, max_sessions=2)
            reg = mcp.McpRegistry()
            srv = mcp.LocalToolServer("a")
            srv.register("t", lambda: "x")
            reg.add(srv)
            s1 = await sm.get_or_create("conv1", reg)
            s2 = await sm.get_or_create("conv1", reg)
            out.append(("same", s1 is s2, sm.count))
            reg2 = mcp.McpRegistry()
            reg2.add(srv)
            reg2.add(mcp.LocalToolServer("b"))
            s3 = await sm.get_or_create("conv1", reg2)
            out.append(("new_registry", s3 is not s1, sm.count))
            s4 = await sm.get_or_create("conv1", reg2, tenant="acme")
            out.append(("new_tenant", s4 is not s3, s4.tenant))
            anon = await sm.get_or_create(None, reg)
            out.append(("anonymous", anon.id, sm.count))
            out.append(("tools", [(t.name, t.server) for t in await s4.tools()]))
            out.append(("call", await s4.call_tool("t", {})))
            out.append(("server_for", s4.server_for("t"), s4.server_for("a.t"),
                        s4.server_for("nope")))
            clock.offset += 50.0
            await sm.get_or_create("conv2", reg)  # LRU overflow: the oldest goes
            out.append(("overflow", sm.count, sm.get("conv1") is None, sm.get(anon.id) is None))
            clock.offset += 101.0
            await sm.get_or_create("conv3", reg)
            out.append(("ttl", sm.count, sm.get("conv2") is None))
            await sm.close()
            out.append(("closed", sm.count))

        asyncio.run(go())

    got = _run_both(scenario, clocks)
    assert got[0] == ("same", True, 1) and got[1] == ("new_registry", True, 1)
    assert got[-2] == ("ttl", 1, True)


# ---- inventory / tenancy ----

def test_inventory_tenant_views(clocks):
    def scenario(mcp, clock, record, out):
        inv = mcp.McpInventory()
        inv.add_server(mcp.LocalToolServer("shared"))
        inv.add_server(mcp.LocalToolServer("acme-internal"), tenants=["acme"])
        inv.add_server(mcp.LocalToolServer("beta"), tenants=["acme", "beta-co"])
        for tenant in ("acme", "beta-co", "other", None):
            out.append((tenant, inv.servers_for(tenant)))
        record("access_ok", inv.check_access, "acme", "acme-internal")
        record("access_denied", inv.check_access, "other", "acme-internal")
        record("access_missing", inv.check_access, "acme", "nope")
        record("allow_missing", inv.allow, "other", "nope")
        inv.allow("other", "shared")
        out.append(("public_stays", inv.servers_for(None), inv.servers_for("other")))
        inv.allow("other", "acme-internal")
        out.append(("granted", inv.servers_for("other")))
        inv.remove_server("acme-internal")
        out.append(("removed", inv.servers, inv.servers_for("acme"), inv.servers_for("other")))
        out.append(("registry", inv.registry_for("beta-co").servers,
                    inv.registry_for(None, extra=[mcp.LocalToolServer("req")]).servers))

    got = _run_both(scenario, clocks)
    assert got[0] == ("acme", ["acme-internal", "beta", "shared"])
    assert got[2] == ("other", ["shared"])
    assert got[5][1] == "ServerAccessDenied"


# ---- multi-server routing and collisions ----

def test_registry_collision_and_qualified_names(clocks):
    def scenario(mcp, clock, record, out):
        async def go():
            a, b = mcp.LocalToolServer("a"), mcp.LocalToolServer("b")
            a.register("search", lambda q: f"a:{q}", "search a", {"type": "object"})
            b.register("search", lambda q: f"b:{q}")
            b.register("only_b", lambda: "ok")
            b.register("boom", lambda: 1 / 0)

            async def structured(x):
                return {"x": x, "list": [1, 2]}

            b.register("structured", structured)
            reg = mcp.McpRegistry()
            reg.add(a)
            reg.add(b)
            out.append(("servers", reg.servers))
            out.append(("collisions", await reg.collisions()))
            out.append(("tools", [(t.name, t.server, t.description, t.input_schema)
                                  for t in await reg.list_tools()]))
            for name, args in (("search", {"q": "x"}), ("a.search", {"q": "x"}),
                               ("b.search", {"q": "y"}), ("only_b", {}), ("nope", {}),
                               ("c.search", {"q": "x"}), ("boom", {}), ("structured", {"x": 3}),
                               ("a.only_b", {})):
                try:
                    out.append((name, "ok", await reg.call_tool(name, args)))
                except mcp.McpError as e:
                    out.append((name, type(e).__name__, e.code, str(e),
                                getattr(e, "servers", None)))
            reg.remove("a")
            out.append(("after_remove", await reg.call_tool("search", {"q": "z"})))

        asyncio.run(go())

    got = _run_both(scenario, clocks)
    assert got[1] == ("collisions", {"search": ["a", "b"]})
    assert got[3][1] == "ToolCollision" and got[3][4] == ["a", "b"]
    assert got[4] == ("a.search", "ok", "a:x")
    assert got[-1] == ("after_remove", "b:z")


def test_local_server_and_registry(clocks):
    """``test_agentic``'s local registry case."""
    def scenario(mcp, clock, record, out):
        async def go():
            srv = mcp.LocalToolServer("test")
            srv.register("add", lambda a, b: {"sum": a + b}, "adds numbers",
                         {"type": "object", "properties": {"a": {}, "b": {}}})
            reg = mcp.McpRegistry()
            reg.add(srv)
            out.append([(t.name, t.description, t.input_schema) for t in await reg.list_tools()])
            out.append(await reg.call_tool("add", {"a": 2, "b": 3}))
            try:
                await srv.call_tool("nope", {})
            except KeyError as e:
                out.append(("KeyError", str(e)))
            await reg.close()

        asyncio.run(go())

    got = _run_both(scenario, clocks)
    assert got[1] == '{"sum": 5}'


def test_error_taxonomy_matches_reference():
    names = sorted(n for n in dir(jerrors) if isinstance(getattr(jerrors, n), type)
                   and issubclass(getattr(jerrors, n), Exception))
    assert names == sorted(n for n in dir(terrors) if isinstance(getattr(terrors, n), type)
                           and issubclass(getattr(terrors, n), Exception))
    for n in names:
        j, t = getattr(jerrors, n), getattr(terrors, n)
        assert getattr(t, "code", None) == getattr(j, "code", None), n
        assert [b.__name__ for b in t.__mro__] == [b.__name__ for b in j.__mro__], n
    assert str(terrors.ToolCollision("t", ["a", "b"])) == str(jerrors.ToolCollision("t", ["a", "b"]))
    assert sorted(tmcp.__all__) == sorted(jmcp.__all__)


# ---- HttpMcpServer over JSON-RPC ----

TOOLS = [{"name": "lookup", "description": "find a word",
          "inputSchema": {"type": "object", "properties": {"q": {"type": "string"}}}},
         {"name": "stats", "description": "structured", "inputSchema": {}}]


class McpHttp:
    """An in-test MCP server: ``initialize``, ``tools/list``, ``tools/call``
    over JSON-RPC 2.0, answering as JSON or as a one-shot SSE body; every
    request it receives is logged (method, id, params, chosen headers)."""

    def __init__(self, sse: bool):
        self.sse, self.log = sse, []

    async def handle(self, request: web.Request) -> web.StreamResponse:
        body = await request.json()
        self.log.append((body["jsonrpc"], body["id"], body["method"], body["params"],
                         request.headers.get("X-Key"), request.headers.get("Content-Type")))
        method, params = body["method"], body["params"]
        if method == "initialize":
            answer = {"result": {"protocolVersion": params["protocolVersion"],
                                 "capabilities": {"tools": {}}}}
        elif method == "tools/list":
            answer = {"result": {"tools": TOOLS}}
        elif params.get("name") == "lookup":
            q = params["arguments"].get("q", "")
            answer = {"result": {"content": [{"type": "text", "text": f"{q}: found"},
                                             {"type": "image", "data": "..."},
                                             {"type": "text", "text": "second part"}]}}
        elif params.get("name") == "stats":
            answer = {"result": {"content": [], "structuredContent": {"n": 3}}}
        else:
            answer = {"error": {"code": -32602, "message": f"unknown tool {params.get('name')}"}}
        payload = {"jsonrpc": "2.0", "id": body["id"], **answer}
        if not self.sse:
            return web.json_response(payload)
        resp = web.StreamResponse(headers={"Content-Type": "text/event-stream"})
        await resp.prepare(request)
        await resp.write(b": comment\n\nevent: message\n")
        await resp.write(f"data: {json.dumps(payload)}\n\n".encode())
        await resp.write_eof()
        return resp


async def _serve(handler):
    app = web.Application()
    app.router.add_post("/mcp", handler)
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    return runner, site._server.sockets[0].getsockname()[1]


@pytest.mark.parametrize("sse", [False, True], ids=["json", "sse"])
def test_http_mcp_server_matches_reference(sse):
    rng = np.random.default_rng(7)
    queries = ["".join(chr(int(c)) for c in rng.integers(97, 123, 6)) for _ in range(3)]

    async def go(mcp):
        server = McpHttp(sse)
        runner, port = await _serve(server.handle)
        out = []
        srv = mcp.HttpMcpServer(name="words", url=f"http://127.0.0.1:{port}/mcp",
                                headers={"X-Key": "k"})
        reg = mcp.McpRegistry()
        reg.add(srv)
        try:
            out.append([(t.name, t.description, t.input_schema, t.server)
                        for t in await reg.list_tools()])
            for q in queries:
                out.append(await reg.call_tool("lookup", {"q": q}))
            out.append(await reg.call_tool("words.stats", {}))
            try:
                await reg.call_tool("words.missing", {})
            except mcp.McpError as e:
                out.append((type(e).__name__, e.code, str(e)))
        finally:
            await reg.close()
            out.append(srv._session.closed)
            await runner.cleanup()
        return out, server.log

    got = {name: asyncio.run(go(p[0])) for name, p in PACKAGES.items()}
    assert got["port"] == got["jax"]
    out, log = got["port"]
    assert out[1] == f"{queries[0]}: found\nsecond part"
    assert json.loads(out[4]) == {"content": [], "structuredContent": {"n": 3}}
    assert out[5][0] == "ToolExecutionError" and "unknown tool missing" in out[5][2]
    assert out[-1] is True  # close() closed the aiohttp session
    assert [m for _v, _i, m, *_ in log] == ["initialize", "tools/list", "tools/call",
                                            "tools/call", "tools/call", "tools/call",
                                            "tools/call"]
    assert {(h, c) for *_x, h, c in log} == {("k", "application/json")}


def test_http_mcp_server_empty_sse_matches_reference():
    async def empty(request):
        await request.read()
        resp = web.StreamResponse(headers={"Content-Type": "text/event-stream"})
        await resp.prepare(request)
        await resp.write(b": nothing\n\n")
        await resp.write_eof()
        return resp

    async def go(mcp):
        runner, port = await _serve(empty)
        srv = mcp.HttpMcpServer(name="e", url=f"http://127.0.0.1:{port}/mcp")
        try:
            await srv.list_tools()
        except RuntimeError as e:
            return type(e).__name__, str(e)
        finally:
            await srv.close()
            await runner.cleanup()

    assert asyncio.run(go(tmcp)) == asyncio.run(go(jmcp)) == (
        "RuntimeError", "empty SSE response from MCP server")
