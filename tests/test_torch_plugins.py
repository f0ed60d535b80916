"""The plugin host and the gateway's plugin stage on the port, held against
the reference on the CPU.

- ``PluginHost`` on both packages over the same plugin files (each file
  imports its own package's actions; the text is otherwise the same):
  loading by file and by dotted module, a hookless module refused, first
  reject wins while modifies accumulate, fail-open and fail-closed, async
  hooks and the per-hook time budget, ``on_response`` modifies.  The
  decisions and the request and response states they leave are equal.
- The plugin stage through both apps (over a worker that streams three
  words): a reject with the plugin's status and ``plugin_rejected``, a
  response header added to probes and chats, a faulting plugin served
  fail-open and rejected fail-closed, a streamed chat passed through
  untouched; statuses, the header the plugin sets and bodies (chat ids and
  times removed) equal.
- ``AppContext.load_plugins`` keeps a fail-closed host fail-closed when a
  later call states no preference.

The reference's ten cases (``tests/test_plugins.py``) are the scenarios
here, each run on both packages.
"""

import asyncio
import importlib
import re
import sys
import threading

import pytest
from aiohttp.test_utils import TestClient, TestServer

from smg_tpu import plugins as jplugins
from smg_tpu.gateway import server as jserver
from smg_tpu.gateway import worker_client as jwc
from smg_tpu.gateway import workers as jworkers
from smg_tpu.plugins import host as jhost
from smg_tpu.tokenizer import MockTokenizer as JaxMockTokenizer
from smg_tpu_torch import plugins as tplugins
from smg_tpu_torch.gateway import server as tserver
from smg_tpu_torch.gateway import worker_client as twc
from smg_tpu_torch.gateway import workers as tworkers
from smg_tpu_torch.plugins import host as thost
from smg_tpu_torch.tokenizer import MockTokenizer

SIDES = {"smg_tpu": (jplugins, jhost, jserver), "smg_tpu_torch": (tplugins, thost, tserver)}
MODEL = "m"

# every plugin's text, ``{pkg}`` the package whose actions it returns
PLUGINS = {
    "cont": "from {pkg}.plugins import Continue\n"
            "def on_request(req):\n    return Continue()\n",
    "empty": "x = 1\n",
    "tag": "from {pkg}.plugins import Modify\n"
           "def on_request(req):\n"
           "    return Modify(headers_set={{'X-Tag': 'a'}}, headers_add={{'x-seen': '1'}},\n"
           "                  headers_remove=['x-drop'], body_replace=b'new')\n",
    "add_again": "from {pkg}.plugins import Modify\n"
                 "def on_request(req):\n"
                 "    return Modify(headers_add={{'x-seen': '2'}}, headers_set={{'x-tag': 'b'}})\n",
    "reject": "from {pkg}.plugins import Reject\n"
              "def on_request(req):\n    return Reject(403, 'nope')\n",
    "never": "def on_request(req):\n    raise AssertionError('must not run after a reject')\n",
    "boom": "def on_request(req):\n    raise RuntimeError('plugin bug')\n",
    "slow": "import asyncio\nfrom {pkg}.plugins import Continue\n"
            "async def on_request(req):\n    await asyncio.sleep(5)\n    return Continue()\n",
    "async_tag": "from {pkg}.plugins import Modify\n"
                 "async def on_request(req):\n    return Modify(headers_set={{'x-async': 'y'}})\n",
    "stamp": "from {pkg}.plugins import Modify\n"
             "def on_response(resp):\n"
             "    return Modify(headers_set={{'X-Stamped': 'yes'}}, status=202,\n"
             "                  headers_remove=['x-old'])\n",
    "veto": "from {pkg}.plugins import Reject\n"
            "def on_response(resp):\n    return Reject(502, 'vetoed')\n",
    "guard": "from {pkg}.plugins import Continue, Modify, Reject\n"
             "def on_request(req):\n"
             "    if req.headers.get('x-block') == '1':\n"
             "        return Reject(451, 'blocked by guard')\n"
             "    if req.headers.get('x-block') == 'boom':\n"
             "        raise RuntimeError('I am a buggy plugin')\n"
             "    return Continue()\n"
             "def on_response(resp):\n"
             "    return Modify(headers_set={{'X-Plugin-Saw': 'true'}})\n",
}


def _files(tmp_path, pkg: str) -> dict:
    out = {}
    for name, text in PLUGINS.items():
        path = tmp_path / pkg / f"{name}.py"
        path.parent.mkdir(exist_ok=True)
        path.write_text(text.format(pkg=pkg))
        out[name] = str(path)
    return out


def _action(a) -> tuple:
    return (type(a).__name__, dict(vars(a)))


def _on_both(tmp_path, fn):
    """``fn(plugins module, host module, plugin files)`` on both packages;
    asserts the two results equal and returns the port's."""
    got = {pkg: fn(mods[0], mods[1], _files(tmp_path, pkg)) for pkg, mods in SIDES.items()}
    assert got["smg_tpu_torch"] == got["smg_tpu"]
    return got["smg_tpu_torch"]


def _host(P, files, names, **kw):
    host = P.PluginHost(**kw)
    for n in names:
        host.load(files[n])
    return host


# ---- the host ----

def test_load_from_file_and_by_module(tmp_path):
    def run(P, H, files):
        host = P.PluginHost()
        loaded = host.load(files["cont"])
        sys.path.insert(0, str(tmp_path / P.__name__.split(".")[0]))
        try:
            mod = host.load("stamp")  # a dotted module name
        finally:
            sys.path.pop(0)
            sys.modules.pop("stamp", None)
        return ([(p.name, p.has_on_request, p.has_on_response) for p in host.plugins],
                loaded.name, mod.name, type(host.plugins[0].module).__name__)

    assert _on_both(tmp_path, run) == (
        [("cont", True, False), ("stamp", False, True)], "cont", "stamp", "module")


def test_load_rejects_hookless_module(tmp_path):
    def run(P, H, files):
        with pytest.raises(ValueError, match="exports neither") as e:
            P.PluginHost().load(files["empty"])
        return str(e.value).replace(files["empty"], "<file>")

    _on_both(tmp_path, run)


def _request_through(P, host, **headers):
    req = P.PluginRequest(method="POST", path="/v1/chat/completions", query="a=1",
                          headers={"x-drop": "d", **headers}, body=b"old", request_id="r1")
    action = asyncio.run(host.on_request(req))
    return _action(action), dict(vars(req))


@pytest.mark.parametrize("chain,want", [
    # first reject wins; the modify before it still applied, the plugin
    # after it never runs
    (["tag", "reject", "never"], "Reject"),
    # modifies accumulate in order: set overwrites, add keeps the first
    (["tag", "add_again"], "Continue"),
    (["cont", "async_tag", "tag"], "Continue"),
], ids=["first_reject_wins", "modify_accumulates", "async_and_sync"])
def test_on_request_chain(tmp_path, chain, want):
    def run(P, H, files):
        return _request_through(P, _host(P, files, chain))

    action, req = _on_both(tmp_path, run)
    assert action[0] == want
    if chain[0] == "tag":
        assert req["headers"]["x-tag"] == ("b" if "add_again" in chain else "a")
        assert req["headers"]["x-seen"] == "1" and "x-drop" not in req["headers"]
        assert req["body"] == b"new"


@pytest.mark.parametrize("fail_open", [True, False], ids=["fail_open", "fail_closed"])
@pytest.mark.parametrize("plugin", ["boom", "slow"])
def test_fault_isolation(tmp_path, plugin, fail_open):
    """A hook that raises, or outlives its budget, is a fault: fail-open
    continues, fail-closed rejects with 500."""
    def run(P, H, files):
        host = _host(P, files, [plugin], fail_open=fail_open, hook_timeout_s=0.05)
        return _request_through(P, host)

    action, _req = _on_both(tmp_path, run)
    if fail_open:
        assert action == ("Continue", {})
    else:
        assert action == ("Reject", {"status": 500, "message": f"plugin {plugin} failed"})


@pytest.mark.parametrize("chain", [["stamp"], ["stamp", "veto"]], ids=["modify", "veto"])
def test_on_response(tmp_path, chain):
    def run(P, H, files):
        resp = P.PluginResponse(status=200, headers={"x-old": "1"}, body=b"b")
        action = asyncio.run(_host(P, files, chain).on_response(resp))
        return _action(action), dict(vars(resp))

    action, resp = _on_both(tmp_path, run)
    assert resp["status"] == 202 and resp["headers"] == {"x-stamped": "yes"}
    assert action[0] == ("Reject" if "veto" in chain else "Continue")


def test_make_request(tmp_path):
    class Req:
        method, path, query_string = "GET", "/health", "x=1"
        headers = {"X-Block": "1", "Authorization": "Bearer k"}

    def run(P, H, files):
        preq = P.PluginHost.make_request(Req(), "rid-1")
        return {k: v for k, v in vars(preq).items() if k != "now_epoch_ms"}

    assert _on_both(tmp_path, run)["headers"] == {"x-block": "1", "authorization": "Bearer k"}


# ---- the plugin stage through both apps ----

def _serve_both(ctxs: dict) -> tuple:
    """The apps of ``ctxs`` ((package, name) -> ``AppContext``) on one
    private loop: (run, {(package, name): TestClient}, stop)."""
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()

    def run(coro):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(timeout=60)

    async def start(server, ctx):
        tc = TestClient(TestServer(server.build_app(ctx)))
        await tc.start_server()
        return tc

    clients = {key: run(start(SIDES[key[0]][2], ctx)) for key, ctx in ctxs.items()}

    def stop():
        for tc in clients.values():
            run(tc.close())
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=10)

    return run, clients, stop


def _worker(wc, workers, tok):
    """A worker of ``wc``'s package that streams three words, one a chunk."""
    class Three(wc.WorkerClient):
        async def generate(self, req):
            ids = tok.encode("w5 w6 w7")
            for i, t in enumerate(ids):
                yield wc.WorkerStreamChunk(
                    rid=req.rid, token_ids=[t], finished=i == len(ids) - 1,
                    finish_reason="stop" if i == len(ids) - 1 else None,
                    prompt_tokens=len(req.input_ids), output_tokens=i + 1)

        async def abort(self, rid):
            return True

        async def health(self):
            return True

    return workers.Worker(worker_id="three", client=Three(), model_id=MODEL)


def _context(pkg: str):
    server, wc, workers, tok = {
        "smg_tpu": (jserver, jwc, jworkers, JaxMockTokenizer()),
        "smg_tpu_torch": (tserver, twc, tworkers, MockTokenizer())}[pkg]
    ctx = server.AppContext(policy="round_robin")
    ctx.tokenizers.register(MODEL, tok, default=True)
    ctx.registry.add(_worker(wc, workers, tok))
    return ctx


@pytest.fixture(scope="module")
def gateways(tmp_path_factory):
    """Per package: a fail-open gateway with ``guard`` loaded and a
    fail-closed one with ``guard`` and ``boom``, each over a worker that
    streams three words."""
    tmp = tmp_path_factory.mktemp("plugins")
    ctxs = {}
    for pkg in SIDES:
        files = _files(tmp, pkg)
        ctxs[(pkg, "open")] = _context(pkg)
        ctxs[(pkg, "open")].load_plugins([files["guard"]])
        ctxs[(pkg, "closed")] = _context(pkg)
        ctxs[(pkg, "closed")].load_plugins([files["guard"]], fail_open=False)
        # a later call with no preference keeps the host fail-closed
        ctxs[(pkg, "closed")].load_plugins([files["boom"]])
    run, clients, stop = _serve_both(ctxs)
    yield run, clients, ctxs
    stop()


CALLS = {
    # the reference's three HTTP cases, then a chat whole and streamed, a
    # 404 and the fail-closed gateway
    "reject": ("open", "GET", "/health", {"X-Block": "1"}),
    "passthrough_and_modify": ("open", "GET", "/health", {}),
    "fault_fail_open": ("open", "GET", "/health", {"X-Block": "boom"}),
    "chat": ("open", "POST", "/v1/chat/completions", {}),
    "streamed": ("open", "POST", "/v1/chat/completions", {"X-Stream": "1"}),
    "unknown_route": ("open", "GET", "/no/such/route", {}),
    "fail_closed": ("closed", "GET", "/health", {}),
}


@pytest.mark.parametrize("case", sorted(CALLS))
def test_plugin_stage_is_the_reference(gateways, case):
    run, clients, ctxs = gateways
    which, method, path, headers = CALLS[case]
    body = ({"model": MODEL, "stream": "X-Stream" in headers,
             "messages": [{"role": "user", "content": "w9"}]} if method == "POST" else None)

    async def one(tc):
        r = await tc.request(method, path, headers=headers, json=body)
        text = await r.text()
        for key in ("id", "created"):  # chat ids and times differ per call
            text = re.sub(f'"{key}": ?("[^"]*"|[0-9]+)', f'"{key}": _', text)
        return (r.status, r.headers.get("X-Plugin-Saw"), r.content_type, text)

    got = {pkg: run(one(clients[(pkg, w)])) for (pkg, w) in clients if w == which}
    assert got["smg_tpu_torch"] == got["smg_tpu"]
    status, saw, ctype, text = got["smg_tpu_torch"]
    if case == "reject":
        assert status == 451 and '"plugin_rejected"' in text and "blocked by guard" in text
    elif case in ("passthrough_and_modify", "fault_fail_open"):
        assert (status, saw) == (200, "true") and '"ok"' in text
    elif case == "chat":
        assert (status, saw) == (200, "true") and "w5 w6 w7" in text
    elif case == "streamed":
        # a stream is not a whole response: on_response does not see it
        assert (status, saw, ctype) == (200, None, "text/event-stream")
        assert text.rstrip().endswith("data: [DONE]")
    elif case == "fail_closed":
        assert status == 500 and "plugin boom failed" in text
    assert ctxs[("smg_tpu_torch", "closed")].plugins.fail_open is False


def test_cli_flag_wires_plugins(tmp_path):
    """``launch --plugins p.py`` parses on both CLIs and loads the host."""
    def run(P, H, files):
        pkg = P.__name__.split(".")[0]
        args = importlib.import_module(f"{pkg}.cli").build_parser().parse_args(
            ["launch", "--plugins", files["cont"]])
        ctx = SIDES[pkg][2].AppContext()
        ctx.load_plugins(args.plugins, fail_open=not args.plugin_fail_closed)
        return len(ctx.plugins.plugins), ctx.plugins.fail_open, args.plugin_fail_closed

    assert _on_both(tmp_path, run) == (1, True, False)
