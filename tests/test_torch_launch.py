"""``launch`` on the port, held against the JAX package on the CPU.

- (a) every ``launch`` flag the port takes has the dest, default, type and
  choices of ``smg_tpu.cli.build_parser()``'s (``--storage`` and
  ``--mcp-config-path`` their help too, on ``serve`` as well), the HA
  mesh's ``--mesh-*`` among them; ``--plugins`` and
  ``--plugin-fail-closed`` reach the plugin host as the reference wires
  them;
- (b) startup validation: every case of ``tests/test_config_cli.py`` (and
  the engine-flag cases of the megastep and speculation tests) through the
  port's ``validate_cli_args`` gives the reference's issues, severities and
  messages, over the reference's parsed namespace and, where the port takes
  the flags, over the port's; ``cli.main`` refuses a bad command line
  before anything binds;
- (c) ``_run_gateway`` in launch mode in front of a port gRPC worker (a
  tiny CPU engine): the worker registered at startup through the workflow,
  the gateway tokenizing with the worker's bundle, TLS, the probe-only and
  metrics-only listeners; with the worker not up yet, the mock fallback
  until the late registration's bundle takes the default over it; ``serve``
  with ``--worker``; ``--mcp-config-path`` read into ``HttpMcpServer``s and
  an unknown ``--storage`` refused with the reference's error before an
  engine loads or a port binds;
- (d) ``worker --device cpu`` and ``launch`` as processes of their own: a
  chat through them, streamed and not, equals the same chat through an
  in-process gateway over the same engine, the worker process's tokens
  equal the in-process engine's with logprobs to 1e-4 (no gateway returns
  logprobs), and both processes exit 0 on SIGTERM;
- (e) discovery over a fake ``KubeApi``: the reference's and the port's
  ``ServiceDiscovery`` register and remove the same workers, and
  ``start_discovery`` watches one group per role selector."""

import argparse
import asyncio
import dataclasses
import datetime
import json
import os
import signal
import socket
import ssl
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import torch

from smg_tpu import cli as jcli
from smg_tpu.config import validation as jval
from smg_tpu.gateway import discovery as jdisc
from smg_tpu.gateway.workers import WorkerRegistry as JaxRegistry
from smg_tpu_torch import cli as tcli
from smg_tpu_torch.config import validation as tval
from smg_tpu_torch.engine import config as tconf
from smg_tpu_torch.engine.engine import Engine
from smg_tpu_torch.gateway import discovery as tdisc
from smg_tpu_torch.gateway import launch
from smg_tpu_torch.gateway.workers import WorkerRegistry
from smg_tpu_torch.models.config import tiny_test_config
from smg_tpu_torch.rpc import server as trpc
from smg_tpu_torch.tokenizer import MockTokenizer

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]


def _options(parser, command: str) -> dict:
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return {o: a for a in sub.choices[command]._actions for o in a.option_strings
            if o not in ("-h", "--help")}


PORT_LAUNCH = _options(tcli.build_parser(), "launch")
REF_LAUNCH = _options(jcli.build_parser(), "launch")

# ---- (a) flags ----


@pytest.mark.parametrize("flag", sorted(PORT_LAUNCH))
def test_launch_flag_has_the_reference_dest_default_and_type(flag):
    port, ref = PORT_LAUNCH[flag], REF_LAUNCH[flag]
    fields = ("dest", "default", "type", "choices", "nargs", "const", "required")
    assert type(port) is type(ref)
    assert {f: getattr(port, f) for f in fields} == {f: getattr(ref, f) for f in fields}


#: the reference's ``launch`` flags the port leaves out, each with the
#: module it waits for (ROADMAP Queue A): none since the HA mesh came
REFUSED: list = []


def test_every_reference_launch_flag_is_taken_or_refused():
    refused = {a[0] for a in REFUSED}
    assert set(REF_LAUNCH) == set(PORT_LAUNCH) | refused
    assert not refused & set(PORT_LAUNCH)


#: the HA mesh flags (they left ``REFUSED`` with ``smg_tpu_torch/mesh``)
MESH_FLAGS = [["--mesh-port", "7946"], ["--mesh-seed", "h:1", "--mesh-seed", "h:2"],
              ["--mesh-tls-cert", "c"], ["--mesh-tls-key", "k"], ["--mesh-tls-ca", "a"]]


@pytest.mark.parametrize("argv", MESH_FLAGS, ids=[a[0] for a in MESH_FLAGS])
def test_mesh_flag_parses_as_the_reference(argv):
    for command in ("launch", "serve"):
        ref, port = (vars(m.build_parser().parse_args([command, *argv])) for m in (jcli, tcli))
        for dest in ("mesh_port", "mesh_seeds", "mesh_tls_cert", "mesh_tls_key", "mesh_tls_ca"):
            assert port[dest] == ref[dest], (command, dest)


#: the routing flags the hashing and DP-rank policies brought (they left
#: ``REFUSED``): the argv, then the policy, its ``prefix_tokens`` and the
#: router's DP-rank policy they must give
ROUTING_FLAGS = [
    (["--policy", "prefix_hash", "--prefix-token-count", "8"], ("prefix_hash", 8, "dp_min_token")),
    (["--dp-aware"], ("cache_aware", None, "dp_min_token")),
    (["--no-dp-aware"], ("cache_aware", None, "dp_passthrough")),
]


@pytest.mark.parametrize("argv,want", ROUTING_FLAGS, ids=[a[-1] if a[-1].startswith("--")
                                                         else a[-2] for a, _ in ROUTING_FLAGS])
def test_routing_flag_parses_as_the_reference_and_reaches_the_router(argv, want):
    from smg_tpu_torch.gateway.server import AppContext

    ref, port = (vars(m.build_parser().parse_args(["launch", *argv])) for m in (jcli, tcli))
    ref0, port0 = (vars(m.build_parser().parse_args(["launch"])) for m in (jcli, tcli))
    for dest in ("policy", "prefix_token_count", "dp_aware"):
        assert (port[dest], port0[dest]) == (ref[dest], ref0[dest]), dest
    ctx = AppContext(**launch.gateway_options(tcli.build_parser().parse_args(["launch", *argv])))
    pol = ctx.policies.policy_for(None)
    assert (pol.name, getattr(pol, "prefix_tokens", None), ctx.router.dp_policy.name) == want


#: the plugin flags (they left ``REFUSED`` with the plugin host): the argv,
#: then the plugin files loaded, in order, and the host's ``fail_open``
#: (None: no host)
PLUGIN_FLAGS = [
    (["--plugins", "{a}"], (["a"], True)),
    (["--plugins", "{a}", "--plugin-fail-closed"], (["a"], False)),
    (["--plugins", "{a}", "--plugins", "{b}"], (["a", "b"], True)),
    (["--plugin-fail-closed"], ([], None)),
]


@pytest.mark.parametrize("command", ["serve", "launch"])
@pytest.mark.parametrize("argv,want", PLUGIN_FLAGS, ids=["one", "fail_closed", "two", "no_file"])
def test_plugin_flags_parse_as_the_reference_and_reach_the_plugin_host(
        command, argv, want, tmp_path, monkeypatch):
    """The flags parse to the reference's values; ``_run_gateway`` loads the
    files in order into ``ctx.plugins`` with the ``fail_open`` the
    reference's wiring (``smg_tpu/gateway/launch.py``: ``load_plugins(args.
    plugins, fail_open=not args.plugin_fail_closed)`` when any are given)
    sets on its own ``AppContext``."""
    from smg_tpu.gateway.server import AppContext as JaxContext

    files = {name: tmp_path / f"{name}.py" for name in "ab"}
    for path in files.values():
        path.write_text("from smg_tpu_torch.plugins import Continue\n"
                        "def on_request(req):\n    return Continue()\n")
    argv = [a.format(**files) for a in argv]
    extra = ["--device", "cpu"] * (command == "serve")
    ref, port = (vars(m.build_parser().parse_args([command, *BASE[command], *argv]))
                 for m in (jcli, tcli))
    for dest in ("plugins", "plugin_fail_closed"):
        assert port[dest] == ref[dest], dest
    ctx = asyncio.run(_context_of(tcli.build_parser().parse_args(
        [command, *BASE[command], *argv, *extra]), monkeypatch))
    names, fail_open = want
    if fail_open is None:
        assert ctx.plugins is None
    else:
        assert [p.name for p in ctx.plugins.plugins] == names
        assert ctx.plugins.fail_open is fail_open
    jctx = JaxContext()
    if ref["plugins"]:
        jctx.load_plugins(ref["plugins"], fail_open=not ref["plugin_fail_closed"])
    assert (None if jctx.plugins is None else jctx.plugins.fail_open) == fail_open


PROVIDERS = [
    {"name": "oai", "kind": "openai", "base_url": "http://127.0.0.1:9/v1/",
     "api_key_env": "SMG_TEST_PROVIDER_KEY", "models": ["gpt-x"],
     "model_map": {"gpt-x": "gpt-x-2024"}},
    {"kind": "anthropic", "base_url": "http://127.0.0.1:9/v1", "api_key": "sk-a",
     "timeout_s": 30},
    {"name": "grok", "kind": "xai", "base_url": "http://127.0.0.1:9", "models": ["grok-4"]},
    {"kind": "gemini", "base_url": "http://127.0.0.1:9", "api_key_env": "SMG_TEST_UNSET_KEY",
     "api_key": "fallback"},
    {"kind": "bedrock", "base_url": "https://bedrock-runtime.us-west-2.amazonaws.com",
     "api_key": "AKID:SECRET"},
]


async def _context_of(args, monkeypatch):
    """The ``AppContext`` ``_run_gateway`` builds from ``args``, taken on its
    way into ``serve_context`` (no engine is built and nothing binds)."""
    held = {}

    async def serve_context(ctx, *a, **kw):
        held["ctx"] = ctx

    monkeypatch.setattr(launch, "serve_context", serve_context)
    monkeypatch.setattr(launch, "build_engine_from_args", lambda args: None)
    monkeypatch.setattr(launch, "add_engine_worker", lambda ctx, engine, **kw: None)
    await launch._run_gateway(args, stop=asyncio.Event())
    return held["ctx"]


@pytest.mark.parametrize("command", ["serve", "launch"])
def test_provider_config_parses_as_the_reference_and_reaches_the_providers(
        command, tmp_path, monkeypatch):
    from smg_tpu.gateway.providers import ProviderRegistry as JaxProviders

    port, ref = (_options(m.build_parser(), command)["--provider-config"] for m in (tcli, jcli))
    fields = ("dest", "default", "type", "nargs", "required")
    assert {f: getattr(port, f) for f in fields} == {f: getattr(ref, f) for f in fields}
    path = tmp_path / "providers.json"
    path.write_text(json.dumps(PROVIDERS))
    monkeypatch.setenv("SMG_TEST_PROVIDER_KEY", "sk-from-env")
    monkeypatch.delenv("SMG_TEST_UNSET_KEY", raising=False)
    argv = [command, *BASE[command], "--provider-config", str(path)]
    ns = tcli.build_parser().parse_args(argv + ["--device", "cpu"] * (command == "serve"))
    assert ns.provider_config == jcli.build_parser().parse_args(argv).provider_config
    ctx = asyncio.run(_context_of(ns, monkeypatch))
    ref = JaxProviders()
    ref.load_config(str(path))

    def specs(reg):
        return [(type(a).__name__, dataclasses.asdict(a.spec)) for a in reg._adapters]

    assert specs(ctx.providers) == specs(ref)
    assert ctx.providers._adapters[0].spec.api_key == "sk-from-env"
    assert ctx.providers._adapters[3].spec.api_key == "fallback"
    assert ctx.providers.list_models() == ref.list_models() == ["gpt-x", "grok-4"]
    for model in ("gpt-x", "anthropic/claude", "grok-4", "grok/grok-3", "bedrock/m", "nope"):
        got, want = ctx.providers.resolve(model), ref.resolve(model)
        assert (got and got.spec.name) == (want and want.spec.name), model


def test_an_unknown_provider_kind_fails_startup_with_the_reference_error(tmp_path, monkeypatch):
    from smg_tpu.gateway.providers import ProviderRegistry as JaxProviders

    path = tmp_path / "providers.json"
    path.write_text(json.dumps([{"kind": "nope", "base_url": "http://x"}]))
    with pytest.raises(ValueError) as want:
        JaxProviders().load_config(str(path))
    built = []
    monkeypatch.setattr(launch, "build_engine_from_args", lambda args: built.append(args))
    ns = tcli.build_parser().parse_args(["serve", "--model-preset", "tiny", "--device", "cpu",
                                         "--provider-config", str(path)])
    with pytest.raises(ValueError) as got:
        asyncio.run(launch._run_gateway(ns, stop=asyncio.Event()))
    assert str(got.value) == str(want.value)
    assert built == []  # refused before an engine is built


@pytest.mark.parametrize("command", ["serve", "launch"])
@pytest.mark.parametrize("flag", ["--storage", "--mcp-config-path"])
def test_storage_and_mcp_flags_are_the_reference_ones(command, flag):
    port = _options(tcli.build_parser(), command)[flag]
    ref = _options(jcli.build_parser(), command)[flag]
    fields = ("dest", "default", "type", "help", "nargs", "required")
    assert {f: getattr(port, f) for f in fields} == {f: getattr(ref, f) for f in fields}


# ---- (b) startup validation ----

BASE = {"launch": [], "serve": ["--model-preset", "tiny"], "worker": ["--model-preset", "tiny"]}
CASES = [("launch", a) for a in (
    [], ["--tls-cert-path", "/c.pem"], ["--tls-cert-path", "/c.pem", "--tls-key-path", "/k.pem"],
    ["--port", "30000", "--health-check-port", "30000"],
    ["--port", "30000", "--health-check-port", "30100"],
    ["--retry-initial-backoff-ms", "5000", "--retry-max-backoff-ms", "1000"],
    ["--cb-failure-threshold", "0"], ["--health-success-threshold", "0"],
    ["--health-check-timeout-secs", "10", "--health-check-interval-secs", "5"],
    ["--disable-retries", "--disable-circuit-breaker"], ["--cache-threshold", "1.5"],
    ["--policy", "round_robin", "--cache-threshold", "0.7"],
    ["--rate-limit-tokens-per-second", "-1"],
    ["--rate-limit-tokens-per-second", "100", "--rate-limit-burst", "10"],
    ["--api-key", ":tenant"], ["--jwt-issuer", "https://idp"], ["--trust-tenant-header"],
    ["--harmony", "on", "--reasoning-parser", "deepseek_r1"], ["--selector", "app=x"],
    ["--mesh-port", "7946", "--mesh-tls-cert", "/c.pem"], ["--prefill-worker", "http://p:1"],
    ["--tls-cert-path", "/c.pem", "--cb-failure-threshold", "0"],
    ["--worker", "grpc://h:1"], ["--worker", "ftp://x"], ["--worker", " "],
    ["--worker", "h:3", "--prefill-worker", "h:1", "--decode-worker", "http://h:2"],
    ["--max-concurrent-requests", "0"], ["--max-payload-size", "10"],
    ["--request-timeout-secs", "0"], ["--retry-max-retries", "-1"], ["--block-size", "12"],
    ["--balance-rel-threshold", "0.5"], ["--priority-slots", "0"],
    ["--trust-tenant-header", "--api-key", "k"],
)] + [("serve", a) for a in (
    ["--draft-model-preset", "tiny"], ["--speculative", "--draft-model-preset", "tiny"],
    ["--speculative-tier", "draft"], ["--speculative-tier", "ngram"], ["--spec-max-draft", "0"],
    ["--decode-horizon", "0"], ["--decode-horizon", "4", "--decode-horizon-max", "2"],
    ["--adaptive-horizon", "on"], ["--adaptive-horizon", "on", "--decode-horizon-max", "4"],
    ["--mesh-shape", "tp=4", "--tp", "2"], ["--mesh-shape", "tp=4", "--tp", "4"],
    ["--mesh-shape", "dp=2,tp=4"], ["--mesh-shape", "tp=4", "--dp", "2"],
    ["--mesh-shape", "bogus=2"], ["--mesh-shape", "tp=2,tp=4"], ["--mesh-shape", "tp=0"],
    ["--mesh-shape", "tp=zero"], ["--mesh-shape", "tp"], ["--mesh-shape", "tp=-1"],
)] + [("worker", a) for a in (
    [], ["--draft-model-preset", "tiny"], ["--decode-horizon", "0"],
)]


def _issues(mod, ns):
    return [(i.severity, i.field, i.message) for i in mod.validate_cli_args(ns)]


@pytest.mark.parametrize("command,argv", CASES,
                         ids=[" ".join([c, *a]) or c for c, a in CASES])
def test_validation_issues_are_the_reference_ones(command, argv):
    full = [command, *BASE[command], *argv]
    ref_ns = jcli.build_parser().parse_args(full)
    want = _issues(jval, ref_ns)
    assert _issues(tval, ref_ns) == want
    try:
        port_ns = tcli.build_parser().parse_args(full)
    except SystemExit:  # a flag the port refuses (parallelism's --mesh-shape)
        assert "--mesh-shape" in argv, argv
        return
    assert _issues(tval, port_ns) == want


def test_raise_on_errors_collects_all_and_warns():
    ns = tcli.build_parser().parse_args(["launch", "--tls-cert-path", "/c.pem",
                                         "--cb-failure-threshold", "0", "--selector", "a=b"])
    with pytest.raises(tval.ConfigError) as ei:
        tval.raise_on_errors(tval.validate_cli_args(ns))
    with pytest.raises(jval.ConfigError) as ej:
        jval.raise_on_errors(jval.validate_cli_args(ns))
    assert str(ei.value) == str(ej.value)
    assert len(ei.value.issues) == 2 and all(i.severity == "error" for i in ei.value.issues)
    warn_only = tcli.build_parser().parse_args(["launch", "--selector", "a=b"])
    tval.raise_on_errors(tval.validate_cli_args(warn_only))  # warnings do not raise


def test_gateway_config_rules():
    """``validate_gateway_config``'s cases (``tests/test_aux.py``); an
    unknown policy names the reference's policies, every one of which the
    port has."""
    for kw in (dict(policy="round_robin", workers=["h:1"]), dict(prefill_workers=["h:1"]),
               dict(workers=["ftp://x"]), dict(workers=["http://x:8000"]),
               dict(kv_connector="transfer"), dict(mesh_port=0), dict(mesh_port=65536)):
        assert ([tuple(vars(i).values()) for i in tval.validate_gateway_config(**kw)]
                == [tuple(vars(i).values()) for i in jval.validate_gateway_config(**kw)])
    [issue] = tval.validate_gateway_config(policy="nope")
    [ref] = jval.validate_gateway_config(policy="nope")
    assert (issue.severity, issue.field) == ("error", "policy")
    assert issue.message == ref.message and "'prefix_hash'" in issue.message
    for name in ("prefix_hash", "consistent_hashing"):
        assert tval.validate_gateway_config(policy=name) == []


@pytest.mark.parametrize("argv", [
    ["launch", "--tls-cert-path", "c.pem", "--port", "0"],
    ["worker", "--model-preset", "tiny", "--draft-model-preset", "tiny", "--device", "cpu"],
    ["serve", "--model-preset", "tiny", "--decode-horizon", "0", "--device", "cpu"],
], ids=["launch-tls", "worker-draft", "serve-horizon"])
def test_main_refuses_a_bad_command_line_before_starting(argv, monkeypatch):
    monkeypatch.setattr(launch, "run_command", lambda args: pytest.fail("it started"))
    with pytest.raises(tval.ConfigError):
        tcli.main(argv)


# ---- (c) _run_gateway in launch mode ----

MODEL = "tiny-launch"
BUNDLE_BOS = 7  # the worker tokenizer's BOS; the fallback's is 1


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(url: str, body=None, method=None, ctx=None, timeout=60):
    req = urllib.request.Request(url, method=method or ("POST" if body is not None else "GET"),
                                 data=None if body is None else json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout, context=ctx) as r:
            status, raw = r.status, r.read()
    except urllib.error.HTTPError as e:
        status, raw = e.code, e.read()
    try:
        return status, json.loads(raw)
    except ValueError:
        return status, raw.decode()


def _wait_http(url: str, ctx=None, timeout: float = 120.0, until=None):
    deadline = time.monotonic() + timeout
    while True:
        try:
            got = _http(url, ctx=ctx, timeout=5)
            if until is None or until(got):
                return got
        except (urllib.error.URLError, ConnectionError, TimeoutError):
            pass
        if time.monotonic() > deadline:
            raise TimeoutError(url)
        time.sleep(0.05)


class Workers:
    """A tiny port engine behind the port's gRPC server, on a loop thread;
    ``listen(port)`` adds a server on a given port."""

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        self.engine = Engine(tconf.EngineConfig(
            model=tiny_test_config(),
            cache=tconf.CacheConfig(page_size=16, num_pages=64, auto_size=False,
                                    dtype="float32"),
            scheduler=tconf.SchedulerConfig(max_batch_size=2, max_seq_len=128,
                                            max_prefill_tokens=32),
            model_id=MODEL), device="cpu",
            tokenizer=MockTokenizer(bos_token_id=BUNDLE_BOS))
        self.engine.start()
        self.servers = []

    def listen(self, port: int = 0) -> int:
        server = asyncio.run_coroutine_threadsafe(
            trpc.serve_worker_async(self.engine, port=port, host="127.0.0.1"),
            self.loop).result(60)
        self.servers.append(server)
        return server._bound_port

    def close(self):
        for s in self.servers:
            asyncio.run_coroutine_threadsafe(s.stop(grace=None), self.loop).result(30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=10)
        self.engine.stop()


@pytest.fixture(scope="module")
def workers():
    w = Workers()
    yield w
    w.close()


class Gateway:
    """``_run_gateway`` over a parsed command line, on a loop thread of its
    own; ``close`` sets its stop event and waits for it to return."""

    def __init__(self, argv: list):
        self.args = tcli.build_parser().parse_args(argv)
        tval.raise_on_errors(tval.validate_cli_args(self.args))
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        self.stop = asyncio.Event()
        self.done = asyncio.run_coroutine_threadsafe(
            launch._run_gateway(self.args, stop=self.stop), self.loop)

    def close(self) -> int:
        self.loop.call_soon_threadsafe(self.stop.set)
        try:
            return self.done.result(60)
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(timeout=10)


def _self_signed(tmp: Path) -> tuple[str, str]:
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    key = ec.generate_private_key(ec.SECP256R1())
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, "127.0.0.1")])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (x509.CertificateBuilder().subject_name(name).issuer_name(name)
            .public_key(key.public_key()).serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(days=1))
            .not_valid_after(now + datetime.timedelta(days=1)).sign(key, hashes.SHA256()))
    (tmp / "c.pem").write_bytes(cert.public_bytes(serialization.Encoding.PEM))
    (tmp / "k.pem").write_bytes(key.private_bytes(
        serialization.Encoding.PEM, serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption()))
    return str(tmp / "c.pem"), str(tmp / "k.pem")


def _insecure() -> ssl.SSLContext:
    ctx = ssl.create_default_context()
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE
    return ctx


def test_launch_registers_at_startup_with_tls_and_listeners(workers, tmp_path):
    wport = workers.listen()
    gp, hp, mp = _free_port(), _free_port(), _free_port()
    cert, key = _self_signed(tmp_path)
    gw = Gateway(["launch", "--host", "127.0.0.1", "--port", str(gp),
                  "--worker", f"127.0.0.1:{wport}", "--health-check-port", str(hp),
                  "--prometheus-port", str(mp), "--prometheus-host", "127.0.0.1",
                  "--tls-cert-path", cert, "--tls-key-path", key])
    base, tls = f"https://127.0.0.1:{gp}", _insecure()
    try:
        assert _wait_http(base + "/health", ctx=tls)[0] == 200
        # registered before the listener bound
        st, body = _http(base + "/workers", ctx=tls)
        assert st == 200 and [(w["worker_id"], w["model_id"]) for w in body["workers"]] == [
            (f"127.0.0.1:{wport}", MODEL)]
        st, wfs = _http(base + "/workflows", ctx=tls)
        [wf] = wfs["workflows"]
        assert wf["workflow_type"] == "worker_registration" and wf["status"] == "completed"
        assert wf["steps"]["tokenizer"]["status"] == "succeeded"
        assert _http(f"{base}/workflows/{wf['instance_id']}", ctx=tls) == (200, wf)
        # the gateway tokenizes with the worker's bundle
        assert _http(base + "/v1/tokenize", {"text": "w5 w6", "add_special_tokens": True},
                     ctx=tls) == (200, {"tokens": [BUNDLE_BOS, 5, 6], "count": 3})
        st, chat = _http(base + "/v1/chat/completions", {
            "model": MODEL, "messages": [{"role": "user", "content": "w5 w6 w7"}],
            "max_tokens": 4, "temperature": 0, "ignore_eos": True}, ctx=tls)
        assert st == 200 and chat["usage"]["completion_tokens"] == 4
        with pytest.raises((urllib.error.URLError, ConnectionError)):  # TLS only
            _http(f"http://127.0.0.1:{gp}/health", timeout=5)
        # the probe-only listener
        probe = f"http://127.0.0.1:{hp}"
        assert _http(probe + "/health")[0] == _http(probe + "/liveness")[0] == 200
        assert _http(probe + "/readiness") == (200, {"ready": True, "workers": 1,
                                                     "healthy": 1})
        assert _http(probe + "/v1/models")[0] == _http(probe + "/metrics")[0] == 404
        # the metrics-only listener
        st, text = _http(f"http://127.0.0.1:{mp}/metrics")
        assert st == 200 and "smg_" in text
        assert _http(f"http://127.0.0.1:{mp}/health")[0] == 404
    finally:
        assert gw.close() == 0


def test_launch_falls_back_to_the_mock_until_a_late_worker_registers(workers):
    """The worker is not up within ``--worker-startup-timeout-secs``: the
    gateway starts with the mock tokenizer, the registration keeps
    retrying, and once it lands the worker's bundle takes the default."""
    dead = _free_port()
    gp = _free_port()
    gw = Gateway(["launch", "--host", "127.0.0.1", "--port", str(gp),
                  "--worker", f"127.0.0.1:{dead}", "--worker-startup-timeout-secs", "0.5"])
    base = f"http://127.0.0.1:{gp}"
    try:
        _wait_http(base + "/health")
        assert _http(base + "/workers") == (200, {"workers": []})
        assert _http(base + "/v1/tokenize", {"text": "w5", "add_special_tokens": True}) == (
            200, {"tokens": [1, 5], "count": 2})
        [wf] = _http(base + "/workflows")[1]["workflows"]
        assert wf["status"] == "running" and wf["current_step"] == "model_info"
        workers.listen(dead)
        _wait_http(base + "/workflows", timeout=60,
                   until=lambda r: r[1]["workflows"][0]["status"] == "completed")
        assert [w["model_id"] for w in _http(base + "/workers")[1]["workers"]] == [MODEL]
        assert _http(base + "/v1/tokenize", {"text": "w5", "add_special_tokens": True}) == (
            200, {"tokens": [BUNDLE_BOS, 5], "count": 2})
        [wf] = _http(base + "/workflows")[1]["workflows"]
        assert wf["status"] == "completed" and wf["steps"]["model_info"]["attempts"] > 1
    finally:
        assert gw.close() == 0


def test_launch_tokenizes_with_the_gateway_tokenizer_path(workers, tmp_path):
    """``--gateway-tokenizer-path`` outranks the worker's bundle, which the
    registration then does not fetch."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    tok = Tokenizer(models.WordLevel({"[UNK]": 0, "hello": 5, "world": 9},
                                     unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.save(str(tmp_path / "tokenizer.json"))
    wport, gp = workers.listen(), _free_port()
    gw = Gateway(["launch", "--host", "127.0.0.1", "--port", str(gp),
                  "--worker", f"127.0.0.1:{wport}", "--gateway-tokenizer-path", str(tmp_path)])
    base = f"http://127.0.0.1:{gp}"
    try:
        _wait_http(base + "/health")
        assert _http(base + "/v1/tokenize", {"text": "hello world w5"}) == (
            200, {"tokens": [5, 9, 0], "count": 3})
        [wf] = _http(base + "/workflows")[1]["workflows"]
        assert wf["status"] == "completed"
        assert _http(base + "/v1/tokenize", {"text": "w5", "model": MODEL})[1]["tokens"] == [0]
    finally:
        assert gw.close() == 0


def test_serve_takes_worker_urls(workers):
    """``serve`` registers URL workers beside its in-process engine; its
    engine's tokenizer stays the default."""
    wport = workers.listen()
    gp = _free_port()
    gw = Gateway(["serve", "--model-preset", "tiny", "--device", "cpu", "--dtype", "float32",
                  "--max-seq-len", "128", "--max-batch-size", "2", "--host", "127.0.0.1",
                  "--port", str(gp), "--worker", f"127.0.0.1:{wport}"])
    base = f"http://127.0.0.1:{gp}"
    try:
        _wait_http(base + "/health")
        st, body = _http(base + "/workers")
        assert st == 200
        assert sorted((w["worker_id"], w["model_id"]) for w in body["workers"]) == [
            ("127.0.0.1:" + str(wport), MODEL), ("inproc-0", "tiny")]
        assert _http(base + "/v1/tokenize", {"text": "w5", "add_special_tokens": True})[1][
            "tokens"] == [1, 5]
    finally:
        assert gw.close() == 0


def test_grpc_client_settings_are_process_wide(monkeypatch):
    """``--mm-transport``, ``--mm-shm-min-bytes`` and
    ``--worker-stream-idle-timeout-secs`` reach every gRPC client as class
    attributes, as in the reference; 0 turns the idle bound off and an
    absent flag keeps the client's own."""
    from smg_tpu_torch.rpc.client import GrpcWorkerClient as C

    for name in ("mm_transport", "mm_shm_min_bytes", "idle_timeout_secs"):
        monkeypatch.setattr(C, name, getattr(C, name))
    launch.configure_grpc_clients(tcli.build_parser().parse_args(["launch"]))
    assert (C.mm_transport, C.mm_shm_min_bytes, C.idle_timeout_secs) == ("auto", 1 << 20, 120.0)
    launch.configure_grpc_clients(tcli.build_parser().parse_args([
        "launch", "--mm-transport", "shm", "--mm-shm-min-bytes", "4096",
        "--worker-stream-idle-timeout-secs", "0"]))
    assert (C.mm_transport, C.mm_shm_min_bytes, C.idle_timeout_secs) == ("shm", 4096, None)


def test_mcp_config_file_becomes_http_mcp_servers(tmp_path):
    from smg_tpu.mcp import HttpMcpServer as JaxHttpMcpServer
    from smg_tpu_torch.gateway.server import AppContext
    from smg_tpu_torch.mcp import HttpMcpServer

    specs = [{"name": "docs", "url": "http://127.0.0.1:1/mcp", "headers": {"X-Key": "k"}},
             {"url": "http://127.0.0.1:2/mcp"}]
    path = tmp_path / "mcp.json"
    path.write_text(json.dumps(specs))
    ctx = AppContext()
    asyncio.run(launch.load_mcp_config(ctx, str(path)))
    servers = [ctx.mcp._servers[n] for n in ctx.mcp.servers]
    assert all(type(s) is HttpMcpServer for s in servers)
    # the reference's _run_gateway builds each entry's server so
    ref = {s.name: s for s in (JaxHttpMcpServer(name=sp.get("name", sp["url"]), url=sp["url"],
                                                headers=sp.get("headers")) for sp in specs)}
    assert ctx.mcp.servers == sorted(ref)
    for s in servers:
        assert (s.url, s.headers) == (ref[s.name].url, ref[s.name].headers)


@pytest.mark.parametrize("command", ["launch", "serve"])
def test_unknown_storage_fails_startup_before_the_engine(command, monkeypatch):
    from smg_tpu.storage import make_storage as jax_make_storage

    monkeypatch.setattr(launch, "build_engine_from_args",
                        lambda args: pytest.fail("the engine loaded first"))
    port = _free_port()
    device = ["--device", "cpu"] if command == "serve" else []
    gw = Gateway([command, *BASE[command], *device, "--port", str(port),
                  "--storage", "nosuch://x"])
    with pytest.raises(ValueError) as got:
        gw.close()
    with pytest.raises(ValueError) as want:
        jax_make_storage("nosuch://x")
    assert str(got.value) == str(want.value) == "unknown storage spec 'nosuch://x'"
    with socket.socket() as s:  # nothing bound the gateway's port
        s.bind(("127.0.0.1", port))


# ---- (d) worker and launch as processes ----

ENGINE_FLAGS = ["--model-preset", "tiny", "--device", "cpu", "--dtype", "float32",
                "--max-seq-len", "256", "--max-batch-size", "4", "--max-prefill-tokens", "64"]
CHAT = {"model": "tiny", "messages": [{"role": "user", "content": "w5 w9 w13 w21 w34"}],
        "max_tokens": 8, "temperature": 0, "ignore_eos": True}


def _env():
    return {**os.environ, "PYTHONPATH": str(REPO)}


def _prompt_ids(tok) -> list:
    return tok.encode(tok.apply_chat_template(CHAT["messages"], add_generation_prompt=True))


def _in_process():
    """The chat, streamed and not, through an in-process gateway over the
    engine the worker command line builds, and its prompt submitted to that
    engine directly: (body, SSE text, (tokens, logprobs))."""
    from aiohttp.test_utils import TestClient, TestServer

    from smg_tpu_torch.gateway.server import build_app
    from smg_tpu_torch.protocols.sampling import SamplingParams

    engine = launch.build_engine_from_args(
        tcli.build_parser().parse_args(["serve", *ENGINE_FLAGS]))
    engine.start()

    async def go():
        ctx = launch.build_context(engine)
        tc = TestClient(TestServer(build_app(ctx)))
        await tc.start_server()
        try:
            one = await (await tc.post("/v1/chat/completions", json=CHAT)).json()
            r = await tc.post("/v1/chat/completions", json={**CHAT, "stream": True})
            return one, await r.text()
        finally:
            await tc.close()

    try:
        one, raw = asyncio.run(go())
        outs = []
        engine.submit(_prompt_ids(engine.tokenizer),
                      SamplingParams(temperature=0.0, max_new_tokens=CHAT["max_tokens"],
                                     ignore_eos=True), rid="direct", on_output=outs.append)
        deadline = time.monotonic() + 60
        while not (outs and outs[-1].finished):
            assert time.monotonic() < deadline, "the in-process engine did not finish"
            time.sleep(0.01)
        return one, raw, ([t for o in outs for t in o.new_token_ids],
                          [x for o in outs for x in o.logprobs])
    finally:
        engine.stop()


def _from_worker(port: int, ids: list) -> tuple:
    """The prompt straight to the worker process over gRPC: (tokens,
    logprobs)."""
    from smg_tpu_torch.gateway.worker_client import WorkerGenerateRequest
    from smg_tpu_torch.protocols.sampling import SamplingParams
    from smg_tpu_torch.rpc.client import GrpcWorkerClient

    async def go():
        client = GrpcWorkerClient(f"127.0.0.1:{port}")
        try:
            toks, lps = [], []
            async for c in client.generate(WorkerGenerateRequest(
                    rid="via-grpc", input_ids=ids, sampling=SamplingParams(
                        temperature=0.0, max_new_tokens=CHAT["max_tokens"], ignore_eos=True))):
                toks += c.token_ids
                lps += c.logprobs
            return toks, lps
        finally:
            await client.close()

    return asyncio.run(go())


def _stream_text(raw: str) -> str:
    return "".join(json.loads(ln[6:])["choices"][0]["delta"].get("content") or ""
                   for ln in raw.splitlines()
                   if ln.startswith("data: {") and json.loads(ln[6:]).get("choices"))


def test_worker_and_launch_processes_serve_the_in_process_chat(tmp_path):
    wport, gp = _free_port(), _free_port()
    logs = [open(tmp_path / "worker.log", "wb"), open(tmp_path / "launch.log", "wb")]
    procs = [subprocess.Popen([sys.executable, "-m", "smg_tpu_torch.cli", "worker",
                               *ENGINE_FLAGS, "--grpc-port", str(wport)],
                              cwd=REPO, env=_env(), stdout=logs[0], stderr=logs[0])]
    procs.append(subprocess.Popen([sys.executable, "-m", "smg_tpu_torch.cli", "launch",
                                   "--host", "127.0.0.1", "--port", str(gp),
                                   "--worker", f"127.0.0.1:{wport}"],
                                  cwd=REPO, env=_env(), stdout=logs[1], stderr=logs[1]))
    base = f"http://127.0.0.1:{gp}"
    try:
        want_one, want_stream, (want_toks, want_lps) = _in_process()
        _wait_http(base + "/health", timeout=120)
        assert [w["model_id"] for w in _http(base + "/workers")[1]["workers"]] == ["tiny"]
        st, one = _http(base + "/v1/chat/completions", CHAT)
        assert st == 200
        want = want_one["choices"][0]
        assert one["choices"][0]["message"] == want["message"]
        assert one["usage"] == want_one["usage"]
        # the gateways return no logprobs: the worker's, over gRPC
        ids = _prompt_ids(MockTokenizer(vocab_size=512, eos_token_id=0, bos_token_id=1))
        toks, lps = _from_worker(wport, ids)
        assert toks == want_toks and len(lps) == len(want_lps) == CHAT["max_tokens"]
        assert max(abs(a - b) for a, b in zip(lps, want_lps)) <= 1e-4
        req = urllib.request.Request(base + "/v1/chat/completions", method="POST",
                                     data=json.dumps({**CHAT, "stream": True}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            stream = r.read().decode()
        assert _stream_text(stream) == _stream_text(want_stream) == want["message"]["content"]
        assert stream.rstrip().endswith("data: [DONE]")
    finally:
        for p in reversed(procs):  # the gateway first, then the worker
            p.send_signal(signal.SIGTERM)
            try:
                p.wait(60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(10)
        for f in logs:
            f.close()
    assert [p.returncode for p in procs] == [0, 0], [
        (tmp_path / n).read_text()[-2000:] for n in ("worker.log", "launch.log")]


# ---- (e) discovery ----


class FakeApi:
    def __init__(self):
        self.pods = []
        self.closed = False

    async def list_pods(self, selector):
        return self.pods

    async def close(self):
        self.closed = True


class FakeClient:
    def __init__(self, url):
        self.url = url

    async def get_model_info(self):
        if self.url.startswith("10.0.0.9"):
            raise ConnectionError("not ready")
        return {"model_id": "m-disc"}

    async def close(self):
        pass


def _pod(name, ip, role=None, port=None, model=None, phase="Running"):
    ann = {}
    if port:
        ann["smg.ai/grpc-port"] = str(port)
    if model:
        ann["smg.ai/model-id"] = model
    return {"metadata": {"name": name, "labels": {"smg.ai/role": role} if role else {},
                         "annotations": ann},
            "status": {"podIP": ip, "phase": phase}}


def test_service_discovery_matches_the_reference():
    async def go(mod, registry_cls, role):
        registry, api = registry_cls(), FakeApi()
        disc = mod.ServiceDiscovery(registry, mod.DiscoveryConfig(default_role=role), api=api,
                                    client_factory=FakeClient)
        views = []
        for pods in (
            [_pod("w0", "10.0.0.1"), _pod("w1", "10.0.0.2", "prefill", 40001),
             _pod("w2", "10.0.0.3", "decode", model="m-ann"), _pod("w3", None),
             _pod("w4", "10.0.0.5", phase="Pending"), _pod("w5", "10.0.0.9")],
            [_pod("w0", "10.0.0.1")],
        ):
            api.pods = pods
            await disc.sync_once()
            views.append(sorted((w.worker_id, w.worker_type.value, w.url, w.model_id)
                                for w in registry.list()))
        await disc.aclose()
        return views, api.closed

    for role in ("regular", "prefill"):
        ref = asyncio.run(go(jdisc, JaxRegistry, role))
        port = asyncio.run(go(tdisc, WorkerRegistry, role))
        assert port == ref
    views, closed = port
    assert closed and views[1] == [("k8s-w0", "prefill", "10.0.0.1:30001", "m-disc")]
    assert ("k8s-w1", "prefill", "10.0.0.2:40001", "m-disc") in views[0]
    assert ("k8s-w2", "decode", "10.0.0.3:30001", "m-ann") in views[0]
    assert len(views[0]) == 3  # no IP, not running, not ready: skipped


def test_start_discovery_watches_one_group_per_role(monkeypatch):
    monkeypatch.setattr(tdisc, "KubeApi", lambda namespace=None: FakeApi())
    args = tcli.build_parser().parse_args([
        "launch", "--service-discovery", "--service-discovery-namespace", "ns1",
        "--selector", "app=w", "--selector", "tier=a", "--prefill-selector", "role=p",
        "--decode-selector", "role=d", "--service-discovery-port", "31000"])

    async def go():
        from smg_tpu_torch.gateway.server import AppContext

        ds = launch.start_discovery(AppContext(), args)
        try:
            return [(d.config.namespace, d.config.selector, d.config.default_role,
                     d.config.default_port, d._task is not None) for d in ds]
        finally:
            for d in ds:
                await d.aclose()

    assert asyncio.run(go()) == [("ns1", "app=w,tier=a", "regular", 31000, True),
                                 ("ns1", "role=p", "prefill", 31000, True),
                                 ("ns1", "role=d", "decode", 31000, True)]
