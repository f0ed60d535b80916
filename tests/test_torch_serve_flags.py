"""The rest of ``serve`` on the port, held against the JAX package on the CPU.

- (a) every ``serve`` flag the port added parses to the reference's value
  (``smg_tpu.cli.build_parser``), defaults and a set value alike; the flags
  of modules still unported are refused; the flags reach the gateway's and
  the engine's configuration;
- (b) ``prefill_mix_policy="throughput"`` and ``enable_prefix_cache=False``:
  streams, finishes, text and ``cached_tokens`` identical to the JAX
  ``Engine`` under the same configuration (a chunked prompt, a grouped
  prefill, penalties, a regex mask, a radix hit or its absence, overlap on
  and off, a page pool small enough to preempt), logprobs to 1e-4;
- (c) routing observability: the cases of ``tests/test_route_observability.py``
  run through the reference's and the port's modules, with identical
  results;
- (d) ``/debug/router`` and ``/debug/kv_index`` bodies through the port's
  gateway over a port engine equal to the reference gateway's over the JAX
  engine (times, trace ids removed);
- (e) ``/start_profile`` and ``/stop_profile``: bodies and errors equal to
  the reference's, and the port's trace written;
- (f) a breaker opened by one failure routes around its worker and closes
  after ``--cb-timeout-duration-secs``.

Float32, the tiny model with weights bridged from the JAX ``init_params``."""

import asyncio
import functools
import json
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer
from prometheus_client import generate_latest

from smg_tpu import cli as jcli
from smg_tpu.engine import config as jconf
from smg_tpu.engine.engine import Engine as JaxEngine
from smg_tpu.faults import FAULTS as JFAULTS
from smg_tpu.gateway import kv_events as jkv
from smg_tpu.gateway import observability as jobs
from smg_tpu.gateway import server as jserver
from smg_tpu.gateway import worker_client as jwc
from smg_tpu.gateway import workers as jworkers
from smg_tpu.kv_index import native as jnative
from smg_tpu.kv_index.positional import chain_hash as jchain_hash
from smg_tpu.models.config import tiny_test_config
from smg_tpu.models.registry import get_model
from smg_tpu import policies as jpolicies
from smg_tpu.protocols import events as jevents
from smg_tpu.protocols.sampling import SamplingParams as JaxSamplingParams
from smg_tpu.tokenizer import MockTokenizer as JaxMockTokenizer
from smg_tpu_torch import cli as tcli
from smg_tpu_torch import policies as tpolicies
from smg_tpu_torch.engine import config as tconf
from smg_tpu_torch.engine.engine import Engine, collect_result
from smg_tpu_torch.faults import FAULTS as TFAULTS
from smg_tpu_torch.gateway import kv_events as tkv
from smg_tpu_torch.gateway import observability as tobs
from smg_tpu_torch.gateway import server as tserver
from smg_tpu_torch.gateway import worker_client as twc
from smg_tpu_torch.gateway import workers as tworkers
from smg_tpu_torch.gateway.launch import build_engine_from_args, gateway_options
from smg_tpu_torch.kv_index import native as tnative
from smg_tpu_torch.kv_index.positional import chain_hash as tchain_hash
from smg_tpu_torch.models.config import tiny_test_config as port_tiny
from smg_tpu_torch.models.convert import params_from_jax
from smg_tpu_torch.protocols import events as tevents
from smg_tpu_torch.protocols.sampling import SamplingParams
from smg_tpu_torch.tokenizer import MockTokenizer

torch.set_num_threads(2)
PAGE, BUDGET = 16, 64

# ---- (a) flags ----

#: (flag, a value other than the default; None for a switch)
NEW_FLAGS = [
    ("--max-payload-size", "1024"), ("--request-id-headers", "X-Trace-Id"),
    ("--cache-threshold", "0.3"), ("--balance-abs-threshold", "7"),
    ("--balance-rel-threshold", "2.5"), ("--max-tree-size", "1000"),
    ("--block-size", "32"), ("--enable-igw", None),
    ("--retry-max-retries", "5"), ("--retry-initial-backoff-ms", "50"),
    ("--retry-max-backoff-ms", "900"), ("--disable-retries", None),
    ("--cb-failure-threshold", "1"), ("--cb-success-threshold", "3"),
    ("--cb-timeout-duration-secs", "0.5"), ("--disable-circuit-breaker", None),
    ("--health-check-interval-secs", "2.5"), ("--health-check-timeout-secs", "1.5"),
    ("--health-failure-threshold", "4"), ("--health-success-threshold", "5"),
    ("--disable-health-check", None), ("--prefill-mix-policy", "throughput"),
    ("--metrics-window-secs", "12"), ("--device-metrics-interval-secs", "0"),
    ("--flight-recorder", "off"), ("--flight-dump-dir", "dumps"),
    ("--flight-dump-min-interval-secs", "1.5"), ("--kv-connector", "host"),
    # the worker URLs, TLS, multimodal transport, discovery and the metrics
    # listener, taken since ``launch`` came
    ("--worker", "http://w"), ("--prefill-worker", "x"), ("--decode-worker", "x"),
    ("--tls-cert-path", "c"), ("--mm-transport", "shm"), ("--selector", "a=b"),
    ("--service-discovery", None), ("--prometheus-port", "9"),
    # the Responses API's conversation storage and MCP servers
    ("--storage", "sqlite:conv.db"), ("--mcp-config-path", "m.json"),
    # the hashing and DP-rank routing policies
    ("--prefix-token-count", "8"), ("--no-dp-aware", None),
    # the plugin host
    ("--plugins", "p.py"), ("--plugin-fail-closed", None),
    # the HA mesh
    ("--mesh-port", "7946"), ("--mesh-seed", "h:1"), ("--mesh-tls-cert", "c"),
    ("--mesh-tls-key", "k"), ("--mesh-tls-ca", "a"),
    # tensor parallelism
    ("--tp", "2"), ("--tensor-parallel-size", "4"), ("--mesh-shape", "tp=2"),
    # pipeline, sequence and expert parallelism
    ("--pp", "2"), ("--sp", "2"), ("--ep", "2"),
]
#: flags of modules not ported yet (ROADMAP Queue A lists them by item)
REFUSED = [["--dp", "2"]]
BASE = ["serve", "--model-preset", "tiny"]


def _both(extra):
    return (vars(jcli.build_parser().parse_args(BASE + extra)),
            vars(tcli.build_parser().parse_args(BASE + extra)))


@pytest.mark.parametrize("flag,value", NEW_FLAGS, ids=[f for f, _ in NEW_FLAGS])
def test_new_flag_parses_to_the_reference_value(flag, value):
    ref, port = _both([])
    extra = [flag] if value is None else [flag, value]
    ref_set, port_set = _both(extra)
    changed = [k for k in ref_set if ref_set[k] != ref[k]]
    assert len(changed) == 1, changed
    dest = changed[0]
    assert port[dest] == ref[dest]  # the default
    assert port_set[dest] == ref_set[dest] and type(port_set[dest]) is type(ref_set[dest])


def test_every_port_flag_has_the_reference_dest_and_default():
    ref, port = _both([])
    assert set(port) <= set(ref) | {"device"}
    for k, v in port.items():
        if k not in ("device", "dtype"):  # the port's own defaults
            assert v == ref[k], k


@pytest.mark.parametrize("argv", REFUSED, ids=[a[0] for a in REFUSED])
def test_flags_of_unported_modules_are_refused(argv):
    jcli.build_parser().parse_args(BASE + argv)  # the reference takes it
    with pytest.raises(SystemExit):
        tcli.build_parser().parse_args(BASE + argv)


def test_flags_reach_the_gateway_and_the_engine():
    args = tcli.build_parser().parse_args(BASE + [
        "--device", "cpu", "--dtype", "float32", "--retry-max-retries", "5",
        "--retry-initial-backoff-ms", "50", "--retry-max-backoff-ms", "900",
        "--cb-failure-threshold", "1", "--cb-success-threshold", "3",
        "--cb-timeout-duration-secs", "0.5", "--health-check-interval-secs", "2.5",
        "--health-failure-threshold", "4", "--cache-threshold", "0.3",
        "--balance-abs-threshold", "7", "--max-tree-size", "1000", "--block-size", "32",
        "--request-id-headers", "X-Trace-Id", "--prefill-mix-policy", "throughput",
        "--metrics-window-secs", "12", "--device-metrics-interval-secs", "0",
        "--flight-recorder", "off", "--max-batch-size", "4", "--kv-connector", "device"])
    ctx = tserver.AppContext(**gateway_options(args))
    rc = ctx.router.config
    assert (rc.max_retries, rc.retry_backoff_base, rc.retry_backoff_max) == (5, 0.05, 0.9)
    assert rc.kv_connector == "device"
    assert ctx.registry.circuit_breaker_config == (1, 3, 0.5)
    hc = ctx.health_monitor.config
    assert (hc.interval_secs, hc.failure_threshold) == (2.5, 4)
    pol = ctx.policies.policy_for(None)
    assert (pol.match_threshold, pol.imbalance_abs, pol.tree.max_size,
            pol.indexer.page_size) == (0.3, 7, 1000, 32)
    assert ctx.request_id_headers == ["X-Trace-Id"]
    off = tcli.build_parser().parse_args(BASE + ["--disable-retries",
                                                 "--disable-circuit-breaker",
                                                 "--disable-health-check"])
    ctx = tserver.AppContext(**gateway_options(off))
    assert ctx.router.config.max_retries == 0
    assert ctx.router.config.kv_connector == "auto"
    assert ctx.registry.circuit_breaker_config[0] == 10**9
    assert ctx.health_monitor.config.interval_secs == 1e9
    engine = build_engine_from_args(args)
    assert engine.config.scheduler.prefill_mix_policy == "throughput"
    assert engine.metrics.window.window_secs == 12
    assert engine.scheduler.flight is None
    assert engine.dump_flight()["error"] == "flight recorder disabled"


# ---- (b) throughput mix policy and the prefix cache off ----


class CharTokenizer:
    """One character per token; id 0 EOS, 1 BOS."""

    ALPHABET = list('{}[]":, 0123456789abcxyz')
    vocab_size, eos_token_id, bos_token_id = 512, 0, 1

    def decode(self, ids, skip_special_tokens=True):
        return "".join(self.ALPHABET[t - 2] if 0 <= t - 2 < len(self.ALPHABET) else "\x00"
                       for t in ids if t not in (0, 1))


@functools.lru_cache(maxsize=1)
def jax_params():
    cfg = tiny_test_config()
    return get_model(cfg.arch).init_params(cfg, jax.random.PRNGKey(0))


SCHED = dict(max_batch_size=8, max_seq_len=256, max_prefill_tokens=BUDGET,
             decode_horizon=4)


def jax_engine(num_pages=128, **kw) -> JaxEngine:
    return JaxEngine(jconf.EngineConfig(
        model=tiny_test_config(),
        cache=jconf.CacheConfig(page_size=PAGE, num_pages=num_pages, auto_size=False,
                                dtype="float32"),
        scheduler=jconf.SchedulerConfig(**{**SCHED, "prefill_token_buckets": (16, 32, 64),
                                           "decode_batch_buckets": (8,), **kw}),
        dtype="float32"), tokenizer=CharTokenizer(), params=jax_params())


def port_engine(num_pages=128, **kw) -> Engine:
    return Engine(tconf.EngineConfig(
        model=port_tiny(),
        cache=tconf.CacheConfig(page_size=PAGE, num_pages=num_pages, auto_size=False,
                                dtype="float32"),
        scheduler=tconf.SchedulerConfig(**{**SCHED, "decode_batch_buckets": (2, 4, 8),
                                           **kw})),
        params=params_from_jax(jax.tree.map(np.asarray, jax_params())), device="cpu",
        tokenizer=CharTokenizer())


def drive(engine, jobs, max_steps=3000) -> dict:
    """Submit ``jobs`` = [(rid, prompt, kwargs)] together and step inline:
    rid -> (tokens, text, finish, cached_tokens, logprobs)."""
    cls = JaxSamplingParams if isinstance(engine, JaxEngine) else SamplingParams
    chunks = {rid: [] for rid, _, _ in jobs}
    for rid, prompt, kw in jobs:
        engine.submit(prompt, cls(**kw), rid=rid, on_output=chunks[rid].append)
    for _ in range(max_steps):
        if not engine.scheduler.has_work():
            break
        engine.step()
    else:
        raise TimeoutError("jobs stuck")
    out = {}
    for rid, c in chunks.items():
        r = collect_result(rid, c)
        out[rid] = (r.token_ids, r.text, r.finish_reason, r.cached_tokens, r.logprobs)
    return out


def g(n, **kw):
    return dict(temperature=0.0, max_new_tokens=n, ignore_eos=True, **kw)


_rng = np.random.default_rng(0)
SHARED = _rng.integers(2, 500, 48).tolist()
WAVES = [
    [("long", _rng.integers(2, 500, 150).tolist(), g(10)),  # 3 chunks of 64
     ("s1", SHARED + [7, 8, 9], g(8)),
     ("s2", _rng.integers(2, 500, 20).tolist(), g(8)),
     ("pen", _rng.integers(2, 500, 30).tolist(),
      g(10, frequency_penalty=0.5, presence_penalty=0.3)),
     ("rx", [5, 7, 9], dict(temperature=0.0, max_new_tokens=12, regex=r"[a-c]+[0-9]{2,3}"))],
    [("hit", SHARED + [11, 12], g(9))],  # a radix hit on the finished "s1"
]
# four lanes of 40 prompt + 40 new tokens, 5 pages each; 12 in the pool
PRESSURE = [(f"p{i}", list(range(5 + 17 * i, 45 + 17 * i)),
             g(40, frequency_penalty=0.6, repetition_penalty=1.2)) for i in range(4)]
PRESSURE_KW = dict(num_pages=13, max_batch_size=4, watermark_pages=1, max_seq_len=128)
CONFIGS = {"throughput": dict(prefill_mix_policy="throughput"),
           "prefix_off": dict(enable_prefix_cache=False)}


@functools.lru_cache(maxsize=None)
def reference(name: str, pressure: bool = False) -> dict:
    if pressure:
        return drive(jax_engine(**PRESSURE_KW, **CONFIGS[name]), PRESSURE)
    je, out = jax_engine(**CONFIGS[name]), {}
    for wave in WAVES:
        out.update(drive(je, wave))
    return out


def assert_same(got: dict, want: dict) -> None:
    assert {r: v[:4] for r, v in got.items()} == {r: v[:4] for r, v in want.items()}
    for rid in want:
        np.testing.assert_allclose(got[rid][4], want[rid][4], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "sync"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_streams_match_jax_engine(name, overlap):
    te = port_engine(overlap_schedule=overlap, **CONFIGS[name])
    got = {}
    for wave in WAVES:
        got.update(drive(te, wave))
    want = reference(name)
    assert_same(got, want)
    hit = want["hit"][3]
    assert hit == 0 if name == "prefix_off" else hit > 0
    assert te.audit()["clean"] and te.audit()["leaked_pages"] == 0
    if name == "prefix_off":
        assert te.scheduler.radix is None and te.loads()["cached_pages"] == 0
    else:  # the long prompt's chunks ran back to back in one step
        assert te.runner.stats["prefill_calls"] >= 3


@pytest.mark.parametrize("name", list(CONFIGS))
def test_preemption_matches_jax_engine(name):
    te = port_engine(**PRESSURE_KW, **CONFIGS[name])
    assert_same(drive(te, PRESSURE), reference(name, pressure=True))
    assert te.scheduler.num_preemptions > 0 and te.audit()["clean"]


def test_throughput_keeps_no_lookahead_across_an_admission():
    """The fold-free predicate under throughput: a lookahead survives only
    a step with nothing waiting."""
    te = port_engine(prefill_mix_policy="throughput")
    s = te.scheduler
    assert s._prefill_phase_fold_free()
    te.submit([5, 6, 7], SamplingParams(**g(4)))
    assert not s._prefill_phase_fold_free()


# ---- (c) routing observability: the reference's cases through both ----


class _Mods:
    def __init__(self, obs, pol, wc, workers, kv, events, chain, faults):
        self.Metrics, self.policies, self.wc, self.workers = obs.Metrics, pol, wc, workers
        self.kv, self.events, self.chain_hash, self.FAULTS = kv, events, chain, faults


MODS = {"ref": _Mods(jobs, jpolicies, jwc, jworkers, jkv, jevents, jchain_hash, JFAULTS),
        "port": _Mods(tobs, tpolicies, twc, tworkers, tkv, tevents, tchain_hash, TFAULTS)}


class FakeWorker:
    def __init__(self, worker_id, model_id="m"):
        self.worker_id, self.model_id, self.load, self.healthy = worker_id, model_id, 0, True

    def is_available(self):
        return True


def _scrub(obj):
    """Drop what differs between two runs (times, random ids).  Both
    gateways' cache-aware trees are native, so the tree's counts compare
    whole."""
    if isinstance(obj, dict):
        return {k: _scrub(v) for k, v in obj.items()
                if k not in ("ts", "decision_us", "trace_id", "request_id")}
    if isinstance(obj, list):
        return [_scrub(v) for v in obj]
    return obj


def _metric_lines(m, prefixes) -> list:
    return sorted(ln for ln in generate_latest(m.registry).decode().splitlines()
                  if ln.startswith(prefixes) and "_created" not in ln
                  and "smg_route_decision_seconds" not in ln)


def case_ring_and_counts(M):
    m = M.Metrics()
    m.route.ring_size = 8
    for i in range(100):
        m.route.record(M.policies.RouteDecision(policy="round_robin", model_id="m",
                                                chosen=f"w{i % 4}", outcome="round_robin"))
    for mid in ("a", "b"):
        for _ in range(5):
            m.route.record(M.policies.RouteDecision(policy="cache_aware", model_id=mid,
                                                    chosen="w0", outcome="prefix_hit"))
    body = m.route.debug_router(limit=3)
    assert body["num_decisions"] == 110 and body["models"]["m"]["window"] == 8
    assert all(set(d) == set(M.policies.DECISION_KEYS)
               for ring in body["models"].values() for d in ring["decisions"])
    return (_scrub(body), _scrub(m.route.debug_router(model="ghost")),
            _metric_lines(m, ("smg_route_decisions",)))


def case_reconcile(M):
    m = M.Metrics()
    route = m.route

    def dec(predicted, policy="cache_aware"):
        d = M.policies.RouteDecision(policy=policy, model_id="m", chosen="w0",
                                     outcome="prefix_hit", predicted_match_tokens=predicted)
        route.record(d)
        return d

    route.reconcile(dec(64), "w0", 64)
    route.reconcile(dec(128), "w0", 64)
    d = dec(0)
    route.reconcile(d, "w0", 32)
    route.reconcile(d, "w0", 999)  # idempotent
    no_pred = M.policies.RouteDecision(policy="manual", chosen="w1")
    route.reconcile(no_pred, "w1", 50)
    for _ in range(10):
        route.reconcile(M.policies.RouteDecision(policy="cache_aware",
                                                 predicted_match_tokens=100), "w2", 0)
    body = route.debug_router()
    assert body["reconciliation"]["w0"]["count"] == 3 and "w1" not in body["reconciliation"]
    assert body["reconciliation"]["w2"]["staleness"] > 0.5
    lines = _metric_lines(m, ("smg_route_reconciliations", "smg_route_index_staleness",
                              "smg_route_prediction"))
    p = M.policies.get_policy("round_robin")
    p._decision_sink = route
    p.on_worker_removed("w0")
    after = route.debug_router()
    assert "w0" not in after["reconciliation"]
    return _scrub(body), lines, _scrub(after)


def _event_gateway(M, page_size=4):
    registry = M.workers.WorkerRegistry()
    policies = M.policies.PolicyRegistry(default="cache_aware", mode="event",
                                         match_threshold=0.25, page_size=page_size, seed=0)
    metrics = M.Metrics()
    metrics.route.watch(policies)
    monitor = M.kv.KvEventMonitor(registry, policies, metrics=metrics)
    return registry, policies, metrics, monitor


def _event_client(M, fail=False):
    class EventClient(M.wc.WorkerClient):
        callback = None

        def subscribe_kv_events(self, callback):
            if fail:
                raise RuntimeError("event stream unavailable")
            self.callback = callback
            return lambda: None

    return EventClient()


def _stored(M, tokens, page_size=4, seq=1):
    hashes, parent = [], 0
    for i in range(len(tokens) // page_size):
        parent = M.chain_hash(parent, tuple(tokens[i * page_size:(i + 1) * page_size]))
        hashes.append(parent)
    return M.events.KvEventBatch(sequence_number=seq, events=[M.events.BlockStored(
        block_hashes=hashes, token_ids=list(tokens), block_size=page_size)])


def case_kv_event_health(M):
    registry, _, metrics, monitor = _event_gateway(M)
    registry.add(M.workers.Worker(worker_id="w0", client=_event_client(M, fail=True),
                                  model_id="m", page_size=4))
    failed = (sorted(monitor.degraded),
              _metric_lines(metrics, ("smg_kv_event_subscribe", "smg_kv_event_degraded")))
    registry.remove("w0")
    w1 = _event_client(M)
    registry.add(M.workers.Worker(worker_id="w1", client=w1, model_id="m", page_size=4))
    w1.callback(_stored(M, list(range(8))))
    registry.add(M.workers.Worker(worker_id="w2", client=_event_client(M), model_id="m",
                                  page_size=8))
    assert monitor.degraded == {"w2"}
    return failed, sorted(monitor.degraded), _metric_lines(
        metrics, ("smg_kv_event_degraded", "smg_cache_index"))


def case_stale_index(M):
    registry, policies, metrics, _ = _event_gateway(M)
    client = _event_client(M)
    registry.add(M.workers.Worker(worker_id="w0", client=client, model_id="m", page_size=4))
    policy = policies.policy_for("m")
    tokens = list(range(16))
    M.FAULTS.arm("gateway.kv_event", mode="always")
    try:
        client.callback(_stored(M, tokens))  # dropped: the index stays empty
    finally:
        M.FAULTS.clear()
    ctx = M.policies.RequestContext(model_id="m", token_ids=tokens)
    _, d1 = policy.select([FakeWorker("w0")], ctx)
    metrics.route.reconcile(d1, "w0", 16)
    client.callback(_stored(M, tokens, seq=2))
    _, d2 = policy.select([FakeWorker("w0")], ctx)
    metrics.route.reconcile(d2, "w0", 16)
    body = metrics.route.debug_router()
    assert d1.predicted_match_tokens == 0 and d2.outcome == "prefix_hit"
    assert body["reconciliation"]["w0"]["under"] == 1
    tree = M.policies.PolicyRegistry(default="cache_aware", mode="approx_token")
    m2 = M.Metrics()
    m2.route.watch(tree)
    tree.policy_for(None).select([FakeWorker("w0")],
                                 M.policies.RequestContext(token_ids=list(range(32))))
    # elements and inserts: neither native tree reports node or eviction
    # counts
    return (_scrub(body), _metric_lines(metrics, ("smg_cache_index",)),
            _metric_lines(m2, ("smg_cache_tree_elements", "smg_cache_inserted")))


@pytest.mark.parametrize("case", [case_ring_and_counts, case_reconcile, case_kv_event_health,
                                  case_stale_index], ids=lambda f: f.__name__[5:])
def test_route_observability_matches_reference(case):
    assert case(MODS["port"]) == case(MODS["ref"])


# ---- (d), (e) the debug and profile routes against the reference gateway ----


NATIVE_WAIT_S = 120.0  # a concurrent build of a native radix library, at most


def _await_native_trees():
    """Both packages' native radix libraries loaded before either gateway
    builds its cache-aware tree.  The reference builds
    ``csrc/libsmg_native.so`` with ``make`` at its first load, and another
    test process's first load may be writing it: a load of the file half
    written fails ("file too short") and that tree falls back to the Python
    tree, whose node and eviction counts the native one does not report.
    Each loader retries at its next call, so wait for the build to end."""
    deadline = time.monotonic() + NATIVE_WAIT_S
    while not (jnative.native_available() and tnative.native_available()):
        assert time.monotonic() < deadline, "a native radix library did not load"
        time.sleep(0.2)


def _run_pair(fn):
    """``fn(client, side)`` on a reference gateway over the JAX engine and
    on the port's over a port engine, in turn on one private loop, both
    cache-aware trees native."""
    _await_native_trees()
    loop = asyncio.new_event_loop()
    out = {}
    try:
        for side in ("ref", "port"):
            out[side] = loop.run_until_complete(_on_gateway(side, fn))
    finally:
        loop.close()
    return out["ref"], out["port"]


@functools.lru_cache(maxsize=1)
def _engines():
    je = jax_engine(max_prefill_tokens=BUDGET)
    je.config.model_id = "tiny-test"
    te = port_engine()
    te.config.model_id = "tiny-test"
    te.tokenizer = MockTokenizer(vocab_size=512)
    je.tokenizer = JaxMockTokenizer()
    return je, te


async def _on_gateway(side, fn):
    je, te = _engines()
    srv, wc, workers = ((jserver, jwc, jworkers) if side == "ref"
                        else (tserver, twc, tworkers))
    engine = je if side == "ref" else te
    engine.flush_cache()
    ctx = srv.AppContext(policy="cache_aware",
                         policy_kwargs={"mode": "event", "match_threshold": 0.05,
                                        "page_size": PAGE, "seed": 0})
    tok = JaxMockTokenizer() if side == "ref" else MockTokenizer(vocab_size=512)
    ctx.tokenizers.register("tiny-test", tok, default=True)
    ctx.registry.add(workers.Worker(worker_id="w0", client=wc.InProcWorkerClient(engine),
                                    model_id="tiny-test", page_size=PAGE))
    tc = TestClient(TestServer(srv.build_app(ctx)))
    await tc.start_server()
    try:
        return await fn(tc, side)
    finally:
        await tc.close()
        ctx.registry.remove("w0")
        engine.stop()


def test_debug_router_and_kv_index_match_reference():
    prompt = " ".join(f"w{i + 2} t{i}" for i in range(24))

    async def fn(tc, side):
        for _ in range(2):  # the second dispatch hits the engine's prefix cache
            resp = await tc.post("/v1/chat/completions", json={
                "model": "tiny-test", "messages": [{"role": "user", "content": prompt}],
                "max_tokens": 2, "temperature": 0, "ignore_eos": True})
            assert resp.status == 200, await resp.text()
        out = {}
        for path in ("/debug/router?limit=16", "/debug/kv_index", "/debug/router?limit=zap",
                     "/debug/kv_index?drift_ratio=x"):
            resp = await tc.get(path)
            out[path] = (resp.status, _scrub(await resp.json()))
        return out

    ref, port = _run_pair(fn)
    assert port == ref
    body = port["/debug/router?limit=16"][1]
    last = [d for d in body["models"]["tiny-test"]["decisions"] if d["reconciled"]][-1]
    assert last["predicted_match_tokens"] > 0 and last["worker_cached_tokens"] > 0
    audit = port["/debug/kv_index"][1]["audit"]
    assert audit and audit[0]["worker_cached_pages"] > 0


def test_profile_routes_match_reference(tmp_path):
    async def fn(tc, side):
        out_dir = str(tmp_path / side)
        steps = []
        for method, path, body in (
                ("post", "/stop_profile", None),  # not running
                ("post", "/start_profile", {"output_dir": out_dir}),
                ("post", "/start_profile", {"output_dir": out_dir}),  # already running
                ("post", "/stop_profile", None)):
            resp = await getattr(tc, method)(path, json=body)
            text = (await resp.json())
            text = json.loads(json.dumps(text).replace(out_dir, "<dir>"))
            steps.append((resp.status, text))
        return steps

    ref, port = _run_pair(fn)
    assert port == ref
    assert [s for s, _ in port] == [503, 200, 503, 200]
    traces = list(Path(tmp_path / "port").glob("trace-*.json"))
    assert len(traces) == 1 and json.loads(traces[0].read_text())["traceEvents"]


def test_engine_profile_stops_itself_after_num_steps(tmp_path):
    te = port_engine()
    te.start_profile(str(tmp_path), num_steps=2)
    with pytest.raises(RuntimeError, match="already running"):
        te.start_profile(str(tmp_path))
    drive(te, [("a", list(range(5, 25)), g(12))])
    assert te._profiler is None and len(list(tmp_path.glob("trace-*.json"))) == 1
    with pytest.raises(RuntimeError, match="not running"):
        te.stop_profile()


# ---- (f) breakers from the CLI ----


def test_breaker_from_the_cli_opens_and_closes():
    args = tcli.build_parser().parse_args(BASE + ["--cb-failure-threshold", "1",
                                                  "--cb-timeout-duration-secs", "0.3",
                                                  "--retry-initial-backoff-ms", "1",
                                                  "--policy", "round_robin"])

    class Scripted(twc.WorkerClient):
        def __init__(self, fail):
            self.fail, self.calls = fail, 0

        async def generate(self, req):
            self.calls += 1
            if self.fail:
                raise RuntimeError("decode fault")
            yield twc.WorkerStreamChunk(rid=req.rid, token_ids=[7], finished=True,
                                        finish_reason="length", prompt_tokens=3,
                                        output_tokens=1)

        async def abort(self, rid):
            return True

        async def health(self):
            return True

    async def go():
        ctx = tserver.AppContext(**gateway_options(args))
        ctx.tokenizers.register("m", MockTokenizer(), default=True)
        bad, good = Scripted(True), Scripted(False)
        for wid, c in (("bad", bad), ("good", good)):
            ctx.registry.add(tworkers.Worker(worker_id=wid, client=c, model_id="m"))
        tc = TestClient(TestServer(tserver.build_app(ctx)))
        await tc.start_server()
        try:
            async def complete():
                resp = await tc.post("/v1/completions", json={
                    "model": "m", "prompt": "w5 w6 w7", "max_tokens": 1})
                return resp.status

            statuses = [await complete() for _ in range(4)]
            state = ctx.registry.get("bad").circuit.state.value
            calls = bad.calls
            await asyncio.sleep(0.35)
            half = ctx.registry.get("bad").circuit.state.value
            bad.fail = False
            for _ in range(4):
                await complete()
            return statuses, state, calls, half, ctx.registry.get("bad").circuit.state.value
        finally:
            await tc.close()

    statuses, state, calls, half, closed = asyncio.run(go())
    assert statuses == [200] * 4  # failover to the good worker
    assert state == "open" and calls == 1  # one failure opened it; routed around since
    assert half == "half_open" and closed == "closed"


def test_max_payload_size_caps_the_body_as_the_reference():
    async def go(srv, argv):
        ctx = srv.AppContext()
        tc = TestClient(TestServer(srv.build_app(ctx, client_max_size=argv.max_payload_size)))
        await tc.start_server()
        try:
            out = []
            for n in (10, 2000):
                resp = await tc.post("/v1/chat/completions", json={
                    "model": "m", "messages": [{"role": "user", "content": "w5 " * n}]})
                out.append((resp.status, (await resp.json())["error"]["message"][:60]))
            return out
        finally:
            await tc.close()

    extra = ["--max-payload-size", "1024"]
    got = asyncio.run(go(tserver, tcli.build_parser().parse_args(BASE + extra)))
    want = asyncio.run(go(jserver, jcli.build_parser().parse_args(BASE + extra)))
    assert got == want and got[1] == (400, "invalid request: Request Entity Too Large")
