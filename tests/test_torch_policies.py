"""The routing policies the port took last, held against the JAX package's
on the CPU.

- ``prefix_hash`` and ``consistent_hashing`` (``policies/hashing.py``):
  one seeded script of requests (routing keys, texts, token ids with shared
  prefixes) over the same worker ids, a worker removed and another added,
  through ``smg_tpu.policies`` and ``smg_tpu_torch.policies``: identical
  picks and identical decision records on ``DECISION_KEYS`` (times
  removed), including the reference's minimal-disruption case;
- ``DpLoadManager``, ``MinimumTokensPolicy`` and ``PassthroughDpPolicy``
  (``policies/dp.py``): the case of ``tests/test_rpc.py``
  (``test_dp_load_manager_and_min_token_policy``) through both packages;
- the native radix index (``kv_index/native.py``, built here with ``g++``
  from the port's own copy of the sources): a seeded insert, match and
  remove script gives the Python tree's and the reference's native tree's
  results; the port never loads the reference's library; concurrent builds
  into an empty directory leave one library; ``SMG_NATIVE_RADIX=0`` and a
  missing compiler give the Python tree with the reference's warning;
  ``cache_aware`` routes over the native tree;
- DP ranks across the two packages: the port's gateway, built from
  ``launch --dp-aware``, in front of the reference's gRPC server hosting two
  tiny JAX engines (``dp_size`` 2) sends the rank sequence the reference's
  gateway sends for the same requests, and ``--no-dp-aware`` sends -1.

Run: ``python -m pytest tests/test_torch_policies.py -q``."""

import asyncio
import logging
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from smg_tpu import policies as jpolicies
from smg_tpu.kv_index import native as jnative
from smg_tpu.kv_index.radix_tree import RadixTree as JaxRadixTree
from smg_tpu.policies import dp as jdp
from smg_tpu_torch import policies as tpolicies
from smg_tpu_torch.kv_index import native as tnative
from smg_tpu_torch.kv_index.radix_tree import RadixTree
from smg_tpu_torch.policies import dp as tdp

PKGS = {"ref": (jpolicies, jdp), "port": (tpolicies, tdp)}


class FakeWorker:
    def __init__(self, worker_id, load=0):
        self.worker_id, self.model_id, self.load, self.healthy = worker_id, "m", load, True

    def is_available(self):
        return True


# ---- prefix_hash and consistent_hashing ----


def _script(seed: int) -> list:
    """(worker ids, RequestContext fields) per request: routing keys, texts
    and token ids, some sharing a prefix, over 4 workers; then w3 removed;
    then w4 added."""
    rng = np.random.default_rng(seed)
    shared = [int(t) for t in rng.integers(0, 50000, 300)]
    reqs = []
    for i in range(60):
        kind = i % 4
        if kind == 0:
            ctx = {"routing_key": f"user-{rng.integers(0, 12)}"}
        elif kind == 1:
            ctx = {"text": " ".join(f"w{t}" for t in rng.integers(0, 500, rng.integers(1, 40)))}
        elif kind == 2:
            n = int(rng.integers(1, 300))
            ctx = {"token_ids": shared[:n] + [int(t) for t in rng.integers(0, 50000, 5)]}
        else:
            ctx = {"token_ids": [int(t) for t in rng.integers(0, 50000, rng.integers(1, 80))]}
        reqs.append(ctx)
    four, three, five = (["w0", "w1", "w2", "w3"], ["w0", "w1", "w2"],
                         ["w0", "w1", "w2", "w4", "w3"])
    return ([(four, c) for c in reqs] + [(three, c) for c in reqs]
            + [(five, c) for c in reqs] + [(four, {})])


def _decision(d) -> dict:
    rec = d.to_dict()
    assert set(rec) == set(tpolicies.DECISION_KEYS)
    return {k: v for k, v in rec.items() if k not in ("ts", "decision_us")}


def _route(pkg, name: str, kw: dict, script) -> list:
    policies = pkg[0]
    pol = policies.get_policy(name, **kw)
    out = []
    for ids, ctx in script:
        worker, decision = pol.select([FakeWorker(w) for w in ids],
                                      policies.RequestContext(model_id="m", **ctx))
        out.append((worker.worker_id if worker else None, _decision(decision)))
    return out


@pytest.mark.parametrize("name,kw", [("consistent_hashing", {}),
                                     ("consistent_hashing", {"vnodes": 7}),
                                     ("prefix_hash", {}), ("prefix_hash", {"prefix_tokens": 8})],
                         ids=["consistent_hashing", "consistent_hashing-7vnodes",
                              "prefix_hash", "prefix_hash-8"])
def test_hashing_policy_picks_and_decisions_match_reference(name, kw):
    script = _script(16)
    got = {side: _route(pkg, name, kw, script) for side, pkg in PKGS.items()}
    assert got["port"] == got["ref"]
    assert len({w for w, _ in got["port"]}) >= 3  # the script spreads over workers


@pytest.mark.parametrize("side", ["ref", "port"])
def test_consistent_hashing_stable_and_minimal_disruption(side):
    """The reference's case (``tests/test_policies.py``), in both packages."""
    policies = PKGS[side][0]
    p = policies.get_policy("consistent_hashing")
    ws = [FakeWorker(f"w{i}") for i in range(4)]
    keys = [f"key-{i}" for i in range(50)]
    pick = lambda ws, k: p.select_worker(ws, policies.RequestContext(routing_key=k)).worker_id  # noqa: E731
    before = {k: pick(ws, k) for k in keys}
    assert {k: pick(ws, k) for k in keys} == before
    after = {k: pick(ws[:3], k) for k in keys}  # w3 removed
    assert sum(1 for k in keys if before[k] != after[k] and before[k] != "w3") == 0
    assert any(before[k] == "w3" for k in keys)


def test_prefix_hash_same_prefix_same_worker():
    for policies, _dp in PKGS.values():
        p = policies.get_policy("prefix_hash", prefix_tokens=4)
        ws = [FakeWorker(f"w{i}") for i in range(4)]
        a = p.select_worker(ws, policies.RequestContext(token_ids=[1, 2, 3, 4, 99]))
        b = p.select_worker(ws, policies.RequestContext(token_ids=[1, 2, 3, 4, 42, 77]))
        assert a.worker_id == b.worker_id


def test_policy_registry_names_match_reference():
    from smg_tpu.policies.base import _POLICIES as J
    from smg_tpu_torch.policies.base import _POLICIES as T

    assert sorted(T) == sorted(J)


# ---- DP-rank policies ----


def _dp_case(dp) -> list:
    class W:
        worker_id = "w1"
        dp_size = 3

    class W1:
        worker_id = "w2"
        dp_size = 1

    pol = dp.MinimumTokensPolicy()
    w = W()
    out = [pol.select_dp_rank(w, 100), pol.select_dp_rank(w, 10), pol.select_dp_rank(w, 10),
           pol.select_dp_rank(w, 10), pol.manager.loads("w1", 3)]
    pol.release(w, 0, 100)
    out += [pol.select_dp_rank(w, 5), pol.select_dp_rank(W1(), 50)]
    mgr = dp.DpLoadManager()
    mgr.seed("w3", [1000, 0])
    out.append(mgr.select_and_increment_lowest("w3", 2, 10))
    # the poll subtracts the gateway's own in-flight share from the base
    mgr.seed("w3", [1000, 40])
    out += [mgr.loads("w3", 2), mgr.select_and_increment_lowest("w3", 2, 1)]
    mgr.on_worker_removed("w3")
    out += [mgr.loads("w3", 2), dp.PassthroughDpPolicy().select_dp_rank(w, 10),
            pol.name, dp.PassthroughDpPolicy.name]
    return out


def test_dp_load_manager_and_min_token_policy_match_reference():
    got = {side: _dp_case(pkg[1]) for side, pkg in PKGS.items()}
    assert got["port"] == got["ref"]
    assert got["port"][:8] == [0, 1, 2, 1, [100, 20, 10], 0, None, 1]


# ---- the native radix index ----


def _tree_script(tree, seed: int) -> list:
    """Inserts with shared prefixes over four workers, matches, a worker
    removed, more matches; returns every match and the size."""
    import random

    rng = random.Random(seed)
    seqs, out = [], []
    for _ in range(300):
        base = (seqs[rng.randrange(len(seqs))][: rng.randrange(1, 20)]
                if seqs and rng.random() < 0.5 else [])
        seq = base + [rng.randrange(64) for _ in range(rng.randrange(1, 30))]
        seqs.append(seq)
        tree.insert(seq, f"w{rng.randrange(4)}")
    for _ in range(150):
        out.append(tree.prefix_match(seqs[rng.randrange(len(seqs))] + [rng.randrange(64)]))
    tree.remove_worker("w1")
    for _ in range(80):
        out.append(tree.prefix_match(seqs[rng.randrange(len(seqs))]))
    for text in ("hello world", "hello there", "help"):
        tree.insert(text, "w2")
    out += [tree.prefix_match("hello world!"), tree.prefix_match("hex")]
    return out


def test_native_tree_equals_python_and_reference_native_trees():
    assert tnative.native_available(), "g++ builds the port's index here"
    assert jnative.native_available(), "the reference's index builds here too"
    port = tnative.NativeRadixTree()
    runs = {name: _tree_script(tree, 3) for name, tree in (
        ("port_native", port), ("port_python", RadixTree()),
        ("ref_native", jnative.NativeRadixTree()), ("ref_python", JaxRadixTree()))}
    assert runs["port_native"] == runs["port_python"] == runs["ref_native"] == runs["ref_python"]
    assert port.stats() == {"elements": port.size, "nodes": None, "evicted_elements": None,
                            "max_size": None}
    lib = tnative._load_lib()
    assert lib._name.startswith(str(tnative.BUILD_DIR)) and "/csrc/" not in lib._name


def test_concurrent_builds_leave_one_library(tmp_path, monkeypatch):
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "_build")
    with ThreadPoolExecutor(4) as pool:
        paths = list(pool.map(lambda _: tnative.build(), range(4)))
    assert len(set(paths)) == 1 and paths[0].exists()
    assert sorted(p.name for p in (tmp_path / "_build").iterdir()) == sorted(
        [paths[0].name, "libsmg_radix.lock"])
    import ctypes

    assert ctypes.CDLL(str(paths[0])).rt_size  # a whole library loads


@pytest.mark.parametrize("way", ["env", "no_compiler"])
def test_python_tree_fallback_with_the_reference_warning(way, tmp_path, monkeypatch):
    monkeypatch.setattr(tnative, "_lib", None)
    if way == "env":
        monkeypatch.setenv("SMG_NATIVE_RADIX", "0")
    else:
        monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "_build")
        monkeypatch.setenv("CXX", "no-such-compiler")
    records: list = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = records.append
    log = logging.getLogger("smg_tpu_torch.kv_index.native")
    log.addHandler(handler)
    try:
        tree = tnative.make_radix_tree(100)
    finally:
        log.removeHandler(handler)
    assert type(tree) is RadixTree and tree.max_size == 100
    warned = [r.getMessage() for r in records if "native radix" in r.getMessage()]
    if way == "env":
        assert warned == []
    else:
        assert warned == ["native radix build failed (no C++ compiler (g++ or $CXX) on "
                          "PATH); using Python tree"]


def test_cache_aware_routes_over_the_native_tree():
    pol = tpolicies.get_policy("cache_aware", mode="approx_token", match_threshold=0.3, seed=0)
    assert type(pol.tree) is tnative.NativeRadixTree
    ws = [FakeWorker(f"w{i}") for i in range(4)]
    prefix = list(range(100))
    first = pol.select_worker(ws, tpolicies.RequestContext(token_ids=prefix))
    for i in range(5):
        again = pol.select_worker(ws, tpolicies.RequestContext(token_ids=prefix + [200 + i]))
        assert again.worker_id == first.worker_id


# ---- DP ranks across the packages ----


@pytest.fixture(scope="module")
def dp_server():
    """The reference's gRPC server over two tiny JAX engines, recording the
    ``data_parallel_rank`` of every generate it receives."""
    from smg_tpu.engine.config import CacheConfig, EngineConfig, SchedulerConfig
    from smg_tpu.engine.engine import Engine as JaxEngine
    from smg_tpu.models.config import tiny_test_config
    from smg_tpu.rpc import server as jserver
    from smg_tpu.tokenizer import MockTokenizer

    def engine():
        return JaxEngine(EngineConfig(
            model=tiny_test_config(),
            cache=CacheConfig(page_size=16, num_pages=128, auto_size=False, dtype="float32"),
            scheduler=SchedulerConfig(max_batch_size=4, max_seq_len=128, max_prefill_tokens=64,
                                      prefill_token_buckets=(32, 64), decode_batch_buckets=(4,)),
            dtype="float32", model_id="tiny-dp"), tokenizer=MockTokenizer())

    ranks: list = []
    orig = jserver.SchedulerServicer._engine_for

    def recording(self, rank):
        ranks.append(rank)
        return orig(self, rank)

    jserver.SchedulerServicer._engine_for = recording
    loop = asyncio.new_event_loop()
    t = threading.Thread(target=loop.run_forever, daemon=True)
    t.start()
    engines = [engine(), engine()]
    for e in engines:
        e.start()
    server = asyncio.run_coroutine_threadsafe(jserver.serve_worker_async(
        None, port=0, host="127.0.0.1", engines=engines), loop).result(120)
    try:
        yield f"127.0.0.1:{server._bound_port}", ranks
    finally:
        jserver.SchedulerServicer._engine_for = orig
        asyncio.run_coroutine_threadsafe(server.stop(grace=None), loop).result(30)
        loop.call_soon_threadsafe(loop.stop)
        for e in engines:
            e.stop()


#: (prompt words, max_tokens) of the requests, opened one after another
#: while the earlier ones still stream: their costs steer the min-token pick
DP_REQUESTS = [(20, 6), (4, 4), (10, 5), (3, 4), (12, 6)]


async def _gateway_ranks(side: str, url: str, dp_aware: bool) -> None:
    """Register the server through ``side``'s registration workflow (model
    info reports ``dp_size`` 2), then open every request's completion
    stream in turn, each one's first chunk read before the next opens, and
    drain them all."""
    if side == "port":
        from smg_tpu_torch import cli
        from smg_tpu_torch.gateway.launch import gateway_options, register_worker
        from smg_tpu_torch.gateway.server import AppContext
        from smg_tpu_torch.gateway.workers import WorkerType
        from smg_tpu_torch.protocols.openai import CompletionRequest

        args = cli.build_parser().parse_args(
            ["launch", "--policy", "round_robin", "--dp-aware" if dp_aware else "--no-dp-aware"])
        ctx = AppContext(**gateway_options(args))
        await register_worker(ctx, url, WorkerType.REGULAR, fetch_bundle=True, timeout=60)
    else:
        from smg_tpu.gateway.registration import WORKER_REGISTRATION
        from smg_tpu.gateway.router import RouterConfig
        from smg_tpu.gateway.server import AppContext
        from smg_tpu.protocols.openai import CompletionRequest

        ctx = AppContext(policy="round_robin", router_config=RouterConfig(
            dp_rank_policy="dp_min_token" if dp_aware else "dp_passthrough"))
        iid = await ctx.workflows.start(WORKER_REGISTRATION, {
            "url": url, "worker_type": "regular", "skip_tokenizer": False})
        await ctx.workflows.wait(iid, timeout=60)
    [worker] = ctx.registry.list()
    assert worker.dp_size == 2
    streams = []
    try:
        for i, (words, n) in enumerate(DP_REQUESTS):
            req = CompletionRequest(model="tiny-dp", prompt=" ".join(f"w{5 + (i + j) % 90}"
                                                                     for j in range(words)),
                                    max_tokens=n, temperature=0.0, stream=True)
            agen = ctx.router.completion_stream(req)
            await agen.__anext__()
            streams.append(agen)
        for agen in streams:
            async for _ in agen:
                pass
    finally:
        for w in ctx.registry.list():
            await w.client.close()


@pytest.mark.parametrize("dp_aware", [True, False], ids=["dp-aware", "no-dp-aware"])
def test_dp_rank_sequence_matches_reference_gateway(dp_server, dp_aware):
    url, ranks = dp_server
    got = {}
    for side in ("ref", "port"):
        ranks.clear()
        asyncio.run(_gateway_ranks(side, url, dp_aware))
        got[side] = list(ranks)
    assert got["port"] == got["ref"]
    if dp_aware:
        assert len(got["port"]) == len(DP_REQUESTS) and set(got["port"]) == {0, 1}
    else:
        assert got["port"] == [-1] * len(DP_REQUESTS)
