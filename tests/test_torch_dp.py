"""Data-parallel replicas in one gRPC worker, held against the reference.

``smg_tpu_torch.rpc.server.serve_worker_async(engines=[e0, e1])`` over two
tiny port engines, and ``smg_tpu.rpc.server.serve_worker_async`` over two
tiny JAX engines with the same weights (``params_from_jax`` of one
``init_params``).  Both packages' ``GrpcWorkerClient`` run against both
servers (four pairs), on the reference's ``dp_rpc`` cases
(``tests/test_rpc.py``) and the rest of the servicer's replica handling:

- ``dp_size`` 2 and two idle ``dp_queued_tokens``;
- a pinned rank reaches that replica (read from the replicas' own prompt
  counters): identical tokens and finishes on every pair and rank;
- with a long stream running on rank 0, a -1 request lands on rank 1, and
  ``GetLoads`` shows two ranks, the busy one queued;
- an out-of-range rank gets the reference's error text;
- an abort of a rank-1 stream: ``ok`` and every page back on that replica;
- ``HealthCheck`` with one replica unhealthy, ``FlushCache``, and the
  flight dump's ``dp_size`` wrapper;
- the port's ``launch --dp-aware`` gateway in front of the port's server
  sends the rank sequence the reference's gateway sends in front of the
  reference's server; ``--no-dp-aware`` sends -1.

Float32 on the CPU."""

import asyncio
import threading
import time

import jax
import numpy as np
import pytest
import torch

from smg_tpu.engine import config as jconf
from smg_tpu.engine.engine import Engine as JaxEngine
from smg_tpu.gateway import worker_client as jwc
from smg_tpu.models.config import tiny_test_config
from smg_tpu.protocols.sampling import SamplingParams as JaxSamplingParams
from smg_tpu.rpc import client as jclient
from smg_tpu.rpc import server as jserver
from smg_tpu.tokenizer import MockTokenizer as JaxMockTokenizer
from smg_tpu_torch.engine import config as tconf
from smg_tpu_torch.engine.engine import Engine
from smg_tpu_torch.gateway import worker_client as twc
from smg_tpu_torch.models.config import tiny_test_config as port_tiny
from smg_tpu_torch.models.convert import params_from_jax
from smg_tpu_torch.protocols.sampling import SamplingParams
from smg_tpu_torch.rpc import client as tclient
from smg_tpu_torch.rpc import server as tserver
from smg_tpu_torch.tokenizer import MockTokenizer
from test_torch_policies import DP_REQUESTS, _gateway_ranks
from test_torch_rpc import _jparams

torch.set_num_threads(2)
MODEL = "tiny-dp"  # the model id test_torch_policies' gateway requests name
SCHED = dict(max_batch_size=4, max_seq_len=128, max_prefill_tokens=64,
             decode_batch_buckets=(4,))
PROMPT = list(range(5, 25))
LONG = 100  # new tokens of a stream that is still running when the next request comes
SERVERS = {"port": tserver, "ref": jserver}
# a client's side: (client module, worker-client module, sampling class)
CLIENTS = {"port": (tclient, twc, SamplingParams), "ref": (jclient, jwc, JaxSamplingParams)}
PAIRS = [(c, s) for c in CLIENTS for s in SERVERS]


def jax_engine() -> JaxEngine:
    return JaxEngine(jconf.EngineConfig(
        model=tiny_test_config(),
        cache=jconf.CacheConfig(page_size=16, num_pages=128, auto_size=False, dtype="float32"),
        scheduler=jconf.SchedulerConfig(prefill_token_buckets=(32, 64), **SCHED),
        dtype="float32", model_id=MODEL), params=_jparams(), tokenizer=JaxMockTokenizer())


def port_engine() -> Engine:
    return Engine(tconf.EngineConfig(
        model=port_tiny(),
        cache=tconf.CacheConfig(page_size=16, num_pages=128, auto_size=False, dtype="float32"),
        scheduler=tconf.SchedulerConfig(**SCHED), model_id=MODEL),
        params=params_from_jax(jax.tree.map(np.asarray, _jparams())), device="cpu",
        tokenizer=MockTokenizer())


class Dp:
    """Both two-replica servers and a client of each side for each, on one
    private loop thread; ``ranks[server]`` records the
    ``data_parallel_rank`` of every generate that server picks a replica
    for."""

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        self.ranks = {s: [] for s in SERVERS}
        self._orig = {s: mod.SchedulerServicer._engine_for for s, mod in SERVERS.items()}
        for s, mod in SERVERS.items():
            mod.SchedulerServicer._engine_for = self._recording(s)
        self.engines = {"port": [port_engine(), port_engine()],
                        "ref": [jax_engine(), jax_engine()]}
        for es in self.engines.values():
            for e in es:
                e.start()
        self.servers = {s: self.run(SERVERS[s].serve_worker_async(
            None, port=0, host="127.0.0.1", engines=self.engines[s])) for s in SERVERS}
        self.urls = {s: f"127.0.0.1:{srv._bound_port}" for s, srv in self.servers.items()}

        async def dial():  # a channel binds to the loop that creates it
            return {(c, s): CLIENTS[c][0].GrpcWorkerClient(self.urls[s]) for c, s in PAIRS}

        self.clients = self.run(dial())

    def _recording(self, side):
        orig = self._orig[side]

        def recording(servicer, rank):
            self.ranks[side].append(rank)
            return orig(servicer, rank)

        return recording

    def run(self, coro, timeout=120):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout=timeout)

    def each(self, fn) -> dict:
        """(client side, server side) -> fn(client, client side, server side)."""
        return {(c, s): self.run(fn(self.clients[c, s], c, s)) for c, s in PAIRS}

    def close(self):
        try:
            for client in self.clients.values():
                self.run(client.close())
            for srv in self.servers.values():
                self.run(srv.stop(grace=None))
        finally:
            for s, mod in SERVERS.items():
                mod.SchedulerServicer._engine_for = self._orig[s]
            for es in self.engines.values():
                for e in es:
                    e.stop()
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(timeout=10)


@pytest.fixture(scope="module")
def dp():
    d = Dp()
    yield d
    d.close()


def req(client_side, rid, rank, ids=PROMPT, max_new_tokens=4):
    _, wc, sp = CLIENTS[client_side]
    return wc.WorkerGenerateRequest(
        rid=rid, input_ids=list(ids), data_parallel_rank=rank,
        sampling=sp(temperature=0.0, max_new_tokens=max_new_tokens, ignore_eos=True))


def fields(chunks) -> list:
    return [(c.token_ids, c.finished, c.finish_reason, c.prompt_tokens, c.cached_tokens,
             c.output_tokens) for c in chunks]


def admitted(engines) -> list:
    """Each replica's prompt tokens admitted so far (cached and computed)."""
    out = []
    for e in engines:
        loads = e.loads(include_audit=False)
        out.append(loads["cached_prompt_tokens"] + loads["computed_prompt_tokens"])
    return out


async def settle(engines, timeout=60.0) -> list:
    """Wait until every replica is quiescent; their audits."""
    deadline = time.monotonic() + timeout
    while True:
        audits = [e.audit() for e in engines]
        if all(a["quiescent"] for a in audits):
            return audits
        assert time.monotonic() < deadline, f"a replica still has work: {audits}"
        await asyncio.sleep(0.01)


def assert_all_equal(out: dict):
    first = next(iter(out.values()))
    assert all(v == first for v in out.values()), out


def test_dp_model_info_reports_dp_size(dp):
    async def go(client, c, s):
        return await client.get_model_info(), await client.get_loads()

    out = dp.each(go)
    assert_all_equal(out)
    info, loads = out["port", "port"]
    assert info["dp_size"] == 2 and info["model_id"] == MODEL
    assert loads["dp_queued_tokens"] == [0, 0] and loads["total_pages"] == 2 * 128


@pytest.mark.parametrize("rank", [0, 1])
def test_dp_pinned_rank_routes_to_that_replica(dp, rank):
    async def go(client, c, s):
        await client.flush_cache()  # every pair starts from a cold prefix cache
        before = admitted(dp.engines[s])
        chunks = [ch async for ch in client.generate(req(c, f"dp-{rank}-{c}", rank))]
        await settle(dp.engines[s])
        moved = [a - b for a, b in zip(admitted(dp.engines[s]), before)]
        return fields(chunks), moved

    out = dp.each(go)
    assert_all_equal(out)
    chunks, moved = out["port", "port"]
    assert sum(len(t) for t, *_ in chunks) == 4 and chunks[-1][2] == "length"
    want = [0, 0]
    want[rank] = len(PROMPT)
    assert moved == want


def test_dp_tokens_equal_across_ranks(dp):
    async def go(client, c, s):
        toks = []
        for rank in (0, 1, -1):
            await client.flush_cache()
            toks.append([t for ch in [x async for x in client.generate(
                req(c, f"eq-{rank}", rank, max_new_tokens=8))] for t in ch.token_ids])
        return toks

    out = dp.each(go)
    assert_all_equal(out)
    toks = out["ref", "port"]
    assert toks[0] == toks[1] == toks[2] and len(toks[0]) == 8


def test_dp_min_tokens_pick_beside_a_busy_replica(dp):
    async def go(client, c, s):
        await client.flush_cache()
        long = client.generate(req(c, f"long-{c}", 0, max_new_tokens=LONG))
        first = await long.__anext__()
        loads = await client.get_loads()
        before = admitted(dp.engines[s])
        short = [ch async for ch in client.generate(req(c, f"pick-{c}", -1, ids=PROMPT[:12]))]
        moved = [a - b for a, b in zip(admitted(dp.engines[s]), before)]
        ok = await client.abort(f"long-{c}")
        await long.aclose()
        await settle(dp.engines[s])
        busy = dict(n_ranks=len(loads["dp_queued_tokens"]),
                    queued=[q > 0 for q in loads["dp_queued_tokens"]],
                    running=loads["num_running"], total_pages=loads["total_pages"])
        return bool(first.token_ids), busy, fields(short), moved, ok

    out = dp.each(go)
    assert_all_equal(out)
    got_first, busy, short, moved, ok = out["port", "ref"]
    assert got_first and ok
    assert busy == dict(n_ranks=2, queued=[True, False], running=1, total_pages=256)
    assert moved == [0, 12] and short[-1][2] == "length"


@pytest.mark.parametrize("rank", [2, 7])
def test_dp_out_of_range_rank_is_an_error(dp, rank):
    async def go(client, c, s):
        try:
            async for _ in client.generate(req(c, f"bad-{rank}", rank)):
                pass
        except RuntimeError as e:
            return str(e)
        return None

    out = dp.each(go)
    assert_all_equal(out)
    assert f"data_parallel_rank {rank} out of range (dp_size 2)" in out["port", "port"]


def test_dp_abort_on_rank_1_frees_its_pages(dp):
    async def go(client, c, s):
        it = client.generate(req(c, f"abort-{c}", 1, max_new_tokens=LONG))
        first = await it.__anext__()
        held = dp.engines[s][1].audit()["held_pages"]
        ok = await client.abort(f"abort-{c}")
        await it.aclose()
        audits = await settle(dp.engines[s])
        return (bool(first.token_ids), held > 0, ok,
                [(a["held_pages"], a["quiescent"], a["clean"]) for a in audits])

    out = dp.each(go)
    assert_all_equal(out)
    assert out["port", "port"] == (True, True, True, [(0, True, True), (0, True, True)])


def test_dp_health_is_every_replica_healthy(dp):
    async def go(client, c, s):
        eng = dp.engines[s][1]
        eng.scheduler.consec_step_failures = eng.config.max_consecutive_step_failures
        try:
            sick = await client.health()
        finally:
            eng.scheduler.consec_step_failures = 0
        return sick, await client.health()

    out = dp.each(go)
    assert_all_equal(out)
    assert out["ref", "ref"] == (False, True)


def test_dp_flush_cache_flushes_every_replica(dp):
    async def go(client, c, s):
        for rank in (0, 1):
            async for _ in client.generate(req(c, f"fill-{rank}", rank)):
                pass
        await settle(dp.engines[s])
        cached = [e.loads(include_audit=False)["cached_pages"] > 0 for e in dp.engines[s]]
        ok = await client.flush_cache()
        return cached, ok, (await client.get_loads())["cached_pages"]

    out = dp.each(go)
    assert_all_equal(out)
    assert out["port", "port"] == ([True, True], True, 0)


def test_dp_flight_dump_wraps_every_replica(dp):
    async def go(client, c, s):
        dump = await client.dump_flight(reason="dp-test")
        return (sorted(dump), dump["dp_size"], dump["schema_version"], len(dump["engines"]),
                [sorted(d) == sorted(dump["engines"][0]) for d in dump["engines"]])

    out = dp.each(go)
    assert_all_equal(out)
    assert out["port", "port"][:2] == (["dp_size", "engines", "schema_version"], 2)


@pytest.mark.parametrize("dp_aware", [True, False], ids=["dp-aware", "no-dp-aware"])
def test_dp_rank_sequence_through_each_gateway(dp, dp_aware):
    """Each package's gateway in front of its own package's two-replica
    server: the same ranks on the wire."""
    got = {}
    for side in SERVERS:
        dp.ranks[side].clear()
        asyncio.run(_gateway_ranks(side, dp.urls[side], dp_aware))
        got[side] = list(dp.ranks[side])
        dp.run(settle(dp.engines[side]))
    assert got["port"] == got["ref"]
    if dp_aware:
        assert len(got["port"]) == len(DP_REQUESTS) and set(got["port"]) == {0, 1}
    else:
        assert got["port"] == [-1] * len(DP_REQUESTS)
