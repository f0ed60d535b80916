"""The port's gRPC worker against the reference's, in pairs (the non-DP
cases of the reference's ``tests/test_rpc.py``).

Each case runs twice, crosswise: the port's ``GrpcWorkerClient`` against
the reference's server over a JAX engine, and the reference's client
against the port's server over a port engine (the same bridged weights,
configuration and ``MockTokenizer``).  Streams, loads, model info, errors,
KV events and the tokenizer bundle must come out identical (logprobs to
1e-4).  Then PD over gRPC: a prefill leg on one implementation and the
decode leg on the other give a co-located run's tokens; the KV's bytes and
``kv_dtype`` on the wire equal the reference's numpy encoding for float32
and bf16.  Last, ``python -m smg_tpu_torch.cli worker --device cpu``
answers ``HealthCheck``.  The DP cases, over two replicas a worker, are in
``test_torch_dp.py``.

Float32 on the CPU, the tiny model with weights bridged from the JAX
``init_params``."""

import asyncio
import io
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from smg_tpu.engine import config as jconf
from smg_tpu.engine.engine import Engine as JaxEngine
from smg_tpu.faults import FAULTS as JFAULTS
from smg_tpu.gateway import worker_client as jwc
from smg_tpu.models.config import tiny_test_config
from smg_tpu.models.lora import empty_adapter
from smg_tpu.models.registry import get_model
from smg_tpu.protocols.sampling import SamplingParams as JaxSamplingParams
from smg_tpu.rpc import client as jclient
from smg_tpu.rpc import server as jserver
from smg_tpu.tokenizer import MockTokenizer as JaxMockTokenizer
from smg_tpu.tokenizer import bundle as jbundle
from smg_tpu_torch.engine import config as tconf
from smg_tpu_torch.engine.engine import Engine
from smg_tpu_torch.faults import FAULTS as TFAULTS
from smg_tpu_torch.gateway import worker_client as twc
from smg_tpu_torch.models.config import tiny_test_config as port_tiny
from smg_tpu_torch.models.convert import params_from_jax
from smg_tpu_torch.protocols.sampling import SamplingParams
from smg_tpu_torch.rpc import client as tclient
from smg_tpu_torch.rpc import server as tserver
from smg_tpu_torch.rpc.convert import kv_from_wire, kv_to_wire
from smg_tpu_torch.tokenizer import MockTokenizer
from smg_tpu_torch.tokenizer import bundle as tbundle

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
MODEL = "tiny-rpc"
SCHED = dict(max_batch_size=4, max_seq_len=128, max_prefill_tokens=64,
             decode_batch_buckets=(4,))
PROMPT = list(range(5, 25))


def jax_params():
    cfg = tiny_test_config()
    return get_model(cfg.arch).init_params(cfg, jax.random.PRNGKey(0))


JAX_PARAMS = None


def _jparams():
    global JAX_PARAMS
    if JAX_PARAMS is None:
        JAX_PARAMS = jax_params()
    return JAX_PARAMS


def jax_engine(**sched) -> JaxEngine:
    return JaxEngine(jconf.EngineConfig(
        model=tiny_test_config(),
        cache=jconf.CacheConfig(page_size=16, num_pages=128, auto_size=False, dtype="float32"),
        scheduler=jconf.SchedulerConfig(prefill_token_buckets=(32, 64), **{**SCHED, **sched}),
        dtype="float32", model_id=MODEL), params=_jparams(), tokenizer=JaxMockTokenizer())


def port_engine(kv_dtype: str = "float32", **sched) -> Engine:
    return Engine(tconf.EngineConfig(
        model=port_tiny(),
        cache=tconf.CacheConfig(page_size=16, num_pages=128, auto_size=False, dtype=kv_dtype),
        scheduler=tconf.SchedulerConfig(**{**SCHED, **sched}), model_id=MODEL),
        params=params_from_jax(jax.tree.map(np.asarray, _jparams())), device="cpu",
        tokenizer=MockTokenizer())


# (client module, server module, worker-client module, sampling class, FAULTS)
# for each direction; the engine behind the server is the server's side's
SIDES = {
    "port-client/ref-server": (tclient, jserver, twc, SamplingParams, JFAULTS),
    "ref-client/port-server": (jclient, tserver, jwc, JaxSamplingParams, TFAULTS),
}


class Pair:
    """Both directions on one private loop thread."""

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        self.engines = {"port-client/ref-server": jax_engine(),
                        "ref-client/port-server": port_engine()}
        self.servers, self.clients = {}, {}
        for side, engine in self.engines.items():
            engine.start()
            self.servers[side], self.clients[side] = self.run(self.dial(side, engine))

    def run(self, coro, timeout=120):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout=timeout)

    async def dial(self, side, engine):
        client_mod, server_mod = SIDES[side][:2]
        server = await server_mod.serve_worker_async(engine, port=0, host="127.0.0.1")
        return server, client_mod.GrpcWorkerClient(f"127.0.0.1:{server._bound_port}")

    def both(self, fn):
        """side -> fn(client, side) run on the loop."""
        return {side: self.run(fn(self.clients[side], side)) for side in SIDES}

    def close(self):
        for side in SIDES:
            self.run(self.clients[side].close())
            self.run(self.servers[side].stop(grace=None))
            self.engines[side].stop()
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=10)


@pytest.fixture(scope="module")
def pair():
    p = Pair()
    yield p
    p.close()


def req(side, rid, ids=PROMPT, **kw):
    wc, sp_cls = SIDES[side][2], SIDES[side][3]
    timeout = kw.pop("timeout_secs", None)
    return wc.WorkerGenerateRequest(rid=rid, input_ids=list(ids), sampling=sp_cls(**kw),
                                    timeout_secs=timeout)


def chunk_fields(chunks) -> list:
    return [(c.rid, c.token_ids, c.finished, c.finish_reason, c.matched_stop,
             c.prompt_tokens, c.cached_tokens, c.output_tokens) for c in chunks]


def assert_same(out: dict):
    a, b = out.values()
    assert a == b, out


def test_model_info_and_health(pair):
    async def go(client, side):
        return await client.get_model_info(), await client.health()

    out = pair.both(go)
    assert out["ref-client/port-server"][0]["supports_kv_transfer"] is True
    assert_same(out)
    info, ok = out["ref-client/port-server"]
    assert info["model_id"] == MODEL and info["page_size"] == 16 and ok is True
    assert info["dp_size"] == 1


def test_generate_stream_over_grpc(pair):
    async def go(client, side):
        return [c async for c in client.generate(req(
            side, "rpc-1", temperature=0.0, max_new_tokens=6, ignore_eos=True))]

    out = pair.both(go)
    assert_same({k: chunk_fields(v) for k, v in out.items()})
    a, b = ([x for c in v for x in c.logprobs] for v in out.values())
    np.testing.assert_allclose(a, b, atol=1e-4)
    chunks = out["ref-client/port-server"]
    assert chunks[-1].finished and chunks[-1].finish_reason == "length"
    assert sum(len(c.token_ids) for c in chunks) == 6 and chunks[-1].prompt_tokens == 20


def test_loads_over_grpc(pair):
    async def go(client, side):
        return await client.get_loads()

    out = pair.both(go)
    assert_same(out)
    assert out["ref-client/port-server"]["total_pages"] == 128
    assert out["ref-client/port-server"]["num_running"] == 0


def test_kv_events_over_grpc(pair):
    async def go(client, side):
        batches, got = [], asyncio.Event()

        def cb(batch):
            batches.append(batch)
            got.set()

        unsub = client.subscribe_kv_events(cb)
        async for _ in client.generate(req(side, "rpc-kv", range(40, 80), temperature=0.0,
                                           max_new_tokens=4, ignore_eos=True)):
            pass
        await asyncio.wait_for(got.wait(), timeout=10)
        await asyncio.sleep(0.2)  # let the batch of this request's finish land
        unsub()
        return [(type(e).__name__, getattr(e, "token_ids", None), getattr(e, "block_size", None))
                for b in batches for e in b.events]

    out = pair.both(go)
    assert_same(out)
    stored = [e for e in out["ref-client/port-server"] if e[0] == "BlockStored"]
    assert stored and stored[0][2] == 16


def test_abort_over_grpc(pair):
    async def go(client, side):
        it = client.generate(req(side, "rpc-abort", temperature=0.0, max_new_tokens=100,
                                 ignore_eos=True))
        first = await it.__anext__()
        ok = await client.abort("rpc-abort")
        await it.aclose()
        return bool(first.token_ids), ok

    out = pair.both(go)
    assert_same(out)
    assert out["ref-client/port-server"] == (True, True)


def test_flush_cache_over_grpc(pair):
    async def go(client, side):
        return await client.flush_cache()

    out = pair.both(go)
    assert_same(out)
    assert out["ref-client/port-server"] is True


def test_lora_rpcs_over_grpc(pair):
    cfg = tiny_test_config()
    rng = np.random.default_rng(5)
    w = empty_adapter(cfg, rank=4)
    for pr in ("wq", "wk", "wv", "wo"):
        w[f"{pr}_a"] = rng.normal(0, 0.5, w[f"{pr}_a"].shape).astype(np.float32)
        w[f"{pr}_b"] = rng.normal(0, 0.5, w[f"{pr}_b"].shape).astype(np.float32)
    buf = io.BytesIO()
    np.savez(buf, **w)

    async def go(client, side):
        async def toks(rid, **kw):
            return [t async for c in client.generate(req(
                side, rid, temperature=0.0, max_new_tokens=5, ignore_eos=True, **kw))
                for t in c.token_ids]

        base = await toks("lora-base")
        r = await client.load_lora_adapter("wire-adapter", data=buf.getvalue())
        names = await client.list_lora_adapters()
        adapted = await toks("lora-on", lora_adapter="wire-adapter")
        un = await client.unload_lora_adapter("wire-adapter")
        return base, r["ok"], r["slot"], names, adapted, un

    out = pair.both(go)
    assert_same(out)
    base, ok, _, names, adapted, un = out["ref-client/port-server"]
    assert ok and "wire-adapter" in names and adapted != base and un["ok"]


def test_get_tokenizer_bundle_over_grpc(pair, tmp_path):
    async def go(client, side):
        tok = await client.get_tokenizer()
        return type(tok).__name__, tok.encode("w5 w6"), tok.decode([7, 8])

    out = pair.both(go)
    assert_same(out)
    assert out["ref-client/port-server"] == ("MockTokenizer", [5, 6], "w7 w8")
    # the bundle bytes themselves: the mock descriptor, and an HF directory
    assert tbundle.make_bundle(MockTokenizer()) == jbundle.make_bundle(JaxMockTokenizer())
    from tokenizers import Tokenizer, models, pre_tokenizers

    from smg_tpu.tokenizer.hf import HFTokenizer as JHF
    from smg_tpu_torch.tokenizer.hf import HFTokenizer as THF

    tk = Tokenizer(models.WordLevel({f"w{i}": i for i in range(64)} | {"[UNK]": 64},
                                    unk_token="[UNK]"))
    tk.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    tk.save(str(tmp_path / "tokenizer.json"))
    data, fmt, sha = tbundle.make_bundle(THF(str(tmp_path)))
    assert (data, fmt, sha) == jbundle.make_bundle(JHF(str(tmp_path))) and fmt == "zip"
    for load in (tbundle.load_bundle, jbundle.load_bundle):
        assert load(data, fmt, sha).encode("w3 w9") == [3, 9]
    with pytest.raises(ValueError, match="sha256 mismatch"):
        tbundle.load_bundle(data, fmt, "0" * 64)


# ---- failure isolation over the wire ----


def test_deadline_rides_the_proto_and_times_out(pair):
    async def go(client, side):
        chunks = [c async for c in client.generate(req(
            side, "deadline-1", temperature=0.0, max_new_tokens=100_000, ignore_eos=True,
            timeout_secs=0.05))]
        return chunks[-1].finished, chunks[-1].finish_reason

    out = pair.both(go)
    assert_same(out)
    assert out["ref-client/port-server"] == (True, "timeout")


@pytest.mark.parametrize("side", list(SIDES))
def test_queue_full_maps_to_resource_exhausted(pair, side):
    """Engine QueueFullError -> RESOURCE_EXHAUSTED -> the client's
    WorkerQueueFullError."""
    client_mod, server_mod, wc, sp_cls, _ = SIDES[side]
    make = jax_engine if server_mod is jserver else port_engine
    engine = make(max_queued_requests=1)
    # never started and full: every submit is refused
    engine.submit([1, 2, 3], (JaxSamplingParams if make is jax_engine else SamplingParams)(
        max_new_tokens=2), rid="filler")
    server, client = pair.run(pair.dial(side, engine))
    try:
        async def go():
            async for _ in client.generate(wc.WorkerGenerateRequest(
                    rid="q1", input_ids=[4, 5, 6], sampling=sp_cls(max_new_tokens=2))):
                pass

        with pytest.raises(wc.WorkerQueueFullError):
            pair.run(go())
    finally:
        pair.run(client.close())
        pair.run(server.stop(grace=None))
        engine.stop()


def test_rpc_generate_fault_point_surfaces_as_rpc_error(pair):
    async def gen(client, side, rid):
        return [c async for c in client.generate(req(side, rid, range(5, 15), temperature=0.0,
                                                     max_new_tokens=2, ignore_eos=True))]

    for side in SIDES:
        faults = SIDES[side][4]  # the server's side
        faults.arm("rpc.generate", mode="once")
        try:
            with pytest.raises(Exception):
                pair.run(gen(pair.clients[side], side, "faulted"))
        finally:
            faults.clear()
    out = pair.both(lambda client, side: gen(client, side, "clean-after"))
    assert_same({k: chunk_fields(v) for k, v in out.items()})
    assert out["ref-client/port-server"][-1].finished


def test_health_reflects_engine_health(pair):
    for side, eng in pair.engines.items():
        threshold = eng.config.max_consecutive_step_failures
        eng.scheduler.consec_step_failures = threshold
        try:
            assert pair.run(pair.clients[side].health()) is False
        finally:
            eng.scheduler.consec_step_failures = 0
        assert pair.run(pair.clients[side].health()) is True


def test_dp_rank_other_than_zero_gets_the_reference_error(pair):
    """A one-engine worker: a pinned rank past 0 is out of range, with the
    reference's message, on both servers."""
    errors = {}
    for side in SIDES:
        url = pair.clients[side].url

        async def go():
            # the reference's client: the port's always lets the worker pick
            client = jclient.GrpcWorkerClient(url)
            try:
                async for _ in client.generate(jwc.WorkerGenerateRequest(
                        rid="dp-bad", input_ids=[5, 6, 7],
                        sampling=JaxSamplingParams(max_new_tokens=2), data_parallel_rank=7)):
                    pass
            finally:
                await client.close()

        with pytest.raises(RuntimeError, match="out of range") as e:
            pair.run(go())
        errors[side] = str(e.value)
    assert_same(errors)
    assert "data_parallel_rank 7 out of range (dp_size 1)" in errors["port-client/ref-server"]


# ---- PD over gRPC ----


def test_kv_bytes_on_the_wire_equal_the_reference_encoding():
    x = np.random.default_rng(0).standard_normal((4, 3, 16, 32)).astype(np.float32)
    for t, want in ((torch.from_numpy(x), x),
                    (torch.from_numpy(x).to(torch.bfloat16), x.astype(ml_dtypes.bfloat16))):
        data, shape, dtype = kv_to_wire(t)
        assert data == want.tobytes() and dtype == str(want.dtype)
        assert shape == list(want.shape)
        back = kv_from_wire(data, shape, dtype)
        assert back.dtype == t.dtype and torch.equal(back, t)
        # the reference's decoding of the same bytes
        np.testing.assert_array_equal(np.frombuffer(data, dtype=dtype).reshape(shape), want)


def test_pd_across_implementations_over_grpc(pair):
    """Prefill on one server, decode on the other, through each direction's
    client: the tokens equal a co-located run's, and the decode engine
    prefills nothing."""
    sp = dict(temperature=0.0, max_new_tokens=8, ignore_eos=True)
    want = Engine.generate(pair.engines["ref-client/port-server"], PROMPT,
                           SamplingParams(**sp)).token_ids
    pair.run(pair.clients["ref-client/port-server"].flush_cache())
    got = {}
    for pside, dside in (("port-client/ref-server", "ref-client/port-server"),
                         ("ref-client/port-server", "port-client/ref-server")):
        d_prefill = pair.engines[dside].scheduler.num_prefill_tokens

        async def go():
            export = await pair.clients[pside].prefill_export(PROMPT, SIDES[pside][3](**sp))
            # each client takes its own host payload: tensors or numpy arrays
            k, v = export["k"], export["v"]
            k, v = ((torch.tensor(k), torch.tensor(v)) if isinstance(k, np.ndarray)
                    else (k.numpy(), v.numpy()))
            r = req(dside, f"pd-{dside}", **sp)
            toks = [t async for c in pair.clients[dside].generate_prefilled(
                r, export["first_token"], k, v) for t in c.token_ids]
            return export, toks

        export, toks = pair.run(go())
        assert export["connector"] == "host" and export["seq_len"] == len(PROMPT)
        assert tuple(np.shape(export["k"]))[1] == 2  # 20 tokens: 2 pages
        got[pside] = toks
        assert pair.engines[dside].scheduler.num_prefill_tokens == d_prefill
    assert got["port-client/ref-server"] == got["ref-client/port-server"] == want


def test_bf16_kv_from_the_port_server_reads_as_the_reference_bytes(pair):
    engine = port_engine(kv_dtype="bfloat16")
    server, client = pair.run(pair.dial("ref-client/port-server", engine))
    try:
        sp = JaxSamplingParams(temperature=0.0, max_new_tokens=4, ignore_eos=True)
        export = pair.run(client.prefill_export(PROMPT, sp))
        local = engine.prefill_export(PROMPT, SamplingParams(temperature=0.0, max_new_tokens=4,
                                                             ignore_eos=True))
        assert str(export["k"].dtype) == "bfloat16"
        n = len(PROMPT)  # slots past the prompt in its last page hold stale data
        for name in ("k", "v"):
            L, P, ps, KD = export[name].shape
            got = export[name].reshape(L, P * ps, KD)[:, :n]
            want = local[name].reshape(L, P * ps, KD)[:, :n]
            assert got.tobytes() == kv_to_wire(want)[0]
    finally:
        pair.run(client.close())
        pair.run(server.stop(grace=None))
        engine.stop()


# ---- the worker subcommand ----


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_worker_subcommand_answers_health_check():
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.Popen(
        [sys.executable, "-m", "smg_tpu_torch.cli", "worker", "--model-preset", "tiny",
         "--device", "cpu", "--dtype", "float32", "--max-seq-len", "256",
         "--grpc-port", str(port)],
        env=env, cwd=str(REPO), stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        async def probe():
            client = tclient.GrpcWorkerClient(f"127.0.0.1:{port}")
            try:
                deadline = time.monotonic() + 90
                while time.monotonic() < deadline:
                    if await client.health():
                        return await client.get_model_info()
                    await asyncio.sleep(0.25)
                return None
            finally:
                await client.close()

        info = asyncio.run(probe())
        assert info is not None, proc.stderr.read().decode() if proc.poll() is not None else ""
        assert info["model_id"] == "tiny" and info["dp_size"] == 1
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
    assert rc == 0
