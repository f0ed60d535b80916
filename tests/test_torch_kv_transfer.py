"""The ``transfer`` KV connector on the port (``engine/kv_transfer.py``),
held against the JAX package's on the CPU (the transfer cases of the
reference's ``tests/test_pd.py``).

- ``offer`` then ``pull`` between two managers: K and V bitwise equal to
  the ``device`` connector's export of the same pages, and equal (1e-5, the
  PD export tolerance) to the reference ``TransferManager``'s pull of the
  reference engine's export of the same prompt under bridged weights.
- A real cross-process pull through a shared memory block
  (``scripts/probe_kv_transfer.py --device cpu``).
- The offer lifecycle: ``mark_consumed``, ``reclaim`` and the TTL reap give
  the reference's return values; a second pull of a consumed offer fails.
- A PD pair of port gRPC workers: the legs alone, then behind the port's
  gateway under ``auto``, which picks ``transfer``: the tokens of a
  co-located run, the body of the reference gateway over a JAX gRPC pair
  and of the ``host`` connector, no prefill on the decode engine and no
  offer left pending; a failed decode leg reclaims the offer.
- A mixed fleet: a reference worker handed a port offer, and the reverse,
  fails its pull within seconds (the addresses differ in scheme) and the
  decode engine falls back to its own prefill; nothing hangs.

Float32, the tiny model with weights bridged from the JAX ``init_params``."""

import asyncio
import json
import socket
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from smg_tpu.engine import kv_transfer as jkvt
from smg_tpu.gateway import router as jrouter
from smg_tpu.gateway import server as jserver
from smg_tpu.gateway import workers as jworkers
from smg_tpu.gateway.worker_client import WorkerGenerateRequest as JaxWorkerRequest
from smg_tpu.protocols.sampling import SamplingParams as JaxSamplingParams
from smg_tpu.rpc import client as jclient
from smg_tpu.rpc import server as jrpc
from smg_tpu.tokenizer import MockTokenizer as JaxMockTokenizer
from smg_tpu_torch.engine import kv_transfer as tkvt
from smg_tpu_torch.gateway import router as trouter
from smg_tpu_torch.gateway import server as tserver
from smg_tpu_torch.gateway import workers as tworkers
from smg_tpu_torch.gateway.worker_client import WorkerGenerateRequest
from smg_tpu_torch.protocols.sampling import SamplingParams
from smg_tpu_torch.rpc import client as tclient
from smg_tpu_torch.rpc import server as trpc
from smg_tpu_torch.tokenizer import MockTokenizer
from test_torch_pd import GREEDY, MODEL, PROMPT, _chat, _strip, jax_engine, port_engine

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]


# ---- offer and pull ----


def test_pull_equals_the_device_export_and_the_reference_pull():
    sp = SamplingParams(**GREEDY)
    p = port_engine()
    try:
        export = p.prefill_export(PROMPT, sp, connector="transfer")
        desc = export["k"]
        assert export["connector"] == "transfer" and export["v"] is desc
        assert desc["transfer_address"].startswith("smgkv://127.0.0.1:")
        assert desc["kv_shape"] == (4, 3, 16, 32) and desc["kv_dtype"] == "float32"
        puller = tkvt.TransferManager("cpu")
        spec = [(desc["kv_shape"], desc["kv_dtype"])] * 2
        k, v = puller.pull(desc["transfer_address"], desc["transfer_uuid"], spec)
        p.flush_cache()
        dev = p.prefill_export(PROMPT, sp, connector="device")
        assert dev["first_token"] == export["first_token"]
        assert torch.equal(k, dev["k"]) and torch.equal(v, dev["v"])
        assert p.runner.kv_transfer.mark_consumed(desc["transfer_uuid"])
        assert not p.runner.kv_transfer._offers
    finally:
        p.stop()
    j = jax_engine()
    try:
        jexport = j.prefill_export(PROMPT, JaxSamplingParams(**GREEDY), connector="transfer")
        jdesc = jexport["k"]
        assert sorted(jdesc) == sorted(desc)
        assert (tuple(jdesc["kv_shape"]), jdesc["kv_dtype"]) == (desc["kv_shape"], "float32")
        assert jexport["first_token"] == export["first_token"]
        jk, jv = jkvt.TransferManager(jax.devices("cpu")[0]).pull(
            jdesc["transfer_address"], jdesc["transfer_uuid"],
            [(tuple(jdesc["kv_shape"]), jdesc["kv_dtype"])] * 2)
        np.testing.assert_allclose(k.numpy(), np.asarray(jk), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-5, rtol=1e-5)
    finally:
        j.stop()


def test_a_manager_pulls_its_own_offer_and_bf16_keeps_its_bits():
    mgr = tkvt.TransferManager("cpu")
    g = torch.Generator().manual_seed(0)
    offered = [torch.randn(2, 3, 16, 8, generator=g).to(torch.bfloat16),
               torch.randn(5, generator=g)]
    uuid = mgr.offer(offered)
    got = mgr.pull(mgr.address, uuid, [((2, 3, 16, 8), "bfloat16"), ((5,), "float32")])
    assert all(torch.equal(a, b) and a.data_ptr() != b.data_ptr()
               for a, b in zip(got, offered))
    with pytest.raises(ValueError, match="want"):
        mgr.pull(mgr.address, mgr.offer(offered), [((5,), "float32")] * 2)


def test_a_pull_crosses_processes_through_shared_memory():
    out = subprocess.run([sys.executable, str(REPO / "scripts/probe_kv_transfer.py"),
                          "--device", "cpu", "--mb", "2"], capture_output=True, text=True,
                         timeout=180, cwd=REPO)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert out.returncode == 0, (out.stdout, out.stderr)
    assert result["ok"] and result["bitwise_equal"] and result["offers_left"] == []
    assert result["bytes"] == 2 * 2**20 and "no kv offer" in result["second_pull"]


# ---- the lifecycle ----


def _tracked(mgr) -> set:
    """The uuids a manager still tracks (the port's ``_offers``, the
    reference's ``_pending``)."""
    return set(mgr._offers if isinstance(mgr, tkvt.TransferManager) else mgr._pending)


def _lifecycle(mgr, arrays) -> list:
    u1, u2 = mgr.offer(arrays[:1]), mgr.offer(arrays[1:])
    out = [_tracked(mgr) == {u1, u2}]
    out += [mgr.mark_consumed(u1), mgr.mark_consumed(u1), _tracked(mgr) == {u2}]
    out += [mgr.reclaim(u2), mgr.reclaim(u2), mgr.mark_consumed(u2), not _tracked(mgr)]
    mgr.OFFER_TTL = 0.0
    u3 = mgr.offer(arrays[:1])
    time.sleep(0.01)
    mgr.OFFER_TTL = 120.0
    u4 = mgr.offer(arrays[:1])  # reaps u3
    out += [_tracked(mgr) == {u4}, mgr.reclaim(u3), mgr.mark_consumed(u4)]
    return out


def _reclaims_done() -> bool:
    return not any(t.name.startswith("kv-reclaim") and t.is_alive()
                   for t in threading.enumerate())


def test_lifecycle_return_values_are_the_reference_ones():
    port = _lifecycle(tkvt.TransferManager("cpu"), [torch.zeros(2, 2), torch.ones(3)])
    ref = _lifecycle(jkvt.TransferManager(jax.devices("cpu")[0]),
                     [jax.numpy.zeros((2, 2)), jax.numpy.ones((3,))])
    for _ in range(100):  # the reference's reclaims self-pull on threads
        if _reclaims_done():
            break
        time.sleep(0.05)
    assert port == ref == [True, True, False, True, True, False, False, True, True, False, True]


def test_dropped_and_consumed_offers_free_their_tensors():
    mgr = tkvt.TransferManager("cpu")
    t = [torch.arange(4.0)]
    spec = [((4,), "float32")]
    pulled = mgr.offer(t)
    mgr.pull(mgr.address, pulled, spec)
    assert pulled not in mgr.held() and pulled in mgr._offers  # freed; still tracked
    with pytest.raises(RuntimeError, match=f"no kv offer {pulled}"):
        mgr.pull(mgr.address, pulled, spec)  # one-shot
    reclaimed = mgr.offer(t)
    assert mgr.reclaim(reclaimed) and not mgr.held()
    with pytest.raises(RuntimeError, match="no kv offer"):
        mgr.pull(mgr.address, reclaimed, spec)
    mgr.close()
    assert not mgr._offers


def _frame(sock, payload: dict) -> dict:
    data = json.dumps(payload).encode()
    sock.sendall(len(data).to_bytes(4, "big") + data)
    n = int.from_bytes(sock.recv(4, socket.MSG_WAITALL), "big")
    return json.loads(sock.recv(n, socket.MSG_WAITALL))


def test_done_is_taken_only_from_the_connection_that_pulled():
    mgr = tkvt.TransferManager("cpu")
    a, b = mgr.offer([torch.arange(4.0)]), mgr.offer([torch.ones(2)])
    assert a != b and 0 < a < 2**63 and 0 < b < 2**63 and abs(a - b) != 1
    host, port = mgr.address.removeprefix(tkvt.SCHEME).rsplit(":", 1)
    with socket.create_connection((host, int(port)), timeout=10) as puller, \
            socket.create_connection((host, int(port)), timeout=10) as other:
        answer = _frame(puller, {"op": "pull", "uuid": a})
        assert answer["ok"] and answer["kind"] == "shm"
        # another connection's "done", for the pulled offer and for one
        # nobody pulled, leaves both offers held
        assert not _frame(other, {"op": "done", "uuid": a})["ok"]
        assert not _frame(other, {"op": "done", "uuid": b})["ok"]
        assert not _frame(puller, {"op": "done", "uuid": b})["ok"]
        assert mgr.held() == sorted([a, b])
        assert _frame(puller, {"op": "done", "uuid": a})["ok"]
    assert mgr.held() == [b] and set(mgr._offers) == {a, b} and mgr.counts["served"] == 1
    assert mgr.pull(mgr.address, b, [((2,), "float32")])[0].tolist() == [1.0, 1.0]
    mgr.close()


# ---- the PD pair over gRPC ----


class Loop:
    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()

    def run(self, coro, timeout=180):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def close(self):
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=10)


class GrpcPair:
    """A PREFILL and a DECODE engine of one package behind its gRPC
    servers, on one private loop; clients are made there too (grpc.aio
    binds a channel to its loop)."""

    def __init__(self, side: str, loop: Loop):
        self.side, self.loop = side, loop
        self.engines = (port_engine(), port_engine()) if side == "port" else (
            jax_engine(), jax_engine())
        for e in self.engines:
            e.start()
        rpc = trpc if side == "port" else jrpc
        self.servers = [loop.run(rpc.serve_worker_async(e, port=0, host="127.0.0.1"))
                        for e in self.engines]
        self.urls = [f"127.0.0.1:{s._bound_port}" for s in self.servers]

    def client(self, i: int, side: str | None = None):
        mod = tclient if (side or self.side) == "port" else jclient
        return self.loop.run(_make(mod, self.urls[i]))

    def close(self):
        for s in self.servers:
            self.loop.run(s.stop(grace=None))
        for e in self.engines:
            e.stop()


async def _make(mod, url):
    return mod.GrpcWorkerClient(url)


@pytest.fixture(scope="module")
def grpc_pairs():
    loop = Loop()
    pairs = {side: GrpcPair(side, loop) for side in ("port", "ref")}
    yield pairs
    for p in pairs.values():
        p.close()
    loop.close()


def test_transfer_legs_over_real_grpc(grpc_pairs):
    pair = grpc_pairs["port"]
    p_eng, d_eng = pair.engines
    sp = SamplingParams(**GREEDY)
    ref = p_eng.generate(prompt_ids=PROMPT, sampling=sp)
    p_eng.flush_cache()
    pc, dc = pair.client(0), pair.client(1)
    d_prefill = d_eng.scheduler.num_prefill_tokens

    async def go():
        assert (await pc.get_model_info())["supports_kv_transfer"] is True
        export = await pc.prefill_export(PROMPT, sp, connector="transfer")
        assert export["connector"] == "transfer" and "k" in export
        toks = []
        async for chunk in dc.generate_prefilled(
                WorkerGenerateRequest(rid="pd-x", input_ids=PROMPT, sampling=sp),
                export["first_token"], export["k"], export["v"]):
            toks.extend(chunk.token_ids)
        released = await pc.release_kv_offer(export["k"]["transfer_uuid"], True)
        again = await pc.release_kv_offer(export["k"]["transfer_uuid"], True)
        await pc.close()
        await dc.close()
        return toks, released, again

    tokens, released, again = pair.loop.run(go())
    assert tokens == ref.token_ids
    assert (released, again) == (True, False)
    assert d_eng.scheduler.num_prefill_tokens == d_prefill
    assert not p_eng.runner.kv_transfer._offers


class Gateway:
    """One package's ``build_app`` over a gRPC PREFILL and DECODE worker."""

    def __init__(self, pair: GrpcPair, connector: str, decode_url: str | None = None):
        self.pair = pair
        self.tc = pair.loop.run(self._start(connector, decode_url))

    async def _start(self, connector, decode_url):
        port = self.pair.side == "port"
        server, router, workers = ((tserver, trouter, tworkers) if port
                                   else (jserver, jrouter, jworkers))
        ctx = server.AppContext(policy="cache_aware", policy_kwargs={"seed": 0},
                                router_config=router.RouterConfig(kv_connector=connector))
        ctx.tokenizers.register(MODEL, (MockTokenizer if port else JaxMockTokenizer)(),
                                default=True)
        client = tclient if port else jclient
        for (wid, wtype), url in zip((("prefill-0", workers.WorkerType.PREFILL),
                                      ("decode-0", workers.WorkerType.DECODE)), self.pair.urls):
            wclient = client.GrpcWorkerClient(url)
            if decode_url and wtype == workers.WorkerType.DECODE:
                wclient.url = decode_url  # the address it names; the channel dials url
            ctx.registry.add(workers.Worker(worker_id=wid, client=wclient,
                                            model_id=MODEL, worker_type=wtype, url=url))
        tc = TestClient(TestServer(server.build_app(ctx)))
        await tc.start_server()
        return tc

    def post(self, body) -> tuple:
        async def one():
            resp = await self.tc.post("/v1/chat/completions", json=body)
            return resp.status, await resp.text()

        return self.pair.loop.run(one())

    def close(self):
        self.pair.loop.run(self.tc.close())


def _spy_connector(engine, calls: list):
    orig = engine.prefill_export

    def spy(prompt_ids, sampling, connector="host"):
        calls.append(connector)
        return orig(prompt_ids, sampling, connector=connector)

    engine.prefill_export = spy
    return orig


def test_gateway_auto_picks_transfer_and_serves_the_reference_body(grpc_pairs):
    port, ref = grpc_pairs["port"], grpc_pairs["ref"]
    p_eng, d_eng = port.engines
    d_prefill = d_eng.scheduler.num_prefill_tokens
    bodies, calls = {}, {"port": [], "ref": []}
    for side, pair, connector in (("port", port, "auto"), ("ref", ref, "auto"),
                                  ("host", port, "host")):
        gw = Gateway(pair, connector)
        orig = _spy_connector(pair.engines[0], calls.setdefault(side, []))
        try:
            for stream in (False, True):
                st, text = gw.post(_chat("w5 w6 w7 w8 w9", 6, stream=stream))
                assert st == 200, text
                bodies[side, stream] = (_strip(json.loads(text)) if not stream else
                                        [b for b in text.split("\n\n") if b.startswith("data")])
        finally:
            pair.engines[0].prefill_export = orig
            gw.close()
    assert calls == {"port": ["transfer"] * 2, "ref": ["transfer"] * 2, "host": ["host"] * 2}
    assert bodies["port", False] == bodies["ref", False] == bodies["host", False]
    strip_frames = lambda fr: [_strip(json.loads(f[6:])) if f[6:] != "[DONE]" else f  # noqa: E731
                               for f in fr]
    assert (strip_frames(bodies["port", True]) == strip_frames(bodies["ref", True])
            == strip_frames(bodies["host", True]))
    assert d_eng.scheduler.num_prefill_tokens == d_prefill  # every leg imported
    mgr = p_eng.runner.kv_transfer
    assert not mgr._offers  # released once the decode leg streamed


@pytest.mark.parametrize("prefill_url,decode_url,same", [
    ("127.0.0.1:5001", "localhost:5002", True),
    ("grpc://127.0.0.2:5001", "[::1]:5002", True),
    ("10.1.2.3:5001", "grpc://10.1.2.3:5002", True),
    ("gpu-a.example:5001", "GPU-A.example:5002", True),
    ("127.0.0.1:5001", "10.1.2.3:5002", False),
    ("10.1.2.3:5001", "10.1.2.4:5001", False),
    ("gpu-a.example:5001", "gpu-b.example:5001", False),
])
def test_worker_hosts_are_read_from_the_urls(prefill_url, decode_url, same):
    hosts = {trouter._worker_host(tworkers.Worker(
        worker_id=u, client=types.SimpleNamespace(supports_device_kv=False, url=u)))
        for u in (prefill_url, decode_url)}
    assert (len(hosts) == 1) is same


def test_gateway_auto_takes_host_for_legs_on_two_hosts(grpc_pairs):
    """CUDA IPC and shared memory do not cross hosts: a decode worker whose
    URL names another host gets host bytes under ``auto``, and imports them
    (its engine prefills nothing)."""
    pair = grpc_pairs["port"]
    p_eng, d_eng = pair.engines
    d_prefill = d_eng.scheduler.num_prefill_tokens
    served = p_eng.runner.kv_transfer.counts["offered"]
    calls = []
    port = pair.urls[1].rsplit(":", 1)[1]
    gw = Gateway(pair, "auto", decode_url=f"10.255.255.2:{port}")
    orig = _spy_connector(p_eng, calls)
    try:
        st, text = gw.post(_chat("w5 w6 w7 w8 w9", 6))
    finally:
        p_eng.prefill_export = orig
        gw.close()
    assert st == 200, text
    assert calls == ["host"]
    assert d_eng.scheduler.num_prefill_tokens == d_prefill
    assert p_eng.runner.kv_transfer.counts["offered"] == served


def test_a_failed_decode_leg_reclaims_the_offer(grpc_pairs):
    pair = grpc_pairs["port"]
    p_eng, d_eng = pair.engines
    mgr = p_eng.runner.kv_transfer
    reclaimed = []
    orig_reclaim, orig_submit = mgr.reclaim, d_eng.submit_prefilled

    def spy(uuid):
        reclaimed.append((uuid, uuid in mgr.held()))
        return orig_reclaim(uuid)

    def boom(*a, **kw):
        raise RuntimeError("decode exploded")

    mgr.reclaim, d_eng.submit_prefilled = spy, boom
    gw = Gateway(pair, "auto")
    try:
        st, text = gw.post(_chat("w40 w41", 3))
    finally:
        mgr.reclaim, d_eng.submit_prefilled = orig_reclaim, orig_submit
        gw.close()
    assert st == 502 and "decode worker error" in text
    assert len(reclaimed) == 1 and reclaimed[0][1] is True  # un-pulled, then dropped
    assert not mgr._offers


# ---- a mixed fleet ----


def test_a_reference_pull_of_a_port_offer_and_the_reverse_fail_fast():
    port_mgr = tkvt.TransferManager("cpu")
    ref_mgr = jkvt.TransferManager(jax.devices("cpu")[0])
    pu = port_mgr.offer([torch.zeros(4)])
    ru = ref_mgr.offer([jax.numpy.zeros((4,))])
    t0 = time.monotonic()
    with pytest.raises(Exception, match="port"):  # jax cannot parse the scheme
        ref_mgr.pull(port_mgr.address, pu, [((4,), "float32")])
    with pytest.raises(ValueError, match="is not a smgkv:// pull server"):
        port_mgr.pull(ref_mgr.address, ru, [((4,), "float32")])
    assert time.monotonic() - t0 < 5
    assert port_mgr.reclaim(pu) and ref_mgr.mark_consumed(ru)


@pytest.mark.parametrize("prefill,decode", [("port", "ref"), ("ref", "port")])
def test_a_mixed_pd_pair_falls_back_to_a_local_prefill(grpc_pairs, prefill, decode):
    """Both workers report ``supports_kv_transfer``, but neither can pull
    the other's offer: the decode worker's pull fails at once and its
    engine prefills the prompt itself (the degraded path), within seconds."""
    p_pair, d_pair = grpc_pairs[prefill], grpc_pairs[decode]
    d_eng = d_pair.engines[1]
    sp = (SamplingParams if prefill == "port" else JaxSamplingParams)(**GREEDY)
    ref_tokens = grpc_pairs["port"].engines[0].generate(
        prompt_ids=PROMPT, sampling=SamplingParams(**GREEDY)).token_ids
    d_prefill = d_eng.scheduler.num_prefill_tokens
    pc, dc = p_pair.client(0), d_pair.client(1, side=prefill)
    request = (WorkerGenerateRequest if prefill == "port" else JaxWorkerRequest)

    async def go():
        export = await pc.prefill_export(PROMPT, sp, connector="transfer")
        t0 = time.monotonic()
        toks = []
        async for chunk in dc.generate_prefilled(request(rid=f"mixed-{decode}",
                                                         input_ids=PROMPT, sampling=sp),
                                                 export["first_token"], export["k"],
                                                 export["v"]):
            toks.extend(chunk.token_ids)
        elapsed = time.monotonic() - t0
        await pc.release_kv_offer(export["k"]["transfer_uuid"], False)
        await pc.close()
        await dc.close()
        return toks, elapsed

    tokens, elapsed = p_pair.loop.run(go())
    assert elapsed < 30
    assert d_eng.scheduler.num_prefill_tokens > d_prefill  # the decode engine prefilled
    assert tokens == ref_tokens
    mgr = p_pair.engines[0].runner.kv_transfer
    assert not _tracked(mgr)
