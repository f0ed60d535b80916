"""The HA mesh on the port (``smg_tpu_torch/mesh``), held against the JAX
package's (``smg_tpu/mesh``) on the CPU.

- ``LwwMap``: seeded scripts of set, delete and merge in both orders across
  three nodes run on both packages: identical ``items()``, snapshots and
  change notifications after every operation.
- ``PartitionDetector``: the cases of ``tests/test_mesh_partition_index.py``
  on both packages, with identical states and descriptions.
- Gossip: the three-node convergence and failure detection of
  ``tests/test_mesh.py`` on port nodes, then a mixed fleet of port and
  reference nodes seeded from each other, over plaintext and mutual TLS
  (certificates from the ``openssl`` CLI); a plaintext dial and a foreign
  CA are refused; the partial-TLS error has the reference's text.  Rounds
  are driven by hand (``_round()``), never waited for.
- The adapters: ``WorkerSyncAdapter`` between a port and a reference
  registry both ways (add, tombstoned remove, no re-publish of mesh-born
  workers); ``TreeSyncAdapter`` replicating ``cache_aware`` routed prefixes
  (the reference's case, a mixed pair, the LRU bound, unserved models);
  the repaired ``CacheAwarePolicy`` makes the reference's decisions with
  and without an insert hook.
- ``launch --mesh-port``: two port gateways and a reference gateway, seeded
  from the first; a worker registered by ``POST /workers`` on the first
  serves the same greedy chat through each of them, and a removal there
  leaves the others."""

import asyncio
import json
import shutil
import ssl
import subprocess
import threading
import time

import numpy as np
import pytest
import torch

from smg_tpu import cli as jcli
from smg_tpu import mesh as jmesh
from smg_tpu.gateway import launch as jlaunch
from smg_tpu.gateway import workers as jworkers
from smg_tpu.mesh import adapters as jadapters
from smg_tpu.mesh import gossip as jgossip
from smg_tpu.policies import base as jbase
from smg_tpu.policies import cache_aware as jcache
from smg_tpu_torch import cli as tcli
from smg_tpu_torch import mesh as tmesh
from smg_tpu_torch.engine import config as tconf
from smg_tpu_torch.engine.engine import Engine
from smg_tpu_torch.gateway import launch as tlaunch
from smg_tpu_torch.gateway import workers as tworkers
from smg_tpu_torch.mesh import adapters as tadapters
from smg_tpu_torch.mesh import gossip as tgossip
from smg_tpu_torch.models.config import tiny_test_config
from smg_tpu_torch.policies import base as tbase
from smg_tpu_torch.policies import cache_aware as tcache
from smg_tpu_torch.rpc import server as trpc
from smg_tpu_torch.tokenizer import MockTokenizer

torch.set_num_threads(2)
PKGS = {"port": tmesh, "ref": jmesh}

# ---- LwwMap ----


def _lww_script(seed: int, n_ops: int = 60) -> list:
    rng = np.random.RandomState(seed)
    ops = []
    for _ in range(n_ops):
        kind = rng.choice(["set", "set", "delete", "merge"])
        node = int(rng.randint(3))
        if kind == "merge":
            ops.append(("merge", node, int((node + 1 + rng.randint(2)) % 3)))
        else:
            key = f"k{rng.randint(6)}"
            ops.append((str(kind), node, key, {"v": int(rng.randint(100))}))
    return ops


def _run_lww(mod, ops) -> list:
    nodes = [mod.LwwMap(f"n{i}") for i in range(3)]
    seen = [[] for _ in nodes]
    for i, n in enumerate(nodes):
        n.on_change(lambda k, v, d, i=i: seen[i].append((k, v, d)))
    trace = []
    for op in ops:
        if op[0] == "set":
            nodes[op[1]].set(op[2], op[3])
        elif op[0] == "delete":
            nodes[op[1]].delete(op[2])
        else:  # merge op[2]'s snapshot into op[1]
            trace.append(sorted(nodes[op[1]].merge(nodes[op[2]].snapshot())))
        trace.append([(n.items(), sorted(map(repr, n.snapshot()))) for n in nodes])
    # full anti-entropy in both orders converges every node
    for a in range(3):
        for b in range(3):
            if a != b:
                nodes[a].merge(nodes[b].snapshot())
    trace.append([n.items() for n in nodes])
    return trace + [seen]


@pytest.mark.parametrize("seed", range(4))
def test_lww_map_script_matches_the_reference(seed):
    ops = _lww_script(seed)
    port, ref = _run_lww(tmesh, ops), _run_lww(jmesh, ops)
    assert port == ref
    final = port[-2]
    assert final[0] == final[1] == final[2]


def test_lww_snapshots_merge_across_packages():
    """A port node and a reference node merge each other's snapshots (the
    wire form is one list of tuples) and converge."""
    a, b = tmesh.LwwMap("a"), jmesh.LwwMap("b")
    a.set("w1", {"url": "h1"})
    b.set("w2", {"url": "h2"})
    a.set("k", "from-a")
    b.set("k", "from-b")
    b.delete("w2")
    a.merge(json.loads(json.dumps(b.snapshot())))
    b.merge(json.loads(json.dumps(a.snapshot())))
    assert a.items() == b.items() == {"w1": {"url": "h1"}, "k": "from-b"}


# ---- PartitionDetector ----


def _partition_script(mod, gossip_mod) -> list:
    node = mod.GossipNode(mod.GossipConfig(node_id="me"), partition_config=mod.PartitionConfig(
        unreachable_timeout=1.0, min_cluster_size=3, quorum_threshold=2))
    det, now, out = node.partition, time.monotonic(), []
    node.members = {"a": gossip_mod.Member(node_id="a", addr="x:1", last_seen=now),
                    "b": gossip_mod.Member(node_id="b", addr="x:2", last_seen=now)}
    out.append((det.detect(node).value, node.has_quorum))
    node.members["b"].last_seen = now - 10
    out.append((det.detect(node).value, node.has_quorum))
    node.members["a"].last_seen = now - 10
    out.append((det.detect(node).value, node.has_quorum, det.describe()))
    node.members["a"].last_seen = node.members["b"].last_seen = time.monotonic()
    out.append((det.detect(node).value, det.describe()))
    node.members["b"].alive = False  # a dead peer is unreachable too
    out.append((det.detect(node).value, det.describe()))
    node.members["seed@x:9"] = gossip_mod.Member(node_id="seed@x:9", addr="x:9",
                                                 last_seen=now - 99)
    out.append(det.detect(node).value)  # seed placeholders never count
    small = mod.GossipNode(mod.GossipConfig(node_id="me"),
                           partition_config=mod.PartitionConfig(min_cluster_size=3))
    small.members = {"a": gossip_mod.Member(node_id="a", addr="x:1",
                                            last_seen=time.monotonic() - 999)}
    out.append(small.partition.detect(small).value)
    return out


def test_partition_detector_matches_the_reference():
    port, ref = _partition_script(tmesh, tgossip), _partition_script(jmesh, jgossip)
    assert port == ref
    assert [s if isinstance(s, str) else s[0] for s in port] == [
        "normal", "partitioned_with_quorum", "partitioned_without_quorum", "normal",
        "partitioned_with_quorum", "partitioned_with_quorum", "normal"]


# ---- gossip ----


def _node(mod, node_id: str, seeds=(), **kw):
    return mod.GossipNode(mod.GossipConfig(node_id=node_id, seeds=list(seeds),
                                           interval_secs=60, **kw))


async def _rounds(nodes, n: int) -> None:
    for _ in range(n):
        for node in nodes:
            await node._round()


async def _converge_and_fail(kinds: list, tls: dict | None = None) -> dict:
    """Three nodes of the given packages, each seeded from the one before:
    state set on two of them converges, membership is complete,
    and a stopped third node is marked dead by the other two."""
    tls = tls or {}
    n1 = _node(PKGS[kinds[0]], "n1", **tls)
    await n1.start()
    n2 = _node(PKGS[kinds[1]], "n2", seeds=[n1.addr], **tls)
    await n2.start()
    n3 = _node(PKGS[kinds[2]], "n3", seeds=[n2.addr], **tls)
    await n3.start()
    try:
        n1.state.set("worker/a", {"url": "10.0.0.1"})
        n3.state.set("worker/c", {"url": "10.0.0.3"})
        n2.state.set("tree/m/x.y", {"kind": "tokens", "seq": [1, 2], "worker": "w"})
        n2.state.delete("tree/m/x.y")
        await _rounds([n1, n2, n3], 12)
        out = {"items": [n.state.items() for n in (n1, n2, n3)],
               "snapshots": [sorted(map(repr, n.state.snapshot())) for n in (n1, n2, n3)],
               "alive": [sorted(m.node_id for m in n.alive_members()) for n in (n1, n2, n3)]}
        await n3.stop()
        await _rounds([n1, n2], 20)
        out["dead"] = [sorted(m.node_id for m in n.members.values() if not m.alive)
                       for n in (n1, n2)]
        return out
    finally:
        for n in (n1, n2, n3):
            await n.stop()


EXPECTED = {"worker/a": {"url": "10.0.0.1"}, "worker/c": {"url": "10.0.0.3"}}


@pytest.mark.parametrize("kinds", [["port"] * 3, ["port", "ref", "port"], ["ref", "port", "ref"]],
                         ids=["port", "port-ref-port", "ref-port-ref"])
def test_three_node_gossip_converges_and_detects_failure(kinds):
    out = asyncio.run(_converge_and_fail(kinds))
    assert out["items"] == [EXPECTED] * 3
    assert out["snapshots"][0] == out["snapshots"][1] == out["snapshots"][2]
    assert out["alive"] == [["n1", "n2", "n3"]] * 3
    assert out["dead"] == [["n3"], ["n3"]]


def test_a_mixed_fleet_gives_the_reference_fleets_state():
    port, ref = (asyncio.run(_converge_and_fail(k))
                 for k in (["port", "ref", "port"], ["ref"] * 3))
    assert port == ref


def _make_certs(tmp_path, ca_name="mesh-ca"):
    """Self-signed CA + a node certificate signed by it (openssl CLI), as
    the reference's mTLS test makes them."""
    if shutil.which("openssl") is None:
        pytest.skip("openssl CLI unavailable")
    tmp_path.mkdir(parents=True, exist_ok=True)

    def run(*args):
        subprocess.run(args, check=True, capture_output=True, cwd=tmp_path)

    run("openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes", "-keyout", "ca.key",
        "-out", "ca.crt", "-days", "1", "-subj", f"/CN={ca_name}")
    run("openssl", "req", "-newkey", "rsa:2048", "-nodes", "-keyout", "node.key",
        "-out", "node.csr", "-subj", "/CN=mesh-node")
    run("openssl", "x509", "-req", "-in", "node.csr", "-CA", "ca.crt", "-CAkey", "ca.key",
        "-CAcreateserial", "-out", "node.crt", "-days", "1")
    return {"tls_cert_file": str(tmp_path / "node.crt"),
            "tls_key_file": str(tmp_path / "node.key"),
            "tls_ca_file": str(tmp_path / "ca.crt")}


async def _refused(addr: str, ssl_ctx=None) -> bool:
    """True when a gossip frame sent to ``addr`` gets no gossip reply."""
    host, port = addr.rsplit(":", 1)
    try:
        r, w = await asyncio.wait_for(asyncio.open_connection(host, int(port), ssl=ssl_ctx), 3)
        payload = b'{"from":"evil","addr":"x","members":[],"state":[]}'
        w.write(len(payload).to_bytes(4, "big") + payload)
        await w.drain()
        data = await asyncio.wait_for(r.read(100), 3)
        w.close()
        return data == b""
    except (ssl.SSLError, ConnectionError, OSError, asyncio.TimeoutError):
        return True


@pytest.mark.parametrize("kinds", [["port", "port"], ["port", "ref"], ["ref", "port"]],
                         ids=["port-port", "port-ref", "ref-port"])
def test_mtls_gossip_and_its_refusals(kinds, tmp_path):
    tls = _make_certs(tmp_path / "mesh")
    foreign = _make_certs(tmp_path / "foreign", ca_name="other-ca")

    async def go():
        a = _node(PKGS[kinds[0]], "a", **tls)
        await a.start()
        b = _node(PKGS[kinds[1]], "b", seeds=[a.addr], **tls)
        await b.start()
        try:
            a.state.set("worker/x", {"url": "h:1"})
            await _rounds([b, a], 3)
            assert {m.node_id for m in a.alive_members()} == {"a", "b"}
            assert {m.node_id for m in b.alive_members()} == {"a", "b"}
            assert b.state.items() == {"worker/x": {"url": "h:1"}}
            plain = await _refused(a.addr)
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
            # the foreign certificate while trusting the mesh CA: refused
            # only if the server verifies its clients (the mutual half)
            ctx.load_cert_chain(foreign["tls_cert_file"], foreign["tls_key_file"])
            ctx.load_verify_locations(tls["tls_ca_file"])
            ctx.check_hostname = False
            return plain, await _refused(a.addr, ctx)
        finally:
            await a.stop()
            await b.stop()

    assert asyncio.run(go()) == (True, True)


@pytest.mark.parametrize("parts", [dict(tls_cert_file="/c"), dict(tls_key_file="/k"),
                                   dict(tls_cert_file="/c", tls_ca_file="/a")],
                         ids=["cert", "key", "cert+ca"])
def test_partial_tls_config_has_the_reference_error(parts):
    with pytest.raises(ValueError) as port:
        tmesh.GossipConfig(node_id="x", **parts)
    with pytest.raises(ValueError) as ref:
        jmesh.GossipConfig(node_id="x", **parts)
    assert str(port.value) == str(ref.value) and "mTLS" in str(port.value)


def test_gossip_frames_are_byte_compatible():
    """The port's frame writer and reader against the reference's."""
    payload = {"from": "n", "addr": "h:1", "members": [], "state": [["k", {"a": 1}, 3, "n",
                                                                     False]]}

    class Sink:
        def __init__(self):
            self.data = b""

        def write(self, b):
            self.data += b

        async def drain(self):
            pass

    async def go():
        out = []
        for mod in (tgossip, jgossip):
            s = Sink()
            await mod._write_frame(s, payload)
            out.append(s.data)
        back = []
        for mod, data in ((tgossip, out[1]), (jgossip, out[0])):
            r = asyncio.StreamReader()
            r.feed_data(data)
            back.append(await mod._read_frame(r))
        return out, back

    frames, back = asyncio.run(go())
    assert frames[0] == frames[1]
    assert back == [payload, payload]


# ---- the adapters ----


class _W:
    def __init__(self, wid, load):
        self.worker_id, self.load = wid, load

    def is_available(self):
        return True


class FakeClient:
    def __init__(self, url):
        self.url = url


def test_worker_sync_between_a_port_and_a_reference_registry():
    for first, second in ((tworkers, jworkers), (jworkers, tworkers)):
        ad = {tworkers: tadapters, jworkers: jadapters}
        reg_a, reg_b = first.WorkerRegistry(), second.WorkerRegistry()
        lww = {tworkers: tmesh.LwwMap, jworkers: jmesh.LwwMap}
        state_a, state_b = lww[first]("a"), lww[second]("b")
        ad[first].WorkerSyncAdapter(reg_a, state_a, client_factory=FakeClient)
        ad[second].WorkerSyncAdapter(reg_b, state_b, client_factory=FakeClient)
        reg_a.add(first.Worker(worker_id="w-local", client=FakeClient("u"), model_id="m",
                               worker_type=first.WorkerType.PREFILL, url="10.0.0.5:30001"))
        state_b.merge(state_a.snapshot())
        synced = reg_b.get("w-local")
        assert (synced.url, synced.model_id, synced.worker_type.value) == (
            "10.0.0.5:30001", "m", "prefill")
        assert isinstance(synced.client, FakeClient) and synced.client.url == "10.0.0.5:30001"
        # b does not re-publish a mesh-born worker as its own
        assert [e[3] for e in state_b.snapshot()] == ["a"]
        # a worker of b's own goes the other way
        reg_b.add(second.Worker(worker_id="w-b", client=FakeClient("v"), model_id="m",
                                url="10.0.0.6:30001"))
        state_a.merge(state_b.snapshot())
        assert reg_a.get("w-b").url == "10.0.0.6:30001"
        # removal propagates as a tombstone
        reg_a.remove("w-local")
        assert [e[4] for e in state_a.snapshot() if e[0] == "worker/w-local"] == [True]
        state_b.merge(state_a.snapshot())
        assert reg_b.get("w-local") is None
        assert [w.worker_id for w in reg_b.list()] == ["w-b"]


def _tree_case(pol_mod, lww_mod, ad_mod, base_mod, wc_mod):
    """The reference's ``test_tree_sync_replicates_routed_prefixes``: its
    decisions and matches."""

    class Client(wc_mod.WorkerClient):
        pass

    def mk_workers():
        return [base_mod.Worker(worker_id=f"w{i}", client=Client(), model_id="m")
                for i in range(4)]

    state_a, state_b = lww_mod.LwwMap("ga"), lww_mod.LwwMap("gb")
    pol_a = pol_mod.PolicyRegistry(default="cache_aware", seed=1)
    pol_b = pol_mod.PolicyRegistry(default="cache_aware", seed=2)
    ad_mod.TreeSyncAdapter(pol_a, state_a)
    ad_mod.TreeSyncAdapter(pol_b, state_b)
    prefix = list(range(100, 164))
    chosen = pol_a.policy_for(None).select_worker(mk_workers(),
                                                  pol_mod.RequestContext(token_ids=prefix))
    state_b.merge(state_a.snapshot())
    ctx2 = pol_mod.RequestContext(token_ids=prefix + list(range(164, 180)))
    chosen_b = pol_b.policy_for(None).select_worker(mk_workers(), ctx2)
    state_a.merge(state_b.snapshot())
    matches = pol_a.policy_for(None).tree.prefix_match(ctx2.token_ids)
    return (chosen.worker_id, chosen_b.worker_id, matches,
            sorted(k for k, *_ in state_a.snapshot()))


def test_tree_sync_matches_the_reference():
    from smg_tpu.gateway import worker_client as jwc
    from smg_tpu_torch.gateway import worker_client as twc

    port = _tree_case(tbase, tmesh, tadapters, tworkers, twc)
    ref = _tree_case(jbase, jmesh, jadapters, jworkers, jwc)
    assert port == ref
    assert port[0] == port[1] and port[2][port[0]] >= 64


def test_tree_sync_between_a_port_and_a_reference_gateway():
    """A prefix routed on a port gateway goes to the same worker on a
    reference peer, and the reverse."""
    from smg_tpu.gateway import worker_client as jwc
    from smg_tpu_torch.gateway import worker_client as twc

    sides = {"port": (tbase, tmesh, tadapters, tworkers, twc),
             "ref": (jbase, jmesh, jadapters, jworkers, jwc)}
    for a, b in (("port", "ref"), ("ref", "port")):
        (pa, la, ada, wa, ca), (pb, lb, adb, wb, cb) = sides[a], sides[b]
        state_a, state_b = la.LwwMap("ga"), lb.LwwMap("gb")
        pol_a = pa.PolicyRegistry(default="cache_aware", seed=1)
        pol_b = pb.PolicyRegistry(default="cache_aware", seed=2)
        ada.TreeSyncAdapter(pol_a, state_a)
        adb.TreeSyncAdapter(pol_b, state_b)
        wk_a = [wa.Worker(worker_id=f"w{i}", client=ca.WorkerClient(), model_id="m")
                for i in range(4)]
        wk_b = [wb.Worker(worker_id=f"w{i}", client=cb.WorkerClient(), model_id="m")
                for i in range(4)]
        picks = []
        for fam in range(4):
            prefix = list(range(1000 * (fam + 1), 1000 * (fam + 1) + 48))
            picks.append(pol_a.policy_for(None).select_worker(
                wk_a, pa.RequestContext(token_ids=prefix)).worker_id)
        state_b.merge(json.loads(json.dumps(state_a.snapshot())))
        assert pol_b.policy_for(None).num_inserted_prefixes == 4
        for fam in range(4):
            prefix = list(range(1000 * (fam + 1), 1000 * (fam + 1) + 64))
            got = pol_b.policy_for(None).select_worker(wk_b, pb.RequestContext(token_ids=prefix))
            assert got.worker_id == picks[fam], (a, b, fam)


def test_tree_sync_lru_bound_tombstones_evicted_keys():
    def run(pol_mod, lww_mod, ad_mod):
        state = lww_mod.LwwMap("g")
        pols = pol_mod.PolicyRegistry(default="cache_aware", seed=0)
        ad_mod.TreeSyncAdapter(pols, state, max_entries=2)
        w = [_W(f"w{i}", 0) for i in range(2)]
        for fam in range(4):
            pols.policy_for("m").select_worker(
                w, pol_mod.RequestContext(token_ids=list(range(fam * 100, fam * 100 + 20))))
        return sorted((s[0], s[4]) for s in state.snapshot())

    port, ref = run(tbase, tmesh, tadapters), run(jbase, jmesh, jadapters)
    assert port == ref
    assert [t for _, t in port].count(True) == 2 and [t for _, t in port].count(False) == 2


def test_tree_sync_ignores_models_this_gateway_does_not_serve():
    for pol_mod, lww_mod, ad_mod in ((tbase, tmesh, tadapters), (jbase, jmesh, jadapters)):
        state = lww_mod.LwwMap("g")
        pols = pol_mod.PolicyRegistry(default="cache_aware", seed=0)
        ad_mod.TreeSyncAdapter(pols, state)
        peer = lww_mod.LwwMap("peer")
        peer.set("tree/other/abc.def", {"kind": "tokens", "seq": [1, 2, 3], "worker": "w9"})
        peer.set("tree/m/abc.def", {"kind": "tokens", "seq": [4, 5, 6], "worker": "w1"})
        state.merge(peer.snapshot())
        assert not pols.has_policy("other")
        # created later: the gossiped tree state replays into it
        pol = pols.policy_for("m")
        assert pol.num_inserted_prefixes == 1
        assert pol.tree.prefix_match([4, 5, 6]) == {"w1": 3}


def _cache_aware_decisions(mod, base_mod, hook: str | None, seed: int) -> tuple:
    rng = np.random.RandomState(seed)
    pol = mod.CacheAwarePolicy(seed=seed, imbalance_abs=4)
    calls = []
    if hook == "record":
        pol.add_insert_hook(lambda seq, wid: calls.append((list(seq)[:4], wid)))
    elif hook == "raise":
        pol.add_insert_hook(lambda seq, wid: 1 / 0)
    picks = []
    for _ in range(40):
        fam = int(rng.randint(5))
        n = int(rng.randint(4, 40))
        seq = list(range(fam * 1000, fam * 1000 + n))
        workers = [_W(f"w{i}", int(rng.randint(0, 12))) for i in range(4)]
        picks.append(pol.select_worker(workers, base_mod.RequestContext(token_ids=seq)).worker_id)
    pol.apply_remote_insert([7, 8, 9], "w3")
    return picks, calls, pol.num_inserted_prefixes, pol.tree.prefix_match([7, 8, 9])


@pytest.mark.parametrize("hook", [None, "record", "raise"])
def test_cache_aware_with_and_without_insert_hooks_matches_the_reference(hook):
    for seed in range(3):
        port = _cache_aware_decisions(tcache, tbase, hook, seed)
        ref = _cache_aware_decisions(jcache, jbase, hook, seed)
        assert port == ref
        # a hook never changes a decision
        assert port[0] == _cache_aware_decisions(tcache, tbase, None, seed)[0]
        assert len(port[1]) == (40 if hook == "record" else 0)


# ---- launch --mesh-port ----


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(url, body=None, method=None, timeout=60):
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, method=method or ("POST" if body is not None else "GET"),
                                 data=None if body is None else json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _wait(url, timeout=60.0):
    import urllib.error

    deadline = time.monotonic() + timeout
    while True:
        try:
            return _http(url, timeout=5)
        except (urllib.error.URLError, ConnectionError, TimeoutError):
            if time.monotonic() > deadline:
                raise
            time.sleep(0.05)


class _Loop:
    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()

    def run(self, coro, timeout=60):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def close(self):
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=10)


@pytest.fixture
def mesh_nodes(monkeypatch):
    """Every gossip node either package's ``_run_gateway`` starts, by node
    address, so a test drives the rounds by hand."""
    nodes = []
    for mod in (tmesh, jmesh):
        base = mod.GossipNode

        class Recorded(base):
            async def start(self):
                self.loop = asyncio.get_running_loop()  # the gateway's
                await super().start()
                nodes.append(self)

        monkeypatch.setattr(mod, "GossipNode", Recorded)
    return nodes


def test_launch_mesh_gateways_share_a_worker(mesh_nodes):
    """G1 (port) holds a port gRPC worker registered by ``POST /workers``; G2
    (port) and R3 (the reference's ``_run_gateway``) are seeded from G1 and
    hold none.  After a few gossip rounds each lists the worker and serves
    G1's greedy chat; ``DELETE`` on G1 removes it from both."""
    wloop = _Loop()
    engine = Engine(tconf.EngineConfig(
        model=tiny_test_config(),
        cache=tconf.CacheConfig(page_size=16, num_pages=64, auto_size=False, dtype="float32"),
        scheduler=tconf.SchedulerConfig(max_batch_size=2, max_seq_len=128,
                                        max_prefill_tokens=32),
        model_id="tiny-mesh"), device="cpu", tokenizer=MockTokenizer())
    engine.start()
    server = wloop.run(trpc.serve_worker_async(engine, port=0, host="127.0.0.1"))
    wurl = f"127.0.0.1:{server._bound_port}"
    ports = [_free_port() for _ in range(3)]
    meshes = [_free_port() for _ in range(3)]
    loops = [_Loop() for _ in range(3)]
    stops = []
    futures = []

    def argv(i):
        a = ["launch", "--host", "127.0.0.1", "--port", str(ports[i]),
             "--mesh-port", str(meshes[i])]
        return a + (["--mesh-seed", f"127.0.0.1:{meshes[0]}"] if i else [])

    try:
        for i in range(2):
            args = tcli.build_parser().parse_args(argv(i))
            stop = asyncio.Event()
            stops.append(stop)
            futures.append(asyncio.run_coroutine_threadsafe(
                tlaunch._run_gateway(args, stop=stop), loops[i].loop))
        ref_args = jcli.build_parser().parse_args(argv(2))
        futures.append(asyncio.run_coroutine_threadsafe(jlaunch._run_gateway(ref_args),
                                                        loops[2].loop))
        bases = [f"http://127.0.0.1:{p}" for p in ports]
        for b in bases:
            assert _wait(b + "/health")[0] == 200
        st, _ = _http(bases[0] + "/workers", {"url": wurl})
        assert st in (200, 202), st
        deadline = time.monotonic() + 60
        while not any(w["url"] == wurl for w in _http(bases[0] + "/workers")[1]["workers"]):
            assert time.monotonic() < deadline
            time.sleep(0.05)
        assert len(mesh_nodes) == 3

        def rounds(n):
            for _ in range(n):
                for node in mesh_nodes:
                    asyncio.run_coroutine_threadsafe(node._round(), node.loop).result(30)

        rounds(4)
        listed = [sorted(w["url"] for w in _http(b + "/workers")[1]["workers"]) for b in bases]
        assert listed == [[wurl]] * 3
        body = {"model": "tiny-mesh", "messages": [{"role": "user", "content": "w5 w6 w7"}],
                "max_tokens": 6, "temperature": 0, "ignore_eos": True}
        texts = []
        for b in bases:
            st, chat = _http(b + "/v1/chat/completions", body)
            assert st == 200, (b, chat)
            texts.append(chat["choices"][0]["message"]["content"])
        assert texts[0] == texts[1] == texts[2] and texts[0]
        wid = next(w["worker_id"] for w in _http(bases[0] + "/workers")[1]["workers"])
        assert _http(f"{bases[0]}/workers/{wid}", method="DELETE")[0] in (200, 202)
        rounds(4)
        assert [_http(b + "/workers")[1]["workers"] for b in bases] == [[], [], []]
    finally:
        for i, stop in enumerate(stops):
            loops[i].loop.call_soon_threadsafe(stop.set)
        for i, f in enumerate(futures):
            if i == 2:
                f.cancel()
            try:
                f.result(60)
            except BaseException:  # noqa: BLE001 — the reference's ends cancelled
                pass
        for lp in loops:
            lp.close()
        wloop.run(server.stop(grace=None))
        wloop.close()
        engine.stop()
