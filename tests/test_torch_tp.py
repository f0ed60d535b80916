"""Tensor parallelism of the port (``smg_tpu_torch/parallel/``) held against
the JAX package's tp engine on the CPU, with gloo rank processes started by
``spawn``.

- (a) ``ParallelConfig`` and ``from_spec``: the reference's sizes, world
  size and errors over a grid of specs;
- (b) ``validate_engine_config``: the reference's issues (severity, field,
  message) over a grid of tp/pp/sp/ep and cache/scheduler settings, on the
  tiny model, Llama-3-8B, Gemma-2 and the tiny MoE;
- (c) ``shard_params``: the rank shards concatenate back to the whole
  params at tp=2 and 4, with the KV heads replicated at tp=4 (2 KV heads);
- (d) the sharded ``forward_prefill`` and ``forward_decode_horizon`` (rank
  threads over gloo) against the JAX functions, float32, 2e-5, and each
  rank's KV cache against its lanes of the JAX cache;
- (e) engine streams: the port's tp=2 (and tp=4 on the tiny model's 2 KV
  heads) against the JAX tp engine on the same weights: tokens exact at
  temperature 0, logprobs within 1e-3 (the reference's own tp bound), with
  overlap on and off, horizons 1 and 4, a chunked prompt and greedy
  speculation; at temperature 0.8 the port's tp=2 against the port's tp=1
  (threefry is not ported), tokens exact;
- (f) the mesh surfaces: ``loads()["mesh"]``, the gauge, the flight ring;
- (g) a zero-leak ``audit()`` after tp traffic;
- (h) ``close()`` leaves no child process; (i) a follower killed mid-run,
  or one whose call fails while rank 0 waits in a collective, turns the
  engine unhealthy and fails the call well inside the timeout;
- (j) ``decode_graphs=True`` under gloo raises; (k) a mesh larger than the
  devices raises with the reference's message; the refused features name
  their ``ROADMAP.md`` items.

One tp=2 and one tp=4 engine serve the whole module (``flush_cache``
between cases; the scheduler's knobs switched on ``scheduler.sched``)."""

import dataclasses
import functools
import multiprocessing
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smg_tpu.config import validation as jval
from smg_tpu.engine import config as jconf
from smg_tpu.models import config as jmodels
from smg_tpu.models import llama as jl
from smg_tpu.ops.rope import rope_frequencies
from smg_tpu_torch.config import validation as tval
from smg_tpu_torch.engine import config as tconf
from smg_tpu_torch.engine.engine import Engine
from smg_tpu_torch.models import config as tmodels
from smg_tpu_torch.models.convert import params_from_jax
from smg_tpu_torch.models.llama import LlamaModel
from smg_tpu_torch.parallel.group import RankGroups, connect_store, open_store
from smg_tpu_torch.parallel.sharding import rank_config, shard_params, shard_plan
from smg_tpu_torch.protocols.sampling import SamplingParams
from smg_tpu_torch.tokenizer import MockTokenizer
from test_tp_decode import PROMPT, SPEC_PROMPT
from test_tp_decode import gen as jax_gen
from test_tp_decode import make_engine as jax_engine

torch.set_num_threads(2)
TIMEOUT = 60.0  # the rank threads' collectives, and every wait on an engine
DEAD_RANK_S = 30.0  # a killed follower fails its engine's request within this
FWD_TOL = dict(rtol=2e-5, atol=2e-5)
LONG_PROMPT = [(7 * j) % 300 + 5 for j in range(96)]


def port_model(jcfg) -> tmodels.ModelConfig:
    names = {f.name for f in dataclasses.fields(tmodels.ModelConfig)}
    return tmodels.ModelConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items()
                                  if k in names})


@pytest.fixture(scope="module")
def weights():
    jcfg = jmodels.tiny_test_config()
    # jitted, as the reference's runner draws them (eager init rounds the
    # scale product differently in the last bit)
    jp = jax.jit(functools.partial(jl.init_params, jcfg))(jax.random.PRNGKey(0))
    return jcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp))


# ---- (a) ParallelConfig ----

SPECS = ["tp=4", "dp=2,tp=4", " tp = 2 , pp=2", "sp=2,ep=2", "", "tp=1", "pp=3,dp=1",
         "tp=2,tp=4", "xx=2", "tp", "tp=0", "tp=a", "tp=-1"]


@pytest.mark.parametrize("base", [None, (1, 2, 1, 1, 1), (2, 1, 1, 2, 1)],
                         ids=["nobase", "tp2", "dp2ep2"])
@pytest.mark.parametrize("spec", SPECS)
def test_parallel_config_from_spec_matches_reference(spec, base):
    jbase = tbase = None
    if base is not None:
        kw = dict(zip(("dp", "tp", "sp", "ep", "pp"), base))
        jbase, tbase = jconf.ParallelConfig(**kw), tconf.ParallelConfig(**kw)

    def parse(cls, b):
        try:
            p = cls.from_spec(spec, base=b)
        except ValueError as e:
            return "error", str(e)
        return p.axis_sizes(), p.world_size

    assert parse(tconf.ParallelConfig, tbase) == parse(jconf.ParallelConfig, jbase)


# ---- (b) validate_engine_config ----

MODELS = {
    "tiny": (jmodels.tiny_test_config, tmodels.tiny_test_config),
    "llama3_8b": (jmodels.llama3_8b_config, tmodels.llama3_8b_config),
    "gemma2": (jmodels.tiny_gemma2_config, tmodels.tiny_gemma2_config),
    "moe": (jmodels.tiny_moe_config, tmodels.tiny_moe_config),
}
AXES = [(1, 1, 1, 1), (2, 1, 1, 1), (4, 1, 1, 1), (8, 1, 1, 1), (3, 1, 1, 1), (16, 1, 1, 1),
        (1, 2, 1, 1), (1, 3, 1, 1), (2, 2, 2, 1), (1, 1, 3, 1), (1, 1, 1, 2), (1, 1, 1, 3),
        (2, 1, 1, 4)]
COHERENCE = {
    "default": ({}, {}),
    "pinned_small": (dict(auto_size=False, num_pages=9), dict(max_seq_len=250)),
    "pinned_short": (dict(auto_size=False, num_pages=12), dict(max_seq_len=512,
                                                               decode_horizon=4)),
    "f32_kv_spec": (dict(dtype="float32"), dict(speculative=True, speculative_tier="draft")),
    "bad_dtype": (dict(dtype="int8"), dict(decode_horizon=600, max_seq_len=512)),
}


def _issues(mod, cfg):
    return [(i.severity, i.field, i.message) for i in mod.validate_engine_config(cfg)]


@pytest.mark.parametrize("coherence", list(COHERENCE))
@pytest.mark.parametrize("axes", AXES, ids=["x".join(map(str, a)) for a in AXES])
@pytest.mark.parametrize("model", list(MODELS))
def test_validate_engine_config_matches_reference(model, axes, coherence):
    jm, tm = (f() for f in MODELS[model])
    tp, pp, sp, ep = axes
    cache_kw, sched_kw = COHERENCE[coherence]
    sched_kw = dict(sched_kw)
    sched_kw.setdefault("max_prefill_tokens", 96)
    sched_kw["prefill_token_buckets"] = (48, 96)
    dtype = "bfloat16"
    jcfg = jconf.EngineConfig(
        model=jm, parallel=jconf.ParallelConfig(tp=tp, pp=pp, sp=sp, ep=ep),
        cache=jconf.CacheConfig(**cache_kw), scheduler=jconf.SchedulerConfig(**sched_kw),
        dtype=dtype)
    tcfg = tconf.EngineConfig(
        model=dataclasses.replace(tm, dtype=dtype),
        parallel=tconf.ParallelConfig(tp=tp, pp=pp, sp=sp, ep=ep),
        cache=tconf.CacheConfig(**cache_kw), scheduler=tconf.SchedulerConfig(**sched_kw))
    assert _issues(tval, tcfg) == _issues(jval, jcfg)


# ---- (c) shard_params ----

@pytest.mark.parametrize("tp", [2, 4])
def test_shard_params_round_trip(weights, tp):
    jcfg, _, full = weights
    cfg = port_model(jcfg)
    D = cfg.head_dim
    shards = [shard_params(full, cfg, tp, r) for r in range(tp)]
    rcfg = rank_config(cfg, tp)
    assert all(s[0] == rcfg for s in shards)
    assert rcfg.num_heads == cfg.num_heads // tp
    assert rcfg.intermediate_size == cfg.intermediate_size // tp
    lay = [s[1]["layers"] for s in shards]
    cat = lambda key, dim: torch.cat([x[key] for x in lay], dim=dim)  # noqa: E731
    for key in ("wq", "w_gate", "w_up"):
        torch.testing.assert_close(cat(key, -1), full["layers"][key], rtol=0, atol=0)
    for key in ("wo", "w_down"):
        torch.testing.assert_close(cat(key, -2), full["layers"][key], rtol=0, atol=0)
    for key in ("attn_norm", "mlp_norm"):
        for x in lay:
            assert torch.equal(x[key], full["layers"][key])
    torch.testing.assert_close(torch.cat([s[1]["embed"] for s in shards], 0), full["embed"],
                               rtol=0, atol=0)
    torch.testing.assert_close(torch.cat([s[1]["lm_head"] for s in shards], -1),
                               full["lm_head"], rtol=0, atol=0)
    K = cfg.num_kv_heads
    for key in ("wk", "wv"):
        if tp <= K:
            torch.testing.assert_close(cat(key, -1), full["layers"][key], rtol=0, atol=0)
        else:  # replicated: rank r keeps KV head r*K//tp, whole
            assert rcfg.num_kv_heads == 1
            for r, x in enumerate(lay):
                g = r * K // tp
                assert torch.equal(x[key], full["layers"][key][..., g * D:(g + 1) * D])
            # every query head of the rank groups onto that KV head
            for r in range(tp):
                h0, h1 = shard_plan(cfg, tp, r).heads
                assert {h // (cfg.num_heads // K) for h in range(h0, h1)} == {r * K // tp}


# ---- (d) the sharded forwards, rank threads over gloo ----

def run_ranks(tp: int, fn):
    """``fn(rank, groups)`` on ``tp`` threads, one gloo rank each."""
    store = open_store(tp, TIMEOUT)
    out, errors = [None] * tp, []

    def body(r):
        try:
            st = store if r == 0 else connect_store(store.port, tp, TIMEOUT)
            out[r] = fn(r, RankGroups(st, r, ["cpu"] * tp, TIMEOUT))
        except BaseException as e:  # noqa: BLE001 - re-raised on the test's thread
            errors.append(e)

    threads = [threading.Thread(target=body, args=(r,)) for r in range(tp)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT * 2)
    if errors:
        raise errors[0]
    return out


def _lanes(x: np.ndarray, plan, D: int) -> np.ndarray:
    return x[..., plan.kv_heads[0] * D:plan.kv_heads[1] * D]


@pytest.fixture(scope="module")
def jax_forwards(weights):
    """The JAX side of (d), once: two prefill chunks over random caches,
    then a 4-column horizon of 3 lanes, the Pallas kernels in interpret
    mode."""
    jcfg, jp, _ = weights
    D = jcfg.head_dim
    inv = jnp.asarray(rope_frequencies(jcfg.head_dim, jcfg.rope_theta, jcfg.rope_scaling))
    L, KD, PS, MP, P = jcfg.num_layers, jcfg.num_kv_heads * D, 16, 8, 40
    rng = np.random.default_rng(7)
    x = dict(kc=rng.standard_normal((L, P, PS, KD)).astype(np.float32),
             vc=rng.standard_normal((L, P, PS, KD)).astype(np.float32),
             pt=np.arange(3, 3 + MP, dtype=np.int32),
             chunks=[(rng.integers(1, jcfg.vocab_size, 24).astype(np.int32), 20),
                     (rng.integers(1, jcfg.vocab_size, 32).astype(np.int32), 27)],
             B=3, N=4, entry=np.array([20, 33, 7], np.int32),
             pts=np.stack([np.arange(1 + i * 12, 1 + i * 12 + MP)
                           for i in range(3)]).astype(np.int32),
             toks0=np.array([5, 77, 300], np.int32))
    jk, jv = jnp.asarray(x["kc"]), jnp.asarray(x["vc"])
    x["want_prefill"], prefix = [], 0
    for toks, t_real in x["chunks"]:
        lo, jk, jv = jl.forward_prefill(jp, jcfg, inv, jnp.asarray(toks), jnp.int32(prefix),
                                        jnp.int32(t_real), jk, jv, jnp.asarray(x["pt"]),
                                        attn_impl="pallas_interpret")
        x["want_prefill"].append(np.asarray(lo))
        prefix += t_real
    x["want_k"], x["want_v"] = np.asarray(jk), np.asarray(jv)
    jhk = jnp.zeros((L, x["B"], x["N"], KD), jnp.float32)
    jhv = jnp.zeros_like(jhk)
    x["want_decode"], toks = [], x["toks0"]
    for j in range(x["N"]):
        lo, jhk, jhv = jl.forward_decode_horizon(
            jp, jcfg, inv, jnp.asarray(toks), jnp.asarray(x["entry"] + j),
            jnp.asarray(x["entry"]), jnp.int32(j), jnp.asarray(x["kc"]),
            jnp.asarray(x["vc"]), jnp.asarray(x["pts"]), jhk, jhv,
            attn_impl="pallas_interpret")
        x["want_decode"].append(np.asarray(lo))
        toks = np.asarray(jnp.argmax(lo, -1)).astype(np.int32)
    x["want_hk"] = np.asarray(jhk)
    return x


@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_forwards_match_jax(weights, jax_forwards, tp):
    jcfg, _, full = weights
    cfg = port_model(jcfg)
    D, L = cfg.head_dim, cfg.num_layers
    x = jax_forwards
    kc, vc, pt, chunks, pts = x["kc"], x["vc"], x["pt"], x["chunks"], x["pts"]
    B, N, entry, toks0 = x["B"], x["N"], x["entry"], x["toks0"]
    want_prefill, want_decode = x["want_prefill"], x["want_decode"]
    want_k, want_v, want_hk = x["want_k"], x["want_v"], x["want_hk"]

    i32 = lambda x: torch.tensor(np.asarray(x), dtype=torch.int32)  # noqa: E731

    def rank(r, groups):
        plan = shard_plan(cfg, tp, r)
        rcfg, rp = shard_params(full, cfg, tp, r)
        model = LlamaModel(rcfg, rp, tp=groups)
        tk = torch.from_numpy(_lanes(kc, plan, D).copy())
        tv = torch.from_numpy(_lanes(vc, plan, D).copy())
        got_prefill, prefix = [], 0
        for toks, t_real in chunks:
            got_prefill.append(model.forward_prefill(
                i32(toks), i32([prefix]), i32([t_real]), tk, tv, i32(pt)).numpy())
            prefix += t_real
        KDr = rcfg.num_kv_heads * D
        hk = torch.zeros((L, B, N, KDr))
        hv = torch.zeros_like(hk)
        dk = torch.from_numpy(_lanes(kc, plan, D).copy())
        dv = torch.from_numpy(_lanes(vc, plan, D).copy())
        got_decode, toks = [], toks0
        for j in range(N):
            lo = model.forward_decode_horizon(i32(toks), i32(entry + j), i32(entry), j,
                                              dk, dv, i32(pts), hk, hv)
            got_decode.append(lo.numpy())
            toks = want_decode[j].argmax(-1).astype(np.int32)  # the reference's chain
        return plan, got_prefill, tk.numpy(), tv.numpy(), got_decode, hk.numpy()

    for plan, got_prefill, tk, tv, got_decode, hk in run_ranks(tp, rank):
        for got, want in zip(got_prefill, want_prefill):
            np.testing.assert_allclose(got, want, **FWD_TOL)
            assert int(got.argmax()) == int(want.argmax())
        np.testing.assert_allclose(tk, _lanes(want_k, plan, D), **FWD_TOL)
        np.testing.assert_allclose(tv, _lanes(want_v, plan, D), **FWD_TOL)
        for got, want in zip(got_decode, want_decode):
            np.testing.assert_allclose(got, want, **FWD_TOL)
            np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        np.testing.assert_allclose(hk, _lanes(want_hk, plan, D), **FWD_TOL)


# ---- (e)-(g) the module's engines ----

def port_engine(full, tp: int) -> Engine:
    cfg = tconf.EngineConfig(
        model=tmodels.tiny_test_config(), parallel=tconf.ParallelConfig(tp=tp),
        cache=tconf.CacheConfig(page_size=16, num_pages=128, auto_size=False, dtype="float32"),
        scheduler=tconf.SchedulerConfig(
            max_batch_size=4, max_seq_len=512, max_prefill_tokens=64,
            prefill_token_buckets=(32, 64), decode_batch_buckets=(4,)),
        decode_graphs=False)
    if tp == 1:
        return Engine(cfg, params=full, device="cpu", tokenizer=MockTokenizer())
    return Engine(cfg, params=full, devices=["cpu"] * tp, tokenizer=MockTokenizer())


@pytest.fixture(scope="module")
def engines(weights):
    built = {tp: port_engine(weights[2], tp) for tp in (1, 2, 4)}
    yield built
    for e in built.values():
        e.close()


def port_gen(eng, temp=0.0, n=24, prompt=PROMPT, **sched):
    """``generate`` from a fresh engine's state: no cached prefix, the
    sampling counter at 0 (a mirrored call: every rank rewinds)."""
    eng.flush_cache()
    eng.runner.rng_restore(0)
    base = dict(overlap_schedule=True, decode_horizon=1, max_prefill_tokens=64,
                speculative=False)
    eng.scheduler.sched = dataclasses.replace(eng.scheduler.sched, **{**base, **sched})
    return eng.generate(prompt, SamplingParams(temperature=temp, max_new_tokens=n,
                                               ignore_eos=True))


# (case id, tp, reference make_engine kwargs, the port's scheduler knobs, gen kwargs)
STREAMS = [
    ("overlap_h1", 2, dict(overlap=True, horizon=1), dict(overlap_schedule=True), {}),
    ("sync_h4", 2, dict(overlap=False, horizon=4),
     dict(overlap_schedule=False, decode_horizon=4), {}),
    ("chunked_96_at_32", 2,
     dict(max_prefill_tokens=32, buckets=(32,), pages=128, max_seq_len=512),
     dict(max_prefill_tokens=32), dict(prompt=LONG_PROMPT)),
    ("spec_greedy", 2, dict(spec=True), dict(speculative=True),
     dict(prompt=SPEC_PROMPT, n=32)),
    ("tp4_kv_replicated_h4", 4, dict(horizon=4), dict(decode_horizon=4), {}),
]


@pytest.mark.parametrize("case,tp,jkw,skw,gkw", STREAMS, ids=[s[0] for s in STREAMS])
def test_tp_streams_match_jax_tp_engine(weights, engines, cpu_devices, case, tp, jkw, skw,
                                        gkw):
    jcfg, jp, _ = weights
    je = jax_engine(jconf.ParallelConfig(tp=tp), cpu_devices[:tp], **jkw)
    _assert_same_weights(je, jp)
    want = jax_gen(je, temp=0.0, **gkw)
    got = port_gen(engines[tp], temp=0.0, **skw, **gkw)
    assert got.token_ids == want.token_ids
    assert got.finish_reason == want.finish_reason
    np.testing.assert_allclose(got.logprobs, want.logprobs, atol=1e-3)
    if skw.get("speculative"):
        assert engines[tp].scheduler.num_spec_drafted > 0


def _assert_same_weights(je, jp):
    """The reference's ``make_engine`` draws its weights from seed 0 with
    the same jitted ``init_params``: the tree the port's engines hold."""
    got = jax.tree.map(np.asarray, je.runner.params)
    want = jax.tree.map(np.asarray, jp)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b), got, want)


@pytest.mark.parametrize("overlap,horizon", [(True, 4), (False, 1)])
def test_tp2_sampled_streams_match_port_tp1(engines, overlap, horizon):
    kw = dict(overlap_schedule=overlap, decode_horizon=horizon)
    want = port_gen(engines[1], temp=0.8, **kw)
    got = port_gen(engines[2], temp=0.8, **kw)
    assert got.token_ids == want.token_ids
    np.testing.assert_allclose(got.logprobs, want.logprobs, atol=1e-3)


def test_tp2_overlap_loop_thread_matches_sync(engines):
    """The engine loop thread with the overlap pipeline (launches and
    fetches from the loop, submits and an abort from this thread): every
    stream equals the synchronous tp=1 engine's."""
    prompts = {f"r{i}": [(5 * i + j) % 90 + 5 for j in range(16 + 3 * i)] for i in range(4)}
    want = {rid: port_gen(engines[1], prompt=p, n=20, decode_horizon=4,
                          overlap_schedule=False).token_ids for rid, p in prompts.items()}
    eng = engines[2]
    eng.flush_cache()
    eng.scheduler.sched = dataclasses.replace(eng.scheduler.sched, overlap_schedule=True,
                                              decode_horizon=4, max_prefill_tokens=64,
                                              speculative=False)
    outs = {rid: [] for rid in prompts}
    done = {rid: threading.Event() for rid in prompts}
    kept0 = eng.loads()["lookahead_kept"]
    eng.start()
    try:
        eng.submit(list(range(40, 90)), SamplingParams(max_new_tokens=400, ignore_eos=True),
                   rid="gone")
        for rid, p in prompts.items():
            eng.submit(p, SamplingParams(temperature=0.0, max_new_tokens=20, ignore_eos=True),
                       rid=rid, on_output=lambda o, rid=rid: (
                           outs[rid].append(o), o.finished and done[rid].set()))
        time.sleep(0.05)
        eng.abort("gone")
        for rid, ev in done.items():
            assert ev.wait(TIMEOUT), rid
    finally:
        eng.stop()
    got = {rid: [t for o in c for t in o.new_token_ids] for rid, c in outs.items()}
    assert got == want
    assert eng.loads()["lookahead_kept"] > kept0  # the overlap pipeline ran
    audit = eng.audit()
    assert audit["quiescent"] and audit["clean"] and audit["leaked_pages"] == 0, audit


def test_tp_mesh_surfaces(engines):
    eng = engines[2]
    port_gen(eng, n=8)
    mesh = eng.loads()["mesh"]
    assert mesh == {"devices": 2, "shape": {"dp": 1, "tp": 2, "sp": 1, "ep": 1, "pp": 1},
                    "platform": "cpu", "backend": "gloo"}
    sample = list(eng.metrics.mesh_devices.collect())[0].samples[0]
    assert sample.value == 2.0
    recs = eng.dump_flight("test")["ring"]
    assert recs and all(r["mesh"] == 2 for r in recs)
    assert engines[1].loads()["mesh"]["devices"] == 1
    assert engines[1].loads()["mesh"]["backend"] is None


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_zero_leak_audit(engines, tp):
    eng = engines[tp]
    for k in range(3):
        port_gen(eng, temp=0.8 if k % 2 else 0.0, n=16, decode_horizon=2)
    audit = eng.audit()
    assert audit["quiescent"] is True and audit["clean"] is True
    assert audit["leaked_pages"] == 0


def test_refused_features_name_their_items(engines, weights):
    eng = engines[2]
    with pytest.raises(NotImplementedError, match="item 9k"):
        eng.embed([[5, 6, 7]])
    with pytest.raises(NotImplementedError, match="item 9l"):
        eng.prefill_export([5, 6, 7], SamplingParams(max_new_tokens=1))
    with pytest.raises(NotImplementedError, match="item 9h"):
        eng.load_lora_adapter("a", data=b"")
    assert eng.runner.supports_kv_transfer is False
    assert eng.healthy  # a refusal breaks nothing
    base = tconf.EngineConfig(model=tmodels.tiny_test_config(), decode_graphs=False)
    # pp, sp and ep are served since items 9c-9e; dp stays refused, and the
    # expert layer under tp (tests/test_torch_ep.py)
    for axes, item in ((dict(tp=2, dp=2), "9g"), (dict(dp=2), "9g")):
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            Engine(dataclasses.replace(base, parallel=tconf.ParallelConfig(**axes)),
                   devices=["cpu"] * 4)
    moe = dataclasses.replace(base, model=tmodels.tiny_moe_config(),
                              parallel=tconf.ParallelConfig(tp=2))
    with pytest.raises(NotImplementedError, match="item 9i"):
        Engine(moe, devices=["cpu", "cpu"])


# ---- (h)-(k) lifecycle and construction errors ----

def _tp_children() -> list:
    return [p for p in multiprocessing.active_children() if p.name.startswith("smg-tp-rank")]


def test_close_leaves_no_child_and_a_killed_follower_fails_fast(weights):
    before = set(_tp_children())
    eng = port_engine(weights[2], 2)
    procs = list(eng._leader.procs)
    assert all(p.is_alive() for p in procs)
    chunks, done = [], threading.Event()
    eng.start()
    try:
        eng.submit(PROMPT, SamplingParams(max_new_tokens=400, ignore_eos=True), rid="long",
                   on_output=lambda o: (chunks.append(o), o.finished and done.set()))
        deadline = time.monotonic() + TIMEOUT
        while not chunks and time.monotonic() < deadline:
            time.sleep(0.01)
        assert chunks, "no token before the kill"
        t_kill = time.monotonic()
        procs[0].kill()
        # far inside the engine's TP_TIMEOUT_S: gloo sees the reset connection
        assert done.wait(DEAD_RANK_S), "the request did not end after its rank died"
        assert chunks[-1].finish_reason == "error"
        while eng.healthy and time.monotonic() - t_kill < DEAD_RANK_S:
            time.sleep(0.05)
        assert not eng.healthy
        assert time.monotonic() - t_kill < DEAD_RANK_S
        with pytest.raises(RuntimeError, match="broken|exited"):  # a call with collectives
            eng.runner.prefill([5, 6, 7], 0, np.arange(1, 9, dtype=np.int32), 0.0, -1, 1.0, 0.0)
        eng.runner.rng_restore(0)  # state alone: rank 0 keeps it, the recovery completes
    finally:
        eng.close()
    assert not any(p.is_alive() for p in procs)
    assert set(_tp_children()) <= before
    ok = port_engine(weights[2], 2)
    kids = [p for p in _tp_children() if p not in before]
    assert len(kids) == 1 and kids[0].is_alive()
    ok.close()
    assert not kids[0].is_alive() and set(_tp_children()) <= before


def test_a_call_failing_on_a_follower_alone_fails_fast(weights, monkeypatch):
    from smg_tpu_torch.parallel import leader as leader_mod

    eng = port_engine(weights[2], 2)
    procs = list(eng._leader.procs)
    # the follower receives arguments its prefill cannot take; rank 0 makes
    # the call as given and waits in the embedding's all-reduce
    wire = leader_mod._wire
    monkeypatch.setattr(leader_mod, "_wire",
                        lambda obj: ("not", "a", "prompt") if isinstance(obj, tuple)
                        else wire(obj))
    held = {}

    def call():
        try:
            eng.runner.prefill([5, 6, 7], 0, np.arange(1, 9, dtype=np.int32), 0.0, -1, 1.0,
                               0.0)
        except Exception as e:  # noqa: BLE001 - read below
            held["error"] = e

    try:
        t0 = time.monotonic()
        caller = threading.Thread(target=call)
        caller.start()
        caller.join(DEAD_RANK_S)
        assert not caller.is_alive(), "rank 0 still waits after its follower's call failed"
        assert time.monotonic() - t0 < DEAD_RANK_S
        assert "error" in held
        procs[0].join(DEAD_RANK_S)
        assert procs[0].exitcode == 5
        assert not eng.healthy
        monkeypatch.setattr(leader_mod, "_wire", wire)
        with pytest.raises(RuntimeError, match="broken"):
            eng.runner.prefill([5, 6, 7], 0, np.arange(1, 9, dtype=np.int32), 0.0, -1, 1.0,
                               0.0)
    finally:
        for p in procs:  # a follower still in its loop would hold rank 0 in the collective
            p.kill()
        eng.close()
    assert not any(p.is_alive() for p in procs)


def test_decode_graphs_under_gloo_raises():
    cfg = tconf.EngineConfig(model=tmodels.tiny_test_config(),
                             parallel=tconf.ParallelConfig(tp=2), decode_graphs=True)
    with pytest.raises(ValueError, match="decode_graphs=True needs the nccl backend"):
        Engine(cfg, devices=["cpu", "cpu"])


def test_more_devices_than_present_raises_with_the_reference_message():
    cfg = tconf.EngineConfig(model=tmodels.tiny_test_config(),
                             parallel=tconf.ParallelConfig(tp=2), decode_graphs=False)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    want = f"mesh {cfg.parallel.axis_sizes()} needs 2 devices, found "
    with pytest.raises(RuntimeError, match=None) as e:
        Engine(dataclasses.replace(cfg, parallel=tconf.ParallelConfig(tp=found + 2)))
    assert str(e.value) == (f"mesh {tconf.ParallelConfig(tp=found + 2).axis_sizes()} needs "
                            f"{found + 2} devices, found {found}")
    with pytest.raises(RuntimeError) as e:
        Engine(cfg, devices=["cpu"])
    assert str(e.value) == want + "1"
