"""Pipeline parallelism of the port (``parallel/pp_serving.py`` and the pp
axis of ``parallel/group.py`` and ``parallel/sharding.py``) held against the
JAX package's serving pipeline (``smg_tpu/parallel/pp_serving.py``) on the
CPU, with gloo rank processes started by ``spawn``.

- (a) ``shards_from_jax``: every stage's (and a pp x tp rank's) part of a
  JAX tree rebuilds the whole tree, and the grid lays ranks out in the
  reference's ``AXIS_ORDER``;
- (b) the staged ``forward_prefill`` (two chunks) and
  ``forward_decode_horizon`` (four columns), rank threads over gloo, against
  the JAX functions, float32 within 1e-5, and each stage's KV against its
  layers of the JAX cache;
- (c) engine streams of the port's pp=2, pp=4 (one layer a stage), a
  chunked prompt and pp=2 x tp=2 against the reference's engines of the
  same mesh (``tests/test_pp_serving.py``), tokens exact and logprobs
  within 1e-5; (d) an adapter under pp=2 against the reference's;
- (e) the mesh surfaces, a pp engine that never speculates, horizon 4 and
  a zero-leak audit;
- (f) what a rank mesh refuses names its ``ROADMAP.md`` item.

One port engine per mesh serves the module (``flush_cache`` between
cases)."""

import dataclasses
import functools
import threading

import jax
import numpy as np
import pytest
import torch

from smg_tpu.engine import config as jconf
from smg_tpu.models import config as jmodels
from smg_tpu.models import llama as jl
from smg_tpu.ops.rope import rope_frequencies
from smg_tpu.protocols.sampling import SamplingParams as JaxSamplingParams
from smg_tpu_torch.engine import config as tconf
from smg_tpu_torch.engine.engine import Engine
from smg_tpu_torch.models import config as tmodels
from smg_tpu_torch.models.convert import params_from_jax, shards_from_jax
from smg_tpu_torch.models.llama import LlamaModel
from smg_tpu_torch.parallel.group import AXIS_ORDER, RankGroups, connect_store, open_store
from smg_tpu_torch.parallel.group import rank_coords
from smg_tpu_torch.parallel.sharding import RankPlace, shard_plan
from smg_tpu_torch.protocols.sampling import SamplingParams
from smg_tpu_torch.tokenizer import MockTokenizer
from test_lora import strong_adapter
from test_pp_serving import _engine as jax_engine

torch.set_num_threads(2)
TIMEOUT = 60.0
TOL = dict(rtol=1e-5, atol=1e-5)
PROMPT = [(i * 5) % 90 + 7 for i in range(30)]  # test_pp_serving's prompts
CHUNKED = [(i * 7) % 90 + 5 for i in range(100)]  # chunks of 64 + 36
PP_TP = [(i * 3) % 90 + 5 for i in range(20)]


def port_model(jcfg) -> tmodels.ModelConfig:
    names = {f.name for f in dataclasses.fields(tmodels.ModelConfig)}
    return tmodels.ModelConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items()
                                  if k in names})


@pytest.fixture(scope="module")
def weights():
    jcfg = jmodels.tiny_test_config()
    # jitted, as the reference's runner draws them
    jp = jax.jit(functools.partial(jl.init_params, jcfg))(jax.random.PRNGKey(0))
    return jcfg, jp, jax.tree.map(np.asarray, jp)


def run_grid(sizes: dict, fn):
    """``fn(rank, groups)`` on one thread a rank of the grid ``sizes`` (gloo
    on the CPU); the results in rank order."""
    world = int(np.prod(list(sizes.values())))
    store = open_store(world, TIMEOUT)
    out, errors = [None] * world, []

    def body(r):
        try:
            st = store if r == 0 else connect_store(store.port, world, TIMEOUT)
            out[r] = fn(r, RankGroups(st, r, ["cpu"] * world, TIMEOUT, sizes=sizes))
        except BaseException as e:  # noqa: BLE001 - re-raised on the test's thread
            errors.append(e)

    threads = [threading.Thread(target=body, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT * 2)
    if errors:
        raise errors[0]
    return out


# ---- (a) the grid and the shards ----

GRIDS = {"pp2": dict(pp=2), "pp4": dict(pp=4), "pp2_tp2": dict(pp=2, tp=2)}


def test_rank_grid_follows_the_reference_axis_order():
    from smg_tpu.parallel.mesh import AXIS_ORDER as J_ORDER

    assert AXIS_ORDER == J_ORDER
    sizes = dict(pp=2, ep=1, sp=2, tp=2)
    # the reference's mesh reshapes the device list in AXIS_ORDER: rank r is
    # the r-th device of that array
    shape = tuple(sizes.get(a, 1) for a in J_ORDER)
    for r in range(8):
        idx = np.unravel_index(r, shape)
        assert rank_coords(sizes, r) == {a: int(i) for a, i in zip(J_ORDER, idx)}


@pytest.mark.parametrize("grid", list(GRIDS))
def test_shards_from_jax_rebuild_the_tree(weights, grid):
    jcfg, _, tree = weights
    cfg = port_model(jcfg)
    par = tconf.ParallelConfig(**GRIDS[grid])
    shards = shards_from_jax(tree, cfg, par)
    full = params_from_jax(tree)
    sizes = par.axis_sizes()
    places = [RankPlace.of(sizes, rank_coords(sizes, r)) for r in range(par.world_size)]
    S = par.pp
    for name, whole in full["layers"].items():
        stages = []
        for s in range(S):
            ranks = [i for i, p in enumerate(places) if p.stage == s]
            parts = [shards[i][1]["layers"][name] for i in ranks]
            if par.tp > 1 and name in ("wq", "wk", "wv", "w_gate", "w_up"):
                stages.append(torch.cat(parts, dim=-1))
            elif par.tp > 1 and name in ("wo", "w_down"):
                stages.append(torch.cat(parts, dim=-2))
            else:
                assert all(torch.equal(p, parts[0]) for p in parts)
                stages.append(parts[0])
        assert all(t.shape[0] == cfg.num_layers // S for t in stages)
        torch.testing.assert_close(torch.cat(stages), whole, rtol=0, atol=0)
    for i, (rcfg, rp) in enumerate(shards):
        p = places[i]
        assert rcfg.num_layers == cfg.num_layers // S
        assert ("embed" in rp) == p.first
        assert ("lm_head" in rp) == ("final_norm" in rp) == p.last
    firsts = [rp["embed"] for (_, rp), p in zip(shards, places) if p.first]
    lasts = [rp["lm_head"] for (_, rp), p in zip(shards, places) if p.last]
    torch.testing.assert_close(torch.cat(firsts), full["embed"], rtol=0, atol=0)
    torch.testing.assert_close(torch.cat(lasts, dim=-1), full["lm_head"], rtol=0, atol=0)


# ---- (b) the staged forwards, rank threads over gloo ----

@pytest.fixture(scope="module")
def jax_forwards(weights):
    """Two prefill chunks over random caches, then a 4-column horizon of 3
    lanes, the Pallas kernels in interpret mode."""
    import jax.numpy as jnp

    jcfg, jp, _ = weights
    D = jcfg.head_dim
    inv = jnp.asarray(rope_frequencies(jcfg.head_dim, jcfg.rope_theta, jcfg.rope_scaling))
    L, KD, PS, MP, P = jcfg.num_layers, jcfg.num_kv_heads * D, 16, 8, 40
    rng = np.random.default_rng(11)
    x = dict(kc=rng.standard_normal((L, P, PS, KD)).astype(np.float32),
             vc=rng.standard_normal((L, P, PS, KD)).astype(np.float32),
             pt=np.arange(3, 3 + MP, dtype=np.int32),
             chunks=[(rng.integers(1, jcfg.vocab_size, 24).astype(np.int32), 20),
                     (rng.integers(1, jcfg.vocab_size, 32).astype(np.int32), 27)],
             N=4, entry=np.array([20, 33, 7], np.int32),
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
    x["want_k"] = np.asarray(jk)
    jhk = jnp.zeros((L, 3, x["N"], KD), jnp.float32)
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


@pytest.mark.parametrize("grid", list(GRIDS))
def test_staged_forwards_match_jax(weights, jax_forwards, grid):
    jcfg, _, tree = weights
    cfg = port_model(jcfg)
    sizes = GRIDS[grid]
    par = tconf.ParallelConfig(**sizes)
    shards = shards_from_jax(tree, cfg, par)
    x = jax_forwards
    D = cfg.head_dim
    i32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.int32)  # noqa: E731

    def rank(r, groups):
        place = RankPlace.of(par.axis_sizes(), groups.coords)
        rcfg, rp = shards[r]
        model = LlamaModel(rcfg, rp, tp=groups.axis("tp"), pp=groups.axis("pp"))
        a, b = place.layers(cfg)
        kv = (slice(a, b), Ellipsis)
        lanes = (shard_plan(cfg, place.tp, place.tp_rank).kv_heads if place.tp > 1
                 else (0, cfg.num_kv_heads))
        cut = lambda t: t[kv][..., lanes[0] * D:lanes[1] * D].copy()  # noqa: E731
        tk, tv = torch.from_numpy(cut(x["kc"])), torch.from_numpy(cut(x["vc"]))
        got_prefill, prefix = [], 0
        for toks, t_real in x["chunks"]:
            got_prefill.append(model.forward_prefill(
                i32(toks), i32([prefix]), i32([t_real]), tk, tv, i32(x["pt"])).numpy())
            prefix += t_real
        hk = torch.zeros((b - a, 3, x["N"], tk.shape[-1]))
        hv = torch.zeros_like(hk)
        dk, dv = torch.from_numpy(cut(x["kc"])), torch.from_numpy(cut(x["vc"]))
        got_decode, toks = [], x["toks0"]
        for j in range(x["N"]):
            got_decode.append(model.forward_decode_horizon(
                i32(toks), i32(x["entry"] + j), i32(x["entry"]), j, dk, dv, i32(x["pts"]),
                hk, hv).numpy())
            toks = x["want_decode"][j].argmax(-1).astype(np.int32)  # the reference's chain
        return (got_prefill, got_decode, tk.numpy(), cut(x["want_k"]), hk.numpy(),
                cut(x["want_hk"]))

    for got_prefill, got_decode, tk, want_k, hk, want_hk in run_grid(sizes, rank):
        for got, want in zip(got_prefill + got_decode, x["want_prefill"] + x["want_decode"]):
            np.testing.assert_allclose(got, want, **TOL)
            np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        np.testing.assert_allclose(tk, want_k, **TOL)
        np.testing.assert_allclose(hk, want_hk, **TOL)


# ---- (c)-(e) the module's engines ----

def port_engine(tree, **axes) -> Engine:
    """The reference test's engine (``test_pp_serving._engine``) in the port,
    on the bridged weights."""
    par = tconf.ParallelConfig(**axes)
    cfg = tconf.EngineConfig(
        model=dataclasses.replace(tmodels.tiny_test_config(), dtype="float32"), parallel=par,
        cache=tconf.CacheConfig(page_size=16, num_pages=96, auto_size=False, dtype="float32"),
        scheduler=tconf.SchedulerConfig(
            max_batch_size=4, max_seq_len=256, max_prefill_tokens=64,
            prefill_token_buckets=(32, 64), decode_batch_buckets=(4,)),
        decode_graphs=False)
    full = params_from_jax(tree)
    if par.world_size == 1:
        return Engine(cfg, params=full, device="cpu", tokenizer=MockTokenizer())
    return Engine(cfg, params=full, devices=["cpu"] * par.world_size, tokenizer=MockTokenizer())


@pytest.fixture(scope="module")
def engines(weights):
    built = {name: port_engine(weights[2], **axes) for name, axes in GRIDS.items()}
    yield built
    for e in built.values():
        e.close()


def port_gen(eng, prompt, n, **sched):
    eng.flush_cache()
    eng.runner.rng_restore(0)
    base = dict(overlap_schedule=True, decode_horizon=1, speculative=False)
    eng.scheduler.sched = dataclasses.replace(eng.scheduler.sched, **{**base, **sched})
    return eng.generate(prompt, SamplingParams(temperature=0.0, max_new_tokens=n,
                                               ignore_eos=True))


def jax_gen(je, prompt, n, lora=None):
    je.flush_cache()
    return je.generate(prompt_ids=prompt, sampling=JaxSamplingParams(
        temperature=0.0, max_new_tokens=n, ignore_eos=True, lora_adapter=lora))


def _assert_same_weights(je, tree):
    got = jax.tree.map(np.asarray, je.runner.params)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b), got, tree)


# (case, grid, prompt, new tokens)
STREAMS = [("pp2", "pp2", PROMPT, 10), ("pp4", "pp4", PROMPT, 10),
           ("chunked_pp2", "pp2", CHUNKED, 8), ("pp2_tp2", "pp2_tp2", PP_TP, 6)]


@pytest.mark.parametrize("case,grid,prompt,n", STREAMS, ids=[s[0] for s in STREAMS])
def test_pp_streams_match_the_reference_pp_engine(weights, engines, cpu_devices, case, grid,
                                                  prompt, n):
    par = jconf.ParallelConfig(**GRIDS[grid])
    je = jax_engine(par, cpu_devices[:par.world_size])
    try:
        _assert_same_weights(je, weights[2])
        want = jax_gen(je, prompt, n)
    finally:
        je.stop()
    got = port_gen(engines[grid], prompt, n)
    assert got.token_ids == want.token_ids and len(got.token_ids) == n
    np.testing.assert_allclose(got.logprobs, want.logprobs, **TOL)


def test_pp_lora_matches_the_reference(weights, engines, cpu_devices):
    """The adapter bank splits its layer axis with the weights
    (``test_pp_serving.py::test_pp_lora_matches_single``)."""
    je = jax_engine(jconf.ParallelConfig(pp=2), cpu_devices[:2])
    try:
        je.runner.load_lora("s", strong_adapter(je.config.model))
        want = jax_gen(je, PROMPT, 8, lora="s")
        base = jax_gen(je, PROMPT, 8)
    finally:
        je.stop()
    eng = engines["pp2"]
    eng.runner.load_lora("s", strong_adapter(jmodels.tiny_test_config()))
    try:
        eng.flush_cache()
        eng.runner.rng_restore(0)
        got = eng.generate(PROMPT, SamplingParams(temperature=0.0, max_new_tokens=8,
                                                  ignore_eos=True, lora_adapter="s"))
    finally:
        eng.runner.unload_lora("s")
    assert got.token_ids == want.token_ids != base.token_ids
    np.testing.assert_allclose(got.logprobs, want.logprobs, **TOL)
    ranks = eng._leader.rank_reports()
    assert [r["stats"]["prefill_calls"] for r in ranks] == [ranks[0]["stats"]["prefill_calls"]] * 2


def test_pp_surfaces_no_speculation_and_a_clean_audit(engines):
    eng = engines["pp2"]
    want = port_gen(eng, PROMPT, 16, decode_horizon=1).token_ids
    drafted = eng.scheduler.num_spec_drafted
    got = port_gen(eng, [17, 40, 61, 17, 52, 61] * 6, 16, speculative=True)
    assert eng.scheduler.num_spec_drafted == drafted  # a pp engine never speculates
    assert len(got.token_ids) == 16
    assert port_gen(eng, PROMPT, 16, decode_horizon=4).token_ids == want
    assert eng.loads()["mesh"] == {"devices": 2, "platform": "cpu", "backend": "gloo",
                                   "shape": {"dp": 1, "tp": 1, "sp": 1, "ep": 1, "pp": 2}}
    assert list(eng.metrics.mesh_devices.collect())[0].samples[0].value == 2.0
    assert eng.runner.k_cache.shape[0] == 2  # the stage's 2 of 4 layers
    audit = eng.audit()
    assert audit["quiescent"] and audit["clean"] and audit["leaked_pages"] == 0


# ---- (f) refusals ----

def test_refused_compositions_name_their_items(engines):
    eng = engines["pp2"]
    with pytest.raises(NotImplementedError, match="item 9k"):
        eng.embed([[5, 6, 7]])
    with pytest.raises(NotImplementedError, match="item 9l"):
        eng.prefill_export([5, 6, 7], SamplingParams(max_new_tokens=1))
    with pytest.raises(NotImplementedError, match="item 9h"):
        engines["pp2_tp2"].load_lora_adapter("a", data=b"")
    assert eng.healthy and engines["pp2_tp2"].healthy
    base = tconf.EngineConfig(model=tmodels.tiny_test_config(), decode_graphs=False)
    with pytest.raises(NotImplementedError, match="item 9g"):
        Engine(dataclasses.replace(base, parallel=tconf.ParallelConfig(dp=2, pp=2)),
               devices=["cpu"] * 4)
    vlm = dataclasses.replace(base, model=tmodels.tiny_vlm_config(),
                              parallel=tconf.ParallelConfig(pp=2))
    with pytest.raises(NotImplementedError, match="item 9j"):
        Engine(vlm, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="pp=3 does not divide num_layers=4"):
        Engine(dataclasses.replace(base, parallel=tconf.ParallelConfig(pp=3)),
               devices=["cpu"] * 3)
