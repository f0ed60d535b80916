"""The Qwen-MoE family on the port, held against the JAX package on the CPU.

- ``moe_mlp`` against the reference's ``_moe_mlp`` on numpy inputs, for
  ``[T, E]`` and ``[B, K, E]`` inputs, 4 experts top-2 and 8 experts top-4,
  with a token-tile boundary inside the input (tolerance 2e-5);
- ``init_params`` shapes and ``params_from_jax`` on the JAX ``tiny-moe``
  weights;
- the five serving forwards (prefill, grouped prefill, the decode column, the
  verify block, the compat decode) against the JAX forwards on ``tiny-moe``
  and on a Qwen3-MoE-like variant with ``qk_norm`` and 8 query heads over one
  KV head (G=8): 1e-4, argmax exact;
- the port's ``Engine`` against the JAX ``Engine`` on ``tiny-moe``, greedy:
  a chunked prompt, a grouped prefill, a radix hit, overlap on and off, the
  n-gram speculative engine (drafted and accepted counts too) and a batch
  with an adapter lane (tokens, finishes and ``cached_tokens`` identical,
  logprobs to 1e-4);
- ``from_hf_config`` for Qwen3-MoE and Qwen2-MoE configs field by field;
  ``load_params`` on MoE checkpoint directories (one file, 2 shards, bf16)
  bitwise against ``params_from_jax`` of the reference loader;
- ``plan_cache`` leaving the expert layer's reserve;
- ``serve --model-preset tiny-moe``: a chat body equal to the reference
  gateway's over the JAX ``serve`` engine (ids and timestamps removed).

Float32 throughout, weights bridged from the JAX ``init_params``."""

import asyncio
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer
from safetensors.numpy import save_file

from smg_tpu import cli as jcli
from smg_tpu.engine import config as jconf
from smg_tpu.engine.config import EngineConfig as JEngineConfig
from smg_tpu.engine.engine import Engine as JaxEngine
from smg_tpu.gateway import launch as jlaunch
from smg_tpu.gateway import server as jserver
from smg_tpu.gateway.worker_client import InProcWorkerClient as JaxInProc
from smg_tpu.gateway.workers import Worker as JaxWorker
from smg_tpu.models import llama as jl
from smg_tpu.models import lora as jlora
from smg_tpu.models.config import ModelConfig as JModelConfig
from smg_tpu.models.config import tiny_moe_config
from smg_tpu.models.weights import load_params as jload
from smg_tpu.ops.rope import rope_frequencies
from smg_tpu.protocols.sampling import SamplingParams as JaxSamplingParams
from smg_tpu_torch import cli as tcli
from smg_tpu_torch.engine import config as tconf
from smg_tpu_torch.engine import runner as trunner
from smg_tpu_torch.engine.engine import Engine
from smg_tpu_torch.engine.kv_cache import moe_reserve_bytes, plan_cache
from smg_tpu_torch.gateway import launch as tlaunch
from smg_tpu_torch.gateway import server as tserver
from smg_tpu_torch.models import config as tmodels
from smg_tpu_torch.models.config import ModelConfig
from smg_tpu_torch.models.convert import params_from_jax
from smg_tpu_torch.models.llama import (
    MOE_TOKEN_TILE,
    LlamaModel,
    init_params,
    moe_mlp,
    moe_scratch_bytes,
)
from smg_tpu_torch.models.weights import load_params
from smg_tpu_torch.protocols.sampling import SamplingParams

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)
PS, MP, P = 16, 8, 40

CONFIGS = {
    "tiny_moe": tiny_moe_config(),
    # Qwen3-30B-A3B's attention shape in small: qk_norm, 8 query heads over 1 KV head
    "qwen3_moe_g8": dataclasses.replace(tiny_moe_config(), num_kv_heads=1, qk_norm=True,
                                        num_experts=8, num_experts_per_tok=4,
                                        moe_intermediate_size=64, rope_theta=1000000.0),
}


def port_config(jcfg) -> ModelConfig:
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items() if k in names})


@functools.lru_cache(maxsize=None)
def jax_params(name: str, seed: int = 0):
    """The JAX engine's own init (``jax.jit(init_params)``), as numpy."""
    cfg = CONFIGS[name]
    p = jax.jit(functools.partial(jl.init_params, cfg))(jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, p)


# ---- (a) the expert layer ----


@pytest.mark.parametrize("X,k", [(4, 2), (8, 4)])
@pytest.mark.parametrize("lead", [(37,), (3, 5)], ids=["T", "BK"])
def test_moe_mlp_matches_reference(X, k, lead):
    rng = np.random.default_rng(X + len(lead))
    E, Fm = 32, 24
    layer = dict(router=rng.standard_normal((E, X)) * 0.3,
                 w_gate=rng.standard_normal((X, E, Fm)) * 0.2,
                 w_up=rng.standard_normal((X, E, Fm)) * 0.2,
                 w_down=rng.standard_normal((X, Fm, E)) * 0.2)
    layer = {key: v.astype(np.float32) for key, v in layer.items()}
    h = rng.standard_normal((*lead, E)).astype(np.float32)
    cfg = dataclasses.replace(tiny_moe_config(), num_experts=X, num_experts_per_tok=k)
    want = jl._moe_mlp(jax.tree.map(jnp.asarray, layer), jnp.asarray(h), cfg)
    t = {key: torch.from_numpy(v) for key, v in layer.items()}
    n = int(np.prod(lead))
    for tile in (MOE_TOKEN_TILE, 16 if n > 16 else 4):  # one tile, and a boundary inside
        got = moe_mlp(torch.from_numpy(h), t["router"], t["w_gate"], t["w_up"],
                      t["w_down"], k, tile=tile)
        assert got.shape == h.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_moe_mlp_keeps_the_model_dtype_and_each_token_alone():
    """bf16 in, bf16 out; a token's result does not depend on its tile."""
    rng = np.random.default_rng(3)
    E, X, Fm = 32, 8, 16
    w = [torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.2).bfloat16()
         for s in ((E, X), (X, E, Fm), (X, E, Fm), (X, Fm, E))]
    h = torch.from_numpy(rng.standard_normal((20, E)).astype(np.float32)).bfloat16()
    whole = moe_mlp(h, *w, 2)
    assert whole.dtype == torch.bfloat16
    assert torch.equal(moe_mlp(h, *w, 2, tile=7), whole)
    assert torch.equal(moe_mlp(h[5:6], *w, 2), whole[5:6])


# ---- (b) weights ----


@pytest.mark.parametrize("name", list(CONFIGS))
def test_init_params_shapes_match_reference(name):
    jcfg = CONFIGS[name]
    want = jax.eval_shape(functools.partial(jl.init_params, jcfg), jax.random.PRNGKey(0))
    got = init_params(port_config(jcfg), torch.Generator().manual_seed(0), "cpu")
    bridged = params_from_jax(jax_params(name))
    assert set(got["layers"]) == set(want["layers"]) == set(bridged["layers"])
    for key in want["layers"]:
        assert got["layers"][key].shape == bridged["layers"][key].shape, key
    X, E = jcfg.num_experts, jcfg.hidden_size
    Fm = jcfg.moe_intermediate_size
    L = jcfg.num_layers
    assert got["layers"]["router"].shape == (L, E, X)
    assert got["layers"]["w_gate"].shape == got["layers"]["w_up"].shape == (L, X, E, Fm)
    assert got["layers"]["w_down"].shape == (L, X, Fm, E)
    # init scales: the expert stacks as the dense MLP's, per expert
    assert abs(float(got["layers"]["w_up"].std()) - 0.02) < 2e-3
    assert abs(float(got["layers"]["w_down"].std()) - 0.02 / np.sqrt(2 * L)) < 1e-3


def test_params_from_jax_bridges_the_jax_tiny_moe_weights():
    p = jax_params("tiny_moe")
    got = params_from_jax(p)
    for key in ("router", "w_gate", "w_up", "w_down"):
        assert np.array_equal(got["layers"][key].numpy(), p["layers"][key]), key
    assert got["layers"]["wq"].shape == (4, 128, 8 * 16)


# ---- (c) the serving forwards ----


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    """(jax cfg, jax params, inv_freq, port model) on the same weights."""
    jcfg = CONFIGS[request.param]
    params = jax.tree.map(jnp.asarray, jax_params(request.param))
    inv = jnp.asarray(rope_frequencies(jcfg.head_dim, jcfg.rope_theta, jcfg.rope_scaling))
    model = LlamaModel(port_config(jcfg), params_from_jax(jax_params(request.param)))
    assert model.moe
    return jcfg, params, inv, model


def _caches(cfg, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    shape = (cfg.num_layers, P, PS, cfg.num_kv_heads * cfg.head_dim)
    return ((rng.standard_normal(shape) * scale).astype(np.float32),
            (rng.standard_normal(shape) * scale).astype(np.float32))


def _i32(x):
    return torch.tensor(np.asarray(x), dtype=torch.int32)


def _close(got, want):
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("attention", ["kernel", "plain"])
def test_forward_prefill_two_chunks(pair, attention):
    jcfg, params, inv, model = pair
    model.attention = attention
    kc, vc = _caches(jcfg)
    jk, jv = jnp.asarray(kc), jnp.asarray(vc)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    pt = np.arange(3, 3 + MP, dtype=np.int32)
    rng = np.random.default_rng(1)
    prefix = 0
    for T, t_real in ((24, 20), (32, 27)):
        toks = rng.integers(1, jcfg.vocab_size, T).astype(np.int32)
        lo, jk, jv = jl.forward_prefill(params, jcfg, inv, jnp.asarray(toks),
                                        jnp.int32(prefix), jnp.int32(t_real), jk, jv,
                                        jnp.asarray(pt))
        got = model.forward_prefill(_i32(toks), _i32([prefix]), _i32([t_real]), tk, tv,
                                    _i32(pt))
        _close(got.numpy(), lo)
        assert int(got.argmax()) == int(jnp.argmax(lo))
        _close(tk.numpy(), jk)
        _close(tv.numpy(), jv)
        prefix += t_real


def test_forward_prefill_batched(pair):
    jcfg, params, inv, model = pair
    model.attention = "kernel"
    kc, vc = _caches(jcfg, seed=2)
    G, T = 3, 24
    rng = np.random.default_rng(3)
    toks = rng.integers(1, jcfg.vocab_size, (G, T)).astype(np.int32)
    prefix = np.array([0, 40, 17], np.int32)
    t_real = np.array([24, 13, 5], np.int32)
    pts = np.stack([np.arange(1 + i * 12, 1 + i * 12 + MP) for i in range(G)]).astype(np.int32)
    lo, jk, jv = jl.forward_prefill_batched(
        params, jcfg, inv, jnp.asarray(toks), jnp.asarray(prefix), jnp.asarray(t_real),
        jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(pts))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got = model.forward_prefill_batched(_i32(toks), _i32(prefix), _i32(t_real), tk, tv,
                                        _i32(pts))
    _close(got.numpy(), lo)
    np.testing.assert_array_equal(got.argmax(-1).numpy(), np.asarray(jnp.argmax(lo, -1)))
    _close(tk.numpy(), jk)
    _close(tv.numpy(), jv)


def test_forward_decode_horizon(pair):
    jcfg, params, inv, model = pair
    model.attention = "kernel"
    kc, vc = _caches(jcfg, seed=4)
    B, N = 3, 4
    L, KD = jcfg.num_layers, jcfg.num_kv_heads * jcfg.head_dim
    entry = np.array([20, 33, 7], np.int32)
    pts = np.stack([np.arange(1 + i * 12, 1 + i * 12 + MP) for i in range(B)]).astype(np.int32)
    toks = np.array([5, 77, 300], np.int32)
    jhk = jnp.zeros((L, B, N, KD), jnp.float32)
    jhv = jnp.zeros_like(jhk)
    thk = torch.zeros((L, B, N, KD))
    thv = torch.zeros_like(thk)
    tkc, tvc = torch.from_numpy(kc), torch.from_numpy(vc)
    for j in range(N):
        lo, jhk, jhv = jl.forward_decode_horizon(
            params, jcfg, inv, jnp.asarray(toks), jnp.asarray(entry + j),
            jnp.asarray(entry), jnp.int32(j), jnp.asarray(kc), jnp.asarray(vc),
            jnp.asarray(pts), jhk, jhv)
        got = model.forward_decode_horizon(_i32(toks), _i32(entry + j), _i32(entry), j,
                                           tkc, tvc, _i32(pts), thk, thv)
        _close(got.numpy(), lo)
        nxt = np.asarray(jnp.argmax(lo, -1)).astype(np.int32)
        np.testing.assert_array_equal(got.argmax(-1).numpy(), nxt)
        _close(thk.numpy(), jhk)
        _close(thv.numpy(), jhv)
        toks = nxt
    np.testing.assert_array_equal(tkc.numpy(), kc)  # the cache stays read-only


def test_forward_verify_block(pair):
    jcfg, params, inv, model = pair
    kc, vc = _caches(jcfg, seed=5, scale=0.5)
    rng = np.random.default_rng(5)
    B, W, mp = 3, 5, 6
    tokens = rng.integers(2, 500, (B, W)).astype(np.int32)
    pt = rng.permutation(np.arange(1, P))[: B * mp].reshape(B, mp).astype(np.int32)
    entry = np.array([3, 50, mp * PS - W], np.int32)
    want = jl.forward_verify_block(params, jcfg, inv, jnp.asarray(tokens),
                                   jnp.asarray(entry), jnp.asarray(kc), jnp.asarray(vc),
                                   jnp.asarray(pt))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got = model.forward_verify_block(torch.from_numpy(tokens).long(), torch.from_numpy(entry),
                                     tk, tv, torch.from_numpy(pt))
    for g, w in zip(got, want):
        _close(g.numpy(), w)
    np.testing.assert_array_equal(got[0].argmax(-1).numpy(), np.asarray(jnp.argmax(want[0], -1)))
    assert np.array_equal(tk.numpy(), kc) and np.array_equal(tv.numpy(), vc)


def test_forward_decode(pair):
    jcfg, params, inv, model = pair
    kc, vc = _caches(jcfg, seed=6, scale=0.5)
    rng = np.random.default_rng(6)
    B, mp = 3, 4
    tokens = rng.integers(2, 500, B).astype(np.int32)
    pt = rng.permutation(np.arange(1, P))[: B * mp].reshape(B, mp).astype(np.int32)
    positions = np.array([0, 21, mp * PS], np.int32)  # the last past the table
    logits, jk, jv = jl.forward_decode(params, jcfg, inv, jnp.asarray(tokens),
                                       jnp.asarray(positions), jnp.asarray(kc),
                                       jnp.asarray(vc), jnp.asarray(pt))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got = model.forward_decode(torch.from_numpy(tokens).long(), torch.from_numpy(positions),
                               tk, tv, torch.from_numpy(pt))
    _close(got.numpy(), logits)
    np.testing.assert_array_equal(got.argmax(-1).numpy(), np.asarray(jnp.argmax(logits, -1)))
    for mine, ref in ((tk, jk), (tv, jv)):  # the garbage page aside
        _close(mine.numpy()[:, 1:], np.asarray(ref)[:, 1:])


# ---- (d) the engine ----


SCHED = dict(max_batch_size=4, max_seq_len=256, max_prefill_tokens=64,
             decode_batch_buckets=(4,), decode_horizon=4)
ADAPTER = {k: np.random.default_rng(1).normal(0, 0.3, v.shape).astype(np.float32)
           for k, v in jlora.empty_adapter(tiny_moe_config(), 4).items()}


def jax_engine(**kw):
    cfg = jconf.EngineConfig(
        model=tiny_moe_config(),
        cache=jconf.CacheConfig(page_size=PS, num_pages=128, auto_size=False,
                                dtype="float32"),
        scheduler=jconf.SchedulerConfig(**{**SCHED, "prefill_token_buckets": (16, 32, 64),
                                           **kw}),
        dtype="float32", seed=0)
    return JaxEngine(cfg, params=jax.tree.map(jnp.asarray, jax_params("tiny_moe")))


def port_engine(**kw):
    cfg = tconf.EngineConfig(
        model=tmodels.tiny_moe_config(),
        cache=tconf.CacheConfig(page_size=PS, num_pages=128, auto_size=False,
                                dtype="float32"),
        scheduler=tconf.SchedulerConfig(**{**SCHED, **kw}), seed=0)
    return Engine(cfg, params=params_from_jax(jax_params("tiny_moe")), device="cpu")


def g(n, **kw):
    return dict(temperature=0.0, max_new_tokens=n, ignore_eos=True, **kw)


def run(engine, jobs, max_steps=3000) -> dict:
    """Submit every job, step inline until all finished; rid -> (tokens,
    finish, cached_tokens, logprobs).  Jobs are (rid, prompt, SamplingParams
    kwargs)."""
    cls = JaxSamplingParams if isinstance(engine, JaxEngine) else SamplingParams
    chunks: dict[str, list] = {}
    for rid, prompt, kw in jobs:
        chunks[rid] = []
        engine.submit(prompt, cls(**kw), rid=rid, on_output=chunks[rid].append)
    for _ in range(max_steps):
        if not engine.scheduler.has_work():
            break
        engine.step()
    else:
        raise TimeoutError("jobs stuck")
    return {rid: ([t for o in c for t in o.new_token_ids], c[-1].finish_reason,
                  c[-1].cached_tokens, [x for o in c for x in o.logprobs])
            for rid, c in chunks.items()}


def assert_same_streams(got: dict, want: dict) -> None:
    assert {r: v[:3] for r, v in got.items()} == {r: v[:3] for r, v in want.items()}
    for rid in want:
        np.testing.assert_allclose(got[rid][3], want[rid][3], **TOL)


def set_overlap(engine, on: bool) -> None:
    s = engine.scheduler
    s.sched = dataclasses.replace(s.sched, overlap_schedule=on)


def assert_clean(engine):
    audit = engine.audit()
    assert audit["quiescent"] and audit["clean"] and audit["leaked_pages"] == 0, audit


_rng = np.random.default_rng(0)
SHARED = _rng.integers(2, 500, 48).tolist()
WAVES = [
    [("long", _rng.integers(2, 500, 150).tolist(), g(10)),  # 3 chunks of 64
     ("shared", SHARED + [7, 8, 9], g(9)),
     ("short", _rng.integers(2, 500, 20).tolist(), g(8)),
     ("eos", _rng.integers(2, 500, 30).tolist(), dict(temperature=0.0, max_new_tokens=7))],
    [("hit", SHARED + [11, 12], g(9))],  # a radix hit on the finished "shared"
]
ADAPTER_JOBS = [("base", list(range(10, 40)), g(8)),
                ("lora", list(range(50, 75)), g(8, lora_adapter="a"))]


@functools.lru_cache(maxsize=None)
def reference(which: str) -> dict:
    je = jax_engine()
    je.runner.load_lora("a", ADAPTER)
    if which == "adapter":
        return run(je, ADAPTER_JOBS)
    out = {}
    for wave in WAVES:
        out.update(run(je, wave))
    return out


@pytest.fixture(scope="module")
def moe_engine():
    te = port_engine()
    te.runner.load_lora("a", ADAPTER)
    return te


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "sync"])
def test_engine_matches_jax_engine(moe_engine, overlap):
    te = moe_engine
    set_overlap(te, overlap)
    te.flush_cache()
    calls0, rows0 = te.runner.stats["prefill_calls"], te.runner.stats["prefill_rows"]
    got = {}
    for wave in WAVES:
        got.update(run(te, wave))
    want = reference("waves")
    assert want["long"][2] == 0 and want["hit"][2] > 0 and want["eos"][1] in ("stop", "length")
    assert_same_streams(got, want)
    # a grouped prefill: more rows than forward calls
    assert te.runner.stats["prefill_rows"] - rows0 > te.runner.stats["prefill_calls"] - calls0
    assert_clean(te)


def test_adapter_lane_matches_jax_engine(moe_engine):
    te = moe_engine
    set_overlap(te, True)
    te.flush_cache()
    got = run(te, ADAPTER_JOBS)
    assert_same_streams(got, reference("adapter"))
    assert_clean(te)


def test_ngram_speculation_matches_jax_spec_engine():
    kw = dict(speculative=True, spec_max_draft=4)
    rep = [5, 6, 7, 8] * 8
    jobs = [("rep", rep, g(16)), ("c1", [11, 12, 13] * 8, g(12)),
            ("long", list(range(5, 120)), g(8))]
    je, te = jax_engine(**kw), port_engine(**kw)
    want, got = run(je, jobs), run(te, jobs)
    assert {r: v[:3] for r, v in got.items()} == {r: v[:3] for r, v in want.items()}
    js, ts = je.scheduler, te.scheduler
    assert (ts.num_spec_drafted, ts.num_spec_accepted) == \
        (js.num_spec_drafted, js.num_spec_accepted)
    assert ts.num_spec_drafted > 0 and te.runner.stats["verify_calls"] > 0
    assert_clean(te)


# ---- (e), (f) the checkpoint path ----


_BASE = dict(vocab_size=320, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=1, head_dim=16, rms_norm_eps=1e-6,
             max_position_embeddings=2048, bos_token_id=1, eos_token_id=2,
             tie_word_embeddings=False)
HF_MOE = {
    "qwen3_moe": dict(_BASE, architectures=["Qwen3MoeForCausalLM"], rope_theta=1000000.0,
                      num_experts=6, num_experts_per_tok=2, moe_intermediate_size=32,
                      norm_topk_prob=True, decoder_sparse_step=1, mlp_only_layers=[]),
    # Qwen2-MoE: the expert count as num_routed_experts; the shared expert and
    # norm_topk_prob: false are ignored by the reference, and so by the port
    "qwen2_moe": dict(_BASE, architectures=["Qwen2MoeForCausalLM"], rope_theta=10000.0,
                      num_routed_experts=5, num_experts_per_tok=2, moe_intermediate_size=32,
                      shared_expert_intermediate_size=64, norm_topk_prob=False),
}


@pytest.mark.parametrize("family", list(HF_MOE))
def test_from_hf_config_reads_moe_configs_as_the_reference(family, tmp_path):
    hf = HF_MOE[family]
    (tmp_path / "config.json").write_text(json.dumps(hf))
    for dtype in ("bfloat16", "float32"):
        ref = JModelConfig.from_hf_config(hf, dtype=dtype)
        for got in (ModelConfig.from_hf_config(hf, dtype=dtype),
                    ModelConfig.from_pretrained(str(tmp_path), dtype=dtype)):
            for f in dataclasses.fields(ModelConfig):
                assert getattr(got, f.name) == getattr(ref, f.name), (family, f.name)
    assert ref.arch == "qwen_moe" and ref.num_experts in (5, 6)


def moe_tensors(jcfg, seed: int) -> dict:
    """The JAX ``init_params`` of ``jcfg`` in HF names and layouts, float32:
    a router per layer and every expert's linears as tensors of their own,
    plus a shared expert the reference does not read."""
    p = jax.tree.map(np.asarray, jl.init_params(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    E, H, K, D = jcfg.hidden_size, jcfg.num_heads, jcfg.num_kv_heads, jcfg.head_dim
    lay = p["layers"]
    out = {"model.embed_tokens.weight": p["embed"], "lm_head.weight": p["lm_head"].T,
           "model.norm.weight": rng.standard_normal(E)}
    for i in range(jcfg.num_layers):
        pre = f"model.layers.{i}."
        out[pre + "self_attn.q_proj.weight"] = lay["wq"][i].reshape(E, H * D).T
        out[pre + "self_attn.k_proj.weight"] = lay["wk"][i].reshape(E, K * D).T
        out[pre + "self_attn.v_proj.weight"] = lay["wv"][i].reshape(E, K * D).T
        out[pre + "self_attn.o_proj.weight"] = lay["wo"][i].reshape(H * D, E).T
        out[pre + "mlp.gate.weight"] = lay["router"][i].T
        out[pre + "mlp.shared_expert.gate_proj.weight"] = rng.standard_normal((8, E))
        for e in range(jcfg.num_experts):
            ex = f"{pre}mlp.experts.{e}."
            out[ex + "gate_proj.weight"] = lay["w_gate"][i, e].T
            out[ex + "up_proj.weight"] = lay["w_up"][i, e].T
            out[ex + "down_proj.weight"] = lay["w_down"][i, e].T
        for key, hf in (("attn_norm", "input_layernorm"),
                        ("mlp_norm", "post_attention_layernorm"),
                        ("q_norm", "self_attn.q_norm"), ("k_norm", "self_attn.k_norm")):
            if key in lay:
                out[pre + hf + ".weight"] = rng.standard_normal(lay[key][i].shape)
    return {k: np.ascontiguousarray(v, np.float32) for k, v in out.items()}


def _write(path, hf: dict, tensors: dict, shards: int) -> None:
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(hf))
    names = sorted(tensors)
    for s in range(shards):
        save_file({n: tensors[n] for n in names[s::shards]},
                  str(path / f"model-{s + 1:05d}-of-{shards:05d}.safetensors"))


def _assert_params_equal(got: dict, want: dict) -> None:
    assert set(got) == set(want) and set(got["layers"]) == set(want["layers"])
    for group_g, group_w in ((got, want), (got["layers"], want["layers"])):
        for k, w in group_w.items():
            if k != "layers":
                assert group_g[k].dtype == w.dtype and group_g[k].shape == w.shape, k
                assert torch.equal(group_g[k], w), k


def _reference_load(path) -> dict:
    ref = jload(JEngineConfig(model=JModelConfig.from_pretrained(str(path)),
                              model_path=str(path), dtype="float32"))
    return params_from_jax(jax.tree.map(np.asarray, ref))


def _port_load(path, dtype="float32") -> dict:
    return load_params(tconf.EngineConfig(
        model=ModelConfig.from_pretrained(str(path), dtype=dtype), model_path=str(path)),
        device="cpu")


@pytest.mark.parametrize("family", list(HF_MOE))
@pytest.mark.parametrize("shards", [1, 2])
def test_load_params_of_a_moe_checkpoint_equals_the_reference_loader(tmp_path, family, shards):
    hf = HF_MOE[family]
    _write(tmp_path, hf, moe_tensors(JModelConfig.from_hf_config(hf, dtype="float32"),
                                     seed=shards), shards)
    got = _port_load(tmp_path)
    _assert_params_equal(got, _reference_load(tmp_path))
    assert got["layers"]["w_gate"].shape[:2] == (2, hf.get("num_experts", 5))


def test_a_bf16_moe_checkpoint_loads_bitwise(tmp_path):
    from safetensors.torch import save_file as save_pt

    hf = HF_MOE["qwen3_moe"]
    tensors = moe_tensors(JModelConfig.from_hf_config(hf, dtype="float32"), seed=9)
    _write(tmp_path / "f32", hf, tensors, 1)
    (tmp_path / "bf16").mkdir()
    (tmp_path / "bf16" / "config.json").write_text(json.dumps(hf))
    save_pt({k: torch.from_numpy(v).bfloat16() for k, v in tensors.items()},
            str(tmp_path / "bf16" / "model.safetensors"))
    ref32 = _reference_load(tmp_path / "f32")
    want16 = {"layers": {k: v.bfloat16() for k, v in ref32["layers"].items()},
              **{k: v.bfloat16() for k, v in ref32.items() if k != "layers"}}
    _assert_params_equal(_port_load(tmp_path / "bf16", "bfloat16"), want16)
    want32 = {"layers": {k: v.float() for k, v in want16["layers"].items()},
              **{k: v.float() for k, v in want16.items() if k != "layers"}}
    _assert_params_equal(_port_load(tmp_path / "bf16", "float32"), want32)


def test_a_missing_expert_tensor_raises_the_reference_key_error(tmp_path):
    hf = HF_MOE["qwen3_moe"]
    tensors = moe_tensors(JModelConfig.from_hf_config(hf, dtype="float32"), seed=2)
    del tensors["model.layers.1.mlp.experts.4.up_proj.weight"]
    _write(tmp_path, hf, tensors, 2)
    with pytest.raises(KeyError) as ref:
        _reference_load(tmp_path)
    with pytest.raises(KeyError) as got:
        _port_load(tmp_path)
    assert str(got.value) == str(ref.value)


# ---- (g) cache planning ----


def test_plan_cache_leaves_the_moe_reserve():
    """KV gets the utilization share of what the weights and the expert
    layer's scratch leave; a dense model reserves nothing."""
    moe = dataclasses.replace(tmodels.tiny_moe_config(), num_experts=128,
                              num_experts_per_tok=8, moe_intermediate_size=768,
                              hidden_size=2048, dtype="bfloat16")
    sched = tconf.SchedulerConfig(max_prefill_tokens=4096, decode_horizon=4)
    reserve = moe_reserve_bytes(moe, sched)
    tile = moe_scratch_bytes(moe, MOE_TOKEN_TILE)
    assert reserve == tile + moe_scratch_bytes(moe, 64 * 4)
    assert moe_scratch_bytes(moe, 4096) == tile  # a chunk runs in tiles
    assert tile == 512 * (128 * (768 + 2048) * 2 + 8 * 2048 * 10 + 4 * 128)  # ~0.9 MB a token
    spec_sched = dataclasses.replace(sched, speculative=True, spec_max_draft=8)
    assert moe_reserve_bytes(moe, spec_sched) == 2 * tile  # 64 lanes x 9 > a tile
    assert moe_reserve_bytes(tmodels.tiny_test_config(), sched) == 0
    cache = tconf.CacheConfig(page_size=16, hbm_utilization=0.9, dtype="bfloat16")
    free = 20 << 30
    plain = plan_cache(moe, cache, free)
    kept = plan_cache(moe, cache, free, reserve_bytes=reserve)
    per_page = kept.bytes_per_page
    assert kept.num_pages == int((free - reserve) * 0.9) // per_page
    assert plain.num_pages - kept.num_pages == pytest.approx(0.9 * reserve / per_page, abs=1)
    # the runner sets it aside before it sizes KV (only on the card; the CPU
    # keeps the configured pages)
    runner = trunner.ModelRunner(tconf.EngineConfig(
        model=tmodels.tiny_moe_config(), scheduler=sched,
        cache=tconf.CacheConfig(num_pages=8, auto_size=False)), device="cpu")
    assert runner.reserve_bytes == moe_reserve_bytes(tmodels.tiny_moe_config(), sched) > 0
    assert runner.spec.num_pages == 8


# ---- (h) serve --model-preset tiny-moe ----


def _strip(obj):
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in ("id", "created")}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def test_serve_tiny_moe_preset_answers_as_the_reference_gateway(monkeypatch):
    flags = ["serve", "--model-preset", "tiny-moe", "--dtype", "float32",
             "--max-batch-size", "4", "--max-seq-len", "256", "--decode-horizon", "2"]
    je = jlaunch.build_engine_from_args(jcli.build_parser().parse_args(flags))
    bridged = params_from_jax(jax.tree.map(np.asarray, je.runner.params))
    # the port's preset engine on the reference's random weights
    monkeypatch.setattr(trunner, "init_params", lambda *a: bridged)
    te = tlaunch.build_engine_from_args(tcli.build_parser().parse_args(
        [*flags, "--device", "cpu"]))
    assert te.config.model_id == je.config.model_id == "tiny-moe"
    assert te.runner.model.moe and te.config.model.num_experts == 4
    jctx = jserver.AppContext(policy="cache_aware")
    jctx.tokenizers.register("tiny-moe", je.tokenizer, default=True)
    jctx.registry.add(JaxWorker(worker_id="inproc-0", client=JaxInProc(je),
                                model_id="tiny-moe", page_size=16))
    tctx = tlaunch.build_context(te, policy="cache_aware", drain_timeout_secs=2)
    chat = {"model": "tiny-moe", "messages": [{"role": "user", "content": "w5 w6 w7 w9"}],
            "max_tokens": 6, "temperature": 0, "ignore_eos": True}

    async def go(server, ctx):
        tc = TestClient(TestServer(server.build_app(ctx)))
        await tc.start_server()
        try:
            resp = await tc.post("/v1/chat/completions", json=chat)
            return resp.status, await resp.json()
        finally:
            await tc.close()
            await ctx.registry.list()[0].client.close()

    want = asyncio.run(go(jserver, jctx))
    got = asyncio.run(go(tserver, tctx))
    assert got[0] == want[0] == 200, (got, want)
    assert _strip(got[1]) == _strip(want[1])
    assert got[1]["usage"]["completion_tokens"] == 6


# ---- on the card ----


@pytest.fixture
def moe_runners():
    """(graph runner, eager runner) of a bf16 Qwen3-MoE-like model (G=8,
    ``qk_norm``, 8 experts top 4) on the same weights and cache contents."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the kernels have no CPU mode")
    from test_torch_graphs import config

    dev = torch.device("cuda")
    cfg = dataclasses.replace(port_config(CONFIGS["qwen3_moe_g8"]), dtype="bfloat16")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)

    def runner(graphs):
        c = config(graphs)
        return trunner.ModelRunner(dataclasses.replace(
            c, model=cfg, cache=dataclasses.replace(c.cache, dtype="bfloat16")),
            params=params, device=dev)

    g, e = runner(True), runner(False)
    gen = torch.Generator(device=dev).manual_seed(1)
    for cache in ("k_cache", "v_cache"):
        fill = (torch.randn(getattr(g, cache).shape, generator=gen, device=dev) * 0.5).bfloat16()
        getattr(g, cache).copy_(fill)
        getattr(e, cache).copy_(fill)
    return g, e


@pytest.mark.cuda
@pytest.mark.parametrize("B_real,B,mp,K", [(3, 4, 8, 1), (8, 8, 16, 4), (5, 8, 32, 4)])
def test_captured_moe_megastep_equals_eager_bitwise(moe_runners, B_real, B, mp, K):
    """``topk``, the gathered combine and the tiles inside a CUDA graph:
    the replay's tokens, logprobs, stop column and landed KV equal the
    eager megastep's bit for bit."""
    from test_torch_graphs import assert_same, case, launch

    g, e = moe_runners
    toks, pos, ds = case(B_real, B, mp, K, seed=B * 100 + K)
    k0, v0 = g.k_cache.clone(), g.v_cache.clone()
    launch(g, toks, pos, ds, K)  # warm-up and capture
    g.k_cache.copy_(k0)
    g.v_cache.copy_(v0)
    replay = launch(g, toks, pos, ds, K)
    eager = launch(e, toks, pos, ds, K)
    assert g.graphs.num_graphs == 1 and e.graphs.num_graphs == 0
    assert_same(replay, eager)
    assert torch.equal(g.k_cache[:, 1:], e.k_cache[:, 1:])
    assert torch.equal(g.v_cache[:, 1:], e.v_cache[:, 1:])


@pytest.mark.cuda
def test_captured_moe_verify_block_equals_eager_bitwise(moe_runners):
    from test_torch_graphs import verify, verify_case

    g, e = moe_runners
    args = verify_case(5, 8, 16, 9, seed=89)
    k0, v0 = g.k_cache.clone(), g.v_cache.clone()
    verify(g, args)  # warm-up and capture
    g.k_cache.copy_(k0)
    g.v_cache.copy_(v0)
    replay, eager = verify(g, args), verify(e, args)
    assert g.graphs.stats()["verify_graphs"] == 1
    for x, y in zip(replay, eager):
        np.testing.assert_array_equal(x, y)
    assert torch.equal(g.k_cache[:, 1:], e.k_cache[:, 1:])
