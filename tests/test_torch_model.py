"""Parity: the port's decoder (``smg_tpu_torch/models/llama.py``) against the
JAX package's serving forwards on weights bridged by ``params_from_jax``.

Configs: the tiny Llama test model, the tiny Gemma-2 model (softcaps, post
norms, embed scale, (1+w) norms, alternating windows), a Mistral-style model
windowing every layer, and a Qwen3-style ``qk_norm`` model.  Tolerance:
float32 on both sides, 1e-4 absolute and relative on logits (summation
order through 4 layers); the argmax token must be identical."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smg_tpu.models import llama as jl
from smg_tpu.models.config import tiny_gemma2_config, tiny_test_config
from smg_tpu.ops.rope import rope_frequencies
from smg_tpu_torch.models.config import ModelConfig
from smg_tpu_torch.models.convert import params_from_jax
from smg_tpu_torch.models.llama import LlamaModel

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)
PS, MP, P = 16, 8, 40

CONFIGS = {
    "llama": tiny_test_config(),
    "gemma2": tiny_gemma2_config(),
    "mistral_window": dataclasses.replace(
        tiny_test_config(), sliding_window=24, sliding_window_pattern=0),
    "qwen3_qk_norm": dataclasses.replace(tiny_test_config(), qk_norm=True),
}


def port_config(jcfg) -> ModelConfig:
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items() if k in names})


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    """(jax cfg, jax params, inv_freq, port model) on the same weights."""
    jcfg = CONFIGS[request.param]
    params = jl.init_params(jcfg, jax.random.PRNGKey(0))
    inv = jnp.asarray(rope_frequencies(jcfg.head_dim, jcfg.rope_theta, jcfg.rope_scaling))
    model = LlamaModel(port_config(jcfg), params_from_jax(jax.tree.map(np.asarray, params)))
    return jcfg, params, inv, model


def _caches(cfg, seed=0):
    rng = np.random.default_rng(seed)
    shape = (cfg.num_layers, P, PS, cfg.num_kv_heads * cfg.head_dim)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _i32(x):
    return torch.tensor(np.asarray(x), dtype=torch.int32)


def _close(got, want):
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("attention", ["kernel", "plain"])
def test_forward_prefill_two_chunks(pair, attention):
    """A cold chunk, then a second chunk over the cached prefix (prefix_len
    > 0), both writing the cache."""
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


@pytest.mark.parametrize("no_ctx", [False, True])
def test_forward_prefill_batched(pair, no_ctx):
    jcfg, params, inv, model = pair
    model.attention = "kernel"
    kc, vc = _caches(jcfg, seed=2)
    G, T = 3, 24
    rng = np.random.default_rng(3)
    toks = rng.integers(1, jcfg.vocab_size, (G, T)).astype(np.int32)
    prefix = np.zeros(G, np.int32) if no_ctx else np.array([0, 40, 17], np.int32)
    t_real = np.array([24, 13, 5], np.int32)
    pts = np.stack([np.arange(1 + i * 12, 1 + i * 12 + MP) for i in range(G)]).astype(np.int32)
    lo, jk, jv = jl.forward_prefill_batched(
        params, jcfg, inv, jnp.asarray(toks), jnp.asarray(prefix), jnp.asarray(t_real),
        jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(pts), no_ctx=no_ctx)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got = model.forward_prefill_batched(_i32(toks), _i32(prefix), _i32(t_real), tk, tv,
                                        _i32(pts))
    _close(got.numpy(), lo)
    np.testing.assert_array_equal(got.argmax(-1).numpy(), np.asarray(jnp.argmax(lo, -1)))
    _close(tk.numpy(), jk)
    _close(tv.numpy(), jv)


def test_forward_decode_horizon(pair):
    """A 4-column horizon over a frozen cache with growing side buffers."""
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
