"""Parity: the PyTorch port's ops (``smg_tpu_torch/ops``) against the JAX
package's (``smg_tpu/ops``) on the same numpy inputs, in float32 on the CPU.

Tolerance: 2e-5 absolute and relative — both sides compute in float32 and
differ only in summation order (einsum/softmax reductions)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smg_tpu.ops import attention as jatt
from smg_tpu.ops.norms import rms_norm as j_rms_norm
from smg_tpu.ops.rope import apply_rope as j_apply_rope
from smg_tpu.ops.rope import rope_frequencies as j_rope_frequencies
from smg_tpu_torch.ops import attention as tatt
from smg_tpu_torch.ops.norms import rms_norm
from smg_tpu_torch.ops.rope import apply_rope, rope_frequencies

torch.set_num_threads(2)
TOL = dict(rtol=2e-5, atol=2e-5)
LLAMA3_SCALING = {"rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
                  "high_freq_factor": 4.0, "original_max_position_embeddings": 8192}


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("unit_offset", [False, True])
def test_rms_norm(unit_offset):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    want = j_rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5, unit_offset=unit_offset)
    got = rms_norm(_t(x), _t(w), 1e-5, unit_offset=unit_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("scaling", [None, LLAMA3_SCALING])
def test_rope(scaling):
    inv_j = j_rope_frequencies(64, 500000.0, scaling)
    inv_t = rope_frequencies(64, 500000.0, scaling)
    np.testing.assert_array_equal(inv_t, inv_j)  # same numpy code path
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 64)).astype(np.float32)
    pos = rng.integers(0, 9000, (2, 7)).astype(np.int32)
    want = j_apply_rope(jnp.asarray(x), jnp.asarray(pos), jnp.asarray(inv_j))
    got = apply_rope(_t(x), _t(pos), _t(inv_t))
    # angles up to ~9000 rad: f32 sin/cos of large arguments differ by ~1e-4
    # between the two libraries' range reductions
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-3)


def _cache(rng, L=3, P=32, ps=16, KD=32):
    return (rng.standard_normal((L, P, ps, KD)).astype(np.float32),
            rng.standard_normal((L, P, ps, KD)).astype(np.float32))


def test_scatter_and_gather():
    rng = np.random.default_rng(2)
    kc, vc = _cache(rng)
    T, K, D = 10, 2, 16
    kn = rng.standard_normal((T, K, D)).astype(np.float32)
    vn = rng.standard_normal((T, K, D)).astype(np.float32)
    dest = rng.permutation(32 * 16)[:T].astype(np.int32)
    jk, jv = jatt.scatter_kv_pages_full(jnp.asarray(kc), jnp.asarray(vc), 1,
                                        jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(dest))
    tk, tv = _t(kc), _t(vc)
    tatt.scatter_kv_pages_full(tk, tv, 1, _t(kn), _t(vn), _t(dest))  # in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    pt = np.array([3, 9, 1, 4], np.int32)
    gk, gv = jatt.gather_seq_kv(jk[1], jv[1], jnp.asarray(pt), K)
    hk, hv = tatt.gather_seq_kv(tk[1], tv[1], _t(pt), K)
    np.testing.assert_array_equal(hk.numpy(), np.asarray(gk))
    np.testing.assert_array_equal(hv.numpy(), np.asarray(gv))


PREFILL_CASES = [
    # T, H, K, D, prefix, t_real, softcap, window
    (16, 8, 2, 16, 0, 16, None, None),
    (16, 8, 2, 16, 37, 11, None, None),  # ragged prefix, padded rows
    (16, 8, 8, 16, 40, 16, 30.0, None),
    (16, 8, 2, 16, 40, 16, None, 20),  # window cuts the prefix
    (16, 8, 2, 16, 40, 16, 50.0, 5),  # window inside the chunk
]


@pytest.mark.parametrize("T,H,K,D,prefix,t_real,softcap,window", PREFILL_CASES)
def test_attention_prefill(T, H, K, D, prefix, t_real, softcap, window):
    rng = np.random.default_rng(3)
    S = 80
    q = rng.standard_normal((T, H, D)).astype(np.float32)
    k = rng.standard_normal((S, K, D)).astype(np.float32)
    v = rng.standard_normal((S, K, D)).astype(np.float32)
    pos = (prefix + np.arange(T)).astype(np.int32)
    scale = 1 / np.sqrt(D)
    want = jatt.attention_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(pos), prefix + t_real, scale,
                                  softcap=softcap,
                                  window=None if window is None else jnp.int32(window))
    got = tatt.attention_prefill(_t(q), _t(k), _t(v), _t(pos), prefix + t_real, scale,
                                 softcap=softcap, window=window)
    np.testing.assert_allclose(got.numpy()[:t_real], np.asarray(want)[:t_real], **TOL)


@pytest.mark.parametrize("softcap,window", [(None, None), (30.0, 9)])
def test_attention_prefill_batched(softcap, window):
    rng = np.random.default_rng(4)
    G, T, H, K, D, S = 3, 12, 8, 2, 16, 64
    q = rng.standard_normal((G, T, H, D)).astype(np.float32)
    k = rng.standard_normal((G, S, K, D)).astype(np.float32)
    v = rng.standard_normal((G, S, K, D)).astype(np.float32)
    prefix = np.array([0, 20, 45], np.int32)
    t_real = np.array([12, 7, 3], np.int32)
    pos = (prefix[:, None] + np.arange(T)[None]).astype(np.int32)
    ctx = prefix + t_real
    want = jatt.attention_prefill_batched(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        jnp.asarray(ctx), 0.25, softcap=softcap,
        window=None if window is None else jnp.int32(window))
    got = tatt.attention_prefill_batched(_t(q), _t(k), _t(v), _t(pos), _t(ctx), 0.25,
                                         softcap=softcap, window=window)
    for g in range(G):
        np.testing.assert_allclose(got.numpy()[g, : t_real[g]],
                                   np.asarray(want)[g, : t_real[g]], **TOL)


# the case list of tests/test_pallas_decode.py (B, H, D, K, entries, n_extra,
# softcap, window)
DECODE_CASES = [
    (2, 8, 64, 8, [100, 37], 1, None, None),
    (2, 8, 64, 2, [100, 37], 3, None, None),
    (2, 8, 64, 8, [100, 37], 1, 30.0, None),
    (2, 8, 64, 8, [100, 37], 1, None, 40),
    (2, 8, 64, 8, [100, 37], 2, 30.0, 40),
    (2, 8, 64, 8, [100, 37], 1, None, 7),
    (2, 8, 64, 8, [100, 37], 1, None, 4096),
    (2, 8, 64, 8, [100, 37], 1, None, 0),
    (2, 4, 128, 2, [190, 5], 1, 50.0, 64),
]


def decode_inputs(B, H, D, K, entries, N=4, ps=16, mp=13, P=64, seed=0):
    """Same construction as tests/test_pallas_decode.py::_setup."""
    rng = np.random.default_rng(seed)
    L, KD = 3, K * D
    k_cache = rng.standard_normal((L, P, ps, KD)).astype(np.float32)
    v_cache = rng.standard_normal((L, P, ps, KD)).astype(np.float32)
    pt = (rng.permutation(P - 1)[: B * mp].reshape(B, mp) + 1).astype(np.int32)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    hk = rng.standard_normal((B, N, KD)).astype(np.float32)
    hv = rng.standard_normal((B, N, KD)).astype(np.float32)
    return q, k_cache, v_cache, hk, hv, 1, pt, np.asarray(entries, np.int32)


@pytest.mark.parametrize("B,H,D,K,entries,n_extra,softcap,window", DECODE_CASES)
def test_attention_decode_cached(B, H, D, K, entries, n_extra, softcap, window):
    q, kc, vc, hk, hv, layer, pt, entry = decode_inputs(B, H, D, K, entries)
    scale = 1 / np.sqrt(D)
    want = jatt.attention_decode_cached(
        *(jnp.asarray(a) for a in (q, kc, vc, hk, hv)), jnp.int32(n_extra), layer,
        jnp.asarray(pt), jnp.asarray(entry), scale, softcap=softcap,
        window=None if window is None else jnp.int32(window))
    got = tatt.attention_decode_cached(
        *(_t(a) for a in (q, kc, vc, hk, hv)), n_extra, layer, _t(pt), _t(entry),
        scale, softcap=softcap, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
