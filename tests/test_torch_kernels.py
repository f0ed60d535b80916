"""The port's kernels: plain versions against the Pallas TPU kernels (run in
interpret mode on the CPU, as tests/test_pallas_*.py run them), the CPU
route of each ``smg_tpu_torch/ops/cuda`` wrapper, and — on a machine with an
NVIDIA GPU only — the CUDA kernels against their plain versions.

Tolerance on the CPU: 2e-5 absolute and relative, float32 on both sides
(summation order only).  On the card: float32 2e-5; bfloat16 outputs a
couple of bf16 ulps apart (2e-2 + 1.6e-2 relative)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ops import DECODE_CASES, decode_inputs

from smg_tpu.ops.pallas.decode_attention import paged_attention_decode_cached as pallas_decode
from smg_tpu.ops.pallas.prefill_attention import paged_attention_prefill as pallas_prefill
from smg_tpu_torch.ops import attention as tatt
from smg_tpu_torch.ops.cuda import decode_attention as dk
from smg_tpu_torch.ops.cuda import prefill_attention as pk

torch.set_num_threads(2)
TOL = dict(rtol=2e-5, atol=2e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _w(window):
    return None if window is None else jnp.int32(window)


@pytest.mark.parametrize("B,H,D,K,entries,n_extra,softcap,window", DECODE_CASES)
def test_plain_decode_matches_pallas(B, H, D, K, entries, n_extra, softcap, window):
    q, kc, vc, hk, hv, layer, pt, entry = decode_inputs(B, H, D, K, entries)
    scale = 1 / np.sqrt(D)
    want = pallas_decode(*(jnp.asarray(a) for a in (q, kc, vc, hk, hv)),
                         jnp.int32(n_extra), layer, jnp.asarray(pt), jnp.asarray(entry),
                         scale, softcap=softcap, window=_w(window), interpret=True)
    got = tatt.attention_decode_cached(*(_t(a) for a in (q, kc, vc, hk, hv)), n_extra,
                                       layer, _t(pt), _t(entry), scale,
                                       softcap=softcap, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_plain_decode_padded_row_matches_pallas():
    """A decode-bucket padding row (entry == table capacity) attends its side
    buffer only in both, and stays finite under softcap + window."""
    q, kc, vc, hk, hv, layer, pt, entry = decode_inputs(2, 8, 64, 8, [100, 13 * 16])
    args = (30.0, 24)
    want = pallas_decode(*(jnp.asarray(a) for a in (q, kc, vc, hk, hv)), jnp.int32(1),
                         layer, jnp.asarray(pt), jnp.asarray(entry), 0.125,
                         softcap=args[0], window=jnp.int32(args[1]), interpret=True)
    got = tatt.attention_decode_cached(*(_t(a) for a in (q, kc, vc, hk, hv)), 1, layer,
                                       _t(pt), _t(entry), 0.125, softcap=args[0],
                                       window=args[1])
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def prefill_inputs(T, H, D, K, prefix_len, t_real, ps=16, mp=24, P=64, seed=0):
    """Same construction as tests/test_pallas_prefill.py::_setup: a cache
    holding a real prefix with the chunk already scattered into it."""
    rng = np.random.default_rng(seed)
    L, layer, KD = 3, 1, K * D
    kc = rng.standard_normal((L, P, ps, KD)).astype(np.float32)
    vc = rng.standard_normal((L, P, ps, KD)).astype(np.float32)
    pt = (rng.permutation(P - 1)[:mp] + 1).astype(np.int32)
    q = rng.standard_normal((T, H, D)).astype(np.float32)
    ck = rng.standard_normal((T, KD)).astype(np.float32)
    cv = rng.standard_normal((T, KD)).astype(np.float32)
    pos = prefix_len + np.arange(T)
    valid = (np.arange(T) < t_real) & (pos < mp * ps)
    pos_c = np.minimum(pos, mp * ps - 1)
    dest = np.where(valid, pt[pos_c // ps] * ps + pos_c % ps, 0)
    kf, vf = kc.reshape(L, P * ps, KD), vc.reshape(L, P * ps, KD)
    kf[layer, dest[valid]] = ck[valid]
    vf[layer, dest[valid]] = cv[valid]
    return q, ck, cv, kc, vc, layer, pt


PREFILL_CASES = [
    # T, H, D, K, prefix_len, t_real, softcap, window, mp, P — the shapes of
    # tests/test_pallas_prefill.py
    (16, 8, 64, 8, 160, 16, None, None, 24, 64),
    (16, 8, 64, 2, 160, 16, None, None, 24, 64),
    (32, 4, 128, 2, 96, 32, None, None, 24, 64),
    (16, 8, 64, 8, 0, 16, None, None, 24, 64),
    (16, 8, 64, 8, 137, 11, None, None, 24, 64),
    (16, 8, 64, 8, 160, 16, 30.0, None, 24, 64),
    (16, 8, 64, 8, 160, 16, None, 100, 24, 64),
    (16, 8, 64, 8, 160, 16, None, 8, 24, 64),
    (16, 8, 64, 8, 160, 16, 30.0, 100, 24, 64),
    (16, 8, 64, 8, 597, 16, None, None, 40, 96),  # multi-block prefix
    (16, 8, 64, 8, 597, 16, None, 64, 40, 96),  # window skips early blocks
]


@pytest.mark.parametrize("T,H,D,K,prefix_len,t_real,softcap,window,mp,P", PREFILL_CASES)
def test_plain_prefill_matches_pallas(T, H, D, K, prefix_len, t_real, softcap, window,
                                      mp, P):
    q, ck, cv, kc, vc, layer, pt = prefill_inputs(T, H, D, K, prefix_len, t_real,
                                                  mp=mp, P=P)
    scale = 1 / np.sqrt(D)
    want = pallas_prefill(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
                          jnp.asarray(kc), jnp.asarray(vc), layer, jnp.asarray(pt),
                          prefix_len, t_real, scale, softcap=softcap,
                          window=_w(window), interpret=True)
    got = pk.plain_prefill_batched(_t(q)[None], _t(kc), _t(vc), layer, _t(pt)[None],
                                   torch.tensor([prefix_len]), torch.tensor([t_real]),
                                   scale, softcap=softcap, window=window)[0]
    np.testing.assert_allclose(got.numpy()[:t_real], np.asarray(want)[:t_real], **TOL)


def test_cpu_wrappers_compute_the_plain_versions():
    """On CPU tensors each wrapper returns its plain version and launches
    nothing."""
    d0, p0 = dk.launches, pk.launches
    q, kc, vc, hk, hv, layer, pt, entry = decode_inputs(2, 8, 64, 2, [100, 37])
    args = [_t(a) for a in (q, kc, vc, hk, hv)]
    got = dk.paged_attention_decode_cached(*args, 3, layer, _t(pt), _t(entry), 0.125,
                                           softcap=30.0, window=40)
    want = tatt.attention_decode_cached(*args, 3, layer, _t(pt), _t(entry), 0.125,
                                        softcap=30.0, window=40)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    q, ck, cv, kc, vc, layer, pt = prefill_inputs(16, 8, 64, 8, 137, 11)
    got = pk.paged_attention_prefill(_t(q), _t(ck), _t(cv), _t(kc), _t(vc), layer,
                                     _t(pt), torch.tensor([137]), torch.tensor([11]), 0.125)
    want = pk.plain_prefill_batched(_t(q)[None], _t(kc), _t(vc), layer, _t(pt)[None],
                                    torch.tensor([137]), torch.tensor([11]), 0.125)[0]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (dk.launches, pk.launches) == (d0, p0)


# ---- on the card ----

@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _close(got, want, dtype):
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    else:
        err = (got.float() - want.float()).abs()
        assert bool((err <= 2e-2 + 1.6e-2 * want.float().abs()).all()), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,D,K,entries,n_extra,softcap,window",
                         DECODE_CASES + [(3, 8, 16, 2, [40, 5, 208], 2, None, 24)])
def test_decode_kernel_matches_plain(cuda_dev, dtype, B, H, D, K, entries, n_extra,
                                     softcap, window):
    q, kc, vc, hk, hv, layer, pt, entry = decode_inputs(B, H, D, K, entries)
    args = [_t(a).to(cuda_dev, dtype) for a in (q, kc, vc, hk, hv)]
    rest = (n_extra, layer, _t(pt).to(cuda_dev), _t(entry).to(cuda_dev), 1 / math.sqrt(D))
    n0 = dk.launches
    got = dk.paged_attention_decode_cached(*args, *rest, softcap=softcap, window=window)
    want = tatt.attention_decode_cached(*args, *rest, softcap=softcap, window=window)
    torch.cuda.synchronize()
    assert dk.launches == n0 + 1
    _close(got, want, dtype)


@pytest.mark.cuda
def test_decode_kernel_skips_out_of_window_pages(cuda_dev):
    """Pages wholly below the window are never read: NaN-poisoned, the
    output stays finite and equal to the unpoisoned plain result."""
    q, kc, vc, hk, hv, layer, pt, entry = decode_inputs(1, 8, 64, 8, [150])
    want = tatt.attention_decode_cached(*(_t(a) for a in (q, kc, vc, hk, hv)), 1, layer,
                                        _t(pt), _t(entry), 0.125, window=33)
    for i in range(7):  # positions < 112
        kc[layer, pt[0, i]] = np.nan
        vc[layer, pt[0, i]] = np.nan
    got = dk.paged_attention_decode_cached(
        *(_t(a).to(cuda_dev) for a in (q, kc, vc, hk, hv)), 1, layer,
        _t(pt).to(cuda_dev), _t(entry).to(cuda_dev), 0.125, window=33)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.cpu(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,H,D,K,prefix_len,t_real,softcap,window,mp,P",
                         PREFILL_CASES + [(40, 8, 16, 2, 21, 33, 50.0, 9, 24, 64)])
def test_prefill_kernel_matches_plain(cuda_dev, dtype, T, H, D, K, prefix_len, t_real,
                                      softcap, window, mp, P):
    q, ck, cv, kc, vc, layer, pt = prefill_inputs(T, H, D, K, prefix_len, t_real,
                                                  mp=mp, P=P)
    dv = [_t(a).to(cuda_dev, dtype) for a in (q, ck, cv, kc, vc)]
    pl = torch.tensor([prefix_len], dtype=torch.int32, device=cuda_dev)
    tr = torch.tensor([t_real], dtype=torch.int32, device=cuda_dev)
    ptd = _t(pt).to(cuda_dev)
    n0 = pk.launches
    got = pk.paged_attention_prefill(*dv, layer, ptd, pl, tr, 1 / math.sqrt(D),
                                     softcap=softcap, window=window)
    want = pk.plain_prefill_batched(dv[0][None], dv[3], dv[4], layer, ptd[None], pl, tr,
                                    1 / math.sqrt(D), softcap=softcap, window=window)[0]
    torch.cuda.synchronize()
    assert pk.launches == n0 + 1
    _close(got[:t_real], want[:t_real], dtype)
