"""The port's kernels: plain versions against the Pallas TPU kernels (run in
interpret mode on the CPU, as tests/test_pallas_*.py run them), the CPU
route of each ``smg_tpu_torch/ops/cuda`` wrapper, and — on a machine with an
NVIDIA GPU only — the CUDA kernels against their plain versions.

Tolerance on the CPU: 2e-5 absolute and relative, float32 on both sides
(summation order only).  On the card: float32 2e-5; bfloat16 outputs a
couple of bf16 ulps apart (1.6e-2 relative, plus 5% of the query row's rms
and at most 2e-2 absolute: see ``_close``)."""

import math
import re
from pathlib import Path

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


# Qwen3-30B-A3B's attention shape: 32 query heads over 4 KV heads (G=8, the
# decode kernel's full head group), head_dim 128
G8_DECODE = [(3, 32, 128, 4, [190, 37, 5], 1, None, None),
             (2, 32, 128, 4, [150, 60], 4, 50.0, 64)]
G8_PREFILL = [(32, 32, 128, 4, 96, 32, None, None, 24, 64),
              (16, 32, 128, 4, 597, 11, None, None, 40, 96)]
# Qwen2-VL-7B's: 28 query heads over 4 KV heads (G=7, a group that does not
# divide 64: the decode kernel masks the eighth head of its group, the
# prefill kernel packs 9 tokens a block with one dead row), head_dim 128
G7_DECODE = [(3, 28, 128, 4, [190, 37, 5], 1, None, None),
             (2, 28, 128, 4, [150, 60], 4, 50.0, 64)]
G7_PREFILL = [(32, 28, 128, 4, 96, 32, None, None, 24, 64),
              (16, 28, 128, 4, 597, 11, None, None, 40, 96),
              (40, 28, 128, 4, 0, 37, None, None, 8, 16)]


def _close(got, want, dtype):
    """float32: 2e-5.  bfloat16: 1.6e-2 x |plain| (two bf16 ulps) plus an
    absolute term of 5% of the row's rms, at most 2e-2: an output over n
    keys has an rms near sqrt(e / n), so over thousands of keys a fixed 2e-2
    would be as large as the values and pass a split dropped or weighed
    wrong.  A row is one query: the last two axes are (heads, head_dim)."""
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    else:
        g, w = got.float(), want.float()
        err = (g - w).abs()
        atol = (0.05 * w.pow(2).mean(dim=(-2, -1), keepdim=True).sqrt()).clamp(max=2e-2)
        assert bool((err <= atol + 1.6e-2 * w.abs()).all()), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,D,K,entries,n_extra,softcap,window",
                         DECODE_CASES + [(3, 8, 16, 2, [40, 5, 208], 2, None, 24)]
                         + G8_DECODE + G7_DECODE)
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
                         PREFILL_CASES + [(40, 8, 16, 2, 21, 33, 50.0, 9, 24, 64)]
                         + G8_PREFILL + G7_PREFILL)
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


# ---- the split-KV decode and tensor-core prefill, at the edges of their
# tiling (card only, except the split-count rule) ----

@pytest.mark.parametrize("B,K,max_keys", [(1, 8, 20), (1, 8, 8016), (4, 8, 4100),
                                          (32, 8, 4116), (64, 8, 132_000), (4, 8, 64),
                                          (1, 1, 63), (256, 8, 1_000_000)])
def test_decode_split_count(B, K, max_keys):
    s = dk.num_splits(B, K, max_keys)
    assert 1 <= s <= dk.MAX_SPLITS  # every context gets at least one split
    # no split shorter than the wrapper's floor, which is at least one tile
    # per warp of either kernel
    assert s == 1 or max_keys / s >= dk.MIN_SPLIT_KEYS


def test_decode_split_cap_is_the_kernels_bound():
    """The wrapper's cap on S is the bound the kernel checks."""
    src = (Path(dk.__file__).parents[2] / "csrc" / "decode_attention.cu").read_text()
    bound = re.search(r"constexpr int MAX_SPLITS = (\d+);", src)
    assert bound and int(bound.group(1)) == dk.MAX_SPLITS


def test_decode_splits_fill_the_card_at_batch_4():
    """Llama-3-8B at batch 4 (8 KV heads) over a 4096-token table: enough
    blocks for every SM."""
    assert 4 * 8 * dk.num_splits(4, 8, 4096 + 4) >= dk.SM_COUNT


def _dev_args(arrays, dev, dtype):
    return [_t(a).to(dev, dtype) for a in arrays]


def _decode_on_card(dev, dtype, B, H, D, K, entries, n_extra, softcap=None, window=None,
                    pad_last=False):
    mp = max(entries) // 16 + 2
    if pad_last:
        entries = list(entries[:-1]) + [mp * 16]
    q, kc, vc, hk, hv, layer, pt, entry = decode_inputs(B, H, D, K, entries, mp=mp,
                                                         P=B * mp + 1)
    args = _dev_args((q, kc, vc, hk, hv), dev, dtype)
    rest = (n_extra, layer, _t(pt).to(dev), _t(entry).to(dev), 1 / math.sqrt(D))
    n0 = dk.launches
    got = dk.paged_attention_decode_cached(*args, *rest, softcap=softcap, window=window)
    want = tatt.attention_decode_cached(*args, *rest, softcap=softcap, window=window)
    torch.cuda.synchronize()
    assert dk.launches == n0 + 1
    assert torch.isfinite(got).all()
    _close(got, want, dtype)


DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_extra", [1, 4])
def test_decode_kernel_split_edges(cuda_dev, dtype, n_extra):
    """Total keys (entry + n_extra) at multiples of the 64-key split floor
    and one either side, and at a 1024-key context cut into 16 splits."""
    edges = [e - n_extra for e in (63, 64, 65, 127, 128, 129, 255, 256, 257)]
    _decode_on_card(cuda_dev, dtype, 9, 32, 128, 8, edges, n_extra)
    _decode_on_card(cuda_dev, dtype, 3, 32, 128, 8, [1023 - n_extra, 1024 - n_extra,
                                                     1025 - n_extra], n_extra)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_extra", [1, 4])
def test_decode_kernel_long_context(cuda_dev, dtype, n_extra):
    """B=1 at Llama-3-8B's 8192-token context, cut into many splits."""
    _decode_on_card(cuda_dev, dtype, 1, 32, 128, 8, [8000], n_extra)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [100, 200])
def test_decode_kernel_window_across_splits(cuda_dev, dtype, window):
    _decode_on_card(cuda_dev, dtype, 2, 32, 128, 8, [3000, 5000], 2, softcap=30.0,
                    window=window)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [None, 2])
def test_decode_kernel_empty_splits_and_padded_row(cuda_dev, dtype, window):
    """A short row beside a long one leaves most of its splits empty; the
    padded last row attends its side rows only (window 2 masks two of its
    four), in a split of its own."""
    _decode_on_card(cuda_dev, dtype, 3, 32, 128, 8, [6000, 5, 0], 4, window=window,
                    pad_last=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("H,K,D", [(12, 12, 64), (16, 8, 256), (64, 8, 128), (32, 2, 128),
                                   (32, 1, 64), (8, 2, 16), (32, 32, 96), (32, 8, 80),
                                   (8, 8, 40)])
def test_decode_kernel_head_shapes(cuda_dev, dtype, H, K, D):
    """head_dim 16/64/128/256, the padded 40/80/96, and 1 to 32 query heads
    per KV head (groups of 16 in bf16, of 8 in float32, beyond those), over
    several splits."""
    _decode_on_card(cuda_dev, dtype, 2, H, D, K, [1500, 700], 3, softcap=50.0)


def _prefill_batch(T, H, D, K, prefixes, t_reals, seed=0):
    """A cache holding each row's prefix with its chunk scattered after it
    (as the models do), row g's pages distinct from the others'."""
    rng = np.random.default_rng(seed)
    Gs, L, layer, KD, ps = len(prefixes), 2, 1, K * D, 16
    mp = (max(prefixes) + T) // ps + 2
    P = Gs * mp + 1
    kc = rng.standard_normal((L, P, ps, KD)).astype(np.float32)
    vc = rng.standard_normal((L, P, ps, KD)).astype(np.float32)
    pt = (rng.permutation(P - 1)[: Gs * mp] + 1).astype(np.int32).reshape(Gs, mp)
    q = rng.standard_normal((Gs, T, H, D)).astype(np.float32)
    ck = rng.standard_normal((Gs, T, KD)).astype(np.float32)
    cv = rng.standard_normal((Gs, T, KD)).astype(np.float32)
    for g in range(Gs):
        pos = prefixes[g] + np.arange(t_reals[g])
        kc[layer, pt[g, pos // ps], pos % ps] = ck[g, : t_reals[g]]
        vc[layer, pt[g, pos // ps], pos % ps] = cv[g, : t_reals[g]]
    return q, ck, cv, kc, vc, layer, pt


def _prefill_on_card(dev, dtype, T, H, D, K, prefixes, t_reals, softcap=None, window=None):
    q, ck, cv, kc, vc, layer, pt = _prefill_batch(T, H, D, K, prefixes, t_reals)
    dv = _dev_args((q, ck, cv, kc, vc), dev, dtype)
    pl = torch.tensor(prefixes, dtype=torch.int32, device=dev)
    tr = torch.tensor(t_reals, dtype=torch.int32, device=dev)
    ptd = _t(pt).to(dev)
    n0 = pk.launches
    got = pk.paged_attention_prefill_batched(*dv, layer, ptd, pl, tr, 1 / math.sqrt(D),
                                             softcap=softcap, window=window)
    want = pk.plain_prefill_batched(dv[0], dv[3], dv[4], layer, ptd, pl, tr,
                                    1 / math.sqrt(D), softcap=softcap, window=window)
    torch.cuda.synchronize()
    assert pk.launches == n0 + 1
    for g, n in enumerate(t_reals):  # rows past t_real are padding
        assert torch.isfinite(got[g, :n]).all()
        _close(got[g, :n], want[g, :n], dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_kernel_ragged_tiles(cuda_dev, dtype):
    """T off the query tile (16 tokens at G=4), t_real < T, a prefix that
    ends inside a key tile."""
    _prefill_on_card(cuda_dev, dtype, 100, 32, 128, 8, [1037], [77])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_kernel_grouped_mixed_prefixes(cuda_dev, dtype):
    """Gs=8 rows of one grouped prefill, each its own prefix and length."""
    _prefill_on_card(cuda_dev, dtype, 64, 32, 128, 8, [0, 16, 37, 100, 1000, 5, 64, 300],
                     [64, 30, 64, 1, 64, 50, 64, 10])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("softcap,window", [(None, None), (50.0, 100)])
@pytest.mark.parametrize("H,K,D", [(8, 8, 64), (16, 8, 256), (32, 8, 128), (64, 8, 128),
                                   (16, 8, 64), (8, 1, 128), (8, 8, 96), (32, 8, 96),
                                   (8, 8, 80), (32, 8, 80), (8, 8, 40), (32, 8, 40)])
def test_prefill_kernel_head_shapes(cuda_dev, dtype, softcap, window, H, K, D):
    """head_dim 64/128/256 and G = 1, 2, 4, 8 query heads per KV head, and
    head dims the bf16 kernel pads (40 to 64; 80 and 96 to 128) at G = 1
    and 4, each over a cached prefix and on a cold row."""
    _prefill_on_card(cuda_dev, dtype, 96, H, D, K, [300, 0], [96, 70], softcap=softcap,
                     window=window)
