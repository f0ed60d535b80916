#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``smg_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py              # every phase, needs one CUDA card
    python3 chip_smoke.py --phases kernels   # build + kernel checks only

Phases (any failure makes the script exit non-zero and print no result):

1. print the card's ``nvidia-smi`` name and power limit, build the kernels
   from ``smg_tpu_torch/csrc`` (nvcc, sm_90a);
2. hold each kernel against its plain PyTorch version on the card, in bf16,
   at the serving path's shapes (Llama-3-8B heads: 32 query / 8 KV heads,
   head_dim 128, page size 16) and at the edges of the decode split (split
   boundaries, a window across two splits, a padded row alone), plus
   head_dim 64 (G=1), 256 (G=2, Gemma-2-9B) and the padded 96 (G=1,
   Phi-3-mini) and 80 (G=4); then time kernel, plain
   version and one PyTorch library call computing the same function (SDPA
   on gathered K/V, a yardstick the port never calls) at the timed shapes:
   decode B=32 ragged, B=4 x ~1000 with n_extra 4 (the serving shape) and
   B=1 x 8000; prefill T=512 over a 1000-token prefix and a cold grouped
   prefill of 8 rows;
3. serve requests on Llama-3-8B at full width and depth (random bf16
   weights from a fixed seed, bf16 KV): a chunked long prompt, a radix
   prefix hit, decode horizon 4, submitted from the main thread with
   ``on_output`` callbacks.  Three paths in turn: the serving path (decode
   megasteps replayed from CUDA graphs, the overlap pipeline, the engine's
   loop thread via ``engine.start()``), the eager synchronous path on the
   same kernels (``decode_graphs=False``, ``overlap_schedule=False``,
   stepped from the main thread), and the plain attention versions (eager,
   synchronous).  Kernel launch counts must equal what the schedule
   implies (32 layers x decode columns, counted through graph replays; 32
   x prefill forward calls) and every run's ``audit()`` must be clean;
   decode is profiled on 4 lanes per path.  All three again on the same
   weights widened to float32 with float32 KV, where the greedy streams
   must be identical and which is the reference the bf16 runs'
   first-token logits are held to.  Then preemption: 4 layers, float32,
   a page pool too small for four requests, streams equal to a roomy run
   and no page leaked;
4. request semantics, on the same weights in bf16 and then in float32,
   through the same three paths: six requests with a synthetic tokenizer
   at the full vocabulary (``PieceTokenizer``): greedy with frequency and
   presence penalties, greedy with a repetition penalty, sampled with a
   frequency penalty, greedy with a stop string (the text of tokens 10-12
   of the same prompt's unconstrained greedy run), greedy under a regex,
   sampled under the JSON grammar.  Each must finish with its expected
   count and reason, the stop request's text must end where its stop
   string began, the regex and JSON texts must be valid (complete and
   parsable when they stopped), launch counts and audits as in phase 3;
   in float32 the greedy streams must be identical across the paths.
   Readings on the graph path: host ms per grammar mask (each dtype); in
   bf16 the penalty work alone, decode on 4 lanes with and without
   penalties, and a window held at horizon 1 by a stop-string lane;
5. print ``{"kernels": [...]}`` and, last, ``{"ok": true, "device": ...}``
   (``--phases kernels`` stops after phase 2 and prints neither).

TF32 is off for matmuls and cuDNN, so float32 references stay float32.
Timings are medians of 15 repeats after warm-up: device time between CUDA
events, the L2 flushed before each repeat and the host's launch overhead
kept out (``cuda_ms``); each is also timed issued from an idle queue
(``call_ms``), host launch time included, as the port's first measurements
were.  The whole script takes a few minutes on an H100, the kernels'
build included.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
# bf16 outputs of the same f32 arithmetic summed in another order: at most a
# couple of bf16 ulps (2^-7 relative) apart, plus an absolute term of 5% of
# the query row's rms (at most 2e-2).  An output over n keys has an rms near
# sqrt(e / n): over thousands of keys a fixed 2e-2 would be as large as the
# values, and would pass a decode split that was dropped or weighed wrong.
KERNEL_RMS_ATOL, KERNEL_MAX_ATOL, KERNEL_RTOL = 0.05, 2e-2, 1.6e-2
# first-token logits at full depth.  In float32 kernel and plain attention
# differ only in summation order: held to 2e-3 absolute, and the greedy
# streams must be identical.  In bf16 each run rounds its attention output
# to bf16 in other places and 32 layers carry that on, so the two are not
# held to each other but to the float32 run on the same (bf16-valued)
# weights: the kernel's bf16 logits may be at most twice as far from it as
# the plain version's.
F32_LOGIT_ATOL = 2e-3
BF16_ERR_RATIO = 2.0


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def call_ms(fn, warmup: int = 3, reps: int = 15) -> float:
    """Median CUDA-event time of one call issued from an idle queue, in
    milliseconds: the device time plus whatever host time the call spends
    before its first kernel starts."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


_L2_FLUSH = []  # a buffer larger than the H100's 50 MB L2


def cuda_ms(fn, warmup: int = 3, reps: int = 15) -> float:
    """Median device time of one call, in milliseconds, with a cold L2.

    A spin kernel holds the stream while the host enqueues every repeat
    (an L2 flush, a start event, the call, an end event), so each event
    pair brackets device work only, not the host's launch overhead.  The
    flush reads 128 MB, so it leaves clean lines and no write-back."""
    import torch

    if not _L2_FLUSH:
        _L2_FLUSH.append(torch.ones(32 << 20, dtype=torch.float32, device="cuda"))
    flush = _L2_FLUSH[0]
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flush.sum()
    fn()
    host_s = time.perf_counter() - t0  # enqueue time of one repeat
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(reps)]
    # ~2e9 spin cycles a second; twice the host's enqueue time, and 2 ms more
    torch.cuda._sleep(int(2e9 * (2 * reps * host_s + 2e-3)))
    for a, b in ev:
        flush.sum()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


# ---- phase 2: kernels against their plain versions ----

H, K, D, PS = 32, 8, 128, 16  # Llama-3-8B attention shapes
SHAPES = {  # (query heads, KV heads, head_dim) of the correctness-only cases
    "llama3": (H, K, D),
    "d64_g1": (12, 12, 64),  # multi-head attention at head_dim 64
    "d256_g2": (16, 8, 256),  # Gemma-2-9B
    # head dims the bf16 kernels pad to 128
    "d96_g1": (32, 32, 96),  # Phi-3-mini
    "d80_g4": (32, 8, 80),
}


def _cache(L: int, P: int, KD: int, gen, dev):
    import torch

    k = torch.randn((L, P, PS, KD), generator=gen, device=dev).bfloat16()
    v = torch.randn((L, P, PS, KD), generator=gen, device=dev).bfloat16()
    return k, v


def decode_case(B, entries, N, n_extra, softcap, window, gen, dev, pad_row=False,
                shape=(H, K, D)):
    """Decode inputs: ragged entries, distinct pages per row; with
    ``pad_row`` the last row is decode-bucket padding (entry = mp*ps)."""
    import torch

    h, k, d = shape
    mp = math.ceil(max(entries) / PS) + 1
    if pad_row:
        entries = list(entries[:-1]) + [mp * PS]
    P = B * mp + 1
    kc, vc = _cache(2, P, k * d, gen, dev)
    pt = (torch.randperm(P - 1, generator=gen, device=dev)[: B * mp] + 1).reshape(B, mp)
    return dict(
        q=torch.randn((B, h, d), generator=gen, device=dev).bfloat16(),
        k_cache=kc, v_cache=vc,
        hk=torch.randn((B, N, k * d), generator=gen, device=dev).bfloat16(),
        hv=torch.randn((B, N, k * d), generator=gen, device=dev).bfloat16(),
        n_extra=n_extra, layer=1, page_tables=pt.int().contiguous(),
        entry_positions=torch.tensor(entries, dtype=torch.int32, device=dev),
        scale=1.0 / math.sqrt(d), softcap=softcap, window=window,
    )


def decode_work(c) -> tuple[float, float]:
    """(bytes, flops) this run's data needs: each attended K/V row read once."""
    mp = c["page_tables"].shape[1]
    B, h, d = c["q"].shape
    kd = c["k_cache"].shape[-1]
    tokens = 0
    for e in c["entry_positions"].tolist():
        end = 0 if e >= mp * PS else e
        qpos = e + c["n_extra"] - 1
        lo = max(qpos - c["window"] + 1, 0) if c["window"] else 0
        tokens += max(end - lo, 0) + sum(1 for r in range(c["n_extra"]) if e + r >= lo)
    nbytes = tokens * kd * 2 * 2 + 2 * B * h * d * 2 + B * (mp + 1) * 4
    return nbytes, 4.0 * tokens * h * d


def prefill_case(T, prefixes, t_reals, softcap, window, gen, dev, shape=(H, K, D)):
    """Prefill inputs for len(prefixes) sequences; the chunk is scattered
    into the cache first, as the model does, so the plain version (which
    gathers the context from the cache) and the kernel see the same K/V."""
    import torch

    h, k, d = shape
    Gs = len(prefixes)
    mp = math.ceil((max(prefixes) + T) / PS) + 1
    P = Gs * mp + 1
    kc, vc = _cache(2, P, k * d, gen, dev)
    pt = (torch.randperm(P - 1, generator=gen, device=dev)[: Gs * mp] + 1).reshape(Gs, mp)
    ck = torch.randn((Gs, T, k * d), generator=gen, device=dev).bfloat16()
    cv = torch.randn((Gs, T, k * d), generator=gen, device=dev).bfloat16()
    for g in range(Gs):
        pos = prefixes[g] + torch.arange(t_reals[g], device=dev)
        pages = pt[g, pos // PS].long()
        kc[1, pages, pos % PS] = ck[g, : t_reals[g]]
        vc[1, pages, pos % PS] = cv[g, : t_reals[g]]
    return dict(
        q=torch.randn((Gs, T, h, d), generator=gen, device=dev).bfloat16(),
        chunk_k=ck, chunk_v=cv, k_cache=kc, v_cache=vc, layer=1,
        page_tables=pt.int().contiguous(),
        prefix_lens=torch.tensor(prefixes, dtype=torch.int32, device=dev),
        t_reals=torch.tensor(t_reals, dtype=torch.int32, device=dev),
        scale=1.0 / math.sqrt(d), softcap=softcap, window=window,
    )


def prefill_work(c) -> tuple[float, float]:
    _, _, h, d = c["q"].shape
    kd = c["k_cache"].shape[-1]
    keys = rows = prefix_rows = 0
    w = c["window"] or 0
    for p, tr in zip(c["prefix_lens"].tolist(), c["t_reals"].tolist()):
        rows += tr
        lo_min = max(p - w + 1, 0) if w > 0 else 0
        prefix_rows += p - min(lo_min, p)
        for t in range(tr):
            lo = max(p + t - w + 1, 0) if w > 0 else 0
            keys += (p - min(lo, p)) + (t + 1 - max(lo - p, 0))
    nbytes = (prefix_rows + rows) * kd * 2 * 2 + 2 * rows * h * d * 2
    return nbytes, 4.0 * keys * h * d


def _gathered(kc, vc, layer, pt, d):
    """[B, K, S, D] K/V gathered through the page tables (for SDPA)."""
    B, mp = pt.shape
    k = kc.shape[-1] // d
    idx = pt.long()
    kg = kc[layer][idx].reshape(B, mp * PS, k, d).transpose(1, 2).contiguous()
    vg = vc[layer][idx].reshape(B, mp * PS, k, d).transpose(1, 2).contiguous()
    return kg, vg


def decode_library(c):
    """One SDPA call on pre-gathered dense K/V computing the same function
    (no softcap/window: the timed cases have none)."""
    import torch
    import torch.nn.functional as F

    B, _, d = c["q"].shape
    kv = c["k_cache"].shape[-1] // d
    k, v = _gathered(c["k_cache"], c["v_cache"], c["layer"], c["page_tables"], d)
    S = k.shape[2]
    n = c["n_extra"]
    k = torch.cat([k, c["hk"][:, :n].reshape(B, n, kv, d).transpose(1, 2)], 2)
    v = torch.cat([v, c["hv"][:, :n].reshape(B, n, kv, d).transpose(1, 2)], 2)
    j = torch.arange(S + n, device=k.device)
    e = c["entry_positions"].long()[:, None]
    mask = torch.where(j < S, j < e, torch.ones_like(j, dtype=torch.bool))
    q = c["q"][:, :, None, :]  # [B, H, 1, D]
    m = mask[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=m, scale=c["scale"],
                                                  enable_gqa=True)


def prefill_library(c):
    import torch
    import torch.nn.functional as F

    d = c["q"].shape[-1]
    k, v = _gathered(c["k_cache"], c["v_cache"], c["layer"], c["page_tables"], d)
    S = k.shape[2]
    T = c["q"].shape[1]
    p = c["prefix_lens"].long()[:, None, None]
    tr = c["t_reals"].long()[:, None, None]
    j = torch.arange(S, device=k.device)[None, None, :]
    t = torch.arange(T, device=k.device)[None, :, None]
    m = ((j <= p + t) & (j < p + tr))[:, None]  # [Gs, 1, T, S]
    q = c["q"].transpose(1, 2)  # [Gs, H, T, D]
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=m, scale=c["scale"],
                                                  enable_gqa=True)


def check_close(name, got, want, rows=None):
    import torch

    if rows is not None:
        got, want = got[rows], want[rows]
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (g - w).abs()
    # a row is one query: the last two axes are (heads, head_dim)
    rms = w.pow(2).mean(dim=(-2, -1), keepdim=True).sqrt()
    atol = (KERNEL_RMS_ATOL * rms).clamp(max=KERNEL_MAX_ATOL)
    limit = atol + KERNEL_RTOL * w.abs()
    ok = bool((err <= limit).all())
    mx = float(err.max())
    print(f"  {name}: max_abs_err={mx:.3e} (largest share of its limit "
          f"{float((err / limit.clamp(min=1e-30)).max()):.3f}, row rms {float(rms.min()):.3e}.."
          f"{float(rms.max()):.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with the plain version ({mx:.3e})")
    return mx


def time_case(label, kernel, plain, library, work) -> dict:
    """Kernel, plain and library times of one case two ways: device time
    with a cold L2 (``ms``, ``plain_ms``, ``library_ms``), and each call
    issued from an idle queue, host launch time included (``call_ms``,
    ``plain_call_ms``, ``library_call_ms``: the method of the port's first
    measurements, so that older figures compare like for like); and the
    case's bound."""
    bms, by = bound_ms(*work)
    r = dict(ms=cuda_ms(kernel), plain_ms=cuda_ms(plain), library_ms=cuda_ms(library),
             call_ms=call_ms(kernel), plain_call_ms=call_ms(plain),
             library_call_ms=call_ms(library), bound_ms=bms, bound_by=by)
    print(f"  {label}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
          f"library {r['library_ms']:.4f} ms, bound {bms:.4f} ms ({by}); from an idle "
          f"queue: kernel {r['call_ms']:.4f}, plain {r['plain_call_ms']:.4f}, "
          f"library {r['library_call_ms']:.4f}")
    return r


def phase_kernels(dev) -> dict:
    import torch

    from smg_tpu_torch.ops.attention import attention_decode_cached
    from smg_tpu_torch.ops.cuda import decode_attention as dk
    from smg_tpu_torch.ops.cuda import prefill_attention as pk

    gen = torch.Generator(device=dev).manual_seed(1234)
    rng_entries = lambda B, lo, hi: torch.randint(  # noqa: E731
        lo, hi, (B,), generator=gen, device=dev).tolist()

    # decode: (label, B, entries, n_extra, softcap, window, pad_row, shape, timed).
    # The random entries are drawn first, in list order, and new cases go
    # after B32_ragged, so its entries (and bound) stay those of earlier
    # measurements.
    dcases = [
        ("B1_e4000", 1, [4000], 1, None, None, False, "llama3", False),
        ("B8_ragged_nx3_softcap", 8, rng_entries(8, 1, 4096), 3, 50.0, None, False,
         "llama3", False),
        ("B32_ragged_window1000", 32, rng_entries(32, 1, 4096), 1, None, 1000, False,
         "llama3", False),
        ("B8_window7_nx3", 8, rng_entries(8, 1, 4096), 3, None, 7, False, "llama3", False),
        ("B8_padded_row_softcap_window24", 8, rng_entries(8, 1, 4096), 1, 30.0, 24, True,
         "llama3", False),
        ("B32_ragged", 32, rng_entries(32, 1, 4096), 1, None, None, False, "llama3", True),
        # total keys (entry + n_extra) at split boundaries and one either side
        ("B9_split_edges", 9, [62, 63, 64, 126, 127, 128, 254, 255, 256], 1, None, None,
         False, "llama3", False),
        ("B3_split_edges_1024", 3, [1022, 1023, 1024], 1, None, None, False, "llama3",
         False),
        ("B1_window100_two_splits", 1, [3000], 1, None, 100, False, "llama3", False),
        ("B4_padded_row_nx4", 4, rng_entries(4, 900, 1100), 4, None, None, True, "llama3",
         False),
        ("B2_d256_g2_softcap", 2, [700, 3000], 2, 50.0, None, False, "d256_g2", False),
        ("B2_d64_g1_window", 2, [700, 3000], 2, None, 500, False, "d64_g1", False),
        ("B2_d96_g1", 2, [700, 3000], 2, None, None, False, "d96_g1", False),
        ("B2_d80_g4_softcap", 2, [700, 3000], 2, 50.0, None, False, "d80_g4", False),
        ("B4_e1000_nx4", 4, rng_entries(4, 950, 1050), 4, None, None, False, "llama3", True),
        ("B1_e8000", 1, [8000], 1, None, None, False, "llama3", True),
    ]
    d_err, d_timed = 0.0, {}
    for label, B, entries, nx, cap, win, pad, shape, timed in dcases:
        c = decode_case(B, entries, 4, nx, cap, win, gen, dev, pad_row=pad,
                        shape=SHAPES[shape])
        got = dk.paged_attention_decode_cached(**c)
        want = attention_decode_cached(**c)
        torch.cuda.synchronize()
        d_err = max(d_err, check_close(f"decode {label}", got, want))
        if timed:
            d_timed[label] = time_case(
                f"decode {label}", lambda: dk.paged_attention_decode_cached(**c),  # noqa: B023
                lambda: attention_decode_cached(**c), decode_library(c), decode_work(c))  # noqa: B023

    # prefill: (label, T, prefixes, t_reals, softcap, window, shape, timed)
    pcases = [
        ("T128_cold", 128, [0], [128], None, None, "llama3", False),
        ("T128_prefix1000_softcap", 128, [1000], [128], 50.0, None, "llama3", False),
        ("T512_cold_window7", 512, [0], [500], None, 7, "llama3", False),
        ("T512_prefix1000_window300", 512, [1000], [512], 30.0, 300, "llama3", False),
        ("G3_T128_mixed", 128, [0, 1000, 37], [128, 100, 5], None, None, "llama3", False),
        ("T500_prefix1037", 500, [1037], [500], None, None, "llama3", False),
        ("D64_G1_T256_prefix300", 256, [300], [250], None, None, "d64_g1", False),
        ("D256_G2_T256_prefix300_softcap_window", 256, [300], [256], 50.0, 200, "d256_g2",
         False),
        ("D96_G1_T256_prefix300", 256, [300], [250], None, None, "d96_g1", False),
        ("D80_G4_T256_prefix300_softcap", 256, [300], [256], 50.0, None, "d80_g4", False),
        ("T512_prefix1000", 512, [1000], [512], None, None, "llama3", True),
        ("Gs8_T512_cold", 512, [0] * 8, [512, 480, 400, 300, 200, 128, 90, 17], None, None,
         "llama3", True),
    ]
    p_err, p_timed = 0.0, {}
    for label, T, pfx, trs, cap, win, shape, timed in pcases:
        c = prefill_case(T, pfx, trs, cap, win, gen, dev, shape=SHAPES[shape])
        plain = lambda: pk.plain_prefill_batched(  # noqa: E731
            c["q"], c["k_cache"], c["v_cache"], c["layer"], c["page_tables"],  # noqa: B023
            c["prefix_lens"], c["t_reals"], c["scale"], c["softcap"], c["window"])  # noqa: B023
        got = pk.paged_attention_prefill_batched(**c)
        want = plain()
        torch.cuda.synchronize()
        for g, tr in enumerate(trs):  # rows past t_real are padding
            p_err = max(p_err, check_close(f"prefill {label} row{g}", got[g, :tr], want[g, :tr]))
        if timed:
            p_timed[label] = time_case(
                f"prefill {label}", lambda: pk.paged_attention_prefill_batched(**c),  # noqa: B023
                plain, prefill_library(c), prefill_work(c))

    results = {}
    for name, err, timed, main in (
        ("decode_attention", d_err, d_timed, "B32_ragged"),
        ("prefill_attention", p_err, p_timed, "T512_prefix1000"),
    ):
        results[name] = dict(timed[main], max_abs_err=err, timed_case=main,
                             timed_cases=timed)
    return results


# ---- phase 3: the engine on Llama-3-8B ----

def _requests(seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    tok = lambda n: rng.integers(1000, 120000, n).tolist()  # noqa: E731
    shared = tok(600)
    first = [
        ("long_chunked", tok(1400)),  # > max_prefill_tokens: 3 chunks
        ("shared_a", shared + tok(40)),
        ("short", tok(200)),
        ("short2", tok(90)),
    ]
    later = [("shared_b", shared + tok(60))]  # after shared_a finished: radix hit
    return first, later


# (label, attention, decode_graphs, overlap_schedule, background loop): the
# serving path (CUDA graphs, the overlap pipeline, the loop thread), the
# eager synchronous path on the same kernels, and the plain attention
PATHS = (
    ("graphs", "kernel", True, True, True),
    ("eager", "kernel", False, False, False),
    ("plain", "plain", False, False, False),
)
LOOP_WAIT_S = 300  # deadline of every wait on the engine's loop thread


def wait_for(cond, what: str, timeout: float = LOOP_WAIT_S) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{what}: not done within {timeout} s")
        time.sleep(0.001)


def drive_engine(engine, max_new: int, record_logits: list, loop: bool):
    """Submit the requests from this thread with ``on_output`` callbacks.
    With ``loop`` the engine's own thread steps (``engine.start()``);
    otherwise this thread calls ``step()``.  Returns per-request results,
    the wall time of every step, the phase split (synchronous paths only:
    timing a pipelined call would need a sync that defeats the pipeline)
    and the drive's wall time."""
    import torch

    from smg_tpu_torch.engine.engine import collect_result
    from smg_tpu_torch.protocols.sampling import SamplingParams

    runner = engine.runner
    model = runner.model
    orig = model.forward_prefill_batched

    def recording(*a, **kw):
        out = orig(*a, **kw)
        if out is not None:
            record_logits.append(out.float().cpu())
        return out

    model.forward_prefill_batched = recording
    timers = {"prefill_s": 0.0, "decode_s": 0.0}
    if not loop:
        def timed(name, fn):
            def wrapper(*a, **kw):
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                timers[name] += time.perf_counter() - t0
                return out
            return wrapper

        runner.prefill_extend = timed("prefill_s", runner.prefill_extend)
        runner.prefill_batched = timed("prefill_s", runner.prefill_batched)
        runner.decode_multi_async = timed("decode_s", runner.decode_multi_async)
        runner.decode_fetch = timed("decode_s", runner.decode_fetch)
    step_ms = []
    step = engine.step

    def timed_step():  # the loop thread calls engine.step
        t0 = time.perf_counter()
        out = step()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    engine.step = timed_step
    first, later = _requests(7)
    chunks: dict[str, list] = {}
    sp = lambda: SamplingParams(temperature=0.0, max_new_tokens=max_new, ignore_eos=True)  # noqa: E731

    def submit(batch):
        for rid, ids in batch:
            chunks[rid] = []
            engine.submit(ids, sp(), rid=rid, on_output=chunks[rid].append)

    finished = lambda rid: bool(chunks[rid]) and chunks[rid][-1].finished  # noqa: E731
    t0 = time.perf_counter()
    if loop:
        engine.start()
        submit(first)
        wait_for(lambda: finished("shared_a"), "shared_a")
        submit(later)  # after shared_a finished: a radix hit
        wait_for(lambda: all(finished(r) for r in chunks) and not engine.has_work(),
                 "the five requests")
        engine.stop()
    else:
        submit(first)
        while engine.has_work() or later:
            if later and finished("shared_a"):
                submit(later)
                later = []
            engine.step()
            if len(step_ms) > 500:
                raise RuntimeError("engine did not finish within 500 steps")
    wall_s = time.perf_counter() - t0
    del engine.step
    results = {rid: collect_result(rid, c) for rid, c in chunks.items()}
    model.forward_prefill_batched = orig
    return results, step_ms, timers, wall_s


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")  # device work in a trace


def device_time(prof) -> tuple[float, dict, int]:
    """(busy ms, ms by kernel name, number of device events) from the
    profiler's trace: device events only, busy time as the union of their
    intervals.  ``key_averages()`` would also count the operator
    annotations the trace places on the device timeline, which repeat the
    time of the kernels under them."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    spans, by_name = [], {}
    for ev in events:
        if ev.get("cat") in DEVICE_CATS and ev.get("ph") == "X":
            t0, dur = float(ev["ts"]), float(ev["dur"])
            spans.append((t0, t0 + dur))
            by_name[ev["name"]] = by_name.get(ev["name"], 0.0) + dur / 1e3
    busy, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3, by_name, len(spans)


def profile_decode(engine, loop: bool, columns: int = 8, sampling=None,
                   label: str = "decode profile") -> dict:
    """Decode of 4 lanes with 1000-token prompts, horizon 4 (greedy unless
    ``sampling`` gives the 4 lanes' parameters), under torch.profiler:
    device time by kernel, device events and the busy share (device busy
    time over the wall time of the same columns).  With ``loop`` the
    engine's thread steps and the window closes once ``columns`` more
    columns were launched; otherwise this thread steps.  For a graph path
    the window's megastep shape is also timed alone with CUDA events
    (``replay_ms``, a cold L2), whatever the profiler sees inside graph
    replays."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from smg_tpu_torch.protocols.sampling import SamplingParams

    sched, runner = engine.scheduler, engine.runner
    sampling = sampling or [SamplingParams(temperature=0.0, max_new_tokens=128,
                                           ignore_eos=True)] * 4
    outs: dict[str, list] = {}
    for i, sp in enumerate(sampling):
        outs[f"prof{i}"] = []
        engine.submit(list(range(2000 + 1000 * i, 3000 + 1000 * i)), sp, rid=f"prof{i}",
                      on_output=outs[f"prof{i}"].append)
    if loop:
        engine.start()
        # every lane decoding and the queue empty: horizons are 4 wide
        wait_for(lambda: all(len(o) >= 2 for o in outs.values()), "profile prefill")
    else:
        while sched.waiting or any(r is not None and r.status.value == "prefilling"
                                   for r in sched.slots):
            engine.step()
    for _attempt in range(3):
        # hold the loop thread between two steps while the profiler starts
        # (it takes longer than the lanes' remaining tokens); the window
        # opens when the engine lock is let go
        engine._lock.acquire()
        torch.cuda.synchronize()  # nothing of before the window in the trace
        capture0 = runner.graphs.capture_s
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            cols0, calls0 = runner.stats["decode_columns"], runner.stats["decode_calls"]
            engine._lock.release()
            if loop:
                wait_for(lambda: runner.stats["decode_columns"] - cols0 >= columns, "profile")
            else:
                while runner.stats["decode_columns"] - cols0 < columns:
                    engine.step()
            with engine._lock:  # never sync while the loop thread captures a graph
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
        if runner.graphs.capture_s == capture0:
            break
        # the window's first launch of a new shape was captured in it: the
        # capture is start-up work, not decode, so measure the next columns
        print(f"  {label}: a graph was captured in the window; measuring again")
    cols = runner.stats["decode_columns"] - cols0
    launches = runner.stats["decode_calls"] - calls0
    busy, by_kernel, n_events = device_time(prof)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    if loop:
        wait_for(lambda: all(o and o[-1].finished for o in outs.values())
                 and not engine.has_work(), "profile drain")
        engine.stop()
    else:
        while engine.has_work():
            engine.step()
    out = dict(columns=cols, launches=launches, lanes=4, wall_ms_per_column=wall_ms / cols,
               device_ms_per_column=busy / cols, busy_share=busy / wall_ms,
               device_events_per_column=n_events / cols,
               decode_tok_s=4 * cols / wall_ms * 1e3,
               top=[(name[:80], ms / cols) for name, ms in top])
    K = round(cols / launches)  # the window's horizon
    pen = any(sp.has_penalties for sp in sampling)
    graphs = [s for s in runner.graphs.steps.values()
              if s.graph is not None and s.K == K and s.use_pen == pen and not s.use_mask]
    if graphs:
        st = max(graphs, key=lambda s: s.mp)  # the shape the window replayed
        out["replay_ms"] = cuda_ms(st.graph.replay)
        out["replay_ms_per_column"] = out["replay_ms"] / st.K
        out["replay_shape"] = dict(B=st.B, mp=st.mp, K=st.K, E=st.E, use_pen=st.use_pen)
        out["replay_busy_share"] = out["replay_ms_per_column"] / out["wall_ms_per_column"]
    print(f"  {label}: {cols} columns in {launches} launches, "
          f"wall {out['wall_ms_per_column']:.2f} ms/column, "
          f"device busy {out['device_ms_per_column']:.2f} ms/column "
          f"(busy share {out['busy_share']:.3f}), "
          f"{out['device_events_per_column']:.0f} device events/column, "
          f"{out['decode_tok_s']:.2f} decode tokens/s"
          + (f"; one replay alone {out['replay_ms']:.3f} ms = {out['replay_ms_per_column']:.3f}"
             f" ms/column (busy share by it {out['replay_busy_share']:.3f})"
             if graphs else ""))
    for name, ms in out["top"]:
        print(f"    {ms:8.3f} ms/column  {name}")
    return out


def serve_paths(cfg, params, dev, max_new: int, with_profile: bool = False) -> dict:
    """Serve the requests once per path of ``PATHS`` on one set of weights.
    Launch counters are zeroed just before each measured run and read just
    after it."""
    import gc

    import torch

    from smg_tpu_torch.engine.config import CacheConfig, EngineConfig, SchedulerConfig
    from smg_tpu_torch.engine.engine import Engine
    from smg_tpu_torch.ops.cuda import decode_attention as dk
    from smg_tpu_torch.ops.cuda import prefill_attention as pk
    from smg_tpu_torch.protocols.sampling import SamplingParams

    runs = {}
    for label, attention, graphs, overlap, loop in PATHS:
        econf = EngineConfig(
            model=cfg,
            cache=CacheConfig(page_size=PS, num_pages=2048, auto_size=False, dtype=cfg.dtype),
            scheduler=SchedulerConfig(max_batch_size=8, max_seq_len=4096,
                                      max_prefill_tokens=512, decode_horizon=4,
                                      overlap_schedule=overlap),
            decode_graphs=graphs,
        )
        engine = Engine(econf, params=params, device=dev, attention=attention)
        # warm-up request (cuBLAS handles, allocator, a first graph); not counted
        engine.generate(prompt_ids=list(range(1000, 1100)),
                        sampling=SamplingParams(temperature=0.0, max_new_tokens=4))
        for k in engine.runner.stats:
            engine.runner.stats[k] = 0
        engine.scheduler.num_decode_tokens = 0
        torch.cuda.synchronize()
        reserved0 = torch.cuda.memory_reserved(dev)
        logits: list = []
        dk.launches = 0
        pk.launches = 0
        results, step_ms, timers, wall_s = drive_engine(engine, max_new, logits, loop)
        torch.cuda.synchronize()
        launches = {"decode_attention": dk.launches, "prefill_attention": pk.launches}
        loads = engine.loads()
        runs[label] = dict(results=results, step_ms=step_ms, timers=timers, wall_s=wall_s,
                           logits=logits, stats=dict(engine.runner.stats),
                           launches=launches, loads=loads,
                           reserved_growth=torch.cuda.memory_reserved(dev) - reserved0,
                           decode_tokens=engine.scheduler.num_decode_tokens)
        if loads["audit"]["leaked_pages"] or not loads["audit"]["clean"]:
            raise AssertionError(f"[{label}] audit not clean: {loads['audit']}")
        if with_profile:  # after the measured run: its counts are already read
            runs[label]["profile"] = profile_decode(engine, loop)
        del engine
        gc.collect()  # drive_engine's timers hold the runner in a cycle
        torch.cuda.empty_cache()  # give the KV buffers back before the next engine
    return runs


def check_launches(r, L: int, label: str, plain: bool) -> None:
    """A run's kernel launches equal its schedule: L per decode column
    (graph replays included) and L per prefill call, and the plain path
    launches none."""
    st = r["stats"]
    expect = ({"decode_attention": 0, "prefill_attention": 0} if plain else
              {"decode_attention": L * st["decode_columns"],
               "prefill_attention": L * st["prefill_calls"]})
    print(f"  [{label}] schedule: {st}; launches {r['launches']}, expected {expect}")
    if r["launches"] != expect or (not plain and min(r["launches"].values()) <= 0):
        raise AssertionError(f"[{label}] launch counts {r['launches']} != {expect}")


def check_runs(runs, L: int, max_new: int, label: str) -> dict:
    """Counts, finishes, the radix hit and the audit of every run; returns
    first-token logit gaps and greedy-stream agreement of each path with
    the plain run and of the graph path with the eager one."""
    import torch

    for name, r in runs.items():
        for rid, res in r["results"].items():
            if res.output_tokens != max_new or res.finish_reason != "length":
                raise AssertionError(f"[{label}/{name}] {rid}: expected {max_new} tokens, "
                                     f"finish 'length'")
        if r["results"]["shared_b"].cached_tokens <= 0:
            raise AssertionError(f"[{label}/{name}] shared_b got no radix prefix hit")
        check_launches(r, L, f"{label}/{name}", plain=name == "plain")
    for rid, res in runs["graphs"]["results"].items():
        print(f"  [{label}] {rid}: prompt {res.prompt_tokens}, cached {res.cached_tokens}, "
              f"output {res.output_tokens}, finish {res.finish_reason}")
    n_logits = {len(r["logits"]) for r in runs.values()}
    if len(n_logits) != 1:
        raise AssertionError(f"[{label}] the runs ran different prefill schedules")
    if not all(bool(torch.isfinite(a).all()) for r in runs.values() for a in r["logits"]):
        raise AssertionError(f"[{label}] non-finite first-token logits")

    def gap(a, b):
        return max(float((x - y).abs().max()) for x, y in zip(runs[a]["logits"],
                                                                runs[b]["logits"]))

    def agree(a, b):
        return sum(runs[a]["results"][rid].token_ids == runs[b]["results"][rid].token_ids
                   for rid in runs[a]["results"])

    out = dict(logit_gap={f"{a}_vs_{b}": gap(a, b) for a, b in
                          (("graphs", "eager"), ("eager", "plain"), ("graphs", "plain"))},
               streams_equal={f"{a}_vs_{b}": agree(a, b) for a, b in
                              (("graphs", "eager"), ("eager", "plain"), ("graphs", "plain"))},
               max_abs_logit=max(float(b.abs().max()) for b in runs["plain"]["logits"]))
    print(f"  [{label}] first-token logits: max_abs_diff {out['logit_gap']} "
          f"(max |logit| {out['max_abs_logit']:.3f}); greedy streams equal (of "
          f"{len(runs['plain']['results'])}): {out['streams_equal']}")
    return out


def _widen(params: dict) -> None:
    """Cast every weight to float32 in place, one tensor at a time."""
    for group in (params, params["layers"]):
        for k, v in group.items():
            if k != "layers":
                group[k] = v.float()


def summarize(runs, card: str, label: str) -> dict:
    out = {}
    for name, r in runs.items():
        s, loads = r["stats"], r["loads"]
        row = dict(
            wall_s=r["wall_s"],
            tok_s=sum(res.output_tokens for res in r["results"].values()) / r["wall_s"],
            steps=len(r["step_ms"]),
            step_ms_median=statistics.median(r["step_ms"]),
            step_ms_max=max(r["step_ms"]),
            decode_columns=s["decode_columns"],
            lookahead_kept=loads["lookahead_kept"],
            lookahead_discarded=loads["lookahead_discarded"],
            decode_graphs=loads["decode_graphs"],
            graph_capture_s=loads["graph_capture_s"],
            graph_capture_bytes=loads["graph_capture_bytes"],
            reserved_growth_bytes=r["reserved_growth"],
        )
        if r["timers"]["decode_s"]:  # synchronous paths: the phase split
            row.update(prefill_tok_s=s["prefill_tokens"] / r["timers"]["prefill_s"],
                       decode_tok_s_drive=r["decode_tokens"] / r["timers"]["decode_s"],
                       decode_ms_per_column=r["timers"]["decode_s"] * 1e3 / s["decode_columns"])
        if "profile" in r:
            p = r["profile"]
            row.update({k: p[k] for k in ("decode_tok_s", "wall_ms_per_column",
                                          "device_ms_per_column", "busy_share",
                                          "device_events_per_column") if k in p})
            row.update({k: p[k] for k in ("replay_ms_per_column", "replay_busy_share")
                        if k in p})
        out[name] = row
        print(f"  [{card}] {label} {name}: " + ", ".join(
            f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}" for k, v in row.items()))
    return out


def phase_preempt(dev) -> dict:
    """Preemption on the card: Llama-3-8B at full width, 4 layers, float32
    weights and KV, the serving path (graphs, overlap, loop).  A pool of
    21 pages cannot grow four 64-token prompts to 112 tokens each; the
    greedy streams must equal a run with room to spare, with no page
    leaked."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from smg_tpu_torch.engine.config import CacheConfig, EngineConfig, SchedulerConfig
    from smg_tpu_torch.engine.engine import Engine, collect_result
    from smg_tpu_torch.models.config import llama3_8b_config
    from smg_tpu_torch.models.llama import init_params
    from smg_tpu_torch.protocols.sampling import SamplingParams

    cfg = dataclasses.replace(llama3_8b_config(), num_layers=4, dtype="float32")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(3), dev)
    rng = np.random.default_rng(11)
    jobs = [(f"p{i}", rng.integers(1000, 120000, 64).tolist()) for i in range(4)]

    def run(num_pages: int):
        engine = Engine(EngineConfig(
            model=cfg,
            cache=CacheConfig(page_size=PS, num_pages=num_pages, auto_size=False,
                              dtype="float32"),
            scheduler=SchedulerConfig(max_batch_size=4, max_seq_len=512,
                                      max_prefill_tokens=512, decode_horizon=4,
                                      watermark_pages=1)), params=params, device=dev)
        chunks = {rid: [] for rid, _ in jobs}
        engine.start()
        try:
            for rid, ids in jobs:
                engine.submit(ids, SamplingParams(temperature=0.0, max_new_tokens=48,
                                                  ignore_eos=True),
                              rid=rid, on_output=chunks[rid].append)
            wait_for(lambda: all(c and c[-1].finished for c in chunks.values())
                     and not engine.has_work(), "preemption run")
        finally:
            engine.stop()
        loads = engine.loads()
        streams = {rid: collect_result(rid, c).token_ids for rid, c in chunks.items()}
        del engine
        gc.collect()
        return streams, loads

    want, roomy = run(256)
    got, tight = run(22)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    audit = tight["audit"]
    out = dict(preemptions=tight["preemptions"], unpressured_preemptions=roomy["preemptions"],
               streams_equal=sum(got[r] == want[r] for r in want), requests=len(want),
               leaked_pages=audit["leaked_pages"], clean=audit["clean"],
               decode_graphs=tight["decode_graphs"])
    print(f"  preemption (4 layers, f32, 21 pages): {out}")
    if out["preemptions"] <= 0 or out["streams_equal"] != len(want) or out["leaked_pages"] \
            or not out["clean"]:
        raise AssertionError(f"preemption check failed: {out}")
    return out


# ---- phase 4: request semantics on Llama-3-8B ----

PIECE_ALPHABET = '{}[]":,. 0123456789abcdefghijklmnopqrstuvwxyz'
REGEX_E = r"[a-z]{2,6}(,[0-9]{1,3}){2}"
NEVER_STOP = "~"  # outside the alphabet: a stop-string lane that never stops


class PieceTokenizer:
    """A synthetic tokenizer at Llama-3's vocabulary, a test harness and not
    part of the port (no tokenizer file is in the repository).  The
    config's BOS and EOS ids are special and decode to nothing; every other
    id is a fixed piece of 1-3 characters over a JSON-capable alphabet,
    drawn from a seed (the first ids after 1 hold each character alone);
    ``decode`` concatenates the pieces.  With it the JSON, regex and
    stop-string paths do their full work over all 128256 ids."""

    def __init__(self, vocab_size: int, special_ids, seed: int = 0):
        import numpy as np

        rng = np.random.default_rng(seed)
        lens = rng.integers(1, 4, vocab_size).tolist()
        chars = rng.integers(0, len(PIECE_ALPHABET), (vocab_size, 3)).tolist()
        self.pieces = ["".join(PIECE_ALPHABET[c] for c in row[:n])
                       for row, n in zip(chars, lens)]
        self.pieces[2:2 + len(PIECE_ALPHABET)] = list(PIECE_ALPHABET)
        for t in special_ids:
            self.pieces[t] = ""

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        return "".join(self.pieces[t] for t in ids)


def _request_jobs(seed: int, stop_d: str | None):
    """D's prompt and the six requests (D first: its 1100-token prompt
    prefills alone in three chunks, as in the probe).  ``stop_d`` None
    gives D's prompt only."""
    import numpy as np

    from smg_tpu_torch.protocols.sampling import SamplingParams as SP

    rng = np.random.default_rng(seed)
    tok = lambda n: rng.integers(1000, 120000, n).tolist()  # noqa: E731
    prompt_d = tok(1100)
    if stop_d is None:
        return prompt_d
    greedy = dict(temperature=0.0, max_new_tokens=32, ignore_eos=True)
    return [
        ("D", prompt_d, SP(**greedy, stop=[stop_d])),
        ("A", tok(80), SP(**greedy, frequency_penalty=0.5, presence_penalty=0.3)),
        ("B", tok(80), SP(**greedy, repetition_penalty=1.3)),
        ("C", tok(80), SP(temperature=0.8, max_new_tokens=32, ignore_eos=True,
                          frequency_penalty=0.4)),
        ("E", tok(40), SP(temperature=0.0, max_new_tokens=16, regex=REGEX_E)),
        ("F", tok(40), SP(temperature=0.7, max_new_tokens=16, json_schema="{}")),
    ]


def drive_requests(engine, jobs, loop: bool, mask_ms: dict):
    """Submit ``jobs`` with ``on_output`` callbacks, then step them to the
    end on the engine's loop thread (``loop``) or from this thread.  Every
    grammar mask the scheduler derives is timed on the host into
    ``mask_ms`` by kind.  Returns (results, wall s)."""
    from smg_tpu_torch.engine.engine import collect_result

    sched = engine.scheduler
    mask_for = sched._mask_for

    def timed_mask(req):
        t0 = time.perf_counter()
        m = mask_for(req)
        mask_ms["regex" if req.sampling.regex else "json"].append(
            (time.perf_counter() - t0) * 1e3)
        return m

    sched._mask_for = timed_mask
    chunks = {rid: [] for rid, _, _ in jobs}
    for rid, prompt, sp in jobs:  # all queued before the first step
        engine.submit(prompt, sp, rid=rid, on_output=chunks[rid].append)
    t0 = time.perf_counter()
    if loop:
        engine.start()
        wait_for(lambda: all(c and c[-1].finished for c in chunks.values())
                 and not engine.has_work(), "the six requests")
        engine.stop()
    else:
        for _ in range(1000):
            if not engine.has_work():
                break
            engine.step()
        else:
            raise RuntimeError("requests did not finish within 1000 steps")
    wall_s = time.perf_counter() - t0
    del sched._mask_for
    return {rid: collect_result(rid, c) for rid, c in chunks.items()}, wall_s


def penalty_ops_ms(dev, V: int, B: int = 8, K: int = 4) -> float:
    """Device ms per decode column of the penalty work a K-column megastep
    adds at batch bucket B: the rows' gather, ``apply_penalties`` and the
    count update per column, the write-back (``cuda_ms`` of one launch's
    share, divided by K)."""
    import torch

    from smg_tpu_torch.engine.sampling import apply_penalties

    gen = torch.Generator(device=dev).manual_seed(4)
    counts_buf = torch.randint(0, 3, (B + 1, V), generator=gen, device=dev, dtype=torch.int32)
    pmask_buf = torch.rand((B + 1, V), generator=gen, device=dev) < 0.01
    slot_idx = torch.arange(B, device=dev)
    logits = torch.randn((B, V), generator=gen, device=dev)
    toks = torch.randint(0, V, (B, K), generator=gen, device=dev)
    freqs, pres, reps = (torch.full((B,), x, device=dev) for x in (0.5, 0.3, 1.3))
    one = torch.ones((B, 1), dtype=torch.int32, device=dev)

    def launch():
        counts = counts_buf.index_select(0, slot_idx)
        pmask = pmask_buf.index_select(0, slot_idx)
        for j in range(K):
            apply_penalties(logits, counts, pmask, freqs, pres, reps)
            counts.scatter_add_(1, toks[:, j:j + 1], one)
        counts_buf.index_copy_(0, slot_idx, counts)

    return cuda_ms(launch) / K


def request_paths(cfg, params, dev, tok, label: str, filters: dict,
                  with_profile: bool = False) -> dict:
    """The six requests once per path of ``PATHS`` on one set of weights.
    Each engine first runs D's prompt alone, greedy, at horizon 1 (a stop
    string that never matches forces it) to take D's stop string from its
    tokens 10-12, then flushes its prefix cache; launch counters are zeroed
    just before the drive and read just after.  The three engines share
    ``filters`` (the grammar filters and their text-keyed mask caches), so
    the graph path, which runs first, pays for every mask it meets.  With
    ``with_profile`` the graph path also profiles decode on 4 lanes without
    and with penalties, and with a stop-string lane that forces horizon 1."""
    import gc

    import torch

    from smg_tpu_torch.engine.config import CacheConfig, EngineConfig, SchedulerConfig
    from smg_tpu_torch.engine.engine import Engine
    from smg_tpu_torch.ops.cuda import decode_attention as dk
    from smg_tpu_torch.ops.cuda import prefill_attention as pk
    from smg_tpu_torch.protocols.sampling import SamplingParams as SP

    prompt_d = _request_jobs(5, None)
    runs = {}
    for name, attention, graphs, overlap, loop in PATHS:
        engine = Engine(EngineConfig(
            model=cfg,
            cache=CacheConfig(page_size=PS, num_pages=2048, auto_size=False, dtype=cfg.dtype),
            scheduler=SchedulerConfig(max_batch_size=8, max_seq_len=4096,
                                      max_prefill_tokens=512, decode_horizon=4,
                                      overlap_schedule=overlap),
            decode_graphs=graphs), params=params, device=dev, attention=attention,
            tokenizer=tok)
        engine._grammar_filters = filters.setdefault("grammar", {})
        engine._json_filter = filters.get("json")
        probe = engine.generate(prompt_d, SP(temperature=0.0, max_new_tokens=13,
                                             ignore_eos=True, stop=[NEVER_STOP]))
        stop_d = tok.decode(probe.token_ids[10:13])
        if not stop_d or not engine.flush_cache():
            raise AssertionError(f"[{label}/{name}] probe: stop text {stop_d!r}")
        for k in engine.runner.stats:
            engine.runner.stats[k] = 0
        torch.cuda.synchronize()
        mask_ms = {"regex": [], "json": []}
        dk.launches = 0
        pk.launches = 0
        results, wall_s = drive_requests(engine, _request_jobs(5, stop_d), loop, mask_ms)
        torch.cuda.synchronize()
        launches = {"decode_attention": dk.launches, "prefill_attention": pk.launches}
        filters["json"] = engine._json_filter
        runs[name] = dict(results=results, wall_s=wall_s, launches=launches,
                          stats=dict(engine.runner.stats), loads=engine.loads(),
                          probe_text=probe.text, stop_d=stop_d, mask_ms=mask_ms)
        if with_profile and name == "graphs":
            runs[name]["penalty_ops_ms"] = penalty_ops_ms(dev, cfg.vocab_size)
            greedy = SP(temperature=0.0, max_new_tokens=128, ignore_eos=True)
            pen = SP(temperature=0.0, max_new_tokens=128, ignore_eos=True,
                     frequency_penalty=0.5, presence_penalty=0.3, repetition_penalty=1.3)
            forced = SP(temperature=0.0, max_new_tokens=128, ignore_eos=True, stop=[NEVER_STOP])
            runs[name]["profile"] = {
                "no_penalties": profile_decode(engine, loop, sampling=[greedy] * 4,
                                               label=f"[{label}] 4 lanes, no penalties"),
                "penalties": profile_decode(engine, loop, sampling=[pen] * 4,
                                            label=f"[{label}] 4 lanes, penalties"),
                "forced_k1": profile_decode(engine, loop, sampling=[forced] + [greedy] * 3,
                                            label=f"[{label}] 4 lanes, one stop-string lane"),
            }
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    return runs


def check_requests(runs, L: int, label: str, card: str, strict: bool) -> dict:
    """Per-request checks on every path (counts, finishes, D cut at its
    stop string, E and F valid), launch counts, audits; greedy streams of
    A, B, D and E compared across paths (``strict``: all must be equal).
    Returns the agreement and the readings."""
    import re

    from smg_tpu_torch.constrained import JsonMachine
    from smg_tpu_torch.constrained.regex_fsm import RegexMachine

    rx = RegexMachine(REGEX_E)
    for name, r in runs.items():
        tag = f"{label}/{name}"
        res = r["results"]
        check_launches(r, L, f"{tag} requests", plain=name == "plain")
        audit = r["loads"]["audit"]
        if audit["leaked_pages"] or not audit["clean"]:
            raise AssertionError(f"[{tag}] audit not clean: {audit}")
        for rid in "ABC":
            if res[rid].output_tokens != 32 or res[rid].finish_reason != "length":
                raise AssertionError(f"[{tag}] {rid}: {res[rid]}")
        d, stop, probe = res["D"], r["stop_d"], r["probe_text"]
        want = probe[:probe.find(stop)]
        if (d.finish_reason != "stop" or d.matched_stop != stop or d.text != want
                or d.output_tokens > 13):
            raise AssertionError(f"[{tag}] D: stop {stop!r}, want text {want!r}, got {d}")
        for rid, ok, whole in (("E", rx.accepts, lambda t: rx.complete(t)
                                and re.fullmatch(REGEX_E, t) is not None),
                               ("F", JsonMachine().accepts, _json_parses)):
            x = res[rid]
            if not ok(x.text) or (x.finish_reason == "stop" and not whole(x.text)) or (
                    x.finish_reason != "stop" and (x.finish_reason, x.output_tokens)
                    != ("length", 16)):
                raise AssertionError(f"[{tag}] {rid}: invalid {x.text!r} ({x})")
        print(f"  [{tag}] " + "; ".join(
            f"{rid}: {x.output_tokens} tok, {x.finish_reason}, {x.text!r}"
            for rid, x in res.items()))

    def agree(a, b):
        return sum(runs[a]["results"][rid].token_ids == runs[b]["results"][rid].token_ids
                   for rid in "ABDE")

    pairs = (("graphs", "eager"), ("eager", "plain"), ("graphs", "plain"))
    out = dict(streams_equal={f"{a}_vs_{b}": agree(a, b) for a, b in pairs})
    print(f"  [{label}] greedy streams A, B, D, E equal (of 4): {out['streams_equal']}")
    if strict and set(out["streams_equal"].values()) != {4}:
        raise AssertionError(f"[{label}] greedy request streams differ: {out}")
    g = runs["graphs"]
    for kind, ms in g["mask_ms"].items():
        if not ms:
            raise AssertionError(f"[{label}] no {kind} mask was derived")
        out[f"mask_ms_{kind}"] = dict(n=len(ms), median=statistics.median(ms), max=max(ms),
                                      total_s=sum(ms) / 1e3)
    out["drive_wall_s"] = {name: r["wall_s"] for name, r in runs.items()}
    out["launches"] = {name: r["launches"] for name, r in runs.items()}
    out["mask_share_of_graph_drive"] = sum(map(sum, g["mask_ms"].values())) / 1e3 / g["wall_s"]
    print(f"  [{card}] {label} host ms per masked token (graph path, V=128256): " + ", ".join(
        f"{k[8:]} median {v['median']:.2f} max {v['max']:.2f} (n={v['n']})"
        for k, v in out.items() if k.startswith("mask_ms_"))
        + f"; masks {out['mask_share_of_graph_drive']:.3f} of the graph drive's "
          f"{g['wall_s']:.2f} s")
    if "profile" in g:
        p = g["profile"]
        out["profile"] = {k: {m: v[m] for m in ("device_ms_per_column", "wall_ms_per_column",
                                                "busy_share", "decode_tok_s", "columns",
                                                "launches", "replay_ms_per_column")
                              if m in v} for k, v in p.items()}
        a, b = p["no_penalties"], p["penalties"]
        out["penalty_ops_ms_per_column"] = g["penalty_ops_ms"]
        out["penalty_device_ms_per_column"] = (b["device_ms_per_column"]
                                               - a["device_ms_per_column"])
        out["forced_k1_host_share"] = 1.0 - p["forced_k1"]["busy_share"]
        print(f"  [{card}] {label} penalty work alone (B=8, K=4): "
              f"{g['penalty_ops_ms']:.4f} ms/column; penalties on 4 lanes: device "
              f"{b['device_ms_per_column']:.3f} vs {a['device_ms_per_column']:.3f} ms/column "
              f"({out['penalty_device_ms_per_column']:+.3f}), busy share "
              f"{b['busy_share']:.3f} vs {a['busy_share']:.3f}, "
              f"{b['decode_tok_s']:.2f} vs {a['decode_tok_s']:.2f} tokens/s; forced K=1: "
              f"wall {p['forced_k1']['wall_ms_per_column']:.2f} ms/column, host share "
              f"{out['forced_k1_host_share']:.3f}")
    return out


def _json_parses(text: str) -> bool:
    try:
        json.loads(text)
        return True
    except ValueError:
        return False


def phase_engine(dev, card: str) -> dict:
    import dataclasses

    import torch

    from smg_tpu_torch.models.config import llama3_8b_config
    from smg_tpu_torch.models.llama import init_params

    cfg = llama3_8b_config()
    L, max_new = cfg.num_layers, 32
    # the serving configuration: bf16 weights and KV
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    runs = serve_paths(cfg, params, dev, max_new, with_profile=True)
    agree = check_runs(runs, L, max_new, "bf16")
    out = {"bf16": summarize(runs, card, "bf16"), "bf16_agreement": agree}
    out["decode_profile"] = {k: r["profile"] for k, r in runs.items()}
    out["launches"] = runs["graphs"]["launches"]
    out["schedule"] = runs["graphs"]["stats"]
    # phase 4 on the same weights: penalties, stop strings and grammars
    # through every path, with the synthetic tokenizer at the full vocabulary
    print("phase 4: request semantics, bf16")
    tok = PieceTokenizer(cfg.vocab_size, (cfg.bos_token_id, *cfg.eos_token_ids))
    rq = request_paths(cfg, params, dev, tok, "bf16", {}, with_profile=True)
    out["requests_bf16"] = check_requests(rq, L, "bf16", card, strict=False)
    del rq
    # the same requests on the same weights widened to float32, with float32
    # KV: the three paths differ only in summation order, so the logits
    # agree tightly and the greedy streams match
    _widen(params)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    runs32 = serve_paths(cfg32, params, dev, max_new)
    agree32 = check_runs(runs32, L, max_new, "f32")
    out["f32"] = summarize(runs32, card, "f32")
    out["f32_agreement"] = agree32
    n = len(runs32["plain"]["results"])
    if agree32["streams_equal"] != {k: n for k in agree32["streams_equal"]} or \
            max(agree32["logit_gap"].values()) > F32_LOGIT_ATOL:
        raise AssertionError(f"f32 paths disagree: {agree32}")
    # the float32 plain run is the reference for the bf16 runs
    ref = runs32["plain"]["logits"]
    err = {name: max(float((a - b).abs().max()) for a, b in zip(runs[name]["logits"], ref))
           for name in runs}
    print(f"  [bf16] first-token logits against the f32 run: " + ", ".join(
        f"{k} max_abs_err={v:.3e}" for k, v in err.items()))
    if not max(err["graphs"], err["eager"]) <= BF16_ERR_RATIO * err["plain"]:
        raise AssertionError(f"bf16 kernel logits {err} from the f32 run, more than "
                             f"{BF16_ERR_RATIO} x the plain version's")
    out["bf16_logit_err_vs_f32"] = err
    del runs, runs32
    torch.cuda.empty_cache()
    print("phase 4: request semantics, float32 (widened weights)")
    rq32 = request_paths(cfg32, params, dev, tok, "f32", {})
    del params
    out["requests_f32"] = check_requests(rq32, L, "f32", card, strict=True)
    del rq32
    torch.cuda.empty_cache()
    out["preemption"] = phase_preempt(dev)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", choices=("all", "kernels"), default="all")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs only on the GPU",
              file=sys.stderr)
        return 2
    if not (REPO / "smg_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no smg_tpu_torch package beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    failed = []
    card = card_line()
    print(card)
    try:
        from smg_tpu_torch.ops.cuda import build

        t0 = time.perf_counter()
        lib = build.build(verbose=True)
        build.load()
        print(f"phase 1: built {lib.name} in {time.perf_counter() - t0:.1f} s")
    except Exception:
        traceback.print_exc()
        print("phase 1 FAILED: kernels did not build")
        return 1

    kernels = {}
    print("phase 2: kernels vs plain versions (bf16)")
    try:
        kernels = phase_kernels(dev)
    except Exception:
        traceback.print_exc()
        failed.append("kernels")
    engine = {}
    if args.phases == "all" and not failed:
        print("phase 3: engine on Llama-3-8B (full width, 32 layers)")
        try:
            engine = phase_engine(dev, card)
        except Exception:
            traceback.print_exc()
            failed.append("engine")
    if failed:
        print(f"FAILED phases: {failed}")
        return 1
    if args.phases == "kernels":
        print("kernels checked; the main path did not run, so no result line")
        return 0

    sources = {
        "decode_attention": ("smg_tpu_torch/csrc/decode_attention.cu",
                             "smg_tpu/ops/pallas/decode_attention.py:177"),
        "prefill_attention": ("smg_tpu_torch/csrc/prefill_attention.cu",
                              "smg_tpu/ops/pallas/prefill_attention.py:189"),
    }
    rows = []
    for name, r in kernels.items():
        src, rep = sources[name]
        rows.append(dict(
            name=name, route="cuda", source=src, replaces=rep,
            launches=engine["launches"][name],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
            max_err=r["max_abs_err"], kernel_ms=r["ms"], call_ms=r["call_ms"],
            plain_call_ms=r["plain_call_ms"], library_call_ms=r["library_call_ms"],
            timed_case=r["timed_case"], timed_cases=r["timed_cases"],
        ))
    print(json.dumps({"engine": engine, "card": card}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
