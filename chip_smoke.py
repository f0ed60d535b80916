#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``smg_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py              # every phase, needs one CUDA card
    python3 chip_smoke.py --phases kernels   # build + kernel checks only

Phases (any failure makes the script exit non-zero and print no result):

1. print the card's ``nvidia-smi`` name and power limit, build the kernels
   from ``smg_tpu_torch/csrc`` (nvcc, sm_90a);
2. hold each kernel against its plain PyTorch version on the card, in bf16,
   at the serving path's shapes (Llama-3-8B heads: 32 query / 8 KV heads,
   head_dim 128, page size 16), and time kernel, plain version and one
   PyTorch library call computing the same function (SDPA on gathered K/V,
   a yardstick the port never calls) with CUDA events;
3. serve requests through ``Engine.submit``/``step`` on Llama-3-8B at full
   width and depth (random bf16 weights from a fixed seed, bf16 KV): a
   chunked long prompt, a radix prefix hit, decode horizon 4.  Kernel launch
   counts must equal what the schedule implies (32 layers x decode columns,
   32 x prefill forward calls); the same requests are rerun with the plain
   attention versions, then both again on the same weights widened to
   float32 with float32 KV, where the greedy streams must be identical and
   which is the reference the two bf16 runs' first-token logits are held
   to;
4. print ``{"kernels": [...]}`` and, last, ``{"ok": true, "device": ...}``
   (``--phases kernels`` stops after phase 2 and prints neither).

TF32 is off for matmuls and cuDNN, so float32 references stay float32.
Timings are medians of CUDA-event-timed repeats after warm-up.
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
# couple of bf16 ulps (2^-7 relative) apart
KERNEL_ATOL, KERNEL_RTOL = 2e-2, 1.6e-2
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


def cuda_ms(fn, warmup: int = 3, reps: int = 15) -> float:
    """Median CUDA-event time of one call, in milliseconds."""
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


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


# ---- phase 2: kernels against their plain versions ----

H, K, D, PS = 32, 8, 128, 16  # Llama-3-8B attention shapes
KD = K * D


def _cache(L: int, P: int, gen, dev):
    import torch

    k = torch.randn((L, P, PS, KD), generator=gen, device=dev).bfloat16()
    v = torch.randn((L, P, PS, KD), generator=gen, device=dev).bfloat16()
    return k, v


def decode_case(B, entries, N, n_extra, softcap, window, gen, dev, pad_row=False):
    """Decode inputs: ragged entries, distinct pages per row; with
    ``pad_row`` the last row is decode-bucket padding (entry = mp*ps)."""
    import torch

    mp = math.ceil(max(entries) / PS) + 1
    if pad_row:
        entries = list(entries[:-1]) + [mp * PS]
    P = B * mp + 1
    kc, vc = _cache(2, P, gen, dev)
    pt = (torch.randperm(P - 1, generator=gen, device=dev)[: B * mp] + 1).reshape(B, mp)
    return dict(
        q=torch.randn((B, H, D), generator=gen, device=dev).bfloat16(),
        k_cache=kc, v_cache=vc,
        hk=torch.randn((B, N, KD), generator=gen, device=dev).bfloat16(),
        hv=torch.randn((B, N, KD), generator=gen, device=dev).bfloat16(),
        n_extra=n_extra, layer=1, page_tables=pt.int().contiguous(),
        entry_positions=torch.tensor(entries, dtype=torch.int32, device=dev),
        scale=1.0 / math.sqrt(D), softcap=softcap, window=window,
    )


def decode_work(c) -> tuple[float, float]:
    """(bytes, flops) this run's data needs: each attended K/V row read once."""
    mp = c["page_tables"].shape[1]
    tokens = 0
    B = c["q"].shape[0]
    for e in c["entry_positions"].tolist():
        end = 0 if e >= mp * PS else e
        qpos = e + c["n_extra"] - 1
        lo = max(qpos - c["window"] + 1, 0) if c["window"] else 0
        tokens += max(end - lo, 0) + sum(1 for r in range(c["n_extra"]) if e + r >= lo)
    nbytes = tokens * KD * 2 * 2 + 2 * B * H * D * 2 + B * (mp + 1) * 4
    return nbytes, 4.0 * tokens * (H // K) * K * D


def prefill_case(T, prefixes, t_reals, softcap, window, gen, dev):
    """Prefill inputs for len(prefixes) sequences; the chunk is scattered
    into the cache first, as the model does, so the plain version (which
    gathers the context from the cache) and the kernel see the same K/V."""
    import torch

    Gs = len(prefixes)
    mp = math.ceil((max(prefixes) + T) / PS) + 1
    P = Gs * mp + 1
    kc, vc = _cache(2, P, gen, dev)
    pt = (torch.randperm(P - 1, generator=gen, device=dev)[: Gs * mp] + 1).reshape(Gs, mp)
    ck = torch.randn((Gs, T, KD), generator=gen, device=dev).bfloat16()
    cv = torch.randn((Gs, T, KD), generator=gen, device=dev).bfloat16()
    for g in range(Gs):
        for t in range(t_reals[g]):
            pos = prefixes[g] + t
            page = int(pt[g, pos // PS])
            kc[1, page, pos % PS] = ck[g, t]
            vc[1, page, pos % PS] = cv[g, t]
    return dict(
        q=torch.randn((Gs, T, H, D), generator=gen, device=dev).bfloat16(),
        chunk_k=ck, chunk_v=cv, k_cache=kc, v_cache=vc, layer=1,
        page_tables=pt.int().contiguous(),
        prefix_lens=torch.tensor(prefixes, dtype=torch.int32, device=dev),
        t_reals=torch.tensor(t_reals, dtype=torch.int32, device=dev),
        scale=1.0 / math.sqrt(D), softcap=softcap, window=window,
    )


def prefill_work(c) -> tuple[float, float]:
    keys = rows = prefix_rows = 0
    w = c["window"] or 0
    for p, tr in zip(c["prefix_lens"].tolist(), c["t_reals"].tolist()):
        rows += tr
        lo_min = max(p - w + 1, 0) if w > 0 else 0
        prefix_rows += p - min(lo_min, p)
        for t in range(tr):
            lo = max(p + t - w + 1, 0) if w > 0 else 0
            keys += (p - min(lo, p)) + (t + 1 - max(lo - p, 0))
    nbytes = (prefix_rows + rows) * KD * 2 * 2 + 2 * rows * H * D * 2
    return nbytes, 4.0 * keys * H * D


def _gathered(kc, vc, layer, pt):
    """[B, K, S, D] K/V gathered through the page tables (for SDPA)."""
    B, mp = pt.shape
    idx = pt.long()
    k = kc[layer][idx].reshape(B, mp * PS, K, D).transpose(1, 2).contiguous()
    v = vc[layer][idx].reshape(B, mp * PS, K, D).transpose(1, 2).contiguous()
    return k, v


def decode_library(c):
    """One SDPA call on pre-gathered dense K/V computing the same function
    (no softcap/window: the timed case has none)."""
    import torch
    import torch.nn.functional as F

    k, v = _gathered(c["k_cache"], c["v_cache"], c["layer"], c["page_tables"])
    B, _, S, _ = k.shape
    n = c["n_extra"]
    k = torch.cat([k, c["hk"][:, :n].reshape(B, n, K, D).transpose(1, 2)], 2)
    v = torch.cat([v, c["hv"][:, :n].reshape(B, n, K, D).transpose(1, 2)], 2)
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

    k, v = _gathered(c["k_cache"], c["v_cache"], c["layer"], c["page_tables"])
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
    ok = bool((err <= KERNEL_ATOL + KERNEL_RTOL * w.abs()).all())
    mx = float(err.max())
    print(f"  {name}: max_abs_err={mx:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with the plain version ({mx:.3e})")
    return mx


def phase_kernels(dev) -> dict:
    import torch

    from smg_tpu_torch.ops.attention import attention_decode_cached
    from smg_tpu_torch.ops.cuda import decode_attention as dk
    from smg_tpu_torch.ops.cuda import prefill_attention as pk

    gen = torch.Generator(device=dev).manual_seed(1234)
    rng_entries = lambda B, hi: torch.randint(  # noqa: E731
        1, hi, (B,), generator=gen, device=dev).tolist()
    results = {}

    # decode: (label, B, entries, n_extra, softcap, window, pad_row)
    dcases = [
        ("B1_e4000", 1, [4000], 1, None, None, False),
        ("B8_ragged_nx3_softcap", 8, rng_entries(8, 4096), 3, 50.0, None, False),
        ("B32_ragged_window1000", 32, rng_entries(32, 4096), 1, None, 1000, False),
        ("B8_window7_nx3", 8, rng_entries(8, 4096), 3, None, 7, False),
        ("B8_padded_row_softcap_window24", 8, rng_entries(8, 4096), 1, 30.0, 24, True),
        ("B32_ragged", 32, rng_entries(32, 4096), 1, None, None, False),  # timed
    ]
    d_err = 0.0
    for label, B, entries, nx, cap, win, pad in dcases:
        c = decode_case(B, entries, 4, nx, cap, win, gen, dev, pad_row=pad)
        got = dk.paged_attention_decode_cached(**c)
        want = attention_decode_cached(**c)
        torch.cuda.synchronize()
        d_err = max(d_err, check_close(f"decode {label}", got, want))
    nbytes, flops = decode_work(c)
    bms, by = bound_ms(nbytes, flops)
    results["decode_attention"] = dict(
        max_abs_err=d_err,
        ms=cuda_ms(lambda: dk.paged_attention_decode_cached(**c)),
        plain_ms=cuda_ms(lambda: attention_decode_cached(**c)),
        library_ms=cuda_ms(decode_library(c)),
        bound_ms=bms, bound_by=by, timed_case="B32_ragged (entries < 4096, n_extra 1)",
    )

    # prefill: (label, T, prefixes, t_reals, softcap, window)
    pcases = [
        ("T128_cold", 128, [0], [128], None, None),
        ("T128_prefix1000_softcap", 128, [1000], [128], 50.0, None),
        ("T512_cold_window7", 512, [0], [500], None, 7),
        ("T512_prefix1000_window300", 512, [1000], [512], 30.0, 300),
        ("G3_T128_mixed", 128, [0, 1000, 37], [128, 100, 5], None, None),
        ("T512_prefix1000", 512, [1000], [512], None, None),  # timed
    ]
    p_err = 0.0
    for label, T, pfx, trs, cap, win in pcases:
        c = prefill_case(T, pfx, trs, cap, win, gen, dev)
        got = pk.paged_attention_prefill_batched(**c)
        want = pk.plain_prefill_batched(
            c["q"], c["k_cache"], c["v_cache"], c["layer"], c["page_tables"],
            c["prefix_lens"], c["t_reals"], c["scale"], c["softcap"], c["window"])
        torch.cuda.synchronize()
        for g, tr in enumerate(trs):  # rows past t_real are padding
            p_err = max(p_err, check_close(f"prefill {label} row{g}", got[g, :tr], want[g, :tr]))
    plain = lambda: pk.plain_prefill_batched(  # noqa: E731
        c["q"], c["k_cache"], c["v_cache"], c["layer"], c["page_tables"],
        c["prefix_lens"], c["t_reals"], c["scale"])
    nbytes, flops = prefill_work(c)
    bms, by = bound_ms(nbytes, flops)
    results["prefill_attention"] = dict(
        max_abs_err=p_err,
        ms=cuda_ms(lambda: pk.paged_attention_prefill_batched(**c)),
        plain_ms=cuda_ms(plain),
        library_ms=cuda_ms(prefill_library(c)),
        bound_ms=bms, bound_by=by, timed_case="T512_prefix1000 (one sequence)",
    )
    for name, r in results.items():
        print(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}) at {r['timed_case']}")
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


def drive_engine(engine, max_new: int, record_logits: list):
    """Submit the requests through Engine.submit/step; returns per-request
    results, step times and the phase split."""
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
    runner.decode_multi = timed("decode_s", runner.decode_multi)

    first, later = _requests(7)
    chunks: dict[str, list] = {}
    sp = lambda: SamplingParams(temperature=0.0, max_new_tokens=max_new, ignore_eos=True)  # noqa: E731
    for rid, ids in first:
        chunks[rid] = []
        engine.submit(ids, sp(), rid=rid, on_output=chunks[rid].append)
    step_ms = []
    pending_later = list(later)
    while engine.has_work() or pending_later:
        if pending_later and chunks["shared_a"] and chunks["shared_a"][-1].finished:
            for rid, ids in pending_later:
                chunks[rid] = []
                engine.submit(ids, sp(), rid=rid, on_output=chunks[rid].append)
            pending_later = []
        t0 = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if len(step_ms) > 500:
            raise RuntimeError("engine did not finish within 500 steps")
    results = {rid: collect_result(rid, c) for rid, c in chunks.items()}
    model.forward_prefill_batched = orig
    return results, step_ms, timers


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


def profile_decode(engine, steps: int = 2) -> dict:
    """Device time by kernel over ``steps`` decode megasteps (4 lanes with
    1000-token prompts, horizon 4) under torch.profiler.  The busy share is
    the device's busy time over the wall time of the same steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from smg_tpu_torch.protocols.sampling import SamplingParams

    sched = engine.scheduler
    sp = SamplingParams(temperature=0.0, max_new_tokens=64, ignore_eos=True)
    for i in range(4):
        engine.submit(list(range(2000 + 1000 * i, 3000 + 1000 * i)), sp, rid=f"prof{i}")
    while sched.waiting or any(r is not None and r.status.value == "prefilling"
                               for r in sched.slots):
        engine.step()
    cols0 = engine.runner.stats["decode_columns"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cols = engine.runner.stats["decode_columns"] - cols0
    busy, by_kernel, n_events = device_time(prof)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    while engine.has_work():
        engine.step()
    out = dict(columns=cols, wall_ms_per_column=wall_ms / cols,
               device_ms_per_column=busy / cols, busy_share=busy / wall_ms,
               device_events_per_column=n_events / cols,
               top=[(name[:80], ms / cols) for name, ms in top])
    print(f"  decode profile: {cols} columns, wall {out['wall_ms_per_column']:.2f} ms/column, "
          f"device busy {out['device_ms_per_column']:.2f} ms/column "
          f"(busy share {out['busy_share']:.3f}), "
          f"{out['device_events_per_column']:.0f} device events/column")
    for name, ms in out["top"]:
        print(f"    {ms:8.3f} ms/column  {name}")
    return out


def serve_pair(cfg, params, dev, max_new: int, with_profile: bool = False) -> dict:
    """Serve the requests twice on one set of weights: attention through the
    kernels, then through the plain versions.  Launch counters are zeroed
    just before each measured run and read just after it."""
    import gc

    import torch

    from smg_tpu_torch.engine.config import CacheConfig, EngineConfig, SchedulerConfig
    from smg_tpu_torch.engine.engine import Engine
    from smg_tpu_torch.ops.cuda import decode_attention as dk
    from smg_tpu_torch.ops.cuda import prefill_attention as pk
    from smg_tpu_torch.protocols.sampling import SamplingParams

    econf = EngineConfig(
        model=cfg,
        cache=CacheConfig(page_size=PS, num_pages=2048, auto_size=False, dtype=cfg.dtype),
        scheduler=SchedulerConfig(max_batch_size=8, max_seq_len=4096,
                                  max_prefill_tokens=512, decode_horizon=4),
    )
    runs = {}
    for attention in ("kernel", "plain"):
        engine = Engine(econf, params=params, device=dev, attention=attention)
        # warm-up request (cuBLAS handles, allocator); not counted
        engine.generate(prompt_ids=list(range(1000, 1100)),
                        sampling=SamplingParams(temperature=0.0, max_new_tokens=4))
        for k in engine.runner.stats:
            engine.runner.stats[k] = 0
        engine.scheduler.num_decode_tokens = 0
        logits: list = []
        dk.launches = 0
        pk.launches = 0
        results, step_ms, timers = drive_engine(engine, max_new, logits)
        launches = {"decode_attention": dk.launches, "prefill_attention": pk.launches}
        runs[attention] = dict(results=results, step_ms=step_ms, timers=timers,
                               logits=logits, stats=dict(engine.runner.stats),
                               launches=launches,
                               decode_tokens=engine.scheduler.num_decode_tokens)
        if with_profile:  # after the measured run: its counts are already read
            runs[attention]["profile"] = profile_decode(engine)
        del engine
        gc.collect()  # drive_engine's timers hold the runner in a cycle
        torch.cuda.empty_cache()  # give the KV buffers back before the next engine
    return runs


def check_pair(runs, L: int, max_new: int, label: str) -> tuple[float, float, int]:
    """Counts, finishes and the radix hit of the kernel run; returns
    (max |first-token logit difference| kernel vs plain, max |logit|,
    requests whose greedy streams agree)."""
    import torch

    kr, pr = runs["kernel"], runs["plain"]
    for rid, r in kr["results"].items():
        print(f"  [{label}] {rid}: prompt {r.prompt_tokens}, cached {r.cached_tokens}, "
              f"output {r.output_tokens}, finish {r.finish_reason}")
        if r.output_tokens != max_new or r.finish_reason != "length":
            raise AssertionError(f"{rid}: expected {max_new} tokens, finish 'length'")
    if kr["results"]["shared_b"].cached_tokens <= 0:
        raise AssertionError("shared_b got no radix prefix hit")
    st = kr["stats"]
    expect = {"decode_attention": L * st["decode_columns"],
              "prefill_attention": L * st["prefill_calls"]}
    print(f"  [{label}] schedule: {st}; launches {kr['launches']}, expected {expect}")
    if kr["launches"] != expect or min(kr["launches"].values()) <= 0:
        raise AssertionError(f"launch counts {kr['launches']} != schedule {expect}")
    if any(pr["launches"].values()):
        raise AssertionError(f"plain run launched kernels: {pr['launches']}")
    if len(kr["logits"]) != len(pr["logits"]):
        raise AssertionError("kernel and plain runs ran different prefill schedules")
    if not all(bool(torch.isfinite(a).all()) for a in kr["logits"]):
        raise AssertionError("non-finite first-token logits")
    diff = max(float((a - b).abs().max()) for a, b in zip(kr["logits"], pr["logits"]))
    scale = max(float(b.abs().max()) for b in pr["logits"])
    agree = sum(kr["results"][rid].token_ids == pr["results"][rid].token_ids
                for rid in kr["results"])
    print(f"  [{label}] first-token logits kernel vs plain: max_abs_diff={diff:.3e} "
          f"(max |logit| {scale:.3f}); greedy streams equal for "
          f"{agree}/{len(kr['results'])}")
    return diff, scale, agree


def _widen(params: dict) -> None:
    """Cast every weight to float32 in place, one tensor at a time."""
    for group in (params, params["layers"]):
        for k, v in group.items():
            if k != "layers":
                group[k] = v.float()


def phase_engine(dev, card: str) -> dict:
    import dataclasses

    import torch

    from smg_tpu_torch.models.config import llama3_8b_config
    from smg_tpu_torch.models.llama import init_params

    cfg = llama3_8b_config()
    L, max_new = cfg.num_layers, 32
    # the serving configuration: bf16 weights and KV
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    runs = serve_pair(cfg, params, dev, max_new, with_profile=True)
    diff, scale, _ = check_pair(runs, L, max_new, "bf16")
    out = {}
    for name, r in runs.items():
        s = r["stats"]
        out[name] = dict(
            prefill_tok_s=s["prefill_tokens"] / r["timers"]["prefill_s"],
            decode_tok_s=r["decode_tokens"] / r["timers"]["decode_s"],
            decode_ms_per_column=r["timers"]["decode_s"] * 1e3 / s["decode_columns"],
            steps=len(r["step_ms"]),
            step_ms_median=statistics.median(r["step_ms"]),
            step_ms_max=max(r["step_ms"]),
        )
        print(f"  [{card}] bf16 attention={name}: " + ", ".join(
            f"{k}={v:.2f}" if isinstance(v, float) else f"{k}={v}" for k, v in out[name].items()))
    out["decode_profile"] = {k: r["profile"] for k, r in runs.items()}
    out["launches"] = runs["kernel"]["launches"]
    out["schedule"] = runs["kernel"]["stats"]
    out["bf16_logit_max_abs_diff"] = diff
    out["bf16_logit_max_abs"] = scale
    # the same requests on the same weights widened to float32, with float32
    # KV: kernel and plain differ only in summation order, so the logits
    # agree tightly and the greedy streams match
    _widen(params)
    runs32 = serve_pair(dataclasses.replace(cfg, dtype="float32"), params, dev, max_new)
    del params
    diff32, _, agree32 = check_pair(runs32, L, max_new, "f32")
    if not diff32 <= F32_LOGIT_ATOL or agree32 != len(runs32["kernel"]["results"]):
        raise AssertionError(f"f32 kernel vs plain: logits differ by {diff32}, "
                             f"{agree32} greedy streams agree")
    out["f32_logit_max_abs_diff"] = diff32
    out["f32_streams_equal"] = agree32
    # the float32 plain run is the reference for both bf16 runs
    ref = runs32["plain"]["logits"]
    err = {name: max(float((a - b).abs().max()) for a, b in zip(runs[name]["logits"], ref))
           for name in ("kernel", "plain")}
    print(f"  [bf16] first-token logits against the f32 run: kernel max_abs_err="
          f"{err['kernel']:.3e}, plain max_abs_err={err['plain']:.3e}")
    if not err["kernel"] <= BF16_ERR_RATIO * err["plain"]:
        raise AssertionError(f"bf16 kernel logits {err['kernel']} from the f32 run, more "
                             f"than {BF16_ERR_RATIO} x the plain version's {err['plain']}")
    out["bf16_logit_err_vs_f32"] = err
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
            max_err=r["max_abs_err"], kernel_ms=r["ms"], timed_case=r["timed_case"],
        ))
    print(json.dumps({"engine": engine, "card": card}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
