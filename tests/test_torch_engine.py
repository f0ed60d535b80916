"""End to end: the port's ``Engine`` against the JAX package's ``Engine`` on
the tiny float32 model with bridged weights, and the port's sampler against
the distribution its K_CAP thresholds imply.

Greedy token streams, finish reasons and ``cached_tokens`` must be
identical; logprobs agree within 1e-4 (float32 logits, summation order)."""

import numpy as np
import pytest
import torch

import jax
from smg_tpu.engine import config as jconf
from smg_tpu.engine.engine import Engine as JaxEngine
from smg_tpu.models.config import tiny_test_config
from smg_tpu.models.registry import get_model
from smg_tpu.protocols.sampling import SamplingParams as JaxSamplingParams
from smg_tpu_torch.engine import config as tconf
from smg_tpu_torch.engine.engine import Engine, collect_result
from smg_tpu_torch.engine.sampling import K_CAP, sample_tokens
from smg_tpu_torch.models.convert import params_from_jax
from smg_tpu_torch.models.config import tiny_test_config as port_tiny
from smg_tpu_torch.protocols.sampling import SamplingParams

torch.set_num_threads(2)
PAGE, PAGES, MAX_SEQ, BUDGET, HORIZON = 16, 128, 256, 64, 4


@pytest.fixture(scope="module")
def engines():
    cfg = tiny_test_config()
    params = get_model(cfg.arch).init_params(cfg, jax.random.PRNGKey(0))
    je = JaxEngine(jconf.EngineConfig(
        model=cfg,
        cache=jconf.CacheConfig(page_size=PAGE, num_pages=PAGES, auto_size=False,
                                dtype="float32"),
        scheduler=jconf.SchedulerConfig(
            max_batch_size=8, max_seq_len=MAX_SEQ, max_prefill_tokens=BUDGET,
            prefill_token_buckets=(16, 32, 64), decode_batch_buckets=(4, 8),
            decode_horizon=HORIZON),
        dtype="float32"), params=params)
    te = Engine(tconf.EngineConfig(
        model=port_tiny(),
        cache=tconf.CacheConfig(page_size=PAGE, num_pages=PAGES, auto_size=False,
                                dtype="float32"),
        scheduler=tconf.SchedulerConfig(
            max_batch_size=8, max_seq_len=MAX_SEQ, max_prefill_tokens=BUDGET,
            decode_horizon=HORIZON)),
        params=params_from_jax(jax.tree.map(np.asarray, params)), device="cpu")
    return je, te


def serve(engine, sampling_cls, waves):
    """Submit each wave's requests together and step until they finish."""
    results = {}
    for wave in waves:
        chunks = {}
        for rid, prompt, kw in wave:
            chunks[rid] = []
            engine.submit(prompt, sampling_cls(temperature=0.0, **kw), rid=rid,
                          on_output=chunks[rid].append)
        for _ in range(400):
            if all(c and c[-1].finished for c in chunks.values()):
                break
            engine.step()
        for rid, c in chunks.items():
            r = collect_result(rid, c)
            results[rid] = (r.token_ids, r.finish_reason, r.cached_tokens, r.logprobs)
    return results


def test_greedy_streams_match_jax_engine(engines):
    je, te = engines
    rng = np.random.default_rng(0)
    shared = rng.integers(2, 500, 48).tolist()
    first = [
        ("long", rng.integers(2, 500, 150).tolist(), dict(max_new_tokens=12, ignore_eos=True)),
        ("shared", shared + [7, 8, 9], dict(max_new_tokens=10, ignore_eos=True)),
        ("short", rng.integers(2, 500, 20).tolist(), dict(max_new_tokens=9, ignore_eos=True)),
        ("eos", rng.integers(2, 500, 30).tolist(), dict(max_new_tokens=7)),
    ]
    want = serve(je, JaxSamplingParams, [first])
    got = serve(te, SamplingParams, [first])
    # a stop id from the middle of a stream: a finish inside a decode horizon
    stop_tok = want["shared"][0][5]
    second = [
        ("hit", shared + [11, 12], dict(max_new_tokens=9, ignore_eos=True)),
        ("stop", shared + [7, 8, 9], dict(max_new_tokens=16, ignore_eos=True,
                                         stop_token_ids=[stop_tok])),
    ]
    want.update(serve(je, JaxSamplingParams, [second]))
    got.update(serve(te, SamplingParams, [second]))
    assert want["long"][2] == 0 and want["hit"][2] > 0  # chunked cold, radix hit
    assert want["stop"][1] == "stop"
    for rid, (toks, reason, cached, lps) in want.items():
        g_toks, g_reason, g_cached, g_lps = got[rid]
        assert (g_toks, g_reason, g_cached) == (toks, reason, cached), rid
        np.testing.assert_allclose(g_lps, lps, rtol=1e-4, atol=1e-4)
    assert not te.has_work()
    assert te.scheduler.pool.free_count + te.scheduler.radix.num_cached_pages == PAGES - 1


@pytest.mark.parametrize("free_bytes", [None, 10 << 30, 1 << 20])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_plan_cache_and_page_pool_match_jax(free_bytes, dtype):
    """KV sizing from a free device-memory figure (``torch.cuda.mem_get_info``
    on the card) and the page allocator's order, against the JAX package."""
    from smg_tpu.engine.kv_cache import PagePool as JaxPagePool
    from smg_tpu.engine.kv_cache import plan_cache as jax_plan_cache
    from smg_tpu.models.config import llama3_8b_config
    from smg_tpu_torch.engine.kv_cache import PagePool, create_kv_buffers, plan_cache
    from smg_tpu_torch.models.config import llama3_8b_config as port_8b

    kw = dict(page_size=16, num_pages=300, auto_size=True, hbm_utilization=0.85, dtype=dtype)
    want = jax_plan_cache(llama3_8b_config(), jconf.CacheConfig(**kw), free_bytes)
    got = plan_cache(port_8b(), tconf.CacheConfig(**kw), free_bytes)
    assert (got.shape, got.bytes_per_page) == (want.shape, want.bytes_per_page)
    small = plan_cache(port_tiny(), tconf.CacheConfig(num_pages=4, auto_size=False,
                                                      dtype=dtype))
    k, v = create_kv_buffers(small, "cpu")
    assert k.shape == v.shape == small.shape and not k.any()
    jp, tp = JaxPagePool(9), PagePool(9)
    assert tp.alloc(3) == jp.alloc(3)
    jp.free([2])
    tp.free([2])
    assert tp.alloc(4) == jp.alloc(4) and tp.free_count == jp.free_count


def expected_probs(logits, temp, top_k, top_p, min_p):
    """The distribution the K_CAP threshold rules keep, in numpy."""
    z = logits.astype(np.float64) / temp
    order = np.sort(z)[::-1]
    kc = min(K_CAP, z.size)
    top = order[:kc]
    k_eff = kc if top_k <= 0 else min(top_k, kc)
    th_k = -np.inf if top_k <= 0 else top[k_eff - 1]
    cand = top[:k_eff] if top_k > 0 else top
    denom = np.log(np.exp(cand - cand.max()).sum()) + cand.max() if top_k > 0 else \
        np.log(np.exp(z - z.max()).sum()) + z.max()
    probs = np.exp(cand - denom)
    cum_excl = np.cumsum(probs) - probs
    keep = cum_excl < top_p
    spills = top_k <= 0 and probs.sum() < top_p
    th_p = -np.inf if (spills or top_p >= 1.0) else cand[keep].min()
    th_m = top[0] + np.log(min_p) if min_p > 0 else -np.inf
    kept = z >= max(th_k, th_p, th_m)
    p = np.where(kept, np.exp(z - z.max()), 0.0)
    return p / p.sum()


@pytest.mark.parametrize("temp,top_k,top_p,min_p,V", [
    (0.7, 20, 0.9, 0.0, 100),   # top-k then nucleus
    (1.3, -1, 0.8, 0.0, 100),   # nucleus inside K_CAP candidates
    (1.0, -1, 1.0, 0.05, 100),  # min-p only
    (2.0, -1, 0.99, 0.0, 200),  # nucleus spills past K_CAP: keep everything
])
def test_sampling_matches_threshold_distribution(temp, top_k, top_p, min_p, V):
    rng = np.random.default_rng(5)
    row = (rng.standard_normal(V) * 2).astype(np.float32)
    n = 20000
    logits = torch.from_numpy(np.tile(row, (n, 1)))
    full = lambda x, dt=torch.float32: torch.full((n,), x, dtype=dt)  # noqa: E731
    toks, lps = sample_tokens(logits, 0, 1, full(temp), full(top_k, torch.int64),
                              full(top_p), full(min_p))
    freq = np.bincount(toks.numpy(), minlength=V) / n
    p = expected_probs(row, temp, top_k, top_p, min_p)
    # 5 standard errors of a binomial frequency (plus a floor for p ~ 0)
    bound = 5 * np.sqrt(p * (1 - p) / n) + 1e-3
    assert np.all(np.abs(freq - p) <= bound), np.max(np.abs(freq - p) - bound)
    assert np.all(freq[p == 0] == 0)  # filtered tokens are never drawn
    # logprobs under the unfiltered distribution (OpenAI semantics)
    ref = torch.log_softmax(logits[0], -1)[toks]
    torch.testing.assert_close(lps, ref, rtol=1e-5, atol=1e-5)


def test_greedy_and_top_k_1_take_the_argmax():
    rng = np.random.default_rng(6)
    logits = torch.from_numpy(rng.standard_normal((8, 300)).astype(np.float32))
    ones = torch.ones(8)
    for temp, k in ((0.0, -1), (0.9, 1)):
        toks, _ = sample_tokens(logits, 1, 1, ones * temp, torch.full((8,), k), ones,
                                torch.zeros(8))
        torch.testing.assert_close(toks, logits.argmax(-1))
