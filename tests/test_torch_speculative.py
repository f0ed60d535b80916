"""Speculative decoding on the port, held against the JAX package on the
CPU: the n-gram drafter and its index, the verify-block and compat-decode
attention, ``forward_verify_block`` and ``forward_decode``, the exact
filtered distribution and the distribution-preserving acceptance, and the
speculative ``Engine`` against the JAX one at temperature 0 for the n-gram
tier and for a draft model (matching and mismatched ``draft_seed``):
identical tokens, finishes, drafted and accepted counts and tier-labelled
metrics, with the overlap schedule on and off.  Then mid-stream rejection,
stop ids and EOS inside a block, a stop-string lane kept at K=1,
chunked-prefill admissions, preemption with a draft model, a raising step's
survivors, and the ``serve`` flags.

The tiny float32 model, weights bridged from the JAX ``init_params``;
engines are shared per module.  The port's sampler noise is not
``jax.random``'s, so sampled streams are compared between the port's own
schedules (overlap on and off), and the acceptance by its distribution."""

import dataclasses
import functools
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from smg_tpu import cli as jcli
from smg_tpu.engine import config as jconf
from smg_tpu.engine import sampling as jsampling
from smg_tpu.engine import speculative as jspec
from smg_tpu.engine.engine import Engine as JaxEngine
from smg_tpu.faults import FAULTS as JFAULTS
from smg_tpu.models import llama as jllama
from smg_tpu.models.config import tiny_gemma2_config, tiny_test_config
from smg_tpu.models.registry import get_model
from smg_tpu.ops import attention as jattn
from smg_tpu.ops.rope import rope_frequencies
from smg_tpu.protocols.sampling import SamplingParams as JaxSamplingParams
from smg_tpu.tokenizer import MockTokenizer as JaxMockTokenizer
from smg_tpu_torch import cli as tcli
from smg_tpu_torch.engine import config as tconf
from smg_tpu_torch.engine import sampling as tsampling
from smg_tpu_torch.engine import speculative as tspec
from smg_tpu_torch.engine.engine import Engine
from smg_tpu_torch.faults import FAULTS
from smg_tpu_torch.gateway.launch import build_engine_from_args
from smg_tpu_torch.models import config as tmodels
from smg_tpu_torch.models.convert import params_from_jax
from smg_tpu_torch.models.llama import LlamaModel
from smg_tpu_torch.ops import attention as tattn
from smg_tpu_torch.protocols.sampling import SamplingParams
from smg_tpu_torch.tokenizer import MockTokenizer

torch.set_num_threads(2)
PS = 16
REP = [5, 6, 7, 8] * 8


@functools.lru_cache(maxsize=None)
def jax_params(seed: int = 0, gemma: bool = False):
    """The JAX engine's own weight init (``ModelRunner`` and ``DraftRunner``
    jit ``init_params``), as numpy."""
    cfg = tiny_gemma2_config() if gemma else tiny_test_config()
    p = jax.jit(functools.partial(get_model(cfg.arch).init_params, cfg))(
        jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, p)


def port_params(seed: int = 0, gemma: bool = False):
    return params_from_jax(jax_params(seed, gemma))


@pytest.fixture(autouse=True)
def _disarm_faults():
    yield
    FAULTS.clear()
    JFAULTS.clear()


# ---- the drafter ----


@pytest.mark.parametrize("seed", range(4))
def test_propose_ngram_and_index_match_reference(seed):
    rng = random.Random(seed)
    for _trial in range(40):
        kw = dict(max_draft=rng.randint(1, 6), ngram_max=rng.randint(1, 4), ngram_min=1,
                  scan_window=rng.choice([8, 1024]))
        jc, tc = jspec.SpecConfig(**kw), tspec.SpecConfig(**kw)
        ids = [rng.randrange(5) for _ in range(rng.randrange(2, 50))]
        jidx, tidx = jspec.NgramIndex(1, kw["ngram_max"]), tspec.NgramIndex(1, kw["ngram_max"])
        stream: list = []
        for n in range(2, len(ids) + 1, 3):
            stream = ids[:n]
            want = jspec.propose_ngram(stream, jc)
            assert tspec.propose_ngram(stream, tc) == want
            assert tspec.propose_ngram(stream, tc, index=tidx) == \
                jspec.propose_ngram(stream, jc, index=jidx)
        # a stop-string rollback rewrites the tail: both indexes rebuild
        cut = stream[: max(1, len(stream) - 3)] + [rng.randrange(5) for _ in range(2)]
        assert tspec.propose_ngram(cut, tc, index=tidx) == \
            jspec.propose_ngram(cut, jc, index=jidx) == jspec.propose_ngram(cut, jc)
        props = [rng.randrange(4) for _ in range(rng.randint(0, 5))]
        argmaxes = [rng.randrange(4) for _ in range(len(props) + 1)]
        assert tspec.accept_greedy(props, argmaxes) == jspec.accept_greedy(props, argmaxes)


# ---- attention ops ----


def _caches(rng, L, P, KD):
    return (rng.standard_normal((L, P, PS, KD)).astype(np.float32),
            rng.standard_normal((L, P, PS, KD)).astype(np.float32))


@pytest.mark.parametrize("softcap,window", [(None, None), (30.0, None), (None, 20),
                                            (50.0, 0)])
def test_attention_verify_block_matches_reference(softcap, window):
    rng = np.random.default_rng(3)
    B, W, H, K, D, P, mp, L = 4, 5, 8, 2, 16, 40, 6, 2
    kc, vc = _caches(rng, L, P, K * D)
    q = rng.standard_normal((B, W, H, D)).astype(np.float32)
    bk = rng.standard_normal((B, W, K * D)).astype(np.float32)
    bv = rng.standard_normal((B, W, K * D)).astype(np.float32)
    pt = rng.permutation(np.arange(1, P))[: B * mp].reshape(B, mp).astype(np.int32)
    pt[3] = 0  # a padded lane: all-garbage table, entry past the table
    entry = np.array([1, 37, mp * PS - W, mp * PS], np.int32)  # ragged
    for layer in range(L):
        want = jattn.attention_verify_block(
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(bk),
            jnp.asarray(bv), layer, jnp.asarray(pt), jnp.asarray(entry), 0.25,
            softcap=softcap, window=None if window is None else jnp.int32(window))
        got = tattn.attention_verify_block(
            *(torch.from_numpy(x) for x in (q, kc, vc, bk, bv)), layer,
            torch.from_numpy(pt), torch.from_numpy(entry), 0.25, softcap=softcap,
            window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("softcap,window", [(None, None), (30.0, 24)])
def test_attention_decode_matches_reference(softcap, window):
    rng = np.random.default_rng(4)
    B, H, K, D, P, mp = 3, 8, 2, 16, 30, 5
    kc, vc = _caches(rng, 1, P, K * D)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    pt = rng.permutation(np.arange(1, P))[: B * mp].reshape(B, mp).astype(np.int32)
    positions = np.array([0, 33, mp * PS - 1], np.int32)
    want = jattn.attention_decode(
        jnp.asarray(q), jnp.asarray(kc[0]), jnp.asarray(vc[0]), jnp.asarray(pt),
        jnp.asarray(positions), 0.25, softcap=softcap,
        window=None if window is None else jnp.int32(window))
    got = tattn.attention_decode(torch.from_numpy(q), torch.from_numpy(kc[0]),
                                 torch.from_numpy(vc[0]), torch.from_numpy(pt),
                                 torch.from_numpy(positions), 0.25, softcap=softcap,
                                 window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


# ---- model forwards ----


def _model_case(gemma: bool, seed: int):
    jcfg = tiny_gemma2_config() if gemma else tiny_test_config()
    tcfg = tmodels.tiny_gemma2_config() if gemma else tmodels.tiny_test_config()
    rng = np.random.default_rng(seed)
    KD = jcfg.num_kv_heads * jcfg.head_dim
    kc, vc = _caches(rng, jcfg.num_layers, 48, KD)
    kc *= 0.5
    vc *= 0.5
    inv = jnp.asarray(rope_frequencies(jcfg.head_dim, jcfg.rope_theta, None))
    model = LlamaModel(tcfg, port_params(0, gemma), attention="plain")
    return jcfg, model, rng, kc, vc, inv


@pytest.mark.parametrize("gemma", [False, True], ids=["llama", "gemma2"])
def test_forward_verify_block_matches_reference(gemma):
    jcfg, model, rng, kc, vc, inv = _model_case(gemma, 5)
    B, W, mp = 3, 5, 6
    tokens = rng.integers(2, 500, (B, W)).astype(np.int32)
    pt = rng.permutation(np.arange(1, 48))[: B * mp].reshape(B, mp).astype(np.int32)
    entry = np.array([3, 50, mp * PS - W], np.int32)
    logits, bk, bv = jllama.forward_verify_block(
        jax_params(0, gemma), jcfg, inv, jnp.asarray(tokens), jnp.asarray(entry),
        jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(pt))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got = model.forward_verify_block(torch.from_numpy(tokens).long(),
                                     torch.from_numpy(entry), tk, tv, torch.from_numpy(pt))
    for g, w in zip(got, (logits, bk, bv)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)
    # the cache is read only
    assert np.array_equal(tk.numpy(), kc) and np.array_equal(tv.numpy(), vc)


@pytest.mark.parametrize("gemma", [False, True], ids=["llama", "gemma2"])
def test_forward_decode_matches_reference(gemma):
    jcfg, model, rng, kc, vc, inv = _model_case(gemma, 6)
    B, mp = 3, 4
    tokens = rng.integers(2, 500, B).astype(np.int32)
    pt = rng.permutation(np.arange(1, 48))[: B * mp].reshape(B, mp).astype(np.int32)
    positions = np.array([0, 21, mp * PS], np.int32)  # the last past the table
    logits, jk, jv = jllama.forward_decode(
        jax_params(0, gemma), jcfg, inv, jnp.asarray(tokens), jnp.asarray(positions),
        jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(pt))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got = model.forward_decode(torch.from_numpy(tokens).long(), torch.from_numpy(positions),
                               tk, tv, torch.from_numpy(pt))
    np.testing.assert_allclose(got.numpy(), np.asarray(logits), rtol=1e-4, atol=1e-4)
    # the written slots (the garbage page aside) hold the reference's KV
    for mine, ref in ((tk, jk), (tv, jv)):
        np.testing.assert_allclose(mine.numpy()[:, 1:], np.asarray(ref)[:, 1:],
                                   rtol=1e-4, atol=1e-4)


# ---- the filtered distribution and the acceptance ----


FILTERS = [(0.9, -1, 1.0, 0.0), (0.7, 5, 1.0, 0.0), (1.3, -1, 0.8, 0.0),
           (1.0, -1, 1.0, 0.2), (0.6, 12, 0.9, 0.05)]


@pytest.mark.parametrize("temp,top_k,top_p,min_p", FILTERS)
def test_filtered_probs_matches_reference(temp, top_k, top_p, min_p):
    rng = np.random.default_rng(8)
    logits = (rng.standard_normal((4, 64)) * 2.0).astype(np.float32)
    want = jsampling._filtered_probs(jnp.asarray(logits), jnp.float32(temp),
                                     jnp.int32(top_k), jnp.float32(top_p), jnp.float32(min_p))
    got = tsampling._filtered_probs(torch.from_numpy(logits), torch.tensor(temp),
                                    torch.tensor(top_k), torch.tensor(top_p),
                                    torch.tensor(min_p))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    # batched over requests: each row block with its own parameters
    batched = tsampling._filtered_probs(
        torch.from_numpy(np.stack([logits, logits[::-1].copy()])),
        torch.tensor([temp, 1.0]), torch.tensor([top_k, -1]), torch.tensor([top_p, 1.0]),
        torch.tensor([min_p, 0.0]))
    np.testing.assert_allclose(batched[0].numpy(), np.asarray(want), atol=1e-6)


def chi2_ok(observed, probs, n) -> bool:
    """Pearson's chi-square over the support of ``probs``, below its
    critical value at p = 0.001."""
    from scipy.stats import chi2

    support = probs > 0
    expected = n * probs[support]
    stat = float(((observed[support] - expected) ** 2 / expected).sum())
    return stat < chi2.ppf(0.999, int(support.sum()) - 1)


def _spec_samples(logits, proposals, k_real, n, temp, top_k, top_p, min_p, counter=1):
    """``n`` independent acceptances of the same verify row (one lane each:
    the noise is keyed by the lane's row)."""
    T, V = logits.shape
    full = lambda x, dt: torch.full((n,), x, dtype=dt)  # noqa: E731
    return tsampling.spec_accept_sample(
        torch.from_numpy(logits)[None].expand(n, T, V),
        torch.tensor(proposals)[None].expand(n, len(proposals)), full(k_real, torch.int64),
        1234, counter, full(temp, torch.float32), full(top_k, torch.int64),
        full(top_p, torch.float32), full(min_p, torch.float32))


@pytest.mark.parametrize("temp,top_k,top_p,min_p", FILTERS[:3])
def test_spec_accept_sample_preserves_distribution(temp, top_k, top_p, min_p):
    """Monte-Carlo chi-square check: with a deterministic draft, the first
    emitted token is distributed as the target's filtered distribution (the
    JAX ``_filtered_probs``), and so is the bonus after a full acceptance."""
    V, K, N = 8, 3, 20000
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((K + 1, V)) * 2.0).astype(np.float32)
    proposals = [2, 5, 1]
    target = np.asarray(jsampling._filtered_probs(
        jnp.asarray(logits), jnp.float32(temp), jnp.int32(top_k), jnp.float32(top_p),
        jnp.float32(min_p)))
    final, n_acc = (x.numpy() for x in _spec_samples(logits, proposals, K, N, temp, top_k,
                                                      top_p, min_p))
    first = np.where(n_acc >= 1, proposals[0], final)
    observed = np.bincount(first, minlength=V)
    assert observed[target[0] == 0].sum() == 0
    assert chi2_ok(observed, target[0], N), (observed, N * target[0])
    # lanes that accepted every draft drew the bonus from the last row
    bonus = final[n_acc == K]
    if len(bonus) > 200:
        assert chi2_ok(np.bincount(bonus, minlength=V), target[K], len(bonus))
    # the acceptance rate of the first draft is its target probability
    assert abs((n_acc >= 1).mean() - target[0][proposals[0]]) < 0.015


def test_spec_accept_sample_respects_top_k_and_the_counter():
    V, K = 16, 2
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((K + 1, V)).astype(np.float32)
    allowed = set(np.argsort(-logits, axis=1)[:, :2].ravel().tolist())
    final, _ = _spec_samples(logits, [0, 1], K, 512, 1.0, 2, 1.0, 0.0)
    assert set(final.tolist()) <= allowed
    # a pure function of (seed, counter, row): a rewound counter repeats
    again, _ = _spec_samples(logits, [0, 1], K, 512, 1.0, 2, 1.0, 0.0)
    other, _ = _spec_samples(logits, [0, 1], K, 512, 1.0, 2, 1.0, 0.0, counter=2)
    assert torch.equal(final, again) and not torch.equal(final, other)


# ---- engines: the port against the JAX package ----


SCHED = dict(max_batch_size=4, max_seq_len=256, max_prefill_tokens=64,
             decode_batch_buckets=(4,), decode_horizon=4)


def jax_engine(draft_seed=None, num_pages=128, eos=None, tokenizer=False, **kw):
    model = tiny_test_config()
    if eos is not None:
        model = dataclasses.replace(model, eos_token_ids=(eos,))
    cfg = jconf.EngineConfig(
        model=model, draft_model=None if draft_seed is None else tiny_test_config(),
        draft_seed=draft_seed or 0,
        cache=jconf.CacheConfig(page_size=PS, num_pages=num_pages, auto_size=False,
                                dtype="float32"),
        scheduler=jconf.SchedulerConfig(**{**SCHED, "prefill_token_buckets": (16, 32, 64),
                                           **kw}),
        dtype="float32", seed=0)
    return JaxEngine(cfg, params=jax.tree.map(jnp.asarray, jax_params(0)),
                     tokenizer=JaxMockTokenizer() if tokenizer else None)


def port_engine(draft_seed=None, num_pages=128, eos=None, tokenizer=False, **kw):
    model = tmodels.tiny_test_config()
    if eos is not None:
        model = dataclasses.replace(model, eos_token_ids=(eos,))
    cfg = tconf.EngineConfig(
        model=model, draft_model=None if draft_seed is None else tmodels.tiny_test_config(),
        draft_seed=draft_seed or 0,
        cache=tconf.CacheConfig(page_size=PS, num_pages=num_pages, auto_size=False,
                                dtype="float32"),
        scheduler=tconf.SchedulerConfig(**{**SCHED, **kw}), seed=0)
    return Engine(cfg, params=port_params(0), device="cpu",
                  draft_params=None if draft_seed is None else port_params(draft_seed),
                  tokenizer=MockTokenizer() if tokenizer else None)


def greedy(n, cls=SamplingParams, **kw):
    return cls(temperature=0.0, max_new_tokens=n, ignore_eos=kw.pop("ignore_eos", True), **kw)


def run(engine, jobs, max_steps=3000) -> dict:
    """Submit every job, step inline until all finished and the pipeline
    drained; rid -> (tokens, finish, logprobs).  Jobs are (rid, prompt,
    SamplingParams kwargs) so one list serves both packages."""
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
                  [x for o in c for x in o.logprobs]) for rid, c in chunks.items()}


def counts(engine) -> tuple:
    s = engine.scheduler
    reg = engine.metrics.registry
    tiers = tuple((reg.get_sample_value(f"smg_engine_spec_{k}_tokens_total", {"tier": t})
                   or 0.0) for t in ("ngram", "draft") for k in ("drafted", "accepted"))
    return s.num_spec_drafted, s.num_spec_accepted, tiers


def set_overlap(engine, on: bool) -> None:
    s = engine.scheduler
    s.sched = dataclasses.replace(s.sched, overlap_schedule=on)


def assert_clean(engine):
    audit = engine.audit()
    assert audit["quiescent"] and audit["clean"] and audit["leaked_pages"] == 0, audit


def g(n, **kw):
    return dict(temperature=0.0, max_new_tokens=n, ignore_eos=True, **kw)


JOBS = [
    ("rep", REP, g(24)),
    ("nines", [9] * 8, g(20)),
    ("novel", list(range(40, 70)), g(12)),
    # the repetition breaks: the drafter keeps proposing the old
    # continuation and the verify rejects mid-block
    ("break", [5, 6, 7, 8] * 4 + [5, 6, 7, 9, 5, 6, 7], g(18)),
    ("mixed", list(range(40, 64)) + [5, 6, 5, 6, 5, 7], g(14)),
]


@functools.lru_cache(maxsize=None)
def reference_run(draft_seed, spec_max_draft):
    """The JAX spec engine's streams and counts over ``JOBS`` (overlap on),
    and the port's non-speculative streams."""
    je = jax_engine(draft_seed, speculative=True, spec_max_draft=spec_max_draft)
    want = run(je, JOBS)
    base = run(port_engine(), JOBS)
    return want, counts(je), base


@pytest.fixture(scope="module")
def port_spec_engines():
    return {}


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "sync"])
@pytest.mark.parametrize("draft_seed,depth", [(None, 6), (0, 4), (1234, 4)],
                         ids=["ngram", "self_draft", "other_draft"])
def test_spec_engine_matches_jax_engine(port_spec_engines, draft_seed, depth, overlap):
    want, want_counts, base = reference_run(draft_seed, depth)
    key = (draft_seed, depth)
    if key not in port_spec_engines:
        port_spec_engines[key] = port_engine(draft_seed, speculative=True,
                                             spec_max_draft=depth)
    te = port_spec_engines[key]
    before = counts(te)
    te.flush_cache()
    set_overlap(te, overlap)
    got = run(te, JOBS)
    after = counts(te)
    for rid, (toks, fin, lps) in want.items():
        assert (got[rid][0], got[rid][1]) == (toks, fin), rid
        assert got[rid][0] == base[rid][0], rid  # speculation changes no greedy token
        np.testing.assert_allclose(got[rid][2], lps, rtol=1e-4, atol=1e-4)
    delta = (after[0] - before[0], after[1] - before[1],
             tuple(a - b for a, b in zip(after[2], before[2])))
    assert delta == want_counts, (delta, want_counts)
    assert delta[0] > 0
    if draft_seed == 0:  # drafts are the target's own greedy picks
        assert delta[1] == delta[0]
    elif draft_seed is None:  # drafts hit and miss
        assert 0 < delta[1] < delta[0]
    else:  # another model's drafts: rejected at their first column
        assert delta[1] < delta[0]
    assert_clean(te)


@pytest.mark.parametrize("kind", ["stop_id", "eos", "length"])
def test_finish_inside_an_accepted_block_matches_jax(kind):
    """A finish on a token that lands inside an accepted run cuts the lane
    there, as the JAX engine and the non-speculative stream do.  The draft
    model is the target itself, so every block is accepted whole and new
    tokens land mid-block (an n-gram draft only repeats earlier tokens)."""
    # horizon 1 everywhere: a multi-token increment is a verify block's
    kw = dict(speculative=True, spec_max_draft=4, decode_horizon=1)
    probe = port_engine(0, **kw)
    steps: list = []
    probe.submit(REP, SamplingParams(**g(24)), rid="p",
                 on_output=lambda o: steps.append(o.new_token_ids))
    while probe.scheduler.has_work():
        probe.step()
    stream = [t for s in steps for t in s]
    # a token emitted mid-way through a block, first seen there
    starts = np.cumsum([0] + [len(s) for s in steps])
    at = next(int(starts[i]) + 1 for i, s in enumerate(steps)
              if len(s) >= 3 and s[1] not in stream[: starts[i] + 1])
    tok = stream[at]
    sp_kw, model_kw = {"stop_id": (dict(stop_token_ids=[tok]), {}),
                       "eos": (dict(ignore_eos=False), dict(eos=tok)),
                       "length": ({}, {})}[kind]
    job = [("x", REP, {**g(at + 1 if kind == "length" else 24), **sp_kw})]
    je = jax_engine(0, **kw, **model_kw)
    want = run(je, job)["x"]
    te = port_engine(0, **kw, **model_kw)
    got = run(te, job)["x"]
    base = run(port_engine(decode_horizon=1, **model_kw), job)["x"]
    assert got[:2] == want[:2] == base[:2]
    assert got[0] == stream[: at + 1]
    assert got[1] == ("length" if kind == "length" else "stop")
    assert counts(te) == counts(je)
    assert_clean(te)


def test_stop_string_lane_keeps_the_k1_path():
    probe = run(port_engine(), [("p", REP, g(10))])["p"][0]
    jobs = [("st", REP, g(16, stop=[f"w{probe[4]}"])), ("rep", [9] * 10, g(12))]
    te = port_engine(tokenizer=True, speculative=True, spec_max_draft=6)
    verified: list = []
    launch = te.scheduler._launch_spec_frame
    te.scheduler._launch_spec_frame = lambda drafting, *a: (
        verified.extend(r.rid for _s, r in drafting), launch(drafting, *a))[1]
    got = run(te, jobs)
    want = run(jax_engine(tokenizer=True, speculative=True, spec_max_draft=6), jobs)
    base = run(port_engine(tokenizer=True), jobs)
    for rid in want:
        assert got[rid][:2] == want[rid][:2] == base[rid][:2], rid
    assert got["st"][1] == "stop"
    assert "st" not in verified and "rep" in verified
    assert_clean(te)


def test_chunked_prefill_admissions_match_jax_and_overlap_off():
    """A 180-token prompt admits in chunks while verify frames fly."""
    kw = dict(speculative=True, spec_max_draft=4, decode_horizon=1)
    greedy_jobs = [("long", list(range(5, 185)), g(8)), ("rep", REP, g(20)),
                   ("c1", [11, 12, 13] * 8, g(10))]
    je = jax_engine(**kw)
    want = run(je, greedy_jobs)
    te = port_engine(**kw)
    got = run(te, greedy_jobs)
    assert {r: v[:2] for r, v in got.items()} == {r: v[:2] for r, v in want.items()}
    assert counts(te) == counts(je) and te.scheduler.num_spec_accepted > 0
    sampled = [("long", list(range(5, 185)), dict(temperature=0.8, top_k=40,
                                                   max_new_tokens=8, ignore_eos=True)),
               ("rep", REP, g(14)),
               ("c1", [11, 12, 13] * 8, dict(temperature=0.8, max_new_tokens=10,
                                             ignore_eos=True))]
    on = run(port_engine(**kw), sampled)
    off_eng = port_engine(**kw, overlap_schedule=False)
    assert on == run(off_eng, sampled)  # tokens, finishes and logprobs, bit for bit
    assert_clean(off_eng)


def test_sampled_streams_byte_identical_with_overlap_on_and_off():
    jobs = [("s0", REP, dict(temperature=0.8, top_k=40, max_new_tokens=12, ignore_eos=True)),
            ("s1", [11, 12, 13] * 9, dict(temperature=0.8, min_p=0.02, max_new_tokens=9,
                                          ignore_eos=True)),
            ("s2", [5, 6] * 12, dict(temperature=1.0, top_p=0.9, max_new_tokens=16,
                                     ignore_eos=True)),
            ("g0", [9] * 10, g(10))]
    on_eng = port_engine(speculative=True, spec_max_draft=6)
    off_eng = port_engine(speculative=True, spec_max_draft=6, overlap_schedule=False)
    on, off = run(on_eng, jobs), run(off_eng, jobs)
    assert on == off
    assert on_eng.scheduler.num_spec_drafted > 0
    assert on_eng.loads()["spec_drafted"] == off_eng.loads()["spec_drafted"]
    ring = on_eng.dump_flight()["ring"]
    assert sum(r["spec_drafted"] for r in ring) == on_eng.scheduler.num_spec_drafted
    for e in (on_eng, off_eng):
        assert_clean(e)


def test_preemption_with_a_draft_model_matches_jax():
    """A pool too small for three requests: preemption resets the draft
    coverage with the pages; the readmitted request re-prefills its draft
    context and finishes with the JAX engine's stream."""
    kw = dict(num_pages=12, max_seq_len=128, watermark_pages=1, speculative=True,
              spec_max_draft=4)
    jobs = [(f"p{i}", list(range(10 + 3 * i, 40 + 3 * i)), g(40)) for i in range(3)]
    je, te = jax_engine(0, **kw), port_engine(0, **kw)
    want, got = run(je, jobs), run(te, jobs)
    assert {r: v[:2] for r, v in got.items()} == {r: v[:2] for r, v in want.items()}
    assert all(len(v[0]) == 40 for v in got.values())
    assert te.scheduler.num_preemptions == je.scheduler.num_preemptions > 0
    assert counts(te)[:2] == counts(je)[:2]
    assert te.scheduler.draft.stats["prefill_calls"] > 0
    assert_clean(te)


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "sync"])
def test_raising_step_survivors_match_jax(overlap):
    """A poisoned decode step with a verify frame in flight, the fault armed
    in both engines: the newest lane is quarantined, the frame's counter
    rewinds, and the survivors' streams equal the JAX engine's."""
    jobs = [(f"q{i}", [5 + i, 6 + i, 7 + i, 8 + i] * 6, g(8)) for i in range(3)]

    def drive(engine, faults, cls):
        chunks = {rid: [] for rid, _, _ in jobs}
        for rid, prompt, kw in jobs:
            engine.submit(prompt, cls(**kw), rid=rid, on_output=chunks[rid].append)
        engine.step()  # admit and prefill all three
        faults.arm("engine.decode_step", mode="once")
        for _ in range(300):
            if not engine.scheduler.has_work():
                break
            engine.step()
        faults.clear()
        assert engine.scheduler.num_quarantined == 1 and engine.scheduler.inflight is None
        return {rid: ([t for o in v for t in o.new_token_ids], v[-1].finish_reason)
                for rid, v in chunks.items()}

    kw = dict(speculative=True, spec_max_draft=4, overlap_schedule=overlap)
    want = drive(jax_engine(**kw), JFAULTS, JaxSamplingParams)
    te = port_engine(**kw)
    got = drive(te, FAULTS, SamplingParams)
    assert got == want and got["q2"][1] == "error"
    assert_clean(te)


def test_sampled_survivors_identical_with_overlap_on_and_off():
    jobs = [(f"q{i}", [5 + i, 6 + i, 7 + i, 8 + i] * 6,
             dict(temperature=0.8, top_k=50, max_new_tokens=8, ignore_eos=True))
            for i in range(3)]

    def drive(overlap):
        te = port_engine(speculative=True, spec_max_draft=4, overlap_schedule=overlap)
        chunks = {rid: [] for rid, _, _ in jobs}
        for rid, prompt, kw in jobs:
            te.submit(prompt, SamplingParams(**kw), rid=rid, on_output=chunks[rid].append)
        te.step()
        FAULTS.arm("engine.decode_step", mode="once")
        while te.scheduler.has_work():
            te.step()
        FAULTS.clear()
        assert_clean(te)
        return {rid: ([t for o in v for t in o.new_token_ids], v[-1].finish_reason)
                for rid, v in chunks.items()}

    piped, sync = drive(True), drive(False)
    assert piped == sync and piped["q2"][1] == "error"


def test_auto_sized_pages_leave_room_for_the_draft_cache():
    from smg_tpu_torch.engine.kv_cache import KvCacheSpec, plan_cache

    target, draft = tmodels.llama3_8b_config(), tmodels.llama32_1b_config()
    cache = tconf.CacheConfig(page_size=PS, dtype="bfloat16")  # auto-sized
    free = 40 << 30
    alone = plan_cache(target, cache, free)
    both = plan_cache(target, cache, free, draft=draft)
    per_draft_page = KvCacheSpec(draft.num_layers, 1, PS, draft.num_kv_heads,
                                 draft.head_dim, "bfloat16").bytes_per_page
    assert both.num_pages * (both.bytes_per_page + per_draft_page) <= \
        free * cache.hbm_utilization
    assert both.num_pages < alone.num_pages


# ---- the serve flags ----


SPEC_FLAGS = ["--speculative", "--speculative-tier", "--spec-max-draft-tokens",
              "--spec-max-draft", "--draft-model-path", "--draft-model-preset"]


def _actions(parser) -> dict:
    sub = next(a for a in parser._actions if a.dest == "command")
    return {s: a for a in sub.choices["serve"]._actions for s in a.option_strings}


def test_serve_speculation_flags_keep_the_reference_names_and_defaults():
    ref, port = _actions(jcli.build_parser()), _actions(tcli.build_parser())
    for flag in SPEC_FLAGS:
        r, p = ref[flag], port[flag]
        assert (p.dest, p.default, p.choices, p.type, p.nargs, p.const) == \
            (r.dest, r.default, r.choices, r.type, r.nargs, r.const), flag


def _serve(*flags):
    return tcli.build_parser().parse_args(["serve", "--model-preset", "tiny", "--device",
                                           "cpu", "--dtype", "float32", "--max-seq-len",
                                           "256", "--max-batch-size", "4", *flags])


def test_serve_speculation_flags_reach_the_engine():
    eng = build_engine_from_args(_serve("--speculative", "--speculative-tier", "ngram",
                                        "--spec-max-draft-tokens", "5"))
    sc = eng.config.scheduler
    assert (sc.speculative, sc.speculative_tier, sc.spec_max_draft) == (True, "ngram", 5)
    assert eng.scheduler.draft is None and eng.scheduler._spec_tier() == "ngram"
    eng = build_engine_from_args(_serve("--speculative", "--draft-model-preset", "tiny",
                                        "--spec-max-draft", "3"))
    assert eng.config.draft_model == tmodels.tiny_test_config()
    assert eng.scheduler.draft is not None and eng.scheduler._spec_tier() == "draft"
    assert eng.config.scheduler.spec_max_draft == 3
    r = eng.generate(REP, SamplingParams(**g(6)))
    assert len(r.token_ids) == 6 and eng.scheduler.num_spec_drafted > 0
    default = build_engine_from_args(_serve())
    assert not default.config.scheduler.speculative and default.config.draft_model is None


def test_draft_model_path_and_a_draft_tier_without_a_draft_model_are_refused():
    # the draft's checkpoint is loaded now: a directory without one is refused
    with pytest.raises(FileNotFoundError, match="config.json"):
        build_engine_from_args(_serve("--speculative", "--draft-model-path", "/models/d"))
    with pytest.raises(SystemExit, match="draft-model-preset"):
        build_engine_from_args(_serve("--speculative", "--speculative-tier", "draft"))
    with pytest.raises(ValueError):
        tconf.SchedulerConfig(speculative_tier="bogus")
    with pytest.raises(ValueError):
        tconf.SchedulerConfig(spec_max_draft=0)
    with pytest.raises(ValueError, match="draft model"):
        port_engine(speculative=True, speculative_tier="draft")
