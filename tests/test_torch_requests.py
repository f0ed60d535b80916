"""Request semantics of the port against the JAX package, on the CPU: the
penalties, the grammar vocab mask and the exact sampler
(``engine/sampling.py``), the constrained-decoding machines
(``constrained/``), detokenisation and stop strings
(``engine/detokenize.py``), and the engine streams that use them, on the
tiny float32 model with weights bridged from the JAX ``init_params``.

Tolerances: penalised logits 1e-6; logprobs 1e-5 for the samplers and 1e-4
through the engines (float32 logits summed in another order); greedy
tokens, masks, text, finishes and ``matched_stop`` exact.  The JAX runner's
megastep never computes a column past the first finish, the port's runs
every column: the penalty counts each leaves behind must agree."""

import functools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from smg_tpu import constrained as jcon
from smg_tpu.constrained import ebnf as jebnf
from smg_tpu.constrained import regex_fsm as jregex
from smg_tpu.engine import config as jconf
from smg_tpu.engine import detokenize as jdetok
from smg_tpu.engine import sampling as jsamp
from smg_tpu.engine.engine import Engine as JaxEngine
from smg_tpu.models.config import tiny_test_config
from smg_tpu.models.registry import get_model
from smg_tpu.protocols.sampling import SamplingParams as JaxSamplingParams
from smg_tpu.tokenizer import MockTokenizer
from smg_tpu_torch import constrained as tcon
from smg_tpu_torch.constrained import ebnf as tebnf
from smg_tpu_torch.constrained import regex_fsm as tregex
from smg_tpu_torch.engine import config as tconf
from smg_tpu_torch.engine import detokenize as tdetok
from smg_tpu_torch.engine import sampling as tsamp
from smg_tpu_torch.engine.engine import Engine, collect_result
from smg_tpu_torch.models.config import tiny_test_config as port_tiny
from smg_tpu_torch.models.convert import params_from_jax
from smg_tpu_torch.protocols.sampling import SamplingParams

torch.set_num_threads(2)
PAGE, BUDGET, V = 16, 64, 512


class CharTokenizer:
    """One character per token over a JSON- and regex-capable alphabet; id 0
    is EOS, 1 BOS, ids past the alphabet decode to an unusable character."""

    ALPHABET = list('{}[]":, 0123456789abcxyz')

    def __init__(self):
        self.vocab_size = V
        self.eos_token_id, self.bos_token_id = 0, 1
        self.special_ids = {0, 1}

    def decode(self, ids, skip_special_tokens=True):
        out = []
        for t in ids:
            if t in self.special_ids:
                continue
            i = t - 2
            out.append(self.ALPHABET[i] if 0 <= i < len(self.ALPHABET) else "\x00")
        return "".join(out)


class ByteTokenizer:
    """One UTF-8 byte per token: a multi-byte character split over tokens
    decodes to a replacement character until it is complete."""

    special_ids = {0, 1}

    def encode(self, text):
        return [b + 2 for b in text.encode()]

    def decode(self, ids, skip_special_tokens=True):
        return bytes(t - 2 for t in ids if t not in self.special_ids).decode(
            "utf-8", errors="replace")


# ---- (a) penalties, the vocab mask and the exact sampler ----


def _sampling_inputs(seed: int, B: int = 6):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    mask = rng.random((B, V)) < 0.3
    mask[:, 0] = True  # never an empty row
    temps = np.array([0.0, 0.0, 0.7, 1.0, 1.3, 0.0], np.float32)[:B]
    topks = np.array([-1, 5, 20, -1, 40, -1], np.int32)[:B]
    topps = np.array([1.0, 1.0, 0.9, 0.8, 1.0, 0.5], np.float32)[:B]
    minps = np.array([0.0, 0.0, 0.0, 0.05, 0.0, 0.0], np.float32)[:B]
    return logits, mask, temps, topks, topps, minps


@pytest.mark.parametrize("seed", [0, 1])
def test_apply_penalties_matches_jax(seed):
    rng = np.random.default_rng(seed)
    B = 5
    logits = (rng.standard_normal((B, V)) * 4).astype(np.float32)
    counts = rng.integers(0, 4, (B, V)).astype(np.int32) * (rng.random((B, V)) < 0.1)
    pmask = rng.random((B, V)) < 0.05
    freq = np.array([0.0, 0.5, 100.0, -0.3, 1.7], np.float32)
    pres = np.array([0.0, 0.3, 0.0, 50.0, -0.2], np.float32)
    rep = np.array([1.0, 1.3, 1.0, 1e6, 0.8], np.float32)
    want = jsamp.apply_penalties(*(jnp.asarray(x) for x in (logits, counts, pmask, freq,
                                                             pres, rep)))
    got = tsamp.apply_penalties(*(torch.from_numpy(x) for x in (logits, counts, pmask,
                                                                freq, pres, rep)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def _masked_logprobs(logits, mask, toks):
    z = np.where(mask, logits, tsamp.NEG_INF).astype(np.float64)
    lse = np.log(np.exp(z - z.max(-1, keepdims=True)).sum(-1)) + z.max(-1)
    return z[np.arange(len(toks)), toks] - lse


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("seed", [0, 3])
def test_masked_sampling_matches_jax(exact, seed):
    logits, mask, temps, topks, topps, minps = _sampling_inputs(seed)
    jfn = jsamp.sample_tokens_exact if exact else jsamp.sample_tokens
    tfn = tsamp.sample_tokens_exact if exact else tsamp.sample_tokens
    want_t, want_lp = jfn(jnp.asarray(logits), jax.random.PRNGKey(seed), jnp.asarray(temps),
                          jnp.asarray(topks), jnp.asarray(topps), jnp.asarray(minps),
                          mask=jnp.asarray(mask))
    got_t, got_lp = tfn(torch.from_numpy(logits), seed, 1, torch.from_numpy(temps),
                        torch.from_numpy(topks), torch.from_numpy(topps),
                        torch.from_numpy(minps), mask=torch.from_numpy(mask))
    got_t, got_lp = got_t.numpy(), got_lp.numpy()
    greedy = temps == 0
    np.testing.assert_array_equal(got_t[greedy], np.asarray(want_t)[greedy])
    np.testing.assert_allclose(got_lp[greedy], np.asarray(want_lp)[greedy], atol=1e-5)
    # sampled rows draw other noise: the token lies in the mask and its
    # logprob is the masked distribution's
    assert mask[np.arange(len(got_t)), got_t].all()
    np.testing.assert_allclose(got_lp, _masked_logprobs(logits, mask, got_t), atol=1e-5)


def test_exact_sampler_keeps_the_exact_filters_and_is_picked_by_env(monkeypatch):
    """Every draw of the full-sort sampler lies in the set its sequential
    top-k / top-p / min-p filters keep, computed in numpy."""
    rng = np.random.default_rng(9)
    row = (rng.standard_normal(V) * 2).astype(np.float32)
    n = 4000
    full = lambda x, dt=torch.float32: torch.full((n,), x, dtype=dt)  # noqa: E731
    for temp, k, p, mp in ((0.9, 100, 0.7, 0.0), (1.2, -1, 0.95, 0.01)):
        toks, _ = tsamp.sample_tokens_exact(
            torch.from_numpy(np.tile(row, (n, 1))), 0, 1, full(temp),
            full(k, torch.int64), full(p), full(mp))
        z = row.astype(np.float64) / temp
        order = np.argsort(-z, kind="stable")
        keep = np.zeros(V, bool)
        keep[order[: (V if k <= 0 else k)]] = True
        pr = np.where(keep, np.exp(z - z.max()), 0)
        pr /= pr.sum()
        cum = np.cumsum(pr[order]) - pr[order]
        keep[order[cum >= p]] = False
        pr = np.where(keep, pr, 0)
        keep &= pr >= mp * pr.max()
        assert keep[toks.numpy()].all()
        assert len(set(toks.tolist())) > 5
    monkeypatch.setenv("SMG_EXACT_SAMPLING", "1")
    assert tsamp.pick_sampler() is tsamp.sample_tokens_exact
    monkeypatch.delenv("SMG_EXACT_SAMPLING")
    assert tsamp.pick_sampler() is tsamp.sample_tokens


# ---- (b) constrained machines and the token filter ----

GRAMMARS = {
    "json": (None, None, ["", "{", '{"a', '{"a":', '{"a": [1, 2', '[1, "x"]', '"abc', "12",
                          "{}", '{"a":1}', "[", "[1,", '{"b": {"c": []}}', "1 2", "}"]),
    "regex": (r"[a-c]+[0-9]{2,3}", None, ["", "a", "abc", "abc1", "abc12", "abc123", "1",
                                          "abcd", "abc1234"]),
    "ebnf": (None, 'root ::= "[" [0-9] ("," [0-9])* "]"', ["", "[", "[1", "[1,", "[1,2]",
                                                            "[1,,", "]", "[1,2,3"]),
}


@pytest.mark.parametrize("kind", sorted(GRAMMARS))
def test_token_filter_masks_match_jax(kind):
    regex, ebnf, prefixes = GRAMMARS[kind]
    tok = CharTokenizer()
    machines = {
        "json": (jcon.JsonMachine, tcon.JsonMachine, ()),
        "regex": (jregex.RegexMachine, tregex.RegexMachine, (regex,)),
        "ebnf": (jebnf.EbnfMachine, tebnf.EbnfMachine, (ebnf,)),
    }[kind]
    jf = jcon.TokenFilter(tok, machines[0](*machines[2]), V, eos_token_ids=(0,))
    tf = tcon.TokenFilter(tok, machines[1](*machines[2]), V, eos_token_ids=(0,))
    for text in prefixes:
        want = jf.allowed_mask(text)
        np.testing.assert_array_equal(tf.allowed_mask(text), want, err_msg=repr(text))
        assert tf.is_finished(text) == jf.is_finished(text)
        assert tf.allowed_mask(text) is tf.allowed_mask(text)  # the text-keyed cache
    assert tf.text_of([2, 30, 0, 5]) == jf.text_of([2, 30, 0, 5])


@pytest.mark.parametrize("regex,ebnf", [
    ("[abc", None), (r"a{2000000000}", None), (r"[a-\d]", None), ("(ab", None),
    (None, 'start ::= "x"'), (None, "root ::= missing"), (None, 'root ::= "a" |'),
    (r"[a-z]+", 'root ::= "y"'),
])
def test_validate_grammar_matches_jax(regex, ebnf):
    def outcome(fn):
        try:
            fn(regex, ebnf)
            return None
        except ValueError as e:
            return type(e).__name__, str(e)

    assert outcome(tcon.validate_grammar) == outcome(jcon.validate_grammar)


# ---- (c) detokenisation and stop strings ----


def _chunks(rng, ids):
    cuts = sorted(rng.choice(np.arange(1, len(ids)), rng.integers(0, 6), replace=False))
    return [ids[a:b] for a, b in zip([0, *cuts], [*cuts, len(ids)])]


@pytest.mark.parametrize("seed", range(4))
def test_incremental_decoder_and_stop_checker_match_jax(seed):
    rng = np.random.default_rng(seed)
    words = ["héllo", "wörld", "→", "ok", " ", "日本", "stop", "x"]
    text = "".join(rng.choice(words, 14))
    tok = ByteTokenizer()
    ids = tok.encode(text)
    stops = ["stop", "日本", "zz"]
    for skip in (True, False):
        dec = [tdetok.IncrementalDecoder(tok, skip), jdetok.IncrementalDecoder(tok, skip)]
        chk = [tdetok.StopStringChecker(stops), jdetok.StopStringChecker(stops)]
        outs = [[], []]
        for chunk in _chunks(rng, ids):
            for i in (0, 1):
                outs[i].append((dec[i].put(list(chunk)),) + chk[i].feed(dec[i].put([])))
        for i in (0, 1):
            outs[i].append((dec[i].flush(), chk[i].flush(), chk[i].matched, chk[i].stopped))
        assert outs[0] == outs[1]
    # a stop string spanning chunks is found, swallowed and reported
    c = tdetok.StopStringChecker(["abc"])
    assert c.feed("xa") == ("", False) and c.feed("bcz") == ("x", True)
    assert c.matched == "abc" and c.flush() == ""


# ---- (d) engine streams against the JAX engine ----


@functools.lru_cache(maxsize=1)
def jax_params():
    cfg = tiny_test_config()
    return get_model(cfg.arch).init_params(cfg, jax.random.PRNGKey(0))


def jax_engine(tokenizer, horizon=4) -> JaxEngine:
    return JaxEngine(jconf.EngineConfig(
        model=tiny_test_config(),
        cache=jconf.CacheConfig(page_size=PAGE, num_pages=128, auto_size=False,
                                dtype="float32"),
        scheduler=jconf.SchedulerConfig(
            max_batch_size=8, max_seq_len=256, max_prefill_tokens=BUDGET,
            prefill_token_buckets=(16, 32, 64), decode_batch_buckets=(8,),
            decode_horizon=horizon, overlap_schedule=True),
        dtype="float32"), tokenizer=tokenizer, params=jax_params())


def port_engine(tokenizer=None, overlap=True, num_pages=128, max_batch=8, horizon=4,
                **sched_kw) -> Engine:
    return Engine(tconf.EngineConfig(
        model=port_tiny(),
        cache=tconf.CacheConfig(page_size=PAGE, num_pages=num_pages, auto_size=False,
                                dtype="float32"),
        scheduler=tconf.SchedulerConfig(
            max_batch_size=max_batch, max_seq_len=256, max_prefill_tokens=BUDGET,
            decode_batch_buckets=(2, 4, 8), decode_horizon=horizon,
            overlap_schedule=overlap, **sched_kw)),
        params=params_from_jax(jax.tree.map(np.asarray, jax_params())), device="cpu",
        tokenizer=tokenizer)


def drive(engine, jobs, max_steps=3000) -> dict:
    """Submit ``jobs`` = [(rid, prompt, sampling)] together and step inline
    until they finish and the pipeline drains: rid -> (tokens, text,
    finish_reason, matched_stop, logprobs)."""
    chunks = {rid: [] for rid, _, _ in jobs}
    for rid, prompt, sampling in jobs:
        engine.submit(prompt, sampling, rid=rid, on_output=chunks[rid].append)
    for _ in range(max_steps):
        if not engine.scheduler.has_work():
            break
        engine.step()
    else:
        raise TimeoutError(f"jobs stuck: {engine.loads()}")
    out = {}
    for rid, c in chunks.items():
        r = collect_result(rid, c)
        out[rid] = (r.token_ids, r.text, r.finish_reason, r.matched_stop, r.logprobs)
    return out


def both(jobs, tokenizer, **port_kw):
    """The same jobs through the JAX engine and the port's (overlap on,
    horizon 4); returns (want, got, port engine)."""
    jjobs = [(rid, p, JaxSamplingParams(**kw)) for rid, p, kw in jobs]
    tjobs = [(rid, p, SamplingParams(**kw)) for rid, p, kw in jobs]
    te = port_engine(tokenizer, **port_kw)
    return drive(jax_engine(tokenizer), jjobs), drive(te, tjobs), te


def assert_streams_equal(want, got, rids=None):
    for rid in rids or want:
        assert got[rid][:4] == want[rid][:4], rid
        np.testing.assert_allclose(got[rid][4], want[rid][4], rtol=1e-4, atol=1e-4)


def g(max_new, **kw) -> dict:
    return dict(temperature=0.0, max_new_tokens=max_new, ignore_eos=True, **kw)


def test_penalised_greedy_streams_match_jax_engine():
    """The analogues of the reference's penalty tests in one mixed batch:
    a huge frequency penalty forbids repeats, a penalised lane beside an
    unpenalised one, a repetition penalty on the prompt's tokens, and
    moderate penalties that reshape the stream."""
    jobs = [
        ("freq", list(range(40, 60)), g(12, frequency_penalty=100.0)),
        ("plain", list(range(70, 90)), g(10)),
        ("pres", list(range(90, 110)), g(10, presence_penalty=50.0)),
        ("rep", [7] * 16, g(8, repetition_penalty=1e6)),
        ("mix", list(range(120, 150)), g(16, frequency_penalty=0.5, presence_penalty=0.3)),
        ("rep13", list(range(5, 30)), g(16, repetition_penalty=1.3)),
    ]
    want, got, te = both(jobs, MockTokenizer())
    assert_streams_equal(want, got)
    assert len(set(got["freq"][0])) == 12 and 7 not in got["rep"][0]
    alone = drive(port_engine(), [("plain", list(range(70, 90)), SamplingParams(**g(10)))])
    assert alone["plain"][0] == got["plain"][0]  # the neutral row changes nothing
    assert te.scheduler.num_lookahead_kept > 0 and te.audit()["clean"]


def test_stop_strings_match_jax_engine():
    """Stop strings met on one token, across two tokens and never, beside a
    penalised lane: the text stops before the match, later tokens are
    rolled back, and the finish names the string."""
    tok = MockTokenizer()
    probe = drive(port_engine(tok), [("p", list(range(60, 75)), SamplingParams(**g(8)))])
    p = probe["p"][0]
    jobs = [
        ("one", list(range(60, 75)), g(12, stop=[f"w{p[2]}"])),
        ("two", list(range(60, 75)), g(12, stop=["xx", f"{p[3]} w{p[4]}"])),
        ("never", list(range(40, 50)), g(9, stop=["no such text"])),
        ("pen", list(range(120, 150)), g(10, frequency_penalty=0.5)),
    ]
    want, got, te = both(jobs, tok)
    assert_streams_equal(want, got)
    assert got["one"][2:4] == ("stop", f"w{p[2]}") and f"w{p[2]}" not in got["one"][1]
    assert got["two"][2] == "stop" and got["never"][2] == "length"
    assert got["one"][0] == p[:3]  # the token that completed the match is kept
    assert te.audit()["clean"]


def test_grammar_streams_match_jax_engine():
    """Greedy regex and EBNF streams equal the JAX engine's; JSON sampled at
    temperature 1.0 stays a valid prefix and parses when it stops; a lane
    whose regex cannot finish before ``max_new_tokens`` keeps the pipeline
    from launching any lookahead."""
    tok = CharTokenizer()
    regex, ebnf = r"[a-c]+[0-9]{2,3}", 'root ::= "[" [0-9] ("," [0-9])* "]"'
    jobs = [
        ("rx", [5, 7, 9], dict(temperature=0.0, max_new_tokens=12, regex=regex)),
        ("eb", [5, 7, 9, 11], dict(temperature=0.0, max_new_tokens=16, ebnf=ebnf)),
    ]
    want, got, _ = both(jobs, tok)
    assert_streams_equal(want, got)
    assert tregex.RegexMachine(regex).accepts(got["rx"][1])
    assert tebnf.EbnfMachine(ebnf).accepts(got["eb"][1])
    te = port_engine(tok)
    res = drive(te, [(f"j{i}", [5, 7, 9, 11], SamplingParams(
        temperature=1.0, max_new_tokens=48, json_schema="{}")) for i in range(3)])
    for toks, text, fin, _stop, _lp in res.values():
        assert tcon.JsonMachine().accepts(text), text
        if fin == "stop":
            json.loads(text)
    # masked lanes run K=1 and keep no lookahead: overlap on == off
    jobs = [("m", [5, 7], SamplingParams(temperature=0.0, max_new_tokens=6,
                                         regex=r"[0-9]{8}")),
            ("u", list(range(70, 95)), SamplingParams(**g(6)))]
    on_eng = port_engine(tok)
    on, off = drive(on_eng, jobs), drive(port_engine(tok, overlap=False), jobs)
    assert on == off and on["m"][0] and on_eng.scheduler.num_lookahead_kept == 0


# ---- (e) the megastep's penalty counts through a mid-horizon finish ----


def test_megastep_penalty_counts_match_jax_through_a_finish():
    from smg_tpu.engine.runner import ModelRunner as JaxRunner

    jr = JaxRunner(jconf.EngineConfig(
        model=tiny_test_config(),
        cache=jconf.CacheConfig(page_size=PAGE, num_pages=64, auto_size=False,
                                dtype="float32"),
        scheduler=jconf.SchedulerConfig(max_batch_size=4, max_seq_len=256,
                                        max_prefill_tokens=64,
                                        prefill_token_buckets=(16, 32, 64),
                                        decode_batch_buckets=(4,)),
        dtype="float32"), params=jax_params())
    tr = port_engine(num_pages=64, max_batch=4).runner
    prompts = [list(range(5, 45)), list(range(50, 70)), list(range(80, 131))]
    mp, B = 8, 4
    pt = np.zeros((B, mp), np.int32)
    firsts = []
    for i, p in enumerate(prompts):
        pt[i] = np.arange(1 + i * mp, 1 + (i + 1) * mp)
        want = jr.prefill(p, 0, pt[i], 0.0, -1, 1.0, 0.0)
        assert tr.prefill(p, 0, pt[i], 0.0, -1, 1.0, 0.0)[0] == want[0]
        firsts.append(want[0])
        outs = [firsts[-1], 3, 3, 9]  # earlier output: repeats count
        jr.sync_slot_penalty_state(i, p, outs)
        tr.sync_slot_penalty_state(i, p, outs)
    toks = np.array(firsts + [0], np.int32)
    pos = np.array([len(p) for p in prompts] + [mp * PAGE], np.int32)
    ones, zeros = np.ones(B, np.float32), np.zeros(B, np.float32)
    args = (toks, pos, pt, zeros, np.full(B, -1, np.int32), ones, zeros)
    pen = (np.array([0, 1, 2, B], np.int32), np.array([0.6, 0.0, 0.4, 0.0], np.float32),
           np.array([0.3, 0.0, 0.2, 0.0], np.float32),
           np.array([1.2, 1.0, 1.5, 1.0], np.float32))
    counts0 = np.asarray(jr._counts_buf).copy()
    free = jr.decode_multi(*args, num_steps=4, pen=pen)  # no stop state: every column
    stop_id = int(free[0][1, 2])  # lane 1 meets it at column 2
    jr._counts_buf = jnp.asarray(counts0)  # rewind the JAX counts
    stop = (np.array([[stop_id]] * B, np.int32), np.full(B, 10_000, np.int32),
            np.array([True, True, True, False]))
    want = jr.decode_multi(*args, num_steps=4, stop_state=stop, pen=pen)
    got = tr.decode_multi(*args, num_steps=4, stop_state=stop, pen=pen)
    assert want[0].shape[1] == 3 and got[0].shape == want[0].shape
    np.testing.assert_array_equal(got[0][:3], want[0][:3])  # row 3 is padding
    np.testing.assert_allclose(got[1][:3], want[1][:3], rtol=1e-4, atol=1e-4)
    # rows of the real slots: the columns past the finish left no count
    np.testing.assert_array_equal(tr._counts_buf[:B].numpy(), np.asarray(jr._counts_buf)[:B])
    assert (tr._counts_buf[:3].sum(1) - torch.from_numpy(counts0[:3].sum(1))).tolist() == [3] * 3


# ---- (f) overlap, discarded lookaheads and preemption with penalty lanes ----


@pytest.mark.parametrize("temp", [0.0, 0.8])
def test_penalty_lanes_overlap_on_and_off_are_byte_identical(temp):
    """A stop id met late discards kept lookaheads under overlap: the
    penalty lanes' device counts are re-derived and the streams stay those
    of the synchronous schedule."""
    probe = drive(port_engine(overlap=False), [("p", list(range(5, 25)),
                                                SamplingParams(**g(30)))])["p"][0]
    stop_tok = next(probe[k] for k in range(22, 30) if probe[k] not in probe[:k])
    s = lambda n, **kw: SamplingParams(temperature=temp, max_new_tokens=n,  # noqa: E731
                                       ignore_eos=True, **kw)
    jobs = [("a", list(range(5, 25)), s(30, stop_token_ids=[stop_tok])),
            ("f", list(range(40, 70)), s(28, frequency_penalty=0.7, presence_penalty=0.2)),
            ("r", list(range(100, 120)), s(26, repetition_penalty=1.4, top_k=40))]
    on_eng = port_engine(overlap=True, max_batch=4)
    on, off = drive(on_eng, jobs), drive(port_engine(overlap=False, max_batch=4), jobs)
    assert on == off
    loads = on_eng.loads()
    assert loads["lookahead_kept"] > 0
    if temp == 0.0:
        assert on["a"][2] == "stop" and loads["lookahead_discarded"] > 0, loads
    assert loads["audit"]["clean"]


def test_preempted_penalty_lanes_keep_their_streams():
    jobs = [(f"p{i}", list(range(5 + 17 * i, 37 + 17 * i)),
             SamplingParams(**g(24, frequency_penalty=0.6, repetition_penalty=1.2)))
            for i in range(4)]
    want = drive(port_engine(), jobs)
    eng = port_engine(num_pages=13, max_batch=4, watermark_pages=1)
    got = drive(eng, jobs)
    assert eng.scheduler.num_preemptions > 0
    # readmission prefills prompt + output: logits summed in another order
    assert_streams_equal(want, got)
    assert eng.audit()["clean"]
