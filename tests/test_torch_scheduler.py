"""The port's serving loop on the CPU: the overlap pipeline, preemption,
abort, deadlines, drain and ``flush_cache``, on the tiny float32 model with
weights bridged from the JAX package's ``init_params``.

Mirrors the reference's own suites (``tests/test_overlap.py``,
``test_megastep.py``, ``test_engine.py``, ``test_chunked_prefill.py``):
greedy streams, finishes and ``cached_tokens`` equal the JAX engine's with
the overlap pipeline on at horizon 4; overlap on and off give
byte-identical streams (tokens and logprobs) at temperature 0 and 0.8;
preempted requests finish with the streams of an unpressured run; and
``audit()`` reports no leaked page and no stray radix pin after every
scenario.  Every wait on the loop thread has its own deadline and every
started engine is stopped in a ``finally``."""

import functools
import time

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
from smg_tpu_torch.engine.engine import Engine
from smg_tpu_torch.engine.request import QueueFullError, RequestStatus
from smg_tpu_torch.models.config import tiny_test_config as port_tiny
from smg_tpu_torch.models.convert import params_from_jax
from smg_tpu_torch.protocols.sampling import SamplingParams

torch.set_num_threads(2)
PAGE, BUDGET = 16, 64
LONG = list(range(5, 205))  # 200 tokens: 4 chunks under the 64-token budget


@functools.lru_cache(maxsize=1)
def jax_params():
    cfg = tiny_test_config()
    return get_model(cfg.arch).init_params(cfg, jax.random.PRNGKey(0))


def port_params():
    return params_from_jax(jax.tree.map(np.asarray, jax_params()))


def make_engine(overlap=True, num_pages=128, max_batch=8, max_seq_len=256, horizon=4,
                **sched_kw) -> Engine:
    return Engine(tconf.EngineConfig(
        model=port_tiny(),
        cache=tconf.CacheConfig(page_size=PAGE, num_pages=num_pages, auto_size=False,
                                dtype="float32"),
        scheduler=tconf.SchedulerConfig(
            max_batch_size=max_batch, max_seq_len=max_seq_len, max_prefill_tokens=BUDGET,
            decode_batch_buckets=(2, 4, 8), decode_horizon=horizon,
            overlap_schedule=overlap, **sched_kw)),
        params=port_params(), device="cpu")


def sp(max_new=8, temp=0.0, cls=SamplingParams, **kw):
    return cls(temperature=temp, max_new_tokens=max_new, ignore_eos=True, **kw)


def assert_clean(engine):
    audit = engine.audit()
    assert audit["quiescent"] and audit["clean"], audit
    assert audit["leaked_pages"] == 0 and audit["radix_lock_refcounts"] == 0, audit


def drive(engine, waves, max_steps=2000) -> dict:
    """Submit ``waves`` = [(step, [(rid, prompt, sampling), ...])], each at
    its step number, step inline until every request finished and the
    pipeline drained; returns rid -> (tokens, finish, cached, logprobs)."""
    chunks: dict[str, list] = {}
    pending = sorted(waves, key=lambda w: w[0])
    for n in range(max_steps):
        while pending and pending[0][0] <= n:
            for rid, prompt, sampling in pending.pop(0)[1]:
                chunks[rid] = []
                engine.submit(prompt, sampling, rid=rid, on_output=chunks[rid].append)
        if not pending and not engine.scheduler.has_work():
            break
        engine.step()
    else:
        raise TimeoutError(f"jobs stuck after {max_steps} steps")
    out = {}
    for rid, c in chunks.items():
        out[rid] = ([t for o in c for t in o.new_token_ids], c[-1].finish_reason,
                    c[0].cached_tokens, [x for o in c for x in o.logprobs])
    return out


def streams(res: dict) -> dict:
    return {rid: (toks, fin) for rid, (toks, fin, _c, _lp) in res.items()}


# staggered traffic: a chunked long prompt, admissions mid-stream, a radix
# hit on a finished request's prefix, and (max_batch 2) requests waiting
# for slots that free inside an in-flight frame
WAVES = [
    (0, [("a", list(range(5, 25)), 6), ("long", list(range(30, 180)), 9)]),
    (3, [("hit", list(range(5, 21)) + [300, 301, 302], 7),
         ("w", list(range(200, 230)), 5)]),
]


def test_overlap_matches_jax_engine_greedy_streams():
    je = JaxEngine(jconf.EngineConfig(
        model=tiny_test_config(),
        cache=jconf.CacheConfig(page_size=PAGE, num_pages=128, auto_size=False,
                                dtype="float32"),
        scheduler=jconf.SchedulerConfig(
            max_batch_size=2, max_seq_len=256, max_prefill_tokens=BUDGET,
            prefill_token_buckets=(16, 32, 64), decode_batch_buckets=(2,),
            decode_horizon=4, overlap_schedule=True),
        dtype="float32"), params=jax_params())
    te = make_engine(max_batch=2)
    jw = [(n, [(r, p, sp(m, cls=JaxSamplingParams)) for r, p, m in jobs]) for n, jobs in WAVES]
    tw = [(n, [(r, p, sp(m)) for r, p, m in jobs]) for n, jobs in WAVES]
    want, got = drive(je, jw), drive(te, tw)
    assert want["hit"][2] > 0 and want["long"][2] == 0  # radix hit, chunked cold
    for rid, (toks, fin, cached, lps) in want.items():
        assert got[rid][:3] == (toks, fin, cached), rid
        np.testing.assert_allclose(got[rid][3], lps, rtol=1e-4, atol=1e-4)
    assert te.scheduler.num_lookahead_kept > 0
    assert_clean(te)


@pytest.mark.parametrize("temp,adaptive", [(0.0, False), (0.8, False), (0.8, True)])
def test_overlap_on_and_off_are_byte_identical(temp, adaptive):
    probe = drive(make_engine(overlap=False), [(0, [("p", list(range(5, 25)), sp(40))])])
    toks = probe["p"][0]
    # a stop id first met late, once the queue has drained and horizons are 4
    # wide: at temperature 0 an unpredicted finish inside a kept lookahead
    stop_tok = next(toks[k] for k in range(33, 40) if toks[k] not in toks[:k])
    waves = [
        (0, [("a", list(range(5, 25)), sp(40, temp, stop_token_ids=[stop_tok])),
             ("long", LONG, sp(10, temp, top_k=40)),
             ("c", list(range(220, 250)), sp(12, temp, min_p=0.05))]),
        (2, [("d", list(range(300, 330)), sp(7, temp, top_p=0.9))]),
    ]
    # the adaptive controller picks K from the finish-gap EMA and the
    # remaining budgets, up to 8 (horizons other than powers of two)
    kw = dict(max_batch=2, adaptive_horizon=adaptive, decode_horizon_max=8 if adaptive else 0)
    on_eng, off_eng = make_engine(overlap=True, **kw), make_engine(overlap=False, **kw)
    on, off = drive(on_eng, waves), drive(off_eng, waves)
    assert on == off  # tokens, finishes, cached tokens and logprobs, bit for bit
    loads = on_eng.loads()
    assert loads["lookahead_kept"] > 0, loads
    if temp == 0.0:
        assert on["a"][1] == "stop" and loads["lookahead_discarded"] > 0, loads
    assert off_eng.loads()["lookahead_kept"] == 0
    for e in (on_eng, off_eng):
        assert_clean(e)


@pytest.mark.parametrize("overlap", [True, False])
def test_abort_waiting_running_and_in_flight(overlap):
    ref = streams(drive(make_engine(overlap=False), [(0, [("b", list(range(30, 55)),
                                                           sp(10))])]))
    eng = make_engine(overlap=overlap, max_batch=2)
    got: dict[str, list] = {k: [] for k in ("a", "b", "q")}
    for rid, prompt, n in (("a", list(range(5, 25)), 64), ("b", list(range(30, 55)), 10),
                           ("q", list(range(60, 80)), 4)):
        eng.submit(prompt, sp(n), rid=rid, on_output=got[rid].append)
    sched = eng.scheduler
    assert sched.requests["q"].status is RequestStatus.WAITING
    assert eng.abort("q") and not eng.abort("q")  # a waiting request
    for _ in range(3):
        eng.step()
    assert sched.requests["a"].status is RequestStatus.RUNNING
    if overlap:  # "a" rides the frame in flight
        assert sched.inflight is not None and any(r.rid == "a"
                                                  for _, r, _ in sched.inflight.lanes)
    assert eng.abort("a")
    for _ in range(200):
        if not sched.has_work():
            break
        eng.step()
    assert not got["q"] and got["b"][-1].finish_reason == "length"
    assert ([t for o in got["b"] for t in o.new_token_ids], "length") == ref["b"]
    assert sched.inflight is None and not sched.requests
    assert_clean(eng)


def test_deadlines_finish_waiting_and_running_with_timeout():
    eng = make_engine(max_batch=1)
    got: dict[str, list] = {"run": [], "wait": []}
    eng.submit(list(range(5, 25)), sp(64), rid="run", on_output=got["run"].append)
    eng.submit(list(range(30, 50)), sp(8), rid="wait", on_output=got["wait"].append,
               timeout_secs=0.0)
    time.sleep(0.01)
    for _ in range(4):
        eng.step()
    assert got["wait"] and got["wait"][-1].finish_reason == "timeout"
    assert not [t for o in got["wait"] for t in o.new_token_ids]
    req = eng.scheduler.requests["run"]
    assert req.status is RequestStatus.RUNNING and req.output_ids
    req.deadline = time.monotonic() - 1.0  # its budget ran out mid-generation
    eng.step()
    last = got["run"][-1]
    assert last.finished and last.finish_reason == "timeout"
    assert 0 < last.output_tokens < 64
    loads = eng.loads()
    assert (loads["deadline_expirations_waiting"], loads["deadline_expirations_running"]) == (1, 1)
    while eng.scheduler.has_work():  # a stale frame may still be in flight
        eng.step()
    assert_clean(eng)
    # generate() turns an expired budget into a result, not an exception
    assert eng.generate(list(range(5, 25)), sp(200), timeout_secs=0.0).finish_reason == "timeout"


def test_stop_drain_finishes_admitted_and_aborts_queued():
    eng = make_engine(max_batch=1)
    got: dict[str, list] = {k: [] for k in ("r", "q1", "q2")}
    for rid, n in (("r", 200), ("q1", 4), ("q2", 4)):
        eng.submit(list(range(5 + n % 50, 30 + n % 50)), sp(n), rid=rid,
                   on_output=got[rid].append)
    eng.step()  # "r" admitted into the only slot; the other two wait
    eng.start()
    try:
        eng.stop(drain=True, timeout=30)
        assert eng._thread is None
        with pytest.raises(QueueFullError):
            eng.submit([5, 6, 7], sp(2))
    finally:
        eng.stop()
    assert got["r"][-1].finish_reason == "length"
    assert sum(len(o.new_token_ids) for o in got["r"]) == 200
    for rid in ("q1", "q2"):
        assert [(o.finished, o.finish_reason) for o in got[rid]] == [(True, "abort")]
    assert_clean(eng)


def test_background_loop_streams_match_inline_stepping():
    jobs = [(f"g{i}", list(range(5 + 7 * i, 40 + 7 * i)), sp(6 + 3 * i)) for i in range(3)]
    want = streams(drive(make_engine(), [(0, jobs)]))
    eng = make_engine()
    done: dict[str, list] = {rid: [] for rid, _, _ in jobs}
    eng.start()
    try:
        for rid, prompt, s in jobs:
            eng.submit(prompt, s, rid=rid, on_output=done[rid].append)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not all(
                v and v[-1].finished for v in done.values()):
            time.sleep(0.005)
        r = eng.generate(list(range(5, 40)), sp(6), timeout_secs=60)
    finally:
        eng.stop()
    assert {rid: ([t for o in v for t in o.new_token_ids], v[-1].finish_reason)
            for rid, v in done.items()} == want
    assert r.token_ids == want["g0"][0] and r.cached_tokens > 0
    assert eng.healthy and eng.scheduler.inflight is None
    assert_clean(eng)


def test_flush_cache_with_a_stale_frame_in_flight():
    eng = make_engine()
    want = eng.generate(list(range(5, 30)), sp(6)).token_ids
    eng.submit(list(range(40, 60)), sp(64), rid="x")
    for _ in range(3):
        eng.step()
    assert eng.scheduler.inflight is not None
    eng.abort("x")  # every lane gone: the frame in flight is stale
    assert eng.scheduler.inflight is not None and not any(eng.scheduler.slots)
    assert eng.flush_cache()
    sched = eng.scheduler
    assert sched.inflight is None and sched.radix.num_cached_pages == 0
    assert sched.pool.free_count == eng.runner.spec.num_pages - 1
    assert not eng.runner.k_cache.any()
    r = eng.generate(list(range(5, 30)), sp(6))
    assert r.token_ids == want and r.cached_tokens == 0
    assert_clean(eng)


@pytest.mark.parametrize("overlap", [True, False])
def test_preemption_under_page_pressure_keeps_streams(overlap):
    jobs = [(f"p{i}", list(range(5 + 17 * i, 37 + 17 * i)), sp(24)) for i in range(4)]
    want = streams(drive(make_engine(overlap=overlap), [(0, jobs)]))
    eng = make_engine(overlap=overlap, num_pages=13, max_batch=4, watermark_pages=1)
    got = streams(drive(eng, [(0, jobs)]))
    assert eng.scheduler.num_preemptions > 0
    assert got == want
    assert_clean(eng)


def test_preemption_lands_mid_prefill_and_resumes_from_the_radix():
    """The pool holds the short lane and the long prompt with nothing to
    spare: the lane's first page crossing preempts the prefilling request,
    which banks its computed chunks and resumes from a prefix hit."""
    want = streams(drive(make_engine(num_pages=64, horizon=1), [(0, [("long", LONG, sp(6))])]))
    eng = make_engine(num_pages=17, horizon=1, watermark_pages=0)
    sched = eng.scheduler
    got: dict[str, list] = {"s": [], "long": []}
    eng.submit(list(range(400, 447)), sp(20), rid="s", on_output=got["s"].append)
    eng.step()
    eng.submit(LONG, sp(6), rid="long", on_output=got["long"].append)
    mid_prefill = False
    for _ in range(400):
        n = sched.num_preemptions
        eng.step()
        if sched.num_preemptions > n and not got["long"]:
            mid_prefill = True
            assert sched.radix.num_cached_pages > 0  # the banked chunks
        if not sched.has_work():
            break
    assert mid_prefill, "preemption never landed mid-prefill"
    assert ([t for o in got["long"] for t in o.new_token_ids], "length") == want["long"]
    assert got["long"][0].cached_tokens > 0  # resumed, not restarted
    assert got["s"][-1].finish_reason == "length"
    assert_clean(eng)


def test_queue_bounds_and_unadmittable_request():
    eng = make_engine(max_queued_requests=1)
    eng.submit([5, 6, 7], sp(2), rid="one")
    with pytest.raises(QueueFullError):
        eng.submit([8, 9], sp(2))
    assert eng.loads()["queue_rejections"] == 1
    # a prompt larger than the whole pool: nothing running can make room
    small = make_engine(num_pages=4, watermark_pages=0)
    r = small.generate(list(range(5, 105)), sp(2))
    assert r.finish_reason == "error" and r.token_ids == []
    assert_clean(small)


def test_threads_submitting_and_aborting_against_the_loop():
    """More submitting threads than cores, a short switch interval: every
    request that is not aborted ends exactly once, and nothing leaks."""
    import sys
    import threading

    eng = make_engine(max_batch=4)
    finals: dict[str, int] = {}
    guard = threading.Lock()

    def on_output(o):
        if o.finished:
            with guard:
                finals[o.rid] = finals.get(o.rid, 0) + 1

    def worker(w):
        for i in range(4):
            rid = f"w{w}-{i}"
            eng.submit(list(range(5 + w, 25 + w + i)), sp(4 + i), rid=rid, on_output=on_output)
            if i == 2:
                eng.abort(rid)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    eng.start()
    try:
        threads = [threading.Thread(target=worker, args=(w,)) for w in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        kept = {f"w{w}-{i}" for w in range(12) for i in (0, 1, 3)}
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not kept <= set(finals):
            time.sleep(0.005)
    finally:
        sys.setswitchinterval(old)
        eng.stop()
    assert kept <= set(finals) and all(n == 1 for n in finals.values()), finals
    assert_clean(eng)


def test_runner_decode_multi_matches_jax_megastep():
    """The runner's megastep (launch plus fetch) against the JAX runner's
    ``decode_multi``: same prompts prefilled, a padded bucket row on the
    garbage page, a stop id met inside the horizon so both loops report the
    same ``steps_run``."""
    from smg_tpu.engine.runner import ModelRunner as JaxRunner

    jcfg = jconf.EngineConfig(
        model=tiny_test_config(),
        cache=jconf.CacheConfig(page_size=PAGE, num_pages=64, auto_size=False,
                                dtype="float32"),
        scheduler=jconf.SchedulerConfig(max_batch_size=4, max_seq_len=256,
                                        max_prefill_tokens=64,
                                        prefill_token_buckets=(16, 32, 64),
                                        decode_batch_buckets=(4,)),
        dtype="float32")
    jr = JaxRunner(jcfg, params=jax_params())
    tr = make_engine(num_pages=64, max_batch=4).runner
    prompts = [list(range(5, 45)), list(range(50, 70)), list(range(80, 131))]
    mp = 8
    pt = np.zeros((4, mp), np.int32)
    firsts = []
    for i, p in enumerate(prompts):
        pt[i] = np.arange(1 + i * mp, 1 + (i + 1) * mp)
        want = jr.prefill(p, 0, pt[i], 0.0, -1, 1.0, 0.0)
        got = tr.prefill(p, 0, pt[i], 0.0, -1, 1.0, 0.0)
        assert got[0] == want[0]
        firsts.append(got[0])
    toks = np.array(firsts + [0], np.int32)
    pos = np.array([len(p) for p in prompts] + [mp * PAGE], np.int32)
    ones, zeros = np.ones(4, np.float32), np.zeros(4, np.float32)
    args = (toks, pos, pt, zeros, np.full(4, -1, np.int32), ones, zeros)
    free = jr.decode_multi(*args, num_steps=4)  # no stop state: every column
    stop_id = int(free[0][1, 2])  # lane 1 meets it at column 2
    stop = (np.array([[stop_id]] * 4, np.int32), np.full(4, 10_000, np.int32),
            np.array([True, True, True, False]))
    want = jr.decode_multi(*args, num_steps=4, stop_state=stop)
    got = tr.decode_multi(*args, num_steps=4, stop_state=stop)
    assert want[0].shape[1] == 3  # the device loop stopped after column 2
    np.testing.assert_array_equal(got[0][:3], want[0][:3])
    np.testing.assert_allclose(got[1][:3], want[1][:3], rtol=1e-4, atol=1e-4)
    assert got[0].shape == want[0].shape
