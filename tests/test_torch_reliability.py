"""Failure isolation of the port's engine against the JAX engine, with the
same fault armed in both packages' fault registries (``smg_tpu.faults`` and
``smg_tpu_torch.faults``): poison-prefill quarantine, a mid-prefill chunk,
the decode step blaming its newest lane, a condemned batch turning the
engine unhealthy, consecutive prefill failures, the step watchdog, and a
submit during drain (``tests/test_reliability.py``'s scenarios).

Each scenario runs with the overlap pipeline on and off, on the tiny
float32 model with weights bridged from the JAX ``init_params``, greedy, at
horizon 4.  The culprit's finish and the survivors' tokens, finishes and
``cached_tokens`` equal the JAX engine's; logprobs agree within 1e-4.  The
flight recorder's step ring carries the reference's keys, step kinds and
fault flags, and ``EngineMetrics`` the reference's family names.

One JAX and one port engine serve every parity scenario (module-scoped;
the overlap mode is switched on the scheduler between scenarios, and
``flush_cache`` empties the radix cache), so the file stays light."""

import dataclasses
import functools
import time

import numpy as np
import pytest
import torch
from prometheus_client import generate_latest

import jax
from smg_tpu.engine import config as jconf
from smg_tpu.engine.engine import Engine as JaxEngine
from smg_tpu.engine.flight_recorder import STEP_RECORD_KEYS as REF_STEP_KEYS
from smg_tpu.engine.metrics import EngineMetrics as RefEngineMetrics
from smg_tpu.faults import FAULTS as JFAULTS
from smg_tpu.models.config import tiny_test_config
from smg_tpu.models.registry import get_model
from smg_tpu.protocols.sampling import SamplingParams as JaxSamplingParams
from smg_tpu_torch.engine import config as tconf
from smg_tpu_torch.engine.engine import Engine
from smg_tpu_torch.engine.flight_recorder import STEP_RECORD_KEYS
from smg_tpu_torch.engine.metrics import EngineMetrics
from smg_tpu_torch.engine.request import QueueFullError
from smg_tpu_torch.faults import FAULT_POINTS, FAULTS
from smg_tpu_torch.models.config import tiny_test_config as port_tiny
from smg_tpu_torch.models.convert import params_from_jax
from smg_tpu_torch.protocols.sampling import SamplingParams

torch.set_num_threads(2)
PAGE, BUDGET, HORIZON = 16, 64, 4
LONG = [(3 * i) % 200 + 5 for i in range(150)]  # three chunks under the budget


@functools.lru_cache(maxsize=1)
def jax_params():
    cfg = tiny_test_config()
    return get_model(cfg.arch).init_params(cfg, jax.random.PRNGKey(0))


def port_engine(**kw) -> Engine:
    return Engine(tconf.EngineConfig(
        model=port_tiny(),
        cache=tconf.CacheConfig(page_size=PAGE, num_pages=128, auto_size=False,
                                dtype="float32"),
        scheduler=tconf.SchedulerConfig(
            max_batch_size=4, max_seq_len=256, max_prefill_tokens=BUDGET,
            decode_batch_buckets=(4,), decode_horizon=HORIZON),
        **kw), params=params_from_jax(jax.tree.map(np.asarray, jax_params())), device="cpu")


@pytest.fixture(scope="module")
def pair():
    je = JaxEngine(jconf.EngineConfig(
        model=tiny_test_config(),
        cache=jconf.CacheConfig(page_size=PAGE, num_pages=128, auto_size=False,
                                dtype="float32"),
        scheduler=jconf.SchedulerConfig(
            max_batch_size=4, max_seq_len=256, max_prefill_tokens=BUDGET,
            prefill_token_buckets=(16, 32, 64), decode_batch_buckets=(4,),
            decode_horizon=HORIZON),
        dtype="float32"), params=jax_params())
    return je, port_engine()


@pytest.fixture(autouse=True)
def _disarm_faults():
    """No armed fault may outlive its test."""
    yield
    FAULTS.clear()
    JFAULTS.clear()


def _mode(engines, overlap: bool) -> None:
    """Switch the overlap pipeline, empty the radix cache (both engines
    idle) and end a failure streak an earlier scenario left, so every
    scenario starts from the same state."""
    for e in engines:
        sch = e.scheduler
        sch.sched = dataclasses.replace(sch.sched, overlap_schedule=overlap)
        sch.consec_step_failures = 0
        assert e.flush_cache()


def _arm(point: str, **kw) -> None:
    FAULTS.arm(point, **kw)
    JFAULTS.arm(point, **kw)


def _sp(max_new=6, cls=SamplingParams, **kw):
    return cls(temperature=0.0, max_new_tokens=max_new, ignore_eos=True, **kw)


def _collector(outs: dict, rid: str):
    return lambda out: outs.setdefault(rid, []).append(out)


def _drive(eng, outs: dict, rids: list, max_steps: int = 300) -> None:
    """Step inline until every rid has a terminal output and the pipeline
    has drained."""
    for _ in range(max_steps):
        if all(rid in outs and outs[rid][-1].finished for rid in rids) \
                and not eng.scheduler.has_work():
            return
        eng.step()
    raise AssertionError(f"requests never finished: {outs}")


def _result(outs: dict) -> dict:
    return {rid: ([t for o in c for t in o.new_token_ids], c[-1].finish_reason,
                  c[0].cached_tokens, [x for o in c for x in o.logprobs])
            for rid, c in outs.items()}


def _assert_same(want: dict, got: dict) -> None:
    assert set(want) == set(got)
    for rid, (toks, fin, cached, lps) in want.items():
        assert got[rid][:3] == (toks, fin, cached), rid
        np.testing.assert_allclose(got[rid][3], lps, rtol=1e-4, atol=1e-4)


def _assert_clean(eng) -> None:
    audit = eng.audit()
    assert audit["quiescent"] and audit["clean"], audit
    assert audit["leaked_pages"] == 0 and audit["radix_lock_refcounts"] == 0, audit
    assert eng.scheduler.requests == {} and eng.scheduler.inflight is None


def _both(pair, overlap, scenario):
    """Run ``scenario(engine, sampling_cls)`` on the JAX and the port engine
    with the same fault armed; returns both results."""
    _mode(pair, overlap)
    out = []
    for eng, cls in zip(pair, (JaxSamplingParams, SamplingParams)):
        out.append(scenario(eng, cls))
        _assert_clean(eng)
    return out


@pytest.mark.parametrize("overlap", [True, False])
def test_poison_prefill_quarantine_matches_jax(pair, overlap):
    prompts = {f"ok-{i}": [5 + i, 6 + i, 7 + i] for i in range(3)}

    def run(eng, cls, poison=True):
        q0 = eng.scheduler.num_quarantined
        serial0 = eng.scheduler.flight.step_serial
        outs: dict = {}
        for rid, ids in prompts.items():
            eng.submit(ids, _sp(cls=cls), rid=rid, on_output=_collector(outs, rid))
        if poison:
            FAULTS.arm("engine.prefill", match="poison")
            JFAULTS.arm("engine.prefill", match="poison")
            eng.submit([9, 10, 11], _sp(cls=cls), rid="poison",
                       on_output=_collector(outs, "poison"))
        _drive(eng, outs, list(outs))
        FAULTS.clear()
        JFAULTS.clear()
        assert eng.scheduler.num_quarantined - q0 == int(poison)
        assert eng.healthy
        ring = [r for r in eng.dump_flight()["ring"] if r["serial"] > serial0]
        return _result(outs), ring, outs.get("poison")

    (want, jring, jpoison), (got, ring, poison) = _both(pair, overlap, run)
    # exactly one terminal error chunk for the culprit, nothing streamed
    assert len(poison) == len(jpoison) == 1
    assert poison[0].finish_reason == "error" and poison[0].new_token_ids == []
    _assert_same(want, got)
    # survivors: full streams, equal to the run without the fault
    _mode(pair, overlap)
    clean, _ring, _ = run(pair[1], SamplingParams, poison=False)
    for rid in prompts:
        assert got[rid][0] == clean[rid][0] and len(got[rid][0]) == 6
    # the step ring: the reference's keys, the same step kinds and the
    # prefill fault flag on the same step
    assert all(set(r) == set(REF_STEP_KEYS) for r in ring)
    assert [(r["kind"], r["faults"]) for r in ring] == \
        [(r["kind"], r["faults"]) for r in jring]
    assert any(r["faults"] == ["prefill"] for r in ring)


@pytest.mark.parametrize("overlap", [True, False])
def test_poison_mid_prefill_chunk_matches_jax(pair, overlap):
    def run(eng, cls):
        outs: dict = {}
        # the second chunk of the long prompt raises: a non-final chunk
        FAULTS.arm("engine.prefill", mode="after", n=1, match="longpoison")
        JFAULTS.arm("engine.prefill", mode="after", n=1, match="longpoison")
        eng.submit(LONG, _sp(4, cls), rid="longpoison",
                   on_output=_collector(outs, "longpoison"))
        eng.submit([5, 6, 7], _sp(4, cls), rid="short", on_output=_collector(outs, "short"))
        _drive(eng, outs, ["longpoison", "short"])
        FAULTS.clear()
        JFAULTS.clear()
        return _result(outs)

    want, got = _both(pair, overlap, run)
    assert got["longpoison"][1] == "error" and len(got["short"][0]) == 4
    _assert_same(want, got)


@pytest.mark.parametrize("overlap", [True, False])
def test_decode_step_blames_newest_lane_matches_jax(pair, overlap):
    def run(eng, cls, fault=True):
        q0 = eng.scheduler.num_quarantined
        outs: dict = {}
        for i in range(3):
            eng.submit([5 + i, 6 + i, 7 + i], _sp(cls=cls), rid=f"r{i}",
                       on_output=_collector(outs, f"r{i}"))
        eng.step()  # admit and prefill all three
        assert all(eng.scheduler.requests[f"r{i}"].status.value == "running"
                   for i in range(3))
        if fault:
            FAULTS.arm("engine.decode_step", mode="once")
            JFAULTS.arm("engine.decode_step", mode="once")
        _drive(eng, outs, [f"r{i}" for i in range(3)])
        FAULTS.clear()
        JFAULTS.clear()
        assert eng.scheduler.num_quarantined - q0 == int(fault)
        return _result(outs), eng.scheduler.consec_step_failures

    (want, jstreak), (got, streak) = _both(pair, overlap, run)
    assert streak == jstreak
    # r2 has the highest admission serial: blamed
    assert got["r2"][1] == "error"
    _assert_same(want, got)
    _mode(pair, overlap)
    clean, _ = run(pair[1], SamplingParams, fault=False)
    for rid in ("r0", "r1"):
        assert got[rid] == clean[rid] and len(got[rid][0]) == 6


@pytest.mark.parametrize("overlap", [True, False])
def test_decode_poison_batch_condemned_and_unhealthy_matches_jax(pair, overlap):
    def run(eng, cls):
        outs: dict = {}
        _arm("engine.decode_step")  # always
        for i in range(2):
            eng.submit([5 + i, 6 + i, 7 + i], _sp(cls=cls), rid=f"c{i}",
                       on_output=_collector(outs, f"c{i}"))
        _drive(eng, outs, ["c0", "c1"], max_steps=10)
        assert eng.healthy
        healthy = []
        for i in range(eng.config.max_consecutive_step_failures + 1):
            eng.submit([5, 6, 7 + i], _sp(cls=cls), rid=f"y{i}",
                       on_output=_collector(outs, f"y{i}"))
            eng.step()
            healthy.append(eng.healthy)
        assert not eng.healthy and eng.loads()["healthy"] is False
        FAULTS.clear()
        JFAULTS.clear()
        eng.submit([5, 6, 99], _sp(cls=cls), rid="fresh", on_output=_collector(outs, "fresh"))
        _drive(eng, outs, list(outs))
        assert eng.healthy  # a clean step resets the streak
        return _result(outs), healthy

    (want, jhealthy), (got, healthy) = _both(pair, overlap, run)
    assert all(got[r][1] == "error" for r in ("c0", "c1"))
    assert healthy == jhealthy
    _assert_same(want, got)


def test_consecutive_prefill_failures_turn_unhealthy_matches_jax(pair):
    def run(eng, cls):
        outs: dict = {}
        _arm("engine.prefill")  # always
        healthy = []
        for i in range(eng.config.max_consecutive_step_failures + 1):
            eng.submit([5, 6, 7 + i], _sp(2, cls), rid=f"p{i}",
                       on_output=_collector(outs, f"p{i}"))
            eng.step()
            assert outs[f"p{i}"][-1].finish_reason == "error"
            healthy.append(eng.healthy)
        FAULTS.clear()
        JFAULTS.clear()
        eng.submit([5, 6, 99], _sp(2, cls), rid="ok", on_output=_collector(outs, "ok"))
        _drive(eng, outs, list(outs))
        assert eng.healthy
        return _result(outs), healthy

    (want, jhealthy), (got, healthy) = _both(pair, True, run)
    assert healthy == jhealthy and not healthy[-1]
    _assert_same(want, got)


def _fetch_raising(eng, times: int):
    """Make the runner's deferred fetch raise ``times`` times (a device
    fault surfacing where the host waits for the card)."""
    real = eng.runner.decode_fetch
    left = [times]

    def fetch(launch):
        if left[0] > 0:
            left[0] -= 1
            raise RuntimeError("device fault at fetch")
        return real(launch)

    eng.runner.decode_fetch = fetch


@pytest.mark.parametrize("temp", [0.0, 0.8])
def test_raising_fetch_under_overlap_rewinds_the_lost_frame(temp):
    """A step that raises inside the overlap pipeline (its frame and the
    lookahead chained off it in flight) quarantines the newest lane and
    rewinds both launches' sampling counters: the survivors' streams,
    logprobs included, equal a run without the fault, at any temperature."""
    prompts = {f"s{i}": list(range(5 + 10 * i, 25 + 10 * i)) for i in range(3)}

    def run(fault: bool):
        eng = port_engine()
        outs: dict = {}
        for rid, p in prompts.items():
            eng.submit(p, SamplingParams(temperature=temp, max_new_tokens=12),
                       rid=rid, on_output=_collector(outs, rid))
        eng.step()
        eng.step()  # a lookahead chained off the frame in flight
        if fault:
            _fetch_raising(eng, 1)
        _drive(eng, outs, list(prompts))
        _assert_clean(eng)
        return _result(outs), eng

    got, eng = run(True)
    clean, _ = run(False)
    assert got["s2"][1] == "error" and eng.scheduler.num_quarantined == 1
    assert eng.scheduler.num_lookahead_discarded > 0
    for rid in ("s0", "s1"):
        assert got[rid] == clean[rid], rid


def test_raising_fetch_never_repeats_forever():
    """Every fetch raising: the loop thread quarantines the lanes (blame,
    then the batch) instead of repeating the failing step; the requests end
    with ``error`` and the engine stays consistent."""
    eng = port_engine()
    _fetch_raising(eng, 10**9)
    done: dict = {}
    eng.start()
    try:
        for i in range(2):
            eng.submit([5 + i, 6 + i, 7 + i], _sp(8), rid=f"f{i}",
                       on_output=_collector(done, f"f{i}"))
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and not (
                len(done) == 2 and all(c[-1].finished for c in done.values())):
            time.sleep(0.01)
        assert all(done[r][-1].finish_reason == "error" for r in ("f0", "f1")), done
        assert eng.scheduler.num_quarantined == 2
        assert eng.scheduler.num_step_failures == 2  # the blame and the retry
    finally:
        eng.stop()
    _assert_clean(eng)


def test_watchdog_stall_detection_and_recovery():
    """A wedged device fetch (an injected hang) turns the engine unhealthy
    through the watchdog thread; progress clears the stall and the request
    still completes."""
    eng = port_engine(step_watchdog_secs=0.3)
    eng.start()
    try:
        eng.generate([5, 6, 7], _sp(4))
        FAULTS.arm("engine.device_fetch", mode="once", action="hang", delay=1.5)
        outs: dict = {}
        eng.submit([8, 9, 10], _sp(4), rid="w", on_output=_collector(outs, "w"))
        saw_unhealthy = False
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            saw_unhealthy |= not eng.healthy
            if outs.get("w") and outs["w"][-1].finished:
                break
            time.sleep(0.02)
        assert saw_unhealthy, "watchdog never flagged the stall"
        assert eng.num_watchdog_stalls == 1 and outs["w"][-1].finish_reason == "length"
        deadline = time.monotonic() + 10
        while not eng.healthy and time.monotonic() < deadline:
            time.sleep(0.02)
        assert eng.healthy, "stall never cleared after progress resumed"
        dumps = [d["reason"] for d in eng.dump_flight()["auto_dumps"]]
        assert "watchdog_stall" in dumps
    finally:
        eng.stop()


def test_submit_during_drain_rejected_not_hung():
    eng = port_engine()
    eng.start()
    eng.stop(drain=True, timeout=10)
    with pytest.raises(QueueFullError):
        eng.submit([1, 2, 3], SamplingParams(max_new_tokens=2), rid="late")


def test_flight_and_metrics_schemas_match_the_reference():
    assert STEP_RECORD_KEYS == REF_STEP_KEYS
    from smg_tpu.engine.flight_recorder import SCHEMA_VERSION as REF_SCHEMA
    from smg_tpu.faults import FAULT_POINTS as REF_POINTS
    from smg_tpu_torch.engine.flight_recorder import SCHEMA_VERSION

    assert SCHEMA_VERSION == REF_SCHEMA and FAULT_POINTS == REF_POINTS

    def families(m):
        return sorted(f.name for c in m._collectors for f in c.collect())

    assert families(EngineMetrics()) == families(RefEngineMetrics())


def test_quarantine_reaches_metrics_loads_and_the_flight_dump():
    eng = port_engine()
    outs: dict = {}
    FAULTS.arm("engine.prefill", match="bad")
    eng.submit([5, 6, 7], _sp(3), rid="good", on_output=_collector(outs, "good"))
    eng.submit([8, 9, 10], _sp(3), rid="bad", on_output=_collector(outs, "bad"))
    _drive(eng, outs, ["good", "bad"])
    loads = eng.loads()
    assert loads["quarantined_requests"] == 1 and loads["step_failures"] == 1
    text = generate_latest(eng.metrics.registry).decode()
    assert "smg_engine_quarantined_requests_total 1.0" in text
    assert 'smg_engine_requests_finished_total{reason="error"} 1.0' in text
    dump = eng.dump_flight("quarantine")
    assert dump["last_auto_dump"]["reason"] == "quarantine"
    bad = next(t for t in dump["timelines"]["finished"] if t["rid"] == "bad")
    assert bad["finish_reason"] == "error"
    assert any(e["kind"] == "quarantine" for e in bad["events"])
