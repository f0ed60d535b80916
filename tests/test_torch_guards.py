"""The port's runtime guards (``smg_tpu_torch/analysis/runtime_guards.py``)
held against the reference's (``smg_tpu/analysis/runtime_guards.py``).

- the lock-order sentinel: every case of ``tests/test_analysis.py``'s
  ``TestLockOrderSentinel`` run through both packages' sentinels, with the
  same outcomes, inversion lists and error texts (stacks removed); the
  port's engine workload under the sentinel, a poison-decode quarantine
  with survivors included, records no inversion;
- the engine's callback map is read and written under the engine lock and
  the callbacks run outside it: outputs arrive in order beside a
  concurrent ``abort``, whose terminal increment is never delivered;
- the graph-family auditor on the tiny model (the CPU runs every family
  eagerly, a new key's first armed launch standing for the card's
  capture): steady-state decode is audit-clean and guard-clean, a batch
  growing from 1 to 2 lanes names the key field ``B`` in its provenance, a
  recapture of one key names the argument that changed, a moved storage and
  an input off the engine's device make the audit unclean, an unarmed
  wrapper records nothing, dropped graphs are forgotten, and
  ``loads()["programs"]`` has the reference snapshot's schema;
- on the CPU the host-sync guard does nothing and says so, and the capture
  budget still holds;
- on the card only (``-m cuda``): graph-replayed decode under
  ``steady_state_guard`` syncs and captures nothing and audits clean,
  ``.item()`` under it raises, and one forced recapture trips the budget.

Run on the CPU: ``python -m pytest tests/test_torch_guards.py -q``; on a
GPU: ``python -m pytest tests/test_torch_guards.py -m cuda -q``."""

import re
import threading
import time

import pytest
import torch

import smg_tpu.analysis.runtime_guards as jrg
import smg_tpu_torch.analysis.runtime_guards as trg
from smg_tpu_torch.engine.config import CacheConfig, EngineConfig, SchedulerConfig
from smg_tpu_torch.engine.engine import Engine
from smg_tpu_torch.faults import FAULTS
from smg_tpu_torch.models.config import tiny_test_config
from smg_tpu_torch.protocols.sampling import SamplingParams

torch.set_num_threads(2)
MODS = {"ref": jrg, "port": trg}


# ---- the lock-order sentinel, through both packages ----


def _strip_stacks(msg: str) -> str:
    """The error text without its stacks (file paths and line numbers
    differ between the packages): the header and the section lines."""
    return "\n".join(line for line in msg.splitlines()
                     if line.startswith(("===", "---")) or "inversion(s)" in line)


def _inversions(s) -> list:
    return [(inv["first"], inv["second"]) for inv in s.inversions]


def case_unarmed_make_lock_is_plain(rg, monkeypatch):
    monkeypatch.delenv(rg.SENTINEL_ENV, raising=False)
    monkeypatch.setattr(rg, "_ambient_sentinel", None)
    plain = isinstance(rg.make_lock("x"), type(threading.Lock()))
    r = rg.make_lock("y", reentrant=True)
    with r:
        with r:
            pass
    return plain, type(r).__name__


def case_clean_order_passes(rg, monkeypatch):
    with rg.lock_order_sentinel() as s:
        a, b = rg.make_lock("a"), rg.make_lock("b")
        for _ in range(3):
            with a:
                with b:
                    pass
    return _inversions(s), type(a).__name__


def case_deliberate_inversion_fails_loudly_with_both_stacks(rg, monkeypatch):
    with pytest.raises(rg.LockOrderError) as ei:
        with rg.lock_order_sentinel():
            a, b = rg.make_lock("a"), rg.make_lock("b")
            with a:
                with b:
                    pass
            with b:
                with a:
                    pass
    msg = str(ei.value)
    return (_strip_stacks(msg), msg.count("stack that"),
            msg.count("case_deliberate_inversion") >= 2)


def case_raise_on_inversion_pinpoints_and_unwinds(rg, monkeypatch):
    with pytest.raises(rg.LockOrderError) as ei:
        with rg.lock_order_sentinel(raise_on_inversion=True) as s:
            a, b = rg.make_lock("a"), rg.make_lock("b")
            with a:
                with b:
                    pass
            with b:
                with a:  # raises here, at the closing acquisition
                    pass
    return (a.locked(), b.locked(), _inversions(s), _strip_stacks(str(ei.value)))


def case_cross_thread_inversion_detected(rg, monkeypatch):
    with pytest.raises(rg.LockOrderError) as ei:
        with rg.lock_order_sentinel():
            a, b = rg.make_lock("a"), rg.make_lock("b")

            def t1():
                with a:
                    with b:
                        pass

            th = threading.Thread(target=t1)
            th.start()
            th.join()
            with b:
                with a:
                    pass
    return _strip_stacks(str(ei.value))


def case_reentrant_lock_not_self_edged(rg, monkeypatch):
    with rg.lock_order_sentinel() as s:
        r = rg.make_lock("engine", reentrant=True)
        with r:
            with r:
                pass
    return _inversions(s)


def case_condition_on_sentinel_rlock_works(rg, monkeypatch):
    with rg.lock_order_sentinel() as s:
        lock = rg.make_lock("engine", reentrant=True)
        cv = threading.Condition(lock)
        got = []

        def waiter():
            with cv:
                cv.wait(timeout=5)
                got.append(1)

        t = threading.Thread(target=waiter)
        t.start()
        time.sleep(0.05)
        with cv:
            cv.notify_all()
        t.join(timeout=5)
    return got, _inversions(s)


def case_env_armed_sentinel_raises_at_the_acquisition(rg, monkeypatch):
    monkeypatch.setenv(rg.SENTINEL_ENV, "1")
    monkeypatch.setattr(rg, "_ambient_sentinel", None)
    a, b = rg.make_lock("a"), rg.make_lock("b")
    with a:
        with b:
            pass
    with pytest.raises(rg.LockOrderError) as ei:
        with b:
            with a:
                pass
    held = (a.locked(), b.locked())
    monkeypatch.setattr(rg, "_ambient_sentinel", None)
    return type(a).__name__, held, _strip_stacks(str(ei.value))


SENTINEL_CASES = [case_unarmed_make_lock_is_plain, case_clean_order_passes,
                  case_deliberate_inversion_fails_loudly_with_both_stacks,
                  case_raise_on_inversion_pinpoints_and_unwinds,
                  case_cross_thread_inversion_detected, case_reentrant_lock_not_self_edged,
                  case_condition_on_sentinel_rlock_works,
                  case_env_armed_sentinel_raises_at_the_acquisition]
#: what each case must give (both packages)
SENTINEL_WANT = {
    "unarmed_make_lock_is_plain": (True, "RLock"),
    "clean_order_passes": ([], "SentinelLock"),
    "deliberate_inversion_fails_loudly_with_both_stacks": (
        "1 lock-order inversion(s):\n=== b -> a (conflicts with a -> b) ===\n"
        "--- stack that established a -> b ---\n"
        "--- stack that closed the cycle (b -> a) ---", 2, True),
    "raise_on_inversion_pinpoints_and_unwinds": (False, False, [("a -> b", "b -> a")], (
        "1 lock-order inversion(s):\n=== b -> a (conflicts with a -> b) ===\n"
        "--- stack that established a -> b ---\n"
        "--- stack that closed the cycle (b -> a) ---")),
    "cross_thread_inversion_detected": (
        "1 lock-order inversion(s):\n=== b -> a (conflicts with a -> b) ===\n"
        "--- stack that established a -> b ---\n"
        "--- stack that closed the cycle (b -> a) ---"),
    "reentrant_lock_not_self_edged": [],
    "condition_on_sentinel_rlock_works": ([1], []),
    "env_armed_sentinel_raises_at_the_acquisition": ("SentinelLock", (False, False), (
        "1 lock-order inversion(s):\n=== b -> a (conflicts with a -> b) ===\n"
        "--- stack that established a -> b ---\n"
        "--- stack that closed the cycle (b -> a) ---")),
}


@pytest.mark.parametrize("case", SENTINEL_CASES, ids=lambda f: f.__name__[5:])
def test_lock_order_sentinel_matches_reference(case, monkeypatch):
    got = {side: case(rg, monkeypatch) for side, rg in MODS.items()}
    assert got["port"] == got["ref"] == SENTINEL_WANT[case.__name__[5:]]


# ---- the engine under the sentinel; callback delivery ----


def tiny_engine(overlap: bool = True, buckets=(4,), horizon: int = 2, **kw) -> Engine:
    return Engine(EngineConfig(
        model=tiny_test_config(),
        cache=CacheConfig(page_size=16, num_pages=64, auto_size=False, dtype="float32"),
        scheduler=SchedulerConfig(max_batch_size=max(buckets), max_seq_len=128,
                                  max_prefill_tokens=32, decode_batch_buckets=buckets,
                                  decode_horizon=horizon, overlap_schedule=overlap),
        **kw), device="cpu")


def _greedy(n: int) -> SamplingParams:
    return SamplingParams(temperature=0.0, max_new_tokens=n, ignore_eos=True)


def _prompt(i: int) -> list:
    return [(5 * i + j) % 90 + 5 for j in range(16)]


def _drive(eng, outs: dict, rids: list, max_steps: int = 300) -> None:
    for _ in range(max_steps):
        if all(rid in outs and outs[rid][-1].finished for rid in rids) \
                and not eng.scheduler.has_work():
            return
        eng.step()
    raise AssertionError(f"requests never finished: {outs}")


def test_engine_workload_under_sentinel_is_inversion_free():
    """A boot, decode, a poison-decode quarantine with survivors (its
    flight-recorder dump runs with the engine lock held) and a drain: the
    engine, flight-recorder and metric locks record no inversion."""
    with trg.lock_order_sentinel() as s:
        eng = tiny_engine(overlap=True)
        assert isinstance(eng._lock, trg.SentinelLock)
        outs: dict = {}
        rids = [f"sent-{i}" for i in range(3)]
        for i, rid in enumerate(rids):
            eng.submit(_prompt(i), _greedy(12), rid=rid,
                       on_output=lambda o, rid=rid: outs.setdefault(rid, []).append(o))
        FAULTS.arm("engine.decode_step", mode="once")
        try:
            _drive(eng, outs, rids)
        finally:
            FAULTS.clear()
        quarantined = [r for r in rids if outs[r][-1].finish_reason == "error"]
        assert len(quarantined) == 1
        survivors = [r for r in rids if r not in quarantined]
        assert all(sum(len(o.new_token_ids) for o in outs[r]) == 12 for r in survivors)
        eng.stop(drain=True, timeout=5.0)
        assert eng.audit()["clean"]
    assert s.inversions == [], s.format_inversions()


def test_delivery_stays_in_order_beside_a_concurrent_abort():
    """The loop thread delivers while another thread aborts: each stream's
    increments arrive in order, the aborted stream's terminal increment is
    never delivered (its callback left the map under the lock), and the
    survivor's tokens equal its lone run's."""
    lone = tiny_engine().generate(_prompt(0), _greedy(40)).token_ids
    eng = tiny_engine()
    outs: dict = {"keep": [], "drop": []}
    eng.start()
    try:
        eng.submit(_prompt(0), _greedy(40), rid="keep", on_output=outs["keep"].append)
        eng.submit(_prompt(1), _greedy(400), rid="drop", on_output=outs["drop"].append)
        deadline = time.monotonic() + 60
        while len(outs["drop"]) < 3 and time.monotonic() < deadline:
            time.sleep(0.001)
        t = threading.Thread(target=eng.abort, args=("drop",))
        t.start()
        t.join()
        while not (outs["keep"] and outs["keep"][-1].finished) and time.monotonic() < deadline:
            time.sleep(0.001)
        while eng.has_work() and time.monotonic() < deadline:
            time.sleep(0.001)
    finally:
        eng.stop()
    for rid in ("keep", "drop"):
        counts = [o.output_tokens for o in outs[rid]]
        assert counts == sorted(counts) and len(set(counts)) == len(counts), rid
    assert outs["keep"][-1].finished and not any(o.finished for o in outs["drop"])
    assert [t for o in outs["keep"] for t in o.new_token_ids] == lone
    assert len(outs["drop"]) >= 3 and outs["drop"][-1].output_tokens < 400
    assert eng.audit()["pending_callbacks"] == 0


# ---- the graph-family auditor on the CPU ----


@pytest.mark.parametrize("overlap", [True, False])
def test_steady_state_decode_is_audit_and_guard_clean(overlap):
    eng = tiny_engine(overlap)
    outs: dict = {}
    for i in range(2):
        eng.submit(_prompt(i), _greedy(48), rid=f"r{i}",
                   on_output=lambda o, i=i: outs.setdefault(i, []).append(o))
    for _ in range(6):  # warmup: prefill, the pipeline primed, every shape seen
        eng.step()
    eng.runner._programs.arm()
    with trg.steady_state_guard(device="cpu") as cc:
        for _ in range(8):
            eng.step()
    assert cc.count == 0 and cc.report == {"device": "cpu", "sync_debug_mode": None,
                                           "checked": False}
    report = trg.program_audit(eng)
    assert report["clean"] and report["recompiles"] == 0, report
    assert report["shared_inputs"] == {"k_cache": {"storages": 1, "programs": 1},
                                       "v_cache": {"storages": 1, "programs": 1}}
    [prog] = [p for p in report["programs"] if p["audited"]]
    assert prog["launches"] == 8 and prog["donate"] == ["k_cache", "v_cache"]
    assert eng.program_audit() == report
    while eng.scheduler.has_work():
        eng.step()
    assert {i: sum(len(o.new_token_ids) for o in v) for i, v in outs.items()} == {0: 48, 1: 48}


def test_batch_growth_names_the_key_field():
    """A second lane joins after arming: the B=2 family member's first
    launch carries provenance naming ``B`` (1 -> 2), the twin of the
    reference's ``test_recompile_provenance_names_the_argument``."""
    eng = tiny_engine(overlap=False, buckets=(1, 2, 4))
    outs: dict = {}
    eng.submit(_prompt(0), _greedy(30), rid="a", on_output=lambda o: outs.setdefault("a", []).append(o))
    for _ in range(4):
        eng.step()
    eng.runner._programs.arm()
    eng.step()
    eng.submit(_prompt(1), _greedy(8), rid="b", on_output=lambda o: outs.setdefault("b", []).append(o))
    _drive(eng, outs, ["a", "b"])
    report = eng.program_audit()
    changes = [c for p in report["programs"] for prov in p["provenance"] for c in prov["changed"]]
    assert {"arg": "B", "field": "key", "before": 1, "after": 2} in changes, changes
    assert report["recompiles"] >= 1 and report["clean"], report
    snap = eng.loads()["programs"]
    assert snap["armed"] and snap["recompiles"] == report["recompiles"]


def test_recapture_of_one_key_names_the_argument():
    auditor = trg.ProgramAuditor("cpu")

    def body(inputs):
        trg.note_capture()  # as GraphCache.run does when it captures
        return inputs["x"] * 2

    launch = auditor.wrap(("toy", 4), body, fields=("n",))
    auditor.arm()
    launch({"x": torch.ones(4)})
    launch({"x": torch.ones(8)})
    prog = auditor.audit()["programs"][0]
    assert prog["recompiles"] == 2
    first, second = prog["provenance"]
    assert first["changed"] == [{"arg": "<key>", "field": "new key", "before": None,
                                 "after": {"n": 4}}]
    assert {"arg": "[0]['x']", "field": "shape", "before": (4,), "after": (8,)} \
        in second["changed"]


def test_moved_storage_and_off_device_inputs_are_caught():
    auditor = trg.ProgramAuditor("cpu", shared=("kv",))
    a = auditor.wrap(("f", 1), lambda inputs: None, fields=("n",))
    b = auditor.wrap(("f", 2), lambda inputs: None, fields=("n",))
    kv = torch.zeros(4)
    auditor.arm()
    a({"kv": kv, "buf": torch.zeros(2)})
    a({"kv": kv, "buf": torch.zeros(2)})  # a fresh buffer: its storage moved
    b({"kv": torch.zeros(4), "buf": torch.empty(2, device="meta")})
    report = auditor.audit()
    assert not report["clean"]
    assert report["off_device_inputs"] == 1
    # one moved buffer in (f, 1), and the shared input in two storages
    assert report["storage_moves"] == 2
    assert report["shared_inputs"]["kv"] == {"storages": 2, "programs": 2}
    assert report["unexplained_captures"] == 0


def test_unexplained_recapture_makes_the_audit_unclean():
    auditor = trg.ProgramAuditor("cpu")
    x = torch.ones(3)
    launch = auditor.wrap(("g", 3), lambda inputs: trg.note_capture(), fields=("n",))
    auditor.arm()
    launch({"x": x})
    launch({"x": x})  # captured again with nothing changed
    report = auditor.audit()
    assert report["unexplained_captures"] == 1 and not report["clean"]
    assert report["programs"][0]["provenance"][1]["changed"] == [
        {"arg": "<none>", "field": "unknown", "before": None, "after": None}]


def test_unarmed_wrapper_records_nothing():
    auditor = trg.ProgramAuditor("cpu")
    launch = auditor.wrap(("idle", 3), lambda x: x + 1, fields=("n",))
    assert torch.equal(launch(torch.ones(3)), torch.full((3,), 2.0))
    report = auditor.audit()
    assert report["programs"][0]["audited"] is False and report["programs"][0]["launches"] == 0
    assert report["clean"]


def test_invalidate_graphs_forgets_their_records():
    eng = tiny_engine()
    eng.generate(_prompt(0), _greedy(4))
    keys = [p["key"] for p in eng.runner._programs.snapshot()["programs"]]
    assert keys and all(k.startswith("('decode'") for k in keys)
    eng.runner.invalidate_graphs("verify")  # no verify family here: nothing goes
    assert [p["key"] for p in eng.runner._programs.snapshot()["programs"]] == keys
    eng.runner.invalidate_graphs()
    assert eng.runner._programs.snapshot()["programs"] == []
    assert eng.runner.graphs.steps == {}
    assert eng.generate(_prompt(0), _greedy(4)).output_tokens == 4  # shapes come back
    assert eng.runner._programs.snapshot()["programs"]


def test_loads_programs_has_the_reference_snapshot_schema():
    import jax
    import jax.numpy as jnp

    ref = jrg.ProgramAuditor()
    launch = ref.wrap(("toy",), jax.jit(lambda x: x + 1))
    ref.arm()
    launch(jnp.ones((3,)))
    want = ref.snapshot()
    eng = tiny_engine()
    eng.generate(_prompt(0), _greedy(4))
    eng.runner._programs.arm()
    eng.generate(_prompt(1), _greedy(4))
    got = eng.loads()["programs"]
    assert set(got) == set(want)
    assert got["programs"] and all(set(p) == set(want["programs"][0])
                                   for p in got["programs"])
    assert {type(v) for p in got["programs"] for v in p.values()} <= {str, int, list, bool}


# ---- the host-sync guard and the capture budget on the CPU ----


def test_cpu_sync_guard_is_a_noop_that_reports_the_cpu():
    with trg.no_implicit_transfers("cpu") as report:
        assert torch.ones(2).sum().item() == 2.0
    assert report == {"device": "cpu", "sync_debug_mode": None, "checked": False}


def test_capture_budget_is_enforced():
    with pytest.raises(RuntimeError, match=r"captured 1 CUDA graph\(s\).*budget 0"):
        with trg.steady_state_guard(device="cpu"):
            trg.note_capture()
    with trg.steady_state_guard(max_captures=1, device="cpu") as cc:
        trg.note_capture()
    assert cc.count == 1


# ---- on the card ----


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the sync guard and CUDA graphs have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def card_engine(dev) -> Engine:
    return Engine(EngineConfig(
        model=tiny_test_config(),
        cache=CacheConfig(page_size=16, num_pages=200, auto_size=False, dtype="float32"),
        scheduler=SchedulerConfig(max_batch_size=4, max_seq_len=256, max_prefill_tokens=64,
                                  decode_batch_buckets=(4,), decode_horizon=4),
        decode_graphs=True), device=dev)


def _warm_lanes(eng, n_tokens: int = 200) -> dict:
    outs: dict = {}
    for i in range(4):
        eng.submit(_prompt(i), _greedy(n_tokens), rid=f"g{i}",
                   on_output=lambda o, i=i: outs.setdefault(i, []).append(o))
    # past the 8-page table's end: the 16-page shape is captured before arming
    while min((sum(len(o.new_token_ids) for o in outs.get(i, [])) for i in range(4)),
              default=0) < 120:
        eng.step()
    return outs


@pytest.mark.cuda
def test_graph_decode_under_the_guard_is_clean(cuda_dev):
    eng = card_engine(cuda_dev)
    outs = _warm_lanes(eng)
    failures = eng.scheduler.num_step_failures
    eng.runner._programs.arm()
    with trg.steady_state_guard(device=cuda_dev) as cc:
        for _ in range(8):
            eng.step()
    assert cc.count == 0 and cc.report["checked"] and cc.report["sync_debug_mode"] == "error"
    assert torch.cuda.get_sync_debug_mode() == 0  # restored
    assert eng.scheduler.num_step_failures == failures
    report = eng.program_audit()
    assert report["clean"] and report["recompiles"] == 0, report
    while eng.scheduler.has_work():
        eng.step()
    assert all(sum(len(o.new_token_ids) for o in v) == 200 for v in outs.values())


@pytest.mark.cuda
def test_item_under_the_guard_raises(cuda_dev):
    x = torch.ones(1, device=cuda_dev)
    with pytest.raises(RuntimeError, match=re.compile("synchroniz", re.I)):
        with trg.steady_state_guard(device=cuda_dev):
            x.item()
    assert x.item() == 1.0  # the mode is back off


@pytest.mark.cuda
def test_forced_recapture_trips_the_budget(cuda_dev):
    """A shape captured again with nothing changed trips the budget and
    leaves an unexplained capture; graphs invalidated through the runner
    are captured again, into a fresh pool, under new records."""
    eng = card_engine(cuda_dev)
    outs = _warm_lanes(eng)
    eng.runner._programs.arm()
    eng.step()
    # the old graphs stay referenced: a pool no graph holds is retired
    held = [step.graph for step in eng.runner.graphs.steps.values()]
    for step in eng.runner.graphs.steps.values():
        step.graph = None  # the next launch of each shape captures again
    failures = eng.scheduler.num_step_failures
    with pytest.raises(RuntimeError, match="budget 0"):
        with trg.steady_state_guard(device=cuda_dev):
            for _ in range(2):
                eng.step()
    assert eng.scheduler.num_step_failures == failures
    report = eng.program_audit()
    assert report["unexplained_captures"] >= 1 and not report["clean"], report
    del held
    eng.runner.invalidate_graphs()
    with trg.CaptureCounter() as cc:
        while eng.scheduler.has_work():
            eng.step()
    assert cc.count >= 1 and eng.runner.graphs.num_graphs >= 1
    assert all(sum(len(o.new_token_ids) for o in v) == 200 for v in outs.values())
    provenance = [p for prog in eng.program_audit()["programs"] for p in prog["provenance"]]
    assert provenance and all(p["changed"][0]["arg"] != "<none>" for p in provenance)
