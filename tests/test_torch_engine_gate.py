"""The engine gate on the port: ``benches/bench_engine.py`` scenarios 1-3
driven through the port's ``Engine`` with the background loop
(``start()``), output callbacks from the loop thread and ``flush_cache``,
on weights bridged from the same JAX seed.  Scenario 3 runs through a
speculative engine (``speculative=True, spec_max_draft=6``) as the bench's
does, then the bench's gate jobs: every stream equals its non-speculative
twin's, and the drafted and accepted counts equal the bench's and lie in
its band.  The digest of every generated token id must equal the bench's
``stream_fingerprint`` on this tree."""

import functools
import hashlib
import time

import numpy as np
import torch

import jax
from smg_tpu.models.config import tiny_test_config
from smg_tpu.models.registry import get_model
from smg_tpu_torch.engine.config import CacheConfig, EngineConfig, SchedulerConfig
from smg_tpu_torch.engine.engine import Engine
from smg_tpu_torch.models.config import tiny_test_config as port_tiny
from smg_tpu_torch.models.convert import params_from_jax
from smg_tpu_torch.protocols.sampling import SamplingParams

torch.set_num_threads(2)
# ``JAX_PLATFORMS=cpu python benches/bench_engine.py`` on this tree
STREAM_FINGERPRINT = "86da56177bf83b94"
# the bench's spec gate on this tree: drafted and accepted tokens over
# scenario 3 and the gate jobs
SPEC_DRAFTED, SPEC_ACCEPTED = 94, 46


def gate_engine(params, **sched) -> Engine:
    return Engine(EngineConfig(
        model=port_tiny(),
        cache=CacheConfig(page_size=16, num_pages=256, auto_size=False, dtype="float32"),
        scheduler=SchedulerConfig(max_batch_size=4, max_seq_len=256, max_prefill_tokens=64,
                                  decode_batch_buckets=(4,), **sched),
        seed=0), params=params, device="cpu")


def greedy(n: int) -> SamplingParams:
    return SamplingParams(temperature=0.0, max_new_tokens=n, ignore_eos=True)


def test_engine_gate_reproduces_the_stream_fingerprint():
    cfg = tiny_test_config()
    # the JAX engine's own weight init (``ModelRunner``: jit of init_params)
    jparams = jax.jit(functools.partial(get_model(cfg.arch).init_params, cfg))(
        jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    fingerprint = hashlib.blake2b(digest_size=8)
    eng = gate_engine(params, decode_horizon=4)
    spec = gate_engine(params, speculative=True, spec_max_draft=6)
    twin = gate_engine(params)  # scenario 3's non-speculative twin
    eng.start()
    spec.start()
    twin.start()
    try:
        # scenario 1: batched greedy decode
        prompts = [[(7 * i + j) % 400 + 5 for j in range(48)] for i in range(4)]
        r = eng.generate(prompts[0], greedy(8), timeout_secs=120)
        fingerprint.update(bytes(str(r.token_ids), "utf8"))
        assert eng.flush_cache()
        done: dict[int, list] = {}
        for i, p in enumerate(prompts):
            eng.submit(p, greedy(24), rid=f"d{i}",
                       on_output=lambda o, i=i: done.setdefault(i, []).append(o))
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and not (
                len(done) == 4 and all(v[-1].finished for v in done.values())):
            time.sleep(0.005)
        assert len(done) == 4 and all(v[-1].finished for v in done.values()), done
        for i in sorted(done):
            ids = [t for o in done[i] for t in o.new_token_ids]
            assert len(ids) == 24
            fingerprint.update(bytes(str(ids), "utf8"))
        # scenario 2: a 64-token prompt on a flushed cache, twice
        p64 = [(11 * j) % 400 + 5 for j in range(64)]
        for _ in range(2):
            assert eng.flush_cache()
            r = eng.generate(p64, greedy(1), timeout_secs=120)
            assert r.cached_tokens == 0
        fingerprint.update(bytes(str(r.token_ids), "utf8"))
        # scenario 3: the repetitive prompt, speculative, and its twin
        rep = [5, 6, 7, 8] * 8
        r = spec.generate(rep, greedy(24), timeout_secs=120)
        fingerprint.update(bytes(str(r.token_ids), "utf8"))
        assert r.token_ids == twin.generate(rep, greedy(24), timeout_secs=120).token_ids
        # the bench's drafter-correctness jobs
        for p in (rep, [9] * 8, list(range(40, 70)) + [5, 6, 7, 8] * 4):
            rs = spec.generate(p, greedy(32), timeout_secs=120)
            assert rs.token_ids == twin.generate(p, greedy(32), timeout_secs=120).token_ids
    finally:
        eng.stop()
        spec.stop()
        twin.stop()
    drafted = spec.scheduler.num_spec_drafted
    accepted = spec.scheduler.num_spec_accepted
    assert (drafted, accepted) == (SPEC_DRAFTED, SPEC_ACCEPTED)
    assert drafted >= 24 and 0.05 <= accepted / drafted <= 1.0  # the bench's band
    for e in (eng, spec, twin):
        audit = e.audit()
        assert audit["clean"] and audit["quiescent"], audit
    assert fingerprint.hexdigest() == STREAM_FINGERPRINT
