"""Parity of the port's sharded training step on its larger grids and its
odd cases, with ``test_torch_train_mesh.py``'s criteria and helpers: ep2
(``tiny_moe_config``) and dp2 x tp2 x sp2 against the reference's step on
the same mesh; tp=4 over 2 KV heads with a vocabulary of 514 (both
replicated over groups of tp ranks, which the reference's training step
refuses: its rules table has no divisibility fallback) against the two
one-device steps; a sharded JAX state carried onto the port's mesh after
step 2 continuing to the reference's step 3; and the errors, with the
reference's words where it has them."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from smg_tpu.models.config import tiny_gemma2_config, tiny_moe_config, tiny_test_config
from smg_tpu.parallel.pipeline import pipeline_apply
from smg_tpu.parallel.sharding import ShardingRules
from smg_tpu_torch.models.convert import train_state_from_jax
from smg_tpu_torch.train import gather_state, make_train_step
from test_torch_train_mesh import (
    MOMENT_RTOL,
    REF_MESH_MOMENT_RTOL,
    Runs,
    batches,
    check_parity,
    close_metrics,
    close_state,
    jax_run,
    jax_state_as_port,
    jax_trainer,
    moment_errors,
    np_tree,
    port_config,
    port_run,
    port_trainer,
)

GRID = dict(dp=2, tp=2, sp=2)
MESHES = {"ep2": (tiny_moe_config, dict(ep=2)), "dp2_tp2_sp2": (tiny_test_config, GRID)}


@pytest.fixture(scope="module")
def runs(cpu_devices):
    r = Runs(cpu_devices)
    yield r
    r.close()


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_matches_the_reference(runs, mesh):
    check_parity(runs.get(mesh, *MESHES[mesh]), mesh)


def test_reference_ep_moments_drift_from_its_one_device(runs):
    """As ``test_torch_train_mesh``'s sp drift: the reference's ep=2 step
    leaves moments up to 1.8e-5 of their norm from its one-device step's;
    the port's ep=2 mesh stays within 1e-5 of it."""
    r = runs.get("ep2", *MESHES["ep2"])
    drift = max(moment_errors(r["ref"], r["ref_one"]).values())
    assert 1e-5 < drift < REF_MESH_MOMENT_RTOL, drift
    assert max(moment_errors(r["whole"], r["ref_one"]).values()) <= MOMENT_RTOL


def wide_vocab_config():
    return tiny_test_config(vocab_size=514)


def test_replicated_kv_heads_and_vocab_match_one_device(runs, cpu_devices):
    """tp=4 over 2 KV heads (each held by two ranks, its gradient summed
    over them) and a vocabulary tp does not divide (held whole by every
    rank): against the reference's one-device step and the port's."""
    jcfg = wide_vocab_config()
    start, want, ref_one = jax_run(jcfg, {}, cpu_devices)
    init, step = runs.trainer("tp4", wide_vocab_config, dict(tp=4))
    r = port_run(jcfg, init, step, start)
    for i, (got, w, one) in enumerate(zip(r["metrics"], want, r["metrics1"], strict=True)):
        close_metrics(got, w, f"tp4 step {i} against the reference's one device")
        close_metrics(got, one, f"tp4 step {i} against the port's one device")
    close_state(r["whole"], ref_one, "tp4 against the reference's one device")
    close_state(r["whole"], r["one"], "tp4 against the port's one device")
    with pytest.raises(ValueError):  # the reference's sharded step refuses both
        jax_run(jcfg, dict(tp=4), cpu_devices)


def test_jax_state_carries_onto_the_mesh(runs, cpu_devices):
    """The reference's dp2 x tp2 x sp2 run stopped after step 2 continues
    on the port's mesh of the same shape: its step 3 equals the
    reference's."""
    jcfg = tiny_test_config()
    jinit, jstep = jax_trainer(jcfg, GRID, cpu_devices)
    jstate = jinit(jax.random.PRNGKey(0))
    data = batches(jcfg.vocab_size, seed=40)
    for tokens, targets, mask in data[:2]:
        jstate, _ = jstep(jstate, jnp.asarray(tokens), jnp.asarray(targets),
                          jnp.asarray(mask))
    init, step = runs.trainer("dp2_tp2_sp2", *MESHES["dp2_tp2_sp2"])
    state = train_state_from_jax(np_tree(jstate), mesh=step)
    assert state.step == 2 and state.count == 2
    assert gather_state(state).opt_state.count == 2
    tokens, targets, mask = data[2]
    jstate, want = jstep(jstate, jnp.asarray(tokens), jnp.asarray(targets), jnp.asarray(mask))
    state, got = step(state, tokens, targets, mask)
    close_metrics(got, want, "carried step 3")
    close_state(gather_state(state), jax_state_as_port(jstate), "carried step 3",
                REF_MESH_MOMENT_RTOL)


def test_a_stale_state_raises(runs):
    init, step = runs.trainer("dp2_tp2_sp2", *MESHES["dp2_tp2_sp2"])
    state = init(seed=1)
    tokens, targets, mask = batches(512, n=1, seed=41)[0]
    nxt, _ = step(state, tokens, targets, mask)
    with pytest.raises(ValueError, match="consumes the state"):
        step(state, tokens, targets, mask)
    assert nxt.step == 1


# ---- the errors ----

def test_ring_under_softcap_raises_the_reference_error(cpu_devices):
    jcfg = tiny_gemma2_config()
    with pytest.raises(ValueError) as want:
        jax_trainer(jcfg, dict(sp=2), cpu_devices)
    for kw in (dict(mesh={"sp": 2}, devices=["cpu", "cpu"]), dict(use_ring_attention=True)):
        with pytest.raises(ValueError) as got:
            make_train_step(port_config(jcfg), device="cpu", **kw)
        assert str(got.value) == str(want.value)


def test_layers_pp_raises_the_pipeline_error(cpu_devices):
    """L % S: the reference's pipeline raises it; the port raises the same
    words before it starts a rank."""
    from smg_tpu.engine.config import ParallelConfig
    from smg_tpu.parallel.mesh import build_mesh

    jcfg = tiny_test_config()
    mesh = build_mesh(ParallelConfig(pp=3), devices=cpu_devices[:3])
    layers = {"w": jnp.zeros((jcfg.num_layers, 2))}
    with pytest.raises(ValueError) as want:
        pipeline_apply(lambda layer, x: x, layers, jnp.zeros((6, 4, 2)), mesh, 6)
    with pytest.raises(ValueError) as got:
        port_trainer(jcfg, dict(pp=3))
    assert str(got.value) == str(want.value) == "num_layers 4 not divisible by pp=3"


def test_uneven_batch_and_sequence_raise(runs, cpu_devices):
    """B % dp and T % sp: the reference's jit refuses unevenly sharded
    arguments (ValueError); so does the port, before any rank computes."""
    jcfg = tiny_test_config()
    init, step = runs.trainer("dp2_tp2_sp2", *MESHES["dp2_tp2_sp2"])
    jinit, jstep = jax_trainer(jcfg, GRID, cpu_devices)
    for b, t in ((3, 24), (4, 23)):
        tokens, targets, mask = batches(jcfg.vocab_size, n=1, b=b, t=t)[0]
        with pytest.raises(ValueError):
            jstep(jinit(jax.random.PRNGKey(0)), jnp.asarray(tokens), jnp.asarray(targets),
                  jnp.asarray(mask))
        state = init(seed=0)
        with pytest.raises(ValueError, match="not divisible by (dp|sp)=2"):
            step(state, tokens, targets, mask)
    state = init(seed=0)  # the mesh still works
    tokens, targets, mask = batches(jcfg.vocab_size, n=1)[0]
    assert np.isfinite(float(step(state, tokens, targets, mask)[1]["loss"]))


def test_unknown_axis_raises():
    for mesh in ({"data": 2}, {"tensor": 2}):
        with pytest.raises(ValueError, match="expected axis=N with axis in"):
            make_train_step(port_config(tiny_test_config()), device="cpu", mesh=mesh)


def test_custom_rules_raise_naming_9m():
    cfg = port_config(tiny_test_config())
    with pytest.raises(NotImplementedError, match="Queue A item 9m"):
        make_train_step(cfg, device="cpu", rules=ShardingRules(
            rules={**ShardingRules().rules, "ffn": None}))
    # the reference's default table (with layers -> pp or without) is taken
    for table in (ShardingRules(), ShardingRules(rules={**ShardingRules().rules,
                                                        "layers": "pp"})):
        init, step = make_train_step(cfg, device="cpu", rules=table)
        assert init(seed=0).step == 0


def test_a_mesh_without_devices_raises():
    with pytest.raises(RuntimeError, match="needs 2 devices, found 0"):
        make_train_step(port_config(tiny_test_config()), mesh={"tp": 2})


def test_close_leaves_no_rank(cpu_devices):
    init, step = port_trainer(tiny_test_config(), dict(dp=2, tp=2))
    pids = step.trainer.rank_pids()
    assert len(pids) == 3
    state = init(seed=0)
    tokens, targets, mask = batches(512, n=1)[0]
    step(state, tokens, targets, mask)
    step.close()
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
    with pytest.raises(RuntimeError, match="closed"):
        init(seed=0)


def test_a_failed_rank_fails_the_step(cpu_devices):
    """A follower that dies breaks the mesh: the next step raises, and so
    does every call after it."""
    init, step = port_trainer(tiny_test_config(), dict(dp=2))
    try:
        state = init(seed=0)
        step.trainer.procs[0].kill()
        step.trainer.procs[0].join(10)
        tokens, targets, mask = batches(512, n=1)[0]
        with pytest.raises(RuntimeError, match="exited"):
            step(state, tokens, targets, mask)
        with pytest.raises(RuntimeError, match="broken"):
            init(seed=0)
    finally:
        step.close()
