"""The training pipeline of the port (``parallel/pipeline.py`` under
``make_train_step(mesh={"pp": ...})``) against the reference's microbatch
pipeline (``smg_tpu/parallel/pipeline.py`` inside its ``make_train_step``)
on the same mesh, with ``test_torch_train_mesh.py``'s criteria: pp=2 with
M=2 and with the reference's default M = 2 x pp = 4, pp=2 x tp=2, and a
tied embedding held on both stages (its gradient summed over them).  The
reference's own test compares only ``wq`` after one step
(``tests/test_parallel.py``); these compare every leaf of params, ``mu``
and ``nu`` after three.  Then the schedule's errors, with the reference's
words."""

import dataclasses

import numpy as np
import pytest

from smg_tpu.models.config import tiny_test_config
from smg_tpu_torch.parallel.pipeline import local_microbatches
from test_torch_train_mesh import Runs, batches, check_parity, port_trainer


def tied_config():
    return dataclasses.replace(tiny_test_config(), tie_word_embeddings=True)


MESHES = {
    "pp2_m2": (tiny_test_config, dict(pp=2), dict(num_microbatches=2)),
    "pp2_m4": (tiny_test_config, dict(pp=2), {}),
    "pp2_tp2": (tiny_test_config, dict(pp=2, tp=2), {}),
    "pp2_tied": (tied_config, dict(pp=2), {}),
}


@pytest.fixture(scope="module")
def runs(cpu_devices):
    r = Runs(cpu_devices)
    yield r
    r.close()


@pytest.mark.parametrize("mesh", list(MESHES))
def test_pipeline_matches_the_reference(runs, mesh):
    make_cfg, sizes, kw = MESHES[mesh]
    check_parity(runs.get(mesh, make_cfg, sizes, **kw), mesh)


def test_default_microbatches_are_twice_pp(runs):
    _, step = runs.trainer("pp2_m4", *MESHES["pp2_m4"][:2])
    assert step.trainer.microbatches == 4


def test_batch_microbatches_raises_the_reference_error(runs, cpu_devices):
    """B % M: the reference's pipeline raises at its step's trace; the port
    at the step, before any rank computes, in the same words."""
    import jax
    import jax.numpy as jnp

    from test_torch_train_mesh import jax_trainer

    jcfg = tiny_test_config()
    tokens, targets, mask = batches(jcfg.vocab_size, n=1, b=6)[0]
    jinit, jstep = jax_trainer(jcfg, dict(pp=2), cpu_devices)
    with pytest.raises(ValueError) as want:
        jstep(jinit(jax.random.PRNGKey(0)), jnp.asarray(tokens), jnp.asarray(targets),
              jnp.asarray(mask))
    init, step = runs.trainer("pp2_m4", *MESHES["pp2_m4"][:2])
    state = init(seed=0)
    with pytest.raises(ValueError) as got:
        step(state, tokens, targets, mask)
    assert str(got.value) == str(want.value) == "batch 6 not divisible by num_microbatches 4"
    tokens, targets, mask = batches(jcfg.vocab_size, n=1)[0]  # the mesh still works
    assert np.isfinite(float(step(state, tokens, targets, mask)[1]["loss"]))


@pytest.mark.parametrize("batch,rows,m,want", [
    (8, 8, 4, 4),  # one dp rank: every microbatch
    (8, 4, 4, 2),  # dp=2: its two of the four
    (4, 2, 4, 2),  # dp=2, one row a microbatch
    (8, 4, 2, 1),  # dp=2: a microbatch is its rows
    (6, 2, 2, 1),  # dp=3: a microbatch spans two ranks' rows
])
def test_local_microbatches(batch, rows, m, want):
    assert local_microbatches(batch, rows, m) == want


@pytest.mark.parametrize("sizes,kw", [(dict(pp=2, dp=2), {}),
                                      (dict(sp=2), dict(use_ring_attention=False))],
                         ids=["pp2_dp2", "sp2_gathered"])
def test_meshes_match_the_one_device_step(sizes, kw):
    """pp=2 x dp=2 with M=4 on B=4 (each dp rank runs its two rows as two
    microbatches), and sp=2 with the ring off (each rank's queries attend
    over every rank's keys and values, gathered): the loss and
    ``grad_norm`` of two steps are the one-device step's."""
    from smg_tpu_torch.train import make_train_step
    from test_torch_train_mesh import close_metrics, port_config

    jcfg = tiny_test_config()
    init, step = port_trainer(jcfg, sizes, **kw)
    try:
        init1, step1 = make_train_step(port_config(jcfg), device="cpu")
        state, one = init(seed=0), init1(seed=0)
        for tokens, targets, mask in batches(jcfg.vocab_size, n=2):
            state, got = step(state, tokens, targets, mask)
            one, want = step1(one, tokens, targets, mask)
            close_metrics(got, want, str(sizes))
    finally:
        step.close()
