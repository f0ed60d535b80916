"""Parity: the port's sharded training step (``make_train_step(mesh=...)``:
``train/leader.py``, ``train/step.py::RankTrainer``, the differentiable
collectives of ``parallel/autograd.py``, the training ring and
``parallel/sharding.py::train_rules``) against the JAX package's
``make_train_step`` on the same mesh of the 8-device CPU mesh, from the same
bridged weights and seeded batches, gloo rank processes on the CPU.

Each mesh takes three steps on both sides:

- loss and ``grad_norm`` within 1e-5 relative at every step, against the
  reference and against the port's one-device step from the same weights;
- after the third step every leaf of the whole state (``gather_state``):
  params within ``test_torch_train.py``'s criteria (every element within one
  learning rate, 99.9% within 1e-3 of it plus 8 float32 ulps; Adam hides a
  gradient's scale, so the moments are checked too), ``mu`` and ``nu`` each
  within 1e-5 of their leaf's norm (the norm of the difference) against the
  reference's one-device step and the port's, and within 1e-4 against the
  reference's own sharded step, which drifts from its one-device step by up
  to 1.8e-5 (sp and ep; a test of its own shows it): a missing, doubled or
  halved gradient sum shows there, at 0.1 or 0.01 of the leaf;
- the norms ``leaf_norms`` assembles from the ranks' sums of squares equal
  the gathered tree's within 1e-5 (float32 norms of the pieces).

This file holds dp2, tp2 and sp2; ``test_torch_train_grid.py`` holds ep2
(``tiny_moe_config``), dp2 x tp2 x sp2, a carried state and the errors,
``test_torch_pipeline.py`` the pp meshes.  Each mesh's runs are made once,
over one set of rank processes a mesh that the module's fixture starts
and closes."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smg_tpu.engine.config import ParallelConfig
from smg_tpu.models import llama as jl
from smg_tpu.models.config import tiny_moe_config, tiny_test_config
from smg_tpu.ops.rope import rope_frequencies
from smg_tpu.parallel.mesh import build_mesh
from smg_tpu.train.step import make_train_step as jax_make_train_step
from smg_tpu_torch.models.config import ModelConfig
from smg_tpu_torch.models.convert import params_from_jax, train_state_from_jax
from smg_tpu_torch.train import gather_state, leaf_norms, make_train_step

torch.set_num_threads(2)
LR = 1e-4
METRIC_RTOL = 1e-5
MOMENT_RTOL = 1e-5
#: the reference's own sp and ep steps drift up to 1.8e-5 of a moment's norm
#: from its one-device step (``test_reference_*_moments_drift``): the port's
#: mesh is held to it at ten times 1e-5, and to both one-device steps at 1e-5
REF_MESH_MOMENT_RTOL = 1e-4
PARAM_FINE, PARAM_FINE_SHARE = 1e-3 * LR, 0.999
ULPS = 8 * float(np.finfo(np.float32).eps)
B, T, STEPS = 4, 24, 3


def port_config(jcfg) -> ModelConfig:
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items() if k in names})


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def batches(vocab: int, n: int = STEPS, seed: int = 30, b: int = B, t: int = T):
    """``n`` batches of tokens, pre-shifted targets and a loss mask with
    holes, [b, t]."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        seq = rng.integers(0, vocab, (b, t + 1)).astype(np.int32)
        out.append((seq[:, :-1], seq[:, 1:], (rng.random((b, t)) > 0.25).astype(np.int32)))
    return out


def jax_trainer(jcfg, sizes: dict, cpu_devices, **kw):
    par = ParallelConfig(**sizes)
    inv = jnp.asarray(rope_frequencies(jcfg.head_dim, jcfg.rope_theta, jcfg.rope_scaling))
    mesh = build_mesh(par, devices=cpu_devices[:par.world_size])
    return jax_make_train_step(jl, jcfg, inv, mesh, **kw)


def port_trainer(jcfg, sizes: dict, **kw):
    n = int(np.prod(list(sizes.values())))
    return make_train_step(port_config(jcfg), device="cpu", mesh=sizes,
                           devices=["cpu"] * n, **kw)


def close_metrics(got: dict, want: dict, what: str) -> None:
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=METRIC_RTOL,
                                   err_msg=f"{what} {key}")


def moment_errors(got, want) -> dict[str, float]:
    """For every leaf of ``mu`` and ``nu``: the norm of the difference of
    two host ``TrainState``s' over the norm of ``want``'s."""
    out = {}
    for t in ("mu", "nu"):
        w = dict(flat(getattr(want.opt_state, t)))
        for name, g in flat(getattr(got.opt_state, t)):
            ref = w[name].double()
            out[f"{t}.{name}"] = float((g.double() - ref).norm() / ref.norm().clamp(min=1e-30))
    return out


def close_state(got, want, what: str, moment_rtol: float = MOMENT_RTOL) -> None:
    """Every leaf of two port ``TrainState``s on the host: params by
    element, moments by their leaf's norm."""
    assert got.step == want.step and got.opt_state.count == want.opt_state.count
    w = dict(flat(want.params))
    assert sorted(w) == sorted(dict(flat(got.params)))
    for name, g in flat(got.params):
        diff = (g - w[name]).abs()
        assert float(diff.max()) <= LR, f"{what} params.{name}: {float(diff.max())}"
        share = float((diff <= PARAM_FINE + ULPS * w[name].abs()).float().mean())
        assert share >= PARAM_FINE_SHARE, f"{what} params.{name}: {share} within {PARAM_FINE}"
    for name, err in moment_errors(got, want).items():
        assert err <= moment_rtol, f"{what} {name}: {err} of its norm"


def jax_state_as_port(jstate):
    return train_state_from_jax(np_tree(jstate))


def jax_run(jcfg, sizes: dict, cpu_devices, **kw):
    """The reference's initial weights and its state after ``STEPS``
    steps on ``sizes``, with its metrics."""
    jinit, jstep = jax_trainer(jcfg, sizes, cpu_devices, **kw)
    jstate = jinit(jax.random.PRNGKey(0))
    start = params_from_jax(np_tree(jstate.params))
    metrics = []
    for tokens, targets, mask in batches(jcfg.vocab_size):
        jstate, m = jstep(jstate, jnp.asarray(tokens), jnp.asarray(targets),
                          jnp.asarray(mask))
        metrics.append({k: float(v) for k, v in m.items()})
    return start, metrics, jax_state_as_port(jstate)


def port_run(jcfg, init, step, start: dict):
    """The port's mesh (``init``/``step``) and its one device from
    ``start``: their metrics at every step, the mesh's whole state and leaf
    norms, the one device's state."""
    init1, step1 = make_train_step(port_config(jcfg), device="cpu")
    state, one = init(params=start), init1(params=start)
    metrics, metrics1 = [], []
    for tokens, targets, mask in batches(jcfg.vocab_size):
        state, got = step(state, tokens, targets, mask)
        one, got1 = step1(one, tokens, targets, mask)
        assert got["loss"].device.type == "cpu" and got["loss"].dtype == torch.float32
        metrics.append({k: float(v) for k, v in got.items()})
        metrics1.append({k: float(v) for k, v in got1.items()})
    assert state.step == STEPS and state.count == STEPS
    return dict(metrics=metrics, metrics1=metrics1, whole=gather_state(state),
                norms=leaf_norms(state), one=gather_state(one))


class Runs:
    """Each mesh's runs, made once for a module's tests (``get``), over one
    port trainer a mesh (``trainer``: its rank processes live until
    ``close``); the reference's one device once a config."""

    def __init__(self, cpu_devices):
        self.cpu_devices = cpu_devices
        self.memo, self.trainers = {}, {}

    def trainer(self, name: str, make_cfg, sizes: dict, **kw):
        if name not in self.trainers:
            self.trainers[name] = port_trainer(make_cfg(), sizes, **kw)
        return self.trainers[name]

    def get(self, name: str, make_cfg, sizes: dict, **kw) -> dict:
        if name not in self.memo:
            jcfg = make_cfg()
            one_key = ("one", make_cfg.__name__)
            if one_key not in self.memo:
                self.memo[one_key] = jax_run(jcfg, {}, self.cpu_devices)
            start, want, jstate = jax_run(jcfg, sizes, self.cpu_devices, **kw)
            init, step = self.trainer(name, make_cfg, sizes, **kw)
            self.memo[name] = dict(ref_metrics=want, ref=jstate, ref_one=self.memo[one_key][2],
                                   **port_run(jcfg, init, step, start))
        return self.memo[name]

    def close(self) -> None:
        for _, step in self.trainers.values():
            step.close()


@pytest.fixture(scope="module")
def runs(cpu_devices):
    r = Runs(cpu_devices)
    yield r
    r.close()


def check_parity(r: dict, what: str) -> None:
    """Every comparison of the module docstring on one mesh's runs."""
    for i, (got, want, one) in enumerate(zip(r["metrics"], r["ref_metrics"], r["metrics1"],
                                             strict=True)):
        close_metrics(got, want, f"{what} step {i} against the reference")
        close_metrics(got, one, f"{what} step {i} against one device")
    whole = r["whole"]
    close_state(whole, r["ref"], f"{what} against the reference", REF_MESH_MOMENT_RTOL)
    close_state(whole, r["ref_one"], f"{what} against the reference's one device")
    close_state(whole, r["one"], f"{what} against the port's one device")
    gathered = leaf_norms(whole)
    assert sorted(r["norms"]) == sorted(gathered)
    for k, v in gathered.items():
        assert abs(r["norms"][k] - v) <= 1e-5 * max(v, 1e-30), (k, r["norms"][k], v)


MESHES = {"dp2": (tiny_test_config, dict(dp=2)), "tp2": (tiny_test_config, dict(tp=2)),
          "sp2": (tiny_test_config, dict(sp=2))}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_matches_the_reference(runs, mesh):
    check_parity(runs.get(mesh, *MESHES[mesh]), mesh)


def test_reference_sp_moments_drift_from_its_one_device(runs):
    """The reference's own sp=2 step leaves moments 1e-5 to 1e-4 of their
    norm away from its one-device step's (float32 sums in another order),
    where the port's sp=2 mesh stays within 1e-5 of both one-device steps
    (ROADMAP, reference-side notes)."""
    r = runs.get("sp2", *MESHES["sp2"])
    drift = max(moment_errors(r["ref"], r["ref_one"]).values())
    assert 1e-5 < drift < REF_MESH_MOMENT_RTOL, drift
    assert max(moment_errors(r["whole"], r["ref_one"]).values()) <= MOMENT_RTOL


def test_a_rank_pool_serves_meshes_in_turn():
    """``RankPool``: its processes serve tp2, then dp2 x tp2, then pp2 as
    followers (the same pids), each mesh's step equal to the one-device
    step; a second mesh while one holds the pool raises; ``close`` leaves
    no process."""
    import os

    from smg_tpu_torch.train import RankPool

    cfg = port_config(tiny_test_config())
    tokens, targets, mask = batches(cfg.vocab_size, n=1)[0]
    init1, step1 = make_train_step(cfg, device="cpu")
    _, want = step1(init1(seed=0), tokens, targets, mask)
    pool = RankPool(3)
    try:
        for sizes in (dict(tp=2), dict(dp=2, tp=2), dict(pp=2)):
            n = int(np.prod(list(sizes.values())))
            init, step = make_train_step(cfg, device="cpu", mesh=sizes, devices=["cpu"] * n,
                                         ranks=pool)
            try:
                assert [p.pid for p in step.trainer.procs] == pool.pids()[:n - 1]
                with pytest.raises(RuntimeError, match="one training mesh at a time"):
                    make_train_step(cfg, device="cpu", mesh=sizes, devices=["cpu"] * n,
                                    ranks=pool)
                _, got = step(init(seed=0), tokens, targets, mask)
                close_metrics(got, want, f"{sizes} from the pool")
            finally:
                step.close()
    finally:
        pool.close()
    for pid in pool.pids():
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
