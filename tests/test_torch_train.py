"""Parity: the port's training path (``LlamaModel.forward_train``,
``smg_tpu_torch/train/step.py``, ``models/convert.py::train_state_from_jax``)
against the JAX package's ``forward_train`` and ``make_train_step`` on a
one-device mesh, weights bridged by ``params_from_jax``.

Tolerances (float32 on both sides): logits 1e-5 absolute; loss and
``grad_norm`` 1e-5 relative at every step; after three AdamW steps 99.9% of
each parameter tensor's elements within ``1e-3 * learning_rate`` plus 8
float32 ulps of their value (a norm weight near 1 rounds at 1.2e-7 a step)
and every element within ``learning_rate``, one step's move.  Adam moves an
element by ``lr * m / (sqrt(v) + 1e-8)``, so where the gradient itself is
about 1e-8 its rounding decides the move: on Gemma-2's ``w_gate`` the two
packages' gradients agree to 6e-8 against a largest of 0.058, yet one
element's is 9.5e-9 in JAX and 3.7e-9 here, and it moved 0.27 x lr apart.
The optimizer alone, on given gradients, is held to ``optax.adamw`` within
1e-4 of its updates (``test_adamw_matches_optax`` says why)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from smg_tpu.models import llama as jl
from smg_tpu.models.config import tiny_gemma2_config, tiny_moe_config, tiny_test_config
from smg_tpu.ops.rope import rope_frequencies
from smg_tpu.parallel.mesh import single_device_mesh
from smg_tpu.train.step import make_train_step as jax_make_train_step
from smg_tpu_torch.models.config import ModelConfig
from smg_tpu_torch.models.convert import params_from_jax, train_state_from_jax
from smg_tpu_torch.models.llama import LlamaModel
from smg_tpu_torch.train.step import adamw, make_train_step

torch.set_num_threads(2)
LOGIT_ATOL = 1e-5
METRIC_RTOL = 1e-5
LR = 1e-4  # make_train_step's default, both packages
PARAM_ATOL = LR
PARAM_FINE, PARAM_FINE_SHARE = 1e-3 * LR, 0.999
ULPS = 8 * float(np.finfo(np.float32).eps)
B, T = 2, 24

CONFIGS = {
    "llama": tiny_test_config(),
    "gemma2": tiny_gemma2_config(),
    "moe": tiny_moe_config(),
    "qwen3_qk_norm": dataclasses.replace(tiny_test_config(), qk_norm=True),
}


def port_config(jcfg) -> ModelConfig:
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items() if k in names})


def _inv(jcfg):
    return jnp.asarray(rope_frequencies(jcfg.head_dim, jcfg.rope_theta, jcfg.rope_scaling))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def _batch(vocab: int, seed: int):
    """tokens, pre-shifted targets and a loss mask with holes, [B, T]."""
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, vocab, (B, T + 1)).astype(np.int32)
    mask = (rng.random((B, T)) > 0.25).astype(np.int32)
    return seq[:, :-1], seq[:, 1:], mask


def _close_params(port: dict, jax_params) -> None:
    want = dict(_flat(params_from_jax(_np(jax_params))))
    for name, got in _flat(port):
        diff = (got.detach() - want[name]).abs()
        assert float(diff.max()) <= PARAM_ATOL, f"{name}: {float(diff.max())}"
        share = float((diff <= PARAM_FINE + ULPS * want[name].abs()).float().mean())
        assert share >= PARAM_FINE_SHARE, f"{name}: {share} within {PARAM_FINE}"


def _close_metrics(got: dict, want: dict, step: int) -> None:
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=METRIC_RTOL,
                                   err_msg=f"step {step} {key}")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_train_matches_jax(name):
    jcfg = CONFIGS[name]
    params = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    want = np.asarray(jl.forward_train(params, jcfg, _inv(jcfg), jnp.asarray(tokens)))
    model = LlamaModel(port_config(jcfg), params_from_jax(_np(params)))
    got = model.forward_train(torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and got.shape == (B, T, jcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_ATOL, rtol=0)


def test_window_error_matches_reference():
    """A windowed model refuses a training context past its window, with
    the reference's message (``tests/test_gemma.py``)."""
    jcfg = dataclasses.replace(tiny_gemma2_config(), sliding_window=4)
    params = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tokens = np.ones((1, 8), np.int32)
    with pytest.raises(ValueError, match="sliding_window") as want:
        jl.forward_train(params, jcfg, _inv(jcfg), jnp.asarray(tokens))
    model = LlamaModel(port_config(jcfg), params_from_jax(_np(params)))
    with pytest.raises(ValueError, match="sliding_window") as got:
        model.forward_train(torch.from_numpy(tokens))
    assert str(got.value) == str(want.value)
    assert model.forward_train(torch.ones((1, 4), dtype=torch.int32)).shape == (1, 4, 512)


@pytest.mark.parametrize("leg", ["prefill", "decode"])
def test_serving_forwards_match_forward_train(leg):
    """The reference's model tests (``tests/test_model.py``) on the port:
    the prefill's last logits and one decode step after it equal
    ``forward_train`` at those positions."""
    cfg = port_config(tiny_test_config())
    model = LlamaModel(cfg, params_from_jax(_np(jl.init_params(tiny_test_config(),
                                                               jax.random.PRNGKey(0)))))
    KD = cfg.num_kv_heads * cfg.head_dim
    kc = torch.zeros(cfg.num_layers, 32, 16, KD)
    vc = torch.zeros_like(kc)
    prompt = torch.arange(5, 15, dtype=torch.int32)
    table = torch.tensor([1, 2, 0, 0], dtype=torch.int32)
    i32 = lambda v: torch.tensor([v], dtype=torch.int32)  # noqa: E731
    logits = model.forward_prefill(prompt, i32(0), i32(10), kc, vc, table)
    seq = prompt
    if leg == "decode":
        tables = torch.stack([table, torch.zeros(4, dtype=torch.int32)])
        logits = model.forward_decode(torch.tensor([3, 0], dtype=torch.int32),
                                      torch.tensor([10, 0], dtype=torch.int32), kc, vc,
                                      tables)[0]
        seq = torch.cat([prompt, torch.tensor([3], dtype=torch.int32)])
    dense = model.forward_train(seq[None])[0, -1]
    np.testing.assert_allclose(logits.numpy(), dense.numpy(), atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_three_steps_match_optax(name):
    """Three steps of ``make_train_step`` against three of the reference's
    on a one-device mesh, from the same bridged weights and batches."""
    jcfg = CONFIGS[name]
    jinit, jstep = jax_make_train_step(jl, jcfg, _inv(jcfg), single_device_mesh())
    jstate = jinit(jax.random.PRNGKey(0))
    init, step = make_train_step(port_config(jcfg), device="cpu")
    state = init(params=params_from_jax(_np(jstate.params)))
    for i in range(3):
        tokens, targets, mask = _batch(jcfg.vocab_size, seed=10 + i)
        jstate, want = jstep(jstate, jnp.asarray(tokens), jnp.asarray(targets),
                             jnp.asarray(mask))
        state, got = step(state, tokens, targets, mask)
        _close_metrics(got, want, i)
    assert state.step == 3 and state.opt_state.count == 3
    _close_params(state.params, jstate.params)
    adam = jstate.opt_state[0]
    mu = dict(_flat(params_from_jax(_np(adam.mu))))
    for key, got in _flat(state.opt_state.mu):  # the first moments, at gradient scale
        np.testing.assert_allclose(got.numpy(), mu[key].numpy(), atol=1e-5, rtol=1e-3)
    assert all(not t.requires_grad for _, t in _flat(state.params))


def test_jax_state_carries_across():
    """A JAX run stopped after step 2 continues in the port: its step 3
    equals the JAX step 3."""
    jcfg = CONFIGS["llama"]
    jinit, jstep = jax_make_train_step(jl, jcfg, _inv(jcfg), single_device_mesh())
    jstate = jinit(jax.random.PRNGKey(0))
    batches = [_batch(jcfg.vocab_size, seed=20 + i) for i in range(3)]
    for tokens, targets, mask in batches[:2]:
        jstate, _ = jstep(jstate, jnp.asarray(tokens), jnp.asarray(targets),
                          jnp.asarray(mask))
    state = train_state_from_jax(_np(jstate))
    assert state.step == 2 and state.opt_state.count == 2
    _, step = make_train_step(port_config(jcfg), device="cpu")
    tokens, targets, mask = batches[2]
    jstate, want = jstep(jstate, jnp.asarray(tokens), jnp.asarray(targets),
                         jnp.asarray(mask))
    state, got = step(state, tokens, targets, mask)
    _close_metrics(got, want, 2)
    assert state.step == 3 and state.opt_state.count == 3
    _close_params(state.params, jstate.params)


@pytest.mark.parametrize("lr", [1e-4, 3e-2])
def test_adamw_matches_optax(lr):
    """The optimizer alone on fixed gradients (magnitudes 1e-9 to 1), three
    updates: b1, b2, eps, the decoupled weight decay of 1e-4 and the bias
    corrections.  optax rounds its bias corrections in float32 (``1 -
    0.999**t`` carries up to 3e-5 of relative rounding), torch takes them
    in double: each update may differ by 1e-4 of its ~``lr`` size, and the
    parameters by 4 float32 ulps.  At lr 3e-2 the decay (``lr * 1e-4 * p``
    a step, parameters near 1) is larger than that tolerance."""
    rng = np.random.default_rng(5)
    p0 = (1.0 + rng.standard_normal((64, 48))).astype(np.float32)
    grads = [(rng.standard_normal((64, 48)) * 10.0 ** rng.integers(-9, 1, (64, 48))
              ).astype(np.float32) for _ in range(3)]
    atol, rtol = 1e-4 * lr * len(grads), 4 * float(np.finfo(np.float32).eps)
    want = {}
    for name, tx in (("adamw", optax.adamw(lr)), ("adam", optax.adam(lr))):
        jp, jopt = jnp.asarray(p0), tx.init(jnp.asarray(p0))
        for g in grads:
            updates, jopt = tx.update(jnp.asarray(g), jopt, jp)
            jp = optax.apply_updates(jp, updates)
        want[name] = (np.asarray(jp), jopt[0])
    leaf = torch.from_numpy(p0.copy()).requires_grad_()
    mu, nu = torch.zeros_like(leaf.detach()), torch.zeros_like(leaf.detach())
    opt = adamw([leaf], [mu], [nu], 0, lr)
    for g in grads:
        leaf.grad = torch.from_numpy(g)
        opt.step()
    got = leaf.detach().numpy()
    jp, adam = want["adamw"]
    np.testing.assert_allclose(got, jp, rtol=rtol, atol=atol)
    np.testing.assert_allclose(mu.numpy(), np.asarray(adam.mu), rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(nu.numpy(), np.asarray(adam.nu), rtol=1e-5, atol=1e-24)
    if lr >= 1e-2:  # the decay shows: without it the parameters are elsewhere
        assert np.abs(got - want["adam"][0]).max() > 2 * atol


@pytest.mark.parametrize("kw", [
    {"mesh": {"data": 2}}, {"mesh": {"tensor": 2}}, {"mesh": {"sp": 2}},
    {"mesh": {"pp": 2}}, {"rules": object()}, {"use_ring_attention": True},
    {"num_microbatches": 2},
], ids=["dp", "tp", "sp", "pp", "rules", "ring", "microbatches"])
def test_sharding_arguments_raise(kw):
    """What the reference's mesh arguments do since the sharded step: an
    axis outside the reference's ``AXIS_ORDER`` ("data", "tensor") raises
    ValueError; a custom rules table raises naming its ROADMAP item (9m); a
    mesh of two devices raises without a device list ("needs 2 devices")
    and takes its step on two CPU ranks; ring attention and microbatches on
    one device take the step (the same attention; one pipeline stage)."""
    cfg = port_config(tiny_test_config())
    mesh = kw.get("mesh", {})
    if set(mesh) - {"sp", "pp"}:
        with pytest.raises(ValueError, match="expected axis=N"):
            make_train_step(cfg, device="cpu", **kw)
        return
    if "rules" in kw:
        with pytest.raises(NotImplementedError, match="Queue A item 9m"):
            make_train_step(cfg, device="cpu", **kw)
        return
    devices = None
    if mesh:
        with pytest.raises(RuntimeError, match="needs 2 devices, found 0"):
            make_train_step(cfg, **kw)
        devices = ["cpu", "cpu"]
    init, step = make_train_step(cfg, device="cpu", devices=devices, **kw)
    try:
        # four rows: pp's default of 2 x pp microbatches
        tokens, targets, mask = (np.concatenate([x, x]) for x in _batch(cfg.vocab_size, seed=9))
        state, m = step(init(seed=0), tokens, targets, mask)
        assert state.step == 1 and np.isfinite(float(m["loss"]))
    finally:
        step.close()


def test_one_device_mesh_is_accepted():
    init, _ = make_train_step(port_config(tiny_test_config()), device="cpu",
                              mesh=single_device_mesh(), use_ring_attention=False,
                              num_microbatches=1)
    state = init(seed=3)
    assert state.step == 0 and state.params["embed"].device.type == "cpu"
    assert float(state.opt_state.nu["layers"]["wq"].abs().sum()) == 0.0
