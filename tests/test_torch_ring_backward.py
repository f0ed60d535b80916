"""The training ring's backward (``parallel/ring_attention.py::
ring_attention_train``) against ``jax.grad`` of the reference's
``ring_attention`` on an sp mesh of the 8-device CPU mesh, and against the
port's dense ``causal_attention`` under autograd, at sp = 2 and 4: seeded
numpy q, k, v and output gradient, each sp rank a thread over gloo holding
its shard; the output and the three gradients within 1e-5 (float32).  Also
the dense path a mesh takes under sp without the ring: keys and values
gathered from every rank (``gather_summed``), the gradient summed back; and
the conjugate pairs of ``parallel/autograd.py`` (a tp-split two-layer
product through ``copy_to``, ``reduce_from`` and ``gather_from``) against
the same product on one rank."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smg_tpu.engine.config import ParallelConfig
from smg_tpu.parallel.mesh import build_mesh
from smg_tpu.parallel.ring_attention import ring_attention as jax_ring
from smg_tpu_torch.models.llama import causal_attention
from smg_tpu_torch.parallel.autograd import copy_to, gather_from, gather_summed, reduce_from
from smg_tpu_torch.parallel.ring_attention import ring_attention_train
from test_torch_pp import run_grid

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)
SCALE = 0.25


def _inputs(seed, B=2, T=32, H=8, K=2, D=16):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, T, H, D), (B, T, K, D), (B, T, K, D), (B, T, H, D)))


def _shards(sp: int, attend):
    """Each sp rank's output and gradients of its shard of ``_inputs``
    through ``attend(q, k, v, group)``, concatenated back along T."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(7))
    Tl = q.shape[1] // sp

    def rank(r, groups):
        s = slice(r * Tl, (r + 1) * Tl)
        x = [t[:, s].clone().requires_grad_() for t in (q, k, v)]
        out = attend(*x, groups.axis("sp"), r * Tl)
        out.backward(do[:, s])
        return [out.detach()] + [t.grad for t in x]

    parts = run_grid({"sp": sp}, rank)
    return [torch.cat([p[i] for p in parts], dim=1).numpy() for i in range(4)]


def _reference(cpu_devices, sp: int):
    q, k, v, do = (jnp.asarray(a) for a in _inputs(7))
    mesh = build_mesh(ParallelConfig(sp=sp), devices=cpu_devices[:sp])
    out, vjp = jax.vjp(lambda q, k, v: jax_ring(q, k, v, mesh, SCALE), q, k, v)
    return [np.asarray(x) for x in (out, *vjp(do))]


def _dense():
    q, k, v, do = (torch.from_numpy(a).clone() for a in _inputs(7))
    x = [t.requires_grad_() for t in (q, k, v)]
    out = causal_attention(*x, torch.full((q.shape[0],), q.shape[1]), SCALE)
    out.backward(do)
    return [out.detach().numpy()] + [t.grad.numpy() for t in x]


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_backward_matches_jax_grad(cpu_devices, sp):
    got = _shards(sp, lambda q, k, v, g, q0: ring_attention_train(q, k, v, SCALE, g))
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, _reference(cpu_devices, sp),
                          strict=True):
        np.testing.assert_allclose(a, b, err_msg=name, **TOL)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, _dense(), strict=True):
        np.testing.assert_allclose(a, b, err_msg=f"{name} against dense", **TOL)


@pytest.mark.parametrize("sp", [2, 4])
def test_gathered_keys_backward_matches_dense(sp):
    def gathered(q, k, v, g, q0):
        k, v = gather_summed(g, k, dim=1), gather_summed(g, v, dim=1)
        return causal_attention(q, k, v, torch.full((q.shape[0],), k.shape[1]), SCALE, q0=q0)

    for name, a, b in zip(("out", "dq", "dk", "dv"), _shards(sp, gathered), _dense(),
                          strict=True):
        np.testing.assert_allclose(a, b, err_msg=name, **TOL)


@pytest.mark.parametrize("tp", [2, 4])
def test_conjugate_pairs_match_one_rank(tp):
    """``y = gelu(x A) B`` with A split by columns and B by rows over tp
    (``copy_to`` before, ``reduce_from`` after), then ``z = y C`` with C
    split by columns, gathered (``gather_from``): the output and the
    gradients of x, A, B and C against the unsplit product."""
    rng = np.random.default_rng(3)
    x, a, b, c = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                  for s in ((4, 8), (8, 16), (16, 8), (8, 12)))
    dz = torch.from_numpy(rng.standard_normal((4, 12)).astype(np.float32))

    def run(x, a, b, c, group):
        h = torch.nn.functional.gelu(copy_to(group, x) @ a)
        y = reduce_from(group, h @ b)
        return gather_from(group, copy_to(group, y) @ c)

    whole = [t.clone().requires_grad_() for t in (x, a, b, c)]
    want = run(*whole, None)
    want.backward(dz)

    def rank(r, groups):
        cols = lambda t: t[:, r * t.shape[1] // tp:(r + 1) * t.shape[1] // tp]  # noqa: E731
        rows = b[r * 16 // tp:(r + 1) * 16 // tp]
        mine = [t.clone().requires_grad_() for t in (x, cols(a), rows, cols(c))]
        out = run(*mine, groups.axis("tp"))
        out.backward(dz)
        return out.detach(), [t.grad for t in mine]

    parts = run_grid({"tp": tp}, rank)
    for out, _ in parts:
        np.testing.assert_allclose(out.numpy(), want.detach().numpy(), **TOL)
    np.testing.assert_allclose(parts[0][1][0].numpy(), whole[0].grad.numpy(), **TOL)
    for i, dim in ((1, 1), (2, 0), (3, 1)):
        got = torch.cat([p[1][i] for p in parts], dim=dim)
        np.testing.assert_allclose(got.numpy(), whole[i].grad.numpy(), **TOL)
