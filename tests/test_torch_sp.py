"""Sequence parallelism of the port (``parallel/ring_attention.py``, the sp
axis of ``parallel/group.py`` and the runner's ring rule) held against the
JAX package's ring attention and sp engine on the CPU.

- (a) ``ring_attention`` against ``smg_tpu.parallel.ring_attention`` on
  seeded numpy q/k/v at sp=2 and sp=4 (rank threads over gloo), float32
  within 1e-5, and a chunk sp does not divide (padded) against dense causal
  attention;
- (b) a cold chunk's ``forward_prefill`` ringed over sp=2 against the JAX
  ``forward_prefill`` with its ``sp_mesh``: logits within 1e-5, the chunk's
  KV whole on every rank;
- (c) engines: the port's sp=4 rings its cold first chunk (read on the
  ``prefill_extend`` key, the reference's ``use_ring`` position) and its
  warm chunk takes the kernel, with streams equal to the reference's sp=4
  and single-device engines; sp=2 x tp=2 rings on each tp rank's heads;
  sp under pp=2 takes the dense path, as the reference does."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smg_tpu.engine import config as jconf
from smg_tpu.models import llama as jl
from smg_tpu.ops.rope import rope_frequencies
from smg_tpu.parallel.mesh import build_mesh
from smg_tpu.parallel.ring_attention import ring_attention as jax_ring
from smg_tpu_torch.engine import config as tconf
from smg_tpu_torch.models.convert import shards_from_jax
from smg_tpu_torch.models.llama import LlamaModel
from smg_tpu_torch.parallel.ring_attention import ring_attention
from test_pp_serving import _engine as jax_engine
from test_ring_attention import dense_causal
from test_torch_pp import (
    CHUNKED,
    TOL,
    jax_gen,
    port_engine,
    port_gen,
    port_model,
    run_grid,
    weights,  # noqa: F401 - the module's fixture
)

torch.set_num_threads(2)


def _qkv(seed, B=2, T=32, H=8, K=2, D=16):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, T, H, D), (B, T, K, D), (B, T, K, D)))


def _port_ring(q, k, v, scale, sp):
    t = [torch.from_numpy(a) for a in (q, k, v)]
    return run_grid({"sp": sp}, lambda r, g: ring_attention(*t, scale, g.axis("sp")).numpy())


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_attention_matches_the_reference(cpu_devices, sp):
    q, k, v = _qkv(sp)
    scale = 1.0 / np.sqrt(q.shape[-1])
    mesh = build_mesh(jconf.ParallelConfig(sp=sp), devices=cpu_devices[:sp])
    want = np.asarray(jax_ring(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mesh, scale))
    for got in _port_ring(q, k, v, scale, sp):
        np.testing.assert_allclose(got, want, **TOL)


def test_ring_attention_pads_a_chunk_sp_does_not_divide():
    q, k, v = _qkv(5, T=30)
    want = np.asarray(dense_causal(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.25))
    for got in _port_ring(q, k, v, 0.25, 4):
        np.testing.assert_allclose(got, want, **TOL)


def test_ringed_prefill_matches_the_reference(weights, cpu_devices):  # noqa: F811
    jcfg, jp, tree = weights
    cfg = port_model(jcfg)
    inv = jnp.asarray(rope_frequencies(jcfg.head_dim, jcfg.rope_theta, jcfg.rope_scaling))
    L, KD, PS, MP, P = jcfg.num_layers, jcfg.num_kv_heads * jcfg.head_dim, 16, 4, 12
    rng = np.random.default_rng(3)
    toks = rng.integers(1, jcfg.vocab_size, 48).astype(np.int32)
    pt = np.arange(2, 2 + MP, dtype=np.int32)
    kc = np.zeros((L, P, PS, KD), np.float32)
    mesh = build_mesh(jconf.ParallelConfig(sp=2), devices=cpu_devices[:2])
    lo, jk, _ = jl.forward_prefill(jp, jcfg, inv, jnp.asarray(toks), jnp.int32(0),
                                   jnp.int32(48), jnp.asarray(kc), jnp.asarray(kc),
                                   jnp.asarray(pt), sp_mesh=mesh)
    want, want_k = np.asarray(lo), np.asarray(jk)
    par = tconf.ParallelConfig(sp=2)
    shards = shards_from_jax(tree, cfg, par)
    i32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.int32)  # noqa: E731

    def rank(r, groups):
        rcfg, rp = shards[r]
        model = LlamaModel(rcfg, rp, sp=groups.axis("sp"))
        tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(kc.copy())
        out = model.forward_prefill(i32(toks), i32([0]), i32([48]), tk, tv, i32(pt), ring=True)
        return out.numpy(), tk.numpy()

    for got, got_k in run_grid({"sp": 2}, rank):
        np.testing.assert_allclose(got, want, **TOL)
        assert int(got.argmax()) == int(want.argmax())
        np.testing.assert_allclose(got_k, want_k, **TOL)


# ---- (c) engines ----

@pytest.fixture(scope="module")
def engines(weights):  # noqa: F811
    built = {"sp4": port_engine(weights[2], sp=4), "sp2_tp2": port_engine(weights[2], sp=2, tp=2),
             "pp2_sp2": port_engine(weights[2], pp=2, sp=2)}
    yield built
    for e in built.values():
        e.close()


@pytest.fixture(scope="module")
def reference_streams(cpu_devices):
    """The reference's single-device and sp=4 engines on the chunked prompt
    (``test_ring_attention.py::test_sp_serving_prefill_matches_single``)."""
    out = {}
    for name, par in (("single", jconf.ParallelConfig()),
                      ("sp4", jconf.ParallelConfig(sp=4))):
        je = jax_engine(par, cpu_devices[:par.world_size])
        try:
            out[name] = jax_gen(je, CHUNKED, 8)
        finally:
            je.stop()
    return out


def _rings(eng) -> dict:
    return {k[0]: k for k in eng.runner.prefill_keys}


@pytest.mark.parametrize("grid,ringed", [("sp4", True), ("sp2_tp2", True), ("pp2_sp2", False)])
def test_sp_streams_and_ring_keys(engines, reference_streams, grid, ringed):
    eng = engines[grid]
    eng.runner.prefill_keys.clear()
    got = port_gen(eng, CHUNKED, 8)
    want = reference_streams["sp4"]
    assert want.token_ids == reference_streams["single"].token_ids
    assert got.token_ids == want.token_ids and len(got.token_ids) == 8
    np.testing.assert_allclose(got.logprobs, want.logprobs, **TOL)
    keys = _rings(eng)
    # the cold 64-token chunk (bucket 64, sp divides it) rings unless under
    # pp; the warm 36-token chunk (bucket 64) extends the cache through the
    # kernel
    extend, final = keys["prefill_extend"], keys["prefill"]
    assert extend[:2] == ("prefill_extend", 64) and extend[5] is ringed
    assert extend[3] == ("ring" if ringed else "kernel")
    assert final[:2] == ("prefill", 64) and final[7] is False and final[3] == "kernel"
    assert [eng.runner.stats["ring_calls"]] == [int(ringed)]
    audit = eng.audit()
    assert audit["quiescent"] and audit["clean"] and audit["leaked_pages"] == 0
