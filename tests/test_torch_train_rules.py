"""Parity of the port's sharded training step on the weights whose
gradient rules (``parallel/sharding.py::train_rules``) the plain tiny
configs never reach, with ``test_torch_train_mesh.py``'s criteria against
the reference's step on the same mesh:

- tp=2 on a dense config with q/k norms: each tp rank applies them to its
  own heads, so their gradients are summed over tp;
- Gemma-2 (``tiny_gemma2_config``: post norms, scaled embeddings, a final
  logit softcap under the vocab-parallel loss, a tied embedding) at tp=2,
  and at pp=2, where the tied embedding is held on the first stage and the
  last.  The attention softcap keeps the ring off, as the reference's step
  requires."""

import dataclasses

import pytest

from smg_tpu.models.config import tiny_gemma2_config, tiny_test_config
from test_torch_train_mesh import Runs, check_parity


def qk_norm_config():
    return dataclasses.replace(tiny_test_config(), qk_norm=True)


MESHES = {
    "qk_norm_tp2": (qk_norm_config, dict(tp=2)),
    "gemma2_tp2": (tiny_gemma2_config, dict(tp=2)),
    "gemma2_pp2": (tiny_gemma2_config, dict(pp=2)),
}


@pytest.fixture(scope="module")
def runs(cpu_devices):
    r = Runs(cpu_devices)
    yield r
    r.close()


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_matches_the_reference(runs, mesh):
    check_parity(runs.get(mesh, *MESHES[mesh]), mesh)


def test_the_rules_these_meshes_reach():
    """The rules the cases above hold: q/k norms and Gemma-2's post norms
    replicated over tp, the q/k norms' gradients summed over it; the tied
    embedding summed over pp."""
    from smg_tpu_torch.parallel.sharding import train_rules
    from test_torch_train_mesh import port_config

    qk = train_rules(port_config(qk_norm_config()), dict(tp=2))
    for key in ("q_norm", "k_norm"):
        assert qk[f"layers.{key}"].summed == ("tp",) and qk[f"layers.{key}"].tp_share == 2
    gemma = port_config(tiny_gemma2_config())
    tp = train_rules(gemma, dict(tp=2))
    assert "lm_head" not in tp
    for key in ("post_attn_norm", "post_mlp_norm"):
        assert tp[f"layers.{key}"].replicated == ("tp",) and tp[f"layers.{key}"].summed == ()
    assert tp["embed"].summed == ()
    pp = train_rules(gemma, dict(pp=2))
    assert pp["embed"].replicated == ("pp",) and pp["embed"].summed == ("pp",)
