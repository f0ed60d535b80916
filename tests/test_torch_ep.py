"""Expert parallelism of the port (the ep axis of ``models/llama.py``'s
``moe_mlp``, ``parallel/group.py`` and ``parallel/sharding.py``) held
against the JAX package's ep-sharded expert layer on the CPU.

- (a) ``shards_from_jax`` at ep=2 and 4: every rank's experts rebuild the
  tree, the router and everything else whole on each rank;
- (b) ``moe_mlp`` over ep ranks (threads over gloo) against the reference's
  ``_moe_mlp``, float32 within 1e-5, across a token-tile boundary;
- (c) the port's ep=2 engine on ``tiny_moe_config`` against the reference's
  ep=2 engine (``tests/test_parallel.py``): tokens exact, logprobs within
  1e-5, at horizons 1 and 4, and a zero-leak audit;
- (d) the expert layer under tp (9i), ep on a dense model and an ep that
  does not divide the experts are refused;
- (e) ``serve --pp 2``, ``--sp 2``, ``--ep 2`` (on ``tiny-moe``) and
  ``--mesh-shape pp=2,...,tp=2`` build a rank engine on the CPU whose
  gateway answers a chat as the single-device engine of the same flags."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smg_tpu.engine import config as jconf
from smg_tpu.engine.engine import Engine as JaxEngine
from smg_tpu.models import config as jmodels
from smg_tpu.models import llama as jl
from smg_tpu.tokenizer import MockTokenizer as JaxMockTokenizer
from smg_tpu_torch.engine import config as tconf
from smg_tpu_torch.engine.engine import Engine
from smg_tpu_torch.models import config as tmodels
from smg_tpu_torch.models.convert import params_from_jax, shards_from_jax
from smg_tpu_torch.models.llama import moe_mlp
from smg_tpu_torch.protocols.sampling import SamplingParams
from smg_tpu_torch.tokenizer import MockTokenizer
from test_torch_pp import TOL, jax_gen, port_gen, port_model, run_grid

torch.set_num_threads(2)
PROMPT = list(range(5, 30))  # test_parallel's prompt


@pytest.fixture(scope="module")
def moe_weights():
    jcfg = jmodels.tiny_moe_config()
    jp = jax.jit(functools.partial(jl.init_params, jcfg))(jax.random.PRNGKey(0))
    return jcfg, jp, jax.tree.map(np.asarray, jp)


# ---- (a) shards ----

@pytest.mark.parametrize("ep", [2, 4])
def test_expert_shards_rebuild_the_tree(moe_weights, ep):
    jcfg, _, tree = moe_weights
    cfg = port_model(jcfg)
    shards = shards_from_jax(tree, cfg, tconf.ParallelConfig(ep=ep))
    full = params_from_jax(tree)
    X = cfg.num_experts
    for name, whole in full["layers"].items():
        parts = [rp["layers"][name] for _, rp in shards]
        if name in ("w_gate", "w_up", "w_down"):
            assert all(p.shape[1] == X // ep for p in parts)
            torch.testing.assert_close(torch.cat(parts, dim=1), whole, rtol=0, atol=0)
        else:
            assert all(torch.equal(p, whole) for p in parts)
    for rcfg, rp in shards:
        assert rcfg.num_experts == X // ep and rcfg.num_layers == cfg.num_layers
        for name in ("embed", "final_norm", "lm_head"):
            assert torch.equal(rp[name], full[name])


# ---- (b) the expert layer over ep ranks ----

@pytest.mark.parametrize("ep", [2, 4])
def test_moe_mlp_over_ep_ranks_matches_the_reference(moe_weights, ep):
    jcfg, jp, tree = moe_weights
    cfg = port_model(jcfg)
    layer = {k: v[1] for k, v in jp["layers"].items()}
    rng = np.random.default_rng(ep)
    x = rng.standard_normal((2, 37, cfg.hidden_size)).astype(np.float32)
    want = np.asarray(jl._moe_mlp(layer, jnp.asarray(x), jcfg))
    shards = shards_from_jax(tree, cfg, tconf.ParallelConfig(ep=ep))
    k = jcfg.num_experts_per_tok

    def rank(r, groups):
        ly = shards[r][1]["layers"]
        g = groups.axis("ep")
        return moe_mlp(torch.from_numpy(x), ly["router"][1], ly["w_gate"][1], ly["w_up"][1],
                       ly["w_down"][1], k, tile=32, ep=g,
                       expert0=g.rank * (cfg.num_experts // ep)).numpy()

    for got in run_grid({"ep": ep}, rank):
        np.testing.assert_allclose(got, want, **TOL)


# ---- (c) engines ----

def _config(module, model, parallel):
    return dict(model=model, parallel=parallel,
                cache=module.CacheConfig(page_size=16, num_pages=64, auto_size=False,
                                         dtype="float32"),
                scheduler=module.SchedulerConfig(
                    max_batch_size=4, max_seq_len=128, max_prefill_tokens=64,
                    prefill_token_buckets=(32, 64), decode_batch_buckets=(4,)))


@pytest.fixture(scope="module")
def ep_engine(moe_weights):
    cfg = tconf.EngineConfig(**_config(tconf, dataclasses.replace(
        tmodels.tiny_moe_config(), dtype="float32"), tconf.ParallelConfig(ep=2)),
        decode_graphs=False)
    eng = Engine(cfg, params=params_from_jax(moe_weights[2]), devices=["cpu", "cpu"],
                 tokenizer=MockTokenizer())
    yield eng
    eng.close()


@pytest.fixture(scope="module")
def reference_ep(moe_weights, cpu_devices):
    """The reference's ep=2 engine (``test_parallel.py``'s settings)."""
    cfg = jconf.EngineConfig(**_config(jconf, jmodels.tiny_moe_config(),
                                       jconf.ParallelConfig(ep=2)), dtype="float32")
    je = JaxEngine(cfg, tokenizer=JaxMockTokenizer(), devices=cpu_devices[:2])
    try:
        got = jax.tree.map(np.asarray, je.runner.params)
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b), got, moe_weights[2])
        yield jax_gen(je, PROMPT, 12)
    finally:
        je.stop()


@pytest.mark.parametrize("horizon", [1, 4])
def test_ep_streams_match_the_reference_ep_engine(ep_engine, reference_ep, horizon):
    got = port_gen(ep_engine, PROMPT, 12, decode_horizon=horizon)
    assert got.token_ids == reference_ep.token_ids and len(got.token_ids) == 12
    np.testing.assert_allclose(got.logprobs, reference_ep.logprobs, **TOL)
    assert ep_engine.runner.model_cfg.num_experts == 2  # the rank's half of 4
    assert ep_engine.loads()["mesh"]["shape"]["ep"] == 2
    audit = ep_engine.audit()
    assert audit["quiescent"] and audit["clean"] and audit["leaked_pages"] == 0


# ---- (d) refusals ----

@pytest.mark.parametrize("model,axes,error,match", [
    ("moe", dict(ep=2, tp=2), NotImplementedError, "item 9i"),
    ("moe", dict(tp=2), NotImplementedError, "item 9i"),
    ("dense", dict(ep=2), ValueError, "ep=2 on a dense"),
    ("moe", dict(ep=3), ValueError, "ep=3 does not divide num_experts=4"),
], ids=["ep_x_tp", "experts_under_tp", "ep_on_dense", "ep_not_dividing"])
def test_expert_compositions_refused(model, axes, error, match):
    m = tmodels.tiny_moe_config() if model == "moe" else tmodels.tiny_test_config()
    cfg = tconf.EngineConfig(model=m, parallel=tconf.ParallelConfig(**axes),
                             decode_graphs=False)
    with pytest.raises(error, match=match):
        Engine(cfg, devices=["cpu"] * cfg.parallel.world_size)


def test_ep_engine_samples_like_a_single_device_one(ep_engine, moe_weights):
    """At temperature 0.8 the ep engine's stream is the port's single-device
    engine's (the same counter-hash noise on every rank)."""
    cfg = tconf.EngineConfig(**_config(tconf, dataclasses.replace(
        tmodels.tiny_moe_config(), dtype="float32"), tconf.ParallelConfig()),
        decode_graphs=False)
    one = Engine(cfg, params=params_from_jax(moe_weights[2]), device="cpu",
                 tokenizer=MockTokenizer())

    def sampled(eng):
        eng.flush_cache()
        eng.runner.rng_restore(0)
        eng.scheduler.sched = dataclasses.replace(eng.scheduler.sched, decode_horizon=2)
        return eng.generate(PROMPT, SamplingParams(temperature=0.8, max_new_tokens=12,
                                                   ignore_eos=True))

    try:
        want = sampled(one)
    finally:
        one.close()
    got = sampled(ep_engine)
    assert got.token_ids == want.token_ids
    np.testing.assert_allclose(got.logprobs, want.logprobs, **TOL)


# ---- (e) serve's mesh flags ----

CLI_MESHES = [("tiny", ["--pp", "2"]), ("tiny", ["--sp", "2"]),
              ("tiny-moe", ["--ep", "2"]), ("tiny", ["--mesh-shape", "pp=2,sp=1,ep=1,tp=2"])]


def _serve_chat(preset: str, flags: list) -> tuple:
    """A chat through the gateway over the engine ``serve``'s flags build on
    the CPU: (status, body, the engine's mesh)."""
    import asyncio

    from aiohttp.test_utils import TestClient, TestServer

    from smg_tpu_torch.cli import build_parser
    from smg_tpu_torch.gateway.launch import build_context, build_engine_from_args
    from smg_tpu_torch.gateway.server import build_app

    args = build_parser().parse_args([
        "serve", "--model-preset", preset, "--device", "cpu", "--dtype", "float32",
        "--port", "0", "--max-batch-size", "4", "--max-seq-len", "128", *flags])
    engine = build_engine_from_args(args)
    mesh = engine.loads(include_audit=False)["mesh"]
    ctx = build_context(engine, policy=args.policy)

    async def go():
        tc = TestClient(TestServer(build_app(ctx)))
        await tc.start_server()
        try:
            r = await tc.post("/v1/chat/completions", json={
                "model": preset, "messages": [{"role": "user", "content": "w5 w6 w7"}],
                "temperature": 0, "ignore_eos": True, "max_tokens": 6})
            return r.status, await r.json()
        finally:
            await tc.close()
            await ctx.registry.list()[0].client.close()

    try:
        status, body = asyncio.run(go())
    finally:
        engine.close()
    return status, body, mesh


@pytest.mark.parametrize("preset,flags", CLI_MESHES, ids=[" ".join(f) for _, f in CLI_MESHES])
def test_serve_mesh_flags_answer_a_chat(preset, flags):
    status, body, mesh = _serve_chat(preset, flags)
    assert status == 200, body
    one_status, one, one_mesh = _serve_chat(preset, [])
    assert mesh["devices"] == (4 if "tp=2" in flags[-1] else 2) and mesh["backend"] == "gloo"
    assert one_mesh["devices"] == 1 and one_status == 200
    # the preset's weights come from one seed, drawn whole on every rank
    assert body["choices"][0]["message"] == one["choices"][0]["message"]
    assert body["usage"]["completion_tokens"] == 6
