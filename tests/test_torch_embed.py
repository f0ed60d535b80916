"""Embeddings, rerank and classify on the port, held against the JAX package
on the CPU, in float32 with weights bridged from the JAX ``init_params``:

- ``forward_embed`` against the reference's on ``tiny``, ``tiny-moe`` and a
  variant with softcap, a sliding window, ``post_norms`` and ``qk_norm``:
  one tile, query tiles with a boundary inside a row, rows split over tiles
  (1e-4; rows of length 0 are batch padding, which the runner drops);
- ``runner.embed`` against the JAX runner's: the power-of-two batch, the
  prefill bucket, truncation at the largest bucket and at the window;
- ``Engine.embed`` against the JAX ``Engine.embed``, also between steps of a
  running request;
- ``/v1/embeddings``, ``/v1/rerank``, ``/rerank`` and ``/v1/classify`` with
  their error cases (the cases of ``tests/test_gateway.py``) through the
  port's gateway over a port engine and the reference ``build_app`` over a
  JAX engine: identical statuses and bodies, ids and timestamps removed,
  floats to 1e-4;
- on the card only (``-m cuda``): ``Engine.embed`` in float32 against the
  CPU path on the same weights (1e-4), and the tiled forward against one
  tile (1e-5)."""

import asyncio
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from smg_tpu.engine import config as jconf
from smg_tpu.engine.engine import Engine as JaxEngine
from smg_tpu.gateway import server as jserver
from smg_tpu.gateway import worker_client as jwc
from smg_tpu.gateway import workers as jworkers
from smg_tpu.models import llama as jl
from smg_tpu.models.config import tiny_moe_config, tiny_test_config
from smg_tpu.ops.rope import rope_frequencies
from smg_tpu.tokenizer import MockTokenizer as JaxMockTokenizer
from smg_tpu_torch.engine import config as tconf
from smg_tpu_torch.engine.engine import Engine
from smg_tpu_torch.gateway import server as tserver
from smg_tpu_torch.gateway import worker_client as twc
from smg_tpu_torch.gateway import workers as tworkers
from smg_tpu_torch.models.config import ModelConfig
from smg_tpu_torch.models.convert import params_from_jax
from smg_tpu_torch.models.llama import LlamaModel
from smg_tpu_torch.protocols.sampling import SamplingParams
from smg_tpu_torch.tokenizer import MockTokenizer

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)

CONFIGS = {
    "tiny": tiny_test_config(),
    "tiny_moe": tiny_moe_config(),
    # Gemma-2's switches and Qwen3's qk_norm in one small model
    "softcap_window": dataclasses.replace(tiny_test_config(), attn_logit_softcap=30.0,
                                          post_norms=True, qk_norm=True, sliding_window=16),
}


def port_config(jcfg) -> ModelConfig:
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items() if k in names})


@functools.lru_cache(maxsize=None)
def jax_params(name: str):
    p = jax.jit(functools.partial(jl.init_params, CONFIGS[name]))(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, p)


# ---- forward_embed ----


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_embed_matches_reference(name):
    jcfg = CONFIGS[name]
    inv = jnp.asarray(rope_frequencies(jcfg.head_dim, jcfg.rope_theta, jcfg.rope_scaling))
    rng = np.random.default_rng(1)
    B, T = 4, 24
    toks = rng.integers(1, jcfg.vocab_size, (B, T)).astype(np.int32)
    lens = np.array([24, 10, 1, 17], np.int32)
    want = np.asarray(jl.forward_embed(jax.tree.map(jnp.asarray, jax_params(name)), jcfg,
                                       inv, jnp.asarray(toks), jnp.asarray(lens)))
    model = LlamaModel(port_config(jcfg), params_from_jax(jax_params(name)))
    # one tile; query tiles of 8 (boundaries at 8 and 16 inside the rows);
    # tiles of 5 queries and two rows a tile
    for token_tile, q_tile in ((4096, 512), (4096, 8), (2 * T, 5)):
        got = model.forward_embed(torch.from_numpy(toks), torch.from_numpy(lens),
                                  token_tile=token_tile, q_tile=q_tile)
        assert got.dtype == torch.float32 and got.shape == (B, jcfg.hidden_size)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0, rtol=1e-5)


def test_forward_embed_rows_do_not_depend_on_their_tile():
    name = "tiny"
    model = LlamaModel(port_config(CONFIGS[name]), params_from_jax(jax_params(name)))
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(1, 512, (3, 32)).astype(np.int32))
    lens = torch.tensor([32, 5, 20], dtype=torch.int32)
    whole = model.forward_embed(toks, lens)
    for i in range(3):
        alone = model.forward_embed(toks[i:i + 1], lens[i:i + 1])
        np.testing.assert_allclose(alone.numpy(), whole[i:i + 1].numpy(), rtol=1e-6,
                                   atol=1e-6)


# ---- runner.embed and Engine.embed ----


def jax_engine(name="tiny", **sched) -> JaxEngine:
    return JaxEngine(jconf.EngineConfig(
        model=CONFIGS[name],
        cache=jconf.CacheConfig(page_size=16, num_pages=64, auto_size=False, dtype="float32"),
        scheduler=jconf.SchedulerConfig(**{
            "max_batch_size": 4, "max_seq_len": 256, "max_prefill_tokens": 64,
            "prefill_token_buckets": (16, 32, 64), "decode_batch_buckets": (4,), **sched}),
        dtype="float32", model_id="tiny-test"),
        params=jax.tree.map(jnp.asarray, jax_params(name)))


def port_engine(name="tiny", **sched) -> Engine:
    return Engine(tconf.EngineConfig(
        model=port_config(CONFIGS[name]),
        cache=tconf.CacheConfig(page_size=16, num_pages=64, auto_size=False, dtype="float32"),
        scheduler=tconf.SchedulerConfig(**{
            "max_batch_size": 4, "max_seq_len": 256, "max_prefill_tokens": 64,
            "prefill_token_buckets": (16, 32, 64), "decode_batch_buckets": (4,), **sched}),
        model_id="tiny-test"),
        params=params_from_jax(jax_params(name)), device="cpu")


@functools.lru_cache(maxsize=None)
def engines(name: str):
    return jax_engine(name), port_engine(name)


def _batches(rng, lengths):
    return [rng.integers(1, 512, n).tolist() for n in lengths]


@pytest.mark.parametrize("name,lengths,shape", [
    ("tiny", (5,), (1, 16)),  # one row, the smallest bucket
    ("tiny", (20, 3, 33), (4, 64)),  # three rows pad to four, 33 tokens to the 64 bucket
    ("tiny", (100, 7), (2, 64)),  # cut at the largest bucket
    ("softcap_window", (40, 12), (2, 16)),  # cut at the sliding window
    ("tiny_moe", (9, 30, 2, 17, 5), (8, 32)),
], ids=["one", "pow2_bucket", "cap", "window", "moe"])
def test_runner_embed_matches_reference(name, lengths, shape):
    je, te = engines(name)
    batches = _batches(np.random.default_rng(len(lengths)), lengths)
    seen = []
    fwd = te.runner.model.forward_embed

    def spy(tokens, lens, **kw):
        seen.append(tuple(tokens.shape))
        return fwd(tokens, lens, **kw)

    te.runner.model.forward_embed = spy
    try:
        got = te.runner.embed(batches)
    finally:
        del te.runner.model.forward_embed
    assert seen == [shape]
    want = je.runner.embed(batches)
    assert got.dtype == np.float32 and got.shape == (len(lengths), CONFIGS[name].hidden_size)
    np.testing.assert_allclose(got, want, **TOL)


def test_engine_embed_matches_reference_beside_a_running_request():
    je, te = engines("tiny")
    batches = _batches(np.random.default_rng(9), (12, 40, 7))
    np.testing.assert_allclose(te.embed(batches), je.embed(batches), **TOL)
    # between steps of a decode: the KV cache and the stream are untouched
    out = []
    te.submit(list(range(5, 30)), SamplingParams(temperature=0.0, max_new_tokens=6,
                                                 ignore_eos=True), rid="r", on_output=out.append)
    te.step()
    mid = te.embed(batches)
    while te.has_work():
        te.step()
    alone = port_engine("tiny").generate(list(range(5, 30)), SamplingParams(
        temperature=0.0, max_new_tokens=6, ignore_eos=True))
    assert [t for o in out for t in o.new_token_ids] == alone.token_ids
    np.testing.assert_array_equal(mid, te.embed(batches))
    assert te.audit()["clean"]


# ---- the routes against the reference gateway ----

CASES = [
    ("/v1/embeddings", {"model": "tiny-test", "input": ["w1 w2 w3", "w4 w5"]}),
    ("/v1/embeddings", {"model": "tiny-test", "input": "w9 w8 w7 w6"}),
    ("/v1/embeddings", {"model": "tiny-test", "input": [5, 6, 7]}),
    ("/v1/embeddings", {"model": "tiny-test", "input": [[5, 6], [7, 8, 9, 10]]}),
    ("/v1/embeddings", {"model": "tiny-test", "input": []}),  # 400 from the router
    ("/v1/embeddings", {"model": "tiny-test"}),  # 400: no input
    ("/v1/rerank", {"model": "tiny-test", "query": "w10 w11 w12",
                    "documents": ["w90 w91", "w10 w11 w12", "w40 w41 w42 w43"]}),
    ("/rerank", {"model": "tiny-test", "query": "w1 w2", "documents": ["w3", "w4", "w5"],
                 "top_n": 2, "return_documents": False}),
    ("/v1/rerank", {"model": "tiny-test", "query": "w1", "documents": []}),
    ("/v1/rerank", {"model": "tiny-test", "documents": ["w1"]}),  # 400: no query
    ("/v1/classify", {"model": "tiny-test", "input": ["w7 w8 w9", "w77 w78"],
                      "labels": ["w7 w8 w9", "w77 w78"]}),
    ("/v1/classify", {"model": "tiny-test", "input": "w7 w8", "labels": ["w7 w8", "w3"]}),
    ("/v1/classify", {"model": "tiny-test", "input": "w7", "labels": []}),
    ("/v1/classify", {"model": "tiny-test", "input": "w7", "labels": ["a", "a"]}),
    ("/v1/classify", {"model": "tiny-test", "input": [], "labels": ["a"]}),
]


def _strip(obj):
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in ("id", "created")}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def _close(got, want, path=""):
    """Equal structure and values, floats to 1e-4."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _close(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert got == pytest.approx(want, abs=1e-4), path
    else:
        assert got == want, path


async def _bodies(side: str) -> list:
    je, te = engines("tiny")
    srv, wc, workers = ((jserver, jwc, jworkers) if side == "ref"
                        else (tserver, twc, tworkers))
    ctx = srv.AppContext(policy="round_robin")
    tok = JaxMockTokenizer() if side == "ref" else MockTokenizer(vocab_size=512)
    ctx.tokenizers.register("tiny-test", tok, default=True)
    ctx.registry.add(workers.Worker(
        worker_id="w0", client=wc.InProcWorkerClient(je if side == "ref" else te),
        model_id="tiny-test"))
    tc = TestClient(TestServer(srv.build_app(ctx)))
    await tc.start_server()
    out = []
    try:
        for path, body in CASES:
            resp = await tc.post(path, json=body)
            out.append((resp.status, _strip(await resp.json())))
    finally:
        await tc.close()
        ctx.registry.remove("w0")
        (je if side == "ref" else te).stop()
    return out


def test_routes_match_reference():
    loop = asyncio.new_event_loop()
    try:
        want = loop.run_until_complete(_bodies("ref"))
        got = loop.run_until_complete(_bodies("port"))
    finally:
        loop.close()
    assert [s for s, _ in got] == [s for s, _ in want] == [
        200, 200, 200, 200, 400, 400, 200, 200, 400, 400, 200, 200, 400, 400, 400]
    for (_, g), (_, w) in zip(got, want):
        _close(g, w)
    emb = got[0][1]
    assert len(emb["data"]) == 2 and len(emb["data"][0]["embedding"]) == 128
    assert abs(np.linalg.norm(emb["data"][0]["embedding"]) - 1.0) < 1e-5
    rr = got[6][1]["results"]
    assert rr[0]["index"] == 1 and rr[0]["relevance_score"] == pytest.approx(1.0, abs=1e-4)
    assert got[10][1]["data"][0]["label"] == "w7 w8 w9"


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CONFIGS))
def test_card_embed_matches_the_cpu_path(cuda_dev, name):
    cpu = port_engine(name)
    card = Engine(tconf.EngineConfig(
        model=port_config(CONFIGS[name]),
        cache=tconf.CacheConfig(page_size=16, num_pages=64, auto_size=False, dtype="float32"),
        scheduler=tconf.SchedulerConfig(max_batch_size=4, max_seq_len=256,
                                        max_prefill_tokens=64,
                                        prefill_token_buckets=(16, 32, 64),
                                        decode_batch_buckets=(4,))),
        params=params_from_jax(jax_params(name)), device=cuda_dev)
    batches = _batches(np.random.default_rng(4), (64, 30, 5))
    np.testing.assert_allclose(card.embed(batches), cpu.embed(batches), **TOL)
    toks = torch.from_numpy(np.random.default_rng(5).integers(1, 512, (2, 64)).astype(np.int32))
    lens = torch.tensor([64, 40], dtype=torch.int32)
    model = card.runner.model
    whole = model.forward_embed(toks.to(cuda_dev), lens.to(cuda_dev), q_tile=64)
    tiled = model.forward_embed(toks.to(cuda_dev), lens.to(cuda_dev), token_tile=64, q_tile=16)
    np.testing.assert_allclose(tiled.cpu().numpy(), whole.cpu().numpy(), rtol=1e-5, atol=1e-5)
