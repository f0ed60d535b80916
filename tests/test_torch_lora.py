"""Multi-adapter LoRA on the port, held against the JAX package on the CPU:
the PEFT and npz loaders (``smg_tpu_torch/models/lora.py``), the dense
one-hot delta (``models/llama.py::lora_delta``), the runner's bank (slot
reuse, capacity, zero-padded smaller ranks), and ``Engine`` streams of base,
adapter and mixed batches at temperature 0 (overlap on and off, chunked and
grouped prefill, a preempted LoRA lane) against the JAX engine's; the
unknown-adapter and busy-slot errors; speculation leaving LoRA lanes out;
the three LoRA routes and ``lora_adapter`` in chat bodies through both
``build_app``s; and ``serve --model-path`` on a tiny HF directory against
the JAX ``serve`` engine.  The tiny float32 model, weights bridged from the
JAX ``init_params``; adapters from numpy seeds.  Tolerances: the delta
1e-6, logprobs 1e-4, tokens exact.

On the card (marker ``cuda``): a captured LoRA megastep equals the eager
one bitwise, and a load or unload between replays of one graph changes the
output of only the rows pinned to that slot.  Run on a GPU:
``python -m pytest tests/test_torch_lora.py -m cuda -q``."""

import asyncio
import dataclasses
import functools
import io
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from smg_tpu import cli as jcli
from smg_tpu.engine import config as jconf
from smg_tpu.engine.engine import Engine as JaxEngine
from smg_tpu.gateway import launch as jlaunch
from smg_tpu.gateway import server as jserver
from smg_tpu.gateway.worker_client import InProcWorkerClient as JaxInProc
from smg_tpu.gateway.workers import Worker as JaxWorker
from smg_tpu.models import llama as jllama
from smg_tpu.models import lora as jlora
from smg_tpu.models.config import ModelConfig as JModelConfig
from smg_tpu.models.config import tiny_test_config
from smg_tpu.models.registry import get_model
from smg_tpu.protocols.sampling import SamplingParams as JaxSamplingParams
from smg_tpu.tokenizer import MockTokenizer as JaxMockTokenizer
from smg_tpu_torch import cli as tcli
from smg_tpu_torch.engine import config as tconf
from smg_tpu_torch.engine.engine import Engine
from smg_tpu_torch.engine.runner import DecodeState, ModelRunner
from smg_tpu_torch.gateway import launch as tlaunch
from smg_tpu_torch.gateway import server as tserver
from smg_tpu_torch.gateway.worker_client import InProcWorkerClient
from smg_tpu_torch.gateway.workers import Worker
from smg_tpu_torch.models import config as tmodels
from smg_tpu_torch.models import lora as tlora
from smg_tpu_torch.models.convert import params_from_jax
from smg_tpu_torch.models.llama import init_params, lora_delta
from smg_tpu_torch.protocols.sampling import SamplingParams
from smg_tpu_torch.tokenizer import MockTokenizer

torch.set_num_threads(2)
PS = 16
SCHED = dict(max_batch_size=4, max_seq_len=256, max_prefill_tokens=64,
             decode_batch_buckets=(4,), decode_horizon=4)


@functools.lru_cache(maxsize=None)
def jax_params():
    cfg = tiny_test_config()
    p = jax.jit(functools.partial(get_model(cfg.arch).init_params, cfg))(
        jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, p)


def adapter(rank: int, seed: int, scale: float = 0.3) -> dict:
    """A canonical adapter for the tiny model that moves greedy streams."""
    rng = np.random.default_rng(seed)
    w = jlora.empty_adapter(tiny_test_config(), rank)
    return {k: rng.normal(0, scale, v.shape).astype(np.float32) for k, v in w.items()}


ADAPTERS = {"a": adapter(4, 1), "b": adapter(4, 2), "small": adapter(2, 3)}


def jax_engine(num_pages=128, **kw):
    cfg = jconf.EngineConfig(
        model=tiny_test_config(),
        cache=jconf.CacheConfig(page_size=PS, num_pages=num_pages, auto_size=False,
                                dtype="float32"),
        scheduler=jconf.SchedulerConfig(**{**SCHED, "prefill_token_buckets": (16, 32, 64),
                                           **kw}),
        dtype="float32", seed=0)
    return JaxEngine(cfg, params=jax.tree.map(jnp.asarray, jax_params()))


def port_engine(num_pages=128, **kw):
    cfg = tconf.EngineConfig(
        model=tmodels.tiny_test_config(),
        cache=tconf.CacheConfig(page_size=PS, num_pages=num_pages, auto_size=False,
                                dtype="float32"),
        scheduler=tconf.SchedulerConfig(**{**SCHED, **kw}), seed=0)
    return Engine(cfg, params=params_from_jax(jax_params()), device="cpu")


def load_all(engine, names=("a", "b")):
    return [engine.runner.load_lora(n, ADAPTERS[n]) for n in names]


def g(n, **kw):
    return dict(temperature=0.0, max_new_tokens=n, ignore_eos=True, **kw)


def run(engine, jobs, max_steps=3000) -> dict:
    """Submit every job, step inline until all finished; rid -> (tokens,
    finish, logprobs).  Jobs are (rid, prompt, SamplingParams kwargs)."""
    cls = JaxSamplingParams if isinstance(engine, JaxEngine) else SamplingParams
    chunks: dict[str, list] = {}
    for rid, prompt, kw in jobs:
        chunks[rid] = []
        engine.submit(prompt, cls(**kw), rid=rid, on_output=chunks[rid].append)
    for _ in range(max_steps):
        if not engine.scheduler.has_work():
            break
        engine.step()
    else:
        raise TimeoutError("jobs stuck")
    return {rid: ([t for o in c for t in o.new_token_ids], c[-1].finish_reason,
                  [x for o in c for x in o.logprobs]) for rid, c in chunks.items()}


def assert_same_streams(got: dict, want: dict) -> None:
    assert {r: v[:2] for r, v in got.items()} == {r: v[:2] for r, v in want.items()}
    for rid in want:
        np.testing.assert_allclose(got[rid][2], want[rid][2], atol=1e-4, rtol=1e-4)


def set_overlap(engine, on: bool) -> None:
    s = engine.scheduler
    s.sched = dataclasses.replace(s.sched, overlap_schedule=on)


def assert_clean(engine):
    audit = engine.audit()
    assert audit["quiescent"] and audit["clean"] and audit["leaked_pages"] == 0, audit


# ---- loaders and the delta ----


def _peft_tensors(cfg, rank: int, seed: int, targets=("q_proj", "k_proj", "v_proj",
                                                      "o_proj")) -> dict:
    rng = np.random.default_rng(seed)
    E, H, K, D = cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dims = {"q_proj": (E, H * D), "k_proj": (E, K * D), "v_proj": (E, K * D),
            "o_proj": (H * D, E)}
    out = {}
    for layer in range(cfg.num_layers):
        for t in targets:
            fin, fout = dims[t]
            pre = f"base_model.model.model.layers.{layer}.self_attn.{t}"
            out[f"{pre}.lora_A.weight"] = rng.normal(0, 1, (rank, fin)).astype(np.float32)
            out[f"{pre}.lora_B.weight"] = rng.normal(0, 1, (fout, rank)).astype(np.float32)
    out["base_model.model.lm_head.extra"] = np.ones(3, np.float32)  # skipped by both
    return out


@pytest.mark.parametrize("fmt", ["safetensors_f32", "safetensors_bf16", "npz"])
def test_load_peft_dir_is_identical(tmp_path, fmt):
    from safetensors.torch import save_file

    cfg = tiny_test_config()
    tensors = _peft_tensors(cfg, rank=2, seed=3,
                            targets=("q_proj", "v_proj") if fmt == "npz" else
                            ("q_proj", "k_proj", "v_proj", "o_proj"))
    (tmp_path / "adapter_config.json").write_text(json.dumps({"r": 2, "lora_alpha": 8}))
    if fmt == "npz":
        np.savez(tmp_path / "adapter_model.npz", **tensors)
    else:
        dtype = torch.bfloat16 if fmt.endswith("bf16") else torch.float32
        save_file({k: torch.from_numpy(v).to(dtype) for k, v in tensors.items()},
                  str(tmp_path / "adapter_model.safetensors"))
    want = jlora.load_peft_dir(str(tmp_path), cfg)
    got = tlora.load_peft_dir(str(tmp_path), tmodels.tiny_test_config())
    assert set(got) == set(want) == set(tlora.canonical_keys())
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k])
    assert tlora.validate_adapter(tmodels.tiny_test_config(), got) == 2


def test_load_npz_and_validate_are_identical(tmp_path):
    w = ADAPTERS["a"]
    buf = io.BytesIO()
    np.savez(buf, **w, extra=np.zeros(2))
    np.savez(tmp_path / "a.npz", **w)
    for src in (buf.getvalue(), str(tmp_path / "a.npz")):
        got, want = tlora.load_npz(src), jlora.load_npz(src)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    cfg, tcfg = tiny_test_config(), tmodels.tiny_test_config()
    assert tlora.validate_adapter(tcfg, w) == jlora.validate_adapter(cfg, w) == 4
    for bad in ({k: v for k, v in w.items() if k != "wo_b"},
                {**w, "wq_a": w["wq_a"][:, :-1]},
                {**w, "wk_b": w["wk_b"][:, :2]}):
        with pytest.raises(ValueError) as ref:
            jlora.validate_adapter(cfg, bad)
        with pytest.raises(ValueError, match=str(ref.value).replace("(", r"\(")
                           .replace(")", r"\)").replace("[", r"\[").replace("]", r"\]")):
            tlora.validate_adapter(tcfg, bad)


@pytest.mark.parametrize("lead", [(5,), (3, 7)])
def test_lora_delta_matches_reference(lead):
    rng = np.random.default_rng(len(lead))
    N, E, r, O = 5, 24, 3, 40
    # an adapter's scale (deltas of O(0.1-1)): 1e-6 is then a few float32
    # roundings of the two summation orders
    x = rng.standard_normal((*lead, E)).astype(np.float32)
    a = (0.2 * rng.standard_normal((N, E, r))).astype(np.float32)
    b = (0.2 * rng.standard_normal((N, r, O))).astype(np.float32)
    a[0], b[0] = 0.0, 0.0  # slot 0: no adapter
    idx = rng.integers(0, N, lead[:1])
    gates = np.eye(N, dtype=np.float32)[idx]
    if len(lead) == 2:
        gates = np.broadcast_to(gates[:, None], (*lead, N))
    want = np.asarray(jllama._lora_delta(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b),
                                         jnp.asarray(gates)))
    got = lora_delta(torch.from_numpy(x), torch.from_numpy(a.transpose(1, 0, 2).reshape(E, -1)),
                     torch.from_numpy(b.reshape(-1, O)), torch.from_numpy(np.ascontiguousarray(gates)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    base = idx == 0
    assert not got.numpy()[base].any()  # a base row adds exact zeros


# ---- the bank ----


def test_bank_slots_capacity_and_rank_rules_match_reference():
    je, te = jax_engine(), port_engine()
    for e in (je, te):
        assert e.runner.lora_slots == 5
    outs = []
    for e in (je, te):
        r = e.runner
        seq = [r.load_lora("a", ADAPTERS["a"]), r.load_lora("b", ADAPTERS["b"]),
               r.load_lora("a", ADAPTERS["b"]), r.load_lora("small", ADAPTERS["small"])]
        seq.append(r.unload_lora("b"))
        seq.append(r.unload_lora("b"))
        seq.append(r.load_lora("c", ADAPTERS["a"]))  # reuses b's freed slot
        seq.append(r.load_lora("d", ADAPTERS["a"]))
        seq.append(r.list_loras())
        errs = []
        for call in (lambda: r.load_lora("e", ADAPTERS["a"]),
                     lambda: r.load_lora("big", adapter(8, 4)),
                     lambda: r.lora_index("nope")):
            with pytest.raises(ValueError) as ei:
                call()
            errs.append(str(ei.value))
        outs.append((seq, errs))
    assert outs[1] == outs[0]
    assert te.runner._lora_bank.rank == 4
    # the smaller-rank adapter was zero-padded into its slot
    slot = te.runner.lora_index("small")
    a = te.runner._lora_bank["wq_a"][:, :, slot * 4: slot * 4 + 4]
    assert torch.equal(a[..., 2:], torch.zeros_like(a[..., 2:]))
    assert torch.equal(a[..., :2], torch.from_numpy(ADAPTERS["small"]["wq_a"]))


# ---- engines: the port against the JAX package ----


MIXED = [
    ("base", list(range(10, 40)), g(10)),
    ("a_long", [7 + (i * 13) % 400 for i in range(150)], g(9, lora_adapter="a")),  # chunked
    ("b", list(range(50, 70)), g(11, lora_adapter="b")),
    ("a", list(range(80, 105)), g(8, lora_adapter="a")),
]


@functools.lru_cache(maxsize=None)
def reference_streams(which: str) -> dict:
    je = jax_engine()
    load_all(je, ("a", "b", "small"))
    jobs = {"mixed": MIXED,
            "solo": [(rid, p, {k: v for k, v in kw.items() if k != "lora_adapter"})
                     for rid, p, kw in MIXED],
            "small": [("s", list(range(10, 40)), g(10, lora_adapter="small"))]}[which]
    return run(je, jobs)


@pytest.fixture(scope="module")
def lora_engine():
    te = port_engine()
    load_all(te, ("a", "b", "small"))
    return te


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "sync"])
def test_mixed_batch_matches_jax_engine(lora_engine, overlap):
    """Base and adapter lanes in one batch: a chunked long prompt, a
    grouped prefill of the short ones, the megastep with per-row slots."""
    te = lora_engine
    set_overlap(te, overlap)
    te.flush_cache()
    got = run(te, MIXED)
    assert_same_streams(got, reference_streams("mixed"))
    base_only = reference_streams("solo")
    assert got["base"][0] == base_only["base"][0]  # the base lane is untouched
    assert all(got[r][0] != base_only[r][0] for r in ("a_long", "b", "a"))
    assert te.runner.stats["prefill_calls"] > 0
    assert_clean(te)


@pytest.mark.parametrize("which", ["solo", "small"])
def test_base_only_and_zero_padded_rank_match_jax_engine(lora_engine, which):
    te = lora_engine
    set_overlap(te, True)
    te.flush_cache()
    jobs = {"solo": [(rid, p, {k: v for k, v in kw.items() if k != "lora_adapter"})
                     for rid, p, kw in MIXED],
            "small": [("s", list(range(10, 40)), g(10, lora_adapter="small"))]}[which]
    assert_same_streams(run(te, jobs), reference_streams(which))
    assert_clean(te)


def test_preempted_lora_lane_matches_jax_engine():
    """A pool too small for three adapter lanes: the preempted lane re-prefills
    through its adapter and finishes with the JAX engine's stream."""
    kw = dict(num_pages=12, max_seq_len=128, watermark_pages=1)
    jobs = [(f"p{i}", list(range(10 + 3 * i, 40 + 3 * i)),
             g(40, lora_adapter="ab"[i % 2])) for i in range(3)]
    je, te = jax_engine(**kw), port_engine(**kw)
    load_all(je)
    load_all(te)
    want, got = run(je, jobs), run(te, jobs)
    assert_same_streams(got, want)
    assert te.scheduler.num_preemptions == je.scheduler.num_preemptions > 0
    assert_clean(te)


def test_unknown_adapter_and_busy_slot_errors_match_reference():
    je, te = jax_engine(), port_engine()
    msgs = []
    for e, cls in ((je, JaxSamplingParams), (te, SamplingParams)):
        load_all(e)
        out = []
        with pytest.raises(ValueError) as ei:
            e.submit(list(range(5, 15)), cls(**g(4, lora_adapter="nope")))
        out.append(str(ei.value))
        rid = e.submit(list(range(5, 15)), cls(**g(30, lora_adapter="a")))
        e.step()
        for call in (lambda: e.load_lora_adapter("a", data=_npz(ADAPTERS["b"])),
                     lambda: e.unload_lora_adapter("a")):
            with pytest.raises(ValueError) as ei:
                call()
            out.append(str(ei.value))
        with pytest.raises(ValueError) as ei:
            e.load_lora_adapter("x")
        out.append(str(ei.value))
        # an idle adapter may be replaced while "a" is busy
        out.append(e.load_lora_adapter("b", data=_npz(ADAPTERS["a"])))
        e.abort(rid)
        while e.scheduler.has_work():
            e.step()
        out.append(e.unload_lora_adapter("a"))
        out.append(e.list_lora_adapters())
        msgs.append(out)
    assert msgs[1] == msgs[0]
    assert_clean(te)


def _npz(w: dict) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **w)
    return buf.getvalue()


def test_speculation_leaves_lora_lanes_out():
    """Spec mode: the adapter lane rides the rest megastep, never a verify
    block (the verify scores the base model only); streams and drafted and
    accepted counts equal the JAX spec engine's."""
    rep = [5, 6, 7, 8] * 8
    jobs = [("spec_base", rep, g(16)), ("spec_lora", rep, g(16, lora_adapter="a"))]
    kw = dict(speculative=True, spec_max_draft=4)
    je, te = jax_engine(**kw), port_engine(**kw)
    load_all(je)
    load_all(te)
    want, got = run(je, jobs), run(te, jobs)
    assert_same_streams(got, want)
    s, js = te.scheduler, je.scheduler
    assert (s.num_spec_drafted, s.num_spec_accepted) == (js.num_spec_drafted,
                                                         js.num_spec_accepted)
    assert s.num_spec_drafted > 0
    te.submit(rep, SamplingParams(**g(30, lora_adapter="a")), rid="probe")
    te.step()  # the prefill: a running lane with output
    active = te.scheduler._decode_active()
    eligible, rest = te.scheduler._partition_spec(active)
    assert [r.rid for _, r in rest] == ["probe"] and not eligible
    while te.scheduler.has_work():
        te.step()
    assert_clean(te)


# ---- the gateway: LoRA routes and lora_adapter in chat bodies ----


class Gateways:
    """Both apps, one engine each, on a private loop thread."""

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        self.engines = [jax_engine(), port_engine()]
        specs = ((jserver, JaxInProc, JaxWorker, JaxMockTokenizer()),
                 (tserver, InProcWorkerClient, Worker, MockTokenizer()))
        self.clients = [self.run(self._start(*spec, e)) for spec, e in zip(specs, self.engines)]

    def run(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout=120)

    async def _start(self, server, client_cls, worker_cls, tokenizer, engine):
        ctx = server.AppContext(policy="round_robin")
        ctx.tokenizers.register("tiny-test", tokenizer, default=True)
        ctx.registry.add(worker_cls(worker_id="w0", client=client_cls(engine),
                                    model_id="tiny-test"))
        tc = TestClient(TestServer(server.build_app(ctx)))
        await tc.start_server()
        return tc

    async def _one(self, tc, method, path, body):
        resp = await tc.request(method, path, json=body)
        return resp.status, json.loads(await resp.text())

    def call(self, method, path, body=None):
        return [self.run(self._one(tc, method, path, body)) for tc in self.clients]

    def close(self):
        for tc in self.clients:
            self.run(tc.close())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=10)
        for e in self.engines:
            e.stop()


def _strip(obj):
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in ("id", "created")}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def test_lora_routes_and_chat_bodies_match_reference(tmp_path):
    for name in ("a", "b"):
        np.savez(tmp_path / f"{name}.npz", **ADAPTERS[name])
    gw = Gateways()
    chat = {"model": "tiny-test", "messages": [{"role": "user", "content": "w5 w6 w7"}],
            "max_tokens": 6, "temperature": 0, "ignore_eos": True}
    try:
        steps = [("POST", "/v1/chat/completions", chat),
                 ("POST", "/load_lora_adapter", {"lora_name": "a",
                                                 "lora_path": str(tmp_path / "a.npz")}),
                 ("POST", "/load_lora_adapter", {"lora_name": "b",
                                                 "lora_path": str(tmp_path / "b.npz")}),
                 ("POST", "/load_lora_adapter", {"lora_name": "bad",
                                                 "lora_path": str(tmp_path / "none.npz")}),
                 ("POST", "/load_lora_adapter", {"lora_path": "x"}),
                 ("GET", "/list_lora_adapters", None),
                 ("POST", "/v1/chat/completions", {**chat, "lora_adapter": "a"}),
                 ("POST", "/v1/chat/completions", {**chat, "lora_adapter": "b",
                                                   "stream": True}),
                 ("POST", "/v1/completions", {"model": "tiny-test", "prompt": "w9 w8",
                                              "max_tokens": 5, "temperature": 0,
                                              "lora_adapter": "b"}),
                 ("POST", "/unload_lora_adapter", {"lora_name": "a"}),
                 ("POST", "/unload_lora_adapter", {"lora_name": "a"}),
                 ("POST", "/v1/chat/completions", {**chat, "lora_adapter": "a"}),
                 ("GET", "/list_lora_adapters", None)]
        bodies = []
        for method, path, body in steps:
            if body is not None and body.get("stream"):
                (js, jt), (ps, pt) = _sse_both(gw, path, body)
                assert ps == js == 200
                assert pt == jt
                bodies.append(pt)
                continue
            (js, jb), (ps, pb) = gw.call(method, path, body)
            assert ps == js, (path, jb, pb)
            if path == "/load_lora_adapter" and js != 200 and "lora_name" in body:
                # the error text names the missing file the same way
                assert pb["ok"] is jb["ok"] is False
                assert pb["workers"]["w0"]["error"] == jb["workers"]["w0"]["error"]
            else:
                assert _strip(pb) == _strip(jb), (path, jb, pb)
            bodies.append(pb)
        base, adapted = bodies[0], bodies[6]
        assert base["choices"][0]["message"] != adapted["choices"][0]["message"]
        assert bodies[5]["workers"]["w0"] == ["a", "b"] and bodies[12]["workers"]["w0"] == ["b"]
        assert bodies[9]["ok"] and not bodies[10]["ok"]
    finally:
        gw.close()


def _sse_both(gw, path, body):
    async def one(tc):
        resp = await tc.post(path, json=body)
        text = await resp.text()
        frames = []
        for block in text.split("\n\n"):
            if block.startswith("data: "):
                data = block[len("data: "):]
                frames.append(data if data == "[DONE]" else _strip(json.loads(data)))
        return resp.status, frames
    return [gw.run(one(tc)) for tc in gw.clients]


# ---- serve --model-path on a tiny HF directory ----


def test_serve_model_path_matches_the_jax_serve_engine(tmp_path):
    """A tiny HF directory (config.json, two safetensors shards, a BPE
    tokenizer.json with Llama-3's specials and a chat template): the port's
    ``serve`` engine loads the JAX ``serve`` engine's weights, renders the
    same prompt and generates its greedy tokens."""
    from safetensors.numpy import save_file
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers

    jcfg = tiny_test_config()
    hf = dict(architectures=["LlamaForCausalLM"], vocab_size=jcfg.vocab_size,
              hidden_size=jcfg.hidden_size, intermediate_size=jcfg.intermediate_size,
              num_hidden_layers=jcfg.num_layers, num_attention_heads=jcfg.num_heads,
              num_key_value_heads=jcfg.num_kv_heads, rope_theta=10000.0,
              eos_token_id=[400], bos_token_id=401, max_position_embeddings=2048)
    (tmp_path / "config.json").write_text(json.dumps(hf))
    p = jax_params()
    E, H, K, D = jcfg.hidden_size, jcfg.num_heads, jcfg.num_kv_heads, jcfg.head_dim
    tensors = {"model.embed_tokens.weight": p["embed"], "model.norm.weight": p["final_norm"],
               "lm_head.weight": p["lm_head"].T}
    lay = p["layers"]
    for i in range(jcfg.num_layers):
        pre = f"model.layers.{i}."
        tensors.update({
            pre + "input_layernorm.weight": lay["attn_norm"][i],
            pre + "post_attention_layernorm.weight": lay["mlp_norm"][i],
            pre + "self_attn.q_proj.weight": lay["wq"][i].reshape(E, H * D).T,
            pre + "self_attn.k_proj.weight": lay["wk"][i].reshape(E, K * D).T,
            pre + "self_attn.v_proj.weight": lay["wv"][i].reshape(E, K * D).T,
            pre + "self_attn.o_proj.weight": lay["wo"][i].reshape(H * D, E).T,
            pre + "mlp.gate_proj.weight": lay["w_gate"][i].T,
            pre + "mlp.up_proj.weight": lay["w_up"][i].T,
            pre + "mlp.down_proj.weight": lay["w_down"][i].T})
    names = sorted(tensors)
    for s in range(2):
        save_file({n: np.ascontiguousarray(tensors[n], np.float32) for n in names[s::2]},
                  str(tmp_path / f"model-{s + 1:05d}-of-00002.safetensors"))
    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.train_from_iterator(["hello world how are you", "the quick brown fox"] * 4,
                            trainers.BpeTrainer(vocab_size=300, show_progress=False,
                                                initial_alphabet=pre_tokenizers.ByteLevel
                                                .alphabet()))
    tok.add_special_tokens(["<|eot_id|>", "<|begin_of_text|>"])
    tok.save(str(tmp_path / "tokenizer.json"))
    (tmp_path / "tokenizer_config.json").write_text(json.dumps({
        "bos_token": "<|begin_of_text|>", "eos_token": "<|eot_id|>",
        "chat_template": "{{ bos_token }}{% for m in messages %}{{ m['role'] }}: "
                         "{{ m['content'] }}<|eot_id|>{% endfor %}assistant:"}))
    flags = ["--model-path", str(tmp_path), "--dtype", "float32", "--max-batch-size", "4",
             "--max-seq-len", "256", "--decode-horizon", "2"]
    je = jlaunch.build_engine_from_args(jcli.build_parser().parse_args(["serve", *flags]))
    te = tlaunch.build_engine_from_args(tcli.build_parser().parse_args(
        ["serve", *flags, "--device", "cpu"]))
    assert te.config.model_id == je.config.model_id == str(tmp_path)
    assert te.config.model.eos_token_ids == (400,)
    msgs = [{"role": "user", "content": "hello world, how are you?"}]
    text = te.tokenizer.apply_chat_template(msgs)
    assert text == je.tokenizer.apply_chat_template(msgs)
    ids = te.tokenizer.encode(text)
    assert ids == je.tokenizer.encode(text) and max(ids) < jcfg.vocab_size
    want = je.generate(prompt_ids=ids, sampling=JaxSamplingParams(**g(8)))
    got = te.generate(prompt_ids=ids, sampling=SamplingParams(**g(8)))
    assert got.token_ids == want.token_ids and got.text == want.text
    assert te.list_lora_adapters() == [] and te.runner._lora_bank is None


# ---- on the card ----


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_config(graphs: bool) -> tconf.EngineConfig:
    return tconf.EngineConfig(
        model=tmodels.tiny_test_config(),
        cache=tconf.CacheConfig(page_size=PS, num_pages=200, auto_size=False, dtype="float32"),
        scheduler=tconf.SchedulerConfig(max_batch_size=8, max_seq_len=256,
                                        decode_batch_buckets=(4, 8), decode_horizon=4),
        decode_graphs=graphs)


def _card_case(B: int, mp: int, K: int, lora_idx, seed: int):
    rng = np.random.default_rng(seed)
    pt = rng.permutation(np.arange(1, 200))[: B * mp].reshape(B, mp).astype(np.int32)
    pos = rng.integers(1, mp * PS - K, B).astype(np.int32)
    toks = rng.integers(2, 500, B).astype(np.int64)
    temps = np.zeros(B, np.float32)
    temps[: B // 2] = 0.8
    stop = (rng.integers(2, 500, (B, 4)), np.full(B, 10_000, np.int64), np.ones(B, bool))
    ds = DecodeState.of(pt, temps, np.full(B, -1), np.ones(B), np.zeros(B), stop,
                        lora_idx=lora_idx)
    return toks, pos, ds


def _launch(runner, toks, pos, ds, K):
    runner.rng_restore(5)
    return runner.decode_fetch(runner.decode_multi_async(toks, pos, ds, K))


@pytest.fixture
def card_runners(cuda_dev):
    """(graph runner, eager runner): same weights, cache contents and bank."""
    params = init_params(tmodels.tiny_test_config(),
                         torch.Generator(device=cuda_dev).manual_seed(0), cuda_dev)
    g_, e_ = (ModelRunner(_card_config(flag), params=params, device=cuda_dev)
              for flag in (True, False))
    gen = torch.Generator(device=cuda_dev).manual_seed(1)
    for cache in ("k_cache", "v_cache"):
        fill = torch.randn(getattr(g_, cache).shape, generator=gen, device=cuda_dev) * 0.5
        getattr(g_, cache).copy_(fill)
        getattr(e_, cache).copy_(fill)
    for r in (g_, e_):
        r.load_lora("a", ADAPTERS["a"])
        r.load_lora("b", ADAPTERS["b"])
    return g_, e_


@pytest.mark.cuda
@pytest.mark.parametrize("B,mp,K", [(4, 8, 1), (8, 16, 4)])
def test_captured_lora_megastep_equals_eager_bitwise(card_runners, B, mp, K):
    g_, e_ = card_runners
    lora_idx = np.arange(B) % 3  # base, a, b, base, ...
    toks, pos, ds = _card_case(B, mp, K, lora_idx, seed=B + K)
    k0, v0 = g_.k_cache.clone(), g_.v_cache.clone()
    _launch(g_, toks, pos, ds, K)  # warm-up and capture
    g_.k_cache.copy_(k0)
    g_.v_cache.copy_(v0)
    replay = _launch(g_, toks, pos, ds, K)
    eager = _launch(e_, toks, pos, ds, K)
    assert g_.graphs.num_graphs == 1
    for x, y in zip(replay[:2], eager[:2]):
        np.testing.assert_array_equal(x, y)
    assert replay[2] == eager[2]
    assert torch.equal(g_.k_cache[:, 1:], e_.k_cache[:, 1:])
    assert torch.equal(g_.v_cache[:, 1:], e_.v_cache[:, 1:])


@pytest.mark.cuda
def test_load_and_unload_between_replays_change_only_that_slots_rows(card_runners):
    """One graph, replayed across an unload and a load into the freed slot:
    rows pinned to other slots keep their outputs bitwise, the slot's rows
    follow the bank (base after the unload, the new adapter after the load,
    as the eager megastep computes them)."""
    g_, e_ = card_runners
    B, mp, K = 4, 8, 4
    lora_idx = np.array([0, 1, 2, 1])
    toks, pos, ds = _card_case(B, mp, K, lora_idx, seed=7)
    k0, v0 = g_.k_cache.clone(), g_.v_cache.clone()

    def replay():
        g_.k_cache.copy_(k0)
        g_.v_cache.copy_(v0)
        return _launch(g_, toks, pos, ds, K)

    replay()  # capture
    graph = next(iter(g_.graphs.steps.values())).graph
    before = replay()
    g_.unload_lora("b")
    after_unload = replay()
    assert g_.load_lora("c", adapter(4, 9)) == 2  # the freed slot
    after_load = replay()
    assert next(iter(g_.graphs.steps.values())).graph is graph and g_.graphs.num_graphs == 1
    other = lora_idx != 2
    for got in (after_unload, after_load):
        np.testing.assert_array_equal(got[0][other], before[0][other])
        np.testing.assert_array_equal(got[1][other], before[1][other])
    assert not np.array_equal(after_unload[1][2], before[1][2])
    assert not np.array_equal(after_load[1][2], after_unload[1][2])
    # the slot's rows are what the eager megastep computes on the same bank
    e_.unload_lora("b")
    e_.load_lora("c", adapter(4, 9))
    e_.k_cache.copy_(k0)
    e_.v_cache.copy_(v0)
    eager = _launch(e_, toks, pos, ds, K)
    np.testing.assert_array_equal(after_load[1], eager[1])
    np.testing.assert_array_equal(after_load[0], eager[0])
