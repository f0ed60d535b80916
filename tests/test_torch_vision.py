"""Qwen2-VL on the port, held against the JAX package on the CPU.

- ``apply_mrope`` against the reference's at 1e-6, and bit for bit
  ``apply_rope`` when the three position ids are equal (float32);
- ``mrope_positions`` and ``image_runs_from_positions``: identical arrays and
  errors;
- ``forward_vision`` on ``tiny_vision_config`` with bridged weights at 1e-5,
  on a square grid, a 4x8 grid and across a query-tile boundary;
- the image operations and ``Qwen2VLImageProcessor``, enlarging and
  shrinking: resized pixels within 1e-3 of the reference's in units of the
  0-255 input (float32 sums of a few terms of values up to 255), and the
  processor's normalized pixels within that over the smallest std;
- ``from_hf_config`` on Qwen2-VL-7B-Instruct's published config, field by
  field;
- ``load_vision_params`` on Conv2d and Conv3d checkpoints written here, bit
  for bit against the reference's loader, the flatten order against
  ``F.conv2d``/``F.conv3d``, and the missing-tensor error;
- the port's ``Engine`` against the JAX ``Engine`` on ``tiny-vlm`` and the
  M-RoPE variant, greedy, each engine encoding its own images: tokens,
  finishes and ``cached_tokens`` identical, logprobs to 1e-4, across chunked
  prefill through an image run, grouped prefill with a text row and an
  image row, overlap on and off, an n-gram speculative lane carrying an
  M-RoPE offset and a preempted image lane;
- radix content keys: two images behind the same placeholder ids never
  share KV, the same image does;
- an image chat through the port's app against the reference's
  ``build_app`` over a JAX engine: identical bodies (ids removed), the
  bad-payload 400, and the text-only model's 400.

Float32 throughout, weights bridged from the JAX package's own inits."""

import asyncio
import base64
import dataclasses
import functools
import json
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from aiohttp.test_utils import TestClient, TestServer
from safetensors.numpy import save_file

from smg_tpu.engine import config as jconf
from smg_tpu.engine import mrope as jmrope
from smg_tpu.engine.engine import Engine as JaxEngine
from smg_tpu.gateway import server as jserver
from smg_tpu.gateway.worker_client import InProcWorkerClient as JaxInProc
from smg_tpu.gateway.workers import Worker as JaxWorker
from smg_tpu.models import config as jmodels
from smg_tpu.models import llama as jl
from smg_tpu.models import vit as jvit
from smg_tpu.models.weights import load_vision_params as jload_vision
from smg_tpu.multimodal import image as jimage
from smg_tpu.multimodal import processor as jproc
from smg_tpu.ops import rope as jrope
from smg_tpu.protocols.sampling import SamplingParams as JaxSamplingParams
from smg_tpu.tokenizer import MockTokenizer as JaxMockTokenizer
from smg_tpu_torch.engine import config as tconf
from smg_tpu_torch.engine import mrope as tmrope
from smg_tpu_torch.engine.engine import Engine
from smg_tpu_torch.engine.kv_cache import plan_cache, vision_reserve_bytes
from smg_tpu_torch.gateway import launch as tlaunch
from smg_tpu_torch.gateway import server as tserver
from smg_tpu_torch.models import config as tmodels
from smg_tpu_torch.models import vit as tvit
from smg_tpu_torch.models.config import ModelConfig
from smg_tpu_torch.models.convert import params_from_jax, vision_params_from_jax
from smg_tpu_torch.models.weights import load_vision_params
from smg_tpu_torch.multimodal import image as timage
from smg_tpu_torch.multimodal import processor as tproc
from smg_tpu_torch.ops.rope import apply_mrope, apply_rope, rope_frequencies
from smg_tpu_torch.protocols.sampling import SamplingParams
from smg_tpu_torch.tokenizer import MockTokenizer

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)
PIXEL_ATOL = 1e-3  # resized pixels, in units of the 0-255 input


# ---- M-RoPE ----


@pytest.mark.parametrize("lead", [(), (3,)], ids=["one", "grouped"])
def test_apply_mrope_matches_reference(lead):
    rng = np.random.default_rng(len(lead))
    T, H, D, section = 11, 4, 16, (2, 3, 3)
    x = rng.standard_normal((*lead, T, H, D)).astype(np.float32)
    pos = rng.integers(0, 60, (*lead, 3, T)).astype(np.int32)
    inv = jrope.rope_frequencies(D, 10000.0)
    want = jrope.apply_mrope(jnp.asarray(x), jnp.asarray(pos), jnp.asarray(inv), section)
    got = apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), torch.from_numpy(inv),
                      section)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("section", [(2, 3, 3), (16, 24, 24)])
def test_apply_mrope_is_apply_rope_bitwise_for_equal_ids(section):
    D = 2 * sum(section)
    rng = np.random.default_rng(D)
    x = torch.from_numpy(rng.standard_normal((2, 9, 3, D)).astype(np.float32))
    pos = torch.from_numpy(rng.integers(0, 4000, (2, 9)).astype(np.int32))
    inv = torch.from_numpy(rope_frequencies(D, 1000000.0))
    three = pos[:, None, :].expand(2, 3, 9)
    assert torch.equal(apply_mrope(x, three, inv, section), apply_rope(x, pos, inv))


MROPE_CASES = [
    (10, []),
    (12, [(2, 2, 3)]),
    (20, [(9, 3, 2), (1, 2, 2)]),  # unsorted runs
    (7, [(0, 1, 7)]),  # a 1 x n grid: delta 0
    (8, [(5, 2, 2)]),  # the run overruns the prompt
]


@pytest.mark.parametrize("n,images", MROPE_CASES)
def test_mrope_positions_match_reference(n, images):
    try:
        want = jmrope.mrope_positions(n, images)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).replace("[", r"\[").replace(")", r"\)")):
            tmrope.mrope_positions(n, images)
        return
    got = tmrope.mrope_positions(n, images)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == want[0].dtype and got[1] == want[1]


RUN_CASES = [
    ([3, 4, 5, 6, 10, 11], [(2, 2), (1, 2)]),
    ([3, 4, 5, 6], [(2, 2), (0, 0)]),
    ([3, 4, 5], [(2, 2)]),  # shorter than the grids
    ([3, 4, 6, 7], [(2, 2)]),  # not contiguous
    ([3, 4, 5, 6, 7], [(2, 2)]),  # longer than the grids
]


@pytest.mark.parametrize("positions,grids", RUN_CASES)
def test_image_runs_from_positions_match_reference(positions, grids):
    pos = np.asarray(positions)
    try:
        want = jmrope.image_runs_from_positions(pos, grids)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            tmrope.image_runs_from_positions(pos, grids)
        return
    assert tmrope.image_runs_from_positions(pos, grids) == want


# ---- the vision tower ----


@functools.lru_cache(maxsize=None)
def jax_vision_params(seed: int = 1, out_hidden: int = 128):
    cfg = jvit.tiny_vision_config(out_hidden)
    p = jax.jit(functools.partial(jvit.init_vision_params, cfg))(jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, p)


def _leaves(tree, path=()) -> dict:
    """{key path: leaf} of a nested dict."""
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _leaves(tree[key], path + (key,)).items()}
    return {path: tree}


def test_init_vision_params_shapes_match_reference():
    cfg = tvit.tiny_vision_config()
    got = _leaves(tvit.init_vision_params(cfg, torch.Generator().manual_seed(0), "cpu"))
    want = _leaves(jax_vision_params())
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}


@pytest.mark.parametrize("grid,q_tile", [((4, 4), 512), ((4, 8), 512), ((6, 10), 16)],
                         ids=["square", "4x8", "tiles"])
def test_forward_vision_matches_reference(grid, q_tile):
    cfg = tvit.tiny_vision_config()
    jp = jax_vision_params()
    rng = np.random.default_rng(grid[1])
    pixels = rng.standard_normal((grid[0] * grid[1], cfg.patch_dim)).astype(np.float32)
    want = np.asarray(jvit.forward_vision(jax.tree.map(jnp.asarray, jp),
                                          jvit.tiny_vision_config(), jnp.asarray(pixels), grid))
    got = tvit.forward_vision(vision_params_from_jax(jp), cfg, torch.from_numpy(pixels), grid,
                              q_tile=q_tile)
    assert got.shape == want.shape == (grid[0] * grid[1] // 4, 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_vision_peak_bytes_bound_the_reserve():
    """The planner sets the tower's peak at the largest image aside: 5120
    patches at patch 14, scores tiled (a tile's float32 scores, not N x N)."""
    cfg = tvit.VisionConfig(dtype="bfloat16")
    assert tvit.max_patches(cfg) == 5120
    peak = tvit.vision_peak_bytes(cfg, 5120)
    assert peak < 16 * 5120 * 5120 * 4  # under the reference's scores alone
    model = dataclasses.replace(tmodels.tiny_test_config(), vision=cfg)
    assert vision_reserve_bytes(model) == peak
    assert vision_reserve_bytes(tmodels.tiny_test_config()) == 0
    cache = tconf.CacheConfig(num_pages=8, auto_size=True)
    free = 10 * peak
    pages = plan_cache(model, cache, free, reserve_bytes=peak).num_pages
    assert pages < plan_cache(model, cache, free).num_pages


# ---- image operations and the processor ----


def _image(h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("src,dst", [((13, 17), (28, 36)), ((40, 33), (9, 7)),
                                     ((20, 12), (8, 30)), ((16, 16), (16, 40))],
                         ids=["enlarge", "shrink", "mixed", "one-axis"])
def test_resize_image_matches_reference(src, dst):
    img = _image(*src)
    want = np.asarray(jimage.resize_image(jnp.asarray(img), *dst))
    got = timage.resize_image(img, *dst, device="cpu").numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=PIXEL_ATOL)


@pytest.mark.parametrize("hw,kw", [((40, 30), {}), ((600, 500), {"max_pixels": 64 * 64})],
                         ids=["enlarge", "shrink"])
def test_qwen2vl_processor_matches_reference(hw, kw):
    img = _image(*hw, seed=hw[0])
    want = jproc.Qwen2VLImageProcessor(patch_size=4, merge_size=2, **kw).process(img)
    got = tproc.Qwen2VLImageProcessor(patch_size=4, merge_size=2, device="cpu",
                                      **kw).process(img)
    assert (got.grid, got.num_placeholder_tokens, got.llm_grid) == \
        (want.grid, want.num_placeholder_tokens, want.llm_grid)
    atol = PIXEL_ATOL / 255.0 / min(jimage.DEFAULT_STD)
    np.testing.assert_allclose(got.pixel_values.numpy(), np.asarray(want.pixel_values),
                               rtol=0, atol=atol)
    patches, grid = timage.patchify(torch.arange(8 * 12 * 3.0).reshape(8, 12, 3), 4)
    ref = jimage.patchify(jnp.arange(8 * 12 * 3.0).reshape(8, 12, 3), 4)
    assert grid == ref[1]
    np.testing.assert_array_equal(patches.numpy(), np.asarray(ref[0]))


def test_processor_registry_matches_reference_for_the_ported_family():
    for name in ("qwen2_vl", "Qwen/Qwen2-VL-7B-Instruct", "qwen3_vl"):
        got = tproc.get_image_processor(name, device="cpu")
        assert type(got).__name__ == type(jproc.get_image_processor(name)).__name__
    got = tproc.processor_for_worker("tiny-vlm", patch_size=4, merge_size=2, device="cpu")
    want = jproc.processor_for_worker("tiny-vlm", patch_size=4, merge_size=2)
    assert (type(got).__name__, got.patch_size, got.merge_size, got.max_pixels) == \
        (type(want).__name__, want.patch_size, want.merge_size, want.max_pixels)
    for name in ("llava-1.5", "internvl2", "pixtral-12b"):
        got = tproc.processor_for_worker(name, device="cpu")
        want = jproc.processor_for_worker(name)
        assert type(got).__name__ == type(want).__name__
        assert {k: v for k, v in vars(got).items() if k != "device"} == vars(want)


# ---- config and checkpoint ----


# Qwen2-VL-7B-Instruct's published config.json (the fields the mapping reads)
QWEN2_VL_7B = {
    "architectures": ["Qwen2VLForConditionalGeneration"], "bos_token_id": 151643,
    "eos_token_id": 151645, "vision_start_token_id": 151652,
    "vision_end_token_id": 151653, "vision_token_id": 151654, "image_token_id": 151655,
    "video_token_id": 151656, "hidden_act": "silu", "hidden_size": 3584,
    "initializer_range": 0.02, "intermediate_size": 18944,
    "max_position_embeddings": 32768, "max_window_layers": 28, "model_type": "qwen2_vl",
    "num_attention_heads": 28, "num_hidden_layers": 28, "num_key_value_heads": 4,
    "rms_norm_eps": 1e-06, "rope_theta": 1000000.0, "sliding_window": 32768,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16", "use_cache": True,
    "use_sliding_window": False, "vocab_size": 152064,
    "vision_config": {"depth": 32, "embed_dim": 1280, "mlp_ratio": 4, "num_heads": 16,
                      "in_chans": 3, "hidden_size": 3584, "patch_size": 14,
                      "spatial_merge_size": 2, "spatial_patch_size": 14,
                      "temporal_patch_size": 2},
    "rope_scaling": {"type": "mrope", "mrope_section": [16, 24, 24]},
}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_from_hf_config_reads_qwen2_vl_as_the_reference(dtype, tmp_path):
    want = jmodels.ModelConfig.from_hf_config(QWEN2_VL_7B, dtype=dtype)
    (tmp_path / "config.json").write_text(json.dumps(QWEN2_VL_7B))
    for got in (ModelConfig.from_hf_config(QWEN2_VL_7B, dtype=dtype),
                ModelConfig.from_pretrained(str(tmp_path), dtype=dtype)):
        for f in dataclasses.fields(ModelConfig):
            a, b = getattr(got, f.name), getattr(want, f.name)
            if f.name == "vision":
                assert dataclasses.asdict(a) == dataclasses.asdict(b)
            else:
                assert a == b, f.name
        assert got.mrope_section == want.mrope_section == (16, 24, 24)
        assert got.vision.intermediate_size == 5120 and got.vision.head_dim == 80
    # a vision config on a name without "vl" builds a text model, as in the reference
    text = dict(QWEN2_VL_7B, architectures=["Qwen2ForCausalLM"])
    assert ModelConfig.from_hf_config(text).vision is None
    assert jmodels.ModelConfig.from_hf_config(text).vision is None


def _vision_checkpoint(path, conv3d: bool) -> dict:
    """A random Qwen2-VL-style ``visual.*`` checkpoint of the tiny tower."""
    vcfg = tvit.tiny_vision_config()
    rng = np.random.default_rng(int(conv3d))
    H, I, m2 = vcfg.hidden_size, vcfg.intermediate_size, vcfg.merge_size ** 2
    ps, C = vcfg.patch_size, vcfg.in_channels

    def r(*shape):
        return (rng.standard_normal(shape) * 0.05).astype(np.float32)

    t = {"visual.patch_embed.proj.weight": r(H, C, 2, ps, ps) if conv3d else r(H, C, ps, ps)}
    for i in range(vcfg.num_layers):
        p = f"visual.blocks.{i}"
        t.update({f"{p}.norm1.weight": r(H) + 1.0, f"{p}.norm1.bias": r(H),
                  f"{p}.attn.qkv.weight": r(3 * H, H), f"{p}.attn.qkv.bias": r(3 * H),
                  f"{p}.attn.proj.weight": r(H, H), f"{p}.attn.proj.bias": r(H),
                  f"{p}.norm2.weight": r(H) + 1.0, f"{p}.norm2.bias": r(H),
                  f"{p}.mlp.fc1.weight": r(I, H), f"{p}.mlp.fc1.bias": r(I),
                  f"{p}.mlp.fc2.weight": r(H, I), f"{p}.mlp.fc2.bias": r(H)})
    t.update({"visual.merger.ln_q.weight": r(H) + 1.0, "visual.merger.ln_q.bias": r(H),
              "visual.merger.mlp.0.weight": r(H * m2, H * m2),
              "visual.merger.mlp.0.bias": r(H * m2),
              "visual.merger.mlp.2.weight": r(128, H * m2), "visual.merger.mlp.2.bias": r(128)})
    save_file(t, str(path / "model.safetensors"))
    return t


def _vlm_engine_configs(path):
    j = jconf.EngineConfig(model=jmodels.tiny_vlm_config(), model_path=str(path))
    t = tconf.EngineConfig(model=tmodels.tiny_vlm_config(), model_path=str(path))
    return j, t


@pytest.mark.parametrize("conv3d", [False, True], ids=["conv2d", "conv3d"])
def test_load_vision_params_equals_the_reference_loader(tmp_path, conv3d):
    tensors = _vision_checkpoint(tmp_path, conv3d)
    jcfg, tcfg = _vlm_engine_configs(tmp_path)
    want = _leaves(jload_vision(jcfg))
    got = load_vision_params(tcfg, device="cpu")
    got_leaves = _leaves(got)
    assert sorted(got_leaves) == sorted(want)
    for k, a in got_leaves.items():
        b = np.asarray(want[k])
        assert a.numpy().dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a.numpy(), b)
    # the flatten order against torch's own convolution
    vcfg = tcfg.model.vision
    ps = vcfg.patch_size
    img = np.random.default_rng(3).standard_normal((2 * ps, 3 * ps, 3)).astype(np.float32)
    patches, _ = timage.patchify(torch.from_numpy(img), ps)
    ours = patches @ got["patch_embed"]
    w = torch.from_numpy(tensors["visual.patch_embed.proj.weight"])
    ti = torch.from_numpy(img).permute(2, 0, 1)[None]
    if conv3d:
        out = F.conv3d(ti.unsqueeze(2).repeat(1, 1, 2, 1, 1), w, stride=(2, ps, ps))[0, :, 0]
    else:
        out = F.conv2d(ti, w, stride=ps)[0]
    torch.testing.assert_close(ours, out.permute(1, 2, 0).reshape(-1, vcfg.hidden_size),
                               rtol=1e-4, atol=1e-4)


def test_a_missing_vision_tensor_raises_the_reference_key_error(tmp_path):
    tensors = _vision_checkpoint(tmp_path, False)
    del tensors["visual.merger.mlp.2.bias"]
    save_file(tensors, str(tmp_path / "model.safetensors"))
    jcfg, tcfg = _vlm_engine_configs(tmp_path)
    with pytest.raises(KeyError) as ref:
        jload_vision(jcfg)
    with pytest.raises(KeyError) as got:
        load_vision_params(tcfg, device="cpu")
    assert str(got.value) == str(ref.value)


# ---- engines: the port against the JAX package ----


CONFIGS = {"vlm": (jmodels.tiny_vlm_config, tmodels.tiny_vlm_config),
           "mrope": (jmodels.tiny_vlm_mrope_config, tmodels.tiny_vlm_mrope_config)}
SCHED = dict(max_batch_size=4, max_seq_len=256, max_prefill_tokens=64,
             decode_batch_buckets=(4,), decode_horizon=4)


@functools.lru_cache(maxsize=None)
def lm_params(seed: int = 0):
    cfg = jmodels.tiny_vlm_config()
    p = jax.jit(functools.partial(jl.init_params, cfg))(jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, p)


def jax_engine(name: str, num_pages: int = 128, **kw):
    sched = {**SCHED, "prefill_token_buckets": (16, 32, 64)}
    sched.update({k: v for k, v in kw.items() if k != "tokenizer"})
    cfg = jconf.EngineConfig(
        model=CONFIGS[name][0](),
        cache=jconf.CacheConfig(page_size=16, num_pages=num_pages, auto_size=False,
                                dtype="float32"),
        scheduler=jconf.SchedulerConfig(**sched), dtype="float32", seed=0,
        model_id="tiny-vlm")
    return JaxEngine(cfg, tokenizer=kw.get("tokenizer"),
                     params=jax.tree.map(jnp.asarray, lm_params()),
                     vision_params=jax.tree.map(jnp.asarray, jax_vision_params()))


def port_engine(name: str, num_pages: int = 128, **kw):
    sched = {**SCHED, **{k: v for k, v in kw.items() if k != "tokenizer"}}
    cfg = tconf.EngineConfig(
        model=CONFIGS[name][1](),
        cache=tconf.CacheConfig(page_size=16, num_pages=num_pages, auto_size=False,
                                dtype="float32"),
        scheduler=tconf.SchedulerConfig(**sched), seed=0, model_id="tiny-vlm")
    return Engine(cfg, params=params_from_jax(lm_params()), device="cpu",
                  tokenizer=kw.get("tokenizer"),
                  vision_params=vision_params_from_jax(jax_vision_params()))


# images as patch grids of the tiny tower (patch 4, merge 2): the merged
# grid is half of each side
def _pixels(gh: int, gw: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(100 + seed)
    return rng.standard_normal((gh * gw, 48)).astype(np.float32)


IMAGES = {"A": (4, 4), "B": (8, 16), "C": (6, 4), "D": (4, 4)}


def g(n, **kw):
    return dict(temperature=0.0, max_new_tokens=n, ignore_eos=True, **kw)


def prompt(*parts):
    """Token ids from parts: a list of ids, or an image name (its merged
    grid's placeholder run of 500s).  Returns (ids, images) with images
    [(name, start)]."""
    ids, images = [], []
    for p in parts:
        if isinstance(p, str):
            gh, gw = IMAGES[p]
            images.append((p, len(ids)))
            ids += [500] * (gh // 2 * gw // 2)
        else:
            ids += list(p)
    return ids, images


def _text(n, seed):
    return np.random.default_rng(seed).integers(2, 499, n).tolist()


WAVE = [
    # the image run [40, 72) crosses the first chunk's end (64)
    ("img_long", prompt(_text(40, 1), "B", _text(40, 2)), g(6)),
    ("img_a", prompt(_text(5, 3), "A", _text(10, 4)), g(8)),
    ("text", prompt(_text(20, 5)), g(8)),
    ("two_img", prompt(_text(3, 6), "A", _text(4, 7), "C", _text(5, 8)), g(7)),
]


def run(engine, jobs, max_steps=3000) -> dict:
    """Submit every job (each image encoded by the engine itself), step
    inline until all finished; rid -> (tokens, finish, cached_tokens,
    logprobs)."""
    cls = JaxSamplingParams if isinstance(engine, JaxEngine) else SamplingParams
    chunks: dict[str, list] = {}
    for rid, (ids, images), kw in jobs:
        chunks[rid] = []
        mm = None
        if images:
            embeds, positions, grids = [], [], []
            for name, start in images:
                gh, gw = IMAGES[name]
                embeds.append(np.asarray(engine.encode_image(
                    _pixels(gh, gw, ord(name)), (gh, gw)), np.float32))
                n = gh // 2 * gw // 2
                positions += range(start, start + n)
                grids.append((gh // 2, gw // 2))
            mm = (np.concatenate(embeds), np.asarray(positions), grids)
        engine.submit(ids, cls(**kw), rid=rid, on_output=chunks[rid].append, mm_embeds=mm)
    for _ in range(max_steps):
        if not engine.scheduler.has_work():
            break
        engine.step()
    else:
        raise TimeoutError("jobs stuck")
    return {rid: ([t for o in c for t in o.new_token_ids], c[-1].finish_reason,
                  c[-1].cached_tokens, [x for o in c for x in o.logprobs])
            for rid, c in chunks.items()}


def assert_same_streams(got: dict, want: dict) -> None:
    assert {r: v[:3] for r, v in got.items()} == {r: v[:3] for r, v in want.items()}
    for rid in want:
        np.testing.assert_allclose(got[rid][3], want[rid][3], **TOL)


def assert_clean(engine):
    audit = engine.audit()
    assert audit["quiescent"] and audit["clean"] and audit["leaked_pages"] == 0, audit


# the radix wave after WAVE: the same image shares, another behind the same
# ids does not
RADIX = [("same", prompt(_text(5, 3), "A", _text(10, 4)), g(4)),
         ("other", prompt(_text(5, 3), "D", _text(10, 4)), g(4))]


@functools.lru_cache(maxsize=None)
def reference(name: str) -> dict:
    je = jax_engine(name)
    out = {"wave": run(je, WAVE)}
    out["radix"] = {job[0]: run(je, [job])[job[0]] for job in RADIX}
    return out


@pytest.fixture(scope="module", params=list(CONFIGS))
def vlm(request):
    return request.param, port_engine(request.param)


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "sync"])
def test_engine_matches_jax_engine(vlm, overlap):
    name, te = vlm
    te.scheduler.sched = dataclasses.replace(te.scheduler.sched, overlap_schedule=overlap)
    te.flush_cache()
    calls0, rows0 = te.runner.stats["prefill_calls"], te.runner.stats["prefill_rows"]
    got = run(te, WAVE)
    want = reference(name)["wave"]
    assert_same_streams(got, want)
    # a grouped prefill: more rows than forward calls
    assert te.runner.stats["prefill_rows"] - rows0 > te.runner.stats["prefill_calls"] - calls0
    if name == "mrope":  # the image lanes decode at an offset
        assert te.runner.graphs.steps and any(k[-1] for k in te.runner.graphs.steps)
    assert_clean(te)


def test_radix_content_keys_match_jax_engine(vlm):
    """The same image behind the same ids shares KV; another image behind
    them shares nothing (its first page holds the image)."""
    name, te = vlm
    te.scheduler.sched = dataclasses.replace(te.scheduler.sched, overlap_schedule=True)
    te.flush_cache()
    run(te, WAVE)
    got = {job[0]: run(te, [job])[job[0]] for job in RADIX}
    want = reference(name)["radix"]
    assert_same_streams(got, want)
    assert got["same"][2] > 0 and got["other"][2] == 0
    assert_clean(te)


def test_text_request_is_untouched_by_images_in_its_batch(vlm):
    name, te = vlm
    te.flush_cache()
    alone = run(te, [WAVE[2]])
    te.flush_cache()
    assert run(te, WAVE)["text"][0] == alone["text"][0]


def test_ngram_spec_lane_with_an_mrope_offset_matches_jax_engine():
    kw = dict(speculative=True, spec_max_draft=4)
    jobs = [("rep_img", prompt([5, 6, 7, 8] * 4, "A", [5, 6, 7, 8] * 4), g(16)),
            ("long_img", prompt(list(range(5, 120)), "C", [5, 6, 7]), g(12)),
            ("c1", prompt([11, 12, 13] * 8), g(12))]
    je, te = jax_engine("mrope", **kw), port_engine("mrope", **kw)
    want, got = run(je, jobs), run(te, jobs)
    assert_same_streams(got, want)
    js, ts = je.scheduler, te.scheduler
    assert (ts.num_spec_drafted, ts.num_spec_accepted) == \
        (js.num_spec_drafted, js.num_spec_accepted)
    assert ts.num_spec_drafted > 0 and te.runner.stats["verify_calls"] > 0
    assert any(k[-1] for k in te.runner.graphs.verify)  # the verify block took the offset
    assert_clean(te)


def test_preempted_image_lane_matches_jax_engine():
    """A pool too small for three image lanes: a preempted lane re-prefills
    its image and its generated tokens (text positions at the offset)."""
    kw = dict(max_seq_len=128, watermark_pages=1)
    jobs = [(f"p{i}", prompt(_text(6, 20 + i), "AC"[i % 2], _text(20, 30 + i)), g(40))
            for i in range(3)]
    je, te = jax_engine("mrope", num_pages=12, **kw), port_engine("mrope", num_pages=12, **kw)
    want, got = run(je, jobs), run(te, jobs)
    assert_same_streams(got, want)
    assert te.scheduler.num_preemptions == je.scheduler.num_preemptions > 0
    assert_clean(te)


def test_submit_validation_matches_reference():
    je, te = jax_engine("mrope"), port_engine("mrope")
    e = np.zeros((4, 128), np.float32)
    for mm in ((e, np.array([0, 1, 2, 9])), (e, np.array([0, 1, 2])),
               (e, np.array([1, 2, 4, 5]), [(2, 2)])):
        errs = []
        for eng, cls in ((je, JaxSamplingParams), (te, SamplingParams)):
            with pytest.raises(ValueError) as ei:
                eng.submit(list(range(8)), cls(max_new_tokens=2), mm_embeds=mm)
            errs.append(str(ei.value))
        assert errs[0] == errs[1]
    assert te.supports_vision and je.supports_vision
    text = Engine(tconf.EngineConfig(model=tmodels.tiny_test_config(),
                                     cache=tconf.CacheConfig(num_pages=8, auto_size=False)),
                  device="cpu")
    assert not text.supports_vision
    with pytest.raises(ValueError, match="no vision tower"):
        text.encode_image(e, (2, 2))


# ---- the gateway's image chat ----


def png_bytes(arr: np.ndarray) -> bytes:
    """An RGB uint8 [H, W, 3] array as a PNG file (zlib and struct only)."""
    h, w, _ = arr.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    raw = b"".join(b"\x00" + arr[r].tobytes() for r in range(h))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def data_uri(arr) -> str:
    return "data:image/png;base64," + base64.b64encode(png_bytes(arr)).decode()


def _strip(obj):
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in ("id", "created")}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def _image_chat(uri: str, **kw) -> dict:
    return {"model": "tiny-vlm", "max_tokens": 8, "temperature": 0, "ignore_eos": True,
            "messages": [{"role": "user", "content": [
                {"type": "text", "text": "w5"},
                {"type": "image_url", "image_url": {"url": uri}},
                {"type": "text", "text": "w6"}]}], **kw}


async def _post_all(server, ctx, bodies) -> list:
    tc = TestClient(TestServer(server.build_app(ctx)))
    await tc.start_server()
    try:
        out = []
        for body in bodies:
            resp = await tc.post("/v1/chat/completions", json=body)
            out.append((resp.status, await resp.json()))
        return out
    finally:
        await tc.close()
        for w in ctx.registry.list():
            await w.client.close()


def test_image_chat_answers_as_the_reference_gateway():
    rng = np.random.default_rng(7)
    bodies = [_image_chat(data_uri(rng.integers(0, 256, (24, 16, 3), dtype=np.uint8))),
              _image_chat("data:image/png;base64,%%%", max_tokens=4)]
    je = jax_engine("mrope", tokenizer=JaxMockTokenizer())
    jctx = jserver.AppContext(policy="round_robin")
    jctx.tokenizers.register("tiny-vlm", JaxMockTokenizer(), default=True)
    jctx.registry.add(JaxWorker(worker_id="inproc-0", client=JaxInProc(je),
                                model_id="tiny-vlm"))
    te = port_engine("mrope", tokenizer=MockTokenizer())
    tctx = tlaunch.build_context(te, policy="round_robin", drain_timeout_secs=2)
    want = asyncio.run(_post_all(jserver, jctx, bodies))
    got = asyncio.run(_post_all(tserver, tctx, bodies))
    assert [s for s, _ in got] == [s for s, _ in want] == [200, 400]
    assert _strip(got[0][1]) == _strip(want[0][1])
    assert got[0][1]["usage"]["prompt_tokens"] > 10  # the placeholder expanded
    assert got[1][1] == want[1][1] and "base64" in json.dumps(got[1][1])


def test_text_only_model_rejects_images_as_the_reference():
    body = _image_chat("data:,x", max_tokens=4)
    jcfg = jconf.EngineConfig(
        model=jmodels.tiny_test_config(),
        cache=jconf.CacheConfig(page_size=16, num_pages=16, auto_size=False,
                                dtype="float32"),
        scheduler=jconf.SchedulerConfig(max_batch_size=2, max_seq_len=64,
                                        max_prefill_tokens=32, prefill_token_buckets=(32,),
                                        decode_batch_buckets=(2,)),
        dtype="float32", model_id="text-only")
    je = JaxEngine(jcfg, tokenizer=JaxMockTokenizer())
    jctx = jserver.AppContext(policy="round_robin")
    jctx.tokenizers.register("text-only", JaxMockTokenizer(), default=True)
    jctx.registry.add(JaxWorker(worker_id="w0", client=JaxInProc(je), model_id="text-only"))
    te = Engine(tconf.EngineConfig(model=tmodels.tiny_test_config(),
                                   cache=tconf.CacheConfig(num_pages=16, auto_size=False),
                                   model_id="text-only"),
                device="cpu", tokenizer=MockTokenizer())
    tctx = tlaunch.build_context(te, policy="round_robin", drain_timeout_secs=2)
    (ws, wb), = asyncio.run(_post_all(jserver, jctx, [body]))
    (gs, gb), = asyncio.run(_post_all(tserver, tctx, [body]))
    assert gs == ws == 400 and gb == wb
    assert "image" in json.dumps(gb).lower()
