"""Parity: the port's checkpoint path (``smg_tpu_torch/models/config.py``
``from_hf_config``/``from_pretrained`` and ``models/weights.py``
``load_params``) against the JAX package's on HF directories the test
writes.

Each directory holds a ``config.json`` and safetensors weights in HF layout
(``[out, in]`` linears) made from the JAX ``init_params`` of the config the
reference reads from that ``config.json`` (numpy seeds, float32), in one
file or sharded with an index.  Families: Llama, Qwen3 (``qk_norm``),
Gemma-2 (four norms, softcaps, query scale, tied), Mistral (every layer
windowed) and a tied-embedding Llama.  Tolerance: none — the port's
tensors equal ``params_from_jax`` of the reference loader's output bitwise,
and its config equals the reference's field by field."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from smg_tpu.engine.config import EngineConfig as JEngineConfig
from smg_tpu.models import llama as jl
from smg_tpu.models.config import ModelConfig as JModelConfig
from smg_tpu.models.weights import load_params as jload
from smg_tpu_torch.engine.config import EngineConfig
from smg_tpu_torch.models.config import ModelConfig
from smg_tpu_torch.models.convert import params_from_jax
from smg_tpu_torch.models.weights import load_params

torch.set_num_threads(2)

_BASE = dict(vocab_size=320, hidden_size=64, intermediate_size=128, num_hidden_layers=3,
             num_attention_heads=4, num_key_value_heads=2, head_dim=16, rope_theta=10000.0,
             rms_norm_eps=1e-5, max_position_embeddings=2048, eos_token_id=[0, 2],
             bos_token_id=1, tie_word_embeddings=False)
HF_CONFIGS = {
    "llama": dict(_BASE, architectures=["LlamaForCausalLM"],
                  rope_scaling={"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                                "high_freq_factor": 4.0,
                                "original_max_position_embeddings": 1024}),
    "qwen3": dict(_BASE, architectures=["Qwen3ForCausalLM"], rope_theta=1000000.0),
    "gemma2": dict(_BASE, architectures=["Gemma2ForCausalLM"], query_pre_attn_scalar=32,
                   attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
                   sliding_window=24, tie_word_embeddings=True),
    "mistral": dict(_BASE, architectures=["MistralForCausalLM"], sliding_window=24),
    "tied": dict(_BASE, architectures=["LlamaForCausalLM"], tie_word_embeddings=True,
                 eos_token_id=2),
}


def hf_tensors(jcfg, seed: int) -> dict:
    """The JAX ``init_params`` of ``jcfg`` (numpy-seeded norms so they are
    not all ones) in HF names and layouts, float32."""
    p = jax.tree.map(np.asarray, jl.init_params(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    E, H, K, D = jcfg.hidden_size, jcfg.num_heads, jcfg.num_kv_heads, jcfg.head_dim
    lay = p["layers"]
    out = {"model.embed_tokens.weight": p["embed"],
           "model.norm.weight": rng.standard_normal(E).astype(np.float32)}
    if "lm_head" in p:
        out["lm_head.weight"] = p["lm_head"].T
    names = {"attn_norm": "input_layernorm", "mlp_norm": "post_attention_layernorm",
             "q_norm": "self_attn.q_norm", "k_norm": "self_attn.k_norm"}
    if jcfg.post_norms:
        names.update(mlp_norm="pre_feedforward_layernorm",
                     post_attn_norm="post_attention_layernorm",
                     post_mlp_norm="post_feedforward_layernorm")
    for i in range(jcfg.num_layers):
        pre = f"model.layers.{i}."
        out[pre + "self_attn.q_proj.weight"] = lay["wq"][i].reshape(E, H * D).T
        out[pre + "self_attn.k_proj.weight"] = lay["wk"][i].reshape(E, K * D).T
        out[pre + "self_attn.v_proj.weight"] = lay["wv"][i].reshape(E, K * D).T
        out[pre + "self_attn.o_proj.weight"] = lay["wo"][i].reshape(H * D, E).T
        out[pre + "mlp.gate_proj.weight"] = lay["w_gate"][i].T
        out[pre + "mlp.up_proj.weight"] = lay["w_up"][i].T
        out[pre + "mlp.down_proj.weight"] = lay["w_down"][i].T
        for key, hf in names.items():
            if key in lay:
                out[pre + hf + ".weight"] = rng.standard_normal(
                    lay[key][i].shape).astype(np.float32)
    return {k: np.ascontiguousarray(v, np.float32) for k, v in out.items()}


def write_dir(path, hf_config: dict, tensors: dict, shards: int = 1) -> None:
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(hf_config))
    names = sorted(tensors)
    if shards == 1:
        save_file(tensors, str(path / "model.safetensors"))
        return
    weight_map = {}
    for s in range(shards):
        fname = f"model-{s + 1:05d}-of-{shards:05d}.safetensors"
        part = {n: tensors[n] for n in names[s::shards]}
        save_file(part, str(path / fname))
        weight_map.update({n: fname for n in part})
    (path / "model.safetensors.index.json").write_text(json.dumps({"weight_map": weight_map}))


def _port_engine_cfg(path, dtype="float32") -> EngineConfig:
    return EngineConfig(model=ModelConfig.from_pretrained(str(path), dtype=dtype),
                        model_path=str(path))


def _assert_params_equal(got: dict, want: dict) -> None:
    assert set(got) == set(want) and set(got["layers"]) == set(want["layers"])
    for group_g, group_w in ((got, want), (got["layers"], want["layers"])):
        for k, w in group_w.items():
            if k == "layers":
                continue
            g = group_g[k]
            assert g.dtype == w.dtype and g.shape == w.shape, k
            assert torch.equal(g, w), k


@pytest.mark.parametrize("family", list(HF_CONFIGS))
def test_from_hf_config_equals_the_reference_field_by_field(family):
    hf = HF_CONFIGS[family]
    for dtype in ("bfloat16", "float32"):
        ref = JModelConfig.from_hf_config(hf, dtype=dtype)
        got = ModelConfig.from_hf_config(hf, dtype=dtype)
        for f in dataclasses.fields(ModelConfig):
            assert getattr(got, f.name) == getattr(ref, f.name), (family, f.name)


@pytest.mark.parametrize("family", list(HF_CONFIGS))
@pytest.mark.parametrize("shards", [1, 3])
def test_load_params_equals_params_from_jax_of_the_reference_loader(tmp_path, family, shards):
    hf = HF_CONFIGS[family]
    jcfg = JModelConfig.from_hf_config(hf, dtype="float32")
    write_dir(tmp_path, hf, hf_tensors(jcfg, seed=len(family) + shards), shards=shards)
    ref = jload(JEngineConfig(model=JModelConfig.from_pretrained(str(tmp_path)),
                              model_path=str(tmp_path), dtype="float32"))
    want = params_from_jax(jax.tree.map(np.asarray, ref))
    got = load_params(_port_engine_cfg(tmp_path), device="cpu")
    _assert_params_equal(got, want)
    assert ("lm_head" in got) == (not hf["tie_word_embeddings"])


def test_a_bf16_checkpoint_loads_in_bf16_and_widens_exactly(tmp_path):
    """Published checkpoints are bf16; the port reads them through torch.
    bf16 weights keep their bits, ``dtype="float32"`` widens them exactly,
    and both equal the reference loader's float32 output rounded to bf16."""
    from safetensors.torch import save_file as save_pt

    hf = HF_CONFIGS["llama"]
    tensors = hf_tensors(JModelConfig.from_hf_config(hf), seed=5)
    f32_dir, bf16_dir = tmp_path / "f32", tmp_path / "bf16"
    write_dir(f32_dir, hf, tensors)
    bf16_dir.mkdir()
    (bf16_dir / "config.json").write_text(json.dumps(hf))
    save_pt({k: torch.from_numpy(v).to(torch.bfloat16) for k, v in tensors.items()},
            str(bf16_dir / "model.safetensors"))
    ref32 = params_from_jax(jax.tree.map(np.asarray, jload(JEngineConfig(
        model=JModelConfig.from_pretrained(str(f32_dir)), model_path=str(f32_dir),
        dtype="float32"))))
    got16 = load_params(_port_engine_cfg(bf16_dir, "bfloat16"), device="cpu")
    got32 = load_params(_port_engine_cfg(bf16_dir, "float32"), device="cpu")
    want16 = {"layers": {k: v.to(torch.bfloat16) for k, v in ref32["layers"].items()},
              **{k: v.to(torch.bfloat16) for k, v in ref32.items() if k != "layers"}}
    _assert_params_equal(got16, want16)
    want32 = {"layers": {k: v.float() for k, v in want16["layers"].items()},
              **{k: v.float() for k, v in want16.items() if k != "layers"}}
    _assert_params_equal(got32, want32)


def test_a_missing_tensor_raises_the_reference_key_error(tmp_path):
    hf = HF_CONFIGS["llama"]
    tensors = hf_tensors(JModelConfig.from_hf_config(hf), seed=1)
    del tensors["model.layers.2.mlp.up_proj.weight"]
    write_dir(tmp_path, hf, tensors, shards=2)
    with pytest.raises(KeyError) as ref:
        jload(JEngineConfig(model=JModelConfig.from_pretrained(str(tmp_path)),
                            model_path=str(tmp_path), dtype="float32"))
    with pytest.raises(KeyError) as got:
        load_params(_port_engine_cfg(tmp_path), device="cpu")
    assert str(got.value) == str(ref.value)
    with pytest.raises(FileNotFoundError, match="no safetensors"):
        load_params(EngineConfig(model=ModelConfig(), model_path=str(tmp_path / "none")),
                    device="cpu")


@pytest.mark.parametrize("extra,item", [
    # MoE configs are accepted now (tests/test_torch_moe.py), and so is a
    # vision-language config (tests/test_torch_vision.py); the vision case
    # keeps the id it had beside them
    pytest.param({"architectures": ["Qwen2VLForConditionalGeneration"],
                  "vision_config": {"embed_dim": 32, "depth": 2}}, "item 10",
                 id="extra2-item 10"),
])
def test_moe_and_vision_configs_are_refused(tmp_path, extra, item):
    """Never a text model built from a config whose vision tower is not
    ported: the Qwen2-VL tower is ported, so its config now builds the
    tower, field for field as the reference does, and is refused no more."""
    hf = dict(_BASE, **extra)
    (tmp_path / "config.json").write_text(json.dumps(hf))
    want = JModelConfig.from_hf_config(hf)
    for got in (ModelConfig.from_hf_config(hf), ModelConfig.from_pretrained(str(tmp_path))):
        assert got.vision is not None and want.vision is not None
        assert dataclasses.asdict(got.vision) == dataclasses.asdict(want.vision)
        assert got.arch == want.arch == "qwen"
