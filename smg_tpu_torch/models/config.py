"""Model architecture config — the port's own copy of
``smg_tpu/models/config.py``: the decoder fields, the HF ``config.json``
loader for the families this port serves (Llama, Mistral, Qwen2/Qwen3,
Gemma-2, the Qwen-MoE family and Qwen2-VL) and the presets (``PRESETS``,
under the reference's names).

A vision-language config is read as the reference reads it: a
``vision_config`` builds a tower (``models/vit.py::VisionConfig``) only when
the architecture's name has "vl" in it, and ``rope_scaling.mrope_section``
turns on M-RoPE.  Like the reference, the mapping has no field for Qwen2's
q/k/v projection biases, so a Qwen2-VL language model is served without
them.

Qwen-MoE configs are read exactly as the reference reads them: the expert
count (``num_experts`` or ``num_routed_experts``), ``num_experts_per_tok``
and ``moe_intermediate_size``.  Like the reference, the mapping has no field
for Qwen2-MoE's shared expert or for ``norm_topk_prob: false``: the top-k
softmax is always normalised (Qwen3-MoE's ``norm_topk_prob: true``)."""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    arch: str = "llama"
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 500000.0
    rope_scaling: dict | None = None
    rms_norm_eps: float = 1e-5
    max_position_embeddings: int = 8192
    tie_word_embeddings: bool = False
    eos_token_ids: tuple[int, ...] = (128001, 128009)
    bos_token_id: int = 128000
    dtype: str = "bfloat16"
    # MoE (0 = dense): Qwen-MoE family, every layer's MLP is the expert layer
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_intermediate_size: int = 0
    # Qwen3-family: per-head RMSNorm on q/k before rope
    qk_norm: bool = False
    # ---- Gemma-2-family knobs (all default to llama semantics) ----
    activation: str = "silu"  # "silu" | "gelu_tanh"
    rms_unit_offset: bool = False  # RMSNorm scales by (1 + weight)
    embed_scale: bool = False  # multiply token embeddings by sqrt(hidden)
    post_norms: bool = False  # post-attention/post-ffn RMSNorms
    attn_logit_softcap: float | None = None
    final_logit_softcap: float | None = None
    query_scale: float | None = None  # 1/sqrt(query_pre_attn_scalar) override
    # sliding window: every ``sliding_window_pattern``-th layer is GLOBAL,
    # the rest local; pattern <= 0 = every layer windowed (Mistral)
    sliding_window: int | None = None
    sliding_window_pattern: int = 2
    # vision tower (VLM; None = text-only).  ``image_token_id`` is the
    # placeholder the gateway expands per image (Qwen2-VL <|image_pad|>)
    vision: "object | None" = None  # models.vit.VisionConfig
    image_token_id: int | None = None

    @property
    def mrope_section(self) -> "tuple[int, ...] | None":
        """Qwen2-VL M-RoPE frequency split (t, h, w) from rope_scaling; None
        = standard rope (engine/mrope.py)."""
        if not self.rope_scaling:
            return None
        sec = self.rope_scaling.get("mrope_section")
        return tuple(sec) if sec else None

    @classmethod
    def from_hf_config(cls, cfg: dict, dtype: str = "bfloat16") -> "ModelConfig":
        """The reference's mapping of an HF ``config.json`` (its fields,
        defaults and family switches)."""
        name = (cfg.get("architectures") or ["LlamaForCausalLM"])[0].lower()
        if "qwen3moe" in name or "qwen2moe" in name:
            arch = "qwen_moe"
        elif "qwen" in name:
            arch = "qwen"
        else:
            arch = "llama"  # Mistral: the llama family
        eos = cfg.get("eos_token_id", 2)
        num_heads = cfg["num_attention_heads"]
        extra: dict = {}
        if "mistral" in name and cfg.get("sliding_window"):
            # Mistral v0.1-style: every layer windowed (pattern 0)
            extra = dict(sliding_window=cfg["sliding_window"], sliding_window_pattern=0)
        if "gemma2" in name or "gemma-2" in name:
            q_scalar = cfg.get("query_pre_attn_scalar") or cfg.get("head_dim", 256)
            extra = dict(
                activation="gelu_tanh", rms_unit_offset=True, embed_scale=True,
                post_norms=True,
                attn_logit_softcap=cfg.get("attn_logit_softcapping", 50.0),
                final_logit_softcap=cfg.get("final_logit_softcapping", 30.0),
                query_scale=1.0 / (q_scalar ** 0.5),
                sliding_window=cfg.get("sliding_window"),
                tie_word_embeddings=cfg.get("tie_word_embeddings", True),
            )
        vision = None
        vc = cfg.get("vision_config")
        if vc and "vl" in name:
            from smg_tpu_torch.models.vit import VisionConfig

            vh = vc.get("embed_dim") or vc.get("hidden_size", 1280)
            vision = VisionConfig(
                hidden_size=vh,
                intermediate_size=vc.get("intermediate_size") or vh * 4,
                num_layers=vc.get("depth") or vc.get("num_hidden_layers", 32),
                num_heads=vc.get("num_heads") or vc.get("num_attention_heads", 16),
                patch_size=vc.get("patch_size", 14),
                merge_size=vc.get("spatial_merge_size", 2),
                in_channels=vc.get("in_channels", vc.get("in_chans", 3)),
                out_hidden_size=cfg["hidden_size"],
                dtype=dtype,
            )
        return cls(
            arch=arch,
            vocab_size=cfg["vocab_size"],
            hidden_size=cfg["hidden_size"],
            intermediate_size=cfg.get("intermediate_size", 4 * cfg["hidden_size"]),
            num_layers=cfg["num_hidden_layers"],
            num_heads=num_heads,
            num_kv_heads=cfg.get("num_key_value_heads", num_heads),
            head_dim=cfg.get("head_dim") or cfg["hidden_size"] // num_heads,
            rope_theta=cfg.get("rope_theta", 10000.0),
            rope_scaling=cfg.get("rope_scaling"),
            rms_norm_eps=cfg.get("rms_norm_eps", 1e-5),
            max_position_embeddings=cfg.get("max_position_embeddings", 8192),
            tie_word_embeddings=extra.pop("tie_word_embeddings",
                                          cfg.get("tie_word_embeddings", False)),
            eos_token_ids=tuple(eos) if isinstance(eos, list) else (eos,),
            bos_token_id=cfg.get("bos_token_id", 1),
            dtype=dtype,
            num_experts=cfg.get("num_experts", cfg.get("num_routed_experts", 0)) or 0,
            num_experts_per_tok=cfg.get("num_experts_per_tok", 0) or 0,
            moe_intermediate_size=cfg.get("moe_intermediate_size", 0) or 0,
            vision=vision,
            image_token_id=cfg.get("image_token_id"),
            qk_norm="qwen3" in name,  # Qwen3 (dense and MoE): q/k RMSNorm before rope
            **extra,
        )

    @classmethod
    def from_pretrained(cls, path: str, dtype: str = "bfloat16") -> "ModelConfig":
        with open(os.path.join(path, "config.json")) as f:
            return cls.from_hf_config(json.load(f), dtype=dtype)


def tiny_test_config(vocab_size: int = 512) -> ModelConfig:
    """Tiny model for CPU tests: 4 layers, GQA 8q/2kv, head_dim 16."""
    return ModelConfig(
        vocab_size=vocab_size, hidden_size=128, intermediate_size=256,
        num_layers=4, num_heads=8, num_kv_heads=2, head_dim=16,
        rope_theta=10000.0, max_position_embeddings=2048,
        eos_token_ids=(0,), bos_token_id=1, dtype="float32",
    )


def llama32_1b_config() -> ModelConfig:
    return ModelConfig(
        vocab_size=128256, hidden_size=2048, intermediate_size=8192,
        num_layers=16, num_heads=32, num_kv_heads=8, head_dim=64,
        rope_theta=500000.0,
        rope_scaling={"rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
                      "high_freq_factor": 4.0, "original_max_position_embeddings": 8192},
        tie_word_embeddings=True,
    )


def llama3_8b_config() -> ModelConfig:
    return ModelConfig(
        vocab_size=128256, hidden_size=4096, intermediate_size=14336,
        num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
        rope_theta=500000.0,
    )


def llama3_70b_config() -> ModelConfig:
    return ModelConfig(
        vocab_size=128256, hidden_size=8192, intermediate_size=28672,
        num_layers=80, num_heads=64, num_kv_heads=8, head_dim=128,
        rope_theta=500000.0,
    )


def tiny_gemma2_config(vocab_size: int = 512) -> ModelConfig:
    """Tiny Gemma-2-style model: gelu MLP, (1+w) norms, scaled embeddings,
    post norms, attn/final softcaps, tied unembed."""
    return dataclasses.replace(
        tiny_test_config(vocab_size),
        activation="gelu_tanh", rms_unit_offset=True, embed_scale=True,
        post_norms=True, attn_logit_softcap=50.0, final_logit_softcap=30.0,
        query_scale=1.0 / (32.0 ** 0.5), sliding_window=4096,
        tie_word_embeddings=True,
    )


def tiny_moe_config() -> ModelConfig:
    """Tiny Qwen-MoE-style config for CPU tests: 4 experts, top-2."""
    return dataclasses.replace(
        tiny_test_config(), arch="qwen_moe", num_experts=4, num_experts_per_tok=2,
        moe_intermediate_size=128,
    )


def tiny_vlm_config() -> ModelConfig:
    """Tiny Qwen2-VL-style VLM for CPU tests: the tiny LLM and the tiny
    vision tower.  Token 500 plays <|image_pad|>."""
    from smg_tpu_torch.models.vit import tiny_vision_config

    base = tiny_test_config()
    return dataclasses.replace(
        base, vision=tiny_vision_config(out_hidden_size=base.hidden_size),
        image_token_id=500)


def tiny_vlm_mrope_config() -> ModelConfig:
    """Tiny VLM with Qwen2-VL M-RoPE on (head_dim 16 -> D/2 = 8 = 2+3+3
    frequency sections)."""
    return dataclasses.replace(
        tiny_vlm_config(), rope_scaling={"type": "mrope", "mrope_section": [2, 3, 3]})


#: ``serve --model-preset`` names, the reference's for the configs this port has
PRESETS = {
    "tiny": tiny_test_config,
    "tiny-gemma2": tiny_gemma2_config,
    "tiny-moe": tiny_moe_config,
    "tiny-vlm": tiny_vlm_config,
    "llama3.2-1b": llama32_1b_config,
    "llama3-8b": llama3_8b_config,
    "llama3-70b": llama3_70b_config,
}
