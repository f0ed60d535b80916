"""Model architecture config — the port's own copy of
``smg_tpu/models/config.py``: the dense decoder fields and presets.  The
vision tower and the HF ``config.json`` loader wait for checkpoint loading."""

from __future__ import annotations

import dataclasses
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
    # MoE (0 = dense); the port serves dense models only so far
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
