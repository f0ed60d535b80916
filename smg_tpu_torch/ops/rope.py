"""Rotary position embeddings with Llama-3 frequency scaling (port of
``smg_tpu/ops/rope.py``; M-RoPE is not ported yet)."""

from __future__ import annotations

import numpy as np
import torch


def rope_frequencies(head_dim: int, theta: float, scaling: dict | None = None) -> np.ndarray:
    """Inverse frequencies [head_dim/2], with optional llama3-style scaling."""
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
    if scaling and scaling.get("rope_type", scaling.get("type")) == "llama3":
        factor = scaling.get("factor", 8.0)
        low_factor = scaling.get("low_freq_factor", 1.0)
        high_factor = scaling.get("high_freq_factor", 4.0)
        old_ctx = scaling.get("original_max_position_embeddings", 8192)
        low_wavelen = old_ctx / low_factor
        high_wavelen = old_ctx / high_factor
        wavelen = 2 * np.pi / inv_freq
        scaled = np.where(wavelen > low_wavelen, inv_freq / factor, inv_freq)
        smooth = (old_ctx / wavelen - low_factor) / (high_factor - low_factor)
        mid = (1 - smooth) * inv_freq / factor + smooth * inv_freq
        is_mid = (wavelen <= low_wavelen) & (wavelen >= high_wavelen)
        inv_freq = np.where(is_mid, mid, scaled)
    return inv_freq.astype(np.float32)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor) -> torch.Tensor:
    """Rotate-half rotary embedding (HF convention), computed in f32.

    x: [..., T, H, D]; positions broadcastable to [..., T]; inv_freq [D/2].
    """
    angles = positions[..., None].float() * inv_freq  # [..., T, D/2]
    cos = torch.cos(angles)[..., None, :]  # [..., T, 1, D/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
