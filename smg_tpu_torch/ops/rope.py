"""Rotary position embeddings with Llama-3 frequency scaling and Qwen2-VL's
multimodal rotary scheme (port of ``smg_tpu/ops/rope.py``)."""

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
    return _rotate_half(x, angles)


def _rotate_half(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """The rotate-half application both schemes share: x [..., T, H, D],
    angles [..., T, D/2]; computed in f32, returned in x's dtype."""
    cos = torch.cos(angles)[..., None, :]  # [..., T, 1, D/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mrope_angles(positions: torch.Tensor, inv_freq: torch.Tensor,
                 section: tuple) -> torch.Tensor:
    """Rotary angles [..., T, D/2] of M-RoPE position ids [..., 3, T]: the
    D/2 frequency slots split into ``section = (t, h, w)`` (static per
    config), each section reading the matching row of ``positions``."""
    # [D/2]: the position row (temporal, height, width) each frequency reads
    sel = torch.from_numpy(np.repeat(np.arange(3), np.asarray(section, np.int64)))
    pos_f = positions.float().transpose(-2, -1).index_select(-1, sel.to(positions.device))
    return pos_f * inv_freq


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, inv_freq: torch.Tensor,
                section: tuple) -> torch.Tensor:
    """Multimodal rotary embedding (Qwen2-VL M-RoPE): x [..., T, H, D],
    positions [..., 3, T] (leading dims broadcast with x's, e.g. the
    grouped-prefill batch).  Text tokens carry three equal ids, which makes
    this exactly ``apply_rope`` for them, bit for bit."""
    return _rotate_half(x, mrope_angles(positions, inv_freq, section))
