"""Normalization ops (port of ``smg_tpu/ops/norms.py``): RMSNorm computed in
f32 regardless of the activation dtype."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5,
             unit_offset: bool = False) -> torch.Tensor:
    """``unit_offset`` = Gemma convention: scale by (1 + weight)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    w = weight.float()
    if unit_offset:
        w = 1.0 + w
    return (out * w).to(x.dtype)
