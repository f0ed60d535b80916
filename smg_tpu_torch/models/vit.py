"""Vision tower: Qwen2-VL-class ViT encoder — port of
``smg_tpu/models/vit.py``.

Patch embedding is one matrix product over pre-patchified pixels (the
gateway runs ``multimodal.image.patchify``), then full-attention blocks with
Qwen2-VL's 2D rotary embedding (each patch's (row, col) grid coordinate
rotates half the head dims each), then the 2x2 spatial-merge MLP that
projects into the language model's hidden space (the "merger").  Patch
order is row-major over (gh, gw).

Parameters keep the JAX package's tree and layouts (``init_vision_params``):
``patch_embed [patch_dim, H]``; ``layers`` stacked ``[L, ...]`` with
right-multiply linears (``qkv_w [L, H, 3H]``, ``fc1_w [L, H, I]``, ...) and
layer norms as ``{"scale", "bias"}``; ``merger`` with ``ln_q``, ``mlp0_*``
and ``mlp2_*``.  The JAX ``lax.scan`` over layers is a Python loop.

Attention.  The reference computes float32 scores and probabilities for
every head over all patches at once, ``[heads, N, N]``: at Qwen2-VL-7B's
tower (16 heads) and the processor's ``max_pixels`` (N = 5120 patches) that
is 1.68 GB for the scores alone, per layer.  Here the queries go through in
tiles of ``VISION_QUERY_TILE`` with the keys whole, so each softmax row is
still taken over all its keys at once; the scores stay float32, and the
scratch is bounded by the tile (``vision_peak_bytes``).  Torch ops only:
the reference computes the tower in XLA, with no Pallas kernel.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

VISION_QUERY_TILE = 512  # queries of one attention tile of forward_vision
# the Qwen2-VL processor's default pixel budget (``multimodal/image.py``):
# the largest image the gateway hands the tower, 1,003,520 pixels
MAX_PIXELS = 14 * 14 * 4 * 1280
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


@dataclass(frozen=True)
class VisionConfig:
    hidden_size: int = 1280
    intermediate_size: int = 5120
    num_layers: int = 32
    num_heads: int = 16
    patch_size: int = 14
    merge_size: int = 2
    in_channels: int = 3
    out_hidden_size: int = 2048  # language model hidden
    layer_norm_eps: float = 1e-6
    dtype: str = "float32"

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.patch_size * self.patch_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def tiny_vision_config(out_hidden_size: int = 128) -> VisionConfig:
    """Tiny tower for CPU tests (pairs with models.config.tiny_test_config)."""
    return VisionConfig(
        hidden_size=64, intermediate_size=128, num_layers=2, num_heads=4,
        patch_size=4, merge_size=2, out_hidden_size=out_hidden_size,
    )


def init_vision_params(cfg: VisionConfig, generator: torch.Generator,
                       device: torch.device | str) -> dict:
    """Random weights with the shapes and He-style scales of the JAX
    package's ``init_vision_params``.  The numbers differ (no threefry);
    tests that need identical weights bridge them with
    ``models/convert.py::vision_params_from_jax``."""
    dtype = _DTYPES[cfg.dtype]
    H, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    m2 = cfg.merge_size * cfg.merge_size

    def dense(fan_in, shape):
        out = torch.empty(shape, dtype=dtype, device=device)
        if len(shape) == 3:  # layer by layer: bounded f32 scratch
            for i in range(shape[0]):
                out[i] = dense(fan_in, shape[1:])
            return out
        out.copy_(torch.randn(shape, generator=generator, device=device,
                              dtype=torch.float32) / math.sqrt(fan_in))
        return out

    def const(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    def norm(lead=()):
        return {"scale": const((*lead, H), 1.0), "bias": const((*lead, H), 0.0)}

    layers = {
        "ln1": norm((L,)),
        "qkv_w": dense(H, (L, H, 3 * H)),
        "qkv_b": const((L, 3 * H), 0.0),
        "proj_w": dense(H, (L, H, H)),
        "proj_b": const((L, H), 0.0),
        "ln2": norm((L,)),
        "fc1_w": dense(H, (L, H, I)),
        "fc1_b": const((L, I), 0.0),
        "fc2_w": dense(I, (L, I, H)),
        "fc2_b": const((L, H), 0.0),
    }
    return {
        "patch_embed": dense(cfg.patch_dim, (cfg.patch_dim, H)),
        "layers": layers,
        "merger": {
            "ln_q": norm(),
            "mlp0_w": dense(H * m2, (H * m2, H * m2)),
            "mlp0_b": const((H * m2,), 0.0),
            "mlp2_w": dense(H * m2, (H * m2, cfg.out_hidden_size)),
            "mlp2_b": const((cfg.out_hidden_size,), 0.0),
        },
    }


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float) -> torch.Tensor:
    """LayerNorm in float32 (population variance), returned in x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)


def _rope_2d(x: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Qwen2-VL vision rotary: the first half of the head dims rotates by
    row position, the second half by column.  x: [N, h, d]."""
    d = x.shape[-1]
    half = d // 2
    quarter = half // 2
    inv = 1.0 / (10000.0 ** (torch.arange(quarter, dtype=torch.float32,
                                          device=x.device) / quarter))
    fr = rows.float()[:, None] * inv[None, :]  # [N, quarter]
    fc = cols.float()[:, None] * inv[None, :]
    freqs = torch.cat([fr, fc], dim=-1)  # [N, half]
    cos = torch.cos(freqs)[:, None, :]
    sin = torch.sin(freqs)[:, None, :]
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
               q_tile: int) -> torch.Tensor:
    """Full (bidirectional) attention over the patches in float32: q, k, v
    [N, h, d] -> [N, h, d] in q's dtype.  Queries in tiles of ``q_tile``,
    each softmax row over all N keys at once."""
    N = q.shape[0]
    qf = q.float().transpose(0, 1)  # [h, N, d]
    kt = k.float().permute(1, 2, 0)  # [h, d, N]
    vf = v.float().transpose(0, 1)  # [h, N, d]
    out = torch.empty_like(q)
    for s in range(0, N, q_tile):
        e = min(s + q_tile, N)
        scores = torch.bmm(qf[:, s:e], kt).mul_(scale)  # [h, tq, N]
        probs = torch.softmax(scores, dim=-1)
        del scores
        out[s:e] = torch.bmm(probs, vf).transpose(0, 1).to(q.dtype)
    return out


def forward_vision(params: dict, cfg: VisionConfig, pixel_values: torch.Tensor,
                   grid: tuple[int, int], q_tile: int = VISION_QUERY_TILE) -> torch.Tensor:
    """Encode one image's patches ``pixel_values`` [N, patch_dim] (row-major
    over ``grid`` = (gh, gw)) -> [gh*gw / merge^2, out_hidden_size] in the
    tower's dtype."""
    gh, gw = int(grid[0]), int(grid[1])
    N = gh * gw
    H, nh, d, m = cfg.hidden_size, cfg.num_heads, cfg.head_dim, cfg.merge_size
    eps = cfg.layer_norm_eps
    scale = 1.0 / math.sqrt(d)
    pe = params["patch_embed"]
    dev = pe.device
    rows = torch.arange(gh, device=dev).repeat_interleave(gw)  # [N] row-major
    cols = torch.arange(gw, device=dev).repeat(gh)

    ly = params["layers"]
    h = torch.matmul(pixel_values.to(device=dev, dtype=pe.dtype), pe)
    for l in range(cfg.num_layers):
        hn = _layer_norm(h, ly["ln1"]["scale"][l], ly["ln1"]["bias"][l], eps)
        qkv = torch.matmul(hn, ly["qkv_w"][l]) + ly["qkv_b"][l]  # [N, 3H]
        q, k, v = qkv.split(H, dim=-1)
        q = _rope_2d(q.reshape(N, nh, d), rows, cols)
        k = _rope_2d(k.reshape(N, nh, d), rows, cols)
        attn = _attention(q, k, v.reshape(N, nh, d), scale, q_tile)
        h = h + (torch.matmul(attn.reshape(N, H).to(h.dtype), ly["proj_w"][l])
                 + ly["proj_b"][l])
        hn = _layer_norm(h, ly["ln2"]["scale"][l], ly["ln2"]["bias"][l], eps)
        act = F.gelu(torch.matmul(hn, ly["fc1_w"][l]) + ly["fc1_b"][l], approximate="tanh")
        h = h + (torch.matmul(act, ly["fc2_w"][l]) + ly["fc2_b"][l])

    # spatial merge: each m x m block of neighbouring patches becomes one
    # language-model token (the Qwen2-VL merger)
    mg = params["merger"]
    h = _layer_norm(h, mg["ln_q"]["scale"], mg["ln_q"]["bias"], eps)
    h = h.reshape(gh // m, m, gw // m, m, H).permute(0, 2, 1, 3, 4)
    h = h.reshape((gh // m) * (gw // m), m * m * H)
    h = F.gelu(torch.matmul(h, mg["mlp0_w"]) + mg["mlp0_b"], approximate="tanh")
    return torch.matmul(h, mg["mlp2_w"]) + mg["mlp2_b"]


def max_patches(cfg: VisionConfig, max_pixels: int = MAX_PIXELS) -> int:
    """Patches of the largest image the processor emits for this tower."""
    return max_pixels // (cfg.patch_size * cfg.patch_size)


def vision_peak_bytes(cfg: VisionConfig, n_patches: int,
                      q_tile: int = VISION_QUERY_TILE) -> int:
    """Device memory one ``forward_vision`` over ``n_patches`` holds above
    its weights at its peak, bounded above: the layer's activations in the
    tower's dtype (h, the normed input, qkv, the rotated q and k, the
    attention output and the projections: 9 x H a patch; the MLP's product
    and activation: 3 x I), their float32 widenings (q, k, v for the
    products and the rotary intermediates: 7 x H), and one query tile's
    float32 scores, probabilities and the softmax's scratch."""
    item = _DTYPES[cfg.dtype].itemsize
    H, I = cfg.hidden_size, cfg.intermediate_size
    per_patch = item * (9 * H + 3 * I) + 4 * 7 * H
    tile = 3 * 4 * cfg.num_heads * min(q_tile, n_patches) * n_patches
    return n_patches * per_patch + tile


# HF checkpoint key mapping (Qwen2-VL "visual." tree) for models/weights.py.
# conv weights [H, C, (T,) ps, ps] flatten to [patch_dim, H] in the
# (ps, ps, C) order patchify uses.
HF_VISION_MAPPING = {
    "patch_embed": "visual.patch_embed.proj.weight",
    "layers.{i}.ln1": "visual.blocks.{i}.norm1",
    "layers.{i}.qkv_w": "visual.blocks.{i}.attn.qkv.weight",
    "layers.{i}.qkv_b": "visual.blocks.{i}.attn.qkv.bias",
    "layers.{i}.proj_w": "visual.blocks.{i}.attn.proj.weight",
    "layers.{i}.proj_b": "visual.blocks.{i}.attn.proj.bias",
    "layers.{i}.ln2": "visual.blocks.{i}.norm2",
    "layers.{i}.fc1_w": "visual.blocks.{i}.mlp.fc1.weight",
    "layers.{i}.fc1_b": "visual.blocks.{i}.mlp.fc1.bias",
    "layers.{i}.fc2_w": "visual.blocks.{i}.mlp.fc2.weight",
    "layers.{i}.fc2_b": "visual.blocks.{i}.mlp.fc2.bias",
    "merger.ln_q": "visual.merger.ln_q",
    "merger.mlp0_w": "visual.merger.mlp.0.weight",
    "merger.mlp0_b": "visual.merger.mlp.0.bias",
    "merger.mlp2_w": "visual.merger.mlp.2.weight",
    "merger.mlp2_b": "visual.merger.mlp.2.bias",
}
