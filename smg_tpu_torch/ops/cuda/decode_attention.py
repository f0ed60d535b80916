"""Paged decode attention: wrapper of ``csrc/decode_attention.cu``.

Port of ``smg_tpu/ops/pallas/decode_attention.py::paged_attention_decode_cached``.
The plain version beside it is ``ops/attention.py::attention_decode_cached``.
"""

from __future__ import annotations

import torch

from smg_tpu_torch.ops.attention import attention_decode_cached
from smg_tpu_torch.ops.cuda import build
from smg_tpu_torch.ops.cuda._checks import (
    check_cuda,
    dtype_code,
    raise_on_error,
    require,
)

MAX_GROUP_DIM = 2048  # kernel bound: (H // K) * head_dim
launches = 0  # kernel launches in this process (reset by the caller)


def paged_attention_decode_cached(
    q: torch.Tensor,  # [B, H, D] post-rope queries
    k_cache: torch.Tensor,  # [L, P, ps, K*D] read-only cache
    v_cache: torch.Tensor,
    hk: torch.Tensor,  # [B, N, K*D] horizon side buffer (this layer)
    hv: torch.Tensor,
    n_extra: int,  # valid side rows (current token included)
    layer: int,
    page_tables: torch.Tensor,  # [B, mp] int32
    entry_positions: torch.Tensor,  # [B] int32: cache token count at horizon entry
    scale: float,
    softcap: float | None = None,
    window: int | None = None,  # sliding window (None/<=0 = global)
) -> torch.Tensor:
    """Returns [B, H, D] in q's dtype.  CUDA tensors launch the kernel;
    CPU tensors get the plain PyTorch version."""
    if q.device.type == "cpu":
        return attention_decode_cached(
            q, k_cache, v_cache, hk, hv, n_extra, layer, page_tables,
            entry_positions, scale, softcap=softcap, window=window,
        )
    B, H, D = q.shape
    L, P, ps, KD = k_cache.shape
    N = hk.shape[1]
    require(D % 8 == 0, f"head_dim {D} must be a multiple of 8")
    require(KD % D == 0 and H % (KD // D) == 0, f"H={H}, K*D={KD}, D={D}: bad GQA shape")
    K = KD // D
    require((H // K) * D <= MAX_GROUP_DIM, f"(H/K)*D must be <= {MAX_GROUP_DIM}")
    require(v_cache.shape == k_cache.shape, "k_cache and v_cache shapes differ")
    require(tuple(hk.shape) == (B, N, KD) and hv.shape == hk.shape,
            f"side buffers must be [{B}, N, {KD}]")
    require(1 <= n_extra <= N, f"n_extra {n_extra} outside [1, {N}]")
    require(0 <= layer < L, f"layer {layer} outside [0, {L})")
    require(page_tables.dim() == 2 and page_tables.shape[0] == B, "page_tables must be [B, mp]")
    require(tuple(entry_positions.shape) == (B,), "entry_positions must be [B]")
    check_cuda({"q": q, "k_cache": k_cache, "v_cache": v_cache, "hk": hk, "hv": hv},
               dtype=q.dtype)
    check_cuda({"page_tables": page_tables, "entry_positions": entry_positions},
               dtype=torch.int32)
    mp = page_tables.shape[1]
    out = torch.empty_like(q)
    lib = build.load()
    err = lib.smg_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), hk.data_ptr(),
        hv.data_ptr(), page_tables.data_ptr(), entry_positions.data_ptr(),
        out.data_ptr(), dtype_code(q), B, H, K, D, P, ps, mp, N, int(n_extra),
        int(layer), int(window or 0), float(scale), float(softcap or 0.0),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    raise_on_error(err, "decode_attention")
    global launches
    launches += 1
    return out
