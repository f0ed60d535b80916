"""Paged prefill attention: wrapper of ``csrc/prefill_attention.cu``.

Port of ``smg_tpu/ops/pallas/prefill_attention.py::paged_attention_prefill``,
with a sequence axis: one launch serves every row of a grouped prefill.
The plain version beside it is ``gather_seq_kv`` + ``attention_prefill``
(``ops/attention.py``), which reads the chunk's K/V back from the cache, so
callers scatter the chunk before attention, as the models do.
"""

from __future__ import annotations

import threading
import weakref

import torch

from smg_tpu_torch.ops.attention import attention_prefill_batched
from smg_tpu_torch.ops.cuda import build
from smg_tpu_torch.ops.cuda._checks import (
    check_cuda,
    dtype_code,
    raise_on_error,
    require,
)

MAX_GROUP = 64  # kernel bound: query heads per KV head
MAX_HEAD_DIM = 256
launches = 0  # kernel launches in this process (reset by the caller)
_launches_lock = threading.Lock()  # engines on several threads launch
_by_thread: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()  # Thread -> launches


def launches_of(thread: threading.Thread) -> int:
    """``thread``'s launches so far (one engine's, among several in a
    process, when its steps run on a thread of their own)."""
    with _launches_lock:
        return _by_thread.get(thread, 0)


def plain_prefill_batched(q, k_cache, v_cache, layer, page_tables, prefix_lens,
                          t_reals, scale, softcap=None, window=None):
    """Plain version: gather each row's pages and run dense masked attention
    (the JAX package's gather path)."""
    Gs, T, H, D = q.shape
    L, P, ps, KD = k_cache.shape
    K = KD // D
    idx = page_tables.to(device=k_cache.device, dtype=torch.long)
    mp = idx.shape[1]
    k_ctx = k_cache[layer][idx].reshape(Gs, mp * ps, K, D)
    v_ctx = v_cache[layer][idx].reshape(Gs, mp * ps, K, D)
    pl = prefix_lens.to(device=q.device, dtype=torch.long)
    pos = pl[:, None] + torch.arange(T, device=q.device)[None, :]
    ctx = pl + t_reals.to(device=q.device, dtype=torch.long)
    return attention_prefill_batched(q, k_ctx, v_ctx, pos, ctx, scale,
                                     softcap=softcap, window=window)


def paged_attention_prefill_batched(
    q: torch.Tensor,  # [Gs, T, H, D] post-rope chunk queries
    chunk_k: torch.Tensor,  # [Gs, T, K*D] post-rope chunk keys
    chunk_v: torch.Tensor,
    k_cache: torch.Tensor,  # [L, P, ps, K*D] (chunk already scattered)
    v_cache: torch.Tensor,
    layer: int,
    page_tables: torch.Tensor,  # [Gs, mp] int32
    prefix_lens: torch.Tensor,  # [Gs] int32: cached tokens before each chunk
    t_reals: torch.Tensor,  # [Gs] int32: valid chunk rows
    scale: float,
    softcap: float | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """Returns [Gs, T, H, D] in q's dtype (rows past t_real are padding).
    CUDA tensors launch the kernel; CPU tensors get the plain version."""
    if q.device.type == "cpu":
        return plain_prefill_batched(q, k_cache, v_cache, layer, page_tables,
                                     prefix_lens, t_reals, scale, softcap, window)
    Gs, T, H, D = q.shape
    L, P, ps, KD = k_cache.shape
    require(D % 8 == 0 and D <= MAX_HEAD_DIM, f"head_dim {D}: multiple of 8, <= {MAX_HEAD_DIM}")
    require(KD % D == 0 and H % (KD // D) == 0, f"H={H}, K*D={KD}, D={D}: bad GQA shape")
    K = KD // D
    require(H // K <= MAX_GROUP, f"at most {MAX_GROUP} query heads per KV head")
    require(v_cache.shape == k_cache.shape, "k_cache and v_cache shapes differ")
    require(tuple(chunk_k.shape) == (Gs, T, KD) and chunk_v.shape == chunk_k.shape,
            f"chunk K/V must be [{Gs}, {T}, {KD}]")
    require(0 <= layer < L, f"layer {layer} outside [0, {L})")
    require(page_tables.dim() == 2 and page_tables.shape[0] == Gs, "page_tables must be [Gs, mp]")
    require(tuple(prefix_lens.shape) == (Gs,) and tuple(t_reals.shape) == (Gs,),
            "prefix_lens and t_reals must be [Gs]")
    check_cuda({"q": q, "chunk_k": chunk_k, "chunk_v": chunk_v,
                "k_cache": k_cache, "v_cache": v_cache}, dtype=q.dtype)
    check_cuda({"page_tables": page_tables, "prefix_lens": prefix_lens,
                "t_reals": t_reals}, dtype=torch.int32)
    mp = page_tables.shape[1]
    out = torch.empty_like(q)
    lib = build.load()
    err = lib.smg_prefill_attention(
        q.data_ptr(), chunk_k.data_ptr(), chunk_v.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), page_tables.data_ptr(), prefix_lens.data_ptr(),
        t_reals.data_ptr(), out.data_ptr(), dtype_code(q), Gs, T, H, K, D, P, ps,
        mp, int(layer), int(window or 0), float(scale), float(softcap or 0.0),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    raise_on_error(err, "prefill_attention")
    global launches
    me = threading.current_thread()
    with _launches_lock:
        launches += 1
        _by_thread[me] = _by_thread.get(me, 0) + 1
    return out


def paged_attention_prefill(
    q: torch.Tensor,  # [T, H, D]
    chunk_k: torch.Tensor,  # [T, K*D]
    chunk_v: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    layer: int,
    page_table: torch.Tensor,  # [mp] int32
    prefix_len: torch.Tensor,  # [1] int32
    t_real: torch.Tensor,  # [1] int32
    scale: float,
    softcap: float | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """Prefix-aware chunked-prefill attention for ONE sequence: [T, H, D]."""
    return paged_attention_prefill_batched(
        q[None], chunk_k[None], chunk_v[None], k_cache, v_cache, layer,
        page_table[None], prefix_len.reshape(1), t_real.reshape(1), scale,
        softcap=softcap, window=window,
    )[0]
