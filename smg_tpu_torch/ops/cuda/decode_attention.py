"""Paged decode attention: wrapper of ``csrc/decode_attention.cu``.

Port of ``smg_tpu/ops/pallas/decode_attention.py::paged_attention_decode_cached``.
The plain version beside it is ``ops/attention.py::attention_decode_cached``.

The kernel splits each sequence's context over several blocks
(flash-decoding).  Who decides what:

- this wrapper picks the split count S, an upper bound for every sequence,
  from the batch, the KV heads and the table capacity (no device read: the
  entries stay on the card);
- the kernel cuts each sequence's actual keys into at most S splits of
  whole warp tiles, and never into splits shorter than one tile per warp;
- the library sizes the scratch for (dtype, B, H, K, D, S)
  (``smg_decode_scratch``), since only the kernel knows its head groups.

The f32 partials are allocated per call (inside a CUDA graph capture they
come from the graph's pool, which is fine while graphs sharing a pool never
run concurrently).  The arrival counters are zeroed once and left zeroed by
every launch: launches on one stream run one after another, so they can
share one buffer.  A caller that captures launches into CUDA graphs passes
its own ``counters``, sized once for the largest batch it will run
(``counter_ints``); otherwise the wrapper keeps one buffer per (device,
stream) and replaces it by a larger one when B x H outgrows it, which would
leave a graph captured earlier pointing at freed memory.

``launches`` counts kernel launches.  A launch recorded into a CUDA graph
runs only when the graph replays, so the code that captures and replays
graphs keeps the count right (``engine/graphs.py``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from smg_tpu_torch.ops.attention import attention_decode_cached
from smg_tpu_torch.ops.cuda import build
from smg_tpu_torch.ops.cuda._checks import (
    DTYPE_CODES,
    check_cuda,
    dtype_code,
    raise_on_error,
    require,
)

MAX_HEAD_DIM = 256  # kernel bound
SM_COUNT = 132  # streaming multiprocessors of an H100 SXM
TARGET_BLOCKS = SM_COUNT  # a block per SM at least (two fit on each)
MAX_SPLITS = 32  # kernel bound (MAX_SPLITS in csrc/decode_attention.cu)
# a long context is cut this fine even when the batch alone fills the card,
# so one long row of a ragged batch does not set the kernel's time
KEYS_PER_SPLIT = 512
# S is never so large that a table-filling context gets splits under 64
# keys: below that a split's fixed cost (its merge, its page-table reads)
# outweighs its share of the bytes.  This is the wrapper's rule alone; the
# kernel's own floor for an actual context is one warp tile per warp (64
# keys in bfloat16, 16-32 in float32).
MIN_SPLIT_KEYS = 64
launches = 0  # kernel launches in this process (reset by the caller)
# arrival counters per (device, stream handle), zero between launches
_counters: dict[tuple[torch.device, int], torch.Tensor] = {}


def num_splits(B: int, K: int, max_keys: int) -> int:
    """Blocks per (sequence, KV head) along the context, for contexts of up
    to ``max_keys`` keys: enough for ``TARGET_BLOCKS`` in all, or one per
    ``KEYS_PER_SPLIT`` keys if that is more, at most ``MAX_SPLITS``, and
    none shorter than ``MIN_SPLIT_KEYS``.  The kernel cuts each sequence's
    actual keys into at most this many equal splits."""
    want = max(-(-TARGET_BLOCKS // max(B * K, 1)), max_keys // KEYS_PER_SPLIT)
    return max(1, min(want, max_keys // MIN_SPLIT_KEYS, MAX_SPLITS))


@functools.lru_cache(maxsize=256)
def _scratch(dtype: int, B: int, H: int, K: int, D: int, S: int) -> tuple[int, int]:
    """(partial floats, counter ints) a launch needs, from the library."""
    floats, ints = ctypes.c_longlong(), ctypes.c_longlong()
    err = build.load().smg_decode_scratch(dtype, B, H, K, D, S, ctypes.byref(floats),
                                          ctypes.byref(ints))
    raise_on_error(err, "decode_attention scratch")
    return floats.value, ints.value


def counter_ints(dtype: torch.dtype, B: int, H: int, K: int, D: int) -> int:
    """Arrival counters a launch at batch B needs (any split count)."""
    return _scratch(DTYPE_CODES[dtype], B, H, K, D, 1)[1]


def _counter_buffer(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    """Zeroed once and replaced by a larger one when the batch's head count
    grows; the kernel's last block per (sequence, head group) resets its
    slot, so no memset runs per call."""
    buf = _counters.get((dev, stream))
    if buf is None or buf.numel() < n:
        old = 0 if buf is None else buf.numel()
        buf = torch.zeros(max(n, 2 * old), dtype=torch.int32, device=dev)
        _counters[(dev, stream)] = buf
    return buf


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
    counters: torch.Tensor | None = None,  # zeroed int32 arrival counters
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
    require(D % 8 == 0 and D <= MAX_HEAD_DIM,
            f"head_dim {D}: multiple of 8, <= {MAX_HEAD_DIM}")
    require(KD % D == 0 and H % (KD // D) == 0, f"H={H}, K*D={KD}, D={D}: bad GQA shape")
    K = KD // D
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
    splits = num_splits(B, K, mp * ps + N)
    dtype = dtype_code(q)
    n_part, n_counters = _scratch(dtype, B, H, K, D, splits)
    out = torch.empty_like(q)
    part = torch.empty(n_part, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if counters is None:
        counters = _counter_buffer(q.device, stream, n_counters)
    require(counters.dtype == torch.int32 and counters.numel() >= n_counters
            and counters.device == q.device, f"counters: {n_counters} int32 on {q.device}")
    err = build.load().smg_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), hk.data_ptr(),
        hv.data_ptr(), page_tables.data_ptr(), entry_positions.data_ptr(),
        out.data_ptr(), part.data_ptr(), counters.data_ptr(), dtype, B, H, K, D,
        P, ps, mp, N, int(n_extra), int(layer), int(window or 0), float(scale),
        float(softcap or 0.0), splits, stream,
    )
    raise_on_error(err, "decode_attention")
    global launches
    launches += 1
    return out
