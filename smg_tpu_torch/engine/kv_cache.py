"""Paged KV cache: host-side page pool and device buffers (port of
``smg_tpu/engine/kv_cache.py``).

Device layout ``[num_layers, num_pages, page_size, kv_heads*head_dim]``
(fused lanes, see ``ops/attention.py``).  Page 0 is the reserved garbage page
for padded/inactive writes, so the allocator never hands it out.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from smg_tpu_torch.engine.config import CacheConfig, SchedulerConfig
from smg_tpu_torch.models.config import ModelConfig
from smg_tpu_torch.models.llama import moe_scratch_bytes, torch_dtype
from smg_tpu_torch.parallel.sharding import rank_config


class OutOfPagesError(RuntimeError):
    pass


class PagePool:
    """Free-list page allocator.  Page 0 is the reserved garbage page."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        self.num_pages = num_pages
        self._free: list[int] = list(range(num_pages - 1, 0, -1))  # pop() yields 1,2,...

    @property
    def free_count(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise OutOfPagesError(f"requested {n} pages, {len(self._free)} free")
        return [self._free.pop() for _ in range(n)]

    def free(self, pages: list[int]) -> None:
        for p in pages:
            if p == 0:
                raise ValueError("page 0 is reserved and never allocated")
            self._free.append(p)


@dataclass
class KvCacheSpec:
    num_layers: int
    num_pages: int
    page_size: int
    num_kv_heads: int
    head_dim: int
    dtype: str

    @property
    def shape(self) -> tuple[int, ...]:
        return (self.num_layers, self.num_pages, self.page_size,
                self.num_kv_heads * self.head_dim)

    @property
    def bytes_per_page(self) -> int:
        # k + v, all layers
        itemsize = torch.empty((), dtype=torch_dtype(self.dtype)).element_size()
        return (2 * self.num_layers * self.page_size * self.num_kv_heads
                * self.head_dim * itemsize)


def moe_reserve_bytes(model: ModelConfig, sched: SchedulerConfig) -> int:
    """Device memory the expert layer needs beside the KV cache: one
    prefill tile's scratch (eager launches, the allocator's own pool) and
    one decode or verify launch's (the CUDA graphs' pool, which keeps its
    blocks between replays): the largest decode bucket times the widest
    horizon or verify block, each capped at a tile.  0 for a dense model."""
    widest = max(sched.horizon_cap, sched.spec_max_draft + 1 if sched.speculative else 1)
    return (moe_scratch_bytes(model, sched.max_prefill_tokens)
            + moe_scratch_bytes(model, max(sched.decode_batch_buckets) * widest))


def vision_reserve_bytes(model: ModelConfig) -> int:
    """Device memory the vision tower needs beside the KV cache: its peak
    above the weights (``models/vit.py::vision_peak_bytes``) for the largest
    image the gateway's processor emits (``max_pixels``: 5120 patches at
    patch 14).  ``encode_image`` runs eagerly on the allocator's own pool,
    between steps.  0 for a text model."""
    if model.vision is None:
        return 0
    from smg_tpu_torch.models.vit import max_patches, vision_peak_bytes

    return vision_peak_bytes(model.vision, max_patches(model.vision))


def plan_cache(model: ModelConfig, cache: CacheConfig,
               free_bytes: int | None = None,
               draft: ModelConfig | None = None,
               reserve_bytes: int = 0, tp: int = 1, pp: int = 1) -> KvCacheSpec:
    """Decide num_pages.  With ``auto_size`` and a known free device-memory
    figure (``torch.cuda.mem_get_info``, taken after the weights, the
    draft model's included, are resident), give ``hbm_utilization`` of it
    to KV; otherwise use the configured num_pages.  ``reserve_bytes``
    (``moe_reserve_bytes`` and ``vision_reserve_bytes``) comes off the
    free figure first: at 61 GB of
    Qwen3-30B-A3B weights on an 80 GB card, the tenth that the utilization
    leaves is about 2 GB, less than a prefill chunk's expert scratch and a
    graph pool together.  A ``draft`` model (``engine/draft.py``) keeps a
    cache of its own with a page for every page of the target's, so each
    page costs both.

    ``tp`` > 1 plans one tensor-parallel rank's cache, as the reference
    sizes KV per device from ``tp``: ``model`` is the whole model, the spec
    holds the rank's KV heads (``parallel/sharding.py::rank_config``: a
    share of them, or one replicated head), and ``free_bytes`` is the
    rank's share of its device.  ``pp`` > 1 plans one pipeline stage's
    cache: its ``L / pp`` layers, the reference's KV sharded on its layer
    axis over pp."""
    if tp > 1 or pp > 1:
        model = rank_config(model, tp, pp)
    spec = KvCacheSpec(
        num_layers=model.num_layers, num_pages=cache.num_pages,
        page_size=cache.page_size, num_kv_heads=model.num_kv_heads,
        head_dim=model.head_dim, dtype=cache.dtype,
    )
    if cache.auto_size and free_bytes is not None:
        per_page = spec.bytes_per_page
        if draft is not None:
            per_page += KvCacheSpec(
                num_layers=draft.num_layers, num_pages=0, page_size=cache.page_size,
                num_kv_heads=draft.num_kv_heads, head_dim=draft.head_dim,
                dtype=cache.dtype).bytes_per_page
        budget = int(max(free_bytes - reserve_bytes, 0) * cache.hbm_utilization)
        spec.num_pages = int(max(budget // per_page, 16))
    return spec


def create_kv_buffers(spec: KvCacheSpec, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Allocate zeroed K and V buffers on ``device``."""
    dtype = torch_dtype(spec.dtype)
    return (torch.zeros(spec.shape, dtype=dtype, device=device),
            torch.zeros(spec.shape, dtype=dtype, device=device))
