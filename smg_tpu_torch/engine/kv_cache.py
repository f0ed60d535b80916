"""Paged KV cache: host-side page pool and device buffers (port of
``smg_tpu/engine/kv_cache.py``).

Device layout ``[num_layers, num_pages, page_size, kv_heads*head_dim]``
(fused lanes, see ``ops/attention.py``).  Page 0 is the reserved garbage page
for padded/inactive writes, so the allocator never hands it out.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from smg_tpu_torch.engine.config import CacheConfig
from smg_tpu_torch.models.config import ModelConfig
from smg_tpu_torch.models.llama import torch_dtype


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


def plan_cache(model: ModelConfig, cache: CacheConfig,
               free_bytes: int | None = None) -> KvCacheSpec:
    """Decide num_pages.  With ``auto_size`` and a known free device-memory
    figure (``torch.cuda.mem_get_info``, taken after the weights are
    resident), give ``hbm_utilization`` of it to KV; otherwise use the
    configured num_pages."""
    spec = KvCacheSpec(
        num_layers=model.num_layers, num_pages=cache.num_pages,
        page_size=cache.page_size, num_kv_heads=model.num_kv_heads,
        head_dim=model.head_dim, dtype=cache.dtype,
    )
    if cache.auto_size and free_bytes is not None:
        budget = int(free_bytes * cache.hbm_utilization)
        spec.num_pages = int(max(budget // spec.bytes_per_page, 16))
    return spec


def create_kv_buffers(spec: KvCacheSpec, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Allocate zeroed K and V buffers on ``device``."""
    dtype = torch_dtype(spec.dtype)
    return (torch.zeros(spec.shape, dtype=dtype, device=device),
            torch.zeros(spec.shape, dtype=dtype, device=device))
