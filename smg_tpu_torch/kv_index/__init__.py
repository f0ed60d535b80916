"""Cache-state index structures for cache-aware routing — the port's copy of
``smg_tpu/kv_index`` (the Python radix tree and the positional indexer; the
native C++ tree is not ported)."""

from smg_tpu_torch.kv_index.positional import PositionalIndexer
from smg_tpu_torch.kv_index.radix_tree import RadixTree

__all__ = ["RadixTree", "PositionalIndexer"]
