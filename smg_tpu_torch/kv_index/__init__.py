"""Cache-state index structures for cache-aware routing — the port's copy of
``smg_tpu/kv_index`` (the Python radix tree and the positional indexer;
``kv_index.native`` is the C++ tree the cache-aware policy takes where it
builds)."""

from smg_tpu_torch.kv_index.positional import PositionalIndexer
from smg_tpu_torch.kv_index.radix_tree import RadixTree

__all__ = ["RadixTree", "PositionalIndexer"]
