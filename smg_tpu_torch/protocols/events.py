"""KV-cache event types — the port's copy of ``smg_tpu/protocols/events.py``.

Reference: ``crates/grpc_client/proto/common.proto:19-63`` — workers publish
block-stored / block-removed / all-cleared events; the gateway's
``KvEventMonitor`` feeds them to the ``PositionalIndexer`` for cache-aware
routing (SURVEY.md §3.5).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class BlockStored:
    block_hashes: list[int]
    token_ids: list[int]
    parent_block_hash: int | None = None
    block_size: int = 0
    lora_id: int | None = None


@dataclass
class BlockRemoved:
    block_hashes: list[int]


@dataclass
class AllBlocksCleared:
    pass


KvEvent = BlockStored | BlockRemoved | AllBlocksCleared


@dataclass
class KvEventBatch:
    """A batch of KV events with a monotone sequence number for resumable
    subscription (reference: ``common.proto:19-29`` ``start_sequence_number``)."""

    sequence_number: int
    events: list[KvEvent] = field(default_factory=list)
    dp_rank: int = 0
