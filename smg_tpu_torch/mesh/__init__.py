"""HA mesh: gossip membership + CRDT state sync between gateway peers —
the port's copy of ``smg_tpu/mesh/`` (standard library only).

Reference: ``crates/mesh`` (smg-mesh) — SWIM-style gossip, CRDT KV with
epoch-count merge, stream namespaces, partition detection (SURVEY.md §2.2).
"""

from smg_tpu_torch.mesh.crdt import LwwMap
from smg_tpu_torch.mesh.gossip import GossipConfig, GossipNode
from smg_tpu_torch.mesh.partition import (
    PartitionConfig,
    PartitionDetector,
    PartitionState,
)

__all__ = [
    "LwwMap",
    "GossipNode",
    "GossipConfig",
    "PartitionConfig",
    "PartitionDetector",
    "PartitionState",
]
