"""Partition detection for the HA gossip mesh — the port's copy of
``smg_tpu/mesh/partition.py``.

Reference: ``crates/mesh/src/partition.rs`` — classify the cluster view as
Normal / PartitionedWithQuorum / PartitionedWithoutQuorum from last-seen
recency and a quorum threshold, so a minority island can fence writes
(degrade to read-only) instead of split-braining the CRDT state.

Design note (TPU-repo): the gossip membership already tracks per-peer
``last_seen``/``alive``; the detector is a pure classifier over that view
plus a fencing hook — the LWW CRDT merge remains the (eventual) safety net
either way, quorum fencing just bounds the divergence window.
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass

from smg_tpu_torch.utils import get_logger

logger = get_logger("mesh.partition")


class PartitionState(enum.Enum):
    NORMAL = "normal"
    PARTITIONED_WITH_QUORUM = "partitioned_with_quorum"
    PARTITIONED_WITHOUT_QUORUM = "partitioned_without_quorum"


@dataclass
class PartitionConfig:
    unreachable_timeout: float = 30.0  # seconds without contact = unreachable
    min_cluster_size: int = 3          # below this, partitions are meaningless
    quorum_threshold: int = 2          # reachable nodes needed for quorum


class PartitionDetector:
    """Classifies the local node's view of the mesh."""

    def __init__(self, config: PartitionConfig | None = None):
        self.config = config or PartitionConfig()
        self.state = PartitionState.NORMAL
        self._transitions = 0

    def detect(self, node: "GossipNode") -> PartitionState:  # noqa: F821
        """One classification pass over the gossip membership (self counts
        as reachable)."""
        cfg = self.config
        now = time.monotonic()
        reachable = 1  # self
        unreachable = 0
        total_known = 1
        for m in node.members.values():
            if m.node_id == node.node_id or m.node_id.startswith("seed@"):
                continue
            total_known += 1
            recent = (now - m.last_seen) < cfg.unreachable_timeout
            if m.alive and recent:
                reachable += 1
            else:
                unreachable += 1
        # quorum = MAJORITY of the known cluster (config threshold is only a
        # floor): a static threshold would let both sides of a split claim
        # quorum simultaneously — the exact split-brain this detector fences
        quorum = max(cfg.quorum_threshold, total_known // 2 + 1)
        if total_known < cfg.min_cluster_size or unreachable == 0:
            new = PartitionState.NORMAL
        elif reachable >= quorum:
            new = PartitionState.PARTITIONED_WITH_QUORUM
        else:
            new = PartitionState.PARTITIONED_WITHOUT_QUORUM
        if new is not self.state:
            self._transitions += 1
            log = logger.warning if new is not PartitionState.NORMAL else logger.info
            log("mesh partition state: %s -> %s (reachable=%d unreachable=%d)",
                self.state.value, new.value, reachable, unreachable)
        self.state = new
        return new

    @property
    def has_quorum(self) -> bool:
        return self.state is not PartitionState.PARTITIONED_WITHOUT_QUORUM

    def describe(self) -> dict:
        return {
            "state": self.state.value,
            "has_quorum": self.has_quorum,
            "transitions": self._transitions,
        }
