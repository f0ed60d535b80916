"""DP-rank selection: route a request to one data-parallel engine replica
behind an already-selected worker — the port's copy of
``smg_tpu/policies/dp.py``.  (The port's own gRPC worker serves one engine
and reports ``dp_size`` 1, so its requests are never pinned; a reference
worker with replicas gets the reference's rank sequence.)

Reference behavior: ``DPRankLoadPolicy`` + ``MinimumTokensPolicy``
(``model_gateway/src/policies/dp_min_token.rs:24-31``) backed by a
``WorkerLoadManager`` per-(worker, rank) token-load cache with
atomic select-and-increment.  Rank selection is a second routing stage —
orthogonal to worker selection (``policies/base.py``): the worker
policy balances across hosts, the DP policy balances across the replicas a
host multiplexes onto its chips.
"""

from __future__ import annotations

import threading


class DpLoadManager:
    """Per-(worker, dp_rank) outstanding token-cost cache.

    The gateway *estimates* a request's cost (prompt tokens + generation
    budget) at dispatch, bumps the chosen rank's counter, and releases it when
    the stream ends.  ``seed`` overwrites a worker's baseline from GetLoads
    polls so gateway restarts and externally-submitted work converge to
    reality (in-flight deltas are kept relative to the seeded base).
    """

    def __init__(self):
        self._lock = threading.Lock()
        # worker_id -> list of outstanding costs per rank (gateway-attributed)
        self._inflight: dict[str, list[int]] = {}
        # worker_id -> last polled per-rank queued tokens (worker-reported)
        self._base: dict[str, list[int]] = {}

    def _ranks(self, worker_id: str, dp_size: int) -> list[int]:
        cur = self._inflight.get(worker_id)
        if cur is None or len(cur) != dp_size:
            cur = [0] * dp_size
            self._inflight[worker_id] = cur
        return cur

    def seed(self, worker_id: str, dp_queued_tokens: list[int]) -> None:
        """Record worker-reported per-rank loads as the EXTERNAL base.

        The worker's numbers include requests this gateway itself has in
        flight, so the gateway-attributed share is subtracted at poll time —
        otherwise a rank serving gateway traffic counts double vs a rank
        serving equal external traffic."""
        with self._lock:
            infl = self._inflight.get(worker_id) or []
            self._base[worker_id] = [
                max(tok - (infl[r] if r < len(infl) else 0), 0)
                for r, tok in enumerate(dp_queued_tokens)
            ]

    def loads(self, worker_id: str, dp_size: int) -> list[int]:
        with self._lock:
            infl = self._ranks(worker_id, dp_size)
            base = self._base.get(worker_id) or []
            return [
                infl[r] + (base[r] if r < len(base) else 0) for r in range(dp_size)
            ]

    def select_and_increment_lowest(
        self, worker_id: str, dp_size: int, cost: int
    ) -> int:
        """Atomically pick the least-loaded rank and charge ``cost`` to it."""
        with self._lock:
            infl = self._ranks(worker_id, dp_size)
            base = self._base.get(worker_id) or []
            totals = [
                infl[r] + (base[r] if r < len(base) else 0) for r in range(dp_size)
            ]
            rank = min(range(dp_size), key=totals.__getitem__)
            infl[rank] += cost
            return rank

    def release(self, worker_id: str, rank: int, cost: int) -> None:
        with self._lock:
            infl = self._inflight.get(worker_id)
            if infl is not None and 0 <= rank < len(infl):
                infl[rank] = max(infl[rank] - cost, 0)

    def on_worker_removed(self, worker_id: str) -> None:
        with self._lock:
            self._inflight.pop(worker_id, None)
            self._base.pop(worker_id, None)


class DpRankPolicy:
    """Trait: decide which DP rank serves a request (None = let the worker
    pick; the wire carries -1)."""

    name = "base"

    def select_dp_rank(self, worker, estimated_cost: int) -> int | None:
        raise NotImplementedError

    def release(self, worker, rank: int, estimated_cost: int) -> None:
        pass


class MinimumTokensPolicy(DpRankPolicy):
    """Pick the rank with the fewest outstanding tokens
    (``dp_min_token.rs:24-31`` behavior)."""

    name = "dp_min_token"

    def __init__(self, manager: DpLoadManager | None = None):
        self.manager = manager or DpLoadManager()

    def select_dp_rank(self, worker, estimated_cost: int) -> int | None:
        dp = getattr(worker, "dp_size", 1)
        if dp <= 1:
            return None
        return self.manager.select_and_increment_lowest(
            worker.worker_id, dp, estimated_cost
        )

    def release(self, worker, rank: int, estimated_cost: int) -> None:
        if rank is not None and rank >= 0:
            self.manager.release(worker.worker_id, rank, estimated_cost)


class PassthroughDpPolicy(DpRankPolicy):
    """Never pin a rank — the worker balances locally (wire rank -1)."""

    name = "dp_passthrough"

    def select_dp_rank(self, worker, estimated_cost: int) -> int | None:
        return None
