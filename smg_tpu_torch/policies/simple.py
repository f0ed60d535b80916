"""Stateless/simple policies: round_robin, random, least_load, power_of_two,
bucket, passthrough, manual — the port's copy of ``smg_tpu/policies/simple.py``.

Reference: ``model_gateway/src/policies/{round_robin,random,least_load,
power_of_two,bucket,passthrough,manual}.rs`` (SURVEY.md §2.1).
"""

from __future__ import annotations

import itertools
import random as _random
import threading
from collections import OrderedDict
from typing import Sequence

from smg_tpu_torch.policies.base import Policy, RequestContext, WorkerLike, register_policy


@register_policy
class RoundRobinPolicy(Policy):
    name = "round_robin"

    def __init__(self):
        self._counter = itertools.count()

    def select_worker(self, workers, ctx, decision=None):
        avail = self.available(workers)
        if not avail:
            return None
        idx = next(self._counter) % len(avail)
        if decision is not None:
            decision.outcome = "round_robin"
            decision.tie_break = f"cursor:{idx}"
        return avail[idx]


@register_policy
class RandomPolicy(Policy):
    name = "random"

    def __init__(self, seed: int | None = None):
        self._rng = _random.Random(seed)

    def select_worker(self, workers, ctx, decision=None):
        avail = self.available(workers)
        if not avail:
            return None  # outcome stays "none" -> select() labels "no_worker"
        if decision is not None:
            decision.outcome = "random"
        return self._rng.choice(avail)


@register_policy
class LeastLoadPolicy(Policy):
    """Shortest queue; ties broken at random to avoid herding
    (reference adds KV-pressure weighting — ``least_load.rs``)."""

    name = "least_load"

    def __init__(self, seed: int | None = None):
        self._rng = _random.Random(seed)

    def select_worker(self, workers, ctx, decision=None):
        avail = self.available(workers)
        if not avail:
            return None
        min_load = min(w.load for w in avail)
        best = [w for w in avail if w.load == min_load]
        if decision is not None:
            decision.outcome = "least_load"
            decision.tie_break = (
                f"random_among_{len(best)}" if len(best) > 1 else "unique_min"
            )
        return self._rng.choice(best)


@register_policy
class PowerOfTwoPolicy(Policy):
    """Sample two, take the less loaded (``power_of_two.rs``)."""

    name = "power_of_two"

    def __init__(self, seed: int | None = None):
        self._rng = _random.Random(seed)

    def select_worker(self, workers, ctx, decision=None):
        avail = self.available(workers)
        if not avail:
            return None
        if len(avail) == 1:
            if decision is not None:
                decision.outcome = "power_of_two"
                decision.tie_break = "single_candidate"
            return avail[0]
        a, b = self._rng.sample(avail, 2)
        chosen = a if a.load <= b.load else b
        if decision is not None:
            decision.outcome = "power_of_two"
            decision.tie_break = f"sampled:{a.worker_id},{b.worker_id}"
        return chosen


@register_policy
class PassthroughPolicy(Policy):
    """Single-worker passthrough: first available (``passthrough.rs``)."""

    name = "passthrough"

    def select_worker(self, workers, ctx, decision=None):
        avail = self.available(workers)
        if not avail:
            return None  # outcome stays "none" -> select() labels "no_worker"
        if decision is not None:
            decision.outcome = "passthrough"
        return avail[0]


@register_policy
class ManualPolicy(Policy):
    """Sticky routing keys: requests carrying the same ``routing_key`` pin to
    the same worker, LRU-bounded (reference: ``manual.rs`` — sticky routing
    keys, 974 LoC)."""

    name = "manual"

    def __init__(self, max_keys: int = 65536, seed: int | None = None):
        self._assignments: OrderedDict[str, str] = OrderedDict()
        self._max_keys = max_keys
        self._rng = _random.Random(seed)
        self._lock = threading.Lock()

    def select_worker(self, workers, ctx, decision=None):
        avail = self.available(workers)
        if not avail:
            return None
        key = ctx.routing_key
        if not key:
            if decision is not None:
                decision.outcome = "sticky_no_key"
            return self._rng.choice(avail)
        by_id = {w.worker_id: w for w in avail}
        with self._lock:
            wid = self._assignments.get(key)
            if wid in by_id:
                self._assignments.move_to_end(key)
                if decision is not None:
                    decision.outcome = "sticky_hit"
                return by_id[wid]
            # (re)assign: least-loaded
            chosen = min(avail, key=lambda w: w.load)
            self._assignments[key] = chosen.worker_id
            self._assignments.move_to_end(key)
            while len(self._assignments) > self._max_keys:
                self._assignments.popitem(last=False)
            if decision is not None:
                decision.outcome = "sticky_assign"
                decision.tie_break = "least_load"
            return chosen

    def on_worker_removed(self, worker_id: str) -> None:
        super().on_worker_removed(worker_id)
        with self._lock:
            for k in [k for k, v in self._assignments.items() if v == worker_id]:
                del self._assignments[k]


@register_policy
class BucketPolicy(Policy):
    """Bucket requests by prompt-length band so short interactive requests
    don't queue behind long-context ones (reference: ``bucket.rs``, 1,326 LoC).
    Workers are striped across buckets; falls back to least-load within the
    bucket's stripe."""

    name = "bucket"

    def __init__(self, boundaries: Sequence[int] = (2048, 8192)):
        self.boundaries = tuple(boundaries)

    def _bucket_of(self, n_tokens: int) -> int:
        for i, b in enumerate(self.boundaries):
            if n_tokens <= b:
                return i
        return len(self.boundaries)

    def select_worker(self, workers, ctx, decision=None):
        avail = self.available(workers)
        if not avail:
            return None
        n = len(ctx.token_ids) if ctx.token_ids else (len(ctx.text or "") // 4)
        n_buckets = len(self.boundaries) + 1
        bucket = self._bucket_of(n)
        stripe = [w for i, w in enumerate(avail) if i % n_buckets == bucket]
        pool = stripe or avail
        if decision is not None:
            decision.outcome = "bucket"
            decision.tie_break = (
                f"bucket:{bucket}" if stripe else f"bucket:{bucket}:empty_stripe"
            )
        return min(pool, key=lambda w: w.load)
