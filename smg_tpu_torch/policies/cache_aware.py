"""Cache-aware routing — the port's copy of
``smg_tpu/policies/cache_aware.py`` (the native radix tree of
``kv_index/native.py`` where it builds, the Python tree otherwise).

Reference: ``model_gateway/src/policies/cache_aware.rs:1-41`` (2,366 LoC) —
the flagship policy, three cache-state modes:

- ``event``: exact, event-driven — match against the ``PositionalIndexer``
  fed by worker KV events (rolling block-hash chain, SURVEY.md §3.5);
- ``approx_token`` / ``approx_string``: approximate — insert routed prefixes
  into a local RadixTree on selection, no worker feedback needed.

Selection: if the best prefix overlap clears ``match_threshold`` (fraction of
the request), route to that worker — unless the load imbalance across workers
exceeds ``imbalance_abs`` + ``imbalance_rel`` (then shortest-queue to protect
tail latency, same balance/cache tension the reference resolves this way).
"""

from __future__ import annotations

import random as _random

from smg_tpu_torch.kv_index.positional import PositionalIndexer
from smg_tpu_torch.policies.base import Policy, RequestContext, register_policy


@register_policy
class CacheAwarePolicy(Policy):
    name = "cache_aware"

    def __init__(
        self,
        mode: str = "approx_token",  # "event" | "approx_token" | "approx_string"
        match_threshold: float = 0.5,
        imbalance_abs: int = 32,
        imbalance_rel: float = 1.5,
        max_tree_size: int = 2**20,
        page_size: int = 16,
        seed: int | None = None,
    ):
        if mode not in ("event", "approx_token", "approx_string"):
            raise ValueError(f"unknown cache_aware mode {mode!r}")
        self.mode = mode
        self.match_threshold = match_threshold
        self.imbalance_abs = imbalance_abs
        self.imbalance_rel = imbalance_rel
        # native C++ tree when the toolchain built it; Python tree otherwise
        from smg_tpu_torch.kv_index.native import make_radix_tree

        self.tree = make_radix_tree(max_tree_size)
        self.indexer = PositionalIndexer(page_size=page_size)
        # mesh replication hooks (tree_sync): fired on local routed-prefix
        # inserts so peers can mirror them; remote applies bypass the hooks
        self._insert_hooks: list = []
        self._rng = _random.Random(seed)
        self.num_inserted_prefixes = 0  # local + remote tree inserts

    # event-mode feed (wired to KvEventMonitor)
    def apply_kv_events(self, worker_id: str, batch) -> None:
        self.indexer.apply_batch(worker_id, batch)

    def stats(self) -> dict:
        """Gateway cache-index snapshot (decision-ring / /debug/kv_index /
        metric-collector surface): tree size + eviction stats, positional
        indexer block counts incl. per-worker."""
        return {
            "mode": self.mode,
            "match_threshold": self.match_threshold,
            "inserted_prefixes": self.num_inserted_prefixes,
            "tree": self.tree.stats(),
            "indexer": self.indexer.stats(),
        }

    def on_worker_removed(self, worker_id: str) -> None:
        super().on_worker_removed(worker_id)
        self.tree.remove_worker(worker_id)
        self.indexer.remove_worker(worker_id)

    def _request_seq(self, ctx: RequestContext):
        if self.mode == "approx_string":
            return ctx.text or (",".join(map(str, ctx.token_ids or [])))
        return ctx.token_ids if ctx.token_ids is not None else (ctx.text or "")

    def _predicted_tokens(self, match_elems: int, seq_len: int, ctx) -> int | None:
        """Predicted prefix overlap in TOKEN space for reconciliation against
        engine-reported ``cached_tokens``.  event/approx_token match in
        tokens already; approx_string matches chars, scaled through the
        tokenized length when the router provides it (approximate by
        construction — exactly the error the reconciliation quantifies)."""
        if self.mode != "approx_string":
            return match_elems if ctx.token_ids is not None else None
        if not ctx.token_ids or seq_len <= 0:
            return None
        return int(round(match_elems / seq_len * len(ctx.token_ids)))

    def select_worker(self, workers, ctx, decision=None):
        avail = self.available(workers)
        if not avail:
            return None
        loads = {w.worker_id: w.load for w in avail}
        max_load, min_load = max(loads.values()), min(loads.values())
        imbalanced = (
            max_load - min_load > self.imbalance_abs
            and max_load > self.imbalance_rel * max(min_load, 1)
        )

        seq = self._request_seq(ctx)
        seq_len = len(seq) if seq is not None else 0
        chosen = None
        outcome = "no_match"
        tie_break = None
        matches: dict = {}
        if not imbalanced and seq is not None and seq_len > 0:
            if self.mode == "event":
                matches = self.indexer.match(list(seq)) if ctx.token_ids else {}
            else:
                matches = self.tree.prefix_match(seq)
            matches = {w: m for w, m in matches.items() if w in loads}
            if matches:
                best_len = max(matches.values())
                if best_len / max(seq_len, 1) >= self.match_threshold:
                    best = [w for w, m in matches.items() if m == best_len]
                    # ties: least load, then smallest worker id for stability
                    wid = min(best, key=lambda w: (loads[w], w))
                    chosen = next(w for w in avail if w.worker_id == wid)
                    outcome = "prefix_hit"
                    tie_break = (
                        f"load_then_id_among_{len(best)}"
                        if len(best) > 1 else "unique_best"
                    )
                else:
                    outcome = "below_threshold"
        elif imbalanced:
            outcome = "imbalance_override"
        if chosen is None:
            min_l = min(loads.values())
            cands = [w for w in avail if w.load == min_l]
            chosen = self._rng.choice(cands)
            if tie_break is None:
                tie_break = f"random_among_{len(cands)}_min_load"
        if self.mode != "event" and seq is not None and seq_len > 0:
            self.tree.insert(seq, chosen.worker_id)
            self.num_inserted_prefixes += 1
            for hook in self._insert_hooks:
                try:
                    hook(seq, chosen.worker_id)
                except Exception:  # replication must never fail routing
                    pass
        if decision is not None:
            decision.mode = self.mode
            decision.match_threshold = self.match_threshold
            decision.imbalanced = imbalanced
            decision.outcome = outcome
            decision.tie_break = tie_break
            decision.prefix_matches = matches
            match_at_chosen = matches.get(chosen.worker_id, 0)
            decision.predicted_match_fraction = (
                match_at_chosen / seq_len if seq_len else 0.0
            )
            # imbalance override skips the index walk entirely: there is no
            # prediction to reconcile, and folding an implicit 0 into the
            # per-worker staleness EMA would blame the index for a decision
            # it never made
            decision.predicted_match_tokens = (
                None if imbalanced
                else self._predicted_tokens(match_at_chosen, seq_len, ctx)
            )
        return chosen

    # ---- mesh tree_sync surface (reference: mesh/adapters/tree_sync.rs) ----

    def add_insert_hook(self, cb) -> None:
        self._insert_hooks.append(cb)

    def apply_remote_insert(self, seq, worker_id: str) -> None:
        """Insert a peer-routed prefix without re-firing replication hooks."""
        if self.mode != "event" and seq is not None and len(seq) > 0:
            self.tree.insert(seq, worker_id)
            self.num_inserted_prefixes += 1
