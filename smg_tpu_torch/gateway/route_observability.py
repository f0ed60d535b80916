"""Routing decision observability: the gateway-side twin of the engine
flight recorder, for the routing plane — the port's copy of
``smg_tpu/gateway/route_observability.py`` (its lock from ``make_lock``,
as the reference's).

Reference posture: the reference's cache-aware routing
(``model_gateway/src/policies/cache_aware.rs``) is its flagship value-add,
yet ``select_worker`` is a black box at runtime — you cannot see why a
worker won, whether the gateway's radix mirror tracks worker cache truth, or
how often a predicted prefix hit materialized.  This module makes the
routing plane accountable:

1. **Decision ring** — every ``Policy.select`` emits a structured
   ``RouteDecision`` (candidate set with loads/breaker states, per-worker
   prefix-match lengths, threshold/imbalance outcomes, tie-break reason,
   decision latency) into a bounded per-model ring behind
   ``GET /debug/router``, with the headline fields also attached as
   attributes on the ambient request span.

2. **Predicted-vs-actual reconciliation** — the router holds the decision
   across dispatch and reconciles the predicted prefix-match length against
   the engine-reported ``cached_tokens`` riding the first stream chunk,
   yielding per-worker prediction-error histograms and an index-staleness
   EMA gauge: exactly how wrong ``approx_token``/``event`` mode is under
   churn, quarantine, and drain.

3. **Cache-index accountability** — attached ``cache_aware`` policies
   export tree/indexer stats (elements, nodes, per-worker blocks, event
   churn, evictions) as scrape-time gauges, and ``kv_index_snapshot()``
   feeds the ``GET /debug/kv_index`` drift audit against worker ``loads()``.
"""

from __future__ import annotations

import itertools
import time
from bisect import bisect_left
from collections import deque

from prometheus_client import Counter, Gauge, Histogram
from prometheus_client.core import (
    CounterMetricFamily,
    GaugeMetricFamily,
    HistogramMetricFamily,
)

from smg_tpu_torch.analysis.runtime_guards import make_lock
from smg_tpu_torch.gateway.tracing import current_span
from smg_tpu_torch.policies.base import DECISION_SCHEMA_VERSION, RouteDecision
from smg_tpu_torch.utils import get_logger

logger = get_logger("gateway.route_observability")

#: smoothing for the per-worker index-staleness EMA (relative signed
#: prediction error; positive = index claims more cache than reality)
STALENESS_ALPHA = 0.2

# decision latencies are single-digit µs (stateless policies) to tens of µs
# (radix walks over long prompts)
DECISION_BUCKETS = (
    1e-6, 5e-6, 1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 1e-3, 1e-2,
)

# |predicted - actual| in tokens; page-size rounding alone lands in the
# first buckets, real index drift in the tail
PREDICTION_ERROR_BUCKETS = (0, 1, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 4096)


class _DecisionCollector:
    """Scrape-time view of the hand-rolled decision counters.

    ``smg_route_decisions_total`` and ``smg_route_decision_seconds`` ride
    EVERY select_worker call; a prometheus ``Counter.inc`` +
    ``Histogram.observe`` pair costs ~3µs per decision (locked value cells),
    which alone blows the ≤2% hot-path overhead budget on fast policies.
    The ring keeps plain dict/list counters — owned by the event-loop thread
    that routes — and this collector materializes the families at scrape
    time."""

    def __init__(self, route: "RouteObservability"):
        self._route = route

    def collect(self):
        decisions = CounterMetricFamily(
            "smg_route_decisions",
            "Routing decisions by policy and outcome (prefix_hit / "
            "below_threshold / imbalance_override / no_match / sticky_* / "
            "policy-name fallbacks)",
            labels=["policy", "outcome"],
        )
        for (policy, outcome), n in list(self._route._decision_counts.items()):
            decisions.add_metric([policy, outcome], n)
        latency = HistogramMetricFamily(
            "smg_route_decision_seconds",
            "select_worker decision latency (candidate snapshot included)",
        )
        acc, buckets = 0, []
        counts = self._route._latency_counts
        for ub, n in zip(DECISION_BUCKETS, counts):
            acc += n
            buckets.append((str(ub), acc))
        buckets.append(("+Inf", acc + counts[-1]))
        latency.add_metric([], buckets, sum_value=self._route._latency_sum)
        yield from (decisions, latency)


class _CacheIndexCollector:
    """Scrape-time gauges over attached cache_aware policies.  A custom
    collector (not pre-registered Gauge objects) because policies are
    created lazily per model and their stats are snapshots, not counters the
    gateway mutates."""

    def __init__(self, route: "RouteObservability"):
        self._route = route

    def collect(self):
        elements = GaugeMetricFamily(
            "smg_cache_tree_elements",
            "Elements stored in the gateway cache_aware radix tree",
            labels=["model"],
        )
        nodes = GaugeMetricFamily(
            "smg_cache_tree_nodes",
            "Nodes in the gateway cache_aware radix tree (Python tree only)",
            labels=["model"],
        )
        evicted = GaugeMetricFamily(
            "smg_cache_tree_evicted_elements",
            "Cumulative elements LRU-evicted from the gateway radix tree",
            labels=["model"],
        )
        inserted = GaugeMetricFamily(
            "smg_cache_inserted_prefixes",
            "Cumulative routed-prefix inserts into the gateway radix tree "
            "(local + mesh-replicated)",
            labels=["model"],
        )
        blocks = GaugeMetricFamily(
            "smg_cache_index_blocks",
            "Distinct KV blocks tracked by the event-mode positional indexer",
            labels=["model"],
        )
        worker_blocks = GaugeMetricFamily(
            "smg_cache_index_worker_blocks",
            "Per-worker KV blocks tracked by the event-mode positional "
            "indexer (compare against the worker's loads() cached_pages "
            "for drift)",
            labels=["model", "worker_id"],
        )
        for key, policy in self._route.cache_policies():
            try:
                stats = policy.stats()
            except Exception:  # scrape must never fail on one policy
                continue
            tree, indexer = stats.get("tree", {}), stats.get("indexer", {})
            if tree.get("elements") is not None:
                elements.add_metric([key], tree["elements"])
            if tree.get("nodes") is not None:
                nodes.add_metric([key], tree["nodes"])
            if tree.get("evicted_elements") is not None:
                evicted.add_metric([key], tree["evicted_elements"])
            inserted.add_metric([key], stats.get("inserted_prefixes", 0))
            blocks.add_metric([key], indexer.get("blocks", 0))
            for wid, n in (indexer.get("per_worker_blocks") or {}).items():
                worker_blocks.add_metric([key, wid], n)
        yield from (elements, nodes, evicted, inserted, blocks, worker_blocks)


class RouteObservability:
    """Per-model decision rings + reconciliation accounting + routing-plane
    metric families, owned by the gateway ``Metrics`` set (``metrics.route``,
    mirroring ``metrics.slo``)."""

    def __init__(self, metrics, ring_size: int = 256):
        self.metrics = metrics
        self.ring_size = ring_size
        r = metrics.registry
        # hot-path decision accounting: plain counters behind
        # _DecisionCollector (see its docstring for why not Counter/Histogram)
        self._decision_counts: dict[tuple, int] = {}
        self._latency_counts = [0] * (len(DECISION_BUCKETS) + 1)
        self._latency_sum = 0.0
        r.register(_DecisionCollector(self))
        self.prediction_error = Histogram(
            "smg_route_prediction_abs_error_tokens",
            "|predicted prefix-match - engine-reported cached_tokens| per "
            "reconciled dispatch",
            ["worker_id"], buckets=PREDICTION_ERROR_BUCKETS, registry=r,
        )
        self.reconciliations_total = Counter(
            "smg_route_reconciliations_total",
            "Predicted-vs-actual reconciliations by outcome: exact, over "
            "(index predicted more than the engine had: stale entries), "
            "under (engine had more than the index knew: missing events)",
            ["worker_id", "outcome"], registry=r,
        )
        self.index_staleness = Gauge(
            "smg_route_index_staleness",
            "Per-worker EMA of signed relative prediction error "
            "((predicted - actual) / max(predicted, actual, 1)); positive = "
            "the gateway index overstates this worker's cache",
            ["worker_id"], registry=r,
        )
        # ---- KvEventMonitor health (previously log-only) ----
        self.kv_subscribe_failures = Counter(
            "smg_kv_event_subscribe_failures_total",
            "KV-event subscription attempts that failed at worker "
            "registration (event-mode cache_aware silently degrades to "
            "no-signal for that worker)",
            ["worker_id"], registry=r,
        )
        self.kv_degraded_workers = Gauge(
            "smg_kv_event_degraded_workers",
            "Workers whose KV-event feed is degraded: subscribe failed or "
            "engine page size mismatches the indexer (event-mode matching "
            "misses for them)",
            registry=r,
        )
        r.register(_CacheIndexCollector(self))

        self._lock = make_lock("route_observability")
        self._serial = itertools.count(1)
        self._rings: dict[str, deque] = {}
        self.num_decisions = 0
        self.num_reconciled = 0
        # worker_id -> reconciliation aggregates
        self._recon: dict[str, dict] = {}
        # (model_key, policy) pairs with a stats() surface (cache_aware)
        self._cache_policies: list = []

    # ---- wiring ----

    def watch(self, policies) -> None:
        """Attach to a PolicyRegistry: every policy instance (existing and
        lazily created) gets this sink; cache_aware policies additionally
        feed the cache-index gauges and /debug/kv_index."""
        policies.add_create_hook(self.attach)

    def attach(self, model_id: str | None, policy) -> None:
        policy._decision_sink = self
        key = model_id or "__default__"
        with self._lock:
            # PolicyRegistry holds exactly ONE policy per model key, so a
            # replacement (set_policy at runtime) supersedes whatever was
            # registered for the key — keeping the stale instance would emit
            # duplicate per-model series from _CacheIndexCollector (which
            # fails the whole scrape) and leak the replaced policy's tree
            kept = [(k, p) for k, p in self._cache_policies if k != key]
            if hasattr(policy, "stats") and callable(policy.stats):
                kept.append((key, policy))
            self._cache_policies = kept

    def cache_policies(self) -> list:
        with self._lock:
            return list(self._cache_policies)

    # ---- decision ring ----

    def record(self, decision: RouteDecision) -> None:
        """Sink for ``Policy.select``: ring append + counters + ambient-span
        attributes.  Hot path — keep this lean."""
        serial = next(self._serial)
        decision.serial = serial
        self.num_decisions = serial  # same monotonic count, one increment
        decision.ts = time.time()
        key = decision.model_id or "__default__"
        # lock-free dict probe on purpose: this rides EVERY select_worker
        # call inside the ≤2% overhead budget; dict.get is GIL-atomic and a
        # miss falls through to the locked setdefault below
        ring = self._rings.get(key)  # smglint: disable=GUARDED hot-path probe; locked setdefault on miss
        if ring is None:
            with self._lock:
                ring = self._rings.setdefault(
                    key, deque(maxlen=self.ring_size)
                )
        ring.append(decision)  # deque append is thread-safe and bounded
        ckey = (decision.policy, decision.outcome)
        counts = self._decision_counts
        counts[ckey] = counts.get(ckey, 0) + 1
        secs = decision.decision_us * 1e-6
        self._latency_counts[bisect_left(DECISION_BUCKETS, secs)] += 1
        self._latency_sum += secs
        # attach the headline fields to the ambient request span so a trace
        # shows WHY the request landed where it did
        span = current_span.get()
        if span is not None:
            span.set("route.policy", decision.policy)
            span.set("route.outcome", decision.outcome)
            if decision.chosen is not None:
                span.set("route.worker", decision.chosen)
            if decision.predicted_match_tokens is not None:
                span.set(
                    "route.predicted_match_tokens",
                    decision.predicted_match_tokens,
                )
            span.set("route.decision_us", decision.decision_us)
            decision.trace_id = span.trace_id

    # ---- predicted-vs-actual reconciliation ----

    def reconcile(
        self, decision: RouteDecision, worker_id: str, cached_tokens: int
    ) -> None:
        """Fold the engine-reported ``cached_tokens`` (first stream chunk)
        back into the decision record and the per-worker error accounting.
        Idempotent per decision; no-op when the decision carried no
        token-space prediction (approx_string without token ids)."""
        if decision.reconciled or decision.predicted_match_tokens is None:
            return
        decision.reconciled = True
        decision.worker_cached_tokens = int(cached_tokens)
        err = decision.predicted_match_tokens - int(cached_tokens)
        decision.prediction_error_tokens = err
        outcome = "exact" if err == 0 else ("over" if err > 0 else "under")
        self.prediction_error.labels(worker_id=worker_id).observe(abs(err))
        self.reconciliations_total.labels(
            worker_id=worker_id, outcome=outcome
        ).inc()
        rel = err / max(decision.predicted_match_tokens, cached_tokens, 1)
        with self._lock:
            self.num_reconciled += 1
            stats = self._recon.get(worker_id)
            if stats is None:
                stats = self._recon[worker_id] = {
                    "count": 0, "exact": 0, "over": 0, "under": 0,
                    "abs_error_sum": 0, "staleness": 0.0,
                    "last_predicted": None, "last_actual": None,
                }
            stats["count"] += 1
            stats[outcome] += 1
            stats["abs_error_sum"] += abs(err)
            stats["staleness"] += STALENESS_ALPHA * (rel - stats["staleness"])
            stats["last_predicted"] = decision.predicted_match_tokens
            stats["last_actual"] = int(cached_tokens)
            staleness = stats["staleness"]
        self.index_staleness.labels(worker_id=worker_id).set(staleness)

    def on_worker_removed(self, worker_id: str) -> None:
        """Purge the ring's per-worker state: reconciliation aggregates and
        metric label series (a removed worker's gauges must not freeze on
        the scrape).  Ring *history* mentioning the worker is kept — that is
        the postmortem record."""
        with self._lock:
            self._recon.pop(worker_id, None)
        for collector in (
            self.prediction_error, self.index_staleness,
            self.kv_subscribe_failures,
        ):
            try:
                collector.remove(worker_id)
            except KeyError:
                pass
        for outcome in ("exact", "over", "under"):
            try:
                self.reconciliations_total.remove(worker_id, outcome)
            except KeyError:
                pass

    # ---- debug surfaces ----

    def debug_router(self, model: str | None = None, limit: int = 64) -> dict:
        """The ``GET /debug/router`` payload: bounded, schema-stable
        decision records (newest last) plus per-worker reconciliation
        aggregates."""
        limit = max(1, min(int(limit), self.ring_size))
        with self._lock:
            keys = (
                [model or "__default__"] if model is not None
                else list(self._rings)
            )
            rings = {
                k: list(self._rings.get(k, ())) for k in keys
            }
            recon = {
                w: dict(s) for w, s in self._recon.items()
            }
            num_decisions = self.num_decisions
            num_reconciled = self.num_reconciled
        models = {}
        for k, ring in rings.items():
            models[k] = {
                "policy": ring[-1].policy if ring else None,
                "window": len(ring),
                "decisions": [d.to_dict() for d in ring[-limit:]],
            }
        for stats in recon.values():
            stats["mean_abs_error_tokens"] = (
                stats["abs_error_sum"] / stats["count"] if stats["count"] else 0.0
            )
        return {
            "schema_version": DECISION_SCHEMA_VERSION,
            "ring_size": self.ring_size,
            "num_decisions": num_decisions,
            "num_reconciled": num_reconciled,
            "models": models,
            "reconciliation": recon,
        }

    def kv_index_snapshot(self) -> dict:
        """Gateway-side cache-index view per model (the /debug/kv_index
        numerator; the handler joins worker ``loads()`` as the denominator)."""
        out = {}
        for key, policy in self.cache_policies():
            try:
                out[key] = policy.stats()
            except Exception as e:
                out[key] = {"error": str(e)}
        return out
