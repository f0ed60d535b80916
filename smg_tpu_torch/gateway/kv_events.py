"""KvEventMonitor: per-worker KV-event subscriptions feeding cache_aware —
the port's copy of ``smg_tpu/gateway/kv_events.py``.

Reference: ``model_gateway/src/worker/kv_event_monitor.rs:1-11`` — on worker
registration, subscribe to its KV-event stream and feed the positional
indexer; unsubscribe + purge on removal (SURVEY.md §3.5).

Degraded modes are metered, not just logged: a failed subscribe or a
page-size mismatch turns event-mode matching off for that worker —
``smg_kv_event_subscribe_failures_total`` and
``smg_kv_event_degraded_workers`` make that visible on ``/metrics``
(``gateway/route_observability.py`` owns the families).
"""

from __future__ import annotations

from smg_tpu_torch.faults import FAULTS, InjectedFault
from smg_tpu_torch.gateway.workers import Worker, WorkerRegistry
from smg_tpu_torch.policies import PolicyRegistry
from smg_tpu_torch.policies.cache_aware import CacheAwarePolicy
from smg_tpu_torch.utils import get_logger

logger = get_logger("gateway.kv_events")


class KvEventMonitor:
    def __init__(self, registry: WorkerRegistry, policies: PolicyRegistry, metrics=None):
        self.registry = registry
        self.policies = policies
        #: gateway Metrics (observability.py); the routing-plane families
        #: live on metrics.route
        self.metrics = metrics
        self._unsubs: dict[str, callable] = {}
        #: workers whose event feed is absent or unusable (subscribe failed
        #: / page-size mismatch) — event-mode matching misses for these
        self.degraded: set[str] = set()
        registry.on_change(self._on_change)

    def _route_metrics(self):
        return getattr(self.metrics, "route", None)

    def _set_degraded(self, worker_id: str, degraded: bool) -> None:
        if degraded:
            self.degraded.add(worker_id)
        else:
            self.degraded.discard(worker_id)
        route = self._route_metrics()
        if route is not None:
            route.kv_degraded_workers.set(len(self.degraded))

    def _cache_policy(self, model_id: str) -> CacheAwarePolicy | None:
        policy = self.policies.policy_for(model_id)
        return policy if isinstance(policy, CacheAwarePolicy) else None

    def _on_change(self, event: str, worker: Worker) -> None:
        if event == "added":
            policy = self._cache_policy(worker.model_id)
            if policy is None:
                return
            # sync the event-tree page size to the worker's engine page size —
            # mismatched page sizes make every chain hash miss silently
            if worker.page_size and worker.page_size != policy.indexer.page_size:
                if policy.indexer.stats()["blocks"] == 0:
                    policy.indexer.page_size = worker.page_size
                    logger.info(
                        "cache_aware indexer page_size set to %d (from %s)",
                        worker.page_size, worker.worker_id,
                    )
                else:
                    self._set_degraded(worker.worker_id, True)
                    logger.warning(
                        "worker %s page_size=%d != indexer page_size=%d; "
                        "event-mode matching will miss for this worker",
                        worker.worker_id, worker.page_size, policy.indexer.page_size,
                    )

            def on_batch(batch, wid=worker.worker_id, p=policy):
                try:
                    # fault point: simulated event loss (a dropped batch
                    # leaves the gateway kv_index stale — exactly what the
                    # reconciliation error histograms must surface)
                    FAULTS.fire("gateway.kv_event", worker_id=wid)
                except InjectedFault:
                    logger.warning("kv-event batch dropped for %s (fault)", wid)
                    return
                p.apply_kv_events(wid, batch)

            try:
                self._unsubs[worker.worker_id] = worker.client.subscribe_kv_events(on_batch)
                logger.info("kv-event subscription started for %s", worker.worker_id)
            except Exception:
                self._set_degraded(worker.worker_id, True)
                route = self._route_metrics()
                if route is not None:
                    route.kv_subscribe_failures.labels(worker_id=worker.worker_id).inc()
                logger.exception("kv-event subscribe failed for %s", worker.worker_id)
        elif event == "removed":
            unsub = self._unsubs.pop(worker.worker_id, None)
            if unsub is not None:
                try:
                    unsub()
                except Exception:
                    pass
            self._set_degraded(worker.worker_id, False)
            policy = self._cache_policy(worker.model_id)
            if policy is not None:
                policy.on_worker_removed(worker.worker_id)
            self.policies.on_worker_removed(worker.worker_id)
