"""Background worker health monitoring — the port's copy of
``smg_tpu/gateway/health.py`` (with the DP-rank load seeding).

Reference: ``model_gateway/src/worker/manager.rs`` — periodic health checks
with consecutive fail/success thresholds (``main.rs:521-556``), and the
isolated readiness model of ``src/health.rs`` (probes answer from maintained
state, never by doing work inline).
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass

from smg_tpu_torch.gateway.workers import WorkerRegistry
from smg_tpu_torch.utils import get_logger

logger = get_logger("gateway.health")


@dataclass
class HealthConfig:
    interval_secs: float = 10.0
    timeout_secs: float = 5.0
    failure_threshold: int = 3
    success_threshold: int = 2


class HealthMonitor:
    def __init__(self, registry: WorkerRegistry, config: HealthConfig | None = None,
                 metrics=None, dp_loads=None):
        self.registry = registry
        self.config = config or HealthConfig()
        self.metrics = metrics
        # DpLoadManager to seed with worker-reported per-rank queued tokens
        # (keeps gateway estimates honest against externally-submitted work)
        self.dp_loads = dp_loads
        self._task: asyncio.Task | None = None
        self._fails: dict[str, int] = {}
        self._succs: dict[str, int] = {}
        # removed workers must not leak monitor state or gauge series: a
        # churning deployment (k8s discovery, autoscaling) otherwise grows
        # _fails/_succs and the worker_healthy/worker_load label sets forever
        registry.on_change(self._on_registry_change)

    def _on_registry_change(self, event: str, worker) -> None:
        if event != "removed":
            return
        wid = worker.worker_id
        self._fails.pop(wid, None)
        self._succs.pop(wid, None)
        if self.metrics is not None:
            for gauge in (self.metrics.worker_healthy, self.metrics.worker_load):
                try:
                    gauge.remove(wid)
                except KeyError:
                    pass  # series never emitted for this worker

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(self._loop())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    async def _loop(self) -> None:
        logger.info("health monitor started (interval %.1fs)", self.config.interval_secs)
        while True:
            try:
                await self.check_all()
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("health sweep failed")
            await asyncio.sleep(self.config.interval_secs)

    async def check_all(self) -> None:
        workers = self.registry.list()
        results = await asyncio.gather(
            *(self._check_one(w) for w in workers), return_exceptions=True
        )
        for w, r in zip(workers, results):
            if isinstance(r, Exception):
                logger.warning("health check error for %s: %s", w.worker_id, r)

    async def _check_one(self, worker) -> None:
        try:
            ok = await asyncio.wait_for(
                worker.client.health(), timeout=self.config.timeout_secs
            )
        except Exception:
            ok = False
        wid = worker.worker_id
        if ok and self.dp_loads is not None and getattr(worker, "dp_size", 1) > 1:
            try:
                loads = await asyncio.wait_for(
                    worker.client.get_loads(), timeout=self.config.timeout_secs
                )
                ranks = loads.get("dp_queued_tokens") or []
                if ranks:
                    self.dp_loads.seed(wid, ranks)
            except Exception:
                pass  # health result stands; dp seeding is best-effort
        if ok:
            self._fails[wid] = 0
            self._succs[wid] = self._succs.get(wid, 0) + 1
            if not worker.healthy and self._succs[wid] >= self.config.success_threshold:
                worker.healthy = True
                logger.info("worker %s recovered", wid)
        else:
            self._succs[wid] = 0
            self._fails[wid] = self._fails.get(wid, 0) + 1
            if worker.healthy and self._fails[wid] >= self.config.failure_threshold:
                worker.healthy = False
                logger.warning("worker %s marked unhealthy", wid)
        if self.metrics is not None:
            self.metrics.worker_healthy.labels(worker_id=wid).set(1 if worker.healthy else 0)
            self.metrics.worker_load.labels(worker_id=wid).set(worker.load)
