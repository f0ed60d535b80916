"""Worker abstraction, registry, circuit breaker, load guards — the port's
copy of ``smg_tpu/gateway/workers.py`` (locks from ``make_lock``, as the
reference's).

Reference: ``model_gateway/src/worker/`` (SURVEY.md §2.1): ``trait Worker``
(url/type/status/load/circuit-breaker, ``worker.rs:193-390``),
``WorkerRegistry`` with events (``registry.rs:89``), three-state
``CircuitBreaker`` (``circuit_breaker.rs:41,103``), RAII ``WorkerLoadGuard``.
"""

from __future__ import annotations

import enum
import time
from typing import Callable

from smg_tpu_torch.analysis.runtime_guards import make_lock
from smg_tpu_torch.gateway.worker_client import WorkerClient
from smg_tpu_torch.utils import get_logger

logger = get_logger("gateway.workers")


class CircuitState(enum.Enum):
    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"


class CircuitBreaker:
    """Three-state breaker: CLOSED -> (N consecutive failures) -> OPEN ->
    (cooldown) -> HALF_OPEN -> (M consecutive successes) -> CLOSED.

    CLI knobs (--cb-*) flow per-registry (WorkerRegistry.
    circuit_breaker_config), applied as workers register."""

    DEFAULT_FAILURE_THRESHOLD = 5
    DEFAULT_SUCCESS_THRESHOLD = 2
    DEFAULT_COOLDOWN_SECS = 30.0

    def __init__(
        self,
        failure_threshold: int | None = None,
        success_threshold: int | None = None,
        cooldown_secs: float | None = None,
    ):
        if failure_threshold is None:
            failure_threshold = self.DEFAULT_FAILURE_THRESHOLD
        if success_threshold is None:
            success_threshold = self.DEFAULT_SUCCESS_THRESHOLD
        if cooldown_secs is None:
            cooldown_secs = self.DEFAULT_COOLDOWN_SECS
        self.failure_threshold = failure_threshold
        self.success_threshold = success_threshold
        self.cooldown_secs = cooldown_secs
        self._state = CircuitState.CLOSED
        self._consecutive_failures = 0
        self._consecutive_successes = 0
        self._opened_at = 0.0
        # HALF_OPEN probe gate: one in-flight probe at a time.  Without it a
        # cooldown expiry under load floods the possibly-still-sick worker
        # with the entire backed-up queue at once (half-open flood).  The
        # slot is claimed at DISPATCH (``begin_probe`` from the load guard),
        # not in ``allow()`` — availability checks (health endpoints, policy
        # filters that pick another worker) must stay read-only or they
        # would starve real probes.  The timestamp self-heals a probe whose
        # outcome never lands (client vanished before record_*).
        self._probe_started: float | None = None
        self._lock = make_lock("breaker")

    def _state_locked(self) -> CircuitState:
        if (
            self._state == CircuitState.OPEN
            and time.monotonic() - self._opened_at >= self.cooldown_secs
        ):
            self._state = CircuitState.HALF_OPEN
            self._consecutive_successes = 0
            self._probe_started = None
        return self._state

    @property
    def state(self) -> CircuitState:
        with self._lock:
            return self._state_locked()

    def allow(self) -> bool:
        """Read-only admission check (no state consumed — safe for health
        endpoints and policy filters): OPEN denies, HALF_OPEN denies while a
        probe is already in flight."""
        with self._lock:
            st = self._state_locked()
            if st == CircuitState.OPEN:
                return False
            if st == CircuitState.HALF_OPEN:
                now = time.monotonic()
                if (
                    self._probe_started is not None
                    and now - self._probe_started < self.cooldown_secs
                ):
                    return False  # a probe is already in flight
            return True

    def begin_probe(self) -> None:
        """Claim the HALF_OPEN probe slot (called when a request actually
        dispatches).  The check-then-claim race with ``allow()`` can at
        worst let a second probe slip through — bounded, unlike the
        unbounded half-open flood this replaces."""
        with self._lock:
            if self._state_locked() == CircuitState.HALF_OPEN:
                self._probe_started = time.monotonic()

    def record_success(self) -> None:
        with self._lock:
            self._consecutive_failures = 0
            self._probe_started = None
            if self._state == CircuitState.HALF_OPEN:
                self._consecutive_successes += 1
                if self._consecutive_successes >= self.success_threshold:
                    self._state = CircuitState.CLOSED
            elif self._state == CircuitState.OPEN:
                pass
            else:
                self._consecutive_successes += 1

    def record_failure(self) -> None:
        with self._lock:
            self._consecutive_successes = 0
            self._consecutive_failures += 1
            self._probe_started = None
            if self._state == CircuitState.HALF_OPEN or (
                self._state == CircuitState.CLOSED
                and self._consecutive_failures >= self.failure_threshold
            ):
                self._state = CircuitState.OPEN
                self._opened_at = time.monotonic()


class WorkerType(enum.Enum):
    REGULAR = "regular"
    PREFILL = "prefill"
    DECODE = "decode"
    ENCODE = "encode"


class Worker:
    """A registered worker: client + gateway-side state."""

    def __init__(
        self,
        worker_id: str,
        client: WorkerClient,
        model_id: str = "default",
        worker_type: WorkerType = WorkerType.REGULAR,
        url: str = "",
        priority: int = 0,
        page_size: int | None = None,
        dp_size: int = 1,
        bootstrap_host: str | None = None,
        bootstrap_port: int | None = None,
    ):
        self.worker_id = worker_id
        self.client = client
        self.model_id = model_id
        self.worker_type = worker_type
        self.url = url or worker_id
        # PD-over-HTTP rendezvous endpoint on a PREFILL worker (reference:
        # pd_router.rs bootstrap_host/bootstrap_port): the engines transfer
        # KV between themselves; the gateway only injects the address
        self.bootstrap_host = bootstrap_host
        self.bootstrap_port = bootstrap_port
        self.priority = priority
        self.page_size = page_size  # engine KV page size (cache_aware event mode)
        self.dp_size = max(int(dp_size), 1)  # DP engine replicas behind this worker
        self.circuit = CircuitBreaker()
        self.healthy = True
        self.draining = False  # drain-before-remove: no new selections
        self._load = 0
        self._lock = make_lock("worker")
        self.registered_at = time.time()
        self.total_requests = 0
        self.total_failures = 0

    @property
    def load(self) -> int:
        # lock-free on purpose: routing policies read every candidate's load
        # per decision (~µs budget), and a torn read is impossible for a
        # GIL-atomic int — worst case the policy sees a load one request old
        return self._load  # smglint: disable=GUARDED hot-path snapshot read; GIL-atomic int

    def is_available(self) -> bool:
        return self.healthy and not self.draining and self.circuit.allow()

    def acquire(self) -> "WorkerLoadGuard":
        return WorkerLoadGuard(self)

    def _inc(self) -> None:
        with self._lock:
            self._load += 1
            self.total_requests += 1

    def _dec(self) -> None:
        with self._lock:
            self._load = max(0, self._load - 1)

    def _record_failure(self) -> None:
        # under the worker lock: total_failures is read by describe()/tests
        # from other threads, and += on a shared int is not atomic
        with self._lock:
            self.total_failures += 1

    def describe(self) -> dict:
        # cold path (debug/admin endpoints): take the lock so the request
        # counters come out of one consistent snapshot
        with self._lock:
            load = self._load
            total_requests = self.total_requests
            total_failures = self.total_failures
        return {
            "worker_id": self.worker_id,
            "model_id": self.model_id,
            "type": self.worker_type.value,
            "url": self.url,
            "healthy": self.healthy,
            "draining": self.draining,
            "circuit": self.circuit.state.value,
            "load": load,
            "total_requests": total_requests,
            "total_failures": total_failures,
        }


class WorkerLoadGuard:
    """RAII load accounting (reference: ``load_guard_raii_test.rs``).
    Releases exactly once, on success or failure."""

    def __init__(self, worker: Worker):
        self.worker = worker
        self._released = False
        worker.circuit.begin_probe()  # half-open: this dispatch IS the probe
        worker._inc()

    def release(self, success: "bool | None" = True) -> None:
        """Release once.  ``success=None`` releases the load WITHOUT a
        breaker signal — for outcomes that are neither success nor worker
        fault (admission backpressure: the worker is healthy, just full)."""
        if self._released:
            return
        self._released = True
        self.worker._dec()
        if success is None:
            return
        if success:
            self.worker.circuit.record_success()
        else:
            self.worker.circuit.record_failure()
            self.worker._record_failure()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.release(success=exc_type is None)


class WorkerRegistry:
    """Thread-safe worker registry with add/remove listeners
    (reference: ``worker/registry.rs:89``, 2,674 LoC)."""

    def __init__(self):
        self._workers: dict[str, Worker] = {}
        self._lock = make_lock("worker_registry")
        self._listeners: list[Callable[[str, Worker], None]] = []
        # per-REGISTRY breaker defaults (CLI --cb-*): applied as workers
        # register, so two gateways in one process keep their own settings
        self.circuit_breaker_config: "tuple | None" = None

    def add(self, worker: Worker) -> None:
        if self.circuit_breaker_config is not None:
            worker.circuit = CircuitBreaker(*self.circuit_breaker_config)
        with self._lock:
            if worker.worker_id in self._workers:
                raise ValueError(f"worker {worker.worker_id} already registered")
            self._workers[worker.worker_id] = worker
        logger.info("worker registered: %s (model=%s)", worker.worker_id, worker.model_id)
        self._notify("added", worker)

    def remove(self, worker_id: str) -> Worker | None:
        with self._lock:
            worker = self._workers.pop(worker_id, None)
        if worker is not None:
            logger.info("worker removed: %s", worker_id)
            self._notify("removed", worker)
        return worker

    def get(self, worker_id: str) -> Worker | None:
        with self._lock:
            return self._workers.get(worker_id)

    def list(self, model_id: str | None = None, worker_type: WorkerType | None = None) -> list[Worker]:
        with self._lock:
            ws = list(self._workers.values())
        if model_id is not None:
            ws = [w for w in ws if w.model_id == model_id]
        if worker_type is not None:
            ws = [w for w in ws if w.worker_type == worker_type]
        return ws

    def model_ids(self) -> list[str]:
        with self._lock:
            return sorted({w.model_id for w in self._workers.values()})

    def on_change(self, listener: Callable[[str, Worker], None]) -> None:
        self._listeners.append(listener)

    def _notify(self, event: str, worker: Worker) -> None:
        for cb in self._listeners:
            try:
                cb(event, worker)
            except Exception:
                logger.exception("worker registry listener failed")
