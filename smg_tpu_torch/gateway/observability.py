"""Gateway metrics — the port's copy of the part of
``smg_tpu/gateway/observability.py`` that the ported handlers touch: the
request, token, TTFT, retry and worker families under the reference's
names, and the ``track_request`` context.  In-proc engines' collectors are
registered into the same registry (``AppContext.adopt_engine_metrics``), so
``/metrics`` is one scrape.  The SLO tracker, the SLO enforcer and the
routing-plane observability are not ported yet.
"""

from __future__ import annotations

import contextvars
import time
from contextlib import contextmanager

from prometheus_client import (
    CollectorRegistry,
    Counter,
    Gauge,
    Histogram,
    generate_latest,
)

LATENCY_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

#: ambient HTTP route for metric labels below the handler layer —
#: ``track_request`` parks the route here so the router can label TTFT
#: without threading the request path through every dispatch call
current_route: contextvars.ContextVar[str] = contextvars.ContextVar(
    "metrics_current_route", default="unknown"
)


class Metrics:
    """Gateway metric set (names mirror the reference's smg_* metrics)."""

    def __init__(self, registry: CollectorRegistry | None = None):
        self.registry = registry or CollectorRegistry()
        r = self.registry
        self.requests_total = Counter(
            "smg_requests_total", "Requests received", ["route", "status"], registry=r
        )
        self.request_duration = Histogram(
            "smg_request_duration_seconds", "End-to-end request latency", ["route"],
            buckets=LATENCY_BUCKETS, registry=r,
        )
        self.ttft = Histogram(
            "smg_time_to_first_token_seconds", "Time to first streamed token", ["route"],
            buckets=LATENCY_BUCKETS, registry=r,
        )
        self.generated_tokens = Counter(
            "smg_generated_tokens_total", "Tokens generated", registry=r
        )
        self.prompt_tokens = Counter(
            "smg_prompt_tokens_total", "Prompt tokens processed", registry=r
        )
        self.cached_tokens = Counter(
            "smg_cached_prompt_tokens_total", "Prompt tokens served from prefix cache",
            registry=r,
        )
        self.in_flight = Gauge(
            "smg_in_flight_requests", "Requests currently executing", registry=r
        )
        self.worker_load = Gauge(
            "smg_worker_load", "Gateway-tracked per-worker in-flight requests",
            ["worker_id"], registry=r,
        )
        self.worker_healthy = Gauge(
            "smg_worker_healthy", "Worker health (1 healthy / 0 not)",
            ["worker_id"], registry=r,
        )
        self.retries_total = Counter(
            "smg_request_retries_total", "Dispatch retries", registry=r
        )

    def export(self) -> bytes:
        return generate_latest(self.registry)

    @contextmanager
    def track_request(self, route: str):
        """Track one request; yields a tracker whose ``status`` the caller
        sets from the actual response (handlers that return 4xx/5xx without
        raising must not count as 200).  Unset + no exception = "200"."""
        start = time.perf_counter()
        self.in_flight.inc()
        tracker = _RequestTracker()
        route_token = current_route.set(route)
        try:
            yield tracker
        except Exception:
            tracker.status = "error"
            raise
        finally:
            current_route.reset(route_token)
            self.in_flight.dec()
            self.requests_total.labels(route=route, status=str(tracker.status)).inc()
            self.request_duration.labels(route=route).observe(time.perf_counter() - start)


class _RequestTracker:
    """Mutable status cell handed out by ``Metrics.track_request``."""

    __slots__ = ("status",)

    def __init__(self):
        self.status = "200"
