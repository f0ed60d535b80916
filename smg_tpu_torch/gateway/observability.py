"""Gateway metrics — the port's copy of ``smg_tpu/gateway/observability.py``:
the request, token, TTFT, retry, worker, rate-limit and queue-wait families
under the reference's names, the ``track_request`` context, the SLO
accounting (``SloRequest``, ``SloTracker``, ``aggregate_slo_records``)
behind the inter-token-latency, deadline and goodput families,
``/debug/slo`` and the SLO enforcer, and the routing plane (``route``:
``gateway/route_observability.py``).  In-proc engines' collectors are
registered into the same registry (``AppContext.adopt_engine_metrics``), so
``/metrics`` is one scrape.

The SLO hooks read ``time.perf_counter()`` only, at the router's chunk
arrivals: nothing here waits on the card.
"""

from __future__ import annotations

import contextvars
import time
from collections import deque
from contextlib import contextmanager

from prometheus_client import (
    CollectorRegistry,
    Counter,
    Gauge,
    Histogram,
    generate_latest,
)

from smg_tpu_torch.analysis.runtime_guards import make_lock
from smg_tpu_torch.utils import percentile

LATENCY_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

# inter-token gaps sit well under request latencies: sub-ms decode steps up
# to multi-second stalls behind an interfering prefill
ITL_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5)

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
        self.rate_limited_total = Counter(
            "smg_rate_limited_total", "Requests rejected by rate limiting", registry=r
        )
        self.queue_wait = Histogram(
            "smg_scheduler_queue_wait_seconds", "Priority-scheduler queue wait",
            ["priority"], buckets=LATENCY_BUCKETS, registry=r,
        )
        # ---- SLO / goodput accounting (fed by the router via self.slo) ----
        self.itl = Histogram(
            "smg_inter_token_latency_seconds",
            "Inter-token latency (per-TOKEN gap, sampled once per streamed "
            "chunk: chunk arrival gap divided by tokens in the chunk)",
            ["route"], buckets=ITL_BUCKETS, registry=r,
        )
        self.deadline_outcomes = Counter(
            "smg_request_deadline_outcomes_total",
            "Requests WITH a deadline (--request-timeout-secs) by outcome: "
            "met = finished cleanly inside the budget, missed = expired or "
            "errored past it",
            ["outcome"], registry=r,
        )
        self.goodput_tokens = Counter(
            "smg_goodput_tokens_total",
            "Output tokens of requests that completed successfully within "
            "their deadline (no deadline = vacuously met); goodput = rate() "
            "of this vs smg_generated_tokens_total",
            registry=r,
        )
        # ---- SLO enforcement (gateway/slo_enforcement.py): declarative
        # specs judged over the SloTracker ring; verdicts behind
        # GET /debug/slo/verdicts ----
        self.slo_violations = Counter(
            "smg_slo_violations_total",
            "SLO evaluation-window violation onsets (edge-triggered per "
            "window: a not-violating -> violating transition counts once, "
            "re-evaluating a still-violating window does not)",
            ["slo", "window"], registry=r,
        )
        self.slo_burn_rate = Gauge(
            "smg_slo_burn_rate",
            "Worst current error-budget burn rate across the SLO's "
            "fast/slow windows (deadline-miss fraction / budget; >= 1 "
            "means the budget is being consumed faster than allowed)",
            ["slo"], registry=r,
        )
        #: per-request SLO timeline accounting behind the three families
        #: above, plus the /debug/slo rolling summary with trace-id exemplars
        self.slo = SloTracker(self)
        #: SLO verdict engine over the tracker ring (specs installed via
        #: --slo-spec / AppContext(slo_specs=...); empty = nothing enforced)
        from smg_tpu_torch.gateway.slo_enforcement import SloEnforcer

        self.slo_enforcer = SloEnforcer(self)
        #: routing-plane observability: per-model decision rings behind
        #: /debug/router, predicted-vs-actual prefix-hit reconciliation,
        #: cache-index gauges, KvEventMonitor health families
        #: (gateway/route_observability.py)
        from smg_tpu_torch.gateway.route_observability import RouteObservability

        self.route = RouteObservability(self)

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


# ---- SLO / goodput accounting --------------------------------------------
#
# The engine's flight recorder keeps per-request timelines WORKER-side; this
# is the gateway-side twin over router dispatches: TTFT / ITL / e2e against
# each request's deadline, goodput (= deadline-met token throughput), and a
# bounded ring of completed-request records carrying trace-id exemplars that
# link a /debug/slo row to its OTel trace and its worker flight timeline.


class SloRequest:
    """One routed request's SLO accounting handle (router-held).  Terminal
    transitions are idempotent: the first of finish/fail/abandon wins."""

    __slots__ = (
        "_tracker", "rid", "route", "trace_id", "t_start", "deadline_s",
        "t_first", "t_last", "prompt_tokens", "cached_tokens",
        "output_tokens", "itl_total", "itl_tokens", "_done",
    )

    def __init__(self, tracker: "SloTracker", rid: str, route: str,
                 deadline_s: float | None, trace_id: str | None,
                 t_start: float):
        self._tracker = tracker
        self.rid = rid
        self.route = route
        self.trace_id = trace_id
        self.t_start = t_start  # the FIRST-dispatch clock, never reset
        self.deadline_s = deadline_s
        self.t_first: float | None = None
        self.t_last: float | None = None
        self.prompt_tokens = 0
        self.cached_tokens = 0
        self.output_tokens = 0
        self.itl_total = 0.0
        self.itl_tokens = 0
        self._done = False

    def first_token(self, prompt_tokens: int, cached_tokens: int) -> None:
        if self.t_first is not None:
            return
        now = time.perf_counter()
        self.t_first = self.t_last = now
        self.prompt_tokens = prompt_tokens
        self.cached_tokens = cached_tokens

    def tokens(self, n: int) -> None:
        """Record ``n`` output tokens arriving now; gaps after the first
        chunk contribute ITL samples (per-chunk mean gap)."""
        if n <= 0:
            return
        now = time.perf_counter()
        if self.t_last is not None and self.output_tokens > 0:
            # PER-TOKEN gap, everywhere: the histogram sample and the
            # record's itl_mean_s must agree with each other (and with the
            # engine flight timeline) regardless of chunking/decode horizon
            gap = now - self.t_last
            self.itl_total += gap
            self.itl_tokens += n
            m = self._tracker.metrics
            if m is not None:
                m.itl.labels(route=self.route).observe(gap / n)
        self.t_last = now
        self.output_tokens += n

    def finish(self, reason: str | None) -> None:
        self._terminal(reason or "stop", error=False)

    def fail(self, reason: str = "error") -> None:
        self._terminal(reason, error=True)

    def abandon(self, reason: str = "abort") -> None:
        """Terminal fallback for VOLUNTARY endings (client disconnect,
        cancellation); no-op once terminal.  Excluded from deadline
        outcomes — a fast client abort is neither met nor missed, and
        counting it as missed would inflate SLO miss rate with endings the
        server did not cause."""
        self._terminal(reason, error=True, voluntary=True)

    def _terminal(self, reason: str, error: bool,
                  voluntary: bool = False) -> None:
        if self._done:
            return
        self._done = True
        self._tracker._complete(self, reason, error, voluntary)


def aggregate_slo_records(records: "list[dict]") -> dict:
    """THE aggregation over completed-request records — the single
    definition of the SLO conventions: nearest-rank percentiles over
    per-request values, VOLUNTARY endings (client disconnects) excluded
    from deadline accounting, goodput = deadline-met token share
    (vacuously 1.0 over zero tokens).  Percentiles are ``None`` over empty
    sample sets.  Shared by ``SloTracker.summary`` (``/debug/slo``) and the
    SLO enforcer's window stats (``/debug/slo/verdicts``,
    ``gateway/slo_enforcement.py``) so the two surfaces cannot diverge."""
    ttfts = [r["ttft_s"] for r in records if r["ttft_s"] is not None]
    itls = [r["itl_mean_s"] for r in records if r["itl_mean_s"] is not None]
    e2es = [r["e2e_s"] for r in records]
    with_deadline = [
        r for r in records
        if r["deadline_s"] is not None and not r["voluntary"]
    ]
    missed = sum(1 for r in with_deadline if not r["deadline_met"])
    good_tokens = sum(r["output_tokens"] for r in records if r["deadline_met"])
    all_tokens = sum(r["output_tokens"] for r in records)
    return {
        "requests": len(records),
        "with_deadline": len(with_deadline),
        "deadline_missed": missed,
        "miss_fraction": (missed / len(with_deadline)) if with_deadline else 0.0,
        "ttft_p50_s": percentile(ttfts, 50) if ttfts else None,
        "ttft_p95_s": percentile(ttfts, 95) if ttfts else None,
        "itl_p50_s": percentile(itls, 50) if itls else None,
        "itl_p95_s": percentile(itls, 95) if itls else None,
        "e2e_p50_s": percentile(e2es, 50) if e2es else None,
        "e2e_p95_s": percentile(e2es, 95) if e2es else None,
        "goodput_tokens": good_tokens,
        "total_tokens": all_tokens,
        "goodput_ratio": (good_tokens / all_tokens) if all_tokens else 1.0,
    }


class SloTracker:
    """Bounded completed-request ring + rolling aggregates for /debug/slo.

    Locked: routers on the event loop write, /debug/slo and tests read; the
    critical sections are dict/deque appends, never I/O."""

    def __init__(self, metrics: "Metrics | None" = None, keep: int = 256):
        self.metrics = metrics
        self.keep = keep
        self._lock = make_lock("slo_tracker")
        self._done: deque = deque(maxlen=keep)
        self.num_requests = 0

    def begin(
        self, rid: str, route: str = "unknown",
        deadline_secs: float | None = None, trace_id: str | None = None,
        t_start: float | None = None,
    ) -> SloRequest:
        return SloRequest(
            self, rid, route, deadline_secs, trace_id,
            time.perf_counter() if t_start is None else t_start,
        )

    def _complete(self, req: SloRequest, reason: str, error: bool,
                  voluntary: bool = False) -> None:
        t_end = time.perf_counter()
        e2e = t_end - req.t_start
        # a deadline is met only by a CLEAN finish inside the budget; engine
        # "timeout" finishes and router errors are misses by definition.
        # VOLUNTARY endings (client disconnect) count toward neither.
        clean = not error and reason not in ("timeout", "error")
        if req.deadline_s is not None:
            met = clean and e2e <= req.deadline_s
        else:
            met = clean  # vacuous deadline: success = goodput
        m = self.metrics
        if m is not None:
            if req.deadline_s is not None and not voluntary:
                m.deadline_outcomes.labels(
                    outcome="met" if met else "missed"
                ).inc()
            if met and req.output_tokens:
                m.goodput_tokens.inc(req.output_tokens)
        record = {
            "rid": req.rid,
            "route": req.route,
            "trace_id": req.trace_id,
            "reason": reason,
            "ttft_s": (req.t_first - req.t_start)
            if req.t_first is not None else None,
            "e2e_s": e2e,
            "itl_mean_s": (req.itl_total / req.itl_tokens)
            if req.itl_tokens else None,
            "prompt_tokens": req.prompt_tokens,
            "cached_tokens": req.cached_tokens,
            "output_tokens": req.output_tokens,
            "deadline_s": req.deadline_s,
            "deadline_met": met,
            "voluntary": voluntary,
            "t_end": t_end,
        }
        with self._lock:
            self.num_requests += 1
            self._done.append(record)

    def window_records(self, window_secs: float,
                       now: float | None = None) -> list[dict]:
        """Completed-request records whose finish fell inside the trailing
        ``window_secs`` (perf_counter clock, same as the records' ``t_end``).
        The ring bounds this at ``keep`` records — a window older than the
        ring's tail sees only what the ring still holds (size the ring, not
        the window, for long-horizon SLOs)."""
        cutoff = (time.perf_counter() if now is None else now) - window_secs
        with self._lock:
            return [r for r in self._done if r["t_end"] >= cutoff]

    def summary(self, recent: int = 32) -> dict:
        """Rolling SLO summary over the completed-request ring (the
        /debug/slo payload).  Percentiles are over per-request values; ITL
        is the per-request mean gap.  Goodput rate spans the ring window.
        Aggregation semantics live in ``aggregate_slo_records`` (shared
        with the SLO enforcer — the two surfaces report one truth)."""
        with self._lock:
            records = list(self._done)
            total = self.num_requests
        agg = aggregate_slo_records(records)
        span = (
            max(r["t_end"] for r in records)
            - min(r["t_end"] - r["e2e_s"] for r in records)
            if records else 0.0
        )
        reasons: dict[str, int] = {}
        for r in records:
            reasons[r["reason"]] = reasons.get(r["reason"], 0) + 1

        def z(v):  # this payload historically reports 0.0 over empty samples
            return 0.0 if v is None else v

        return {
            "window_requests": agg["requests"],
            "total_requests": total,
            "finish_reasons": reasons,
            "ttft": {"p50_s": z(agg["ttft_p50_s"]),
                     "p95_s": z(agg["ttft_p95_s"])},
            "itl": {"p50_s": z(agg["itl_p50_s"]),
                    "p95_s": z(agg["itl_p95_s"])},
            "e2e": {"p50_s": z(agg["e2e_p50_s"]),
                    "p95_s": z(agg["e2e_p95_s"])},
            "deadline": {
                "with_deadline": agg["with_deadline"],
                "met": agg["with_deadline"] - agg["deadline_missed"],
                "missed": agg["deadline_missed"],
            },
            "goodput": {
                "tokens": agg["goodput_tokens"],
                "total_tokens": agg["total_tokens"],
                "tokens_per_s": (
                    agg["goodput_tokens"] / span if span > 1e-9 else 0.0
                ),
                "ratio": agg["goodput_ratio"],
            },
            # trace-id exemplars: each row links to its OTel trace and (via
            # the propagated traceparent) its worker flight timeline
            "recent": records[-recent:] if recent > 0 else [],
        }
