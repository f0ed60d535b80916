"""Engine-deep metrics: step-loop telemetry below the HTTP layer — the
port's copy of ``smg_tpu/engine/metrics.py``, with the same family names.
The speculative-decoding families count each verified lane by drafting
tier (``observe_spec``, fed by the scheduler's verify consume).

Reference: ``model_gateway/src/observability/`` — the reference gateway ships
45 ``record_*`` metric functions and exports engine counters (batch occupancy,
cache hit rate, token throughput) through one Prometheus registry.  The
gateway-level twin lives in ``smg_tpu_torch/gateway/observability.py``; this module
covers everything below it: the scheduler step loop, the radix prefix cache,
the KV page pool, speculative decoding, and device memory.

Design notes:

- ``EngineMetrics`` owns its instruments but can be *additionally* registered
  into the gateway's ``CollectorRegistry`` (``register_into``) so ``/metrics``
  exports one coherent ``smg_*`` set — prometheus collectors are registry
  -agnostic and may belong to several registries at once.
- The scheduler keeps plain int counters (cheap, lock-free under the engine
  lock); ``observe_step`` converts their cumulative values into Prometheus
  counter increments by delta-tracking, so the step loop never touches label
  lookups for quantities it already counts.
- Device memory gauges come from ``torch.cuda.memory_stats()`` and the
  card's total memory; an engine on the CPU has no such gauges.
- ``RollingStepStats`` is the live-signal side: p50/p95 step latency and
  tokens/s over the last N seconds, surfaced through ``Scheduler.loads()``
  and the gateway's ``/scheduler`` endpoint for the cache-aware router and
  benchmarks.
"""

from __future__ import annotations

import time
from collections import deque

from prometheus_client import CollectorRegistry, Counter, Gauge, Histogram

from smg_tpu_torch.utils import get_logger

logger = get_logger("engine.metrics")

# step latencies sit well under the request-level buckets: millisecond
# decode steps up to multi-second chunked prefills
STEP_LATENCY_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 10.0,
)


class RollingStepStats:
    """Fixed-horizon window over step records -> p50/p95 step time, tokens/s.

    Append-only deque pruned on both record and snapshot; bounded by
    ``max_samples`` so a pathological step rate cannot grow host memory.
    All callers hold the engine lock, so no extra locking here.
    """

    def __init__(self, window_secs: float = 30.0, max_samples: int = 8192):
        self.window_secs = window_secs
        self.max_samples = max_samples
        # (monotonic_ts, step_seconds, prefill_tokens, decode_tokens)
        self._samples: deque[tuple[float, float, int, int]] = deque()

    def record(
        self, step_seconds: float, prefill_tokens: int, decode_tokens: int,
        now: float | None = None,
    ) -> None:
        now = time.monotonic() if now is None else now
        self._samples.append((now, step_seconds, prefill_tokens, decode_tokens))
        self._prune(now)

    def _prune(self, now: float) -> None:
        horizon = now - self.window_secs
        s = self._samples
        while s and (s[0][0] < horizon or len(s) > self.max_samples):
            s.popleft()

    def snapshot(self, now: float | None = None) -> dict:
        """Live stats over the window (keys stable for /scheduler + loads())."""
        now = time.monotonic() if now is None else now
        self._prune(now)
        s = self._samples
        if not s:
            return {
                "window_secs": self.window_secs, "num_steps": 0,
                "p50_step_seconds": 0.0, "p95_step_seconds": 0.0,
                "steps_per_s": 0.0, "prefill_tokens_per_s": 0.0,
                "decode_tokens_per_s": 0.0, "tokens_per_s": 0.0,
            }
        durations = sorted(x[1] for x in s)
        n = len(durations)
        # effective span: oldest record's age plus that step's own duration
        # (records are stamped at step END, so the first step's work would
        # otherwise fall outside the window), floored so a burst of steps in
        # 1ms doesn't report absurd rates
        span = max(now - s[0][0] + s[0][1], 1e-3)
        pf = sum(x[2] for x in s)
        dc = sum(x[3] for x in s)
        return {
            "window_secs": self.window_secs,
            "num_steps": n,
            "p50_step_seconds": durations[n // 2],
            "p95_step_seconds": durations[min(n - 1, (n * 95) // 100)],
            "steps_per_s": n / span,
            "prefill_tokens_per_s": pf / span,
            "decode_tokens_per_s": dc / span,
            "tokens_per_s": (pf + dc) / span,
        }


class EngineMetrics:
    """Engine metric set (``smg_engine_*``, same naming scheme as the
    gateway's ``smg_*`` metrics)."""

    def __init__(
        self,
        registry: CollectorRegistry | None = None,
        window_secs: float = 30.0,
        device_sample_interval_secs: float = 10.0,
    ):
        self.registry = registry or CollectorRegistry()
        self.window = RollingStepStats(window_secs)
        self.device_sample_interval_secs = device_sample_interval_secs
        self._next_device_sample = 0.0
        self._last: dict[str, int] = {}  # cumulative-counter delta tracking
        self._collectors: list = []
        r = self.registry

        def _track(c):
            self._collectors.append(c)
            return c

        self.step_duration = _track(Histogram(
            "smg_engine_step_duration_seconds",
            "Engine step latency by phase (prefill admission / decode / full step)",
            ["phase"], buckets=STEP_LATENCY_BUCKETS, registry=r,
        ))
        self.prefill_tokens = _track(Counter(
            "smg_engine_prefill_tokens_total",
            "Prompt tokens computed by prefill (cache misses; excludes radix hits)",
            registry=r,
        ))
        self.decode_tokens = _track(Counter(
            "smg_engine_decode_tokens_total",
            "Tokens produced by decode steps (incl. speculative-accepted)",
            registry=r,
        ))
        self.cached_prompt_tokens = _track(Counter(
            "smg_engine_cached_prompt_tokens_total",
            "Prompt tokens served from the radix prefix cache at admission",
            registry=r,
        ))
        self.preemptions = _track(Counter(
            "smg_engine_preemptions_total",
            "Requests evicted mid-generation for KV pages", registry=r,
        ))
        self.requests_finished = _track(Counter(
            "smg_engine_requests_finished_total",
            "Engine request completions by finish reason", ["reason"], registry=r,
        ))
        self.spec_drafted = _track(Counter(
            "smg_engine_spec_drafted_tokens_total",
            "Speculative tokens proposed, by drafting tier (ngram = "
            "prompt-lookup over the request's own context, draft = small "
            "draft model)", ["tier"], registry=r,
        ))
        self.spec_accepted = _track(Counter(
            "smg_engine_spec_accepted_tokens_total",
            "Speculative tokens accepted by the fused verify block, by "
            "drafting tier", ["tier"], registry=r,
        ))
        self.spec_accept_len = _track(Histogram(
            "smg_engine_spec_accepted_length",
            "Accepted-prefix length per lane per verify block (0 = first "
            "draft rejected; the distribution the adaptive draft-depth "
            "controller follows)",
            buckets=(0, 1, 2, 3, 4, 6, 8, 12, 16), registry=r,
        ))
        self.radix_hit_pages = _track(Counter(
            "smg_engine_radix_hit_pages_total",
            "KV pages reused from the radix cache at admission", registry=r,
        ))
        self.radix_miss_pages = _track(Counter(
            "smg_engine_radix_miss_pages_total",
            "KV pages newly allocated at admission (radix misses)", registry=r,
        ))
        self.radix_evicted_pages = _track(Counter(
            "smg_engine_radix_evicted_pages_total",
            "KV pages evicted from the radix cache (LRU + flush)", registry=r,
        ))
        self.radix_cached_pages = _track(Gauge(
            "smg_engine_radix_cached_pages",
            "KV pages currently held by the radix cache", registry=r,
        ))
        self.running_requests = _track(Gauge(
            "smg_engine_running_requests",
            "Requests resident in decode slots", registry=r,
        ))
        self.waiting_requests = _track(Gauge(
            "smg_engine_waiting_requests",
            "Requests queued for admission (incl. preempted)", registry=r,
        ))
        self.batch_occupancy = _track(Gauge(
            "smg_engine_batch_occupancy",
            "Decode-slot occupancy ratio (running / max_batch_size)", registry=r,
        ))
        self.kv_free_pages = _track(Gauge(
            "smg_engine_kv_free_pages", "Free pages in the KV page pool",
            registry=r,
        ))
        self.kv_total_pages = _track(Gauge(
            "smg_engine_kv_total_pages", "Total pages in the KV page pool",
            registry=r,
        ))
        self.kv_page_utilization = _track(Gauge(
            "smg_engine_kv_page_utilization",
            "Fraction of KV pages in use (allocated or cached)", registry=r,
        ))
        self.hbm_bytes_in_use = _track(Gauge(
            "smg_engine_hbm_bytes_in_use",
            "Device memory in use (torch.cuda.memory_stats; absent on CPU)",
            ["device"], registry=r,
        ))
        self.hbm_bytes_limit = _track(Gauge(
            "smg_engine_hbm_bytes_limit",
            "Device memory capacity (CUDA device properties; absent on CPU)",
            ["device"], registry=r,
        ))
        # stall-free chunked-prefill scheduling (per-step prefill budget)
        self.steps_kind = _track(Counter(
            "smg_engine_steps_total",
            "Scheduler steps that moved tokens, by composition (kind: "
            "prefill-only, decode-only, or mixed — a mixed step carried a "
            "prefill chunk AND a decode launch under the per-step budget)",
            ["kind"], registry=r,
        ))
        self.decode_stall = _track(Counter(
            "smg_engine_decode_stall_seconds_total",
            "Decode delay attributable to same-step prefill work (host-side "
            "prefill-phase seconds in steps that also decoded); bounded by "
            "~one chunk per step under stall-free scheduling, by the whole "
            "prompt under the legacy throughput policy",
            registry=r,
        ))
        self.prefill_inflight = _track(Gauge(
            "smg_engine_prefill_inflight_tokens",
            "Un-prefilled prompt tokens of admitted in-progress (resumable) "
            "prefills — slot-holding prefill backlog",
            registry=r,
        ))
        # failure isolation (poison-step quarantine / deadlines / watchdog)
        self.step_failures = _track(Counter(
            "smg_engine_step_failures_total",
            "Scheduler steps that raised, by phase (prefill = admission/"
            "prefill dispatch, decode = batch launch/consume, loop = "
            "escaped to the engine loop's last-resort handler)",
            ["phase"], registry=r,
        ))
        self.quarantined_requests = _track(Counter(
            "smg_engine_quarantined_requests_total",
            "Requests failed with finish_reason=error by poison-step "
            "quarantine (blamed for a prefill/decode step failure); their "
            "pages, radix locks, and decode lanes are released while "
            "surviving lanes keep streaming",
            registry=r,
        ))
        self.deadline_expirations = _track(Counter(
            "smg_engine_deadline_expirations_total",
            "Requests finished with reason=timeout by the per-request "
            "deadline sweep (state: waiting = expired in queue before "
            "admission, running = aborted mid-generation)",
            ["state"], registry=r,
        ))
        self.queue_rejections = _track(Counter(
            "smg_engine_queue_rejections_total",
            "Submits rejected by the bounded waiting queue "
            "(max_queued_requests / max_queued_tokens backpressure)",
            registry=r,
        ))
        self.watchdog_stalls = _track(Counter(
            "smg_engine_watchdog_stalls_total",
            "Step-watchdog detections of a wedged engine (no step progress "
            "for step_watchdog_secs while work was pending)",
            registry=r,
        ))
        self.flight_dumps = _track(Counter(
            "smg_engine_flight_dumps_total",
            "Flight-recorder postmortem dumps by trigger (reason: "
            "quarantine, health_flip, watchdog_stall, drain; rate-limited "
            "per reason — see engine/flight_recorder.py)",
            ["reason"], registry=r,
        ))
        # megastep decode (device-fused K-step horizon, engine/runner.py)
        self.decode_horizon = _track(Gauge(
            "smg_engine_decode_horizon",
            "Decode horizon K of the most recent consumed megastep (tokens "
            "per device round trip; 1 = single-step, forced for grammar-"
            "masked and stop-string batches; the adaptive controller moves "
            "this with finish rates, page headroom, and admission pressure)",
            registry=r,
        ))
        self.wasted_decode_tokens = _track(Counter(
            "smg_engine_wasted_decode_tokens_total",
            "Decode token slots computed on device but never emitted: "
            "horizon columns past a finish (normally zero thanks to the "
            "done-mask early exit) plus discarded lookahead frames counted "
            "at full width (upper bound — their results are never fetched)",
            registry=r,
        ))
        self.megastep_early_exits = _track(Counter(
            "smg_engine_megastep_early_exits_total",
            "Megastep device loops that exited before the requested horizon "
            "because a lane finished (EOS/stop-token/length detected by the "
            "device-side done mask)",
            registry=r,
        ))
        # overlapped decode pipeline (scheduler one-step lookahead)
        self.lookahead_launches = _track(Counter(
            "smg_engine_lookahead_launches_total",
            "Overlap-pipeline steps by lookahead outcome (kept = chained "
            "launch stood; discarded = schedule changed, launch dropped; "
            "sync = no lookahead launched, forced-sync or unpredictable)",
            ["outcome"], registry=r,
        ))
        self.deferred_fetch = _track(Histogram(
            "smg_engine_deferred_fetch_seconds",
            "Time blocked materializing an in-flight decode's results "
            "(device not yet done when the host came back for them)",
            buckets=STEP_LATENCY_BUCKETS, registry=r,
        ))
        self.overlap_host_busy = _track(Counter(
            "smg_engine_overlap_host_busy_seconds_total",
            "Host-side step time excluding the deferred fetch wait "
            "(scheduling, detokenize, bookkeeping that overlap device work)",
            registry=r,
        ))
        self.overlap_device_wait = _track(Counter(
            "smg_engine_overlap_device_wait_seconds_total",
            "Cumulative deferred-fetch wait (host stalled on the device); "
            "rate vs overlap_host_busy gives the pipeline balance",
            registry=r,
        ))
        # tensor-parallel sharded decode (first-class runner mode)
        self.mesh_devices = _track(Gauge(
            "smg_engine_mesh_devices",
            "Devices in this engine's mesh (1 = single-device; tp*dp*sp*"
            "ep*pp otherwise) — the unit the per-worker throughput story "
            "multiplies over",
            registry=r,
        ))
        self.dispatch_seconds = _track(Counter(
            "smg_engine_dispatch_seconds_total",
            "Per-step host time by dispatch phase: enqueue = async launch "
            "of the (sharded or single-device) decode/verify programs, "
            "fetch = blocked materializing their results.  On a mesh the "
            "enqueue share is the sharded-dispatch overhead the megastep "
            "must amortize",
            ["phase"], registry=r,
        ))

    # ---- registry unification ----

    def register_into(self, registry: CollectorRegistry) -> None:
        """Additionally register every engine collector into ``registry``
        (the gateway's) so one /metrics scrape covers both layers.
        All-or-nothing: a name collision (e.g. a second engine adopting into
        the same gateway registry) rolls back and re-raises, never leaving a
        half-registered set."""
        if registry is self.registry:
            return
        done = []
        try:
            for c in self._collectors:
                registry.register(c)
                done.append(c)
        except ValueError:
            for c in done:
                registry.unregister(c)
            raise

    def unregister_from(self, registry: CollectorRegistry) -> None:
        for c in self._collectors:
            try:
                registry.unregister(c)
            except KeyError:
                pass

    # ---- step-loop hooks ----

    def _bump(self, key: str, counter: Counter, cumulative: int) -> None:
        """Increment ``counter`` by the delta of a scheduler-side cumulative
        int since the last observation (restart-safe: a smaller value resets
        the baseline rather than underflowing)."""
        last = self._last.get(key, 0)
        if cumulative < last:
            last = 0
        if cumulative > last:
            counter.inc(cumulative - last)
        self._last[key] = cumulative

    def observe_step(
        self,
        *,
        step_s: float,
        prefill_s: float,
        decode_s: float,
        prefill_tokens: int,
        decode_tokens: int,
        running: int,
        waiting: int,
        max_batch: int,
        prefill_inflight_tokens: int = 0,
        free_pages: int,
        total_pages: int,
        cached_pages: int,
        cumulative: dict | None = None,
        decode_horizon: int = 0,
    ) -> None:
        """Record one scheduler step.  ``prefill_tokens``/``decode_tokens``
        are this step's deltas; ``cumulative`` carries the scheduler's
        monotonically-growing counters (spec/preemption/radix), converted to
        Prometheus increments here."""
        self.step_duration.labels(phase="step").observe(step_s)
        if prefill_tokens:
            self.step_duration.labels(phase="prefill").observe(prefill_s)
            self.prefill_tokens.inc(prefill_tokens)
        if decode_tokens:
            self.step_duration.labels(phase="decode").observe(decode_s)
            self.decode_tokens.inc(decode_tokens)
            if decode_horizon > 0:
                self.decode_horizon.set(decode_horizon)
        if prefill_tokens or decode_tokens:
            kind = (
                "mixed" if (prefill_tokens and decode_tokens)
                else ("prefill" if prefill_tokens else "decode")
            )
            self.steps_kind.labels(kind=kind).inc()
            if prefill_tokens and decode_tokens:
                # the decode launch waited behind this step's prefill work
                self.decode_stall.inc(max(prefill_s, 0.0))
        self.prefill_inflight.set(prefill_inflight_tokens)
        self.running_requests.set(running)
        self.waiting_requests.set(waiting)
        self.batch_occupancy.set(running / max_batch if max_batch else 0.0)
        self.kv_free_pages.set(free_pages)
        self.kv_total_pages.set(total_pages)
        self.kv_page_utilization.set(
            (total_pages - free_pages) / total_pages if total_pages else 0.0
        )
        self.radix_cached_pages.set(cached_pages)
        for key, counter in (
            ("preemptions", self.preemptions),
            ("radix_hit_pages", self.radix_hit_pages),
            ("radix_miss_pages", self.radix_miss_pages),
            ("radix_evicted_pages", self.radix_evicted_pages),
            ("cached_prompt_tokens", self.cached_prompt_tokens),
            ("wasted_decode_tokens", self.wasted_decode_tokens),
            ("megastep_early_exits", self.megastep_early_exits),
        ):
            if cumulative and key in cumulative:
                self._bump(key, counter, int(cumulative[key]))
        self.window.record(step_s, prefill_tokens, decode_tokens)

    def on_finish(self, reason: str) -> None:
        self.requests_finished.labels(reason=reason or "unknown").inc()

    def observe_spec(self, tier: str, drafted: int, accepted: int) -> None:
        """Record one lane's draft-verify outcome (called per eligible lane
        per consumed verify block): tier-labeled drafted/accepted token
        totals plus the acceptance-length sample the depth controller's EMA
        mirrors."""
        self.spec_drafted.labels(tier=tier).inc(drafted)
        self.spec_accepted.labels(tier=tier).inc(accepted)
        self.spec_accept_len.observe(accepted)

    def observe_overlap(
        self, *, outcome: str, fetch_wait_s: float, host_s: float
    ) -> None:
        """Record one overlap-pipeline step: its lookahead outcome and the
        host-busy vs device-wait split (the numbers that show whether host
        work actually hides behind device compute)."""
        self.lookahead_launches.labels(outcome=outcome).inc()
        self.deferred_fetch.observe(fetch_wait_s)
        self.overlap_host_busy.inc(max(host_s, 0.0))
        self.overlap_device_wait.inc(max(fetch_wait_s, 0.0))

    def observe_dispatch(self, *, enqueue_s: float, fetch_s: float) -> None:
        """Record one step's dispatch-time split (async launch enqueue vs
        deferred-fetch block); see ``smg_engine_dispatch_seconds_total``."""
        self.dispatch_seconds.labels(phase="enqueue").inc(max(enqueue_s, 0.0))
        self.dispatch_seconds.labels(phase="fetch").inc(max(fetch_s, 0.0))

    def set_mesh_devices(self, n: int) -> None:
        """One-shot topology gauge (engine construction)."""
        self.mesh_devices.set(n)

    # ---- device memory gauges ----

    def maybe_sample_devices(self, devices, now: float | None = None) -> bool:
        """Rate-limited HBM sampling (the step loop calls this every step;
        memory_stats is a host round-trip, so cadence-gate it)."""
        now = time.monotonic() if now is None else now
        if now < self._next_device_sample:
            return False
        self._next_device_sample = now + self.device_sample_interval_secs
        self.sample_devices(devices)
        return True

    def sample_devices(self, devices) -> int:
        """Read ``torch.cuda.memory_stats`` for every CUDA device in
        ``devices``; returns how many reported.  Other devices have no
        stats and are skipped — the gauges simply never appear, rather
        than exporting zeros."""
        import torch

        sampled = 0
        for d in devices or ():
            if getattr(d, "type", None) != "cuda":
                continue
            stats = torch.cuda.memory_stats(d)
            name = f"cuda:{d.index if d.index is not None else 0}"
            self.hbm_bytes_in_use.labels(device=name).set(
                stats.get("allocated_bytes.all.current", 0)
            )
            self.hbm_bytes_limit.labels(device=name).set(
                torch.cuda.get_device_properties(d).total_memory
            )
            sampled += 1
        return sampled
