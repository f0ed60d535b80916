"""Engine flight recorder: the step-loop black box — the port's copy of
``smg_tpu/engine/flight_recorder.py`` (same ``SCHEMA_VERSION`` and
``STEP_RECORD_KEYS``, so one dump reader serves both engines).

Aggregate metrics (``engine/metrics.py``) answer "how is the worker doing";
they cannot answer "what happened in the 200 steps before this worker
quarantined a request" or "where did this one request's 3-second TTFT go".
This module is the postmortem layer: an always-on, bounded-overhead record
of recent engine activity that is dumped as structured JSON when something
goes wrong (quarantine, watchdog stall, health flip, drain) and fetchable on
demand (``Engine.dump_flight`` → ``DumpFlight`` RPC →
``GET /debug/flight/{worker}``).

Two record kinds:

- **Step ring** — a fixed-size ring of per-step records: step serial, step
  kind (prefill/decode/mixed/idle), batch occupancy, prefill-budget tokens
  spent, overlap outcome (lookahead kept/discarded/sync) with the
  host-busy vs device-wait split, admissions/finishes, and fault flags.
  One dict append per step; the ring bound makes host memory constant.
- **Request timelines** — per-request event sequences from queued →
  admitted → each prefill chunk → first token → ITL samples → terminal
  finish, with preempt/quarantine/deadline events, the request's sampling
  metadata, and the gateway trace id when one was propagated.  Live
  timelines move to a bounded finished-ring at terminal finish.

Hard constraints:

- **No device interaction.**  Every recorded value is host-side step
  metadata the scheduler already has in hand — the recorder never touches a
  tensor on the card, so it adds no synchronisation to the step loop.
- **Bounded overhead.**  Appends into ``deque(maxlen=...)`` under a small
  dedicated lock (NOT the engine lock — the watchdog must be able to dump
  while the step thread is wedged holding the engine lock).
- **Dumps never raise.**  ``auto_dump`` is called from failure paths; a
  broken dump directory (or the ``flight.dump`` fault point) degrades to a
  log line, never to a second failure.

The dump is schema-versioned JSON (``SCHEMA_VERSION``); the key set of step
records and timeline dicts is a stable contract covered by
``tests/test_flight_recorder.py::test_dump_schema_stable`` (and, for this
copy, ``tests/test_torch_reliability.py``).
"""

from __future__ import annotations

import json
import os
import time
from collections import deque

from smg_tpu_torch.analysis.runtime_guards import make_lock
from smg_tpu_torch.faults import FAULTS
from smg_tpu_torch.utils import get_logger, percentile

logger = get_logger("engine.flight_recorder")

#: bump when the dump layout changes; consumers key parsing off this
#: (v2: megastep decode telemetry — per-step horizon K, device early
#: exits, and wasted-token count joined the step record; v3: speculative
#: decoding — per-step drafted/accepted token counts from the fused
#: verify blocks consumed that step; v4: tensor-parallel sharded decode —
#: the engine's mesh device count rides every step record, so rings pulled
#: from a mixed single-device/TP fleet self-describe their topology)
SCHEMA_VERSION = 4

#: stable key set of one step record (schema contract, tested)
STEP_RECORD_KEYS = frozenset({
    "serial", "t", "kind", "step_s", "running", "waiting", "occupancy",
    "prefill_tokens", "decode_tokens", "prefill_inflight_tokens",
    "free_pages", "admissions", "finishes", "overlap", "fetch_wait_s",
    "faults", "horizon", "early_exits", "wasted_decode_tokens",
    "spec_drafted", "spec_accepted", "mesh",
})


class RequestTimeline:
    """One request's recorded lifetime.  All mutation happens through
    FlightRecorder (which holds its lock); this object is plain state."""

    __slots__ = (
        "rid", "trace_id", "meta", "queued_t", "admitted_t", "first_token_t",
        "last_token_t", "finish_t", "finish_reason", "finish_message",
        "prompt_tokens", "cached_tokens", "output_tokens", "deadline_t",
        "events", "itl_samples", "itl_count", "itl_total", "itl_max",
    )

    def __init__(self, rid: str, t: float, *, prompt_tokens: int = 0,
                 trace_id: str | None = None, meta: dict | None = None,
                 deadline_t: float | None = None, events_cap: int = 96,
                 itl_cap: int = 64):
        self.rid = rid
        self.trace_id = trace_id
        self.meta = meta or {}
        self.queued_t = t
        self.admitted_t: float | None = None
        self.first_token_t: float | None = None
        self.last_token_t: float | None = None
        self.finish_t: float | None = None
        self.finish_reason: str | None = None
        self.finish_message: str | None = None
        self.prompt_tokens = prompt_tokens
        self.cached_tokens = 0
        self.output_tokens = 0
        self.deadline_t = deadline_t
        # (t, kind, detail-dict) tuples; bounded so a long generation cannot
        # grow the timeline without limit (summary fields keep the totals)
        self.events: deque = deque(maxlen=events_cap)
        # bounded inter-token-gap samples for p50/p95; count/total/max keep
        # the full-population summary even after the sample window saturates
        self.itl_samples: deque = deque(maxlen=itl_cap)
        self.itl_count = 0
        self.itl_total = 0.0
        self.itl_max = 0.0

    def to_dict(self) -> dict:
        ttft = (
            self.first_token_t - self.queued_t
            if self.first_token_t is not None else None
        )
        e2e = (
            self.finish_t - self.queued_t if self.finish_t is not None else None
        )
        samples = list(self.itl_samples)
        return {
            "rid": self.rid,
            "trace_id": self.trace_id,
            "meta": dict(self.meta),
            "queued_t": self.queued_t,
            "admitted_t": self.admitted_t,
            "first_token_t": self.first_token_t,
            "finish_t": self.finish_t,
            "finish_reason": self.finish_reason,
            "finish_message": self.finish_message,
            "deadline_t": self.deadline_t,
            "ttft_s": ttft,
            "e2e_s": e2e,
            "prompt_tokens": self.prompt_tokens,
            "cached_tokens": self.cached_tokens,
            "output_tokens": self.output_tokens,
            "itl": {
                "count": self.itl_count,
                "mean_s": (self.itl_total / self.itl_count) if self.itl_count else 0.0,
                "p50_s": percentile(samples, 50),
                "p95_s": percentile(samples, 95),
                "max_s": self.itl_max,
            },
            "events": [
                {"t": t, "kind": kind, **detail} for t, kind, detail in self.events
            ],
        }


class FlightRecorder:
    """Bounded black box: step ring + request timelines + reason-tagged
    dumps.  Thread-safe via an internal lock; see the module docstring for
    why that lock is NOT the engine lock."""

    def __init__(
        self,
        ring_size: int = 256,
        timeline_keep: int = 64,
        events_per_timeline: int = 96,
        dump_dir: str | None = None,
        dump_min_interval_secs: float = 5.0,
        dump_keep: int = 4,
    ):
        self.ring_size = ring_size
        self.events_per_timeline = events_per_timeline
        self.dump_dir = dump_dir
        self.dump_min_interval_secs = dump_min_interval_secs
        self._lock = make_lock("flight_recorder")
        self._ring: deque = deque(maxlen=ring_size)
        self._live: dict[str, RequestTimeline] = {}
        self._finished: deque = deque(maxlen=timeline_keep)
        #: completed auto-dump snapshots, newest last (bounded)
        self.dumps: deque = deque(maxlen=dump_keep)
        self.num_dumps = 0
        self.num_dump_suppressed = 0
        self.step_serial = 0
        # per-REASON rate limiting: a quarantine storm is throttled without
        # suppressing the one drain/watchdog dump that follows it
        self._last_dump_t: dict[str, float] = {}
        # EngineMetrics hook (smg_engine_flight_dumps_total); duck-typed so
        # bare recorders in tests stay dependency-free
        self.metrics = None

    # ---- step ring ----

    def record_step(
        self, *, step_s: float, prefill_tokens: int, decode_tokens: int,
        running: int, waiting: int, max_batch: int,
        prefill_inflight_tokens: int, free_pages: int,
        admissions: int, finishes: int, overlap: str | None,
        fetch_wait_s: float, faults: list | None = None,
        horizon: int = 0, early_exits: int = 0,
        wasted_decode_tokens: int = 0,
        spec_drafted: int = 0, spec_accepted: int = 0,
        mesh: int = 1,
    ) -> int:
        """Append one step record; returns the step serial.  Called once per
        scheduler step with values already in hand — no derivation here."""
        if prefill_tokens and decode_tokens:
            kind = "mixed"
        elif prefill_tokens:
            kind = "prefill"
        elif decode_tokens:
            kind = "decode"
        else:
            kind = "idle"
        with self._lock:
            self.step_serial += 1
            self._ring.append({
                "serial": self.step_serial,
                "t": time.monotonic(),
                "kind": kind,
                "step_s": step_s,
                "running": running,
                "waiting": waiting,
                "occupancy": (running / max_batch) if max_batch else 0.0,
                "prefill_tokens": prefill_tokens,
                "decode_tokens": decode_tokens,
                "prefill_inflight_tokens": prefill_inflight_tokens,
                "free_pages": free_pages,
                "admissions": admissions,
                "finishes": finishes,
                "overlap": overlap,
                "fetch_wait_s": fetch_wait_s,
                "faults": list(faults) if faults else [],
                # megastep decode: K of the consumed frame (0 = no decode
                # consumed), device done-mask early exits, and columns
                # computed but never emitted this step
                "horizon": horizon,
                "early_exits": early_exits,
                "wasted_decode_tokens": wasted_decode_tokens,
                # speculative decoding: draft tokens verified / accepted by
                # the fused verify blocks consumed this step
                "spec_drafted": spec_drafted,
                "spec_accepted": spec_accepted,
                # sharded decode: devices in this engine's mesh (1 =
                # single-device; static per engine, but the ring is often
                # read detached from the engine that produced it)
                "mesh": mesh,
            })
            return self.step_serial

    # ---- request timelines ----

    def on_queued(
        self, rid: str, *, prompt_tokens: int, trace_id: str | None = None,
        meta: dict | None = None, deadline_t: float | None = None,
    ) -> None:
        t = time.monotonic()
        tl = RequestTimeline(
            rid, t, prompt_tokens=prompt_tokens, trace_id=trace_id, meta=meta,
            deadline_t=deadline_t, events_cap=self.events_per_timeline,
        )
        tl.events.append((t, "queued", {"prompt_tokens": prompt_tokens}))
        with self._lock:
            self._live[rid] = tl

    def event(self, rid: str, kind: str, **detail) -> None:
        """Append a timeline event; unknown rids are ignored (a recorder
        attached mid-flight, or a rid evicted by the finished ring)."""
        t = time.monotonic()
        with self._lock:
            tl = self._live.get(rid)
            if tl is None:
                return
            tl.events.append((t, kind, detail))
            if kind == "admitted":
                tl.admitted_t = t
                tl.cached_tokens = detail.get("cached_tokens", 0)

    def on_tokens(self, rid: str, n: int, first: bool) -> None:
        """Record ``n`` accepted tokens.  ``first`` marks the request's first
        output (TTFT); later calls contribute inter-token samples (the chunk
        gap split evenly over its tokens — decode horizons emit in chunks)."""
        if n <= 0:
            return
        t = time.monotonic()
        with self._lock:
            tl = self._live.get(rid)
            if tl is None:
                return
            tl.output_tokens += n
            if first or tl.first_token_t is None:
                tl.first_token_t = t
                tl.events.append((t, "first_token", {"n": n}))
            elif tl.last_token_t is not None:
                gap = (t - tl.last_token_t) / n
                tl.itl_count += n
                tl.itl_total += t - tl.last_token_t
                tl.itl_samples.append(gap)
                if gap > tl.itl_max:
                    tl.itl_max = gap
            tl.last_token_t = t

    def on_finish(self, rid: str, reason: str, message: str | None = None) -> None:
        t = time.monotonic()
        with self._lock:
            tl = self._live.pop(rid, None)
            if tl is None:
                return
            tl.finish_t = t
            tl.finish_reason = reason
            tl.finish_message = message
            tl.events.append((t, "finish", {"reason": reason}))
            self._finished.append(tl)

    # ---- dumps ----

    def snapshot(self, reason: str = "manual") -> dict:
        """JSON-able view of the ring + timelines (schema-versioned)."""
        with self._lock:
            return {
                "schema_version": SCHEMA_VERSION,
                "reason": reason,
                "ts_unix": time.time(),
                "t_mono": time.monotonic(),
                "last_step_serial": self.step_serial,
                "ring": [dict(r) for r in self._ring],
                "timelines": {
                    "live": [tl.to_dict() for tl in self._live.values()],
                    "finished": [tl.to_dict() for tl in self._finished],
                },
                "auto_dumps": [
                    {
                        "reason": d["reason"],
                        "ts_unix": d["ts_unix"],
                        "last_step_serial": d["last_step_serial"],
                    }
                    for d in self.dumps
                ],
            }

    def auto_dump(self, reason: str) -> bool:
        """Reason-tagged rate-limited dump from a failure path.  Keeps the
        snapshot in ``self.dumps`` and writes a JSON file when ``dump_dir``
        is set.  Never raises — a dump failure must not compound the failure
        that triggered it."""
        now = time.monotonic()
        with self._lock:
            last = self._last_dump_t.get(reason, -float("inf"))
            if now - last < self.dump_min_interval_secs:
                self.num_dump_suppressed += 1
                return False
            # stamp inside the check (atomic vs a concurrent caller); rolled
            # back on failure so a transient write error cannot consume the
            # window and suppress the one genuine postmortem of an incident
            self._last_dump_t[reason] = now
        try:
            # fault point: a failing dump (unwritable dir, serialization bug)
            # must degrade to a log line, never break the step loop
            FAULTS.fire("flight.dump", reason=reason)
            snap = self.snapshot(reason)
            if self.dump_dir:
                os.makedirs(self.dump_dir, exist_ok=True)
                path = os.path.join(
                    self.dump_dir,
                    f"flight-{int(snap['ts_unix'])}-{snap['last_step_serial']}"
                    f"-{reason}.json",
                )
                with open(path, "w") as f:
                    json.dump(snap, f)
                logger.warning("flight dump (%s) written to %s", reason, path)
            else:
                logger.warning(
                    "flight dump (%s) recorded in memory (%d ring records, "
                    "%d timelines)", reason, len(snap["ring"]),
                    len(snap["timelines"]["live"]) + len(snap["timelines"]["finished"]),
                )
            # success bookkeeping LAST: a failed file write must not count
            # as a taken dump (dumps/num_dumps/metric all report success)
            with self._lock:
                self.dumps.append(snap)
                self.num_dumps += 1
            if self.metrics is not None:
                self.metrics.flight_dumps.labels(reason=reason).inc()
            return True
        except Exception:
            logger.exception("flight auto-dump (%s) failed", reason)
            with self._lock:
                if self._last_dump_t.get(reason) == now:
                    # transient failure: allow a retry after HALF the window
                    # (a full rollback would unthrottle a quarantine storm on
                    # a persistently full disk — snapshot-per-step inside the
                    # engine lock; a full window could eat the incident's
                    # only dump).  Bounded at 2x the normal dump rate.
                    self._last_dump_t[reason] = (
                        now - self.dump_min_interval_secs / 2.0
                    )
            return False
