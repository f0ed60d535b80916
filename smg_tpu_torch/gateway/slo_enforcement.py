"""Declarative SLO enforcement over the gateway's SLO accounting.

The SLO tracker is the *measurement* half of the SLO story: ``SloTracker``
(``gateway/observability.py``) keeps a bounded ring of completed-request
records — TTFT/ITL/e2e against each request's deadline, goodput, trace-id
exemplars — behind ``GET /debug/slo``.  This module is the *judgement*
half: operator-declared ``SloSpec``s are evaluated against that ring and
turned into hard pass/fail **verdicts**, so the observability surface can
gate a CI run or page an operator instead of merely describing the outage.

Model (SRE burn-rate alerting, scaled down to one process):

- every spec evaluates over TWO windows of the completed-request ring —
  a ``fast`` window (is it happening *now*?) and a ``slow`` window (is it
  *sustained*?).  A spec's failing **candidate** requires BOTH windows in
  violation, which is what keeps a single slow request from paging anyone.
- percentile targets (``ttft_p95_s`` / ``itl_p95_s`` / ``e2e_p95_s``) and
  the ``goodput_ratio_floor`` breach when the window's observed value
  crosses the target (gated on ``min_requests`` so an empty or thin window
  never breaches);
- ``deadline_miss_budget`` is an error budget: the window's deadline-miss
  fraction divided by the budget is its **burn rate**, and the window
  violates when burn >= its threshold (``fast_burn`` / ``slow_burn``,
  default 1.0 = missing faster than the budget allows).  Voluntary endings
  (client disconnects) are excluded, exactly as in ``/debug/slo``;
- verdict flips are **hysteresis**-damped: the verdict changes only after
  ``hysteresis`` consecutive evaluations whose candidate disagrees with it,
  so a flapping boundary condition cannot strobe pass/fail.

Metric families (registered by ``Metrics``, set/incremented here):

- ``smg_slo_violations_total{slo,window}`` — edge-triggered per window:
  counts not-violating -> violating transitions, not evaluations;
- ``smg_slo_burn_rate{slo}`` — the spec's worst current window burn rate.

Surfaces: ``GET /debug/slo/verdicts`` (gateway/server.py) evaluates on
demand; ``benches/loadgen.py`` drives the same object as its epilogue's
asserted contract; specs load from ``--slo-spec FILE.json``.

The port's copy of ``smg_tpu/gateway/slo_enforcement.py``, unchanged but for its imports.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, fields as dataclass_fields

from smg_tpu_torch.utils import get_logger

logger = get_logger("gateway.slo_enforcement")

SCHEMA_VERSION = 1


@dataclass
class SloSpec:
    """One declarative SLO.  ``None`` targets are not evaluated; a spec with
    no targets at all is rejected (it could never fail, which is exactly the
    kind of dead config this layer exists to prevent)."""

    name: str
    # percentile / ratio targets over each evaluation window
    ttft_p95_s: float | None = None
    itl_p95_s: float | None = None
    e2e_p95_s: float | None = None
    goodput_ratio_floor: float | None = None
    # error budget: allowed deadline-miss fraction; burn = observed/budget
    deadline_miss_budget: float | None = None
    # multiwindow burn-rate evaluation (fast = happening now, slow = sustained)
    fast_window_s: float = 60.0
    slow_window_s: float = 300.0
    fast_burn: float = 1.0
    slow_burn: float = 1.0
    #: windows thinner than this never breach (empty-window safety)
    min_requests: int = 8
    #: consecutive disagreeing evaluations required to flip the verdict
    hysteresis: int = 2

    def __post_init__(self) -> None:
        if not self.name:
            raise ValueError("SloSpec needs a non-empty name")
        if self.fast_window_s <= 0 or self.slow_window_s <= 0:
            raise ValueError(f"slo {self.name!r}: windows must be positive")
        if self.fast_window_s > self.slow_window_s:
            raise ValueError(
                f"slo {self.name!r}: fast_window_s must be <= slow_window_s"
            )
        if self.deadline_miss_budget is not None and not (
            0.0 < self.deadline_miss_budget <= 1.0
        ):
            raise ValueError(
                f"slo {self.name!r}: deadline_miss_budget must be in (0, 1]"
            )
        if self.goodput_ratio_floor is not None and not (
            0.0 <= self.goodput_ratio_floor <= 1.0
        ):
            raise ValueError(
                f"slo {self.name!r}: goodput_ratio_floor must be in [0, 1]"
            )
        if self.hysteresis < 1:
            raise ValueError(f"slo {self.name!r}: hysteresis must be >= 1")
        if self.min_requests < 1:
            raise ValueError(f"slo {self.name!r}: min_requests must be >= 1")
        if all(
            getattr(self, f) is None
            for f in ("ttft_p95_s", "itl_p95_s", "e2e_p95_s",
                      "goodput_ratio_floor", "deadline_miss_budget")
        ):
            raise ValueError(
                f"slo {self.name!r} declares no targets; it could never fail"
            )

    @classmethod
    def from_dict(cls, d: dict) -> "SloSpec":
        known = {f.name for f in dataclass_fields(cls)}
        unknown = set(d) - known
        if unknown:
            # a typo'd target key would silently never be enforced — reject
            raise ValueError(
                f"unknown SloSpec key(s) {sorted(unknown)} "
                f"(known: {sorted(known)})"
            )
        return cls(**d)


def load_slo_specs(source) -> list[SloSpec]:
    """Parse specs from a JSON file path, JSON string, or already-parsed
    list/dict.  Accepts either a bare list of spec objects or
    ``{"slos": [...]}``."""
    if isinstance(source, str):
        if source.lstrip().startswith(("[", "{")):
            data = json.loads(source)
        else:
            with open(source) as f:
                data = json.load(f)
    else:
        data = source
    if isinstance(data, dict):
        data = data.get("slos", [])
    if not isinstance(data, list):
        raise ValueError("SLO spec must be a list of objects or {'slos': [...]}")
    specs = [s if isinstance(s, SloSpec) else SloSpec.from_dict(s) for s in data]
    names = [s.name for s in specs]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate SLO names in spec: {names}")
    return specs


def _window_stats(records: list[dict]) -> dict:
    """One window of SloTracker completed-request records, aggregated by
    the SAME code as ``/debug/slo`` (``observability.aggregate_slo_records``
    — voluntary-exclusion / goodput / percentile semantics are defined
    exactly once, so the two surfaces cannot diverge).  The p50 keys ride
    along in the verdict payload; the enforcer's targets read the p95s."""
    # local import: observability lazily imports THIS module in
    # Metrics.__init__; a module-level import here would be circular
    from smg_tpu_torch.gateway.observability import aggregate_slo_records

    return aggregate_slo_records(records)


#: (spec target attr, window stat key) pairs breaching when stat > target
_UPPER_BOUND_TARGETS = (
    ("ttft_p95_s", "ttft_p95_s"),
    ("itl_p95_s", "itl_p95_s"),
    ("e2e_p95_s", "e2e_p95_s"),
)


class SloEnforcer:
    """Evaluates installed ``SloSpec``s against the SloTracker ring.

    Single-threaded by design: evaluations run on the gateway event loop
    (``/debug/slo/verdicts`` handlers, the loadgen epilogue); the tracker
    read underneath takes the tracker's own lock.  State per spec: the
    current verdict, the hysteresis streak, and each window's last
    violating flag (for edge-triggered violation counting)."""

    def __init__(self, metrics=None, tracker=None):
        self.metrics = metrics
        self.tracker = tracker if tracker is not None else (
            metrics.slo if metrics is not None else None
        )
        self.specs: list[SloSpec] = []
        self._state: dict[str, dict] = {}

    def install(self, specs, replace: bool = False) -> None:
        """Install specs (SloSpec objects, dicts, a JSON string/path, or a
        pre-parsed list).  ``replace=False`` appends; same-name reinstall
        replaces that spec but keeps its verdict state."""
        specs = load_slo_specs(specs)
        if replace:
            keep = {s.name for s in specs}
            self.specs = []
            self._state = {k: v for k, v in self._state.items() if k in keep}
        by_name = {s.name: i for i, s in enumerate(self.specs)}
        for spec in specs:
            if spec.name in by_name:
                self.specs[by_name[spec.name]] = spec
            else:
                by_name[spec.name] = len(self.specs)
                self.specs.append(spec)
            self._state.setdefault(spec.name, {
                "verdict": "pass", "streak": 0, "evaluations": 0,
                "win_violating": {"fast": False, "slow": False},
            })
        logger.info("slo specs installed: %s", [s.name for s in self.specs])

    def remove(self, name: str) -> bool:
        before = len(self.specs)
        self.specs = [s for s in self.specs if s.name != name]
        self._state.pop(name, None)
        return len(self.specs) != before

    def _evaluate_window(self, spec: SloSpec, window: str, window_s: float,
                         burn_threshold: float, now: float) -> dict:
        records = self.tracker.window_records(window_s, now=now)
        stats = _window_stats(records)
        sufficient = stats["requests"] >= spec.min_requests
        breaches: list[str] = []
        if sufficient:
            for target_attr, stat_key in _UPPER_BOUND_TARGETS:
                target = getattr(spec, target_attr)
                observed = stats[stat_key]
                if target is not None and observed is not None and observed > target:
                    breaches.append(target_attr)
            if (spec.goodput_ratio_floor is not None
                    and stats["goodput_ratio"] < spec.goodput_ratio_floor):
                breaches.append("goodput_ratio_floor")
        burn = 0.0
        if spec.deadline_miss_budget is not None and stats["with_deadline"]:
            burn = stats["miss_fraction"] / spec.deadline_miss_budget
            # the burn breach gates on DEADLINE-CARRYING requests, not total
            # window traffic: one missed deadline among deadline-less
            # requests would otherwise read as miss_fraction 1.0 and page on
            # a single request — exactly what min_requests exists to prevent
            if stats["with_deadline"] >= spec.min_requests and burn >= burn_threshold:
                breaches.append("deadline_miss_budget")
        return {
            **stats,
            "window": window,
            "window_s": window_s,
            "sufficient": sufficient,
            "burn_rate": round(burn, 4),
            "burn_threshold": burn_threshold,
            "breaches": breaches,
            "violating": bool(breaches),
        }

    def evaluate(self, now: float | None = None) -> dict:
        """One evaluation pass over every installed spec; returns the
        ``/debug/slo/verdicts`` payload.  Updates burn-rate gauges every
        pass and the violation counters on each window's not-violating ->
        violating edge."""
        if now is None:
            now = time.perf_counter()
        m = self.metrics
        verdicts = []
        for spec in self.specs:
            st = self._state[spec.name]
            windows = {}
            for wname, wsecs, wburn in (
                ("fast", spec.fast_window_s, spec.fast_burn),
                ("slow", spec.slow_window_s, spec.slow_burn),
            ):
                w = self._evaluate_window(spec, wname, wsecs, wburn, now)
                if w["violating"] and not st["win_violating"][wname] and m is not None:
                    m.slo_violations.labels(slo=spec.name, window=wname).inc()
                st["win_violating"][wname] = w["violating"]
                windows[wname] = w
            if m is not None:
                m.slo_burn_rate.labels(slo=spec.name).set(
                    max(windows["fast"]["burn_rate"], windows["slow"]["burn_rate"])
                )
            # multiwindow rule: failing needs BOTH the fast window (still
            # happening) and the slow window (sustained) in violation
            candidate = (
                "fail"
                if windows["fast"]["violating"] and windows["slow"]["violating"]
                else "pass"
            )
            if candidate == st["verdict"]:
                st["streak"] = 0
            else:
                st["streak"] += 1
                if st["streak"] >= spec.hysteresis:
                    logger.warning(
                        "slo %r verdict %s -> %s (after %d consecutive)",
                        spec.name, st["verdict"], candidate, st["streak"],
                    )
                    st["verdict"] = candidate
                    st["streak"] = 0
            st["evaluations"] += 1
            verdicts.append({
                "slo": spec.name,
                "verdict": st["verdict"],
                "candidate": candidate,
                "flip_streak": st["streak"],
                "evaluations": st["evaluations"],
                "windows": windows,
            })
        return {
            "schema_version": SCHEMA_VERSION,
            "specs": len(self.specs),
            "all_pass": all(v["verdict"] == "pass" for v in verdicts),
            "verdicts": verdicts,
        }
