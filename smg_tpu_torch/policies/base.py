"""Policy trait + registry — the port's copy of ``smg_tpu/policies/base.py``
(without the registry's per-model overrides).

Reference: ``trait LoadBalancingPolicy::select_worker``
(``model_gateway/src/policies/mod.rs:47-56``) and ``PolicyRegistry``
(``policies/registry.rs:29``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from types import MappingProxyType
from typing import Mapping, Protocol, Sequence

_EMPTY_MATCHES: Mapping = MappingProxyType({})


class WorkerLike(Protocol):
    worker_id: str
    model_id: str

    @property
    def load(self) -> int: ...

    def is_available(self) -> bool: ...


@dataclass
class RequestContext:
    """What a policy may look at when selecting a worker
    (reference: ``SelectWorkerInfo``, ``policies/mod.rs:214``)."""

    text: str | None = None
    token_ids: list[int] | None = None
    model_id: str | None = None
    routing_key: str | None = None  # sticky routing (manual policy)
    request_id: str | None = None
    headers: dict = field(default_factory=dict)


#: schema-stable key set of ``RouteDecision.to_dict()`` — /debug/router
#: consumers and dashboards pin against this; extend, never rename
DECISION_SCHEMA_VERSION = 1
DECISION_KEYS = (
    "serial", "ts", "policy", "model_id", "request_id", "trace_id",
    "seq_len", "candidates", "prefix_matches", "chosen", "outcome",
    "tie_break", "predicted_match_tokens", "predicted_match_fraction",
    "match_threshold", "imbalanced", "mode", "decision_us",
    "worker_cached_tokens", "prediction_error_tokens", "reconciled",
)


class RouteDecision:
    """One ``select_worker`` call, structured: who was considered, who won,
    and why (the routing-plane twin of the engine flight recorder's step
    record).  The router later reconciles ``predicted_match_tokens`` against
    the engine-reported ``cached_tokens`` riding the first stream chunk.

    Deliberately NOT a dataclass: one of these is built per routing
    decision, and class-level defaults mean the hot-path constructor writes
    three fields instead of twenty-one (a generated ``__init__`` alone costs
    more than the whole ring append)."""

    policy: str = ""
    model_id: str | None = None
    request_id: str | None = None
    trace_id: str | None = None
    seq_len: int = 0  # request length in the policy's element space
    #: per-candidate snapshot: (worker_id, load, available, circuit_state)
    #: — tuples, not dicts, because this rides the routing hot path;
    #: ``to_dict`` expands them for /debug/router.  Empty-immutable
    #: defaults: no per-decision container allocations
    candidates: Sequence = ()
    #: cache_aware: per-worker predicted prefix overlap (elements)
    prefix_matches: Mapping = _EMPTY_MATCHES
    chosen: str | None = None
    outcome: str = "none"
    tie_break: str | None = None
    #: predicted prefix-cache overlap AT THE CHOSEN WORKER, in tokens
    #: (None when the policy has no token-space prediction to reconcile)
    predicted_match_tokens: int | None = None
    predicted_match_fraction: float = 0.0
    match_threshold: float | None = None
    imbalanced: bool = False
    mode: str | None = None
    decision_us: float = 0.0
    ts: float = 0.0
    serial: int = 0
    # ---- reconciliation (filled at first stream chunk) ----
    worker_cached_tokens: int | None = None
    prediction_error_tokens: int | None = None
    reconciled: bool = False

    def __init__(self, policy="", model_id=None, request_id=None, **fields):
        self.policy = policy
        self.model_id = model_id
        self.request_id = request_id
        if fields:  # off the hot path: tests / hand-built records
            cls = type(self)
            for k, v in fields.items():
                if not hasattr(cls, k):
                    raise TypeError(f"unknown RouteDecision field {k!r}")
                setattr(self, k, v)

    def to_dict(self) -> dict:
        return {
            "serial": self.serial,
            "ts": self.ts,
            "policy": self.policy,
            "model_id": self.model_id,
            "request_id": self.request_id,
            "trace_id": self.trace_id,
            "seq_len": self.seq_len,
            "candidates": [
                {
                    "worker_id": wid,
                    "load": load,
                    "available": avail,
                    "circuit": getattr(circuit, "value", circuit),
                }
                for wid, load, avail, circuit in self.candidates
            ],
            "prefix_matches": dict(self.prefix_matches),
            "chosen": self.chosen,
            "outcome": self.outcome,
            "tie_break": self.tie_break,
            "predicted_match_tokens": self.predicted_match_tokens,
            "predicted_match_fraction": self.predicted_match_fraction,
            "match_threshold": self.match_threshold,
            "imbalanced": self.imbalanced,
            "mode": self.mode,
            "decision_us": self.decision_us,
            "worker_cached_tokens": self.worker_cached_tokens,
            "prediction_error_tokens": self.prediction_error_tokens,
            "reconciled": self.reconciled,
        }


def _snapshot_candidates(decision: RouteDecision, workers) -> None:
    """Per-worker state at decision time.  Racy reads on purpose: breaker
    state is read without its lock (observability must not add a lock
    acquisition per worker to the routing hot path).  The fast path assumes
    a homogeneous pool of gateway ``Worker``s (direct attribute reads); any
    missing attribute drops the WHOLE list to the getattr-degraded path, so
    FakeWorker-style test doubles still snapshot."""
    try:
        decision.candidates = [
            (
                w.worker_id,
                w.load,
                w.healthy and not w.draining,
                # raw CircuitState enum; ``to_dict`` unwraps .value (the
                # DynamicClassAttribute read is too slow for this loop)
                c._state if (c := w.circuit) is not None else None,
            )
            for w in workers
        ]
    except AttributeError:
        g = getattr
        decision.candidates = [
            (
                w.worker_id,
                g(w, "load", 0),
                g(w, "healthy", True) and not g(w, "draining", False),
                g(g(g(w, "circuit", None), "_state", None), "value", None),
            )
            for w in workers
        ]


class Policy:
    name: str = "base"
    #: decision sink attached by the gateway (RouteObservability) — policies
    #: never import gateway code; None = decisions are built but not retained
    _decision_sink = None

    def select_worker(
        self,
        workers: Sequence[WorkerLike],
        ctx: RequestContext,
        decision: RouteDecision | None = None,
    ) -> WorkerLike | None:
        raise NotImplementedError

    def select(
        self, workers: Sequence[WorkerLike], ctx: RequestContext
    ) -> tuple[WorkerLike | None, RouteDecision]:
        """``select_worker`` + a structured ``RouteDecision``: candidate
        snapshot, outcome, tie-break, decision latency.  The router's entry
        point; emits to the attached sink (gateway decision ring + metrics +
        routing-span attributes) when one is wired."""
        decision = RouteDecision(
            policy=self.name, model_id=ctx.model_id, request_id=ctx.request_id,
        )
        seq = ctx.token_ids if ctx.token_ids is not None else ctx.text
        decision.seq_len = len(seq) if seq else 0
        pc = time.perf_counter
        t0 = pc()
        worker = self.select_worker(workers, ctx, decision=decision)
        decision.chosen = worker.worker_id if worker is not None else None
        if not decision.candidates:
            _snapshot_candidates(decision, workers)
        # the snapshot is part of the decision's hot-path cost, so it sits
        # inside the timed region (smg_route_decision_seconds help says so)
        decision.decision_us = (pc() - t0) * 1e6
        if decision.outcome == "none":
            decision.outcome = self.name if worker is not None else "no_worker"
        if (
            decision.predicted_match_tokens is None
            and decision.mode is None  # cache_aware owns its own prediction
            and ctx.token_ids
            and worker is not None
        ):
            # cache-oblivious policies implicitly predict ZERO reuse; the
            # reconciliation then measures what such routing leaves on the
            # table (engine-reported cached_tokens with no prediction)
            decision.predicted_match_tokens = 0
        sink = self._decision_sink
        if sink is not None:
            try:
                sink.record(decision)
            except Exception:  # observability must never fail routing
                pass
        return worker, decision

    # feedback hooks
    def on_request_complete(self, worker_id: str, success: bool) -> None:
        pass

    def on_worker_removed(self, worker_id: str) -> None:
        """Base behavior: purge the decision sink's per-worker state
        (reconciliation EMAs, metric label series).  Overrides must call
        ``super().on_worker_removed(worker_id)``."""
        sink = self._decision_sink
        if sink is not None:
            try:
                sink.on_worker_removed(worker_id)
            except Exception:
                pass

    @staticmethod
    def available(workers: Sequence[WorkerLike]) -> list[WorkerLike]:
        return [w for w in workers if w.is_available()]


_POLICIES: dict[str, type[Policy]] = {}


def register_policy(cls: type[Policy]) -> type[Policy]:
    _POLICIES[cls.name] = cls
    return cls


def get_policy(name: str, **kwargs) -> Policy:
    if name not in _POLICIES:
        raise KeyError(f"unknown policy {name!r}; known: {sorted(_POLICIES)}")
    return _POLICIES[name](**kwargs)


class PolicyRegistry:
    """Per-model policy instances with a default fallback
    (multi-model 'IGW' mode routes each model by its own policy)."""

    def __init__(self, default: str = "cache_aware", **default_kwargs):
        self._default_name = default
        self._default_kwargs = default_kwargs
        self._per_model: dict[str, Policy] = {}
        # fired with (model_id, policy) whenever a policy instance is
        # created: policies are created lazily per model, so the routing
        # observability attaches its decision sink here
        self._create_hooks: list = []

    def add_create_hook(self, cb) -> None:
        self._create_hooks.append(cb)
        for key, policy in self._per_model.items():
            cb(None if key == "__default__" else key, policy)

    def _created(self, model_id: str | None, policy: Policy) -> None:
        for cb in self._create_hooks:
            try:
                cb(model_id, policy)
            except Exception:
                pass

    def has_policy(self, model_id: str | None) -> bool:
        return (model_id or "__default__") in self._per_model

    def policy_for(self, model_id: str | None) -> Policy:
        key = model_id or "__default__"
        if key not in self._per_model:
            self._per_model[key] = get_policy(self._default_name, **self._default_kwargs)
            self._created(model_id, self._per_model[key])
        return self._per_model[key]

    def set_policy(self, model_id: str, name: str, **kwargs) -> None:
        """Give ``model_id`` its own policy (``POST /models/{id}/router``)."""
        self._per_model[model_id] = get_policy(name, **kwargs)
        self._created(model_id, self._per_model[model_id])

    def on_worker_removed(self, worker_id: str) -> None:
        for p in self._per_model.values():
            p.on_worker_removed(worker_id)
