"""Deterministic fault injection — the port's copy of ``smg_tpu/faults.py``,
with the same fault-point names and the same ``SMG_FAULTS`` grammar, so a
reliability scenario arms the two engines identically.

A registry of NAMED FAULT POINTS compiled into production seams, disarmed by
default (one attribute read on the hot path), armed explicitly by tests or
via the ``SMG_FAULTS`` environment variable.

Fault points wired in this package:

=====================  =====================================================
``engine.prefill``      per-request, before any prefill dispatch
                        (``scheduler._prefill_final/_prefill_chunk`` and each
                        member of a grouped prefill)
``engine.decode_step``  before a decode-batch launch (``_launch_frame``,
                        ``_launch_lookahead``)
``engine.device_fetch`` before the deferred device fetch
                        (``scheduler._consume_frame``) — supports ``hang``
                        to simulate a wedged device for the step watchdog
``worker.stream``       per streamed chunk in ``InProcWorkerClient.generate``
``flight.dump``         inside the flight recorder's auto-dump path
``gateway.kv_event``    per kv-event batch in the gateway's KvEventMonitor
=====================  =====================================================

``rpc.generate`` is a known name (the gRPC worker is not ported yet), so an
``SMG_FAULTS`` string written for the JAX package parses here unchanged.

Trigger grammar (``arm()`` kwargs, or ``SMG_FAULTS`` entries):

- ``mode="always"``   fire on every matched call (default)
- ``mode="once"``     fire on the first matched call only
- ``mode="after"``    skip the first ``n`` matched calls, fire on the rest
- ``mode="every"``    fire on every ``n``-th matched call
- ``match="req-3"``   only calls whose context values contain the substring
- ``action="raise"``  raise ``InjectedFault`` (default)
- ``action="hang"``   ``time.sleep(delay)`` then return (wedge simulation)

Env syntax (comma-separated)::

    SMG_FAULTS="engine.prefill=once,engine.decode_step=after:3,\
worker.stream=every:2@req-abc,engine.device_fetch=hang:0.5"
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field

from smg_tpu_torch.utils import get_logger

logger = get_logger("faults")

#: the fault points compiled into seams; ``arm`` rejects unknown names so a
#: typo in a test or SMG_FAULTS fails loudly instead of silently never firing
FAULT_POINTS = (
    "engine.prefill",
    "engine.decode_step",
    "engine.device_fetch",
    "worker.stream",
    "rpc.generate",
    "flight.dump",
    "gateway.kv_event",
)

_MODES = ("always", "once", "after", "every")
_ACTIONS = ("raise", "hang")


class InjectedFault(RuntimeError):
    """Raised at an armed fault point (deterministic, test-identifiable)."""


@dataclass
class FaultSpec:
    point: str
    mode: str = "always"
    n: int = 1
    match: str | None = None
    action: str = "raise"
    delay: float = 0.0  # hang duration (action="hang")
    message: str = ""
    # state
    calls: int = 0  # matched-call counter
    fired: int = 0

    def should_fire(self) -> bool:
        """Advance the matched-call counter and decide (caller holds lock)."""
        self.calls += 1
        if self.mode == "once":
            return self.fired == 0
        if self.mode == "after":
            return self.calls > self.n
        if self.mode == "every":
            return self.calls % max(self.n, 1) == 0
        return True  # always


@dataclass
class FaultRegistry:
    """Process-global fault-point registry (module singleton ``FAULTS``).

    ``fire()`` is the production seam: a single attribute check when nothing
    is armed, so the shipped hot path pays ~nothing.  State mutation is
    locked — seams fire from the engine thread, asyncio executors, and the
    gRPC servicer concurrently."""

    _specs: dict[str, list[FaultSpec]] = field(default_factory=dict)
    _armed: bool = False
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def arm(
        self,
        point: str,
        mode: str = "always",
        n: int = 1,
        match: str | None = None,
        action: str = "raise",
        delay: float = 0.0,
        message: str = "",
    ) -> FaultSpec:
        if point not in FAULT_POINTS:
            raise ValueError(
                f"unknown fault point {point!r} (known: {', '.join(FAULT_POINTS)})"
            )
        if mode not in _MODES:
            raise ValueError(f"unknown fault mode {mode!r}")
        if action not in _ACTIONS:
            raise ValueError(f"unknown fault action {action!r}")
        spec = FaultSpec(
            point=point, mode=mode, n=int(n), match=match, action=action,
            delay=float(delay), message=message,
        )
        with self._lock:
            self._specs.setdefault(point, []).append(spec)
            self._armed = True
        logger.warning("fault armed: %s mode=%s n=%d match=%r action=%s",
                       point, mode, n, match, action)
        return spec

    def disarm(self, point: str | None = None) -> None:
        """Remove every spec for ``point`` (or all points when None)."""
        with self._lock:
            if point is None:
                self._specs.clear()
            else:
                self._specs.pop(point, None)
            self._armed = bool(self._specs)

    clear = disarm  # test-teardown alias

    def armed(self, point: str | None = None) -> bool:
        if point is None:
            return self._armed
        with self._lock:
            return bool(self._specs.get(point))

    def fire(self, point: str, **ctx) -> None:
        """Production seam.  No-op unless a spec for ``point`` matches the
        call context; then sleeps (``hang``) or raises ``InjectedFault``."""
        if not self._armed:  # fast path: disarmed process
            return
        to_hang = 0.0
        boom: FaultSpec | None = None
        with self._lock:
            for spec in self._specs.get(point, ()):
                if spec.match is not None and not any(
                    spec.match in str(v) for v in ctx.values()
                ):
                    continue
                if not spec.should_fire():
                    continue
                spec.fired += 1
                if spec.action == "hang":
                    to_hang = max(to_hang, spec.delay)
                else:
                    boom = spec
                break  # first matching spec wins
        if to_hang > 0.0:
            logger.warning("fault %s: hanging %.3fs (ctx=%s)", point, to_hang, ctx)
            time.sleep(to_hang)
            return
        if boom is not None:
            msg = boom.message or f"injected fault at {point}"
            logger.warning("fault %s: raising (ctx=%s)", point, ctx)
            raise InjectedFault(f"{msg} (ctx={ctx})")

    # ---- env arming ----

    def arm_from_env(self, env: str | None = None) -> int:
        """Parse ``SMG_FAULTS`` and arm each entry; returns how many armed.

        Entry grammar: ``point=mode[:param][@match]`` where mode is one of
        ``once`` / ``always`` / ``after:N`` / ``every:N`` / ``hang:SECS``
        (hang = action "hang" with mode "always")."""
        raw = os.environ.get("SMG_FAULTS", "") if env is None else env
        count = 0
        for entry in raw.split(","):
            entry = entry.strip()
            if not entry:
                continue
            try:
                point, _, rhs = entry.partition("=")
                spec_str, _, match = rhs.partition("@")
                mode, _, param = spec_str.partition(":")
                mode = mode or "always"
                if mode == "hang":
                    self.arm(point, mode="always", action="hang",
                             delay=float(param or 0.1), match=match or None)
                else:
                    self.arm(point, mode=mode, n=int(param or 1),
                             match=match or None)
                count += 1
            except (ValueError, TypeError) as e:
                logger.error("ignoring malformed SMG_FAULTS entry %r: %s", entry, e)
        return count


#: the process singleton every seam fires through
FAULTS = FaultRegistry()

if os.environ.get("SMG_FAULTS"):
    FAULTS.arm_from_env()
