"""Runtime guards of the port — the twin of ``smg_tpu/analysis``'s
``runtime_guards`` (the reference's static lint, ``smglint``, is not
ported: its rules read the JAX package's idioms, and the repository's tests
run it over this package as it is).

- :func:`no_implicit_transfers`, :class:`CaptureCounter` and
  :func:`steady_state_guard`: no host sync and no CUDA-graph capture or
  kernel build inside post-warmup decode;
- :class:`ProgramAuditor` / :func:`program_audit`: the runner's CUDA-graph
  families, audited for device placement, storage kept across replays and
  capture provenance;
- :func:`make_lock` / :func:`lock_order_sentinel`: lockdep-style dynamic
  lock-order tracking on the serving locks.
"""

from smg_tpu_torch.analysis.runtime_guards import (
    SENTINEL_ENV,
    CaptureCounter,
    LockOrderError,
    LockOrderSentinel,
    ProgramAuditor,
    SentinelLock,
    capture_count,
    lock_order_sentinel,
    make_lock,
    no_implicit_transfers,
    note_capture,
    program_audit,
    steady_state_guard,
)

__all__ = [
    "SENTINEL_ENV", "CaptureCounter", "LockOrderError", "LockOrderSentinel",
    "ProgramAuditor", "SentinelLock", "capture_count", "lock_order_sentinel",
    "make_lock", "no_implicit_transfers", "note_capture", "program_audit",
    "steady_state_guard",
]
