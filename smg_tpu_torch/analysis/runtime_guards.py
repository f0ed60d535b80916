"""Runtime guards of the port: host-sync, capture and lock-order guards —
the twin of ``smg_tpu/analysis/runtime_guards.py``.

- :func:`no_implicit_transfers` — on a CUDA device,
  ``torch.cuda.set_sync_debug_mode("error")`` for the block (the previous
  mode restored on exit): any operation that makes the host wait for the
  card — a stray ``.item()``, a ``.cpu()`` without ``non_blocking``, a
  ``torch.as_tensor`` of host data onto the device, a stream synchronize —
  raises at the offending call instead of silently draining the pipeline.
  The hot path's intended waits are event waits on pinned buffers
  (``runner.decode_fetch``, ``runner.spec_fetch``), and its uploads are
  ``non_blocking`` copies (``graphs.Megastep.load``); neither is a
  synchronizing operation in the mode's sense.  The mode is process-wide,
  so it covers the engine's loop thread too; a violation there raises
  inside the step, where the scheduler quarantines it (the caller reads
  the step-failure count).  On the CPU there is no host-device boundary:
  the guard does nothing, and the report it yields says so;
- :class:`CaptureCounter` — counts CUDA-graph captures
  (``engine/graphs.py``) and kernel-library builds (``ops/cuda/build.py``),
  where the reference counts XLA compiles: after warmup, steady-state
  decode must capture and build nothing;
- :func:`steady_state_guard` — both at once, raising ``RuntimeError``
  naming the budget when the block captured more than ``max_captures``;
- :class:`ProgramAuditor` / :func:`program_audit` — the runner registers
  each CUDA-graph family (decode megasteps keyed (B, mp, K, E, use_pen,
  use_mask, use_lora, use_mrope), verify blocks keyed (B, mp, W,
  use_mrope)) through :meth:`ProgramAuditor.wrap`; once ARMED (after
  warmup) each launch records its inputs' shape, dtype, device and
  ``data_ptr`` (the graph's static buffers and the KV cache), and the audit
  asserts (1) every input lies on the engine's device — the counterpart of
  the reference's mesh-commitment check; (2) the KV cache and each graph's
  static buffers keep their storage across replays — the port writes in
  place where the reference donates, so this stands where the donation
  check stands; (3) every build while armed carries provenance: a new key
  of a family names the key fields that differ from the family's previous
  launch, and a recapture of the same key names the argument whose shape,
  dtype, device or storage changed.  A build is a capture on the card, or
  an eager family's first launch of a new key (the CPU runs every family
  eagerly), so the CPU shows the provenance the card would.  The
  reference's ``_count_output_aliases`` (the ``input_output_alias`` of
  compiled HLO text) has no counterpart: there is no compiled program to
  read, and in-place writes are checked by (2) instead;
- :func:`lock_order_sentinel` — lockdep-style dynamic lock-order tracking:
  locks created through :func:`make_lock` while the sentinel is armed (the
  context manager, or ``SMG_LOCK_SENTINEL=1`` in the environment) are
  wrapped in :class:`SentinelLock`; each first-depth acquisition records an
  order edge from every lock the thread already holds, with the acquiring
  stack captured on the edge's first observation.  An edge whose reverse
  already exists is an inversion: it is recorded with BOTH stacks and, at
  context exit (or immediately under the env flag), raises
  :class:`LockOrderError`.  Identity is per lock name, not per instance.
  Unarmed, ``make_lock`` returns the plain ``threading`` primitive.

torch is imported lazily: the gateway's processes create their locks here.
"""

from __future__ import annotations

import os
import threading
import traceback
from contextlib import contextmanager

# ---- captures and kernel builds (the compile counter's counterpart) ----

_capture_lock = threading.Lock()
_capture_count = 0


def note_capture() -> None:
    """Count one CUDA-graph capture or kernel-library build; the graph
    cache and the kernel build call this where they capture or compile."""
    global _capture_count
    with _capture_lock:
        _capture_count += 1


def capture_count() -> int:
    """Monotonic count of captures and builds in this process so far."""
    return _capture_count


class CaptureCounter:
    """Context manager counting captures and builds inside the block::

        with CaptureCounter() as cc:
            engine.step()
        assert cc.count == 0, "steady-state decode captured a graph"
    """

    def __init__(self) -> None:
        self._start = 0
        self.count = 0

    def __enter__(self) -> "CaptureCounter":
        self._start = _capture_count
        return self

    def __exit__(self, *exc) -> None:
        self.count = _capture_count - self._start


# ---- host syncs ----

_sync_lock = threading.Lock()
_sync_depth = 0
_sync_prev = 0


@contextmanager
def no_implicit_transfers(device=None):
    """Raise on any synchronizing CUDA operation inside the block, on any
    thread.  ``device`` None means the card, as the port's entry points
    do (no CUDA raises: a guard on the CPU by default would check
    nothing).  Yields a report: ``{"device", "sync_debug_mode",
    "checked"}`` — on the CPU ``checked`` is False and the mode None.
    Nested guards keep the mode until the outermost one exits, which
    restores the mode found on entry."""
    global _sync_depth, _sync_prev
    import torch

    from smg_tpu_torch.engine.runner import resolve_device

    dev = resolve_device(device)
    report = {"device": dev.type, "sync_debug_mode": None, "checked": False}
    if dev.type != "cuda":
        yield report
        return
    with _sync_lock:
        if _sync_depth == 0:
            _sync_prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
        _sync_depth += 1
    report.update(sync_debug_mode="error", checked=True)
    try:
        yield report
    finally:
        with _sync_lock:
            _sync_depth -= 1
            if _sync_depth == 0:
                torch.cuda.set_sync_debug_mode(_sync_prev)


@contextmanager
def steady_state_guard(max_captures: int = 0, device=None):
    """Both guards at once, for wrapping post-warmup decode::

        with steady_state_guard(device=dev) as cc:
            for _ in range(8):
                engine.step()

    Raises RuntimeError when the block captured or built more than
    ``max_captures``; a host sync raises at the offending call (with a
    stack trace pointing at it).  ``cc.report`` is the sync guard's
    report."""
    with no_implicit_transfers(device) as report:
        with CaptureCounter() as cc:
            cc.report = report
            yield cc
    if cc.count > max_captures:
        raise RuntimeError(
            f"steady-state section captured {cc.count} CUDA graph(s) or kernel "
            f"build(s) (budget {max_captures}): a graph key changed per step — "
            "ProgramAuditor provenance names the field"
        )


# ---- the graph-family auditor (program_audit) ----

_UNKNOWN = {"arg": "<none>", "field": "unknown", "before": None, "after": None}


def _describe_args(args) -> list[dict]:
    """Flatten a launch's arguments (tensors, and dicts, lists and tuples of
    them) into leaf entries: path, shape, dtype, device, ``data_ptr``;
    anything else is host-static and recorded by its type name."""
    import torch

    entries: list[dict] = []

    def walk(path: str, x) -> None:
        if isinstance(x, torch.Tensor):
            entries.append({"path": path, "shape": tuple(x.shape), "dtype": str(x.dtype),
                            "device": str(x.device), "data_ptr": x.data_ptr()})
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(f"{path}[{k!r}]", v)
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(f"{path}[{i}]", v)
        else:
            entries.append({"path": path, "shape": None, "dtype": type(x).__name__,
                            "device": None, "data_ptr": None})

    for i, a in enumerate(args):
        walk(f"[{i}]", a)
    return entries


def _sig_diff(old: list[dict], new: list[dict]) -> list[dict]:
    """Which argument changed between two launches of one key."""
    if len(old) != len(new):
        return [{"arg": "<tree>", "field": "structure", "before": len(old),
                 "after": len(new)}]
    out = []
    for o, n in zip(old, new):
        for field in ("shape", "dtype", "device", "data_ptr"):
            if o[field] != n[field]:
                out.append({"arg": n["path"], "field": field, "before": o[field],
                            "after": n[field]})
    return out


def _key_diff(old: tuple, new: tuple, fields: tuple) -> list[dict]:
    """Which key fields differ between two keys of one family."""
    names = tuple(fields) + tuple(f"key[{i}]" for i in range(len(fields) + 1, len(new)))
    return [{"arg": name, "field": "key", "before": a, "after": b}
            for name, a, b in zip(names, old[1:], new[1:]) if a != b]


def _leaf_name(path: str) -> str:
    """``[1]['k_cache']`` -> ``k_cache``."""
    tail = path.rsplit("[", 1)[-1].rstrip("]")
    return tail.strip("'\"")


class _ProgramRecord:
    __slots__ = ("key", "fn", "donate", "fields", "born_armed", "launches", "recompiles",
                 "last_entries", "moves", "provenance")

    def __init__(self, key, fn, donate, fields, born_armed: bool):
        self.key = key
        self.fn = fn
        self.donate = tuple(donate or ())
        self.fields = tuple(fields or ())
        self.born_armed = born_armed
        self.launches = 0
        self.recompiles = 0
        self.last_entries: list[dict] | None = None
        self.moves: list[dict] = []
        self.provenance: list[dict] = []


class ProgramAuditor:
    """Registry and launch interceptor for the runner's CUDA-graph
    families.  ``key[0]`` names the family (``"decode"``, ``"verify"``),
    ``fields`` the rest of the key; ``donate`` names the inputs the launch
    writes in place (reported where the reference reports its donated
    positions); ``shared`` names inputs that every family must read from one
    storage (the KV cache).  Unarmed, the wrapper is a single attribute
    check per launch.  Armed (:meth:`arm`, after warmup), each launch
    records its inputs and brackets the call with the process capture
    counter."""

    def __init__(self, device=None, shared=()) -> None:
        self._mu = threading.Lock()
        self._records: dict = {}
        self._family_last: dict = {}  # family -> the key it launched last while armed
        self.armed = False
        self.device = device
        self.shared = tuple(shared)

    # ---- registration / launch path ----

    def wrap(self, key, fn, *, fields=(), donate=()):
        """Register ``fn`` under ``key`` and return the launch wrapper to
        call in its place (same arguments)."""
        rec = _ProgramRecord(key, fn, donate, fields, self.armed)
        with self._mu:
            self._records[key] = rec

        def launch(*args):
            if not self.armed:
                return fn(*args)
            entries = _describe_args(args)
            pre = _capture_count
            out = fn(*args)
            built = _capture_count - pre
            if not built and rec.born_armed and rec.launches == 0:
                built = 1  # an eager family's first launch of a new key
            with self._mu:
                if built:
                    rec.recompiles += built
                    if rec.launches == 0:
                        prev = self._family_last.get(key[0])
                        changed = (_key_diff(prev, key, rec.fields) if prev is not None
                                   else [{"arg": "<key>", "field": "new key", "before": None,
                                          "after": dict(zip(rec.fields, key[1:]))}])
                    else:
                        changed = _sig_diff(rec.last_entries, entries)
                    rec.provenance.append({"key": repr(key), "compiles": built,
                                           "changed": changed or [dict(_UNKNOWN)]})
                if rec.last_entries is not None:
                    seen = {m["arg"] for m in rec.moves}
                    for o, n in zip(rec.last_entries, entries):
                        if (o["data_ptr"] is not None and o["data_ptr"] != n["data_ptr"]
                                and n["path"] not in seen):
                            rec.moves.append({"arg": n["path"], "why": "storage moved "
                                              "between launches", "before": o["data_ptr"],
                                              "after": n["data_ptr"]})
                rec.launches += 1
                rec.last_entries = entries
                self._family_last[key[0]] = key
            return out

        launch.__wrapped__ = fn
        return launch

    def arm(self) -> None:
        """Start recording launches (call after warmup)."""
        self.armed = True

    def disarm(self) -> None:
        self.armed = False

    def forget(self, keys) -> None:
        """Drop the records of dropped graphs."""
        with self._mu:
            for k in list(keys):
                self._records.pop(k, None)
                if self._family_last.get(k[0]) == k:
                    del self._family_last[k[0]]

    # ---- reporting ----

    def snapshot(self) -> dict:
        """Cheap JSON-safe summary for ``Engine.loads()["programs"]`` (the
        reference's schema)."""
        with self._mu:
            programs = [
                {
                    "key": repr(rec.key),
                    "launches": rec.launches,
                    "recompiles": rec.recompiles,
                    "donate": list(rec.donate),
                    "audited": rec.last_entries is not None,
                }
                for rec in self._records.values()
            ]
        return {
            "armed": self.armed,
            "recompiles": sum(p["recompiles"] for p in programs),
            "programs": programs,
        }

    def _on_device(self, device: str) -> bool:
        import torch

        got, want = torch.device(device), torch.device(self.device)
        if got.type != want.type:
            return False
        if got.type != "cuda" or want.index is None or got.index is None:
            return True
        return got.index == want.index

    def audit(self) -> dict:
        """Walk every recorded family member; ``report["clean"]`` is the
        go/no-go bit: no input off the engine's device, no storage moved
        between launches or between the families' shared inputs, and every
        build while armed explained by its provenance."""
        with self._mu:
            records = list(self._records.values())
            programs = []
            off_device = moved = unexplained = recompiles = 0
            shared_ptrs: dict[str, dict] = {}
            for rec in records:
                entry: dict = {
                    "key": repr(rec.key),
                    "launches": rec.launches,
                    "recompiles": rec.recompiles,
                    "provenance": list(rec.provenance),
                    "audited": rec.last_entries is not None,
                    "donate": list(rec.donate),
                }
                recompiles += rec.recompiles
                unexplained += sum(1 for p in rec.provenance
                                   if p["changed"][0]["arg"] == _UNKNOWN["arg"])
                if rec.last_entries is None:
                    programs.append(entry)
                    continue
                tensors = [e for e in rec.last_entries if e["device"] is not None]
                bad = []
                if self.device is not None:
                    bad = [e for e in tensors if not self._on_device(e["device"])]
                elif len({e["device"] for e in tensors}) > 1:
                    bad = tensors  # no engine device given: one device for all
                for e in bad:
                    entry.setdefault("bad_inputs", []).append(
                        {"arg": e["path"], "why": "off the engine's device",
                         "device": e["device"]})
                off_device += len(bad)
                if rec.moves:
                    entry["storage_moves"] = list(rec.moves)
                    moved += len(rec.moves)
                for e in tensors:
                    name = _leaf_name(e["path"])
                    if name in self.shared:
                        shared_ptrs.setdefault(name, {})[repr(rec.key)] = e["data_ptr"]
                programs.append(entry)
        shared = {}
        for name, ptrs in shared_ptrs.items():
            shared[name] = {"storages": len(set(ptrs.values())), "programs": len(ptrs)}
            if len(set(ptrs.values())) > 1:
                moved += 1
        return {
            "armed": self.armed,
            "programs": programs,
            "shared_inputs": shared,
            "off_device_inputs": off_device,
            "storage_moves": moved,
            "unexplained_captures": unexplained,
            "recompiles": recompiles,
            "clean": not (off_device or moved or unexplained),
        }


def program_audit(target) -> dict:
    """Audit every recorded graph family of ``target`` — a
    :class:`ProgramAuditor`, or anything exposing one as ``_programs`` (the
    runner) or ``runner._programs`` (the engine)::

        eng.generate(...); eng.runner._programs.arm()
        ...steady-state traffic...
        report = program_audit(eng)
        assert report["clean"], report
    """
    auditor = target
    for attr in ("runner", "_programs"):
        nxt = getattr(auditor, attr, None)
        if nxt is not None and not isinstance(auditor, ProgramAuditor):
            auditor = nxt
    if not isinstance(auditor, ProgramAuditor):
        raise TypeError(f"program_audit: no ProgramAuditor reachable from {target!r}")
    return auditor.audit()


# ---- lock-order sentinel ----

#: env flag arming a process-global sentinel that raises AT THE ACQUISITION
#: that completes an inversion
SENTINEL_ENV = "SMG_LOCK_SENTINEL"


class LockOrderError(RuntimeError):
    """A lock-order inversion, reported with both acquisition stacks."""


class LockOrderSentinel:
    """Dynamic lock-order graph: nodes are lock NAMES, an edge A->B means
    some thread acquired B while holding A.  The reverse edge appearing is
    an inversion (a 2-cycle — the classic ABBA deadlock shape); it is
    recorded with the stack that created the first edge and the stack that
    closed the cycle.  The graph and inversion list live under a plain
    internal lock (never a SentinelLock — the sentinel must not watch
    itself)."""

    def __init__(self, raise_on_inversion: bool = False):
        self.raise_on_inversion = raise_on_inversion
        self._mu = threading.Lock()
        # (holder, acquired) -> stack captured when the edge first appeared
        self._edges: dict[tuple[str, str], str] = {}
        self.inversions: list[dict] = []
        self._held = threading.local()

    # ---- per-acquisition hooks (called by SentinelLock at depth 0/1) ----

    def note_acquire(self, name: str) -> None:
        held: list[str] = getattr(self._held, "names", None)
        if held is None:
            held = self._held.names = []
        # racy fast-path pre-check, re-verified under self._mu below: a
        # stale miss only costs one extra stack capture, never a lost edge
        new_edges = [(h, name) for h in held if h != name
                     and (h, name) not in self._edges]  # smglint: disable=GUARDED benign pre-check, rechecked under _mu
        held.append(name)
        if not new_edges:
            return
        stack = "".join(traceback.format_stack(limit=16)[:-2])
        fresh = 0
        with self._mu:
            for edge in new_edges:
                if edge in self._edges:
                    continue
                self._edges[edge] = stack
                rev = self._edges.get((edge[1], edge[0]))
                if rev is not None:
                    fresh += 1
                    self.inversions.append({
                        "first": f"{edge[1]} -> {edge[0]}",
                        "first_stack": rev,
                        "second": f"{edge[0]} -> {edge[1]}",
                        "second_stack": stack,
                    })
        if fresh and self.raise_on_inversion:
            raise LockOrderError(self.format_inversions())

    def note_release(self, name: str) -> None:
        held = getattr(self._held, "names", None)
        if held:
            # remove the LAST occurrence: releases unwind LIFO, and an
            # out-of-order release of an aliased name must not strip the
            # wrong hold
            for i in range(len(held) - 1, -1, -1):
                if held[i] == name:
                    del held[i]
                    break

    def format_inversions(self) -> str:
        with self._mu:
            inversions = list(self.inversions)
        parts = [f"{len(inversions)} lock-order inversion(s):"]
        for inv in inversions:
            parts.append(
                f"\n=== {inv['second']} (conflicts with {inv['first']}) ===\n"
                f"--- stack that established {inv['first']} ---\n"
                f"{inv['first_stack']}"
                f"--- stack that closed the cycle ({inv['second']}) ---\n"
                f"{inv['second_stack']}"
            )
        return "".join(parts)


class SentinelLock:
    """Drop-in wrapper over a ``threading`` lock that reports first-depth
    acquisitions/releases to a :class:`LockOrderSentinel`.  Re-entrant
    acquisitions (RLock) are depth-counted and not re-reported.  Implements
    the ``threading.Condition`` owner protocol (``_release_save`` /
    ``_acquire_restore`` / ``_is_owned``) so a Condition built on a
    sentinel-wrapped (R)Lock keeps working — a ``wait()`` fully releases
    the hold and re-registers it on wakeup."""

    def __init__(self, name: str, inner, sentinel: LockOrderSentinel):
        self._name = name
        self._inner = inner
        self._sentinel = sentinel
        self._local = threading.local()

    # ---- core lock protocol ----

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            depth = getattr(self._local, "depth", 0)
            self._local.depth = depth + 1
            if depth == 0:
                try:
                    self._sentinel.note_acquire(self._name)
                except LockOrderError:
                    # raise-on-inversion mode: leave the lock UNHELD so the
                    # failing test's unwinding doesn't wedge other threads
                    self._local.depth = depth
                    self._sentinel.note_release(self._name)
                    self._inner.release()
                    raise
        return ok

    def release(self) -> None:
        self._inner.release()
        depth = getattr(self._local, "depth", 1) - 1
        self._local.depth = depth
        if depth == 0:
            self._sentinel.note_release(self._name)

    def __enter__(self) -> "SentinelLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()

    # ---- Condition owner protocol ----

    def _release_save(self):
        depth = getattr(self._local, "depth", 0)
        self._local.depth = 0
        if depth:
            self._sentinel.note_release(self._name)
        if hasattr(self._inner, "_release_save"):
            return (self._inner._release_save(), depth)
        self._inner.release()
        return (None, depth)

    def _acquire_restore(self, state) -> None:
        inner_state, depth = state
        if hasattr(self._inner, "_acquire_restore"):
            self._inner._acquire_restore(inner_state)
        else:
            self._inner.acquire()
        self._local.depth = depth
        if depth:
            self._sentinel.note_acquire(self._name)

    def _is_owned(self) -> bool:
        if hasattr(self._inner, "_is_owned"):
            return self._inner._is_owned()
        return getattr(self._local, "depth", 0) > 0


_ambient_sentinel: LockOrderSentinel | None = None


def _active_sentinel() -> LockOrderSentinel | None:
    global _ambient_sentinel
    if _ambient_sentinel is not None:
        return _ambient_sentinel
    if os.environ.get(SENTINEL_ENV, "").strip() not in ("", "0"):
        # env-armed: one process-global sentinel, inversions raise at the
        # offending acquisition (the test holding it fails with both stacks)
        _ambient_sentinel = LockOrderSentinel(raise_on_inversion=True)
        return _ambient_sentinel
    return None


def make_lock(name: str, *, reentrant: bool = False):
    """The adoption point: the serving locks (engine, flight recorder,
    breaker, worker, worker registry, SLO tracker, route observability) are
    created through this instead of ``threading.Lock()`` directly.  Unarmed
    it returns the bare primitive; armed it returns a :class:`SentinelLock`
    participating in order tracking under ``name`` (the lock CLASS —
    instances share it)."""
    inner = threading.RLock() if reentrant else threading.Lock()
    sentinel = _active_sentinel()
    if sentinel is None:
        return inner
    return SentinelLock(name, inner, sentinel)


@contextmanager
def lock_order_sentinel(*, raise_on_inversion: bool = False):
    """Arm lock-order tracking for the block: locks created via
    :func:`make_lock` inside it are sentinel-wrapped.  Yields the
    :class:`LockOrderSentinel`; on exit, any recorded inversion raises
    :class:`LockOrderError` with both acquisition stacks.
    ``raise_on_inversion=True`` raises at the acquisition that closes the
    cycle instead."""
    global _ambient_sentinel
    prev = _ambient_sentinel
    sentinel = LockOrderSentinel(raise_on_inversion=raise_on_inversion)
    _ambient_sentinel = sentinel
    try:
        yield sentinel
    finally:
        _ambient_sentinel = prev
    if sentinel.inversions:
        raise LockOrderError(sentinel.format_inversions())
