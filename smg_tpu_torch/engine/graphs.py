"""Decode megasteps replayed from CUDA graphs — the port's counterpart of
the JAX runner's compiled decode programs (``smg_tpu/engine/runner.py``,
``_decode_multi_fn``: one jitted program per batch bucket, page-table
bucket, loop width, stop-id width, penalties and vocab mask).

One ``Megastep`` exists per (B bucket, page-table width ``mp``, horizon K,
stop-id width E, penalties on, vocab mask on, LoRA on, M-RoPE on).  It owns the
launch's persistent device inputs, which the runner refreshes only when the
batch composition or the page tables change (``load``), and, on the card
with graphs on, one CUDA graph of the whole megastep: every column's
forward, the side-buffer writes, the penalties and their count update, the
sampler, the device stop mask and the final KV scatter.  The penalty count
and prompt-mask buffers are the runner's, read and written in place; so is
the LoRA bank, whose per-row slot indices load with the lane composition;
so do the per-row M-RoPE decode offsets (the graph is keyed by
``use_mrope`` as the reference keys its program: a composition without an
M-RoPE lane runs the graph it always ran, and one with such a lane reads
its offsets, zero for text rows, from a buffer the graph captured, never a
tensor made at launch, which a replay would not see); the vocab mask (grammar lanes, K=1 only) is uploaded at every launch.  The
first launch of a shape runs eagerly on the capture stream (the warm-up:
first launches of a kernel instantiation set its attributes, cuBLAS sets up
its workspace), and its results are that launch's; the shape is then
captured and every later launch replays it.  All graphs share one memory
pool: a graph's intermediates are dead once it ends, and graphs replay one
at a time on one stream.

A graph per horizon rather than one at ``horizon_cap`` with a device-side
column limit: a graph runs every column it captured (leaving a loop on
device data would need conditional graph nodes), so a cap-wide graph would
compute cap columns for every K=1 launch that pending admissions force.
Horizons are few: powers of two under the cap, plus the adaptive
controller's clamps.

Speculative verify blocks (``runner._verify_step``) get graphs of their own,
one per (B bucket, ``mp``, block width W, M-RoPE on): a ``VerifyStep``
holds the block's inputs (tokens ``[B, W]``, per-lane draft counts,
entries, page tables, the sampling counter and parameters, the M-RoPE
offsets), all loaded at every launch,
since a verify frame is rebuilt from the drafts of its step.  Per-lane
draft counts ride a device tensor, so one graph serves every draft count.

A graph captured on the card never falls back to eager launches: a failed
warm-up or capture raises.  A rank of a rank mesh (``parallel/``: tp, pp,
sp, ep) captures its megasteps the same way, each rank in its own process
on its own card: the model's NCCL collectives (tp's all-reduces and
all-gather, a pipeline stage's send, receive and logits broadcast, ep's
all-reduce) are issued inside ``body`` on the capture stream, so they are
part of the graph, and every rank captures the same shapes in the same
order (rank 0 mirrors its calls).  Gloo collectives go through host memory
and cannot be captured: an engine whose ranks use them refuses
``decode_graphs=True`` at construction.

Every shape is registered with the runner's ``ProgramAuditor``
(``analysis/runtime_guards.py``) under its family and key (``("decode", B,
mp, K, E, use_pen, use_mask, use_lora, use_mrope)``, ``("verify", B, mp, W,
use_mrope)``): the runner launches a shape through ``step.launch``, which
the auditor records once armed, and ``drop`` returns the keys of the shapes
it lets go so the runner forgets their records.  Each capture counts in the
process capture counter (``runtime_guards.note_capture``), which the
steady-state guard reads.

Every ``GraphCache`` of a device captures on that device's one capture
stream (``_DeviceCapture``).  PyTorch keeps a cuBLAS workspace for every
(cuBLAS handle, stream) pair that ran a product and never frees it, so a
stream per engine left 32 MiB on the card for every engine a process
built.  A captured graph holds the workspace pointer of its pair, so the
workspaces are released only when no ``GraphCache`` of the device holds a
graph any more: the collection of the last holder (its engine dropped)
clears them.
"""

from __future__ import annotations

import threading
import time
import weakref

import numpy as np
import torch

from smg_tpu_torch.analysis.runtime_guards import ProgramAuditor, note_capture
from smg_tpu_torch.ops.cuda import decode_attention

#: the key fields of each family after its name (``ProgramAuditor`` provenance)
DECODE_FIELDS = ("B", "mp", "K", "E", "use_pen", "use_mask", "use_lora", "use_mrope")
VERIFY_FIELDS = ("B", "mp", "W", "use_mrope")


class Megastep:
    """Persistent inputs, and the graph, of one decode megastep shape."""

    def __init__(self, device: torch.device, B: int, mp: int, K: int, E: int,
                 use_pen: bool = False, use_mask: bool = False, vocab: int = 0,
                 use_lora: bool = False, use_mrope: bool = False):
        i32, i64, f32 = torch.int32, torch.int64, torch.float32
        self.B, self.mp, self.K, self.E = B, mp, K, E
        self.use_pen, self.use_mask, self.use_lora = use_pen, use_mask, use_lora
        self.use_mrope = use_mrope
        # each row's adapter slot (0 = none, padded rows 0)
        self.lora_idx = torch.zeros(B, dtype=i64, device=device) if use_lora else None
        # each row's M-RoPE decode offset (0 for text and padded rows)
        self.rope_delta = torch.zeros(B, dtype=i32, device=device) if use_mrope else None
        self.tokens = torch.zeros(B, dtype=i64, device=device)
        self.entry = torch.zeros(B, dtype=i32, device=device)
        self.counter = torch.zeros(1, dtype=i64, device=device)  # sampling step before col 0
        self.page_tables = torch.zeros((B, mp), dtype=i32, device=device)
        self.temps = torch.zeros(B, dtype=f32, device=device)
        self.topks = torch.full((B,), -1, dtype=i64, device=device)
        self.topps = torch.ones(B, dtype=f32, device=device)
        self.minps = torch.zeros(B, dtype=f32, device=device)
        self.stop_ids = self.limits = self.live = None
        if E:
            self.stop_ids = torch.full((B, E), -1, dtype=i64, device=device)
            self.limits = torch.ones(B, dtype=i64, device=device)
            self.live = torch.zeros(B, dtype=torch.bool, device=device)
        # penalties: each row's slot in the runner's [S+1, V] buffers (S for
        # padded rows) and its scalars; a neutral row changes nothing
        self.slot_idx = self.freqs = self.pres = self.reps = None
        if use_pen:
            self.slot_idx = torch.zeros(B, dtype=i64, device=device)
            self.freqs = torch.zeros(B, dtype=f32, device=device)
            self.pres = torch.zeros(B, dtype=f32, device=device)
            self.reps = torch.ones(B, dtype=f32, device=device)
        self.mask = torch.ones((B, vocab), dtype=torch.bool, device=device) if use_mask else None
        self.lane_sig = None  # DecodeState signatures the buffers hold
        self.pt_sig = None
        self.graph: torch.cuda.CUDAGraph | None = None
        self.outputs: tuple | None = None  # the graph's static outputs
        self.replay_launches = 0  # decode-kernel launches one replay runs
        # the persistent inputs by name (a graph reads them at their addresses)
        self.buffers = {k: v for k, v in vars(self).items() if isinstance(v, torch.Tensor)}
        self.launch = None  # the auditor's wrapper of GraphCache.run (GraphCache.get)

    def load(self, ds, tokens, positions: np.ndarray, counter: int,
             mask: np.ndarray | None = None) -> None:
        """Bring the inputs up to date for one launch.  Sampling parameters,
        penalty rows and stop state move only on a new lane signature, page
        tables only on a new page-table signature; tokens (host numpy, or
        the device column a lookahead chains from), positions, the sampling
        counter and the vocab mask every launch.  Host copies are enqueued
        without a sync."""
        if self.lane_sig != ds.lane_sig:
            for dst, src in ((self.temps, ds.temps), (self.topks, ds.topks),
                             (self.topps, ds.topps), (self.minps, ds.minps)):
                dst.copy_(torch.from_numpy(src), non_blocking=True)
            if self.E:
                self.stop_ids.copy_(torch.from_numpy(ds.stop_ids), non_blocking=True)
                self.limits.copy_(torch.from_numpy(ds.limits), non_blocking=True)
                self.live.copy_(torch.from_numpy(ds.live), non_blocking=True)
            if self.use_pen:
                for dst, src in ((self.slot_idx, ds.slot_idx), (self.freqs, ds.freqs),
                                 (self.pres, ds.pres), (self.reps, ds.reps)):
                    dst.copy_(torch.from_numpy(src), non_blocking=True)
            if self.use_lora:
                self.lora_idx.copy_(torch.from_numpy(ds.lora_idx), non_blocking=True)
            if self.use_mrope:
                self.rope_delta.copy_(torch.from_numpy(ds.rope_delta), non_blocking=True)
            self.lane_sig = ds.lane_sig
        if self.pt_sig != ds.pt_sig:
            self.page_tables.copy_(torch.from_numpy(ds.page_tables), non_blocking=True)
            self.pt_sig = ds.pt_sig
        if torch.is_tensor(tokens):
            self.tokens.copy_(tokens)  # device to device: stream-ordered
        else:
            self.tokens.copy_(torch.from_numpy(np.asarray(tokens, np.int64)), non_blocking=True)
        self.entry.copy_(torch.from_numpy(np.asarray(positions, np.int32)), non_blocking=True)
        self.counter.fill_(counter)
        if self.use_mask:
            self.mask.copy_(torch.from_numpy(mask), non_blocking=True)


class VerifyStep:
    """Persistent inputs, and the graph, of one verify-block shape."""

    def __init__(self, device: torch.device, B: int, mp: int, W: int,
                 use_mrope: bool = False):
        i32, i64, f32 = torch.int32, torch.int64, torch.float32
        self.B, self.mp, self.W = B, mp, W
        self.use_mrope = use_mrope
        self.rope_delta = torch.zeros(B, dtype=i32, device=device) if use_mrope else None
        self.tokens = torch.zeros((B, W), dtype=i64, device=device)
        self.draft_n = torch.zeros(B, dtype=i64, device=device)
        self.entry = torch.zeros(B, dtype=i32, device=device)
        self.counter = torch.zeros(1, dtype=i64, device=device)  # the launch's counter
        self.page_tables = torch.zeros((B, mp), dtype=i32, device=device)
        self.temps = torch.zeros(B, dtype=f32, device=device)
        self.topks = torch.full((B,), -1, dtype=i64, device=device)
        self.topps = torch.ones(B, dtype=f32, device=device)
        self.minps = torch.zeros(B, dtype=f32, device=device)
        self.graph: torch.cuda.CUDAGraph | None = None
        self.outputs: tuple | None = None
        self.replay_launches = 0  # decode-kernel launches one replay runs (none)
        self.buffers = {k: v for k, v in vars(self).items() if isinstance(v, torch.Tensor)}
        self.launch = None

    def load(self, tokens, draft_n, positions, page_tables, temps, topks, topps, minps,
             counter: int, rope_delta=None) -> None:
        """Copy one launch's host inputs in, enqueued without a sync."""
        if self.use_mrope:
            self.rope_delta.copy_(torch.from_numpy(np.ascontiguousarray(rope_delta, np.int32)),
                                  non_blocking=True)
        for dst, src, dt in ((self.tokens, tokens, np.int64), (self.draft_n, draft_n, np.int64),
                             (self.entry, positions, np.int32),
                             (self.page_tables, page_tables, np.int32),
                             (self.temps, temps, np.float32), (self.topks, topks, np.int64),
                             (self.topps, topps, np.float32), (self.minps, minps, np.float32)):
            dst.copy_(torch.from_numpy(np.ascontiguousarray(src, dt)), non_blocking=True)
        self.counter.fill_(counter)


class _DeviceCapture:
    """One device's capture stream, shared by every ``GraphCache`` on it,
    the lock that keeps two captures off the stream at once, and the count
    of caches holding graphs (their replays read the cuBLAS workspaces of
    the stream's pairs)."""

    _by_device: dict[int, "_DeviceCapture"] = {}  # process-wide, as the workspaces are
    _guard = threading.Lock()

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.lock = threading.Lock()
        self.holders = 0

    @classmethod
    def of(cls, device: torch.device) -> "_DeviceCapture":
        index = device.index if device.index is not None else torch.cuda.current_device()
        with cls._guard:
            dc = cls._by_device.get(index)
            if dc is None:
                dc = cls._by_device[index] = cls(torch.device("cuda", index))
            return dc

    def hold(self) -> None:
        with self._guard:
            self.holders += 1

    def let_go(self) -> None:
        """One holder fewer; the last one releases the cuBLAS workspaces.
        A cache holds before it takes the capture lock, so no capture runs
        once the count is 0 under the lock."""
        with self._guard:
            self.holders -= 1
            if self.holders:
                return
        with self.lock:
            with self._guard:
                if self.holders:  # a new holder since: its capture needs them
                    return
            torch.cuda.synchronize(self.device)  # no replay still reads one
            clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)  # CUDA builds
            if clear is not None:
                clear()


class GraphCache:
    """The runner's megasteps, keyed by shape, and their capture record."""

    def __init__(self, device: torch.device, use_graphs: bool, programs: ProgramAuditor):
        self.device = device
        self.use_graphs = use_graphs and device.type == "cuda"
        self.programs = programs  # the runner's auditor: every shape registers there
        self.steps: dict[tuple, Megastep] = {}
        self.verify: dict[tuple, VerifyStep] = {}
        self.capture_s = 0.0  # all graphs
        self.capture_bytes = 0  # memory_reserved growth over warm-ups + captures
        self.verify_capture_s = 0.0  # verify graphs alone
        self.verify_capture_bytes = 0
        self._held = None  # from the first capture: lets go of the device's count
        if self.use_graphs:
            self.pool = torch.cuda.graph_pool_handle()
            self.capture = _DeviceCapture.of(device)
            self.stream = self.capture.stream

    @property
    def num_graphs(self) -> int:
        return sum(1 for s in self.steps.values() if s.graph is not None)

    def stats(self) -> dict:
        return {"decode_graphs": self.num_graphs, "graph_capture_s": self.capture_s,
                "graph_capture_bytes": self.capture_bytes,
                "verify_graphs": sum(1 for s in self.verify.values() if s.graph is not None),
                "verify_capture_s": self.verify_capture_s,
                "verify_capture_bytes": self.verify_capture_bytes}

    def get(self, B: int, mp: int, K: int, E: int, use_pen: bool = False,
            use_mask: bool = False, vocab: int = 0, use_lora: bool = False,
            use_mrope: bool = False) -> Megastep:
        key = (B, mp, K, E, use_pen, use_mask, use_lora, use_mrope)
        step = self.steps.get(key)
        if step is None:
            step = self.steps[key] = Megastep(self.device, B, mp, K, E, use_pen, use_mask,
                                              vocab, use_lora, use_mrope)
            donate = ("k_cache", "v_cache") + (("counts",) if use_pen else ())
            step.launch = self.programs.wrap(("decode", *key), self._launcher(step),
                                             fields=DECODE_FIELDS, donate=donate)
        return step

    def get_verify(self, B: int, mp: int, W: int, use_mrope: bool = False) -> VerifyStep:
        key = (B, mp, W, use_mrope)
        step = self.verify.get(key)
        if step is None:
            step = self.verify[key] = VerifyStep(self.device, B, mp, W, use_mrope)
            step.launch = self.programs.wrap(("verify", *key), self._launcher(step),
                                             fields=VERIFY_FIELDS, donate=("k_cache", "v_cache"))
        return step

    def _launcher(self, step):
        """``run`` for ``step``, looked up at each launch (a caller may wrap
        the cache's ``run`` to time it); the launch's named inputs are the
        auditor's record alone."""
        return lambda body, inputs: self.run(step, body)

    def drop(self, kind: str | None = None) -> list:
        """Let go of every shape (``kind`` None) or of one family's
        (``"decode"``, ``"verify"``); returns the dropped keys, family
        first, as the auditor knows them.  Later captures go to a fresh
        memory pool: the allocator retires a pool once no graph holds it,
        and a capture into a retired pool fails; the old pool's memory
        returns once the graphs still holding it go."""
        dropped = []
        for family, steps in (("decode", self.steps), ("verify", self.verify)):
            if kind in (None, family):
                dropped += [(family, *k) for k in steps]
                steps.clear()
        if dropped and self.use_graphs:
            self.pool = torch.cuda.graph_pool_handle()
        return dropped

    def run(self, step, body) -> tuple:
        """One launch of ``step`` (a ``Megastep`` or a ``VerifyStep``):
        ``body(step)`` computes it from the step's inputs and returns its
        output tensors.  Replays the graph
        when there is one; otherwise runs ``body`` eagerly (and, with graphs
        on, captures it right after)."""
        if step.graph is not None:
            step.graph.replay()
            decode_attention.count_launches(step.replay_launches)
            return step.outputs
        if not self.use_graphs:
            return body(step)
        main = torch.cuda.current_stream(self.device)
        t0 = time.perf_counter()
        if self._held is None:
            self.capture.hold()
            self._held = weakref.finalize(self, self.capture.let_go)
            self._held.atexit = False  # no CUDA calls while the process exits
        with self.capture.lock:  # one capture at a time on the shared stream
            # under the lock: the allocator asserts that no capture is
            # underway when it empties its cache, and another engine's
            # thread may be capturing on this stream
            torch.cuda.empty_cache()
            reserved0 = torch.cuda.memory_reserved(self.device)
            self.stream.wait_stream(main)
            with torch.cuda.stream(self.stream):
                out = body(step)  # warm-up: this launch's results
            main.wait_stream(self.stream)
            for t in out:
                t.record_stream(main)
            before = decode_attention.thread_launches()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                                  capture_error_mode="thread_local"):
                outputs = body(step)
        # a capture records launches without running them: they count at
        # each replay instead.  This thread's tally: another engine's thread
        # may launch or replay during the capture
        step.replay_launches = decode_attention.thread_launches() - before
        decode_attention.count_launches(-step.replay_launches)
        step.graph, step.outputs = graph, outputs
        note_capture()
        grown = torch.cuda.memory_reserved(self.device) - reserved0
        took = time.perf_counter() - t0
        self.capture_bytes += grown
        self.capture_s += took
        if isinstance(step, VerifyStep):
            self.verify_capture_bytes += grown
            self.verify_capture_s += took
        return out
