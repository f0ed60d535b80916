"""Decode megasteps replayed from CUDA graphs — the port's counterpart of
the JAX runner's compiled decode programs (``smg_tpu/engine/runner.py``,
``_decode_multi_fn``: one jitted program per batch bucket, page-table
bucket, loop width, stop-id width, penalties and vocab mask).

One ``Megastep`` exists per (B bucket, page-table width ``mp``, horizon K,
stop-id width E, penalties on, vocab mask on).  It owns the launch's
persistent device inputs, which the runner refreshes only when the batch
composition or the page tables change (``load``), and, on the card with
graphs on, one CUDA graph of the whole megastep: every column's forward,
the side-buffer writes, the penalties and their count update, the sampler,
the device stop mask and the final KV scatter.  The penalty count and
prompt-mask buffers are the runner's, read and written in place; the
vocab mask (grammar lanes, K=1 only) is uploaded at every launch.  The first launch of a shape
runs eagerly on the capture stream (the warm-up: first launches of a kernel
instantiation set its attributes, cuBLAS sets up its workspace), and its
results are that launch's; the shape is then captured and every later
launch replays it.  All graphs share one memory pool: a graph's
intermediates are dead once it ends, and graphs replay one at a time on one
stream.

A graph per horizon rather than one at ``horizon_cap`` with a device-side
column limit: a graph runs every column it captured (leaving a loop on
device data would need conditional graph nodes), so a cap-wide graph would
compute cap columns for every K=1 launch that pending admissions force.
Horizons are few: powers of two under the cap, plus the adaptive
controller's clamps.

A graph captured on the card never falls back to eager launches: a failed
warm-up or capture raises.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from smg_tpu_torch.ops.cuda import decode_attention


class Megastep:
    """Persistent inputs, and the graph, of one decode megastep shape."""

    def __init__(self, device: torch.device, B: int, mp: int, K: int, E: int,
                 use_pen: bool = False, use_mask: bool = False, vocab: int = 0):
        i32, i64, f32 = torch.int32, torch.int64, torch.float32
        self.B, self.mp, self.K, self.E = B, mp, K, E
        self.use_pen, self.use_mask = use_pen, use_mask
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


class GraphCache:
    """The runner's megasteps, keyed by shape, and their capture record."""

    def __init__(self, device: torch.device, use_graphs: bool):
        self.device = device
        self.use_graphs = use_graphs and device.type == "cuda"
        self.steps: dict[tuple, Megastep] = {}
        self.capture_s = 0.0
        self.capture_bytes = 0  # memory_reserved growth over warm-ups + captures
        if self.use_graphs:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(device)

    @property
    def num_graphs(self) -> int:
        return sum(1 for s in self.steps.values() if s.graph is not None)

    def stats(self) -> dict:
        return {"decode_graphs": self.num_graphs, "graph_capture_s": self.capture_s,
                "graph_capture_bytes": self.capture_bytes}

    def get(self, B: int, mp: int, K: int, E: int, use_pen: bool = False,
            use_mask: bool = False, vocab: int = 0) -> Megastep:
        key = (B, mp, K, E, use_pen, use_mask)
        step = self.steps.get(key)
        if step is None:
            step = self.steps[key] = Megastep(self.device, B, mp, K, E, use_pen, use_mask,
                                              vocab)
        return step

    def run(self, step: Megastep, body) -> tuple:
        """One launch of ``step``: ``body(step)`` computes the megastep from
        the step's inputs and returns its output tensors.  Replays the graph
        when there is one; otherwise runs ``body`` eagerly (and, with graphs
        on, captures it right after)."""
        if step.graph is not None:
            step.graph.replay()
            decode_attention.launches += step.replay_launches
            return step.outputs
        if not self.use_graphs:
            return body(step)
        main = torch.cuda.current_stream(self.device)
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        reserved0 = torch.cuda.memory_reserved(self.device)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            out = body(step)  # warm-up: this launch's results
        main.wait_stream(self.stream)
        for t in out:
            t.record_stream(main)
        before = decode_attention.launches
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                              capture_error_mode="thread_local"):
            outputs = body(step)
        # a capture records launches without running them: they count at
        # each replay instead
        step.replay_launches = decode_attention.launches - before
        decode_attention.launches = before
        step.graph, step.outputs = graph, outputs
        self.capture_bytes += torch.cuda.memory_reserved(self.device) - reserved0
        self.capture_s += time.perf_counter() - t0
        return out
