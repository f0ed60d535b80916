"""ModelRunner: owns the weights, the KV buffers, the sampler's counter and
the decode megasteps (port of ``smg_tpu/engine/runner.py``'s serving path).

Entry points run on the card: ``device=None`` resolves to ``cuda`` and a
machine without one raises; the CPU is used only when the caller asks for
it (the tests do).  Prefill runs eagerly at its exact shapes.  Decode runs
as megasteps at bucketed shapes; on the card each shape is replayed from a
CUDA graph (``engine/graphs.py``) unless the configuration asks for eager
launches (``EngineConfig.decode_graphs=False``); the CPU always runs them
eagerly.  Cache writes are in place, so the JAX runner's donation policy,
sharding and program auditor have no counterpart.

Penalties keep per-slot state on the device, as the JAX runner does: a
``[S+1, V]`` int32 count buffer and a bool prompt-mask buffer (row S is the
garbage row of padded decode rows), created at the first penalised launch
and written only in place, since CUDA graphs hold their addresses.  The
megastep reads the rows of its lanes, penalises each column's float32
logits and counts each sampled token, then writes the rows back.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from smg_tpu_torch.engine.config import EngineConfig
from smg_tpu_torch.engine.graphs import GraphCache, Megastep
from smg_tpu_torch.engine.kv_cache import KvCacheSpec, create_kv_buffers, plan_cache
from smg_tpu_torch.engine.sampling import apply_penalties, pick_sampler
from smg_tpu_torch.models.llama import LlamaModel, init_params
from smg_tpu_torch.ops.cuda import decode_attention


def resolve_device(device) -> torch.device:
    """``None`` means the card.  No silent CPU fallback: without CUDA the
    caller must ask for ``device="cpu"`` explicitly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; smg_tpu_torch runs on the GPU by "
                "default — pass device='cpu' explicitly to run on the CPU"
            )
        device = "cuda"
    return torch.device(device)


class DecodeState:
    """Host-side decode inputs of one batch composition (port of the JAX
    runner's ``DecodeState``).  The scheduler rebuilds the sampling
    parameters and stop state only when ``lane_sig`` (bucket, loop width,
    stop-id width, lanes and their admission serials) changes, and the
    page tables only when ``pt_sig`` does; each megastep shape copies them
    into its persistent device buffers only when its own copy is older
    (``graphs.Megastep.load``).  Steady-state launches upload positions and
    the sampling counter, and chain their tokens on the device."""

    __slots__ = ("lane_sig", "temps", "topks", "topps", "minps",
                 "stop_ids", "limits", "live", "slot_idx", "freqs", "pres", "reps",
                 "pt_sig", "page_tables")

    def __init__(self):
        self.lane_sig = self.pt_sig = None
        self.temps = self.topks = self.topps = self.minps = None
        # stop state ([B, E] ids -1 padded, [B] absolute total-length
        # limits, [B] real-lane mask; padded rows start done), None at E=0
        self.stop_ids = self.limits = self.live = None
        # penalties ([B] slot rows, S for padded rows; [B] scalars), None
        # when no lane of the composition has penalties
        self.slot_idx = self.freqs = self.pres = self.reps = None
        self.page_tables = None

    @property
    def use_pen(self) -> bool:
        return self.slot_idx is not None

    @classmethod
    def of(cls, page_tables, temps, topks, topps, minps, stop_state=None,
           pen=None) -> "DecodeState":
        """A one-off state from raw arrays (a fresh signature each call);
        ``pen`` = (slot_idx, freqs, pres, reps)."""
        ds = cls()
        ds.lane_sig = ds.pt_sig = object()
        ds.page_tables = np.ascontiguousarray(page_tables, np.int32)
        ds.temps = np.asarray(temps, np.float32)
        ds.topks = np.asarray(topks, np.int64)
        ds.topps = np.asarray(topps, np.float32)
        ds.minps = np.asarray(minps, np.float32)
        if stop_state is not None:
            ds.stop_ids = np.asarray(stop_state[0], np.int64)
            ds.limits = np.asarray(stop_state[1], np.int64)
            ds.live = np.asarray(stop_state[2], bool)
        if pen is not None:
            ds.slot_idx = np.asarray(pen[0], np.int64)
            ds.freqs, ds.pres, ds.reps = (np.asarray(x, np.float32) for x in pen[1:])
        return ds


@dataclass
class DecodeLaunch:
    """A dispatched megastep: host buffers its results land in, the event
    that marks their arrival, and the last sampled column on the device (the
    input a chained lookahead launch reads)."""

    toks: torch.Tensor  # [B, K] int64, host (pinned on the card)
    lps: torch.Tensor  # [B, K] float32, host
    steps_run: torch.Tensor  # [1] int64, host
    last_col: torch.Tensor  # [B] int64, device
    event: "torch.cuda.Event | None"


class ModelRunner:
    def __init__(self, config: EngineConfig, params: dict | None = None,
                 device=None, attention: str = "kernel"):
        self.config = config
        self.model_cfg = config.model
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(config.seed)
            params = init_params(self.model_cfg, gen, self.device)
        else:
            params = _to_device(params, self.device)
        self.model = LlamaModel(self.model_cfg, params, attention=attention)
        free = None
        if self.device.type == "cuda":
            free = torch.cuda.mem_get_info(self.device)[0]  # weights already resident
        self.spec: KvCacheSpec = plan_cache(self.model_cfg, config.cache, free)
        self.k_cache, self.v_cache = create_kv_buffers(self.spec, self.device)
        self.max_pages_per_seq = math.ceil(
            config.scheduler.max_seq_len / config.cache.page_size)
        # the sampler's noise is a function of (seed, counter, row): the
        # counter advances once per sampling step, so a discarded launch
        # rewinds it with integer arithmetic (rng_mark / rng_restore)
        self.sample_seed = config.seed ^ 0x5EED
        self._step = 0
        self.graphs = GraphCache(self.device, config.decode_graphs)
        self._counters = None  # decode kernel arrival counters (card, kernel path)
        # penalty slot state, created at the first penalised launch (most
        # workloads never set a penalty): [S+1, V] int32 output counts and
        # bool prompt masks; row S is the garbage row of padded decode rows
        self._counts_buf: torch.Tensor | None = None
        self._pmask_buf: torch.Tensor | None = None
        # what the schedule asked of the device: forward calls, rows and
        # tokens of prefill; megastep launches and decode columns computed
        self.stats = dict(prefill_calls=0, prefill_rows=0, prefill_tokens=0,
                          decode_calls=0, decode_columns=0)

    # ---- sampling counter ----

    def rng_mark(self) -> int:
        """The sampling counter before a launch; ``rng_restore`` rewinds to
        it when the launch is discarded, so the replacement samples with the
        counters the synchronous schedule would have used."""
        return self._step

    def rng_restore(self, mark: int) -> None:
        self._step = mark

    def _next_counter(self) -> int:
        self._step += 1
        return self._step

    def _consume_folds(self, n: int) -> int:
        """Advance the counter by ``n`` (one per megastep column: column j
        samples with mark + 1 + j, the counter the single-step schedule uses
        at that step); returns the mark before the advance."""
        mark = self._step
        self._step += n
        return mark

    # ---- penalty slot state ----

    def _ensure_penalty_buffers(self) -> None:
        if self._counts_buf is None:
            S = self.config.scheduler.max_batch_size
            V = self.model_cfg.vocab_size
            self._counts_buf = torch.zeros((S + 1, V), dtype=torch.int32, device=self.device)
            self._pmask_buf = torch.zeros((S + 1, V), dtype=torch.bool, device=self.device)

    def penalty_state(self, prompt_ids: list[int], output_ids: list[int]
                      ) -> tuple[np.ndarray, np.ndarray]:
        """Host-side (counts [V] int32, prompt_mask [V] bool) for a request."""
        V = self.model_cfg.vocab_size
        ids = np.asarray([t for t in output_ids if 0 <= t < V], np.int64)
        counts = np.bincount(ids, minlength=V).astype(np.int32)
        pmask = np.zeros(V, bool)
        pmask[[t for t in prompt_ids if 0 <= t < V]] = True
        return counts, pmask

    def sync_slot_penalty_state(self, slot: int, prompt_ids: list[int],
                                output_ids: list[int]) -> None:
        """(Re)derive a decode slot's penalty row from the host after
        admission, preemption or a discarded launch; from then on the
        megastep counts on the device.  Rows are written in place (stream-
        ordered after any launch already enqueued)."""
        self._ensure_penalty_buffers()
        counts, pmask = self.penalty_state(prompt_ids, output_ids)
        self._counts_buf[slot].copy_(torch.from_numpy(counts), non_blocking=True)
        self._pmask_buf[slot].copy_(torch.from_numpy(pmask), non_blocking=True)

    # ---- host -> device packing ----

    def _i32(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.int32), device=self.device)

    def _f32(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def _check_chunk(self, n: int, prefix_len: int, mp: int) -> None:
        ps = self.config.cache.page_size
        if prefix_len + n > mp * ps:
            raise ValueError(
                f"prefill chunk overruns page table: prefix {prefix_len} + "
                f"chunk {n} > {mp} pages * {ps}")

    # ---- prefill ----

    def prefill(self, token_ids: list[int], prefix_len: int, page_table: np.ndarray,
                temperature: float, top_k: int, top_p: float, min_p: float,
                pen: tuple | None = None, mask: np.ndarray | None = None
                ) -> tuple[int, float]:
        """Run one (final) prefill chunk; returns (sampled_token, logprob).
        ``pen`` = (counts [V], prompt_mask [V], freq, pres, rep); ``mask``
        [V] bool, the sampleable vocabulary."""
        if pen is not None:
            counts, pmask, freq, pres, rep = pen
            pen = (counts[None], pmask[None], [freq], [pres], [rep])
        toks, lps = self.prefill_batched(
            [(token_ids, prefix_len, page_table)], [temperature], [top_k],
            [top_p], [min_p], pen=pen, mask=None if mask is None else mask[None])
        return int(toks[0]), float(lps[0])

    def prefill_extend(self, token_ids: list[int], prefix_len: int,
                       page_table: np.ndarray) -> None:
        """Write one NON-final chunk's KV: nothing is sampled."""
        self._check_chunk(len(token_ids), prefix_len, len(page_table))
        self.model.forward_prefill(
            self._i32(token_ids), self._i32([prefix_len]), self._i32([len(token_ids)]),
            self.k_cache, self.v_cache, self._i32(page_table), compute_logits=False)
        self._count_prefill(1, len(token_ids))

    def prefill_batched(self, chunks, temps, topks, topps, minps,
                        pen: tuple | None = None, mask: np.ndarray | None = None
                        ) -> tuple[np.ndarray, np.ndarray]:
        """Prefill several sequences' final chunks in one forward.  ``chunks``
        is a list of (token_ids, prefix_len, page_table_row); rows are padded
        to the longest chunk.  Returns (tokens [G], logprobs [G]).  One
        sampling step for the call: row i's noise is row i's.  ``pen`` =
        (counts [G, V], prompt_masks [G, V], freqs, pres, reps) penalises
        the float32 logits; ``mask`` [G, V] bool restricts the vocabulary."""
        G = len(chunks)
        T = max(len(c[0]) for c in chunks)
        mp = len(chunks[0][2])
        tokens = np.zeros((G, T), np.int32)
        prefix_lens = np.zeros(G, np.int32)
        t_reals = np.zeros(G, np.int32)
        page_tables = np.zeros((G, mp), np.int32)
        for i, (ids, pfx, row) in enumerate(chunks):
            self._check_chunk(len(ids), pfx, mp)
            tokens[i, : len(ids)] = ids
            prefix_lens[i] = pfx
            t_reals[i] = len(ids)
            page_tables[i] = row
        logits = self.model.forward_prefill_batched(
            self._i32(tokens), self._i32(prefix_lens), self._i32(t_reals),
            self.k_cache, self.v_cache, self._i32(page_tables))
        if pen is not None:
            counts, pmask, freqs, pres, reps = pen
            logits = apply_penalties(
                logits, torch.as_tensor(np.asarray(counts, np.int32), device=self.device),
                torch.as_tensor(np.asarray(pmask, bool), device=self.device),
                self._f32(freqs), self._f32(pres), self._f32(reps))
        dmask = None if mask is None else torch.as_tensor(np.asarray(mask, bool),
                                                          device=self.device)
        toks, lps = pick_sampler()(logits, self.sample_seed, self._next_counter(),
                                   self._f32(temps), self._i32(topks), self._f32(topps),
                                   self._f32(minps), mask=dmask)
        self._count_prefill(G, int(t_reals.sum()))
        return toks.cpu().numpy(), lps.cpu().numpy()  # the blocking fetch

    def _count_prefill(self, rows: int, tokens: int) -> None:
        self.stats["prefill_calls"] += 1
        self.stats["prefill_rows"] += rows
        self.stats["prefill_tokens"] += tokens

    # ---- decode megastep ----

    def decode_multi_async(self, tokens, positions: np.ndarray, ds: DecodeState,
                           num_steps: int, mask: np.ndarray | None = None) -> DecodeLaunch:
        """Dispatch a ``num_steps``-column megastep and return without a host
        sync.  ``tokens`` is a host [B] array or a device column (a lookahead
        chaining from the previous launch); ``positions`` [B] are the cache
        token counts at entry (padded rows: ``mp * page_size``, which lands
        their KV on the garbage page).  The launch consumes ``num_steps``
        sampling counters; all columns run (there is no device-side exit),
        and ``steps_run`` says where the first live lane finished, as the
        JAX megastep's loop exit does.  ``ds.slot_idx`` set turns penalties
        on (rows read from and written back to the runner's buffers);
        ``mask`` [B, V] bool restricts each row's vocabulary."""
        B, mp = ds.page_tables.shape
        E = ds.stop_ids.shape[1] if (num_steps > 1 and ds.stop_ids is not None) else 0
        if ds.use_pen:
            self._ensure_penalty_buffers()  # before any capture reads them
        step = self.graphs.get(B, mp, num_steps, E, ds.use_pen, mask is not None,
                               self.model_cfg.vocab_size)
        step.load(ds, tokens, positions, self._consume_folds(num_steps), mask)
        if self._counters is None and self.device.type == "cuda" \
                and self.model.attention == "kernel":
            cfg = self.model_cfg
            self._counters = torch.zeros(decode_attention.counter_ints(
                self.k_cache.dtype, max(self.config.scheduler.decode_batch_buckets),
                cfg.num_heads, cfg.num_kv_heads, cfg.head_dim),
                dtype=torch.int32, device=self.device)
        toks, lps, steps_run = self.graphs.run(step, self._megastep)
        self.stats["decode_calls"] += 1
        self.stats["decode_columns"] += num_steps
        last_col = toks[:, num_steps - 1].clone()
        if self.device.type != "cuda":
            return DecodeLaunch(toks, lps, steps_run, last_col, None)
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in (toks, lps, steps_run)]
        for h, t in zip(host, (toks, lps, steps_run)):
            h.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return DecodeLaunch(*host, last_col, event)

    def decode_fetch(self, launch: DecodeLaunch) -> tuple[np.ndarray, np.ndarray, int]:
        """Wait for a launch's results: (tokens [B, K], logprobs [B, K],
        steps_run) — the one blocking fetch of a step."""
        if launch.event is not None:
            launch.event.synchronize()
        return launch.toks.numpy(), launch.lps.numpy(), int(launch.steps_run[0])

    def decode_multi(self, tokens: np.ndarray, positions: np.ndarray,
                     page_tables: np.ndarray, temps, topks, topps, minps,
                     num_steps: int, stop_state: tuple | None = None,
                     pen: tuple | None = None, mask: np.ndarray | None = None
                     ) -> tuple[np.ndarray, np.ndarray]:
        """Launch plus fetch.  Returns (tokens [B, n], logprobs [B, n]) with n
        the reference's ``steps_run``; ``stop_state`` = (stop_ids [B, E] -1
        padded, limits [B] absolute total-length caps, live [B] real-lane
        mask); None never stops early.  ``pen`` = (slot_idx [B], freqs [B],
        pres [B], reps [B]) over the runner's penalty rows; ``mask`` [B, V]."""
        ds = DecodeState.of(page_tables, temps, topks, topps, minps, stop_state, pen)
        toks, lps, n = self.decode_fetch(self.decode_multi_async(
            tokens, positions, ds, num_steps, mask))
        return toks[:, :n], lps[:, :n]

    def _megastep(self, st: Megastep) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The megastep on ``st``'s device inputs: K columns against the
        frozen cache (each column's K/V land in per-layer side buffers
        ``[L, B, K, K*D]``), the penalties, the sampler and the device stop
        mask per column, and one scatter that lands the horizon.  KV of
        columns past ``steps_run``, and of positions past the table, goes to
        the garbage page, as in the JAX megastep.  The JAX loop never
        computes a column past the first finish, so here column j's token
        counts only while no real lane finished before column j: the counts
        written back are those of the accepted tokens.  No host sync and no
        host tensor, so a CUDA graph can capture it."""
        cfg = self.model_cfg
        B, mp, N = st.B, st.mp, st.K
        L, KD = cfg.num_layers, cfg.num_kv_heads * cfg.head_dim
        ps = self.spec.page_size
        dev = self.device
        entry = st.entry
        hk = torch.zeros((L, B, N, KD), dtype=self.k_cache.dtype, device=dev)
        hv = torch.zeros_like(hk)
        toks_out = torch.zeros((B, N), dtype=torch.int64, device=dev)
        lps_out = torch.zeros((B, N), dtype=torch.float32, device=dev)
        steps_run = torch.full((1,), N, dtype=torch.int64, device=dev)
        if st.E:
            done = ~st.live  # padded lanes start done and never gate the exit
        if st.use_pen:
            counts = self._counts_buf.index_select(0, st.slot_idx)  # [B, V] int32
            pmask = self._pmask_buf.index_select(0, st.slot_idx)
        sampler = pick_sampler()
        cur = st.tokens
        for j in range(N):
            logits = self.model.forward_decode_horizon(
                cur, entry + j, entry, j, self.k_cache, self.v_cache, st.page_tables,
                hk, hv, counters=self._counters)
            if st.use_pen:
                logits = apply_penalties(logits, counts, pmask, st.freqs, st.pres, st.reps)
            new, lps = sampler(logits, self.sample_seed, st.counter + (1 + j),
                               st.temps, st.topks, st.topps, st.minps, mask=st.mask)
            toks_out[:, j] = new
            lps_out[:, j] = lps
            if st.use_pen:
                # columns past the first finish are never accepted
                inc = (steps_run == N).int() if (st.E and j) else torch.ones(
                    1, dtype=torch.int32, device=dev)
                counts.scatter_add_(1, new[:, None], inc.expand(B, 1))
            if st.E:
                # length finish: total_len after accepting column j is
                # entry + j + 2, so the lane is done once entry + j >= limit - 2
                done = done | (new[:, None] == st.stop_ids).any(dim=1) | (
                    entry.long() + j >= st.limits - 2)
                first = (done & st.live).any() & (steps_run == N)
                steps_run = torch.where(first, j + 1, steps_run)
            cur = new
        cols = torch.arange(N, device=dev)[None, :]
        pos = entry.long()[:, None] + cols
        valid = (pos < mp * ps) & (cols < steps_run)
        pos_c = pos.clamp(max=mp * ps - 1)
        page = torch.gather(st.page_tables.long(), 1, pos_c // ps)
        dest = torch.where(valid, page * ps + pos_c % ps, 0).reshape(-1)
        P = self.k_cache.shape[1]
        self.k_cache.view(L, P * ps, KD).index_copy_(1, dest, hk.reshape(L, B * N, KD))
        self.v_cache.view(L, P * ps, KD).index_copy_(1, dest, hv.reshape(L, B * N, KD))
        if st.use_pen:
            # in place: graphs hold the buffer's address.  Padded rows all
            # write the garbage row S, the one row duplicates may share
            self._counts_buf.index_copy_(0, st.slot_idx, counts)
        return toks_out, lps_out, steps_run

    def flush_cache_buffers(self) -> None:
        """Zero the KV buffers in place (flush_cache, after the radix reset):
        the captured graphs hold their addresses."""
        self.k_cache.zero_()
        self.v_cache.zero_()


def _to_device(params: dict, device: torch.device) -> dict:
    out = {k: v.to(device) for k, v in params.items() if k != "layers"}
    out["layers"] = {k: v.to(device) for k, v in params["layers"].items()}
    return out
