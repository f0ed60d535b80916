"""ModelRunner: owns the weights, the KV buffers, the sampler's counter and
the decode megasteps (port of ``smg_tpu/engine/runner.py``'s serving path).

Entry points run on the card: ``device=None`` resolves to ``cuda`` and a
machine without one raises; the CPU is used only when the caller asks for
it (the tests do).  Prefill runs eagerly at its exact shapes.  Decode runs
as megasteps at bucketed shapes; on the card each shape is replayed from a
CUDA graph (``engine/graphs.py``) unless the configuration asks for eager
launches (``EngineConfig.decode_graphs=False``); the CPU always runs them
eagerly.  Cache writes are in place, so the JAX runner's donation policy
and sharding have no counterpart.  Its program auditor does: every graph
family registers with ``self._programs`` (``analysis/runtime_guards.py``
``ProgramAuditor``), which, armed after warmup, records each launch's
inputs (the graph's static buffers and the KV cache) and audits device
placement, storage kept across replays and capture provenance
(``program_audit``); ``invalidate_graphs`` drops shapes and forgets their
records.

Penalties keep per-slot state on the device, as the JAX runner does: a
``[S+1, V]`` int32 count buffer and a bool prompt-mask buffer (row S is the
garbage row of padded decode rows), created at the first penalised launch
and written only in place, since CUDA graphs hold their addresses.  The
megastep reads the rows of its lanes, penalises each column's float32
logits and counts each sampled token, then writes the rows back.

Speculative verify blocks (``decode_spec_async``, the reference's
``_decode_spec_fn``) score every lane's drafts in one forward, accept on the
device and land only the accepted columns' KV; on the card each (B, mp, W)
shape is replayed from a CUDA graph of its own, under the same
``decode_graphs`` switch.

LoRA (the reference's adapter bank, ``runner.py:471-537``): adapters live
in one ``models/lora.py::LoraBank`` of ``max_loras + 1`` slots (slot 0 =
no adapter), created at the first load with that adapter's rank and
written in place by every load and unload, so graphs that read it stay
valid.  A prefill or megastep with any adapter row takes the bank and a
slot index per row; the megastep's key gains ``use_lora`` and its slot
indices are a static input, loaded with the lane composition.

Multimodal (the reference's ``use_embeds``/``use_mrope`` programs): a
prefill row may carry the vision tower's embeddings for its placeholder
positions (``mm`` = (dense [t, E] float32, mask [t] bool)) and M-RoPE ids
(``[3, t]``; a text row of the same call rotates by three copies of its
sequential position, which is exactly standard rope).  A megastep or verify
block with an M-RoPE lane takes a per-row decode offset: its key gains
``use_mrope`` and the offsets are a static input buffer, zero for text
rows, loaded with the lane composition (the verify block's at every
launch), so a replayed graph reads the offsets of the lanes it runs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from smg_tpu_torch.analysis.runtime_guards import ProgramAuditor
from smg_tpu_torch.engine.config import EngineConfig
from smg_tpu_torch.engine.graphs import GraphCache, Megastep, VerifyStep
from smg_tpu_torch.engine.kv_cache import (
    KvCacheSpec,
    create_kv_buffers,
    moe_reserve_bytes,
    plan_cache,
    vision_reserve_bytes,
)
from smg_tpu_torch.engine.sampling import apply_penalties, pick_sampler, spec_accept_sample
from smg_tpu_torch.models.llama import LlamaModel, init_params
from smg_tpu_torch.models.lora import LoraBank, canonical_keys, validate_adapter
from smg_tpu_torch.ops.cuda import decode_attention
from smg_tpu_torch.parallel.sharding import RankPlace, Sharder, rank_config, shard_params
from smg_tpu_torch.utils import get_logger

logger = get_logger("engine.runner")


def resolve_device(device) -> torch.device:
    """``None`` means the card.  No silent CPU fallback: without CUDA the
    caller must ask for ``device="cpu"`` explicitly."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; smg_tpu_torch runs on the GPU by "
            "default — pass device='cpu' explicitly to run on the CPU"
        )
    return device


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
                 "lora_idx", "rope_delta", "pt_sig", "page_tables")

    def __init__(self):
        self.lane_sig = self.pt_sig = None
        self.temps = self.topks = self.topps = self.minps = None
        # stop state ([B, E] ids -1 padded, [B] absolute total-length
        # limits, [B] real-lane mask; padded rows start done), None at E=0
        self.stop_ids = self.limits = self.live = None
        # penalties ([B] slot rows, S for padded rows; [B] scalars), None
        # when no lane of the composition has penalties
        self.slot_idx = self.freqs = self.pres = self.reps = None
        # [B] adapter slot per row (0 = none, padded rows 0), None when no
        # lane of the composition has an adapter
        self.lora_idx = None
        # [B] M-RoPE decode offset per row (text and padded rows 0), None
        # when no lane of the composition has one
        self.rope_delta = None
        self.page_tables = None

    @property
    def use_pen(self) -> bool:
        return self.slot_idx is not None

    @property
    def use_mrope(self) -> bool:
        return self.rope_delta is not None

    @classmethod
    def of(cls, page_tables, temps, topks, topps, minps, stop_state=None,
           pen=None, lora_idx=None, rope_delta=None) -> "DecodeState":
        """A one-off state from raw arrays (a fresh signature each call);
        ``pen`` = (slot_idx, freqs, pres, reps); ``lora_idx`` and
        ``rope_delta`` [B]."""
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
        if lora_idx is not None:
            ds.lora_idx = np.asarray(lora_idx, np.int64)
        if rope_delta is not None:
            ds.rope_delta = np.asarray(rope_delta, np.int32)
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


@dataclass
class SpecLaunch:
    """A dispatched verify block: host buffers its results land in and the
    event that marks their arrival."""

    toks: torch.Tensor  # [B, W] int64 emitted rows, host
    lps: torch.Tensor  # [B, W] float32, host
    n_emit: torch.Tensor  # [B] int64, host: lane b's tokens are toks[b, :n_emit[b]]
    event: "torch.cuda.Event | None"


class ModelRunner:
    def __init__(self, config: EngineConfig, params: dict | None = None,
                 device=None, attention: str = "kernel", groups=None):
        """``groups`` (``parallel/group.py::RankGroups``) makes this a rank
        of a rank-mesh engine, at ``groups.coords`` on its grid: it holds its
        shard of the weights (``params`` the whole model, or None for weights
        from the seed, drawn whole and cut piece by piece; a pp stage's
        layers, an ep rank's experts, a tp rank's heads and columns), computes
        with the rank's config (``model_cfg``) and sizes its KV cache by the
        rank's layers and KV heads, all ranks agreeing on the page count."""
        self.config = config
        self.groups = groups
        par = config.parallel
        if groups is None:
            self.place = RankPlace()
        else:
            self.place = RankPlace.of(par.axis_sizes(), groups.coords)
        tp, pp, ep = self.place.tp, self.place.pp, self.place.ep
        self.model_cfg = (config.model if groups is None
                          else rank_config(config.model, tp, pp, ep))
        self.device = resolve_device(device)
        shard = None if groups is None else Sharder(config.model, self.place)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(config.seed)
            params = (init_params(config.model, gen, self.device) if shard is None
                      else init_params(config.model, gen, self.device, shard=shard))
        else:
            if shard is not None:
                params = shard_params(params, config.model, place=self.place)[1]
            params = _to_device(params, self.device)
        axis = (lambda name: None) if groups is None else groups.axis
        self.model = LlamaModel(self.model_cfg, params, attention=attention, tp=axis("tp"),
                                pp=axis("pp"), sp=axis("sp"), ep=axis("ep"))
        free = None
        if self.device.type == "cuda":
            # weights already resident; blocks the allocator caches but no
            # tensor holds (an earlier engine's, a widened dtype's) count as free
            torch.cuda.empty_cache()
            if groups is not None:
                groups.barrier()  # every rank's weights resident before the read
            free = torch.cuda.mem_get_info(self.device)[0]
            if groups is not None:  # ranks sharing the card share its free memory
                free //= groups.ranks_on_device
        self.free_bytes = free  # the free figure the KV plan read (None on the CPU)
        # the expert layer's scratch and the vision tower's peak at the
        # largest image are set aside before KV is sized
        self.reserve_bytes = (moe_reserve_bytes(self.model_cfg, config.scheduler)
                              + vision_reserve_bytes(self.model_cfg))
        self.spec: KvCacheSpec = plan_cache(config.model, config.cache, free,
                                            draft=config.draft_model,
                                            reserve_bytes=self.reserve_bytes, tp=tp, pp=pp)
        if groups is not None:  # every rank's cache holds the page pool rank 0 hands out
            self.spec.num_pages = groups.min_int(self.spec.num_pages)
        self.k_cache, self.v_cache = create_kv_buffers(self.spec, self.device)
        # mesh topology, fixed at construction: the device count the metrics
        # gauge and the flight ring read, and the loads() snapshot
        self.mesh_devices = par.world_size if groups is not None else 1
        self._mesh_info = {
            "devices": self.mesh_devices, "shape": par.axis_sizes(),
            "platform": self.device.type,
            "backend": groups.backend if groups is not None else None,
        }
        # what each prefill call ran, by the reference's compile-key layout
        # (``("prefill", T, mp, impl, use_pen, use_mask, use_lora, use_ring,
        # use_embeds, use_mrope)``, ``("prefill_extend", T, mp, impl,
        # use_lora, use_ring, use_embeds, use_mrope)``, T the chunk's prefill
        # bucket); the port compiles nothing, the keys say which path each
        # chunk took
        self.prefill_keys: set[tuple] = set()
        self.max_pages_per_seq = math.ceil(
            config.scheduler.max_seq_len / config.cache.page_size)
        # the sampler's noise is a function of (seed, counter, row): the
        # counter advances once per sampling step, so a discarded launch
        # rewinds it with integer arithmetic (rng_mark / rng_restore)
        self.sample_seed = config.seed ^ 0x5EED
        self._step = 0
        # every graph family's launches, once armed (program_audit)
        self._programs = ProgramAuditor(self.device, shared=("k_cache", "v_cache"))
        self.graphs = GraphCache(self.device, config.decode_graphs, programs=self._programs)
        self._counters = None  # decode kernel arrival counters (card, kernel path)
        # penalty slot state, created at the first penalised launch (most
        # workloads never set a penalty): [S+1, V] int32 output counts and
        # bool prompt masks; row S is the garbage row of padded decode rows
        self._counts_buf: torch.Tensor | None = None
        self._pmask_buf: torch.Tensor | None = None
        self._lora_bank: LoraBank | None = None  # created at the first load
        self._lora_names: dict[str, int] = {}
        # what the schedule asked of the device: forward calls, rows and
        # tokens of prefill (and of those, the calls that ring-attended over
        # sp, with no prefill kernel); megastep launches and decode columns
        # computed; verify blocks
        self.stats = dict(prefill_calls=0, prefill_rows=0, prefill_tokens=0, ring_calls=0,
                          decode_calls=0, decode_columns=0, verify_calls=0)
        # PD handoffs by leg and route (export_pages*/import_pages*)
        self.kv_handoffs = dict(export_host=0, export_device=0, import_host=0,
                                import_device=0)

    @property
    def use_pp(self) -> bool:
        """A pipeline stage: such an engine never speculates (the scheduler's
        ``_partition_spec``), as in the reference."""
        return self.place.pp > 1

    def mesh_info(self) -> dict:
        """Mesh topology for ``loads()`` and ``/scheduler``: device count,
        the five axes' sizes, the platform and the device group's backend
        (None on one device); a copy."""
        return {**self._mesh_info, "shape": dict(self._mesh_info["shape"])}

    # ---- graph families: audit and invalidation ----

    def _graph_inputs(self, step) -> dict:
        """What a launch of ``step`` reads at fixed addresses: its static
        buffers, the KV cache and, with penalties, the slot rows."""
        inputs = dict(step.buffers, k_cache=self.k_cache, v_cache=self.v_cache)
        if getattr(step, "use_pen", False):
            inputs.update(counts=self._counts_buf, prompt_mask=self._pmask_buf)
        return inputs

    def invalidate_graphs(self, kind: str | None = None) -> None:
        """Drop graph shapes (all, or the ``"decode"`` or ``"verify"``
        family) and forget their audit records; the next launch of a shape
        captures it again."""
        self._programs.forget(self.graphs.drop(kind))

    def program_audit(self) -> dict:
        """Audit every recorded graph family (``ProgramAuditor.audit``): arm
        ``self._programs`` after warmup, run steady-state traffic, then call
        this; ``report["clean"]`` asserts every input on this device, no
        storage moved between launches and every capture explained."""
        return self._programs.audit()

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

    # ---- LoRA bank (multi-adapter serving; see models/lora.py) ----

    @property
    def lora_slots(self) -> int:
        return self.config.max_loras + 1  # slot 0 = no adapter

    def lora_index(self, name: str) -> int:
        try:
            return self._lora_names[name]
        except KeyError:
            raise ValueError(f"unknown LoRA adapter {name!r}") from None

    def list_loras(self) -> list[str]:
        return sorted(self._lora_names)

    def load_lora(self, name: str, weights: dict) -> int:
        """Install (or replace) an adapter in the bank; returns its slot.
        The first load creates the bank at its adapter's rank; a smaller
        rank is zero-padded, a larger one refused."""
        if self.place.pp > 1:  # the stage's layers of each matrix, as its weights
            a, b = self.place.layers(self.config.model)
            weights = {k: (v[a:b] if k in canonical_keys() else v) for k, v in weights.items()}
        rank = validate_adapter(self.model_cfg, weights)
        if self._lora_bank is None:
            self._lora_bank = LoraBank(self.model_cfg, self.lora_slots, rank,
                                       self.model.dtype, self.device)
        if rank > self._lora_bank.rank:
            raise ValueError(
                f"adapter rank {rank} exceeds bank rank {self._lora_bank.rank} "
                f"(first-loaded adapter fixes the bank rank)")
        idx = self._lora_names.get(name)
        if idx is None:
            used = set(self._lora_names.values())
            free = [i for i in range(1, self.lora_slots) if i not in used]
            if not free:
                raise ValueError(f"LoRA bank full ({self.lora_slots - 1} slots)")
            idx = free[0]
        # canonical keys only; ignore npz extras
        self._lora_bank.write(idx, {k: weights[k] for k in canonical_keys()})
        self._lora_names[name] = idx
        logger.info("lora adapter %r -> slot %d (rank %d)", name, idx, rank)
        return idx

    def unload_lora(self, name: str) -> bool:
        idx = self._lora_names.pop(name, None)
        if idx is None:
            return False
        self._lora_bank.write(idx, None)
        return True

    def _lora_args(self, lora_idx) -> dict:
        """The forward's adapter arguments for per-row slots ``lora_idx``:
        none when no row has an adapter (or nothing was ever loaded)."""
        if self._lora_bank is None or lora_idx is None or not np.any(lora_idx):
            return {}
        return dict(lora=self._lora_bank,
                    lora_idx=torch.as_tensor(np.asarray(lora_idx, np.int64),
                                             device=self.device))

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
                pen: tuple | None = None, mask: np.ndarray | None = None,
                lora_idx: int = 0, mm: tuple | None = None,
                rope_pos: np.ndarray | None = None) -> tuple[int, float]:
        """Run one (final) prefill chunk; returns (sampled_token, logprob).
        ``pen`` = (counts [V], prompt_mask [V], freq, pres, rep); ``mask``
        [V] bool, the sampleable vocabulary; ``lora_idx`` the adapter slot
        (0 = none); ``mm`` = (embeds [t, E] float32, emask [t] bool), the
        multimodal splice; ``rope_pos`` [3, t] M-RoPE position ids."""
        if pen is not None:
            counts, pmask, freq, pres, rep = pen
            pen = (counts[None], pmask[None], [freq], [pres], [rep])
        ring = self._use_ring(len(token_ids), prefix_len, rope_pos)
        toks, lps = self._prefill_rows(
            [(token_ids, prefix_len, page_table)], [temperature], [top_k],
            [top_p], [min_p], pen=pen, mask=None if mask is None else mask[None],
            lora_idx=[lora_idx], mm=None if mm is None else [mm],
            rope=None if rope_pos is None else [rope_pos], ring=ring)
        return int(toks[0]), float(lps[0])

    def _use_ring(self, n: int, prefix_len: int, rope_pos) -> bool:
        """The reference's sequence-parallel rule (``runner.py``
        ``_prefill_chunk_prep``): an sp engine ring-attends a cold chunk (no
        cached prefix: the chunk is the whole context) whose prefill bucket
        sp divides, unless it is a pipeline stage or the chunk carries
        M-RoPE ids.  Warm chunks, and decode, take the kernels on every
        rank."""
        sp = self.config.parallel.sp
        return (self.groups is not None and sp > 1 and prefix_len == 0
                and self.config.scheduler.prefill_bucket(n) % sp == 0
                and not self.use_pp and rope_pos is None)

    def _impl(self, ring: bool) -> str:
        return "ring" if ring else self.model.attention

    def prefill_extend(self, token_ids: list[int], prefix_len: int,
                       page_table: np.ndarray, lora_idx: int = 0, mm: tuple | None = None,
                       rope_pos: np.ndarray | None = None) -> None:
        """Write one NON-final chunk's KV: nothing is sampled."""
        n = len(token_ids)
        self._check_chunk(n, prefix_len, len(page_table))
        ring = self._use_ring(n, prefix_len, rope_pos)
        lora = self._lora_args([lora_idx])
        mm_args = self._mm_args(None if mm is None else [mm],
                                None if rope_pos is None else [rope_pos],
                                np.array([prefix_len]), n)
        self.prefill_keys.add(("prefill_extend", self.config.scheduler.prefill_bucket(n),
                               len(page_table), self._impl(ring),
                               bool(lora), ring, "input_embeds" in mm_args,
                               "rope_pos" in mm_args))
        self.model.forward_prefill_batched(
            self._i32([token_ids]), self._i32([prefix_len]), self._i32([n]),
            self.k_cache, self.v_cache, self._i32([page_table]), compute_logits=False,
            ring=ring, **lora, **mm_args)
        self._count_prefill(1, n, ring)

    def _mm_args(self, mm, rope, prefix_lens: np.ndarray, T: int) -> dict:
        """The forward's multimodal arguments for per-row ``mm`` = (dense
        [t, E], mask [t]) and ``rope`` [3, t] (None entries: text rows),
        padded to ``T``: the splice ``input_embeds`` [G, T, E] float32 and
        ``embeds_mask`` [G, T], and ``rope_pos`` [G, 3, T] whose text rows
        hold three copies of the sequential position."""
        out = {}
        G = len(prefix_lens)
        if mm is not None and any(m is not None for m in mm):
            E = next(m[0].shape[1] for m in mm if m is not None)
            dense = np.zeros((G, T, E), np.float32)
            emask = np.zeros((G, T), bool)
            for i, m in enumerate(mm):
                if m is not None:
                    dense[i, : m[0].shape[0]] = m[0]
                    emask[i, : m[1].shape[0]] = m[1]
            out["input_embeds"] = torch.as_tensor(dense, device=self.device)
            out["embeds_mask"] = torch.as_tensor(emask, device=self.device)
        if rope is not None and any(r is not None for r in rope):
            rp = np.broadcast_to(
                (np.asarray(prefix_lens, np.int64)[:, None] + np.arange(T))[:, None, :],
                (G, 3, T)).astype(np.int32)
            for i, r in enumerate(rope):
                if r is not None:
                    rp[i, :, : r.shape[1]] = r
            out["rope_pos"] = torch.as_tensor(rp, device=self.device)
        return out

    def prefill_batched(self, chunks, temps, topks, topps, minps,
                        pen: tuple | None = None, mask: np.ndarray | None = None,
                        lora_idx=None, mm: list | None = None,
                        rope: list | None = None) -> tuple[np.ndarray, np.ndarray]:
        """Prefill several sequences' final chunks in one forward.  ``chunks``
        is a list of (token_ids, prefix_len, page_table_row); rows are padded
        to the longest chunk.  Returns (tokens [G], logprobs [G]).  One
        sampling step for the call: row i's noise is row i's.  ``pen`` =
        (counts [G, V], prompt_masks [G, V], freqs, pres, reps) penalises
        the float32 logits; ``mask`` [G, V] bool restricts the vocabulary;
        ``lora_idx`` [G] the rows' adapter slots (None: no adapter); ``mm``
        and ``rope`` per row (dense [t, E], mask [t]) and [3, t] M-RoPE ids,
        None for a text row (both None: no row has any)."""
        return self._prefill_rows(chunks, temps, topks, topps, minps, pen=pen, mask=mask,
                                  lora_idx=lora_idx, mm=mm, rope=rope)

    def _prefill_rows(self, chunks, temps, topks, topps, minps,
                      pen: tuple | None = None, mask: np.ndarray | None = None,
                      lora_idx=None, mm: list | None = None, rope: list | None = None,
                      ring: bool = False) -> tuple[np.ndarray, np.ndarray]:
        """``prefill_batched``'s body; ``ring``: the one chunk ring-attends
        over the sp group (``prefill``'s rule, ``_use_ring``)."""
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
        lora = self._lora_args(lora_idx)
        mm_args = self._mm_args(mm, rope, prefix_lens, T)
        flags = (pen is not None, mask is not None, bool(lora))
        extra = ("input_embeds" in mm_args, "rope_pos" in mm_args)
        bucket = self.config.scheduler.prefill_bucket(T)
        self.prefill_keys.add(("prefill", bucket, mp, self._impl(ring), *flags, ring, *extra)
                              if G == 1 else
                              ("prefill_batched", G, bucket, mp, self._impl(ring), *flags, *extra))
        logits = self.model.forward_prefill_batched(
            self._i32(tokens), self._i32(prefix_lens), self._i32(t_reals),
            self.k_cache, self.v_cache, self._i32(page_tables), ring=ring, **lora, **mm_args)
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
        self._count_prefill(G, int(t_reals.sum()), ring)
        return toks.cpu().numpy(), lps.cpu().numpy()  # the blocking fetch

    def _count_prefill(self, rows: int, tokens: int, ring: bool = False) -> None:
        self.stats["prefill_calls"] += 1
        self.stats["ring_calls"] += int(ring)
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
        ``ds.lora_idx`` set, with a bank loaded, adds each row's adapter;
        ``ds.rope_delta`` set offsets each row's rotary position (M-RoPE);
        ``mask`` [B, V] bool restricts each row's vocabulary."""
        B, mp = ds.page_tables.shape
        E = ds.stop_ids.shape[1] if (num_steps > 1 and ds.stop_ids is not None) else 0
        if ds.use_pen:
            self._ensure_penalty_buffers()  # before any capture reads them
        use_lora = ds.lora_idx is not None and self._lora_bank is not None
        step = self.graphs.get(B, mp, num_steps, E, ds.use_pen, mask is not None,
                               self.model_cfg.vocab_size, use_lora, ds.use_mrope)
        step.load(ds, tokens, positions, self._consume_folds(num_steps), mask)
        if self._counters is None and self.device.type == "cuda" \
                and self.model.attention == "kernel":
            cfg = self.model_cfg
            self._counters = torch.zeros(decode_attention.counter_ints(
                self.k_cache.dtype, max(self.config.scheduler.decode_batch_buckets),
                cfg.num_heads, cfg.num_kv_heads, cfg.head_dim),
                dtype=torch.int32, device=self.device)
        toks, lps, steps_run = step.launch(self._megastep, self._graph_inputs(step))
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
                     pen: tuple | None = None, mask: np.ndarray | None = None,
                     lora_idx=None, rope_delta=None) -> tuple[np.ndarray, np.ndarray]:
        """Launch plus fetch.  Returns (tokens [B, n], logprobs [B, n]) with n
        the reference's ``steps_run``; ``stop_state`` = (stop_ids [B, E] -1
        padded, limits [B] absolute total-length caps, live [B] real-lane
        mask); None never stops early.  ``pen`` = (slot_idx [B], freqs [B],
        pres [B], reps [B]) over the runner's penalty rows; ``mask`` [B, V];
        ``lora_idx`` [B] adapter slots; ``rope_delta`` [B] M-RoPE offsets."""
        ds = DecodeState.of(page_tables, temps, topks, topps, minps, stop_state, pen,
                            lora_idx, rope_delta)
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
        lora = dict(lora=self._lora_bank, lora_idx=st.lora_idx) if st.use_lora else {}
        cur = st.tokens
        for j in range(N):
            logits = self.model.forward_decode_horizon(
                cur, entry + j, entry, j, self.k_cache, self.v_cache, st.page_tables,
                hk, hv, counters=self._counters, rope_delta=st.rope_delta, **lora)
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

    # ---- speculative verify block ----

    def decode_spec_async(self, tokens, draft_n, positions, page_tables, temps, topks,
                          topps, minps, rope_delta=None) -> SpecLaunch:
        """Dispatch one fused verify block and return without a host sync.
        ``tokens`` [B, W] hold each lane's last committed token, its drafts
        and padding; ``draft_n`` [B] the lane's draft count (0 for padded
        rows); ``positions`` [B] the entries (padded rows: ``mp *
        page_size``, which lands their KV on the garbage page);
        ``rope_delta`` [B] the lanes' M-RoPE offsets (None: no M-RoPE lane).
        Consumes exactly one sampling counter, the one a K=1 launch would
        use at this step, so a discarded frame rewinds it."""
        B, W = np.shape(tokens)
        mp = np.shape(page_tables)[1]
        step = self.graphs.get_verify(B, mp, W, rope_delta is not None)
        step.load(tokens, draft_n, positions, page_tables, temps, topks, topps, minps,
                  self._consume_folds(1), rope_delta)
        toks, lps, n_emit = step.launch(self._verify_step, self._graph_inputs(step))
        self.stats["verify_calls"] += 1
        if self.device.type != "cuda":
            return SpecLaunch(toks, lps, n_emit, None)
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in (toks, lps, n_emit)]
        for h, t in zip(host, (toks, lps, n_emit)):
            h.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return SpecLaunch(*host, event)

    def spec_fetch(self, launch: SpecLaunch) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Wait for a verify block: (emitted [B, W], logprobs [B, W],
        n_emit [B])."""
        if launch.event is not None:
            launch.event.synchronize()
        return launch.toks.numpy(), launch.lps.numpy(), launch.n_emit.numpy()

    def _verify_step(self, st: VerifyStep) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The verify block on ``st``'s device inputs: one forward over the
        block, then per lane a greedy chain at temperature 0 (accept drafted
        column c + 1 while it equals the argmax after column c; the first
        mismatch's argmax is the correction) and ``spec_accept_sample``
        above it; the emitted row (accepted drafts, then the bonus or the
        correction), ``n_emit`` and each emitted token's logprob under its
        column's raw distribution.  KV discipline: column c's K/V lands in
        its real slot only when that token is committed (c = 0, the
        already-committed input, or an accepted draft) and its position
        lies within the table; every other column goes to the garbage page,
        so a rejected draft never poisons a slot.  No host sync and no host
        tensor, so a CUDA graph can capture it."""
        cfg = self.model_cfg
        B, mp, W = st.B, st.mp, st.W
        L, KD = cfg.num_layers, cfg.num_kv_heads * cfg.head_dim
        ps = self.spec.page_size
        dev = self.device
        logits, bk, bv = self.model.forward_verify_block(
            st.tokens, st.entry, self.k_cache, self.v_cache, st.page_tables,
            rope_delta=st.rope_delta)
        props = st.tokens[:, 1:]  # [B, W-1] drafted columns
        greedy = st.temps <= 0.0
        g = torch.argmax(logits, dim=-1)  # [B, W]
        cols = torch.arange(W - 1, device=dev)[None, :]
        match = (props == g[:, :-1]) & (cols < st.draft_n[:, None])
        n_acc_g = torch.cumprod(match.long(), dim=1).sum(dim=1)
        final_g = g.gather(1, n_acc_g[:, None])[:, 0]
        safe_t = torch.where(greedy, 1.0, st.temps)  # greedy rows' samples are discarded
        final_s, n_acc_s = spec_accept_sample(
            logits, props, st.draft_n, self.sample_seed, st.counter + 1, safe_t,
            st.topks, st.topps, st.minps)
        n_acc = torch.where(greedy, n_acc_g, n_acc_s)
        final = torch.where(greedy, final_g, final_s)
        c = torch.arange(W, device=dev)[None, :]
        props_pad = torch.cat([props, torch.zeros_like(props[:, :1])], dim=1)
        emitted = torch.where(c < n_acc[:, None], props_pad, 0)
        emitted = torch.where(c == n_acc[:, None], final[:, None], emitted)
        lps = torch.log_softmax(logits.float(), dim=-1).gather(-1, emitted[..., None])[..., 0]
        pos = st.entry.long()[:, None] + c
        valid = (c <= n_acc[:, None]) & (pos < mp * ps)
        pos_c = pos.clamp(max=mp * ps - 1)
        page = torch.gather(st.page_tables.long(), 1, pos_c // ps)
        dest = torch.where(valid, page * ps + pos_c % ps, 0).reshape(-1)
        P = self.k_cache.shape[1]
        self.k_cache.view(L, P * ps, KD).index_copy_(1, dest, bk.reshape(L, B * W, KD))
        self.v_cache.view(L, P * ps, KD).index_copy_(1, dest, bv.reshape(L, B * W, KD))
        return emitted, lps, n_acc + 1

    # ---- embeddings ----

    def embed(self, batches: list[list[int]]) -> np.ndarray:
        """Sequence embeddings of token-id lists: [n, hidden] float32 (the
        reference's ``runner.embed``).  The batch pads to a power of two and
        the length to its prefill bucket; each list is cut to the largest
        bucket, and to the sliding window on a model with one (the embedding
        forward attends without per-layer windows, and within the window
        both agree).  Runs eagerly, with no CUDA graph."""
        n = len(batches)
        B = 1
        while B < n:
            B *= 2
        sched = self.config.scheduler
        cap = max(sched.prefill_token_buckets)
        if self.model_cfg.sliding_window:
            cap = min(cap, self.model_cfg.sliding_window)
        batches = [b[:cap] for b in batches]
        T = sched.prefill_bucket(max(len(b) for b in batches))
        tokens = np.zeros((B, T), np.int32)
        lengths = np.zeros(B, np.int32)
        for i, ids in enumerate(batches):
            tokens[i, : len(ids)] = ids
            lengths[i] = len(ids)
        out = self.model.forward_embed(self._i32(tokens), self._i32(lengths))
        return out[:n].cpu().numpy()  # the blocking fetch

    # ---- PD disaggregation: the KV handoff legs ----

    @property
    def kv_transfer(self):
        """Lazy per-runner TransferManager (KV pulls between processes)."""
        if getattr(self, "_kv_transfer", None) is None:
            from smg_tpu_torch.engine.kv_transfer import TransferManager

            self._kv_transfer = TransferManager(self.device)
        return self._kv_transfer

    @property
    def supports_kv_transfer(self) -> bool:
        """True when this engine can serve and accept KV pulls: a
        single-device engine (CUDA IPC on the card, shared memory on the
        CPU); a rank-mesh one refuses the PD legs, as the reference
        turns ``transfer`` off on a mesh."""
        return self.groups is None and self.device.type in ("cuda", "cpu")

    def export_pages_device(self, pages: list[int]) -> tuple[torch.Tensor, torch.Tensor]:
        """Gather KV pages into fresh tensors on this engine's device:
        ([L, n, ps, KD] k, v).  Runs on the calling thread's current stream
        (the device's default stream: the engine launches nothing on side
        streams outside graph captures).  The gather copies, so the caller
        may free the pages at once: a later write to them on this stream is
        ordered after it.  On the card an event recorded after the gather
        rides each tensor (``ready``), for an import on another stream."""
        idx = torch.as_tensor(pages, dtype=torch.long, device=self.device)
        k = self.k_cache.index_select(1, idx)
        v = self.v_cache.index_select(1, idx)
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record()
            k.ready = v.ready = ready
        self.kv_handoffs["export_device"] += 1
        return k, v

    def export_pages(self, pages: list[int]) -> tuple[torch.Tensor, torch.Tensor]:
        """Gather KV pages to host memory: ([L, n, ps, KD] k, v) CPU tensors
        in the cache's dtype (pinned on the card; the copy blocks).  bf16
        has no numpy dtype, so the host payload is a torch tensor where the
        reference's is a numpy array; its bytes are the same."""
        idx = torch.as_tensor(pages, dtype=torch.long, device=self.device)
        out = []
        for cache in (self.k_cache, self.v_cache):
            gathered = cache.index_select(1, idx)
            if self.device.type == "cuda":
                host = torch.empty(gathered.shape, dtype=gathered.dtype, pin_memory=True)
                host.copy_(gathered)
                gathered = host
            out.append(gathered)
        self.kv_handoffs["export_host"] += 1
        return out[0], out[1]

    def import_pages(self, pages: list[int], k, v) -> None:
        """Scatter a host payload (CPU tensors) into the cache at ``pages``;
        the copy to the device runs on the calling thread's current
        stream."""
        dev = self.k_cache.device
        self._scatter_pages(pages, torch.as_tensor(k).to(dev), torch.as_tensor(v).to(dev))
        self.kv_handoffs["import_host"] += 1

    def import_pages_device(self, pages: list[int], k: torch.Tensor, v: torch.Tensor) -> None:
        """Scatter a device payload into the cache at ``pages``: a device-to-
        device copy on the calling thread's current stream.  The payload must
        lie on this engine's own device.  It was made on the exporting
        thread's stream: this stream waits for its ``ready`` event, and
        ``record_stream`` keeps its memory from being handed out on the
        exporting stream before this scatter has read it."""
        dev = self.k_cache.device
        for t in (k, v):
            if not isinstance(t, torch.Tensor) or t.device != dev:
                where = t.device if isinstance(t, torch.Tensor) else type(t).__name__
                raise ValueError(f"device KV payload on {where}, not on this engine's {dev}")
        if dev.type == "cuda":
            stream = torch.cuda.current_stream(dev)
            for t in (k, v):
                ready = getattr(t, "ready", None)
                if ready is not None:
                    stream.wait_event(ready)
                t.record_stream(stream)
        self._scatter_pages(pages, k, v)
        self.kv_handoffs["import_device"] += 1

    def _scatter_pages(self, pages: list[int], k: torch.Tensor, v: torch.Tensor) -> None:
        """In place (``index_copy_`` on the page dim): captured megastep and
        verify graphs read the cache at the addresses they captured, so the
        import must never rebind it, as the reference's ``.at[].set`` does."""
        n = len(pages)
        want = (self.k_cache.shape[0], n, *self.k_cache.shape[2:])
        if tuple(k.shape) != want or tuple(v.shape) != want:
            raise ValueError(f"KV payload of shape {tuple(k.shape)}, want {want}")
        idx = torch.as_tensor(pages, dtype=torch.long, device=self.k_cache.device)
        self.k_cache.index_copy_(1, idx, k.to(self.k_cache.dtype))
        self.v_cache.index_copy_(1, idx, v.to(self.v_cache.dtype))

    def flush_cache_buffers(self) -> None:
        """Zero the KV buffers in place (flush_cache, after the radix reset):
        the captured graphs hold their addresses."""
        self.k_cache.zero_()
        self.v_cache.zero_()


def _to_device(params: dict, device: torch.device) -> dict:
    out = {k: v.to(device) for k, v in params.items() if k != "layers"}
    out["layers"] = {k: v.to(device) for k, v in params["layers"].items()}
    return out
