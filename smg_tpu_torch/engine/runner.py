"""ModelRunner: owns the weights, the KV buffers and the sampler's generator
(port of ``smg_tpu/engine/runner.py``'s serving path).

Entry points run on the card: ``device=None`` resolves to ``cuda`` and a
machine without one raises; the CPU is used only when the caller asks for
it (the tests do).  PyTorch runs eagerly, so the JAX runner's compile
buckets, donation policy, sharding and program auditor have no counterpart;
cache writes are in place.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from smg_tpu_torch.engine.config import EngineConfig
from smg_tpu_torch.engine.kv_cache import KvCacheSpec, create_kv_buffers, plan_cache
from smg_tpu_torch.engine.sampling import sample_tokens
from smg_tpu_torch.models.llama import LlamaModel, init_params


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
        self.generator = torch.Generator(device=self.device).manual_seed(
            config.seed ^ 0x5EED)
        # what the schedule asked of the device: forward calls, rows and
        # tokens of prefill; megastep launches and decode columns computed
        self.stats = dict(prefill_calls=0, prefill_rows=0, prefill_tokens=0,
                          decode_calls=0, decode_columns=0)

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

    def _sample(self, logits, temps, topks, topps, minps):
        toks, lps = sample_tokens(logits, self.generator, self._f32(temps),
                                  self._i32(topks), self._f32(topps), self._f32(minps))
        return toks, lps

    # ---- prefill ----

    def prefill(self, token_ids: list[int], prefix_len: int, page_table: np.ndarray,
                temperature: float, top_k: int, top_p: float, min_p: float
                ) -> tuple[int, float]:
        """Run one (final) prefill chunk; returns (sampled_token, logprob)."""
        toks, lps = self.prefill_batched(
            [(token_ids, prefix_len, page_table)], [temperature], [top_k],
            [top_p], [min_p])
        return int(toks[0]), float(lps[0])

    def prefill_extend(self, token_ids: list[int], prefix_len: int,
                       page_table: np.ndarray) -> None:
        """Write one NON-final chunk's KV: nothing is sampled."""
        self._check_chunk(len(token_ids), prefix_len, len(page_table))
        self.model.forward_prefill(
            self._i32(token_ids), self._i32([prefix_len]), self._i32([len(token_ids)]),
            self.k_cache, self.v_cache, self._i32(page_table), compute_logits=False)
        self._count_prefill(1, len(token_ids))

    def prefill_batched(self, chunks, temps, topks, topps, minps
                        ) -> tuple[np.ndarray, np.ndarray]:
        """Prefill several sequences' final chunks in one forward.  ``chunks``
        is a list of (token_ids, prefix_len, page_table_row); rows are padded
        to the longest chunk.  Returns (tokens [G], logprobs [G])."""
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
        toks, lps = self._sample(logits, temps, topks, topps, minps)
        self._count_prefill(G, int(t_reals.sum()))
        return toks.cpu().numpy(), lps.cpu().numpy()  # the blocking fetch

    def _count_prefill(self, rows: int, tokens: int) -> None:
        self.stats["prefill_calls"] += 1
        self.stats["prefill_rows"] += rows
        self.stats["prefill_tokens"] += tokens

    # ---- decode megastep ----

    def decode_multi(self, tokens: np.ndarray, positions: np.ndarray,
                     page_tables: np.ndarray, temps, topks, topps, minps,
                     num_steps: int, stop_state: tuple | None = None
                     ) -> tuple[np.ndarray, np.ndarray]:
        """The decode megastep: ``num_steps`` columns for the batch with one
        host round trip.  Returns (tokens [B, n], logprobs [B, n]) where n is
        the reference's ``steps_run``: the first column at which any live lane
        hits a stop id or its length limit, plus one (``num_steps`` if none).

        Inside the horizon the cache is read-only: each column's K/V land in
        per-layer side buffers ``[L, B, N, K*D]``, and one scatter at the end
        lands the horizon.  PyTorch cannot leave a device loop on data
        without a host sync, so all columns run and the host trims; KV of
        columns past ``steps_run`` (and of positions past the table) goes to
        the garbage page, as in the JAX megastep.

        ``stop_state`` = (stop_ids [B, E] -1 padded, limits [B] absolute total
        length caps, live [B] real-lane mask); None never stops early."""
        cfg = self.model_cfg
        B, mp = page_tables.shape
        N = num_steps
        L, KD = cfg.num_layers, cfg.num_kv_heads * cfg.head_dim
        ps = self.spec.page_size
        dev = self.device
        entry = self._i32(positions)
        pt = self._i32(page_tables)
        temps, topks = self._f32(temps), self._i32(topks)
        topps, minps = self._f32(topps), self._f32(minps)
        hk = torch.zeros((L, B, N, KD), dtype=self.k_cache.dtype, device=dev)
        hv = torch.zeros_like(hk)
        toks_out = torch.zeros((B, N), dtype=torch.long, device=dev)
        lps_out = torch.zeros((B, N), dtype=torch.float32, device=dev)
        steps_run = torch.full((), N, dtype=torch.long, device=dev)
        if stop_state is not None:
            stop_ids = torch.as_tensor(np.asarray(stop_state[0]), device=dev).long()
            limits = self._i32(stop_state[1]).long()
            live = torch.as_tensor(np.asarray(stop_state[2], bool), device=dev)
            done = ~live  # padded lanes start done and never gate the exit
        cur = self._i32(tokens)
        for j in range(N):
            logits = self.model.forward_decode_horizon(
                cur, entry + j, entry, j, self.k_cache, self.v_cache, pt, hk, hv)
            new, lps = sample_tokens(logits, self.generator, temps, topks, topps, minps)
            toks_out[:, j] = new
            lps_out[:, j] = lps
            if stop_state is not None:
                # length finish: total_len after accepting column j is
                # entry + j + 2, so the lane is done once entry + j >= limit - 2
                done = done | (new[:, None] == stop_ids).any(dim=1) | (
                    entry.long() + j >= limits - 2)
                first = (done & live).any() & (steps_run == N)
                steps_run = torch.where(first, torch.full_like(steps_run, j + 1), steps_run)
            cur = new
        # land the horizon: uncomputed-in-the-reference columns (>= steps_run)
        # and positions past the table go to the garbage page
        pos = entry.long()[:, None] + torch.arange(N, device=dev)[None, :]
        valid = (pos < mp * ps) & (torch.arange(N, device=dev)[None, :] < steps_run)
        pos_c = pos.clamp(max=mp * ps - 1)
        page = torch.gather(pt.long(), 1, pos_c // ps)
        dest = torch.where(valid, page * ps + pos_c % ps, 0).reshape(-1)
        P = self.k_cache.shape[1]
        self.k_cache.view(L, P * ps, KD).index_copy_(1, dest, hk.reshape(L, B * N, KD))
        self.v_cache.view(L, P * ps, KD).index_copy_(1, dest, hv.reshape(L, B * N, KD))
        self.stats["decode_calls"] += 1
        self.stats["decode_columns"] += N
        n = int(steps_run)  # the blocking fetch
        return toks_out[:, :n].cpu().numpy(), lps_out[:, :n].cpu().numpy()


def _to_device(params: dict, device: torch.device) -> dict:
    out = {k: v.to(device) for k, v in params.items() if k != "layers"}
    out["layers"] = {k: v.to(device) for k, v in params["layers"].items()}
    return out
