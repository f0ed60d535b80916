"""Llama-family dense decoder (Llama 2/3, Mistral, Qwen2/3-dense, Gemma-2
switches) — port of ``smg_tpu/models/llama.py``'s serving forwards.

Parameters keep the JAX package's stacked per-layer layout (leading ``L``
axis), with the head axes folded so every projection is one
``torch.matmul``: ``wq [L, E, H*D]``, ``wk``/``wv [L, E, K*D]``,
``wo [L, H*D, E]``, ``w_gate``/``w_up [L, E, F]``, ``w_down [L, F, E]``.
The JAX ``lax.scan`` over layers is a Python loop here.

Attention: with ``attention="kernel"`` (the default) every prefill goes
through the prefill kernel and every decode column through the decode
kernel (``ops/cuda/``; on CPU tensors their wrappers compute the plain
version).  ``attention="plain"`` runs the plain PyTorch versions
(``ops/attention.py``) on any device — the reference the card checks the
kernels against end to end.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from smg_tpu_torch.models.config import ModelConfig
from smg_tpu_torch.ops.attention import attention_decode_cached, scatter_kv_pages_full
from smg_tpu_torch.ops.cuda.decode_attention import paged_attention_decode_cached
from smg_tpu_torch.ops.cuda.prefill_attention import (
    paged_attention_prefill_batched,
    plain_prefill_batched,
)
from smg_tpu_torch.ops.norms import rms_norm
from smg_tpu_torch.ops.rope import apply_rope, rope_frequencies

ATTENTION_IMPLS = ("kernel", "plain")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device | str) -> dict:
    """Random weights with the shapes and init scales of the JAX package's
    ``init_params`` (``smg_tpu/models/llama.py``).  The numbers differ (no
    threefry); tests that need identical weights bridge them with
    ``models/convert.py::params_from_jax``."""
    E, Fd, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    H, K, D, V = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.vocab_size
    dtype = torch_dtype(cfg.dtype)
    if cfg.num_experts:
        raise NotImplementedError("MoE layers are not ported yet")

    def normal(shape, scale):
        if len(shape) == 2:
            return (torch.randn(shape, generator=generator, device=device,
                                dtype=torch.float32) * scale).to(dtype)
        out = torch.empty(shape, dtype=dtype, device=device)
        for i in range(shape[0]):  # layer by layer: bounded f32 scratch
            out[i] = normal(shape[1:], scale)
        return out

    def const(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    norm_one = 0.0 if cfg.rms_unit_offset else 1.0  # Gemma stores w as a delta
    layers = {
        "attn_norm": const((L, E), norm_one),
        "wq": normal((L, E, H * D), 0.02),
        "wk": normal((L, E, K * D), 0.02),
        "wv": normal((L, E, K * D), 0.02),
        "wo": normal((L, H * D, E), 0.02 / math.sqrt(2 * L)),
        "mlp_norm": const((L, E), norm_one),
        "w_gate": normal((L, E, Fd), 0.02),
        "w_up": normal((L, E, Fd), 0.02),
        "w_down": normal((L, Fd, E), 0.02 / math.sqrt(2 * L)),
    }
    if cfg.post_norms:
        layers["post_attn_norm"] = const((L, E), norm_one)
        layers["post_mlp_norm"] = const((L, E), norm_one)
    if cfg.qk_norm:
        layers["q_norm"] = const((L, D), 1.0)
        layers["k_norm"] = const((L, D), 1.0)
    params = {
        "embed": normal((V, E), 0.02),
        "layers": layers,
        "final_norm": const((E,), norm_one),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = normal((E, V), 0.02)
    return params


def layer_window(cfg: ModelConfig, layer: int) -> int | None:
    """Per-layer sliding window: every ``sliding_window_pattern``-th layer is
    global (0), the rest use ``cfg.sliding_window``; pattern <= 0 windows
    every layer (Mistral); None when the model has no window."""
    if not cfg.sliding_window:
        return None
    p = cfg.sliding_window_pattern
    if p <= 0:
        return cfg.sliding_window
    return 0 if layer % p == p - 1 else cfg.sliding_window


class LlamaModel(nn.Module):
    """The dense decoder.  Caches are ``[L, P, ps, K*D]`` (fused lanes,
    page 0 = garbage page) and are written in place."""

    def __init__(self, cfg: ModelConfig, params: dict, attention: str = "kernel"):
        super().__init__()
        if attention not in ATTENTION_IMPLS:
            raise ValueError(f"attention must be one of {ATTENTION_IMPLS}, got {attention!r}")
        self.cfg = cfg
        self.attention = attention
        self.scale = cfg.query_scale or 1.0 / math.sqrt(cfg.head_dim)
        self.layers = nn.Module()  # stacked [L, ...] weights, one buffer each
        for name, t in params["layers"].items():
            self.layers.register_buffer(name, t, persistent=False)
        for name in ("embed", "final_norm", "lm_head"):
            if name in params:
                self.register_buffer(name, params[name], persistent=False)
        if not cfg.tie_word_embeddings and "lm_head" not in params:
            raise ValueError("untied model needs an lm_head")
        device = params["embed"].device
        # Gemma scales embeddings by sqrt(hidden), rounded to the weights'
        # dtype as the JAX package does; a Python float keeps every forward
        # free of host tensors (CUDA graph capture)
        self.embed_scale = (float(torch.tensor(math.sqrt(cfg.hidden_size),
                                               dtype=params["embed"].dtype))
                            if cfg.embed_scale else None)
        self.register_buffer("inv_freq", torch.from_numpy(
            rope_frequencies(cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)).to(device),
            persistent=False)

    # ---- shared pieces ----

    def _norm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, w, self.cfg.rms_norm_eps, unit_offset=self.cfg.rms_unit_offset)

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        h = self.embed[tokens.long()]
        if self.embed_scale is not None:
            h = h * self.embed_scale
        return h

    def unembed(self, h: torch.Tensor) -> torch.Tensor:
        h = self._norm(h, self.final_norm)
        w = self.embed.t() if self.cfg.tie_word_embeddings else self.lm_head
        logits = torch.matmul(h, w).float()
        c = self.cfg.final_logit_softcap
        if c:
            logits = c * torch.tanh(logits / c)
        return logits

    def _qkv(self, l: int, h: torch.Tensor):
        cfg, ly = self.cfg, self.layers
        lead = h.shape[:-1]
        q = torch.matmul(h, ly.wq[l]).reshape(*lead, cfg.num_heads, cfg.head_dim)
        k = torch.matmul(h, ly.wk[l]).reshape(*lead, cfg.num_kv_heads, cfg.head_dim)
        v = torch.matmul(h, ly.wv[l]).reshape(*lead, cfg.num_kv_heads, cfg.head_dim)
        if cfg.qk_norm:  # Qwen3: per-head RMSNorm over head_dim before rope
            q = rms_norm(q, ly.q_norm[l], cfg.rms_norm_eps)
            k = rms_norm(k, ly.k_norm[l], cfg.rms_norm_eps)
        return q, k, v

    def _attn_residual(self, l: int, h: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
        o = torch.matmul(attn.reshape(*attn.shape[:-2], -1), self.layers.wo[l])
        if self.cfg.post_norms:
            o = self._norm(o, self.layers.post_attn_norm[l])
        return h + o

    def _mlp_residual(self, l: int, h: torch.Tensor) -> torch.Tensor:
        ly = self.layers
        x = self._norm(h, ly.mlp_norm[l])
        gate = torch.matmul(x, ly.w_gate[l])
        up = torch.matmul(x, ly.w_up[l])
        if self.cfg.activation == "gelu_tanh":
            act = F.gelu(gate, approximate="tanh")
        else:
            act = F.silu(gate)
        o = torch.matmul(act * up, ly.w_down[l])
        if self.cfg.post_norms:
            o = self._norm(o, ly.post_mlp_norm[l])
        return h + o

    # ---- serving forwards ----

    def forward_prefill(self, tokens, prefix_len, t_real, k_cache, v_cache, page_table,
                        compute_logits: bool = True):
        """Prefill one sequence chunk (``tokens`` [T], ``prefix_len`` and
        ``t_real`` [1] int32, ``page_table`` [mp] int32, all on the cache's
        device); writes its KV and returns the last token's logits [V] (None
        with ``compute_logits=False``: a non-final chunk)."""
        logits = self.forward_prefill_batched(
            tokens[None], prefix_len.reshape(1), t_real.reshape(1), k_cache, v_cache,
            page_table[None], compute_logits=compute_logits)
        return None if logits is None else logits[0]

    def forward_prefill_batched(self, tokens, prefix_lens, t_reals, k_cache, v_cache,
                                page_tables, compute_logits: bool = True):
        """Prefill several sequences in one call: ``tokens`` [G, T] (rows
        padded past ``t_reals``), ``prefix_lens``/``t_reals`` [G] int32,
        ``page_tables`` [G, mp] int32.  Returns last-token logits [G, V]."""
        cfg = self.cfg
        G_, T = tokens.shape
        K, D = cfg.num_kv_heads, cfg.head_dim
        ps = k_cache.shape[2]
        mp = page_tables.shape[1]
        dev = tokens.device
        ar = torch.arange(T, device=dev)
        pl, tr = prefix_lens.long(), t_reals.long()
        pos = pl[:, None] + ar[None, :]  # [G, T]
        # padded rows and positions past the table write to the garbage page
        valid = (ar[None, :] < tr[:, None]) & (pos < mp * ps)
        pos_c = pos.clamp(max=mp * ps - 1)
        page = torch.gather(page_tables.long(), 1, pos_c // ps)
        dest = torch.where(valid, page * ps + pos_c % ps, 0).reshape(-1)
        cd = k_cache.dtype

        h = self.embed_tokens(tokens)  # [G, T, E]
        for l in range(cfg.num_layers):
            q, k, v = self._qkv(l, self._norm(h, self.layers.attn_norm[l]))
            q = apply_rope(q, pos, self.inv_freq)
            k = apply_rope(k, pos, self.inv_freq)
            scatter_kv_pages_full(k_cache, v_cache, l, k.reshape(G_ * T, K, D),
                                  v.reshape(G_ * T, K, D), dest)
            window = layer_window(cfg, l)
            if self.attention == "kernel":
                attn = paged_attention_prefill_batched(
                    q.to(cd).contiguous(), k.reshape(G_, T, K * D).to(cd).contiguous(),
                    v.reshape(G_, T, K * D).to(cd).contiguous(), k_cache, v_cache, l,
                    page_tables, prefix_lens, t_reals, self.scale,
                    softcap=cfg.attn_logit_softcap, window=window)
            else:
                attn = plain_prefill_batched(
                    q, k_cache, v_cache, l, page_tables, prefix_lens, t_reals,
                    self.scale, softcap=cfg.attn_logit_softcap, window=window)
            h = self._attn_residual(l, h, attn.to(h.dtype))
            h = self._mlp_residual(l, h)
        if not compute_logits:
            return None
        last = h[torch.arange(G_, device=dev), (tr - 1).clamp(min=0)]
        return self.unembed(last)

    def forward_decode_horizon(self, tokens, positions, entry_positions, step_idx: int,
                               k_cache, v_cache, page_tables, hk_all, hv_all,
                               counters=None):
        """One decode column against the frozen cache + side buffers.

        ``tokens``/``positions`` [B] (positions = entry + step_idx),
        ``entry_positions`` [B] int32, ``page_tables`` [B, mp] int32,
        ``hk_all``/``hv_all`` [L, B, N, K*D]: this column's K/V land in
        ``[:, :, step_idx]`` in place; the cache itself is read only (the
        runner scatters the whole horizon once at the end).  Returns logits
        [B, V].  Reads nothing back to the host and creates no host tensor,
        so a CUDA graph can capture it; ``counters`` are the decode kernel's
        arrival counters (``ops/cuda/decode_attention.py``), preallocated
        by the caller for the largest batch it captures."""
        cfg = self.cfg
        B = tokens.shape[0]
        KD = cfg.num_kv_heads * cfg.head_dim
        cd = k_cache.dtype
        h = self.embed_tokens(tokens)  # [B, E]
        for l in range(cfg.num_layers):
            q, k, v = self._qkv(l, self._norm(h, self.layers.attn_norm[l]))
            q = apply_rope(q[:, None], positions[:, None], self.inv_freq)[:, 0]
            k = apply_rope(k[:, None], positions[:, None], self.inv_freq)[:, 0]
            hk_all[l, :, step_idx] = k.reshape(B, KD).to(hk_all.dtype)
            hv_all[l, :, step_idx] = v.reshape(B, KD).to(hv_all.dtype)
            args = (q.to(cd).contiguous(), k_cache, v_cache, hk_all[l], hv_all[l],
                    step_idx + 1, l, page_tables, entry_positions, self.scale)
            kw = dict(softcap=cfg.attn_logit_softcap, window=layer_window(cfg, l))
            if self.attention == "kernel":
                attn = paged_attention_decode_cached(*args, **kw, counters=counters)
            else:
                attn = attention_decode_cached(*args, **kw)
            h = self._attn_residual(l, h, attn.to(h.dtype))
            h = self._mlp_residual(l, h)
        return self.unembed(h)
