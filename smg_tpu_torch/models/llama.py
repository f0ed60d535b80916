"""Llama-family decoder (Llama 2/3, Mistral, Qwen2/3, Gemma-2 switches and
the Qwen-MoE family) — port of ``smg_tpu/models/llama.py``'s serving
forwards.

Parameters keep the JAX package's stacked per-layer layout (leading ``L``
axis), with the head axes folded so every projection is one
``torch.matmul``: ``wq [L, E, H*D]``, ``wk``/``wv [L, E, K*D]``,
``wo [L, H*D, E]``, ``w_gate``/``w_up [L, E, F]``, ``w_down [L, F, E]``.
A Qwen-MoE model has ``router [L, E, X]``, ``w_gate``/``w_up [L, X, E, Fm]``
and ``w_down [L, X, Fm, E]`` instead, and every layer's MLP is the expert
layer ``moe_mlp``.  The JAX ``lax.scan`` over layers is a Python loop here.

Attention: with ``attention="kernel"`` (the default) every prefill goes
through the prefill kernel and every decode column through the decode
kernel (``ops/cuda/``; on CPU tensors their wrappers compute the plain
version).  ``attention="plain"`` runs the plain PyTorch versions
(``ops/attention.py``) on any device — the reference the card checks the
kernels against end to end.  The speculative verify block and the compat
decode of the draft proposer run torch attention ops in either mode: the
reference computes them in XLA, with no Pallas kernel.

LoRA: the serving forwards (prefill, grouped prefill, the decode column)
take the runner's adapter bank and a slot index per row; every projection
of q, k, v and o adds ``lora_delta`` over every bank slot, gated one-hot
(slot 0 is all zeros: a base row adds exact zeros).  The verify block and
the compat decode take no adapter: LoRA lanes are not speculated, as in the
reference.

Multimodal (Qwen2-VL): the prefill forwards splice the vision tower's
embeddings into the placeholder rows (``input_embeds`` under
``embeds_mask``) and, given ``rope_pos`` [3, T] a row, rotate q and k by
M-RoPE; masking and cache destinations keep the sequential position.  The
decode column, the verify block and the compat decode take a per-row
``rope_delta``: rope uses ``position + delta``, cache slots use
``position``.  The attention calls are unchanged, so an image prompt goes
through the prefill kernel and an image lane through the decode kernel.

Embeddings (``forward_embed``, the reference's XLA function of the same
name) run dense causal attention in torch ops over right-padded rows, with
no KV cache and no kernel.  The reference materialises float32 scores of
every row, head and query pair at once; here rows go through in tiles of at
most ``EMBED_TOKEN_TILE`` padded tokens and queries in tiles of
``EMBED_QUERY_TILE``, every softmax row summed over its keys in one go, so
the scratch is bounded by the tiles.

Training (``forward_train``, the reference's dense causal forward of the
same name) runs the same layer as the embeddings, ``decoder_layer_train``,
over unpadded rows, differentiably: ``train/step.py`` builds the model over
one leaf tensor a layer (``params["layers"]`` values given as sequences of
L tensors), so each layer's gradient lands in its own tensor instead of a
zero-filled copy of the whole stack.  On a training mesh the groups are
``parallel/autograd.py::TrainGroup``s, whose sums and gathers carry
gradients, and the model adds the conjugate ``copy_to`` where a replicated
activation enters a product the axis splits (``_fan_out``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from smg_tpu_torch.models.config import ModelConfig
from smg_tpu_torch.ops.attention import (
    attention_decode,
    attention_decode_cached,
    attention_verify_block,
    scatter_kv_pages_full,
)
from smg_tpu_torch.ops.cuda.decode_attention import paged_attention_decode_cached
from smg_tpu_torch.ops.cuda.prefill_attention import (
    paged_attention_prefill_batched,
    plain_prefill_batched,
)
from smg_tpu_torch.ops.norms import rms_norm
from smg_tpu_torch.ops.rope import _rotate_half, apply_rope, mrope_angles, rope_frequencies
from smg_tpu_torch.parallel import pp_serving
from smg_tpu_torch.parallel.autograd import TrainGroup, gather_summed
from smg_tpu_torch.parallel.ring_attention import ring_attention, ring_attention_train

ATTENTION_IMPLS = ("kernel", "plain")
EMBED_TOKEN_TILE = 4096  # padded tokens of one row tile of forward_embed
EMBED_QUERY_TILE = 512  # queries of one attention tile of forward_embed
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device | str, shard=None) -> dict:
    """Random weights with the shapes and init scales of the JAX package's
    ``init_params`` (``smg_tpu/models/llama.py``).  The numbers differ (no
    threefry); tests that need identical weights bridge them with
    ``models/convert.py::params_from_jax``.  ``shard`` (a rank's
    ``parallel/sharding.py::Sharder``) keeps the rank's part as each piece
    is drawn: its layers and experts of each stacked weight, its tp slice of
    each drawn piece, the top-level weights it holds.  Every piece is drawn
    all the same, in the same order, so the draws, and the model, are those
    of the whole one."""
    E, Fd, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    H, K, D, V = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.vocab_size
    dtype = torch_dtype(cfg.dtype)

    def normal(shape, scale, name, depth=0):
        if len(shape) == 2:
            t = (torch.randn(shape, generator=generator, device=device,
                             dtype=torch.float32) * scale).to(dtype)
            return t if shard is None else shard(name, t)
        a, b = (0, shape[0]) if shard is None else shard.keep(name, depth, shape[0])
        out = None
        for i in range(shape[0]):  # layer by layer (expert by expert): bounded f32 scratch
            part = normal(shape[1:], scale, name, depth + 1)
            if not a <= i < b:
                continue  # drawn, not kept: the generator moves on as for the whole
            if out is None:
                out = torch.empty((b - a, *part.shape), dtype=dtype, device=device)
            out[i - a] = part
        return out

    lo, hi = (0, L) if shard is None else shard.keep("attn_norm", 0, L)
    Lr = hi - lo  # the rank's layers (its pipeline stage's)

    def const(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    norm_one = 0.0 if cfg.rms_unit_offset else 1.0  # Gemma stores w as a delta
    layers = {
        "attn_norm": const((Lr, E), norm_one),
        "wq": normal((L, E, H * D), 0.02, "wq"),
        "wk": normal((L, E, K * D), 0.02, "wk"),
        "wv": normal((L, E, K * D), 0.02, "wv"),
        "wo": normal((L, H * D, E), 0.02 / math.sqrt(2 * L), "wo"),
        "mlp_norm": const((Lr, E), norm_one),
    }
    if cfg.num_experts:  # Qwen-MoE: the router and the stacked expert MLPs
        X, Fm = cfg.num_experts, cfg.moe_intermediate_size or Fd
        layers["router"] = normal((L, E, X), 0.02, "router")
        layers["w_gate"] = normal((L, X, E, Fm), 0.02, "w_gate")
        layers["w_up"] = normal((L, X, E, Fm), 0.02, "w_up")
        layers["w_down"] = normal((L, X, Fm, E), 0.02 / math.sqrt(2 * L), "w_down")
    else:
        layers["w_gate"] = normal((L, E, Fd), 0.02, "w_gate")
        layers["w_up"] = normal((L, E, Fd), 0.02, "w_up")
        layers["w_down"] = normal((L, Fd, E), 0.02 / math.sqrt(2 * L), "w_down")
    if cfg.post_norms:
        layers["post_attn_norm"] = const((Lr, E), norm_one)
        layers["post_mlp_norm"] = const((Lr, E), norm_one)
    if cfg.qk_norm:
        layers["q_norm"] = const((Lr, D), 1.0)
        layers["k_norm"] = const((Lr, D), 1.0)
    params = {"embed": normal((V, E), 0.02, "embed"), "layers": layers,
              "final_norm": const((E,), norm_one)}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = normal((E, V), 0.02, "lm_head")
    if shard is not None:
        params = {k: v for k, v in params.items() if k == "layers" or shard.holds(k)}
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


def lora_delta(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               gates: torch.Tensor) -> torch.Tensor:
    """Per-row multi-adapter LoRA delta, dense one-hot dispatch (the
    reference's ``_lora_delta``).  ``x`` [..., E_in]; ``a`` [E_in, N*r] and
    ``b`` [N*r, E_out] hold slot n in rank columns ``n*r .. n*r + r - 1``
    (alpha/r folded into ``b``); ``gates`` [..., N] one-hot in ``x``'s
    dtype.  Every slot's rank-r projection is computed and all but the
    row's own are zeroed before the second product, which is the
    reference's sum over slots of gate x delta in two matrix products."""
    t = torch.matmul(x, a)
    t = (t.unflatten(-1, (gates.shape[-1], -1)) * gates[..., None]).flatten(-2)
    return torch.matmul(t, b)


def lora_gates(lora_idx: torch.Tensor, n_slots: int, dtype: torch.dtype) -> torch.Tensor:
    """One-hot [..., N] rows from slot indices, without a host sync."""
    return (lora_idx[..., None].long() == torch.arange(n_slots, device=lora_idx.device)
            ).to(dtype)


#: tokens of one dense-dispatch tile of the expert layer.  Every expert's
#: product over a tile reads the layer's expert weights once, so at 512
#: tokens a tile of Qwen3-30B-A3B does about 512 operations a weight byte,
#: above the H100's 295 (bf16 tensor-core rate over memory rate), while its
#: scratch stays under 0.5 GB (``moe_scratch_bytes``)
MOE_TOKEN_TILE = 512


def moe_route(x: torch.Tensor, router: torch.Tensor, k: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Router of the expert layer (the reference's, ``_moe_mlp``): logits in
    the model dtype, then float32; the top ``k`` by ``torch.topk``; a softmax
    over those k (Qwen's normalised top-k).  Returns (expert ids [..., k]
    int64, their float32 gate weights [..., k]).

    Ties: ``jax.lax.top_k`` takes the lower expert id first; ``torch.topk``
    promises no order among equal values (on the CPU it returns them in no
    index order: a row of 128 zeros gives ids 84, 87, 86, ...).  Two equal
    logits at the k-th place can therefore route a token to another expert
    than the reference does; with random or trained float32 weights an exact
    tie is improbable, and every path of the port takes the same
    ``torch.topk``."""
    logits = torch.matmul(x, router).float()
    vals, idx = torch.topk(logits, k, dim=-1)
    return idx, torch.softmax(vals, dim=-1)


def moe_experts(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                w_down: torch.Tensor) -> torch.Tensor:
    """Every expert on every token of ``x`` [T, E] (dense dispatch):
    ``silu(x W_gate) * (x W_up)``, then ``W_down``, as three batched
    products over the expert axis.  Returns y [X, T, E] in the model
    dtype."""
    xb = x.unsqueeze(0).expand(w_gate.shape[0], *x.shape)
    g = torch.bmm(xb, w_gate)  # [X, T, Fm]
    if g.requires_grad:  # training: autograd keeps g and the up product intact
        act = F.silu(g) * torch.bmm(xb, w_up)
    else:
        act = F.silu(g, inplace=True).mul_(torch.bmm(xb, w_up))
    return torch.bmm(act, w_down)


def moe_combine(y: torch.Tensor, idx: torch.Tensor, probs: torch.Tensor,
                expert0: int | None = None) -> torch.Tensor:
    """The gated sum of the expert outputs in float32: y [X, T, E], the
    routing ``idx``/``probs`` [T, k].  The reference sums ``y * gates``
    over all X experts, where the gates are zero off the top k; those X - k
    terms are exact zeros, so summing the k gated rows alone is the same sum
    and reads 1/(X/k) of ``y`` in float32.  Under expert parallelism
    (``expert0`` given) ``y`` holds the rank's experts ``[expert0, expert0 +
    X)`` alone: a routed expert off the rank adds zero, and the caller sums
    the ranks' partial results.  Returns [T, E] float32."""
    X, T, E = y.shape
    if expert0 is not None:
        local = idx - expert0
        mine = (local >= 0) & (local < X)
        idx, probs = local.clamp(0, X - 1), torch.where(mine, probs, 0.0)
    rows = idx * T + torch.arange(T, device=y.device)[:, None]  # [T, k] into y's [X*T]
    sel = y.reshape(X * T, E).index_select(0, rows.reshape(-1)).reshape(*idx.shape, E)
    return (sel.float() * probs[..., None]).sum(dim=-2)


def moe_mlp(x: torch.Tensor, router: torch.Tensor, w_gate: torch.Tensor,
            w_up: torch.Tensor, w_down: torch.Tensor, k: int,
            tile: int = MOE_TOKEN_TILE, ep=None, expert0: int = 0) -> torch.Tensor:
    """Mixture-of-experts MLP of the Qwen-MoE family — the reference's
    ``_moe_mlp`` (``smg_tpu/models/llama.py``) with its order and dtypes:
    the router (``moe_route``), every expert on every token
    (``moe_experts``), the expert outputs cast to float32 and combined with
    the gates (``moe_combine``), the result cast back to the model dtype.

    ``x`` [..., E] (the normed hidden state), ``router`` [E, X],
    ``w_gate``/``w_up`` [X, E, Fm], ``w_down`` [X, Fm, E].  The tokens go
    through in tiles of at most ``tile``, so the scratch is bounded by the
    tile, not by the prefill chunk; each token's result depends on that
    token alone.  Shapes depend only on the input's and no value goes to
    the host, so a CUDA graph can capture it.

    Expert parallelism (the reference's ``ep`` axis over the expert dim):
    with ``ep`` (the rank's ``parallel/group.py::AxisGroup``) the expert
    weights are the rank's ``[expert0, expert0 + X/ep)``; every rank routes
    over all X experts with the whole router, computes its experts for
    every token and combines them with their gates, and the float32 partial
    combines are all-reduced over ep before the cast, as GSPMD sums the
    reference's combine."""
    lead = x.shape[:-1]
    flat = x.reshape(-1, x.shape[-1])
    outs = []
    for s in range(0, flat.shape[0], tile):
        xt = flat[s:s + tile]
        idx, probs = moe_route(xt, router, k)
        y = moe_experts(xt, w_gate, w_up, w_down)
        part = moe_combine(y, idx, probs, None if ep is None else expert0)
        outs.append(part if ep is not None else part.to(x.dtype))
        del y  # gone before the next tile's products: one tile's scratch at a time
    out = outs[0] if len(outs) == 1 else torch.cat(outs)
    if ep is not None:
        out = ep.all_reduce(out).to(x.dtype)
    return out.reshape(*lead, x.shape[-1])


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, scale: float, softcap: float | None = None,
                     q_tile: int = EMBED_QUERY_TILE, q0: int = 0) -> torch.Tensor:
    """Dense causal attention of right-padded rows, in float32 as the
    reference's ``forward_embed`` computes it: ``q`` [B, Tq, H, D] at
    positions ``q0 .. q0+Tq-1``, ``k``/``v`` [B, T, K, D] at 0..T-1,
    ``lengths`` [B]; key j is seen by query i when j <= q0 + i and j < the
    row's length.  Queries go through in tiles of ``q_tile``; a tile reads
    only the keys up to its last query (the rest are masked for all of its
    queries), each softmax row over those keys at once.  Returns [B, Tq, H,
    D] in ``q``'s dtype."""
    B, Tq, H, D = q.shape
    K, T = k.shape[2], k.shape[1]
    dev = q.device
    kf, vf = k.float(), v.float()
    j = torch.arange(max(T, q0 + Tq), device=dev)
    key_ok = j[None, :T] < lengths.long()[:, None]  # [B, T]
    out = torch.empty_like(q)
    for s in range(0, Tq, q_tile):
        e = min(s + q_tile, Tq)
        ek = min(q0 + e, T)  # keys up to the tile's last query
        qf = q[:, s:e].float().reshape(B, e - s, K, H // K, D)
        scores = torch.einsum("btkgd,bskd->bkgts", qf, kf[:, :ek]) * scale
        if softcap:
            scores = softcap * torch.tanh(scores / softcap)
        seen = (j[None, :ek] <= j[q0 + s:q0 + e, None])[None] & key_ok[:, None, :ek]
        scores = torch.where(seen[:, None, None], scores, -1e30)
        probs = torch.softmax(scores, dim=-1)
        o = torch.einsum("bkgts,bskd->btkgd", probs, vf[:, :ek])
        out[:, s:e] = o.reshape(B, e - s, H, D).to(q.dtype)
    return out


def moe_scratch_bytes(cfg: ModelConfig, tokens: int) -> int:
    """Device memory one ``moe_mlp`` call over ``tokens`` tokens (a tile at
    most) holds at its peak, bounded above: the activation beside y (which
    outweighs the gate and up products together while E > Fm), the gathered
    rows in the model dtype and in float32 with their products, the router
    logits.  The broadcast input is a stride-0 view ``bmm`` reads as it is:
    Qwen3-30B-A3B's 512-token prefill chunk peaked at 383 MB above the
    resident on the H100, this gives 453 MB."""
    if not cfg.num_experts:
        return 0
    item = torch_dtype(cfg.dtype).itemsize
    X, E = cfg.num_experts, cfg.hidden_size
    Fm = cfg.moe_intermediate_size or cfg.intermediate_size
    k = max(cfg.num_experts_per_tok, 1)
    per_token = (X * max(2 * Fm, Fm + E) * item  # g and u, then act beside y
                 + k * E * (item + 8) + 4 * X)  # gathered rows, f32 products, logits
    return int(min(tokens, MOE_TOKEN_TILE)) * per_token


class LlamaModel(nn.Module):
    """The decoder.  Caches are ``[L, P, ps, K*D]`` (fused lanes,
    page 0 = garbage page) and are written in place.  Each value of
    ``params["layers"]`` is a stacked ``[L, ...]`` tensor, or (training) a
    sequence of L per-layer tensors that require grad.

    Tensor parallel: given ``tp`` (a rank's ``parallel/group.py::AxisGroup``
    for tp, or a tp-only ``RankGroups``), ``cfg`` is the rank's config
    (``parallel/sharding.py::rank_config``) and ``params`` its shard.  The
    attention output projection and ``w_down`` give partial sums that are
    all-reduced before the post-norm (Gemma-2's ``post_norms`` need the
    whole sum) and the residual add; a vocab-sharded embedding is a masked
    lookup of the rank's rows, all-reduced; the logits of the rank's vocab
    columns are all-gathered before the final softcap.

    Pipeline parallel: given ``pp`` (the pp group; ``parallel/pp_serving.py``)
    the model holds stage ``pp.rank``'s ``cfg.num_layers`` layers, the
    global layers from ``layer0``: the first stage embeds, every later one
    receives ``h`` from the stage before it, and the last unembeds and
    broadcasts the logits.  Windows follow the global layer index.

    Sequence parallel: given ``sp`` (the sp group), a prefill asked to
    ``ring`` attends through ``parallel/ring_attention.py`` over the sp
    ranks, each of which holds the whole model and writes the chunk's whole
    KV, as the reference replicates over sp.

    Expert parallel: given ``ep`` (the ep group) the expert stacks hold the
    rank's ``cfg.num_experts`` experts from ``expert0``, and ``moe_mlp``
    all-reduces its combine over ep.

    Without any group nothing changes.  The attention calls are the same
    either way, so the kernels run on every rank at its head counts and
    layers."""

    def __init__(self, cfg: ModelConfig, params: dict, attention: str = "kernel", tp=None,
                 pp=None, sp=None, ep=None):
        super().__init__()
        if attention not in ATTENTION_IMPLS:
            raise ValueError(f"attention must be one of {ATTENTION_IMPLS}, got {attention!r}")
        self.cfg = cfg
        self.attention = attention
        self.tp, self.pp, self.sp, self.ep = tp, pp, sp, ep
        self.first = pp is None or pp.rank == 0
        self.last = pp is None or pp.rank == pp.size - 1
        self.layer0 = 0 if pp is None else pp.rank * cfg.num_layers
        self.expert0 = 0 if ep is None else ep.rank * cfg.num_experts
        rows = (params["embed"].shape[0] if "embed" in params
                else params["lm_head"].shape[-1] if "lm_head" in params else cfg.vocab_size)
        # first vocab row of this rank's embedding or lm_head slice (None:
        # whole vocab)
        self.vocab_start = (tp.rank * rows if tp is not None and rows != cfg.vocab_size
                            else None)
        self.scale = cfg.query_scale or 1.0 / math.sqrt(cfg.head_dim)
        self.layers = nn.Module()  # the layer weights, one buffer (or sequence) each
        self.moe = "router" in params["layers"]
        for name, t in params["layers"].items():
            if isinstance(t, torch.Tensor):
                self.layers.register_buffer(name, t, persistent=False)
            else:  # training leaves: ``w[l]`` indexes the sequence as it does the stack
                setattr(self.layers, name, tuple(t))
        for name in ("embed", "final_norm", "lm_head"):
            if name in params:
                self.register_buffer(name, params[name], persistent=False)
        if self.last and not cfg.tie_word_embeddings and "lm_head" not in params:
            raise ValueError("untied model needs an lm_head")
        wq = params["layers"]["wq"]
        wq = wq if isinstance(wq, torch.Tensor) else wq[0]
        self.dtype, device = wq.dtype, wq.device
        # Gemma scales embeddings by sqrt(hidden), rounded to the weights'
        # dtype as the JAX package does; a Python float keeps every forward
        # free of host tensors (CUDA graph capture)
        self.embed_scale = (float(torch.tensor(math.sqrt(cfg.hidden_size), dtype=self.dtype))
                            if cfg.embed_scale else None)
        self.register_buffer("inv_freq", torch.from_numpy(
            rope_frequencies(cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)).to(device),
            persistent=False)

    # ---- shared pieces ----

    def _norm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, w, self.cfg.rms_norm_eps, unit_offset=self.cfg.rms_unit_offset)

    @staticmethod
    def _fan_out(group, x: torch.Tensor) -> torch.Tensor:
        """A replicated activation entering a product ``group`` splits: on a
        training mesh its gradient is summed over the group (``copy_to``);
        anywhere else it is ``x``."""
        return group.copy_to(x) if isinstance(group, TrainGroup) else x

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        if self.vocab_start is None:
            h = self.embed[tokens.long()]
        else:  # the rank's rows; every other rank adds zeros
            local = tokens.long() - self.vocab_start
            mine = (local >= 0) & (local < self.embed.shape[0])
            h = self.embed[torch.where(mine, local, 0)]
            h = self.tp.all_reduce(torch.where(mine[..., None], h, 0))
        if self.embed_scale is not None:
            h = h * self.embed_scale
        return h

    def unembed(self, h: torch.Tensor, gather: bool = True) -> torch.Tensor:
        """Float32 logits of ``h``; under a vocab-sharded tp only this
        rank's columns (from ``vocab_start``) unless ``gather``."""
        h = self._norm(h, self.final_norm)
        if self.vocab_start is not None:
            h = self._fan_out(self.tp, h)
        w = self.embed.t() if self.cfg.tie_word_embeddings else self.lm_head
        logits = torch.matmul(h, w).float()
        if self.vocab_start is not None and gather:
            logits = self.tp.all_gather(logits)
        c = self.cfg.final_logit_softcap
        if c:
            logits = c * torch.tanh(logits / c)
        return logits

    def _qkv(self, l: int, h: torch.Tensor, lora=None,
             gates: torch.Tensor | None = None):
        cfg, ly = self.cfg, self.layers
        lead = h.shape[:-1]
        q, k, v = (torch.matmul(h, w[l]) for w in (ly.wq, ly.wk, ly.wv))
        if lora is not None:
            q = q + lora_delta(h, lora["wq_a"][l], lora["wq_b"][l], gates)
            k = k + lora_delta(h, lora["wk_a"][l], lora["wk_b"][l], gates)
            v = v + lora_delta(h, lora["wv_a"][l], lora["wv_b"][l], gates)
        q = q.reshape(*lead, cfg.num_heads, cfg.head_dim)
        k = k.reshape(*lead, cfg.num_kv_heads, cfg.head_dim)
        v = v.reshape(*lead, cfg.num_kv_heads, cfg.head_dim)
        if cfg.qk_norm:  # Qwen3: per-head RMSNorm over head_dim before rope
            q = rms_norm(q, ly.q_norm[l], cfg.rms_norm_eps)
            k = rms_norm(k, ly.k_norm[l], cfg.rms_norm_eps)
        return q, k, v

    def _attn_residual(self, l: int, h: torch.Tensor, attn: torch.Tensor,
                       lora=None, gates: torch.Tensor | None = None
                       ) -> torch.Tensor:
        flat = attn.reshape(*attn.shape[:-2], -1)
        o = torch.matmul(flat, self.layers.wo[l])
        if lora is not None:
            o = o + lora_delta(flat, lora["wo_a"][l], lora["wo_b"][l], gates)
        if self.tp is not None:
            o = self.tp.all_reduce(o)
        if self.cfg.post_norms:
            o = self._norm(o, self.layers.post_attn_norm[l])
        return h + o

    def _mlp_residual(self, l: int, h: torch.Tensor) -> torch.Tensor:
        ly = self.layers
        x = self._fan_out(self.ep if self.moe else self.tp, self._norm(h, ly.mlp_norm[l]))
        if self.moe:  # Qwen-MoE: the expert layer, in every forward
            o = moe_mlp(x, ly.router[l], ly.w_gate[l], ly.w_up[l], ly.w_down[l],
                        max(self.cfg.num_experts_per_tok, 1), ep=self.ep,
                        expert0=self.expert0)
        else:
            gate = torch.matmul(x, ly.w_gate[l])
            up = torch.matmul(x, ly.w_up[l])
            if self.cfg.activation == "gelu_tanh":
                act = F.gelu(gate, approximate="tanh")
            else:
                act = F.silu(gate)
            o = torch.matmul(act * up, ly.w_down[l])
        if self.tp is not None:
            o = self.tp.all_reduce(o)
        if self.cfg.post_norms:
            o = self._norm(o, ly.post_mlp_norm[l])
        return h + o

    @staticmethod
    def _gates(lora, lora_idx, dtype) -> torch.Tensor | None:
        if lora is None:
            return None
        return lora_gates(lora_idx, lora.slots, dtype)

    def _enter(self, shape: tuple, embed) -> torch.Tensor:
        """The input of this rank's layers: ``embed()`` on the first stage,
        the stage before's ``h`` on a later one."""
        if self.first:
            return embed()
        return pp_serving.receive(self.pp, shape, self.dtype, self.inv_freq.device)

    def _leave(self, h: torch.Tensor, unembed, shape: tuple) -> torch.Tensor:
        """Logits [*shape] float32 from the stack's output ``h``: this
        rank's ``unembed()``, or under pp the last stage's on every stage
        (``h`` handed on to the next stage first)."""
        if self.pp is None:
            return unembed()
        pp_serving.hand_on(self.pp, h)
        return pp_serving.logits_from_last(self.pp, unembed, shape, h.device)

    # ---- serving forwards ----

    def forward_prefill(self, tokens, prefix_len, t_real, k_cache, v_cache, page_table,
                        compute_logits: bool = True, lora=None,
                        lora_idx: torch.Tensor | None = None,
                        input_embeds: torch.Tensor | None = None,
                        embeds_mask: torch.Tensor | None = None,
                        rope_pos: torch.Tensor | None = None, ring: bool = False):
        """Prefill one sequence chunk (``tokens`` [T], ``prefix_len`` and
        ``t_real`` [1] int32, ``page_table`` [mp] int32, all on the cache's
        device); writes its KV and returns the last token's logits [V] (None
        with ``compute_logits=False``: a non-final chunk).  ``lora`` is the
        adapter bank and ``lora_idx`` [1] the sequence's slot;
        ``input_embeds`` [T, E] and ``embeds_mask`` [T] bool the multimodal
        splice, ``rope_pos`` [3, T] the M-RoPE position ids; ``ring`` as in
        ``forward_prefill_batched``."""
        logits = self.forward_prefill_batched(
            tokens[None], prefix_len.reshape(1), t_real.reshape(1), k_cache, v_cache,
            page_table[None], compute_logits=compute_logits, lora=lora, lora_idx=lora_idx,
            input_embeds=None if input_embeds is None else input_embeds[None],
            embeds_mask=None if embeds_mask is None else embeds_mask[None],
            rope_pos=None if rope_pos is None else rope_pos[None], ring=ring)
        return None if logits is None else logits[0]

    def forward_prefill_batched(self, tokens, prefix_lens, t_reals, k_cache, v_cache,
                                page_tables, compute_logits: bool = True,
                                lora=None,
                                lora_idx: torch.Tensor | None = None,
                                input_embeds: torch.Tensor | None = None,
                                embeds_mask: torch.Tensor | None = None,
                                rope_pos: torch.Tensor | None = None, ring: bool = False):
        """Prefill several sequences in one call: ``tokens`` [G, T] (rows
        padded past ``t_reals``), ``prefix_lens``/``t_reals`` [G] int32,
        ``page_tables`` [G, mp] int32, ``lora_idx`` [G] each row's adapter
        slot in the bank ``lora`` (both None: no adapter).  ``input_embeds``
        [G, T, E] replace the token embeddings where ``embeds_mask`` [G, T]
        is set (the multimodal splice); ``rope_pos`` [G, 3, T] are M-RoPE
        position ids (text rows: three copies of the sequential position).
        ``ring`` (an sp rank, a cold chunk: the runner's rule) attends the
        chunk by ring attention over the sp group instead of the prefill
        kernel; the chunk's KV is written whole all the same.  Returns
        last-token logits [G, V]."""
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

        def embed():
            h = self.embed_tokens(tokens)  # [G, T, E]
            if input_embeds is not None:
                # multimodal splice: placeholder rows take the vision tower's output
                h = torch.where(embeds_mask[..., None], input_embeds.to(h.dtype), h)
            return h

        h = self._enter((G_, T, cfg.hidden_size), embed)
        gates = self._gates(lora, lora_idx, h.dtype)
        if gates is not None:
            gates = gates[:, None, :]  # every token of a row takes its slot
        # M-RoPE: 3-axis ids rotate sectioned frequencies (``apply_mrope``,
        # its angles taken once for every layer); masking and cache
        # destinations keep the sequential ``pos``
        angles = (None if rope_pos is None
                  else mrope_angles(rope_pos, self.inv_freq, cfg.mrope_section))
        for l in range(cfg.num_layers):
            q, k, v = self._qkv(l, self._norm(h, self.layers.attn_norm[l]), lora, gates)
            if angles is not None:
                q = _rotate_half(q, angles)
                k = _rotate_half(k, angles)
            else:
                q = apply_rope(q, pos, self.inv_freq)
                k = apply_rope(k, pos, self.inv_freq)
            scatter_kv_pages_full(k_cache, v_cache, l, k.reshape(G_ * T, K, D),
                                  v.reshape(G_ * T, K, D), dest)
            window = layer_window(cfg, self.layer0 + l)
            if ring:
                attn = ring_attention(q, k, v, self.scale, self.sp)
            elif self.attention == "kernel":
                attn = paged_attention_prefill_batched(
                    q.to(cd).contiguous(), k.reshape(G_, T, K * D).to(cd).contiguous(),
                    v.reshape(G_, T, K * D).to(cd).contiguous(), k_cache, v_cache, l,
                    page_tables, prefix_lens, t_reals, self.scale,
                    softcap=cfg.attn_logit_softcap, window=window)
            else:
                attn = plain_prefill_batched(
                    q, k_cache, v_cache, l, page_tables, prefix_lens, t_reals,
                    self.scale, softcap=cfg.attn_logit_softcap, window=window)
            h = self._attn_residual(l, h, attn.to(h.dtype), lora, gates)
            h = self._mlp_residual(l, h)
        if not compute_logits:
            if self.pp is not None:
                pp_serving.hand_on(self.pp, h)
            return None
        return self._leave(h, lambda: self.unembed(
            h[torch.arange(G_, device=dev), (tr - 1).clamp(min=0)]), (G_, cfg.vocab_size))

    def forward_decode_horizon(self, tokens, positions, entry_positions, step_idx: int,
                               k_cache, v_cache, page_tables, hk_all, hv_all,
                               counters=None, lora=None,
                               lora_idx: torch.Tensor | None = None,
                               rope_delta: torch.Tensor | None = None):
        """One decode column against the frozen cache + side buffers.

        ``tokens``/``positions`` [B] (positions = entry + step_idx),
        ``entry_positions`` [B] int32, ``page_tables`` [B, mp] int32,
        ``hk_all``/``hv_all`` [L, B, N, K*D]: this column's K/V land in
        ``[:, :, step_idx]`` in place; the cache itself is read only (the
        runner scatters the whole horizon once at the end).  Returns logits
        [B, V].  Reads nothing back to the host and creates no host tensor,
        so a CUDA graph can capture it; ``counters`` are the decode kernel's
        arrival counters (``ops/cuda/decode_attention.py``), preallocated
        by the caller for the largest batch it captures; ``lora_idx`` [B]
        each row's slot in the adapter bank ``lora``; ``rope_delta`` [B] each
        row's M-RoPE decode offset (generated tokens are text: the three
        axes are equal, so rope takes ``positions + rope_delta``)."""
        cfg = self.cfg
        B = tokens.shape[0]
        KD = cfg.num_kv_heads * cfg.head_dim
        cd = k_cache.dtype
        rope_positions = positions if rope_delta is None else positions + rope_delta
        h = self._enter((B, cfg.hidden_size), lambda: self.embed_tokens(tokens))  # [B, E]
        gates = self._gates(lora, lora_idx, h.dtype)
        for l in range(cfg.num_layers):
            q, k, v = self._qkv(l, self._norm(h, self.layers.attn_norm[l]), lora, gates)
            q = apply_rope(q[:, None], rope_positions[:, None], self.inv_freq)[:, 0]
            k = apply_rope(k[:, None], rope_positions[:, None], self.inv_freq)[:, 0]
            hk_all[l, :, step_idx] = k.reshape(B, KD).to(hk_all.dtype)
            hv_all[l, :, step_idx] = v.reshape(B, KD).to(hv_all.dtype)
            args = (q.to(cd).contiguous(), k_cache, v_cache, hk_all[l], hv_all[l],
                    step_idx + 1, l, page_tables, entry_positions, self.scale)
            kw = dict(softcap=cfg.attn_logit_softcap, window=layer_window(cfg, self.layer0 + l))
            if self.attention == "kernel":
                attn = paged_attention_decode_cached(*args, **kw, counters=counters)
            else:
                attn = attention_decode_cached(*args, **kw)
            h = self._attn_residual(l, h, attn.to(h.dtype), lora, gates)
            h = self._mlp_residual(l, h)
        return self._leave(h, lambda: self.unembed(h), (B, cfg.vocab_size))

    def forward_verify_block(self, tokens, entry_positions, k_cache, v_cache, page_tables,
                             rope_delta: torch.Tensor | None = None):
        """Speculative verify block: score W tokens per lane in one forward.

        ``tokens`` [B, W] (the last committed token, the drafts, padding)
        sit at positions ``entry .. entry + W - 1``; ``entry_positions``
        [B] int32, ``page_tables`` [B, mp] int32.  The block's K/V goes to
        side buffers and the cache is read only: the caller scatters the
        accepted columns once acceptance is known, so a rejected draft's KV
        never lands in a real slot.  ``rope_delta`` [B] each lane's M-RoPE
        decode offset (rope only).  Returns (logits [B, W, V], bk, bv
        [L, B, W, K*D]).  No host tensor and no sync: graph-capturable."""
        cfg = self.cfg
        B, W = tokens.shape
        L, KD = cfg.num_layers, cfg.num_kv_heads * cfg.head_dim
        pos = entry_positions.long()[:, None] + torch.arange(W, device=tokens.device)[None, :]
        if rope_delta is not None:
            pos = pos + rope_delta.long()[:, None]
        bk = torch.zeros((L, B, W, KD), dtype=k_cache.dtype, device=tokens.device)
        bv = torch.zeros_like(bk)
        h = self.embed_tokens(tokens)  # [B, W, E]
        for l in range(L):
            q, k, v = self._qkv(l, self._norm(h, self.layers.attn_norm[l]))
            q = apply_rope(q, pos, self.inv_freq)
            k = apply_rope(k, pos, self.inv_freq)
            bk[l] = k.reshape(B, W, KD).to(bk.dtype)
            bv[l] = v.reshape(B, W, KD).to(bv.dtype)
            attn = attention_verify_block(
                q, k_cache, v_cache, bk[l], bv[l], l, page_tables, entry_positions,
                self.scale, softcap=cfg.attn_logit_softcap, window=layer_window(cfg, self.layer0 + l))
            h = self._attn_residual(l, h, attn.to(h.dtype))
            h = self._mlp_residual(l, h)
        return self.unembed(h), bk, bv

    def forward_embed(self, tokens, lengths, token_tile: int = EMBED_TOKEN_TILE,
                      q_tile: int = EMBED_QUERY_TILE) -> torch.Tensor:
        """Sequence embeddings (the reference's ``forward_embed``): the
        final-norm hidden state of each row's last valid token,
        L2-normalised, [B, E] float32.  ``tokens`` [B, T] right-padded,
        ``lengths`` [B] (0 for a padded row).  Every layer attends densely
        and causally, without per-layer windows (the runner bounds the
        lengths).  Rows go through in tiles of ``token_tile`` // T (at least
        one): a row's result depends on that row alone."""
        B, T = tokens.shape
        rows = max(1, token_tile // T)
        return torch.cat([self._embed_rows(tokens[r:r + rows], lengths[r:r + rows], q_tile)
                          for r in range(0, B, rows)])

    def _embed_rows(self, tokens, lengths, q_tile: int) -> torch.Tensor:
        B = tokens.shape[0]
        dev = tokens.device
        h = self.embed_tokens(tokens)
        for l in range(self.cfg.num_layers):
            h = self.decoder_layer_train(l, h, lengths, q_tile)
        last = h[torch.arange(B, device=dev), (lengths.long() - 1).clamp(min=0)]
        last = self._norm(last, self.final_norm).float()
        return last / last.norm(dim=-1, keepdim=True).clamp(min=1e-12)

    def forward_train(self, tokens: torch.Tensor, ring: bool = False) -> torch.Tensor:
        """Dense causal forward for training and eval logprobs (the
        reference's ``forward_train``): ``tokens`` [B, T] -> float32 logits
        [B, T, V].  No KV cache, no kernel and no per-layer window: a
        windowed model refuses a T past its window, as the reference does.
        On a training mesh with an sp group, ``tokens`` are the rank's
        ``T`` positions of a ``T * sp`` sequence and the logits theirs;
        ``ring`` attends through the training ring (the reference's
        ``ring_mesh``), else over the keys and values gathered from every
        sp rank."""
        return self.unembed(self.layers_train(self.embed_tokens(tokens), ring))

    def layers_train(self, h: torch.Tensor, ring: bool = False) -> torch.Tensor:
        """This model's layers over ``h`` [B, T, E] as ``forward_train``
        runs them (a pipeline stage's part of it)."""
        cfg = self.cfg
        B, T = h.shape[:2]
        pos0 = 0 if self.sp is None else self.sp.rank * T
        T_all = T if self.sp is None else T * self.sp.size
        if cfg.sliding_window and T_all > cfg.sliding_window:
            raise ValueError(
                f"training supports contexts <= sliding_window "
                f"({cfg.sliding_window}); got {T_all}"
            )
        lengths = torch.full((B,), T_all, device=h.device)
        for l in range(cfg.num_layers):
            h = self.decoder_layer_train(l, h, lengths, pos0=pos0, sp=self.sp, ring=ring)
        return h

    def decoder_layer_train(self, l: int, h: torch.Tensor, lengths: torch.Tensor,
                            q_tile: int = EMBED_QUERY_TILE, pos0: int = 0, sp=None,
                            ring: bool = False) -> torch.Tensor:
        """Layer ``l`` over ``h`` [B, T, E], dense and causal in float32
        (``causal_attention``: keys past a row's ``lengths`` unseen), rope at
        positions ``pos0 .. pos0+T-1``: the reference's
        ``decoder_layer_train`` and the layer of its ``forward_embed``.
        With ``sp`` (the rank's sp group; ``h`` its positions) the queries
        attend over every sp rank's keys: round the training ring when
        ``ring``, else gathered."""
        B, T = h.shape[:2]
        pos = torch.arange(pos0, pos0 + T, device=h.device)[None].expand(B, T)
        x = self._fan_out(self.tp, self._norm(h, self.layers.attn_norm[l]))
        q, k, v = self._qkv(l, x)
        q = apply_rope(q, pos, self.inv_freq)
        k = apply_rope(k, pos, self.inv_freq)
        if sp is not None and ring:
            attn = ring_attention_train(q, k, v, self.scale, sp)
        else:
            if sp is not None:
                k, v = gather_summed(sp, k, dim=1), gather_summed(sp, v, dim=1)
            attn = causal_attention(q, k, v, lengths, self.scale,
                                    softcap=self.cfg.attn_logit_softcap, q_tile=q_tile, q0=pos0)
        h = self._attn_residual(l, h, attn.to(h.dtype))
        return self._mlp_residual(l, h)

    def forward_decode(self, tokens, positions, k_cache, v_cache, page_tables,
                       rope_delta: torch.Tensor | None = None):
        """One decode step for the batch (the compat path the draft
        proposer runs): ``tokens``/``positions`` [B] (position = the
        token's own, ctx len - 1), ``page_tables`` [B, mp] int32.  Writes
        each token's KV into the cache in place (positions past the table
        go to the garbage page) and returns logits [B, V].  ``rope_delta``
        [B]: rope takes ``positions + rope_delta``, the cache ``positions``."""
        cfg = self.cfg
        B = tokens.shape[0]
        ps = k_cache.shape[2]
        mp = page_tables.shape[1]
        pos = positions.long()
        valid = pos < mp * ps
        pos_c = pos.clamp(max=mp * ps - 1)
        page = torch.gather(page_tables.long(), 1, (pos_c // ps)[:, None])[:, 0]
        dest = torch.where(valid, page * ps + pos_c % ps, 0)
        rope_positions = positions if rope_delta is None else positions + rope_delta
        h = self.embed_tokens(tokens)  # [B, E]
        for l in range(cfg.num_layers):
            q, k, v = self._qkv(l, self._norm(h, self.layers.attn_norm[l]))
            q = apply_rope(q[:, None], rope_positions[:, None], self.inv_freq)[:, 0]
            k = apply_rope(k[:, None], rope_positions[:, None], self.inv_freq)[:, 0]
            scatter_kv_pages_full(k_cache, v_cache, l, k, v, dest)
            attn = attention_decode(
                q, k_cache[l], v_cache[l], page_tables, positions, self.scale,
                softcap=cfg.attn_logit_softcap, window=layer_window(cfg, self.layer0 + l))
            h = self._attn_residual(l, h, attn.to(h.dtype))
            h = self._mlp_residual(l, h)
        return self.unembed(h)
