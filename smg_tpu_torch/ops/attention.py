"""Attention over the paged KV cache — plain PyTorch versions (port of
``smg_tpu/ops/attention.py``).

Layout (per layer): ``[num_pages, page_size, kv_heads*head_dim]`` — the
kv-head and head-dim axes fused into one trailing axis, exactly the JAX
package's layout, so page tables, the radix cache and the tests compare like
with like.  Page 0 is the garbage page: padded/inactive tokens scatter there.

Most of these functions are the correctness reference for the hand-written
CUDA kernels in ``smg_tpu_torch/ops/cuda/`` and the path the CPU tests run.
Two are the port itself on every device, as they are XLA code with no
Pallas kernel in the reference: ``attention_verify_block`` (speculative
verify) and ``attention_decode`` (the draft model's compat decode).
Scores are computed in f32 whatever the input dtype.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _window_on(window) -> bool:
    return window is not None and int(window) > 0


def scatter_kv_pages_full(
    k_cache: torch.Tensor,  # [L, P, ps, KD] — full stacked cache, updated IN PLACE
    v_cache: torch.Tensor,
    layer: int,
    k_new: torch.Tensor,  # [T, K, D] (or [T, KD])
    v_new: torch.Tensor,
    dest_slots: torch.Tensor,  # [T] flat slot index (page*ps + offset)
) -> None:
    """Write new K/V rows into one layer of the cache.

    The JAX version returns new arrays and relies on buffer donation to make
    the update in place; here the write is an explicit in-place
    ``index_copy_`` on the flattened ``[L, P*ps, KD]`` view.  Several padded
    rows may target the garbage page 0; which of them lands there does not
    matter (nothing reads page 0 as context)."""
    L, P, ps, KD = k_cache.shape
    T = k_new.shape[0]
    dest = dest_slots.to(device=k_cache.device, dtype=torch.long)
    k_cache.view(L, P * ps, KD)[layer].index_copy_(
        0, dest, k_new.reshape(T, KD).to(k_cache.dtype))
    v_cache.view(L, P * ps, KD)[layer].index_copy_(
        0, dest, v_new.reshape(T, KD).to(v_cache.dtype))


def gather_seq_kv(
    k_pages: torch.Tensor,  # [P, ps, KD]
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # [mp] page ids for one sequence
    num_kv_heads: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Materialize one sequence's KV contiguously: [mp*ps, K, D]."""
    idx = page_table.to(device=k_pages.device, dtype=torch.long)
    k = k_pages[idx]
    v = v_pages[idx]
    mp, ps, KD = k.shape
    K = num_kv_heads
    return k.reshape(mp * ps, K, KD // K), v.reshape(mp * ps, K, KD // K)


def _softcap(scores: torch.Tensor, softcap: float | None) -> torch.Tensor:
    if softcap:
        return softcap * torch.tanh(scores / softcap)
    return scores


def attention_prefill(
    q: torch.Tensor,  # [T, H, D] new tokens, post-rope
    k_ctx: torch.Tensor,  # [S, K, D] contiguous KV incl. prefix and new tokens
    v_ctx: torch.Tensor,
    q_positions: torch.Tensor,  # [T] global positions of the new tokens
    ctx_len,  # total valid tokens in k_ctx
    scale: float,
    softcap: float | None = None,
    window=None,  # sliding window (None/<=0 = global)
) -> torch.Tensor:
    """Causal attention for one sequence's prefill chunk. GQA-aware."""
    return attention_prefill_batched(
        q[None], k_ctx[None], v_ctx[None], q_positions[None],
        torch.as_tensor([int(ctx_len)], device=q.device), scale,
        softcap=softcap, window=window,
    )[0]


def attention_prefill_batched(
    q: torch.Tensor,  # [G, T, H, D]
    k_ctx: torch.Tensor,  # [G, S, K, D] per-sequence contiguous KV
    v_ctx: torch.Tensor,
    q_positions: torch.Tensor,  # [G, T] global positions
    ctx_lens: torch.Tensor,  # [G] valid tokens per row
    scale: float,
    softcap: float | None = None,
    window=None,
) -> torch.Tensor:
    """Batched multi-sequence prefill attention (one row per sequence)."""
    G_, T, H, D = q.shape
    S, K = k_ctx.shape[1], k_ctx.shape[2]
    Gq = H // K
    qf = q.float().reshape(G_, T, K, Gq, D)
    scores = torch.einsum("gtkhd,gskd->gtkhs", qf, k_ctx.float()) * scale
    scores = _softcap(scores, softcap)
    j = torch.arange(S, device=q.device)
    qp = q_positions.to(q.device)
    mask = (j[None, None, :] <= qp[:, :, None]) & (
        j[None, None, :] < ctx_lens.to(q.device)[:, None, None])
    if _window_on(window):
        mask = mask & (j[None, None, :] > qp[:, :, None] - int(window))
    scores = torch.where(mask[:, :, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("gtkhs,gskd->gtkhd", probs, v_ctx.float())
    return out.reshape(G_, T, H, D).to(q.dtype)


def attention_decode_cached(
    q: torch.Tensor,  # [B, H, D]
    k_cache: torch.Tensor,  # [L, P, ps, KD] read-only cache
    v_cache: torch.Tensor,
    hk: torch.Tensor,  # [B, N, KD] horizon side buffer (this layer)
    hv: torch.Tensor,
    n_extra: int,  # valid side rows (current token included)
    layer: int,
    page_tables: torch.Tensor,  # [B, mp]
    entry_positions: torch.Tensor,  # [B] cache token count at horizon entry
    scale: float,
    softcap: float | None = None,
    window=None,
) -> torch.Tensor:
    """Horizon-decode attention: cache tokens < entry plus the first
    ``n_extra`` side-buffer rows, one joint softmax.

    Padded rows (``entry >= mp*ps``, decode-bucket padding) attend the side
    buffer only, as the Pallas kernel (``decode_attention.py``) does; the
    JAX XLA version lets them attend their all-garbage page table instead.
    Either way the row is finite and its output is discarded."""
    B, H, D = q.shape
    L, P, ps, KD = k_cache.shape
    K = KD // D
    N = hk.shape[1]
    G = H // K
    idx = page_tables.to(device=k_cache.device, dtype=torch.long)
    kl = k_cache[layer][idx]  # [B, mp, ps, KD]
    vl = v_cache[layer][idx]
    mp = kl.shape[1]
    S = mp * ps
    k_all = torch.cat([kl.reshape(B, S, K, D), hk.reshape(B, N, K, D).to(kl.dtype)], 1)
    v_all = torch.cat([vl.reshape(B, S, K, D), hv.reshape(B, N, K, D).to(vl.dtype)], 1)
    qf = q.float().reshape(B, K, G, D)
    scores = torch.einsum("bkgd,bskd->bkgs", qf, k_all.float()) * scale
    scores = _softcap(scores, softcap)
    entry = entry_positions.to(device=q.device, dtype=torch.long)[:, None]
    j = torch.arange(S + N, device=q.device)[None, :]
    live_cache = entry < S  # padded rows attend the side buffer only
    mask = torch.where(j < S, (j < entry) & live_cache, (j - S) < n_extra)
    if _window_on(window):
        key_pos = torch.where(j < S, j, entry + (j - S))
        q_pos = entry + n_extra - 1
        mask = mask & (key_pos > q_pos - int(window))
    scores = torch.where(mask[:, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v_all.float())
    return out.reshape(B, H, D).to(q.dtype)


def attention_verify_block(
    q: torch.Tensor,  # [B, W, H, D] one verify block per lane, post-rope
    k_cache: torch.Tensor,  # [L, P, ps, KD] read-only cache
    v_cache: torch.Tensor,
    bk: torch.Tensor,  # [B, W, KD] the block's own K/V (this layer)
    bv: torch.Tensor,
    layer: int,
    page_tables: torch.Tensor,  # [B, mp]
    entry_positions: torch.Tensor,  # [B] cache token count at block entry
    scale: float,
    softcap: float | None = None,
    window=None,
) -> torch.Tensor:
    """Speculative verify attention: W query tokens per lane (the last
    committed token and the drafted columns) against the lane's cache keys
    below its entry plus the block's own rows, causal within the block, one
    joint softmax.  The block's K/V lives in side buffers, not the cache:
    the caller scatters only the accepted columns once acceptance is known.
    The multi-query cousin of ``attention_decode_cached``, with the
    reference's masks (a padded lane attends its all-garbage page table, as
    in the reference; its output is discarded)."""
    B, W, H, D = q.shape
    L, P, ps, KD = k_cache.shape
    K = KD // D
    G = H // K
    idx = page_tables.to(device=k_cache.device, dtype=torch.long)
    kl = k_cache[layer][idx]  # [B, mp, ps, KD]
    vl = v_cache[layer][idx]
    S = kl.shape[1] * ps
    k_all = torch.cat([kl.reshape(B, S, K, D), bk.reshape(B, W, K, D).to(kl.dtype)], 1)
    v_all = torch.cat([vl.reshape(B, S, K, D), bv.reshape(B, W, K, D).to(vl.dtype)], 1)
    qf = q.float().reshape(B, W, K, G, D)
    scores = torch.einsum("bwkgd,bskd->bwkgs", qf, k_all.float()) * scale
    scores = _softcap(scores, softcap)
    entry = entry_positions.to(device=q.device, dtype=torch.long)[:, None, None]
    j = torch.arange(S + W, device=q.device)[None, None, :]
    w_idx = torch.arange(W, device=q.device)[None, :, None]
    # cache key j is valid below the entry; block row i is visible to query
    # column w iff i <= w
    mask = torch.where(j < S, j < entry, (j - S) <= w_idx)  # [B, W, S+W]
    if _window_on(window):
        key_pos = torch.where(j < S, j, entry + (j - S))
        mask = mask & (key_pos > entry + w_idx - int(window))
    scores = torch.where(mask[:, :, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bwkgs,bskd->bwkgd", probs, v_all.float())
    return out.reshape(B, W, H, D).to(q.dtype)


def attention_decode(
    q: torch.Tensor,  # [B, H, D] one new token per sequence, post-rope
    k_pages: torch.Tensor,  # [P, ps, KD] one layer of the cache
    v_pages: torch.Tensor,
    page_tables: torch.Tensor,  # [B, mp]
    positions: torch.Tensor,  # [B] position of the new token (= ctx len - 1)
    scale: float,
    softcap: float | None = None,
    window=None,
) -> torch.Tensor:
    """Batched single-token attention over paged KV whose new token is
    already in the cache (the compat decode the draft model's proposer
    runs): keys at positions <= the token's own, GQA-aware."""
    B, H, D = q.shape
    P, ps, KD = k_pages.shape
    K = KD // D
    G = H // K
    idx = page_tables.to(device=k_pages.device, dtype=torch.long)
    k = k_pages[idx]  # [B, mp, ps, KD]
    v = v_pages[idx]
    S = k.shape[1] * ps
    qf = q.float().reshape(B, K, G, D)
    scores = torch.einsum("bkgd,bskd->bkgs", qf, k.reshape(B, S, K, D).float()) * scale
    scores = _softcap(scores, softcap)
    pos = positions.to(device=q.device, dtype=torch.long)[:, None]
    j = torch.arange(S, device=q.device)[None, :]
    mask = j <= pos
    if _window_on(window):
        mask = mask & (j > pos - int(window))
    scores = torch.where(mask[:, None, None, :], scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v.reshape(B, S, K, D).float())
    return out.reshape(B, H, D).to(q.dtype)
