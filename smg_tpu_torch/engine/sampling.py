"""Batched sampling: temperature / top-k / top-p / min-p with a greedy mix,
a grammar vocab mask, and OpenAI/HF penalties (port of
``smg_tpu/engine/sampling.py``: ``sample_tokens``, ``sample_tokens_exact``,
``apply_penalties``).

Same algorithm as the JAX package — no full-vocab sort: per-row probability
thresholds come from the top ``K_CAP`` candidates, then a gumbel-argmax over
the filtered logits.  top-k is exact for ``top_k <= K_CAP``; top-p is exact
whenever the nucleus fits in ``K_CAP`` candidates and otherwise keeps the
whole distribution (wider, never narrower, than requested).

The gumbel noise is a pure function of (seed, counter, row, vocab index): a
counter-based integer hash in plain int64 torch ops, identical on the CPU
and on the card.  The counter plays the part of the JAX runner's folded key
step (``runner._next_key``): a discarded launch rewinds it on the host with
integer arithmetic, and a CUDA graph reads it from a device tensor that the
host sets before each replay.  It does not reproduce ``jax.random``'s bits,
so tests compare distributions (and exact greedy tokens), not sampled
streams.  ``sample_tokens_exact`` is the full-sort reference (exact for any
top_k/top_p), with the same noise; ``SMG_EXACT_SAMPLING=1`` selects it as
the JAX runner's ``_pick_sampler`` does.
"""

from __future__ import annotations

import os

import torch

NEG_INF = -1e30
K_CAP = 64  # top-k candidates examined for thresholds
_M32 = 0xFFFFFFFF
# odd multipliers below 2**31: a 32-bit value times one stays under 2**63,
# so the int64 products never overflow
_C1, _C2 = 0x7FEB352D, 0x2C1B3C6D
_GOLDEN = 0x9E3779B9


def _mix32(x):
    """A 32-bit integer finaliser (xorshift-multiply) on a Python int or an
    int64 tensor of non-negative values."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = (x * _C1) & _M32
    x = x ^ (x >> 15)
    x = (x * _C2) & _M32
    return x ^ (x >> 16)


def gumbel_noise(seed: int, counter, B: int, V: int, device) -> torch.Tensor:
    """[B, V] float32 gumbel noise for one sampling step.  ``counter`` is a
    Python int or an int64 tensor of one element on ``device``; row r of
    the result depends only on (seed, counter, r), not on B."""
    if not torch.is_tensor(counter):
        counter = torch.tensor([counter], dtype=torch.int64, device=device)
    k1 = _mix32(counter ^ _mix32(seed & _M32))
    k2 = _mix32(k1 + _GOLDEN)
    idx = torch.arange(B * V, dtype=torch.int64, device=device).view(B, V)
    h = _mix32(_mix32(idx ^ k1) + k2)
    u = ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))  # in (0, 1), never 0 or 1
    return -torch.log(-torch.log(u))


def sample_tokens(
    logits: torch.Tensor,  # [B, V] float32
    seed: int,
    counter,  # int, or an int64 tensor of one element on the logits' device
    temperature: torch.Tensor,  # [B] (0 => greedy)
    top_k: torch.Tensor,  # [B] int (-1 => disabled)
    top_p: torch.Tensor,  # [B] (1.0 => disabled)
    min_p: torch.Tensor,  # [B] (0.0 => disabled)
    mask: torch.Tensor | None = None,  # [B, V] bool: sampleable vocabulary
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (tokens [B] int64, logprobs [B] float32 of the chosen token
    under the unfiltered distribution — OpenAI logprob semantics).  Creates
    no host tensor and reads nothing back, so it runs inside a CUDA graph
    capture.

    ``mask`` (grammar-constrained decoding) hard-excludes tokens before any
    filtering; logprobs are then reported under the mask-renormalised
    distribution, since the excluded tokens were never sampleable."""
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    B, V = logits.shape
    inf = float("inf")
    greedy = temperature <= 0.0
    safe_temp = torch.where(greedy, 1.0, temperature)
    z = (logits / safe_temp[:, None]).float()

    # top-K_CAP candidates give every threshold needed
    k_cap = min(K_CAP, V)
    top_vals = torch.topk(z, k_cap, dim=-1).values  # [B, k_cap] descending
    top_k = top_k.long()
    k_eff = torch.where(top_k <= 0, k_cap, top_k.clamp(max=k_cap))
    kth = top_vals.gather(1, (k_eff - 1)[:, None])[:, 0]
    thresh_k = torch.where(top_k <= 0, -inf, kth)

    # top-p over the distribution AFTER top-k renormalization (sequential
    # filters): with top-k on, the candidates cover the whole filtered set
    cand_idx = torch.arange(k_cap, device=logits.device)[None, :]
    in_topk = cand_idx < k_eff[:, None]
    masked_vals = torch.where(in_topk | (top_k[:, None] <= 0), top_vals, -inf)
    lse_full = torch.logsumexp(z, dim=-1, keepdim=True)
    lse_topk = torch.logsumexp(masked_vals, dim=-1, keepdim=True)
    denom = torch.where((top_k > 0)[:, None], lse_topk, lse_full)
    cand_probs = torch.exp(masked_vals - denom)  # [B, k_cap] descending
    cum_excl = torch.cumsum(cand_probs, dim=-1) - cand_probs
    in_nucleus = (cum_excl < top_p[:, None]) & (cand_probs > 0)  # keeps top-1
    # nucleus spilling past K_CAP (top-k off): conservatively keep everything
    spills = (cum_excl[:, -1] + cand_probs[:, -1] < top_p) & (top_k <= 0)
    thresh_p = torch.where(in_nucleus, top_vals, inf).min(dim=-1).values
    thresh_p = torch.where(spills | (top_p >= 1.0), -inf, thresh_p)

    # min-p: min_p * max_prob, in logit space
    thresh_m = torch.where(
        min_p > 0.0, top_vals[:, 0] + torch.log(min_p.clamp(min=1e-10)), -inf)

    thresh = torch.maximum(torch.maximum(thresh_k, thresh_p), thresh_m)
    zf = torch.where(z >= thresh[:, None], z, NEG_INF)
    sampled = torch.argmax(zf + gumbel_noise(seed, counter, B, V, logits.device), dim=-1)
    tokens = torch.where(greedy, torch.argmax(logits, dim=-1), sampled)

    lf = logits.float()
    chosen = lf.gather(1, tokens[:, None])[:, 0]
    return tokens, chosen - torch.logsumexp(lf, dim=-1)


def sample_tokens_exact(
    logits: torch.Tensor,
    seed: int,
    counter,
    temperature: torch.Tensor,
    top_k: torch.Tensor,
    top_p: torch.Tensor,
    min_p: torch.Tensor,
    mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sort reference (exact for any top_k/top_p): sequential top-k,
    top-p and min-p filters over the sorted distribution, then the same
    gumbel-argmax as ``sample_tokens``.  Graph-capturable too."""
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    B, V = logits.shape
    greedy = temperature <= 0.0
    safe_temp = torch.where(greedy, 1.0, temperature)
    z = logits / safe_temp[:, None]

    order = torch.argsort(-z, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True)
    top_k = top_k.long()
    k_eff = torch.where(top_k <= 0, V, top_k)
    z = torch.where(ranks < k_eff[:, None], z, NEG_INF)

    probs = torch.softmax(z, dim=-1)
    sorted_probs = probs.gather(1, order)
    cum_excl = torch.cumsum(sorted_probs, dim=-1) - sorted_probs
    keep = (cum_excl < top_p[:, None]).gather(1, ranks)
    z = torch.where(keep, z, NEG_INF)

    probs = torch.softmax(z, dim=-1)
    max_prob = probs.max(dim=-1, keepdim=True).values
    z = torch.where(probs >= min_p[:, None] * max_prob, z, NEG_INF)

    sampled = torch.argmax(z + gumbel_noise(seed, counter, B, V, logits.device), dim=-1)
    tokens = torch.where(greedy, torch.argmax(logits, dim=-1), sampled)
    chosen = torch.log_softmax(logits.float(), dim=-1).gather(1, tokens[:, None])[:, 0]
    return tokens, chosen


def pick_sampler():
    """``SMG_EXACT_SAMPLING=1`` selects the full-sort exact sampler (no
    top-k cap), as the JAX runner's ``_pick_sampler`` does."""
    return sample_tokens_exact if os.environ.get("SMG_EXACT_SAMPLING") == "1" else sample_tokens


def apply_penalties(
    logits: torch.Tensor,  # [B, V] float32
    output_counts: torch.Tensor,  # [B, V] int32: count of each token in the output so far
    prompt_mask: torch.Tensor,  # [B, V] bool: token appeared in the prompt
    frequency_penalty: torch.Tensor,  # [B]
    presence_penalty: torch.Tensor,  # [B]
    repetition_penalty: torch.Tensor,  # [B]
) -> torch.Tensor:
    """OpenAI frequency/presence penalties + HF-style repetition penalty, on
    float32 logits.  No host tensor and no sync: graph-capturable."""
    logits = logits - frequency_penalty[:, None] * output_counts
    seen_out = output_counts > 0
    logits = logits - presence_penalty[:, None] * seen_out
    seen = seen_out | prompt_mask
    rp = repetition_penalty[:, None]
    penalized = torch.where(logits > 0, logits / rp, logits * rp)
    return torch.where(seen, penalized, logits)
