"""Batched sampling: temperature / top-k / top-p / min-p with a greedy mix
(port of ``smg_tpu/engine/sampling.py::sample_tokens``).

Same algorithm as the JAX package — no full-vocab sort: per-row probability
thresholds come from the top ``K_CAP`` candidates, then a gumbel-argmax over
the filtered logits.  top-k is exact for ``top_k <= K_CAP``; top-p is exact
whenever the nucleus fits in ``K_CAP`` candidates and otherwise keeps the
whole distribution (wider, never narrower, than requested).

The gumbel noise comes from an explicit ``torch.Generator``: it does not
reproduce ``jax.random``'s bits, so tests compare distributions (and exact
greedy tokens), not sampled streams.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30
K_CAP = 64  # top-k candidates examined for thresholds


def sample_tokens(
    logits: torch.Tensor,  # [B, V] float32
    generator: torch.Generator,
    temperature: torch.Tensor,  # [B] (0 => greedy)
    top_k: torch.Tensor,  # [B] int (-1 => disabled)
    top_p: torch.Tensor,  # [B] (1.0 => disabled)
    min_p: torch.Tensor,  # [B] (0.0 => disabled)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (tokens [B] int64, logprobs [B] float32 of the chosen token
    under the unfiltered distribution — OpenAI logprob semantics)."""
    B, V = logits.shape
    dev = logits.device
    inf = torch.tensor(float("inf"), device=dev)
    greedy = temperature <= 0.0
    safe_temp = torch.where(greedy, torch.ones_like(temperature), temperature)
    z = (logits / safe_temp[:, None]).float()

    # top-K_CAP candidates give every threshold needed
    k_cap = min(K_CAP, V)
    top_vals = torch.topk(z, k_cap, dim=-1).values  # [B, k_cap] descending
    top_k = top_k.long()
    k_eff = torch.where(top_k <= 0, torch.full_like(top_k, k_cap), top_k.clamp(max=k_cap))
    kth = top_vals.gather(1, (k_eff - 1)[:, None])[:, 0]
    thresh_k = torch.where(top_k <= 0, -inf, kth)

    # top-p over the distribution AFTER top-k renormalization (sequential
    # filters): with top-k on, the candidates cover the whole filtered set
    cand_idx = torch.arange(k_cap, device=dev)[None, :]
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
    zf = torch.where(z >= thresh[:, None], z, torch.full_like(z, NEG_INF))

    u = torch.rand(z.shape, generator=generator, device=dev, dtype=torch.float32)
    g = -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))
    sampled = torch.argmax(zf + g, dim=-1)
    tokens = torch.where(greedy, torch.argmax(logits, dim=-1), sampled)

    lf = logits.float()
    chosen = lf.gather(1, tokens[:, None])[:, 0]
    return tokens, chosen - torch.logsumexp(lf, dim=-1)
