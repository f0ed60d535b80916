"""Ring attention: sequence-parallel causal attention over the sp group —
the port of ``smg_tpu/parallel/ring_attention.py`` (``_ring_attention_local``,
``ring_attention``).

Blockwise ring attention (Liu et al.): each sp rank takes its ``T / sp``
shard of the chunk's queries, keys and values; the key/value shards rotate
round the ring (``AxisGroup.exchange``, every send and receive of a step
posted together), and each rank folds every visiting block into its
queries' online-softmax statistics, in float32 as the reference keeps
them.  Rank d's queries sit at ``[d*T/sp, (d+1)*T/sp)``; the block visiting
at step i came from rank ``(d - i) mod sp``, so a block wholly in the future
is masked, the diagonal one is triangular and past ones are whole.  The
shards' outputs are all-gathered over sp, so every rank holds the chunk's
attention, as the reference's replicated out-spec leaves it.

Training (``ring_attention_train``) keeps each rank's shard as it is: the
model under sp holds only its ``T / sp`` positions.  Its backward is a second
ring, the transpose of the reference's ``ppermute`` scan as ``jax.grad``
derives it: each rank recomputes the probabilities of every visiting block
from the float32 log-sum-exp the forward saved, accumulates its queries'
gradient locally, and hands each block on together with the key and value
gradients its queries added; after ``sp`` hops every block and its
gradients are home.  No rank ever holds the whole sequence.

The reference computes this with einsums outside any Pallas kernel, so it
is owed no hand-written kernel: these are plain torch ops.  Like the
reference it knows no logit softcap and no window (``config/validation.py``
refuses sp for such models)."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                         sp) -> torch.Tensor:
    """One rank's body: ``q`` [B, Tl, H, D] its query shard (after rope),
    ``k``/``v`` [B, Tl, K, D] its key/value shard; ``sp`` its
    ``parallel/group.py::AxisGroup``.  Returns [B, Tl, H, D] in ``q``'s
    dtype."""
    out, _ = _ring_fold(q, k, v, scale, sp)
    return out.reshape(q.shape).to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                   sp) -> torch.Tensor:
    """Causal attention of a whole chunk held by every sp rank: ``q`` [B, T,
    H, D], ``k``/``v`` [B, T, K, D].  Each rank ring-attends its shard and
    the shards are gathered back; T is padded up to a multiple of sp with
    rows at later positions, which no real query sees.  Returns [B, T, H, D]
    in ``q``'s dtype on every rank."""
    n = sp.size
    T = q.shape[1]
    Tl = -(-T // n)
    if Tl * n != T:
        pad = lambda x: torch.nn.functional.pad(x, (0, 0, 0, 0, 0, Tl * n - T))  # noqa: E731
        q, k, v = pad(q), pad(k), pad(v)
    s = slice(sp.rank * Tl, (sp.rank + 1) * Tl)
    out = ring_attention_local(q[:, s], k[:, s].contiguous(), v[:, s].contiguous(), scale, sp)
    return sp.all_gather(out, dim=1)[:, :T]


def _ring_fold(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, sp
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward fold of ``ring_attention_local``: (the float32 output
    [B, Tl, K, G, D], the float32 log-sum-exp [B, Tl, K, G, 1])."""
    n, me = sp.size, sp.rank
    B, Tl, H, D = q.shape
    K = k.shape[2]
    dev = q.device
    qf = q.float().reshape(B, Tl, K, H // K, D)
    ar = torch.arange(Tl, device=dev)
    q_pos = me * Tl + ar
    m = torch.full((B, Tl, K, H // K, 1), NEG_INF, dtype=torch.float32, device=dev)
    den = torch.zeros_like(m)
    acc = torch.zeros((B, Tl, K, H // K, D), dtype=torch.float32, device=dev)
    k_cur, v_cur = k, v
    for i in range(n):
        k_pos = ((me - i) % n) * Tl + ar
        scores = torch.einsum("btkgd,bskd->btkgs", qf, k_cur.float()) * scale
        seen = q_pos[:, None] >= k_pos[None, :]
        scores = torch.where(seen[None, :, None, None, :], scores, NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new)
        den = den * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("btkgs,bskd->btkgd", p, v_cur.float())
        m = m_new
        if i < n - 1:
            k_cur, v_cur = sp.exchange([k_cur, v_cur], dst=(me + 1) % n, src=(me - 1) % n)
    den = den.clamp(min=1e-20)
    return acc / den, m + torch.log(den)


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, sp):
        out, lse = _ring_fold(q, k, v, scale, sp)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.sp = scale, sp
        return out.reshape(q.shape).to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        sp, scale = ctx.sp, ctx.scale
        n, me = sp.size, sp.rank
        B, Tl, H, D = q.shape
        K = k.shape[2]
        dev = q.device
        qf = q.float().reshape(B, Tl, K, H // K, D)
        do = dout.float().reshape(B, Tl, K, H // K, D)
        delta = (do * out).sum(dim=-1, keepdim=True)  # [B, Tl, K, G, 1]
        ar = torch.arange(Tl, device=dev)
        q_pos = me * Tl + ar
        dq = torch.zeros_like(qf)
        k_cur, v_cur = k, v
        dk = torch.zeros(k.shape, dtype=torch.float32, device=dev)
        dv = torch.zeros_like(dk)
        for i in range(n):
            k_pos = ((me - i) % n) * Tl + ar
            kf, vf = k_cur.float(), v_cur.float()
            scores = torch.einsum("btkgd,bskd->btkgs", qf, kf) * scale
            seen = q_pos[:, None] >= k_pos[None, :]
            scores = torch.where(seen[None, :, None, None, :], scores, NEG_INF)
            p = torch.exp(scores - lse)
            dv = dv + torch.einsum("btkgs,btkgd->bskd", p, do)
            ds = p * (torch.einsum("btkgd,bskd->btkgs", do, vf) - delta) * scale
            dq = dq + torch.einsum("btkgs,bskd->btkgd", ds, kf)
            dk = dk + torch.einsum("btkgs,btkgd->bskd", ds, qf)
            # the block and the gradients its visits added travel on; after
            # n hops they are home
            dst, src = (me + 1) % n, (me - 1) % n
            if i < n - 1:
                k_cur, v_cur, dk, dv = sp.exchange([k_cur, v_cur, dk, dv], dst=dst, src=src)
            elif n > 1:
                dk, dv = sp.exchange([dk, dv], dst=dst, src=src)
        return (dq.reshape(q.shape).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None)


def ring_attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                         sp) -> torch.Tensor:
    """Differentiable ring attention of one rank's shard: ``q`` [B, Tl, H, D]
    at global positions ``[sp.rank*Tl, (sp.rank+1)*Tl)`` (after rope),
    ``k``/``v`` [B, Tl, K, D] of the same positions; ``sp`` the rank's sp
    ``AxisGroup``.  The forward is ``ring_attention_local``'s; the backward
    the second ring above.  Returns [B, Tl, H, D] in ``q``'s dtype."""
    return _RingAttention.apply(q, k.contiguous(), v.contiguous(), scale, sp)
