"""Pipeline parallelism of the training step over the ``pp`` group — the
counterpart of ``smg_tpu/parallel/pipeline.py`` (``pipeline_apply``).

The reference runs its microbatch schedule as one SPMD program: M + S - 1
ticks of a ``lax.scan`` in which every stage computes (idle ticks on zero
microbatches), ``ppermute`` handing ``h`` on, and ``jax.grad`` of that scan
as the backward: all forwards, then all backwards (GPipe), every
microbatch's activations held until its backward.  Here every stage is a
process of its own (``parallel/group.py``), so nothing is computed to be
thrown away: each stage receives a microbatch's ``h`` from the stage before
it (the first embeds), runs its layers and sends ``h`` on; the last stage
holds ``final_norm`` and ``lm_head`` (``parallel/sharding.py``) and turns
its ``h`` into the microbatch's loss.  A microbatch's backward runs on the
last stage and goes back stage by stage: each stage receives the gradient
of its output and sends the gradient of its input.  The parameters'
gradients accumulate over the microbatches.

The order is one-forward-one-backward (1F1B, as Megatron-LM's
non-interleaved schedule): stage s runs ``S - 1 - s`` forwards ahead, then
alternates a forward and the backward of its oldest microbatch, then
drains the backwards.  The gradients are GPipe's (the same sums, in another
order), but a stage holds at most ``S - s`` microbatches' activations where
GPipe holds all M: at Llama-3-8B's full depth in bf16, two stages with 4
microbatches of 512 tokens need ~75 GB on one card instead of ~93.  A send
and the receive that the neighbour pairs with it are posted together
(``AxisGroup.exchange``), so no two stages wait on each other.

Under pp x tp the tp collectives inside a stage's forward and backward run
in the same order on every tp rank of the stage (one program, one autograd
graph), so the groups never wait on each other."""

from __future__ import annotations

from collections import deque

import torch


def check_microbatches(batch: int, microbatches: int) -> None:
    """The reference's error, with its words (``pipeline_apply``)."""
    if batch % microbatches != 0:
        raise ValueError(f"batch {batch} not divisible by num_microbatches {microbatches}")


def check_stages(num_layers: int, stages: int) -> None:
    """The reference's error, with its words (``pipeline_apply``)."""
    if num_layers % stages != 0:
        raise ValueError(f"num_layers {num_layers} not divisible by pp={stages}")


def local_microbatches(batch: int, rows: int, microbatches: int) -> int:
    """How many microbatches a rank holding ``rows`` consecutive rows of a
    ``batch`` (a dp rank's share) runs: the reference's microbatches of
    ``batch / microbatches`` rows that fall within its rows, or its rows in
    one pass when a microbatch spans more than them.  Each row's result is
    its own, so the grouping changes no number."""
    mb = batch // microbatches
    return rows // mb if rows % mb == 0 else 1


def pipeline_backward(pp, microbatches: int, embed, layers, loss, shape: tuple,
                      dtype: torch.dtype, device: torch.device) -> torch.Tensor | None:
    """Forward and backward of one step through the stages of ``pp`` (the
    rank's pp ``AxisGroup``, or None: one stage).  ``embed(m)`` gives
    microbatch m's input to the layers (the first stage), ``layers(h)`` runs
    the stage's layers, ``loss(m, h)`` gives microbatch m's loss from the
    last layer's output (the last stage); ``shape`` is a microbatch's ``h``.
    The parameters' gradients accumulate in their ``.grad``.  Returns the
    sum of the microbatches' losses, detached, on the last stage (None
    elsewhere)."""
    if pp is None:
        total = None
        for m in range(microbatches):
            part = loss(m, layers(embed(m)))
            part.backward()
            total = part.detach() if total is None else total + part.detach()
        return total
    s, S = pp.rank, pp.size
    first, last = s == 0, s == S - 1
    ahead = min(S - 1 - s, microbatches)
    pending = deque()  # (input, output or loss) of each microbatch not yet differentiated
    losses = []

    def receive(src: int) -> torch.Tensor:
        return pp.recv(torch.empty(shape, dtype=dtype, device=device), src)

    def forward(m: int, x: torch.Tensor | None) -> torch.Tensor:
        y = layers(embed(m) if first else x.requires_grad_())
        if last:
            y = loss(m, y)
        pending.append((x, y))
        return y.detach()

    def backward(dy: torch.Tensor | None) -> torch.Tensor | None:
        x, y = pending.popleft()
        if last:
            y.backward()
            losses.append(y.detach())
        else:
            torch.autograd.backward(y, dy)
        return None if first else x.grad

    for m in range(ahead):
        pp.send(forward(m, None if first else receive(s - 1)), s + 1)
    steady = microbatches - ahead
    x = None if first or not steady else receive(s - 1)
    for i in range(steady):
        y = forward(ahead + i, x)
        dy = None if last else pp.exchange([y], dst=s + 1, src=s + 1)[0]
        dx = backward(dy)
        if first:
            continue
        if i == steady - 1:
            pp.send(dx, s - 1)
        else:  # this microbatch's input gradient out, the next one's input in
            x = pp.exchange([dx], dst=s - 1, src=s - 1)[0]
    for _ in range(ahead):
        dx = backward(None if last else receive(s + 1))
        if not first:
            pp.send(dx, s - 1)
    return torch.stack(losses).sum() if losses else None
