"""Serving pipeline parallelism of the port — the counterpart of
``smg_tpu/parallel/pp_serving.py`` (``pp_serving_scan``, ``pp_decode_scan``).

The reference runs its stage schedule as one SPMD program under
``shard_map``: S ticks, every stage computing its layers on every tick and
keeping the result only on its own, ``ppermute`` handing ``h`` on, and a
``psum`` parking the final ``h`` on every device for a replicated unembed.
Here every stage is a process of its own, so nothing is computed to be
thrown away: a stage waits for ``h`` from the stage before it
(``receive``), runs its own layers once and sends ``h`` to the next
(``hand_on``).  The last stage alone holds ``final_norm`` and ``lm_head``
(``parallel/sharding.py``), so it unembeds and broadcasts the float32
logits over the pp group (``logits_from_last``) where the reference
broadcasts ``h``; every rank then samples the same tokens from the same
logits, as the leader's mirrored calls need (``leader.py``).

Each stage's KV cache and horizon side buffers hold its ``L / S`` layers
(``engine/kv_cache.py::plan_cache``) under the leader's page tables, and an
adapter bank holds the stage's layers of each adapter
(``engine/runner.py::load_lora``).  The attention kernels run on every
stage; the reference forces XLA attention under pp, because a Pallas kernel
cannot run inside its ``shard_map``: the function computed is the same."""

from __future__ import annotations

import torch


def receive(pp, shape: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A later stage's input to its layers: the stage before it's ``h``."""
    return pp.recv(torch.empty(shape, dtype=dtype, device=device), pp.rank - 1)


def hand_on(pp, h: torch.Tensor) -> None:
    """Send a stage's output to the next stage (the last keeps it)."""
    if pp.rank < pp.size - 1:
        pp.send(h, pp.rank + 1)


def logits_from_last(pp, unembed, shape: tuple, device: torch.device) -> torch.Tensor:
    """The last stage's logits (``unembed()`` there, float32 ``shape``) on
    every stage of the pp group."""
    last = pp.size - 1
    if pp.rank == last:
        return pp.broadcast(unembed(), last)
    return pp.broadcast(torch.empty(shape, dtype=torch.float32, device=device), last)
