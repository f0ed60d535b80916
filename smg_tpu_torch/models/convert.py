"""Bridge the JAX package's parameter pytree into the port's tensors.

The JAX side is handed over as nested dicts of numpy arrays (for example
``jax.tree.map(np.asarray, params)``), so this module needs no JAX.  Layouts
follow ``smg_tpu/models/llama.py::init_params``; the head axes are folded so
each projection is one matmul in ``smg_tpu_torch/models/llama.py``.  A
Qwen-MoE tree's ``router`` and expert stacks (``w_gate``/``w_up``
``[L, X, E, Fm]``, ``w_down [L, X, Fm, E]``) keep their layout.  The
vision tower's tree (``smg_tpu/models/vit.py::init_vision_params``) bridges
through ``vision_params_from_jax`` with its nesting and layouts unchanged.
A training state (``smg_tpu/train/step.py::TrainState``) bridges through
``train_state_from_jax``: the params and optax's AdamW moments folded alike,
onto one device or a training mesh's ranks.
A rank-mesh engine takes the whole bridged dict, and each rank keeps its
part (``parallel/sharding.py::shard_params``); ``shards_from_jax`` gives
every rank's part of a JAX tree at once: a pipeline stage's layers, an
expert-parallel rank's experts, a tensor-parallel rank's slices.
"""

from __future__ import annotations

import numpy as np
import torch

from smg_tpu_torch.parallel.group import rank_coords
from smg_tpu_torch.parallel.sharding import RankPlace, shard_params
from smg_tpu_torch.train.step import AdamWState, TrainState

# JAX key -> how its trailing axes fold: wq [L,E,H,D] -> [L,E,H*D], ...
_FOLD = {
    "wq": lambda a: a.reshape(a.shape[0], a.shape[1], -1),
    "wk": lambda a: a.reshape(a.shape[0], a.shape[1], -1),
    "wv": lambda a: a.reshape(a.shape[0], a.shape[1], -1),
    "wo": lambda a: a.reshape(a.shape[0], -1, a.shape[-1]),  # [L,H,D,E] -> [L,H*D,E]
}
_LAYER_KEYS = {
    "attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate", "w_up", "w_down",
    "post_attn_norm", "post_mlp_norm", "q_norm", "k_norm", "router",
}


def _tensor(a, device, dtype) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bf16: go through f32
        arr = arr.astype(np.float32)
    t = torch.from_numpy(np.array(arr))  # a writable copy
    return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)


def params_from_jax(tree: dict, device: torch.device | str = "cpu",
                    dtype: torch.dtype | None = None) -> dict:
    """JAX parameter tree (numpy leaves) -> the port's parameter dict."""
    layers_in = tree["layers"]
    unknown = set(layers_in) - _LAYER_KEYS
    if unknown:
        raise NotImplementedError(f"layer weights not ported yet: {sorted(unknown)}")
    layers = {}
    for key, a in layers_in.items():
        arr = np.asarray(a)
        layers[key] = _tensor(_FOLD.get(key, lambda x: x)(arr), device, dtype)
    out = {"layers": layers}
    for key in ("embed", "final_norm", "lm_head"):
        if key in tree:
            out[key] = _tensor(tree[key], device, dtype)
    return out


def shards_from_jax(tree: dict, cfg, parallel, device: torch.device | str = "cpu",
                    dtype: torch.dtype | None = None) -> list[tuple]:
    """Every rank's ``(rank_cfg, rank_params)`` of a JAX parameter tree
    (numpy leaves) on the grid of ``parallel`` (an ``engine/config.py``
    ``ParallelConfig``; ranks in ``parallel/group.py``'s order), ``cfg``
    the whole model's port config: what each rank of an engine over that
    grid holds."""
    full = params_from_jax(tree, device, dtype)
    sizes = parallel.axis_sizes()
    return [shard_params(full, cfg, place=RankPlace.of(sizes, rank_coords(sizes, r)))
            for r in range(parallel.world_size)]


def vision_params_from_jax(tree: dict, device: torch.device | str = "cpu",
                           dtype: torch.dtype | None = None) -> dict:
    """JAX vision-tower tree (numpy leaves) -> the port's tower parameters:
    the same nested dicts (``patch_embed``, stacked ``layers``, ``merger``),
    every leaf a tensor of the same shape."""
    if isinstance(tree, dict):
        return {k: vision_params_from_jax(v, device, dtype) for k, v in tree.items()}
    return _tensor(tree, device, dtype)


def train_state_from_jax(state, device: torch.device | str = "cpu",
                         dtype: torch.dtype | None = None, *, mesh=None):
    """A JAX ``TrainState`` with numpy leaves (``jax.tree.map(np.asarray,
    state)``) -> the port's (``smg_tpu_torch/train/step.py``): the params as
    ``params_from_jax`` folds them, the ``mu`` and ``nu`` of optax.adamw's
    ``ScaleByAdamState`` (the one entry of its chain state that has them)
    folded exactly as the params are, its ``count``, and the step.  The
    port's step then continues the JAX run: the same next update.

    ``mesh``: the ``init_fn`` or ``step_fn`` of a sharded
    ``make_train_step`` (or its ``MeshTrainer``): the state, a sharded JAX
    run's gathered to the host, is cut onto that mesh's ranks, each keeping
    its piece of the params and both moments, and its handle returned."""
    if mesh is not None:
        whole = train_state_from_jax(state, "cpu", dtype)
        return getattr(mesh, "trainer", mesh).place(whole)
    adam = next(s for s in state.opt_state if hasattr(s, "mu"))
    return TrainState(
        params=params_from_jax(state.params, device, dtype),
        opt_state=AdamWState(mu=params_from_jax(adam.mu, device, dtype),
                             nu=params_from_jax(adam.nu, device, dtype),
                             count=int(np.asarray(adam.count))),
        step=int(np.asarray(state.step)))
