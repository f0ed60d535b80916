"""Bridge the JAX package's parameter pytree into the port's tensors.

The JAX side is handed over as nested dicts of numpy arrays (for example
``jax.tree.map(np.asarray, params)``), so this module needs no JAX.  Layouts
follow ``smg_tpu/models/llama.py::init_params``; the head axes are folded so
each projection is one matmul in ``smg_tpu_torch/models/llama.py``.
"""

from __future__ import annotations

import numpy as np
import torch

# JAX key -> how its trailing axes fold: wq [L,E,H,D] -> [L,E,H*D], ...
_FOLD = {
    "wq": lambda a: a.reshape(a.shape[0], a.shape[1], -1),
    "wk": lambda a: a.reshape(a.shape[0], a.shape[1], -1),
    "wv": lambda a: a.reshape(a.shape[0], a.shape[1], -1),
    "wo": lambda a: a.reshape(a.shape[0], -1, a.shape[-1]),  # [L,H,D,E] -> [L,H*D,E]
}
_DENSE_LAYER_KEYS = {
    "attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate", "w_up", "w_down",
    "post_attn_norm", "post_mlp_norm", "q_norm", "k_norm",
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
    unknown = set(layers_in) - _DENSE_LAYER_KEYS
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
