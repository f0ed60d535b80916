"""LoRA adapter loading for multi-adapter serving — the port's copy of
``smg_tpu/models/lora.py``.  Adapters live in the runner's fixed-size
**bank** of stacked tensors ``[L, N, ...]`` (L layers, N adapter slots, slot
0 all-zeros = "no adapter"), and the forward pass applies every slot densely
with a per-row one-hot gate (``models/llama.py::lora_delta``): static
shapes, batch-mixable adapters, and loading writes a bank slot in place, so
a captured CUDA graph stays valid across load and unload.

Canonical adapter layout (per target projection p in wq/wk/wv/wo):
``{p}_a`` [L, E_in, r] and ``{p}_b`` [L, r, E_out] with the PEFT
``alpha / r`` scaling pre-folded into ``b``.  Loaders accept:

- an ``.npz`` file / bytes in canonical layout (tests, custom tooling);
- a HF PEFT directory: ``adapter_config.json`` + ``adapter_model.safetensors``
  with ``...layers.{i}.self_attn.{q,k,v,o}_proj.lora_{A,B}.weight`` entries.
"""

from __future__ import annotations

import io
import json
import os

import numpy as np
import torch

_PROJ_DIMS = {
    # proj -> (in_dim_fn, out_dim_fn)
    "wq": (lambda c: c.hidden_size, lambda c: c.num_heads * c.head_dim),
    "wk": (lambda c: c.hidden_size, lambda c: c.num_kv_heads * c.head_dim),
    "wv": (lambda c: c.hidden_size, lambda c: c.num_kv_heads * c.head_dim),
    "wo": (lambda c: c.num_heads * c.head_dim, lambda c: c.hidden_size),
}
_PEFT_NAMES = {"q_proj": "wq", "k_proj": "wk", "v_proj": "wv", "o_proj": "wo"}


def canonical_keys() -> list[str]:
    return [f"{p}_{ab}" for p in _PROJ_DIMS for ab in ("a", "b")]


def empty_adapter(cfg, rank: int) -> dict[str, np.ndarray]:
    L = cfg.num_layers
    out = {}
    for p, (fin, fout) in _PROJ_DIMS.items():
        out[f"{p}_a"] = np.zeros((L, fin(cfg), rank), np.float32)
        out[f"{p}_b"] = np.zeros((L, rank, fout(cfg)), np.float32)
    return out


def validate_adapter(cfg, weights: dict) -> int:
    """Check canonical-layout shapes; returns the adapter rank."""
    rank = None
    for p, (fin, fout) in _PROJ_DIMS.items():
        a, b = weights.get(f"{p}_a"), weights.get(f"{p}_b")
        if a is None or b is None:
            raise ValueError(f"adapter missing {p}_a/{p}_b")
        L, ein, r = a.shape
        if L != cfg.num_layers or ein != fin(cfg):
            raise ValueError(f"{p}_a shape {a.shape} mismatches model")
        if b.shape != (cfg.num_layers, r, fout(cfg)):
            raise ValueError(f"{p}_b shape {b.shape} mismatches model/rank")
        if rank is None:
            rank = r
        elif r != rank:
            raise ValueError("mixed ranks across projections unsupported")
    return int(rank)


def load_npz(data: bytes | str) -> dict[str, np.ndarray]:
    if isinstance(data, (bytes, bytearray)):
        f = np.load(io.BytesIO(bytes(data)))
    else:
        f = np.load(data)
    return {k: np.asarray(f[k], np.float32) for k in f.files}


def load_peft_dir(path: str, cfg) -> dict[str, np.ndarray]:
    """HF PEFT directory -> canonical stacked layout (scaling folded in)."""
    with open(os.path.join(path, "adapter_config.json")) as f:
        acfg = json.load(f)
    rank = int(acfg.get("r", 8))
    alpha = float(acfg.get("lora_alpha", rank))
    scaling = alpha / rank

    tensors: dict[str, np.ndarray] = {}
    st_path = os.path.join(path, "adapter_model.safetensors")
    if os.path.exists(st_path):
        # through torch, which reads bf16 adapters (numpy cannot without
        # ml_dtypes)
        from safetensors.torch import load_file

        tensors = {k: v.float().numpy() for k, v in load_file(st_path).items()}
    else:  # npz fallback inside a PEFT-style dir
        npz_path = os.path.join(path, "adapter_model.npz")
        tensors = dict(np.load(npz_path))

    out = empty_adapter(cfg, rank)
    for key, val in tensors.items():
        parts = key.split(".")
        try:
            li = parts.index("layers") + 1
            layer = int(parts[li])
            proj = next(p for p in _PEFT_NAMES if p in parts)
            ab = "a" if "lora_A" in key else "b"
        except (ValueError, StopIteration):
            continue
        name = _PEFT_NAMES[proj]
        val = np.asarray(val, np.float32)
        if ab == "a":
            out[f"{name}_a"][layer] = val.T  # PEFT A: [r, in] -> [in, r]
        else:
            out[f"{name}_b"][layer] = val.T * scaling  # PEFT B: [out, r] -> [r, out]
    return out


class LoraBank:
    """The runner's adapter bank on the device: for each projection p,
    ``{p}_a`` [L, E_in, N*r] and ``{p}_b`` [L, N*r, E_out] in the
    activations' dtype, slot n in rank columns ``n*r .. n*r + r - 1``
    (the layout ``models/llama.py::lora_delta`` multiplies without a
    copy).  Created once at the first load with that adapter's rank; slots
    are written in place, so the tensors keep their addresses for the
    CUDA graphs that read them."""

    def __init__(self, cfg, slots: int, rank: int, dtype: torch.dtype,
                 device: torch.device):
        self.slots, self.rank = slots, rank
        L, n = cfg.num_layers, slots * rank
        self.w: dict[str, torch.Tensor] = {}
        for p, (fin, fout) in _PROJ_DIMS.items():
            self.w[f"{p}_a"] = torch.zeros((L, fin(cfg), n), dtype=dtype, device=device)
            self.w[f"{p}_b"] = torch.zeros((L, n, fout(cfg)), dtype=dtype, device=device)

    def __getitem__(self, key: str) -> torch.Tensor:
        return self.w[key]

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.w.values())

    def write(self, slot: int, weights: dict | None) -> None:
        """Copy a canonical adapter (``{p}_a`` [L, E_in, r'], ``{p}_b``
        [L, r', E_out], r' <= rank: zero-padded) into ``slot``; None zeroes
        the slot.  In place, stream-ordered after any launch already
        enqueued."""
        cols = slice(slot * self.rank, (slot + 1) * self.rank)
        for key, t in self.w.items():
            dst = t[:, :, cols] if key.endswith("_a") else t[:, cols, :]
            dst.zero_()
            if weights is None:
                continue
            src = torch.from_numpy(np.ascontiguousarray(weights[key], np.float32))
            r = src.shape[2] if key.endswith("_a") else src.shape[1]
            part = dst[:, :, :r] if key.endswith("_a") else dst[:, :r, :]
            part.copy_(src.to(t.device))
