"""HF safetensors checkpoint -> the port's parameter dict (port of
``smg_tpu/models/weights.py::load_params``).

Every ``*.safetensors`` file of the directory is opened lazily (one file, or
the shards a ``model.safetensors.index.json`` lists) through
``safe_open(framework="pt")``, which reads bf16 tensors without numpy's
help.  The stacked ``[L, ...]`` buffers are allocated on the target device
first and filled one tensor at a time, so host memory holds about one
layer's tensor, never the whole model.  The result has the layout and dtype
``models/convert.py::params_from_jax`` gives the JAX loader's output: HF's
``[out, in]`` linears transposed to ``[in, out]``, which is the JAX layout
with its head axes folded.

A Qwen-MoE checkpoint holds a router per layer (``mlp.gate.weight``, read as
``router [L, E, X]``) and every expert's three linears as tensors of their
own (``mlp.experts.{e}.{gate,up,down}_proj.weight``, 18,432 of them in
Qwen3-30B-A3B), each transposed into its slot of ``[L, X, ...]``.  As in the
reference, Qwen2-MoE's shared expert has no key here and is not read.

The vision tower of a Qwen2-VL checkpoint (``visual.*``) loads through
``load_vision_params`` the same way, into the tree
``models/vit.py::init_vision_params`` gives.
"""

from __future__ import annotations

import contextlib
import glob
import os

import torch

from smg_tpu_torch.models.llama import torch_dtype
from smg_tpu_torch.utils import get_logger

logger = get_logger("models.weights")

# port key -> (HF tensor name, stored as an [out, in] linear)
_GLOBAL_KEYS = {
    "embed": ("model.embed_tokens.weight", False),
    "final_norm": ("model.norm.weight", False),
    "lm_head": ("lm_head.weight", True),
}


def _layer_keys(cfg) -> dict[str, tuple[str, bool]]:
    """Port layer key -> (HF name template, linear): the reference's
    ``_hf_key_map``.  An ``{e}`` in a template is the expert index."""
    p = "model.layers.{i}."
    m = {
        "attn_norm": (p + "input_layernorm.weight", False),
        "wq": (p + "self_attn.q_proj.weight", True),
        "wk": (p + "self_attn.k_proj.weight", True),
        "wv": (p + "self_attn.v_proj.weight", True),
        "wo": (p + "self_attn.o_proj.weight", True),
        "mlp_norm": (p + "post_attention_layernorm.weight", False),
        "w_gate": (p + "mlp.gate_proj.weight", True),
        "w_up": (p + "mlp.up_proj.weight", True),
        "w_down": (p + "mlp.down_proj.weight", True),
    }
    if cfg.qk_norm:
        m["q_norm"] = (p + "self_attn.q_norm.weight", False)
        m["k_norm"] = (p + "self_attn.k_norm.weight", False)
    if cfg.post_norms:
        # Gemma-2 four-norm layers: HF's post_attention_layernorm is the
        # POST-attention norm there, and the ffn pre-norm is its own key
        m["mlp_norm"] = (p + "pre_feedforward_layernorm.weight", False)
        m["post_attn_norm"] = (p + "post_attention_layernorm.weight", False)
        m["post_mlp_norm"] = (p + "post_feedforward_layernorm.weight", False)
    if cfg.num_experts:
        # Qwen-MoE naming: router = mlp.gate, experts under mlp.experts.{e}
        m["router"] = (p + "mlp.gate.weight", True)
        for key, proj in (("w_gate", "gate_proj"), ("w_up", "up_proj"),
                          ("w_down", "down_proj")):
            m[key] = (p + "mlp.experts.{e}." + proj + ".weight", True)
    return m


class Checkpoint(contextlib.ExitStack):
    """Lazy handles over every ``*.safetensors`` file of a directory, open
    until the ``with`` block ends."""

    def __init__(self, path: str):
        from safetensors import safe_open

        super().__init__()
        files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
        if not files:
            raise FileNotFoundError(f"no safetensors under {path}")
        handles = [self.enter_context(safe_open(f, framework="pt", device="cpu"))
                   for f in files]
        self._where = {name: h for h in handles for name in h.keys()}

    def _handle(self, name: str):
        h = self._where.get(name)
        if h is None:
            raise KeyError(f"tensor {name} not found in checkpoint")
        return h

    def get(self, name: str) -> torch.Tensor:
        return self._handle(name).get_tensor(name)

    def shape(self, name: str) -> list[int]:
        return list(self._handle(name).get_slice(name).get_shape())


def load_params(engine_cfg, device=None) -> dict:
    """Weights of ``engine_cfg.model`` from the HF directory
    ``engine_cfg.model_path``, in the model's dtype (a bf16 checkpoint is
    widened exactly for ``dtype="float32"``), on ``device`` (the card
    unless the caller asks for the CPU)."""
    from smg_tpu_torch.engine.runner import resolve_device

    cfg = engine_cfg.model
    device = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    with Checkpoint(engine_cfg.model_path) as ckpt:
        return _load(cfg, ckpt, device, dtype)


def _load(cfg, ckpt: Checkpoint, device: torch.device, dtype: torch.dtype) -> dict:
    def place(t: torch.Tensor, linear: bool, out: torch.Tensor) -> None:
        t = t.to(device)
        out.copy_(t.t() if linear else t)  # transpose and cast on the device

    def one(name: str, linear: bool) -> torch.Tensor:
        shape = ckpt.shape(name)
        out = torch.empty(shape[::-1] if linear else shape, dtype=dtype, device=device)
        place(ckpt.get(name), linear, out)
        return out

    params: dict = {"layers": {}}
    for key, (tmpl, linear) in _layer_keys(cfg).items():
        experts = cfg.num_experts if "{e}" in tmpl else 0
        shape = ckpt.shape(tmpl.format(i=0, e=0))
        lead = [cfg.num_layers] + ([experts] if experts else [])
        out = torch.empty(lead + (shape[::-1] if linear else shape),
                          dtype=dtype, device=device)
        for i in range(cfg.num_layers):
            if experts:  # one tensor at a time, into its [i, e] slot
                for e in range(experts):
                    place(ckpt.get(tmpl.format(i=i, e=e)), linear, out[i, e])
            else:
                place(ckpt.get(tmpl.format(i=i)), linear, out[i])
        params["layers"][key] = out
        logger.info("loaded layers/%s %s", key, tuple(out.shape))
    for key, (name, linear) in _GLOBAL_KEYS.items():
        if key == "lm_head" and cfg.tie_word_embeddings:
            continue
        params[key] = one(name, linear)
        logger.info("loaded %s %s", key, tuple(params[key].shape))
    return params


def load_vision_params(engine_cfg, device=None) -> dict:
    """The vision tower of ``engine_cfg.model`` from the Qwen2-VL-style HF
    directory ``engine_cfg.model_path`` (``visual.*`` keys, through
    ``models.vit.HF_VISION_MAPPING``), in the tower's dtype, on ``device``
    (the card unless the caller asks for the CPU).  The reference's layout
    transforms:

    - the patch-embed conv ``[H, C, (T,) ps, ps]`` -> ``[patch_dim, H]``.  A
      temporal axis (Qwen2-VL's Conv3d, T=2 frames) is summed away: for a
      single image the temporal patch is the same frame repeated, and a conv
      over a repeated frame is the conv with the summed kernel.  Elements go
      in (ps, ps, C) order, ``multimodal.image.patchify``'s flatten;
    - linears ``[out, in]`` -> ``[in, out]``;
    - layer norms -> ``{"scale", "bias"}`` from ``.weight`` and ``.bias``.
    """
    from smg_tpu_torch.engine.runner import resolve_device
    from smg_tpu_torch.models.vit import HF_VISION_MAPPING

    vcfg = engine_cfg.model.vision
    if vcfg is None:
        raise ValueError("model config has no vision tower")
    device = resolve_device(device)
    dtype = torch_dtype(vcfg.dtype)
    L = vcfg.num_layers

    def conv_to_matrix(w: torch.Tensor) -> torch.Tensor:
        if w.ndim == 5:  # [H, C, T, ps, ps] Conv3d: the temporal axis summed
            w = w.sum(dim=2)
        H, C, ph, pw = w.shape
        return w.permute(2, 3, 1, 0).reshape(ph * pw * C, H)

    with Checkpoint(engine_cfg.model_path) as ckpt:
        def one(name: str, linear: bool = False) -> torch.Tensor:
            t = ckpt.get(name).to(device)
            return (t.t() if linear else t).to(dtype).contiguous()

        def norm(prefix: str, lead=()) -> dict:
            if not lead:
                return {"scale": one(prefix + ".weight"), "bias": one(prefix + ".bias")}
            return {"scale": stacked(prefix + ".weight"), "bias": stacked(prefix + ".bias")}

        def stacked(tmpl: str, linear: bool = False) -> torch.Tensor:
            out = None
            for i in range(L):  # one tensor at a time, into its layer's slot
                t = ckpt.get(tmpl.format(i=i)).to(device)
                t = t.t() if linear else t
                if out is None:
                    out = torch.empty((L, *t.shape), dtype=dtype, device=device)
                out[i].copy_(t)
            return out

        def key(k: str) -> str:
            return HF_VISION_MAPPING[k]

        layers = {
            "ln1": norm(key("layers.{i}.ln1"), (L,)),
            "ln2": norm(key("layers.{i}.ln2"), (L,)),
        }
        for name in ("qkv_w", "proj_w", "fc1_w", "fc2_w"):
            layers[name] = stacked(key(f"layers.{{i}}.{name}"), linear=True)
        for name in ("qkv_b", "proj_b", "fc1_b", "fc2_b"):
            layers[name] = stacked(key(f"layers.{{i}}.{name}"))
        params = {
            "patch_embed": conv_to_matrix(
                ckpt.get(key("patch_embed")).to(device)).to(dtype).contiguous(),
            "layers": layers,
            "merger": {
                "ln_q": norm(key("merger.ln_q")),
                "mlp0_w": one(key("merger.mlp0_w"), linear=True),
                "mlp0_b": one(key("merger.mlp0_b")),
                "mlp2_w": one(key("merger.mlp2_w"), linear=True),
                "mlp2_b": one(key("merger.mlp2_b")),
            },
        }
    logger.info("loaded vision tower: %d layers, patch_embed %s", L,
                tuple(params["patch_embed"].shape))
    return params
