"""Image operations (resize, normalize, patchify) as torch computations on
an explicit device — port of ``smg_tpu/multimodal/image.py``.

Every operation takes ``device``: ``None`` means the card (and raises on a
machine without one); the tests pass ``"cpu"``.  The resize is the
reference's ``jax.image.resize(..., "bilinear")``, which antialiases when it
shrinks: each spatial axis is resampled by a weight matrix built as JAX's
``scale_and_translate`` builds it (the triangle kernel, widened by the
inverse scale when shrinking, each output's weights normalised to sum 1,
outputs whose sample falls outside the input zeroed), applied as two matrix
products.  ``torch.nn.functional.interpolate(antialias=True)`` is not held
to the same border weights, so it is not used.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# CLIP/SigLIP-style defaults (per-model processors override)
DEFAULT_MEAN = (0.48145466, 0.4578275, 0.40821073)
DEFAULT_STD = (0.26862954, 0.26130258, 0.27577711)


def _device(device) -> torch.device:
    from smg_tpu_torch.engine.runner import resolve_device

    return resolve_device(device)


def _as_image(img, device) -> torch.Tensor:
    """[H, W, C] numpy or tensor -> a tensor on ``device``; uint8 widens to
    float32."""
    t = img if torch.is_tensor(img) else torch.tensor(np.asarray(img))  # a host copy
    t = t.to(_device(device))
    return t.float() if t.dtype == torch.uint8 else t


def resize_weights(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """[n_in, n_out] float32 weights of a bilinear antialiased resize along
    one axis (JAX's ``compute_weight_mat`` for the triangle kernel, zero
    translation)."""
    dev = _device(device)
    f32 = torch.float32
    scale = torch.tensor(n_out / n_in, dtype=f32, device=dev)
    inv_scale = 1.0 / scale
    # shrinking low-pass filters: the kernel widens by the inverse scale
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = (torch.arange(n_out, dtype=f32, device=dev) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(n_in, dtype=f32, device=dev)[:, None]).abs() \
        / kernel_scale
    weights = torch.clamp(1 - x.abs(), min=0)  # the triangle kernel
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                          weights / torch.where(total != 0, total, 1.0),
                          torch.zeros((), dtype=f32, device=dev))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros((), dtype=f32, device=dev))


def resize_image(img, height: int, width: int, device=None) -> torch.Tensor:
    """Bilinear resize [H, W, C] -> [height, width, C] float32, antialiased
    when shrinking.  An axis whose size does not change is left as it is,
    as JAX leaves it."""
    x = _as_image(img, device).float()
    H, W = x.shape[:2]
    if H != height:
        x = torch.einsum("hwc,hH->Hwc", x, resize_weights(H, height, x.device))
    if W != width:
        x = torch.einsum("hwc,wW->hWc", x, resize_weights(W, width, x.device))
    return x


def normalize_image(img, mean: tuple = DEFAULT_MEAN, std: tuple = DEFAULT_STD,
                    rescale: float = 1.0 / 255.0, device=None) -> torch.Tensor:
    """uint8/float [H, W, C] -> normalized float32."""
    x = _as_image(img, device).float() * rescale
    m = torch.tensor(mean, dtype=torch.float32, device=x.device)
    s = torch.tensor(std, dtype=torch.float32, device=x.device)
    return (x - m) / s


def patchify(img: torch.Tensor, patch_size: int, merge_size: int = 1
             ) -> tuple[torch.Tensor, tuple[int, int]]:
    """[H, W, C] -> (patches [n, patch_size*patch_size*C], (gh, gw)).

    H and W must be multiples of patch_size * merge_size (``smart_resize``
    first).  Patch order is row-major over the (gh, gw) grid."""
    H, W, C = img.shape
    ps = patch_size
    gh, gw = H // ps, W // ps
    x = img.reshape(gh, ps, gw, ps, C).permute(0, 2, 1, 3, 4)
    return x.reshape(gh * gw, ps * ps * C), (gh, gw)


def smart_resize(height: int, width: int, factor: int = 28, min_pixels: int = 56 * 56,
                 max_pixels: int = 14 * 14 * 4 * 1280) -> tuple[int, int]:
    """Qwen2-VL resize rule: round dims to ``factor`` keeping the pixel count
    within [min_pixels, max_pixels] and the aspect ratio."""
    if max(height, width) / min(height, width) > 200:
        raise ValueError("absolute aspect ratio must be < 200")
    h_bar = max(factor, round(height / factor) * factor)
    w_bar = max(factor, round(width / factor) * factor)
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = math.floor(height / beta / factor) * factor
        w_bar = math.floor(width / beta / factor) * factor
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return h_bar, w_bar


def decode_image(data: bytes) -> np.ndarray:
    """PNG/JPEG bytes -> [H, W, 3] uint8 array on the host (PIL, imported
    when called)."""
    import io

    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError("image decoding requires pillow") from e
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def decode_data_url(url: str) -> np.ndarray:
    """data:image/...;base64,... -> image array."""
    import base64

    if not url.startswith("data:"):
        raise ValueError("only data: URLs decodable without egress")
    _, b64 = url.split(",", 1)
    return decode_image(base64.b64decode(b64))
