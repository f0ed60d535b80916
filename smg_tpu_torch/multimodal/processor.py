"""Per-model image processors — port of ``smg_tpu/multimodal/processor.py``
for the Qwen2-VL family.  A processor turns a raw image into the pixel
tensor and grid its vision tower expects, and the number of image
placeholder tokens the prompt expands to.

Only ``Qwen2VLImageProcessor`` is ported: the reference builds a vision
tower only for "vl" configs (Qwen2-VL's), so no serving path of the port
reaches its other processors (LLaVA, InternVL, Pixtral, Gemma 3,
Phi-3-vision, Llama 4, Phi-4, Kimi-K2.5, Qwen3-Omni).  Asking for one of
them raises ``NotImplementedError`` naming ROADMAP Queue A item 4.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from smg_tpu_torch.multimodal.image import normalize_image, patchify, resize_image, smart_resize


@dataclass
class ProcessedImage:
    pixel_values: torch.Tensor  # [n_patches, patch_dim] float32, on the processor's device
    grid: tuple[int, int]  # (gh, gw) patch grid
    num_placeholder_tokens: int
    # merged LLM-token grid (gh_m, gw_m), set only by processors whose
    # placeholder run is a planar spatial grid (it drives M-RoPE)
    llm_grid: "tuple[int, int] | None" = None


class ImageProcessor:
    name = "base"

    def process(self, img) -> ProcessedImage:
        raise NotImplementedError


class Qwen2VLImageProcessor(ImageProcessor):
    """Qwen2-VL: smart-resize to the factor patch * merge, 2x2 patch
    merging.  The image operations run on ``device`` (None: the card)."""

    name = "qwen2_vl"

    def __init__(self, patch_size: int = 14, merge_size: int = 2,
                 min_pixels: int = 56 * 56, max_pixels: int = 14 * 14 * 4 * 1280,
                 device=None):
        self.patch_size = patch_size
        self.merge_size = merge_size
        self.min_pixels = min_pixels
        self.max_pixels = max_pixels
        self.device = device

    def process(self, img) -> ProcessedImage:
        H, W = img.shape[:2]
        h2, w2 = smart_resize(H, W, factor=self.patch_size * self.merge_size,
                              min_pixels=self.min_pixels, max_pixels=self.max_pixels)
        x = resize_image(img, h2, w2, device=self.device)
        x = normalize_image(x, device=x.device)
        patches, grid = patchify(x, self.patch_size)
        mgh, mgw = grid[0] // self.merge_size, grid[1] // self.merge_size
        return ProcessedImage(pixel_values=patches, grid=grid,
                              num_placeholder_tokens=mgh * mgw, llm_grid=(mgh, mgw))


_PROCESSORS = {
    "qwen2_vl": Qwen2VLImageProcessor,
    "qwen3_vl": Qwen2VLImageProcessor,
}
# the reference's processors this port does not have
_NOT_PORTED = ("llava", "internvl", "pixtral", "gemma3", "phi3_v", "llama4", "phi4_v",
               "kimi_k25", "qwen3_omni")

_MODEL_MAP = [
    ("qwen2-vl", "qwen2_vl"),
    ("qwen2.5-vl", "qwen2_vl"),
    ("qwen3-omni", "qwen3_omni"),
    ("qwen3-vl", "qwen3_vl"),
    ("llava", "llava"),
    ("internvl", "internvl"),
    ("pixtral", "pixtral"),
    ("mistral-small", "pixtral"),
    ("gemma-3", "gemma3"),
    ("gemma3", "gemma3"),
    ("llama-4", "llama4"),
    ("llama4", "llama4"),
    ("phi-4", "phi4_v"),
    ("phi4", "phi4_v"),
    ("phi-3", "phi3_v"),
    ("phi-3.5", "phi3_v"),
    ("kimi-k2.5", "kimi_k25"),
    ("kimi_k25", "kimi_k25"),
    ("kimi-vl", "kimi_k25"),
]


def _not_ported(family: str) -> NotImplementedError:
    return NotImplementedError(
        f"the {family} image processor is not ported to the PyTorch engine yet "
        "(ROADMAP Queue A item 4)")


def get_image_processor(name_or_model: str, device=None) -> ImageProcessor:
    """The processor of a family or model name.  The reference falls back
    to its LLaVA processor for a name it does not know; that processor is
    not ported, so an unknown name raises here."""
    key = (name_or_model or "").lower()
    if key in _PROCESSORS:
        return _PROCESSORS[key](device=device)
    for sub, name in _MODEL_MAP:
        if sub in key:
            if name not in _PROCESSORS:
                raise _not_ported(name)
            return _PROCESSORS[name](device=device)
    raise _not_ported("llava")


def processor_for_worker(name_or_model: str, patch_size: int | None = None,
                         merge_size: int | None = None, device=None) -> ImageProcessor:
    """Processor matched to a worker's advertised vision tower (its model
    info's vision fields): the family by model name, the geometry from the
    worker so the gateway's patchify agrees with the tower's patch
    embedding.  Unknown families take the smart-resize (Qwen2-VL-style)
    processor, the general dynamic-resolution mechanism, as in the
    reference."""
    key = (name_or_model or "").lower()
    family = None
    for sub, name in _MODEL_MAP:
        if sub in key:
            family = name
            break
    if family in _NOT_PORTED:
        raise _not_ported(family)
    return Qwen2VLImageProcessor(patch_size=patch_size or 14, merge_size=merge_size or 2,
                                 device=device)
