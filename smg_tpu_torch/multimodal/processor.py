"""Per-model image processors — port of ``smg_tpu/multimodal/processor.py``.
A processor turns a raw image into the pixel tensor and grid its vision
tower expects, and the number of image placeholder tokens the prompt
expands to.

Every processor of the reference, with its registry: Qwen2-VL (and
Qwen3-VL), LLaVA, InternVL, Pixtral, Gemma 3, Phi-3-vision, Llama 4, Phi-4,
Kimi-K2.5 and Qwen3-Omni.  Each takes ``device``, where its resize,
normalize, pad and patchify run as torch ops (None: the card, which raises
on a machine without one; the tests pass ``"cpu"``).  The geometry, the
token counts and the tie rules are the reference's, copied exactly.
"""

from __future__ import annotations

import abc
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from smg_tpu_torch.multimodal.image import (
    DEFAULT_MEAN,
    DEFAULT_STD,
    normalize_image,
    patchify,
    resize_image,
    smart_resize,
)

HALF = (0.5, 0.5, 0.5)  # mean and std of Llama 4, Phi-4 and Kimi-K2.5


@dataclass
class ProcessedImage:
    pixel_values: torch.Tensor  # [n_patches, patch_dim] float32, on the processor's device
    grid: tuple[int, int]  # (gh, gw) patch grid
    num_placeholder_tokens: int
    # merged LLM-token grid (gh_m, gw_m), set only by processors whose
    # placeholder run is a planar spatial grid (it drives M-RoPE); None for
    # tiled or stacked geometries
    llm_grid: "tuple[int, int] | None" = None


class ImageProcessor(abc.ABC):
    name = "base"

    @abc.abstractmethod
    def process(self, img) -> ProcessedImage:
        """A raw [H, W, C] image (numpy or a tensor) -> its pixels, grid and
        placeholder count."""


def _best_tiling(h: int, w: int, max_tiles: int, tile_size: int) -> tuple[int, int]:
    """(rows, cols) with rows * cols <= ``max_tiles`` closest to the image's
    aspect ratio; a ratio tie takes more tiles only when the image has the
    pixels to fill them (area over half the tiles' area).  InternVL's and
    Llama 4's rule, float ties included."""
    best, best_diff = (1, 1), float("inf")
    ratio = w / h
    area = h * w
    for rows in range(1, max_tiles + 1):
        for cols in range(1, max_tiles // rows + 1):
            diff = abs(cols / rows - ratio)
            prefer_bigger = (rows * cols > best[0] * best[1]
                             and area > 0.5 * rows * cols * tile_size ** 2)
            if diff < best_diff or (diff == best_diff and prefer_bigger):
                best, best_diff = (rows, cols), diff
    return best


def _tiles(img: torch.Tensor, rows: int, cols: int, size: int) -> list:
    """The ``size`` x ``size`` tiles of ``img``, row-major."""
    return [img[r * size:(r + 1) * size, c * size:(c + 1) * size]
            for r in range(rows) for c in range(cols)]


def _stack_patches(views: list, patch_size: int) -> torch.Tensor:
    return torch.cat([patchify(v, patch_size)[0] for v in views], dim=0)


class Qwen2VLImageProcessor(ImageProcessor):
    """Qwen2-VL: smart-resize to the factor patch * merge, 2x2 patch
    merging."""

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
        x = normalize_image(resize_image(img, h2, w2, device=self.device), device=self.device)
        patches, grid = patchify(x, self.patch_size)
        mgh, mgw = grid[0] // self.merge_size, grid[1] // self.merge_size
        return ProcessedImage(pixel_values=patches, grid=grid,
                              num_placeholder_tokens=mgh * mgw, llm_grid=(mgh, mgw))


class LlavaImageProcessor(ImageProcessor):
    """Fixed-size square resize (LLaVA/CLIP style), one token per patch."""

    name = "llava"

    def __init__(self, image_size: int = 336, patch_size: int = 14, device=None):
        self.image_size = image_size
        self.patch_size = patch_size
        self.device = device

    def process(self, img) -> ProcessedImage:
        x = resize_image(img, self.image_size, self.image_size, device=self.device)
        patches, grid = patchify(normalize_image(x, DEFAULT_MEAN, DEFAULT_STD,
                                                 device=self.device), self.patch_size)
        return ProcessedImage(pixel_values=patches, grid=grid,
                              num_placeholder_tokens=grid[0] * grid[1])


class InternVLImageProcessor(ImageProcessor):
    """InternVL dynamic tiling: up to ``max_tiles`` aspect-matched tiles of
    ``tile_size`` plus a global thumbnail when tiled; each tile gives
    (tile/patch/merge)^2 tokens."""

    name = "internvl"

    def __init__(self, tile_size: int = 448, patch_size: int = 14, merge_size: int = 2,
                 max_tiles: int = 12, use_thumbnail: bool = True, device=None):
        self.tile_size = tile_size
        self.patch_size = patch_size
        self.merge_size = merge_size
        self.max_tiles = max_tiles
        self.use_thumbnail = use_thumbnail
        self.device = device

    def _grid_for(self, h: int, w: int) -> tuple[int, int]:
        return _best_tiling(h, w, self.max_tiles, self.tile_size)

    def process(self, img) -> ProcessedImage:
        H, W = img.shape[:2]
        rows, cols = self._grid_for(H, W)
        ts = self.tile_size
        resized = normalize_image(resize_image(img, rows * ts, cols * ts, device=self.device),
                                  device=self.device)
        tiles = _tiles(resized, rows, cols, ts)
        if self.use_thumbnail and len(tiles) > 1:
            tiles.append(normalize_image(resize_image(img, ts, ts, device=self.device),
                                         device=self.device))
        g = ts // self.patch_size
        # the grid covers the stacked tiles vertically: (n_tiles * g, g)
        return ProcessedImage(pixel_values=_stack_patches(tiles, self.patch_size),
                              grid=(len(tiles) * g, g),
                              num_placeholder_tokens=len(tiles) * (g // self.merge_size) ** 2)


class PixtralImageProcessor(ImageProcessor):
    """Pixtral: longest side capped at ``max_size``, aspect kept, snapped to
    patch multiples; one token per patch (no merge)."""

    name = "pixtral"

    def __init__(self, max_size: int = 1024, patch_size: int = 16, device=None):
        self.max_size = max_size
        self.patch_size = patch_size
        self.device = device

    def process(self, img) -> ProcessedImage:
        H, W = img.shape[:2]
        scale = min(1.0, self.max_size / max(H, W))
        ps = self.patch_size
        h2 = max(ps, int(round(H * scale / ps)) * ps)
        w2 = max(ps, int(round(W * scale / ps)) * ps)
        x = normalize_image(resize_image(img, h2, w2, device=self.device), device=self.device)
        patches, grid = patchify(x, ps)
        return ProcessedImage(pixel_values=patches, grid=grid,
                              num_placeholder_tokens=grid[0] * grid[1])


class Gemma3ImageProcessor(ImageProcessor):
    """Gemma 3: fixed square resize (896), patch 14, a ``merge_size`` pooled
    merge (4: 256 tokens an image)."""

    name = "gemma3"

    def __init__(self, image_size: int = 896, patch_size: int = 14, merge_size: int = 4,
                 device=None):
        self.image_size = image_size
        self.patch_size = patch_size
        self.merge_size = merge_size
        self.device = device

    def process(self, img) -> ProcessedImage:
        x = resize_image(img, self.image_size, self.image_size, device=self.device)
        patches, grid = patchify(normalize_image(x, device=self.device), self.patch_size)
        merged = (grid[0] // self.merge_size) * (grid[1] // self.merge_size)
        return ProcessedImage(pixel_values=patches, grid=grid, num_placeholder_tokens=merged)


class Phi3VisionImageProcessor(ImageProcessor):
    """Phi-3.5-vision HD transform: resize to ``base`` multiples under a
    crop budget, plus a ``base`` x ``base`` global view first."""

    name = "phi3_v"

    def __init__(self, base: int = 336, patch_size: int = 14, max_crops: int = 4,
                 merge_size: int = 2, device=None):
        self.base = base
        self.patch_size = patch_size
        self.max_crops = max_crops
        self.merge_size = merge_size
        self.device = device

    def process(self, img) -> ProcessedImage:
        H, W = img.shape[:2]
        ratio = W / H
        cols = max(1, min(self.max_crops, int(round(math.sqrt(self.max_crops * ratio)))))
        rows = max(1, self.max_crops // cols)
        b = self.base
        main = normalize_image(resize_image(img, rows * b, cols * b, device=self.device),
                               device=self.device)
        # uniform base-size views stacked vertically (global, then crops)
        views = [normalize_image(resize_image(img, b, b, device=self.device),
                                 device=self.device)] + _tiles(main, rows, cols, b)
        g = b // self.patch_size
        return ProcessedImage(pixel_values=_stack_patches(views, self.patch_size),
                              grid=(len(views) * g, g),
                              num_placeholder_tokens=len(views) * (g * g) // self.merge_size ** 2)


class Llama4VisionProcessor(ImageProcessor):
    """Llama 4: aspect-matched ``tile_size`` tiling under a 16-tile budget,
    a global tile last when tiled; (tile/patch)^2 tokens a tile, no merge;
    mean and std 0.5."""

    name = "llama4"

    def __init__(self, tile_size: int = 336, patch_size: int = 14, max_tiles: int = 16,
                 device=None):
        self.tile_size = tile_size
        self.patch_size = patch_size
        self.max_tiles = max_tiles
        self.device = device

    def process(self, img) -> ProcessedImage:
        H, W = img.shape[:2]
        ts = self.tile_size
        rows, cols = _best_tiling(H, W, self.max_tiles, ts)
        resized = normalize_image(resize_image(img, rows * ts, cols * ts, device=self.device),
                                  HALF, HALF, device=self.device)
        tiles = _tiles(resized, rows, cols, ts)
        if len(tiles) > 1:  # the global view rides last
            tiles.append(normalize_image(resize_image(img, ts, ts, device=self.device),
                                         HALF, HALF, device=self.device))
        g = ts // self.patch_size
        return ProcessedImage(pixel_values=_stack_patches(tiles, self.patch_size),
                              grid=(len(tiles) * g, g),
                              num_placeholder_tokens=len(tiles) * g * g)


class Phi4VisionProcessor(ImageProcessor):
    """Phi-4-multimodal HD transform: ``base`` crops under a ``dynamic_hd``
    budget plus a global view first; tokens ``256 + 1 + 256 * crops +
    16 * rows + 16`` (the reference's formula with full masks)."""

    name = "phi4_v"

    def __init__(self, base: int = 448, patch_size: int = 14, dynamic_hd: int = 36,
                 merge_size: int = 2, device=None):
        self.base = base
        self.patch_size = patch_size
        self.dynamic_hd = dynamic_hd
        self.merge_size = merge_size
        self.device = device

    def process(self, img) -> ProcessedImage:
        H, W = img.shape[:2]
        ratio = W / H
        cols = max(1, min(self.dynamic_hd, int(round(math.sqrt(self.dynamic_hd * ratio)))))
        rows = max(1, min(self.dynamic_hd // cols, self.dynamic_hd))
        b = self.base
        main = normalize_image(resize_image(img, rows * b, cols * b, device=self.device),
                               HALF, HALF, device=self.device)
        views = [normalize_image(resize_image(img, b, b, device=self.device), HALF, HALF,
                                 device=self.device)] + _tiles(main, rows, cols, b)
        g = b // self.patch_size
        per_view = (g // self.merge_size) ** 2
        tokens = per_view + 1 + per_view * rows * cols + (g // 2) * rows + (g // 2)
        return ProcessedImage(pixel_values=_stack_patches(views, self.patch_size),
                              grid=(len(views) * g, g), num_placeholder_tokens=tokens)


class KimiK25ImageProcessor(ImageProcessor):
    """Kimi-K2.5: scaled down to fit the side and area patch budgets (never
    up), then zero-padded, not resized, to (patch * merge)-multiples; 2x2
    merge, a planar grid."""

    name = "kimi_k25"

    def __init__(self, patch_size: int = 14, merge_size: int = 2,
                 in_patch_limit: int = 16384, side_patch_limit: int = 512, device=None):
        self.patch_size = patch_size
        self.merge_size = merge_size
        self.in_patch_limit = in_patch_limit
        self.side_patch_limit = side_patch_limit
        self.device = device

    def process(self, img) -> ProcessedImage:
        ps = self.patch_size
        H, W = img.shape[:2]
        side_cap = self.side_patch_limit * ps
        area_cap = self.in_patch_limit * ps * ps
        scale = min(1.0, side_cap / max(H, W), math.sqrt(area_cap / (H * W)))
        h2, w2 = max(1, int(H * scale)), max(1, int(W * scale))
        if scale < 1.0:
            img = resize_image(img, h2, w2, device=self.device)
        x = normalize_image(img, HALF, HALF, device=self.device)
        factor = ps * self.merge_size
        pad_h, pad_w = (-x.shape[0]) % factor, (-x.shape[1]) % factor
        if pad_h or pad_w:
            x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))  # zeros below and to the right
        patches, grid = patchify(x, ps)
        mgh, mgw = grid[0] // self.merge_size, grid[1] // self.merge_size
        return ProcessedImage(pixel_values=patches, grid=grid,
                              num_placeholder_tokens=mgh * mgw, llm_grid=(mgh, mgw))


class Qwen3OmniVisionProcessor(Qwen2VLImageProcessor):
    """Qwen3-Omni's vision leg: the Qwen smart resize at patch 16."""

    name = "qwen3_omni"

    def __init__(self, patch_size: int = 16, merge_size: int = 2, min_pixels: int = 3136,
                 max_pixels: int = 12_845_056, device=None):
        super().__init__(patch_size=patch_size, merge_size=merge_size,
                         min_pixels=min_pixels, max_pixels=max_pixels, device=device)


_PROCESSORS = {
    "qwen2_vl": Qwen2VLImageProcessor,
    "qwen3_vl": Qwen2VLImageProcessor,
    "llava": LlavaImageProcessor,
    "internvl": InternVLImageProcessor,
    "pixtral": PixtralImageProcessor,
    "gemma3": Gemma3ImageProcessor,
    "phi3_v": Phi3VisionImageProcessor,
    "llama4": Llama4VisionProcessor,
    "phi4_v": Phi4VisionProcessor,
    "kimi_k25": KimiK25ImageProcessor,
    "qwen3_omni": Qwen3OmniVisionProcessor,
}

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


def get_image_processor(name_or_model: str, device=None) -> ImageProcessor:
    """The processor of a family or model name, with its default geometry;
    a name of no known family takes LLaVA's, as in the reference."""
    key = (name_or_model or "").lower()
    if key in _PROCESSORS:
        return _PROCESSORS[key](device=device)
    for sub, name in _MODEL_MAP:
        if sub in key:
            return _PROCESSORS[name](device=device)
    return LlavaImageProcessor(device=device)


def processor_for_worker(name_or_model: str, patch_size: int | None = None,
                         merge_size: int | None = None, device=None) -> ImageProcessor:
    """Processor matched to a worker's advertised vision tower (its model
    info's vision fields): the family by model name, the geometry from the
    worker so the gateway's patchify agrees with the tower's patch
    embedding.  Unknown families take the smart-resize (Qwen2-VL-style)
    processor, the general dynamic-resolution mechanism."""
    key = (name_or_model or "").lower()
    family = next((name for sub, name in _MODEL_MAP if sub in key), None)
    ps, ms = patch_size, merge_size
    if family == "llava":
        return LlavaImageProcessor(patch_size=ps or 14, device=device)
    if family == "internvl":
        return InternVLImageProcessor(patch_size=ps or 14, merge_size=ms or 2, device=device)
    if family == "pixtral":
        return PixtralImageProcessor(patch_size=ps or 16, device=device)
    if family == "gemma3":
        return Gemma3ImageProcessor(patch_size=ps or 14, merge_size=ms or 4, device=device)
    if family == "phi3_v":
        return Phi3VisionImageProcessor(patch_size=ps or 14, merge_size=ms or 2, device=device)
    if family == "llama4":
        return Llama4VisionProcessor(patch_size=ps or 14, device=device)
    if family == "phi4_v":
        return Phi4VisionProcessor(patch_size=ps or 14, merge_size=ms or 2, device=device)
    if family == "kimi_k25":
        return KimiK25ImageProcessor(patch_size=ps or 14, merge_size=ms or 2, device=device)
    if family == "qwen3_omni":
        return Qwen3OmniVisionProcessor(patch_size=ps or 16, merge_size=ms or 2, device=device)
    return Qwen2VLImageProcessor(patch_size=ps or 14, merge_size=ms or 2, device=device)
