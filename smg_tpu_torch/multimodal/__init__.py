"""Multimodal preprocessing on the port: the Qwen2-VL image pipeline (port of
``smg_tpu/multimodal``).  Resize, normalize and patchify run as torch ops on
an explicit device, the card by default; decoding (PNG/JPEG) uses PIL when
it is installed.  The reference's other processors, ``video.py`` and
``audio.py`` are not ported (ROADMAP Queue A item 4).
"""

from smg_tpu_torch.multimodal.image import normalize_image, patchify, resize_image, smart_resize
from smg_tpu_torch.multimodal.processor import (
    ImageProcessor,
    Qwen2VLImageProcessor,
    get_image_processor,
)

__all__ = [
    "resize_image",
    "normalize_image",
    "patchify",
    "smart_resize",
    "ImageProcessor",
    "Qwen2VLImageProcessor",
    "get_image_processor",
]
