"""Multimodal preprocessing on the port (port of ``smg_tpu/multimodal``):
every image processor of the reference, video frame sampling and the audio
front-end.  Resize, normalize, pad and patchify run as torch ops on an
explicit device, the card by default; decoding (PNG/JPEG, GIF frames) uses
PIL when it is installed; the audio front-end is numpy on the host.
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
