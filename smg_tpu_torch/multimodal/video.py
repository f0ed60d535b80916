"""Video preprocessing: frame sampling and per-frame vision processing —
the port's copy of ``smg_tpu/multimodal/video.py``.

Codec demuxing is out of scope (no ffmpeg or OpenCV): multi-frame
containers PIL reads (GIF, APNG, multipage TIFF) decode here, and lists of
frames already extracted are taken as they are.  Each sampled frame goes
through an image processor, on that processor's device; the frames'
patches are concatenated there.
"""

from __future__ import annotations

import io
from dataclasses import dataclass

import numpy as np
import torch


def decode_video_bytes(raw: bytes, max_frames: int = 256) -> list[np.ndarray]:
    """Multi-frame image container -> list of RGB uint8 [H, W, 3] frames."""
    from PIL import Image, ImageSequence

    img = Image.open(io.BytesIO(raw))
    frames = []
    for frame in ImageSequence.Iterator(img):
        frames.append(np.asarray(frame.convert("RGB"), np.uint8))
        if len(frames) >= max_frames:
            break
    if not frames:
        raise ValueError("no frames decoded")
    return frames


def sample_frames(frames: list, num_frames: int) -> list:
    """Uniform temporal sampling (the standard VLM recipe)."""
    if len(frames) <= num_frames:
        return list(frames)
    idx = np.linspace(0, len(frames) - 1, num_frames).round().astype(int)
    return [frames[i] for i in idx]


@dataclass
class ProcessedVideo:
    pixel_values: torch.Tensor  # [sum_patches, patch_dim], on the processor's device
    frame_grids: list  # per-frame (gh, gw)
    num_placeholder_tokens: int
    num_frames: int


class VideoProcessor:
    """Per-frame image processing with uniform sampling; the token count is
    the per-frame sum (temporal pooling is the tower's concern)."""

    def __init__(self, image_processor, num_frames: int = 8):
        self.image_processor = image_processor
        self.num_frames = num_frames

    def process(self, frames: list) -> ProcessedVideo:
        picked = sample_frames(frames, self.num_frames)
        parts, grids, tokens = [], [], 0
        for f in picked:
            p = self.image_processor.process(f)
            parts.append(p.pixel_values)
            grids.append(p.grid)
            tokens += p.num_placeholder_tokens
        return ProcessedVideo(pixel_values=torch.cat(parts, dim=0), frame_grids=grids,
                              num_placeholder_tokens=tokens, num_frames=len(picked))

    def process_bytes(self, raw: bytes) -> ProcessedVideo:
        return self.process(decode_video_bytes(raw))
