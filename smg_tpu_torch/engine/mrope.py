"""M-RoPE position ids, computed on the host per request — the port's copy of
``smg_tpu/engine/mrope.py``.

Qwen2-VL's multimodal rotary scheme (the published ``get_rope_index``
recipe): every token carries three position ids (temporal, height, width).

- Text tokens: all three equal the running position ``p``; ``p`` advances 1.
- An image's tokens (merged LLM grid ``gh x gw``, row-major): temporal is
  pinned at the image's start position ``p0``; height = ``p0 + row``;
  width = ``p0 + col``.  After the image ``p`` jumps to ``p0 + max(gh, gw)``
  so later text clears the widest spatial extent.

Decode positions continue at ``max_position + 1``, which differs from the
sequence length once images compress positions, so each request carries
``delta = (max_pos + 1) - prompt_len`` and decode applies ``rope_position =
seq_position + delta`` (the three axes are equal for generated text, so
decode stays on the standard rope path with an offset).
"""

from __future__ import annotations

import numpy as np


def mrope_positions(
    prompt_len: int,
    images: "list[tuple[int, int, int]]",  # (start, gh, gw) merged grid each
) -> tuple[np.ndarray, int]:
    """-> (positions [3, prompt_len] int32, decode delta).

    ``images`` must be non-overlapping runs of ``gh*gw`` placeholder tokens
    starting at ``start``, ascending."""
    pos = np.zeros((3, prompt_len), np.int32)
    p = 0
    i = 0
    images = sorted(images)
    t = 0
    while t < prompt_len:
        if i < len(images) and t == images[i][0]:
            start, gh, gw = images[i]
            n = gh * gw
            if start + n > prompt_len:
                raise ValueError(
                    f"image run [{start}, {start + n}) exceeds prompt {prompt_len}")
            rows = np.repeat(np.arange(gh, dtype=np.int32), gw)
            cols = np.tile(np.arange(gw, dtype=np.int32), gh)
            pos[0, t:t + n] = p
            pos[1, t:t + n] = p + rows
            pos[2, t:t + n] = p + cols
            p += max(gh, gw)
            t += n
            i += 1
        else:
            pos[:, t] = p
            p += 1
            t += 1
    return pos, int(p - prompt_len)


def image_runs_from_positions(
    positions: np.ndarray, grids: "list[tuple[int, int]]"
) -> "list[tuple[int, int, int]]":
    """Split the flat placeholder position array into per-image (start, gh,
    gw) runs: the splice positions are contiguous per image, in order."""
    runs = []
    off = 0
    for gh, gw in grids:
        n = gh * gw
        chunk = positions[off:off + n]
        if len(chunk) != n:
            raise ValueError("mm positions shorter than the grids describe")
        if n and (np.diff(chunk) != 1).any():
            raise ValueError("image placeholder run is not contiguous")
        runs.append((int(chunk[0]) if n else 0, int(gh), int(gw)))
        off += n
    if off != len(positions):
        raise ValueError("mm positions longer than the grids describe")
    return runs
