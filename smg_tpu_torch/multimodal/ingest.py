"""Gateway-side image ingestion: OpenAI/Anthropic content parts -> pixel
arrays, and prompt placeholder expansion — the port's copy of
``smg_tpu/multimodal/ingest.py``.

Reference: the EncodeStage extracts image content from chat requests and
ships pixels to the encode leg (``model_gateway/src/routers/grpc/common/
stages/encode.rs:1-40``); URL/base64/data-URI handling mirrors the
reference's multimodal request parsing (``crates/multimodal``).  Decoding
uses PIL (the reference uses image crates/OpenCV); resize/normalize/patchify
then run as torch ops on the card (``smg_tpu_torch/multimodal/image.py``).
PIL is imported only when an image is decoded: where it is not installed,
an image part answers "image decoding unavailable (no PIL)", a 400.
"""

from __future__ import annotations

import base64
import binascii
import io

import numpy as np


class ImageIngestError(ValueError):
    """Malformed or unfetchable image content (maps to HTTP 400)."""


def extract_image_parts(messages: list[dict]) -> list[dict]:
    """Collect image content parts from chat messages, in prompt order.

    Returns the raw part dicts (OpenAI ``image_url`` parts and Anthropic
    ``image`` source blocks).  ``messages`` is not modified.
    """
    parts: list[dict] = []
    for m in messages:
        content = m.get("content")
        if not isinstance(content, list):
            continue
        for part in content:
            if isinstance(part, dict) and part.get("type") in ("image_url", "image"):
                parts.append(part)
    return parts


def flatten_content(messages: list[dict], placeholder: str) -> list[dict]:
    """Rewrite list-content messages to plain strings, replacing each image
    part with ``placeholder`` text.  Keeps text parts in order so the chat
    template sees one string per message (placeholders later re-tokenize to
    the model's image token and get grid-expanded)."""
    out = []
    for m in messages:
        content = m.get("content")
        if not isinstance(content, list):
            out.append(m)
            continue
        pieces: list[str] = []
        for part in content:
            if not isinstance(part, dict):
                pieces.append(str(part))
            elif part.get("type") == "text":
                pieces.append(part.get("text") or "")
            elif part.get("type") in ("image_url", "image"):
                pieces.append(placeholder)
            # unknown part types are dropped (reference behavior: ignore)
        m2 = dict(m)
        m2["content"] = " ".join(p for p in pieces if p)
        out.append(m2)
    return out


def _decode_base64(data: str) -> bytes:
    try:
        return base64.b64decode(data, validate=True)
    except (binascii.Error, ValueError) as e:
        raise ImageIngestError(f"invalid base64 image data: {e}")


def _bytes_to_array(raw: bytes) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError:
        raise ImageIngestError("image decoding unavailable (no PIL)")
    try:
        img = Image.open(io.BytesIO(raw))
        img = img.convert("RGB")
    except Exception as e:
        raise ImageIngestError(f"cannot decode image: {e}")
    return np.asarray(img, dtype=np.uint8)  # [H, W, 3]


async def fetch_image(part: dict, http_session=None) -> np.ndarray:
    """Resolve one image content part to an RGB uint8 array [H, W, 3].

    Accepts (reference: multimodal request parsing):
    - OpenAI: ``{"type": "image_url", "image_url": {"url": ...}}`` where url
      is a ``data:`` URI, raw base64, or ``http(s)://`` (fetched — works for
      intra-cluster/object-store URLs; the serving host needs reachability);
    - Anthropic: ``{"type": "image", "source": {"type": "base64", "data": ...}}``.
    """
    ptype = part.get("type")
    if ptype == "image":
        source = part.get("source") or {}
        if source.get("type") == "base64":
            return _bytes_to_array(_decode_base64(source.get("data") or ""))
        if source.get("type") == "url":
            return await _fetch_url(source.get("url") or "", http_session)
        raise ImageIngestError(f"unsupported image source type {source.get('type')!r}")
    url_field = part.get("image_url")
    if isinstance(url_field, dict):
        url = url_field.get("url") or ""
    else:
        url = url_field or ""
    if not url:
        raise ImageIngestError("image_url part has no url")
    if url.startswith("data:"):
        # data:[<mediatype>][;base64],<data>
        try:
            header, data = url.split(",", 1)
        except ValueError:
            raise ImageIngestError("malformed data URI")
        if not header.endswith(";base64"):
            raise ImageIngestError("data URI must be base64-encoded")
        return _bytes_to_array(_decode_base64(data))
    if url.startswith(("http://", "https://")):
        return await _fetch_url(url, http_session)
    # bare base64 (some clients send the payload without the data: header)
    return _bytes_to_array(_decode_base64(url))


async def _fetch_url(url: str, http_session=None) -> np.ndarray:
    import aiohttp

    close = False
    if http_session is None:
        http_session = aiohttp.ClientSession()
        close = True
    try:
        async with http_session.get(
            url, timeout=aiohttp.ClientTimeout(total=30)
        ) as resp:
            if resp.status != 200:
                raise ImageIngestError(f"image fetch failed: HTTP {resp.status}")
            raw = await resp.read()
    except ImageIngestError:
        raise
    except Exception as e:
        raise ImageIngestError(f"image fetch failed: {e}")
    finally:
        if close:
            await http_session.close()
    return _bytes_to_array(raw)


def expand_image_placeholders(
    input_ids: list[int], image_token_id: int, counts: list[int]
) -> tuple[list[int], list[int]]:
    """Expand each occurrence of ``image_token_id`` to ``counts[i]`` copies
    (one per merged vision token, reference: grid-based prompt expansion in
    the encode stage).  Returns (new_ids, positions) where positions index
    every expanded placeholder slot in the new id list."""
    occurrences = sum(1 for t in input_ids if t == image_token_id)
    if occurrences != len(counts):
        raise ImageIngestError(
            f"prompt has {occurrences} image placeholder(s) but request "
            f"carries {len(counts)} image(s)"
        )
    new_ids: list[int] = []
    positions: list[int] = []
    img_idx = 0
    for t in input_ids:
        if t == image_token_id:
            n = counts[img_idx]
            img_idx += 1
            positions.extend(range(len(new_ids), len(new_ids) + n))
            new_ids.extend([image_token_id] * n)
        else:
            new_ids.append(t)
    return new_ids, positions
