"""Tokenizer bundle: ship a worker's tokenizer to the gateway over the RPC
(the port's copy of ``smg_tpu/tokenizer/bundle.py``, byte-compatible).

Reference: ``GetTokenizer`` streaming RPC (``sglang_scheduler.proto:43-45``)
paired with ``grpc_servicer/.../tokenizer_bundle.py`` (zip + sha256
streaming) — the gateway does all tokenization, so a freshly registered
worker must be able to hand over its tokenizer instead of requiring the
operator to mirror tokenizer files onto the gateway host.

Formats:
- ``zip``       — the HF tokenizer directory's relevant files;
- ``mock-json`` — a MockTokenizer descriptor (tests / token-id workloads).
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import tempfile
import zipfile

_BUNDLE_FILES = (
    "tokenizer.json",
    "tokenizer_config.json",
    "chat_template.jinja",
    "special_tokens_map.json",
)


def make_bundle(tokenizer) -> tuple[bytes, str, str]:
    """(data, format, sha256) for a worker's tokenizer object."""
    path = getattr(tokenizer, "path", None)
    if path:
        dirname = path if os.path.isdir(path) else os.path.dirname(path)
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
            for name in _BUNDLE_FILES:
                p = os.path.join(dirname, name)
                if os.path.exists(p):
                    z.write(p, name)
        data, fmt = buf.getvalue(), "zip"
    else:  # MockTokenizer-style
        desc = {
            "kind": "mock",
            "vocab_size": getattr(tokenizer, "vocab_size", 512),
            "eos_token_id": getattr(tokenizer, "eos_token_id", 0),
            "bos_token_id": getattr(tokenizer, "bos_token_id", 1),
        }
        data, fmt = json.dumps(desc).encode(), "mock-json"
    return data, fmt, hashlib.sha256(data).hexdigest()


def load_bundle(data: bytes, fmt: str, sha256: str | None = None):
    """Materialize a bundle into a live tokenizer object."""
    if sha256 is not None:
        actual = hashlib.sha256(data).hexdigest()
        if actual != sha256:
            raise ValueError(f"tokenizer bundle sha256 mismatch: {actual} != {sha256}")
    if fmt == "mock-json":
        from smg_tpu_torch.tokenizer import MockTokenizer

        desc = json.loads(data)
        return MockTokenizer(
            vocab_size=int(desc.get("vocab_size", 512)),
            eos_token_id=int(desc.get("eos_token_id", 0)),
            bos_token_id=int(desc.get("bos_token_id", 1)),
        )
    if fmt == "zip":
        from smg_tpu_torch.tokenizer.hf import HFTokenizer

        # bundles are small (a few MB); a persistent temp dir keeps the
        # HFTokenizer's lazy file accesses valid for the process lifetime
        dirname = tempfile.mkdtemp(prefix="smg_tokenizer_")
        with zipfile.ZipFile(io.BytesIO(data)) as z:
            z.extractall(dirname)
        return HFTokenizer(dirname)
    raise ValueError(f"unknown tokenizer bundle format {fmt!r}")
