"""Argument checks shared by the kernel wrappers: the kernels read raw
pointers, so everything they rely on is validated here before a launch."""

from __future__ import annotations

import torch

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(t: torch.Tensor) -> int:
    try:
        return DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(
            f"kernel takes float32 or bfloat16 tensors, got {t.dtype}"
        ) from None


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def check_cuda(name_to_tensor: dict, dtype: torch.dtype | None = None) -> None:
    """Every tensor on one CUDA device, contiguous, 16-byte aligned, and of
    ``dtype`` when given."""
    dev = None
    for name, t in name_to_tensor.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
        if dtype is not None and t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")


def raise_on_error(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError_t {err}")
