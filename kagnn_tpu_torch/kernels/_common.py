"""Argument checks shared by the kernel wrappers."""
from __future__ import annotations

import torch

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(t: torch.Tensor) -> int:
    try:
        return DTYPE_CODE[t.dtype]
    except KeyError:
        raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}") from None


def check_cuda(name: str, t: torch.Tensor, dtype=None, shape=None) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of the given dtype and
    shape (None entries of `shape` match any size)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None:
        if t.dim() != len(shape) or any(
                s is not None and s != a for s, a in zip(shape, t.shape)):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def segment_ids(row_ptr: torch.Tensor) -> torch.Tensor:
    """Row of each CSR entry: row_ptr (n+1,) -> (row_ptr[-1],) int64."""
    n = row_ptr.numel() - 1
    counts = (row_ptr[1:] - row_ptr[:-1]).long()
    return torch.repeat_interleave(
        torch.arange(n, device=row_ptr.device), counts)
