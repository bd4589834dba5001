"""Argument checks, the launch stream and the launch device shared by the
kernels' wrappers."""
from __future__ import annotations

import torch


def require(name: str, t, dtype: torch.dtype, dim: int, device: torch.device) -> None:
    """``t`` is a contiguous tensor of ``dtype`` with ``dim`` dims on ``device``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.dtype != dtype or t.dim() != dim:
        raise TypeError(f"{name}: {t.dtype} of {t.dim()} dims; expected {dtype} of {dim}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the other inputs on {device}")


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of the current CUDA stream of ``t``'s device, read
    without building a ``torch.cuda.Stream``."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def launch_on(t: torch.Tensor, fn, *args) -> int:
    """``fn(*args)`` with ``t``'s CUDA device current; the device context is
    entered only when another device is current."""
    index = t.device.index
    if torch.cuda.current_device() == index:
        return fn(*args)
    with torch.cuda.device(index):
        return fn(*args)
