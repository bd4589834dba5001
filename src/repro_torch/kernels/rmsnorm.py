"""Row RMSNorm, gemma-style ``(1 + scale)``: the CUDA kernel's wrapper and
its gradient.

Port of ``repro.kernels.rmsnorm.rmsnorm_fwd``; the kernel is
``csrc/rmsnorm.cu``. On a CUDA tensor ``rmsnorm_fwd`` launches the kernel (or
raises); on a CPU tensor it computes the plain version ``ref.rmsnorm``.
``launches`` counts kernel launches. The launch path is kept short, since a
decode step makes 105 of these calls on rows of a few KB: cheap checks, no
device context unless ``x`` lies on another device than the current one, the
stream's raw handle.

``RMSNormFn`` is the autograd function the model's norms go through: its
forward is ``rmsnorm_fwd``, its backward ``rmsnorm_bwd`` in plain PyTorch (the
JAX package has no backward kernel for RMSNorm either).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.checks import launch_on, stream_of
from repro_torch.kernels.flash_attention import DTYPE_CODES

launches = 0
MAX_WIDTH = 8192      # csrc/rmsnorm.cu: rmsnorm_max_width(), a row in one block

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("rmsnorm").rmsnorm_fwd
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(x, scale):
    """The inputs' rules, checked by cheap reads in order (a message is
    built only for a failure); returns the dtype codes and D."""
    if not isinstance(x, torch.Tensor) or not isinstance(scale, torch.Tensor):
        raise TypeError("x and scale must be tensors")
    cx, cs = DTYPE_CODES.get(x.dtype), DTYPE_CODES.get(scale.dtype)
    if cx is None or cs is None:
        raise TypeError(f"dtypes x {x.dtype}, scale {scale.dtype}; supported: float32, bfloat16")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("x and scale must be contiguous")
    if x.dim() < 1 or scale.dim() != 1 or scale.shape[0] != x.shape[-1]:
        raise ValueError(f"shapes x {tuple(x.shape)}, scale {tuple(scale.shape)}: "
                         "scale must be (D,) for x (..., D)")
    if x.device != scale.device:
        raise ValueError(f"devices differ: {x.device}, {scale.device}")
    return cx, cs, x.shape[-1]


def rmsnorm_fwd(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x: (..., D); scale: (D,) -> (..., D) in x's dtype. Any number of rows."""
    global launches
    cx, cs, d = _check(x, scale)
    dev = x.device
    if dev.type != "cuda":
        if dev.type == "cpu":
            return ref.rmsnorm(x, scale, eps)
        raise ValueError(f"unsupported device {dev}")
    rows = x.numel() // d if d else 0
    if not 0 < d <= MAX_WIDTH:
        raise ValueError(f"row width {d} outside 1..{MAX_WIDTH}")
    if rows >= 2 ** 31:
        raise ValueError(f"{rows} rows: the kernel takes at most 2^31 - 1")
    out = torch.empty_like(x)
    if rows == 0:
        return out
    err = launch_on(x, _fn or _kernel(), x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows,
                    d, eps, cx, cs, stream_of(x))
    if err != 0:
        raise RuntimeError(f"rmsnorm_fwd launch failed: CUDA error {err}")
    launches += 1
    return out


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                eps: float = 1e-6):
    """Gradients of ``ref.rmsnorm`` in fp32: with r = rsqrt(mean(x^2) + eps),
    x_hat = x * r and g = dy * (1 + scale),
    dx = r * (g - x_hat * mean(g * x_hat)) and dscale = sum over rows of
    dy * x_hat. Returns (dx in x's dtype, dscale in scale's dtype)."""
    xf = x.float()
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    x_hat = xf * r
    dyf = dy.float()
    g = dyf * (1.0 + scale.float())
    dx = r * (g - x_hat * (g * x_hat).mean(dim=-1, keepdim=True))
    dscale = (dyf * x_hat).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


class RMSNormFn(torch.autograd.Function):
    """``rmsnorm_fwd`` with ``rmsnorm_bwd`` as its gradient."""

    @staticmethod
    def forward(ctx, x, scale, eps: float):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rmsnorm_fwd(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd(x, scale, dy, ctx.eps)
        return dx, dscale, None
