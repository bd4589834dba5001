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

The split mode normalises rows whose columns lie on several ranks (the norm
over every head of a recurrent cell computed on a rank's heads):
``rmsnorm_sumsq`` launches the kernel that writes each row's float32 sum of
squares over the rank's columns, the caller sums them over the ranks (a
``Split``'s ``reduce``: one all-reduce of (rows,) float32), and
``rmsnorm_scale`` launches the kernel that scales the rank's columns by the
whole row's factor. ``split_launches`` counts the two launches.
``RMSNormFn`` with a ``Split`` runs the two, and its backward sums each row's
dy (1 + scale) x over the ranks as well (``rmsnorm_split_bwd``).
"""
from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.checks import launch_on, stream_of
from repro_torch.kernels.flash_attention import DTYPE_CODES

launches = 0
split_launches = 0
MAX_WIDTH = 8192      # csrc/rmsnorm.cu: rmsnorm_max_width(), a row in one block

_fn = None
_split_fns = None


class Split(NamedTuple):
    """A row held in part: ``width`` the whole row's columns, ``reduce`` a
    function summing a float32 tensor of per-row values over the ranks that
    hold the row's columns (the identity where one rank holds them all)."""
    width: int
    reduce: Callable[[torch.Tensor], torch.Tensor]


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("rmsnorm").rmsnorm_fwd
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _split_kernels():
    global _split_fns
    if _split_fns is None:
        lib = _build.load("rmsnorm")
        sumsq, scale = lib.rmsnorm_sumsq, lib.rmsnorm_scale
        sumsq.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        scale.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        sumsq.restype = scale.restype = ctypes.c_int
        _split_fns = sumsq, scale
    return _split_fns


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


def _rows(x: torch.Tensor, d: int) -> int:
    rows = x.numel() // d if d else 0
    if not 0 < d <= 2 ** 31 - 1 or rows >= 2 ** 31:
        raise ValueError(f"{rows} rows of {d}: the split kernels take 1 .. 2^31 - 1 of each")
    return rows


def rmsnorm_sumsq(x: torch.Tensor) -> torch.Tensor:
    """Each row's float32 sum of squares over the columns ``x`` (..., D)
    holds: (...,) float32. The split mode's first launch."""
    global split_launches
    if not isinstance(x, torch.Tensor) or x.dtype not in DTYPE_CODES:
        raise TypeError("x must be a float32 or bfloat16 tensor")
    if x.device.type != "cuda":
        if x.device.type == "cpu":
            return ref.rmsnorm_sumsq(x)
        raise ValueError(f"unsupported device {x.device}")
    if not x.is_contiguous() or x.dim() < 1:
        raise ValueError("x must be contiguous, (..., D)")
    out = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    rows = _rows(x, x.shape[-1])
    if rows == 0:
        return out
    err = launch_on(x, _split_kernels()[0], x.data_ptr(), out.data_ptr(), rows, x.shape[-1],
                    DTYPE_CODES[x.dtype], stream_of(x))
    if err != 0:
        raise RuntimeError(f"rmsnorm_sumsq launch failed: CUDA error {err}")
    split_launches += 1
    return out


def rmsnorm_scale(x: torch.Tensor, sumsq: torch.Tensor, scale: torch.Tensor, width: int,
                  eps: float = 1e-6) -> torch.Tensor:
    """``x``'s columns (..., D) scaled by rsqrt(sumsq / width + eps) *
    (1 + scale): ``sumsq`` (...,) float32, each row's sum of squares over
    all its ``width`` columns; ``scale`` (D,), that of x's columns. The
    split mode's second launch."""
    global split_launches
    cx, cs, d = _check(x, scale)
    if not (sumsq.dtype == torch.float32 and sumsq.shape == x.shape[:-1]
            and sumsq.device == x.device):
        raise ValueError(f"sumsq must be float32 {tuple(x.shape[:-1])} on {x.device}")
    if width < d:
        raise ValueError(f"whole width {width} below the shard's {d} columns")
    if x.device.type != "cuda":
        if x.device.type == "cpu":
            return ref.rmsnorm_scale(x, sumsq, scale, width, eps)
        raise ValueError(f"unsupported device {x.device}")
    out = torch.empty_like(x)
    rows = _rows(x, d)
    if rows == 0:
        return out
    sumsq = sumsq.contiguous()
    err = launch_on(x, _split_kernels()[1], x.data_ptr(), sumsq.data_ptr(), scale.data_ptr(),
                    out.data_ptr(), rows, d, width, eps, cx, cs, stream_of(x))
    if err != 0:
        raise RuntimeError(f"rmsnorm_scale launch failed: CUDA error {err}")
    split_launches += 1
    return out


def rmsnorm_split_fwd(x: torch.Tensor, scale: torch.Tensor, eps: float, split: Split,
                      use_kernel: bool = True):
    """The split mode's forward: (out, the rows' sums of squares summed
    over the ranks). ``use_kernel=False`` computes the plain halves."""
    if use_kernel:
        total = split.reduce(rmsnorm_sumsq(x))
        return rmsnorm_scale(x, total, scale, split.width, eps), total
    total = split.reduce(ref.rmsnorm_sumsq(x))
    return ref.rmsnorm_scale(x, total, scale, split.width, eps), total


def rmsnorm_split_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                      sumsq: torch.Tensor, split: Split, eps: float = 1e-6):
    """``rmsnorm_bwd`` for a row held in part: r from the rows' sums of
    squares over every rank (``sumsq``), and the row mean of g * x_hat from
    its sum over the ranks (``split.reduce``: the backward's own
    all-reduce). Returns (dx of this rank's columns, dscale of theirs)."""
    xf = x.float()
    r = torch.rsqrt(sumsq.float()[..., None] / split.width + eps)
    x_hat = xf * r
    dyf = dy.float()
    g = dyf * (1.0 + scale.float())
    dot = split.reduce((g * x_hat).sum(dim=-1)) / split.width
    dx = r * (g - x_hat * dot[..., None])
    dscale = column_sum(dyf * x_hat)
    return dx.to(x.dtype), dscale.to(scale.dtype)


def column_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum over every row of a (..., D) float32 tensor, as a
    matrix-vector product with ones: cuBLAS needs no buffer for it, where
    the CUDA reduction over the rows allocates a staging buffer of up to
    twice its input (132 MiB at (8704, 3584) on the H100), which the dry
    run's trace of a step cannot count."""
    t = t.reshape(-1, t.shape[-1])
    return torch.mv(t.t(), t.new_ones(t.shape[0]))


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
    dscale = column_sum(dyf * x_hat)
    return dx.to(x.dtype), dscale.to(scale.dtype)


class RMSNormFn(torch.autograd.Function):
    """``rmsnorm_fwd`` (with ``use_kernel`` False, the plain version) with
    ``rmsnorm_bwd`` as its gradient; with a ``Split``, the split mode
    (``rmsnorm_split_fwd``, through the kernels or, with ``use_kernel``
    False, the plain halves) with ``rmsnorm_split_bwd``. The plain forward
    serves the dry run's trace on the meta device (``ops.rmsnorm``), which
    saves and computes in the backward what the kernel path does."""

    @staticmethod
    def forward(ctx, x, scale, eps: float, split: Split = None, use_kernel: bool = True):
        ctx.eps, ctx.split = eps, split
        if split is None:
            ctx.save_for_backward(x, scale)
            return rmsnorm_fwd(x, scale, eps) if use_kernel else ref.rmsnorm(x, scale, eps)
        out, total = rmsnorm_split_fwd(x, scale, eps, split, use_kernel)
        ctx.save_for_backward(x, scale, total)
        return out

    @staticmethod
    def backward(ctx, dy):
        if ctx.split is None:
            x, scale = ctx.saved_tensors
            dx, dscale = rmsnorm_bwd(x, scale, dy, ctx.eps)
        else:
            x, scale, total = ctx.saved_tensors
            dx, dscale = rmsnorm_split_bwd(x, scale, dy, total, ctx.split, ctx.eps)
        return dx, dscale, None, None, None
