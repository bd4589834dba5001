"""The slow-path z fold: the wrapper of ``csrc/slow_fold.cu``.

Port of the XLA jit kernel ``repro.core.jaxsim.kernels.slow_fold_kernel``
(and its vmapped batch). On CUDA tensors ``slow_fold`` launches the kernel
(or raises, never falling back); on CPU tensors it computes the plain version
``detect_ref.slow_fold_kernel``. ``launches`` counts the calls
that launched (one launch each).
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import detect_ref as plain
from repro_torch.kernels.checks import launch_on, require, stream_of

launches = 0

_fn = None
_P, _I, _D = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
_INPUTS = ("wmed", "center_d", "scale_d", "center_w", "scale_w")


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("slow_fold").slow_fold
        fn.argtypes = [_P, _I] + [_P] * 6 + [_I, _I, _D, _D, _I, _I] + [_P] * 6
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _outputs(b: int, g: int, n: int, dev):
    """The 13 outputs in the five buffers the kernel writes (its arrays of
    one dtype and length one after another): unbind gives each array as a
    contiguous view, one operation a buffer, fewer than 13 allocations."""
    z = torch.empty((2, b, g), dtype=torch.float64, device=dev)
    scores = torch.empty((3, b, n), dtype=torch.float64, device=dev)
    counts = torch.empty((4, b, n), dtype=torch.int64, device=dev)
    point = torch.empty((b, g), dtype=torch.bool, device=dev)
    sels = torch.empty((3, b, n), dtype=torch.bool, device=dev)
    out = dict(zip(("zd", "zw"), z.unbind(0)))
    out.update(zip(("row_score", "col_score", "wait_score"), scores.unbind(0)))
    out.update(zip(("row_hot", "row_obs", "col_hot", "col_obs"), counts.unbind(0)))
    out["point"] = point
    out.update(zip(("row_sel", "col_sel", "wait_sel"), sels.unbind(0)))
    return (z, scores, counts, point, sels), out


def _check(gkey, dmed, others, n: int):
    """The inputs' rules, checked in order (a message is built only for a
    failure); returns dmed's device and (B, G)."""
    if not isinstance(dmed, torch.Tensor) or dmed.dtype != torch.float64 or dmed.dim() != 2:
        raise TypeError("dmed must be a float64 tensor (B, G)")
    dev, shape = dmed.device, dmed.shape
    for name, x in (("dmed", dmed), *zip(_INPUTS, others)):
        require(name, x, torch.float64, 2, dev)
        if x.shape != shape:
            raise ValueError(f"{name} {tuple(x.shape)}, expected {tuple(shape)}")
    require("gkey", gkey, torch.int64, 2, dev)
    if gkey.shape[1] != shape[1] or gkey.shape[0] not in (1, shape[0]):
        raise ValueError(f"gkey {tuple(gkey.shape)} for medians {tuple(shape)}")
    if n <= 0 or shape[0] == 0:
        raise ValueError(f"n={n}, {shape[0]} windows")
    return dev, shape


def slow_fold(gkey, dmed, wmed, center_d, scale_d, center_w, scale_w,
              mad_threshold: float, row_col_fraction: float, min_observations: int, *,
              n: int) -> Dict[str, torch.Tensor]:
    """gkey (int64): (B|1, G); medians, centers and scales (B, G) float64.
    Returns zd, zw, point (B, G) and row/col sel, score, hot, obs and wait
    sel, score (B, n); on the card, views into five buffers (``_outputs``)."""
    global launches
    others = (wmed, center_d, scale_d, center_w, scale_w)
    dev, shape = _check(gkey, dmed, others, n)
    if dev.type != "cuda":
        if dev.type == "cpu":
            return plain.slow_fold_kernel(gkey, dmed, *others, mad_threshold,
                                          row_col_fraction, min_observations, n=n)
        raise ValueError(f"unsupported device {dev}")
    b, g = shape
    bufs, out = _outputs(b, g, n, dev)
    err = launch_on(dmed, _fn or _kernel(), gkey.data_ptr(), 0 if gkey.shape[0] == 1 else g,
                    dmed.data_ptr(), *(x.data_ptr() for x in others), b, g,
                    float(mad_threshold), float(row_col_fraction), int(min_observations), n,
                    *(t.data_ptr() for t in bufs), stream_of(dmed))
    if err != 0:
        raise RuntimeError(f"slow_fold launch failed: CUDA error {err}")
    launches += 1
    return out
