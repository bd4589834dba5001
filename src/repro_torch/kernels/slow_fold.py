"""The slow-path z fold: the wrapper of ``csrc/slow_fold.cu``.

Port of the XLA jit kernel ``repro.core.jaxsim.kernels.slow_fold_kernel``
(and its vmapped batch). On CUDA tensors ``slow_fold`` launches the kernel
(or raises, never falling back); on CPU tensors it computes the plain version
``detect_ref.slow_fold_kernel``. ``launches`` counts the calls
that launched.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import detect_ref as plain
from repro_torch.kernels.checks import require, stream_of

launches = 0

_fn = None
_P, _I, _D = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("slow_fold").slow_fold
        fn.argtypes = [_P, _I] + [_P] * 6 + [_I, _I, _D, _D, _I, _I] + [_P] * 14
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def slow_fold(gkey, dmed, wmed, center_d, scale_d, center_w, scale_w,
              mad_threshold: float, row_col_fraction: float, min_observations: int, *,
              n: int) -> Dict[str, torch.Tensor]:
    """gkey (int64): (B|1, G); medians, centers and scales (B, G) float64.
    Returns zd, zw, point (B, G) and row/col sel, score, hot, obs and wait
    sel, score (B, n)."""
    global launches
    if not isinstance(dmed, torch.Tensor) or dmed.dtype != torch.float64 or dmed.dim() != 2:
        raise TypeError("dmed must be a float64 tensor (B, G)")
    dev = dmed.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    b, g = dmed.shape
    for name, x in (("dmed", dmed), ("wmed", wmed), ("center_d", center_d),
                    ("scale_d", scale_d), ("center_w", center_w), ("scale_w", scale_w)):
        require(name, x, torch.float64, 2, dev)
        if x.shape != (b, g):
            raise ValueError(f"{name} {tuple(x.shape)}, expected {(b, g)}")
    require("gkey", gkey, torch.int64, 2, dev)
    if gkey.shape[1] != g or gkey.shape[0] not in (1, b):
        raise ValueError(f"gkey {tuple(gkey.shape)} for medians {(b, g)}")
    if n <= 0 or b == 0:
        raise ValueError(f"n={n}, {b} windows")
    if dev.type == "cpu":
        return plain.slow_fold_kernel(gkey, dmed, wmed, center_d, scale_d, center_w, scale_w,
                                      mad_threshold, row_col_fraction, min_observations, n=n)
    groups = lambda dt: torch.empty((b, g), dtype=dt, device=dev)    # noqa: E731
    ranks = lambda dt: torch.empty((b, n), dtype=dt, device=dev)     # noqa: E731
    out = dict(zd=groups(torch.float64), zw=groups(torch.float64), point=groups(torch.bool),
               row_sel=ranks(torch.bool), row_score=ranks(torch.float64),
               row_hot=ranks(torch.int64), row_obs=ranks(torch.int64),
               col_sel=ranks(torch.bool), col_score=ranks(torch.float64),
               col_hot=ranks(torch.int64), col_obs=ranks(torch.int64),
               wait_sel=ranks(torch.bool), wait_score=ranks(torch.float64))
    with torch.cuda.device(dev):
        err = _kernel()(
            gkey.data_ptr(), 0 if gkey.shape[0] == 1 else g,
            dmed.data_ptr(), wmed.data_ptr(), center_d.data_ptr(), scale_d.data_ptr(),
            center_w.data_ptr(), scale_w.data_ptr(), b, g, float(mad_threshold),
            float(row_col_fraction), int(min_observations), n,
            *(out[k].data_ptr() for k in ("zd", "zw", "point", "row_sel", "row_score",
                                          "row_hot", "row_obs", "col_sel", "col_score",
                                          "col_hot", "col_obs", "wait_sel", "wait_score")),
            stream_of(dmed))
    if err != 0:
        raise RuntimeError(f"slow_fold launch failed: CUDA error {err}")
    launches += 1
    return out
