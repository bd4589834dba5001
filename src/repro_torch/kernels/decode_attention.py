"""One-token decode attention against a KV cache: the CUDA kernel's wrapper.

Port of ``repro.kernels.decode_attention.decode_attention_fwd``; the kernel is
``csrc/decode_attention.cu`` (split over the kv axis, then combined). On a
CUDA tensor the wrapper launches the kernel (or raises); on a CPU tensor it
computes the plain version ``ref.decode_attention``. ``pos`` and ``window`` are
host ints: the serve loop knows them, so no device-to-host sync is needed.
``launches`` counts kernel launches (one per call, both passes together).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.flash_attention import DTYPE_CODES, _window, check_attention_inputs

launches = 0

_fn = None
_chunk = 0


def _kernel():
    global _fn, _chunk
    if _fn is None:
        lib = _build.load("decode_attention")
        fn = lib.decode_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _chunk = lib.decode_attention_chunk()
        _fn = fn
    return _fn


def decode_attention_fwd(q, k_cache, v_cache, pos: int, *, window=None,
                         logit_cap: float = 0.0, scale: float) -> torch.Tensor:
    """q: (B,1,H,D); caches: (B,S,Hkv,D); ``pos`` the current token's index
    (keys past it are masked) -> (B,1,H,D). Any cache length S."""
    global launches
    check_attention_inputs(q, k_cache, v_cache, query_len=1)
    b, _, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    pos = int(pos)
    if not 0 <= pos < s:
        raise ValueError(f"pos {pos} outside the cache of length {s}")
    w = _window(window)
    if q.device.type == "cpu":
        return ref.decode_attention(q, k_cache, v_cache, pos, window=w,
                                    logit_cap=logit_cap, scale=scale)
    if d % (16 // q.element_size()):
        raise ValueError(f"head_dim {d}: the CUDA kernel reads rows in 16-byte pieces")
    fn = _kernel()
    nsplit = -(-s // _chunk)
    out = torch.empty_like(q)
    part_m = torch.empty((b * h, nsplit), dtype=torch.float32, device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((b * h, nsplit, d), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
                 part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
                 b, s, h, hkv, d, pos, w, float(scale), float(logit_cap or 0.0),
                 DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention_fwd launch failed: CUDA error {err}")
    launches += 1
    return out
