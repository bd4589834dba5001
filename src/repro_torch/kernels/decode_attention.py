"""One-token decode attention against a KV cache: the CUDA kernel's wrapper.

Port of ``repro.kernels.decode_attention.decode_attention_fwd``; the kernel is
``csrc/decode_attention.cu``: for bf16 with a head_dim of ``TMA_HEAD_DIMS``
(64, 112, 128, 160, 256; ``tma_path``) one launch of ``decode_tma_kernel``
(the key range split across the card, the splits merged by the last CTA of
each (batch, kv head)), otherwise split-K and a combine pass on the CUDA
cores (a head_dim above 256 in passes of 256 output columns). A group above
``MAX_GROUP`` query heads a kv head is launched in passes
(``flash_attention.group_passes``). On a CUDA tensor the wrapper launches the
kernel (or raises); on a CPU tensor it computes the plain version
``ref.decode_attention``. ``pos`` and ``window`` are host ints:
the serve loop knows them, so no device-to-host sync is needed. The split
partials and the per-(batch, kv head) counters are scratch kept per (device,
stream), grown when a larger shape arrives; the counters are zeroed once when
allocated and every launch leaves them zero. A call allocates only its
output. ``launches`` counts the kernel calls (one per call or group pass,
whatever the kernel's launch count).

Shard mode (``return_lse=True``): the cache is a shard of a longer one, its
keys at global positions ``k0`` .. ``k0 + S - 1``, masked by their global
positions; the call returns (out, lse), both float32 whatever the inputs'
dtype (the merge rounds once): out normalised over the shard's valid keys,
lse the log-sum-exp (B, H) of each query head's valid scores, or
``ref.NEG_INF`` with out 0 where the shard holds no valid key; one launch, or
a group above ``MAX_GROUP`` in passes (``shard_passes``), each writing its
heads' columns of out and lse. ``ref.merge_shards`` (or an all-reduce of the
same sums across ranks) merges the shards into the whole cache's output. Its
plain version is ``ref.decode_attention_shard``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.flash_attention import (DTYPE_CODES, MAX_GROUP, _window,
                                                 check_attention_inputs, group_passes,
                                                 pass_group)

launches = 0
# bf16 head_dims ``csrc/decode_attention.cu`` runs ``decode_tma_kernel`` for
TMA_HEAD_DIMS = (64, 112, 128, 160, 256)

_lib = None
# (device index, stream) -> (float32 partials, int32 counters)
_scratch: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("decode_attention")
        lib.decode_attention_shard_fwd.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        lib.decode_attention_shard_fwd.restype = ctypes.c_int
        lib.decode_attention_scratch_floats.argtypes = [ctypes.c_int] * 6
        lib.decode_attention_scratch_floats.restype = ctypes.c_longlong
        _lib = lib
    return _lib


def tma_path(dtype, d: int, group: int) -> bool:
    """Whether one launch of ``dtype`` at head_dim ``d`` with ``group`` query
    heads a kv head (a pass of ``group_passes``) runs ``decode_tma_kernel``;
    otherwise ``decode_partial_kernel`` and ``decode_combine_kernel``."""
    return dtype == torch.bfloat16 and d in TMA_HEAD_DIMS and group <= MAX_GROUP


def _scratch_for(device: torch.device, stream: int, floats: int, counters: int):
    key = (device.index, stream)
    part, cnt = _scratch.get(key, (None, None))
    if part is None or part.numel() < floats or cnt.numel() < counters:
        part = torch.empty(max(floats, 0 if part is None else part.numel()),
                           dtype=torch.float32, device=device)
        cnt = torch.zeros(max(counters, 0 if cnt is None else cnt.numel()),
                          dtype=torch.int32, device=device)
        _scratch[key] = (part, cnt)
    return part, cnt


def decode_attention_fwd(q, k_cache, v_cache, pos: int, *, window=None,
                         logit_cap: float = 0.0, scale: float, k0: int = 0,
                         return_lse: bool = False):
    """q: (B,1,H,D); caches: (B,S,Hkv,D); ``pos`` the current token's index
    (keys past it are masked) -> (B,1,H,D). Any cache length S. With
    ``return_lse``, the caches are the shard at global positions ``k0`` ..
    ``k0 + S - 1`` (any ``pos`` >= 0) and the call returns (out (B,1,H,D),
    lse (B,H)), both float32."""
    check_attention_inputs(q, k_cache, v_cache, query_len=1)
    d, s = q.shape[3], k_cache.shape[1]
    pos, k0 = int(pos), int(k0)
    if not return_lse and k0:
        raise ValueError("a shard's output (k0 > 0) is only of use with its lse: pass "
                         "return_lse=True")
    if pos < 0 or k0 < 0 or (not return_lse and pos >= s):
        raise ValueError(f"pos {pos} outside the cache of length {s}")
    w = _window(window)
    if q.device.type == "cpu":
        if return_lse:
            return ref.decode_attention_shard(q, k_cache, v_cache, pos, k0=k0, window=w,
                                              logit_cap=logit_cap, scale=scale)
        return ref.decode_attention(q, k_cache, v_cache, pos, window=w,
                                    logit_cap=logit_cap, scale=scale)
    if d % (16 // q.element_size()):
        raise ValueError(f"head_dim {d}: the CUDA kernel reads rows in 16-byte pieces")

    if not return_lse:
        return group_passes(lambda qp, kp, vp: _launch(qp, kp, vp, pos, 0, w, scale, logit_cap,
                                                       False), q, k_cache, v_cache)
    return shard_passes(lambda qp: _launch(qp, k_cache, v_cache, pos, k0, w, scale, logit_cap,
                                           True), q, k_cache.shape[2])


def shard_passes(run, q, n_kv: int):
    """``run(q_pass)`` -> (out, lse) of the shard mode over passes of at most
    ``MAX_GROUP`` query heads of each of the ``n_kv`` kv heads, as
    ``group_passes`` cuts them (heads c0..c0+gc-1 of each group), each
    pass's float32 out and lse written into its heads' columns. One pass
    when the group fits."""
    b, _, h, d = q.shape
    group = h // n_kv
    if group <= MAX_GROUP:
        return run(q)
    step = pass_group(group)
    qg = q.view(b, 1, n_kv, group, d)
    out = torch.empty(b, 1, n_kv, group, d, dtype=torch.float32, device=q.device)
    lse = torch.empty(b, n_kv, group, dtype=torch.float32, device=q.device)
    for c0 in range(0, group, step):
        gc = min(step, group - c0)
        o, l = run(qg[:, :, :, c0:c0 + gc].contiguous().view(b, 1, n_kv * gc, d))
        out[:, :, :, c0:c0 + gc] = o.view(b, 1, n_kv, gc, d)
        lse[:, :, c0:c0 + gc] = l.view(b, n_kv, gc)
    return out.view(b, 1, h, d), lse.view(b, h)


def _launch(q, k_cache, v_cache, pos: int, k0: int, w: int, scale: float, logit_cap: float,
            return_lse: bool):
    global launches
    b, _, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    lib = _kernel()
    dtype = DTYPE_CODES[q.dtype]
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device) if return_lse else \
        torch.empty_like(q)
    lse = torch.empty(b, h, dtype=torch.float32, device=q.device) if return_lse else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        floats = lib.decode_attention_scratch_floats(b, s, h, hkv, d, dtype)
        if floats < 0:
            raise RuntimeError("decode_attention_fwd: no CUDA device to size the scratch for")
        part, cnt = _scratch_for(q.device, stream, floats, b * hkv)
        err = lib.decode_attention_shard_fwd(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), part.data_ptr(), cnt.data_ptr(),
            b, s, h, hkv, d, pos, k0, w, float(scale), float(logit_cap or 0.0), dtype, stream)
    if err != 0:
        raise RuntimeError(f"decode_attention_fwd launch failed: CUDA error {err}")
    launches += 1
    return (out, lse) if return_lse else out
