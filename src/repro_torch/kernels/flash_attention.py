"""Causal GQA flash attention (forward): the CUDA kernel's wrapper.

Port of ``repro.kernels.flash_attention.flash_attention_fwd``; the kernel is
``csrc/flash_attention.cu``. On a CUDA tensor the wrapper launches the kernel
(or raises); on a CPU tensor it computes the plain version
``ref.flash_attention``. ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

launches = 0
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# query heads per kv head in one launch: the bf16 kernel's Q box holds
# 128 // group positions of the whole group; the decode kernel keeps a group
# in a block. A larger group runs in passes (``group_passes``).
MAX_GROUP = 8
# bf16 head_dims ``csrc/flash_attention.cu`` instantiates its tensor-core
# kernel for (a multiple of 16 in 64..256 builds; these are the configs')
WGMMA_HEAD_DIMS = (64, 112, 128, 160, 256)

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("flash_attention").flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def wgmma_path(dtype, d: int, group: int) -> bool:
    """Whether one launch of ``dtype`` at head_dim ``d`` with ``group`` query
    heads a kv head (a pass of ``group_passes``) runs ``flash_wgmma_kernel``
    on the tensor cores; otherwise ``flash_fwd_kernel`` on the CUDA cores."""
    return dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS and group <= MAX_GROUP


def pass_group(group: int) -> int:
    """The query heads a kv head of the widest pass ``group_passes`` makes."""
    return -(-group // -(-group // MAX_GROUP))


def check_attention_inputs(q, k, v, *, query_len=None):
    """Raise on anything the CUDA kernels do not take."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.dim() != 4:
            raise ValueError(f"{name} must be a 4-d tensor")
        if t.dtype not in DTYPE_CODES:
            raise TypeError(f"{name} has dtype {t.dtype}; supported: float32, bfloat16")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"devices differ: {q.device}, {k.device}, {v.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    b, s, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if query_len is not None and s != query_len:
        raise ValueError(f"q has {s} positions, expected {query_len}")
    hkv = k.shape[2]
    if h % hkv != 0:
        raise ValueError(f"{h} query heads do not group onto {hkv} kv heads")
    if d <= 0:
        raise ValueError(f"head_dim {d} must be positive")
    # TMA takes a global base address on a 16-byte boundary and row strides
    # in multiples of 16 bytes; contiguous bf16 rows of the ``WGMMA_HEAD_DIMS``
    # (D*2, H*D*2 and Hkv*D*2 bytes) always are, so the base is what can fail
    if q.device.type == "cuda" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("CUDA inputs must start on a 16-byte boundary")


def _window(window) -> int:
    w = int(window or 0)
    if w < 0:
        raise ValueError(f"window must be >= 0, got {w}")
    return w


def group_passes(run, q, k, v) -> torch.Tensor:
    """``run(q_pass, k, v)`` over passes of at most ``MAX_GROUP`` query heads
    of every kv head, the outputs written back into their columns: query
    head h belongs to kv head h // group, so a pass takes heads c0..c0+gc-1
    of each group, as q viewed (B, S, Hkv, group, D). One pass when the
    group fits."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    group = h // hkv
    if group <= MAX_GROUP:
        return run(q, k, v)
    step = pass_group(group)
    qg = q.view(b, s, hkv, group, d)
    out = q.new_empty(b, s, hkv, group, d)
    for c0 in range(0, group, step):
        gc = min(step, group - c0)
        part = run(qg[:, :, :, c0:c0 + gc].contiguous().view(b, s, hkv * gc, d), k, v)
        out[:, :, :, c0:c0 + gc] = part.view(b, s, hkv, gc, d)
    return out.view(b, s, h, d)


def flash_attention_fwd(q, k, v, *, window=None, logit_cap: float = 0.0,
                        scale: float, q_offset: int = 0) -> torch.Tensor:
    """q: (B,Sq,H,D); k,v: (B,Sk,Hkv,D) -> (B,Sq,H,D). ``window`` 0/None =
    full causal. Any Sq: the kernel masks the ragged edge itself.
    ``q_offset``: the global position of q's first row (a rank's shard of
    the sequence), masked against every key at positions 0 .. Sk - 1; the
    keys must reach the last query (``q_offset + Sq <= Sk``).

    bf16 with a head_dim of ``WGMMA_HEAD_DIMS`` runs on the tensor cores
    (wgmma fed by TMA; ``wgmma_path``), anything else on the fp32 CUDA cores
    (a head_dim above 256 in passes of 256 output columns). A group above
    ``MAX_GROUP`` is launched in passes (``group_passes``); ``launches``
    counts each."""
    check_attention_inputs(q, k, v)
    q_off = int(q_offset)
    if q_off < 0 or q_off + q.shape[1] > k.shape[1]:
        raise ValueError(f"q_offset {q_off}: q's {q.shape[1]} positions from there must lie "
                         f"within the {k.shape[1]} keys (0 <= q_offset, q_offset + Sq <= Sk)")
    w = _window(window)
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, window=w, logit_cap=logit_cap, scale=scale,
                                   q_offset=q_off)
    return group_passes(lambda qp, kp, vp: _launch(qp, kp, vp, q_off, w, scale, logit_cap),
                        q, k, v)


def _launch(q, k, v, q_off: int, w: int, scale: float, logit_cap: float) -> torch.Tensor:
    global launches
    b, s, h, d = q.shape
    out = torch.empty_like(q)
    fn = _kernel()
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, s, k.shape[1], q_off, h, k.shape[2], d, w, float(scale),
                 float(logit_cap or 0.0), DTYPE_CODES[q.dtype],
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error {err}")
    launches += 1
    return out
