"""Dispatch for the kernels: flash attention, decode attention, RMSNorm.

``use_kernel=True`` goes through the kernel wrappers, which launch the CUDA
kernel for a CUDA tensor and compute the plain version for a CPU tensor;
``use_kernel=False`` computes the plain version on any device: the
query-chunked attention (as the JAX package's CPU lowering does), the dense
``ref.decode_attention`` and ``ref.rmsnorm``. There is no fallback for
awkward shapes: the kernels mask a ragged S themselves. Port of
``repro.kernels.ops``.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rmsnorm
from repro_torch.kernels.rmsnorm import Split  # noqa: F401  (ops.rmsnorm's split)


def flash_attention(q, k, v, *, window=None, logit_cap: float = 0.0,
                    scale: float, use_kernel: bool = True, q_offset: int = 0):
    """Causal GQA attention. q: (B,Sq,H,D) at global positions ``q_offset``
    on; k,v: (B,Sk,Hkv,D), Sk >= q_offset + Sq."""
    if use_kernel:
        return _flash.flash_attention_fwd(q, k, v, window=window, logit_cap=logit_cap,
                                          scale=scale, q_offset=q_offset)
    from repro_torch.models.attention import chunked_causal_attention
    return chunked_causal_attention(q, k, v, window=window, logit_cap=logit_cap,
                                    scale=scale, q_offset=q_offset)


def decode_attention(q, k_cache, v_cache, pos: int, *, window=None,
                     logit_cap: float = 0.0, scale: float, use_kernel: bool = True,
                     k0: int = 0, return_lse: bool = False):
    """One-token decode against a KV cache. q: (B,1,H,D). With
    ``return_lse``, the cache is the shard at global positions ``k0`` on and
    the result is (out, lse) (``decode_attention.decode_attention_fwd``)."""
    if use_kernel:
        return _decode.decode_attention_fwd(q, k_cache, v_cache, pos, window=window,
                                            logit_cap=logit_cap, scale=scale, k0=k0,
                                            return_lse=return_lse)
    if return_lse:
        return ref.decode_attention_shard(q, k_cache, v_cache, pos, k0=k0, window=window,
                                          logit_cap=logit_cap, scale=scale)
    return ref.decode_attention(q, k_cache, v_cache, pos, window=window,
                                logit_cap=logit_cap, scale=scale)


def rmsnorm(x, scale, eps: float = 1e-6, use_kernel: bool = True, split=None):
    """Gemma-style RMSNorm over the last axis; differentiable either way.
    The kernel goes through ``RMSNormFn`` only when a backward can be taken
    (grad enabled and an input that requires it); otherwise, as in serving,
    ``rmsnorm_fwd`` is called directly, without the autograd node. Without
    ``use_kernel`` the gradient is autograd's over ``ref.rmsnorm``, a
    backward of its own that the kernel path's is held to; on the meta
    device (the dry run's trace) it goes through ``RMSNormFn`` with the
    plain forward, so the trace saves and computes what the kernel path does
    on the card. With ``split`` (an ``rmsnorm.Split``), ``x`` holds this
    rank's columns of each row and ``scale`` their scale: the split mode
    (its two launches, or their plain halves without ``use_kernel``), always
    through ``RMSNormFn`` for a backward."""
    backward = torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad)
    if backward and (use_kernel or split is not None or x.is_meta):
        return _rmsnorm.RMSNormFn.apply(x, scale, eps, split, use_kernel)
    if split is not None:
        return _rmsnorm.rmsnorm_split_fwd(x, scale, eps, split, use_kernel)[0]
    return _rmsnorm.rmsnorm_fwd(x, scale, eps) if use_kernel else ref.rmsnorm(x, scale, eps)


def launch_counts() -> Dict[str, int]:
    """CUDA kernel launches since the last reset, by kernel."""
    return {"flash_attention": _flash.launches, "decode_attention": _decode.launches,
            "rmsnorm": _rmsnorm.launches}


def reset_launch_counts() -> None:
    """Every count to 0, the RMSNorm split mode's (``rmsnorm.split_launches``,
    read on its own) included."""
    _flash.launches = 0
    _decode.launches = 0
    _rmsnorm.launches = 0
    _rmsnorm.split_launches = 0
