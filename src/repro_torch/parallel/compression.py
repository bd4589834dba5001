"""Gradient compression for the slow (cross-pod) axis.

Port of ``repro.parallel.compression``:

  * ``quantize_int8`` / ``dequantize_int8``: symmetric per-tensor int8 with
    the JAX package's arithmetic (``amax`` in fp32, ``scale = max(amax / 127,
    1e-12)``, ``round(x / scale)`` half to even as ``jnp.round``, clip to
    +-127; the scale divides, it is never inverted and multiplied);
  * ``ring_allreduce_int8``: a ring reduce-scatter then all-gather over a
    process group, every hop one int8 chunk and its fp32 scale to rank + 1,
    accumulation in fp32 with a requantisation a hop;
  * ``ErrorFeedback``: the residual of the lossy stage, added back next step.

Gradients are flat ``{name: tensor}`` dicts, as the optimizer takes them.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

Tree = Dict[str, torch.Tensor]


def quantize_int8(x: torch.Tensor, amax: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (q int8, scale fp32 0-d). ``amax`` is max|x| by default; a
    sharded leaf passes the max over all its shards."""
    if amax is None:
        amax = x.abs().max()
    amax = amax.to(torch.float32)
    # a tensor, not a number: CUDA multiplies by a number's reciprocal, an ulp off
    scale = torch.clamp(amax / amax.new_tensor(127.0), min=1e-12)
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def roundtrip_int8(x: torch.Tensor, amax: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dequantize(quantize(x)) in x's dtype: the train step's lossy stage."""
    return dequantize_int8(*quantize_int8(x, amax)).to(x.dtype)


def _exchange(send: Tuple[torch.Tensor, ...], recv: Tuple[torch.Tensor, ...],
              to_rank: int, from_rank: int, group) -> None:
    """Send ``send`` to ``to_rank`` while receiving ``recv`` from
    ``from_rank`` (global ranks), posted together so that no ring of any size
    waits on itself."""
    import torch.distributed as dist
    ops = [dist.P2POp(dist.isend, t, to_rank, group) for t in send]
    ops += [dist.P2POp(dist.irecv, t, from_rank, group) for t in recv]
    for req in dist.batch_isend_irecv(ops):
        req.wait()


def ring_allreduce_int8(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``group`` (default: the world), by an
    int8 ring: the flat fp32 view padded to a multiple of n and cut into n
    chunks, n - 1 reduce-scatter hops and n - 1 all-gather hops, each sending
    the chunk's int8 payload and its scale to rank + 1. The chunk a rank
    completes keeps its fp32 sum; the others arrive requantised, so ranks
    may differ by a quantisation step, as in the JAX package. n = 1 returns
    ``x`` unchanged."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    if n == 1:
        return x
    idx = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (idx + 1) % n) if group is not None else (idx + 1) % n
    prv = dist.get_global_rank(group, (idx - 1) % n) if group is not None else (idx - 1) % n
    flat = x.to(torch.float32).reshape(-1)
    pad = (-flat.shape[0]) % n
    chunks = torch.nn.functional.pad(flat, (0, pad)).reshape(n, -1).clone()
    q_in = torch.empty(chunks.shape[1], dtype=torch.int8, device=x.device)
    s_in = torch.empty((), dtype=torch.float32, device=x.device)

    def hop(send_idx: int):
        q, s = quantize_int8(chunks[send_idx])
        _exchange((q, s), (q_in, s_in), nxt, prv, group)
        return dequantize_int8(q_in, s_in)

    # reduce-scatter: after n - 1 hops chunk (idx + 1) % n holds the full sum
    for k in range(n - 1):
        got = hop((idx - k) % n)
        chunks[(idx - k - 1) % n] += got
    # all-gather: each hop forwards the chunk completed most recently
    for k in range(n - 1):
        got = hop((idx + 1 - k) % n)
        chunks[(idx - k) % n] = got
    out = chunks.reshape(-1)
    if pad:
        out = out[:-pad]
    return out.reshape(x.shape).to(x.dtype)


class ErrorFeedback:
    """Residual error feedback for lossy gradient compression."""

    @staticmethod
    def init(grads: Tree) -> Tree:
        return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                for k, g in grads.items()}

    @staticmethod
    def apply(grads: Tree, residual: Tree, compress_fn: Callable[[str, torch.Tensor], torch.Tensor]
              ) -> Tuple[Tree, Tree]:
        """g' = compress(g + r); r' = (g + r) - g'. Returns (g', r'), both
        fp32 whatever the gradients' dtype; ``compress_fn(name, x)``. To keep
        one gradient tree and one residual tree on the device (the residual
        is 4 bytes a parameter), it pops each leaf of ``grads`` as it goes and
        computes r' in ``residual``'s own tensors: both dicts are consumed.
        The arithmetic is the JAX package's: (g + r) in fp32, then the
        difference."""
        compressed = {}
        for k in list(grads):
            r = residual[k]
            r.add_(grads.pop(k))                # r + g: the corrected gradient
            compressed[k] = compress_fn(k, r)
            r.sub_(compressed[k].to(torch.float32))
        return compressed, residual
