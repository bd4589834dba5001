"""Hierarchical, topology-aware gradient reduction.

Port of ``repro.parallel.collectives``. An all-reduce over (pod, data) is
decomposed as

    reduce-scatter over ``data`` (fast)  ->  all-reduce over ``pod`` (slow,
    1/|data| of the bytes, optionally the int8 ring)  ->  all-gather over
    ``data`` (fast),

so the scarce cross-pod fabric carries only one shard of every leaf. Each
step is a collective over the ``DeviceMesh``'s process group of that axis.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.parallel.compression import ring_allreduce_int8


def _hier_allreduce_local(x: torch.Tensor, fast, slow, compress_slow: bool) -> torch.Tensor:
    import torch.distributed as dist
    n_fast = dist.get_world_size(fast)
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % n_fast
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    # 1) reduce-scatter over the fast axis: fast-rank j owns chunk j
    shard = flat.new_empty(flat.shape[0] // n_fast)
    dist.reduce_scatter_tensor(shard, flat.contiguous(), group=fast)
    # 2) all-reduce the owned shard over the slow axis (1/n_fast of the bytes)
    if compress_slow:
        shard = ring_allreduce_int8(shard, slow)
    else:
        dist.all_reduce(shard, group=slow)
    # 3) all-gather over the fast axis
    full = flat.new_empty(flat.shape[0])
    dist.all_gather_into_tensor(full, shard, group=fast)
    if pad:
        full = full[:-pad]
    return full.reshape(x.shape)


def hierarchical_allreduce(tree: Dict[str, torch.Tensor], mesh, fast_axis: str = "data",
                           slow_axis: str = "pod", compress_slow: bool = False
                           ) -> Dict[str, torch.Tensor]:
    """Sum each leaf of ``tree`` (this rank's values) over fast_axis x
    slow_axis of ``mesh``, as ``psum`` sums it; other axes are left alone.
    Without ``slow_axis`` in the mesh, a plain all-reduce over the fast
    axis."""
    import torch.distributed as dist
    fast = mesh.get_group(fast_axis)
    if slow_axis not in mesh.mesh_dim_names:
        out = {}
        for k, x in tree.items():
            out[k] = x.clone()
            dist.all_reduce(out[k], group=fast)
        return out
    slow = mesh.get_group(slow_axis)
    return {k: _hier_allreduce_local(x, fast, slow, compress_slow) for k, x in tree.items()}
