"""Device meshes over ``torch.distributed``.

Port of ``repro.launch.mesh``. A mesh is a ``DeviceMesh`` with dims
``("data", "model")`` or ``("pod", "data", "model")``, one process a device:
NCCL on ``cuda``, gloo on ``cpu``. The process group comes from the caller
(``init_process_group``) or from ``torchrun``'s environment; nothing is
started at import.

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch gemma2-2b \
        --smoke --device cpu --data 2 --model 2

The hardware constants at the end are one H100 SXM's, the roofline's targets
(``launch/roofline.py``) and the bounds ``chip_smoke.py`` holds the kernels
to. The production meshes keep the JAX package's shapes, so that the dry
run's cells compare one for one with its own; their 16-wide ``model`` axis
spans two 8-GPU hosts, so every collective crosses the network and NVLink
does not enter the collective term.
"""
from __future__ import annotations

import math
import os

import torch

from repro_torch import resolve_device


def backend_for(device) -> str:
    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def ensure_process_group(device=None) -> None:
    """Start the default process group from ``torchrun``'s environment
    (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) unless one
    is running; on ``cuda`` each process takes the device of its
    ``LOCAL_RANK``."""
    import torch.distributed as dist
    if dist.is_initialized():
        return
    if "WORLD_SIZE" not in os.environ:
        raise RuntimeError("a mesh needs a process group: call init_process_group, or run "
                           "under torchrun --nproc-per-node N")
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend_for(dev), init_method="env://")


def make_local_mesh(data: int = 1, model: int = 1, pod: int = 0, device=None):
    """A (data, model) or (pod, data, model) mesh over every rank of the
    process group, whose world size must be pod * data * model."""
    from torch.distributed.device_mesh import init_device_mesh
    import torch.distributed as dist
    ensure_process_group(device)
    shape = (pod, data, model) if pod else (data, model)
    names = ("pod", "data", "model") if pod else ("data", "model")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"a {dict(zip(names, shape))} mesh needs {math.prod(shape)} ranks; "
                         f"the process group has {world}")
    return init_device_mesh(resolve_device(device).type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16 x 16 = 256 devices a pod; 2 pods = 512 devices multi-pod."""
    if multi_pod:
        return make_local_mesh(16, 16, pod=2, device=device)
    return make_local_mesh(16, 16, device=device)


def rebuild(mesh):
    """A new mesh of ``mesh``'s shape and names over the same ranks (an
    elastic restart rebuilds its groups over the healthy host set)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(mesh.device_type, tuple(mesh.mesh.shape),
                            mesh_dim_names=mesh.mesh_dim_names)


# One H100 SXM (NVIDIA data sheet, dense rates, at the full 700 W)
PEAK_FLOPS_BF16 = 989e12          # FLOP/s, bf16 on the tensor cores
PEAK_FLOPS_FP32 = 67e12           # FLOP/s, fp32 on the CUDA cores
HBM_BW = 3.35e12                  # bytes/s, HBM3
HBM_BYTES = 80e9                  # bytes of HBM a GPU
# bytes/s a GPU on the network: one NIC a GPU, two 200 Gbps ports bonded (the
# paper's testbed, core/topology.py: nics_per_host 8, port_gbps 200)
NET_BW = 50e9
