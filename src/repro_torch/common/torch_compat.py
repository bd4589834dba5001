"""Version gate for torch and the card: the port's counterpart of
``repro.common.jax_compat``.

``check_supported`` holds the installed torch to ``MIN_TORCH``, the first
release with every torch API the port calls. Unlike the JAX package's gate,
which refuses every jax from ``MAX_JAX_EXCLUSIVE`` on, a torch newer than
``NEWEST_TESTED`` is only warned about, once: a hard upper bound refuses a
release before anyone has seen it fail, and the JAX package's own bound is
why its test files fail at import on jax 0.9.

``check_device`` refuses a card that the kernels cannot run on before
anything is compiled for it: they are built for ``sm_90a`` (``wgmma``, TMA,
``setmaxnreg``), which only a compute capability 9.0 part runs, and by a CUDA
12 toolkit. The decision is ``device_error``, a pure function of the
capability and ``torch.version.cuda``, so a test on the CPU reaches both of
its branches.

The JAX package's shims for ``shard_map``, ``set_mesh``/``get_abstract_mesh``,
``make_mesh``'s axis types, Pallas' ``tpu_compiler_params``,
``resolve_interpret``, ``cost_analysis_dict``, ``axis_size`` and the tree and
dtype helpers have no counterpart here: the port has no JAX mesh, no Pallas
kernel and no XLA executable, and ``torch.utils._pytree`` is not needed where
the trees are plain dicts. Nor have its ``Features`` record and ``_select_*``
helpers: with one path for every torch release there is nothing to select.
"""
from __future__ import annotations

import re
import warnings
from typing import Optional, Tuple

import torch

# the public torch.distributed.tensor (DTensor with Shard, Replicate and
# Partial), which parallel/sharding.py and the sharded train step import;
# before 2.5 it was the private torch.distributed._tensor
MIN_TORCH: Tuple[int, ...] = (2, 5)
# the newest release the tier-1 tests have run on; a newer one is warned about
NEWEST_TESTED: Tuple[int, ...] = (2, 13)
# sm_90a code runs on compute capability 9.0 only (the 'a' features are not
# carried forward); wgmma and TMA need a CUDA 12 toolkit
DEVICE_CAPABILITY: Tuple[int, int] = (9, 0)
MIN_CUDA: Tuple[int, ...] = (12, 0)

_WARNED: set = set()


class TorchCompatError(RuntimeError):
    """Raised when the installed torch or the card is outside what the port
    supports."""


def parse_version(version: str) -> Tuple[int, ...]:
    """'2.11.0+cu128', '2.12.0a0+git3f1e', '2.6.0.dev20250101' -> the
    leading numeric tuple (the JAX package's rule)."""
    parts = []
    for piece in version.split("."):
        m = re.match(r"\d+", piece)
        if m is None:
            break
        parts.append(int(m.group()))
    if not parts:
        raise TorchCompatError(f"cannot parse torch version {version!r}")
    return tuple(parts)


def check_supported(version: Optional[str] = None) -> Tuple[int, ...]:
    """Validate ``version`` (default: the installed torch): raises below
    ``MIN_TORCH``; above ``NEWEST_TESTED`` warns once per version and
    returns."""
    version = torch.__version__ if version is None else version
    v = parse_version(version)
    lo = ".".join(map(str, MIN_TORCH))
    if v < MIN_TORCH:
        raise TorchCompatError(
            f"detected torch {version}, but repro_torch needs torch >= {lo} "
            "(torch.distributed.tensor's public DTensor API)")
    if v[:len(NEWEST_TESTED)] > NEWEST_TESTED and version not in _WARNED:
        _WARNED.add(version)
        hi = ".".join(map(str, NEWEST_TESTED))
        warnings.warn(f"torch {version} is newer than the newest release repro_torch was "
                      f"tested on ({hi}); run the tier-1 tests on it", stacklevel=2)
    return v


def device_error(capability: Tuple[int, int], cuda: Optional[str]) -> Optional[str]:
    """Why the kernels cannot run on a card of ``capability`` under a torch
    built for CUDA ``cuda`` (``torch.version.cuda``, None for a CPU build),
    or None when they can."""
    if cuda is None:
        return "this torch is built without CUDA (torch.version.cuda is None)"
    if parse_version(cuda) < MIN_CUDA:
        return (f"torch is built for CUDA {cuda}; the kernels need CUDA >= "
                f"{'.'.join(map(str, MIN_CUDA))} (wgmma and TMA on sm_90a)")
    if tuple(capability) != DEVICE_CAPABILITY:
        return (f"the card has compute capability {tuple(capability)}; the kernels are "
                f"built for sm_90a, which runs on capability {DEVICE_CAPABILITY} (Hopper) only")
    return None


def check_device(index: int = 0) -> Tuple[int, int]:
    """Raise ``TorchCompatError`` unless CUDA device ``index`` can run the
    port's kernels (``device_error``). Returns its compute capability."""
    capability = tuple(torch.cuda.get_device_capability(index))
    err = device_error(capability, torch.version.cuda)
    if err is not None:
        raise TorchCompatError(f"CUDA device {index}: {err}")
    return capability
