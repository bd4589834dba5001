"""Build the CUDA kernels with ``nvcc`` and load them through ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own into
``build/<name>-<hash>.so`` next to this file (the directory is git-ignored).
The hash covers the source, the headers of ``csrc/`` it includes (``#include
"..."``, followed into headers that include others) and the flags (those of
``NVCC_FLAGS`` and the kernel's own in ``EXTRA_FLAGS``), so an
edited source or header is rebuilt and an unchanged one is loaded as it is.
``build_all`` starts one ``nvcc`` per source, all at once, and waits for
them. Before the first ``nvcc`` runs it checks that there is one, then the
card and the toolkit (``common.torch_compat.check_device``), so a card that
cannot run ``sm_90a`` code is refused with its reason, not by a failed launch.
Nothing is built at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List

from repro_torch.common import torch_compat

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
KERNELS = ("flash_attention", "decode_attention", "rmsnorm", "window_score", "slow_fold",
           "waterfill", "ewma_scan")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
#: flags added for one kernel. The detection kernels and water-filling are
#: held bit-equal to NumPy, so nvcc may not contract a*b + c into an FMA in
#: them (the EWMA scan is held by a tolerance and may).
EXTRA_FLAGS: Dict[str, List[str]] = {"window_score": ["--fmad=false"],
                                     "slow_fold": ["--fmad=false"],
                                     "waterfill": ["--fmad=false"]}

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _local_includes(path: Path, seen=None) -> list:
    """The headers of ``csrc/`` that ``path`` includes, directly or not, in
    the order first met."""
    seen = [] if seen is None else seen
    for inc in re.findall(r'^\s*#\s*include\s+"([^"]+)"', path.read_text(), re.M):
        header = CSRC / inc
        if header.exists() and header not in seen:
            seen.append(header)
            _local_includes(header, seen)
    return seen


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in _local_includes(src):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(flags(name)).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def flags(name: str) -> list:
    """nvcc's flags for kernel ``name``."""
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, [])


def nvcc_command(source: Path, out: Path, name: str = "") -> list:
    """nvcc with the flags of kernel ``name``; ``csrc/`` on the include path,
    so that a copy of a source elsewhere (an ablation) finds its headers."""
    return [_nvcc(), *flags(name), "-I", str(CSRC), "-o", str(out), str(source)]


def build_log(name: str) -> str:
    """What nvcc and ptxas printed for ``name`` (registers, spills, smem)."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_all(names: Iterable[str] = KERNELS) -> float:
    """Compile every source that is not built yet, in parallel. Returns the
    wall seconds spent; raises with nvcc's output if any build fails, and
    before any build if the current card cannot run the kernels."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pending = [name for name in names if not _target(name).exists()]
    if pending:
        import torch
        _nvcc()
        torch_compat.check_device(torch.cuda.current_device())
    procs = []
    for name in pending:
        out = _target(name)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        procs.append((name, out, tmp, subprocess.Popen(
            nvcc_command(CSRC / f"{name}.cu", tmp, name), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The shared library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        if not _target(name).exists():
            build_all([name])
        lib = _LIBS[name] = ctypes.CDLL(str(_target(name)))
    return lib
