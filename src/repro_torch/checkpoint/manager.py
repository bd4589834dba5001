"""Fast checkpointing: in-memory replica + async disk flush.

Port of ``repro.checkpoint.manager``, with the same API and behaviour. The
paper (section 2/4.2.1, citing Gemini) relies on frequent checkpoints so that
little work is lost when C4D restarts a job. This manager provides:

  * ``save(step, tree)``: a synchronous host-RAM copy of the tree (the fast
    path) plus a disk flush on a worker thread,
  * a sha256 per leaf in a JSON manifest beside the ``.npz`` (detects torn or
    corrupt writes on restore),
  * ``restore_flat`` / ``restore``: the newest *valid* checkpoint, memory
    first, falling back past corrupt ones on disk,
  * retention of the last ``keep`` checkpoints, in memory and on disk.

``disk=False`` keeps the in-memory replica only (the ranks of a mesh other
than rank 0, which alone writes the shared directory).

A tree is nested dicts (and lists) of tensors, numpy arrays or numbers; its
flat keys are the ``/``-joined paths, as in the JAX package. Leaves come back
as CPU tensors of their saved dtype. numpy has no bfloat16, so a bf16 leaf is
written as its int16 bits and the manifest names the dtype: a restore is
bit-exact.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import zipfile
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

_FILE = re.compile(r"ckpt_(\d{8})\.npz$")
_BITS = {torch.bfloat16: torch.int16}      # dtypes numpy lacks, stored as their bits
_DTYPES = {str(d).removeprefix("torch."): d for d in (
    torch.float32, torch.float64, torch.bfloat16, torch.float16, torch.int8, torch.int16,
    torch.int32, torch.int64, torch.uint8, torch.bool)}


def _leaves(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree) if isinstance(tree, (list, tuple)) else None)
    if items is None:
        yield prefix, tree
        return
    for k, v in items:
        yield from _leaves(v, f"{prefix}/{k}" if prefix else str(k))


def _to_host(leaf) -> torch.Tensor:
    """A CPU tensor holding its own copy of ``leaf``."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return torch.from_numpy(np.array(leaf))


def _tree_to_flat(tree) -> Dict[str, torch.Tensor]:
    return {k: _to_host(v) for k, v in _leaves(tree)}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.view(_BITS.get(t.dtype, t.dtype)).numpy()


def _sha(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).reshape(-1).view(np.uint8)).hexdigest()[:16]


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_disk: bool = True,
                 disk: bool = True):
        self.dir = directory
        self.keep = keep
        self.disk = disk
        os.makedirs(directory, exist_ok=True)
        self.memory: Dict[int, Dict[str, torch.Tensor]] = {}   # Gemini-style replica
        self._pool = ThreadPoolExecutor(max_workers=1) if async_disk else None
        self._pending: List[Future] = []
        self.save_count = 0

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, blocking: bool = False) -> None:
        flat = _tree_to_flat(tree)
        self.memory[step] = flat
        for old in sorted(self.memory)[: -self.keep]:
            self.memory.pop(old, None)
        self.save_count += 1
        if not self.disk:
            return
        if self._pool is not None and not blocking:
            self._pending.append(self._pool.submit(self._write, step, flat))
        else:
            self._write(step, flat)

    def _write(self, step: int, flat: Dict[str, torch.Tensor]) -> None:
        path = os.path.join(self.dir, f"ckpt_{step:08d}")
        arrays = {k: _to_numpy(t) for k, t in flat.items()}
        np.savez(path + ".tmp.npz", **arrays)
        manifest = {k: {"sha": _sha(arrays[k]), "shape": list(t.shape),
                        "dtype": str(t.dtype).removeprefix("torch.")}
                    for k, t in flat.items()}
        with open(path + ".tmp.json", "w") as f:
            json.dump({"step": step, "leaves": manifest}, f)
        os.replace(path + ".tmp.npz", path + ".npz")
        os.replace(path + ".tmp.json", path + ".json")
        self._gc()

    def _gc(self):
        for s in self.disk_steps()[: -self.keep]:
            for ext in (".npz", ".json"):
                try:
                    os.remove(os.path.join(self.dir, f"ckpt_{s:08d}{ext}"))
                except FileNotFoundError:
                    pass

    def wait(self):
        """Block until every disk flush so far is done; raise the first
        flush's error, if one failed."""
        pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()

    # ------------------------------------------------------------------
    def disk_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_FILE.match, os.listdir(self.dir)) if m)

    def _validate(self, step: int) -> Optional[Dict[str, torch.Tensor]]:
        """The checkpoint on disk, or None if it is missing, unreadable or
        any leaf's sha256 disagrees with the manifest."""
        base = os.path.join(self.dir, f"ckpt_{step:08d}")
        try:
            with open(base + ".json") as f:
                manifest = json.load(f)["leaves"]
            flat = {}
            with np.load(base + ".npz") as z:
                for k, meta in manifest.items():
                    arr = z[k]
                    if _sha(arr) != meta["sha"] or list(arr.shape) != meta["shape"]:
                        return None
                    dtype = _DTYPES[meta["dtype"]]
                    flat[k] = torch.from_numpy(arr).view(dtype)
            return flat
        except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
            return None

    def restore_flat(self, step: Optional[int] = None) -> Tuple[int, Dict[str, torch.Tensor]]:
        """Newest valid checkpoint (memory first, then disk)."""
        candidates = sorted(set(self.memory) | set(self.disk_steps()), reverse=True)
        if step is not None:
            candidates = [s for s in candidates if s == step]
        for s in candidates:
            if s in self.memory:
                return s, self.memory[s]
            flat = self._validate(s)
            if flat is not None:
                return s, flat
        raise FileNotFoundError("no valid checkpoint found")

    def restore(self, template: Any, step: Optional[int] = None) -> Tuple[int, Any]:
        """Restore into ``template``'s structure (nested dicts and lists);
        the leaves are CPU tensors. A checkpoint whose leaves are not the
        template's (a leaf missing or extra, or of another shape or, against
        a tensor, another dtype: the optimizer state of another layout) is
        refused with a ``ValueError`` that names the first such leaf."""
        s, flat = self.restore_flat(step)
        keys = dict(_leaves(template))
        for k, t in keys.items():
            got = flat.get(k)
            if got is None:
                raise ValueError(f"checkpoint of step {s}: no leaf {k}")
            want = (tuple(t.shape), t.dtype) if isinstance(t, torch.Tensor) else None
            if want is not None and (tuple(got.shape), got.dtype) != want:
                raise ValueError(f"checkpoint of step {s}: leaf {k} is {tuple(got.shape)} "
                                 f"{got.dtype}, expected {want[0]} {want[1]}")
        extra = sorted(set(flat) - set(keys))
        if extra:
            raise ValueError(f"checkpoint of step {s}: leaf {extra[0]} is not in the template "
                             f"({len(extra)} such)")
        it = iter(flat[k] for k in keys)

        def build(t):
            if isinstance(t, dict):
                return {k: build(v) for k, v in t.items()}
            if isinstance(t, (list, tuple)):
                return type(t)(build(v) for v in t)
            return next(it)
        return s, build(template)

    def close(self):
        self.wait()
        if self._pool is not None:
            self._pool.shutdown()
