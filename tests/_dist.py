"""Spawn gloo ranks on the CPU for the multi-rank tests of the port.

``run_world(target, world, tmp_path, **kwargs)`` starts ``world`` Python
processes. Each sets ``torch.set_num_threads(1)``, joins a gloo process group
through a file rendezvous under ``tmp_path`` (no fixed port, so parallel test
workers never collide), calls ``target(rank, world, out_dir, **kwargs)`` and
leaves the group. ``target`` is ``"path/to/file.py:function"``; the file is
loaded by path, so it must import nothing heavy at module level that the
ranks do not need. ``kwargs`` must be JSON.

The spawn has its own time limit (``timeout`` seconds, at most 240): past it
every child is killed and the test fails, so a hung collective cannot run
the suite into its own limit. 240, not less: under the suite's six parallel
workers the mesh tests' JAX child (a GSPMD step compiled for several
configs, 70 s alone) has taken more than 120 s. Returns ``out_dir``, where
the ranks write what the test reads.

At most ``SLOTS`` spawns (a ``run_world``'s ranks, or a ``JaxChild``) run at
once across the suite's workers: each takes a slot, a lock file under
``SLOTS_DIR`` in the temporary directory, before it starts, and its time
limit counts from then. The spawned processes hold the lock (its file
descriptor passed to them), so a slot frees itself when they exit. Under six
workers with every spawn at once, the mesh tests' JAX children ran past the
limit.
"""
from __future__ import annotations

import fcntl
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_TIMEOUT = 240
SLOTS = 3
SLOTS_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_spawn_slots")


def take_slot() -> int:
    """An open file descriptor holding one of the ``SLOTS`` locks (waiting
    until one is free). Pass it to the spawned processes and close it."""
    os.makedirs(SLOTS_DIR, exist_ok=True)
    while True:
        for i in range(SLOTS):
            fd = os.open(os.path.join(SLOTS_DIR, f"slot{i}"), os.O_RDWR | os.O_CREAT, 0o644)
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                return fd
            except OSError:
                os.close(fd)
        time.sleep(0.2)


_CHILD = r"""
import importlib.util, json, os, sys
sys.path.insert(0, os.path.join({root!r}, "src"))
sys.path.insert(0, os.path.join({root!r}, "tests"))
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from datetime import timedelta
rank, world = int(sys.argv[1]), int(sys.argv[2])
dist.init_process_group("gloo", init_method="file://" + {rdv!r}, world_size=world, rank=rank,
                        timeout=timedelta(seconds={timeout}))
path, fn = {target!r}.rsplit(":", 1)
spec = importlib.util.spec_from_file_location("_dist_target", path)
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
getattr(mod, fn)(rank, world, {out!r}, **json.loads({kwargs!r}))
dist.barrier()
dist.destroy_process_group()
"""


def run_world(target: str, world: int, tmp_path, timeout: float = MAX_TIMEOUT,
              **kwargs) -> str:
    timeout = min(timeout, MAX_TIMEOUT)
    tmp = str(tmp_path)
    out = os.path.join(tmp, "out")
    os.makedirs(out, exist_ok=True)
    code = _CHILD.format(root=ROOT, rdv=os.path.join(tmp, "rendezvous"), timeout=int(timeout),
                         target=target, out=out, kwargs=json.dumps(kwargs))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.path.join(ROOT, "src"))
    logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+") for r in range(world)]
    slot = take_slot()
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(world)], cwd=ROOT,
                              env=env, stdout=logs[r], stderr=subprocess.STDOUT,
                              pass_fds=(slot,))
             for r in range(world)]
    os.close(slot)
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            if any(p.poll() not in (None, 0) for p in procs):
                break            # one rank failed: the others would wait for it
            time.sleep(0.05)
    finally:
        hung = [r for r, p in enumerate(procs) if p.poll() is None]
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    failed = {r: p.returncode for r, p in enumerate(procs) if p.returncode != 0}
    if failed:
        tails = []
        for r, f in enumerate(logs):
            f.seek(0)
            tails.append(f"--- rank {r} (rc {procs[r].returncode}) ---\n{f.read()[-3000:]}")
        for f in logs:
            f.close()
        reason = (f"ranks {hung} still running after {timeout:.0f} s, killed"
                  if hung and time.monotonic() >= deadline else f"ranks failed: {failed}")
        raise AssertionError(f"{target} on {world} ranks: {reason}\n" + "\n".join(tails))
    for f in logs:
        f.close()
    return out


class JaxChild:
    """A Python child that computes the JAX package's side of a test, with
    ``n_devices`` forced host devices and ``repro.common.jax_compat``
    imported under a supported version string (it refuses this jax; the
    string is put back once it is imported), ``xla_flags`` added to its
    ``XLA_FLAGS``. It starts once it has a slot (module docstring) and runs
    beside the spawned ranks; ``result()`` waits for it (``timeout`` seconds at most, then it is
    killed and the test fails) and returns its output directory."""

    PRELUDE = r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={n} {flags}"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.join({root!r}, "src"))
sys.path.insert(0, os.path.join({root!r}, "tests"))
OUT = {out!r}
import jax
_real = jax.__version__
jax.__version__ = "0.4.37"
from repro.common import jax_compat as jc
jax.__version__ = _real
'''

    def __init__(self, code: str, tmp_path, n_devices: int = 4, timeout: float = MAX_TIMEOUT,
                 xla_flags: str = ""):
        import textwrap
        self.out = os.path.join(str(tmp_path), "jax")
        os.makedirs(self.out, exist_ok=True)
        self.timeout = min(timeout, MAX_TIMEOUT)
        self.log = open(os.path.join(str(tmp_path), "jax.log"), "w+")
        src = self.PRELUDE.format(n=n_devices, flags=xla_flags, root=ROOT,
                                  out=self.out) + textwrap.dedent(code)
        env = dict(os.environ, OMP_NUM_THREADS="1")
        slot = take_slot()
        self.proc = subprocess.Popen([sys.executable, "-c", src], cwd=ROOT, env=env,
                                     stdout=self.log, stderr=subprocess.STDOUT,
                                     pass_fds=(slot,))
        os.close(slot)
        self.started = time.monotonic()

    def result(self) -> str:
        try:
            self.proc.wait(timeout=max(self.timeout - (time.monotonic() - self.started), 1))
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self.log.seek(0)
        text = self.log.read()
        self.log.close()
        assert self.proc.returncode == 0, (
            f"JAX child rc {self.proc.returncode} after {time.monotonic() - self.started:.0f} s:\n"
            + text[-4000:])
        return self.out
