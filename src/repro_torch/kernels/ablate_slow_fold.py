"""Ablation of the z fold kernel's design choices, on the card.

    PYTHONPATH=src python -m repro_torch.kernels.ablate_slow_fold [--iters N]

Builds ``csrc/slow_fold.cu`` as it is and, beside it, copies with one choice
undone each (``ABLATIONS``; ``first_design`` is ``csrc/earlier/slow_fold.cu``,
the kernel's first design, whole), all with the flags of ``_build``, into
``build/ablate/``. Each build is held bit-equal to ``detect_ref.slow_fold_kernel``
and timed, by device time from torch.profiler, in turns (kernel as it is,
each ablation, kernel as it is) on the two inputs of the detection path:
one 100,000-rank window (``RingJobTelemetry(seed=3)``, a slow source on
rank 5: 300,000 groups; 4 copies cycled so that the 50 MB L2 holds none) and
``ingest_batch``'s shape, 8 windows of 1,024 ranks (seed 7, a slow source on
rank 5 in the odd ones). The medians come from ``window_score`` on the card,
the centers and scales from NumPy, as ``analyze`` makes them. Prints one
line a build (the four-launch copy split by phase) and a JSON list last.
Needs a CUDA card; used nowhere by the port.
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import subprocess
import sys
from pathlib import Path

from repro_torch.core.c4d.detector import DetectorConfig
from repro_torch.kernels import _build
from repro_torch.kernels import detect_ref as plain
from repro_torch.kernels.ablate_decode import _sub
from repro_torch.kernels.ablate_flash import device_ms

SOURCE = _build.CSRC / "slow_fold.cu"
FIRST_DESIGN = _build.CSRC / "earlier" / "slow_fold.cu"
OUT = _build.BUILD_DIR / "ablate"
_CFG = DetectorConfig()
THR, RCF, MIN_OBS = _CFG.mad_threshold, _CFG.row_col_fraction, _CFG.min_observations
OUTPUTS = ("zd", "zw", "point", "row_sel", "row_score", "row_hot", "row_obs", "col_sel",
           "col_score", "col_hot", "col_obs", "wait_sel", "wait_score")

# The four phases as four launches of one kernel (the grid and the phase
# functions as in the source), the points phase reading every group's key
# and zd again: the source's cooperative launch replaced.
_PHASE_KERNEL = """
__global__ void __launch_bounds__(THREADS) fold_phase(Args a, int phase) {
  const long long nthreads = (long long)gridDim.x * THREADS;
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  Kept kept[KEEP];
  if (phase == 0) fold_identities(a, tid, nthreads);
  if (phase == 1) fold_groups(a, tid, nthreads, kept);
  if (phase == 2) fold_ranks(a, tid, nthreads);
  if (phase == 3) fold_points(a, tid, nthreads, kept, 0);
}

struct DeviceInfo {"""
_COOPERATIVE = """  if (!info->cooperative) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)fold_kernel, dim3((unsigned)grid),
                                    dim3(THREADS), params, 0, st);
"""
_FOUR_LAUNCHES = """  for (int phase = 0; phase < 4 && err == cudaSuccess; ++phase) {
    if (groups == 0 && (phase == 1 || phase == 3)) continue;
    fold_phase<<<(unsigned)grid, THREADS, 0, st>>>(a, phase);
    err = cudaGetLastError();
  }
"""


def _four_launches(src: str) -> str:
    src = _sub("\nstruct DeviceInfo {", _PHASE_KERNEL)(src)
    return _sub(_COOPERATIVE, _FOUR_LAUNCHES)(src)


# name -> (what is undone, edit of the source)
ABLATIONS = {
    "four_launches": ("the four phases as four launches, not one cooperative launch",
                      _four_launches),
    "group_atomics": ("every group does its own atomics, not one lane a run of a rank",
                      _sub("kept.rs, kept.hot, kd, lanes, true);",
                           "kept.rs, kept.hot, kd, lanes, false);")),
    "first_design": ("the first design whole (csrc/earlier/slow_fold.cu: four launches, "
                     "int64 atomics a group, 13 outputs apart)",
                     lambda src: FIRST_DESIGN.read_text()),
}


def build(names):
    """Write and compile every variant in parallel; returns {name: .so path}."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = SOURCE.read_text()
    procs = {}
    for name in names:
        cu = OUT / f"slow_fold_{name}.cu"
        cu.write_text(src if name == "kernel" else ABLATIONS[name][1](src))
        so = OUT / f"slow_fold_{name}.so"
        procs[name] = (so, subprocess.Popen(_build.nvcc_command(cu, so, "slow_fold"),
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        libs[name] = so
    return libs


def fold_inputs(n: int, seed: int, faults):
    """(gkey, dmed, wmed, cd, sd, cw, sw) on the card for the windows of
    ``RingJobTelemetry(n, seed)`` with ``faults[i]`` in window i, stacked
    along the batch; gkey (1, G) where the windows share their keys."""
    import numpy as np
    import torch
    from repro_torch.core.faults import RingJobTelemetry
    from repro_torch.core.torchsim import detectors as tdet
    from repro_torch.kernels import window_score as ws
    tel = RingJobTelemetry(n_ranks=n, seed=seed)
    cuda = torch.device("cuda")
    parts, keys = [], []
    for i, f in enumerate(faults):
        pw = tdet._PackedWindow(tel.window_arrays(i, f), n, None)
        lay = pw.layout
        lt = lay.device_tensors(cuda)
        gkey = lt["gkey"]
        keys.append(gkey[0])
        up = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)[None]
              for a in (pw.values, pw.hb_rank, pw.hb_seq, pw.offsets)]
        got = ws.window_score(up[0], lt["order"], lt["starts"], lt["counts"], gkey, *up[1:], 3.0,
                              n=n, large=lt["large"], max_count=lay.max_count)
        dmed, wmed = got["dmed"][0].cpu().numpy(), got["wmed"][0].cpu().numpy()
        cs = [*tdet._mixed_center_scale(dmed, lay.gkey, n, None, "delay"),
              *tdet._mixed_center_scale(wmed, lay.gkey, n, None, "wait")]
        parts.append([got["dmed"][0], got["wmed"][0],
                      *(torch.from_numpy(a).to(cuda) for a in cs)])
    shared = all(torch.equal(k, keys[0]) for k in keys)
    gkey = keys[0][None] if shared else torch.stack(keys)
    return (gkey, *(torch.stack(col).contiguous() for col in zip(*parts)))


def _caller(so: Path, name: str, n: int):
    """A function (inputs, buffers, outputs) -> CUDA error that calls build
    ``name``: the first design takes 13 output pointers, the others the five
    buffers of ``slow_fold._outputs``."""
    import torch
    lib = ctypes.CDLL(str(so))
    fn = lib.slow_fold
    p, i, d = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
    stream = torch.cuda.current_stream().cuda_stream
    outs = 14 if name == "first_design" else 6
    fn.argtypes = [p, i] + [p] * 6 + [i, i, d, d, i, i] + [p] * outs
    fn.restype = ctypes.c_int

    def call(args, bufs, out):
        gkey, dmed = args[0], args[1]
        b, g = dmed.shape
        head = [gkey.data_ptr(), 0 if gkey.shape[0] == 1 else g,
                *(t.data_ptr() for t in args[1:]), b, g, THR, RCF, MIN_OBS, n]
        ptrs = (out[k] for k in OUTPUTS) if name == "first_design" else bufs
        return fn(*head, *(t.data_ptr() for t in ptrs), stream)
    return call


def main(argv=None) -> int:
    import torch
    from repro_torch.core.faults import Fault
    from repro_torch.kernels import slow_fold as sf
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=40)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: the ablation runs on the card only", file=sys.stderr)
        return 1
    order = ["kernel", *ABLATIONS, "kernel"]
    libs = build(dict.fromkeys(order))
    slow = [Fault("slow_src", rank=5)]
    cases = {"100000 ranks": (100_000, fold_inputs(100_000, 3, [slow])),
             "1024 ranks x 8": (1024, fold_inputs(1024, 7, [slow if i % 2 else []
                                                            for i in range(8)]))}
    rows = []
    for name in order:
        row = {"build": name, "undone": ABLATIONS[name][0] if name in ABLATIONS else None}
        for label, (n, fargs) in cases.items():
            call = _caller(libs[name], name, n)
            b, g = fargs[1].shape
            sets = [fargs] + [tuple(t.clone() for t in fargs) for _ in range(3)]
            outs = [sf._outputs(b, g, n, torch.device("cuda")) for _ in sets]
            err = call(sets[0], *outs[0])
            torch.cuda.synchronize()
            if err:
                raise RuntimeError(f"{name}, {label}: CUDA error {err}")
            want = plain.slow_fold_kernel(*fargs, THR, RCF, MIN_OBS, n=n)
            bad = [k for k in OUTPUTS if not _bit_equal(outs[0][1][k], want[k])]
            if bad:
                raise RuntimeError(f"{name}, {label}: differs from the plain version in {bad}")
            turn = itertools.count()

            def run():
                j = next(turn) % len(sets)
                if call(sets[j], *outs[j]):
                    raise RuntimeError(f"{name}, {label}: launch failed")

            row[label] = device_ms(run, args.iters)
            if name == "four_launches":
                row[label + " by phase"] = phase_ms(run, args.iters)
        rows.append(row)
        print(f"  {name:14s} device_ms " + ", ".join(f"{k} {row[k]:.5f}" for k in cases)
              + f"; bit-equal  {row['undone'] or ''}", flush=True)
        for k in cases:
            if f"{k} by phase" in row:
                print(f"    {k} by phase (identities, groups, ranks, points): "
                      + ", ".join(f"{ms:.5f}" for ms in row[f"{k} by phase"]), flush=True)
    print(json.dumps(rows))
    return 0


def phase_ms(run, iters: int, phases: int = 4):
    """Device ms of each launch of a call of ``run`` that makes ``phases``
    launches, in launch order (torch.profiler's kernel events), averaged
    over ``iters`` calls; [] when the profiler recorded another count."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
    ev = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                 and "fold_phase" in e.name), key=lambda e: e.time_range.start)
    if not ev or len(ev) % phases:
        return []
    us = [e.self_device_time_total for e in ev]
    return [sum(us[k::phases]) / (len(us) // phases) / 1e3 for k in range(phases)]


def _bit_equal(a, b) -> bool:
    import torch
    if a.dtype == torch.float64:
        a, b = a.view(torch.int64), b.view(torch.int64)
    return a.dtype == b.dtype and a.shape == b.shape and bool(torch.equal(a, b))


if __name__ == "__main__":
    sys.exit(main())
