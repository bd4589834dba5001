"""Ablation of the EWMA scan kernel's design choices, on the card.

    PYTHONPATH=src python -m repro_torch.kernels.ablate_ewma [--iters N]

Builds ``csrc/ewma_scan.cu`` as it is and, beside it, copies with one choice
undone each (``ABLATIONS``; ``first_design`` is ``csrc/earlier/ewma_scan.cu``,
the kernel's first design, whole), all with the flags of ``_build``, into
``build/ablate/``. Each build is held within 1e-9 of
``detect_ref.ewma_scan_ref`` (counts equal) and timed, by device time from
torch.profiler and split by kernel, in turns (kernel as it is, each
ablation, kernel as it is), at ``bench_jaxsim.py``'s full size: 64 windows
of 16,384 cells, N(10, 1) with 10 % NaN. "L2 path" is the kernel as it is
told to take its L2 path. Prints one line a build and a JSON list last.
Needs a CUDA card; used nowhere by the port.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

from repro_torch.kernels import _build
from repro_torch.kernels.ablate_decode import _sub

SOURCE = _build.CSRC / "ewma_scan.cu"
FIRST_DESIGN = _build.CSRC / "earlier" / "ewma_scan.cu"
OUT = _build.BUILD_DIR / "ablate"
WINDOWS, CELLS, TOL = 64, 16384, 1e-9
KERNELS = ("ewma_pool_kernel", "ewma_pool_l2_kernel", "ewma_step_kernel")

_PLAIN_COPY = """  for (long long i = tid; i < n; i += blockDim.x) v[i] = src[i];
  __syncthreads();
"""
# the window's part in whole 16-byte pieces (the bench shape's are)
_BULK_COPY = """  __shared__ unsigned long long bar_mem;
  const uint32_t bar = smem_u32(&bar_mem);
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && n > 0) {
    mbar_expect_tx(bar, (uint32_t)(8 * n));
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                 "[%0], [%1], %2, [%3];\\n"
                 :: "r"(smem_u32(v)), "l"(src), "r"((uint32_t)(8 * n)), "r"(bar) : "memory");
  }
  if (n > 0) mbar_wait(bar, 0);
"""

# name -> (what is undone, edit of the source, path)
ABLATIONS = {
    "l2_path": ("the windows' medians read from L2 a pass, a CTA a window (the L2 path)",
                lambda s: s, 2),
    "cluster_1": ("one CTA a window, not a cluster of two",
                  _sub("constexpr int CLUSTER = 2;", "constexpr int CLUSTER = 1;"), 1),
    "eight_passes": ("all eight radix passes, not ending once each statistic's bin holds "
                     "one candidate",
                     _sub("if (shift > 0 && sh.pick[0][2] == 1 && sh.pick[1][2] == 1) {",
                          "if (false) {"), 1),
    "match_any": ("one shared atomic a distinct digit of a warp (__match_any_sync), not one a "
                  "lane",
                  _sub("""      for (long long i = tid; i < n; i += blockDim.x) {
        const double x = v[i];
        if (!isfinite(x)) continue;
        const u64 u = order_key(x);
        const unsigned d = (unsigned)(u >> shift) & 255u;
        for (int s = 0; s < (same ? 1 : 2); ++s)
          if ((u & mask) == prefix[s]) atomicAdd(&sh.hist[b][s][d], 1u);
      }""", """      for (long long base = 0; base < n; base += blockDim.x) {
        const long long i = base + tid;
        const double x = i < n ? v[i] : CUDART_NAN;
        const u64 u = order_key(x);
        const unsigned d = (unsigned)(u >> shift) & 255u;
        for (int s = 0; s < (same ? 1 : 2); ++s) {
          const bool hit = isfinite(x) && (u & mask) == prefix[s];
          const unsigned peers = __match_any_sync(FULL, hit ? d : 256u + lane);
          if (hit && lane == __ffs(peers) - 1) atomicAdd(&sh.hist[b][s][d], __popc(peers));
        }
      }"""), 1),
    "step_256": ("256-thread step CTAs, one window's load ahead, not 64 and eight",
                 lambda s: _sub("constexpr int STEP_THREADS = 64;",
                                "constexpr int STEP_THREADS = 256;")(
                     _sub("constexpr int STEP_AHEAD = 8;", "constexpr int STEP_AHEAD = 1;")(s)),
                 1),
    "bulk_copy": ("the window brought into shared memory by one bulk asynchronous copy "
                  "(TMA, an mbarrier), not by the threads' loads",
                  lambda s: _sub("#include <math_constants.h>\n",
                                 "#include <math_constants.h>\n\n#include \"tma.cuh\"\n")(
                      _sub(_PLAIN_COPY, _BULK_COPY)(s)), 1),
    "pool_512_threads": ("512 threads a pool CTA, not 1,024",
                         _sub("constexpr int POOL_THREADS = 1024;",
                              "constexpr int POOL_THREADS = 512;"), 1),
    "step_ahead_16": ("sixteen windows' loads in flight a step thread, not eight",
                      _sub("constexpr int STEP_AHEAD = 8;", "constexpr int STEP_AHEAD = 16;"), 1),
    "step_32": ("32-thread step CTAs, not 64",
                _sub("constexpr int STEP_THREADS = 64;", "constexpr int STEP_THREADS = 32;"), 1),
    "first_design": ("the first design whole (csrc/earlier/ewma_scan.cu: a CTA a window "
                     "reading it from L2 in each of 2 x 8 radix passes)",
                     lambda src: FIRST_DESIGN.read_text(), None),
}


def build(names):
    """Write and compile every variant in parallel; returns {name: .so path}."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = SOURCE.read_text()
    procs = {}
    for name in names:
        cu = OUT / f"ewma_{name}.cu"
        cu.write_text(src if name == "kernel" else ABLATIONS[name][1](src))
        so = OUT / f"ewma_{name}.so"
        procs[name] = (so, subprocess.Popen(_build.nvcc_command(cu, so, "ewma_scan"),
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        libs[name] = so
    return libs


def bench_inputs(device):
    """bench_jaxsim.py's ewma_scan input on ``device``: (values, mean0, dev0,
    count0, alpha, clip_sigma)."""
    import numpy as np
    import torch
    from repro_torch.core.c4d.baseline import AdaptiveBaseline
    rng = np.random.default_rng(0)
    values = rng.normal(10.0, 1.0, size=(WINDOWS, CELLS))
    values[rng.random(values.shape) < 0.1] = np.nan
    base = AdaptiveBaseline(n_ranks=2)
    zeros = torch.zeros(CELLS, dtype=torch.float64, device=device)
    return (torch.from_numpy(values).to(device), zeros, zeros.clone(),
            torch.zeros(CELLS, dtype=torch.int64, device=device), base.alpha, base.clip_sigma)


def caller(so: Path, name: str, args):
    """A function () -> (mean, dev, count) that launches build ``name`` on
    ``args``; outputs and the pool allocated once. The first design takes
    no path."""
    import torch
    fn = ctypes.CDLL(str(so)).ewma_scan
    p, i, d = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
    values, mean0, dev0, count0, alpha, clip = args
    w, e = values.shape
    out = torch.empty((2, e), dtype=torch.float64, device=values.device)
    count = torch.empty(e, dtype=torch.int64, device=values.device)
    pool = torch.empty(2 * w, dtype=torch.float64, device=values.device)
    path = ABLATIONS[name][2] if name in ABLATIONS else 0
    head = [values.data_ptr(), w, e, mean0.data_ptr(), dev0.data_ptr(), count0.data_ptr(),
            float(alpha), float(clip), out[0].data_ptr(), out[1].data_ptr(), count.data_ptr(),
            pool.data_ptr()]
    stream = torch.cuda.current_stream().cuda_stream
    if path is None:
        fn.argtypes = [p, i, i, p, p, p, d, d, p, p, p, p, p]
        tail = [stream]
    else:
        fn.argtypes = [p, i, i, p, p, p, d, d, p, p, p, p, ctypes.c_int, p]
        tail = [path, stream]

    def run():
        err = fn(*head, *tail)
        if err:
            raise RuntimeError(f"ewma_scan {name}: CUDA error {err}")
        return out[0], out[1], count
    return run


def split_ms(run, iters: int) -> dict:
    """Device ms a call by kernel (torch.profiler), over ``iters`` calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            key = next((k for k in KERNELS if k in e.key), e.key[:40])
            out[key] = out.get(key, 0.0) + e.self_device_time_total / iters / 1e3
    return out


def main(argv=None) -> int:
    import torch
    from repro_torch.kernels import detect_ref
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=40)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: the ablation runs on the card only", file=sys.stderr)
        return 1
    order = ["kernel", *ABLATIONS, "kernel"]
    libs = build(dict.fromkeys(order))
    inputs = bench_inputs(torch.device("cuda"))
    want = detect_ref.ewma_scan_ref(*inputs)
    rows = []
    for name in order:
        run = caller(libs[name], name, inputs)
        got = run()
        torch.cuda.synchronize()
        err = max((g - x).abs().max().item() for g, x in zip(got[:2], want[:2]))
        if not torch.equal(got[2], want[2]) or not err <= TOL:
            raise RuntimeError(f"{name}: outside {TOL:g} of the plain version ({err:.3e})")
        by_kernel = split_ms(run, args.iters)
        row = {"build": name, "device_ms": sum(by_kernel.values()), "by_kernel": by_kernel,
               "max_abs_err": err, "undone": ABLATIONS[name][0] if name in ABLATIONS else None}
        rows.append(row)
        print(f"  {name:14s} device_ms {row['device_ms']:.5f} ("
              + ", ".join(f"{k} {v:.5f}" for k, v in by_kernel.items())
              + f"); max_abs_err {err:.3e}  {row['undone'] or ''}", flush=True)
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
