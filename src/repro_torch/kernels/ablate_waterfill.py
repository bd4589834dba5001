"""Ablation of the water-filling kernel's design choices, on the card.

    PYTHONPATH=src python -m repro_torch.kernels.ablate_waterfill [--iters N]

Builds ``csrc/waterfill.cu`` as it is and, beside it, copies with one choice
undone each (``ABLATIONS``; ``first_design`` is ``csrc/earlier/waterfill.cu``,
the kernel's first design, whole, in both of its variants), all with the
flags of ``_build``, into ``build/ablate/``. Each build is held bit-equal to
``waterfill.waterfill_ref`` and timed, by device time from torch.profiler,
in turns (kernel as it is, each ablation, kernel as it is), at the three
shapes of chip_smoke.py's ``[fabric]``: the C4P main path's balancer call
(the Fig. 2 fabric with a 64-host ring job and 8 two-host tenants, 2 QPs a
port, balanced with CNP jitter 0.05; its flows timed without jitter, as
chip_smoke.py times them: 2,560 flows, ~1,280 rounds), the Fig. 2 fabric
(17 rounds) and the 10,240-GPU fabric (57 rounds), built by
``scenarios/c4p_fabrics.py``. The kernel as it is runs in each variant that
holds the shape. Then the barriers of the rounds alone
(``waterfill_sync_probe``, each variant's). Prints one line a build and
shape and a JSON list last. Needs a CUDA card; used nowhere by the port.
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
from repro_torch.kernels.ablate_flash import device_ms

SOURCE = _build.CSRC / "waterfill.cu"
FIRST_DESIGN = _build.CSRC / "earlier" / "waterfill.cu"
OUT = _build.BUILD_DIR / "ablate"

# name -> (what is undone, edit of the source)
ABLATIONS = {
    "no_dirty_rule": ("every link refreshed every round, not only the links of the flows "
                      "frozen in it",
                      lambda s: _sub("(first || ld<G>(&s.dirty_chunk[mine]) != 0)", "true")(
                          _sub("if (first || ld<G>(&s.dirty_link[l]) != 0) {", "if (true) {")(
                              s))),
    "no_chunk_minimums": ("the least share over every link, and the tie scan over every chunk "
                          "(the chunk minimums still kept)",
                          lambda s: _sub("m = least_of<false>(s.wmin, wpb);",
                                         "m = least_of<false>(s.share, s.L);")(
                              _sub("mine < s.chunks && ld<G>(&s.cmin[mine]) == m",
                                   "mine < s.chunks")(s))),
    "smem_1024_threads": ("the smem variant on 1,024 threads, not 512",
                          _sub("constexpr int SMEM_THREADS = 512;",
                               "constexpr int SMEM_THREADS = 1024;")),
    "smem_256_threads": ("the smem variant on 256 threads, not 512",
                         _sub("constexpr int SMEM_THREADS = 512;",
                              "constexpr int SMEM_THREADS = 256;")),
    "shuffle_min": ("the least share by five double shuffles, not two redux.sync",
                    _sub("""  const unsigned long long b = (unsigned long long)__double_as_longlong(v);
  const unsigned hi = __reduce_min_sync(FULL, (unsigned)(b >> 32));
  const unsigned lo = __reduce_min_sync(FULL, (unsigned)(b >> 32) == hi ? (unsigned)b : ~0u);
  return __longlong_as_double((long long)(((unsigned long long)hi << 32) | lo));""",
                         """  for (int o = 16; o; o >>= 1) v = dmin(v, __shfl_xor_sync(FULL, v, o));
  return v;""")),
    "device_memory": ("the state in device memory on one CTA of 1,024 threads (the grid "
                      "variant's code on one CTA, its barriers __syncthreads), not in shared "
                      "memory",
                      lambda s: _sub("fill_in_device_memory<true>(a);",
                                     "fill_in_device_memory<false>(a);")(
                          _sub("constexpr int GRID_THREADS = 256;",
                               "constexpr int GRID_THREADS = 1024;")(
                              _sub("*blocks = g < 1 ? 1 : g;", "*blocks = 1;")(s)))),
    "first_design": ("the first design whole (csrc/earlier/waterfill.cu: every link's pairs "
                     "rescanned twice a round, through L2)",
                     lambda src: FIRST_DESIGN.read_text()),
}


def build(names):
    """Write and compile every variant in parallel; returns {name: .so path}."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = SOURCE.read_text()
    procs = {}
    for name in names:
        cu = OUT / f"waterfill_{name}.cu"
        cu.write_text(src if name == "kernel" else ABLATIONS[name][1](src))
        so = OUT / f"waterfill_{name}.so"
        procs[name] = (so, subprocess.Popen(_build.nvcc_command(cu, so, "waterfill"),
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        libs[name] = so
    return libs


def caller(so: Path, name: str, args, by_flow):
    """A function variant -> (rate, remaining, rounds) that launches build
    ``name`` on ``args``; outputs and scratch allocated once. The first
    design takes the incidence by link only and a grid flag."""
    import torch
    lib = ctypes.CDLL(str(so))
    fn = lib.waterfill
    p, i = ctypes.c_void_p, ctypes.c_int64
    link_ptr, link_flow, w, alive, cap = args
    f, l, n = w.shape[0], cap.shape[0], link_flow.shape[0]
    dev = w.device
    out = torch.empty(f + l, dtype=torch.float64, device=dev)
    rounds = torch.empty(1, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in args]
    if name == "first_design":
        fn.argtypes = [p] * 5 + [i, i] + [p] * 4 + [ctypes.c_int, p]
        scratch = torch.empty(l + 1024 + (f + 1) // 2, dtype=torch.float64, device=dev)

        def call(variant):
            return fn(*ptrs, f, l, out.data_ptr(), out.data_ptr() + 8 * f, rounds.data_ptr(),
                      scratch.data_ptr(), int(variant == "grid"), stream)
    else:
        from repro_torch.kernels.waterfill import VARIANTS
        fn.argtypes = [p] * 7 + [i] * 3 + [p] * 4 + [i, ctypes.c_int, p]
        sb = lib.waterfill_scratch_bytes
        sb.argtypes, sb.restype = [i, i], ctypes.c_longlong
        scratch = torch.empty(-(-sb(f, l) // 8), dtype=torch.float64, device=dev)

        def call(variant):
            return fn(*ptrs[:2], by_flow[0].data_ptr(), by_flow[1].data_ptr(), *ptrs[2:], f, l, n,
                      out.data_ptr(), out.data_ptr() + 8 * f, rounds.data_ptr(),
                      scratch.data_ptr(), 8 * scratch.numel(), VARIANTS[variant], stream)

    def run(variant):
        err = call(variant)
        if err:
            raise RuntimeError(f"waterfill {name} ({variant}): CUDA error {err}")
        return out[:f], out[f:], rounds
    return run


def _bit_equal(got, want) -> bool:
    import torch
    return all(torch.equal(g.view(torch.int64) if g.is_floating_point() else g,
                           w.view(torch.int64) if w.is_floating_point() else w)
               for g, w in zip(got, want))


def shapes(device):
    """{label: (inputs, rounds)} at the three shapes."""
    from repro_torch.kernels import waterfill as wf
    from repro_torch.scenarios.c4p_fabrics import (BIG_HOSTS, FIG2_HOSTS, balancer_flowset,
                                                   clos_fabric, waterfill_inputs)
    out = {}
    for label, fs, jitter, seed in (("main path", balancer_flowset(device), 0.0, 0),
                                    ("fig2", clos_fabric(FIG2_HOSTS), 0.0, 0),
                                    ("10240", clos_fabric(BIG_HOSTS), 0.0, 0)):
        args, by_flow = waterfill_inputs(fs, device, jitter, seed)
        out[label] = (args, by_flow, int(wf.waterfill_ref(*args)[2][0]))
    return out


def variants_of(name: str, fits: bool):
    """The variants timed for build ``name`` at a shape whose state fits
    (``fits``) or does not fit in shared memory: the first design's own
    two, and the device-memory copy's grid variant (one CTA there)."""
    if name == "first_design":
        return ["cta", "grid"]
    if name == "kernel":
        return (["smem"] if fits else []) + ["grid"]
    if name == "device_memory":
        return ["grid"]
    return ["smem"] if fits else ["grid"]


def main(argv=None) -> int:
    import torch
    from repro_torch.kernels import waterfill as wf
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: the ablation runs on the card only", file=sys.stderr)
        return 1
    cuda = torch.device("cuda")
    order = ["kernel", *ABLATIONS, "kernel"]
    libs = build(dict.fromkeys(order))
    cases = shapes(cuda)
    rows = []
    for name in order:
        for label, (wargs, by_flow, rounds) in cases.items():
            plain = wf.waterfill_ref(*wargs)
            fits = wf.pick_variant(wargs[2].shape[0], wargs[4].shape[0],
                                   wargs[1].shape[0]) == "smem"
            run = caller(libs[name], name, wargs, by_flow)
            row = {"build": name, "shape": label, "rounds": rounds,
                   "undone": ABLATIONS[name][0] if name in ABLATIONS else None}
            for variant in variants_of(name, fits):
                got = run(variant)
                torch.cuda.synchronize()
                if not _bit_equal(got, plain):
                    raise RuntimeError(f"{name} ({variant}) at {label}: differs from the plain "
                                       "version")
                row[variant] = device_ms(lambda: run(variant), args.iters)
            rows.append(row)
            print(f"  {name:18s} {label:9s} ({rounds} rounds) device_ms "
                  + ", ".join(f"{v} {row[v]:.5f}" for v in ("smem", "cta", "grid") if v in row)
                  + f"; bit-equal  {row['undone'] or ''}", flush=True)
    for label, (wargs, _, rounds) in cases.items():
        l = wargs[4].shape[0]
        floor = {v: device_ms(lambda: wf.sync_probe(l, rounds, v, cuda), args.iters)
                 for v in wf.VARIANTS}
        rows.append({"build": "sync_probe", "shape": label, "rounds": rounds, **floor})
        print(f"  barriers alone   {label:9s} ({rounds} rounds) device_ms "
              + ", ".join(f"{v} {floor[v]:.5f}" for v in floor), flush=True)
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
