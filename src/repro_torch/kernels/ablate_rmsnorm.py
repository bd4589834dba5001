"""Ablation of the RMSNorm kernel's design choices, on the card.

    PYTHONPATH=src python -m repro_torch.kernels.ablate_rmsnorm [--iters N]

Builds ``csrc/rmsnorm.cu`` as it is and, beside it, copies with one choice
undone each (``ABLATIONS``), all with the flags of ``_build``, into
``build/ablate/``: the kernel's first design whole (``csrc/earlier/rmsnorm.cu``)
and the warp-a-row design it was measured against
(``csrc/earlier/rmsnorm_warp_rows.cu``), alone and with two rows a warp.
Each build is held against ``ref.rmsnorm`` per row within ``ROW_REL_TOL`` and
timed at gemma2-2b's three shapes of the main path (bf16, d_model 2304:
training (1, 4096), prefill (2, 4352), decode (2, 1)), 4 input sets cycled
so that the 50 MB L2 does not hold the rows a launch reads, by device time
from torch.profiler, in turns: kernel as it is, each ablation, kernel as it
is. Then the kernel and the warp-a-row design over a sweep of row counts at
D = 2304, and the empty kernel's device time, the floor of a launch.

Last, the split mode's pair (``rmsnorm_sumsq``, ``rmsnorm_scale``) against
its first design, a CTA a row (the ``split_cta`` ablation, which puts
``csrc/earlier/rmsnorm_split_cta.cu`` in place of the pair), at
``SPLIT_CASES``: every shard's sum of squares, then every shard's scale, as
``chip_smoke.py`` times them, in turns kernel, first design, kernel, first
design; the two launches' device times apart and together, each shard held
against ``ref.rmsnorm_scale`` within ``ROW_REL_TOL``. Prints one line a
build or row count and a JSON object last. Needs a CUDA card; used nowhere
by the port.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

from repro_torch.kernels import _build, ref
from repro_torch.kernels.ablate_decode import _sub
from repro_torch.kernels.ablate_flash import device_ms

SOURCE = _build.CSRC / "rmsnorm.cu"
EARLIER = _build.CSRC / "earlier"
OUT = _build.BUILD_DIR / "ablate"
SHAPES = {"train": (1, 4096, 2304), "prefill": (2, 4352, 2304), "decode": (2, 1, 2304)}
SWEEP = (1, 2, 8, 32, 128, 256, 512, 1024, 2048, 4096, 8704)   # rows at D = 2304
# the split mode's cases (chip_smoke.py's SPLIT_CASES): (rows, width, shards, whose norm)
SPLIT_CASES = ((8704, 7168, 8, "zamba2-7b Mamba2, model 8"),
               (8704, 1536, 16, "xlstm-125m mLSTM, model 16"),
               (8704, 768, 16, "xlstm-125m sLSTM, model 16"))


def _warp_rows(rows_per_warp: int):
    """The warp-a-row design, ``rows_per_warp`` consecutive rows a warp."""
    def edit(src: str) -> str:
        out = (EARLIER / "rmsnorm_warp_rows.cu").read_text()
        return out if rows_per_warp == 1 else _sub(
            "constexpr int ROWS_PER_WARP = 1;",
            f"constexpr int ROWS_PER_WARP = {rows_per_warp};")(out)
    return edit


_SCALE_LOAD = "      load_scale<TS, VEC>(scale + piece * VEC, s[j]);\n"


def _scale_after(src: str) -> str:
    """The scale's loads moved from beside x's to after the reduction."""
    src = _sub(_SCALE_LOAD, "")(src)
    return _sub("      float y[VEC];\n", "      float y[VEC];\n" + _SCALE_LOAD)(src)


# warp 0 folds the partials and hands the total on through shared memory
_two_barriers = _sub(
    "  const float total = warp_sum(lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0.f);\n",
    "  __shared__ float row_sum;\n"
    "  if (warp == 0) {\n"
    "    const float t = warp_sum(lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0.f);\n"
    "    if (lane == 0) row_sum = t;\n"
    "  }\n"
    "  __syncthreads();\n"
    "  const float total = row_sum;\n")


# the split mode's kernels and dispatch: from the first line after the comment
# they share to the empty kernel
_SPLIT_FROM = "// rsqrt(sum / width + eps) * (1 + scale), width the whole row's."
_SPLIT_TO = "// A launch that does nothing"


def _split_cta(src: str) -> str:
    """The split mode's pair and dispatch replaced by its first design's."""
    assert src.count(_SPLIT_FROM) == 1 and src.count(_SPLIT_TO) == 1
    start = src.index("\n", src.index(_SPLIT_FROM)) + 1
    return src[:start] + (EARLIER / "rmsnorm_split_cta.cu").read_text() + src[src.index(_SPLIT_TO):]


# name -> (what is undone, edit of the source)
ABLATIONS = {
    "warp_rows": ("a warp a row, not a CTA a row (csrc/earlier/rmsnorm_warp_rows.cu: up to 16 "
                  "pieces a lane, shuffles only)", _warp_rows(1)),
    "prefetch": ("a warp a row, two rows a warp, the second's loads issued before the first's "
                 "fold", _warp_rows(2)),
    "scale_after": ("scale loaded after the reduction, not with x", _scale_after),
    "two_barriers": ("warp 0 folds the partials between two barriers", _two_barriers),
    "first_design": ("the first design whole (csrc/earlier/rmsnorm.cu: two barriers, scale read "
                     "element by element after the reduction)",
                     lambda src: (EARLIER / "rmsnorm.cu").read_text()),
    "split_cta": ("the split pair a CTA a row (csrc/earlier/rmsnorm_split_cta.cu)", _split_cta),
}


def build(names):
    """Write and compile every variant in parallel; returns {name: .so path}."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = SOURCE.read_text()
    procs = {}
    for name in names:
        cu = OUT / f"rmsnorm_{name}.cu"
        cu.write_text(src if name == "kernel" else ABLATIONS[name][1](src))
        so = OUT / f"rmsnorm_{name}.so"
        procs[name] = (so, subprocess.Popen(_build.nvcc_command(cu, so, "rmsnorm"),
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        libs[name] = so
    return libs


def _lib(so: Path):
    lib = ctypes.CDLL(str(so))
    lib.rmsnorm_fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.rmsnorm_fwd.restype = ctypes.c_int
    return lib


def _split_lib(so: Path):
    lib = ctypes.CDLL(str(so))
    lib.rmsnorm_sumsq.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.rmsnorm_scale.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.rmsnorm_sumsq.restype = lib.rmsnorm_scale.restype = ctypes.c_int
    return lib


def split_pairs(libs, iters: int):
    """The split pair of the kernel and of its first design at each of
    ``SPLIT_CASES`` (module docstring); returns one row a case and build."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(15)
    eps, tol = 1e-6, ref.ROW_REL_TOL[torch.bfloat16]
    stream = torch.cuda.current_stream().cuda_stream
    rows_out = []
    for rows, width, shards, label in SPLIT_CASES:
        d = width // shards
        sets = []
        for _ in range(4):
            xs = [torch.randn((rows, d), generator=gen, device="cuda").bfloat16()
                  for _ in range(shards)]
            ss = [(0.1 * torch.randn((d,), generator=gen, device="cuda")).bfloat16()
                  for _ in range(shards)]
            sums = [torch.empty(rows, device="cuda") for _ in range(shards)]
            total = sum(ref.rmsnorm_sumsq(x) for x in xs)
            sets.append((xs, ss, sums, total, [torch.empty_like(x) for x in xs]))
        for name in ("kernel", "split_cta", "kernel", "split_cta"):
            lib = _split_lib(libs[name])

            def sumsq(i, lib=lib):
                xs, _, sums, _, _ = sets[i]
                for x, out in zip(xs, sums):
                    if lib.rmsnorm_sumsq(x.data_ptr(), out.data_ptr(), rows, d, 1, stream):
                        raise RuntimeError(f"{name}: rmsnorm_sumsq failed")

            def scale(i, lib=lib):
                xs, ss, _, total, outs = sets[i]
                for x, s, out in zip(xs, ss, outs):
                    if lib.rmsnorm_scale(x.data_ptr(), total.data_ptr(), s.data_ptr(),
                                         out.data_ptr(), rows, d, width, eps, 1, 1, stream):
                        raise RuntimeError(f"{name}: rmsnorm_scale failed")
            sumsq(0)
            scale(0)
            torch.cuda.synchronize()
            xs, ss, sums, total, outs = sets[0]
            rel = max(ref.max_row_rel_err(o, ref.rmsnorm_scale(x, total, s, width, eps))
                      for x, s, o in zip(xs, ss, outs))
            sum_rel = max(((a - ref.rmsnorm_sumsq(x)).abs() / ref.rmsnorm_sumsq(x)).max().item()
                          for x, a in zip(xs, sums))
            if not (rel <= tol and sum_rel <= 1e-5):
                raise RuntimeError(f"{name} {label}: max_row_rel_err {rel}, sums {sum_rel}")

            def cycled(fn):
                turn = iter(range(1 << 30))
                return lambda: fn(next(turn) % 4)
            row = {"case": label, "build": name, "shards": shards, "columns": d,
                   "sumsq_ms": device_ms(cycled(sumsq), iters),
                   "scale_ms": device_ms(cycled(scale), iters),
                   "pair_ms": device_ms(cycled(lambda i: (sumsq(i), scale(i))), iters),
                   "max_row_rel_err": rel}
            rows_out.append(row)
            print(f"  split {label}, {shards} shards of {d}: {name:9s} device_ms sums "
                  f"{row['sumsq_ms']:.5f} + scales {row['scale_ms']:.5f}, pair "
                  f"{row['pair_ms']:.5f} ({2 * shards} launches)", flush=True)
    return rows_out


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=80)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: the ablation runs on the card only", file=sys.stderr)
        return 1
    # split_cta changes only the split pair: timed by split_pairs, not per row
    order = ["kernel", *(a for a in ABLATIONS if a != "split_cta"), "kernel"]
    libs = build(dict.fromkeys([*order, "split_cta"]))
    gen = torch.Generator(device="cuda").manual_seed(14)
    eps = 1e-6
    stream = torch.cuda.current_stream().cuda_stream
    inputs = {k: [(torch.randn(shape, generator=gen, device="cuda").bfloat16(),
                   (0.1 * torch.randn(shape[-1:], generator=gen, device="cuda")).bfloat16())
                  for _ in range(4)] for k, shape in SHAPES.items()}
    outs = {k: torch.empty_like(v[0][0]) for k, v in inputs.items()}
    tol = ref.ROW_REL_TOL[torch.bfloat16]

    def runner(call, key):
        x0 = inputs[key][0][0]
        rows, d = x0.numel() // x0.shape[-1], x0.shape[-1]
        turn = iter(range(1 << 30))

        def run(i=None):
            x, s = inputs[key][next(turn) % 4 if i is None else i]
            err = call(x.data_ptr(), s.data_ptr(), outs[key].data_ptr(), rows, d, eps, 1, 1,
                       stream)
            if err:
                raise RuntimeError(f"CUDA error {err}")
        return run

    rows_out = []
    for name in order:
        lib = _lib(libs[name])
        row = {"build": name, "undone": ABLATIONS[name][0] if name in ABLATIONS else None}
        for key in SHAPES:
            run = runner(lib.rmsnorm_fwd, key)
            run(0)
            torch.cuda.synchronize()
            rel = ref.max_row_rel_err(outs[key], ref.rmsnorm(*inputs[key][0], eps))
            if not (rel <= tol and bool(torch.isfinite(outs[key]).all())):
                raise RuntimeError(f"{name} {key}: max_row_rel_err {rel} above {tol}")
            row[key] = {"device_ms": device_ms(run, args.iters), "max_row_rel_err": rel}
        rows_out.append(row)
        print(f"  {name:13s} device_ms train {row['train']['device_ms']:.5f}, prefill "
              f"{row['prefill']['device_ms']:.5f}, decode {row['decode']['device_ms']:.5f}  "
              f"{row['undone'] or ''}", flush=True)

    d = 2304
    xs = [torch.randn((max(SWEEP), d), generator=gen, device="cuda").bfloat16()
          for _ in range(4)]
    s = (0.1 * torch.randn((d,), generator=gen, device="cuda")).bfloat16()
    out = torch.empty_like(xs[0])
    sweep = []
    for rows in SWEEP:
        line = {"rows": rows}
        for name in ("kernel", "warp_rows"):
            fn = _lib(libs[name]).rmsnorm_fwd
            turn = iter(range(1 << 30))

            def run(fn=fn, rows=rows, i=None):
                x = xs[next(turn) % 4 if i is None else i]
                if fn(x.data_ptr(), s.data_ptr(), out.data_ptr(), rows, d, eps, 1, 1, stream):
                    raise RuntimeError(f"{name}, {rows} rows: launch failed")

            run(i=0)
            torch.cuda.synchronize()
            rel = ref.max_row_rel_err(out[:rows], ref.rmsnorm(xs[0][:rows], s, eps))
            if not rel <= tol:
                raise RuntimeError(f"{name}, {rows} rows: max_row_rel_err {rel}")
            line[name] = device_ms(run, args.iters)
        sweep.append(line)
        print(f"  sweep {rows:5d} rows x {d}: device_ms kernel {line['kernel']:.5f}, warp_rows "
              f"{line['warp_rows']:.5f}", flush=True)
    lib = ctypes.CDLL(str(libs["kernel"]))
    lib.rmsnorm_empty.argtypes = [ctypes.c_void_p]
    lib.rmsnorm_empty.restype = ctypes.c_int
    floor = device_ms(lambda: lib.rmsnorm_empty(stream), args.iters)
    print(f"  empty kernel: device_ms {floor:.5f}", flush=True)
    split = split_pairs(libs, args.iters)
    print(json.dumps({"ablations": rows_out, "sweep": sweep, "empty_kernel_ms": floor,
                      "split": split}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
