"""Ablation of the bf16 decode kernel's design choices, on the card.

    PYTHONPATH=src python -m repro_torch.kernels.ablate_decode [--iters N]
        [--shape gemma2-2b|stablelm-12b]

Builds ``csrc/decode_attention.cu`` as it is and, beside it, copies with one
choice undone each (``ABLATIONS``), all with the flags of ``_build``, into
``build/ablate/``. Each build is held against ``ref.decode_attention`` per row
within ``ROW_REL_TOL`` and timed at a decode shape (``SHAPES``: gemma2-2b's
B=2, cache 4384, H=8 on 4 kv heads, D=256, cap 50, pos 4383, window 4096 and
full; stablelm-12b's 32 heads on 8, D=160, no cap, full), 4 cache sets cycled
so that the 50 MB L2 does not hold the one a launch reads, by device time
from torch.profiler, in turns: kernel as it is, each ablation, kernel as it
is. Then the kernel as it is over a sweep of positions (global attention, 64
to 4384 keys), whose device times against the bytes read split a fixed cost
from the rate at which it streams the cache. Prints one line a build or
position and a JSON object last. Needs a CUDA card; used nowhere by the port.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

from repro_torch.kernels import _build, ref
from repro_torch.kernels.ablate_flash import device_ms

SOURCE = _build.CSRC / "decode_attention.cu"
OUT = _build.BUILD_DIR / "ablate"
SWEEP = (63, 127, 511, 1023, 2047, 3071, 4095, 4383)     # positions, global attention


def _sub(old: str, new: str):
    def edit(src: str) -> str:
        if old not in src:
            raise ValueError(f"ablation target not in the source: {old!r}")
        return src.replace(old, new)
    return edit


def _other_splits_per_sm(src: str) -> str:
    m = re.search(r"constexpr int SPLITS_PER_SM = (\d+);", src)
    if m is None:
        raise ValueError("SPLITS_PER_SM not in the source")
    other = 1 if m.group(1) != "1" else 2
    return src.replace(m.group(0), f"constexpr int SPLITS_PER_SM = {other};")


# name -> (what is undone, edit of the source)
ABLATIONS = {
    "ring96k": ("a ring of 96 KB (3 tile slots at D=256) instead of 64 KB (2)",
                _sub("constexpr int RING_BYTES = 64 * 1024;",
                     "constexpr int RING_BYTES = 96 * 1024;")),
    "other_c": ("the other number of CTAs an SM in the split plan (SPLITS_PER_SM 1 <-> 2)",
                _other_splits_per_sm),
    "two_launch": ("the combine as a second launch, not by the last CTA",
                   _sub("constexpr bool FUSED_COMBINE = true;",
                        "constexpr bool FUSED_COMBINE = false;")),
    "floor_splits": ("splits floor(2 n_SM / (B Hkv)), at most one wave, not the ceiling",
                     _sub("const int want = (SPLITS_PER_SM * n_sm + B * Hkv - 1) / (B * Hkv);",
                          "const int want = SPLITS_PER_SM * n_sm / (B * Hkv);")),
    "g8_for_group4": ("a group of 3 or 4 on the 8-head instance (one CTA an SM), not the 4-head",
                      _sub("  if (group <= 4)\n", "  if (false)\n")),
    "split_k_160": ("bf16 head_dim 160 on split-K + combine (the first draft), not the TMA kernel",
                    _sub(" || D == 160", "")),
}

# decode shapes: (b, cache, h, hkv, d, cap, pos, windows)
SHAPES = {"gemma2-2b": (2, 4384, 8, 4, 256, 50.0, 4383, (4096, 0)),
          "stablelm-12b": (2, 4384, 32, 8, 160, 0.0, 4383, (0,))}


def build(names):
    """Write and compile every variant in parallel; returns {name: .so path}."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = SOURCE.read_text()
    procs = {}
    for name in names:
        cu = OUT / f"decode_{name}.cu"
        cu.write_text(src if name == "kernel" else ABLATIONS[name][1](src))
        so = OUT / f"decode_{name}.so"
        procs[name] = (so, subprocess.Popen(_build.nvcc_command(cu, so), stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        libs[name] = so
    return libs


def _lib(so: Path):
    lib = ctypes.CDLL(str(so))
    lib.decode_attention_fwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.decode_attention_fwd.restype = ctypes.c_int
    lib.decode_attention_scratch_floats.argtypes = [ctypes.c_int] * 6
    lib.decode_attention_scratch_floats.restype = ctypes.c_longlong
    return lib


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=80)
    ap.add_argument("--shape", choices=sorted(SHAPES), default="gemma2-2b")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: the ablation runs on the card only", file=sys.stderr)
        return 1
    b, s, h, hkv, d, cap, pos, windows = SHAPES[args.shape]
    order = ["kernel", *ABLATIONS, "kernel"]
    libs = build(dict.fromkeys(order))
    gen = torch.Generator(device="cuda").manual_seed(12)
    sets = [tuple(torch.randn(shape, generator=gen, device="cuda").bfloat16()
                  for shape in ((b, 1, h, d), (b, s, hkv, d), (b, s, hkv, d)))
            for _ in range(4)]
    out = torch.empty_like(sets[0][0])
    stream = torch.cuda.current_stream().cuda_stream
    want = {w: ref.decode_attention(*sets[0], pos, window=w, logit_cap=cap, scale=d ** -0.5)
            for w in windows}
    tol = ref.ROW_REL_TOL[torch.bfloat16]
    rows = []
    for name in order:
        lib = _lib(libs[name])
        part = torch.empty(lib.decode_attention_scratch_floats(b, s, h, hkv, d, 1),
                           dtype=torch.float32, device="cuda")
        cnt = torch.zeros(b * hkv, dtype=torch.int32, device="cuda")
        turn = iter(range(1 << 30))

        def run(w, i=None):
            qq, kk, vv = sets[next(turn) % len(sets) if i is None else i]
            err = lib.decode_attention_fwd(qq.data_ptr(), kk.data_ptr(), vv.data_ptr(),
                                           out.data_ptr(), part.data_ptr(), cnt.data_ptr(), b, s,
                                           h, hkv, d, pos, w, d ** -0.5, cap, 1, stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")

        row = {"build": name, "undone": ABLATIONS[name][0] if name in ABLATIONS else None,
               "shape": args.shape}
        for w in windows:
            run(w, 0)
            torch.cuda.synchronize()
            rel = ref.max_row_rel_err(out, want[w])
            if not (rel <= tol and bool(torch.isfinite(out).all())):
                raise RuntimeError(f"{name} window {w}: max_row_rel_err {rel} above {tol}")
            row[f"window_{w}"] = {"device_ms": device_ms(lambda: run(w), args.iters),
                                  "max_row_rel_err": rel}
        rows.append(row)
        times = ", ".join(f"window {w} {row[f'window_{w}']['device_ms']:.5f}" for w in windows)
        print(f"  {name:12s} {args.shape} device_ms {times}; max_row_rel_err "
              f"{max(row[f'window_{w}']['max_row_rel_err'] for w in windows):.3e}  "
              f"{row['undone'] or ''}", flush=True)
    lib = _lib(libs["kernel"])
    part = torch.empty(lib.decode_attention_scratch_floats(b, s, h, hkv, d, 1),
                       dtype=torch.float32, device="cuda")
    cnt = torch.zeros(b * hkv, dtype=torch.int32, device="cuda")
    sweep = []
    for p in SWEEP:
        turn = iter(range(1 << 30))

        def run_pos():
            qq, kk, vv = sets[next(turn) % len(sets)]
            err = lib.decode_attention_fwd(qq.data_ptr(), kk.data_ptr(), vv.data_ptr(),
                                           out.data_ptr(), part.data_ptr(), cnt.data_ptr(), b, s,
                                           h, hkv, d, p, 0, d ** -0.5, cap, 1, stream)
            if err:
                raise RuntimeError(f"pos {p}: CUDA error {err}")

        ms = device_ms(run_pos, args.iters)
        nbytes = 2 * b * (p + 1) * hkv * d * 2
        sweep.append({"pos": p, "bytes": nbytes, "device_ms": ms})
        print(f"  sweep pos {p:5d}: {nbytes:9d} B of K and V, device_ms {ms:.5f}, "
              f"{nbytes / ms / 1e6:.1f} GB/s", flush=True)
    print(json.dumps({"ablations": rows, "sweep": sweep}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
