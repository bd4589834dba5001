"""Ablation of the bf16 flash kernel's design choices, on the card.

    PYTHONPATH=src python -m repro_torch.kernels.ablate_flash [--iters N]
        [--shape gemma2-2b|stablelm-12b]

Builds ``csrc/flash_attention.cu`` as it is and, beside it, copies with one
choice undone each (``ABLATIONS``), all with the flags of ``_build``, into
``build/ablate/``. Each build is held against ``ref.flash_attention`` per row
within ``ROW_REL_TOL`` and timed at a prefill shape (``SHAPES``: gemma2-2b's
B=2, S=4352, H=8 on 4 kv heads, D=256, cap 50, window 4096 and full;
stablelm-12b's 32 heads on 8, D=160, no cap, full), by device time from
torch.profiler, in turns: kernel as it is, each ablation, kernel as it is.
Prints one line a build and a JSON list last. Needs a CUDA card; used nowhere
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

SOURCE = _build.CSRC / "flash_attention.cu"
OUT = _build.BUILD_DIR / "ablate"

_STAGED = "    // stage O in this warpgroup's Q rows"
_DIRECT = """#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row >= rows || qpos[r] - q_off >= S) continue;
      const int h = kvh * group + row % group;
      bf16* orow = o + (((long long)b * S + qpos[r] - q_off) * H + h) * D + 2 * t;
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(orow + 8 * n) =
            pack_bf16(acc[4 * n + 2 * r] * inv, acc[4 * n + 2 * r + 1] * inv);
    }
"""


def _direct_epilogue(src: str) -> str:
    a = src.index(_STAGED)
    b = src.index("  }\n}\n\ntemplate <int D>\ncudaError_t launch_wgmma", a)
    return src[:a] + _DIRECT + src[b:]


def _sub(old: str, new: str):
    def edit(src: str) -> str:
        if old not in src:
            raise ValueError(f"ablation target not in the source: {old!r}")
        return src.replace(old, new)
    return edit


# name -> (what is undone, edit of the source)
ABLATIONS = {
    "tanhf": ("tanhf for the cap instead of tanh.approx",
              _sub("tanh_approx(s[e] * pre)", "tanhf(s[e] * pre)")),
    "exp2f": ("exp2f in the softmax instead of ex2.approx",
              _sub("= ex2_approx(", "= exp2f(")),
    "no_pingpong": ("the consumers issue in any order (no named-barrier turns)",
                    lambda s: _sub("named_arrive(their_turn);", ";")(
                        _sub("named_sync(my_turn);", ";")(s))),
    "direct_epilogue": ("O stored from registers in 4-byte pieces, not staged",
                        _direct_epilogue),
    "cuda_cores_160": ("bf16 head_dim 160 on the fp32 CUDA-core kernel (the first draft), not wgmma",
                       _sub("    if (D == 160) return (int)launch_wgmma<160>(ARGS, window, scale, "
                            "cap, st);\n", "")),
}

# prefill shapes: (b, s, h, hkv, d, cap, windows)
SHAPES = {"gemma2-2b": (2, 4352, 8, 4, 256, 50.0, (4096, 0)),
          "stablelm-12b": (2, 4352, 32, 8, 160, 0.0, (0,))}


def build(names):
    """Write and compile every variant in parallel; returns {name: .so path}."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = SOURCE.read_text()
    procs = {}
    for name in names:
        cu = OUT / f"{name}.cu"
        cu.write_text(src if name == "kernel" else ABLATIONS[name][1](src))
        so = OUT / f"{name}.so"
        procs[name] = (so, subprocess.Popen(
            _build.nvcc_command(cu, so),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        libs[name] = so
    return libs


def _fn(so: Path):
    fn = ctypes.CDLL(str(so)).flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def device_ms(run, iters: int) -> float:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / iters / 1e3


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--shape", choices=sorted(SHAPES), default="gemma2-2b")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: the ablation runs on the card only", file=sys.stderr)
        return 1
    b, s, h, hkv, d, cap, windows = SHAPES[args.shape]
    order = ["kernel", *ABLATIONS, "kernel"]
    libs = build(dict.fromkeys(order))
    gen = torch.Generator(device="cuda").manual_seed(11)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").bfloat16()
               for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d)))
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    want = {w: ref.flash_attention(q, k, v, window=w, logit_cap=cap, scale=d ** -0.5)
            for w in windows}
    tol = ref.ROW_REL_TOL[torch.bfloat16]
    rows = []
    for name in order:
        fn = _fn(libs[name])

        def run(w):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, s, 0, h,
                     hkv, d, w, d ** -0.5, cap, 1, stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")

        row = {"build": name, "undone": ABLATIONS[name][0] if name in ABLATIONS else None,
               "shape": args.shape}
        for w in windows:
            run(w)
            torch.cuda.synchronize()
            rel = ref.max_row_rel_err(out, want[w])
            if not (rel <= tol and bool(torch.isfinite(out).all())):
                raise RuntimeError(f"{name} window {w}: max_row_rel_err {rel} above {tol}")
            row[f"window_{w}"] = {"device_ms": device_ms(lambda: run(w), args.iters),
                                  "max_row_rel_err": rel}
        rows.append(row)
        times = ", ".join(f"window {w} {row[f'window_{w}']['device_ms']:.4f}" for w in windows)
        print(f"  {name:16s} {args.shape} device_ms {times}; max_row_rel_err "
              f"{max(row[f'window_{w}']['max_row_rel_err'] for w in windows):.3e}  "
              f"{row['undone'] or ''}", flush=True)
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
