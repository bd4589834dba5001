#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py                  # needs one CUDA card
    python3 chip_smoke.py --profile DIR    # also profile the served model

Phases, each fatal on failure:
 1. the card (``nvidia-smi`` name and power limit), torch/CUDA versions, and
    the build of every CUDA kernel from ``src/repro_torch/kernels/csrc``;
 2. kernels: each kernel against its plain PyTorch version on the card, at
    gemma2-2b's shapes: the largest error of a query row over that row's norm
    must be within ``ref.ROW_REL_TOL``, and planted faults (the plain version
    of a kernel that ignores the window, drops the last 128 keys or ignores
    the cap) must read above it. Kernel, plain and library times from CUDA
    events;
 3. serve: gemma2-2b at full width (random bf16 weights from a seeded
    ``torch.Generator``), batch 2, a 4352-token prompt and 32 greedy decode
    steps through ``repro_torch.launch.serve.serve``. The timed part must make
    26 flash and 26 x 32 decode launches (plus 26 of each in serve's untimed
    warm-up step), and the prefill logits must match
    the same model served through the plain attention.
The line before the last is a JSON ``kernels`` record; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
and prints no result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores,
# fp32 CUDA cores, HBM3 bandwidth.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
ITERS = 20                                   # timed launches per measurement

# gemma2-2b serving shapes of this smoke run
B, PROMPT, STEPS = 2, 4352, 32
H, HKV, D, WINDOW, CAP = 8, 4, 256, 4096, 50.0
CACHE = PROMPT + STEPS


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float, dtype: str):
    t_ops = flops / PEAK_FLOPS[dtype]
    t_mem = nbytes / PEAK_BYTES
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem else "bytes")


def compare(name: str, got, want, faults=()):
    """Hold a kernel's output against its plain version: the largest error of
    a query row over the norm of that row must be within ``ref.ROW_REL_TOL``.
    ``faults`` are (label, plain output of a wrongly written kernel); each must
    read above the limit, or the check could not tell it from a sound kernel.
    Returns (max_abs_err, max_row_rel_err)."""
    import torch
    from repro_torch.kernels import ref
    tol = ref.ROW_REL_TOL[got.dtype]
    err = (got.float() - want.float()).abs().max().item()
    rel = ref.max_row_rel_err(got, want)
    ok = bool(torch.isfinite(got).all()) and rel <= tol
    print(f"  parity {name}: max_row_rel_err={rel:.3e} limit={tol:g} max_abs_err={err:.3e} "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail(f"{name}: kernel disagrees with its plain version")
    for label, wrong in faults:
        r = ref.max_row_rel_err(wrong, want)
        print(f"    planted fault, {label}: max_row_rel_err={r:.3e}", flush=True)
        if not r > tol:
            fail(f"{name}: the planted fault '{label}' reads within the limit")
    return err, rel


def randn(shape, dtype, gen, std: float = 1.0):
    import torch
    x = torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32)
    return (x * std).to(dtype)


def flash_phase(iters: int):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_fwd

    gen = torch.Generator(device="cuda").manual_seed(11)
    # q_std 8 spreads the scores (std 8) so that the cap of 50 bends the largest
    cases = [  # (b, s, h, hkv, d), window, cap, dtype, q_std, timed
        ((B, PROMPT, H, HKV, D), WINDOW, CAP, "bfloat16", 1.0, True),
        ((B, PROMPT, H, HKV, D), 0, CAP, "bfloat16", 1.0, True),
        ((B, PROMPT, H, HKV, D), WINDOW, CAP, "bfloat16", 8.0, False),
        ((2, 1000, 9, 3, 64), 300, 0.0, "float32", 1.0, False),
        ((1, 777, 6, 2, 128), 0, 30.0, "float32", 1.0, False),
        ((2, 1000, 9, 3, 64), 300, 50.0, "bfloat16", 1.0, False),
        ((1, 777, 6, 2, 128), 0, 30.0, "bfloat16", 1.0, False),
        ((2, 300, 4, 2, 16), 16, 50.0, "bfloat16", 1.0, False),   # bf16 on the CUDA cores
    ]
    errs, rows = [], []
    for (b, s, h, hkv, d), w, cap, dt, q_std, timed in cases:
        dtype = getattr(torch, dt)
        q = randn((b, s, h, d), dtype, gen, q_std)
        k = randn((b, s, hkv, d), dtype, gen)
        v = randn((b, s, hkv, d), dtype, gen)
        kw = dict(window=w, logit_cap=cap, scale=d ** -0.5)
        name = (f"flash {dt} (b,s,h,hkv,d)={(b, s, h, hkv, d)} window={w} cap={cap:g} "
                f"q_std={q_std:g}")
        faults = []
        if s == PROMPT:  # the main path's shape
            if q_std == 1.0:
                wrong_w = 0 if w else WINDOW
                faults.append((f"window {wrong_w} instead of {w}",
                               ref.flash_attention(q, k, v, **{**kw, "window": wrong_w})))
            else:
                faults.append(("cap ignored",
                               ref.flash_attention(q, k, v, **{**kw, "logit_cap": 0.0})))
        got = flash_attention_fwd(q, k, v, **kw)
        err = compare(name, got, ref.flash_attention(q, k, v, **kw), faults)
        del faults, got
        if s == PROMPT:
            errs.append(err)
        if not timed:
            continue
        n_keys = sum(min(i + 1, w) if w else i + 1 for i in range(s))
        flops = 4.0 * b * h * n_keys * d
        nbytes = 2.0 * (q.numel() + k.numel()) * q.element_size()
        b_ms, b_by = bound(flops, nbytes, dt)
        ms = time_ms(lambda: flash_attention_fwd(q, k, v, **kw), iters)
        plain = time_ms(lambda: ref.flash_attention(q, k, v, **kw), max(2, iters // 4))
        # yardstick only, never called by the port: causal SDPA, no window, no cap
        qt = q.transpose(1, 2).contiguous()
        kt = k.repeat_interleave(h // hkv, dim=2).transpose(1, 2).contiguous()
        vt = v.repeat_interleave(h // hkv, dim=2).transpose(1, 2).contiguous()
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, scale=d ** -0.5), iters)
        print(f"  time {name}: kernel_ms={ms:.4f} plain_ms={plain:.4f} library_ms={lib:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by}; {flops:.4e} FLOP, {nbytes:.4e} B) "
              f"bound/kernel={b_ms / ms:.4f}", flush=True)
        rows.append((ms, plain, lib, b_ms, b_by))
    return tuple(max(e[i] for e in errs) for i in range(2)), rows


def decode_phase(iters: int):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_fwd

    gen = torch.Generator(device="cuda").manual_seed(12)
    dt, dtype = "bfloat16", torch.bfloat16
    # 4 cache sets (4 x 36 MB) cycled while timing, so that the 50 MB L2 does
    # not hold the cache a launch reads, as it does not in the serve loop
    sets = [(randn((B, 1, H, D), dtype, gen), randn((B, CACHE, HKV, D), dtype, gen),
             randn((B, CACHE, HKV, D), dtype, gen)) for _ in range(4)]
    q8 = randn((B, 1, H, D), dtype, gen, 8.0)   # scores of std 8: the cap bends them
    cases = [(pos, w, sets[0][0]) for pos in (0, PROMPT - 1, CACHE - 1) for w in (WINDOW, 0)]
    cases.append((CACHE - 1, WINDOW, q8))
    errs, rows = [], []
    for pos, w, q in cases:
        _, kc, vc = sets[0]
        kw = dict(window=w, logit_cap=CAP, scale=D ** -0.5)
        plain_q = q is not q8
        name = (f"decode {dt} B={B} cache={CACHE} H={H} Hkv={HKV} D={D} pos={pos} window={w} "
                f"cap={CAP:g} q_std={1 if plain_q else 8}")
        faults = []
        if plain_q and pos >= 128:
            wrong_w = 0 if w else WINDOW
            faults = [(f"window {wrong_w} instead of {w}",
                       ref.decode_attention(q, kc, vc, pos, **{**kw, "window": wrong_w})),
                      ("last 128 keys dropped",
                       ref.decode_attention(q, kc, vc, pos - 128,
                                            **{**kw, "window": max(w - 128, 0)}))]
        elif not plain_q:
            faults = [("cap ignored",
                       ref.decode_attention(q, kc, vc, pos, **{**kw, "logit_cap": 0.0}))]
        errs.append(compare(name, decode_attention_fwd(q, kc, vc, pos, **kw),
                            ref.decode_attention(q, kc, vc, pos, **kw), faults))
        if not plain_q or pos != CACHE - 1:
            continue
        lo = max(0, pos - w + 1) if w else 0
        n = pos - lo + 1
        flops = 4.0 * B * H * n * D
        nbytes = (2.0 * B * n * HKV * D + 2.0 * q.numel()) * q.element_size()
        b_ms, b_by = bound(flops, nbytes, dt)
        it = iter(range(1 << 30))

        def run_kernel():
            qq, kk, vv = sets[next(it) % len(sets)]
            decode_attention_fwd(qq, kk, vv, pos, **kw)

        def run_plain():
            qq, kk, vv = sets[next(it) % len(sets)]
            ref.decode_attention(qq, kk, vv, pos, **kw)

        ms = time_ms(run_kernel, iters * 4)
        plain = time_ms(run_plain, iters)
        libs = [(qq.transpose(1, 2).contiguous(),
                 kk[:, lo:pos + 1].repeat_interleave(H // HKV, dim=2).transpose(1, 2).contiguous(),
                 vv[:, lo:pos + 1].repeat_interleave(H // HKV, dim=2).transpose(1, 2).contiguous())
                for qq, kk, vv in sets]

        def run_lib():  # yardstick only: SDPA over the keys in range, no cap
            qq, kk, vv = libs[next(it) % len(libs)]
            F.scaled_dot_product_attention(qq, kk, vv, scale=D ** -0.5)

        lib = time_ms(run_lib, iters * 4)
        print(f"  time {name}: kernel_ms={ms:.5f} plain_ms={plain:.5f} library_ms={lib:.5f} "
              f"bound_ms={b_ms:.5f} ({b_by}; {flops:.4e} FLOP, {nbytes:.4e} B) "
              f"bound/kernel={b_ms / ms:.4f}", flush=True)
        rows.append((ms, plain, lib, b_ms, b_by))
    return tuple(max(e[i] for e in errs) for i in range(2)), rows


def serve_phase():
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve

    run = get_config("gemma2-2b")
    n_layers = run.model.n_layers
    ops.reset_launch_counts()
    res = serve(run, batch=B, prompt_len=PROMPT, decode_steps=STEPS, device="cuda", seed=0)
    counts = ops.launch_counts()
    print("  serve " + json.dumps({k: res[k] for k in (
        "arch", "device", "prefill_s", "decode_s", "decode_tok_per_s", "kernel_launches")}),
        flush=True)
    print(f"  serve tokens[0]={res['tokens'][0].tolist()}", flush=True)
    print(f"  serve tokens[1]={res['tokens'][1].tolist()}", flush=True)
    # timed part: one prefill and STEPS decode steps; serve() also runs one
    # untimed warm-up prefill and decode step before it
    want = {"flash_attention": n_layers, "decode_attention": n_layers * STEPS}
    want_all = {k: v + n_layers for k, v in want.items()}
    if res["kernel_launches"] != want or counts != want_all:
        fail(f"launch counts {res['kernel_launches']} timed, {counts} in all; "
             f"expected {want} and {want_all}")
    toks, logits = res["tokens"], res["prefill_logits"]
    if toks.shape != (B, STEPS + 1) or toks.min() < 0 or toks.max() >= run.model.vocab_size:
        fail(f"sampled tokens out of shape or range: {toks.shape}")
    if logits.shape != (B, 1, run.model.vocab_size) or not torch.isfinite(logits).all():
        fail("prefill logits not finite or of the wrong shape")

    plain = serve(run, batch=B, prompt_len=PROMPT, decode_steps=STEPS, device="cuda", seed=0,
                  use_kernel=False)
    if any(plain["kernel_launches"].values()):
        fail("the plain path launched a kernel")
    # Both paths keep attention in fp32 and round its output to bf16; they differ
    # only where an fp32 sum in another order flips a bf16 rounding, which then
    # travels through 26 bf16 layers. Tolerance: 2e-2 of the largest |logit|
    # (about five bf16 ulps at that magnitude).
    err = (logits - plain["prefill_logits"]).abs().max().item()
    scale = plain["prefill_logits"].abs().max().item()
    agree = float((toks == plain["tokens"]).mean())
    print(f"  serve prefill logits vs plain attention: max_abs_err={err:.4e} "
          f"max|logit|={scale:.4e} rel={err / scale:.4e} tol_rel=2e-2; "
          f"greedy tokens equal to the plain path's: {agree:.4f} "
          f"(plain prefill_s={plain['prefill_s']:.4f}, "
          f"decode_tok_per_s={plain['decode_tok_per_s']:.2f})", flush=True)
    if not err <= 2e-2 * scale:
        fail("served prefill logits disagree with the plain attention path")
    return counts


def profile_phase(out_dir: Path) -> None:
    """torch.profiler over one prefill and 8 decode steps of the served model:
    device time by kernel and the device's busy share of the wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.common.config import ShapeSpec
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model, synthetic_batch
    from repro_torch.train.steps import make_decode_step, make_prefill_step

    run = get_config("gemma2-2b")
    model = build_model(run, device="cuda")
    model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    prompt = synthetic_batch(run.model, ShapeSpec("serve", PROMPT, B, "prefill"), seed=1,
                             device="cuda")
    cache = model.init_cache(B, CACHE, dtype=torch.bfloat16)
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    logits, _ = prefill(prompt, cache)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]

    def decode8():
        for i in range(8):
            decode({"tokens": tok}, cache, PROMPT + i)

    decode8()
    out_dir.mkdir(parents=True, exist_ok=True)
    for label, fn in (("prefill", lambda: prefill(prompt, cache)), ("decode_x8", decode8)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        # device-side events only: the CPU ops also carry their kernels' time
        dev = sorted(((e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA), reverse=True)
        busy = sum(d[0] for d in dev)
        print(f"  profile {label}: wall_ms={wall_us / 1e3:.3f} (profiled) "
              f"device_busy_ms={busy / 1e3:.3f} busy_share={busy / wall_us:.4f}", flush=True)
        for us, n, key in dev[:8]:
            print(f"    {us / 1e3:10.3f} ms {us / busy:7.2%} x{n:<5d} {key[:90]}", flush=True)
        (out_dir / f"profile_{label}.txt").write_text(
            prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", type=Path, default=None, metavar="DIR",
                    help="also profile the served model; tables go to DIR")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs on the card only")
    from repro_torch.kernels import _build

    card = card_line()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind} x{count}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    secs = _build.build_all()
    print(f"[build] {len(_build.KERNELS)} kernels in {secs:.2f} s "
          f"into {_build.BUILD_DIR.relative_to(ROOT)}", flush=True)
    for name in _build.KERNELS:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                print(f"  {name}: {line.strip()}", flush=True)

    t0 = time.perf_counter()
    print("[kernels]", flush=True)
    flash_err, flash_rows = flash_phase(ITERS)
    decode_err, decode_rows = decode_phase(ITERS)
    print(f"[kernels] done in {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    print("[serve]", flush=True)
    counts = serve_phase()
    print(f"[serve] done in {time.perf_counter() - t0:.1f} s", flush=True)
    if args.profile is not None:
        print("[profile]", flush=True)
        profile_phase(args.profile)

    def entry(name, source, replaces, err, rows):
        # one local-window and one global launch of the main path, averaged
        mean = [sum(r[i] for r in rows) / len(rows) for i in range(4)]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": counts[name], "max_abs_err": err[0], "max_row_rel_err": err[1],
                "ms": mean[0], "plain_ms": mean[1], "bound_ms": mean[3],
                "bound_by": rows[0][4], "library_ms": mean[2]}

    print(card, flush=True)
    print(json.dumps({"kernels": [
        entry("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention.py:88", flash_err, flash_rows),
        entry("decode_attention", "src/repro_torch/kernels/csrc/decode_attention.cu",
              "src/repro/kernels/decode_attention.py:70", decode_err, decode_rows),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
