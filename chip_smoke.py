#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py                  # needs one CUDA card
    python3 chip_smoke.py --profile DIR    # also profile serving and one train step

Phases, each fatal on failure:
 1. the card (``nvidia-smi`` name and power limit), torch/CUDA versions, and
    the build of every CUDA kernel from ``src/repro_torch/kernels/csrc``;
 2. kernels: each kernel against its plain PyTorch version on the card, at
    gemma2-2b's shapes: the largest error of a row over that row's norm must
    be within ``ref.ROW_REL_TOL``, and planted faults (the plain version of a
    kernel that ignores the window, drops the window's first 64 keys or the
    last 128 keys, or ignores the cap; of a split decode kernel that loses
    one split or counts a 64-key tile twice; of an RMSNorm that applies scale
    instead of 1 + scale, subtracts the row mean or leaves 4 features out of
    the mean) must read above it; RMSNorm also from 1 to 8704 rows, at
    mixed dtypes, on one-element pieces and up to width 8192; the RMSNorm
    gradient against autograd of the plain version; two decode calls on the
    same inputs bit-equal, and decode parity again on another cache set
    after its timed launches. At RMSNorm's decode shape, an empty kernel's
    device time (the floor of a launch) and the host path by events: the
    wrapper, the model's entry under no_grad, and F.rms_norm.
    Kernel, plain and library times from CUDA events, the
    kernel's and the library call's device time from torch.profiler (each
    kernel's mean a launch times the launches of one call; a launched kernel
    missing from the wrapper's name list fails the run; a profiled window
    of which the profiler recorded nothing is profiled again, up to 8
    times, and the time then reads "not measured"), and the flash
    kernel's achieved TFLOP/s;
 3. serve: gemma2-2b at full width (random bf16 weights from a seeded
    ``torch.Generator``), batch 2, a 4352-token prompt and 32 greedy decode
    steps through ``repro_torch.launch.serve.serve``. The timed part must make
    26 flash, 26 x 32 decode and 105 x 33 RMSNorm launches (plus 26, 26 and
    210 in serve's untimed warm-up step), and the prefill logits must match
    the same model served through the plain attention and norms;
 4. train: gemma2-2b at full width, seq 4096, global batch 2 (the config's
    256 cut to one card), 2 microbatches, remat full, AdamW, through
    ``repro_torch.train.trainer.Trainer`` for 3 steps. Loss and grad norm of
    the first batch must match the plain norms; each step must make 2 x (105
    + 104) RMSNorm launches; losses must be finite; the step-0 checkpoint
    restored from disk must equal the initial weights bit for bit;
 5. detect: the C4D detection loop (``repro_torch.core``) at 100,000 ranks
    (``RingJobTelemetry``, seed 3: 3M transports in 300k pair groups, 1M
    heartbeats). Each detection kernel (``window_score``, its prefilter
    ``row_select`` entry, ``slow_fold``) must be bit-equal to its plain
    version on the card, and planted faults (a median by the lower middle,
    a row max started at 0, a hang median one order statistic off) must
    read unequal; the row select also at every tier (groups of 10 to
    20,000, and 70,000 windows in one call) on signed, zero, NaN and
    infinite samples, where a median by the raw int64 bit pattern must read
    unequal; ``slow_fold`` also on shuffled keys, a run of 100 groups
    across warps, NaN of both signs and +-0.0, ranks with no row or column
    groups, and batches on shared and on own keys, where a NaN with the sign
    bit ranked lowest (the first design's key) must read unequal; device times (4 copies of the inputs cycled, so that the L2
    holds none) against the bytes bound and ``torch.sort``, for the
    prefilter's edge-wait and node groups too, and for the batched kernels
    as ``ingest_batch`` launches them (1,024 ranks x 8 windows).
    At 1,024 ranks the card's verdicts on the ten golden windows, a
    12-window stream (with and without an operating point, baseline
    arrays included) and ``ingest_batch`` must equal the port's NumPy
    composite. ``analyze`` wall times at 1,024, 16,384 and 100,000 ranks,
    split into phases. The main path: a streaming ``C4DMaster`` on the card
    ingests three 100,000-rank windows (a slow source twice, then a hang)
    and must isolate both nodes, through 3 ``window_score``, 6
    ``row_select`` and 2 ``slow_fold`` launches.
They run in the order 1, 2, 5, 3, 4: late in the process (after the train
phase) torch.profiler dropped the records of short profiled windows, so the
detection kernels are timed first.
The line before the last is a JSON ``kernels`` record; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores,
# fp32 CUDA cores, HBM3 bandwidth.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
ITERS = 20                                   # timed launches per measurement
PROFILE_ATTEMPTS = 8                         # profiled windows before "not measured"

# the __global__ functions each wrapper may launch (parts of their names)
FLASH_KERNELS = ("flash_wgmma_kernel", "flash_fwd_kernel")
DECODE_KERNELS = ("decode_tma_kernel", "decode_partial_kernel", "decode_combine_kernel",
                  "decode_merge_kernel")
RMSNORM_KERNELS = ("rmsnorm_block_kernel",)

# gemma2-2b serving shapes of this smoke run
B, PROMPT, STEPS = 2, 4352, 32
H, HKV, D, WINDOW, CAP = 8, 4, 256, 4096, 50.0
CACHE = PROMPT + STEPS
# gemma2-2b training of this smoke run: the config's seq 4096, batch cut to 2
TRAIN_BATCH, TRAIN_STEPS = 2, 3
D_MODEL = 2304


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


def _profiled(fn, calls: int):
    """torch.profiler over ``calls`` calls of ``fn``: {kernel name: (launches
    recorded, device us)} of the device-side events. The profiler at times
    records no event of a whole window (on the H100 machines, more often
    after minutes of load, whether or not the window is padded with idle
    time); such a window is profiled again, up to ``PROFILE_ATTEMPTS``
    times, and {} is returned when none recorded a kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        got = {e.key: (e.count, e.self_device_time_total) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.count > 0}
        if any(not _is_copy(k) for k in got):
            if attempt > 1:
                print(f"    profiler: a window of {calls} call(s) recorded at attempt {attempt}",
                      flush=True)
            return got
    print(f"    profiler: no kernel recorded in {PROFILE_ATTEMPTS} windows of {calls} call(s)",
          flush=True)
    return {}


def _is_copy(key: str) -> bool:
    return key.startswith(("Memcpy", "Memset"))


def device_ms(fn, iters: int, names=None, by_name=None) -> float | None:
    """Device time of one call of ``fn`` (torch.profiler): each kernel's mean
    time a launch over ``iters`` profiled calls, times the launches one call
    makes, summed over the call's kernels. The launches a call makes are
    counted in a profiled call of its own (a library call launches several
    kernels); where the profiler recorded fewer launches than were made, the
    shortfall is printed, and the mean a launch stands. ``names``: the
    kernels ``fn`` launches (parts of their names; copies and memsets aside),
    or None for a library call: a launched kernel that matches none fails
    the run, so that a renamed or added ``__global__`` cannot drop out of
    the sum. ``by_name``, a dict, receives each name's ms per call. None
    (printed "not measured") when no window of ``iters`` calls recorded a
    kernel; a single call that recorded none counts its launches from those
    ``iters`` calls."""
    fn()
    one, many = _profiled(fn, 1), _profiled(fn, iters)
    if not many:
        print("    device time not measured: the profiler recorded no window", flush=True)
        return None
    total, by_calls = 0.0, 0.0
    for key in sorted(set(one) | set(many)):
        hit = [k for k in names if k in key] if names is not None else [key[:60]]
        if not hit:
            if _is_copy(key):
                continue
            fail(f"kernel {key[:120]} was launched but is not in the name list {names}")
        per_call = one.get(key, (0, 0.0))[0]
        count, us = many.get(key, (0, 0.0))
        if count > per_call * iters:  # the single call's count was short
            print(f"    profiler: {per_call} launches of {hit[0]} in one call but {count} in "
                  f"{iters}; taking {-(-count // iters)} a call", flush=True)
            per_call = -(-count // iters)
        elif count < per_call * iters:
            print(f"    profiler: {count} of {per_call * iters} launches of {hit[0]} recorded "
                  f"in {iters} calls", flush=True)
        if count == 0:  # none recorded in the timed calls: the single call's
            count, us = one[key]
        ms = us / count / 1e3 * per_call
        total += ms
        by_calls += us / iters / 1e3 if key in many else 0.0
        if by_name is not None:
            by_name[hit[0]] = by_name.get(hit[0], 0.0) + ms
    if abs(by_calls - total) > 0.01 * total:
        print(f"    device time by the calls made (the earlier rule) would read {by_calls:.5f} ms "
              f"for {total:.5f}", flush=True)
    return total


def _ms(x, digits: int = 5) -> str:
    """A time for a printed line; None (no window recorded) reads so."""
    return "not measured" if x is None else f"{x:.{digits}f}"


def _share(b_ms: float, dev) -> str:
    """bound/device for a printed line."""
    return "not measured" if dev is None else f"{b_ms / dev:.4f}"


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
                if w:  # what a k_begin one key tile too late would read
                    faults.append(("the window's first 64 keys dropped",
                                   ref.flash_attention(q, k, v, **{**kw, "window": w - 64})))
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
        dev = device_ms(lambda: flash_attention_fwd(q, k, v, **kw), iters, FLASH_KERNELS)
        plain = time_ms(lambda: ref.flash_attention(q, k, v, **kw), max(2, iters // 4))
        # yardstick only, never called by the port: causal SDPA, no window, no cap
        qt = q.transpose(1, 2).contiguous()
        kt = k.repeat_interleave(h // hkv, dim=2).transpose(1, 2).contiguous()
        vt = v.repeat_interleave(h // hkv, dim=2).transpose(1, 2).contiguous()
        def run_lib():
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=d ** -0.5)

        lib, lib_dev = time_ms(run_lib, iters), device_ms(run_lib, iters)
        print(f"  time {name}: kernel_ms={ms:.4f} device_ms={_ms(dev, 4)} plain_ms={plain:.4f} "
              f"library_ms={lib:.4f} library_device_ms={_ms(lib_dev, 4)} bound_ms={b_ms:.4f} "
              f"({b_by}; {flops:.4e} FLOP, {nbytes:.4e} B) bound/device={_share(b_ms, dev)} "
              f"achieved {_ms(None if dev is None else flops / dev / 1e9, 1)} TFLOP/s "
              "(device time)", flush=True)
        rows.append((ms, plain, lib, b_ms, b_by, dev, lib_dev))
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
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    errs, rows = [], []
    for pos, w, q in cases:
        _, kc, vc = sets[0]
        kw = dict(window=w, logit_cap=CAP, scale=D ** -0.5)
        plain_q = q is not q8
        lo = max(0, pos - w + 1) if w else 0
        name = (f"decode {dt} B={B} cache={CACHE} H={H} Hkv={HKV} D={D} pos={pos} window={w} "
                f"cap={CAP:g} q_std={1 if plain_q else 8}")
        faults = []
        if plain_q and pos >= 128:
            wrong_w = 0 if w else WINDOW
            # the split kernel's own faults, on its plan for this card: a
            # split lost in the merge, a tile loaded twice
            ranges = ref.plan_splits(lo, pos, n_sm, B, HKV)
            mid = len(ranges) // 2
            faults = [(f"window {wrong_w} instead of {w}",
                       ref.decode_attention(q, kc, vc, pos, **{**kw, "window": wrong_w})),
                      ("last 128 keys dropped",
                       ref.decode_attention(q, kc, vc, pos - 128,
                                            **{**kw, "window": max(w - 128, 0)})),
                      (f"one split's keys dropped (split {mid} of {len(ranges)})",
                       ref.decode_attention_split(q, kc, vc, pos, ranges=ranges[:mid] +
                                                  ranges[mid + 1:], **kw)),
                      ("one 64-key tile counted twice",
                       ref.decode_attention_split(q, kc, vc, pos, ranges=ranges + [
                           (ranges[mid][0], ranges[mid][0] + 63)], **kw))]
        elif not plain_q:
            faults = [("cap ignored",
                       ref.decode_attention(q, kc, vc, pos, **{**kw, "logit_cap": 0.0}))]
        got = decode_attention_fwd(q, kc, vc, pos, **kw)
        errs.append(compare(name, got, ref.decode_attention(q, kc, vc, pos, **kw), faults))
        if not _bit_equal(decode_attention_fwd(q, kc, vc, pos, **kw), got):
            fail(f"{name}: two calls on the same inputs differ")
        if not plain_q or pos != CACHE - 1:
            continue
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
        dev = device_ms(run_kernel, iters * 4, DECODE_KERNELS)
        plain = time_ms(run_plain, iters)
        libs = [(qq.transpose(1, 2).contiguous(),
                 kk[:, lo:pos + 1].repeat_interleave(H // HKV, dim=2).transpose(1, 2).contiguous(),
                 vv[:, lo:pos + 1].repeat_interleave(H // HKV, dim=2).transpose(1, 2).contiguous())
                for qq, kk, vv in sets]

        def run_lib():  # yardstick only: SDPA over the keys in range, no cap
            qq, kk, vv = libs[next(it) % len(libs)]
            F.scaled_dot_product_attention(qq, kk, vv, scale=D ** -0.5)

        lib, lib_dev = time_ms(run_lib, iters * 4), device_ms(run_lib, iters * 4)
        print(f"  time {name}: kernel_ms={ms:.5f} device_ms={_ms(dev)} plain_ms={plain:.5f} "
              f"library_ms={lib:.5f} library_device_ms={_ms(lib_dev)} bound_ms={b_ms:.5f} "
              f"({b_by}; {flops:.4e} FLOP, {nbytes:.4e} B) bound/kernel={b_ms / ms:.4f} "
              f"bound/device={_share(b_ms, dev)} splits={len(ref.plan_splits(lo, pos, n_sm, B, HKV))}"
              f" on {n_sm} SMs", flush=True)
        rows.append((ms, plain, lib, b_ms, b_by, dev, lib_dev))
        # after the timed launches, on another cache set: a stale partial or
        # a counter left non-zero would show here
        qq, kk, vv = sets[2]
        errs.append(compare(name + " again, cache set 2", decode_attention_fwd(qq, kk, vv, pos, **kw),
                            ref.decode_attention(qq, kk, vv, pos, **kw)))
    return tuple(max(e[i] for e in errs) for i in range(2)), rows


def rmsnorm_phase(iters: int):
    import ctypes
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.rmsnorm import rmsnorm_fwd

    gen = torch.Generator(device="cuda").manual_seed(13)
    eps = 1e-6
    path = [(1, 4096, D_MODEL), (B, PROMPT, D_MODEL), (B, 1, D_MODEL)]   # train, prefill, decode
    bf, f32 = "bfloat16", "float32"
    # the JAX suite's shapes; one-element pieces (101 fp32; 100 fp32 is 16-byte
    # pieces); 1 to 8704 rows; mixed dtypes; one piece a thread up to 1024
    # pieces, then two (fp32 4096 and 4100); width 8192
    cases = [(shape, bf, bf) for shape in path] + [
        ((4, 37, 96), f32, f32), ((512, 1024), bf, bf), ((2, 3, 5, 256), f32, f32),
        ((3, 37, 100), f32, f32), ((3, 37, 101), f32, f32),
        *(((rows, D_MODEL), bf, bf) for rows in (1, 2, 4096, 8704)),
        ((B, 1, D_MODEL), bf, f32), ((1, 4096, D_MODEL), bf, f32),
        ((3, 4096), f32, f32), ((3, 4100), f32, f32), ((4, 8192), bf, bf), ((4, 8192), f32, f32)]
    errs, rows = [], []
    for shape, dt, sdt in cases:
        x = randn(shape, getattr(torch, dt), gen)
        scale = randn(shape[-1:], getattr(torch, sdt), gen, 0.1)
        name = f"rmsnorm {dt} x={shape}" + ("" if sdt == dt else f" scale {sdt}")
        faults = []
        if shape == path[0] and sdt == dt:
            faults = [(ref.RMSNORM_FAULTS["scale"], ref.rmsnorm_fault(x, scale, eps, "scale"))]
        elif shape == (3, 37, 100):
            faults = [(ref.RMSNORM_FAULTS["tail4"], ref.rmsnorm_fault(x, scale, eps, "tail4"))]
        err = compare(name, rmsnorm_fwd(x, scale, eps), ref.rmsnorm(x, scale, eps), faults)
        if shape in path:
            errs.append(err)
        if shape == path[0] and sdt == dt:
            # a layer norm differs from an RMSNorm only on rows whose mean is far from 0
            x1 = x + 1.0
            compare(name + " row mean 1", rmsnorm_fwd(x1, scale, eps), ref.rmsnorm(x1, scale, eps),
                    [(ref.RMSNORM_FAULTS["layernorm"],
                      ref.rmsnorm_fault(x1, scale, eps, "layernorm"))])
            grad_check(x, scale, eps, gen)
    extra = {}
    for shape in path:
        dtype = torch.bfloat16
        # 4 input sets cycled, so that the 50 MB L2 does not hold the rows a
        # launch reads (the larger two shapes are 19 and 40 MB an input)
        sets = [(randn(shape, dtype, gen), randn(shape[-1:], dtype, gen, 0.1)) for _ in range(4)]
        weights = [(1.0 + s.float()).to(dtype) for _, s in sets]
        it = iter(range(1 << 30))

        def cycled(fn):
            def run():
                i = next(it) % len(sets)
                fn(sets[i][0], sets[i][1], weights[i])
            return run

        ms = time_ms(cycled(lambda x, s, w: rmsnorm_fwd(x, s, eps)), iters * 4)
        dev = device_ms(cycled(lambda x, s, w: rmsnorm_fwd(x, s, eps)), iters * 4,
                        RMSNORM_KERNELS)
        plain = time_ms(cycled(lambda x, s, w: ref.rmsnorm(x, s, eps)), iters * 4)
        # yardstick only, never called by the port: weight 1 + scale precomputed
        run_lib = cycled(lambda x, s, w: F.rms_norm(x, (shape[-1],), w, eps))
        lib, lib_dev = time_ms(run_lib, iters * 4), device_ms(run_lib, iters * 4)
        n = sets[0][0].numel()
        nbytes = (2.0 * n + shape[-1]) * 2
        b_ms, b_by = bound(4.0 * n, nbytes, "float32")
        print(f"  time rmsnorm bfloat16 x={shape}: kernel_ms={ms:.5f} device_ms={_ms(dev)} "
              f"plain_ms={plain:.5f} library_ms={lib:.5f} library_device_ms={_ms(lib_dev)} "
              f"bound_ms={b_ms:.5f} ({b_by}; {nbytes:.4e} B) bound/kernel={b_ms / ms:.4f} "
              f"bound/device={_share(b_ms, dev)}", flush=True)
        rows.append((ms, plain, lib, b_ms, b_by, dev, lib_dev))
        if shape != path[2]:
            continue
        # the decode shape is bound by the launch: an empty kernel's device
        # time is its floor. And the host path: the wrapper, the model's
        # entry under no_grad, and F.rms_norm, by events, back to back
        lib_so = _build.load("rmsnorm")
        lib_so.rmsnorm_empty.argtypes = [ctypes.c_void_p]
        stream = torch.cuda.current_stream().cuda_stream
        floor = device_ms(lambda: lib_so.rmsnorm_empty(stream), iters * 4,
                          ("rmsnorm_empty_kernel",))
        print(f"    launch floor: empty kernel device_ms={_ms(floor)}; decode shape "
              f"device_ms={_ms(dev)}", flush=True)
        with torch.no_grad():
            ops_ms = time_ms(cycled(lambda x, s, w: ops.rmsnorm(x, s, eps)), iters * 4)
        print(f"    host path at the decode shape (CUDA events, back to back): rmsnorm_fwd "
              f"{ms:.5f} ms, ops.rmsnorm under no_grad {ops_ms:.5f} ms, F.rms_norm {lib:.5f} ms",
              flush=True)
        extra = {"empty_kernel_device_ms": floor, "decode_ops_no_grad_ms": ops_ms}
    return tuple(max(e[i] for e in errs) for i in range(2)), rows, extra


def grad_check(x, scale, eps, gen) -> None:
    """RMSNormFn's gradients (kernel forward, plain backward) against autograd
    of the plain version: dx per row within ROW_REL_TOL, dscale by the
    relative norm of the difference within GRAD_SCALE_TOL."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import RMSNormFn

    dy = randn(x.shape, x.dtype, gen)
    grads = []
    for fn in (lambda a, b: RMSNormFn.apply(a, b, eps), lambda a, b: ref.rmsnorm(a, b, eps)):
        xx, ss = x.clone().requires_grad_(), scale.clone().requires_grad_()
        fn(xx, ss).backward(dy)
        grads.append((xx.grad, ss.grad))
    (dx, ds), (want_dx, want_ds) = grads
    rel_dx = ref.max_row_rel_err(dx, want_dx)
    rel_ds = ref.max_row_rel_err(ds[None], want_ds[None])
    tol = ref.ROW_REL_TOL[x.dtype]
    print(f"  grad rmsnorm {str(x.dtype)[6:]} x={tuple(x.shape)}: dx max_row_rel_err={rel_dx:.3e} "
          f"limit={tol:g}; dscale rel_norm_err={rel_ds:.3e} limit={GRAD_SCALE_TOL:g}", flush=True)
    if not (rel_dx <= tol and rel_ds <= GRAD_SCALE_TOL and torch.isfinite(dx).all()):
        fail("RMSNormFn's gradient disagrees with autograd of the plain version")


# dscale sums dy * x_hat over 4096 rows in fp32 on both sides and rounds to
# bf16 once: they differ by about one bf16 ulp (2^-9 = 2e-3) of a few entries
GRAD_SCALE_TOL = 1e-2


def norms_per_forward(cfg) -> int:
    """RMSNorm launches of one forward: 2 a block (4 with sandwich norms) and
    the final norm."""
    return (4 if cfg.post_block_norm else 2) * cfg.n_layers + 1


def serve_phase():
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve

    run = get_config("gemma2-2b")
    n_layers = run.model.n_layers
    n_norms = norms_per_forward(run.model)
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
    want = {"flash_attention": n_layers, "decode_attention": n_layers * STEPS,
            "rmsnorm": n_norms * (1 + STEPS)}
    want_all = {"flash_attention": 2 * n_layers, "decode_attention": n_layers * (STEPS + 1),
                "rmsnorm": n_norms * (3 + STEPS)}
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
    # Both paths round the attention probabilities to bf16 before PV (the
    # plain path as the JAX CPU lowering does; the flash kernel before its PV
    # wgmma, unnormalised, dividing by the fp32 row sum at the end) and sum
    # the scores and norms in other orders. Both round every op's output to
    # bf16, so they differ where such a difference flips a bf16 rounding,
    # which then travels through 26 bf16 layers. Tolerance: 2e-2 of the
    # largest |logit| (about five bf16 ulps at that magnitude).
    err = (logits - plain["prefill_logits"]).abs().max().item()
    scale = plain["prefill_logits"].abs().max().item()
    agree = float((toks == plain["tokens"]).mean())
    print(f"  serve prefill logits vs the plain path: max_abs_err={err:.4e} "
          f"max|logit|={scale:.4e} rel={err / scale:.4e} tol_rel=2e-2; "
          f"greedy tokens equal to the plain path's: {agree:.4f} "
          f"(plain prefill_s={plain['prefill_s']:.4f}, "
          f"decode_tok_per_s={plain['decode_tok_per_s']:.2f})", flush=True)
    if not err <= 2e-2 * scale:
        fail("served prefill logits disagree with the plain path")
    return counts


def train_phase(profile_dir=None):
    """gemma2-2b through the Trainer; returns the kernels' launch counts of
    the 3 train steps."""
    import torch
    from repro_torch.checkpoint import manager as ckpt_mod
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.common.config import ShapeSpec
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.train.steps import make_grad_fn
    from repro_torch.train.trainer import Trainer

    run = get_config("gemma2-2b")
    run = run.replace(train=dataclasses.replace(run.train, global_batch=TRAIN_BATCH))
    cfg, pcfg = run.model, run.parallel
    shape = ShapeSpec("train", run.train.seq_len, TRAIN_BATCH, "train")
    # per microbatch: every norm of the forward, and the block norms again in
    # the backward's recompute (remat full; the final norm is outside the
    # block checkpoints)
    if pcfg.remat != "full":
        fail(f"the launch count below is derived for remat 'full', not {pcfg.remat!r}")
    n_norms = norms_per_forward(cfg)
    per_step = pcfg.microbatches * (2 * n_norms - 1)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    sha = ckpt_mod._sha
    try:
        t0 = time.perf_counter()
        trainer = Trainer(run, shape, workdir, device="cuda", use_kernel=True)
        print(f"  train {cfg.name}: {trainer.model.num_params():,} params, seq "
              f"{shape.seq_len}, global batch {shape.global_batch} (config: "
              f"{get_config('gemma2-2b').train.global_batch}), microbatches "
              f"{pcfg.microbatches}, remat {pcfg.remat}, {trainer.opt_cfg.kind}; built in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)

        # kernel against plain norms, same weights, first batch, no update
        grad_fn = make_grad_fn(trainer.model, run)
        batch = {k: torch.from_numpy(v).cuda() for k, v in trainer.pipeline.batch(0).items()}
        got = {}
        for use_kernel in (True, False):
            trainer.model.use_kernel = use_kernel
            ops.reset_launch_counts()
            loss, _, grads = grad_fn(trainer.params, batch)
            got[use_kernel] = (loss.item(), adamw.global_norm(grads).item(), ops.launch_counts())
            del grads
        trainer.model.use_kernel = True
        (lk, gk, ck), (lp, gp, cp) = got[True], got[False]
        rel_l, rel_g = abs(lk - lp) / abs(lp), abs(gk - gp) / gp
        print(f"  train kernel vs plain norms, batch 0: loss {lk:.6f} vs {lp:.6f} rel={rel_l:.3e} "
              f"(limit 2e-3); grad_norm {gk:.6f} vs {gp:.6f} rel={rel_g:.3e} (limit 2e-2); "
              f"rmsnorm launches {ck['rmsnorm']} vs {cp['rmsnorm']}", flush=True)
        if not (rel_l <= 2e-3 and rel_g <= 2e-2):
            fail("training loss or grad norm with the RMSNorm kernel disagrees with the "
                 "plain norms")
        if ck["rmsnorm"] != per_step or any(cp.values()):
            fail(f"gradient launches {ck} (kernel) and {cp} (plain); expected {per_step} "
                 "rmsnorm launches and none")

        # the checkpoint's seconds, split into the host copy, np.savez and sha256
        spent = {"save": [], "write": [], "sha": []}

        def timed(fn, key):
            def wrapped(*a, **kw):
                t = time.perf_counter()
                out = fn(*a, **kw)
                spent[key].append(time.perf_counter() - t)
                return out
            return wrapped
        trainer.ckpt.save = timed(trainer.ckpt.save, "save")
        trainer.ckpt._write = timed(trainer.ckpt._write, "write")
        ckpt_mod._sha = timed(sha, "sha")
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        report = trainer.train(TRAIN_STEPS)
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        for i, m in enumerate(report.metrics):
            print(f"  train step {i}: loss={m['loss']:.6f} grad_norm={m['grad_norm']:.6f} "
                  f"lr={m['lr']:.4e} step_s={trainer.monitor.durations[i]:.4f}", flush=True)
        stats = trainer.monitor.summary()
        tok_s = shape.global_batch * shape.seq_len / stats["median_s"]
        ckpt_bytes = sum(t.numel() * t.element_size() for t in trainer.ckpt.memory[0].values())
        npz = os.path.join(workdir, "ckpt_00000000.npz")
        print(f"  train {TRAIN_STEPS} steps in {wall:.2f} s: median_step_s={stats['median_s']:.4f} "
              f"tokens_per_s={tok_s:.1f} max_memory_allocated={peak / 1e9:.2f} GB", flush=True)
        save_s, write_s, sha_s = spent["save"][0], spent["write"][0], sum(spent["sha"])
        print(f"  train step-0 checkpoint (blocking): {save_s:.2f} s = host copy "
              f"{save_s - write_s:.2f} + np.savez {write_s - sha_s:.2f} + sha256 {sha_s:.2f}; "
              f"{ckpt_bytes / 1e9:.3f} GB in host RAM, {os.path.getsize(npz) / 1e9:.3f} GB "
              "on disk", flush=True)
        if not all(map(lambda v: v == v and abs(v) < float("inf"), report.losses)):
            fail(f"non-finite training losses {report.losses}")
        want = {"flash_attention": 0, "decode_attention": 0, "rmsnorm": TRAIN_STEPS * per_step}
        if counts != want:
            fail(f"train launch counts {counts}; expected {want}")

        # the step-0 checkpoint from disk (a manager with no memory replica,
        # as after a restart), against an independent init of the weights
        spent["sha"].clear()
        t0 = time.perf_counter()
        step, flat = CheckpointManager(workdir, keep=run.train.keep_checkpoints,
                                       async_disk=False).restore_flat(0)
        t_restore = time.perf_counter() - t0
        sha_s = sum(spent["sha"])
        fresh = build_model(run, device="cuda")
        fresh.init_weights(torch.Generator("cuda").manual_seed(run.train.seed))
        bad = [n for n, p in fresh.named_parameters()
               if not _bit_equal(flat[f"params/{n}"], p.detach().cpu())]
        bad += [k for k, t in flat.items() if k.startswith("opt/") and bool(t.any())]
        bad += [k for k, t in flat.items() if not _bit_equal(t, trainer.ckpt.memory[0][k])]
        del fresh
        print(f"  train restore of step {step} from disk: {t_restore:.2f} s = read "
              f"{t_restore - sha_s:.2f} + sha256 {sha_s:.2f}, {len(flat)} leaves; params "
              "bit-equal to a fresh init from the seed, moments zero, all leaves equal to "
              f"the in-memory replica: {not bad}", flush=True)
        if step != 0 or bad:
            fail(f"the step-0 checkpoint restored from disk differs in {bad[:5]}")
        del flat
        if profile_dir is not None:
            batch = {k: torch.from_numpy(v).cuda() for k, v in trainer.pipeline.batch(3).items()}

            def one_step():
                _, trainer.opt_state, metrics = trainer._step_fn(
                    trainer.params, trainer.opt_state, batch)
                metrics["loss"].item()
            profile_one("train_step", one_step, profile_dir)
        trainer.ckpt.close()
        return counts
    finally:
        ckpt_mod._sha = sha
        shutil.rmtree(workdir, ignore_errors=True)


# --- [detect]: the C4D detection loop at 100,000 ranks ------------------------

DEV = "cuda"
DETECT_RANKS = 100_000                  # the JAX package's largest detection scale
ANALYZE_RANKS = (1024, 16384, DETECT_RANKS)
PARITY_RANKS = 1024
STREAM_WINDOWS, BATCH_WINDOWS = 12, 8
DETECT_ITERS = 10


DETECT_KERNELS = [
    ("window_score", "src/repro_torch/kernels/csrc/window_score.cu",
     "src/repro/core/jaxsim/kernels.py:235"),
    ("row_select", "src/repro_torch/kernels/csrc/window_score.cu",
     "src/repro/core/jaxsim/kernels.py:112"),
    ("slow_fold", "src/repro_torch/kernels/csrc/slow_fold.cu",
     "src/repro/core/jaxsim/kernels.py:175"),
]


def golden_faults():
    """The ten golden windows of tests/test_c4d_vectorized.py (a copy: this
    script imports neither the tests nor the JAX package)."""
    from repro_torch.core.faults import Fault
    return [[], [Fault("slow_src", rank=5)], [Fault("slow_dst", rank=7)],
            [Fault("slow_link", link=(3, 4))], [Fault("straggler", rank=9, severity=20)],
            [Fault("comm_hang", rank=11)], [Fault("noncomm_hang", rank=2)],
            [Fault("crash", rank=30)], [Fault("comm_hang", rank=1), Fault("slow_src", rank=6)],
            [Fault("slow_src", rank=3), Fault("slow_link", link=(10, 11)),
             Fault("straggler", rank=20, severity=25)]]


RS_KERNELS = ("row_select_small", "row_select_warp", "row_select_radix")
WS_KERNELS = ("rank_init", "hb_fold", "group_src", *RS_KERNELS, "rank_stats", "hang_median",
              "rank_deficit")
FOLD_KERNELS = ("fold_kernel",)


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _max_abs(got: dict, want: dict) -> float:
    import torch
    err = 0.0
    for k, w in want.items():
        g, w = got[k].cpu(), w.cpu()
        if g.dtype.is_floating_point:
            fin = torch.isfinite(w)
            if bool(fin.any()):
                err = max(err, (g[fin] - w[fin]).abs().max().item())
    return err


def bit_check(name: str, got: dict, want: dict, faults=()) -> float:
    """Every output of a kernel bit-equal to its plain version's; each
    planted fault (label, key, output of a wrongly written plain version,
    and "bits" to compare every value by its bits, not only the finite
    ones) must differ from the kernel's. Returns the largest |difference|."""
    bad = [k for k in want if not _bit_equal(got[k].cpu(), want[k].cpu())]
    err = _max_abs(got, want)
    print(f"  parity {name}: {len(want)} outputs bit-equal to the plain version: "
          f"{'yes' if not bad else 'NO ' + str(bad)} (max_abs_err={err:.3e})", flush=True)
    if bad:
        fail(f"{name}: the kernel differs from its plain version in {bad}")
    import torch
    for label, key, wrong, *bits in faults:
        g = got[key].reshape(-1)
        w = wrong.reshape(-1).to(g.device)
        if bits:  # every value, by its bits (a fault of NaN handling)
            differ = int((g.view(torch.int64) != w.view(torch.int64)).sum())
            print(f"    planted fault, {label}: {differ} of {g.numel()} values of {key} differ "
                  "in their bits", flush=True)
        else:
            # only where the kernel's value is finite: an empty group's +inf
            # against the fault's NaN would count as a difference of no meaning
            fin = torch.isfinite(g)
            differ = int((g[fin] != w[fin]).sum())
            print(f"    planted fault, {label}: {differ} of {int(fin.sum())} finite values of "
                  f"{key} differ", flush=True)
        if differ == 0:
            fail(f"{name}: the planted fault '{label}' reads equal to the kernel")
    return err


def lower_middle(values, order, starts, counts):
    """Planted fault: per-group medians by torch's convention (the lower of
    the two middles; NaN padding ignored). (V, B, G)."""
    import torch
    from repro_torch.core.torchsim.kernels import padded_rows
    rows = padded_rows(values, order, starts, counts, float("nan"))
    return torch.nanmedian(rows, dim=-1).values.transpose(0, 1).contiguous()


def window_inputs(w, n: int, hb_seq=None):
    """A window packed as the scorer packs it, its tensors on the card:
    (values, order, starts, counts, gkey, hb_rank, hb_seq, offsets, grace)."""
    import numpy as np
    import torch
    from repro_torch.core.torchsim import detectors as tdet
    pw = tdet._PackedWindow(w, n, None)
    lay = pw.layout
    lt = lay.device_tensors(torch.device(DEV))
    up = [torch.from_numpy(np.ascontiguousarray(a)).to(DEV)[None]
          for a in (pw.values, pw.hb_rank, pw.hb_seq if hb_seq is None else hb_seq,
                    pw.offsets)]
    args = (up[0], lt["order"], lt["starts"], lt["counts"], lt["gkey"], *up[1:], 3.0)
    return lay, lt, args, dict(n=n)


def detect_kernels(iters: int):
    """Kernel parity, planted faults, and device times at 100,000 ranks."""
    import numpy as np
    import torch
    from repro_torch.core.c4d.detector import DetectorConfig
    from repro_torch.core.c4d.telemetry import grouped_median
    from repro_torch.core.faults import Fault, RingJobTelemetry
    from repro_torch.core.torchsim import detectors as tdet
    from repro_torch.core.torchsim import kernels as tk
    from repro_torch.kernels import slow_fold as sf
    from repro_torch.kernels import window_score as ws

    n = DETECT_RANKS
    cfg = DetectorConfig()
    tel = RingJobTelemetry(n_ranks=n, seed=3)
    t0 = time.perf_counter()
    wins = {"clean": tel.window_arrays(0, []),
            "slow_src 5 + comm_hang 11": tel.window_arrays(
                1, [Fault("slow_src", rank=5), Fault("comm_hang", rank=11)]),
            "slow_src 5": tel.window_arrays(2, [Fault("slow_src", rank=5)])}
    w0 = wins["clean"]
    print(f"  {n} ranks: {w0.tr_src.size:,} transports, {w0.hb_rank.size:,} heartbeats a "
          f"window ({time.perf_counter() - t0:.2f} s to make 3 windows)", flush=True)
    errs = {"window_score": 0.0, "row_select": 0.0, "slow_fold": 0.0}
    for label, w in wins.items():
        lay, lt, args, kw = window_inputs(w, n)
        kk = dict(kw, large=lt["large"], max_count=lay.max_count)
        got = ws.window_score(*args, **kk)
        want = tk.fused_window_kernel(*args, **kw)
        faults = []
        if label == "clean":
            low = lower_middle(args[0], *args[1:4])
            faults = [("median by the lower middle (torch.median)", "dmed", low[0])]
            print(f"    window: {lay.g:,} groups of up to {lay.max_count}, "
                  f"{args[5].shape[1]:,} heartbeats, {n:,} ranks (no padding)", flush=True)
        errs["window_score"] = max(errs["window_score"],
                                   bit_check(f"window_score, {label}", got, want, faults))
        hung = got["hung"][0].nonzero().flatten().tolist()
        print(f"    hung ranks {hung}", flush=True)
        if ("comm_hang" in label) != (hung == [11]):
            fail(f"window_score: hung ranks {hung} in the window '{label}'")
        if label != "slow_src 5":
            continue
        # the fold, on the hang-free faulted window, centers/scales from NumPy
        dmed, wmed = got["dmed"][0].cpu().numpy(), got["wmed"][0].cpu().numpy()
        cs = [*tdet._mixed_center_scale(dmed, lay.gkey, n, None, "delay"),
              *tdet._mixed_center_scale(wmed, lay.gkey, n, None, "wait")]
        fargs = (lt["gkey"], got["dmed"], got["wmed"],
                 *(torch.from_numpy(a).to(DEV)[None] for a in cs),
                 cfg.mad_threshold, cfg.row_col_fraction, cfg.min_observations)
        fgot = sf.slow_fold(*fargs, n=n)
        fwant = tk.slow_fold_kernel(*fargs, n=n)
        zero_init = torch.zeros((1, n), dtype=torch.float64, device=DEV).scatter_reduce(
            1, lt["gkey"] // n, fwant["zd"], "amax", include_self=True)
        errs["slow_fold"] = bit_check(
            "slow_fold, slow_src 5", fgot, fwant,
            [("row max started at 0, not -inf", "row_score", zero_init)])
        rows = fgot["row_sel"][0].nonzero().flatten().tolist()
        print(f"    row_sel ranks {rows[:8]}{' ...' if len(rows) > 8 else ''} "
              f"({len(rows)}); points {int(fgot['point'].sum())}", flush=True)
        if 5 not in rows:
            fail("slow_fold: the slow source rank 5 is not selected")
        fold_case = (fargs, lay)

    # the hang median on distinct seqs (the telemetry's are all equal but one)
    rng = np.random.default_rng(7)
    lay, lt, args, kw = window_inputs(w0, n, rng.permutation(1 << 21)[:w0.hb_rank.size])
    kk = dict(kw, large=lt["large"], max_count=lay.max_count)
    got = ws.window_score(*args, **kk)
    want = tk.fused_window_kernel(*args, **kw)
    seqs_f = want["seqs"].double()
    s = torch.sort(torch.where(want["present"], seqs_f, float("inf")), dim=1).values
    c = int(want["present"].sum())
    off_by_one = 0.5 * (s[0, (c - 1) // 2 + 1] + s[0, c // 2 + 1])
    errs["window_score"] = max(errs["window_score"], bit_check(
        "window_score, distinct seqs", got, want,
        [("hang median one order statistic off", "med", off_by_one.reshape(1))]))

    # the prefilter's row select: edge waits (10 a group, a thread each) and
    # per-node absolute deviations (240 a group, a warp each)
    transfer, wait = w0.tr_transfer(), w0.tr_wait()
    node = w0.tr_src // 8
    _, node_med, _, idx = grouped_median(node, transfer, return_groups=True)
    absdev = np.abs(transfer - node_med[idx])
    edge = w0.tr_src * n + w0.tr_dst
    rs_cases = {}
    for label, keys, vals in (("edge wait", edge, wait),
                              ("node |transfer - median|", node, absdev)):
        uk, med = grouped_median(keys, vals, backend="torch", device=DEV)
        gk, pmed, _, valid = tk.grouped_median_kernel(torch.from_numpy(keys).to(DEV),
                                                      torch.from_numpy(vals).to(DEV))
        lay = tdet._layout_for(keys)
        lt = lay.device_tensors(torch.device(DEV))
        v = torch.from_numpy(vals).to(DEV).view(1, 1, -1)
        low = lower_middle(v, lt["order"], lt["starts"], lt["counts"])[0, 0, :lay.g]
        got = {"gkey": torch.from_numpy(uk), "median": torch.from_numpy(med).to(DEV)}
        want = {"gkey": gk[valid].cpu(), "median": pmed[valid]}
        errs["row_select"] = max(errs["row_select"], bit_check(
            f"row_select (prefilter), {label}: {lay.g:,} groups of {lay.max_count}", got, want,
            [("median by the lower middle (torch.median)", "median", low)]))
        rs_cases[label] = (v, lt, lay)
    errs["row_select"] = max(errs["row_select"], signed_tiers())
    errs["slow_fold"] = max(errs["slow_fold"], fold_edge_cases())

    rows = {}
    # window_score: the clean window, layout cached, inputs on the card. The
    # bound counts each input and output once at the window's own sizes
    lay, lt, args, kw = window_inputs(w0, n)
    rows["window_score"] = window_row("window_score", args,
                                      dict(kw, large=lt["large"], max_count=lay.max_count), iters)
    for key, case, label in (("row_select", "edge wait", "edge wait"),
                             ("row_select_node", "node |transfer - median|", "node groups")):
        v, lt, lay = rs_cases[case]
        rows[key] = row_select_row(f"row_select (prefilter {label}, {lay.g:,} groups of up to "
                                   f"{lay.max_count})", v, lt, lay, iters)
    fargs, lay = fold_case
    rows["slow_fold"] = fold_row("slow_fold", fargs, n, iters)
    return errs, rows


def fold_edge_cases() -> float:
    """``slow_fold`` bit-equal to its plain version on the inputs of
    ``detect_ref.fold_cases``: keys shuffled, a run of 100 groups across
    warps, NaN of both signs and +-0.0 among the medians, ranks with no row
    or no column groups, batches on shared and on own keys. Planted faults:
    a row max started at 0, and where the card's arithmetic leaves a NaN
    with the sign bit in zd, the first design's signed order key, which
    ranks such a NaN lowest. Returns the largest |difference|."""
    import torch
    from repro_torch.kernels import detect_ref
    from repro_torch.kernels import slow_fold as sf

    err = 0.0
    for case in detect_ref.FOLD_CASES:
        gkey, *vals, n = detect_ref.fold_cases(case)
        args = [torch.from_numpy(a).to(DEV) for a in (gkey, *vals)]
        got = sf.slow_fold(*args, 1.5, 0.6, 1, n=n)
        want = detect_ref.slow_fold_kernel(*args, 1.5, 0.6, 1, n=n)
        seg = args[0].expand(args[1].shape) // n
        zero_init = torch.zeros_like(want["row_score"]).scatter_reduce(
            1, seg, want["zd"], "amax", include_self=True)
        faults = [("row max started at 0, not -inf", "row_score", zero_init)]
        neg_nan = int((torch.isnan(want["zd"]) & torch.signbit(want["zd"])).sum())
        if case == "NaN and signed zeros":
            print(f"    {neg_nan} zd values are NaN with the sign bit on this card", flush=True)
            if neg_nan:
                faults.append(("a NaN with the sign bit ranked lowest (the first design's key)",
                               "row_score", signed_key_max(seg, want["zd"], n), "bits"))
        err = max(err, bit_check(f"slow_fold, {case}", got, want, faults))
    return err


def signed_key_max(seg, zd, n):
    """Planted fault: the row max on the first design's signed order key
    (negatives' bits but the sign flipped), under which a NaN with the sign
    bit falls below -inf and drops out."""
    import torch
    flip = 0x7FFFFFFFFFFFFFFF
    bits = zd.view(torch.int64)
    key = torch.where(bits < 0, bits ^ flip, bits)
    neg_inf = torch.tensor([float("-inf")], dtype=torch.float64).view(torch.int64).item() ^ flip
    start = torch.full((zd.shape[0], n), neg_inf, dtype=torch.int64, device=zd.device)
    m = start.scatter_reduce(1, seg, key, "amax", include_self=True)
    return torch.where(m < 0, m ^ flip, m).view(torch.float64)


# input sets a timed detection call cycles through, so that the 50 MB L2
# does not hold the inputs a launch reads (they are 3-100 MB), as it does
# not on the main path, which scores a window every few seconds
SETS = 4


def cycling(fn, *tensors):
    """A call of ``fn`` on one of ``SETS`` copies of ``tensors`` in turn
    (non-tensors are shared)."""
    import itertools
    import torch
    sets = [tensors] + [tuple(t.clone() if isinstance(t, torch.Tensor) else t for t in tensors)
                        for _ in range(SETS - 1)]
    turn = itertools.count()
    return lambda: fn(*sets[next(turn) % SETS])


def window_row(name, args, kk, iters, where=None):
    """The timed row of ``window_score`` on packed inputs ``args`` and its
    keywords ``kk`` (n, large, max_count); library: sort the padded rows and
    gather the middles."""
    import torch
    from repro_torch.core.torchsim import kernels as tk
    from repro_torch.kernels import window_score as ws
    run = cycling(lambda *a: ws.window_score(*a, **kk), *args)
    plain = lambda: tk.fused_window_kernel(*args, n=kk["n"])       # noqa: E731
    reads = _nbytes(*args[:8], kk["large"])
    writes = _nbytes(*run().values())
    vmat = tk.padded_rows(args[0], *args[1:4], float("inf"))       # (B, 2, g, max_count)
    lo_i = torch.clamp((args[3] - 1) // 2, min=0)[:, None, :, None].expand(
        vmat.shape[0], 2, -1, 1)
    # yardstick only: sort the rows, gather the two middles
    library = cycling(lambda m: torch.take_along_dim(
        torch.sort(m.view(torch.int64), dim=-1).values, lo_i, dim=-1), vmat)
    return timed(name, run, plain, library, reads + writes, WS_KERNELS, iters,
                 f"{tuple(vmat.shape)} torch.sort + gather", where)


def row_select_row(name, v, lt, lay, iters):
    """The timed row of the prefilter's row select on values ``v`` (1, 1, T)."""
    import torch
    from repro_torch.core.torchsim import kernels as tk
    from repro_torch.kernels import window_score as ws
    layout = (lt["order"], lt["starts"], lt["counts"])
    run = cycling(lambda *a: ws.row_select(*a, large=lt["large"], max_count=lay.max_count),
                  v, *layout)
    plain = lambda: tk.row_median(v, *layout)      # noqa: E731
    vm = tk.padded_rows(v, *layout, float("inf"))[0]
    lo_1 = torch.clamp((lt["counts"][0] - 1) // 2, min=0)[None, :, None]
    # yardstick only: sort the rows, gather the lower middle
    library = cycling(lambda m: torch.take_along_dim(
        torch.sort(m.view(torch.int64), dim=-1).values, lo_1, -1), vm)
    nb = _nbytes(v, *layout, lt["large"]) + 8 * lay.g
    return timed(name, run, plain, library, nb, RS_KERNELS, iters,
                 f"{tuple(vm.shape)} torch.sort + gather")


def fold_row(name, fargs, n, iters, where=None):
    """The timed row of ``slow_fold`` on ``fargs`` (no one library call)."""
    from repro_torch.core.torchsim import kernels as tk
    from repro_torch.kernels import slow_fold as sf
    run = cycling(lambda *a: sf.slow_fold(*a, n=n), *fargs)
    plain = lambda: tk.slow_fold_kernel(*fargs, n=n)    # noqa: E731
    nb = _nbytes(*fargs[:7]) + _nbytes(*run().values())
    return timed(name, run, plain, None, nb, FOLD_KERNELS, iters, None, where)


# groups of these sizes reach every tier of the row select and its edges: a
# thread (up to 16), a warp (up to 512), a CTA in device memory (above)
TIER_SIZES = (10, 16, 17, 240, 512, 513, 20000)


def signed_groups(size: int, seed: int):
    """Five groups of ``size`` samples: mixed signs over 400 decades, all
    negative, signed zeros in both orders, NaN of both signs, +-inf among
    finite values; keys shuffled. Returns (keys, values) as NumPy arrays."""
    import numpy as np
    rng = np.random.default_rng(seed)
    neg_nan = np.array([0xFFF8000000000001], np.uint64).view(np.float64)[0]
    mixed = rng.normal(size=size) * 10.0 ** rng.integers(-200, 200, size)
    neg = -np.abs(rng.normal(size=size)) - 1e-12
    zeros = np.where(rng.random(size) < 0.5, -0.0, 0.0)
    zeros[::5] = rng.normal(size=zeros[::5].size)
    nans = rng.normal(size=size)
    nans[rng.random(size) < 0.4] = np.nan
    nans[rng.random(size) < 0.2] = neg_nan
    infs = rng.normal(size=size)
    infs[rng.random(size) < 0.3] = np.inf
    infs[rng.random(size) < 0.3] = -np.inf
    keys = np.repeat(np.arange(5, dtype=np.int64) * 1000 - 7, size)
    vals = np.concatenate([mixed, neg, zeros, nans, infs])
    perm = rng.permutation(keys.size)
    return keys[perm], vals[perm]


def raw_bits_median(values, order, starts, counts):
    """Planted fault: per-group medians ordered by the raw int64 bit pattern
    (the row select's order before it took any float64). (V, B, G)."""
    import torch
    from repro_torch.core.torchsim.kernels import padded_rows
    rows = padded_rows(values, order, starts, counts, float("inf"))
    b, v, g, m = rows.shape
    srt = torch.sort(rows.view(torch.int64), dim=-1).values.view(torch.float64)
    c = counts.expand(b, g)
    lo = srt.gather(3, torch.clamp((c - 1) // 2, min=0)[:, None, :, None].expand(b, v, g, 1))
    hi = srt.gather(3, torch.clamp(c // 2, max=m - 1)[:, None, :, None].expand(b, v, g, 1))
    return (0.5 * (lo + hi))[..., 0].transpose(0, 1).contiguous()


def _same_bits(a, b) -> bool:
    """Bit for bit, any NaN equal to any NaN."""
    import torch
    a, b = a.cpu(), b.cpu()
    nan = torch.isnan(a)
    return a.shape == b.shape and bool(torch.equal(nan, torch.isnan(b))) and \
        torch.equal(a[~nan].view(torch.int64), b[~nan].view(torch.int64))


def signed_tiers() -> float:
    """The row select at every tier on signed, zero, NaN and infinite
    samples (one window; and 70,000 windows of groups of 1 to 33), against
    its plain version on the card, bit for bit with NaN equal to NaN; a
    median by the raw int64 bit pattern must read unequal."""
    import numpy as np
    import torch
    from repro_torch.core.torchsim import detectors as tdet
    from repro_torch.core.torchsim import kernels as tk
    from repro_torch.kernels import window_score as ws
    cases = [(f"groups of {s}", 1, *signed_groups(s, s)) for s in TIER_SIZES]
    rng = np.random.default_rng(70)
    keys = np.repeat(np.arange(5, dtype=np.int64), [1, 2, 10, 17, 33])[rng.permutation(63)]
    vals = rng.normal(size=(70_000, 63))
    vals[rng.random(vals.shape) < 0.05] = np.nan
    vals[rng.random(vals.shape) < 0.05] = -0.0
    cases.append(("70,000 windows of groups of 1, 2, 10, 17, 33", 70_000, keys, vals.ravel()))
    err = 0.0
    for label, b, keys, vals in cases:
        lay = tdet._WindowLayout(keys)
        lt = lay.device_tensors(torch.device(DEV))
        v = torch.from_numpy(vals).to(DEV).view(b, 1, -1)
        args = (v, lt["order"], lt["starts"], lt["counts"])
        got = ws.row_select(*args, large=lt["large"], max_count=lay.max_count)
        want = tk.row_median(*args)
        wrong = raw_bits_median(*args)
        ok = _same_bits(got, want)
        fin = torch.isfinite(want)
        if fin.any():
            err = max(err, (got[fin] - want[fin]).abs().max().item())
        same = (got.view(torch.int64) == wrong.view(torch.int64)) | \
            (torch.isnan(got) & torch.isnan(wrong))
        differ = int((~same).sum())
        print(f"  parity row_select, signed tiers, {label} (B={b}): bit-equal to the plain "
              f"version (NaN = NaN): {'yes' if ok else 'NO'}; {int(torch.isnan(want).sum())} NaN "
              f"medians", flush=True)
        print(f"    planted fault, median by the raw int64 bit pattern: {differ} of "
              f"{got.numel()} medians differ", flush=True)
        if not ok:
            fail(f"row_select, {label}: the kernel differs from its plain version")
        if differ == 0:
            fail(f"row_select, {label}: the raw-bit-pattern fault reads equal to the kernel")
    return err


def timed(name, run, plain, library, nbytes, names, iters, lib_label, where=None):
    """Event and device times of a kernel, its plain version and the
    library yardstick, and its bytes bound (each input read once, each
    output written once, at 3.35 TB/s)."""
    ms = time_ms(run, iters)
    split = {}
    dev = device_ms(run, iters, names, split)
    plain_ms = time_ms(plain, max(2, iters // 4))
    lib = lib_dev = None
    if library is not None:
        lib, lib_dev = time_ms(library, iters), device_ms(library, iters)
    b_ms, b_by = bound(0.0, nbytes, "float32")
    print(f"  time {name} at {where or f'{DETECT_RANKS} ranks'}: kernel_ms={ms:.5f} "
          f"device_ms={_ms(dev)} "
          f"plain_ms={plain_ms:.5f} library_ms={'null' if lib is None else f'{lib:.5f}'} "
          f"library_device_ms={'null' if library is None else _ms(lib_dev)} "
          f"bound_ms={b_ms:.5f} ({b_by}; {nbytes:.4e} B) bound/device={_share(b_ms, dev)}"
          f"{'' if lib_label is None else '; library: ' + lib_label}", flush=True)
    print("    device ms by kernel: " + ", ".join(f"{k} {v:.5f}" for k, v in split.items()),
          flush=True)
    return (ms, plain_ms, lib, b_ms, b_by, dev, lib_dev)


def _vkey(verdicts):
    """Verdicts field for field, scores as their exact hex."""
    return [(v.syndrome, v.rank, v.link, float(v.score).hex(), v.detail) for v in verdicts]


def _akey(a):
    return (a.node_id, a.action, _vkey(a.verdicts))


def detect_parity():
    """The card's verdicts and streaming actions against the port's NumPy
    composite at 1,024 ranks."""
    from repro_torch.core.c4d.detector import C4DDetector
    from repro_torch.core.c4d.master import C4DMaster, OperatingPoint
    from repro_torch.core.faults import RingJobTelemetry

    n = PARITY_RANKS
    golden = golden_faults()
    n_verdicts = 0
    for faults in golden:
        w = RingJobTelemetry(n_ranks=n, seed=9).window_arrays(0, faults)
        want = C4DDetector(backend="numpy").analyze(w, n)
        got = C4DDetector(backend="torch", device=DEV).analyze(w, n)
        if _vkey(got) != _vkey(want):
            fail(f"card verdicts differ from the NumPy composite on {faults}: "
                 f"{_vkey(got)[:3]} vs {_vkey(want)[:3]}")
        n_verdicts += len(want)
    print(f"  verdicts at {n} ranks, 10 golden windows: equal to the NumPy composite field for "
          f"field, scores bit-equal ({n_verdicts} verdicts)", flush=True)
    seq = [golden[1 + (i // 2) % (len(golden) - 1)] for i in range(STREAM_WINDOWS)]
    for op in (None, OperatingPoint(mad_threshold=5.0, confirm_streak=2)):
        tel_a, tel_b = RingJobTelemetry(n_ranks=n, seed=5), RingJobTelemetry(n_ranks=n, seed=5)
        if op is None:
            ma, mb = (C4DMaster(n_ranks=n, backend="numpy"),
                      C4DMaster(n_ranks=n, backend="torch", device=DEV))
        else:
            ma = C4DMaster.from_operating_point(op, n_ranks=n, backend="numpy")
            mb = C4DMaster.from_operating_point(op, n_ranks=n, backend="torch", device=DEV)
        acted = 0
        for i, faults in enumerate(seq):
            ra = ma.ingest(tel_a.window_arrays(i, faults))
            rb = mb.ingest(tel_b.window_arrays(i, faults))
            if [_akey(a) for a in ra] != [_akey(a) for a in rb]:
                fail(f"streaming actions differ at window {i} (op {op})")
            acted += len(ra)
        same_base = True
        if op is not None:
            same_base = all(getattr(ma.baseline, a)[k].tobytes() == getattr(mb.baseline, a)[k]
                            .tobytes() for a in ("_mean", "_dev", "_count")
                            for k in ("delay", "wait", "hb"))
            if not same_base:
                fail("the card master's adaptive baseline differs from the NumPy master's")
        print(f"  stream of {STREAM_WINDOWS} windows at {n} ranks, operating point "
              f"{'none' if op is None else op.label()}: actions equal ({acted} actions), "
              f"baseline arrays bit-equal: {same_base if op else 'no baseline'}", flush=True)
    tels = [RingJobTelemetry(n_ranks=n, seed=13) for _ in range(3)]
    bseq = [golden[i % len(golden)] for i in range(BATCH_WINDOWS)]
    wins = [[t.window_arrays(i, f) for i, f in enumerate(bseq)] for t in tels]
    ref = C4DMaster(n_ranks=n, backend="numpy")
    one, many = (C4DMaster(n_ranks=n, backend="torch", device=DEV) for _ in range(2))
    want = [[_akey(a) for a in ref.ingest(w)] for w in wins[0]]
    got_seq = [[_akey(a) for a in one.ingest(w)] for w in wins[1]]
    got_bat = [[_akey(a) for a in acts] for acts in many.ingest_batch(wins[2])]
    if not got_bat == got_seq == want:
        fail("ingest_batch differs from sequential ingests")
    print(f"  ingest_batch of {BATCH_WINDOWS} windows at {n} ranks equals {BATCH_WINDOWS} "
          "ingests and the NumPy master", flush=True)


def detect_analyze_times():
    """analyze wall time on clean windows, warm (layouts cached): the
    unsynchronised median of 3, then one call split into phases."""
    from repro_torch.core.c4d.detector import C4DDetector
    from repro_torch.core.faults import RingJobTelemetry
    from repro_torch.core.torchsim import detectors as tdet

    out = {}
    for n in ANALYZE_RANKS:
        w = RingJobTelemetry(n_ranks=n, seed=3).window_arrays(0, [])
        det = C4DDetector(backend="torch", device=DEV)
        det.analyze(w, n)
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            det.analyze(w, n)
            walls.append(time.perf_counter() - t0)
        tdet.phase_seconds = {}
        try:
            det.analyze(w, n)
            phases = dict(tdet.phase_seconds)
        finally:
            tdet.phase_seconds = None
        wall = sorted(walls)[1]
        line = " ".join(f"{k}={v * 1e3:.3f}" for k, v in phases.items())
        extra = ""
        if n == PARITY_RANKS:
            ref = C4DDetector(backend="numpy")
            ref.analyze(w, n)
            t0 = time.perf_counter()
            ref.analyze(w, n)
            extra = f"; NumPy composite on this host {(time.perf_counter() - t0) * 1e3:.3f} ms"
        print(f"  analyze {n} ranks ({w.tr_src.size:,} transports): wall_ms={wall * 1e3:.3f} "
              f"(median of 3); phases (synchronised) ms: {line}{extra}", flush=True)
        out[n] = (wall, phases)
    return out


CROSSOVER_RANKS = (64, 128, 256, 512, 1024, 2048, 4096)
CROSSOVER_ELEMENTS = (1 << 12, 1 << 14, 1 << 16, 1 << 17, 1 << 18, 1 << 20)


def _wall_ms(fn, reps: int = 3) -> float:
    """Median of ``reps`` host walls of ``fn`` after one warm-up call."""
    fn()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t0)
    return sorted(walls)[reps // 2] * 1e3


def detect_crossover():
    """Where backend="auto" switches from NumPy to the card: the NumPy
    composite's analyze against the card's on clean windows, and the NumPy
    grouped median against the card's on groups of 10 (the prefilter's
    edges), both warm (layouts cached, as in a steady stream). Prints each
    wall beside the faster backend and the one auto picks."""
    import numpy as np
    from repro_torch.core import torchsim
    from repro_torch.core.c4d.detector import C4DDetector
    from repro_torch.core.c4d.telemetry import grouped_median
    from repro_torch.core.faults import RingJobTelemetry

    def line(what, np_ms, card_ms, auto):
        faster = "torch" if card_ms < np_ms else "numpy"
        print(f"  crossover {what}: numpy_ms={np_ms:.4f} torch_ms={card_ms:.4f} "
              f"faster={faster} auto={auto}", flush=True)

    for n in CROSSOVER_RANKS:
        w = RingJobTelemetry(n_ranks=n, seed=3).window_arrays(0, [])
        ref, det = C4DDetector(backend="numpy"), C4DDetector(backend="torch", device=DEV)
        line(f"analyze {n} ranks", _wall_ms(lambda: ref.analyze(w, n)),
             _wall_ms(lambda: det.analyze(w, n)), torchsim.effective_backend("auto", ranks=n))
    rng = np.random.default_rng(5)
    for size in CROSSOVER_ELEMENTS:
        keys = rng.integers(0, size // 10, size)
        vals = rng.uniform(0.0, 1.0, size)
        line(f"grouped_median {size} elements",
             _wall_ms(lambda: grouped_median(keys, vals, backend="numpy")),
             _wall_ms(lambda: grouped_median(keys, vals, backend="torch", device=DEV)),
             torchsim.effective_backend("auto", elements=size))


def detect_main_path():
    """The main path: a streaming C4DMaster on the card ingesting 100,000-rank
    windows (a slow source twice, then a hang). Returns the launches."""
    from repro_torch.core.c4d.detector import COMM_HANG, COMM_SLOW_SRC
    from repro_torch.core.c4d.master import C4DMaster
    from repro_torch.core.faults import Fault, RingJobTelemetry
    from repro_torch.core.torchsim import detectors as tdet

    n = DETECT_RANKS
    tel = RingJobTelemetry(n_ranks=n, seed=4)
    master = C4DMaster(n_ranks=n, backend="torch", device=DEV)
    plan = [[Fault("slow_src", rank=5)]] * 2 + [[Fault("comm_hang", rank=11)]]
    wins = [tel.window_arrays(i, f) for i, f in enumerate(plan)]
    tdet.reset_launch_counts()
    acts = []
    for i, w in enumerate(wins):
        t0 = time.perf_counter()
        merged = master._merge(w)
        t1 = time.perf_counter()
        verdicts = master.detector.analyze(merged, n_ranks=n, baseline=master.baseline)
        t2 = time.perf_counter()
        actions = master._act(w, merged, verdicts)
        t3 = time.perf_counter()
        acts.append(actions)
        print(f"  ingest {i} at {n} ranks ({w.tr_src.size:,} transports -> "
              f"{merged.tr_src.size:,} after the prefilter): prefilter_s={t1 - t0:.4f} "
              f"detect_s={t2 - t1:.4f} act_s={t3 - t2:.4f}; {len(verdicts)} verdicts, actions "
              f"{[(a.node_id, a.action) for a in actions][:6]}"
              f"{' ...' if len(actions) > 6 else ''}", flush=True)
    counts = tdet.launch_counts()
    slow = [a for a in acts[1] if a.node_id == 0]
    if not (slow and any(v.syndrome == COMM_SLOW_SRC and v.rank == 5 for v in slow[0].verdicts)):
        fail("the slow source rank 5 was not isolated at its second window")
    if [(a.node_id, [(v.syndrome, v.rank) for v in a.verdicts]) for a in acts[2]] != \
            [(1, [(COMM_HANG, 11)])]:
        fail(f"the hang window's actions are {acts[2]}")
    want = {"window_score": 3, "row_select": 6, "slow_fold": 2}
    if counts != want:
        fail(f"detection launches {counts} on the main path; expected {want}")
    print(f"  launches on the detection main path: {counts}", flush=True)
    return counts


def detect_batched(iters: int):
    """``window_score`` and ``slow_fold`` as ``ingest_batch`` launches them at
    the JAX package's batched shape (``benchmarks/bench_jaxsim.py``: 1,024
    ranks, 8 windows of ``RingJobTelemetry(seed=7)``, a slow source on rank
    5 in the odd ones): the launches of one call, then each kernel timed on
    the inputs that call gave it. Returns (launches, rows)."""
    from repro_torch.core.c4d.master import C4DMaster
    from repro_torch.core.faults import Fault, RingJobTelemetry
    from repro_torch.core.torchsim import detectors as tdet
    from repro_torch.kernels import slow_fold as sf
    from repro_torch.kernels import window_score as ws

    n, b = 1024, 8
    tel = RingJobTelemetry(n_ranks=n, seed=7)
    wins = [tel.window_arrays(i, [Fault("slow_src", rank=5)] if i % 2 else [])
            for i in range(b)]
    seen, calls = {}, {"window_score": 0, "slow_fold": 0}
    real = {"window_score": (ws, ws.window_score), "slow_fold": (sf, sf.slow_fold)}

    def recording(name):
        def call(*a, **kw):
            seen.setdefault(name, (a, kw))
            calls[name] += 1
            return real[name][1](*a, **kw)
        return call

    try:
        for name, (mod, _) in real.items():
            setattr(mod, name, recording(name))
        master = C4DMaster(n_ranks=n, backend="torch", device=DEV)
        tdet.reset_launch_counts()
        acts = master.ingest_batch(wins)
        counts = tdet.launch_counts()
    finally:
        for name, (mod, fn) in real.items():
            setattr(mod, name, fn)
    print(f"  ingest_batch of {b} windows at {n} ranks: launches {counts}, "
          f"{sum(map(len, acts))} actions", flush=True)
    if calls != {"window_score": 1, "slow_fold": 1}:
        fail(f"ingest_batch did not batch its windows: calls {calls}")
    where = f"{n} ranks x {b} windows (ingest_batch)"
    a, kw = seen["window_score"]
    rows = {"window_score": window_row("window_score, batched", a, kw, iters, where)}
    a, kw = seen["slow_fold"]
    rows["slow_fold"] = fold_row(f"slow_fold, batched ({a[1].shape[0]} hang-free windows)",
                                 a, kw["n"], iters, where)
    return counts, rows


def detect_phase(iters: int):
    errs, rows = detect_kernels(iters)
    rows["batched"] = detect_batched(iters)
    detect_parity()
    detect_analyze_times()
    detect_crossover()
    counts = detect_main_path()
    return errs, rows, counts


def _bit_equal(a, b) -> bool:
    import torch
    bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        a, b = a.view(bits[a.element_size()]), b.view(bits[b.element_size()])
    return torch.equal(a, b)


def profile_phase(out_dir: Path) -> None:
    """torch.profiler over one prefill and 8 decode steps of the served model."""
    import torch
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
    for label, fn in (("prefill", lambda: prefill(prompt, cache)), ("decode_x8", decode8)):
        profile_one(label, fn, out_dir)


def profile_one(label: str, fn, out_dir: Path) -> None:
    """torch.profiler over one call of ``fn``: device time by kernel and the
    device's busy share of the profiled wall time; the table goes to
    ``out_dir/profile_<label>.txt``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out_dir.mkdir(parents=True, exist_ok=True)
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
    for us, n, key in dev[:10]:
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
        log = _build.build_log(name)
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores", log))
        print(f"  {name}: {len(regs)} kernel instances, {min(regs, default=0)}-"
              f"{max(regs, default=0)} registers a thread, {spills} bytes of spill stores "
              "in all (ptxas)", flush=True)
    # each instance of the split decode kernel (D, query heads a warp keeps)
    log = _build.build_log("decode_attention")
    for d, g, body in re.findall(r"decode_tma_kernelILi(\d+)ELi(\d+)EE\S*\n(.*?)Compile time",
                                 log, re.S):
        spill = re.search(r"(\d+) bytes spill stores", body)
        reg = re.search(r"Used (\d+) registers", body)
        print(f"    decode_tma_kernel<D={d}, G={g}>: {reg.group(1) if reg else '?'} registers, "
              f"{spill.group(1) if spill else '?'} bytes of spill stores", flush=True)
    # each instance of the wgmma flash kernel: registers at launch (the
    # consumers then take 240 by setmaxnreg) and spills
    log = _build.build_log("flash_attention")
    for d, cap, body in re.findall(r"flash_wgmma_kernelILi(\d+)ELb(\d)EE\S*\n(.*?)Compile time",
                                   log, re.S):
        spill = re.search(r"(\d+) bytes spill stores", body)
        reg = re.search(r"Used (\d+) registers", body)
        print(f"    flash_wgmma_kernel<D={d}, cap={cap}>: {reg.group(1) if reg else '?'} "
              f"registers, {spill.group(1) if spill else '?'} bytes of spill stores", flush=True)

    t0 = time.perf_counter()
    print("[kernels]", flush=True)
    flash_err, flash_rows = flash_phase(ITERS)
    decode_err, decode_rows = decode_phase(ITERS)
    norm_err, norm_rows, norm_extra = rmsnorm_phase(ITERS)
    print(f"[kernels] done in {time.perf_counter() - t0:.1f} s", flush=True)

    # [detect] before [serve] and [train]: after the train phase the profiler
    # dropped the records of short profiled windows
    t0 = time.perf_counter()
    print("[detect]", flush=True)
    det_err, det_rows, det_counts = detect_phase(DETECT_ITERS)
    print(f"[detect] done in {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    print("[serve]", flush=True)
    serve_counts = serve_phase()
    print(f"[serve] done in {time.perf_counter() - t0:.1f} s", flush=True)
    if args.profile is not None:
        print("[profile]", flush=True)
        profile_phase(args.profile)

    t0 = time.perf_counter()
    print("[train]", flush=True)
    train_counts = train_phase(args.profile)
    print(f"[train] done in {time.perf_counter() - t0:.1f} s", flush=True)
    counts = {k: serve_counts[k] + train_counts[k] for k in serve_counts}
    print(f"launches on the main paths: serve {serve_counts}, train {train_counts}", flush=True)


    def entry(name, source, replaces, err, rows):
        # attention: one local-window and one global launch of the main path,
        # averaged; rmsnorm: the training microbatch (1, 4096, 2304)
        col = [[r[i] for r in rows] for i in range(7)]
        mean = [None if i == 4 or None in c else sum(c) / len(c) for i, c in enumerate(col)]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": counts[name], "max_abs_err": err[0], "max_row_rel_err": err[1],
                "ms": mean[0], "device_ms": mean[5], "plain_ms": mean[1], "bound_ms": mean[3],
                "bound_by": rows[0][4], "library_ms": mean[2], "library_device_ms": mean[6]}

    def times(row):
        ms, plain, lib, b_ms, b_by, dev, lib_dev = row
        return {"ms": ms, "device_ms": dev, "plain_ms": plain, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": lib, "library_device_ms": lib_dev}

    batch_counts, batch_rows = det_rows["batched"]

    def detect_entry(name, source, replaces, launches, err, row):
        # one window at 100,000 ranks; launches on the detection main path.
        # Besides: the prefilter's node groups, and ingest_batch at 1,024 x 8
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": launches, "max_abs_err": err, **times(row)}
        if name == "row_select":
            entry["node_groups"] = times(det_rows["row_select_node"])
        if name in batch_rows:
            entry["batched"] = dict(times(batch_rows[name]), launches=batch_counts[name])
        return entry

    print(card, flush=True)
    print(json.dumps({"kernels": [
        entry("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention.py:88", flash_err, flash_rows),
        entry("decode_attention", "src/repro_torch/kernels/csrc/decode_attention.cu",
              "src/repro/kernels/decode_attention.py:70", decode_err, decode_rows),
        dict(entry("rmsnorm", "src/repro_torch/kernels/csrc/rmsnorm.cu",
                   "src/repro/kernels/rmsnorm.py:27", norm_err, norm_rows[:1]),
             prefill=times(norm_rows[1]), decode=dict(times(norm_rows[2]), **norm_extra)),
        *(detect_entry(name, src, rep, det_counts[name], det_err[name], det_rows[name])
          for name, src, rep in DETECT_KERNELS),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
