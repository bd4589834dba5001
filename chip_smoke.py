#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py                  # needs one CUDA card
    python3 chip_smoke.py --profile DIR    # also profile serving and one train step,
                                           # and the MoE configs' prefill and decode

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
    after its timed launches. Flash and decode also at a group above 8 (16
    and 9: the wrappers' passes of at most 8 query heads a kv head, their
    launches counted) and a head_dim of 320 (passes of 256 output columns),
    fp32 and bf16, with a planted fault each (a pass's heads in the wrong
    columns, V's last 64 columns dropped). At RMSNorm's decode shape, an empty kernel's
    device time (the floor of a launch) and the host path by events: the
    wrapper, the model's entry under no_grad, and F.rms_norm. At the
    [models] configs' shapes (no window, no cap): flash and decode at
    yi-34b's (56 heads on 8, head_dim 128), stablelm-12b's (32 on 8, 160:
    the wgmma flash and the TMA decode over three 64-column boxes, the last
    half out of bounds), musicgen-medium's (24 on 24, 64),
    llama-3.2-vision-11b's (32 on 8, 128) and zamba2-7b's (MHA 32, 112: a
    partial box) prefill and decode shapes, with planted faults (a window of
    4096; V's last 32 columns, at head_dim 160 or 112 its columns in the
    partial box, or the last 128 keys, dropped); RMSNorm at each one's
    d_model, stablelm-12b's qk-norm rows (2 x 4352 x 32 of 160),
    deepseek-v2-236b's MLA norms (2 x 4352 of 512 and of 1536) and
    xlstm-125m's (768 and, the mLSTM's, 1536). RMSNorm's split mode
    (``rmsnorm_split_phase``, ``SPLIT_CASES``): zamba2-7b's gated norm
    (2 x 4352 x 7168, bf16) cut into 8 column shards, and xlstm-125m's mLSTM
    (1536 wide) and sLSTM (768) norms in 16 shards of 96 and of 48 columns,
    as a rank of model 16 holds them; each shard's sum-of-squares launch, the
    sums added (the all-reduce over ``model`` on a mesh), each shard's
    scale launch, every row within ``ROW_REL_TOL`` of the plain whole row
    and of the whole-row launch, a planted fault (each shard normalised by
    its own columns) above the limit, the launches' device ms beside the
    whole-row launch's and the bound. The decode kernel's shard
    mode (``k0``, ``return_lse``; ``SHARD_CASES``): gemma2-2b's,
    stablelm-12b's (32 heads on 8, 160) and yi-34b's (56 on 8, 128) decode
    caches and a float32 one on the split-K path cut into 8 shards of 548
    keys, each launched at its global offset; the float32 partials merged on
    the card by ``ref.merge_shards`` and held within ``ROW_REL_TOL[float32]``
    of the plain shards merged, and, rounded once to the inputs' dtype,
    within that dtype's ``ROW_REL_TOL`` of the plain version and of the
    whole-cache launch; each shard's lse within ``LSE_TOL`` of its plain
    version's, the wholly masked shards (past pos, or before the window) out
    0 and lse NEG_INF, a planted fault (the shard holding pos launched one
    64-key tile late) above the limit; each shard launch's event ms and the
    8 launches' device ms beside the card; and at a synthetic group of 12
    (48 heads on 4, 128; no shipped config has a group above 8) in two
    passes of 6 a shard, 16 launches. The flash kernel's query offset
    (``OFFSET_CASES``): the last of 8 shards of the prompt (544 query
    positions at q_offset 3808 against all 4352 keys) at gemma2-2b's shape
    (its window and a global layer), yi-34b's (group 7), stablelm-12b's and
    in float32 on the CUDA cores, per row within ``ROW_REL_TOL`` of the
    plain version with ``q_offset`` and of the whole-sequence launch's rows,
    a planted fault (q_offset off by one) above it, offset 0 bit-equal to
    the whole launch; its time beside the whole launch's, the bound and,
    without a cap, SDPA with a boolean mask. Every timed attention row must
    launch the kernels the wrapper's dispatch rule names for its shape
    (``wgmma_path``, ``tma_path``), as many a call as it has group passes,
    and no other: at stablelm-12b's shapes ``flash_wgmma_kernel`` and one
    ``decode_tma_kernel``, no CUDA-core or split-K kernel.
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
    ``repro_torch.train.trainer.Trainer`` for 3 steps with a crash of rank 9
    (of 4 simulated nodes, 32 ranks) before step 2: DETECT -> ISOLATE ->
    RESTORE, then steps 0-2 again (5 steps run). Loss and grad norm of the
    first batch must match the plain norms; each step run must make 2 x (105
    + 104) RMSNorm launches; losses must be finite; one restart from step 0,
    the detection record (verdicts, isolated and backup node, windows) equal
    to the port's NumPy master's on the same telemetry, node 1 out of the
    active set, each ingest of the handler one ``window_score`` launch on the
    card, and the replayed steps' losses bit-equal to the first pass's; the
    handler's seconds split into detection, steering and the restore from
    the in-memory replica. The step-0 checkpoint restored from disk must
    equal the initial weights and the replica bit for bit (after the
    restore and the replay, so a step that wrote into the replica fails);
    a fault-free run of the 3 steps from the replica through the Trainer's
    step must end with losses and parameters bit-equal to the fault run's.
    Then one int8 step (``grad_compression="int8"``, error feedback, the
    ``ef`` residual of one fp32 a parameter) of the same model: a finite
    loss, the first quantised leaves of the step, copied to the CPU, bit-equal
    to the CPU's quantisation of the same gradient leaf at the same amax,
    its time beside a plain step's. Then the stacked optimizer updates
    (``stacked_update_check``): two ``adamw_factored`` and two ``adamw_8bit``
    updates of yi-34b's stacked norm scales (60 x 7168) and of zamba2-7b's
    per-head vectors and conv bias (81 layers in 7 stacks) through
    ``adamw.apply_updates`` on the card and on the CPU from the same seeded
    values: parameters and fp32 statistics within 1e-6, bf16 first moments,
    8-bit codes and scales equal;
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
 6. fabric: C4P's water-filling (``FlowSet.max_min`` at ``torch`` on the card,
    ``csrc/waterfill.cu``) bit-equal to the NumPy loop, and every kernel
    variant (the state in one CTA's shared memory where it fits, in device
    memory on a cooperative grid) bit-equal to the plain
    version, on 40 random fabrics (links failed in the odd ones), the Fig. 2
    fabric (2,048 flows) with and without CNP jitter and a 10,240-GPU fabric
    (20,480 flows); planted faults (a link's sums in reverse pair order, no
    clamp at 0, earlier-frozen flows frozen again) must read unequal. The
    main path: C4P (``FabricState``, dynamic LB) at the Fig. 2 fabric's
    width on the card, equal to NumPy, one launch per ``max_min`` call.
    Times at the main path's call, Fig. 2 and 10,240 GPUs: each variant's
    event and device ms and its barriers alone, the first design's device
    ms (``csrc/earlier/waterfill.cu``, built by ``ablate_waterfill``), the
    plain version's and NumPy's ms, the bound (the larger of the bytes the
    work needs once and the default variant's barriers alone); the
    card-against-NumPy crossover from 128 to 20,480 flows
    (``AUTO_WATERFILL_FLOWS``). The EWMA scan (``csrc/ewma_scan.cu``) at 64
    windows x 16,384 cells within 1e-9 of its plain version on both of its
    paths (shared memory, L2) and of ``AdaptiveBaseline.update``, planted
    faults (NaN kept in the median's pool, the seed deviation over all
    cells), both paths' times and the first design's;
    ``analyze_arrays_reference`` on the card equal to NumPy on the ten
    golden windows at 1,024 ranks;
 7. drills: the 11 shipped C4 fault drills (32 ranks) through
    ``repro_torch.scenarios.engine.run_scenario`` at ``backend="torch"`` on
    the card and at ``backend="numpy"``, then ``straggler_gpu`` at fleet_day's
    anchor scale (10,240 ranks, 1,288 nodes, a 900 s tick). Each card report
    must equal the NumPy one and hash to the JAX package's (pinned here);
    every ingest on the card, the streaming master's and each per-fault
    master's, must launch ``window_score`` once and ``row_select`` at least
    twice, ``slow_fold`` and ``waterfill`` must launch (172 water-fills in
    the 11 drills), and the NumPy runs launch nothing. Wall seconds and
    seconds a streaming window at both backends.
 8. live: ``repro_torch.scenarios.live.drive`` replays ``single_nic_down``'s
    fault script on a Trainer on the card (the smollm-135m smoke config, 12
    steps, 4 simulated nodes): one restart for a crash, the isolated node on
    the shared cluster, a finite final loss, each ingest one ``window_score``
    launch on the card, RMSNorm launches;
 9. campaigns: ``fleet_smoke`` and ``fleet_mixed`` at 2 trials through
    ``repro_torch.scenarios.montecarlo.run_campaign`` at ``torch`` on the card
    with 1 and 2 (spawned) workers and at ``numpy``: every report must hash to
    the JAX package's (pinned here); ``fleet_hour`` (``fleet.run_fleet``) and
    the ``roc_smoke`` sweep (``precision.run_sweep``) at ``torch`` on the card
    and at ``numpy``: reports (and the selected operating point) equal. Each
    card run in this process must launch ``window_score``, ``slow_fold`` and
    ``waterfill``. Wall seconds at both backends.
 10. models: yi-34b (60 layers), stablelm-12b (40, qk-norm), musicgen-medium
    (48, audio: frame embeddings in, a zero frame a decode step), arctic-480b
    (MoE, 128 experts top 2 with a dense residual, cut to 2 of 35 layers),
    deepseek-v2-236b (MLA, 160 experts top 6 with 2 shared, the first
    layer dense; cut to 6 of 60), llama-3.2-vision-11b (40: 32 self-attention
    and 8 cross-attention layers over (2, 6404, 1280) image embeddings, the
    cross gates drawn non-zero from a seed before anything runs), zamba2-7b
    (81 Mamba2 layers and 13 applications of one shared attention block,
    MHA at head_dim 112) and xlstm-125m (12: mLSTM x 3, sLSTM) at full width
    through ``serve`` as in 3 (``MODEL_SERVE_LAYERS``): exact launch counts
    (flash once an attention application, decode that x 32, none with MLA
    or without attention; RMSNorm 2 a block application (+ 2 with sandwich
    norms or qk-norm, + 1 or 2 with MLA) + 1 a forward), tokens in range.
    The dense, vision, hybrid and recurrent configs' prefill logits within
    2e-2 of the plain path's (or, where a deep bf16 model misses that with
    no kernel at fault, as close to the fp32 forward as the plain path,
    within 1.25x). llama-3.2-vision-11b: each cross layer's output against
    the plain path's within 0.1 of its largest |output|, planted faults (the
    gates back to 0, another seed's image) above it. zamba2-7b and
    xlstm-125m, in float32: decode step 1 against a fresh prefill of the
    prompt and that token, logits within 2e-2 of max|logit| and each block
    application's mixer output within 1e-3, planted faults (the recurrent
    state zeroed between prefill and decode; one KV cache for the 13
    shared-block applications) above them. The MoE configs: one
    model prefilled (``head="full"``) through the kernels and the plain path;
    each MoE layer's input captured in both and routed (``route_check``):
    every top-k flip a near tie of the plain path (its k-th and (k+1)-th
    router logits within 2x the paths' largest router-logit difference),
    every kept/dropped difference in an expert a flip touched; the logits at
    the positions whose routes agree in every layer within 2e-2 of
    max|logit|; at least 0.9 of the positions agreeing, or, where flips
    compound over the layers (deepseek-v2-236b's 5 MoE layers), disagreeing
    at most 1.25x as often as the plain path with float64 norms does;
    planted faults (the dense residual or the shared experts left out, gates
    not renormalised) above the logit limit. Each but
    arctic-480b trained at full width for 2 steps of ``make_train_step`` over
    ``TokenPipeline`` batches (seq 4096, global batch 2, 2 microbatches, the
    config's remat and optimizer; yi-34b and stablelm-12b cut to 4 layers,
    deepseek-v2-236b to 2, llama-3.2-vision-11b to 5, zamba2-7b to 13,
    xlstm-125m to 4): the first batch's loss and grad norm against the
    plain norms, finite losses, exact RMSNorm launches a step;
    musicgen-medium's first step under remat ``dots`` against ``full``
    (within 1e-6), with seconds and peak memory of each. With ``--profile``,
    the MoE, vision, hybrid and recurrent configs' prefill and a decode step
    are profiled too, their device time split by part (expert GEMMs, gathers
    and scatters, attention products, norms) and by scope (cross attention,
    the Mamba2, mLSTM and sLSTM cells).
 11. mesh: a world-1 NCCL process group (``tcp://localhost``, a free port) and
    a (1, 1) ``make_local_mesh("cuda")``: one full-width gemma2-2b step
    through the sharded step (the tensor-parallel code path of
    ``parallel/tensor.py`` at model 1: DTensor masters and moments, the
    model on its shards, each layer's gathers and Megatron's f and g, the
    gradients arriving on the shards) and one through the one-device step
    from the same weights and batch, under ``adamw`` and then under
    ``adamw_factored`` (its first moment on the shards, its row and column
    statistics reduced over the mesh); loss and parameters must be equal
    (``torch.equal``), or the script prints which leaves differ (and fails
    only above a learning rate's difference); the one-device step run twice
    (does it repeat itself bit for bit; the second is timed warm) and the
    sharded step twice (the first starts the NCCL communicators); the
    sharded step's RMSNorm launches counted. Then gemma2-2b served at full
    width on that mesh with its weights and caches on the rank's shards
    (``serve(..., sharded=True)``) and on one device from the same seed:
    tokens and prefill logits ``torch.equal``, every kernel launched; the
    process group destroyed.
 13. tp: one rank (rank 0) of a (data 1, model 8) mesh under torch's fake
    process group (``fake``, in which a collective moves nothing) on the
    card: stablelm-12b at its full 40 layers and full widths (32 heads on 8,
    4 of them and 1 kv head a rank; a 12,544-wide vocab shard), seq 4096,
    batch 2, one microbatch, remat full, adamw_factored, drawn on its shards
    a block at a time and trained 2 steps through ``make_train_step`` on the
    mesh, its optimizer state as the JAX package places it (the factored
    first moment on the rank's shards, the row and column statistics
    whole) and updated on the shards. It prints each step's seconds,
    ``max_memory_allocated`` beside the dry run's prediction of the same
    rank's peak (``launch/dryrun.py``, traced on the meta device under its
    own fake group of 8), the rank's stored optimizer bytes beside the dry
    run's, and the RMSNorm kernel's launches in a step; it fails where the
    kernel did not launch, a loss or grad norm is not finite, the stored
    optimizer bytes are not the dry run's, or the peak misses the
    prediction by more than ``TP_PEAK_TOL``. The loss is not a model's
    loss: the fake group sums nothing, so each rank's attention and FFN
    outputs stand for the sum of 8, and the token ids are drawn within the
    rank's vocab shard (a token outside it would embed as zeros on this rank).
    Before it, gemma2-2b's layer-0 prefill attention under
    ``attn_activation_sharding`` "batch" on rank 0 of a (1, 2) mesh
    (``batch_mode_check``: the flash kernel on the rank's rows only, within
    ``ROW_REL_TOL`` of the one-device layer's rows), and its layer-0 and
    layer-1 prefill under "sequence" on the last rank of a (1, 8) mesh
    (``sequence_mode_check``: the flash kernel on the rank's 544 query
    positions at q_offset 3808 against every key, as many launches as one
    device, within ``ROW_REL_TOL`` of the one-device layer's positions);
    after it, one step of
    the same rank under ``adamw_8bit`` (the embedding's and head's 8-bit
    state on their shards), its peak printed beside the dry run's.
    Then one rank of yi-34b's sharded serve on the same (1, 8) mesh at its 60
    layers and published widths (``tp_serve_phase``): batch 2, the
    4352-token prompt, 32 decode steps, the cache 4384 = 8 x 548 long with
    its sequence over model (the decode kernel's shard mode a layer and
    step), ``max_memory_allocated`` from the end of the weights' draw against
    the dry run's peak of the rank's prefill cell within ``TP_PEAK_TOL``,
    finite logits, tokens in range, exact flash and decode launches.
    Last, one rank of zamba2-7b on the same (1, 8) mesh at full width and one
    unit (6 Mamba2 cells and the shared block; ``tp_ssm_phase``): each cell
    on the rank's 14 of 112 heads, its norm in RMSNorm's split mode. One
    train step at seq 4096, batch 2, then a prefill of the 4352-token prompt
    and 4 decode steps, each peak against the dry run's within
    ``TP_PEAK_TOL``; finite losses, logits and tokens in range; the split
    mode, flash and decode launched. The fake group's all-to-all leaves its
    output unwritten on the card, so the check fills each received piece as
    the fake group does on the CPU (the rank's own first rows).
    Then one rank of xlstm-125m on a (data 1, model 16) mesh, the grid's
    model size, at full width and one unit (3 mLSTM cells and an sLSTM
    cell; ``tp_xlstm_phase``): its 4 heads do not divide 16, so every cell
    computes a quarter of one head, its scores, q and k and sLSTM's hidden
    state summed or gathered over the head's 4 ranks (a subgroup of the fake
    group). A train step at seq 4096, batch 2, then a prefill of the
    4352-token prompt and 4 decode steps, each peak (from the end of the
    weights' draw) against the dry run's within ``TP_PEAK_TOL``; the grad
    norm finite, every cell on a head part, the split mode launched, the
    head groups' collectives counted. The fake group's all-gathers and
    reduce-scatters leave their outputs unwritten on the card too, so they
    are filled as well (``filled_collectives``). The rank's dry runs trace
    the sLSTM a step at a time (~60 s of host time), so a child process
    makes them beside ``[fabric]`` and ``[drills]``, which are held to no
    roofline, and is done before the timed phases (``xlstm_dry_runs``).
 12. dryrun: ``repro_torch.launch.dryrun`` traces the two gemma2-2b cells of
    3 and 4 (the prefill at 2 x 4352; the train step at seq 4096, batch 2, 2
    microbatches, remat full, adamw) on the meta device for one device and
    prints their counted and model FLOPs, the three roofline terms at the
    H100's peaks (``launch/mesh.py``), the dominant term and the bound, the
    measured time (3's ``prefill_s``, 4's median step s), the roofline share
    (bound / measured) and the MFU (model FLOPs / (989e12 x measured)), and
    the predicted peak beside ``max_memory_allocated``; the record's train
    roofline is at one microbatch (the JAX package's rule) and printed, the
    card's step held to the terms at its own 2 microbatches. It fails where the
    predicted argument bytes (parameters, optimizer state, cache, batch)
    differ from the real tensors', where the share or the MFU exceeds 1.05
    (a count too high), or where ``HBM_BYTES`` exceeds the card's
    ``total_memory``.
At start-up ``common/torch_compat.py`` checks the torch release and the card
(compute capability 9.0, CUDA 12) and prints one line.
They run in the order 1, 2, 5, 6, 7, 9, 3, 4, 12, 11, 13, 8, 10: late in the process (after the
train phase) torch.profiler dropped the records of short profiled windows, so
the detection kernels are timed first.
The line before the last is a JSON ``kernels`` record; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
and prints no result.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import hashlib
import json
import math
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
# fp32 CUDA cores, HBM3 bandwidth; launch/mesh.py holds them for the roofline too
try:
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16, PEAK_FLOPS_FP32
except ImportError as e:
    sys.exit(f"FAIL: this script runs from the root of the repository ({e})")
PEAK_FLOPS = {"bfloat16": PEAK_FLOPS_BF16, "float32": PEAK_FLOPS_FP32}
PEAK_BYTES = HBM_BW
ITERS = 20                                   # timed launches per measurement
PROFILE_ATTEMPTS = 8                         # profiled windows before "not measured"

# the __global__ functions each wrapper may launch (parts of their names)
FLASH_KERNELS = ("flash_wgmma_kernel", "flash_fwd_kernel")
DECODE_KERNELS = ("decode_tma_kernel", "decode_partial_kernel", "decode_combine_kernel",
                  "decode_merge_kernel", "decode_empty_kernel")
RMSNORM_KERNELS = ("rmsnorm_block_kernel",)
RMSNORM_SPLIT_KERNELS = ("rmsnorm_sumsq_kernel", "rmsnorm_scale_kernel")
# the copies a call in group passes makes around its kernel launches
PASS_COPIES = ("direct_copy_kernel",)

# gemma2-2b serving shapes of this smoke run
B, PROMPT, STEPS = 2, 4352, 32
H, HKV, D, WINDOW, CAP = 8, 4, 256, 4096, 50.0
CACHE = PROMPT + STEPS
# gemma2-2b training of this smoke run: the config's seq 4096, batch cut to 2;
# a crash of rank 9 (node 1 of SIM_NODES) before step FAULT_STEP
TRAIN_BATCH, TRAIN_STEPS = 2, 3
FAULT_KIND, FAULT_RANK, FAULT_STEP, SIM_NODES = "crash", 9, 2, 4
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


def device_ms(fn, iters: int, names=None, by_name=None, calls=None) -> float | None:
    """Device time of one call of ``fn`` (torch.profiler): each kernel's mean
    time a launch over ``iters`` profiled calls, times the launches one call
    makes, summed over the call's kernels. The launches a call makes are
    counted in a profiled call of its own (a library call launches several
    kernels); where the profiler recorded fewer launches than were made, the
    shortfall is printed, and the mean a launch stands. ``names``: the
    kernels ``fn`` launches (parts of their names; copies and memsets aside),
    or None for a library call: a launched kernel that matches none fails
    the run, so that a renamed or added ``__global__`` cannot drop out of
    the sum. ``by_name``, a dict, receives each name's ms per call, and
    ``calls`` each name's launches a call. None
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
        if calls is not None:
            calls[hit[0]] = calls.get(hit[0], 0) + per_call
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


def path_check(name: str, kind: str, q, k, calls: dict) -> None:
    """Fail unless one call launched the kernels that the wrapper's dispatch
    rule names for this shape, once a group pass each, and no other."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    group = q.shape[2] // k.shape[2]
    passes = -(-group // fa.pass_group(group))
    if kind == "flash":
        fast = fa.wgmma_path(q.dtype, q.shape[3], fa.pass_group(group))
        want = ["flash_wgmma_kernel"] if fast else ["flash_fwd_kernel"]
    else:
        fast = da.tma_path(q.dtype, q.shape[3], fa.pass_group(group))
        want = ["decode_tma_kernel"] if fast else ["decode_partial_kernel", "decode_combine_kernel"]
    want = dict.fromkeys(want, passes)
    print(f"    kernels a call: {calls or 'not measured'} (the dispatch rule: {want})", flush=True)
    if calls != want:
        fail(f"{name}: a call launched {calls or 'nothing the profiler recorded'}; the dispatch "
             f"rule names {want}")


def time_flash(name, q, k, v, kw, dt: str, iters: int):
    """Event and device ms of the flash kernel, its plain version and causal
    SDPA (no window, no cap; a yardstick only, never called by the port) on
    the same q, k, v, and the bound; the kernels a call launched held to the
    dispatch rule. Returns the row (ms, plain, lib, bound_ms, bound_by,
    device_ms, library_device_ms, {kernel: launches a call})."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_fwd

    b, s, h, d = q.shape
    hkv, w = k.shape[2], kw["window"]
    n_keys = sum(min(i + 1, w) if w else i + 1 for i in range(s))
    flops = 4.0 * b * h * n_keys * d
    nbytes = 2.0 * (q.numel() + k.numel()) * q.element_size()
    b_ms, b_by = bound(flops, nbytes, dt)
    ms = time_ms(lambda: flash_attention_fwd(q, k, v, **kw), iters)
    calls = {}
    dev = device_ms(lambda: flash_attention_fwd(q, k, v, **kw), iters, FLASH_KERNELS, calls=calls)
    path_check(name, "flash", q, k, calls)
    plain = time_ms(lambda: ref.flash_attention(q, k, v, **kw), max(2, iters // 4))
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
    return (ms, plain, lib, b_ms, b_by, dev, lib_dev, calls)


def flash_phase(iters: int):
    import torch
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
        rows.append(time_flash(name, q, k, v, kw, dt, iters))
    return tuple(max(e[i] for e in errs) for i in range(2)), rows


# the flash kernel with a query offset: the last of SEQ_SHARDS shards of the
# PROMPT-token prefill, as the last model rank of a (1, 8) mesh runs it under
# the "sequence" attention mode: (label, (h, hkv, d), window, cap, dtype)
SEQ_SHARDS = 8
OFFSET_CASES = [
    ("gemma2-2b local", (H, HKV, D), WINDOW, CAP, "bfloat16"),
    ("gemma2-2b global", (H, HKV, D), 0, CAP, "bfloat16"),
    ("yi-34b", (56, 8, 128), 0, 0.0, "bfloat16"),          # group 7: one pass
    ("stablelm-12b", (32, 8, 160), 0, 0.0, "bfloat16"),
    ("gemma2-2b local float32", (H, HKV, D), WINDOW, CAP, "float32"),   # the CUDA cores
]


def flash_offset_phase(iters: int, card: str):
    """The flash kernel's query offset (``q_offset``) at ``OFFSET_CASES``:
    q of the last shard's Sq = PROMPT / SEQ_SHARDS positions at q_off =
    PROMPT - Sq against all PROMPT keys, batch B. Each row is held per row
    within ``ROW_REL_TOL`` of the plain version with ``q_offset`` and of rows
    [q_off, PROMPT) of the whole-sequence launch; a planted fault (q_off off
    by one) must read above the limit. The same q and keys at offset 0
    (the first shard, a prefix of the keys) must equal the whole launch's
    first rows bit for bit, and a launch with ``q_offset=0`` and Sk = Sq the
    whole launch. Times: the offset launch's event and device ms beside the
    whole-sequence launch's event ms, the plain version's, the bound (the (query,
    key) pairs the mask keeps, each input read once) and, without a cap,
    SDPA with an explicit boolean mask of those rows (the kv heads repeated
    first) as the library call. Returns ((max_abs_err, max_row_rel_err),
    {case: row})."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_fwd

    gen = torch.Generator(device="cuda").manual_seed(32)
    sq = PROMPT // SEQ_SHARDS
    q_off = PROMPT - sq
    errs, rows = [], {}
    for label, (h, hkv, d), w, cap, dtype in OFFSET_CASES:
        dt = getattr(torch, dtype)
        q = randn((B, PROMPT, h, d), dt, gen)
        k, v = randn((B, PROMPT, hkv, d), dt, gen), randn((B, PROMPT, hkv, d), dt, gen)
        kw = dict(window=w, logit_cap=cap, scale=d ** -0.5)
        qs = q[:, q_off:].contiguous()
        name = (f"flash offset {label} {dtype} (b,sq,sk,h,hkv,d)={(B, sq, PROMPT, h, hkv, d)} "
                f"q_off={q_off} window={w} cap={cap:g}")
        got = flash_attention_fwd(qs, k, v, q_offset=q_off, **kw)
        whole = flash_attention_fwd(q, k, v, **kw)
        want = ref.flash_attention(qs, k, v, q_offset=q_off, **kw)
        errs.append(compare(name, got, want, [
            ("q_off off by one", ref.flash_attention(qs, k, v, q_offset=q_off + 1, **kw))]))
        vs_whole = ref.max_row_rel_err(got, whole[:, q_off:])
        first = flash_attention_fwd(q[:, :sq].contiguous(), k, v, q_offset=0, **kw)
        at_zero = flash_attention_fwd(q, k, v, q_offset=0, **kw)
        torch.cuda.synchronize()
        prefix_equal = torch.equal(first, whole[:, :sq])
        zero_equal = torch.equal(at_zero, whole)
        rows_equal = torch.equal(got, whole[:, q_off:])
        print(f"    against the whole-sequence launch's rows {q_off}..{PROMPT - 1}: "
              f"max_row_rel_err {vs_whole:.3e} (limit {ref.ROW_REL_TOL[dt]:g}; bit-equal "
              f"{rows_equal}); offset 0, the first {sq} rows: bit-equal {prefix_equal}; "
              f"q_offset=0, Sk = Sq: bit-equal to the whole launch {zero_equal}", flush=True)
        if vs_whole > ref.ROW_REL_TOL[dt] or not prefix_equal or not zero_equal:
            fail(f"{name}: the offset launch misses the whole launch's rows, or offset 0 "
                 "differs from the whole launch")
        del got, whole, want, first, at_zero
        pos = range(q_off, PROMPT)
        n_keys = sum(min(i + 1, w) if w else i + 1 for i in pos)
        lo = max(0, q_off - w + 1) if w else 0
        flops = 4.0 * B * h * n_keys * d
        nbytes = (2.0 * qs.numel() + 2.0 * B * (PROMPT - lo) * hkv * d) * qs.element_size()
        b_ms, b_by = bound(flops, nbytes, dtype)
        ms = time_ms(lambda: flash_attention_fwd(qs, k, v, q_offset=q_off, **kw), iters)
        dev = device_ms(lambda: flash_attention_fwd(qs, k, v, q_offset=q_off, **kw), iters,
                        FLASH_KERNELS)
        # the whole launch by events only: its device ms at these shapes are
        # the main rows' (gemma2-2b) and model_kernel_phase's (yi-34b, stablelm-12b)
        whole_ms = time_ms(lambda: flash_attention_fwd(q, k, v, **kw), iters)
        plain = time_ms(lambda: ref.flash_attention(qs, k, v, q_offset=q_off, **kw), 2)
        lib = lib_dev = None
        if not cap:
            qpos = torch.arange(q_off, PROMPT, device="cuda")
            mask = ref.causal_window_mask(qpos, torch.arange(PROMPT, device="cuda"), w)
            qt = qs.transpose(1, 2).contiguous()
            kt = k.repeat_interleave(h // hkv, dim=2).transpose(1, 2).contiguous()
            vt = v.repeat_interleave(h // hkv, dim=2).transpose(1, 2).contiguous()

            def run_lib():
                F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=d ** -0.5)

            lib, lib_dev = time_ms(run_lib, iters), device_ms(run_lib, iters)
            del qt, kt, vt
        print(f"  time {name}: kernel_ms={ms:.5f} device_ms={_ms(dev)}; the whole "
              f"{PROMPT}-position launch {whole_ms:.5f} ms by events; "
              f"plain_ms={plain:.5f} library_ms={_ms(lib)} library_device_ms={_ms(lib_dev)} "
              f"({'none: no library call has a soft-cap' if cap else 'SDPA, a boolean mask'}); "
              f"bound_ms={b_ms:.5f} ({b_by}; {flops:.4e} FLOP, {nbytes:.4e} B) "
              f"bound/device={_share(b_ms, dev)}; {card}", flush=True)
        rows[label] = {"ms": ms, "device_ms": dev, "whole_ms": whole_ms,
                       "plain_ms": plain, "library_ms": lib,
                       "library_device_ms": lib_dev, "bound_ms": b_ms, "bound_by": b_by,
                       "max_row_rel_err_vs_whole": vs_whole, "bit_equal_to_whole": rows_equal,
                       "q_offset": q_off, "sq": sq, "sk": PROMPT}
    return tuple(max(e[i] for e in errs) for i in range(2)), rows


def time_decode(name, sets, pos: int, kw, iters: int):
    """Event and device ms of the decode kernel at ``pos``, its plain version
    and SDPA over the keys in range (no cap; a yardstick only), each cycling
    the cache ``sets`` so that the L2 does not hold the cache a launch reads,
    and the bound; the kernels a call launched held to the dispatch rule.
    Returns the row as ``time_flash`` does."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_fwd, tma_path
    from repro_torch.kernels.flash_attention import pass_group

    q0, k0, _ = sets[0]
    b, _, h, d = q0.shape
    hkv, w = k0.shape[2], kw["window"]
    lo = max(0, pos - w + 1) if w else 0
    n = pos - lo + 1
    flops = 4.0 * b * h * n * d
    nbytes = (2.0 * b * n * hkv * d + 2.0 * q0.numel()) * q0.element_size()
    b_ms, b_by = bound(flops, nbytes, str(q0.dtype)[6:])
    it = iter(range(1 << 30))

    def run_kernel():
        qq, kk, vv = sets[next(it) % len(sets)]
        decode_attention_fwd(qq, kk, vv, pos, **kw)

    def run_plain():
        qq, kk, vv = sets[next(it) % len(sets)]
        ref.decode_attention(qq, kk, vv, pos, **kw)

    ms = time_ms(run_kernel, iters * 4)
    calls = {}
    dev = device_ms(run_kernel, iters * 4, DECODE_KERNELS, calls=calls)
    path_check(name, "decode", q0, k0, calls)
    plain = time_ms(run_plain, iters)
    libs = [(qq.transpose(1, 2).contiguous(),
             kk[:, lo:pos + 1].repeat_interleave(h // hkv, dim=2).transpose(1, 2).contiguous(),
             vv[:, lo:pos + 1].repeat_interleave(h // hkv, dim=2).transpose(1, 2).contiguous())
            for qq, kk, vv in sets]

    def run_lib():
        qq, kk, vv = libs[next(it) % len(libs)]
        F.scaled_dot_product_attention(qq, kk, vv, scale=d ** -0.5)

    lib, lib_dev = time_ms(run_lib, iters * 4), device_ms(run_lib, iters * 4)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    path = (f"one launch, {len(ref.plan_splits(lo, pos, n_sm, b, hkv))} splits on {n_sm} SMs"
            if tma_path(q0.dtype, d, pass_group(h // hkv)) else "split-K + combine")
    print(f"  time {name}: kernel_ms={ms:.5f} device_ms={_ms(dev)} plain_ms={plain:.5f} "
          f"library_ms={lib:.5f} library_device_ms={_ms(lib_dev)} bound_ms={b_ms:.5f} "
          f"({b_by}; {flops:.4e} FLOP, {nbytes:.4e} B) bound/kernel={b_ms / ms:.4f} "
          f"bound/device={_share(b_ms, dev)} ({path})", flush=True)
    return (ms, plain, lib, b_ms, b_by, dev, lib_dev, calls)


def decode_phase(iters: int):
    import torch
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
        rows.append(time_decode(name, sets, pos, kw, iters))
        # after the timed launches, on another cache set: a stale partial or
        # a counter left non-zero would show here
        qq, kk, vv = sets[2]
        errs.append(compare(name + " again, cache set 2", decode_attention_fwd(qq, kk, vv, pos, **kw),
                            ref.decode_attention(qq, kk, vv, pos, **kw)))
    return tuple(max(e[i] for e in errs) for i in range(2)), rows


# the decode kernel's shard mode: the cache cut into SHARDS shards over its
# sequence, as a rank of a (1, 8) mesh holds it in sharded serving, at
# gemma2-2b's decode shape (window, cap; the TMA kernel's 2-head instance),
# stablelm-12b's (32 heads on 8, 160: the 4-head instance) and yi-34b's (56
# heads on 8, 128: the 8-head instance), and on the split-K + combine path
# (float32 at gemma2-2b's heads, its window cut to 1024 so that the first
# shards lie wholly before it); (label, (b, cache, h, hkv, d), window, cap,
# dtype, positions): at the positions below CACHE - 1 the last shards lie
# wholly past pos
SHARDS = 8
SHARD_CASES = [
    ("gemma2-2b", (B, CACHE, H, HKV, D), WINDOW, CAP, "bfloat16", (CACHE - 1, 3000)),
    ("stablelm-12b", (B, CACHE, 32, 8, 160), 0, 0.0, "bfloat16", (3000,)),
    ("yi-34b", (B, CACHE, 56, 8, 128), 0, 0.0, "bfloat16", (CACHE - 1, 2000)),
    ("split-K float32", (B, CACHE, H, HKV, D), 1024, CAP, "float32", (CACHE - 1,)),
    # a group of 12 in passes of 6 a kv head (two launches a shard); no
    # shipped config has a group above 8 (yi-34b's 7 is the largest)
    ("synthetic group 12, no shipped config", (B, CACHE, 48, 4, 128), 0, 0.0, "bfloat16",
     (CACHE - 1,)),
]
LSE_TOL = 1e-3            # |lse - the plain lse| of a shard, fp32 sums of the inputs


def shard_library(q, shards, pos: int, lo: int, cap: float, dtype: str, iters: int):
    """The shard mode's library counterpart, timed: one memory-efficient
    attention call (``aten._scaled_dot_product_efficient_attention`` with
    ``compute_log_sumexp``; aten's flash call where it refuses the shapes) a
    shard that holds a valid key, over those keys, the kv heads repeated to
    the query heads (made before the timing). Only without a soft-cap (no
    library call has one) and in bf16. Returns (events ms, device ms, calls)
    of the calls together, or (None, None, 0)."""
    import torch
    if cap or dtype != "bfloat16":
        return None, None, 0
    h, d = q.shape[2], q.shape[3]
    qt = q.transpose(1, 2)
    live = []
    for k0, kk, vv in shards:
        a, c = max(k0, lo), min(k0 + kk.shape[1], pos + 1)
        if a < c:
            live.append([t[:, a - k0:c - k0].repeat_interleave(h // t.shape[2], dim=2)
                         .transpose(1, 2).contiguous() for t in (kk, vv)])

    def efficient():
        return [torch.ops.aten._scaled_dot_product_efficient_attention(
            qt, kl, vl, None, True, scale=d ** -0.5) for kl, vl in live]

    def flash():
        return [torch.ops.aten._scaled_dot_product_flash_attention(
            qt, kl, vl, scale=d ** -0.5) for kl, vl in live]

    for label, library in (("memory-efficient", efficient), ("flash", flash)):
        try:
            library()
        except RuntimeError as e:
            print(f"    library: the {label} call refused these shapes ({str(e)[:120]})",
                  flush=True)
            continue
        print(f"    library: aten's {label} attention with its log-sum-exp", flush=True)
        return time_ms(library, iters), device_ms(library, iters), len(live)
    return None, None, 0


def shard_decode_phase(iters: int, card: str):
    """The decode kernel's shard mode (``k0``, ``return_lse``): each of
    ``SHARD_CASES``' caches cut into ``SHARDS`` contiguous shards, each
    launched at its global offset. The partials are float32 and merged on
    the card (``ref.merge_shards``, float32) and held per row within
    ``ROW_REL_TOL[float32]`` of the plain shards merged; rounded once to the
    inputs' dtype, within ``ROW_REL_TOL`` of that dtype of the plain whole-
    cache version and of the whole-cache launch; every shard's lse within
    ``LSE_TOL`` of its plain version's; a wholly masked shard zero with lse
    NEG_INF; a planted fault (the shard holding pos launched one 64-key tile
    late) above the limit. Each shard launch's event ms, the 8 launches'
    device ms beside the card. Returns ((max_abs_err, max_row_rel_err),
    {case: row})."""
    import torch
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_fwd
    from repro_torch.kernels.flash_attention import MAX_GROUP

    gen = torch.Generator(device="cuda").manual_seed(14)
    errs, rows = [], {}
    for label, (b, s, h, hkv, d), w, cap, dtype, positions in SHARD_CASES:
        dt = getattr(torch, dtype)
        q = randn((b, 1, h, d), dt, gen)
        k, v = randn((b, s, hkv, d), dt, gen), randn((b, s, hkv, d), dt, gen)
        cuts = [i * s // SHARDS for i in range(SHARDS + 1)]
        shards = [(a, k[:, a:c].contiguous(), v[:, a:c].contiguous())
                  for a, c in zip(cuts, cuts[1:])]
        kw = dict(window=w, logit_cap=cap, scale=d ** -0.5)
        for pos in positions:
            lo = max(0, pos - w + 1) if w else 0
            name = (f"decode shard mode {label} (b,cache,h,hkv,d)={(b, s, h, hkv, d)} {dtype} "
                    f"{SHARDS} shards of {s // SHARDS} pos={pos} window={w} cap={cap:g}")

            def launch_all():
                return [decode_attention_fwd(q, kk, vv, pos, k0=k0, return_lse=True, **kw)
                        for k0, kk, vv in shards]

            passes = -(-(h // hkv) // MAX_GROUP)
            before = da.launches
            parts = launch_all()
            if da.launches - before != SHARDS * passes:
                fail(f"{name}: {da.launches - before} launches for {SHARDS} shards in {passes} "
                     "group pass(es) each")
            plain_parts = [ref.decode_attention_shard(q, kk, vv, pos, k0=k0, **kw)
                           for k0, kk, vv in shards]
            if any(o.dtype != torch.float32 for o, _ in parts):
                fail(f"{name}: a shard's output is not float32")
            empty = [i for i, (k0, kk, _) in enumerate(shards)
                     if k0 > pos or k0 + kk.shape[1] <= lo]
            for i in empty:
                o, l = parts[i]
                if o.any() or not bool((l == ref.NEG_INF).all()):
                    fail(f"{name}: the wholly masked shard {i} is not out 0, lse NEG_INF")
            lse_err = max((l - pl).abs().max().item() for (_, l), (_, pl) in
                          zip(parts, plain_parts) if bool((pl > ref.NEG_INF).all()))
            hold = max(i for i, (k0, _, _) in enumerate(shards) if k0 <= pos)
            late = [ref.decode_attention_shard(q, kk, vv, pos, k0=k0 + (64 if i == hold else 0),
                                               **kw) for i, (k0, kk, vv) in enumerate(shards)]
            merged = ref.merge_shards(*zip(*parts))
            errs.append(compare(name, merged, ref.merge_shards(*zip(*plain_parts)), [
                (f"the shard holding pos ({hold}) launched one 64-key tile late",
                 ref.merge_shards(*zip(*late)))]))
            once = merged.to(dt)
            whole = decode_attention_fwd(q, k, v, pos, **kw)
            vs_plain = ref.max_row_rel_err(once, ref.decode_attention(q, k, v, pos, **kw))
            vs_whole = ref.max_row_rel_err(once, whole)
            print(f"    rounded once to {dtype}: max_row_rel_err {vs_plain:.3e} against the plain "
                  f"whole-cache version, {vs_whole:.3e} against the whole-cache launch (limit "
                  f"{ref.ROW_REL_TOL[dt]:g}); wholly masked shards {empty}; max |lse - plain lse| "
                  f"{lse_err:.3e} (limit {LSE_TOL:g})", flush=True)
            if max(vs_plain, vs_whole) > ref.ROW_REL_TOL[dt] or lse_err > LSE_TOL:
                fail(f"{name}: the merged shards miss the whole-cache version or launch, or the "
                     "lse its plain version")
            each = [time_ms(lambda kk=kk, vv=vv, k0=k0: decode_attention_fwd(
                q, kk, vv, pos, k0=k0, return_lse=True, **kw), iters) for k0, kk, vv in shards]
            # a group above MAX_GROUP: each pass's q heads copied out and its
            # out and lse columns written back (``shard_passes``), counted
            dev = device_ms(launch_all, iters,
                            DECODE_KERNELS + (PASS_COPIES if passes > 1 else ()))
            whole_ms = time_ms(lambda: decode_attention_fwd(q, k, v, pos, **kw), iters)
            plain_ms = time_ms(lambda: ref.merge_shards(*zip(*[ref.decode_attention_shard(
                q, kk, vv, pos, k0=k0, **kw) for k0, kk, vv in shards])), 2)
            lib_ms, lib_dev, lib_calls = shard_library(q, shards, pos, lo, cap, dtype, iters)
            n_keys = max(0, pos - lo + 1)
            flops = 4.0 * b * h * n_keys * d
            es = q.element_size()
            # the valid keys and each live shard's q read; every shard's
            # float32 out and lse written
            nbytes = (2.0 * b * n_keys * hkv * d + (SHARDS - len(empty)) * q.numel()) * es \
                + 4.0 * SHARDS * (q.numel() + b * h)
            b_ms, b_by = bound(flops, nbytes, dtype)
            print(f"  time {name}: each shard's launch ms (events) {[round(x, 5) for x in each]}; "
                  f"the {SHARDS * passes} launches {sum(each):.5f} ms by events, "
                  f"device_ms={_ms(dev)}; "
                  f"whole-cache launch {whole_ms:.5f} ms; plain shards and merge {plain_ms:.5f} ms; "
                  f"library ({lib_calls} calls over the shards' valid keys, lse computed) "
                  f"{'none: no library call has a soft-cap' if cap else _ms(lib_ms)} ms by events, "
                  f"device_ms={_ms(lib_dev)}; bound_ms={b_ms:.5f} ({b_by}; {flops:.4e} FLOP, "
                  f"{nbytes:.4e} B; the L2 holds the {SHARDS} shards between launches: warm); "
                  f"{card}", flush=True)
            rows[f"{label} pos={pos}"] = {"ms": sum(each), "shard_ms": each, "device_ms": dev,
                                          "launches": SHARDS * passes,
                                          "whole_cache_ms": whole_ms, "plain_ms": plain_ms,
                                          "library_ms": lib_ms, "library_device_ms": lib_dev,
                                          "library_calls": lib_calls,
                                          "bound_ms": b_ms, "bound_by": b_by,
                                          "max_row_rel_err_vs_whole": vs_whole,
                                          "wholly_masked_shards": empty}
    return tuple(max(e[i] for e in errs) for i in range(2)), rows


WIDE_CASES = [  # (kind, (b, s, h, hkv, d), window, cap, dtype): the wrappers' lifted limits
    ("flash", (1, 2048, 32, 2, 128), 1024, CAP, "bfloat16"),    # group 16: 2 passes of 8
    ("decode", (2, 4384, 32, 2, 128), WINDOW, CAP, "bfloat16"),
    ("flash", (2, 600, 18, 2, 64), 0, 0.0, "float32"),          # group 9: passes of 5 and 4
    ("decode", (1, 700, 18, 2, 64), 0, 30.0, "float32"),
    ("flash", (1, 1024, 8, 4, 320), 512, CAP, "float32"),       # head_dim 320: 2 column passes
    ("flash", (1, 1024, 8, 4, 320), 512, CAP, "bfloat16"),
    ("decode", (2, 2048, 8, 4, 320), 1024, CAP, "float32"),
    ("decode", (2, 2048, 8, 4, 320), 1024, CAP, "bfloat16"),
]


def wide_attention_phase() -> float:
    """Flash and decode at a group above 8 (the wrappers' passes of at most
    8 query heads a kv head) and a head_dim above 256 (the CUDA-core
    kernels' passes of 256 output columns), per row against their plain
    versions, with a planted fault each (a pass's heads written back into
    the wrong columns; the last 64 columns of V dropped). Prints the
    launches each call made. Returns the largest row error."""
    import torch
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(13)
    worst = 0.0
    for kind, (b, s, h, hkv, d), w, cap, dt in WIDE_CASES:
        dtype = getattr(torch, dt)
        q = randn((b, s if kind == "flash" else 1, h, d), dtype, gen)
        k, v = randn((b, s, hkv, d), dtype, gen), randn((b, s, hkv, d), dtype, gen)
        kw = dict(window=w, logit_cap=cap, scale=d ** -0.5)
        plain = ((lambda qq, kk, vv: ref.flash_attention(qq, kk, vv, **kw)) if kind == "flash"
                 else (lambda qq, kk, vv: ref.decode_attention(qq, kk, vv, s - 1, **kw)))
        mod = fa if kind == "flash" else da
        before = mod.launches
        got = (fa.flash_attention_fwd(q, k, v, **kw) if kind == "flash"
               else da.decode_attention_fwd(q, k, v, s - 1, **kw))
        torch.cuda.synchronize()
        passes = mod.launches - before
        group = h // hkv
        if passes != -(-group // fa.MAX_GROUP):
            fail(f"{kind} at group {group}: {passes} launches")
        if group > fa.MAX_GROUP:   # heads of the second pass written one column block early
            half = -(-group // -(-group // fa.MAX_GROUP))
            perm = torch.arange(h).view(hkv, group).roll(-half, dims=1).reshape(h)
            fault = ("a pass's heads in the wrong columns", plain(q, k, v)[:, :, perm])
        else:
            vv = v.clone()
            vv[..., -64:] = 0
            fault = ("the last 64 columns of V dropped", plain(q, k, vv))
        name = (f"{kind} {dt} (b,s,h,hkv,d)={(b, s, h, hkv, d)} group={group} window={w} "
                f"cap={cap:g}: {passes} launch(es)")
        worst = max(worst, compare(name, got, plain(q, k, v), [fault])[1])
    return worst


def time_rmsnorm(shape, gen, iters: int):
    """Event and device ms of the RMSNorm kernel on bf16 rows of ``shape``,
    its plain version and ``F.rms_norm`` (weight 1 + scale precomputed; a
    yardstick only, never called by the port), 4 input sets cycled so that
    the 50 MB L2 does not hold the rows a launch reads, and the bound.
    Returns the row as ``time_flash`` does, and the cycling helper."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import rmsnorm_fwd

    eps = 1e-6
    dtype = torch.bfloat16
    sets = [(randn(shape, dtype, gen), randn(shape[-1:], dtype, gen, 0.1)) for _ in range(4)]
    weights = [(1.0 + s.float()).to(dtype) for _, s in sets]
    it = iter(range(1 << 30))

    def cycled(fn):
        def run():
            i = next(it) % len(sets)
            fn(sets[i][0], sets[i][1], weights[i])
        return run

    ms = time_ms(cycled(lambda x, s, w: rmsnorm_fwd(x, s, eps)), iters * 4)
    dev = device_ms(cycled(lambda x, s, w: rmsnorm_fwd(x, s, eps)), iters * 4, RMSNORM_KERNELS)
    plain = time_ms(cycled(lambda x, s, w: ref.rmsnorm(x, s, eps)), iters * 4)
    run_lib = cycled(lambda x, s, w: F.rms_norm(x, (shape[-1],), w, eps))
    lib, lib_dev = time_ms(run_lib, iters * 4), device_ms(run_lib, iters * 4)
    n = sets[0][0].numel()
    nbytes = (2.0 * n + shape[-1]) * 2
    b_ms, b_by = bound(4.0 * n, nbytes, "float32")
    print(f"  time rmsnorm bfloat16 x={shape}: kernel_ms={ms:.5f} device_ms={_ms(dev)} "
          f"plain_ms={plain:.5f} library_ms={lib:.5f} library_device_ms={_ms(lib_dev)} "
          f"bound_ms={b_ms:.5f} ({b_by}; {nbytes:.4e} B) bound/kernel={b_ms / ms:.4f} "
          f"bound/device={_share(b_ms, dev)}", flush=True)
    return (ms, plain, lib, b_ms, b_by, dev, lib_dev), cycled


def rmsnorm_phase(iters: int):
    import ctypes
    import torch
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
        row, cycled = time_rmsnorm(shape, gen, iters)
        rows.append(row)
        ms, _, lib, _, _, dev, _ = row
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


# (shape, shards, whose norm): the gated norms over d_inner that the split
# mode runs on a mesh, at a prefill of 4352 tokens; the first is timed into
# the JSON's row, each case's times go beside it under "cases"
SPLIT_CASES = [
    ((2, 4352, 7168), 8, "zamba2-7b Mamba2, model 8"),    # 14 of 112 heads a rank
    ((2, 4352, 1536), 16, "xlstm-125m mLSTM, model 16"),  # a quarter of a head: 96 columns
    ((2, 4352, 768), 16, "xlstm-125m sLSTM, model 16"),   # a quarter of a head: 48 columns
]


def rmsnorm_split_phase(iters: int, card: str):
    """RMSNorm's split mode at each of ``SPLIT_CASES`` (module docstring).
    Returns ((max_abs_err, max_row_rel_err) over the cases, one timed row a
    case as ``time_rmsnorm``'s with the whole-row launch's device ms)."""
    errs, rows = [], []
    for i, (shape, shards, label) in enumerate(SPLIT_CASES):
        err, row = split_case(iters, card, shape, shards, label, 17 + i)
        errs.append(err)
        rows.append(row)
    return tuple(max(e[i] for e in errs) for i in range(2)), rows


def split_case(iters: int, card: str, shape, shards: int, label: str, seed: int):
    """One case of ``rmsnorm_split_phase``: bf16 rows of ``shape`` cut into
    ``shards`` column shards, against the plain whole row, the planted fault
    and the whole-row launch, then timed."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as norm

    gen = torch.Generator(device="cuda").manual_seed(seed)
    eps, dtype = 1e-6, torch.bfloat16
    width = shape[-1]

    def inputs():
        x = randn(shape, dtype, gen)
        scale = randn((width,), dtype, gen, 0.1)
        return (x, scale, [c.contiguous() for c in x.chunk(shards, -1)],
                list(scale.chunk(shards)))

    def split(xs, ss, total=None):
        if total is None:
            total = sum(norm.rmsnorm_sumsq(a) for a in xs)
        return torch.cat([norm.rmsnorm_scale(a, total, b, width, eps) for a, b in zip(xs, ss)],
                         -1)

    x, scale, xs, ss = inputs()
    name = (f"rmsnorm split mode bfloat16 {label} x={shape} in {shards} shards of "
            f"{width // shards}")
    got = split(xs, ss)
    err = compare(name, got, ref.rmsnorm(x, scale, eps),
                  [(ref.RMSNORM_SPLIT_FAULT,
                    torch.cat(ref.rmsnorm_split_fault(xs, ss, eps), -1))])
    compare(name + " against the whole-row launch", got, norm.rmsnorm_fwd(x, scale, eps))

    sets = [inputs() for _ in range(4)]
    totals = [sum(ref.rmsnorm_sumsq(a) for a in st[2]) for st in sets]
    weights = [(1.0 + st[1].float()).to(dtype) for st in sets]
    it = iter(range(1 << 30))

    def cycled(fn):
        def run():
            i = next(it) % len(sets)
            fn(i)
        return run

    # the shards' two launches each; the sums' addition (the all-reduce on a
    # mesh) is not the kernel's
    def launches(i):
        _, _, xs_, ss_ = sets[i]
        for a in xs_:
            norm.rmsnorm_sumsq(a)
        for a, b in zip(xs_, ss_):
            norm.rmsnorm_scale(a, totals[i], b, width, eps)

    ms = time_ms(cycled(launches), iters * 4)
    dev = device_ms(cycled(launches), iters * 4, RMSNORM_SPLIT_KERNELS)
    whole_dev = device_ms(cycled(lambda i: norm.rmsnorm_fwd(sets[i][0], sets[i][1], eps)),
                          iters * 4, RMSNORM_KERNELS)
    plain = time_ms(cycled(lambda i: ref.rmsnorm_split(sets[i][2], sets[i][3], eps)), iters * 4)
    run_lib = cycled(lambda i: F.rms_norm(sets[i][0], (width,), weights[i], eps))
    lib, lib_dev = time_ms(run_lib, iters * 4), device_ms(run_lib, iters * 4)
    n = x.numel()
    rows = n // width
    nbytes = (2.0 * n + width) * 2 + 2.0 * rows * shards * 4
    b_ms, b_by = bound(4.0 * n, nbytes, "float32")
    print(f"  time {name} ({2 * shards} launches): kernel_ms={ms:.5f} device_ms={_ms(dev)} "
          f"(the whole-row launch {_ms(whole_dev)}) plain_ms={plain:.5f} library_ms={lib:.5f} "
          f"library_device_ms={_ms(lib_dev)} (F.rms_norm of the whole rows) "
          f"bound_ms={b_ms:.5f} ({b_by}; {nbytes:.4e} B) bound/device={_share(b_ms, dev)}; "
          f"{card}", flush=True)
    return err, (ms, plain, lib, b_ms, b_by, dev, lib_dev, whole_dev)


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


ATTENTION_KINDS = ("dense", "moe", "shared_attn")


def norms_per_forward(cfg) -> int:
    """RMSNorm launches of one forward: 2 an attention block application (4
    with sandwich norms, 2 more with the qk norm; with MLA, its ``kv_norm``
    and, where the queries are low-rank, its ``q_norm``), 2 a cross block
    (``ln1``, ``ln2``) and 2 a recurrent block (``ln1`` and the cell's gated
    norm), and the final norm."""
    from repro_torch.models.transformer import layer_plan
    per_attn = (4 if cfg.post_block_norm else 2) + (2 if cfg.qk_norm else 0)
    if cfg.mla is not None:
        per_attn += 1 + bool(cfg.mla.q_lora_rank)
    return sum(per_attn if k in ATTENTION_KINDS else 2 for k in layer_plan(cfg)) + 1


def attention_applications(cfg) -> int:
    """Applications of a self-attention block in one forward (zamba2's shared
    block once a unit); MLA runs no attention kernel."""
    from repro_torch.models.transformer import layer_plan
    return 0 if cfg.mla is not None else sum(k in ATTENTION_KINDS for k in layer_plan(cfg))


def serve_phase():
    """gemma2-2b served through the kernels and through the plain path.
    Returns the kernels' launch counts and what ``[dryrun]`` holds its
    prefill cell to: ``prefill_s`` and the weights' bytes."""
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
    facts = {"seconds": res["prefill_s"], "weight_bytes": res["weight_bytes"]}
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
    return counts, facts


# --- the [models] configs: kernel rows at their shapes, serve and train -------

MODEL_ARCHS = ("yi-34b", "stablelm-12b", "musicgen-medium", "arctic-480b", "deepseek-v2-236b",
               "llama-3.2-vision-11b", "zamba2-7b", "xlstm-125m")
# serving depth on one card: the dense, audio, vision, hybrid and recurrent
# configs whole; arctic-480b cut to 2 layers (an MoE layer is 13.6 B
# parameters: 55.4 GB of bf16 weights at 2), deepseek-v2-236b to 6 (1 dense +
# 5 MoE: 42.5 GB, and ~14 GB of the chunked MLA prefill's fp32 scores at the
# peak)
MODEL_SERVE_LAYERS = {"yi-34b": 60, "stablelm-12b": 40, "musicgen-medium": 48,
                      "arctic-480b": 2, "deepseek-v2-236b": 6, "llama-3.2-vision-11b": 40,
                      "zamba2-7b": 81, "xlstm-125m": 12}
# training depth on one card: yi-34b and stablelm-12b cut to 4 layers (the
# optimizer state of all 60 / 40 does not fit 80 GB), musicgen-medium whole,
# deepseek-v2-236b 2 (1 dense + 1 MoE: 5.34 B parameters, ~43 GB of weights,
# accumulator, gradients and moment before activations), llama-3.2-vision-11b
# 5 (one unit, 4 dense + 1 cross: ~2.1 B parameters), zamba2-7b 13 (two units
# and a tail of 1: the shared block applied twice, both segments), xlstm-125m
# 4 (one unit, 3 mLSTM + 1 sLSTM: all 12 fit, but each sLSTM layer's loop
# over 4096 time steps under autograd is launch-bound, ~23 s of a 68-76 s
# step at 12 layers on an H100 80GB HBM3 at 700 W and its host, which would
# take the run past its time limit). arctic-480b is not trained on the card:
# one MoE layer and the embeddings are 14.1 B parameters, 28 GB each for the
# weights, the gradients and the moment
MODEL_TRAIN_LAYERS = {"yi-34b": 4, "stablelm-12b": 4, "musicgen-medium": 48,
                      "deepseek-v2-236b": 2, "llama-3.2-vision-11b": 5, "zamba2-7b": 13,
                      "xlstm-125m": 4}
MODEL_TRAIN_STEPS = 2
# the configs whose attention and RMSNorm shapes get kernel rows; arctic-480b's
# are yi-34b's (56 heads on 8, head_dim 128, d_model 7168), deepseek-v2-236b's
# d_model is stablelm-12b's, and its MLA norms get rows of their own;
# zamba2-7b's gated norm (7168 wide) is yi-34b's row; xlstm-125m has no
# attention, its norm rows are 768 (d_model, the sLSTM's) and 1536 (the mLSTM's)
KERNEL_ARCHS = ("yi-34b", "stablelm-12b", "musicgen-medium", "llama-3.2-vision-11b",
                "zamba2-7b", "xlstm-125m")


def model_attention_rows(arch: str, cfg, gen, errs: dict, rows: dict, iters: int) -> None:
    """Flash and decode at ``arch``'s prefill and decode shapes, each against
    its plain version with planted faults, then timed (``model_kernel_phase``)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_fwd
    from repro_torch.kernels.flash_attention import flash_attention_fwd

    dt, dtype = "bfloat16", torch.bfloat16
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    kw = dict(window=cfg.sliding_window, logit_cap=cfg.attn_logit_softcap, scale=d ** -0.5)
    if kw["window"] or kw["logit_cap"]:
        fail(f"{arch}: the planted faults below are for no window and no cap")
    q = randn((B, PROMPT, h, d), dtype, gen)
    k, v = randn((B, PROMPT, hkv, d), dtype, gen), randn((B, PROMPT, hkv, d), dtype, gen)
    # the partial box's columns (160: 128..159), else the last 32
    tail = d % 64 or 32
    cut = (f"V's columns {d - tail}..{d - 1} (the partial box) dropped" if d % 64
           else "V's last 32 columns dropped")
    v_cut = v.clone()
    v_cut[..., d - tail:] = 0
    name = f"flash {dt} {arch} (b,s,h,hkv,d)={(B, PROMPT, h, hkv, d)} window=0 cap=0"
    faults = [(f"window {WINDOW} instead of 0",
               ref.flash_attention(q, k, v, **{**kw, "window": WINDOW})),
              (cut, ref.flash_attention(q, k, v_cut, **kw))]
    errs["flash_attention"].append(compare(name, flash_attention_fwd(q, k, v, **kw),
                                           ref.flash_attention(q, k, v, **kw), faults))
    del faults, v_cut
    rows["flash_attention"][arch] = time_flash(name, q, k, v, kw, dt, iters)
    del q, k, v
    torch.cuda.empty_cache()

    sets = [(randn((B, 1, h, d), dtype, gen), randn((B, CACHE, hkv, d), dtype, gen),
             randn((B, CACHE, hkv, d), dtype, gen)) for _ in range(4)]
    q, kc, vc = sets[0]
    pos = CACHE - 1
    name = f"decode {dt} {arch} B={B} cache={CACHE} H={h} Hkv={hkv} D={d} pos={pos} window=0"
    vc_cut = vc.clone()
    vc_cut[..., d - tail:] = 0
    faults = [(f"window {WINDOW} instead of 0",
               ref.decode_attention(q, kc, vc, pos, **{**kw, "window": WINDOW})),
              ("last 128 keys dropped", ref.decode_attention(q, kc, vc, pos - 128, **kw)),
              (cut, ref.decode_attention(q, kc, vc_cut, pos, **kw))]
    got = decode_attention_fwd(q, kc, vc, pos, **kw)
    errs["decode_attention"].append(
        compare(name, got, ref.decode_attention(q, kc, vc, pos, **kw), faults))
    if not _bit_equal(decode_attention_fwd(q, kc, vc, pos, **kw), got):
        fail(f"{name}: two calls on the same inputs differ")
    rows["decode_attention"][arch] = time_decode(name, sets, pos, kw, iters)
    qq, kk, vv = sets[2]
    errs["decode_attention"].append(compare(
        name + " again, cache set 2", decode_attention_fwd(qq, kk, vv, pos, **kw),
        ref.decode_attention(qq, kk, vv, pos, **kw)))
    del sets, q, kc, vc, qq, kk, vv, got, faults, vc_cut
    torch.cuda.empty_cache()


def model_kernel_phase(iters: int):
    """Flash and decode at each of ``KERNEL_ARCHS``' prefill and decode shapes
    (its heads, kv heads and head_dim; no window, no cap; xlstm-125m has no
    attention), and RMSNorm at each one's d_model, at stablelm-12b's qk-norm
    rows (160 wide), at deepseek-v2-236b's ``kv_norm`` (512) and ``q_norm``
    (1536) rows and at xlstm-125m's mLSTM norm (1536), each against its
    plain version with planted faults (at a head_dim that is not whole
    64-column boxes, V's columns in the partial box dropped), then timed,
    the attention rows' kernels held to the dispatch rule. Returns {kernel:
    (max_abs_err, max_row_rel_err)} and {kernel: {label: row}}."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import rmsnorm_fwd

    gen = torch.Generator(device="cuda").manual_seed(14)
    dt, dtype, eps = "bfloat16", torch.bfloat16, 1e-6
    errs = {"flash_attention": [], "decode_attention": [], "rmsnorm": []}
    rows = {"flash_attention": {}, "decode_attention": {}, "rmsnorm": {}}
    for arch in KERNEL_ARCHS:
        cfg = get_config(arch).model
        if attention_applications(cfg):
            model_attention_rows(arch, cfg, gen, errs, rows, iters)
        norm_shapes = [(arch, (B, PROMPT, cfg.d_model))]
        if cfg.qk_norm:
            norm_shapes.append((f"{arch} qk", (B, PROMPT, cfg.n_heads, cfg.resolved_head_dim)))
        if arch == "musicgen-medium":   # deepseek-v2-236b's MLA norms, at its prefill
            mla = get_config("deepseek-v2-236b").model.mla
            norm_shapes += [("deepseek-v2-236b kv_norm", (B, PROMPT, mla.kv_lora_rank)),
                            ("deepseek-v2-236b q_norm", (B, PROMPT, mla.q_lora_rank))]
        if arch == "xlstm-125m":        # the mLSTM's norm, over its d_inner
            norm_shapes.append(("xlstm-125m mLSTM", (B, PROMPT, 2 * cfg.d_model)))
        for label, shape in norm_shapes:
            x = randn(shape, dtype, gen)
            scale = randn(shape[-1:], dtype, gen, 0.1)
            errs["rmsnorm"].append(compare(
                f"rmsnorm {dt} {label} x={shape}", rmsnorm_fwd(x, scale, eps),
                ref.rmsnorm(x, scale, eps),
                [(ref.RMSNORM_FAULTS["scale"], ref.rmsnorm_fault(x, scale, eps, "scale"))]))
            del x, scale
            rows["rmsnorm"][label] = time_rmsnorm(shape, gen, iters)[0]
    return ({name: tuple(max(e[i] for e in es) for i in range(2)) for name, es in errs.items()},
            rows)


def model_serve_run(arch: str):
    """The [models] serving run of ``arch``: depth ``MODEL_SERVE_LAYERS``."""
    from repro_torch.configs import get_config
    run = get_config(arch)
    return run.replace(model=dataclasses.replace(run.model, n_layers=MODEL_SERVE_LAYERS[arch]))


def model_serve(arch: str, card: str, profile_dir=None) -> dict:
    """``serve`` at full width and ``MODEL_SERVE_LAYERS`` depth: batch 2,
    the 4352-token prompt, 32 greedy steps; exact launch counts (an MLA
    model launches no attention kernel), tokens in range. A dense model's
    prefill logits against the same model served through the plain
    attention and norms (within 2e-2 of the largest |logit|, as gemma2-2b's);
    an MoE model's through ``moe_check``."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import MAX_GROUP
    from repro_torch.launch.serve import serve
    from repro_torch.models.transformer import layer_plan

    run = model_serve_run(arch)
    cfg = run.model
    n_layers, n_norms = cfg.n_layers, norms_per_forward(cfg)
    # attention launches: a pass of at most MAX_GROUP query heads a kv head
    n_attn = attention_applications(cfg) * -(-(cfg.n_heads // cfg.n_kv_heads) // MAX_GROUP)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = serve(run, batch=B, prompt_len=PROMPT, decode_steps=STEPS, device="cuda", seed=0)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {"flash_attention": n_attn, "decode_attention": n_attn * STEPS,
            "rmsnorm": n_norms * (1 + STEPS)}
    want_all = {"flash_attention": 2 * n_attn, "decode_attention": n_attn * (STEPS + 1),
                "rmsnorm": n_norms * (3 + STEPS)}
    toks, logits = res["tokens"], res["prefill_logits"]
    weights = res["weight_bytes"]
    print(f"  models serve {arch}: {n_layers} layers, prefill_s={res['prefill_s']:.4f} "
          f"decode_s={res['decode_s']:.4f} decode_tok_per_s={res['decode_tok_per_s']:.2f} "
          f"max_memory_allocated={peak / 1e9:.2f} GB; weights {weights / 1e9:.2f} GB (decode "
          f"weight-read floor {weights / PEAK_BYTES * 1e3:.2f} ms a step); launches "
          f"{res['kernel_launches']} timed, {counts} in all; tokens[0]={toks[0].tolist()} "
          f"[{card}]", flush=True)
    if res["kernel_launches"] != want or counts != want_all:
        fail(f"{arch} serve: launch counts {res['kernel_launches']} timed, {counts} in all; "
             f"expected {want} and {want_all}")
    if toks.shape != (B, STEPS + 1) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
        fail(f"{arch} serve: sampled tokens out of shape or range: {toks.shape}")
    if logits.shape != (B, 1, cfg.vocab_size) or not torch.isfinite(logits).all():
        fail(f"{arch} serve: prefill logits not finite or of the wrong shape")
    out = {"launches": res["kernel_launches"], "launches_all": counts,
           "prefill_s": res["prefill_s"], "decode_tok_per_s": res["decode_tok_per_s"],
           "max_memory_allocated": peak, "weight_bytes": weights, "layers": n_layers}
    if cfg.moe is not None:
        del res, logits
        return dict(out, **moe_check(run, card, profile_dir))

    torch.cuda.empty_cache()
    plain = serve(run, batch=B, prompt_len=PROMPT, decode_steps=STEPS, device="cuda", seed=0,
                  use_kernel=False)
    if any(plain["kernel_launches"].values()):
        fail(f"{arch} serve: the plain path launched a kernel")
    err = (logits - plain["prefill_logits"]).abs().max().item()
    scale = plain["prefill_logits"].abs().max().item()
    agree = float((toks == plain["tokens"]).mean())
    print(f"  models serve {arch} prefill logits vs the plain path ({n_layers} layers): "
          f"max_abs_err={err:.4e} max|logit|={scale:.4e} rel={err / scale:.4e} tol_rel=2e-2; "
          f"greedy tokens equal to the plain path's: {agree:.4f} (plain prefill_s="
          f"{plain['prefill_s']:.4f}, decode_tok_per_s={plain['decode_tok_per_s']:.2f})",
          flush=True)
    if not err <= 2e-2 * scale:
        # A deep bf16 model can sit this far from any other bf16 path: then
        # the kernel path must be as close to the exact forward (fp32, the
        # same bf16-rounded weights) as the plain bf16 path is
        exact = fp32_prefill_logits(run)
        k_err = (logits - exact).abs().max().item()
        floor = (plain["prefill_logits"] - exact).abs().max().item()
        print(f"  models serve {arch} against the fp32 forward of the same weights: kernel "
              f"path max_abs_err={k_err:.4e}, plain bf16 path {floor:.4e} (the bf16 noise "
              f"floor, rel={floor / scale:.4e}); kernel/plain={k_err / floor:.4f} (limit "
              f"{EXACT_RATIO:g})", flush=True)
        if not k_err <= EXACT_RATIO * floor:
            fail(f"{arch}: served prefill logits disagree with the plain path")
        out["fp32_ratio"] = k_err / floor
    out["logit_err"] = err / scale
    recurrent = any(k in RECURRENT_KINDS for k in layer_plan(cfg))
    if cfg.cross_attn_every:
        out.update(cross_check(run, card))
    if recurrent:
        out.update(handoff_check(run, card))
    if profile_dir is not None and (cfg.cross_attn_every or recurrent):
        model, prompt = serve_model(run)
        profile_serve(model, prompt, profile_dir, cfg.name)
    return out


# --- the vision, hybrid and recurrent configs' checks --------------------------

RECURRENT_KINDS = ("mamba2", "mlstm", "slstm")
GATE_SEED = 7             # the cross blocks' gates, drawn before anything runs
# of the largest |output| of a layer: above the bf16 noise that a layer's input
# carries from the layers before it on two paths (up to 2.7e-2 at the smoke
# widths on the CPU, whose attention averages 12 image rows; 1.8e-2 at full
# width on an H100 80GB HBM3, 700 W), and a tenth of what each planted fault
# reads (~1: a zero, or another average)
MIXER_TOL = 0.1
# the handoff check's, in float32: two orders of float32 sums over 94 layers
# (~1e-5 relative), with room; a fault reads ~1
HANDOFF_TOL = 1e-3


def draw_gates(model, seed: int = GATE_SEED) -> None:
    """Every cross block's ``xattn.gate`` and ``ffn_gate`` drawn from ``seed``,
    in layer order: a magnitude in [0.5, 1.5), a random sign. The JAX init
    makes both zero, so a cross block would be the identity."""
    import torch
    from repro_torch.models.transformer import CrossBlock
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for blk in model.blocks:
            if isinstance(blk, CrossBlock):
                for gate in (blk.xattn.gate, blk.ffn_gate):
                    sign = 2.0 * torch.randint(0, 2, (), generator=gen) - 1.0
                    gate.fill_(float(sign * (0.5 + torch.rand((), generator=gen))))


@contextlib.contextmanager
def drawn_gates():
    """Every ``LM`` whose weights are drawn inside (``serve``'s, the train
    step's, the checks') draws its cross gates next (``draw_gates``)."""
    from repro_torch.models.transformer import LM
    real = LM.init_weights

    def init_weights(self, generator):
        real(self, generator)
        draw_gates(self)
        return self
    LM.init_weights = init_weights
    try:
        yield
    finally:
        LM.init_weights = real


def serve_model(run, fp32: bool = False):
    """``serve``'s model (weights from seed 0) and prompt (seed 1) on the card;
    with ``fp32``, the model in float32 holding the same bf16-rounded weights."""
    import torch
    from repro_torch.common.config import ShapeSpec
    from repro_torch.models.model import build_model, synthetic_batch
    torch.cuda.empty_cache()
    if fp32:
        run = run.replace(parallel=dataclasses.replace(run.parallel, param_dtype="float32"))
    model = build_model(run, device="cuda")
    model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    if fp32:
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(p.to(torch.bfloat16))
    prompt = synthetic_batch(run.model, ShapeSpec("serve", PROMPT, B, "prefill"), seed=1,
                             device="cuda")
    return model, prompt


def max_rel(got, want) -> float:
    """max |got - want| over max |want|, in float32."""
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def cross_check(run, card: str) -> dict:
    """llama-3.2-vision: each cross block's ``xattn`` output over the whole
    prompt, kernel path against plain path (the norms and self-attention
    through the kernels or not; the cross attention is plain in both), within
    ``MIXER_TOL`` of its largest |output|; the logits as ``serve``'s check.
    Planted faults, each read against the plain path: every cross block's
    ``gate`` back to 0, and the image embeddings of another seed. The logits
    alone cannot hold them: attention over 6,404 random image rows averages
    them to ~1/80 of a row, a few percent of a residual stream built by 40
    layers."""
    import torch
    from repro_torch.common.config import ShapeSpec
    from repro_torch.models.model import synthetic_batch
    from repro_torch.models.transformer import CrossBlock
    from repro_torch.train.steps import make_prefill_step

    model, prompt = serve_model(run)
    prefill = make_prefill_step(model)
    crosses = [blk for blk in model.blocks if isinstance(blk, CrossBlock)]

    def run_prefill(batch, use_kernel: bool):
        model.use_kernel = use_kernel
        outs = []
        hooks = [blk.xattn.register_forward_hook(lambda m, a, o: outs.append(o.detach()))
                 for blk in crosses]
        try:
            logits, _ = prefill(batch, model.init_cache(B, PROMPT))
        finally:
            for h in hooks:
                h.remove()
        model.use_kernel = True
        return logits, outs

    t0 = time.perf_counter()
    plain_logits, plain = run_prefill(prompt, False)
    logits, got = run_prefill(prompt, True)
    ratios = [max_rel(g, p) for g, p in zip(got, plain)]
    logit = max_rel(logits, plain_logits)
    print(f"  models cross {run.model.name}: {len(crosses)} cross blocks, xattn output (B, "
          f"{PROMPT}, {run.model.d_model}) kernel vs plain path, max_abs_err over max|output| "
          f"by layer {[round(r, 6) for r in ratios]} (limit {MIXER_TOL:g}); prefill logits "
          f"{logit:.4e}; gates (xattn, ffn) "
          f"{[(round(b.xattn.gate.item(), 4), round(b.ffn_gate.item(), 4)) for b in crosses]}",
          flush=True)
    if not max(ratios) <= MIXER_TOL:
        fail(f"{run.model.name}: cross attention disagrees with the plain path")
    del got
    gates = [blk.xattn.gate.detach().clone() for blk in crosses]
    with torch.no_grad():
        for blk in crosses:
            blk.xattn.gate.zero_()
    zero_logits, zero = run_prefill(prompt, True)
    with torch.no_grad():
        for blk, g in zip(crosses, gates):
            blk.xattn.gate.copy_(g)
    other = dict(prompt, vision_embed=synthetic_batch(
        run.model, ShapeSpec("serve", PROMPT, B, "prefill"), seed=2,
        device="cuda")["vision_embed"])
    other_logits, moved = run_prefill(other, True)
    faults = {"gate 0 in every cross block": (max(max_rel(z, p) for z, p in zip(zero, plain)),
                                              max_rel(zero_logits, plain_logits)),
              "vision_embed of another seed": (max(max_rel(m, p) for m, p in zip(moved, plain)),
                                               max_rel(other_logits, plain_logits))}
    for label, (r, lg) in faults.items():
        print(f"    planted fault, {label}: xattn output {r:.4e} (limit {MIXER_TOL:g}), prefill "
              f"logits {lg:.4e} (the serve check's limit 2e-2)", flush=True)
        if not r > MIXER_TOL:
            fail(f"{run.model.name}: the planted fault '{label}' reads within the limit")
    print(f"  models cross {run.model.name} check done in {time.perf_counter() - t0:.1f} s "
          f"[{card}]", flush=True)
    return {"xattn_err": max(ratios), "cross_faults": faults}


@contextlib.contextmanager
def mixer_outputs(model, records: list):
    """Record, for every block application in order, its mixer's output at
    the last position ((B, d) float32): a recurrent block's increment to the
    residual (its cell's output), an attention block's attention output
    (``attn.prefill`` / ``attn.decode``; zamba2's shared block at each of
    its applications)."""
    from repro_torch.models.transformer import RecurrentBlock
    patched = []
    for mod in set(model._apps):
        if isinstance(mod, RecurrentBlock):
            def forward_aux(x, real=mod.forward_aux, **kw):
                y, aux = real(x, **kw)
                records.append((y - x)[:, -1].float())
                return y, aux
            mod.forward_aux = forward_aux
            patched.append((mod, "forward_aux"))
        elif hasattr(mod, "attn"):
            for name in ("prefill", "decode"):
                def attend(*args, real=getattr(mod.attn, name), **kw):
                    out = real(*args, **kw)
                    records.append(out[:, -1].float())
                    return out
                setattr(mod.attn, name, attend)
                patched.append((mod.attn, name))
    try:
        yield records
    finally:
        for obj, name in patched:
            delattr(obj, name)


def handoff_check(run, card: str) -> dict:
    """zamba2 and xlstm: the logits of decode step 1 (the prefill's greedy
    token at position 4352) against a fresh prefill of the prompt and that
    token at its last position, within 2e-2 of max|logit|, and every block
    application's mixer output there (``mixer_outputs``) within
    ``HANDOFF_TOL`` of its largest |output|: the chunked SSD and mLSTM forms
    and the sLSTM loop against their one-step forms across the boundary, the
    decode kernel against flash. In float32 (``serve_model(fp32=True)``,
    float32 caches, the kernels' float32 paths): in bf16 the two orders of
    the same sums differ with no fault by more than these limits over 81
    layers (zamba2's smoke widths on the CPU: 2.66e-2 of max|logit|, 0.13 of
    a Mamba2 cell's output), which would hide a small fault. Planted
    faults: the recurrent state zeroed between prefill and decode, and
    (zamba2) one KV cache for all the shared block's applications."""
    import torch
    from repro_torch.models.transformer import RECURRENT_BLOCKS
    from repro_torch.train.steps import make_decode_step, make_prefill_step

    cfg = run.model
    t0 = time.perf_counter()
    model, prompt = serve_model(run, fp32=True)
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    cache = model.init_cache(B, CACHE, torch.float32)
    logits, _ = prefill(prompt, cache)
    step = {"tokens": torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]}
    with mixer_outputs(model, []) as got:
        logits, _ = decode(step, cache, PROMPT)
    for c, kind in zip(cache, model.kinds):            # the fault: the state zeroed
        if kind in RECURRENT_BLOCKS:
            for t in c:
                t.zero_()
    with mixer_outputs(model, []) as zeroed:
        zero_logits, _ = decode(step, cache, PROMPT)
    del cache
    full = {"tokens": torch.cat([prompt["tokens"], step["tokens"]], dim=1)}
    with mixer_outputs(model, []) as want:
        fresh, _ = prefill(full, model.init_cache(B, CACHE, torch.float32))
    ratios = [max_rel(g, w) for g, w in zip(got, want)]
    logit = max_rel(logits, fresh)
    by_kind = {k: max(r for r, kk in zip(ratios, model.kinds) if kk == k)
               for k in dict.fromkeys(model.kinds)}
    print(f"  models handoff {cfg.name}: decode step 1 vs a fresh prefill of {PROMPT + 1} "
          f"tokens at its last position: logits max_abs_err over max|logit| {logit:.4e} "
          f"(limit 2e-2); mixer outputs of {len(ratios)} applications, worst by kind "
          f"{ {k: float(f'{v:.4e}') for k, v in by_kind.items()} } (limit {HANDOFF_TOL:g}); "
          f"float32", flush=True)
    if not (logit <= 2e-2 and max(ratios) <= HANDOFF_TOL):
        fail(f"{cfg.name}: decode after prefill disagrees with a fresh prefill")
    faults = {"recurrent state zeroed between prefill and decode": (
        max(max_rel(z, w) for z, w in zip(zeroed, want)), max_rel(zero_logits, fresh))}
    if "shared_attn" in model.kinds:
        cache = model.init_cache(B, CACHE, torch.float32)
        apps = [i for i, k in enumerate(model.kinds) if k == "shared_attn"]
        for i in apps[1:]:
            cache[i] = cache[apps[0]]
        prefill(prompt, cache)
        with mixer_outputs(model, []) as one_cache:
            one_logits, _ = decode(step, cache, PROMPT)
        del cache
        faults[f"one KV cache for the {len(apps)} shared-block applications"] = (
            max(max_rel(o, w) for o, w in zip(one_cache, want)), max_rel(one_logits, fresh))
    for label, (r, lg) in faults.items():
        print(f"    planted fault, {label}: mixer outputs {r:.4e} (limit {HANDOFF_TOL:g}), "
              f"logits {lg:.4e} (limit 2e-2)", flush=True)
        if not (r > HANDOFF_TOL or lg > 2e-2):
            fail(f"{cfg.name}: the planted fault '{label}' reads within the limits")
    print(f"  models handoff {cfg.name} check done in {time.perf_counter() - t0:.1f} s "
          f"[{card}]", flush=True)
    return {"handoff_logit_err": logit, "handoff_mixer_err": max(ratios),
            "handoff_faults": faults}


# --- the MoE configs' check: routes, then logits where the routes agree -------

LOGIT_TOL = 2e-2          # of the largest |logit|, as the dense configs' check
AGREE_MIN = 0.9           # the share of positions whose routes agree in every layer


def prefill_routes(model, prompt):
    """A ``head="full"`` prefill of ``prompt``: the logits (B, S, vocab) float32
    on the host, and each MoE layer's input (what its router sees), captured
    by a forward pre-hook on the layer's ``moe``."""
    import torch
    from repro_torch.models.model import model_inputs
    inputs = {}
    hooks = [blk.moe.register_forward_pre_hook(
        lambda mod, args, i=i: inputs.__setitem__(i, args[0].detach()))
        for i, blk in enumerate(model.blocks) if hasattr(blk, "moe")]
    try:
        with torch.no_grad():
            logits, _ = model(mode="prefill", cache=model.init_cache(B, PROMPT), head="full",
                              **model_inputs(prompt))
    finally:
        for h in hooks:
            h.remove()
    return logits.cpu(), inputs


def route_check(moe, cfg, x_kernel, x_plain, layer: int):
    """Route a MoE layer's two captured inputs (kernel and plain path) with
    the port's ``route_topk`` / ``_dispatch_indices``. Fails unless every
    token whose top-k sets differ is a near tie in the plain path (its k-th
    and (k+1)-th router logits closer than 2x the largest router-logit
    difference between the paths: no pair further apart can swap), and every
    kept/dropped difference of a token with equal sets is in an expert that
    such a flip touched in its group. Returns (B, S) bool: the tokens whose
    top-k set and kept slots agree."""
    import torch
    from repro_torch.models.moe import _capacity, _dispatch_indices, route_topk
    m = cfg.moe
    cap = _capacity(x_kernel.shape[1], m)
    logits_k = x_kernel.float() @ moe.router
    logits_p = x_plain.float() @ moe.router
    margin = 2 * (logits_k - logits_p).abs().max().item()
    kept_by_expert, chosen = [], []
    for x in (x_kernel, x_plain):
        _, idx, _ = route_topk(moe.router, x, m)
        _, valid, _, _, order = _dispatch_indices(idx, m.num_experts, cap)
        kept = torch.empty_like(valid).scatter_(1, order, valid).reshape(idx.shape)
        one = torch.zeros(*idx.shape[:2], m.num_experts, dtype=torch.bool, device=idx.device)
        chosen.append(one.scatter(2, idx, True))
        kept_by_expert.append(one.scatter(2, idx, kept))
    flip_by_expert = chosen[0] != chosen[1]                          # (B, S, E)
    flipped = flip_by_expert.any(-1)                                 # (B, S)
    touched = flip_by_expert.any(1)                                  # (B, E)
    top = logits_p.topk(m.top_k + 1, dim=-1).values
    gap = top[..., m.top_k - 1] - top[..., m.top_k]
    kept_diff = (kept_by_expert[0] != kept_by_expert[1]) & ~flipped[..., None]
    untouched = kept_diff & ~touched[:, None, :]
    agree = ~flipped & ~kept_diff.any(-1)
    worst_gap = gap[flipped].max().item() if flipped.any() else 0.0
    print(f"    layer {layer}: routes agree on {agree.float().mean().item():.4f} of "
          f"{agree.numel()} tokens; top-k flips {int(flipped.sum())} (largest plain k-th vs "
          f"(k+1)-th logit gap among them {worst_gap:.4e}, margin {margin:.4e} = 2 x the "
          f"largest router-logit difference); kept/dropped differences "
          f"{int(kept_diff.sum())} (in experts no flip touched: {int(untouched.sum())}); "
          f"capacity {cap}", flush=True)
    if flipped.any() and not worst_gap < margin:
        fail(f"layer {layer}: a top-k flip where the plain path's gap {worst_gap:.4e} is "
             f"not below the margin {margin:.4e}")
    if untouched.any():
        fail(f"layer {layer}: a kept/dropped difference in an expert no flip touched")
    return agree


def rmsnorm_f64(x, scale, eps: float = 1e-6):
    """The plain RMSNorm computed in float64, rounded once to ``x.dtype``."""
    import torch
    xd = x.double()
    var = xd.square().mean(dim=-1, keepdim=True)
    return (xd * torch.rsqrt(var + eps) * (1.0 + scale.double())).to(x.dtype)


def route_floor(model, prompt, plain_in) -> float:
    """The share of positions whose routes agree in every MoE layer between
    the plain path (``plain_in``: its MoE layers' inputs) and the plain path
    with every RMSNorm in float64 (``route_check`` on each layer)."""
    import torch
    from repro_torch.kernels import ref
    model.use_kernel = False
    real, ref.rmsnorm = ref.rmsnorm, rmsnorm_f64
    try:
        _, f64_in = prefill_routes(model, prompt)
    finally:
        ref.rmsnorm = real
    print("    routes of the float64-norm plain path against the plain path:", flush=True)
    agree = torch.ones(B, PROMPT, dtype=torch.bool, device=plain_in[min(plain_in)].device)
    for i in sorted(f64_in):
        agree &= route_check(model.blocks[i].moe, model.cfg, f64_in[i], plain_in[i], i)
    return agree.float().mean().item()


def logit_err(logits, plain, mask) -> float:
    """max |logits - plain| over the positions of ``mask`` (B, S), over the
    largest |plain| there. On the host, a batch row at a time."""
    err = scale = 0.0
    for b in range(plain.shape[0]):
        pick = mask[b]
        if pick.any():
            err = max(err, (logits[b, pick] - plain[b, pick]).abs().max().item())
            scale = max(scale, plain[b, pick].abs().max().item())
    return err / scale


def moe_check(run, card: str, profile_dir=None) -> dict:
    """One model of ``run`` (``serve``'s seeds), prefilled with ``head="full"``
    through the kernels and through the plain norms and attention
    (``use_kernel`` toggled): (a) each MoE layer's routes of the two paths by
    ``route_check``; (b) the logits at the positions whose routes agree in
    every MoE layer, within ``LOGIT_TOL`` of the largest |logit|, at least
    ``AGREE_MIN`` of the positions qualifying, or else the kernel path's
    disagreement at most ``EXACT_RATIO`` times the float64-norm plain path's
    (``route_floor``); (c) planted faults in the
    plain path (the dense residual or the shared experts left out, gates not
    renormalised) read above that limit. With ``profile_dir``, a profiled
    prefill and decode step of the kernel path."""
    import torch
    from repro_torch.common.config import ShapeSpec
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.model import build_model, synthetic_batch
    from repro_torch.kernels import ops

    cfg = run.model
    torch.cuda.empty_cache()
    model = build_model(run, device="cuda")
    model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    prompt = synthetic_batch(cfg, ShapeSpec("serve", PROMPT, B, "prefill"), seed=1,
                             device="cuda")
    t0 = time.perf_counter()
    kernel_logits, kernel_in = prefill_routes(model, prompt)
    model.use_kernel = False
    ops.reset_launch_counts()
    plain_logits, plain_in = prefill_routes(model, prompt)
    if any(ops.launch_counts().values()):
        fail(f"{cfg.name}: the plain path launched a kernel")
    moe_layers = sorted(kernel_in)
    print(f"  models moe {cfg.name}: routes of the kernel and plain paths, {len(moe_layers)} "
          f"MoE layers of {cfg.n_layers}, {cfg.moe.num_experts} experts, top {cfg.moe.top_k}, "
          f"capacity factor {cfg.moe.capacity_factor}", flush=True)
    agree = torch.ones(B, PROMPT, dtype=torch.bool, device="cuda")
    for i in moe_layers:
        agree &= route_check(model.blocks[i].moe, cfg, kernel_in[i], plain_in[i], i)
    del kernel_in
    mask = agree.cpu()
    share = mask.float().mean().item()
    err = logit_err(kernel_logits, plain_logits, mask)
    print(f"  models moe {cfg.name} logits (head full) at the {share:.4f} of positions whose "
          f"routes agree in every MoE layer (at least {AGREE_MIN:g}): max_abs_err over "
          f"max|logit| {err:.4e} (limit {LOGIT_TOL:g})", flush=True)
    floor = None
    if share < AGREE_MIN:
        # A flip at one layer moves that token's later inputs by an expert's
        # output, so disagreement compounds with depth whatever the kernel.
        # Then the kernel path must disagree with the plain path no more than
        # EXACT_RATIO times as often as another plain path does: every norm
        # in float64 before its one rounding (bf16 noise of the same kind)
        floor = route_floor(model, prompt, plain_in)
        ratio = (1 - share) / (1 - floor) if floor < 1 else math.inf
        print(f"  models moe {cfg.name}: the plain path with float64 norms agrees with the "
              f"plain path at {floor:.4f} of positions; kernel-path disagreement over "
              f"theirs {ratio:.4f} (limit {EXACT_RATIO:g})", flush=True)
        if not ratio <= EXACT_RATIO:
            fail(f"{cfg.name}: routes agree at {share:.4f} of positions, under {AGREE_MIN:g} "
                 f"and under the float64-norm path's {floor:.4f}")
    del plain_in
    if not err <= LOGIT_TOL:
        fail(f"{cfg.name}: prefill logits disagree with the plain path where routes agree")
    del kernel_logits

    part = "shared" if cfg.moe.num_shared_experts else "dense_residual"
    mods = [getattr(blk.moe, part) for blk in model.blocks if hasattr(blk, "moe")]
    hooks = [mod.register_forward_hook(lambda mod, args, out: torch.zeros_like(out))
             for mod in mods]
    try:
        left_out = prefill_routes(model, prompt)[0]
    finally:
        for h in hooks:
            h.remove()
    route_topk = moe_mod.route_topk

    def gates_not_renormalised(router_w, x, m, **kw):     # the top-k probabilities as gates
        _, idx, aux = route_topk(router_w, x, m, **kw)
        return torch.gather(torch.softmax(x.float() @ router_w, dim=-1), -1, idx), idx, aux
    moe_mod.route_topk = gates_not_renormalised
    try:
        unnormalised = prefill_routes(model, prompt)[0]
    finally:
        moe_mod.route_topk = route_topk
    faults = {f"{part} left out": logit_err(left_out, plain_logits, mask),
              "gates not renormalised": logit_err(unnormalised, plain_logits, mask)}
    del left_out, unnormalised, plain_logits
    for label, r in faults.items():
        print(f"    planted fault, {label}: max_abs_err over max|logit| {r:.4e}", flush=True)
        if not r > LOGIT_TOL:
            fail(f"{cfg.name}: the planted fault '{label}' reads within the limit")
    print(f"  models moe {cfg.name} check done in {time.perf_counter() - t0:.1f} s", flush=True)
    model.use_kernel = True
    if profile_dir is not None:
        profile_serve(model, prompt, profile_dir, cfg.name)
    return {"routes_agree": share, "logit_err": err, "faults": faults}


def profile_serve(model, prompt, out_dir: Path, label: str) -> None:
    """torch.profiler over one prefill and one decode step of ``model``
    (kernel path), each split by part (``profile_one``) and by the scopes of
    ``scoped``."""
    import torch
    from repro_torch.train.steps import make_decode_step, make_prefill_step
    cache = model.init_cache(B, CACHE)
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    logits, _ = prefill(prompt, cache)
    step = {"tokens": torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]}
    if "vision_embed" in prompt:
        step["vision_embed"] = prompt["vision_embed"]
    decode(step, cache, PROMPT)
    e = model.cfg.moe.num_experts if model.cfg.moe is not None else None
    with scoped(model):
        profile_one(f"{label}_prefill", lambda: prefill(prompt, cache), out_dir, e)
        profile_one(f"{label}_decode", lambda: decode(step, cache, PROMPT), out_dir, e)


SCOPES = {"CrossAttention": "scope: cross attention", "Mamba2": "scope: Mamba2 SSD cell",
          "MLSTM": "scope: mLSTM cell", "SLSTM": "scope: sLSTM cell"}


@contextlib.contextmanager
def scoped(model):
    """Each cross attention and recurrent cell of ``model`` runs inside a
    ``record_function`` range named by ``SCOPES`` (its forward and decode),
    so that ``profile_one`` can sum the device time of the kernels each
    launches (GEMMs and the rest)."""
    import torch
    patched = []
    for mod in model.modules():
        label = SCOPES.get(type(mod).__name__)
        if label is None:
            continue
        for name in ("forward", "decode"):
            if hasattr(type(mod), name):
                def run(*args, real=getattr(mod, name), label=label, **kw):
                    with torch.profiler.record_function(label):
                        return real(*args, **kw)
                setattr(mod, name, run)
                patched.append((mod, name))
    try:
        yield
    finally:
        for mod, name in patched:
            delattr(mod, name)


# the kernel path's distance to the exact forward, at most this many times
# the plain bf16 path's (both round every op to bf16)
EXACT_RATIO = 1.25


def fp32_prefill_logits(run):
    """Last-position prefill logits of ``serve``'s model and prompt in float32
    through the plain path, with every weight rounded to bf16 first
    (``serve_model(fp32=True)``): the exact forward that both bf16 paths
    approximate. (B, 1, vocab) float32 on the CPU."""
    import torch
    from repro_torch.train.steps import make_prefill_step

    model, prompt = serve_model(run, fp32=True)
    model.use_kernel = False
    logits, _ = make_prefill_step(model)(prompt, model.init_cache(B, PROMPT, torch.float32))
    return logits.float().cpu()


def model_train_run(arch: str):
    """The [models] training run of ``arch``: seq 4096, global batch 2 (the
    config's 256 cut to one card), 2 microbatches, the config's remat and
    optimizer, depth ``MODEL_TRAIN_LAYERS``."""
    from repro_torch.configs import get_config
    run = get_config(arch)
    return run.replace(
        model=dataclasses.replace(run.model, n_layers=MODEL_TRAIN_LAYERS[arch]),
        parallel=dataclasses.replace(run.parallel, microbatches=2),
        train=dataclasses.replace(run.train, global_batch=TRAIN_BATCH))


def model_train(arch: str, card: str) -> dict:
    """``MODEL_TRAIN_STEPS`` steps of ``make_train_step`` over ``TokenPipeline``
    batches: the first batch's loss and grad norm against the plain norms,
    finite losses, the RMSNorm launches of each step exact."""
    import torch
    from repro_torch.common.config import ShapeSpec
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.train.steps import jax_leaves, make_grad_fn, make_train_step

    run = model_train_run(arch)
    cfg, pcfg = run.model, run.parallel
    if pcfg.remat not in ("full", "dots"):
        fail(f"{arch}: the launch count below is derived for remat 'full' or 'dots'")
    per_step = pcfg.microbatches * (2 * norms_per_forward(cfg) - 1)
    shape = ShapeSpec("train", run.train.seq_len, TRAIN_BATCH, "train")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(run, device="cuda")
    model.init_weights(torch.Generator("cuda").manual_seed(run.train.seed))
    params = dict(model.named_parameters())
    opt_cfg = adamw.OptimizerConfig(kind=pcfg.optimizer_state,
                                    weight_decay=run.train.weight_decay)
    opt_state = adamw.init_state(opt_cfg, params, jax_leaves(model))
    pipeline = TokenPipeline(cfg, shape, PipelineConfig(seed=run.train.seed))

    def batch_of(step):
        return {k: torch.from_numpy(v).cuda() for k, v in pipeline.batch(step).items()}

    grad_fn = make_grad_fn(model, run)
    got = {}
    for use_kernel in (True, False):
        model.use_kernel = use_kernel
        ops.reset_launch_counts()
        loss, _, grads = grad_fn(params, batch_of(0))
        got[use_kernel] = (loss.item(), adamw.global_norm(grads).item(), ops.launch_counts())
        del grads
    model.use_kernel = True
    (lk, gk, ck), (lp, gp, cp) = got[True], got[False]
    rel_l, rel_g = abs(lk - lp) / abs(lp), abs(gk - gp) / gp
    print(f"  models train {arch} kernel vs plain norms, batch 0: loss {lk:.6f} vs {lp:.6f} "
          f"rel={rel_l:.3e} (limit 2e-3); grad_norm {gk:.6f} vs {gp:.6f} rel={rel_g:.3e} "
          f"(limit 2e-2); rmsnorm launches {ck['rmsnorm']} vs {cp['rmsnorm']}", flush=True)
    if not (rel_l <= 2e-3 and rel_g <= 2e-2):
        fail(f"{arch} train: loss or grad norm with the RMSNorm kernel disagrees with the "
             "plain norms")
    if ck != {"flash_attention": 0, "decode_attention": 0, "rmsnorm": per_step} or any(cp.values()):
        fail(f"{arch} train: gradient launches {ck} (kernel) and {cp} (plain); expected "
             f"{per_step} rmsnorm launches and none")

    step_fn = make_train_step(model, run, opt_cfg)
    losses, secs, counts = [], [], []
    for step in range(MODEL_TRAIN_STEPS):
        batch = batch_of(step)
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(metrics["loss"].item())
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        counts.append(ops.launch_counts())
    peak = torch.cuda.max_memory_allocated()
    print(f"  models train {arch}: {model.num_params():,} params ({cfg.n_layers} layers), seq "
          f"{shape.seq_len}, global batch {TRAIN_BATCH}, microbatches {pcfg.microbatches}, "
          f"remat {pcfg.remat}, {opt_cfg.kind}: losses {losses}, step_s "
          f"{[round(t, 4) for t in secs]}, tokens_per_s (step 2) "
          f"{TRAIN_BATCH * shape.seq_len / secs[-1]:.1f}, max_memory_allocated "
          f"{peak / 1e9:.2f} GB; rmsnorm launches a step {[c['rmsnorm'] for c in counts]} "
          f"[{card}]", flush=True)
    if not all(math.isfinite(x) for x in losses):
        fail(f"{arch} train: non-finite losses {losses}")
    want = {"flash_attention": 0, "decode_attention": 0, "rmsnorm": per_step}
    if any(c != want for c in counts):
        fail(f"{arch} train: launches a step {counts}; expected {want}")
    return {"launches": sum(c["rmsnorm"] for c in counts), "step_s": secs, "losses": losses,
            "max_memory_allocated": peak, "params": model.num_params()}


def dots_check(arch: str, card: str) -> dict:
    """The first train step of ``arch`` from the same weights and batch
    under remat ``full`` and ``dots``: loss and grad norm within 1e-6
    relative of each other; seconds and peak memory of each."""
    import torch
    from repro_torch.common.config import ShapeSpec
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.train.steps import jax_leaves, make_train_step

    run = model_train_run(arch)
    torch.cuda.empty_cache()
    model = build_model(run, device="cuda")
    opt_cfg = adamw.OptimizerConfig(kind=run.parallel.optimizer_state,
                                    weight_decay=run.train.weight_decay)
    shape = ShapeSpec("train", run.train.seq_len, TRAIN_BATCH, "train")
    batch = {k: torch.from_numpy(v).cuda() for k, v in TokenPipeline(
        run.model, shape, PipelineConfig(seed=run.train.seed)).batch(0).items()}
    model.init_weights(torch.Generator("cuda").manual_seed(run.train.seed))
    params = dict(model.named_parameters())
    start = {n: p.detach().clone() for n, p in params.items()}
    out = {}
    for remat in ("full", "dots"):   # warm: model_train ran this config's steps before
        model.remat = remat
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(start[n])
        opt_state = adamw.init_state(opt_cfg, params, jax_leaves(model))
        step_fn = make_train_step(model, run, opt_cfg)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, opt_state, metrics = step_fn(params, opt_state, batch)
        loss, gnorm = metrics["loss"].item(), metrics["grad_norm"].item()
        torch.cuda.synchronize()
        out[remat] = {"loss": loss, "grad_norm": gnorm, "step_s": time.perf_counter() - t0,
                      "max_memory_allocated": torch.cuda.max_memory_allocated(),
                      "rmsnorm": ops.launch_counts()["rmsnorm"]}
        del opt_state, metrics
    full, dots = out["full"], out["dots"]
    rel_l = abs(dots["loss"] - full["loss"]) / abs(full["loss"])
    rel_g = abs(dots["grad_norm"] - full["grad_norm"]) / full["grad_norm"]
    bit_equal = dots["loss"] == full["loss"] and dots["grad_norm"] == full["grad_norm"]
    print(f"  models dots {arch} ({run.model.n_layers} layers), first step from the same "
          f"weights: loss {full['loss']!r} (full) vs {dots['loss']!r} (dots) rel={rel_l:.3e}; "
          f"grad_norm {full['grad_norm']!r} vs {dots['grad_norm']!r} rel={rel_g:.3e} (limit "
          f"1e-6 each); bit-equal: {bit_equal}; step_s full {full['step_s']:.4f} dots "
          f"{dots['step_s']:.4f}; max_memory_allocated full "
          f"{full['max_memory_allocated'] / 1e9:.2f} GB dots "
          f"{dots['max_memory_allocated'] / 1e9:.2f} GB; rmsnorm launches {full['rmsnorm']} "
          f"and {dots['rmsnorm']} [{card}]", flush=True)
    if not (rel_l <= 1e-6 and rel_g <= 1e-6) or full["rmsnorm"] != dots["rmsnorm"]:
        fail(f"{arch}: remat dots disagrees with full")
    return dict(out, bit_equal=bit_equal)


def models_phase(card: str, profile_dir=None) -> dict:
    """yi-34b, stablelm-12b, musicgen-medium, arctic-480b, deepseek-v2-236b,
    llama-3.2-vision-11b, zamba2-7b and xlstm-125m: serve at full width and
    ``MODEL_SERVE_LAYERS`` depth, train at full width (``MODEL_TRAIN_LAYERS``;
    arctic-480b not), and musicgen's first step under remat ``dots`` against
    ``full``. llama's cross gates are drawn non-zero before anything of it
    runs (``drawn_gates``). The launch counts of each path are read from 0
    around it. With ``profile_dir``, the MoE, vision and recurrent configs'
    prefill and a decode step are profiled."""
    import gc
    import torch
    from repro_torch.configs import get_config
    held = torch.cuda.memory_allocated()
    gc.collect()   # what the earlier phases left in reference cycles
    torch.cuda.empty_cache()
    print(f"  models: the earlier phases left {held / 1e9:.2f} GB allocated, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB after gc.collect()", flush=True)
    out = {}
    for arch in MODEL_ARCHS:
        t0 = time.perf_counter()
        with drawn_gates() if get_config(arch).model.cross_attn_every else contextlib.nullcontext():
            out[arch] = {"serve": model_serve(arch, card, profile_dir)}
            gc.collect()
            if arch in MODEL_TRAIN_LAYERS:
                out[arch]["train"] = model_train(arch, card)
        gc.collect()
        print(f"  models {arch} done in {time.perf_counter() - t0:.1f} s", flush=True)
    out["dots"] = dots_check("musicgen-medium", card)
    layers = {a: get_config(a).model.n_layers for a in MODEL_SERVE_LAYERS}
    cuts = ", ".join(f"{a} {MODEL_TRAIN_LAYERS[a]} layers" for a in MODEL_TRAIN_LAYERS)
    serve_cuts = ", ".join(f"{a} {n} of {layers[a]} layers"
                           for a, n in MODEL_SERVE_LAYERS.items() if n != layers[a])
    print(f"  models reduced: serving depth {serve_cuts} (the others whole); training depth "
          f"{cuts}; arctic-480b not trained on the card; train global batch {TRAIN_BATCH} (the "
          "configs' 256) in 2 microbatches; weights random from a seeded torch.Generator",
          flush=True)
    return out


def numpy_fault_replay(kind: str, rank: int, seed: int, sim_nodes: int, at_step: int):
    """The Trainer's ``_handle_fault`` detection and isolation on fresh
    control-plane copies with the port's NumPy master: (verdicts, isolated
    pairs, windows, active nodes after it)."""
    from repro_torch.core.c4d.master import C4DMaster
    from repro_torch.core.cluster import SimCluster, SteeringService
    from repro_torch.core.faults import Fault, RingJobTelemetry

    cluster = SimCluster(n_active=sim_nodes, n_backup=max(1, sim_nodes // 4))
    steering = SteeringService(cluster)
    telemetry = RingJobTelemetry(n_ranks=sim_nodes * 8, seed=seed)
    c4d = C4DMaster(n_ranks=telemetry.n, ranks_per_node=8, backend="numpy")
    fault, actions, windows = Fault(kind, rank=rank), [], 0
    while not actions and windows < 4:
        actions = c4d.ingest(telemetry.window(window_id=windows, faults=[fault]))
        windows += 1
    replaced = [(a.node_id, steering.execute(a.node_id, t=at_step,
                                             reason=a.verdicts[0].syndrome)[0])
                for a in actions]
    return ([v.syndrome for a in actions for v in a.verdicts], replaced, windows,
            cluster.active_nodes)


@contextlib.contextmanager
def ingest_launches():
    """Within the block, record the detection launches and the seconds of
    each ``C4DMaster.ingest`` call in the list it yields; the wrapper does
    not change the call."""
    from repro_torch.core.c4d.master import C4DMaster
    from repro_torch.core.torchsim import detectors as tdet

    real, per_ingest = C4DMaster.ingest, []

    def ingest(self, window):
        before, t0 = tdet.launch_counts(), time.perf_counter()
        out = real(self, window)
        after = tdet.launch_counts()
        per_ingest.append(dict({k: after[k] - before[k] for k in after},
                               s=time.perf_counter() - t0))
        return out

    C4DMaster.ingest = ingest
    try:
        yield per_ingest
    finally:
        C4DMaster.ingest = real


def train_phase(profile_dir=None):
    """gemma2-2b through the Trainer with a crash of rank 9 before step
    FAULT_STEP: DETECT -> ISOLATE -> RESTORE, then the replay. Returns the
    launch counts of the run (RMSNorm's, and the detection kernels' under
    ``detect``), and under ``dryrun`` what ``[dryrun]`` holds its train cell
    to: the median step s, the run's peak memory and the bytes of the
    Trainer's parameters, optimizer state and batch."""
    import torch
    from repro_torch.checkpoint import manager as ckpt_mod
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.common.config import ShapeSpec
    from repro_torch.configs import get_config
    from repro_torch.core.faults import Fault
    from repro_torch.core.torchsim import detectors as tdet
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.train.steps import make_grad_fn
    from repro_torch.train.trainer import FaultInjector, Trainer

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
        trainer = Trainer(run, shape, workdir, device="cuda", use_kernel=True,
                          sim_nodes=SIM_NODES)
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
        spent = {"save": [], "write": [], "sha": [], "steer": [], "restore": []}

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
        # the fault handler's seconds: detection (the ingests), steering, the
        # restore; the first replayed step is the monitor's step FAULT_STEP
        trainer.steering.execute = timed(trainer.steering.execute, "steer")
        trainer.restore = timed(trainer.restore, "restore")
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        tdet.reset_launch_counts()
        t0 = time.perf_counter()
        with ingest_launches() as per_ingest:
            report = trainer.train(TRAIN_STEPS, injector=FaultInjector(
                {FAULT_STEP: Fault(FAULT_KIND, rank=FAULT_RANK)}))
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        det_counts = tdet.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        for i, m in enumerate(report.metrics):
            print(f"  train step {i} (step {trainer.monitor.stats[i].step}): loss={m['loss']:.6f} "
                  f"grad_norm={m['grad_norm']:.6f} lr={m['lr']:.4e} "
                  f"step_s={trainer.monitor.durations[i]:.4f}", flush=True)
        stats = trainer.monitor.summary()
        dry = {"seconds": stats["median_s"], "peak": peak,
               "param_bytes": _nbytes(*trainer.params.values()),
               "opt_bytes": _nbytes(*_leaves(trainer.opt_state)),
               "batch_bytes": sum(v.nbytes for v in trainer.pipeline.batch(0).values())}
        tok_s = shape.global_batch * shape.seq_len / stats["median_s"]
        ckpt_bytes = sum(t.numel() * t.element_size() for t in trainer.ckpt.memory[0].values())
        npz = os.path.join(workdir, "ckpt_00000000.npz")
        print(f"  train {TRAIN_STEPS} steps and a fault in {wall:.2f} s ({report.steps_run} "
              f"steps run): median_step_s={stats['median_s']:.4f} tokens_per_s={tok_s:.1f} "
              f"max_memory_allocated={peak / 1e9:.2f} GB", flush=True)
        fault_check(trainer, report, per_ingest, spent, det_counts, ckpt_bytes)
        save_s, write_s, sha_s = spent["save"][0], spent["write"][0], sum(spent["sha"])
        print(f"  train step-0 checkpoint (blocking): {save_s:.2f} s = host copy "
              f"{save_s - write_s:.2f} + np.savez {write_s - sha_s:.2f} + sha256 {sha_s:.2f}; "
              f"{ckpt_bytes / 1e9:.3f} GB in host RAM, {os.path.getsize(npz) / 1e9:.3f} GB "
              "on disk", flush=True)
        if not all(map(lambda v: v == v and abs(v) < float("inf"), report.losses)):
            fail(f"non-finite training losses {report.losses}")
        want = {"flash_attention": 0, "decode_attention": 0,
                "rmsnorm": report.steps_run * per_step}
        if report.steps_run != TRAIN_STEPS + FAULT_STEP or counts != want:
            fail(f"train launch counts {counts} in {report.steps_run} steps; expected {want} "
                 f"in {TRAIN_STEPS + FAULT_STEP}")

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
        fault_free_check(trainer, report)
        int8_counts = int8_check(trainer, run)
        if profile_dir is not None:
            batch = {k: torch.from_numpy(v).cuda() for k, v in trainer.pipeline.batch(3).items()}

            def one_step():
                _, trainer.opt_state, metrics = trainer._step_fn(
                    trainer.params, trainer.opt_state, batch)
                metrics["loss"].item()
            profile_one("train_step", one_step, profile_dir)
        trainer.ckpt.close()
        return dict(counts, detect=det_counts, int8=int8_counts, dryrun=dry)
    finally:
        ckpt_mod._sha = sha
        shutil.rmtree(workdir, ignore_errors=True)


DRYRUN_MAX = 1.05         # a roofline share or MFU above this: a count is too high


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


def dryrun_phase(card: str, serve_facts: dict, train_facts: dict) -> None:
    """The dry run (``repro_torch.launch.dryrun``) of the two gemma2-2b cells
    this script runs, traced on the meta device for one device, against the
    card: ``[serve]``'s prefill (2 x 4352) and ``[train]``'s step (seq 4096,
    batch 2, 2 microbatches, remat full, adamw). Fails where the predicted
    argument bytes differ from the real tensors' (parameters, optimizer
    state, cache, batch), or where the roofline share (the bound, the
    largest of the three terms, over the measured time) or the MFU (model
    FLOPs over the bf16 peak times the measured time) exceeds DRYRUN_MAX:
    either would mean a count is too high. The predicted peak is printed
    beside max_memory_allocated, not held to it: the train step's over the
    Trainer's run, the prefill's over one prefill of the cell's tensors
    (weights drawn before the count starts, the memory held before them
    taken off), run as traced (``use_kernel=False``) and, printed beside it,
    through the kernels. Fails too where ``launch/mesh.py``'s HBM_BYTES
    exceeds the card's memory. The record's train roofline is traced at one
    microbatch (the JAX package's rule) and printed; the share and the MFU
    hold the card's step to the terms at its own 2 microbatches
    (``dryrun.config_cost``; on one device the FLOPs do not change with the
    microbatches)."""
    import torch
    from repro_torch.common.config import ShapeSpec
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch import mesh as meshmod
    from repro_torch.models.model import DTYPES, build_model, synthetic_batch
    from repro_torch.train.steps import make_prefill_step

    total = torch.cuda.get_device_properties(0).total_memory
    print(f"  {card}: total_memory {total:,} bytes; launch/mesh.py HBM_BYTES "
          f"{meshmod.HBM_BYTES:,.0f}", flush=True)
    if meshmod.HBM_BYTES > total:
        fail("launch/mesh.py's HBM_BYTES exceeds the card's memory")
    run = get_config("gemma2-2b")
    prefill = ShapeSpec("prefill_card", PROMPT, B, "prefill")
    # the prefill cell's arguments as real tensors on the card, and one
    # prefill's peak with the memory held before them taken off
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    model = build_model(run, device="cuda")
    model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    cache = model.init_cache(B, PROMPT, dtype=DTYPES[run.parallel.param_dtype])
    prompt = synthetic_batch(run.model, prefill, seed=1, device="cuda")
    step = make_prefill_step(model)
    peaks = {}
    for use_kernel in (False, True):
        model.use_kernel = use_kernel
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step(prompt, cache)
        torch.cuda.synchronize()
        peaks[use_kernel] = torch.cuda.max_memory_allocated() - held
    print(f"  dryrun serve prefill: one prefill's peak {peaks[False] / 1e9:.3f} GB as traced "
          f"(use_kernel=False), {peaks[True] / 1e9:.3f} GB through the kernels; "
          f"{held / 1e9:.3f} GB held before it, taken off", flush=True)
    serve_facts = dict(serve_facts, peak=peaks[False], param_bytes=_nbytes(*model.parameters()),
                       cache_bytes=_nbytes(*(t for c in cache if c is not None for t in c)),
                       batch_bytes=_nbytes(*prompt.values()))
    if serve_facts["param_bytes"] != serve_facts["weight_bytes"]:
        fail(f"the served weights' bytes {serve_facts['weight_bytes']} differ from the model's "
             f"{serve_facts['param_bytes']}")
    del model, cache, prompt, step
    torch.cuda.empty_cache()
    train_run = run.replace(train=dataclasses.replace(run.train, global_batch=TRAIN_BATCH))
    train = ShapeSpec("train_card", train_run.train.seq_len, TRAIN_BATCH, "train")
    one = ("one_device", {"data": 1, "model": 1})
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    try:
        for label, cell_run, shape, facts in (("serve prefill", run, prefill, serve_facts),
                                              ("train step", train_run, train, train_facts)):
            rec = dr.run_cell(cell_run.model.name, shape.name, False, True, out_dir, mesh=one,
                              run=cell_run, shape=shape)
            if rec["status"] != "ok":
                fail(f"dry run of the {label}: {rec.get('error')}\n{rec.get('traceback', '')}")
            mem, roof, cost = rec["memory"], rec["roofline"], rec["cost_analysis"]
            k = max(cell_run.parallel.microbatches, 1) if shape.kind == "train" else 1
            if k > 1:
                # the record's roofline follows the JAX package's rule (one
                # microbatch); the card ran the config's k: its terms at k
                print(f"  dryrun {label}: the record's roofline at microbatches "
                      f"{roof['microbatches']} (the JAX package's rule): compute "
                      f"{roof['t_comp_s'] * 1e3:.4f} ms, memory {roof['t_mem_s'] * 1e3:.4f} ms, "
                      f"collective {roof['t_coll_s'] * 1e3:.4f} ms, FLOPs "
                      f"{roof['flops_per_device']:.6e}; held to the card at its microbatches "
                      f"{k} below", flush=True)
                roof = dr.roofline_record(cell_run, shape, one[0], 1, cell_run.model.name,
                                          dr.config_cost(rec), rec["extrapolation"], k)
            terms = {"compute": roof["t_comp_s"], "memory": roof["t_mem_s"],
                     "collective": roof["t_coll_s"]}
            bound = max(terms.values())
            measured = facts["seconds"]
            share = bound / measured
            mfu = roof["model_flops"] / (meshmod.PEAK_FLOPS_BF16 * measured)
            parts = ("param_bytes", "opt_bytes", "cache_bytes", "batch_bytes")
            want = {k: facts.get(k, 0) for k in parts}
            got = {k: int(mem[k]) for k in parts}
            print(f"  dryrun {label} ({shape.global_batch} x {shape.seq_len}, microbatches "
                  f"{roof['microbatches']}): FLOPs counted "
                  f"{cost['flops_per_device']:.6e}, model {roof['model_flops']:.6e}; terms "
                  f"compute {terms['compute'] * 1e3:.4f} ms, memory {terms['memory'] * 1e3:.4f} "
                  f"ms (traced, unfused: {roof['t_mem_traced_s'] * 1e3:.4f}), collective "
                  f"{terms['collective'] * 1e3:.4f} ms; dominant {roof['dominant']}, bound "
                  f"{bound * 1e3:.4f} ms; measured {measured:.4f} s: roofline_share "
                  f"{share:.4f}, mfu {mfu:.4f} (limit {DRYRUN_MAX}); trace "
                  f"{rec['trace_s']} s", flush=True)
            print(f"  dryrun {label}: argument bytes predicted {got}, real {want}; peak "
                  f"predicted {mem['peak_bytes'] / 1e9:.3f} GB (temporaries "
                  f"{mem['temp_bytes'] / 1e9:.3f}), max_memory_allocated "
                  f"{facts['peak'] / 1e9:.3f} GB", flush=True)
            if got != want:
                fail(f"the dry run's argument bytes of the {label} differ from the real tensors'")
            if share > DRYRUN_MAX or mfu > DRYRUN_MAX:
                fail(f"the {label}'s roofline share {share:.4f} or mfu {mfu:.4f} exceeds "
                     f"{DRYRUN_MAX}: a count is too high")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


INT8_CHECKED = 4          # quantised leaves copied back and checked on the CPU
INT8_CHECK_NUMEL = 1 << 23


def int8_check(trainer, run) -> dict:
    """One int8 step of the Trainer's model from its present state (the
    ``ef`` residual started at zero, one fp32 a parameter), beside a plain
    step of the same batch: the loss finite, the first ``INT8_CHECKED``
    quantised leaves of at most ``INT8_CHECK_NUMEL`` elements copied to the
    CPU bit-equal to the CPU's round trip of the same corrected gradient at
    the same amax, and to ``quantize_int8`` there; the seconds of both steps
    (the plain one first). Returns the int8 step's launch counts."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.parallel.compression import (ErrorFeedback, dequantize_int8,
                                                  quantize_int8)
    from repro_torch.train import steps as steps_mod
    irun = run.replace(parallel=dataclasses.replace(run.parallel, grad_compression="int8"))
    batch = {k: torch.from_numpy(v).cuda() for k, v in trainer.pipeline.batch(3).items()}
    seen = []
    roundtrip = steps_mod.roundtrip_int8

    def spy(x, amax=None):
        out = roundtrip(x, amax)
        if len(seen) < INT8_CHECKED and x.numel() <= INT8_CHECK_NUMEL:
            q, s = quantize_int8(x, amax)
            seen.append(tuple(t.to("cpu", copy=True) for t in (x, amax, out, q, s)))
        return out

    def timed_step(step, state):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, metrics = step(trainer.params, state, batch)
        loss = metrics["loss"].item()
        return params, state, loss, time.perf_counter() - t0

    _, trainer.opt_state, plain_loss, plain_s = timed_step(trainer._step_fn, trainer.opt_state)
    state = dict(trainer.opt_state, ef=ErrorFeedback.init(trainer.params))
    ef_bytes = sum(r.numel() * r.element_size() for r in state["ef"].values())
    step = steps_mod.make_train_step(trainer.model, irun, trainer.opt_cfg)
    compress = steps_mod._compress
    stage_s = []

    def timed_compress(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = compress(*a, **kw)
        torch.cuda.synchronize()
        stage_s.append(time.perf_counter() - t0)
        return out
    steps_mod.roundtrip_int8, steps_mod._compress = spy, timed_compress
    ops.reset_launch_counts()
    try:
        _, state, loss, int8_s = timed_step(step, state)
    finally:
        steps_mod.roundtrip_int8, steps_mod._compress = roundtrip, compress
    counts = ops.launch_counts()
    resid = max(float(r.abs().max()) for r in state["ef"].values())
    del state
    bad = []
    for i, (x, amax, out, q, s) in enumerate(seen):
        cq, cs = quantize_int8(x, amax)
        if not (torch.equal(out, dequantize_int8(cq, cs).to(x.dtype)) and torch.equal(q, cq)
                and torch.equal(s, cs)):
            bad.append(i)
    print(f"  train int8 step (ef {ef_bytes / 1e9:.3f} GB, fp32 a parameter): loss {loss:.6f} "
          f"(plain step {plain_loss:.6f}); step_s {int8_s:.4f} against the plain step's "
          f"{plain_s:.4f} ({(int8_s - plain_s) * 1e3:+.1f} ms), of it the int8 stage "
          f"(amax, error feedback, round trip) {stage_s[0] * 1e3:.1f} ms; largest residual "
          f"{resid:.3e}; "
          f"{len(seen)} quantised leaves of {[tuple(x.shape) for x, *_ in seen]} bit-equal to "
          f"the CPU's quantisation: {not bad}; rmsnorm launches {counts['rmsnorm']}",
          flush=True)
    if not math.isfinite(loss) or len(seen) < INT8_CHECKED or bad or not resid > 0:
        fail(f"train int8 step: loss {loss}, {len(seen)} leaves checked, leaves {bad} differ "
             f"from the CPU's quantisation, largest residual {resid}")
    return counts


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


# the stacked leaves the optimizer check updates: (arch, parameter paths)
STACK_CHECKS = (("yi-34b", ("ln1.scale", "ln2.scale")),
                ("zamba2-7b", ("cell.A_log", "cell.dt_bias", "cell.D", "cell.conv_b")))
STACK_TOL = 1e-6


def stacked_update_check(card: str) -> None:
    """``STACK_CHECKS``' stacked leaves (every layer of the full config,
    fp32) updated twice by ``adamw.apply_updates`` under ``adamw_factored``
    and ``adamw_8bit`` on the card and on the CPU, from the same seeded
    parameters and gradients: the stacks that the optimizer updates as one
    (``adamw.stacks``: a factored (units, d) leaf; 8-bit blocks that span
    layers) and those it slices a layer at a time. Parameters (relative to
    max(1, |p|): a second 8-bit moment decoded as 0 moves an element by lr *
    mu / eps) and fp32 statistics within ``STACK_TOL`` (their row and column
    means are sums in another order), bf16 first moments, 8-bit codes and
    scales equal (all elementwise but the scale's maximum). Fails otherwise."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.train.steps import jax_leaves

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(35)
    lines = []
    for arch, paths in STACK_CHECKS:
        model = build_model(get_config(arch), device="meta")
        leaves = {n: leaf for n, leaf in jax_leaves(model).items()
                  if n.split(".", 2)[2] in paths}
        shapes = {n: tuple(p.shape) for n, p in model.named_parameters() if n in leaves}
        del model
        p0 = {n: 0.1 * torch.randn(shape, generator=gen) for n, shape in shapes.items()}
        grads = [{n: 1e-2 * torch.randn(shape, generator=gen) for n, shape in shapes.items()}
                 for _ in range(2)]
        for kind in ("adamw_factored", "adamw_8bit"):
            cfg = adamw.OptimizerConfig(kind=kind)
            stacks = adamw.stacks(cfg, shapes, leaves)
            out = {}
            for dev in ("cuda", "cpu"):
                params = {n: v.to(dev, copy=True) for n, v in p0.items()}
                state = adamw.init_state(cfg, params, leaves)
                for i, g in enumerate(grads):
                    lr = adamw.warmup_cosine(state["step"], base_lr=1e-3, warmup=1, total=10)
                    params, state = adamw.apply_updates(
                        cfg, params, {n: v.to(dev) for n, v in g.items()}, state, lr, leaves)
                out[dev] = ({n: v.cpu() for n, v in params.items()},
                            {n: {k: v.cpu() for k, v in st.items()}
                             for n, st in state["m"].items()})
            (p_gpu, m_gpu), (p_cpu, m_cpu) = out["cuda"], out["cpu"]
            p_err = max(((p_gpu[n] - p_cpu[n]).abs() / p_cpu[n].abs().clamp(min=1.0))
                        .max().item() for n in shapes)
            moved = max((p_cpu[n] - p0[n]).abs().max().item() for n in shapes)
            s_err, unequal, tensors = 0.0, [], 0
            for n in shapes:
                if m_gpu[n].keys() != m_cpu[n].keys():
                    fail(f"stacked update {arch} {kind}: {n}'s state keys differ")
                for k, v in m_gpu[n].items():
                    tensors += 1
                    want = m_cpu[n][k]
                    if v.dtype == torch.float32 and not k.endswith("_s"):
                        s_err = max(s_err, ((v - want).abs() / (want.abs() + 1e-30)).max().item()
                                    if k.startswith("nu") else (v - want).abs().max().item())
                    elif not torch.equal(v, want):
                        unequal.append(f"{n}/{k}")
            joint = sum(len(ms) for ms in stacks.values())
            lines.append(f"{arch} {kind}: {len(shapes)} tensors, {len(stacks)} stacks updated as "
                         f"one ({joint} layers), max param diff {p_err:.3e} (moved "
                         f"{moved:.3e}), max state diff {s_err:.3e}, {tensors} state tensors, "
                         f"{len(unequal)} unequal")
            if p_err > STACK_TOL or s_err > STACK_TOL or unequal or not moved > 10 * STACK_TOL \
                    or (kind == "adamw_factored" and not stacks):
                fail(f"stacked update {arch} {kind}: param diff {p_err}, state diff {s_err}, "
                     f"unequal {unequal[:4]}, moved {moved}, stacks {len(stacks)}")
    print(f"  stacked optimizer updates on the card against the CPU ({time.perf_counter() - t0:.1f}"
          f" s; {card}): " + "; ".join(lines), flush=True)


def mesh_phase() -> dict:
    """One full-width gemma2-2b step through the sharded step on a world-1
    NCCL (1, 1) mesh and one through the one-device step, from the same
    weights and batch, under ``adamw`` and under ``adamw_factored``: loss
    and parameters equal (``torch.equal``) or the leaves that differ
    printed, with whether the one-device step repeats itself. Returns the
    sharded ``adamw`` step's launch counts."""
    import gc
    import torch
    import torch.distributed as dist
    from repro_torch.common.config import ShapeSpec
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as shd
    from repro_torch.train.steps import gather, jax_leaves, make_train_step, shard_train_state

    gc.collect()        # what the train phase left in reference cycles
    torch.cuda.empty_cache()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_local_mesh(1, 1, device="cuda")
        run = get_config("gemma2-2b")
        run = run.replace(train=dataclasses.replace(run.train, global_batch=TRAIN_BATCH))
        shape = ShapeSpec("train", run.train.seq_len, TRAIN_BATCH, "train")
        batch = {k: torch.from_numpy(v).cuda() for k, v in TokenPipeline(
            run.model, shape, PipelineConfig(seed=run.train.seed)).batch(0).items()}
        model = build_model(run, device="cuda")
        model.init_weights(torch.Generator("cuda").manual_seed(run.train.seed))
        params = dict(model.named_parameters())
        w0 = {n: p.detach().to("cpu", copy=True) for n, p in params.items()}
        cfg = adamw.OptimizerConfig(kind=run.parallel.optimizer_state,
                                    weight_decay=run.train.weight_decay)

        def plain_step(cfg=cfg):
            with torch.no_grad():
                for n, p in params.items():
                    p.copy_(w0[n])
            state = adamw.init_state(cfg, params, jax_leaves(model))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, state, met = make_train_step(model, run, cfg)(params, state, batch)
            loss = met["loss"].item()
            seconds = time.perf_counter() - t0
            return loss, {n: p.detach().to("cpu", copy=True) for n, p in params.items()}, seconds

        def same_step(kind, after, plain_after, loss, plain_loss):
            """The sharded step's loss and parameters ``torch.equal`` to the
            one-device step's, or the leaves that differ printed; fails
            above a learning rate's difference."""
            diff = {n: float((after[n].float() - plain_after[n].float()).abs().max())
                    for n in after if not torch.equal(after[n], plain_after[n])}
            print(f"  mesh {kind}: loss equal: {loss == plain_loss}, parameters "
                  f"torch.equal: {not diff}", flush=True)
            if diff or loss != plain_loss:
                worst = max(diff.items(), key=lambda kv: kv[1], default=(None, 0.0))
                print(f"  mesh {kind}: {len(diff)} leaves differ (largest {worst[0]}: "
                      f"{worst[1]:.3e})", flush=True)
                if worst[1] > run.train.learning_rate or abs(loss - plain_loss) > 1e-3 * abs(
                        plain_loss):
                    fail(f"mesh: the sharded {kind} step is more than a learning rate from "
                         "the one-device step")

        # twice from the same weights: the second time is warm, and the two
        # show whether the one-device step repeats itself bit for bit
        plain_loss, plain_after, plain_cold = plain_step()
        again_loss, again, plain_s = plain_step()
        repeat = again_loss == plain_loss and all(
            torch.equal(again[n], plain_after[n]) for n in again)
        del again
        # adamw_factored one step on one device too, before the sharded step
        # cuts the model (its first moment on the shards there, its
        # statistics reduced over the mesh)
        fcfg = dataclasses.replace(cfg, kind="adamw_factored")
        f_plain_loss, f_plain_after, f_plain_s = plain_step(fcfg)
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(w0[n])
        placements = shd.param_placements(params, mesh)
        masters, state = shard_train_state(params, adamw.init_state(cfg, params, jax_leaves(model)),
                                           cfg, mesh, placements)
        step = make_train_step(model, run, cfg, mesh)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        masters, state, met = step(masters, state, batch)
        loss = met["loss"].item()
        sharded_cold = time.perf_counter() - t0
        counts = ops.launch_counts()
        after = {n: t.to("cpu", copy=True) for n, t in gather(masters).items()}
        t0 = time.perf_counter()
        masters, state, met = step(masters, state, batch)
        warm_loss = met["loss"].item()
        sharded_s = time.perf_counter() - t0
        del state, masters
        sharded = sum(1 for pl in placements.values() if any(
            type(p).__name__ == "Shard" for p in pl))
        print(f"  mesh {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))} nccl world 1: "
              f"{sharded} of {len(placements)} leaves under Shard placements; sharded step "
              f"{sharded_cold:.4f} s (first: the NCCL communicators start), then "
              f"{sharded_s:.4f} s; one-device step {plain_cold:.4f} s, then {plain_s:.4f} s; "
              f"loss {loss!r} against {plain_loss!r}; rmsnorm launches {counts['rmsnorm']}; "
              f"the one-device step repeats itself bit for bit: {repeat}", flush=True)
        same_step("adamw", after, plain_after, loss, plain_loss)
        del after, plain_after

        with torch.no_grad():
            for n, p in params.items():
                p.copy_(w0[n])
        masters, state = shard_train_state(params, adamw.init_state(fcfg, params, jax_leaves(model)),
                                           fcfg, mesh, placements)
        step = make_train_step(model, run, fcfg, mesh)
        t0 = time.perf_counter()
        masters, state, met = step(masters, state, batch)
        f_loss = met["loss"].item()
        f_s = time.perf_counter() - t0
        f_after = {n: t.to("cpu", copy=True) for n, t in gather(masters).items()}
        mu = [v["mu"].to_local().numel() for v in state["m"].values() if "nu_row" in v]
        del state, masters
        print(f"  mesh adamw_factored: sharded step {f_s:.4f} s, one-device {f_plain_s:.4f} s; "
              f"loss {f_loss!r} against {f_plain_loss!r}; {len(mu)} factored first moments, "
              f"{sum(mu) / 1e9:.4f} B elements on the shards", flush=True)
        same_step("adamw_factored", f_after, f_plain_after, f_loss, f_plain_loss)
        if counts["rmsnorm"] == 0 or not (math.isfinite(loss) and math.isfinite(warm_loss)):
            fail(f"mesh: launches {counts}, losses {loss}, {warm_loss}")
        del model, params, w0
        return dict(counts, serve=mesh_serve_check(mesh))
    finally:
        dist.destroy_process_group()


def mesh_serve_check(mesh) -> dict:
    """gemma2-2b at full width served on the world-1 mesh with its weights
    and caches on the rank's shards (``serve(..., sharded=True)``: the
    sharded prefill and decode of ``models/attention.py``) and on one
    device, from the same seed: tokens and prefill logits ``torch.equal``.
    Returns the sharded serve's launch counts (reset just before it)."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve

    gc.collect()
    torch.cuda.empty_cache()
    run = get_config("gemma2-2b")
    kw = dict(batch=B, prompt_len=PROMPT, decode_steps=STEPS, device="cuda", seed=0)
    ops.reset_launch_counts()
    sharded = serve(run, mesh=mesh, sharded=True, **kw)
    counts = ops.launch_counts()
    one = serve(run, **kw)
    same_tokens = bool((sharded["tokens"] == one["tokens"]).all())
    same_logits = torch.equal(sharded["prefill_logits"], one["prefill_logits"])
    print(f"  mesh serve (sharded=True, world 1): prefill_s {sharded['prefill_s']:.4f}, "
          f"decode_tok_per_s {sharded['decode_tok_per_s']:.2f} (one device "
          f"{one['prefill_s']:.4f}, {one['decode_tok_per_s']:.2f}); tokens equal: {same_tokens}; "
          f"prefill logits torch.equal: {same_logits}; launches {counts}", flush=True)
    if not (same_tokens and same_logits) or not all(counts.values()):
        fail("mesh: the sharded serve differs from the one-device serve, or a kernel did not "
             "launch")
    return counts


TP_ARCH = "stablelm-12b"
TP_MESH = {"data": 1, "model": 8}
TP_SEQ, TP_BATCH, TP_STEPS = 4096, 2, 2
TP_PEAK_TOL = 0.10        # the measured peak within 10 % of the predicted one


def tp_run():
    """stablelm-12b's config at ``[tp]``'s size: one microbatch of batch 2 at
    seq 4096 (the config's 8 microbatches of 256 cut to one card's rank)."""
    from repro_torch.configs import get_config
    run = get_config(TP_ARCH)
    return run.replace(parallel=dataclasses.replace(run.parallel, microbatches=1),
                       train=dataclasses.replace(run.train, seq_len=TP_SEQ,
                                                 global_batch=TP_BATCH))


BATCH_MODE_MESH = {"data": 1, "model": 2}
SEQ_MODE_MESH = {"data": 1, "model": 8}


def batch_mode_check(card: str) -> dict:
    """gemma2-2b's prefill attention (layer 0, its window) under
    ``attn_activation_sharding`` "batch" on rank 0 of a (data 1, model 2)
    mesh under the fake group, at batch B and the PROMPT-token prompt: the
    layer's weights whole on the rank, as a layer whose heads do not divide
    ``model`` holds them (gemma2-2b's 8 heads at the production mesh's 16),
    so that nothing the flash kernel reads crosses the fake group. Fails
    unless the kernel is launched on the rank's rows only (its q holds B / 2
    rows; as many launches as the one-device call's) and its output rows are
    within ``ROW_REL_TOL`` of the one-device layer's flash output at those
    rows. Returns the rank's launch counts."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.models.attention import GQAttention, KVCache, layer_window
    from repro_torch.parallel import tensor

    cfg = get_config("gemma2-2b").model
    gen = torch.Generator(device="cuda").manual_seed(21)
    layer = GQAttention(cfg, torch.bfloat16, "cuda", sp_attn="batch")
    with torch.no_grad():
        layer.init_weights(gen)
    x = randn((B, PROMPT, cfg.d_model), torch.bfloat16, gen)
    kv = (B, PROMPT, cfg.n_kv_heads, cfg.resolved_head_dim)
    seen, real = [], ops.flash_attention

    def spy(q, k, v, **kw):
        out = real(q, k, v, **kw)
        seen.append((tuple(q.shape), out))
        return out

    def prefill():
        ops.reset_launch_counts()
        cache = KVCache(torch.zeros(kv, dtype=torch.bfloat16, device="cuda"),
                        torch.zeros(kv, dtype=torch.bfloat16, device="cuda"))
        with torch.no_grad():
            layer.prefill(x, cache, window=layer_window(cfg, 0))
        torch.cuda.synchronize()
        return seen[-1], ops.launch_counts()

    ops.flash_attention = spy
    try:
        (whole_q, whole_out), whole_counts = prefill()
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=math.prod(BATCH_MODE_MESH.values()))
        try:
            mesh = init_device_mesh("cuda", tuple(BATCH_MODE_MESH.values()),
                                    mesh_dim_names=tuple(BATCH_MODE_MESH))
            layer.tp = tensor.TensorParallel(mesh)
            (rank_q, rank_out), counts = prefill()
        finally:
            dist.destroy_process_group()
    finally:
        ops.flash_attention = real
    rows = B // BATCH_MODE_MESH["model"]
    rel = ref.max_row_rel_err(rank_out, whole_out[:rows])
    tol = ref.ROW_REL_TOL[torch.bfloat16]
    print(f"  batch mode: rank 0 of {BATCH_MODE_MESH}, gemma2-2b layer 0 prefill at batch {B} x "
          f"{PROMPT}: flash q {rank_q} (one device {whole_q}), launches {counts['flash_attention']} "
          f"(one device {whole_counts['flash_attention']}); its rows against the one-device "
          f"layer's rows 0..{rows - 1}: max_row_rel_err {rel:.3e} (limit {tol:g}); {card}",
          flush=True)
    if rank_q[0] != rows or whole_q[0] != B \
            or counts["flash_attention"] != whole_counts["flash_attention"] \
            or not counts["flash_attention"] or rel > tol:
        fail(f"batch mode: flash q {rank_q} against {whole_q}, launches {counts} against "
             f"{whole_counts}, max_row_rel_err {rel:.3e}")
    return counts


def sequence_mode_check(card: str) -> dict:
    """gemma2-2b's prefill attention (layer 0, its window, and layer 1,
    global) under ``attn_activation_sharding`` "sequence" on the last rank
    of a (data 1, model 8) mesh under the fake group, at batch B and the
    PROMPT-token prompt: the layer's weights whole on the rank, as a layer
    whose heads do not divide ``model`` holds them, so that nothing the
    flash kernel reads crosses the fake group (its output's gather over
    ``model`` moves nothing). Fails unless the kernel is launched on the
    rank's query positions only (q of PROMPT / 8 positions at q_offset
    7 x PROMPT / 8, against every key; as many launches as the one-device
    call's) and its output rows are within ``ROW_REL_TOL`` of the one-device
    layer's flash output at those positions. Returns the rank's launch
    counts, summed over the two layers."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.models.attention import GQAttention, KVCache, layer_window
    from repro_torch.parallel import tensor

    cfg = get_config("gemma2-2b").model
    gen = torch.Generator(device="cuda").manual_seed(22)
    layer = GQAttention(cfg, torch.bfloat16, "cuda", sp_attn="sequence")
    with torch.no_grad():
        layer.init_weights(gen)
    x = randn((B, PROMPT, cfg.d_model), torch.bfloat16, gen)
    kv = (B, PROMPT, cfg.n_kv_heads, cfg.resolved_head_dim)
    seen, real = [], ops.flash_attention
    size = SEQ_MODE_MESH["model"]
    sq, start = PROMPT // size, (size - 1) * (PROMPT // size)

    def spy(q, k, v, **kw):
        out = real(q, k, v, **kw)
        seen.append((tuple(q.shape), kw.get("q_offset", 0), out))
        return out

    def prefill(i):
        ops.reset_launch_counts()
        cache = KVCache(torch.zeros(kv, dtype=torch.bfloat16, device="cuda"),
                        torch.zeros(kv, dtype=torch.bfloat16, device="cuda"))
        with torch.no_grad():
            layer.prefill(x, cache, window=layer_window(cfg, i))
        torch.cuda.synchronize()
        return seen[-1], ops.launch_counts()

    ops.flash_attention = spy
    total = collections.Counter()
    tol = ref.ROW_REL_TOL[torch.bfloat16]
    try:
        whole = [prefill(i) for i in (0, 1)]
        dist.init_process_group("fake", store=FakeStore(), rank=size - 1,
                                world_size=math.prod(SEQ_MODE_MESH.values()))
        try:
            mesh = init_device_mesh("cuda", tuple(SEQ_MODE_MESH.values()),
                                    mesh_dim_names=tuple(SEQ_MODE_MESH))
            layer.tp = tensor.TensorParallel(mesh)
            ranks = [prefill(i) for i in (0, 1)]
        finally:
            dist.destroy_process_group()
    finally:
        ops.flash_attention = real
    for i, (((whole_q, _, whole_out), whole_counts),
            ((rank_q, offset, rank_out), counts)) in enumerate(zip(whole, ranks)):
        rel = ref.max_row_rel_err(rank_out, whole_out[:, start:])
        print(f"  sequence mode: rank {size - 1} of {SEQ_MODE_MESH}, gemma2-2b layer {i} "
              f"(window {layer_window(cfg, i)}) prefill at batch {B} x {PROMPT}: flash q "
              f"{rank_q} at q_offset {offset} (one device {whole_q}), launches "
              f"{counts['flash_attention']} (one device {whole_counts['flash_attention']}); "
              f"its rows against the one-device layer's positions {start}..{PROMPT - 1}: "
              f"max_row_rel_err {rel:.3e} (limit {tol:g}); {card}", flush=True)
        if rank_q[1] != sq or offset != start or whole_q[1] != PROMPT \
                or counts["flash_attention"] != whole_counts["flash_attention"] \
                or not counts["flash_attention"] or rel > tol:
            fail(f"sequence mode, layer {i}: flash q {rank_q} at offset {offset} against "
                 f"{whole_q}, launches {counts} against {whole_counts}, max_row_rel_err "
                 f"{rel:.3e}")
        total.update(counts)
    return dict(total)


def mesh_name(sizes: dict) -> str:
    return "_".join(f"{a}{n}" for a, n in sizes.items())


def tp_rank(run, shape, steps: int, arch: str = TP_ARCH, mesh_sizes=TP_MESH, rec=None) -> dict:
    """The dry run of rank 0 of ``run``'s train step at ``shape`` on a mesh
    of ``mesh_sizes`` ((data 1, model 8) unless given), then that rank on the
    card under the fake group (module docstring): drawn on its shards, its
    optimizer state made, ``steps`` steps. Returns the record's memory and
    costs, the card's peak during the steps over the memory held before the
    draw (the draw's own temporaries left out; ``draw_peak`` is the draw's
    peak over the same base, printed beside it), each step's
    losses, grad norms, seconds and launch counts, the stored optimizer
    bytes, the parameter counts and each recurrent cell's g where it
    computes on a part of one head (else 0). ``rec``: the dry run's record,
    made already (``xlstm_dry_runs``)."""
    import gc
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as norm
    from repro_torch.launch import dryrun as dr
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.parallel import tensor
    from repro_torch.train.steps import init_train_state, make_train_step

    t0 = time.perf_counter()
    if rec is None:
        with tempfile.TemporaryDirectory() as out:
            rec = dr.run_cell(arch, shape.name, False, False, out,
                              mesh=(mesh_name(mesh_sizes), mesh_sizes), run=run, shape=shape)
    if rec["status"] != "ok":
        fail(f"tp: the dry run of the rank failed: {rec.get('error')}")
    mem = rec["memory"]
    print(f"  dry run of rank 0 ({run.parallel.optimizer_state}, "
          f"{time.perf_counter() - t0:.1f} s): predicted peak "
          f"{mem['peak_bytes'] / 2**30:.3f} GiB (stored {mem['argument_bytes'] / 2**30:.3f}, "
          f"gathered {mem['gathered_bytes'] / 2**30:.3f}, temporaries "
          f"{mem['temp_bytes'] / 2**30:.3f}); {rec['cost_analysis']['flops_per_device']:.4e} "
          f"FLOPs, collectives {rec['collectives']['counts']}", flush=True)

    gc.collect()
    torch.cuda.empty_cache()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(mesh_sizes.values()))
    try:
        mesh = init_device_mesh("cuda", tuple(mesh_sizes.values()),
                                mesh_dim_names=tuple(mesh_sizes))
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        model = build_model(run, device="meta")
        tensor.build_sharded(model, mesh, torch.Generator("cuda").manual_seed(run.train.seed))
        cfg = adamw.OptimizerConfig(kind=run.parallel.optimizer_state,
                                    weight_decay=run.train.weight_decay)
        masters, state = init_train_state(model, cfg, mesh)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        # the steps' peak from here: the draw makes each block whole before it
        # cuts it (xlstm-125m's whole embedding, 0.43 GiB of draw temporaries,
        # is above its rank's step); the draw's own peak is printed beside it
        draw_peak = torch.cuda.max_memory_allocated() - base
        torch.cuda.reset_peak_memory_stats()
        held_opt = _nbytes(*(t.to_local() if hasattr(t, "to_local") else t
                             for t in _leaves(state)))
        whole = sum(math.prod(p.tp_full_shape) for p in model.parameters())
        local = sum(p.numel() for p in model.parameters())
        step = make_train_step(model, run, cfg, mesh)
        parts = [getattr(m.head_part(), "g", 0) for m in model.modules()
                 if hasattr(m, "head_part")]
        # token ids in this rank's vocab shard: the fake group does not add the
        # other ranks' rows of the embedding, so a token outside the shard would
        # embed as zeros here (with the whole vocab the 40-layer gradient is NaN
        # from step 1 on; with the shard's tokens it is finite)
        shard = run.model.vocab_size // mesh_sizes["model"]
        batch = {k: torch.from_numpy(v % shard).cuda() for k, v in TokenPipeline(
            run.model, shape, PipelineConfig(seed=run.train.seed)).batch(0).items()}
        losses, norms, seconds, launches = [], [], [], []
        for _ in range(steps):
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            masters, state, met = step(masters, state, batch)
            losses.append(met["loss"].item())
            seconds.append(time.perf_counter() - t0)
            norms.append(met["grad_norm"].item())
            launches.append(dict(ops.launch_counts(), rmsnorm_split=norm.split_launches))
        peak = torch.cuda.max_memory_allocated() - base
        del masters, state, step, model
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    return {"mem": mem, "peak": peak, "draw_peak": draw_peak,
            "miss": peak / mem["peak_bytes"] - 1, "losses": losses,
            "norms": norms, "seconds": seconds, "launches": launches, "held_opt": held_opt,
            "build_s": build_s, "local": local, "whole": whole, "shard": shard, "parts": parts}


def tp_phase(card: str) -> dict:
    """Phase 13: one rank of stablelm-12b's tensor-parallel train step on the
    card under the fake group (module docstring), ``TP_STEPS`` steps under
    its config's optimizer, then one under ``adamw_8bit`` (its embedding's
    and head's 8-bit state on their shards, ``steps.BlockShards``; the
    layers' whole on every rank), its peak printed beside the dry run's.
    Returns the launch counts of the first."""
    from repro_torch.common.config import ShapeSpec

    run = tp_run()
    shape = ShapeSpec("train_tp_card", TP_SEQ, TP_BATCH, "train")
    r = tp_rank(run, shape, TP_STEPS)
    mem, peak, miss, launches = r["mem"], r["peak"], r["miss"], r["launches"]
    losses, norms, held_opt = r["losses"], r["norms"], r["held_opt"]
    predicted = mem["peak_bytes"]
    print(f"  rank 0 of {TP_MESH} ({run.model.n_layers} layers, d_model {run.model.d_model}, "
          f"{run.model.n_heads} heads on {TP_MESH['model']}): {r['local'] / 1e9:.4f} B of "
          f"{r['whole'] / 1e9:.4f} B parameters held, drawn in {r['build_s']:.2f} s; step seconds "
          f"{[round(x, 4) for x in r['seconds']]}; max_memory_allocated {peak / 2**30:.3f} GiB "
          f"(the weights' draw {r['draw_peak'] / 2**30:.3f} GiB, not held to the dry run) "
          f"against the dry run's {predicted / 2**30:.3f} GiB ({miss:+.2%}, "
          f"{'within' if abs(miss) <= TP_PEAK_TOL else 'outside'} "
          f"{TP_PEAK_TOL:.0%}); rmsnorm launches a step {[c['rmsnorm'] for c in launches]}; "
          f"losses {losses}, grad norms {norms} (not a model's: the fake group sums "
          f"nothing; token ids below {r['shard']}, this rank's vocab shard); {card}", flush=True)
    print(f"  rank 0's stored optimizer state {held_opt / 2**30:.3f} GiB "
          f"({held_opt} bytes) against the dry run's {mem['opt_bytes'] / 2**30:.3f} GiB of "
          f"{mem['argument_bytes'] / 2**30:.3f} GiB stored (argument_bytes)", flush=True)
    if any(c["rmsnorm"] == 0 for c in launches) or not all(map(math.isfinite, losses + norms)):
        fail(f"tp: launches {launches}, losses {losses}, grad norms {norms}")
    if held_opt != mem["opt_bytes"]:
        fail(f"tp: the rank holds {held_opt} bytes of optimizer state, the dry run "
             f"predicts {mem['opt_bytes']}")
    if abs(miss) > TP_PEAK_TOL:
        fail(f"tp: max_memory_allocated {peak / 2**30:.3f} GiB misses the dry run's "
             f"{predicted / 2**30:.3f} GiB by {miss:+.2%}")

    q8 = tp_rank(run.replace(parallel=dataclasses.replace(run.parallel,
                                                          optimizer_state="adamw_8bit")),
                 shape, 1)
    print(f"  rank 0 under adamw_8bit: one step {q8['seconds'][0]:.4f} s, loss "
          f"{q8['losses'][0]}, grad norm {q8['norms'][0]}; stored optimizer state "
          f"{q8['held_opt'] / 2**30:.3f} GiB (dry run {q8['mem']['opt_bytes'] / 2**30:.3f}); "
          f"max_memory_allocated {q8['peak'] / 2**30:.3f} GiB (the weights' draw "
          f"{q8['draw_peak'] / 2**30:.3f} GiB) against the dry run's "
          f"{q8['mem']['peak_bytes'] / 2**30:.3f} GiB ({q8['miss']:+.2%}; gathered "
          f"{q8['mem']['gathered_bytes'] / 2**30:.3f} GiB); {card}", flush=True)
    if not all(map(math.isfinite, q8["losses"] + q8["norms"])) \
            or q8["held_opt"] != q8["mem"]["opt_bytes"]:
        fail(f"tp 8-bit: losses {q8['losses']}, grad norms {q8['norms']}, stored optimizer "
             f"bytes {q8['held_opt']} against the dry run's {q8['mem']['opt_bytes']}")
    return dict(launches[-1], peak_bytes=peak, draw_peak_bytes=r["draw_peak"],
                predicted_peak_bytes=predicted,
                step_s=r["seconds"], adamw_8bit=dict(peak_bytes=q8["peak"],
                                                      predicted_peak_bytes=q8["mem"]["peak_bytes"]))



TP_SERVE_ARCH = "yi-34b"


def tp_serve_phase(card: str, arch: str = TP_SERVE_ARCH, run=None, steps: int = STEPS,
                   split: bool = False, mesh_sizes=TP_MESH, rec=None, rank: int = 0) -> dict:
    """One rank (rank 0) of yi-34b's sharded serve on a (data 1, model 8)
    mesh under the fake group, at its 60 layers and published widths:
    ``serve(..., sharded=True)`` with batch B, the PROMPT-token prompt and
    STEPS decode steps (the cache CACHE = 8 x 548 long, its sequence over
    model: the rank holds positions 0..547 of every layer's cache and
    launches the decode kernel's shard mode over them), its 7 q heads and 1
    kv head a layer through the flash kernel. ``max_memory_allocated`` from
    the end of the weights' draw (the draw makes a block whole before it
    cuts it) against the dry run's peak of the rank's prefill cell (the
    prompt's length, the same placement), within ``TP_PEAK_TOL``; finite
    logits, tokens in range, each kernel launched (the counts reset just
    before the serve). The outputs are not a model's: the fake group sums
    nothing. Returns the launch counts. ``arch``, ``run`` and ``steps``: another
    config's rank at ``steps`` decode steps (a kernel it has no layer for
    need not launch); ``split``: its recurrent cells on the rank's heads,
    RMSNorm's split mode launched too; ``mesh_sizes``: another mesh;
    ``rec``: the dry run's record, made already; ``rank``: the rank the card
    runs (the dry run traces the last: ``dryrun.traced_rank``)."""
    import gc
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.common.config import ShapeSpec
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch import serve as serve_mod

    from repro_torch.kernels import rmsnorm as norm
    run = get_config(arch) if run is None else run
    shape = ShapeSpec("prefill_tp_card", PROMPT, B, "prefill")
    t0 = time.perf_counter()
    if rec is None:
        with tempfile.TemporaryDirectory() as out:
            rec = dr.run_cell(arch, shape.name, False, False, out,
                              mesh=(mesh_name(mesh_sizes), mesh_sizes), run=run, shape=shape)
    if rec["status"] != "ok":
        fail(f"tp serve: the dry run of the rank failed: {rec.get('error')}")
    mem = rec["memory"]
    print(f"  dry run of the rank's prefill ({time.perf_counter() - t0:.1f} s): predicted peak "
          f"{mem['peak_bytes'] / 2**30:.3f} GiB (stored {mem['argument_bytes'] / 2**30:.3f}: "
          f"cache {mem['cache_bytes'] / 2**30:.3f}; gathered {mem['gathered_bytes'] / 2**30:.3f}, "
          f"temporaries {mem['temp_bytes'] / 2**30:.3f}); "
          f"{rec['cost_analysis']['flops_per_device']:.4e} FLOPs, collectives "
          f"{rec['collectives']['counts']}", flush=True)

    gc.collect()
    torch.cuda.empty_cache()
    draw = serve_mod.tensor.build_sharded

    def drawn(*args, **kw):        # the peak of serving, from the end of the draw
        tp = draw(*args, **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        return tp

    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=math.prod(mesh_sizes.values()))
    serve_mod.tensor.build_sharded = drawn
    try:
        mesh = init_device_mesh("cuda", tuple(mesh_sizes.values()),
                                mesh_dim_names=tuple(mesh_sizes))
        base = torch.cuda.memory_allocated()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = serve_mod.serve(run, batch=B, prompt_len=PROMPT, decode_steps=steps, device="cuda",
                              mesh=mesh, sharded=True)
        seconds = time.perf_counter() - t0
        counts = dict(ops.launch_counts(), rmsnorm_split=norm.split_launches)
        peak = torch.cuda.max_memory_allocated() - base
    finally:
        serve_mod.tensor.build_sharded = draw
        dist.destroy_process_group()
    predicted = mem["peak_bytes"]
    miss = peak / predicted - 1
    logits, toks = res["prefill_logits"], res["tokens"]
    n_layers = run.model.n_layers
    apps = attention_applications(run.model)
    want = {"flash_attention": apps, "decode_attention": apps * steps}
    timed = res["kernel_launches"]
    m = mesh_sizes["model"]
    print(f"  tp serve: rank {rank} of {mesh_sizes} {arch} ({n_layers} layers, "
          f"{run.model.n_heads} heads on {run.model.n_kv_heads} on {m}), batch {B}, "
          f"prompt {PROMPT}, {steps} steps, cache {-(-CACHE // m) * m} ({-(-CACHE // m)} a "
          "rank): "
          f"{res['weight_bytes'] / 2**30:.3f} GiB of weights held; serve {seconds:.2f} s with the "
          f"draw; prefill_s {res['prefill_s']:.4f}, decode_tok_per_s "
          f"{res['decode_tok_per_s']:.2f}; max_memory_allocated {peak / 2**30:.3f} GiB against "
          f"the dry run's {predicted / 2**30:.3f} GiB ({miss:+.2%}, "
          f"{'within' if abs(miss) <= TP_PEAK_TOL else 'outside'} {TP_PEAK_TOL:.0%}); "
          f"launches timed {timed}, in all {counts}; {card}", flush=True)
    if not torch.isfinite(logits).all() or toks.min() < 0 or toks.max() >= run.model.vocab_size:
        fail("tp serve: prefill logits not finite or tokens out of range")
    if not all(v for k, v in counts.items() if (k != "rmsnorm_split" or split) and want.get(k, 1)) \
            or any(timed[k] != v for k, v in want.items()):
        fail(f"tp serve: launches {timed} timed, {counts} in all; expected {want} timed")
    if abs(miss) > TP_PEAK_TOL:
        fail(f"tp serve: max_memory_allocated {peak / 2**30:.3f} GiB misses the dry run's "
             f"{predicted / 2**30:.3f} GiB by {miss:+.2%}")
    return dict(counts, peak_bytes=peak, predicted_peak_bytes=predicted,
                prefill_s=res["prefill_s"], decode_tok_per_s=res["decode_tok_per_s"])


TP_SSM_ARCH = "zamba2-7b"
TP_SSM_LAYERS = 6          # one unit: 6 Mamba2 cells and the shared attention block
TP_SSM_STEPS = 4


def tp_ssm_run():
    """zamba2-7b at full width cut to one unit, one microbatch of batch 2 at
    seq 4096 (``[tp]``'s size)."""
    from repro_torch.configs import get_config
    run = get_config(TP_SSM_ARCH)
    return run.replace(model=dataclasses.replace(run.model, n_layers=TP_SSM_LAYERS),
                       parallel=dataclasses.replace(run.parallel, microbatches=1),
                       train=dataclasses.replace(run.train, seq_len=TP_SEQ,
                                                 global_batch=TP_BATCH))


@contextlib.contextmanager
def filled_collectives():
    """The fake group's all-to-all, all-gather and reduce-scatter leave their
    outputs unwritten on the card (uninitialised memory, NaN at times),
    where on the CPU the all-to-all fills each received piece with the first
    rows of the rank's input. Under this context every such collective of
    ``parallel.tensor`` is issued to the group as before and its output then
    filled in place, so that a rank's values stay finite (they are not a
    model's either way): an all-to-all as on the CPU, an all-gather with the
    rank's input in every rank's place, a reduce-scatter with the rank's own
    chunk of its input (one copy kernel each). Yields a dict counting each
    collective issued on the card by (kind, group size), the all-reduces
    included (a dry run's trace on the meta device is not counted)."""
    from repro_torch.parallel import tensor
    real = {n: getattr(tensor, n) for n in ("all_to_all", "all_gather", "reduce_scatter",
                                            "all_reduce")}
    calls = {}

    def count(kind, group, t):
        if group.size > 1 and not t.is_meta:
            calls[kind, group.size] = calls.get((kind, group.size), 0) + 1

    def all_to_all(t, group, out_splits, in_splits):
        count("all_to_all", group, t)
        out = real["all_to_all"](t, group, out_splits, in_splits)
        if group.size > 1:
            start = 0
            for n in out_splits:
                out[start:start + n].copy_(t[:n])
                start += n
        return out

    def all_gather(t, group, dim):
        count("all_gather", group, t)
        out = real["all_gather"](t, group, dim)
        if group.size > 1:
            d = dim % t.dim()
            out.unflatten(d, (group.size, t.shape[d])).copy_(t.unsqueeze(d))
        return out

    def reduce_scatter(t, group, dim):
        count("reduce_scatter", group, t)
        out = real["reduce_scatter"](t, group, dim)
        if group.size > 1:
            n = out.shape[dim]
            out.copy_(t.narrow(dim, group.rank * n, n))
        return out

    def all_reduce(t, group, op="sum"):
        count("all_reduce", group, t)
        return real["all_reduce"](t, group, op)

    for n, f in (("all_to_all", all_to_all), ("all_gather", all_gather),
                 ("reduce_scatter", reduce_scatter), ("all_reduce", all_reduce)):
        setattr(tensor, n, f)
    try:
        yield calls
    finally:
        for n, f in real.items():
            setattr(tensor, n, f)


def tp_ssm_phase(card: str) -> dict:
    """One rank of zamba2-7b on the (1, 8) mesh under the fake group
    (module docstring): every Mamba2 cell on the rank's 14 heads. A train
    step (``tp_rank``) and a sharded serve (``tp_serve_phase``), each peak
    within ``TP_PEAK_TOL`` of the dry run's; the split mode launched in
    both. The all-to-alls are filled as the fake group fills them on the
    CPU (``filled_collectives``). Returns the launch counts: ``train`` and
    ``serve`` apart, and their sums."""
    with filled_collectives():
        return _tp_ssm(card)


def _tp_ssm(card: str) -> dict:
    from repro_torch.common.config import ShapeSpec
    from repro_torch.models.ssm import mamba_dims

    run = tp_ssm_run()
    heads = mamba_dims(run.model)[1]
    if heads % TP_MESH["model"]:
        fail(f"tp zamba2: {heads} heads do not split over model {TP_MESH['model']}")
    shape = ShapeSpec("train_tp_ssm_card", TP_SEQ, TP_BATCH, "train")
    r = tp_rank(run, shape, 1, arch=TP_SSM_ARCH)
    (launches,) = r["launches"]
    print(f"  zamba2-7b rank 0 of {TP_MESH} ({run.model.n_layers} Mamba2 layers and the shared "
          f"block, {heads // TP_MESH['model']} of {heads} heads a rank): {r['local'] / 1e9:.4f} B "
          f"of {r['whole'] / 1e9:.4f} B parameters held; step {r['seconds'][0]:.4f} s; "
          f"max_memory_allocated {r['peak'] / 2**30:.3f} GiB (the weights' draw "
          f"{r['draw_peak'] / 2**30:.3f} GiB, not held to the dry run) against the dry run's "
          f"{r['mem']['peak_bytes'] / 2**30:.3f} GiB ({r['miss']:+.2%}, "
          f"{'within' if abs(r['miss']) <= TP_PEAK_TOL else 'outside'} {TP_PEAK_TOL:.0%}); "
          f"launches {launches}; loss {r['losses'][0]}, grad norm {r['norms'][0]} (not a "
          f"model's: the fake group sums nothing); {card}", flush=True)
    if launches["rmsnorm_split"] == 0 or launches["rmsnorm"] == 0 \
            or not all(map(math.isfinite, r["losses"] + r["norms"])):
        fail(f"tp zamba2: launches {launches}, losses {r['losses']}, grad norms {r['norms']}")
    if abs(r["miss"]) > TP_PEAK_TOL:
        fail(f"tp zamba2: max_memory_allocated {r['peak'] / 2**30:.3f} GiB misses the dry "
             f"run's {r['mem']['peak_bytes'] / 2**30:.3f} GiB by {r['miss']:+.2%}")
    serve = tp_serve_phase(card, arch=TP_SSM_ARCH, run=run, steps=TP_SSM_STEPS, split=True)
    serve_counts = {k: v for k, v in serve.items() if k in launches}
    return dict({k: launches[k] + serve_counts[k] for k in launches},
                train=launches, serve=serve_counts, train_peak_bytes=r["peak"],
                train_draw_peak_bytes=r["draw_peak"],
                train_predicted_peak_bytes=r["mem"]["peak_bytes"],
                serve_peak_bytes=serve["peak_bytes"],
                serve_predicted_peak_bytes=serve["predicted_peak_bytes"])


TP_XLSTM_ARCH = "xlstm-125m"
TP_XLSTM_MESH = {"data": 1, "model": 16}   # the grid's model size: 4 ranks a head
TP_XLSTM_LAYERS = 4        # one unit: 3 mLSTM cells and an sLSTM cell


def tp_xlstm_run():
    """xlstm-125m at full width cut to one unit, one microbatch of batch 2 at
    seq 4096 (``[tp]``'s size)."""
    from repro_torch.configs import get_config
    run = get_config(TP_XLSTM_ARCH)
    return run.replace(model=dataclasses.replace(run.model, n_layers=TP_XLSTM_LAYERS),
                       parallel=dataclasses.replace(run.parallel, microbatches=1),
                       train=dataclasses.replace(run.train, seq_len=TP_SEQ,
                                                 global_batch=TP_BATCH))


def xlstm_dry_runs() -> dict:
    """The dry run's records of the xlstm-125m rank of ``tp_xlstm_phase``, its
    train step and its prefill (``train``, ``prefill``). Its sLSTM is traced
    a step at a time at two lengths (``dryrun.LENGTHS``), ~40-60 s of host
    time, so ``main`` runs this in a child process beside ``[fabric]`` and
    ``[drills]`` (no card time there is held to a bound) and waits for it
    before ``[campaigns]``; the child touches no card."""
    from repro_torch.common.config import ShapeSpec
    from repro_torch.launch import dryrun as dr
    run, recs = tp_xlstm_run(), {}
    with tempfile.TemporaryDirectory() as out:
        for shape in (ShapeSpec("train_tp_xlstm_card", TP_SEQ, TP_BATCH, "train"),
                      ShapeSpec("prefill_tp_card", PROMPT, B, "prefill")):
            recs[shape.kind] = dr.run_cell(TP_XLSTM_ARCH, shape.name, False, False, out,
                                           mesh=(mesh_name(TP_XLSTM_MESH), TP_XLSTM_MESH),
                                           run=run, shape=shape)
    return recs


def tp_xlstm_phase(card: str, recs=None) -> dict:
    """One rank of xlstm-125m on a (data 1, model 16) mesh under the fake
    group (module docstring): its 4 heads do not divide 16, so every cell
    computes a quarter of one head (``models/ssm.py``), its scores, q and k
    and sLSTM's hidden state summed or gathered over the head's 4 ranks. A
    train step (``tp_rank``) and a sharded serve (``tp_serve_phase``), each
    peak within ``TP_PEAK_TOL`` of the dry run's, the grad norm finite, the
    split mode launched in both and the head groups' collectives issued
    (``filled_collectives``, which also fills the fake group's all-gathers
    and reduce-scatters). ``recs``: ``xlstm_dry_runs``' records, made
    already. Returns the launch counts as ``tp_ssm_phase``."""
    with filled_collectives() as calls:
        return _tp_xlstm(card, calls, recs or {})


def _tp_xlstm(card: str, calls: dict, recs: dict) -> dict:
    from repro_torch.common.config import ShapeSpec
    from repro_torch.launch import dryrun as dr

    run = tp_xlstm_run()
    heads, m = run.model.n_heads, TP_XLSTM_MESH["model"]
    g = m // heads
    shape = ShapeSpec("train_tp_xlstm_card", TP_SEQ, TP_BATCH, "train")
    calls.clear()
    r = tp_rank(run, shape, 1, arch=TP_XLSTM_ARCH, mesh_sizes=TP_XLSTM_MESH,
                rec=recs.get("train"))
    train_calls = {k: v for k, v in calls.items() if k[1] == g}
    (launches,) = r["launches"]
    print(f"  xlstm-125m rank 0 of {TP_XLSTM_MESH} ({run.model.n_layers} layers: 3 mLSTM cells "
          f"and an sLSTM cell, a quarter of one of {heads} heads a rank, g {r['parts']}): "
          f"{r['local'] / 1e9:.4f} B of {r['whole'] / 1e9:.4f} B parameters held; step "
          f"{r['seconds'][0]:.4f} s; max_memory_allocated {r['peak'] / 2**30:.3f} GiB (the "
          f"weights' draw {r['draw_peak'] / 2**30:.3f} GiB, not held to the dry run) against "
          f"the dry run's {r['mem']['peak_bytes'] / 2**30:.3f} GiB ({r['miss']:+.2%}, "
          f"{'within' if abs(r['miss']) <= TP_PEAK_TOL else 'outside'} {TP_PEAK_TOL:.0%}); "
          f"launches {launches} (split mode {launches['rmsnorm_split']}); head-group "
          f"collectives {train_calls}; loss {r['losses'][0]}, grad norm {r['norms'][0]} (not a "
          f"model's: the fake group sums nothing); {card}", flush=True)
    if r["parts"] != [g] * TP_XLSTM_LAYERS or not train_calls:
        fail(f"tp xlstm: cells on head parts {r['parts']}, head-group collectives {train_calls}")
    if launches["rmsnorm_split"] == 0 or not all(map(math.isfinite, r["losses"] + r["norms"])):
        fail(f"tp xlstm: launches {launches}, losses {r['losses']}, grad norms {r['norms']}")
    if abs(r["miss"]) > TP_PEAK_TOL:
        fail(f"tp xlstm: max_memory_allocated {r['peak'] / 2**30:.3f} GiB misses the dry "
             f"run's {r['mem']['peak_bytes'] / 2**30:.3f} GiB by {r['miss']:+.2%}")
    calls.clear()
    # the rank the dry run traces for a serve step: the last, which holds the
    # decoded position (rank 0 holds xi's columns of up and sends each to
    # every rank: a send buffer 16 times the last rank's)
    prefill = ShapeSpec("prefill_tp_card", PROMPT, B, "prefill")
    serve = tp_serve_phase(card, arch=TP_XLSTM_ARCH, run=run, steps=TP_SSM_STEPS, split=True,
                           mesh_sizes=TP_XLSTM_MESH, rec=recs.get("prefill"),
                           rank=dr.traced_rank(run, prefill, TP_XLSTM_MESH)[0])
    serve_calls = {k: v for k, v in calls.items() if k[1] == g}
    print(f"  xlstm-125m serve: split mode {serve['rmsnorm_split']}, head-group collectives "
          f"{serve_calls}", flush=True)
    if not serve_calls:
        fail(f"tp xlstm serve: no collective over a head's {g} ranks")
    serve_counts = {k: v for k, v in serve.items() if k in launches}
    return dict({k: launches[k] + serve_counts[k] for k in launches},
                train=launches, serve=serve_counts, train_peak_bytes=r["peak"],
                train_draw_peak_bytes=r["draw_peak"],
                train_predicted_peak_bytes=r["mem"]["peak_bytes"], train_s=r["seconds"][0],
                serve_peak_bytes=serve["peak_bytes"],
                serve_predicted_peak_bytes=serve["predicted_peak_bytes"],
                head_collectives={"train": {f"{k}/{n}": v for (k, n), v in train_calls.items()},
                                  "serve": {f"{k}/{n}": v for (k, n), v in serve_calls.items()}})


def fault_check(trainer, report, per_ingest, spent, det_counts, ckpt_bytes) -> None:
    """The fault of ``[train]``: one restart from step 0, the detection
    record equal to the port's NumPy master's on the same windows, the
    isolated node out of the active set, every ingest through the detection
    kernels on the card, and the replayed steps' losses bit-equal to the
    first pass's."""
    if report.restarts != 1 or len(report.detections) != 1:
        fail(f"train fault: {report.restarts} restarts, {len(report.detections)} detections")
    det = report.detections[0]
    verdicts, isolated, windows, active = numpy_fault_replay(
        FAULT_KIND, FAULT_RANK, trainer.run.train.seed, SIM_NODES, FAULT_STEP)
    got = (det["verdicts"], [tuple(p) for p in det["isolated"]], det["detection_windows"])
    if got != (verdicts, isolated, windows) or trainer.cluster.active_nodes != active:
        fail(f"train fault: detection {got}, active {trainer.cluster.active_nodes}; the NumPy "
             f"master gives {(verdicts, isolated, windows)}, active {active}")
    if det["restored_step"] != 0 or report.steps_run != TRAIN_STEPS + FAULT_STEP:
        fail(f"train fault: restored step {det['restored_step']}, {report.steps_run} steps run")
    out_node = isolated[0][0] if isolated else None
    if out_node is None or out_node in trainer.cluster.active_nodes:
        fail(f"train fault: node {out_node} still active: {trainer.cluster.active_nodes}")
    short = [c for c in per_ingest if c["window_score"] != 1]
    if len(per_ingest) != windows or short or det_counts["window_score"] != windows:
        fail(f"train fault: {len(per_ingest)} ingests for {windows} windows, launches "
             f"{per_ingest}, in all {det_counts}")
    first, replay = report.losses[:FAULT_STEP], report.losses[FAULT_STEP:2 * FAULT_STEP]
    if replay != first:
        fail(f"train fault: replayed losses {replay} differ from the first pass's {first}")
    detect_s = sum(c["s"] for c in per_ingest)
    steer_s, restore_s = sum(spent["steer"]), sum(spent["restore"])
    replay_s = trainer.monitor.durations[FAULT_STEP]
    print(f"  train fault {FAULT_KIND} rank {FAULT_RANK} at step {FAULT_STEP} ({SIM_NODES * 8} "
          f"ranks): verdicts {det['verdicts']} after {windows} window(s), isolated "
          f"{det['isolated']} = the NumPy master's; restored step {det['restored_step']}; "
          f"handler {det['wall_s']:.4f} s = detection {detect_s:.4f} + steering {steer_s:.6f} "
          f"+ restore from memory {restore_s:.4f} ({ckpt_bytes / 1e9:.3f} GB) + rest "
          f"{det['wall_s'] - detect_s - steer_s - restore_s:.4f}; first replayed step "
          f"{replay_s:.4f} s; launches a window "
          f"{[{k: c[k] for k in DRILL_KERNELS} for c in per_ingest]}; replayed losses "
          "bit-equal to the first pass's", flush=True)


def fault_free_check(trainer, report) -> None:
    """A fault-free run of the same TRAIN_STEPS steps from the step-0 replica
    (equal to a fresh init, checked above), through the Trainer's own step:
    its losses and final parameters must be bit-equal to the fault run's."""
    import torch
    t0 = time.perf_counter()
    final = {n: p.detach().to("cpu", copy=True) for n, p in trainer.params.items()}
    trainer.restore(0)
    losses = []
    for s in range(TRAIN_STEPS):
        batch = {k: torch.from_numpy(v).to(trainer.device)
                 for k, v in trainer.pipeline.batch(s).items()}
        trainer.params, trainer.opt_state, metrics = trainer._step_fn(
            trainer.params, trainer.opt_state, batch)
        losses.append(float(metrics["loss"]))
    want = report.losses[:FAULT_STEP] + report.losses[2 * FAULT_STEP:]
    bad = [n for n, p in trainer.params.items() if not _bit_equal(p.detach().cpu(), final[n])]
    print(f"  train fault-free run of {TRAIN_STEPS} steps from the step-0 replica in "
          f"{time.perf_counter() - t0:.2f} s: losses {losses}; final parameters bit-equal to "
          f"the fault run's: {not bad}", flush=True)
    if losses != want or bad:
        fail(f"train: the fault-free run differs from the fault run: losses {losses} against "
             f"{want}; parameters {bad[:5]}")


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


# --- [fabric]: C4P's water-filling, the EWMA scan and the reference path ------

WATERFILL_KERNELS = ("waterfill_smem_kernel", "waterfill_grid_kernel")
EWMA_KERNELS = ("ewma_pool_kernel", "ewma_pool_l2_kernel", "ewma_step_kernel")
FABRIC_RANDOM = 40
CROSSOVER_HOSTS = (8, 16, 32, 64, 128, 256, 512, 1024, 1280)     # 128 .. 20,480 flows
EWMA_WINDOWS, EWMA_CELLS, EWMA_TOL = 64, 16384, 1e-9
EWMA_L2_CELLS = 60000                              # 240 KB a CTA of two: above shared memory
FLOW_FIELDS = ("flow_rate", "conn_rate", "link_util", "link_touched", "flow_alive")


def random_fabric(rng, fail_links: bool):
    """A copy of tests/test_netsim_perf.py's ``_random_scenario`` over the
    port's types (this script imports neither the tests nor the JAX package)."""
    from repro_torch.core.netsim import Flow
    from repro_torch.core.topology import ClosTopology
    topo = ClosTopology(
        n_hosts=int(rng.integers(4, 33)), nics_per_host=int(rng.choice([2, 4, 8])),
        n_leaf_pairs=int(rng.choice([2, 4])), n_spines=int(rng.choice([2, 4, 8])),
        n_host_groups=int(rng.choice([1, 2])),
        oversubscription=float(rng.choice([1.0, 1.5, 2.0])))
    n = int(rng.integers(2, 60))
    flows = []
    for fid in range(n):
        src = int(rng.integers(0, topo.n_hosts))
        dst = int(rng.integers(0, topo.n_hosts))
        if dst == src:
            dst = (src + 1) % topo.n_hosts
        nic = int(rng.integers(0, topo.nics_per_host))
        port = int(rng.integers(0, 2))
        spine = int(rng.integers(0, topo.n_spines))
        same_leaf = topo.leaf_of(src, nic, port) == topo.leaf_of(dst, nic, port)
        s = (spine if rng.random() < 0.3 else None) if same_leaf else spine
        links = topo.path_links(src, dst, nic, port, port, s)
        flows.append(Flow(fid, 0, ("c", fid % max(1, n // 3)), links,
                          weight=float(rng.uniform(0.05, 2.0))))
    if fail_links and rng.random() < 0.7:
        for _ in range(int(rng.integers(1, 4))):
            victim = flows[int(rng.integers(0, n))]
            topo.fail_link(victim.links[int(rng.integers(0, len(victim.links)))])
    return topo, flows


def wf_inputs(fs, jitter: float = 0.0, seed: int = 0):
    """The kernel's inputs for one ``max_min`` call on the card: (the
    incidence by link, floored weights, aliveness, capacity after the
    jitter draw ``max_min`` makes) and the incidence by flow."""
    from repro_torch.scenarios.c4p_fabrics import waterfill_inputs
    return waterfill_inputs(fs, DEV, jitter, seed)


def wf_variants(fs):
    """The kernel's variants that hold this fabric: ``smem`` only where its
    state fits in one CTA's shared memory."""
    from repro_torch.kernels import waterfill as wf
    fits = wf.pick_variant(fs.n_flows, fs.n_links, fs.pair_flow.size) == "smem"
    return [v for v in wf.VARIANTS if v != "smem" or fits]


def faulty_waterfill(link_ptr, link_flow, w, alive, cap, fault: str):
    """Planted faults: ``waterfill_ref`` written wrongly in one place.
    "lowest tie": only the tied link with the lowest index freezes in a
    round; "reverse": a link's sums taken in reverse pair order; "no clamp":
    remaining capacity not clamped at 0; "refreeze": flows frozen in an
    earlier round frozen again on a tied link. Returns (rate, remaining,
    rounds)."""
    import torch
    from repro_torch.kernels import waterfill as wf
    inverse, n, pos = wf.link_columns(link_ptr)
    pair_link = wf.pair_links(link_ptr)

    def sums(per_pair):
        vals = per_pair.index_select(1, pos)
        acc = per_pair.new_zeros(per_pair.shape[0], inverse.shape[0])
        starts = [sum(n[:j]) for j in range(len(n))]
        order = range(len(n) - 1, -1, -1) if fault == "reverse" else range(len(n))
        for j in order:
            acc[:, :n[j]] += vals[:, starts[j]:starts[j] + n[j]]
        return acc.index_select(1, inverse)

    f, dev = w.shape[0], w.device
    pair_w = w[link_flow]
    unfrozen, rate, remaining = alive.clone(), torch.zeros_like(w), cap.clone()
    inf = torch.full_like(remaining, float("inf"))
    rounds = 0
    while bool(unfrozen.any()):
        load = sums(torch.where(unfrozen[link_flow], pair_w, 0.0)[None])[0]
        share = torch.where(load > 0.0, remaining / load, inf)
        m = share.min()
        if not bool(torch.isfinite(m)):
            break
        tied = share == m
        if fault == "lowest tie":
            first = int(torch.nonzero(tied)[0])
            tied = torch.zeros_like(tied)
            tied[first] = True
        sel = tied[pair_link] & (alive if fault == "refreeze" else unfrozen)[link_flow]
        newly = torch.zeros(f, dtype=torch.bool, device=dev)
        newly[link_flow[sel]] = True
        rate = torch.where(newly, m * w, rate)
        unfrozen &= ~newly
        dec = sums(torch.where(newly[link_flow], rate[link_flow], 0.0)[None])[0]
        remaining = remaining - dec
        if fault != "no clamp":
            remaining = torch.clamp_min(remaining, 0.0)
        rounds += 1
    return rate, remaining, torch.tensor([rounds], device=dev)


WF_FAULTS = ("lowest tie", "reverse", "no clamp", "refreeze")


def _differ(a, b) -> int:
    import torch
    if a.is_floating_point():
        a, b = a.view(torch.int64), b.view(torch.int64)
    return int((a != b.to(a.device)).sum())


def waterfill_parity():
    """FlowSet.max_min at torch on the card against the NumPy loop, the raw
    kernel (both variants) against the plain version, and the planted
    faults, on 40 random fabrics, the Fig. 2 fabric with and without jitter
    and the 10,240-GPU fabric. Returns (the fabrics by label, rounds)."""
    import numpy as np
    import torch
    from repro_torch.core.flowset import FlowSet
    from repro_torch.kernels import waterfill as wf
    from repro_torch.scenarios.c4p_fabrics import BIG_HOSTS, FIG2_HOSTS, clos_fabric

    rng = np.random.default_rng(5)
    cases = []
    for i in range(FABRIC_RANDOM):
        topo, flows = random_fabric(rng, fail_links=bool(i % 2))
        cases.append((f"random {i}", FlowSet(topo, flows), 0.0, i))
    fig2, big = clos_fabric(FIG2_HOSTS), clos_fabric(BIG_HOSTS)
    cases += [("fig2", fig2, 0.0, 3), ("fig2 jitter 0.05", fig2, 0.05, 3),
              ("10240 GPUs", big, 0.0, 0)]
    diffs = dict.fromkeys(WF_FAULTS, 0)
    err = 0.0
    rounds = {}
    held = dict.fromkeys(wf.VARIANTS, 0)
    for label, fs, jitter, seed in cases:
        want = fs.max_min(backend="numpy", cnp_jitter=jitter, seed=seed)
        got = fs.max_min(backend="torch", device=DEV, cnp_jitter=jitter, seed=seed)
        bad = [k for k in FLOW_FIELDS if not _bit_equal(
            *(torch.from_numpy(getattr(r, k)) for r in (got, want)))]
        if bad:
            fail(f"waterfill on {label}: the card's {bad} differ from the NumPy loop's")
        args, by_flow = wf_inputs(fs, jitter, seed)
        plain = wf.waterfill_ref(*args)
        for variant in wf_variants(fs):
            kern = wf.waterfill(*args, flow_csr=by_flow, variant=variant)
            if any(_differ(k, p) for k, p in zip(kern, plain)):
                fail(f"waterfill ({variant}) on {label}: differs from its plain version")
            err = max(err, *((k - p).abs().max().item() for k, p in zip(kern[:2], plain[:2])))
            held[variant] += 1
        for fault in diffs:
            wrong = faulty_waterfill(*args, fault)
            diffs[fault] += _differ(kern[0], wrong[0]) + _differ(kern[1], wrong[1])
        if not label.startswith("random"):
            rounds[label] = int(plain[2][0])
            print(f"  waterfill {label}: {fs.n_flows:,} flows, {fs.n_links:,} links, "
                  f"{fs.pair_flow.size:,} pairs, {rounds[label]} rounds: FlowSet.max_min at torch "
                  "on the card bit-equal to the NumPy loop (rates, connection rates, link "
                  f"utilisation); kernel variants {wf_variants(fs)} bit-equal to the plain "
                  f"version (default {wf.pick_variant(fs.n_flows, fs.n_links, fs.pair_flow.size)})",
                  flush=True)
    print(f"  waterfill on {FABRIC_RANDOM} random fabrics (links failed in the odd ones): "
          "bit-equal, card to NumPy and kernel to plain; fabrics held bit-equal by variant: "
          f"{held}", flush=True)
    if held["grid"] != len(cases) or held["smem"] < len(cases) - 1:
        fail(f"waterfill: variants held on {held} of {len(cases)} fabrics")
    # freezing tied links one at a time reaches the same fixed point, so
    # "lowest tie" differs only where the later rounds round otherwise (the
    # 10,240-GPU fabric); "refreeze" is the fault of the freeze step that
    # every fabric shows
    for fault in WF_FAULTS:
        print(f"    planted fault, {fault}: {diffs[fault]} rate or remaining values differ "
              "from the kernel's", flush=True)
        if diffs[fault] == 0:
            fail(f"waterfill: the planted fault '{fault}' reads equal to the kernel")
    return {"fig2": fig2, "10240": big}, rounds, err


def waterfill_bytes(fs) -> int:
    """The bytes one water-fill needs once: the incidence by link (L + 1
    offsets, P flows, int64), weights and capacities (float64) and
    aliveness (bool) read; rates and remaining capacities (float64)
    written."""
    f, l, p = fs.n_flows, fs.n_links, fs.pair_flow.size
    return 8 * (l + 1) + 8 * p + 8 * f + f + 8 * l + 8 * (f + l)


_EARLIER = {}


def earlier_waterfill(args, by_flow):
    """The first design's kernel (csrc/earlier/waterfill.cu, built once by
    kernels/ablate_waterfill.py) on these inputs: a function variant ->
    (rate, remaining, rounds), variant "cta" or "grid"."""
    from repro_torch.kernels import ablate_waterfill
    if "so" not in _EARLIER:
        _EARLIER["so"] = ablate_waterfill.build(["first_design"])["first_design"]
    return ablate_waterfill.caller(_EARLIER["so"], "first_design", args, by_flow)


def consistent(dev, events_ms):
    """A device time the profiler gave, unless it exceeds the CUDA events'
    time of the same calls (one launch a call, on one stream): then some of
    the window's records were lost (whole windows of long calls drop at
    times) and the time reads "not measured"."""
    if dev is not None and dev > 1.02 * events_ms:
        print(f"    device time {dev:.5f} ms above the events' {events_ms:.5f} ms: profiler "
              "records lost, not measured", flush=True)
        return None
    return dev


def waterfill_times(label, fs, rounds, iters):
    """One water-fill's times on the card: each variant's event and device
    ms and the barriers of its rounds alone, the first design's device ms
    (both its variants, bit-equal first), the plain version's ms on the
    card, NumPy's wall ms for the same call, and the bound: the larger of
    the bytes the work needs once over the card's rate and the default
    variant's barriers alone. Returns a row for the JSON line."""
    from repro_torch.kernels import waterfill as wf

    args, by_flow = wf_inputs(fs)
    f, l, p = fs.n_flows, fs.n_links, fs.pair_flow.size
    nbytes = waterfill_bytes(fs)
    bytes_ms, _ = bound(0.0, nbytes, "float32")
    default = wf.pick_variant(f, l, p)
    row = {"flows": f, "links": l, "pairs": p, "rounds": rounds, "bytes": nbytes,
           "bytes_ms": bytes_ms, "variant": default}
    for v in wf_variants(fs):
        run = lambda: wf.waterfill(*args, flow_csr=by_flow, variant=v)      # noqa: E731
        row[f"{v}_ms"] = time_ms(run, iters)
        row[f"{v}_device_ms"] = consistent(device_ms(run, iters, WATERFILL_KERNELS),
                                           row[f"{v}_ms"])
        probe = lambda: wf.sync_probe(l, rounds, v, DEV)                     # noqa: E731
        row[f"{v}_sync_floor_ms"] = time_ms(probe, iters)
    plain = wf.waterfill_ref(*args)
    old = earlier_waterfill(args, by_flow)
    for v in ("cta", "grid"):
        if any(_differ(k, w) for k, w in zip(old(v), plain)):
            fail(f"the first design ({v}) on {label}: differs from the plain version")
        row[f"earlier_{v}_device_ms"] = consistent(device_ms(lambda: old(v), iters),
                                                   time_ms(lambda: old(v), iters))
    # bound_ms: the bytes the work needs once (its operations, a few a pair
    # a round, take less); floor_ms: the larger of that and the rounds'
    # dependency floor, the default variant's barriers alone
    row.update(ms=row[f"{default}_ms"], device_ms=row[f"{default}_device_ms"],
               sync_floor_ms=row[f"{default}_sync_floor_ms"], bound_ms=bytes_ms,
               bound_by="bytes")
    row["floor_ms"] = max(bytes_ms, row["sync_floor_ms"])
    row["floor_by"] = "bytes" if bytes_ms >= row["sync_floor_ms"] else "the rounds' barriers"
    row["plain_ms"] = time_ms(lambda: wf.waterfill_ref(*args), 2)
    row["numpy_ms"] = _wall_ms(lambda: fs.max_min(backend="numpy"))
    row["card_call_ms"] = _wall_ms(lambda: fs.max_min(backend="torch", device=DEV))
    print(f"  time waterfill {label} ({f:,} flows, {l:,} links, {rounds} rounds): "
          + " ".join(f"{v}_ms={_ms(row[f'{v}_ms'])} {v}_device_ms={_ms(row[f'{v}_device_ms'])} "
                     f"{v}_sync_floor_ms={_ms(row[f'{v}_sync_floor_ms'])}"
                     for v in wf_variants(fs))
          + f"; first design (csrc/earlier) device_ms cta={_ms(row['earlier_cta_device_ms'])} "
          f"grid={_ms(row['earlier_grid_device_ms'])}; plain_ms={row['plain_ms']:.5f} "
          f"numpy_ms={row['numpy_ms']:.5f} card_call_ms={row['card_call_ms']:.5f} "
          f"(FlowSet.max_min, copies and epilogue included); bound_ms={bytes_ms:.6f} (bytes "
          f"once, {nbytes:,} B); floor_ms={row['floor_ms']:.6f} = max(bound_ms, {rounds} "
          f"rounds of the {default} variant's barriers alone {row['sync_floor_ms']:.6f}): "
          f"{row['floor_by']} bind; default variant {default}, bound/device="
          f"{_share(bytes_ms, row['device_ms'])} floor/device="
          f"{_share(row['floor_ms'], row['device_ms'])}", flush=True)
    return row


def _from_here(sizes, wins):
    """The smallest size from which ``wins`` holds at every larger size."""
    ok = [n for i, n in enumerate(sizes) if all(wins[i:])]
    return ok[0] if ok else None


def waterfill_crossover():
    """FlowSet.max_min at numpy against torch on the card, whole calls, on
    the Fig. 2 scenario from 8 to 1,280 hosts (128 to 20,480 flows): the
    smallest size from which the card wins at every larger size sets
    AUTO_WATERFILL_FLOWS. Beside it, the kernel's variants by events (the
    grid alone where the state does not fit in shared memory)."""
    from repro_torch.core import torchsim
    from repro_torch.kernels import waterfill as wf
    from repro_torch.scenarios.c4p_fabrics import clos_fabric
    flows, wins = [], []
    for hosts in CROSSOVER_HOSTS:
        fs = clos_fabric(hosts)
        np_ms = _wall_ms(lambda: fs.max_min(backend="numpy"))
        card_ms = _wall_ms(lambda: fs.max_min(backend="torch", device=DEV))
        args, by_flow = wf_inputs(fs)
        ms = {v: time_ms(lambda: wf.waterfill(*args, flow_csr=by_flow, variant=v), ITERS)
              for v in wf_variants(fs)}
        flows.append(fs.n_flows)
        wins.append(card_ms < np_ms)
        print(f"  crossover waterfill {fs.n_flows} flows ({fs.n_links} links): numpy_ms="
              f"{np_ms:.4f} torch_ms={card_ms:.4f} faster={'torch' if card_ms < np_ms else 'numpy'} "
              f"auto={torchsim.effective_backend('auto', flows=fs.n_flows)}; kernel "
              + " ".join(f"{v}_ms={t:.5f}" for v, t in ms.items())
              + f" default {wf.pick_variant(fs.n_flows, fs.n_links, fs.pair_flow.size)}",
              flush=True)
    print(f"  crossover waterfill: the card wins from {_from_here(flows, wins)} flows up "
          f"(AUTO_WATERFILL_FLOWS = {torchsim.AUTO_WATERFILL_FLOWS})", flush=True)


def c4p_main_path():
    """The main path: C4P on the card at the Fig. 2 fabric's width
    (``FabricState`` in C4P mode, 2 QPs a port): a 64-host ring job and 8
    two-host tenants, evaluated with the dynamic load balancer (CNP jitter
    0.05) and without, a leaf-spine link failed and re-probed, one more job,
    evaluated again. Every result equal to the same run at numpy, bit for
    bit; one waterfill launch per FlowSet.max_min call. Returns (launches,
    the balancer's FlowSet after its last call, that call's rounds)."""
    from repro_torch.core.flowset import FlowSet
    from repro_torch.kernels import waterfill as wf
    from repro_torch.scenarios.c4p_fabrics import balancer_flowset, run_main_path

    def drive(backend):
        calls = []
        real = FlowSet.max_min

        def counted(self, *a, **kw):
            calls.append(self)
            return real(self, *a, **kw)

        FlowSet.max_min = counted
        try:
            t0 = time.perf_counter()
            out, busbw = run_main_path(backend, DEV)
            return out, busbw, len(calls), time.perf_counter() - t0
        finally:
            FlowSet.max_min = real

    def key(res):
        return [[(k, float(v).hex()) for k, v in d.items()]
                for d in (res.flow_rate, res.conn_rate, res.link_util)]

    wf.launches = 0
    card, card_bw, card_calls, card_s = drive("torch")
    launches = wf.launches
    ref, ref_bw, ref_calls, ref_s = drive("numpy")
    if [key(r) for r in card] != [key(r) for r in ref] or card_bw != ref_bw:
        fail("C4P on the card: rates differ from the NumPy run's")
    if launches != card_calls or card_calls != ref_calls or launches == 0:
        fail(f"C4P on the card: {launches} waterfill launches for {card_calls} FlowSet.max_min "
             f"calls ({ref_calls} at numpy)")
    print(f"  main path: C4P at the Fig. 2 fabric (64-host job + 9 tenants, 2 QPs a port, "
          f"dynamic LB, a leaf-spine failure): torch_s={card_s:.4f} numpy_s={ref_s:.4f}; "
          f"{card_calls} FlowSet.max_min calls, {launches} waterfill launches; flow, "
          f"connection and link rates and busbw bit-equal to NumPy "
          f"({sum(len(r.flow_rate) for r in card)} flow rates)", flush=True)
    # the balancer's last call, timed at the main path's shape
    fs = balancer_flowset(DEV)
    args, by_flow = wf_inputs(fs)
    rounds = int(wf.waterfill(*args, flow_csr=by_flow)[2][0])
    return launches, fs, rounds


def ewma_faulty(values, mean0, dev0, count0, alpha, clip, fault: str):
    """Planted faults of the scan: ``ewma_scan_ref`` written wrongly in one
    place. "NaN in the pool": the window's median taken with its NaNs kept
    (sorted last, as torch.sort puts them); "seed over all cells": the seed
    deviation averaged over every cell of the window, NaN ones too."""
    import torch
    from repro_torch.kernels.detect_ref import MEANAD_TO_SIGMA
    mean, dev, count = mean0.clone(), dev0.clone(), count0.clone()
    for vals in values:
        finite = torch.isfinite(vals)
        nf = int(finite.sum())
        if nf == 0:
            continue
        s, c = ((torch.sort(vals).values, vals.numel()) if fault == "NaN in the pool"
                else (torch.sort(vals[finite]).values, nf))
        med = 0.5 * (s[(c - 1) // 2] + s[c // 2])
        fin = vals[finite]
        seed_dev = torch.abs(fin - med).sum() / (vals.numel() if fault == "seed over all cells"
                                                 else nf)
        first, rest = finite & (count == 0), finite & (count > 0)
        lim = clip * (MEANAD_TO_SIGMA * dev + 1e-12 * torch.clamp_min(torch.abs(mean), 1e-12)
                      + 1e-30)
        delta = torch.minimum(torch.maximum(torch.where(rest, vals, mean) - mean, -lim), lim)
        dev = torch.where(first, seed_dev, torch.where(
            rest, (1.0 - alpha) * dev + alpha * torch.abs(delta), dev))
        mean = torch.where(first, vals, torch.where(rest, mean + alpha * delta, mean))
        count = count + finite.to(count.dtype)
    return mean, dev, count


def ewma_phase(iters):
    """The scan at bench_jaxsim.py's full size against its plain version
    (within 1e-9, count equal), against AdaptiveBaseline.update on a
    10-window stream, planted faults, and its times. Returns (launches of
    its entry, max abs err, row)."""
    import numpy as np
    import torch
    from repro_torch.core.c4d.baseline import AdaptiveBaseline
    from repro_torch.core.torchsim import kernels as tk
    from repro_torch.kernels import detect_ref
    from repro_torch.kernels import ewma_scan as ew

    def close(got, want):
        (gm, gd, gc), (wm, wd, wc) = [[x.cpu() for x in t] for t in (got, want)]
        ok = torch.equal(gc, wc) and torch.allclose(gm, wm, rtol=EWMA_TOL, atol=EWMA_TOL) \
            and torch.allclose(gd, wd, rtol=EWMA_TOL, atol=EWMA_TOL)
        return ok, max((gm - wm).abs().max().item(), (gd - wd).abs().max().item())

    rng = np.random.default_rng(0)
    values = rng.normal(10.0, 1.0, size=(EWMA_WINDOWS, EWMA_CELLS))
    values[rng.random(values.shape) < 0.1] = np.nan
    base = AdaptiveBaseline(n_ranks=2)
    alpha, clip = base.alpha, base.clip_sigma
    v = torch.from_numpy(values).to(DEV)
    zeros = torch.zeros(EWMA_CELLS, dtype=torch.float64, device=DEV)
    count0 = torch.zeros(EWMA_CELLS, dtype=torch.int64, device=DEV)
    ew.launches = 0
    got = tk.ewma_scan(values, np.zeros(EWMA_CELLS), np.zeros(EWMA_CELLS),
                       np.zeros(EWMA_CELLS, np.int64), alpha, clip, device=DEV)
    launches = ew.launches
    want = detect_ref.ewma_scan_ref(v, zeros, zeros, count0, alpha, clip)
    default = ew.path_for(EWMA_CELLS, v.device)
    ok, err = close(got, want)
    print(f"  ewma_scan {EWMA_WINDOWS} windows x {EWMA_CELLS} cells (10 % NaN), {default} path "
          f"(by size): within {EWMA_TOL:g} of the plain version, count equal: "
          f"{'yes' if ok else 'NO'} (max_abs_err={err:.3e}); launches of the entry {launches}",
          flush=True)
    if not ok or launches != 1:
        fail("ewma_scan: the kernel disagrees with its plain version")
    if default != "smem":
        fail(f"ewma_scan: the {default} path at {EWMA_CELLS} cells, not the shared-memory path")
    # the L2 path: by size above shared memory, through the wrapper, and at
    # the bench shape through the ablation's caller, which names the path
    from repro_torch.kernels import ablate_ewma
    libs = ablate_ewma.build(["l2_path", "first_design"])
    l2 = ablate_ewma.caller(libs["l2_path"], "l2_path", (v, zeros, zeros, count0, alpha, clip))
    big = rng.normal(10.0, 1.0, size=(2, EWMA_L2_CELLS))
    big[rng.random(big.shape) < 0.1] = np.nan
    vb = torch.from_numpy(big).to(DEV)
    zb = torch.zeros(EWMA_L2_CELLS, dtype=torch.float64, device=DEV)
    cb = torch.zeros(EWMA_L2_CELLS, dtype=torch.int64, device=DEV)
    for label, run_l2, ref_l2, path in (
            (f"{EWMA_WINDOWS} x {EWMA_CELLS}, named", l2, want, "l2"),
            (f"2 x {EWMA_L2_CELLS:,}, by size", lambda: ew.ewma_scan(vb, zb, zb, cb, alpha, clip),
             detect_ref.ewma_scan_ref(vb, zb, zb, cb, alpha, clip),
             ew.path_for(EWMA_L2_CELLS, v.device))):
        ok, perr = close(run_l2(), ref_l2)
        print(f"  ewma_scan, the {path} path at {label}: within {EWMA_TOL:g} of the plain "
              f"version, count equal: {'yes' if ok else 'NO'} (max_abs_err={perr:.3e})",
              flush=True)
        if not ok or path != "l2":
            fail(f"ewma_scan ({path} path, {label}): the kernel disagrees with its plain version")
        err = max(err, perr)
    for fault in ("NaN in the pool", "seed over all cells"):
        wrong = ewma_faulty(v, zeros, zeros, count0, alpha, clip, fault)
        bad, ferr = close(got, wrong)
        print(f"    planted fault, {fault}: max_abs_err={ferr:.3e}", flush=True)
        if bad:
            fail(f"ewma_scan: the planted fault '{fault}' reads within {EWMA_TOL:g}")
    print("    planted fault, a median by the lower middle (not a gate): the seed deviation is "
          "the mean |x - c|, flat for c between the two middles, so it moves by rounding "
          "only; 'NaN in the pool' takes its place", flush=True)
    n = 6
    srng = np.random.default_rng(2)
    ours = AdaptiveBaseline(n_ranks=n)
    stream = []
    for _ in range(10):
        m = srng.normal(10.0, 1.0, size=(n, n))
        m[srng.random((n, n)) < 0.2] = np.nan
        stream.append(m.ravel())
        ours.update("delay", m)
    got_s = tk.ewma_scan(np.stack(stream), np.zeros(n * n), np.zeros(n * n),
                         np.zeros(n * n, np.int64), ours.alpha, ours.clip_sigma, device=DEV)
    ok, serr = close(got_s, [torch.from_numpy(ours._mean["delay"].ravel()),
                             torch.from_numpy(ours._dev["delay"].ravel()),
                             torch.from_numpy(ours._count["delay"].ravel())])
    print(f"  ewma_scan on a 10-window stream of a 6 x 6 matrix: within {EWMA_TOL:g} of "
          f"AdaptiveBaseline.update, count equal: {'yes' if ok else 'NO'} "
          f"(max_abs_err={serr:.3e})", flush=True)
    if not ok:
        fail("ewma_scan differs from AdaptiveBaseline.update")
    nbytes = _nbytes(v, zeros, zeros, count0) + 3 * 8 * EWMA_CELLS
    b_ms, b_by = bound(0.0, nbytes, "float32")
    row = {"path": default, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
           "library_device_ms": None}
    for path, run in (("smem", lambda: ew.ewma_scan(v, zeros, zeros, count0, alpha, clip)),
                      ("l2", l2)):
        split = {}
        row[f"{path}_ms"] = time_ms(run, iters)
        row[f"{path}_device_ms"] = device_ms(run, iters, EWMA_KERNELS, split)
        row[f"{path}_by_kernel"] = split
    old = ablate_ewma.caller(libs["first_design"], "first_design",
                             (v, zeros, zeros, count0, alpha, clip))
    ok, _ = close(old(), want)
    if not ok:
        fail("ewma_scan, the first design: outside the tolerance of the plain version")
    split = {}
    row["earlier_device_ms"] = device_ms(old, iters, EWMA_KERNELS, split)
    row["earlier_by_kernel"] = split
    row.update(ms=row[f"{default}_ms"], device_ms=row[f"{default}_device_ms"])
    row["plain_ms"] = time_ms(lambda: detect_ref.ewma_scan_ref(v, zeros, zeros, count0, alpha,
                                                               clip), 2)
    print(f"  time ewma_scan at {EWMA_WINDOWS} x {EWMA_CELLS}: "
          + " ".join(f"{p}_ms={row[f'{p}_ms']:.5f} {p}_device_ms={_ms(row[f'{p}_device_ms'])} "
                     f"({', '.join(f'{k} {x:.5f}' for k, x in row[f'{p}_by_kernel'].items())})"
                     for p in ew.PATHS)
          + f"; first design (csrc/earlier) device_ms={_ms(row['earlier_device_ms'])} "
          f"({', '.join(f'{k} {x:.5f}' for k, x in split.items())}); plain_ms="
          f"{row['plain_ms']:.5f} library_ms=null bound_ms={b_ms:.5f} ({b_by}; {nbytes:.4e} B) "
          f"default path {default}, bound/device={_share(b_ms, row['device_ms'])}", flush=True)
    return launches, err, row


def reference_path_phase():
    """analyze_arrays_reference (plain torch on the card) on the ten golden
    windows at 1,024 ranks: verdicts equal to the NumPy composite's."""
    from repro_torch.core.c4d.detector import C4DDetector, DetectorConfig
    from repro_torch.core.faults import RingJobTelemetry
    from repro_torch.core.torchsim import detectors as tdet
    n, count = PARITY_RANKS, 0
    for faults in golden_faults():
        w = RingJobTelemetry(n_ranks=n, seed=9).window_arrays(0, faults)
        want = C4DDetector(backend="numpy").analyze(w, n)
        got = tdet.analyze_arrays_reference(w, DetectorConfig(), n_ranks=n, device=DEV)
        if _vkey(got) != _vkey(want):
            fail(f"analyze_arrays_reference on the card differs from NumPy on {faults}")
        count += len(want)
    print(f"  analyze_arrays_reference at {n} ranks on the card, 10 golden windows: verdicts "
          f"equal to the NumPy composite ({count} verdicts)", flush=True)


def fabric_phase(iters):
    """Water-filling parity and faults, the C4P main path, times and the
    crossover; the EWMA scan; the reference path. Returns the JSON rows."""
    fabrics, rounds, err = waterfill_parity()
    launches, main_fs, main_rounds = c4p_main_path()
    rows = {"main path": waterfill_times("main path (the balancer's last call)", main_fs,
                                         main_rounds, iters),
            "fig2": waterfill_times("fig2", fabrics["fig2"], rounds["fig2"], iters),
            "10240": waterfill_times("10240 GPUs", fabrics["10240"], rounds["10240 GPUs"],
                                     iters)}
    waterfill_crossover()
    ewma = ewma_phase(iters)
    reference_path_phase()
    return launches, err, rows, ewma


# --- [drills]: the C4 fault drills through the port's scenario engine ---------

#: sha256 of each shipped drill's report (``report_hash``), as the JAX
#: package's ``run_scenario`` gives it at its NumPy default: the
#: ``DRILL_GOLDENS`` of tests/test_fleet.py (copied: this script imports
#: neither the tests nor the JAX package).
DRILL_GOLDENS = {
    "cascading_spine_flaps": "1af9d45487eec2f40b705cd91ebf2baaae86a7f779c5aa1015c93f064fb61ffa",
    "degraded_pcie_attribution":
        "4ae9937198c92e2e33292623341fd9c5d928ce9e5875e4f7e4dfdd443364c344",
    "ecmp_vs_c4p_ab": "7f1404e5c68a60f24dfe100e85269c963f7908a1f7b742a30aa2cb4fefc72582",
    "fault_during_restart": "354e8766d92d1f4b0ae69782ea12ac743113235fad72dc4c34753a18f4929ce1",
    "loss_spike_cascade": "3c71db2f9197fa33c7438afe53b131b373555b2c3388c82340cbbe8a5936366a",
    "multijob_contention": "538ee2ea99487331bcd78b6d7c2ce3ae5aad68409b86fbdb0bfb4c740e14ea88",
    "nccl_timeout_storm": "48d0537d7ba0ada05d63ed22d54ace328a20d102bbf8a7e5a28762ee8dca2e31",
    "silent_data_corruption": "a3b8f49edc5074eb6cf9229f9874f0de7783ca5995cdc28cb715dbc844ba345f",
    "silent_pcie_degradation": "bf568cceb0b66c950f8f545b971201a9fe85801fe3f6176c47a3868cc6440051",
    "single_nic_down": "44e8911aec6330aacda625f034276e5d38b3b5e638cc51ea24dbc4d89e746dd2",
    "straggler_gpu": "7bcf2a16cf445bdf607297ad9d4e961b304cca47f62716a709924904c2235493",
}
#: straggler_gpu at the scale of fleet_day's anchor (10,240 ranks on 1,280
#: nodes plus backups, a 900 s streaming tick). Reduced: the horizon is the
#: drill's 2 h, the cadence fleet_day's 15 min.
FLEET_DRILL = ("straggler_gpu", {"telemetry_ranks": 10240, "n_nodes": 1288,
                                 "streaming_tick_s": 900.0})
#: report_hash of the JAX package's report on that spec, taken on the CPU
#: from ``repro.scenarios.engine.run_scenario(dataclasses.replace(
#: repro.scenarios.library.get("straggler_gpu"), telemetry_ranks=10240,
#: n_nodes=1288, streaming_tick_s=900.0, backend="numpy"))``.
FLEET_GOLDEN = "28d504183d789040f01fb2ba1da1dce0a25376372078a58efcd11847f4ba0767"
DRILL_KERNELS = ("window_score", "row_select", "slow_fold")
#: the drills' kernels on the card: detection's and C4P's water-filling
SIM_KERNELS = DRILL_KERNELS + ("waterfill",)
#: FlowSet.max_min calls of the 11 drills (the JAX package's run at numpy,
#: counted on the CPU): cascading_spine_flaps 71, multijob_contention 45,
#: ecmp_vs_c4p_ab 40, each of the other 8 drills 2
DRILL_WATERFILLS = 172


def sim_launches() -> dict:
    """The detection kernels' launches and water-filling's since the last reset."""
    from repro_torch.core.torchsim import detectors as tdet
    from repro_torch.kernels import waterfill as wf
    return dict(tdet.launch_counts(), waterfill=wf.launches)


def reset_sim_launches() -> None:
    from repro_torch.core.torchsim import detectors as tdet
    from repro_torch.kernels import waterfill as wf
    tdet.reset_launch_counts()
    wf.launches = 0


def report_hash(rep: dict) -> str:
    """sha256 of a report's canonical JSON, as tests/test_fleet.py hashes it."""
    return hashlib.sha256(json.dumps(rep, sort_keys=True, default=str).encode()).hexdigest()


def drill_run(spec, backend: str):
    """One drill through ``repro_torch.scenarios.engine.run_scenario``.
    Returns (report, wall s, streaming windows, s a window, launches, the
    launches of each ``C4DMaster.ingest``). The streaming windows are timed
    around ``C4DService.on_tick``; neither wrapper changes the run."""
    from repro_torch.scenarios.engine import run_scenario
    from repro_torch.scenarios.services.c4d_service import C4DService

    real_tick = C4DService.on_tick
    ticks = []

    def on_tick(self, t):
        t0 = time.perf_counter()
        real_tick(self, t)
        ticks.append(time.perf_counter() - t0)

    C4DService.on_tick = on_tick
    try:
        reset_sim_launches()
        t0 = time.perf_counter()
        with ingest_launches() as per_ingest:
            rep = run_scenario(dataclasses.replace(spec, backend=backend),
                               device=DEV if backend == "torch" else None)
        wall = time.perf_counter() - t0
        counts = sim_launches()
    finally:
        C4DService.on_tick = real_tick
    return rep, wall, len(ticks), sum(ticks) / max(len(ticks), 1), counts, per_ingest


def drill_pair(label: str, spec, golden: str) -> dict:
    """A drill at ``torch`` on the card, then at ``numpy``: the reports must
    be equal and hash to ``golden``; every ingest of the torch run (the
    streaming master's and each per-fault master's) must launch
    ``window_score`` once and ``row_select`` at least twice, and the NumPy run
    none. Returns the torch run's launches and times."""
    rep, wall, windows, per_win, counts, ingests = drill_run(spec, "torch")
    rep_np, wall_np, windows_np, per_win_np, counts_np, ingests_np = drill_run(spec, "numpy")
    if rep != rep_np:
        bad = [k for k in rep if rep[k] != rep_np.get(k)]
        fail(f"drill {label}: the card's report differs from NumPy's in {bad}")
    got = report_hash(rep)
    if got != golden:
        fail(f"drill {label}: report sha256 {got}, reference {golden}")
    if not rep["passed"]:
        fail(f"drill {label}: assertions failed: {[c for c in rep['checks'] if not c['ok']]}")
    short = [i for i, c in enumerate(ingests)
             if c["window_score"] != 1 or c["row_select"] < 2]
    if not ingests or short:
        fail(f"drill {label}: {len(short)} of {len(ingests)} ingests on the card did not "
             f"launch window_score once and row_select twice: {ingests[short[0]] if short else {}}")
    if any(counts[k] <= 0 for k in SIM_KERNELS) or any(counts_np.values()):
        fail(f"drill {label}: launches torch {counts}, numpy {counts_np}")
    print(f"  drill {label}: torch_s={wall:.4f} numpy_s={wall_np:.4f}; {windows} streaming "
          f"windows, s a window torch {per_win:.6f} numpy {per_win_np:.6f}; {len(ingests)} "
          f"ingests; launches {counts}; equal to NumPy, sha256 {got[:12]} = reference",
          flush=True)
    return {"torch_s": wall, "numpy_s": wall_np, "windows": windows, "ingests": len(ingests),
            "window_s": per_win, "window_numpy_s": per_win_np, "launches": counts}


def drills_phase() -> dict:
    """The 11 shipped drills, then straggler_gpu at 10,240 ranks. Returns the
    launches of the detection kernels in each part."""
    from repro_torch.scenarios import library

    if sorted(library.names()) != sorted(DRILL_GOLDENS):
        fail(f"drill library {library.names()} differs from the goldens' names")
    runs = [drill_pair(name, library.get(name), DRILL_GOLDENS[name])
            for name in sorted(DRILL_GOLDENS)]
    lib = {k: sum(r["launches"][k] for r in runs) for k in SIM_KERNELS}
    tot = {k: sum(r[k] for r in runs) for k in ("torch_s", "numpy_s", "windows", "ingests")}
    print(f"  {len(runs)} drills at 32 ranks: torch_s={tot['torch_s']:.4f} "
          f"numpy_s={tot['numpy_s']:.4f}; {tot['windows']} streaming windows, s a window "
          f"torch {sum(r['window_s'] * r['windows'] for r in runs) / tot['windows']:.6f} numpy "
          f"{sum(r['window_numpy_s'] * r['windows'] for r in runs) / tot['windows']:.6f}; "
          f"{tot['ingests']} ingests; launches {lib} (water-fills predicted from the CPU: "
          f"{DRILL_WATERFILLS})", flush=True)
    if lib["waterfill"] != DRILL_WATERFILLS:
        fail(f"the 11 drills launched waterfill {lib['waterfill']} times, not "
             f"{DRILL_WATERFILLS}")
    name, scale = FLEET_DRILL
    fleet = drill_pair(f"{name} at {scale['telemetry_ranks']} ranks",
                       dataclasses.replace(library.get(name), **scale), FLEET_GOLDEN)
    return {"library": lib, "fleet": fleet["launches"]}


# --- [live]: the drill's fault script replayed on the real Trainer -------------

LIVE_DRILL, LIVE_STEPS = "single_nic_down", 12


def live_phase() -> dict:
    """``repro_torch.scenarios.live.drive`` on the card: the reference's live
    test (the smollm-135m smoke config, 4 simulated nodes). Returns the
    launch counts of the replay."""
    from repro_torch.kernels import ops
    from repro_torch.scenarios import library, live

    workdir = tempfile.mkdtemp(prefix="chip_smoke_live_")
    try:
        ops.reset_launch_counts()
        reset_sim_launches()
        t0 = time.perf_counter()
        with ingest_launches() as per_ingest:
            rep = live.drive(library.get(LIVE_DRILL), workdir, n_steps=LIVE_STEPS,
                             sim_nodes=4, device=DEV)
        wall = time.perf_counter() - t0
        counts = dict(ops.launch_counts(), **sim_launches())
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    dets = rep["detections"]
    windows = sum(d["detection_windows"] for d in dets)
    print(f"  live {LIVE_DRILL}: {wall:.2f} s, {rep['steps_run']} steps, scheduled "
          f"{rep['scheduled_faults']}, restarts {rep['restarts']}, detections "
          f"{[(d['fault'], d['verdicts'], d['isolated'], d['detection_windows']) for d in dets]}, "
          f"isolated nodes {rep['isolated_nodes']}, final loss {rep['final_loss']}; "
          f"launches {counts}", flush=True)
    if rep["restarts"] != 1 or not dets or dets[0]["fault"] != "crash":
        fail(f"live: restarts {rep['restarts']}, detections {dets}")
    if not dets[0]["isolated"] or not rep["isolated_nodes"]:
        fail(f"live: no isolation on the shared cluster: {rep['isolated_nodes']}")
    if rep["final_loss"] is None or not rep["final_loss"] == rep["final_loss"]:
        fail(f"live: final loss {rep['final_loss']}")
    if len(per_ingest) != windows or any(c["window_score"] != 1 for c in per_ingest) \
            or counts["rmsnorm"] <= 0:
        fail(f"live: {len(per_ingest)} ingests for {windows} windows, launches {per_ingest}; "
             f"in all {counts}")
    return counts


# --- [campaigns]: Monte Carlo campaigns, the fleet and the ROC sweep ----------

#: sha256 (``report_hash``) of the 2-trial campaign reports: the
#: ``CAMPAIGN_GOLDENS`` of tests/test_fleet.py (copied, as the drills' are).
CAMPAIGN_GOLDENS = {
    "fleet_smoke": "48cda1db6f506cf5840581c2b6b10fe166fc8f48b567e87d2a0ac1ea8223c09c",
    "fleet_mixed": "af4288a9d17ab5401299575ed14f71c6851032aa52558c5379054ecd49c57185",
}
CAMPAIGN_TRIALS, FLEET, SWEEP = 2, "fleet_hour", "roc_smoke"


def _at(backend: str, fn):
    """``fn(device)`` under ``use_backend(backend)``, with its wall seconds
    and the detection and water-filling launches it made in this process."""
    from repro_torch.core.torchsim import use_backend

    reset_sim_launches()
    t0 = time.perf_counter()
    with use_backend(backend):
        out = fn(DEV if backend == "torch" else None)
    return out, time.perf_counter() - t0, sim_launches()


def campaigns_phase() -> dict:
    """fleet_smoke and fleet_mixed (2 trials) at torch on the card with 1
    and 2 workers and at numpy: each report must hash to the golden; then
    fleet_hour and the roc_smoke sweep at torch on the card and at numpy: the
    reports must be equal. Returns the detection launches of the card runs
    in this process."""
    from repro_torch.scenarios import fleet, montecarlo, precision

    total = dict.fromkeys(SIM_KERNELS, 0)

    def card_run(label, counts, need=("window_score", "slow_fold", "waterfill")):
        if any(counts[k] <= 0 for k in need):
            fail(f"campaigns {label}: the card run launched {counts}")
        for k in SIM_KERNELS:
            total[k] += counts[k]

    for name in sorted(CAMPAIGN_GOLDENS):
        spec = montecarlo.get(name, n_trials=CAMPAIGN_TRIALS)
        times = {}
        for backend, workers in (("torch", 1), ("torch", 2), ("numpy", 1)):
            rep, wall, counts = _at(backend, lambda dev: montecarlo.run_campaign(
                spec, workers=workers, device=dev))
            got = report_hash(rep.to_json())
            if got != CAMPAIGN_GOLDENS[name]:
                fail(f"campaign {name} at {backend}, {workers} worker(s): sha256 {got}, "
                     f"reference {CAMPAIGN_GOLDENS[name]}")
            if backend == "torch" and workers == 1:
                card_run(name, counts)
            elif any(counts.values()):
                fail(f"campaign {name} at {backend}, {workers} workers: launches in this "
                     f"process {counts}")
            times[f"{backend}_w{workers}_s"] = wall
        print(f"  campaign {name} ({CAMPAIGN_TRIALS} trials x {spec.gpus} GPUs): "
              + " ".join(f"{k}={v:.4f}" for k, v in times.items())
              + f"; sha256 {CAMPAIGN_GOLDENS[name][:12]} = reference at each", flush=True)

    fspec = fleet.get(FLEET)
    card, wall, counts = _at("torch", lambda dev: fleet.run_fleet(fspec, device=dev).to_json())
    ref, wall_np, _ = _at("numpy", lambda dev: fleet.run_fleet(fspec, device=dev).to_json())
    if card != ref:
        fail(f"fleet {FLEET}: the card's report differs from NumPy's in "
             f"{[k for k in card if card[k] != ref.get(k)]}")
    card_run(FLEET, counts)
    print(f"  fleet {FLEET} ({fspec.gpus} GPUs, {fspec.duration_s / 3600:.0f} h): torch_s="
          f"{wall:.4f} numpy_s={wall_np:.4f}; {card['n_segments']} segments; equal to NumPy, "
          f"sha256 {report_hash(card)[:12]}; launches {counts}", flush=True)

    sspec = precision.get(SWEEP)
    card, wall, counts = _at("torch", lambda dev: precision.run_sweep(sspec, device=dev))
    ref, wall_np, _ = _at("numpy", lambda dev: precision.run_sweep(sspec, device=dev))
    if card.to_json() != ref.to_json() or card.selected != ref.selected:
        fail(f"sweep {SWEEP}: the card's report or selected point differs from NumPy's")
    card_run(SWEEP, counts, need=("window_score", "slow_fold"))   # no fabric in a sweep
    print(f"  sweep {SWEEP} ({sspec.n_trials} trials x {len(card.points) + 1} points): "
          f"torch_s={wall:.4f} numpy_s={wall_np:.4f}; selected {card.selected['label']} "
          f"(targets met: {card.meets_targets}); equal to NumPy; launches {counts}",
          flush=True)
    print(f"  campaigns on the card, this process: launches {total}", flush=True)
    return total


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


def profile_one(label: str, fn, out_dir: Path, num_experts=None) -> None:
    """torch.profiler over one call of ``fn``: device time by kernel and the
    device's busy share of the profiled wall time, and the device time by
    part (``parts``); the table goes to ``out_dir/profile_<label>.txt``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out_dir.mkdir(parents=True, exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only: the CPU ops also carry their kernels' time
    # (a ``scoped`` range is shown on the device too: its span, not a kernel)
    dev = sorted(((e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and not e.key.startswith("scope: ")),
                 reverse=True)
    busy = sum(d[0] for d in dev)
    print(f"  profile {label}: wall_ms={wall_us / 1e3:.3f} (profiled) "
          f"device_busy_ms={busy / 1e3:.3f} busy_share={busy / wall_us:.4f}", flush=True)
    for us, n, key in dev[:10]:
        print(f"    {us / 1e3:10.3f} ms {us / busy:7.2%} x{n:<5d} {key[:90]}", flush=True)
    by_part = parts(prof, num_experts)
    print("    by part: " + "; ".join(f"{k} {us / 1e3:.3f} ms ({us / busy:.2%})"
                                      for k, us in by_part.most_common()), flush=True)
    scopes = sorted(((e.device_time_total, e.count, e.key[len("scope: "):])
                     for e in prof.key_averages()
                     if e.key.startswith("scope: ") and e.device_type != DeviceType.CUDA),
                    reverse=True)
    if scopes:
        print("    by scope (device time of the kernels launched inside; they overlap the "
              "parts above): " + "; ".join(f"{key} {us / 1e3:.3f} ms ({us / busy:.2%}, x{n})"
                                          for us, n, key in scopes), flush=True)
    (out_dir / f"profile_{label}.txt").write_text(
        prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))


DISPATCH_OPS = ("aten::gather", "aten::scatter", "aten::scatter_", "aten::scatter_add_",
                "aten::sort", "aten::argsort", "aten::cumsum", "aten::one_hot", "aten::index",
                "aten::cat", "aten::zeros", "aten::fill_", "aten::clamp_max")


def parts(prof, num_experts) -> collections.Counter:
    """Device us by part: the port's kernels by name (their launches are
    ctypes calls, in no aten op); every other kernel by the aten op that
    launched it (its self device time): ``bmm`` batched over the experts
    (the expert GEMMs), other ``bmm`` (attention scores and PV, MLA's
    absorbed decode, the MoE combine), ``mm`` (projections, the router, the
    shared or residual MLPs, the read-out), the dispatch and combine's index
    work (gathers, scatters, sorts, concatenations), softmax, and the rest
    (elementwise, casts and copies)."""
    from torch.autograd import DeviceType
    out = collections.Counter()
    for e in prof.key_averages(group_by_input_shape=True):
        us = e.self_device_time_total
        if us <= 0 or e.key.startswith("scope: "):
            continue
        if e.device_type == DeviceType.CUDA:
            for part, names in (("flash kernel", FLASH_KERNELS),
                                ("decode kernel", DECODE_KERNELS),
                                ("rmsnorm kernel", RMSNORM_KERNELS)):
                if any(n in e.key for n in names):
                    out[part] += us
            continue
        shapes = e.input_shapes or [[]]
        if e.key == "aten::bmm" and shapes[0] and shapes[0][0] == num_experts:
            out["expert GEMMs"] += us
        elif e.key == "aten::bmm":
            out["other bmm"] += us
        elif e.key in ("aten::mm", "aten::addmm"):
            out["mm"] += us
        elif e.key in DISPATCH_OPS:
            out["gather/scatter/sort/cat"] += us
        elif "softmax" in e.key:
            out["softmax"] += us
        else:
            out["other ops"] += us
    return out


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
    from repro_torch.common import torch_compat
    try:
        version, capability = torch_compat.check_supported(), torch_compat.check_device(0)
    except torch_compat.TorchCompatError as e:
        fail(str(e))
    print(f"torch_compat: torch {'.'.join(map(str, version))} supported (>= "
          f"{'.'.join(map(str, torch_compat.MIN_TORCH))}, tested to "
          f"{'.'.join(map(str, torch_compat.NEWEST_TESTED))}); device 0 compute capability "
          f"{capability}, CUDA {torch.version.cuda}: runs the sm_90a kernels", flush=True)
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
    offset_err, offset_rows = flash_offset_phase(ITERS, card)
    decode_err, decode_rows = decode_phase(ITERS)
    shard_err, shard_rows = shard_decode_phase(ITERS, card)
    wide_attention_phase()
    norm_err, norm_rows, norm_extra = rmsnorm_phase(ITERS)
    split_err, split_rows = rmsnorm_split_phase(ITERS, card)
    model_err, model_rows = model_kernel_phase(ITERS)
    print(f"[kernels] done in {time.perf_counter() - t0:.1f} s", flush=True)

    # [detect] before [serve] and [train]: after the train phase the profiler
    # dropped the records of short profiled windows
    t0 = time.perf_counter()
    print("[detect]", flush=True)
    det_err, det_rows, det_counts = detect_phase(DETECT_ITERS)
    print(f"[detect] done in {time.perf_counter() - t0:.1f} s", flush=True)

    # the [tp] xlstm-125m rank's dry runs, in a child process beside [fabric]
    # and [drills] (host time only; the child touches no card)
    import concurrent.futures
    import multiprocessing
    pool = concurrent.futures.ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
    xlstm_dry = pool.submit(xlstm_dry_runs)
    t0 = time.perf_counter()
    print("[fabric]", flush=True)
    wf_launches, wf_err, wf_rows, (ew_launches, ew_err, ew_row) = fabric_phase(ITERS)
    print(f"[fabric] done in {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    print("[drills]", flush=True)
    drill_counts = drills_phase()
    print(f"[drills] done in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    xlstm_recs = xlstm_dry.result()
    pool.shutdown()
    print(f"[tp] xlstm-125m rank's dry runs waited for {time.perf_counter() - t0:.1f} s "
          "after [drills]", flush=True)

    t0 = time.perf_counter()
    print("[campaigns]", flush=True)
    campaign_counts = campaigns_phase()
    print(f"[campaigns] done in {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    print("[serve]", flush=True)
    serve_counts, serve_facts = serve_phase()
    print(f"[serve] done in {time.perf_counter() - t0:.1f} s", flush=True)
    if args.profile is not None:
        print("[profile]", flush=True)
        profile_phase(args.profile)

    t0 = time.perf_counter()
    print("[train]", flush=True)
    train_counts = train_phase(args.profile)
    train_fault_counts = train_counts.pop("detect")
    int8_counts = train_counts.pop("int8")
    train_facts = train_counts.pop("dryrun")
    stacked_update_check(card)
    print(f"[train] done in {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    print("[dryrun]", flush=True)
    dryrun_phase(card, serve_facts, train_facts)
    print(f"[dryrun] done in {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    print("[mesh]", flush=True)
    mesh_counts = mesh_phase()
    print(f"[mesh] done in {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    print("[tp]", flush=True)
    batch_mode_counts = batch_mode_check(card)
    seq_mode_counts = sequence_mode_check(card)
    tp_counts = tp_phase(card)
    tp_serve_counts = tp_serve_phase(card)
    tp_ssm_counts = tp_ssm_phase(card)
    t1 = time.perf_counter()
    tp_xlstm_counts = tp_xlstm_phase(card, xlstm_recs)
    print(f"[tp] xlstm-125m rank {time.perf_counter() - t1:.1f} s", flush=True)
    print(f"[tp] done in {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    print("[live]", flush=True)
    live_counts = live_phase()
    print(f"[live] done in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    print(f"[models] {card}", flush=True)
    models = models_phase(card, args.profile)
    print(f"[models] done in {time.perf_counter() - t0:.1f} s", flush=True)
    counts = {k: serve_counts[k] + train_counts[k] for k in serve_counts}
    model_launches = {name: {arch: {"serve": models[arch]["serve"]["launches"][name],
                                    "train": models[arch]["train"]["launches"]
                                    if name == "rmsnorm" and "train" in models[arch] else 0}
                             for arch in MODEL_ARCHS} for name in counts}
    print(f"launches on the main paths: serve {serve_counts}, train {train_counts}, "
          f"train fault {train_fault_counts}, train int8 {int8_counts}, mesh {mesh_counts}, "
          f"tp {tp_counts}, tp serve {tp_serve_counts}, tp batch mode {batch_mode_counts}, "
          f"tp sequence mode {seq_mode_counts}, tp zamba2 {tp_ssm_counts}, "
          f"tp xlstm {tp_xlstm_counts}, "
          f"live {live_counts}, campaigns {campaign_counts}, models {model_launches}",
          flush=True)


    def times(row):
        ms, plain, lib, b_ms, b_by, dev, lib_dev = row[:7]
        out = {"ms": ms, "device_ms": dev, "plain_ms": plain, "bound_ms": b_ms,
               "bound_by": b_by, "library_ms": lib, "library_device_ms": lib_dev}
        if len(row) > 7:   # attention: the kernels a call launched (profiler)
            out["kernels_a_call"] = row[7]
        return out

    def entry(name, source, replaces, err, rows):
        # attention: one local-window and one global launch of the main path,
        # averaged; rmsnorm: the training microbatch (1, 4096, 2304). The
        # [models] configs' shapes and launches besides (max_abs_err over all)
        col = [[r[i] for r in rows] for i in range(7)]
        mean = [None if i == 4 or None in c else sum(c) / len(c) for i, c in enumerate(col)]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": counts[name], "max_abs_err": max(err[0], model_err[name][0]),
                "max_row_rel_err": max(err[1], model_err[name][1]),
                "ms": mean[0], "device_ms": mean[5], "plain_ms": mean[1], "bound_ms": mean[3],
                "bound_by": rows[0][4], "library_ms": mean[2], "library_device_ms": mean[6],
                "models": {label: times(row) for label, row in model_rows[name].items()},
                "models_launches": model_launches[name],
                **({"kernels_a_call": rows[0][7]} if len(rows[0]) > 7 else {})}

    batch_counts, batch_rows = det_rows["batched"]

    def detect_entry(name, source, replaces, launches, err, row):
        # one window at 100,000 ranks; launches on the detection main path.
        # Besides: the prefilter's node groups, ingest_batch at 1,024 x 8, and
        # the launches of the 11 drills' torch runs, of the 10,240-rank drill,
        # of the Trainer's fault handler, of the live replay and of the
        # campaigns, the fleet and the sweep on the card (this process)
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": launches, "max_abs_err": err, **times(row),
                 "drills": drill_counts["library"][name],
                 "fleet_drill": drill_counts["fleet"][name],
                 "train_fault": train_fault_counts[name], "live": live_counts[name],
                 "campaigns": campaign_counts[name]}
        if name == "row_select":
            entry["node_groups"] = times(det_rows["row_select_node"])
        if name in batch_rows:
            entry["batched"] = dict(times(batch_rows[name]), launches=batch_counts[name])
        return entry

    print(card, flush=True)
    # the sharded serves' launches: [mesh]'s world-1 gemma2-2b, [tp]'s yi-34b rank
    def sharded(name):
        return {"mesh_serve": mesh_counts["serve"][name], "tp_serve": tp_serve_counts[name]}

    print(json.dumps({"kernels": [
        # the query offset's rows (the last of 8 shards of the prompt) and
        # its launches in [tp]'s "sequence" mode check
        dict(entry("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
                   "src/repro/kernels/flash_attention.py:88",
                   tuple(max(a, b) for a, b in zip(flash_err, offset_err)), flash_rows),
             **sharded("flash_attention"),
             tp_batch_mode=batch_mode_counts["flash_attention"],
             offset_mode=offset_rows, tp_sequence_mode=seq_mode_counts["flash_attention"]),
        # the shard mode at its shapes (8 shards, merged), its launches in
        # [tp]'s sharded serve (world 1 runs the whole-cache call)
        dict(entry("decode_attention", "src/repro_torch/kernels/csrc/decode_attention.cu",
                   "src/repro/kernels/decode_attention.py:70",
                   tuple(max(a, b) for a, b in zip(decode_err, shard_err)), decode_rows),
             shard_mode=shard_rows, **sharded("decode_attention")),
        dict(entry("rmsnorm", "src/repro_torch/kernels/csrc/rmsnorm.cu",
                   "src/repro/kernels/rmsnorm.py:27", norm_err, norm_rows[:1]),
             prefill=times(norm_rows[1]), decode=dict(times(norm_rows[2]), **norm_extra),
             live=live_counts["rmsnorm"], train_int8=int8_counts["rmsnorm"],
             mesh=mesh_counts["rmsnorm"], tp=tp_counts["rmsnorm"], **sharded("rmsnorm"),
             tp_zamba2=tp_ssm_counts["rmsnorm"], tp_xlstm=tp_xlstm_counts["rmsnorm"],
             split_mode="rmsnorm_split"),
        # the split mode at zamba2-7b's gated norm in 8 shards (xlstm-125m's
        # two in 16 under "cases", its max errors over all three); its launches in
        # [tp]'s zamba2-7b rank and xlstm-125m rank (each a train step, a
        # prefill and 4 decode steps)
        {"name": "rmsnorm_split", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
         "replaces": "src/repro/kernels/rmsnorm.py:27",
         "launches": tp_ssm_counts["rmsnorm_split"] + tp_xlstm_counts["rmsnorm_split"],
         "max_abs_err": split_err[0],
         "max_row_rel_err": split_err[1], **times(split_rows[0][:7]),
         "whole_row_device_ms": split_rows[0][7], "shape": list(SPLIT_CASES[0][0]),
         "shards": SPLIT_CASES[0][1],
         "cases": [dict(times(row[:7]), whole_row_device_ms=row[7], shape=list(shape),
                        shards=shards, norm=label)
                   for row, (shape, shards, label) in zip(split_rows[1:], SPLIT_CASES[1:])],
         "train": tp_ssm_counts["train"]["rmsnorm_split"],
         "serve": tp_ssm_counts["serve"]["rmsnorm_split"],
         "xlstm_train": tp_xlstm_counts["train"]["rmsnorm_split"],
         "xlstm_serve": tp_xlstm_counts["serve"]["rmsnorm_split"]},
        *(detect_entry(name, src, rep, det_counts[name], det_err[name], det_rows[name])
          for name, src, rep in DETECT_KERNELS),
        # the balancer's last call of the C4P main path; launches there, in the
        # drills, the 10,240-rank drill, the campaigns and the live replay;
        # the Fig. 2 and 10,240-GPU fabrics besides
        {"name": "waterfill", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/waterfill.cu",
         "replaces": "src/repro/core/jaxsim/kernels.py:360", "launches": wf_launches,
         "max_abs_err": wf_err, **wf_rows["main path"],
         "library_ms": None, "drills": drill_counts["library"]["waterfill"],
         "fleet_drill": drill_counts["fleet"]["waterfill"],
         "campaigns": campaign_counts["waterfill"], "live": live_counts["waterfill"],
         "fig2": wf_rows["fig2"], "fabric_10240": wf_rows["10240"]},
        # its own entry at bench_jaxsim.py's full size (no caller on a main path)
        dict({"name": "ewma_scan", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/ewma_scan.cu",
              "replaces": "src/repro/core/jaxsim/kernels.py:320", "launches": ew_launches,
              "max_abs_err": ew_err}, **ew_row),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
