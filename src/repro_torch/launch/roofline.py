"""Roofline of a dry-run cell at one H100 SXM's peaks (``launch/mesh.py``).

Port of ``repro.launch.roofline``. Three terms a cell, each per device:

    t_comp = FLOPs                 / 989e12   (bf16 tensor cores)
    t_mem  = HBM bytes             / 3.35e12
    t_coll = collective wire bytes / 50e9     (one NIC a GPU: NET_BW)

The JAX package reads the FLOPs and bytes from XLA's ``cost_analysis()`` of
unrolled lowerings at 1 and 2 units; the port counts them by tracing the
step on the meta device (``launch/dryrun.py``), at 2 and 3 units
(``dryrun.UNITS``), and extrapolates as the JAX package does:

    per_unit = cost(3 units) - cost(2 units)
    total    = cost(2 units) + (n_units - 2) * per_unit

The JAX package parses its collectives from the compiled HLO
(``parse_collectives``). The port has no HLO: ``collectives_of`` counts what
the port's sharded train step (``train/steps.py``) issues, a leaf at a time,
with the JAX package's ring wire factors:

    all-reduce      2 (N-1)/N * bytes     all-gather     (N-1)/N * out_bytes
    reduce-scatter  (N-1)/N * in_bytes    all-to-all     (N-1)/N * bytes
    collective-permute  bytes
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict

import torch

from repro_torch.launch import mesh as meshmod


@dataclass
class CollectiveStats:
    counts: Dict[str, int] = field(default_factory=dict)
    raw_bytes: Dict[str, float] = field(default_factory=dict)
    wire_bytes: float = 0.0    # per-device bytes on the wire (ring factors)

    def add(self, kind: str, nbytes: float, group: int):
        self.counts[kind] = self.counts.get(kind, 0) + 1
        self.raw_bytes[kind] = self.raw_bytes.get(kind, 0.0) + nbytes
        n = max(group, 2)
        factor = {"all-reduce": 2 * (n - 1) / n,
                  "all-gather": (n - 1) / n,
                  "reduce-scatter": (n - 1) / n,
                  "all-to-all": (n - 1) / n,
                  "collective-permute": 1.0}[kind]
        self.wire_bytes += factor * nbytes

    def merged(self, other: "CollectiveStats", scale: float) -> "CollectiveStats":
        out = CollectiveStats(dict(self.counts), dict(self.raw_bytes),
                              self.wire_bytes)
        for k, v in other.counts.items():
            out.counts[k] = out.counts.get(k, 0) + int(v * scale)
        for k, v in other.raw_bytes.items():
            out.raw_bytes[k] = out.raw_bytes.get(k, 0.0) + v * scale
        out.wire_bytes += other.wire_bytes * scale
        return out


@dataclass
class CostTerms:
    flops: float = 0.0               # per-device FLOPs
    hbm_bytes: float = 0.0           # per-device bytes accessed
    coll: CollectiveStats = field(default_factory=CollectiveStats)

    def extrapolate(self, per_unit: "CostTerms", extra_units: int) -> "CostTerms":
        return CostTerms(
            flops=self.flops + per_unit.flops * extra_units,
            hbm_bytes=self.hbm_bytes + per_unit.hbm_bytes * extra_units,
            coll=self.coll.merged(per_unit.coll, extra_units))

    def diff(self, smaller: "CostTerms") -> "CostTerms":
        d = CollectiveStats()
        d.wire_bytes = max(self.coll.wire_bytes - smaller.coll.wire_bytes, 0.0)
        for k in set(self.coll.counts) | set(smaller.coll.counts):
            d.counts[k] = self.coll.counts.get(k, 0) - smaller.coll.counts.get(k, 0)
            d.raw_bytes[k] = self.coll.raw_bytes.get(k, 0.0) - smaller.coll.raw_bytes.get(k, 0.0)
        return CostTerms(max(self.flops - smaller.flops, 0.0),
                         max(self.hbm_bytes - smaller.hbm_bytes, 0.0), d)


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    t_comp: float
    t_mem: float
    t_coll: float
    model_flops: float
    hlo_flops: float                 # the counted FLOPs of every device
    bytes_per_device: float
    collective_counts: Dict[str, int]

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_comp, "memory": self.t_mem,
                 "collective": self.t_coll}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """How close the step is to the compute roofline: the ideal
        (compute-only) time over the achievable lower-bound time (max of the
        three terms — they overlap at best)."""
        ideal = self.model_flops / (self.chips * meshmod.PEAK_FLOPS_BF16)
        bound = max(self.t_comp, self.t_mem, self.t_coll)
        return ideal / bound if bound else 0.0


def roofline_terms(arch: str, shape: str, mesh_name: str, chips: int,
                   total: CostTerms, model_flops: float,
                   mem_bytes_per_device: float) -> Roofline:
    # the counted FLOPs are a device's; scale to global
    t_comp = total.flops / meshmod.PEAK_FLOPS_BF16
    t_mem = total.hbm_bytes / meshmod.HBM_BW
    t_coll = total.coll.wire_bytes / meshmod.NET_BW
    return Roofline(arch, shape, mesh_name, chips, t_comp, t_mem, t_coll,
                    model_flops, total.flops * chips, mem_bytes_per_device,
                    dict(total.coll.counts))


def model_flops_estimate(n_params_active: int, tokens: int, kind: str) -> float:
    """6*N*D for training; 2*N*D for a forward-only (serve) step."""
    return (6.0 if kind == "train" else 2.0) * n_params_active * tokens


def step_model_flops(cfg, n_params_active: int, shape) -> float:
    """The model FLOPs of one step of ``shape`` (the MFU's numerator):
    ``model_flops_estimate`` over the step's tokens, except that a prefill's
    read-out (vocab x d_model parameters) counts only at the last position
    of each row, the one ``make_prefill_step`` (``head="last"``) makes
    logits for: 2 (N - V d) B S + 2 V d B."""
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    if shape.kind != "prefill":
        return model_flops_estimate(n_params_active, tokens, shape.kind)
    readout = cfg.vocab_size * cfg.d_model
    return (model_flops_estimate(n_params_active - readout, tokens, shape.kind)
            + model_flops_estimate(readout, shape.global_batch, shape.kind))


def cache_bytes(run, batch: int, seq_len: int) -> int:
    """Bytes of the port's ``LM.init_cache(batch, seq_len)`` at the config's
    ``kv_cache_dtype``, built on the meta device."""
    from repro_torch.models.transformer import LM
    model = LM(run.model, device="meta")
    cache = model.init_cache(batch, seq_len, dtype=getattr(torch, run.parallel.kv_cache_dtype))
    return sum(t.numel() * t.element_size() for c in cache if c is not None for t in c)


def structural_hbm_bytes(run, shape, chips: int) -> float:
    """Per-device HBM traffic estimate assuming perfect fusion and the
    parameters sharded over every device (the JAX package's formula; the
    traced bytes, ``t_mem_traced_s``, are an unfused upper bound). Terms:

      train:   3x params (fwd read, bwd read, update write) + 2x opt state
               + saved layer activations (write + read) + remat recompute
               writes + chunked-CE logits (write+read fwd, recompute bwd)
               + MoE dispatch buffers
      prefill: params + cache write + per-layer activations + CE last pos
      decode:  params + full KV cache read (the decode hot spot)
    """
    from repro_torch.models.model import count_params_analytic

    cfg = run.model
    n_params = count_params_analytic(cfg)
    n_active = count_params_analytic(cfg, active_only=True)
    p_bytes = 2 * n_params / chips                      # bf16, fully sharded
    a_bytes_active = 2 * n_active / chips
    dp_shards = max(chips // 16, 1)                     # batch over pod x data
    tokens_local = shape.global_batch * shape.seq_len / dp_shards
    d = cfg.d_model
    cache = cache_bytes(run, shape.global_batch, shape.seq_len) / chips

    if shape.kind == "train":
        opt = {"adamw": 8, "adamw_factored": 2.1, "adamw_8bit": 2.1}[
            run.parallel.optimizer_state] * n_params / chips
        acts = cfg.n_layers * tokens_local * d * 2      # saved carries, bf16
        ce = tokens_local * cfg.vocab_size * 4 * 3      # logits w+r fwd, bwd
        moe = 0.0
        if cfg.moe is not None:
            m = cfg.moe
            n_moe_layers = cfg.n_layers - cfg.first_k_dense
            moe = (n_moe_layers * tokens_local * m.top_k * m.capacity_factor
                   * d * 2 * 4)
        return 3 * p_bytes + 2 * a_bytes_active + 2 * opt + 3 * acts + ce + moe
    if shape.kind == "prefill":
        acts = cfg.n_layers * tokens_local * d * 2 * 2
        return a_bytes_active + cache + acts
    # decode: read every param + the whole cache once per token
    toks = shape.global_batch / dp_shards
    return a_bytes_active + cache + cfg.n_layers * toks * d * 2 * 8


# ---------------------------------------------------------------------------
# The sharded train step's collectives
# ---------------------------------------------------------------------------

METRICS = ("ce_loss", "loss")
MOE_METRICS = ("moe_lb_loss", "moe_z_loss")


def collectives_of(params: Dict[str, torch.Tensor], mesh_sizes: Dict[str, int], opt_cfg,
                   run) -> CollectiveStats:
    """The collectives one step of ``train/steps.py``'s sharded step issues
    on a mesh of ``mesh_sizes`` ({axis: size} in mesh order), for the
    parameters ``params`` ({name: tensor}; meta tensors will do) under
    ``param_placements``' specs, the optimizer ``opt_cfg`` and ``run``'s
    microbatches, remat, accumulator dtype and compression. A group of one
    device moves nothing and is not counted. Per parameter:

      * its master gathered before the forward (``full_tensor``): an
        all-gather a mesh axis that shards it, the last axis first, each
        growing the tensor by that axis;
      * its gradient averaged over each batch axis onto its placement: a
        reduce-scatter of the whole gradient over an axis that shards the
        master, else an all-reduce; the ``model`` axis is sliced, no
        collective;
      * with an optimizer that is not elementwise (``adamw_factored``,
        ``adamw_8bit``): master and gradient gathered whole again for the
        update.

    Besides: the metrics' all-reduce over every device; the global norm's
    all-reduce of one float a leaf over each mesh axis that shards a leaf;
    with int8 compression, the per-leaf maxima over every device; with MoE,
    each MoE layer's two load-balance means over every device in each
    forward (again in remat's recompute) and the gradient of one of them in
    the backward, a microbatch each."""
    from repro_torch.models.model import DTYPES
    from repro_torch.parallel import sharding as shd

    sizes = dict(mesh_sizes)
    world = math.prod(sizes.values())
    stats = CollectiveStats()
    if world == 1:
        return stats
    pcfg = run.parallel
    k = max(pcfg.microbatches, 1)
    int8 = pcfg.grad_compression == "int8"
    specs = shd.param_specs(params, sizes)
    axes_order = [a for a in sizes if sizes[a] > 1]
    batch = [a for a in shd.BATCH_AXES if sizes.get(a, 1) > 1]

    def add(kind: str, nbytes: float, n: int) -> None:
        if n > 1:
            stats.add(kind, nbytes, n)

    def gather(nbytes: float, axes) -> None:
        cur = nbytes / math.prod(sizes[a] for a in axes)
        for a in reversed(axes):
            cur *= sizes[a]
            add("all-gather", cur, sizes[a])

    sharding_axes = set()
    for name, p in params.items():
        on = {a for e in specs[name] for a in shd._axes_of(e)}
        axes = [a for a in axes_order if a in on]
        sharding_axes.update(axes)
        p_bytes = p.numel() * p.element_size()
        g_dtype = DTYPES[pcfg.grad_accum_dtype] if k > 1 else p.dtype
        g_bytes = p.numel() * g_dtype.itemsize
        gather(p_bytes, axes)
        for a in batch:
            add("reduce-scatter" if a in axes else "all-reduce", g_bytes, sizes[a])
        if opt_cfg.kind != "adamw":
            gather(p_bytes, axes)
            gather(p.numel() * (4 if int8 else g_dtype.itemsize), axes)

    n_leaves = len(params)
    moe_layers = sum(name.endswith("moe.router") for name in params)
    metrics = len(METRICS) + (len(MOE_METRICS) if moe_layers else 0)
    add("all-reduce", 4 * metrics, world)
    if int8:
        add("all-reduce", 4 * n_leaves, world)
    for a in axes_order:
        if a in sharding_axes:
            add("all-reduce", 4 * n_leaves, sizes[a])
    if moe_layers:
        e = run.model.moe.num_experts
        # a microbatch: me and ce in the forward and in remat's recompute,
        # me's gradient in the backward
        per_microbatch = 2 * (2 if pcfg.remat != "none" else 1) + 1
        for _ in range(moe_layers * k * per_microbatch):
            add("all-reduce", 4 * e, world)
    return stats
