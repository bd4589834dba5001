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
(``parse_collectives``). The port has no HLO: the dry run counts the
collectives that one rank's share of the sharded train step issues as it
traces it (``dryrun.collectives_of``), with the JAX package's ring wire
factors:

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
