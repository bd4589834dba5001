"""Configuration dataclasses: the port's own copy of ``repro.common.config``.

The dataclasses are field-for-field those of the JAX package (a test holds
them equal). ``ModelConfig.param_count`` is not copied: it traced the JAX
model; ``repro_torch.models.transformer.LM.num_params`` counts the torch one.

Every architecture is expressed as a ``RunConfig`` combining a
``ModelConfig`` (architecture), ``ParallelConfig`` (mesh / sharding / remat),
and ``TrainConfig`` (optimizer / schedule / checkpointing). Configs are plain
frozen dataclasses.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

BLOCK_DENSE = "dense"          # attention + MLP
BLOCK_MOE = "moe"              # attention + MoE FFN
BLOCK_MAMBA2 = "mamba2"        # Mamba2 SSD block
BLOCK_SLSTM = "slstm"          # xLSTM scalar-memory block
BLOCK_MLSTM = "mlstm"          # xLSTM matrix-memory block


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 2
    d_ff_expert: int = 0          # per-expert hidden size
    num_shared_experts: int = 0   # deepseek-style always-on experts
    dense_residual_d_ff: int = 0  # arctic-style parallel dense FFN (0 = none)
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    load_balance_loss: float = 1e-2


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 0          # 0 = full-rank queries
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64           # N (per-head SSM state)
    conv_width: int = 4
    head_dim: int = 64            # P
    num_heads: int = 0            # 0 = derived from d_inner // head_dim
    expand: int = 2               # d_inner = expand * d_model
    chunk_size: int = 256         # SSD block length


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 = d_model // n_heads
    # --- attention variants ---
    rope_theta: float = 10_000.0
    sliding_window: int = 0                  # 0 = full attention
    local_global_alternating: bool = False   # gemma2: even layers local, odd global
    attn_logit_softcap: float = 0.0          # 0 = disabled
    final_logit_softcap: float = 0.0
    qk_norm: bool = False
    # --- MLA (deepseek) ---
    mla: Optional[MLAConfig] = None
    # --- MoE ---
    moe: Optional[MoEConfig] = None
    moe_every: int = 1            # MoE FFN in every k-th layer (1 = all)
    first_k_dense: int = 0        # deepseek: first k layers use dense FFN
    # --- SSM / hybrid ---
    ssm: Optional[SSMConfig] = None
    block_pattern: Tuple[str, ...] = ()      # explicit per-layer pattern; () = all dense/moe
    shared_attn_every: int = 0               # zamba2: shared attention block every k layers
    # --- cross attention (vlm) ---
    cross_attn_every: int = 0                # llama-3.2-vision: cross-attn each k-th layer
    vision_d_model: int = 0                  # width of the (stubbed) patch embeddings
    vision_seq_len: int = 0
    # --- misc ---
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    act: str = "silu"             # silu | gelu
    post_block_norm: bool = False            # gemma2 sandwich norms
    embed_scale: bool = False                # gemma2: embeddings * sqrt(d_model)
    # audio (musicgen): number of EnCodec codebooks summed at the input; frontend stub
    n_codebooks: int = 0
    supports_long_context: bool = False      # may run the long_500k cell

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def layer_kind(self, i: int) -> str:
        """Block type of layer ``i``."""
        if self.block_pattern:
            return self.block_pattern[i % len(self.block_pattern)]
        if self.moe is not None:
            if i < self.first_k_dense or (self.moe_every > 1 and i % self.moe_every != 0):
                return BLOCK_DENSE
            return BLOCK_MOE
        return BLOCK_DENSE


# ---------------------------------------------------------------------------
# Parallelism
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ParallelConfig:
    # logical->mesh-axis rules. The mesh axes are ("pod","data","model") or
    # ("data","model"); "pod" composes with "data" for batch/FSDP purposes.
    fsdp_axis: str = "data"
    tp_axis: str = "model"
    remat: str = "dots"                  # none | dots | full
    scan_layers: bool = True
    # serving: shard a long KV cache along sequence over tp_axis
    sequence_shard_kv: bool = False
    # hierarchical gradient reduction over the pod axis (C4P-inspired)
    hierarchical_allreduce: bool = True
    grad_compression: str = "none"       # none | int8
    microbatches: int = 1                # gradient accumulation
    # dense matmul precision for roofline realism
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # microbatch gradient-accumulator dtype; bf16 halves accumulator HBM on
    # the 200B+ MoE archs (error ~1e-3 relative over 8 microbatches)
    grad_accum_dtype: str = "float32"
    # ZeRO-style 2D attention-weight sharding ("off" | "on" | "auto");
    # "auto" enables it when n_heads % tp != 0 (see parallel/sharding.py)
    attn_zero_sharding: str = "off"
    # attention ACTIVATION sharding: "off" | "batch" | "sequence" | "auto";
    # "batch" splits attention's rows over pod x data x model where they
    # divide, "sequence" its query positions over model where they divide
    # (every key on each rank); "auto" = "batch" where the kv heads don't
    # divide 16 and there is no MLA, else "off"
    # (models/model.py::attn_activation_mode)
    attn_activation_sharding: str = "off"
    # MoE expert-weight sharding: "2d" (E over tp + dim over fsdp) or
    # "zero" (E over tp, non-contracted dim over fsdp -> weights gathered,
    # never partial-sum all-reduce of dispatch activations; Perf cell 2)
    moe_weight_sharding: str = "2d"
    # KV-cache storage dtype for serving ("bfloat16" | "float8_e4m3fn");
    # fp8 halves decode's dominant memory term (EXPERIMENTS.md Perf cell 3)
    kv_cache_dtype: str = "bfloat16"
    # optimizer-state policy (see optim/): adamw | adamw_factored | adamw_8bit
    optimizer_state: str = "adamw"


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    seq_len: int = 4096
    global_batch: int = 256
    checkpoint_every: int = 10           # paper: ~every 10 iterations (fast ckpt)
    keep_checkpoints: int = 3
    seed: int = 0


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Input shapes (assigned shape grid)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k":    ShapeSpec("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeSpec("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeSpec("long_500k",   524_288, 1,   "decode"),
}


def shape_applicable(model: ModelConfig, shape: ShapeSpec) -> bool:
    """Whether an (arch x shape) cell is runnable (see DESIGN.md section 7)."""
    if shape.name == "long_500k":
        return model.supports_long_context
    return True
