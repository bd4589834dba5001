"""arctic-480b [moe] — 35L d_model=7168 56H (GQA kv=8) vocab=32000,
MoE 128 experts top-2 (d_ff_expert=4864) + parallel dense residual MLP
(d_ff=4864). Dense-MoE hybrid. [hf:Snowflake/snowflake-arctic-base; hf]
"""
from repro_torch.common.config import (ModelConfig, MoEConfig, ParallelConfig,
                                       RunConfig, TrainConfig)


def config() -> RunConfig:
    return RunConfig(
        model=ModelConfig(
            name="arctic-480b", family="moe",
            n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
            d_ff=4864, vocab_size=32_000,
            moe=MoEConfig(num_experts=128, top_k=2, d_ff_expert=4864,
                          dense_residual_d_ff=4864, capacity_factor=1.25),
            tie_embeddings=False,
        ),
        parallel=ParallelConfig(remat="full", optimizer_state="adamw_factored",
                                microbatches=8,
                                grad_accum_dtype="bfloat16"),
        train=TrainConfig(),
    )


def smoke_config() -> RunConfig:
    return RunConfig(
        model=ModelConfig(
            name="arctic-smoke", family="moe",
            n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=96, vocab_size=512,
            moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=96,
                          dense_residual_d_ff=96),
            tie_embeddings=False,
        ),
        parallel=ParallelConfig(remat="none"),
        train=TrainConfig(seq_len=32, global_batch=2),
    )
