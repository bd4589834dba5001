"""deepseek-v2-236b [moe] — 60L d_model=5120 128H vocab=102400.

MLA attention (kv_lora=512, q_lora=1536, rope 64 + nope 128, v 128); MoE
160 routed experts top-6 (d_ff_expert=1536) + 2 shared experts; first layer
dense (d_ff=12288). The MLA compressed cache (576/token) makes the 500k
decode cell feasible. [arXiv:2405.04434; hf]
"""
from repro_torch.common.config import (MLAConfig, ModelConfig, MoEConfig,
                                       ParallelConfig, RunConfig, TrainConfig)


def config() -> RunConfig:
    return RunConfig(
        model=ModelConfig(
            name="deepseek-v2-236b", family="moe",
            n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
            d_ff=12288, vocab_size=102_400,
            mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                          rope_head_dim=64, nope_head_dim=128, v_head_dim=128),
            moe=MoEConfig(num_experts=160, top_k=6, d_ff_expert=1536,
                          num_shared_experts=2, capacity_factor=1.0),
            first_k_dense=1, tie_embeddings=False,
            supports_long_context=True,
        ),
        parallel=ParallelConfig(remat="full", optimizer_state="adamw_factored",
                                microbatches=8,
                                grad_accum_dtype="bfloat16"),
        train=TrainConfig(),
    )


def smoke_config() -> RunConfig:
    return RunConfig(
        model=ModelConfig(
            name="deepseek-smoke", family="moe",
            n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
            d_ff=160, vocab_size=512,
            mla=MLAConfig(kv_lora_rank=32, q_lora_rank=48, rope_head_dim=8,
                          nope_head_dim=16, v_head_dim=16),
            moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=64,
                          num_shared_experts=1),
            first_k_dense=1, tie_embeddings=False, supports_long_context=True,
        ),
        parallel=ParallelConfig(remat="none"),
        train=TrainConfig(seq_len=32, global_batch=2),
    )
