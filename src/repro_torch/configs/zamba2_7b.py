"""zamba2-7b [hybrid] — 81 Mamba2 layers, d_model=3584, ssm_state=64,
plus a SHARED attention block (32H, d_ff=14336) applied every 6 layers.
O(1) recurrent state => runs the long_500k cell. [arXiv:2411.15242; unverified]
"""
from repro_torch.common.config import (ModelConfig, ParallelConfig, RunConfig,
                                 SSMConfig, TrainConfig)


def config() -> RunConfig:
    return RunConfig(
        model=ModelConfig(
            name="zamba2-7b", family="hybrid",
            n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=112,
            d_ff=14336, vocab_size=32_000,
            ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_width=4,
                          chunk_size=256),
            shared_attn_every=6, tie_embeddings=True,
            supports_long_context=True,
        ),
        parallel=ParallelConfig(remat="full", optimizer_state="adamw_factored", microbatches=8),
        train=TrainConfig(),
    )


def smoke_config() -> RunConfig:
    return RunConfig(
        model=ModelConfig(
            name="zamba2-smoke", family="hybrid",
            n_layers=7, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
            d_ff=128, vocab_size=256,
            ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, conv_width=4,
                          chunk_size=8),
            shared_attn_every=3, tie_embeddings=True,
            supports_long_context=True,
        ),
        parallel=ParallelConfig(remat="none"),
        train=TrainConfig(seq_len=32, global_batch=2),
    )
