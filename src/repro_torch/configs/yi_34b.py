"""yi-34b [dense] — 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.

Llama-architecture GQA decoder. [arXiv:2403.04652; hf]
"""
from repro_torch.common.config import ModelConfig, ParallelConfig, RunConfig, TrainConfig


def config() -> RunConfig:
    return RunConfig(
        model=ModelConfig(
            name="yi-34b", family="dense",
            n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
            d_ff=20480, vocab_size=64_000,
            tie_embeddings=False, rope_theta=5_000_000.0,
        ),
        parallel=ParallelConfig(remat="full", optimizer_state="adamw_factored", microbatches=8),
        train=TrainConfig(),
    )


def smoke_config() -> RunConfig:
    return RunConfig(
        model=ModelConfig(
            name="yi-smoke", family="dense",
            n_layers=3, d_model=96, n_heads=6, n_kv_heads=2, head_dim=16,
            d_ff=256, vocab_size=512, tie_embeddings=False,
        ),
        parallel=ParallelConfig(remat="none"),
        train=TrainConfig(seq_len=32, global_batch=2),
    )
