"""stablelm-12b [dense] — 40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352.

StableLM-2 architecture (per-head qk layernorm). [hf:stabilityai/stablelm-2-12b; hf]
"""
from repro_torch.common.config import ModelConfig, ParallelConfig, RunConfig, TrainConfig


def config() -> RunConfig:
    return RunConfig(
        model=ModelConfig(
            name="stablelm-12b", family="dense",
            n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=160,
            d_ff=13824, vocab_size=100_352,
            qk_norm=True, tie_embeddings=False,
        ),
        parallel=ParallelConfig(remat="full", optimizer_state="adamw_factored", microbatches=8),
        train=TrainConfig(),
    )


def smoke_config() -> RunConfig:
    return RunConfig(
        model=ModelConfig(
            name="stablelm-smoke", family="dense",
            n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab_size=512, qk_norm=True, tie_embeddings=False,
        ),
        parallel=ParallelConfig(remat="none"),
        train=TrainConfig(seq_len=32, global_batch=2),
    )
