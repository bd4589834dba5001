"""smollm-135m [dense] — 30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152.

Llama-architecture small model. [hf:HuggingFaceTB/SmolLM-135M; hf]
"""
from repro_torch.common.config import ModelConfig, ParallelConfig, RunConfig, TrainConfig


def config() -> RunConfig:
    return RunConfig(
        model=ModelConfig(
            name="smollm-135m", family="dense",
            n_layers=30, d_model=576, n_heads=9, n_kv_heads=3, head_dim=64,
            d_ff=1536, vocab_size=49_152, tie_embeddings=True,
        ),
        parallel=ParallelConfig(remat="full", microbatches=2),
        train=TrainConfig(),
    )


def smoke_config() -> RunConfig:
    return RunConfig(
        model=ModelConfig(
            name="smollm-smoke", family="dense",
            n_layers=4, d_model=72, n_heads=3, n_kv_heads=3, head_dim=24,
            d_ff=128, vocab_size=512, tie_embeddings=True,
        ),
        parallel=ParallelConfig(remat="none"),
        train=TrainConfig(seq_len=32, global_batch=2),
    )
