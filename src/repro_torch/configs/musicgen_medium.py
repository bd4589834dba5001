"""musicgen-medium [audio] — 48L d_model=1536 24H (MHA kv=24) d_ff=6144 vocab=2048.

Decoder-only transformer over EnCodec audio tokens. Per the assignment the
EnCodec frontend is a STUB: ``input_specs()`` provides precomputed frame
embeddings (B, S, d_model) and next-frame token labels over the 2048-entry
codebook. [arXiv:2306.05284; hf]
"""
from repro_torch.common.config import ModelConfig, ParallelConfig, RunConfig, TrainConfig


def config() -> RunConfig:
    return RunConfig(
        model=ModelConfig(
            name="musicgen-medium", family="audio",
            n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, head_dim=64,
            d_ff=6144, vocab_size=2048,
            n_codebooks=4, tie_embeddings=False, act="gelu",
        ),
        parallel=ParallelConfig(remat="full", microbatches=4),
        train=TrainConfig(),
    )


def smoke_config() -> RunConfig:
    return RunConfig(
        model=ModelConfig(
            name="musicgen-smoke", family="audio",
            n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
            d_ff=128, vocab_size=128, n_codebooks=4, tie_embeddings=False,
            act="gelu",
        ),
        parallel=ParallelConfig(remat="none"),
        train=TrainConfig(seq_len=32, global_batch=2),
    )
