"""llama-3.2-vision-11b [vlm] — 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256, cross-attention image layers every 5th layer (3,8,...,38).

The vision tower is a STUB per the assignment: ``input_specs()`` provides
precomputed patch embeddings (B, 6404, 1280) = 4 tiles x 1601 CLIP patches.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]
"""
from repro_torch.common.config import ModelConfig, ParallelConfig, RunConfig, TrainConfig


def config() -> RunConfig:
    return RunConfig(
        model=ModelConfig(
            name="llama-3.2-vision-11b", family="vlm",
            n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
            d_ff=14336, vocab_size=128_256,
            cross_attn_every=5, vision_d_model=1280, vision_seq_len=6404,
            tie_embeddings=False, rope_theta=500_000.0,
        ),
        parallel=ParallelConfig(remat="full", optimizer_state="adamw_factored", microbatches=8),
        train=TrainConfig(),
    )


def smoke_config() -> RunConfig:
    return RunConfig(
        model=ModelConfig(
            name="llama-vision-smoke", family="vlm",
            n_layers=5, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab_size=512,
            cross_attn_every=5, vision_d_model=48, vision_seq_len=12,
            tie_embeddings=False,
        ),
        parallel=ParallelConfig(remat="none"),
        train=TrainConfig(seq_len=32, global_batch=2),
    )
