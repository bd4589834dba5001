"""gemma2-2b [dense] — 26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000.

Local+global alternating attention (4096-token sliding window on even
layers), attention/final logit softcaps, sandwich norms, scaled embeddings.
[arXiv:2408.00118; hf]
"""
from repro_torch.common.config import ModelConfig, ParallelConfig, RunConfig, TrainConfig


def config() -> RunConfig:
    return RunConfig(
        model=ModelConfig(
            name="gemma2-2b", family="dense",
            n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, head_dim=256,
            d_ff=9216, vocab_size=256_000,
            sliding_window=4096, local_global_alternating=True,
            attn_logit_softcap=50.0, final_logit_softcap=30.0,
            post_block_norm=True, embed_scale=True, tie_embeddings=True,
            act="gelu", rope_theta=10_000.0,
            supports_long_context=True,  # local layers are windowed
        ),
        parallel=ParallelConfig(remat="full", microbatches=2),
        train=TrainConfig(),
    )


def smoke_config() -> RunConfig:
    return RunConfig(
        model=ModelConfig(
            name="gemma2-smoke", family="dense",
            n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab_size=512,
            sliding_window=16, local_global_alternating=True,
            attn_logit_softcap=50.0, final_logit_softcap=30.0,
            post_block_norm=True, embed_scale=True, tie_embeddings=True,
            act="gelu", supports_long_context=True,
        ),
        parallel=ParallelConfig(remat="none"),
        train=TrainConfig(seq_len=32, global_batch=2),
    )
