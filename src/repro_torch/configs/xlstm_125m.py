"""xlstm-125m [ssm] — 12L d_model=768 4H d_ff=0 vocab=50304.

sLSTM + mLSTM blocks (3:1 mLSTM:sLSTM pattern); no separate FFN (d_ff=0),
expansion lives inside the mLSTM block. Recurrent state => O(1) decode,
runs the long_500k cell. [arXiv:2405.04517; unverified]
"""
from repro_torch.common.config import ModelConfig, ParallelConfig, RunConfig, TrainConfig


def config() -> RunConfig:
    return RunConfig(
        model=ModelConfig(
            name="xlstm-125m", family="ssm",
            n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
            d_ff=0, vocab_size=50_304,
            block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
            tie_embeddings=True, supports_long_context=True,
        ),
        parallel=ParallelConfig(remat="full", microbatches=2),
        train=TrainConfig(),
    )


def smoke_config() -> RunConfig:
    return RunConfig(
        model=ModelConfig(
            name="xlstm-smoke", family="ssm",
            n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
            d_ff=0, vocab_size=256,
            block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
            tie_embeddings=True, supports_long_context=True,
        ),
        parallel=ParallelConfig(remat="none"),
        train=TrainConfig(seq_len=32, global_batch=2),
    )
