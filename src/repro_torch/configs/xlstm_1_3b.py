"""xLSTM-1.3B [arXiv:2405.04517; unverified] — port of
``repro.configs.xlstm_1_3b``: sLSTM + mLSTM blocks, 4 heads, d_ff=0.

48 blocks, 1 sLSTM per 8 blocks (rest mLSTM). Blocks carry their own
up/down projections (mLSTM: pre-up-projection x2, sLSTM: post-FFN 4/3),
hence d_ff=0.
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b",
        family="ssm",
        num_layers=48,
        d_model=2048,
        num_heads=4,
        num_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        slstm_every=8,
        mlstm_proj_factor=2.0,
        ssm_conv=4,
        ssm_chunk=256,
        tie_embeddings=True,
        source="arXiv:2405.04517 (unverified tier)",
    )


def reduced() -> ModelConfig:
    return full().replace(
        name="xlstm-1.3b-reduced",
        num_layers=4, d_model=64, num_heads=2, num_kv_heads=2,
        vocab_size=256, slstm_every=2, ssm_chunk=8,
        param_dtype="float32", compute_dtype="float32",
    )


register("xlstm-1.3b", full, reduced)
