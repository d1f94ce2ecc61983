"""Zamba2-2.7B [arXiv:2411.15242] — port of ``repro.configs.zamba2_2_7b``.

Hybrid: 54 Mamba2 (SSD) layers; one *shared* attention+MLP block is invoked
after every 6th layer (9 invocations of the same parameters), fed
concat(hidden, initial embedding) per the Zamba design. ssm_state=64.
As a denoiser trunk it runs causally (the recurrence is causal-only).
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b",
        family="hybrid",
        num_layers=54,
        d_model=2560,
        num_heads=32,
        num_kv_heads=32,
        d_ff=10240,
        vocab_size=32000,
        ssm_state=64,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_conv=4,
        ssm_chunk=256,
        attn_every=6,
        tie_embeddings=True,
        source="arXiv:2411.15242",
    )


def reduced() -> ModelConfig:
    return full().replace(
        name="zamba2-2.7b-reduced",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
        vocab_size=256, ssm_state=16, ssm_head_dim=16, ssm_chunk=8,
        attn_every=2, param_dtype="float32", compute_dtype="float32",
    )


register("zamba2-2.7b", full, reduced)
