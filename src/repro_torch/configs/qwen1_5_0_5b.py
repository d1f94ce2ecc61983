"""Qwen1.5-0.5B [hf:Qwen/Qwen1.5-0.5B] — dense, QKV bias, full MHA (kv=16) — port of
``repro.configs.qwen1_5_0_5b``."""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-0.5b",
        family="dense",
        num_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        d_ff=2816,
        vocab_size=151936,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        tie_embeddings=True,
        source="hf:Qwen/Qwen1.5-0.5B",
    )


def reduced() -> ModelConfig:
    return full().replace(
        name="qwen1.5-0.5b-reduced",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
        vocab_size=256, param_dtype="float32", compute_dtype="float32",
    )


register("qwen1.5-0.5b", full, reduced)
