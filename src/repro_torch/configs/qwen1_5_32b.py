"""Qwen1.5-32B [hf:Qwen/Qwen1.5-32B] — dense, QKV bias, GQA kv=40 per assignment — port of
``repro.configs.qwen1_5_32b``."""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b",
        family="dense",
        num_layers=64,
        d_model=5120,
        num_heads=40,
        num_kv_heads=40,
        d_ff=27392,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        tie_embeddings=False,
        source="hf:Qwen/Qwen1.5-32B (assigned spec)",
    )


def reduced() -> ModelConfig:
    return full().replace(
        name="qwen1.5-32b-reduced",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=192,
        vocab_size=256, param_dtype="float32", compute_dtype="float32",
    )


register("qwen1.5-32b", full, reduced)
