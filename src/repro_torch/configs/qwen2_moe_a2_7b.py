"""Qwen2-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B] — 60 routed experts top-4 + 4 shared — port of
``repro.configs.qwen2_moe_a2_7b``."""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=1408,  # per-expert intermediate
        vocab_size=151936,
        qkv_bias=True,
        num_experts=60,
        experts_per_tok=4,
        num_shared_experts=4,
        rope_theta=1_000_000.0,
        tie_embeddings=False,
        source="hf:Qwen/Qwen1.5-MoE-A2.7B",
    )


def reduced() -> ModelConfig:
    return full().replace(
        name="qwen2-moe-a2.7b-reduced",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=64,
        vocab_size=256, num_experts=8, experts_per_tok=2, num_shared_experts=2,
        param_dtype="float32", compute_dtype="float32",
    )


register("qwen2-moe-a2.7b", full, reduced)
