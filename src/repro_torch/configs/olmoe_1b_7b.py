"""OLMoE-1B-7B [arXiv:2409.02060] — 64 routed experts top-8, no shared experts — port of
``repro.configs.olmoe_1b_7b``."""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b",
        family="moe",
        num_layers=16,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=1024,  # per-expert intermediate
        vocab_size=50304,
        num_experts=64,
        experts_per_tok=8,
        num_shared_experts=0,
        rope_theta=10_000.0,
        tie_embeddings=False,
        source="arXiv:2409.02060",
    )


def reduced() -> ModelConfig:
    return full().replace(
        name="olmoe-1b-7b-reduced",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=64,
        vocab_size=256, num_experts=8, experts_per_tok=2,
        param_dtype="float32", compute_dtype="float32",
    )


register("olmoe-1b-7b", full, reduced)
