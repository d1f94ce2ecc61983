"""Gemma-7B [arXiv:2403.08295] — GeGLU, head_dim=256, embeddings scaled by sqrt(d) — port of
``repro.configs.gemma_7b``."""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b",
        family="dense",
        num_layers=28,
        d_model=3072,
        num_heads=16,
        num_kv_heads=16,
        head_dim=256,
        d_ff=24576,
        vocab_size=256000,
        act="geglu",
        emb_scale=True,
        tie_embeddings=True,
        rope_theta=10_000.0,
        source="arXiv:2403.08295",
    )


def reduced() -> ModelConfig:
    return full().replace(
        name="gemma-7b-reduced",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=32,
        d_ff=192, vocab_size=256, param_dtype="float32", compute_dtype="float32",
    )


register("gemma-7b", full, reduced)
