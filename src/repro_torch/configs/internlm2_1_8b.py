"""InternLM2-1.8B [arXiv:2403.17297] — dense, GQA kv=8 — port of
``repro.configs.internlm2_1_8b``."""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="internlm2-1.8b",
        family="dense",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=8,
        d_ff=8192,
        vocab_size=92544,
        rope_theta=1_000_000.0,
        tie_embeddings=False,
        source="arXiv:2403.17297",
    )


def reduced() -> ModelConfig:
    return full().replace(
        name="internlm2-1.8b-reduced",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=192,
        vocab_size=256, param_dtype="float32", compute_dtype="float32",
    )


register("internlm2-1.8b", full, reduced)
