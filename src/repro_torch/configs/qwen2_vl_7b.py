"""Qwen2-VL-7B [arXiv:2409.12191] — M-RoPE, GQA kv=4; vision frontend stub.

Port of ``repro.configs.qwen2_vl_7b``. Backbone only, as in the reference:
the ViT patch frontend is a stub; ``prefill(..., embeds=)`` takes
precomputed patch embeddings, and text-only positions are M-RoPE ids with
three equal (t, h, w) rows.
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b",
        family="vlm",
        num_layers=28,
        d_model=3584,
        num_heads=28,
        num_kv_heads=4,
        d_ff=18944,
        vocab_size=152064,
        qkv_bias=True,
        mrope_sections=(16, 24, 24),  # sums to head_dim/2 = 64
        rope_theta=1_000_000.0,
        embeds_input=True,
        tie_embeddings=False,
        source="arXiv:2409.12191",
    )


def reduced() -> ModelConfig:
    return full().replace(
        name="qwen2-vl-7b-reduced",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=192,
        vocab_size=256, mrope_sections=(4, 2, 2),  # head_dim/2 = 8
        param_dtype="float32", compute_dtype="float32",
    )


register("qwen2-vl-7b", full, reduced)
