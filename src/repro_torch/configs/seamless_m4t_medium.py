"""SeamlessM4T-medium [arXiv:2308.11596] — port of
``repro.configs.seamless_m4t_medium``: enc-dec, multimodal (audio frontend
stub).

12 encoder + 12 decoder layers. The speech frontend is a stub: the caller
provides precomputed frame embeddings (source length = seq_len //
src_ratio).
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium",
        family="encdec",
        num_layers=24,  # total; enc_layers/dec_layers below
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        d_ff=4096,
        vocab_size=256206,
        enc_layers=12,
        dec_layers=12,
        src_ratio=8,
        embeds_input=True,
        tie_embeddings=True,
        source="arXiv:2308.11596",
    )


def reduced() -> ModelConfig:
    return full().replace(
        name="seamless-m4t-medium-reduced",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
        vocab_size=256, enc_layers=2, dec_layers=2, src_ratio=4,
        param_dtype="float32", compute_dtype="float32",
    )


register("seamless-m4t-medium", full, reduced)
