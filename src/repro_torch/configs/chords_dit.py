"""Paper-native denoiser configs — port of ``repro.configs.chords_dit``:
``chords-dit-xl`` (36 layers, d_model 3072, 24 heads of 128, d_ff 12288,
~5.45 B parameters) and its reduced ``chords-dit-micro``."""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    # Flux/HunyuanVideo-class latent transformer backbone (non-causal usage).
    return ModelConfig(
        name="chords-dit-xl",
        family="dense",
        num_layers=36,
        d_model=3072,
        num_heads=24,
        num_kv_heads=24,
        d_ff=12288,
        vocab_size=8,  # unused in denoiser role (embeds in/out)
        tie_embeddings=False,
        source="paper-native (Flux/Hunyuan-class DiT backbone)",
    )


def reduced() -> ModelConfig:
    return full().replace(
        name="chords-dit-micro",
        num_layers=4, d_model=128, num_heads=4, num_kv_heads=4, d_ff=512,
        param_dtype="float32", compute_dtype="float32",
    )


register("chords-dit-xl", full, reduced)
