"""Model config and registry — port of ``repro.configs.base`` (the fields
the ported families read, with the same names and defaults)."""
from __future__ import annotations

import dataclasses
from typing import Callable


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | encdec | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    qkv_bias: bool = False
    act: str = "swiglu"  # swiglu | geglu
    rope_theta: float = 10_000.0
    mrope_sections: tuple = ()  # qwen2-vl M-RoPE (t,h,w) sections of head_dim/2
    emb_scale: bool = False  # gemma: scale embeddings by sqrt(d_model)
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    # MoE
    num_experts: int = 0
    experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_capacity_factor: float = 1.25
    # SSM (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256
    attn_every: int = 0  # zamba2: shared attention block cadence
    # modality frontend stub (vlm): accepts precomputed embeddings
    embeds_input: bool = False
    # numerics: backbone weights are stored in param_dtype (see
    # diffusion.wrapper.init_wrapper), activations run in compute_dtype
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # kernels: route rmsnorm / attention / the SSD chunk block through
    # repro_torch.kernels — the CUDA kernels for CUDA tensors, their plain
    # versions on the CPU (bitwise-neutral there). False -> plain PyTorch
    # everywhere.
    use_kernels: bool = False
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def q_groups(self) -> int:
        return self.num_heads // max(1, self.num_kv_heads)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}
_REDUCED: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str, full: Callable[[], ModelConfig],
             reduced: Callable[[], ModelConfig]):
    _REGISTRY[name] = full
    _REDUCED[name] = reduced


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    table = _REDUCED if reduced else _REGISTRY
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(table)} "
                       f"(xlstm-1.3b and seamless-m4t-medium are not ported "
                       f"yet: ROADMAP.md queue 1 item 13)")
    return table[name]()


def list_archs() -> list[str]:
    return sorted(_REGISTRY)
