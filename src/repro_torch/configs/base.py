"""Model config, input-shape cells and the registry — port of
``repro.configs.base`` (the fields the ported families read, with the same
names and defaults). Shape cells follow the reference:

  train_4k     seq_len=4096    global_batch=256   (train_step)
  prefill_32k  seq_len=32768   global_batch=32    (prefill)
  decode_32k   seq_len=32768   global_batch=128   (serve_step, 1 new token)
  long_500k    seq_len=524288  global_batch=1     (serve_step; SSM/hybrid only)
"""
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
    # xLSTM
    slstm_every: int = 0  # 1 sLSTM block per this many blocks (rest mLSTM)
    mlstm_proj_factor: float = 2.0
    # enc-dec (seamless)
    enc_layers: int = 0
    dec_layers: int = 0
    src_ratio: int = 8  # encoder source length = seq_len // src_ratio
    # modality frontend stub (vlm / audio): accepts precomputed embeddings
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


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode
    sub_quadratic_required: bool = False


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode",
                        sub_quadratic_required=True)

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}

# Families that support 500k context (sub-quadratic sequence mixing).
SUB_QUADRATIC_FAMILIES = ("ssm", "hybrid")


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether a (arch, shape) cell runs; reason string if skipped."""
    if shape.sub_quadratic_required and \
            cfg.family not in SUB_QUADRATIC_FAMILIES:
        return False, (
            f"{cfg.name} is full-attention; long_500k requires sub-quadratic "
            "sequence mixing (see DESIGN.md §Arch-applicability)"
        )
    return True, ""


_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}
_REDUCED: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str, full: Callable[[], ModelConfig],
             reduced: Callable[[], ModelConfig]):
    _REGISTRY[name] = full
    _REDUCED[name] = reduced


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    table = _REDUCED if reduced else _REGISTRY
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(table)}")
    return table[name]()


def list_archs() -> list[str]:
    return sorted(_REGISTRY)
