"""Importing this package registers the port's configs: the denoisers
``chords-dit-xl`` and ``zamba2-2.7b``, and the LM configs of every family
the reference serves — dense, VLM and MoE (``qwen1.5-0.5b``,
``qwen1.5-32b``, ``gemma-7b``, ``internlm2-1.8b``, ``qwen2-vl-7b``,
``olmoe-1b-7b``, ``qwen2-moe-a2.7b``), the hybrid (``zamba2-2.7b``),
xLSTM (``xlstm-1.3b``) and enc-dec (``seamless-m4t-medium``) — each with
its reduced variant (``get_config(name, reduced=True)``) — and the
reference's input-shape cells (``SHAPES``, ``shape_applicable``)."""
from repro_torch.configs.base import (DECODE_32K, LONG_500K,  # noqa: F401
                                      PREFILL_32K, SHAPES,
                                      SUB_QUADRATIC_FAMILIES, TRAIN_4K,
                                      ModelConfig, ShapeConfig, get_config,
                                      list_archs, shape_applicable)
from repro_torch.configs import (chords_dit, gemma_7b,  # noqa: F401
                                 internlm2_1_8b, olmoe_1b_7b, qwen1_5_0_5b,
                                 qwen1_5_32b, qwen2_moe_a2_7b, qwen2_vl_7b,
                                 seamless_m4t_medium, xlstm_1_3b,
                                 zamba2_2_7b)

# the LM configs the reference serves (``repro.configs.ASSIGNED_ARCHS``)
ASSIGNED_ARCHS = (
    "qwen1.5-0.5b",
    "qwen1.5-32b",
    "gemma-7b",
    "internlm2-1.8b",
    "zamba2-2.7b",
    "xlstm-1.3b",
    "seamless-m4t-medium",
    "qwen2-moe-a2.7b",
    "olmoe-1b-7b",
    "qwen2-vl-7b",
)
