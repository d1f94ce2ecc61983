"""Importing this package registers the port's configs: the denoisers
``chords-dit-xl`` and ``zamba2-2.7b``, and the LM configs of the dense,
VLM and MoE families (``qwen1.5-0.5b``, ``qwen1.5-32b``, ``gemma-7b``,
``internlm2-1.8b``, ``qwen2-vl-7b``, ``olmoe-1b-7b``, ``qwen2-moe-a2.7b``),
each with its reduced variant (``get_config(name, reduced=True)``)."""
from repro_torch.configs.base import (ModelConfig, get_config,  # noqa: F401
                                      list_archs)
from repro_torch.configs import (chords_dit, gemma_7b,  # noqa: F401
                                 internlm2_1_8b, olmoe_1b_7b, qwen1_5_0_5b,
                                 qwen1_5_32b, qwen2_moe_a2_7b, qwen2_vl_7b,
                                 zamba2_2_7b)
