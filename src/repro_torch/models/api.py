"""Model API by config family — port of ``repro.models.api`` (dense only).

Every other family raises ``NotImplementedError`` naming its ROADMAP.md
item: the hybrid (zamba2/mamba2, with the ``ssd_chunk`` kernel) is queue 1
item 12; MoE, xLSTM, enc-dec and the VLM are queue 1 item 13.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import dense

_NOT_PORTED = {
    "hybrid": "ROADMAP.md queue 1 item 12 (hybrid backbone, ssd_chunk)",
    "moe": "ROADMAP.md queue 1 item 13 (LM families)",
    "ssm": "ROADMAP.md queue 1 item 13 (LM families)",
    "encdec": "ROADMAP.md queue 1 item 13 (LM families)",
    "audio": "ROADMAP.md queue 1 item 13 (LM families)",
    "vlm": "ROADMAP.md queue 1 item 13 (LM families)",
}


def get_module(cfg: ModelConfig):
    if cfg.family == "dense":
        return dense
    where = _NOT_PORTED.get(cfg.family, "no ROADMAP.md item")
    raise NotImplementedError(
        f"model family {cfg.family!r} is not ported yet: {where}")


def model_specs(cfg: ModelConfig) -> dict:
    return get_module(cfg).specs(cfg)


def forward_hidden(params, cfg: ModelConfig, embeds, **kw):
    """Backbone as a denoiser trunk: embeds in, hidden out (non-causal)."""
    return get_module(cfg).forward_hidden(params, cfg, embeds, **kw)
