"""Model API by config family — port of ``repro.models.api`` (the denoiser
trunks: dense and the zamba2 hybrid).

Every other family raises ``NotImplementedError`` naming its ROADMAP.md
item: MoE, xLSTM, enc-dec and the VLM are queue 1 item 13.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import dense, zamba2

_FAMILY = {"dense": dense, "hybrid": zamba2}
_NOT_PORTED = {
    "moe": "ROADMAP.md queue 1 item 13 (LM families)",
    "ssm": "ROADMAP.md queue 1 item 13 (LM families)",
    "encdec": "ROADMAP.md queue 1 item 13 (LM families)",
    "audio": "ROADMAP.md queue 1 item 13 (LM families)",
    "vlm": "ROADMAP.md queue 1 item 13 (LM families)",
}


def get_module(cfg: ModelConfig):
    if cfg.family in _FAMILY:
        return _FAMILY[cfg.family]
    where = _NOT_PORTED.get(cfg.family, "no ROADMAP.md item")
    raise NotImplementedError(
        f"model family {cfg.family!r} is not ported yet: {where}")


def model_specs(cfg: ModelConfig) -> dict:
    return get_module(cfg).specs(cfg)


def forward_hidden(params, cfg: ModelConfig, embeds, **kw):
    """Backbone as a denoiser trunk: embeds in, hidden out (non-causal for
    the dense trunk). The hybrid's recurrence is causal-only, so, as in the
    reference, it runs causally whatever ``causal`` the caller passes."""
    if cfg.family == "hybrid":
        kw["causal"] = True
    return get_module(cfg).forward_hidden(params, cfg, embeds, **kw)
