"""Config registry: the 10 assigned architectures + input shapes.

``get_config(name)`` returns the full published-size config;
``get_config(name, reduced=True)`` the smoke-test variant (2 scan blocks,
d_model <= 512, <= 4 experts) used by per-arch CPU smoke tests."""

from __future__ import annotations

from typing import Dict

from repro_torch.configs import base
from repro_torch.configs.base import (DECODE_32K, LONG_500K, PREFILL_32K, SHAPES,
                                TRAIN_4K, InputShape, ModelConfig, reduced)
from repro_torch.configs.arctic_480b import CONFIG as ARCTIC_480B
from repro_torch.configs.deepseek_67b import CONFIG as DEEPSEEK_67B
from repro_torch.configs.granite_34b import CONFIG as GRANITE_34B
from repro_torch.configs.granite_moe_3b import CONFIG as GRANITE_MOE_3B
from repro_torch.configs.internvl2_1b import CONFIG as INTERNVL2_1B
from repro_torch.configs.jamba_1_5_large_398b import CONFIG as JAMBA_1_5_LARGE
from repro_torch.configs.mamba2_370m import CONFIG as MAMBA2_370M
from repro_torch.configs.mistral_large_123b import CONFIG as MISTRAL_LARGE_123B
from repro_torch.configs.qwen2_5_32b import CONFIG as QWEN2_5_32B
from repro_torch.configs.whisper_base import CONFIG as WHISPER_BASE

ARCHS: Dict[str, ModelConfig] = {c.name: c for c in (
    MISTRAL_LARGE_123B, WHISPER_BASE, MAMBA2_370M, INTERNVL2_1B, DEEPSEEK_67B,
    GRANITE_34B, GRANITE_MOE_3B, QWEN2_5_32B, JAMBA_1_5_LARGE, ARCTIC_480B,
)}

# per-arch smoke-variant overrides (keep patterns but shrink periods)
REDUCED_OVERRIDES = {
    "jamba-1.5-large-398b": dict(attn_every=2, moe_every=2, scan_block=2,
                                 n_layers=4),
}


def get_config(name: str, reduced_variant: bool = False) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; choose from {sorted(ARCHS)}")
    cfg = ARCHS[name]
    if reduced_variant:
        return reduced(cfg, **REDUCED_OVERRIDES.get(name, {}))
    return cfg


__all__ = ["ARCHS", "SHAPES", "ModelConfig", "InputShape", "get_config",
           "reduced", "TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K",
           "base"]
