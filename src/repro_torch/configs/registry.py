"""Architecture registry: ``--arch <id>`` resolution.

Only the archs the port can build are registered (yi-6b: a decoder of attention
mixers and dense MLPs).  The reference's other nine configs need MoE, SSM,
encoder-decoder or M-RoPE layers, which are ROADMAP slice 8.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig

ARCHS: Dict[str, str] = {
    "yi-6b": "repro_torch.configs.yi_6b",
}


def get_config(arch: str, smoke: bool = False, **overrides) -> ModelConfig:
    """The arch's published config (or its reduced smoke config), with fields
    replaced by ``overrides``."""
    if arch not in ARCHS:
        raise ValueError(f"unknown arch {arch!r}; the port builds {list(ARCHS)}")
    mod = importlib.import_module(ARCHS[arch])
    cfg = mod.SMOKE_CONFIG if smoke else mod.CONFIG
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def list_archs() -> List[str]:
    return list(ARCHS)
