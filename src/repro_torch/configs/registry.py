"""Architecture registry (``repro.configs.registry``): ``--arch <id>``
resolution and the (arch x shape) cells.

All ten of the reference's archs are registered, in its order: the
encoder-decoder whisper-medium (its audio frontend a stub: frame embeddings
are an input), qwen2-vl-72b (M-RoPE; its vision frontend a stub: patch
embeddings and the three position streams are inputs), the decoders of
attention mixers with dense MLPs (minitron-4b, yi-6b, gemma-7b, gemma3-4b) or
MoE MLPs (deepseek-moe-16b, llama4-scout-17b-a16e), and of the recurrent
mixers (jamba-1.5-large-398b, Mamba and attention with MoE; xlstm-350m, mLSTM
and sLSTM).

``runnable_cells()`` applies the reference's skip rule: long_500k needs
sub-quadratic sequence mixing (gemma3-4b, jamba-1.5-large-398b, xlstm-350m).
The dry-run's input specs are not ported: their torch purpose belongs to
``launch/`` (ROADMAP slice 10).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeSpec

ARCHS: Dict[str, str] = {
    "whisper-medium": "repro_torch.configs.whisper_medium",
    "qwen2-vl-72b": "repro_torch.configs.qwen2_vl_72b",
    "minitron-4b": "repro_torch.configs.minitron_4b",
    "yi-6b": "repro_torch.configs.yi_6b",
    "gemma-7b": "repro_torch.configs.gemma_7b",
    "gemma3-4b": "repro_torch.configs.gemma3_4b",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1_5_large",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout",
    "xlstm-350m": "repro_torch.configs.xlstm_350m",
}

# Archs whose sequence mixing is sub-quadratic (SSM / hybrid / sliding-window
# majority) — the only ones that run the long_500k cell.
SUBQUADRATIC = ("gemma3-4b", "jamba-1.5-large-398b", "xlstm-350m")


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


def cell_is_runnable(arch: str, shape: ShapeSpec) -> Tuple[bool, str]:
    if shape.name == "long_500k" and arch not in SUBQUADRATIC:
        return False, "long_500k skipped: pure full-attention arch"
    return True, ""


def runnable_cells() -> List[Tuple[str, ShapeSpec]]:
    return [(arch, shape) for arch in ARCHS for shape in SHAPES
            if cell_is_runnable(arch, shape)[0]]


def concrete_batch(cfg: ModelConfig, shape: ShapeSpec, batch: int, seq: Optional[int] = None,
                   seed: int = 0, device="cuda") -> Dict[str, torch.Tensor]:
    """A small concrete batch for a reduced config, made from a numpy seed in
    the reference's order, on ``device``: tokens (batch, seq) int64, or for the
    vision frontend the stub's patch embeddings ``embeds`` (batch, seq,
    d_model) in bfloat16 and M-RoPE ``positions`` (batch, 3, seq) with the
    three streams equal; for the encoder-decoder family the stub's frame
    embeddings ``enc_embeds`` (batch, encoder_seq, d_model) in bfloat16; and
    labels (batch, seq) int64."""
    rng = np.random.default_rng(seed)
    S = seq or min(shape.seq_len, 32)
    out: Dict[str, torch.Tensor] = {}
    if cfg.frontend == "vision":
        out["embeds"] = _bfloat16(rng.standard_normal((batch, S, cfg.d_model)), device)
        out["positions"] = convert.from_numpy(
            np.broadcast_to(np.arange(S, dtype=np.int32), (batch, 3, S)), device)
    else:
        out["tokens"] = convert.from_numpy(rng.integers(0, cfg.vocab_size, (batch, S)), device)
    if cfg.family == "encdec":
        out["enc_embeds"] = _bfloat16(
            rng.standard_normal((batch, cfg.encoder_seq, cfg.d_model)), device)
    out["labels"] = convert.from_numpy(rng.integers(0, cfg.vocab_size, (batch, S)), device)
    return out


def _bfloat16(x: np.ndarray, device) -> torch.Tensor:
    """float64 -> bfloat16 on the host, rounded as ``jnp.asarray(x, jnp.bfloat16)``
    rounds it (through float32, each step to nearest even), then to ``device``."""
    return convert.from_numpy(x, "cpu").to(torch.bfloat16).to(convert.resolve_device(device))
