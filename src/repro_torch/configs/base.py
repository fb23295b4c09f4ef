"""Model / run configuration schema (``repro.configs.base``).

A ``ModelConfig`` fully determines an architecture.  Each arch module exports
``CONFIG`` (the published widths) and ``SMOKE_CONFIG`` (a reduced config of the
same family for CPU tests).

Layer topology is a repeating ``pattern`` of ``BlockCfg`` entries (mixer kind +
MLP kind + attention window): ``num_layers // period`` periods plus a tail of
the pattern's first ``num_layers % period`` blocks.  Dtype names map to torch
dtypes.  The reference's fields that only training or the unported layers read
(remat, the SSM and xLSTM chunks, encoder frames, frontends, M-RoPE sections,
MoE routing knobs) come with the slice that reads them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class MoECfg:
    num_experts: int
    top_k: int
    d_expert: int
    num_shared: int = 0


@dataclasses.dataclass(frozen=True)
class BlockCfg:
    """One layer's shape: mixer + MLP.

    mixer:  attn | mamba | mlstm | slstm
    mlp:    dense | moe | none
    window: 0 = global attention; >0 = sliding-window size (attn mixers only)
    """
    mixer: str = "attn"
    mlp: str = "dense"
    window: int = 0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # decoder | encdec
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    pattern: Tuple[BlockCfg, ...] = (BlockCfg(),)
    mlp_act: str = "swiglu"          # swiglu | geglu (gated; d_ff = hidden width) | relu2
    rope_theta: float = 10_000.0
    rope_type: str = "standard"      # standard | mrope | none
    moe: Optional[MoECfg] = None
    # SSM / xLSTM
    ssm_state_dim: int = 16
    ssm_expand: int = 2
    # encoder-decoder
    encoder_layers: int = 0
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    policy_name: str = "bf16"        # precision policy for weight matmuls
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    attn_chunk: int = 1024           # flash-style q-block size (0 = unchunked)

    @property
    def period(self) -> int:
        return len(self.pattern)

    @property
    def num_periods(self) -> int:
        return self.num_layers // self.period

    @property
    def tail_blocks(self) -> Tuple[BlockCfg, ...]:
        rem = self.num_layers % self.period
        return self.pattern[:rem]

    def block_at(self, layer: int) -> BlockCfg:
        return self.pattern[layer % self.period]

    @property
    def compute_torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    @property
    def param_torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def d_inner(self) -> int:
        """SSM/xLSTM inner width."""
        return self.ssm_expand * self.d_model

    def param_count(self) -> int:
        """Approximate total parameter count (embedding + blocks), for 6ND."""
        d, v = self.d_model, self.vocab_size
        total = v * d * (1 if self.tie_embeddings else 2)
        for i in range(self.num_layers):
            b = self.block_at(i)
            if b.mixer == "attn":
                total += d * (self.num_heads * self.head_dim) * 2  # q, o
                total += d * (self.num_kv_heads * self.head_dim) * 2  # k, v
            elif b.mixer == "mamba":
                di = self.d_inner
                total += d * di * 3 + di * self.ssm_state_dim * 2 + di * d
            elif b.mixer in ("mlstm", "slstm"):
                di = self.d_inner
                total += d * di * 4 + di * d
            if b.mlp == "dense" and self.d_ff > 0:
                total += 3 * d * self.d_ff
            elif b.mlp == "moe" and self.moe is not None:
                m = self.moe
                total += d * m.num_experts  # router
                total += (m.num_experts + m.num_shared) * 3 * d * m.d_expert
        if self.family == "encdec":
            enc = self.encoder_layers * (
                d * (self.num_heads * self.head_dim) * 2
                + d * (self.num_kv_heads * self.head_dim) * 2 + 3 * d * self.d_ff)
            cross = self.num_layers * (
                d * (self.num_heads * self.head_dim) * 2
                + d * (self.num_kv_heads * self.head_dim) * 2)
            total += enc + cross
        return total


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", 4_096, 256, "train"),
    ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    ShapeSpec("decode_32k", 32_768, 128, "decode"),
    ShapeSpec("long_500k", 524_288, 1, "decode"),
)
