"""Core layers (``repro.models.layers``), functional: params are plain dicts of tensors.

Every weight matmul routes through the precision policy (``repro_torch.core.policy``):
the same model runs natively or at FP64-equivalent accuracy on the Ozaki-II int8
path by flipping ``ModelConfig.policy_name``.  Initialisers draw from an explicit
``torch.Generator`` and make their tensors on its device.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.policy import Policy


def _uniform(gen: torch.Generator, shape, lo: float, hi: float, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=gen.device).uniform_(lo, hi, generator=gen)


# ---------------------------------------------------------------------------
# Dense
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype) -> Dict:
    scale = 1.0 / math.sqrt(d_in)
    return {"w": _uniform(gen, (d_in, d_out), -scale, scale, dtype)}


def dense_apply(params: Dict, x: torch.Tensor, policy: Policy) -> torch.Tensor:
    return policy.dot(x, params["w"].to(x.dtype))


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype, device) -> Dict:
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


def rmsnorm_apply(params: Dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + params["scale"].float())).to(dt)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeGLU gated, or squared ReLU)
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, dtype, act: str = "swiglu") -> Dict:
    p = {"wi_up": dense_init(gen, d_model, d_ff, dtype),
         "wo": dense_init(gen, d_ff, d_model, dtype)}
    if act in ("swiglu", "geglu"):
        p["wi_gate"] = dense_init(gen, d_model, d_ff, dtype)
    return p


def mlp_apply(params: Dict, x: torch.Tensor, policy: Policy, act: str = "swiglu") -> torch.Tensor:
    up = dense_apply(params["wi_up"], x, policy)
    if act == "swiglu":
        h = F.silu(dense_apply(params["wi_gate"], x, policy)) * up
    elif act == "geglu":
        h = F.gelu(dense_apply(params["wi_gate"], x, policy), approximate="tanh") * up
    elif act == "relu2":        # minitron/nemotron squared-ReLU, non-gated
        h = torch.square(F.relu(up))
    else:
        raise ValueError(act)
    return dense_apply(params["wo"], h, policy)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------

def embed_init(gen: torch.Generator, vocab: int, d: int, dtype) -> Dict:
    table = torch.empty((vocab, d), dtype=dtype, device=gen.device).normal_(generator=gen)
    return {"table": table * 0.02}


def embed_apply(params: Dict, tokens: torch.Tensor, compute_dtype) -> torch.Tensor:
    return params["table"].to(compute_dtype)[tokens]


def unembed_apply(params: Dict, x: torch.Tensor, policy: Policy) -> torch.Tensor:
    """Logits = x @ table^T (tied) — float32 output for a stable softmax."""
    return policy.dot(x, params["table"].to(x.dtype).T).float()


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_angles(positions: torch.Tensor, head_dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (..., S) -> (sin, cos) of shape (..., S, head_dim // 2), float32."""
    half = head_dim // 2
    inv_freq = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                             device=positions.device) / half))
    ang = positions.float()[..., None] * inv_freq
    return torch.sin(ang), torch.cos(ang)


def mrope_positions(positions3: torch.Tensor, sections: Tuple[int, int, int]) -> torch.Tensor:
    """positions3 (B, 3, S) -> float32 (B, S, sum(sections)): frequency j takes
    the position of the stream that owns it, the first ``sections[0]``
    frequencies stream t, the next ``sections[1]`` stream h, the rest stream w."""
    dev = positions3.device
    sec_id = torch.repeat_interleave(torch.arange(3, device=dev),
                                     torch.tensor(sections, device=dev))   # (half,) owner
    return positions3.float()[:, sec_id, :].transpose(1, 2)


def mrope_angles(positions3: torch.Tensor, head_dim: int, theta: float,
                 sections: Tuple[int, int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Qwen2-VL M-RoPE: three position streams (t, h, w) own disjoint frequency
    sections of the rotary half-space.  positions3 (B, 3, S) -> (sin, cos) of
    shape (B, S, head_dim // 2), float32."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to {half}")
    inv_freq = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                             device=positions3.device) / half))
    ang = mrope_positions(positions3, sections) * inv_freq                # (B, S, half)
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); sin/cos: (B, S, D//2) or (S, D//2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if sin.ndim == 2:
        sin = sin[None]
        cos = cos[None]
    s = sin[:, :, None, :].to(x.dtype)
    c = cos[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0:
        return cap * torch.tanh(logits / cap)
    return logits
