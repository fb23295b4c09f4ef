"""GQA attention with sliding windows and ring-buffer KV caches (``repro.models.attention``).

Shapes: activations (B, S, d_model); q (B, S, H, D); k/v (B, S, Hkv, D).  GQA
groups H // Hkv query heads per KV head.  Sliding-window layers keep a cache of
only ``window`` positions (ring buffer).  Under an emulated policy the whole
score path goes through the dispatch seam's ``attention`` kind: the fused
Hopper kernel on the card, its bitwise-equal reference elsewhere.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import dispatch
from repro_torch.core.policy import Policy
from repro_torch.models import layers

NEG_INF = -1e30


def attn_init(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    d, dt = cfg.d_model, cfg.param_torch_dtype
    return {
        "wq": layers.dense_init(gen, d, cfg.num_heads * cfg.head_dim, dt),
        "wk": layers.dense_init(gen, d, cfg.num_kv_heads * cfg.head_dim, dt),
        "wv": layers.dense_init(gen, d, cfg.num_kv_heads * cfg.head_dim, dt),
        "wo": layers.dense_init(gen, cfg.num_heads * cfg.head_dim, d, dt),
    }


def _split_heads(x: torch.Tensor, n: int, d: int) -> torch.Tensor:
    return x.reshape(tuple(x.shape[:-1]) + (n, d))


def _qkv(params: Dict, x: torch.Tensor, kv_x: torch.Tensor, cfg: ModelConfig,
         policy: Policy):
    q = _split_heads(layers.dense_apply(params["wq"], x, policy), cfg.num_heads, cfg.head_dim)
    k = _split_heads(layers.dense_apply(params["wk"], kv_x, policy), cfg.num_kv_heads,
                     cfg.head_dim)
    v = _split_heads(layers.dense_apply(params["wv"], kv_x, policy), cfg.num_kv_heads,
                     cfg.head_dim)
    return q, k, v


def _gqa_scores(q: torch.Tensor, k: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(B,S,H,D) x (B,T,Hkv,D) -> (B, Hkv, H/Hkv, S, T)."""
    g = cfg.num_heads // cfg.num_kv_heads
    B, S = q.shape[0], q.shape[1]
    qg = q.reshape(B, S, cfg.num_kv_heads, g, cfg.head_dim)
    return torch.einsum("bsngd,btnd->bngst", qg, k) / math.sqrt(cfg.head_dim)


def _gqa_out(probs: torch.Tensor, v: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    B, _, g, S, _ = probs.shape
    out = torch.einsum("bngst,btnd->bsngd", probs, v)
    return out.reshape(B, S, cfg.num_heads * cfg.head_dim)


def _causal_window_mask(s: int, t: int, window: int, offset: int = 0,
                        device=None) -> torch.Tensor:
    """Mask (s, t): query i (absolute pos i+offset) attends to key j iff
    j <= i+offset and (window == 0 or i+offset - j < window)."""
    qpos = torch.arange(s, device=device)[:, None] + offset
    kpos = torch.arange(t, device=device)[None, :]
    ok = kpos <= qpos
    if window > 0:
        ok &= (qpos - kpos) < window
    return ok


def _emulated_attn(q, k, v, cfg: ModelConfig, mask, dtype) -> torch.Tensor:
    """GQA attention through the dispatch seam's ``attention`` kind.

    q: (B, S, H, D); k/v: (B, T, Hkv, D); mask: (S, T) shared across the batch
    (or None = attend to all).  Queries are grouped per KV head and flattened
    to (B·Hkv·g, S, D) problems; k and v are repeated for the g query heads of
    their group.
    """
    B, S, H, D = q.shape
    T = k.shape[1]
    n = cfg.num_kv_heads
    g = H // n
    qf = q.movedim(2, 1).reshape(B * n * g, S, D)
    kf = k.movedim(2, 1)[:, :, None].expand(B, n, g, T, D).reshape(B * n * g, T, D)
    vf = v.movedim(2, 1)[:, :, None].expand(B, n, g, T, D).reshape(B * n * g, T, D)
    out = dispatch.attention(qf, kf, vf, mask=mask, softcap=float(cfg.logit_softcap))
    out = out.reshape(B, H, S, D).movedim(1, 2)
    return out.reshape(B, S, H * D).to(dtype)


def _attn_direct(q, k, v, cfg: ModelConfig, window: int, causal: bool, dtype) -> torch.Tensor:
    scores = _gqa_scores(q, k, cfg).float()
    scores = layers.softcap(scores, cfg.logit_softcap)
    if causal:
        mask = _causal_window_mask(q.shape[1], k.shape[1], window, device=q.device)
        scores = torch.where(mask[None, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    B, S = q.shape[0], q.shape[1]
    out = torch.einsum("bngst,btnd->bsngd",
                       probs.reshape(B, cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads,
                                     S, -1), v)
    return out.reshape(B, S, cfg.num_heads * cfg.head_dim)


def _attn_chunked(q, k, v, cfg: ModelConfig, window: int, dtype, chunk: int) -> torch.Tensor:
    """Causal attention over q-blocks of ``chunk`` rows: peak activation is
    O(chunk * T) per head instead of O(S * T)."""
    B, S, H, D = q.shape
    n = cfg.num_kv_heads
    g = H // n
    scale = 1.0 / math.sqrt(D)
    outs = []
    for ci in range(S // chunk):
        qg = q[:, ci * chunk:(ci + 1) * chunk].reshape(B, chunk, n, g, D)
        s = torch.einsum("bsngd,btnd->bngst", qg, k).float() * scale
        s = layers.softcap(s, cfg.logit_softcap)
        mask = _causal_window_mask(chunk, k.shape[1], window, offset=ci * chunk,
                                   device=q.device)
        s = torch.where(mask[None, None, None], s, NEG_INF)
        p = torch.softmax(s, dim=-1).to(dtype)
        outs.append(torch.einsum("bngst,btnd->bsngd", p, v).reshape(B, chunk, H * D))
    return torch.cat(outs, dim=1)


def attn_apply(params: Dict, x: torch.Tensor, cfg: ModelConfig, policy: Policy,
               sin: torch.Tensor, cos: torch.Tensor, window: int = 0,
               causal: bool = True) -> torch.Tensor:
    """Full-sequence attention (prefill)."""
    q, k, v = _qkv(params, x, x, cfg, policy)
    if cfg.rope_type != "none":
        q = layers.apply_rope(q, sin, cos)
        k = layers.apply_rope(k, sin, cos)
    S, T = q.shape[1], k.shape[1]
    if policy.is_emulated:
        mask = (_causal_window_mask(S, T, window, device=x.device) if causal
                else torch.ones((S, T), dtype=torch.bool, device=x.device))
        attn_out = _emulated_attn(q, k, v, cfg, mask, x.dtype)
    elif causal and cfg.attn_chunk and S > cfg.attn_chunk and S % cfg.attn_chunk == 0:
        attn_out = _attn_chunked(q, k, v, cfg, window, x.dtype, cfg.attn_chunk)
    else:
        attn_out = _attn_direct(q, k, v, cfg, window, causal, x.dtype)
    return layers.dense_apply(params["wo"], attn_out, policy)


# ---------------------------------------------------------------------------
# KV cache (decode)
# ---------------------------------------------------------------------------

def cache_init(cfg: ModelConfig, batch: int, seq_len: int, window: int, dtype=None,
               device="cuda") -> Dict:
    """Ring-buffer cache: capacity = window for sliding layers else seq_len.

    The cache dtype follows the model's compute dtype, so decode equals the
    teacher-forced forward pass.
    """
    if dtype is None:
        dtype = cfg.compute_torch_dtype
    cap = min(window, seq_len) if window > 0 else seq_len
    shape = (batch, cap, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_decode_step(params: Dict, x: torch.Tensor, cache: Dict, pos: int,
                     cfg: ModelConfig, policy: Policy, sin: torch.Tensor,
                     cos: torch.Tensor, window: int = 0) -> Tuple[torch.Tensor, Dict]:
    """One-token decode: x (B, 1, d); pos the current position (shared by the batch).

    The KV cache is a ring buffer of capacity C (= window or full seq); the new
    K/V is written at pos % C by a masked select (cache * (1 - sel) + new * sel,
    the reference's arithmetic: an index write would differ in the sign of
    zeros); queries attend to all valid slots with the ring-distance mask.
    """
    q, k, v = _qkv(params, x, x, cfg, policy)
    if cfg.rope_type != "none":
        q = layers.apply_rope(q, sin, cos)
        k = layers.apply_rope(k, sin, cos)
    cap = cache["k"].shape[1]
    slot = pos % cap
    dev = x.device
    sel = (torch.arange(cap, device=dev) == slot).to(cache["k"].dtype)[None, :, None, None]
    ck = cache["k"] * (1 - sel) + k.to(cache["k"].dtype) * sel
    cv = cache["v"] * (1 - sel) + v.to(cache["v"].dtype) * sel
    # slot j holds absolute position p_j; valid iff 0 <= p_j <= pos (and within window)
    j = torch.arange(cap, device=dev)
    pj = torch.where(j <= slot, pos - slot + j, pos - slot + j - cap)
    ok = (pj >= 0) & (pj <= pos)
    if window > 0:
        ok &= (pos - pj) < window
    if policy.is_emulated:
        attn_out = _emulated_attn(q, ck.to(q.dtype), cv.to(q.dtype), cfg, ok[None, :], x.dtype)
        return layers.dense_apply(params["wo"], attn_out, policy), {"k": ck, "v": cv}
    scores = _gqa_scores(q, ck.to(q.dtype), cfg).float()
    scores = layers.softcap(scores, cfg.logit_softcap)
    scores = torch.where(ok[None, None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = layers.dense_apply(params["wo"], _gqa_out(probs, cv.to(x.dtype), cfg), policy)
    return out, {"k": ck, "v": cv}
