"""State-space and recurrent mixers (``repro.models.ssm``): Mamba (jamba) and
xLSTM's mLSTM (matrix memory) and sLSTM (scalar memory, head-blocked).

All three are attention-free mixers that carry a state, so their decode state
is O(1) in sequence length.  Time runs in chunks, as in the reference:

  * Mamba: an outer loop over ``ssm_chunk`` steps carries the (B, d_inner,
    d_state) boundary state; inside a chunk, ``_associative_scan`` (in
    ``jax.lax.associative_scan``'s association) combines the steps.
  * mLSTM / sLSTM: an outer loop over ``lstm_chunk`` steps and a step loop
    inside.  sLSTM's recurrence R is block-diagonal per head (xLSTM paper).

The chunk bounds change the association of the state update, so they change
the last bits of the result; ``ssm_chunk`` and ``lstm_chunk`` are the
reference's.  Every weight product goes through the precision policy
(``layers.dense_apply``): under an emulated policy it runs on the seam's
``gemm_hilo``, or ``gemv_hilo`` for 16 columns or fewer (mLSTM's gate
projection, 2·num_heads wide).  The recurrences are plain torch ops, as the
reference's are XLA scans and einsums outside any Pallas kernel.  The
reference's activation checkpointing (``remat``) acts here on whole layers, in
``transformer.Model.apply``; the reference also checkpoints each time chunk,
which changes its memory and not its values, and the port does not.  Its
dry-run unrolling (``force_unroll``) has nothing to act on, since every loop
here is already a Python loop.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch

from repro_torch import convert
from repro_torch.configs.base import ModelConfig
from repro_torch.core.policy import Policy
from repro_torch.models import layers

Tensors = Tuple[torch.Tensor, ...]


# ---------------------------------------------------------------------------
# Activations, written as the reference's
# ---------------------------------------------------------------------------

def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``, with no switch
    to x above a threshold (``F.softplus`` has one at 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x · sigmoid(x) (``F.silu`` divides, x / (1 + e^-x))."""
    return x * torch.sigmoid(x)


# ---------------------------------------------------------------------------
# Scans
# ---------------------------------------------------------------------------

def _chunk_len(chunk: int, S: int) -> int:
    """The reference's chunk: at most S, and all of S unless it divides S."""
    chunk = min(chunk, S)
    return S if S % chunk else chunk


def _chunk_scan(chunk_fn, state, xs: Tensors, nchunks: int):
    """Outer sequential loop over time chunks.  xs: tensors (B, nchunks, ...);
    returns (final state, the chunks' outputs stacked on axis 1)."""
    outs = []
    for c in range(nchunks):
        state, yc = chunk_fn(state, tuple(t[:, c] for t in xs))
        outs.append(yc)
    return state, torch.stack(outs, dim=1)


def _take(t: torch.Tensor, dim: int, start: int, stop=None, step: int = 1) -> torch.Tensor:
    return t[(slice(None),) * dim + (slice(start, stop, step),)]


def _interleave(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """a at the even places of ``dim``, b at the odd ones (a one longer, or as long)."""
    shape = list(a.shape)
    shape[dim] += b.shape[dim]
    out = a.new_empty(shape)
    out[(slice(None),) * dim + (slice(0, None, 2),)] = a
    out[(slice(None),) * dim + (slice(1, None, 2),)] = b
    return out


def _associative_scan(combine: Callable[[Tensors, Tensors], Tensors], elems: Tensors,
                      dim: int) -> Tensors:
    """Inclusive scan of ``combine`` along ``dim`` in ``jax.lax.associative_scan``'s
    association: combine adjacent pairs, scan the half-length sequence by
    recursion (the odd places), then combine each of its elements with the
    next even element (the even places; at an odd length the last scanned pair
    joins the last element)."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems
    reduced = combine(tuple(_take(e, dim, 0, -1, 2) for e in elems),
                      tuple(_take(e, dim, 1, None, 2) for e in elems))
    odd = _associative_scan(combine, reduced, dim)
    evens = tuple(_take(e, dim, 2, None, 2) for e in elems)
    if n % 2 == 0:
        even = combine(tuple(_take(o, dim, 0, -1) for o in odd), evens)
    else:
        even = combine(odd, evens)
    even = tuple(torch.cat([_take(e, dim, 0, 1), r], dim=dim) for e, r in zip(elems, even))
    return tuple(_interleave(e, o, dim) for e, o in zip(even, odd))


# ---------------------------------------------------------------------------
# Mamba (selective SSM)
# ---------------------------------------------------------------------------

def mamba_init(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    """In and out projections, the depthwise conv, x_proj (B, C and dt), and
    A = -exp(a_log), whose log is float32 whatever the parameter dtype."""
    d, di, ds = cfg.d_model, cfg.d_inner, cfg.ssm_state_dim
    dt, dev = cfg.param_torch_dtype, gen.device
    conv_w = torch.empty((cfg.ssm_conv_width, di), dtype=dt, device=dev).normal_(generator=gen)
    return {
        "in_proj": layers.dense_init(gen, d, 2 * di, dt),
        "conv_w": conv_w * 0.1,
        "x_proj": layers.dense_init(gen, di, 2 * ds + 1, dt),     # B, C, dt
        "dt_bias": torch.zeros((di,), dtype=dt, device=dev),
        "a_log": torch.log(torch.arange(1, ds + 1, dtype=torch.float32, device=dev)
                           ).repeat(di, 1),
        "d_skip": torch.ones((di,), dtype=dt, device=dev),
        "out_proj": layers.dense_init(gen, di, d, dt),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, state=None):
    """Depthwise causal conv over time, x (B, S, di), w (K, di): the K taps
    summed left to right.  Returns (y, the last K - 1 inputs: the next state)."""
    K = w.shape[0]
    if state is None:
        pad = x.new_zeros(x.shape[:1] + (K - 1,) + x.shape[2:])
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                         # (B, S+K-1, di)
    y = sum(xp[:, i:i + x.shape[1]] * w[i][None, None] for i in range(K))
    return y, xp[:, -(K - 1):]


def _mamba_bcd(params: Dict, xin: torch.Tensor, cfg: ModelConfig):
    """(B, C, dt) from x_proj's output.  dt is one value per token: its raw
    value plus the mean of ``dt_bias[..., :1]`` (one element), through
    softplus, broadcast over d_inner — the reference's function, kept as it is."""
    ds = cfg.ssm_state_dim
    bcd = xin.float()
    Bm, Cm, dt_raw = bcd[..., :ds], bcd[..., ds:2 * ds], bcd[..., -1:]
    dt = softplus(dt_raw + params["dt_bias"].float()[..., :1].mean())
    return Bm, Cm, dt


def _mamba_combine(a: Tensors, b: Tensors) -> Tensors:
    return a[0] * b[0], b[0] * a[1] + b[1]


def mamba_apply(params: Dict, x: torch.Tensor, cfg: ModelConfig, policy: Policy
                ) -> torch.Tensor:
    """Chunked selective scan, x (B, S, d) -> (B, S, d): the outer chunk loop
    carries h; inside a chunk h_t = gA_t · h0 + gB_t from the associative scan."""
    B, S, _ = x.shape
    di = cfg.d_inner
    chunk = _chunk_len(cfg.ssm_chunk, S)
    nchunks = S // chunk

    xin, z = torch.chunk(layers.dense_apply(params["in_proj"], x, policy), 2, dim=-1)
    xin, _ = _causal_conv(xin, params["conv_w"].to(x.dtype))
    xin = silu(xin)
    Bm, Cm, dt = _mamba_bcd(params, layers.dense_apply(params["x_proj"], xin, policy), cfg)
    A = -torch.exp(params["a_log"])                            # (di, ds)
    xf32 = xin.float()

    dA = torch.exp(dt[..., None] * A[None, None])              # (B, S, di, ds)
    dBx = (dt * xf32)[..., None] * Bm[:, :, None, :]            # (B, S, di, ds)

    def chunk_fn(h0, xc):
        dAc, dBxc, Cc = xc                                     # (B, chunk, di, ds), (B, chunk, ds)
        gA, gB = _associative_scan(_mamba_combine, (dAc, dBxc), dim=1)
        h = gA * h0[:, None] + gB                              # inject the boundary state
        return h[:, -1], torch.einsum("bsdn,bsn->bsd", h, Cc)

    def rs(t):
        return t.reshape(B, nchunks, chunk, *t.shape[2:])

    h0 = torch.zeros((B, di, cfg.ssm_state_dim), dtype=torch.float32, device=x.device)
    _, y = _chunk_scan(chunk_fn, h0, (rs(dA), rs(dBx), rs(Cm)), nchunks)
    y = y.reshape(B, S, di)
    y = y + xf32 * params["d_skip"].float()[None, None]
    y = (y * silu(z.float())).to(x.dtype)
    return layers.dense_apply(params["out_proj"], y, policy)


def mamba_state_init(cfg: ModelConfig, batch: int, device="cuda") -> Dict:
    """h (B, d_inner, d_state) and the conv's last K - 1 inputs, float32, on
    ``device`` (default: the card)."""
    device = convert.resolve_device(device)
    return {"h": torch.zeros((batch, cfg.d_inner, cfg.ssm_state_dim), device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, cfg.d_inner), device=device)}


def mamba_decode_step(params: Dict, x: torch.Tensor, state: Dict, cfg: ModelConfig,
                      policy: Policy) -> Tuple[torch.Tensor, Dict]:
    """One-token recurrent update, x (B, 1, d)."""
    xin, z = torch.chunk(layers.dense_apply(params["in_proj"], x, policy), 2, dim=-1)
    xin, conv_state = _causal_conv(xin, params["conv_w"].to(x.dtype), state["conv"])
    xin = silu(xin)
    Bm, Cm, dt = _mamba_bcd(params, layers.dense_apply(params["x_proj"], xin, policy), cfg)
    A = -torch.exp(params["a_log"])
    xf = xin.float()[:, 0]                                     # (B, di)
    dA = torch.exp(dt[:, 0, :, None] * A[None])                # (B, di, ds)
    dBx = (dt[:, 0] * xf)[..., None] * Bm[:, 0, None, :]
    h = state["h"] * dA + dBx
    y = torch.einsum("bdn,bn->bd", h, Cm[:, 0])
    y = y + xf * params["d_skip"].float()[None]
    y = (y * silu(z.float()[:, 0]))[:, None].to(x.dtype)
    out = layers.dense_apply(params["out_proj"], y, policy)
    return out, {"h": h, "conv": conv_state.to(state["conv"].dtype)}


# ---------------------------------------------------------------------------
# xLSTM: mLSTM (matrix memory) and sLSTM (scalar memory, head-blocked)
# ---------------------------------------------------------------------------

def mlstm_init(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    d, di, H = cfg.d_model, cfg.d_inner, cfg.num_heads
    dt = cfg.param_torch_dtype
    return {
        "up_proj": layers.dense_init(gen, d, 2 * di, dt),
        "wq": layers.dense_init(gen, di, di, dt),
        "wk": layers.dense_init(gen, di, di, dt),
        "wv": layers.dense_init(gen, di, di, dt),
        "w_if": layers.dense_init(gen, di, 2 * H, dt),     # input and forget gates
        "down_proj": layers.dense_init(gen, di, d, dt),
    }


def _mlstm_heads(x: torch.Tensor, H: int) -> torch.Tensor:
    B, S, di = x.shape
    return x.reshape(B, S, H, di // H)


def _mlstm_step(carry: Tensors, inp: Tensors, scale: float):
    """One step of the matrix memory, stabilised exponential gating."""
    C, n, m = carry                                            # (B,H,dh,dh), (B,H,dh), (B,H)
    qt, kt, vt, it, ft = inp
    m_new = torch.maximum(ft + m, it)
    i_ = torch.exp(it - m_new)
    f_ = torch.exp(ft + m - m_new)
    C = f_[..., None, None] * C + i_[..., None, None] * (kt[..., :, None] * vt[..., None, :])
    n = f_[..., None] * n + i_[..., None] * kt
    num = torch.einsum("bhd,bhde->bhe", qt * scale, C)
    den = torch.abs(torch.einsum("bhd,bhd->bh", qt * scale, n))
    h = num / torch.clamp(den, min=1.0)[..., None]
    return (C, n, m_new), h


def _mlstm_inputs(params: Dict, x: torch.Tensor, cfg: ModelConfig, policy: Policy):
    """(q, k, v (B, S, H, dh), input and forget gates (B, S, H) float32, z)."""
    H = cfg.num_heads
    xi, z = torch.chunk(layers.dense_apply(params["up_proj"], x, policy), 2, dim=-1)
    q, k, v = (_mlstm_heads(layers.dense_apply(params[w], xi, policy), H)
               for w in ("wq", "wk", "wv"))
    gates = layers.dense_apply(params["w_if"], xi, policy).float()
    ig, fg = torch.chunk(gates, 2, dim=-1)
    return q, k, v, ig, fg, z


def mlstm_apply(params: Dict, x: torch.Tensor, cfg: ModelConfig, policy: Policy
                ) -> torch.Tensor:
    """Chunked mLSTM, x (B, S, d) -> (B, S, d): outer chunk loop, step loop inside."""
    H = cfg.num_heads
    B, S, _ = x.shape
    q, k, v, ig, fg, z = _mlstm_inputs(params, x, cfg, policy)
    dh = q.shape[-1]
    scale = 1.0 / math.sqrt(dh)
    chunk = _chunk_len(cfg.lstm_chunk, S)
    nchunks = S // chunk

    def chunk_fn(carry, xc):
        qc, kc, vc, ic, fc = (t.float() for t in xc)           # (B, chunk, ...)
        hs = []
        for t in range(chunk):
            carry, h = _mlstm_step(carry, (qc[:, t], kc[:, t], vc[:, t], ic[:, t], fc[:, t]),
                                   scale)
            hs.append(h)
        return carry, torch.stack(hs, dim=1)                   # (B, chunk, H, dh)

    def rs(t):
        return t.reshape(B, nchunks, chunk, *t.shape[2:])

    state = mlstm_state_init(cfg, B, x.device)
    init = (state["C"], state["n"], state["m"])
    _, hs = _chunk_scan(chunk_fn, init, tuple(rs(t) for t in (q, k, v, ig, fg)), nchunks)
    h = hs.reshape(B, S, -1).to(x.dtype) * silu(z)
    return layers.dense_apply(params["down_proj"], h, policy)


def mlstm_state_init(cfg: ModelConfig, batch: int, device="cuda") -> Dict:
    """C (B, H, dh, dh), n (B, H, dh) and m (B, H), float32, on ``device``
    (default: the card)."""
    device = convert.resolve_device(device)
    H = cfg.num_heads
    dh = cfg.d_inner // H
    return {"C": torch.zeros((batch, H, dh, dh), device=device),
            "n": torch.zeros((batch, H, dh), device=device),
            "m": torch.zeros((batch, H), device=device)}


def mlstm_decode_step(params: Dict, x: torch.Tensor, state: Dict, cfg: ModelConfig,
                      policy: Policy) -> Tuple[torch.Tensor, Dict]:
    q, k, v, it, ft, z = _mlstm_inputs(params, x, cfg, policy)
    (C, n, m), h = _mlstm_step(
        (state["C"], state["n"], state["m"]),
        (q[:, 0].float(), k[:, 0].float(), v[:, 0].float(), it[:, 0], ft[:, 0]),
        1.0 / math.sqrt(q.shape[-1]))
    h = h.reshape(x.shape[0], 1, -1).to(x.dtype) * silu(z)
    out = layers.dense_apply(params["down_proj"], h, policy)
    return out, {"C": C, "n": n, "m": m}


def slstm_init(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    d, di, H = cfg.d_model, cfg.d_inner, cfg.num_heads
    dh = di // H
    dt = cfg.param_torch_dtype
    scale = 1.0 / math.sqrt(dh)
    return {
        "w_in": layers.dense_init(gen, d, 4 * di, dt),      # i, f, z, o pre-activations
        # the head-blocked recurrence (xLSTM's block-diagonal R): (H, dh, 4·dh)
        "r_blocks": layers._uniform(gen, (H, dh, 4 * dh), -scale, scale, dt),
        "down_proj": layers.dense_init(gen, di, d, dt),
    }


def _slstm_step(carry: Tensors, wx: torch.Tensor, r_blocks: torch.Tensor):
    """wx: (B, H, 4·dh) input pre-activations; carry (c, n, m, h), each (B, H, dh)."""
    c, n, m, h_prev = carry
    pre = wx + torch.einsum("bhd,hde->bhe", h_prev, r_blocks)     # block-diagonal R
    i_r, f_r, z_r, o_r = torch.chunk(pre, 4, dim=-1)
    m_new = torch.maximum(f_r + m, i_r)
    i_ = torch.exp(i_r - m_new)
    f_ = torch.exp(f_r + m - m_new)
    c = f_ * c + i_ * torch.tanh(z_r)
    n = f_ * n + i_
    h = torch.sigmoid(o_r) * c / torch.clamp(n, min=1.0)
    return (c, n, m_new, h), h


def slstm_apply(params: Dict, x: torch.Tensor, cfg: ModelConfig, policy: Policy
                ) -> torch.Tensor:
    B, S, _ = x.shape
    H, di = cfg.num_heads, cfg.d_inner
    dh = di // H
    wx = layers.dense_apply(params["w_in"], x, policy).float().reshape(B, S, H, 4 * dh)
    r = params["r_blocks"].float()
    chunk = _chunk_len(cfg.lstm_chunk, S)
    nchunks = S // chunk

    def chunk_fn(carry, xc):
        hs = []
        for t in range(chunk):
            carry, h = _slstm_step(carry, xc[0][:, t], r)
            hs.append(h)
        return carry, torch.stack(hs, dim=1)

    state = slstm_state_init(cfg, B, x.device)
    init = (state["c"], state["n"], state["m"], state["h"])
    _, hs = _chunk_scan(chunk_fn, init, (wx.reshape(B, nchunks, chunk, H, 4 * dh),), nchunks)
    h = hs.reshape(B, S, di).to(x.dtype)
    return layers.dense_apply(params["down_proj"], h, policy)


def slstm_state_init(cfg: ModelConfig, batch: int, device="cuda") -> Dict:
    """c, n, m and h, each (B, H, d_inner / H) float32, on ``device`` (default:
    the card)."""
    device = convert.resolve_device(device)
    H = cfg.num_heads
    shape = (batch, H, cfg.d_inner // H)
    return {key: torch.zeros(shape, device=device) for key in ("c", "n", "m", "h")}


def slstm_decode_step(params: Dict, x: torch.Tensor, state: Dict, cfg: ModelConfig,
                      policy: Policy) -> Tuple[torch.Tensor, Dict]:
    B, H = x.shape[0], cfg.num_heads
    dh = cfg.d_inner // H
    wx = layers.dense_apply(params["w_in"], x, policy).float().reshape(B, H, 4 * dh)
    carry = (state["c"], state["n"], state["m"], state["h"])
    (c, n, m, h), _ = _slstm_step(carry, wx, params["r_blocks"].float())
    out = layers.dense_apply(params["down_proj"], h.reshape(B, 1, cfg.d_inner).to(x.dtype),
                             policy)
    return out, {"c": c, "n": n, "m": m, "h": h}
