"""Fused Ozaki-II attention: the Hopper kernel ``attention_fused`` and its plain version.

out = softmax(mask(Q Kᵀ / √D)) V in one online-softmax sweep over blocks of
``bkv`` keys, with both products rebuilt exactly from int8 residue products:
QKᵀ from q and k scaled per row over D, PV from the block's probabilities
scaled per row over the block and v scaled per (block, column).  Replaces the
TPU kernel ``repro/kernels/ozaki_attention.py::attention_fused``.  The CUDA
source, ``csrc/ozaki_attention.cu``, states the kernel's bound on the H100 and
its design; ``attention_ref`` is the same scan composed from
``ozaki2.emulated_matmul`` per block, which the CPU takes and against which the
kernel is held bitwise on the card.

Both routes share ``_masked_scores`` and ``_online_update``.  Where torch leaves
an order or a rounding open, these helpers fix it so that a kernel can repeat
it: the row sum is a pairwise tree over the block's columns zero-padded to a
power of two (exact padding, since p >= 0), and the softcap divides by
multiplying with 1/softcap.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import ozaki2, splitting
from repro_torch.kernels import _build
from repro_torch.kernels.ozaki_gemm import check_cuda, check_plan

# Finite stand-in for -inf (as repro.models.attention.NEG_INF): keeps the
# online-softmax state NaN-free for fully masked rows on both routes.
NEG_INF = -1e30

# Limits of csrc/ozaki_attention.cu: a q tile is one or two 16-row MMA tiles;
# above D = 128 two tiles' staging and residue planes do not fit a block's
# shared memory, so bq <= 16 there.
MAX_BQ = 32
MAX_BQ_WIDE = 16
WIDE_D = 128
MAX_BKV = 128
MAX_D = 256
_MAX_PROBLEMS = 65535


def max_bq(D: int) -> int:
    """The largest q tile the kernel takes at head dimension D."""
    return MAX_BQ if D <= WIDE_D else MAX_BQ_WIDE


PATHS = ("sweep", "row")
_PATH_CODES = {name: i for i, name in enumerate(PATHS)}


def choose_path(S: int) -> str:
    """The kernel's path over the key axis; both give the same bits.

    ``row`` for one query row per problem (decode: the key axis split across
    blocks, no residue planes of k and v, no MMA tile of 15 padding rows);
    else the one-pass ``sweep`` over q tiles.
    """
    return "row" if S == 1 else "sweep"


class AttnShape(ctypes.Structure):
    """Mirror of ``ozaki::AttnShape`` (``csrc/ozaki_attention.cu``)."""

    _fields_ = [(n, ctypes.c_int) for n in ("B", "S", "T", "D", "Dp", "Tq", "bq", "bkv",
                                            "bkvp", "nblk", "rq", "rp", "payload_pv")] + \
               [(n, ctypes.c_int64) for n in ("mask_sb", "mask_ss", "mask_st")] + \
               [(n, ctypes.c_double) for n in ("inv_sqrt_d", "softcap", "inv_cap",
                                               "two_pow_payload")]


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


# ---------------------------------------------------------------------------
# Shared per-block math: the same operations on both routes
# ---------------------------------------------------------------------------

def _masked_scores(s_prod: torch.Tensor, mask_blk: torch.Tensor, softcap: float,
                   inv_sqrt_d: float) -> torch.Tensor:
    """Scale / softcap / mask one block of raw QKᵀ products.

    The models' order: scores·(1/√D), then the tanh softcap (when enabled),
    then masked positions to NEG_INF.  The softcap's division is a multiply
    by 1/softcap (CUDA torch divides by a Python scalar that way, the CPU
    does not; writing it out makes every device and the kernel agree).
    """
    s = s_prod * inv_sqrt_d
    if softcap > 0:
        s = softcap * torch.tanh(s * (1.0 / softcap))
    return torch.where(mask_blk, s, NEG_INF)


def _row_sum(p: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis as a pairwise tree over its columns zero-padded
    to a power of two: level by level, column 2i plus column 2i + 1."""
    n = p.shape[-1]
    x = F.pad(p, (0, (1 << (n - 1).bit_length()) - n))
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def _online_update(s: torch.Tensor, m: torch.Tensor, l: torch.Tensor):
    """One FlashAttention online-softmax step over a (..., rows, bkv) score block.

    Returns (p, corr, m_new, l_new): the block's unnormalised probabilities,
    the correction factor for the running accumulator, and the updated
    running max / normaliser.
    """
    m_new = torch.maximum(m, s.amax(dim=-1))
    corr = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * corr + _row_sum(p)
    return p, corr, m_new, l_new


# ---------------------------------------------------------------------------
# Plain version: the same scan composed from the emulated GEMMs
# ---------------------------------------------------------------------------

def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """Zero rows appended along the next-to-last axis up to ``rows``."""
    return F.pad(x, (0, 0, 0, rows - x.shape[-2]))


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
                  plan_qk: ozaki2.Plan, plan_pv: ozaki2.Plan, softcap: float = 0.0,
                  bkv: int = 128) -> torch.Tensor:
    """Plain torch version of ``attention_fused`` (the reference route).

    q: (..., S, D), k/v: (..., T, D), mask: (..., S, T) (nonzero = attend),
    with equal leading dims, each problem on its own.  Scans blocks of ``bkv``
    keys in order; each block's QKᵀ and PV are ``ozaki2.emulated_matmul`` at
    the kernel's scaling granularity (q and k per row over D; p per row and v
    per column over the block).  Returns float64 (..., S, D).
    """
    S, D = q.shape[-2:]
    T = k.shape[-2]
    f64 = torch.float64
    q = q.to(f64)
    tp = _round_up(T, bkv)
    kp = _pad_rows(k.to(f64), tp)
    vp = _pad_rows(v.to(f64), tp)
    mp = F.pad(mask != 0, (0, tp - T))
    inv_sqrt_d = 1.0 / math.sqrt(D)
    m = torch.full(q.shape[:-1], NEG_INF, dtype=f64, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(q)
    for t0 in range(0, tp, bkv):
        blk = slice(t0, t0 + bkv)
        s_prod = ozaki2.emulated_matmul(q, kp[..., blk, :].transpose(-1, -2), plan_qk)
        s = _masked_scores(s_prod, mp[..., blk], softcap, inv_sqrt_d)
        p, corr, m, l = _online_update(s, m, l)
        pv = ozaki2.emulated_matmul(p, vp[..., blk, :], plan_pv)
        acc = acc * corr[..., None] + pv
    return acc / l[..., None]


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------

def _decompose(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, plan_qk: ozaki2.Plan,
               plan_pv: ozaki2.Plan, bkv: int):
    """Phase 1 of the kernel, in torch: q and k scaled per row over D, v per
    (kv block, column), each split into int32 (hi, lo).  Returns the operands
    of ``_launch``: (q_hi, q_lo, k_hi, k_lo, v_hi, v_lo, sq, sk, sv) with v and
    sk padded to whole blocks."""
    B, T, D = k.shape
    nblk = -(-T // bkv)
    q, k, v = (x.to(torch.float64).contiguous() for x in (q, k, v))
    qi, sq = splitting.scale_to_int(q, plan_qk.payload_bits, axis=-1)
    ki, sk = splitting.scale_to_int(k, plan_qk.payload_bits, axis=-1)
    vb = _pad_rows(v, nblk * bkv).reshape(B, nblk, bkv, D)
    vi, sv = splitting.scale_to_int(vb, plan_pv.payload_bits, axis=2)
    q_hi, q_lo = splitting.split_hi_lo(qi)
    k_hi, k_lo = splitting.split_hi_lo(ki)
    v_hi, v_lo = splitting.split_hi_lo(vi.reshape(B, nblk * bkv, D))
    sk = F.pad(sk, (0, nblk * bkv - T))
    return q_hi, q_lo, k_hi, k_lo, v_hi, v_lo, sq, sk, sv


def _launch(q_hi, q_lo, k_hi, k_lo, v_hi, v_lo, sq, sk, sv, mask: torch.Tensor,
            plan_qk: ozaki2.Plan, plan_pv: ozaki2.Plan, softcap: float, bq: int,
            bkv: int, path: Optional[str] = None) -> torch.Tensor:
    """The CUDA kernel on the operands of ``_decompose``: float64 (B, S, D).

    ``path`` picks one of ``PATHS`` (None: ``choose_path``; ``row`` needs
    S = 1); both give the same bits."""
    B, S, D = q_hi.shape
    T = k_hi.shape[1]
    tq = v_hi.shape[1]
    if not 1 <= bq <= max_bq(D):
        raise ValueError(f"attention_fused: bq must be in 1..{max_bq(D)} at D = {D}, got {bq}")
    if bkv % 8 or not 8 <= bkv <= MAX_BKV:
        raise ValueError(f"attention_fused: bkv must be a multiple of 8 in 8..{MAX_BKV}, "
                         f"got {bkv}")
    if D > MAX_D or B > _MAX_PROBLEMS:
        raise ValueError(f"attention_fused: the kernel takes D <= {MAX_D} and at most "
                         f"{_MAX_PROBLEMS} problems, got D = {D}, {B} problems")
    if abs(plan_qk.r - plan_pv.r) > 1:
        raise ValueError(f"attention_fused: the kernel takes plans whose r differ by at "
                         f"most 1, got {plan_qk.r} and {plan_pv.r}")
    check_plan("attention_fused", plan_qk)
    check_plan("attention_fused", plan_pv)
    check_cuda("attention_fused", (q_hi, q_lo, k_hi, k_lo, v_hi, v_lo, sq, sk, sv))
    if mask.dtype != torch.int8 or tuple(mask.shape) != (B, S, T):
        raise ValueError(f"attention_fused: mask must be int8 ({B}, {S}, {T}), got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    dp = _round_up(D, 64)
    nblk = tq // bkv
    dev = q_hi.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if path is None:
        path = choose_path(S)
    if path not in PATHS or (path == "row" and S != 1):
        raise ValueError(f"attention_fused: path must be one of {PATHS} ('row' for S = 1), "
                         f"got {path!r} at S = {S}")
    sh = AttnShape(B=B, S=S, T=T, D=D, Dp=dp, Tq=tq, bq=bq, bkv=bkv, bkvp=_round_up(bkv, 64),
                   nblk=nblk, rq=plan_qk.r, rp=plan_pv.r,
                   payload_pv=plan_pv.payload_bits, mask_sb=mask.stride(0),
                   mask_ss=mask.stride(1), mask_st=mask.stride(2),
                   inv_sqrt_d=1.0 / math.sqrt(D), softcap=float(softcap),
                   inv_cap=1.0 / softcap if softcap > 0 else 0.0,
                   two_pow_payload=2.0 ** plan_pv.payload_bits)
    out = torch.empty((B, S, D), dtype=torch.float64, device=dev)
    # Scratch, one allocation each, carved by byte offsets (all multiples of 64):
    # for the sweep the int8 residue planes of q (B, rq, S, Dp), k (B, rq, Tq, Dp)
    # and v (B, rp, Dp, Tq); for the row path f64 scores (B, Tq), P V per block
    # (B, nblk, D) and the block max and row sum (B, nblk, 2).
    res, work = [None, None, None], [None, None, None]
    if path == "sweep":
        n_q, n_k = B * plan_qk.r * S * dp, B * plan_qk.r * tq * dp
        planes = torch.empty(n_q + n_k + B * plan_pv.r * dp * tq, dtype=torch.int8, device=dev)
        res = [planes.data_ptr() + off for off in (0, n_q, n_q + n_k)]
    else:
        n_s, n_pv = B * tq, B * nblk * D
        buf = torch.empty(n_s + n_pv + 2 * B * nblk, dtype=torch.float64, device=dev)
        work = [buf.data_ptr() + 8 * off for off in (0, n_s, n_s + n_pv)]
    params = _build.garner_params(plan_qk if plan_qk.r > plan_pv.r else plan_pv)
    lib = _build.library("ozaki_attention")
    err = lib.ozaki_attention_fused(
        index, q_hi.data_ptr(), q_lo.data_ptr(), k_hi.data_ptr(), k_lo.data_ptr(),
        v_hi.data_ptr(), v_lo.data_ptr(), sq.data_ptr(), sk.data_ptr(), sv.data_ptr(),
        mask.data_ptr(), out.data_ptr(), *res, *work, _PATH_CODES[path], ctypes.addressof(sh),
        ctypes.addressof(params), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"attention_fused: CUDA launch failed with error {err}")
    return out


def attention_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
                    plan_qk: ozaki2.Plan, plan_pv: ozaki2.Plan, softcap: float = 0.0, *,
                    bq: int, bkv: int) -> torch.Tensor:
    """Fused emulated attention: out = softmax(mask(QKᵀ/√D)) V in one sweep.

    q: (B, S, D), k/v: (B, T, D), mask: (B, S, T) (nonzero = attend), one
    problem per leading index; returns float64 (B, S, D).  CPU tensors take
    the plain version; CUDA tensors launch the kernel, one launch for all B
    problems with q tiles of ``bq`` rows (``dispatch.attention`` takes bq
    and bkv from the tuning table), or raise.  The result does not depend on
    ``bq``, nor on the kernel's path over the key axis (``choose_path``);
    ``bkv`` is part of the function (it sets p's scaling blocks).
    """
    if q.ndim != 3 or k.ndim != 3 or v.shape != k.shape or q.shape[0] != k.shape[0] \
            or q.shape[2] != k.shape[2] or tuple(mask.shape) != (q.shape[0], q.shape[1],
                                                                  k.shape[1]):
        raise ValueError(f"attention_fused takes q (B, S, D), k and v (B, T, D), mask "
                         f"(B, S, T); got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(mask.shape)}")
    if not all(t.is_floating_point() for t in (q, k, v)):
        raise TypeError(f"attention_fused: q, k and v must be floating point, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if len({t.device for t in (q, k, v, mask)}) != 1:
        raise ValueError("attention_fused: q, k, v and mask on different devices")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, mask, plan_qk, plan_pv, softcap, bkv)
    ops = _decompose(q, k, v, plan_qk, plan_pv, bkv)
    out = _launch(*ops, mask if mask.dtype == torch.int8 else (mask != 0).to(torch.int8),
                  plan_qk, plan_pv, softcap, bq, bkv)
    attention_fused.launches += 1
    return out


attention_fused.launches = 0  # kernel launches since the count was last set to 0
