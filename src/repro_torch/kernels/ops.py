"""Kernel-level wrappers around the Hopper kernels (``repro.kernels.ops``).

``ozaki_gemm`` / ``ozaki_gemv`` do the cheap streaming pre/post work around one
kernel call: Phase-1 scaling, the hi/lo split, padding to block multiples, the
digit epilogue and the exact unscale.  They ARE the kernel route;
``repro_torch.core.dispatch.matmul`` calls them.  The kernel wrappers take the
plain version for CPU tensors, so these run (bitwise equal) on the CPU too.
``ozaki_stencil7`` / ``ozaki_spmv_bell`` / ``ozaki_attention`` are routed through
the seam (``dispatch.stencil7`` / ``dispatch.spmv`` / ``dispatch.attention``) like
every emulated multiplication.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import dispatch, ozaki2, splitting
from repro_torch.kernels import common
from repro_torch.kernels import ozaki_gemm as _gemm
from repro_torch.kernels import ozaki_gemv as _gemv


def _pad2(x: torch.Tensor, bm: int, bn: int) -> torch.Tensor:
    """Zero-pad a 2-D operand to block multiples, contiguous: the kernels take
    row-major operands, and a transposed input (``b.T`` in a backward) keeps
    its strides through Phase 1."""
    M, N = x.shape
    pm, pn = (-M) % bm, (-N) % bn
    if pm or pn:
        x = F.pad(x, (0, pn, 0, pm))
    return x.contiguous()


def _finish(raw: torch.Tensor, plan: ozaki2.Plan, out_rep: str,
            shape: Tuple[int, int]) -> torch.Tensor:
    """Epilogue: raw kernel output -> scaled-integer product as float64."""
    M, N = shape
    return common.raw_to_f64(raw, plan, out_rep)[:M, :N]


def ozaki_gemm(a: torch.Tensor, b: torch.Tensor, plan: Optional[ozaki2.Plan] = None,
               out_rep: str = "f64", bm: int = _gemm.TILE_M, bn: int = _gemm.TILE_N,
               bk: int = _gemm.TILE_K) -> torch.Tensor:
    """FP64-accurate C = A @ B through ``gemm_hilo`` (the kernel on CUDA tensors)."""
    M, K = a.shape
    N = b.shape[1]
    if plan is None:
        plan = dispatch.get_plan(K)
    ai, sa = splitting.scale_to_int(a.to(torch.float64), plan.payload_bits, axis=-1)
    bi, sb = splitting.scale_to_int(b.to(torch.float64), plan.payload_bits, axis=0)
    a_hi, a_lo = splitting.split_hi_lo(ai)
    b_hi, b_lo = splitting.split_hi_lo(bi)
    a_hi, a_lo = _pad2(a_hi, bm, bk), _pad2(a_lo, bm, bk)
    b_hi, b_lo = _pad2(b_hi, bk, bn), _pad2(b_lo, bk, bn)

    raw = _gemm.gemm_hilo(a_hi, a_lo, b_hi, b_lo, plan, out_rep=out_rep)
    c = _finish(raw, plan, out_rep, (M, N))
    return splitting.apply_unscale(c, sa, sb)


def ozaki_gemv(a: torch.Tensor, x: torch.Tensor, plan: Optional[ozaki2.Plan] = None,
               out_rep: str = "f64", bm: int = _gemv.TILE_M,
               bk: int = _gemv.TILE_K) -> torch.Tensor:
    """Batched GEMV Y = A @ X: A (M, N), X (N, B) with B <= 16, through ``gemv_hilo``."""
    M, N = a.shape
    B = x.shape[1]
    if plan is None:
        plan = dispatch.get_plan(N)
    ai, sa = splitting.scale_to_int(a.to(torch.float64), plan.payload_bits, axis=-1)
    xi, sx = splitting.scale_to_int(x.to(torch.float64), plan.payload_bits, axis=0)
    a_hi, a_lo = splitting.split_hi_lo(ai)
    x_hi, x_lo = splitting.split_hi_lo(xi)
    a_hi, a_lo = _pad2(a_hi, bm, bk), _pad2(a_lo, bm, bk)
    x_hi, x_lo = _pad2(x_hi, bk, 1), _pad2(x_lo, bk, 1)

    raw = _gemv.gemv_hilo(a_hi, a_lo, x_hi, x_lo, plan, out_rep=out_rep)
    y = _finish(raw, plan, out_rep, (M, B))
    return splitting.apply_unscale(y, sa, sx)


def ozaki_stencil7(u: torch.Tensor, c: torch.Tensor, plan: Optional[ozaki2.Plan] = None,
                   out_rep: str = "f64", bz: Optional[int] = None,
                   mode: Optional[str] = None) -> torch.Tensor:
    """7-point 3-D stencil (paper Alg. 2) at FP64 accuracy, dispatch-routed.

    u: (X, Y, Z) grid, c: (7,) coefficients ordered
    [centre, -x, +x, -y, +y, -z, +z].  Boundary points use a zero halo.
    """
    return dispatch.stencil7(u, c, plan=plan, out_rep=out_rep, bz=bz, mode=mode)


def ozaki_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None, softcap: float = 0.0,
                    plan_qk: Optional[ozaki2.Plan] = None, plan_pv: Optional[ozaki2.Plan] = None,
                    mode: Optional[str] = None) -> torch.Tensor:
    """Fused emulated attention softmax(mask(QKᵀ/√D)) V, dispatch-routed.

    q: (..., S, D), k/v: (..., T, D), mask: None | (S, T) | (..., S, T)
    (nonzero = attend).  ``mode`` selects the fused Hopper kernel (QKᵀ and PV
    as Ozaki-II residue products inside one online-softmax sweep) or the
    bitwise-equal reference composed from the emulated GEMMs.
    """
    return dispatch.attention(q, k, v, mask=mask, softcap=softcap, plan_qk=plan_qk,
                              plan_pv=plan_pv, mode=mode)


def ozaki_spmv_bell(a_val: torch.Tensor, a_col: torch.Tensor, x: torch.Tensor,
                    plan: Optional[ozaki2.Plan] = None, out_rep: str = "f64",
                    br: Optional[int] = None, mode: Optional[str] = None) -> torch.Tensor:
    """Blocked-ELL SpMV y = A x (paper Alg. 3), dispatch-routed.

    a_val: (M, bw) padded per-row values; a_col: (M, bw) column indices (a
    structural-zero slot must point at a valid column, value 0.0).
    """
    return dispatch.spmv(a_val, a_col, x, plan=plan, out_rep=out_rep, br=br, mode=mode)
