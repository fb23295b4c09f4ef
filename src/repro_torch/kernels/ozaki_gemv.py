"""Fused Ozaki-II batched GEMV: the Hopper kernel ``gemv_hilo`` and its plain version.

Y = A·X with A (M, N) and a small batch X (N, B ≤ 16); every CG matvec has
B = 1.  Replaces the TPU kernel ``repro/kernels/ozaki_gemv.py::gemv_hilo``.  The
CUDA source, ``csrc/ozaki_gemv.cu``, states the kernel's bound on the H100 and
its design; ``gemv_hilo_ref`` is the same arithmetic as torch ops.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import ozaki2
from repro_torch.kernels import _build
from repro_torch.kernels.ozaki_gemm import (OUT_CODES, check_cuda, check_operands,
                                            check_plan, gemm_hilo_ref, out_shape)

# Granules of csrc/ozaki_gemv.cu: 8 rows per warp, K in 32-deep steps.
TILE_M, TILE_K = 8, 32
MAX_B = 16


def table_bytes(r: int, k: int, b: int) -> int:
    """Bytes of the kernel's residue table of X: r * K entries of 8 bytes, 16
    when B > 8 (csrc/ozaki_gemv.cu, gemv_x_table)."""
    return r * k * (16 if b > 8 else 8)


def gemv_hilo_ref(a_hi: torch.Tensor, a_lo: torch.Tensor, x_hi: torch.Tensor,
                  x_lo: torch.Tensor, plan: ozaki2.Plan, out_rep: str = "f64") -> torch.Tensor:
    """Plain torch version of ``gemv_hilo``: the GEMM arithmetic on a narrow X."""
    return gemm_hilo_ref(a_hi, a_lo, x_hi, x_lo, plan, out_rep)


def gemv_hilo(a_hi: torch.Tensor, a_lo: torch.Tensor, x_hi: torch.Tensor,
              x_lo: torch.Tensor, plan: ozaki2.Plan, out_rep: str = "f64") -> torch.Tensor:
    """Exact integer product of pre-scaled (hi, lo) operands with a narrow RHS.

    a_hi/a_lo (M, N), x_hi/x_lo (N, B) int32, B <= 16.  Returns f64 (M, B) | ds
    f32 (2, M, B) | digits int8 (r, M, B), integer-scaled.  CPU tensors take the
    plain version; CUDA tensors launch the kernel (M a multiple of 8, N of 32)
    or raise.
    """
    check_operands("gemv_hilo", a_hi, a_lo, x_hi, x_lo)
    (m, k), b = a_hi.shape, x_hi.shape[1]
    if not 1 <= b <= MAX_B:
        raise ValueError(f"gemv_hilo: the right-hand side has {b} columns, "
                         f"the kernel takes 1..{MAX_B}")
    if a_hi.device.type == "cpu":
        return gemv_hilo_ref(a_hi, a_lo, x_hi, x_lo, plan, out_rep)
    check_cuda("gemv_hilo", (a_hi, a_lo, x_hi, x_lo))
    check_plan("gemv_hilo", plan)
    if m % TILE_M or k % TILE_K:
        raise ValueError(f"gemv_hilo: shape ({m}, {k}) must tile as {TILE_M} x {TILE_K}")
    shape, dtype = out_shape(out_rep, plan.r, m, b)
    dev = a_hi.device
    out = torch.empty(shape, dtype=dtype, device=dev)
    xres = torch.empty(table_bytes(plan.r, k, b), dtype=torch.int8, device=dev)
    lib = _build.library("ozaki_gemv")
    err = lib.ozaki_gemv_hilo(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        a_hi.data_ptr(), a_lo.data_ptr(), x_hi.data_ptr(), x_lo.data_ptr(),
        m, k, b, OUT_CODES[out_rep], out.data_ptr(), xres.data_ptr(),
        ctypes.addressof(_build.garner_params(plan)), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gemv_hilo: CUDA launch failed with error {err}")
    gemv_hilo.launches += 1
    return out


gemv_hilo.launches = 0  # kernel launches since the count was last set to 0
