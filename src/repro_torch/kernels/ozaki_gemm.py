"""Fused Ozaki-II GEMM: the Hopper kernel ``gemm_hilo`` and its plain version.

Replaces the TPU kernel ``repro/kernels/ozaki_gemm.py::gemm_hilo``.  The CUDA
source, ``csrc/ozaki_gemm.cu``, states the kernel's bound on the H100 and its
design; ``gemm_hilo_ref`` is the same arithmetic as torch ops, which the CPU
takes and against which the kernel is held bitwise on the card.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import moduli as moduli_lib
from repro_torch.core import ozaki2
from repro_torch.kernels import _build, common

# Granules of csrc/ozaki_gemm.cu: M in 128-row tiles, N in 128-column halves of
# its 256-column tile, K in 64 (its TMA zero-fills a 128-deep stage past K).
# Callers pad to these (repro_torch.core.dispatch does).
TILE_M, TILE_N, TILE_K = 128, 128, 64
OUT_CODES = {"f64": 0, "digits": 1, "ds": 2}


def out_shape(out_rep: str, r: int, *dims: int):
    """(shape, dtype) of a kernel output representation over outputs of shape dims."""
    if out_rep == "f64":
        return dims, torch.float64
    if out_rep == "ds":
        return (2, *dims), torch.float32
    if out_rep == "digits":
        return (r, *dims), torch.int8
    raise ValueError(f"out_rep must be one of {common.OUT_REPS}, got {out_rep!r}")


def check_operands(name: str, a_hi, a_lo, b_hi, b_lo) -> None:
    """Shared validation of the (hi, lo) operand pairs of gemm_hilo / gemv_hilo."""
    for t in (a_hi, a_lo, b_hi, b_lo):
        if t.dtype != torch.int32 or t.ndim != 2:
            raise TypeError(f"{name}: operands must be 2-D int32, got {t.dtype} {tuple(t.shape)}")
        if t.device != a_hi.device:
            raise ValueError(f"{name}: operands on different devices")
    if a_lo.shape != a_hi.shape or b_lo.shape != b_hi.shape:
        raise ValueError(f"{name}: hi/lo shapes differ")
    if a_hi.shape[1] != b_hi.shape[0]:
        raise ValueError(f"{name}: contraction mismatch {tuple(a_hi.shape)} x {tuple(b_hi.shape)}")


def check_plan(name: str, plan: ozaki2.Plan) -> None:
    """The kernels hold the default moduli table as compile-time constants."""
    if plan.substrate != "int8":
        raise ValueError(f"{name}: the kernel implements the int8 substrate only")
    if tuple(plan.moduli) != moduli_lib.DEFAULT_MODULI[:plan.r]:
        raise ValueError(f"{name}: the kernel needs a prefix of DEFAULT_MODULI, "
                         f"got {plan.moduli}")


def check_cuda(name: str, tensors) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: the kernel takes CUDA tensors, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")


def gemm_hilo_ref(a_hi: torch.Tensor, a_lo: torch.Tensor, b_hi: torch.Tensor,
                  b_lo: torch.Tensor, plan: ozaki2.Plan, out_rep: str = "f64") -> torch.Tensor:
    """Plain torch version of ``gemm_hilo``: residues, one exact product per modulus
    (float64 matmul of the residues), balanced reduction, Garner, output."""
    check_operands("gemm_hilo_ref", a_hi, a_lo, b_hi, b_lo)
    if out_rep not in common.OUT_REPS:
        raise ValueError(f"out_rep must be one of {common.OUT_REPS}, got {out_rep!r}")
    accs = []
    for m in plan.moduli:
        ar = common.residue(a_hi, a_lo, m).to(torch.float64)
        br = common.residue(b_hi, b_lo, m).to(torch.float64)
        accs.append(common.balanced_mod(torch.matmul(ar, br).to(torch.int64), m)
                    .to(torch.int32))
    return common.represent(common.garner_digits(accs, plan), plan, out_rep)


def gemm_hilo(a_hi: torch.Tensor, a_lo: torch.Tensor, b_hi: torch.Tensor,
              b_lo: torch.Tensor, plan: ozaki2.Plan, out_rep: str = "f64") -> torch.Tensor:
    """Exact integer product of pre-scaled (hi, lo) operands.

    a_hi/a_lo (M, K), b_hi/b_lo (K, N) int32.  Returns f64 (M, N) | ds f32
    (2, M, N) | digits int8 (r, M, N): the *integer-scaled* product; callers
    apply the exact power-of-two unscale.  CPU tensors take the plain version;
    CUDA tensors launch the kernel (M, N multiples of 128, K of 64) or raise.
    """
    check_operands("gemm_hilo", a_hi, a_lo, b_hi, b_lo)
    if a_hi.device.type == "cpu":
        return gemm_hilo_ref(a_hi, a_lo, b_hi, b_lo, plan, out_rep)
    check_cuda("gemm_hilo", (a_hi, a_lo, b_hi, b_lo))
    check_plan("gemm_hilo", plan)
    (m, k), n = a_hi.shape, b_hi.shape[1]
    if m % TILE_M or n % TILE_N or k % TILE_K:
        raise ValueError(f"gemm_hilo: shapes ({m}, {k}) x ({k}, {n}) must tile as "
                         f"{TILE_M} x {TILE_K} x {TILE_N}")
    shape, dtype = out_shape(out_rep, plan.r, m, n)
    dev = a_hi.device
    out = torch.empty(shape, dtype=dtype, device=dev)
    ares = torch.empty((plan.r, m, k), dtype=torch.int8, device=dev)
    bres = torch.empty((plan.r, n, k), dtype=torch.int8, device=dev)
    cres = torch.empty((plan.r, m, n), dtype=torch.int8, device=dev)
    lib = _build.library("ozaki_gemm")
    err = lib.ozaki_gemm_hilo(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        a_hi.data_ptr(), a_lo.data_ptr(), b_hi.data_ptr(), b_lo.data_ptr(),
        m, n, k, OUT_CODES[out_rep], out.data_ptr(), ares.data_ptr(), bres.data_ptr(),
        cres.data_ptr(), ctypes.addressof(_build.garner_params(plan)),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gemm_hilo: CUDA launch failed with error {err}")
    gemm_hilo.launches += 1
    return out


gemm_hilo.launches = 0  # kernel launches since the count was last set to 0
