"""Fused Ozaki-II Blocked-ELL SpMV: the Hopper kernel ``spmv_bell`` and its plain version.

y = A x with A in Blocked-ELL form: ``a_val (M, bw)`` padded per-row values and
``a_col (M, bw)`` column indices (a structural-zero slot points at a valid
column with value 0.0).  Each row of A takes its own power-of-two scale, x one
global scale; both are split into (hi, lo) int32, and every y_i is rebuilt
exactly from its residues over the plan's moduli.  Replaces the TPU kernel
``repro/kernels/ozaki_spmv.py::spmv_bell``.  The CUDA source,
``csrc/ozaki_spmv.cu``, states the kernel's bound on the H100 and its design;
``spmv_bell_ref`` is the same arithmetic as torch ops.  Every integer step is
exact and row-local, so the two are bitwise equal whatever the row blocking.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import ozaki2, splitting
from repro_torch.kernels import _build, common
from repro_torch.kernels.ozaki_gemm import OUT_CODES, check_cuda, check_plan, out_shape
from repro_torch.kernels.ozaki_stencil import _global_scale_to_int

MAX_BLOCK_ROWS = 256  # rows (threads) per block of csrc/ozaki_spmv.cu


def table_width(r: int) -> int:
    """Bytes per x_j of the kernel's residue table: r int8 residues, zero-padded
    to 16 (to 32 from r = 17 on)."""
    return 16 * -(-r // 16)


def _decompose_operands(a_val: torch.Tensor, a_col: torch.Tensor, x: torch.Tensor,
                        plan: ozaki2.Plan):
    """Phase 1 of the kernel and of its plain version: per-row scaling of
    a_val, global scaling of x, the (hi, lo) splits, the column cast."""
    av, sa = splitting.scale_to_int(a_val.to(torch.float64), plan.payload_bits, axis=-1)
    xi, sx = _global_scale_to_int(x.to(torch.float64), plan.payload_bits)
    av_hi, av_lo = splitting.split_hi_lo(av)
    x_hi, x_lo = splitting.split_hi_lo(xi)
    return av_hi, av_lo, a_col.to(torch.int32), x_hi, x_lo, sa, sx


def _contract_ref(av_hi: torch.Tensor, av_lo: torch.Tensor, cols: torch.Tensor,
                  x_hi: torch.Tensor, x_lo: torch.Tensor, plan: ozaki2.Plan,
                  out_rep: str) -> torch.Tensor:
    """Plain version of the kernel proper: the raw output (f64 | ds | digits)
    of the scaled integer product, one modulus at a time.  The row sums are
    taken in int64, so they are exact for any bw."""
    idx = cols.to(torch.int64)
    xg_hi, xg_lo = x_hi[idx], x_lo[idx]
    accs = []
    for m in plan.moduli:
        prod = common.residue(av_hi, av_lo, m) * common.residue(xg_hi, xg_lo, m)
        accs.append(common.balanced_mod(prod.sum(dim=-1, dtype=torch.int64), m)
                    .to(torch.int32))
    return common.represent(common.garner_digits(accs, plan), plan, out_rep)


def _finish(raw: torch.Tensor, plan: ozaki2.Plan, out_rep: str, sa: torch.Tensor,
            sx: torch.Tensor) -> torch.Tensor:
    y = common.raw_to_f64(raw, plan, out_rep)
    return splitting.ldexp(y, -(sa + sx))


def _check_operands(a_val: torch.Tensor, a_col: torch.Tensor, x: torch.Tensor) -> None:
    if a_val.ndim != 2 or a_col.shape != a_val.shape or x.ndim != 1:
        raise ValueError(f"spmv_bell takes a_val, a_col (M, bw) and x (N,), got "
                         f"{tuple(a_val.shape)}, {tuple(a_col.shape)}, {tuple(x.shape)}")
    if not (a_val.device == a_col.device == x.device):
        raise ValueError("spmv_bell: operands on different devices")
    if not (a_val.is_floating_point() and x.is_floating_point()):
        raise TypeError(f"spmv_bell: a_val and x must be floating point, got "
                        f"{a_val.dtype}, {x.dtype}")
    if a_col.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"spmv_bell: a_col must be int32 or int64, got {a_col.dtype}")


def spmv_bell_ref(a_val: torch.Tensor, a_col: torch.Tensor, x: torch.Tensor,
                  plan: ozaki2.Plan, out_rep: str = "f64") -> torch.Tensor:
    """Plain torch version of ``spmv_bell`` (the reference route); float64 (M,)."""
    _check_operands(a_val, a_col, x)
    if out_rep not in common.OUT_REPS:
        raise ValueError(f"out_rep must be one of {common.OUT_REPS}, got {out_rep!r}")
    av_hi, av_lo, cols, x_hi, x_lo, sa, sx = _decompose_operands(a_val, a_col, x, plan)
    raw = _contract_ref(av_hi, av_lo, cols, x_hi, x_lo, plan, out_rep)
    return _finish(raw, plan, out_rep, sa, sx)


def _launch(av_hi: torch.Tensor, av_lo: torch.Tensor, cols: torch.Tensor,
            x_hi: torch.Tensor, x_lo: torch.Tensor, plan: ozaki2.Plan, out_rep: str,
            br: int) -> torch.Tensor:
    """The CUDA kernel on the (hi, lo) operands: the raw output."""
    M, bw = av_hi.shape
    if not 1 <= br <= MAX_BLOCK_ROWS:
        raise ValueError(f"spmv_bell: row block {br} outside 1..{MAX_BLOCK_ROWS}")
    n = x_hi.shape[0]
    if cols.numel():
        lo, hi = torch.aminmax(cols)               # one pass, one host sync
        if bool((lo < 0) | (hi >= n)):
            raise ValueError(f"spmv_bell: a column index lies outside 0..{n - 1}")
    shape, dtype = out_shape(out_rep, plan.r, M)
    dev = av_hi.device
    out = torch.empty(shape, dtype=dtype, device=dev)
    xres = torch.empty((n, table_width(plan.r)), dtype=torch.int8, device=dev)
    lib = _build.library("ozaki_spmv")
    err = lib.ozaki_spmv_hilo(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        av_hi.data_ptr(), av_lo.data_ptr(), cols.data_ptr(), x_hi.data_ptr(),
        x_lo.data_ptr(), M, n, bw, br, OUT_CODES[out_rep], out.data_ptr(), xres.data_ptr(),
        ctypes.addressof(_build.garner_params(plan)), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"spmv_bell: CUDA launch failed with error {err}")
    return out


def spmv_bell(a_val: torch.Tensor, a_col: torch.Tensor, x: torch.Tensor,
              plan: ozaki2.Plan, out_rep: str = "f64", *, br: int) -> torch.Tensor:
    """Emulated FP64-accurate Blocked-ELL SpMV y = A x; float64 (M,) on x's device.

    CPU tensors take the plain version; CUDA tensors launch the kernel with
    blocks of br rows (``dispatch.spmv`` takes br from the tuning table), or
    raise.  The result does not depend on br.
    """
    _check_operands(a_val, a_col, x)
    if x.device.type == "cpu":
        return spmv_bell_ref(a_val, a_col, x, plan, out_rep)
    check_plan("spmv_bell", plan)
    av_hi, av_lo, cols, x_hi, x_lo, sa, sx = _decompose_operands(a_val, a_col, x, plan)
    check_cuda("spmv_bell", (av_hi, av_lo, cols, x_hi, x_lo))
    raw = _launch(av_hi, av_lo, cols, x_hi, x_lo, plan, out_rep, br)
    spmv_bell.launches += 1
    return _finish(raw, plan, out_rep, sa, sx)


spmv_bell.launches = 0  # kernel launches since the count was last set to 0
